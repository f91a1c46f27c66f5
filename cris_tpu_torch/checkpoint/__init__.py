"""Weight conversion into the port, checkpoint loading, and the eval-time
BN fold."""

from .fold import fold_batchnorm, fold_pos_embed
from .from_jax import from_jax, load_jax_variables
from .pth import BEST_NAME, load_cris_checkpoint

__all__ = ["BEST_NAME", "fold_batchnorm", "fold_pos_embed", "from_jax",
           "load_cris_checkpoint", "load_jax_variables"]
