"""Weight conversion into the port, and the eval-time BN fold."""

from .fold import fold_batchnorm, fold_pos_embed
from .from_jax import from_jax, load_jax_variables

__all__ = ["fold_batchnorm", "fold_pos_embed", "from_jax",
           "load_jax_variables"]
