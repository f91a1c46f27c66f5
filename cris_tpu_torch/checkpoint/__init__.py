"""Weight conversion into the port, CLIP archives, training checkpoints,
and the eval-time BN fold."""

from .fold import fold_batchnorm, fold_pos_embed
from .from_jax import from_jax, load_jax_variables
from .pth import (BEST_NAME, LAST_NAME, load_cris_checkpoint,
                  load_train_checkpoint, promote_best, save_checkpoint)
from .torch_convert import infer_clip_config, load_clip_torchscript

__all__ = ["BEST_NAME", "LAST_NAME", "fold_batchnorm", "fold_pos_embed",
           "from_jax", "infer_clip_config", "load_clip_torchscript",
           "load_cris_checkpoint", "load_jax_variables",
           "load_train_checkpoint", "promote_best", "save_checkpoint"]
