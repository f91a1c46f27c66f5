"""Weight conversion into the port, CLIP archives, training checkpoints,
the eval-time BN fold, and the int8 sites' activation scales."""

from .calibrate import (SCALES_NAME, attach_act_scales, calibrate_act_scales,
                        load_act_scales, quant_config, save_act_scales,
                        set_act_scales)
from .fold import fold_batchnorm, fold_pos_embed
from .from_jax import (clip_from_jax, from_jax, load_jax_variables,
                       quant_from_jax)
from .pth import (BEST_NAME, LAST_NAME, load_cris_checkpoint,
                  load_train_checkpoint, promote_best, save_checkpoint)
from .torch_convert import infer_clip_config, load_clip_torchscript

__all__ = ["BEST_NAME", "LAST_NAME", "SCALES_NAME", "attach_act_scales",
           "calibrate_act_scales", "clip_from_jax",
           "fold_batchnorm", "fold_pos_embed", "from_jax",
           "infer_clip_config", "load_act_scales", "load_clip_torchscript",
           "load_cris_checkpoint", "load_jax_variables",
           "load_train_checkpoint", "promote_best", "quant_config",
           "quant_from_jax", "save_act_scales", "save_checkpoint",
           "set_act_scales"]
