"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch
version. Built from ``cris_tpu_torch/csrc`` at first use (see build.py)."""

from .attention import (attention_bse_backward_plain, attention_plain,
                        fused_attention_bse)
from .attention_dropout import (attention_dropout_backward,
                                attention_dropout_forward,
                                attention_dropout_plain,
                                fused_attention_bse_dropout)
from .bottleneck import bottleneck_plain, fused_bottleneck
from .dropout_mask import keep_mask
from .stem import fused_stem_pool, stem_pool_plain

__all__ = ["attention_bse_backward_plain", "attention_dropout_backward",
           "attention_dropout_forward", "attention_dropout_plain",
           "attention_plain", "bottleneck_plain", "fused_attention_bse",
           "fused_attention_bse_dropout", "fused_bottleneck",
           "fused_stem_pool", "keep_mask", "stem_pool_plain"]
