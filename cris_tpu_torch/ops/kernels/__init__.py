"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch
version. Built from ``cris_tpu_torch/csrc`` at first use (see build.py)."""

from .attention import (attention_bse_backward_plain, attention_plain,
                        fused_attention_bse)
from .attention_dropout import (attention_dropout_backward,
                                attention_dropout_forward,
                                attention_dropout_plain,
                                fused_attention_bse_dropout)
from .dropout_mask import keep_mask

__all__ = ["attention_bse_backward_plain", "attention_dropout_backward",
           "attention_dropout_forward", "attention_dropout_plain",
           "attention_plain", "fused_attention_bse",
           "fused_attention_bse_dropout", "keep_mask"]
