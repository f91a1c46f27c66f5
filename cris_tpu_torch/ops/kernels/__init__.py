"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch
version. Built from ``cris_tpu_torch/csrc`` at first use (see build.py)."""

from .attention import attention_plain, fused_attention_bse

__all__ = ["attention_plain", "fused_attention_bse"]
