"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch
version. Built from ``cris_tpu_torch/csrc`` at first use (see build.py)."""

from .attention import (attention_bse_backward_plain, attention_plain,
                        fused_attention_bse)
from .attention_dropout import (attention_dropout_backward,
                                attention_dropout_backward_plain,
                                attention_dropout_forward,
                                attention_dropout_plain,
                                attention_dropout_route,
                                fused_attention_bse_dropout)
from .bottleneck import (bottleneck_plain, bottleneck_plan,
                         bottleneck_route, bottleneck_takes, fused_bottleneck)
from .dropout_mask import keep_bits_packed, keep_mask
from .fused_attention import fused_attention, fused_attention_plain
from .fused_matmul import conv1x1_fused, fused_matmul, fused_matmul_plain
from .int8_conv import (int8_conv, int8_conv_packed_plain, int8_conv_plain,
                        int8_plan, int8_quantize, int8_quantize_plain,
                        pack_int8_weights)
from .layernorm import (layer_norm, layer_norm_backward,
                        layer_norm_backward_plain, layer_norm_plain)
from .stem import fused_stem_pool, stem_plan, stem_pool_plain, stem_route

__all__ = ["attention_bse_backward_plain", "attention_dropout_backward",
           "attention_dropout_backward_plain", "attention_dropout_forward",
           "attention_dropout_plain", "attention_dropout_route",
           "attention_plain", "bottleneck_plain", "bottleneck_plan",
           "bottleneck_route", "bottleneck_takes", "conv1x1_fused",
           "fused_attention", "fused_attention_bse",
           "fused_attention_bse_dropout", "fused_attention_plain",
           "fused_bottleneck", "fused_matmul", "fused_matmul_plain",
           "fused_stem_pool", "int8_conv", "int8_conv_packed_plain",
           "int8_conv_plain", "int8_plan", "int8_quantize",
           "int8_quantize_plain", "pack_int8_weights",
           "keep_bits_packed", "keep_mask", "layer_norm",
           "layer_norm_backward", "layer_norm_backward_plain",
           "layer_norm_plain", "stem_plan", "stem_pool_plain", "stem_route"]
