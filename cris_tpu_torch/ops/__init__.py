"""Functional ops of the port: attention (with the K1 CUDA kernel),
resizes, positional encodings and the dynamic conv."""

from .attention import (NEG_INF, causal_mask, dot_product_attention,
                        merge_heads, split_heads)
from .dynamic_conv import dynamic_conv2d
from .posenc import sincos_1d, sincos_2d
from .resize import avg_pool2d, resize2d, upsample2x

__all__ = ["NEG_INF", "avg_pool2d", "causal_mask", "dot_product_attention",
           "dynamic_conv2d", "merge_heads", "resize2d", "sincos_1d",
           "sincos_2d", "split_heads", "upsample2x"]
