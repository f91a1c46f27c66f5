"""Per-sample text-conditioned KxK convolution (the Projector's mask head),
as CRIS.pytorch computes it: one grouped conv with groups=B over a
(1, B*C, H, W) view. Counterpart of ``cris_tpu.ops.dynamic_conv``."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def dynamic_conv2d(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                   kernel_size: int = 3) -> torch.Tensor:
    """x (B, C, H, W), weight (B, C, K, K), bias (B,) -> (B, 1, H, W)."""
    b, c, h, w = x.shape
    out = F.conv2d(x.reshape(1, b * c, h, w), weight.to(x.dtype),
                   padding=kernel_size // 2, groups=b)
    return (out.transpose(0, 1) + bias.reshape(b, 1, 1, 1)).to(x.dtype)
