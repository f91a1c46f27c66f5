"""Resizes on NCHW tensors, as ``cris_tpu.ops.resize`` computes them.

The JAX package builds torch's interpolation weights as matrices
(resize.py:9-18); here ``F.interpolate`` and ``F.avg_pool2d`` are the
operations themselves.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F


def resize2d(
    x: torch.Tensor,
    out_hw: Tuple[int, int],
    method: str = "bilinear",
    align_corners: bool = False,
) -> torch.Tensor:
    """Resize (B, C, H, W) to ``out_hw``; a no-op at the same size."""
    if tuple(x.shape[-2:]) == tuple(out_hw):
        return x
    if method == "nearest":
        return F.interpolate(x, size=tuple(out_hw), mode="nearest")
    return F.interpolate(x, size=tuple(out_hw), mode=method,
                         align_corners=align_corners)


def upsample2x(x: torch.Tensor) -> torch.Tensor:
    """Bilinear x2 upsample with align_corners=False."""
    return resize2d(x, (x.shape[-2] * 2, x.shape[-1] * 2), "bilinear", False)


def avg_pool2d(x: torch.Tensor, window: int,
               stride: Optional[int] = None) -> torch.Tensor:
    """Unpadded average pooling, as F.avg_pool2d."""
    return F.avg_pool2d(x, window, stride or window)
