"""Building blocks, with CRIS.pytorch's module names so that state_dict keys
match (counterpart of cris_tpu/models/layers.py:358-460,463-507,707-760).

Eval forms only: BatchNorm normalizes with its running statistics.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.resize import upsample2x


class BatchNorm(nn.Module):
    """Eval-mode BatchNorm over dim 1 with torch's parameter names
    (weight, bias, running_mean, running_var; eps 1e-5).

    The per-channel affine is prepared in f32 and applied in the input's
    dtype, as the JAX BatchNorm does (layers.py:418-428)."""

    def __init__(self, num_features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        inv = torch.rsqrt(self.running_var.float() + self.eps) * self.weight.float()
        shift = self.bias.float() - self.running_mean.float() * inv
        shape = (1, -1) + (1,) * (x.dim() - 2)
        return x * inv.to(x.dtype).view(shape) + shift.to(x.dtype).view(shape)


class LayerNormF32(nn.LayerNorm):
    """LayerNorm computed in f32 and cast back to the input dtype."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.layer_norm(x.float(), self.normalized_shape, self.weight.float(),
                         self.bias.float(), self.eps)
        return y.to(x.dtype)


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    """x * sigmoid(1.702 x)."""
    return x * torch.sigmoid(1.702 * x)


class QuickGELU(nn.Module):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return quick_gelu(x)


class ConvBNReLU(nn.Sequential):
    """conv(bias=False) + BN + ReLU: CRIS.pytorch's ``conv_layer``
    (keys ``0.weight`` and ``1.*``)."""

    def __init__(self, in_dim: int, out_dim: int, kernel_size: int = 1,
                 padding: int = 0, stride: int = 1):
        super().__init__(
            nn.Conv2d(in_dim, out_dim, kernel_size, stride, padding, bias=False),
            BatchNorm(out_dim),
            nn.ReLU(inplace=True),
        )


class LinearBNReLU(nn.Sequential):
    """linear(bias=False) + BN1d + ReLU: CRIS.pytorch's ``linear_layer``."""

    def __init__(self, in_dim: int, out_dim: int):
        super().__init__(
            nn.Linear(in_dim, out_dim, bias=False),
            BatchNorm(out_dim),
            nn.ReLU(inplace=True),
        )


class CoordConv(nn.Module):
    """Concatenates x/y coordinate planes in [-1, 1], then a ConvBNReLU."""

    def __init__(self, in_dim: int, out_dim: int, kernel_size: int = 3,
                 padding: int = 1):
        super().__init__()
        self.conv1 = ConvBNReLU(in_dim + 2, out_dim, kernel_size, padding)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, _, h, w = x.shape
        ys = torch.linspace(-1.0, 1.0, h, device=x.device)
        xs = torch.linspace(-1.0, 1.0, w, device=x.device)
        yy = ys[:, None].expand(h, w)
        xx = xs[None, :].expand(h, w)
        coords = torch.stack([xx, yy]).to(x.dtype).expand(b, 2, h, w)
        return self.conv1(torch.cat([x, coords], dim=1))


class Upsample2x(nn.Module):
    """Bilinear x2 upsample (align_corners=False) as a module, for the
    projector's Sequential."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return upsample2x(x)
