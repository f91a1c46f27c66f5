"""Building blocks, with CRIS.pytorch's module names so that state_dict keys
match (counterpart of cris_tpu/models/layers.py:358-460,463-507,707-760).

BatchNorm normalises with the batch statistics in training (and updates
its running statistics), those of the global batch under data parallel,
and with the running statistics in eval; with
``fold_bn`` (inference only) a conv or linear carries the BN's affine in
its weight and bias and the BN is gone. ``Dropout`` draws its mask from an
explicit generator. ``remat`` runs a block under activation checkpointing.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Callable, Optional

import torch
import torch.nn.functional as F
import torch.utils.checkpoint
from torch import nn

# set on the thread that recomputes a checkpointed block in the backward
_recompute = threading.local()


@contextlib.contextmanager
def _recomputing():
    _recompute.active = True
    try:
        yield
    finally:
        _recompute.active = False


def remat(fn: Callable[..., torch.Tensor], *args) -> torch.Tensor:
    """``fn(*args)`` with its activations recomputed in the backward
    instead of kept (``torch.utils.checkpoint``, non-reentrant; the JAX
    package's ``nn.remat``). ``fn`` must compute the same values on its
    second call: the train-mode ``BatchNorm`` skips its running-statistics
    update on that call, and randomness has to be fixed by the caller."""
    return torch.utils.checkpoint.checkpoint(
        fn, *args, use_reentrant=False,
        context_fn=lambda: (contextlib.nullcontext(), _recomputing()))

from ..ops.resize import upsample2x
from ..parallel import all_reduce_sum, process_count


class BatchNorm(nn.Module):
    """BatchNorm over dim 1 with torch's parameter names (weight, bias,
    running_mean, running_var; eps 1e-5, momentum 0.1).

    The JAX BatchNorm's form (layers.py:398-431): in training the batch
    mean and ``var = max(E[x^2] - E[x]^2, 0)`` are taken in f32 over every
    dim but 1 and the output is normalised with that biased variance; the
    running statistics are updated in place, outside autograd, with the
    unbiased ``n / (n - 1)`` correction on the variance (once a step:
    not when ``remat`` recomputes the forward). In eval the
    running statistics normalise. Either way the per-channel affine is
    prepared in f32 and applied in the input's dtype.

    With more than one data-parallel rank, training normalises with the
    global batch's statistics (the JAX package's cross-replica mean over
    the data axis): the per-channel sums of x and x^2 and the count are
    summed over the ranks in one differentiable all-reduce, and the mean
    and E[x^2] - E[x]^2 are taken from them in f32. The gradient flows
    back through that sum, and the running statistics, updated with the
    global n / (n - 1), are equal on every rank."""

    momentum = 0.1

    def __init__(self, num_features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            with torch.autocast(x.device.type, enabled=False):
                dims = [0] + list(range(2, x.dim()))
                x32 = x.float()
                n = x.numel() // x.shape[1]
                if process_count() == 1:
                    mean = x32.mean(dims)
                    var = torch.clamp(x32.square().mean(dims) - mean.square(),
                                      min=0.0)
                    unbias = n / max(n - 1, 1)
                else:
                    c = x.shape[1]
                    sums = all_reduce_sum(torch.cat([
                        x32.sum(dims), x32.square().sum(dims),
                        x32.new_full((1,), float(n))]))
                    n = sums[2 * c]  # the global count, kept on the device
                    mean = sums[:c] / n
                    var = torch.clamp(sums[c:2 * c] / n - mean.square(),
                                      min=0.0)
                    unbias = n / (n - 1).clamp(min=1.0)
            # remat's second forward: the first one updated them
            if not getattr(_recompute, "active", False):
                with torch.no_grad():
                    m = self.momentum
                    self.running_mean.mul_(1.0 - m).add_(m * mean)
                    self.running_var.mul_(1.0 - m).add_(m * var * unbias)
        else:
            mean, var = self.running_mean, self.running_var
        inv = torch.rsqrt(var.float() + self.eps) * self.weight.float()
        shift = self.bias.float() - mean.float() * inv
        shape = (1, -1) + (1,) * (x.dim() - 2)
        return x * inv.to(x.dtype).view(shape) + shift.to(x.dtype).view(shape)


class Dropout(nn.Module):
    """Inverted elementwise dropout, as flax ``nn.Dropout``: kept values
    are scaled by 1 / (1 - p), the mask comes from ``generator`` (on the
    input's device). The identity in eval or at p = 0."""

    def __init__(self, p: float):
        super().__init__()
        self.p = float(p)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        if not self.training or self.p == 0.0:
            return x
        keep = torch.rand(x.shape, generator=generator, device=x.device) >= self.p
        return torch.where(keep, x / (1.0 - self.p), torch.zeros_like(x))


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


def norm(num_features: int, fold_bn: bool = False) -> nn.Module:
    """The BN after a conv or linear, or nothing where ``fold_bn`` has
    folded it into that layer's weight and bias
    (``checkpoint.fold.fold_batchnorm``)."""
    return nn.Identity() if fold_bn else BatchNorm(num_features)


class ConvBNReLU(nn.Sequential):
    """conv(bias=False) + BN + ReLU: CRIS.pytorch's ``conv_layer``
    (keys ``0.weight`` and ``1.*``); with ``fold_bn``, conv(bias=True) +
    ReLU (keys ``0.weight``, ``0.bias``)."""

    def __init__(self, in_dim: int, out_dim: int, kernel_size: int = 1,
                 padding: int = 0, stride: int = 1, fold_bn: bool = False):
        super().__init__(
            nn.Conv2d(in_dim, out_dim, kernel_size, stride, padding,
                      bias=fold_bn),
            norm(out_dim, fold_bn),
            nn.ReLU(inplace=True),
        )


class LinearBNReLU(nn.Sequential):
    """linear(bias=False) + BN1d + ReLU: CRIS.pytorch's ``linear_layer``;
    with ``fold_bn``, linear(bias=True) + ReLU."""

    def __init__(self, in_dim: int, out_dim: int, fold_bn: bool = False):
        super().__init__(
            nn.Linear(in_dim, out_dim, bias=fold_bn),
            norm(out_dim, fold_bn),
            nn.ReLU(inplace=True),
        )


class CoordConv(nn.Module):
    """Concatenates x/y coordinate planes in [-1, 1], then a ConvBNReLU."""

    def __init__(self, in_dim: int, out_dim: int, kernel_size: int = 3,
                 padding: int = 1, fold_bn: bool = False):
        super().__init__()
        self.conv1 = ConvBNReLU(in_dim + 2, out_dim, kernel_size, padding,
                                fold_bn=fold_bn)

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
