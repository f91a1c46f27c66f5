"""Building blocks, with CRIS.pytorch's module names so that state_dict keys
match (counterpart of cris_tpu/models/layers.py:358-460,463-507,707-760).

BatchNorm normalises with the batch statistics in training (and updates
its running statistics), those of the global batch under data parallel,
and with the running statistics in eval; with
``fold_bn`` (inference only) a conv or linear carries the BN's affine in
its weight and bias and the BN is gone. ``Dropout`` draws its mask from an
explicit generator. ``remat`` runs a block under activation checkpointing.

The int8 serving sites (counterpart of cris_tpu/models/layers.py:25-356,
550-690): ``QuantConv`` is an ``nn.Conv2d`` (same parameters and keys)
that, once ``enable_int8`` gives it a ``QuantConfig``, runs its conv in
one of the site forms through ``ops.quant`` (K8,
``ops.kernels.int8_conv``, on the card) on the BN-folded eval model: as
a plain conv (``forward``), as a pooled 1x1 (``pooled``, the JAX
package's ``PooledConv1x1``), as a pooled 1x1 on a
space-to-depth input (``s2d_pooled``, ``S2dPooledConv1x1``), as the s2d
stem's 3x3 (``s2d3x3``, ``S2dConv3x3``) or as the phase convs of an
upsample fold (``UpConvBNReLU``, ``CatUpConvBNReLU``). The JAX package's
trace-time env gates become the ``QuantConfig`` fields. Each site keeps
its calibrated scale in the non-persistent buffer ``act_scale`` (the JAX
"quant" collection; ``checkpoint.calibrate`` maps the two); without one a
plain-conv site quantises with a dynamic scale and the other forms run
their plain conv. Under ``calibrating()`` every site records its input's
maxabs (or a percentile of |x|) and runs plain; under ``auditing(mode)``
every site that runs int8 also runs plain and records the error
(``python3 -m cris_tpu_torch.int8_error_audit``). Weights are quantised
once per form and cached on the module.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Callable, Dict, Optional

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

from ..ops import s2d as s2d_ops
from ..ops import upsample_conv as upc
from ..ops.kernels.bottleneck import compute_dtype
from ..ops.quant import (dynamic_scale, int8_conv2d_static,
                         int8_phase_conv_static, quantize_packed)
from ..ops.resize import upsample2x
from ..parallel import all_reduce_sum, grid


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
    summed over the grid's data group in one differentiable all-reduce,
    and the mean and E[x^2] - E[x]^2 are taken from them in f32. The
    gradient flows back through that sum, and the running statistics,
    updated with the global n / (n - 1), are equal on every rank. The
    ranks of a model group (tensor parallel) hold the same rows and are
    not summed, or each sample would count once a model rank."""

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
                group = grid()
                if group.data_size == 1:
                    mean = x32.mean(dims)
                    var = torch.clamp(x32.square().mean(dims) - mean.square(),
                                      min=0.0)
                    unbias = n / max(n - 1, 1)
                else:
                    c = x.shape[1]
                    sums = all_reduce_sum(torch.cat([
                        x32.sum(dims), x32.square().sum(dims),
                        x32.new_full((1,), float(n))]), group.data_group)
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
    ReLU (keys ``0.weight``, ``0.bias``). The conv is a ``QuantConv`` of
    the int8 ``family`` (None: never a site)."""

    def __init__(self, in_dim: int, out_dim: int, kernel_size: int = 1,
                 padding: int = 0, stride: int = 1, fold_bn: bool = False,
                 family: Optional[str] = None):
        super().__init__(
            QuantConv(in_dim, out_dim, kernel_size, stride, padding,
                      bias=fold_bn, family=family),
            norm(out_dim, fold_bn),
            nn.ReLU(inplace=True),
        )

    def finish(self, y: torch.Tensor) -> torch.Tensor:
        """The BN (or nothing, folded) and the ReLU after the conv."""
        return F.relu(self[1](y))


class UpConvBNReLU(ConvBNReLU):
    """bilinear upsample x2 + ConvBNReLU(k3, pad 1) (the projector's
    trunk); with ``fuse`` the upsample is folded into the conv
    (``ops.upsample_conv``, exact), the JAX package's ``UpConvBNReLU``.
    The same parameters and keys as the ConvBNReLU. The fold's up-core is
    the int8 site of family "upfold" (the phase form through K8)."""

    def __init__(self, in_dim: int, out_dim: int, fold_bn: bool = False,
                 fuse: bool = False):
        super().__init__(in_dim, out_dim, 3, 1, fold_bn=fold_bn,
                         family="upfold")
        self.fuse = fuse

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.fuse:
            return super().forward(upsample2x(x))
        conv = self[0]
        dt = compute_dtype(x)
        xn = x.permute(0, 2, 3, 1).to(dt)
        kernel = conv.weight.permute(2, 3, 1, 0)
        if conv.site_on("upfold", "upfold_min_ch",
                        min(conv.in_channels, conv.out_channels)):
            core = conv.phase_site(xn, dt, upc.phase_kernels6, upc.PHASE_PADS6,
                                   lambda: upc.up_core3x3(xn, kernel, dt))
            y = upc.apply_border_correction3x3(core, xn, kernel.to(dt))
            if conv.bias is not None:
                y = y + conv.bias.to(dt)
        else:
            y = upc.upsample2x_conv3x3(xn, kernel.to(dt), conv.bias)
        return self.finish(y.permute(0, 3, 1, 2))


class CatUpConvBNReLU(ConvBNReLU):
    """ConvBNReLU(1x1) over ``cat([*parts, upsample2x(up)])`` (the FPN's
    f2_cat and aggr); with ``fuse`` the upsample is folded into the
    concat kernel's ``up`` slice: conv1x1(cat) = conv1x1_a(parts) +
    upsample2x_conv1x1(up, K_b), the JAX package's ``CatUpConvBNReLU``.
    The same parameters and keys as the ConvBNReLU; the up-core is the
    int8 site of family "upfold"."""

    def __init__(self, in_dim: int, out_dim: int, fold_bn: bool = False,
                 fuse: bool = False):
        super().__init__(in_dim, out_dim, 1, 0, fold_bn=fold_bn,
                         family="upfold")
        self.fuse = fuse

    def forward(self, parts, up: torch.Tensor) -> torch.Tensor:
        if not self.fuse:
            return super().forward(torch.cat([*parts, upsample2x(up)], 1))
        conv = self[0]
        dt = compute_dtype(up)
        cu = up.shape[1]
        ca = conv.in_channels - cu
        kernel = conv.weight.permute(2, 3, 1, 0)  # (1, 1, ci, F)
        cat = parts[0] if len(parts) == 1 else torch.cat(parts, 1)
        with torch.autocast(up.device.type, enabled=False):
            y = torch.einsum("bchw,cd->bhwd", cat.to(dt),
                             kernel[0, 0, :ca].to(dt))
        k_up = kernel[:, :, ca:]
        upn = up.permute(0, 2, 3, 1).to(dt)
        if conv.site_on("upfold", "upfold_min_ch", min(cu, conv.out_channels)):
            core = conv.phase_site(upn, dt, upc.phase_kernels4,
                                   upc.PHASE_PADS4,
                                   lambda: upc.up_core1x1(upn, k_up, dt),
                                   lambda w: w[:, :, ca:])
            y = y + upc.apply_border_ring1x1(core, upn, k_up)
        else:
            y = y + upc.upsample2x_conv1x1(upn, k_up)
        if conv.bias is not None:
            y = y + conv.bias.to(dt)
        return self.finish(y.permute(0, 3, 1, 2))


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
                 padding: int = 1, fold_bn: bool = False,
                 family: Optional[str] = None):
        super().__init__()
        self.conv1 = ConvBNReLU(in_dim + 2, out_dim, kernel_size, padding,
                                fold_bn=fold_bn, family=family)

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


@dataclasses.dataclass(frozen=True)
class QuantConfig:
    """The int8 sites' gates (the JAX package's trace-time env gates):
    ``min_ch`` (CRIS_INT8_MIN_CH) the min(cin, cout) of a plain-conv site
    and of the s2d stem's embedded widths; ``pooled_min_ch``
    (CRIS_INT8_POOLED_MIN_CH) of the pooled and s2d-pooled sites;
    ``upfold_min_ch`` (CRIS_INT8_UPFOLD_MIN_CH) of the upsample folds'
    cores; ``stem``, ``head`` and ``upfold`` (CRIS_INT8_STEM, _HEAD,
    _UPFOLD) include those families."""

    min_ch: int = 128
    pooled_min_ch: int = 256
    upfold_min_ch: int = 256
    stem: bool = True
    head: bool = True
    upfold: bool = True

    def takes(self, family: Optional[str]) -> bool:
        return family == "backbone" or (
            family in ("stem", "head", "upfold") and getattr(self, family))


_calibration = threading.local()


def act_stat(x: torch.Tensor, pct: float = 0.0) -> torch.Tensor:
    """max |x|, or with ``pct`` the pct-th percentile of |x| as
    ``jnp.quantile``'s linear method takes it (in f32: position
    q * (n - 1), the two order statistics around it weighted by its
    fraction), by a sort: ``torch.quantile`` refuses inputs above 2^24
    elements."""
    with torch.autocast(x.device.type, enabled=False):
        ax = x.detach().float().abs().reshape(-1)
        if not pct:
            return ax.amax()
        n = ax.numel()
        f32 = dict(dtype=torch.float32, device=ax.device)
        q = torch.tensor(pct / 100.0, **f32) * torch.tensor(float(n - 1), **f32)
        lo, hi = torch.floor(q), torch.ceil(q)
        w_hi = q - lo
        w_lo = 1.0 - w_hi
        srt = torch.sort(ax).values
        v_lo = srt[lo.clamp(0, n - 1).long()]
        v_hi = srt[hi.clamp(0, n - 1).long()]
        return v_lo * w_lo + v_hi * w_hi


class Calibration:
    """Per-site running maximum of ``act_stat`` over calibration forwards
    (``stats``: site module -> f32 scalar)."""

    def __init__(self, pct: float = 0.0):
        self.pct = float(pct)
        self.stats: Dict[nn.Module, torch.Tensor] = {}

    def record(self, site: nn.Module, x: torch.Tensor) -> None:
        stat = act_stat(x, self.pct)
        prev = self.stats.get(site)
        self.stats[site] = stat if prev is None else torch.maximum(prev, stat)


@contextlib.contextmanager
def calibrating(pct: float = 0.0):
    """Within it, every int8 site records its input's statistic into the
    yielded ``Calibration`` and runs its plain conv (the JAX package's
    CRIS_INT8_CALIB=1 with CRIS_INT8_CALIB_PCT=pct)."""
    cal = Calibration(pct)
    _calibration.state = cal
    try:
        yield cal
    finally:
        _calibration.state = None


class Audit:
    """Per-site running element-wise maximum over the audited forwards of
    (max |err|, rms(err), max |ref|, rms(ref)) in f32, err the int8
    result less the plain one (``stats``: site module -> (4,) tensor);
    ``mode`` "local" feeds the plain result on, "compound" the int8 one."""

    MODES = ("local", "compound")

    def __init__(self, mode: str = "local"):
        if mode not in self.MODES:
            raise ValueError(f"audit mode {mode!r}: one of {self.MODES}")
        self.mode = mode
        self.stats: Dict[nn.Module, torch.Tensor] = {}

    def record(self, site: nn.Module, got: torch.Tensor,
               ref: torch.Tensor) -> None:
        with torch.autocast(ref.device.type, enabled=False):
            rf = ref.detach().float()
            err = got.detach().float() - rf
            stat = torch.stack([err.abs().amax(), err.square().mean().sqrt(),
                                rf.abs().amax(), rf.square().mean().sqrt()])
        prev = self.stats.get(site)
        self.stats[site] = stat if prev is None else torch.maximum(prev, stat)


@contextlib.contextmanager
def auditing(mode: str = "local"):
    """Within it, every int8 site that runs its static or dynamic form
    also runs its plain conv, records the error into the yielded
    ``Audit`` and returns the plain result ("local") or the int8 one
    ("compound"): the JAX package's CRIS_INT8_AUDIT hook."""
    audit = Audit(mode)
    _calibration.audit = audit
    try:
        yield audit
    finally:
        _calibration.audit = None


def quant_site(site: nn.Module, x: torch.Tensor, plain: Callable,
               static: Callable, dynamic: Optional[Callable] = None):
    """The JAX package's ``_quant_site``: record and run plain while
    calibrating; else the static form with the site's scale, else the
    dynamic form if the site has one, else plain. While ``auditing``,
    a site that ran int8 also runs plain and records the error."""
    cal = getattr(_calibration, "state", None)
    if cal is not None:
        cal.record(site, x)
        return plain()
    if site.act_scale is not None:
        got = static(site.act_scale)
    elif dynamic is not None:
        got = dynamic()
    else:
        return plain()
    audit = getattr(_calibration, "audit", None)
    if audit is None:
        return got
    ref = plain()
    audit.record(site, got, ref)
    return got if audit.mode == "compound" else ref


class QuantConv(nn.Conv2d):
    """``nn.Conv2d`` (the same parameters and keys) that is also an int8
    site of ``family``: "backbone" (the bottlenecks' convs, plain, pooled
    and s2d-pooled), "stem" (the s2d stem's conv2 and conv3), "head" (the
    FPN's and projector's convs) or "upfold" (the upsample folds' cores),
    or None. ``enable_int8`` sets ``quant``; a site runs int8 only on the
    eval model and only where its gate in ``quant`` takes its widths.
    Outputs are in the compute dtype (``compute_dtype``), channels-last in
    memory."""

    def __init__(self, *args, family: Optional[str] = None, **kwargs):
        super().__init__(*args, **kwargs)
        self.family = family
        self.quant: Optional[QuantConfig] = None
        self.register_buffer("act_scale", None, persistent=False)
        self._int8: Dict[str, tuple] = {}

    def site_on(self, family: str, gate: str, width: int) -> bool:
        """Does this conv of ``family`` run int8 here, at min-width
        ``width`` under ``quant``'s threshold ``gate`` (a QuantConfig
        field)?"""
        return (self.quant is not None and not self.training
                and self.family == family
                and width >= getattr(self.quant, gate))

    def _weights(self, form: str, make: Callable):
        """What ``make`` gives for ``form`` (the packed int8 kernel, its
        k_scale and the f32 bias; the four phases' (packed kernel,
        k_scale) pairs at the phase sites), made once and kept until the
        weights change."""
        w, b = self.weight, self.bias
        tag = (w.data_ptr(), w._version, w.device,
               None if b is None else (b.data_ptr(), b._version))
        hit = self._int8.get(form)
        if hit is None or hit[0] != tag:
            with torch.no_grad():
                hit = (tag, make())
            self._int8[form] = hit
        return hit[1]

    def _hwio(self) -> torch.Tensor:
        return self.weight.permute(2, 3, 1, 0)

    def _int8_call(self, x, form, make, stride, pads, s, dt):
        packed, ks, bias = self._weights(form, make)
        y = int8_conv2d_static(x.permute(0, 2, 3, 1), (packed, ks), s, stride,
                               pads, bias, out_dtype=dt)
        return y.permute(0, 3, 1, 2)

    def _quantized(self, kernel, bias):
        return (*quantize_packed(kernel),
                None if bias is None else bias.detach().float())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        k = self.kernel_size[0]
        if not (self.padding == (k // 2, k // 2) and self.site_on(
                self.family if self.family == "head" else "backbone",
                "min_ch", min(self.in_channels, self.out_channels))):
            return super().forward(x)
        dt = compute_dtype(x)
        pads = ((k // 2, k // 2), (k // 2, k // 2))

        def static(s):
            return self._int8_call(
                x, "plain", lambda: self._quantized(self._hwio(), self.bias),
                self.stride[0], pads, s, dt)
        return quant_site(self, x, lambda: super(QuantConv, self).forward(x),
                          static, lambda: static(dynamic_scale(x)))

    def pooled(self, x: torch.Tensor, pool: int) -> torch.Tensor:
        """``avg_pool(pool) -> this 1x1 conv`` as one pool x pool /
        stride-pool conv with taps K / pool^2 (``PooledConv1x1``)."""
        w = (self.weight * (1.0 / pool ** 2)).expand(-1, -1, pool, pool)

        def plain():
            return F.conv2d(x, w, self.bias, pool)
        if not self.site_on("backbone", "pooled_min_ch",
                            min(self.in_channels, self.out_channels)):
            return plain()
        dt = compute_dtype(x)
        return quant_site(self, x, plain, lambda s: self._int8_call(
            x, f"pooled{pool}",
            lambda: self._quantized(w.permute(2, 3, 1, 0), self.bias),
            pool, ((0, 0), (0, 0)), s, dt))

    def s2d_pooled(self, x: torch.Tensor) -> torch.Tensor:
        """``pooled(2)`` of a space-to-depth input (B, 4C, H, W): an exact
        1x1 conv over cells with normal-layout output
        (``S2dPooledConv1x1``)."""
        w = (self.weight * 0.25).repeat(1, 4, 1, 1)

        def plain():
            return F.conv2d(x, w, self.bias)
        if not self.site_on("backbone", "pooled_min_ch",
                            min(4 * self.in_channels, self.out_channels)):
            return plain()
        dt = compute_dtype(x)
        return quant_site(self, x, plain, lambda s: self._int8_call(
            x, "s2d_pooled",
            lambda: self._quantized(w.permute(2, 3, 1, 0), self.bias),
            1, ((0, 0), (0, 0)), s, dt))

    def s2d3x3(self, x: torch.Tensor) -> torch.Tensor:
        """This k3/s1 SAME conv on a space-to-depth-resident input, staying
        s2d (``S2dConv3x3``)."""
        dt = compute_dtype(x)

        def plain():
            return s2d_ops.conv3x3_s2d(x.permute(0, 2, 3, 1), self._hwio(),
                                       self.bias, dt).permute(0, 3, 1, 2)
        if not self.site_on("stem", "min_ch",
                            4 * min(self.in_channels, self.out_channels)):
            return plain()
        return quant_site(self, x, plain, lambda s: self._int8_call(
            x, "s2d3x3", lambda: self._quantized(
                s2d_ops.embed_conv3x3_s2d(self._hwio()),
                None if self.bias is None else self.bias.repeat(4)),
            1, ((1, 1), (1, 1)), s, dt))

    def phase_site(self, xn: torch.Tensor, dt, phase_kernels, pads,
                   plain: Callable, slice_kernel: Optional[Callable] = None):
        """The upsample fold's up-core of NHWC ``xn`` (in ``dt``) through
        four int8 phase convs that write their interleaved positions of
        one (B, 2H, 2W, Co) tensor in ``dt`` (``int8_phase_conv_static``),
        or ``plain()``."""
        def make():
            k = self._hwio()
            if slice_kernel is not None:
                k = slice_kernel(k)
            pk = phase_kernels(k)
            return [quantize_packed(pk[di, dj])
                    for di in (0, 1) for dj in (0, 1)]

        return quant_site(self, xn, plain, lambda s: int8_phase_conv_static(
            xn, self._weights("phase", make), pads, s, out_dtype=dt))


def enable_int8(model: nn.Module, quant: Optional[QuantConfig]) -> nn.Module:
    """Give every ``QuantConv`` whose family ``quant`` takes that config
    (None: no int8 site anywhere). The model must be the BN-folded one."""
    for mod in model.modules():
        if isinstance(mod, QuantConv):
            mod.quant = quant if quant is not None and quant.takes(
                mod.family) else None
    return model


def int8_sites(model: nn.Module) -> Dict[str, QuantConv]:
    """name -> QuantConv of every conv that has a QuantConfig."""
    return {name: mod for name, mod in model.named_modules()
            if isinstance(mod, QuantConv) and mod.quant is not None}
