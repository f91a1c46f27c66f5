"""Bilinear upsample x2 folded into the conv that follows it, exactly
(counterpart of cris_tpu/ops/upsample_conv.py).

``conv3x3_same(upsample2x(x), K)`` equals one conv of x dilated by 2 with
the (6, 6) kernel ``fold_kernel6(K)`` (the x2 bilinear taps [1, 3, 3, 1]
/ 4 folded in), plus a correction on the outer two output rows and
columns: the dilated core extends the image with zeros where
``upsample2x`` clamps at the edge. ``conv1x1(upsample2x(x), K)`` is the
same with ``fold_kernel4`` and a one-wide ring that is overwritten. The
JAX module's docstring derives both.

The up-core, the conv of x dilated by 2, is one ``F.conv_transpose2d``
with stride 2 (the JAX package's ``lhs_dilation=2`` conv; its kernel
flipped). The int8 sites (``models.layers``) compute it instead as four
ordinary convs over x, one per output phase, with the
``phase_kernels6`` / ``phase_kernels4`` kernels and the ``PHASE_PADS6``
/ ``PHASE_PADS4`` paddings (``ops.quant.int8_phase_conv_static``), as
the JAX package's do: each phase is a plain int8 conv.

Layout: NHWC tensors and HWIO kernels, as the JAX functions. The border
strips are computed in f32 and added to the core in its dtype, as in the
JAX package; autocast is off inside these functions.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

# bilinear phase taps rho[di][tap a][x offset u] of the x2 upsample
_PHASE_RHO = (
    ((0.75, 0.25, 0.0), (0.25, 0.75, 0.0), (0.0, 0.75, 0.25)),  # di = 0
    ((0.25, 0.75, 0.0), (0.0, 0.75, 0.25), (0.0, 0.25, 0.75)),  # di = 1
)
# per-phase padding of the k3 phase convs (both phases span x rows
# i-1..i+1) and of the k2 ones (di = 0 spans i-1..i, di = 1 spans i..i+1)
PHASE_PADS6 = ((1, 1), (1, 1))
PHASE_PADS4 = ((1, 0), (0, 1))


# The folded and phase kernels are summed in f64 and rounded once: each
# tap product with an f32 weight is exact there, and so is the sum of the
# at most four that meet in one entry unless their weights differ by more
# than 2^25 in magnitude, so the kernels come out the same on every
# device (the int8 sites quantise them there).


def fold_kernel6(k3: torch.Tensor) -> torch.Tensor:
    """(3, 3, Ci, Co) -> (6, 6, Ci, Co) folded with the bilinear taps."""
    b = (1.0 / 4.0, 3.0 / 4.0, 3.0 / 4.0, 1.0 / 4.0)
    k3f = k3.double()
    k6 = k3f.new_zeros((6, 6) + tuple(k3.shape[2:]))
    for a in range(4):
        for c in range(4):
            k6[a:a + 3, c:c + 3] += b[a] * b[c] * k3f
    return k6.to(k3.dtype)


def fold_kernel4(k1: torch.Tensor) -> torch.Tensor:
    """(1, 1, Ci, Co) -> (4, 4, Ci, Co) folded with the bilinear taps."""
    b = torch.tensor([0.25, 0.75, 0.75, 0.25], dtype=torch.float64,
                     device=k1.device)
    k4 = torch.einsum("a,c,io->acio", b, b, k1.double()[0, 0])
    return k4.to(k1.dtype)


def phase_kernels6(k3: torch.Tensor) -> torch.Tensor:
    """(3, 3, Ci, Co) -> (2, 2, 3, 3, Ci, Co): phase (di, dj)'s SAME k3
    kernel over x; interleaved, the four convs are the dilated
    ``fold_kernel6`` core, borders included."""
    rho = torch.tensor(_PHASE_RHO, dtype=torch.float64,
                       device=k3.device)  # (2, 3, 3): [d, a, u]
    pk = torch.einsum("dau,ebv,abio->deuvio", rho, rho, k3.double())
    return pk.to(k3.dtype)


def phase_kernels4(k1: torch.Tensor) -> torch.Tensor:
    """(1, 1, Ci, Co) -> (2, 2, 2, 2, Ci, Co) phase kernels of the
    ``fold_kernel4`` core; paddings ``PHASE_PADS4``."""
    t = torch.tensor(((0.25, 0.75), (0.75, 0.25)), dtype=torch.float64,
                     device=k1.device)
    pk = torch.einsum("du,ev,io->deuvio", t, t, k1.double()[0, 0])
    return pk.to(k1.dtype)


def transpose_core(x: torch.Tensor, kfold: torch.Tensor, dtype) -> torch.Tensor:
    """The dilated core ``conv(dilate2(x), kfold, padding k - 2)`` as one
    transposed conv with stride 2 (its kernel is the flipped fold)."""
    k = kfold.shape[0]
    w = kfold.to(dtype).flip(0, 1).permute(2, 3, 0, 1)  # (Ci, Co, k, k)
    with torch.autocast(x.device.type, enabled=False):
        y = F.conv_transpose2d(x.to(dtype).permute(0, 3, 1, 2), w, None, 2,
                               k // 2 - 1)
    return y.permute(0, 2, 3, 1)


def up_core3x3(x, kernel, dtype) -> torch.Tensor:
    """The k3 site's dilated core: the ``fold_kernel6`` transposed conv."""
    return transpose_core(x, fold_kernel6(kernel), dtype)


def up_core1x1(x, kernel, dtype) -> torch.Tensor:
    """The 1x1 site's dilated core: the ``fold_kernel4`` transposed conv."""
    return transpose_core(x, fold_kernel4(kernel), dtype)


def _up1d_zero(v: torch.Tensor) -> torch.Tensor:
    """(B, N, C) -> (B, 2N, C), the transposed-conv x2 upsample (zero
    beyond the ends): 2i = .75 v[i] + .25 v[i-1], 2i+1 = .75 v[i] + .25
    v[i+1]."""
    prev = F.pad(v, (0, 0, 1, 0))[:, :-1]
    nxt = F.pad(v, (0, 0, 0, 1))[:, 1:]
    even = 0.75 * v + 0.25 * prev
    odd = 0.75 * v + 0.25 * nxt
    b, n, c = v.shape
    return torch.stack([even, odd], dim=2).reshape(b, 2 * n, c)


def _up1d_clamped(v: torch.Tensor) -> torch.Tensor:
    """(B, N, C) -> (B, 2N, C), PyTorch's bilinear x2 (edge clamped)."""
    return F.interpolate(v.transpose(1, 2), scale_factor=2, mode="linear",
                         align_corners=False).transpose(1, 2)


def _strip_conv(strip: torch.Tensor, krow: torch.Tensor) -> torch.Tensor:
    """1D 3-tap conv of a (B, L, Ci) strip with (3, Ci, Co), zero-padded."""
    p = F.pad(strip, (0, 0, 1, 1))
    n = strip.shape[1]
    stack = torch.stack([p[:, i:i + n] for i in range(3)], dim=2)
    return torch.einsum("bltc,tcd->bld", stack, krow)


def _strip_conv_valid(strip: torch.Tensor, krow: torch.Tensor) -> torch.Tensor:
    """Valid 3-tap conv: (B, L+2, Ci) x (3, Ci, Co) -> (B, L, Co)."""
    n = strip.shape[1] - 2
    stack = torch.stack([strip[:, i:i + n] for i in range(3)], dim=2)
    return torch.einsum("bltc,tcd->bld", stack, krow)


def apply_border_ring1x1(y: torch.Tensor, x: torch.Tensor,
                         kernel: torch.Tensor) -> torch.Tensor:
    """Overwrite the one-wide output ring of the ``fold_kernel4`` core
    ``y`` with the clamped-edge values, computed in f32. In place on y,
    which is returned."""
    _, h, w, _ = x.shape
    dt = y.dtype
    with torch.autocast(x.device.type, enabled=False):
        xf = x.float()
        kf = kernel.float()[0, 0]
        row_t = torch.einsum("bwc,cd->bwd", _up1d_clamped(xf[:, 0]), kf)
        row_b = torch.einsum("bwc,cd->bwd", _up1d_clamped(xf[:, h - 1]), kf)
        col_l = torch.einsum("bhc,cd->bhd", _up1d_clamped(xf[:, :, 0]), kf)
        col_r = torch.einsum("bhc,cd->bhd", _up1d_clamped(xf[:, :, w - 1]),
                             kf)
        y[:, 0] = row_t.to(dt)
        y[:, 2 * h - 1] = row_b.to(dt)
        y[:, 1:2 * h - 1, 0] = col_l[:, 1:2 * h - 1].to(dt)
        y[:, 1:2 * h - 1, 2 * w - 1] = col_r[:, 1:2 * h - 1].to(dt)
    return y


def apply_border_correction3x3(y: torch.Tensor, x: torch.Tensor,
                               kernel: torch.Tensor) -> torch.Tensor:
    """Add the clamped-edge correction to the ``fold_kernel6`` core ``y``
    (strips in f32, added in y's dtype). In place on y, which is
    returned."""
    _, h, w, _ = x.shape
    dt = y.dtype
    with torch.autocast(x.device.type, enabled=False):
        xf = x.float()
        kf = kernel.float()
        top = 0.25 * _up1d_clamped(xf[:, 0])        # (B, 2W, Ci), U-row 0
        bot = 0.25 * _up1d_clamped(xf[:, h - 1])    # U-row 2H-1
        left = 0.25 * _up1d_zero(xf[:, :, 0])       # (B, 2H, Ci), U-col 0
        right = 0.25 * _up1d_zero(xf[:, :, w - 1])  # U-col 2W-1

        # the core's implicit upsample extends one element past the grid
        # (0.25 x[0] before, 0.25 x[N-1] after, per axis), which the
        # chain's zero padding discards: subtract that ring; its corners
        # belong to the row strips
        def ring_row(row):  # (B, W, Ci) -> (B, 2W+2, Ci)
            up = _up1d_zero(row)
            return 0.25 * torch.cat([0.25 * row[:, :1], up, 0.25 * row[:, -1:]],
                                    dim=1)

        ring_top = ring_row(xf[:, 0])
        ring_bot = ring_row(xf[:, h - 1])
        ring_left = 0.25 * _up1d_zero(xf[:, :, 0])
        ring_right = 0.25 * _up1d_zero(xf[:, :, w - 1])

        corr_top = torch.stack(
            [_strip_conv(top, kf[1]) - _strip_conv_valid(ring_top, kf[0]),
             _strip_conv(top, kf[0])], dim=1)
        corr_bot = torch.stack(
            [_strip_conv(bot, kf[2]),
             _strip_conv(bot, kf[1]) - _strip_conv_valid(ring_bot, kf[2])],
            dim=1)
        corr_left = torch.stack(
            [_strip_conv(left, kf[:, 1]) - _strip_conv(ring_left, kf[:, 0]),
             _strip_conv(left, kf[:, 0])], dim=2)
        corr_right = torch.stack(
            [_strip_conv(right, kf[:, 2]),
             _strip_conv(right, kf[:, 1]) - _strip_conv(ring_right, kf[:, 2])],
            dim=2)
        y[:, 0:2] += corr_top.to(dt)
        y[:, 2 * h - 2:2 * h] += corr_bot.to(dt)
        y[:, :, 0:2] += corr_left.to(dt)
        y[:, :, 2 * w - 2:2 * w] += corr_right.to(dt)
    return y


def upsample2x_conv1x1(x: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """== conv1x1(upsample2x(x), kernel) in x's dtype, NHWC, exactly (no
    bias)."""
    if tuple(kernel.shape[:2]) != (1, 1):
        raise ValueError(f"1x1 kernel required, got {tuple(kernel.shape)}")
    y = up_core1x1(x, kernel.to(x.dtype), x.dtype)
    return apply_border_ring1x1(y, x, kernel)


def upsample2x_conv3x3(x: torch.Tensor, kernel: torch.Tensor,
                       bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """== conv3x3_same(upsample2x(x), kernel) [+ bias] in x's dtype, NHWC,
    exactly."""
    if tuple(kernel.shape[:2]) != (3, 3):
        raise ValueError(f"3x3 kernel required, got {tuple(kernel.shape)}")
    y = up_core3x3(x, kernel.to(x.dtype), x.dtype)
    y = apply_border_correction3x3(y, x, kernel)
    if bias is not None:
        with torch.autocast(x.device.type, enabled=False):
            y = y + bias.to(y.dtype)
    return y
