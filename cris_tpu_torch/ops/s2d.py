"""Space-to-depth (s2d) forms of the low-channel stem convs (counterpart of
cris_tpu/ops/s2d.py).

In the s2d layout each 2x2 pixel cell of an (H, W, C) map becomes one
pixel of an (H/2, W/2, 4C) map, channel (2 * row_phase + col_phase) * C +
c. The stem's convs have exact equivalents there: conv1 (k3, stride 2)
produces the layout directly as a k5 / stride-4 conv, conv2 and conv3
(k3, stride 1) stay s2d-resident as k3 convs over cells with (4C, 4D)
kernels, and layer1_0's pooled 1x1 convs leave the region as exact 1x1
convs over cells (``models.layers.QuantConv.s2d_pooled``).

Layout: the functions take and return NHWC tensors and HWIO kernels, as
the JAX functions do, so the tests hold them against each other as they
are. The model is NCHW and passes NHWC views
(``models.clip_resnet._nhwc`` / ``_nchw``); the convs run ``F.conv2d`` on
the NCHW view of the same memory, so no copy is made around them. The
kernel rearrangements are exact (each tap is copied or zeroed, the pooled
ones scaled by 0.25) and run in the kernel's dtype.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def space_to_depth(x: torch.Tensor) -> torch.Tensor:
    """(B, H, W, C) -> (B, H/2, W/2, 4C); channel = (2*rp + cp)*C + c."""
    b, h, w, c = x.shape
    x = x.reshape(b, h // 2, 2, w // 2, 2, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, h // 2, w // 2, 4 * c)


def depth_to_space(x: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`space_to_depth`."""
    b, h, w, c = x.shape
    x = x.reshape(b, h, w, 2, 2, c // 4).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, 2 * h, 2 * w, c // 4)


def _phase_gather(w: torch.Tensor, offs: np.ndarray, axis: int) -> torch.Tensor:
    """Taps of ``w`` along ``axis`` at original-tap offsets ``offs`` (any
    shape; offset o reads tap o + 1), zero where |o| > 1; the gathered dims
    replace ``axis``."""
    valid = torch.from_numpy((np.abs(offs) <= 1).astype(np.float32))
    idx = torch.from_numpy(np.clip(offs + 1, 0, 2).reshape(-1))
    g = torch.index_select(w, axis, idx.to(w.device))
    g = g.reshape(w.shape[:axis] + offs.shape + w.shape[axis + 1:])
    mask_shape = (1,) * axis + offs.shape + (1,) * (w.dim() - 1 - axis)
    return g * valid.to(w.device, w.dtype).reshape(mask_shape)


def embed_conv3x3_s2d(kernel: torch.Tensor) -> torch.Tensor:
    """(3, 3, C, D) k3/s1 kernel -> its (3, 3, 4C, 4D) s2d-resident form:
    output phase p at cell offset oy reads original row 2*oy + r - p of
    input phase r; taps outside [-1, 1] are zero."""
    c, d = kernel.shape[2], kernel.shape[3]
    oy, r, p = np.arange(-1, 2), np.arange(2), np.arange(2)
    dy = 2 * oy[:, None, None] + r[None, :, None] - p[None, None, :]
    w = _phase_gather(kernel, dy, axis=0)      # (3,2,2, 3, C, D)
    w = _phase_gather(w, dy, axis=3)           # (3,2,2, 3,2,2, C, D)
    # (a, r, p, b, s, q, C, D) -> (a, b, r, s, C, p, q, D)
    w = w.permute(0, 3, 1, 4, 6, 2, 5, 7)
    return w.reshape(3, 3, 4 * c, 4 * d)


def embed_stem_conv1_s2d(kernel: torch.Tensor) -> torch.Tensor:
    """(3, 3, C, D) k3/stride-2 kernel -> the (5, 5, C, 4D) k5/stride-4
    kernel that writes the original output in s2d layout (stride 4,
    padding (1, 0) on each axis, for H, W % 4 == 0)."""
    c, d = kernel.shape[2], kernel.shape[3]
    e, p = np.arange(5), np.arange(2)
    dy = e[:, None] - 1 - 2 * p[None, :]       # (5, 2)
    w = _phase_gather(kernel, dy, axis=0)      # (5,2, 3, C, D)
    w = _phase_gather(w, dy, axis=2)           # (5,2, 5,2, C, D)
    # (e, p, f, q, C, D) -> (e, f, C, p, q, D)
    w = w.permute(0, 2, 4, 1, 3, 5)
    return w.reshape(5, 5, c, 4 * d)


def embed_pool2_conv1x1_s2d(kernel: torch.Tensor) -> torch.Tensor:
    """(1, 1, C, D) kernel of ``avg_pool(2) -> 1x1 conv`` -> the (1, 1,
    4C, D) kernel of the exact 1x1 conv on the s2d-resident input, whose
    output is in normal layout at cell resolution (the region's exit)."""
    c, d = kernel.shape[2], kernel.shape[3]
    return (kernel[0, 0] * 0.25).repeat(4, 1).reshape(1, 1, 4 * c, d)


def embed_conv1x1_s2d(kernel: torch.Tensor) -> torch.Tensor:
    """(1, 1, C, D) -> the (1, 1, 4C, 4D) block-diagonal s2d-resident
    form (each phase maps on its own)."""
    c, d = kernel.shape[2], kernel.shape[3]
    eye = torch.eye(4, dtype=kernel.dtype, device=kernel.device)
    wb = torch.einsum("gh,cd->gchd", eye, kernel[0, 0])
    return wb.reshape(1, 1, 4 * c, 4 * d)


def embed_pool2_conv1x1_s2d_to_s2d(kernel: torch.Tensor) -> torch.Tensor:
    """(1, 1, C, D) kernel of ``avg_pool(2) -> 1x1 conv`` -> the (2, 2, 4C,
    4D) stride-2 VALID kernel from an s2d input to an s2d output one cell
    level down: output phase (p, q) reads window position (p, q) only."""
    c, d = kernel.shape[2], kernel.shape[3]
    out = kernel.new_zeros((2, 2, 4, c, 4, d))
    for pq in range(4):
        out[pq // 2, pq % 2, :, :, pq, :] = kernel[0, 0] * 0.25
    return out.reshape(2, 2, 4 * c, 4 * d)


def conv_nhwc(x: torch.Tensor, kernel: torch.Tensor, bias, stride,
              padding, dtype) -> torch.Tensor:
    """``lax.conv_general_dilated`` in NHWC/HWIO: x and kernel cast to
    ``dtype``, ``padding`` ((top, bottom), (left, right)), bias added in
    ``dtype``; F.conv2d on the NCHW view."""
    (pt, pb), (pl, pr) = padding
    xc = x.to(dtype).permute(0, 3, 1, 2)
    if pt != pb or pl != pr:
        xc = F.pad(xc, (pl, pr, pt, pb))
        pad = 0
    else:
        pad = (pt, pl)
    w = kernel.to(dtype).permute(3, 2, 0, 1)
    with torch.autocast(x.device.type, enabled=False):
        y = F.conv2d(xc, w, None, stride, pad)
        if bias is not None:
            y = y + bias.to(dtype).reshape(1, -1, 1, 1)
    return y.permute(0, 2, 3, 1)


def _bias4(bias):
    return None if bias is None else bias.repeat(4)


def stem_conv1_s2d(x, kernel, bias, dtype) -> torch.Tensor:
    """conv1 (k3/s2, SAME) evaluated directly into s2d layout:
    (B, H, W, C) with H, W % 4 == 0 -> (B, H/4, W/4, 4D)."""
    return conv_nhwc(x, embed_stem_conv1_s2d(kernel), _bias4(bias), 4,
                     ((1, 0), (1, 0)), dtype)


def conv3x3_s2d(x, kernel, bias, dtype) -> torch.Tensor:
    """k3/s1 SAME conv of an s2d-resident tensor, staying s2d."""
    return conv_nhwc(x, embed_conv3x3_s2d(kernel), _bias4(bias), 1,
                     ((1, 1), (1, 1)), dtype)


def conv1x1_s2d(x, kernel, bias, dtype) -> torch.Tensor:
    """1x1 conv of an s2d-resident tensor, staying s2d."""
    return conv_nhwc(x, embed_conv1x1_s2d(kernel), _bias4(bias), 1,
                     ((0, 0), (0, 0)), dtype)


def pool2_conv1x1_s2d_to_s2d(x, kernel, bias, dtype) -> torch.Tensor:
    """avg_pool(2) -> 1x1 conv from an s2d input to an s2d output one cell
    level down ((B, H, W, 4C) -> (B, H/2, W/2, 4D))."""
    return conv_nhwc(x, embed_pool2_conv1x1_s2d_to_s2d(kernel),
                     _bias4(bias), 2, ((0, 0), (0, 0)), dtype)
