"""K6: LayerNorm over the last axis, forward and backward, in CUDA for
Hopper.

Replaces the TPU kernels of ``layer_norm`` (cris_tpu/ops/pallas/
layernorm.py:77): the forward ``pallas_call`` at :92 and the backward one
at :123. The CUDA source is ``cris_tpu_torch/csrc/layernorm.cu``; its
header says how it is laid out and what bounds it (device memory: each
direction reads its rows once).

``layer_norm`` is a ``torch.autograd.Function`` on the CPU and on the
card. It saves (x, scale) only, as the JAX rule does (``_fwd_rule``,
:110-111). Its forward takes ``layer_norm_plain`` for a tensor on the CPU
and launches the forward kernel for a CUDA tensor (or raises); its
backward is ``layer_norm_backward``, which likewise takes
``layer_norm_backward_plain`` or launches the backward kernel. Neither
falls back. ``layer_norm.launches`` and ``layer_norm_backward.launches``
count the two kernels' launches.

The backward returns dscale and dbias as per-block partial sums, (nb, C)
in f32 with block b summing the rows of ``backward_blocks``' chunk b; the
wrapper sums them with ``torch.sum``, as the JAX wrapper sums its (nb, 8,
C) partials (:149). The JAX function's ``interpret`` argument is Pallas's
CPU mode; the port has none, so it is dropped.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .attention import DTYPE_CODES
from .build import check, load_library

MAX_CHANNELS = 8192  # a row in registers: 16 values a thread, 16 warps
BWD_MAX_BLOCKS = 264  # two a streaming multiprocessor on the H100
BWD_MIN_ROWS = 16  # rows a backward block sums at least


def supports(c: int) -> bool:
    """The JAX gate (``supports``, layernorm.py:155: C a multiple of 128)
    and the kernel's register-held row (C at most 8192)."""
    return c % 128 == 0 and c <= MAX_CHANNELS


def backward_blocks(rows: int):
    """(nb, chunk): the backward's blocks and the rows each sums (the last
    block may sum fewer)."""
    chunk = max(BWD_MIN_ROWS, -(-rows // BWD_MAX_BLOCKS))
    return -(-rows // chunk), chunk


def _stats(x2, eps):
    """xhat and rstd of (n, C) f32 rows, as ``_fwd_kernel``:41-45."""
    mean = x2.mean(dim=-1, keepdim=True)
    xc = x2 - mean
    rstd = torch.rsqrt((xc * xc).mean(dim=-1, keepdim=True) + eps)
    return xc * rstd, rstd


def layer_norm_plain(x, scale, bias, eps=1e-5):
    """The forward in plain PyTorch, ``_fwd_kernel``'s math: f32 mean, the
    centred biased variance, eps inside the rsqrt, the f32 affine, rounded
    once to x's dtype."""
    with torch.autocast(x.device.type, enabled=False):
        xhat, _ = _stats(x.float(), eps)
        y = xhat * scale.float() + bias.float()
    return y.to(x.dtype)


def layer_norm_backward_plain(x, scale, g, eps=1e-5):
    """The backward in plain PyTorch, ``_bwd_kernel``'s math: returns dx in
    x's dtype and the (nb, C) f32 partial sums of dscale and dbias, block b
    summing rows [b * chunk, (b + 1) * chunk) of ``backward_blocks``."""
    c = x.shape[-1]
    with torch.autocast(x.device.type, enabled=False):
        x2 = x.reshape(-1, c).float()
        g2 = g.reshape(-1, c).float()
        xhat, rstd = _stats(x2, eps)
        gs = g2 * scale.float()
        dx = rstd * (gs - gs.mean(dim=-1, keepdim=True)
                     - xhat * (gs * xhat).mean(dim=-1, keepdim=True))
        nb, chunk = backward_blocks(x2.shape[0])
        pad = (0, 0, 0, nb * chunk - x2.shape[0])
        ds = F.pad(g2 * xhat, pad).view(nb, chunk, c).sum(dim=1)
        db = F.pad(g2, pad).view(nb, chunk, c).sum(dim=1)
    return dx.to(x.dtype).reshape(x.shape), ds, db


def _rows(x, what):
    """x as (n, C) rows for the kernels: contiguous and 16-byte aligned."""
    if x.device.type != "cuda":
        raise ValueError(f"layer_norm: no kernel for {x.device}")
    if x.dtype not in DTYPE_CODES:
        raise ValueError(f"layer_norm: dtype {x.dtype}; need float32 or "
                         "bfloat16")
    c = x.shape[-1]
    if not supports(c):
        raise ValueError(f"layer_norm: C = {c}; the kernel takes multiples "
                         f"of 128 up to {MAX_CHANNELS}")
    x2 = x.reshape(-1, c).contiguous()
    if x2.data_ptr() % 16:
        raise ValueError(f"layer_norm: {what} is not 16-byte aligned")
    return x2


def _affine(t, x):
    if t.shape != (x.shape[-1],) or t.device != x.device:
        raise ValueError(f"layer_norm: a scale or bias of {tuple(t.shape)} "
                         f"on {t.device} for x {tuple(x.shape)} on {x.device}")
    return _rows(t.float(), "scale or bias")


def _launch_fwd(x, scale, bias, eps):
    x2 = _rows(x, "x")
    scale, bias = _affine(scale, x), _affine(bias, x)
    y = torch.empty_like(x2)
    lib = load_library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.cris_layer_norm_fwd(
            x2.data_ptr(), scale.data_ptr(), bias.data_ptr(), y.data_ptr(),
            x2.shape[0], x2.shape[1], DTYPE_CODES[x.dtype], float(eps), stream)
    check(lib, err, "layer_norm")
    layer_norm.launches += 1
    return y.reshape(x.shape)


def _launch_bwd(x, scale, g, eps):
    x2, g2 = _rows(x, "x"), _rows(g.to(x.dtype), "g")
    if g2.shape != x2.shape:
        raise ValueError(f"layer_norm: g {tuple(g.shape)} != x {tuple(x.shape)}")
    scale = _affine(scale, x)
    rows, c = x2.shape
    nb, chunk = backward_blocks(rows)
    dx = torch.empty_like(x2)
    parts = torch.empty(2, nb, c, dtype=torch.float32, device=x.device)
    lib = load_library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.cris_layer_norm_bwd(
            x2.data_ptr(), scale.data_ptr(), g2.data_ptr(), dx.data_ptr(),
            parts[0].data_ptr(), parts[1].data_ptr(), rows, c, nb, chunk,
            DTYPE_CODES[x.dtype], float(eps), stream)
    check(lib, err, "layer_norm_backward")
    layer_norm_backward.launches += 1
    return dx.reshape(x.shape), parts[0], parts[1]


def layer_norm_backward(x, scale, g, eps=1e-5):
    """(dx, dscale, dbias) of ``layer_norm`` for the output gradient g:
    dx in x's dtype, dscale and dbias in f32, summed from the per-block
    partials."""
    if x.device.type == "cpu":
        dx, ds, db = layer_norm_backward_plain(x, scale, g, eps)
    else:
        dx, ds, db = _launch_bwd(x, scale, g, eps)
    return dx, torch.sum(ds, dim=0), torch.sum(db, dim=0)


layer_norm_backward.launches = 0


class _LayerNorm(torch.autograd.Function):
    """K6's forward with its backward; scale and bias come in f32."""

    @staticmethod
    def forward(ctx, x, scale, bias, eps):
        ctx.eps = eps
        ctx.save_for_backward(x, scale)
        if x.device.type == "cpu":
            return layer_norm_plain(x, scale, bias, eps)
        return _launch_fwd(x, scale, bias, eps)

    @staticmethod
    def backward(ctx, g):
        x, scale = ctx.saved_tensors
        return (*layer_norm_backward(x, scale, g, ctx.eps), None)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the last axis of x (..., C) with f32 statistics.

    scale and bias (C,) are cast to f32 (their gradients flow back through
    the cast); the output is in x's dtype (float32 or bfloat16 on the card;
    C a multiple of 128 up to 8192 there, see ``supports``).
    Differentiable in x, scale and bias."""
    return _LayerNorm.apply(x, scale.float(), bias.float(), eps)


layer_norm.launches = 0
