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

The backward returns dx and the finished dscale and dbias, as the JAX rule
does (``_bwd_rule``, :149), from one cooperative launch. Its kernel walks
the rows in tiles of R rows on a persistent grid, block b taking tiles b,
b + grid, ...; ``backward_partition`` picks R, the ring's stages and the
grid from (rows, C, dtype, SMs), ``backward_fused`` says which schedule
the kernel runs, and the kernel sums the grid's partial rows itself, in a
fixed order: the same bits on every call. The JAX function's
``interpret`` argument is Pallas's CPU mode; the port has none, so it is
dropped.
"""

from __future__ import annotations

import functools

import torch

from .attention import DTYPE_CODES
from .build import check, load_library

MAX_CHANNELS = 8192  # the forward's row in registers: 16 values a thread
# The backward's partition (csrc/layernorm.cu): a stage holds a tile's x
# and g, about BWD_STAGE_BYTES, or one row where a row is larger; the ring
# holds up to BWD_STAGES stages within BWD_RING_BYTES of shared memory.
BWD_STAGE_BYTES = 32 * 1024
BWD_STAGES = 4
BWD_RING_BYTES = 200 * 1024
# and its schedule: 8 row warps and 8 sweep warps, or, at C <= 512 with
# tiles of 8 rows or more, 16 row warps that sum dscale and dbias
BWD_ROW_WARPS = 8
BWD_FUSED_MAX_C = 512


def supports(c: int) -> bool:
    """The JAX gate (``supports``, layernorm.py:155: C a multiple of 128)
    and the kernels' widths (C at most 8192)."""
    return c % 128 == 0 and c <= MAX_CHANNELS


def backward_partition(rows: int, c: int, itemsize: int, sms: int):
    """(R, stages, grid) of the backward kernel for rows x C values of
    itemsize bytes on a card of sms SMs: tiles of R contiguous rows, the
    ring's stages, and min(sms, tiles) blocks, block b walking tiles b, b +
    grid, ... The busiest block walks as few tiles as stages of at most
    BWD_STAGE_BYTES (or one row) allow, and R is the smallest tile that
    keeps that count, so that the blocks' rows differ by at most a tile."""
    row_bytes = 2 * c * itemsize  # a row of x and of g
    most = max(1, BWD_STAGE_BYTES // row_bytes)
    walk = -(-rows // (sms * most))  # tiles of the busiest block
    r = -(-rows // (sms * walk))
    grid = min(sms, -(-rows // r))
    stages = min(BWD_STAGES, BWD_RING_BYTES // (r * row_bytes))
    return r, stages, grid


def backward_fused(c: int, r: int) -> bool:
    """Whether the backward kernel runs its fused schedule at width C and
    tiles of R rows: all 16 consumer warps take rows and sum dscale and
    dbias themselves, in place of 8 row warps and a column sweep."""
    return c <= BWD_FUSED_MAX_C and r >= BWD_ROW_WARPS


@functools.lru_cache(maxsize=None)
def _sms(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


# the backward kernel's meeting counters, one a (device, stream, grid):
# the blocks of each call add one each, so that a counter stays a multiple
# of its grid between calls; calls on two streams share nothing
_syncs: dict = {}


def _sync(device, stream: int, grid: int) -> torch.Tensor:
    key = (device.index, stream, grid)
    if key not in _syncs:
        _syncs[key] = torch.zeros(1, dtype=torch.int64, device=device)
    return _syncs[key]


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
    x's dtype and dscale and dbias, f32 sums over every row."""
    c = x.shape[-1]
    with torch.autocast(x.device.type, enabled=False):
        x2 = x.reshape(-1, c).float()
        g2 = g.reshape(-1, c).float()
        xhat, rstd = _stats(x2, eps)
        gs = g2 * scale.float()
        dx = rstd * (gs - gs.mean(dim=-1, keepdim=True)
                     - xhat * (gs * xhat).mean(dim=-1, keepdim=True))
        ds = (g2 * xhat).sum(dim=0)
        db = g2.sum(dim=0)
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
    sms = _sms(x.device)
    r, stages, grid = backward_partition(rows, c, x2.element_size(), sms)
    dx = torch.empty_like(x2)
    sums = torch.empty(2, c, dtype=torch.float32, device=x.device)
    part = torch.empty(2, grid, c, dtype=torch.float32, device=x.device)
    lib = load_library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.cris_layer_norm_bwd(
            x2.data_ptr(), scale.data_ptr(), g2.data_ptr(), dx.data_ptr(),
            sums.data_ptr(), part.data_ptr(),
            _sync(x.device, stream, grid).data_ptr(), rows, c, r, stages, grid,
            DTYPE_CODES[x.dtype], float(eps), stream)
    check(lib, err, "layer_norm_backward")
    layer_norm_backward.launches += 1
    return dx.reshape(x.shape), sums[0], sums[1]


def layer_norm_backward(x, scale, g, eps=1e-5):
    """(dx, dscale, dbias) of ``layer_norm`` for the output gradient g:
    dx in x's dtype, dscale and dbias finished f32 sums over the rows."""
    if x.device.type == "cpu":
        return layer_norm_backward_plain(x, scale, g, eps)
    return _launch_bwd(x, scale, g, eps)


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
