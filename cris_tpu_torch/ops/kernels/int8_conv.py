"""K8: the int8 implicit-GEMM convolution of the int8 serving sites, and
its quantise pass, in CUDA for Hopper.

Replaces no Pallas kernel: it is the counterpart of the int8
``lax.conv_general_dilated`` that cris_tpu/ops/quant.py runs through XLA
(``int8_conv2d_static`` :64, ``int8_phase_conv_static`` :101,
``int8_conv2d`` :136); PyTorch has no int8 convolution on CUDA. The
CUDA source is ``cris_tpu_torch/csrc/int8_conv.cu``; its header says how
it is laid out and what bounds it.

    xq  = clip(round_half_even(x / s), -127, 127)   (x float; int8 as is)
    acc = conv(xq, wq) in int32, stride and (asymmetric) zero padding
    y   = float(acc) * (s * k_scale) [+ bias] [relu], in out_dtype

Two kernels, each with its launch count:

- ``int8_quantize(x, s)``: NHWC ``x`` (any strides: the model passes NHWC
  views of its NCHW tensors) in f32, bf16 or int8 -> an ``Int8Act``, a
  contiguous (B, H, W, Cp) int8 tensor with Cp = C rounded up to 64 and
  zeros in the padding. A site quantises once; the four phase convs of
  an upsample fold share one.
- ``int8_conv``: the GEMM. ``x`` is an ``Int8Act`` or a float / int8
  NHWC tensor (quantised first, one ``int8_quantize``); ``wq`` the HWIO
  int8 kernel (the JAX layout) or its ``PackedInt8`` form, K-major (Co,
  kh * kw * Cp), which the sites make once (``pack_int8_weights``). The
  per-tensor scale ``s`` is a one-element f32 tensor on x's device,
  ``k_scale`` per output channel f32, ``bias`` optional f32. It writes
  (B, Ho, Wo, Co) in ``out_dtype``, into ``out`` when given (any strides:
  the phase convs write their interleaved positions).

For tensors on the CPU both take their plain versions
(``int8_quantize_plain``; ``int8_conv_plain`` for an HWIO kernel on a
tensor, ``int8_conv_packed_plain`` otherwise). For CUDA tensors they
launch their kernels or raise, for a shape K8 does not take too (kernels
1 to 3 a side, stride 1 or 2, each padding below the kernel's size).
``int8_plan`` chooses the GEMM's tile, loader, split-K and grid.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple, Union

import torch
import torch.nn.functional as F

from .build import check, load_library

IN_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
OUT_CODES = {torch.float32: 0, torch.bfloat16: 1}
Pads = Tuple[Tuple[int, int], Tuple[int, int]]

# the GEMM's output tile: 256 or 128 rows (int8_conv.cu Ring::kBM) by 128
# channels (kBN), and its K step, 64 channels (kBK); the SMs of an H100
# SXM for a plan made off the card
TILE_ROWS, TILE_N, K_BLOCK = (256, 128), 128, 64
H100_SMS = 132
# int8_plan's cost model (us on an H100 SXM, fitted to chip_smoke.py
# phase 18(a), which times each R50 site's plan against both tile
# heights and splits 1, 2, 4 and 8 at the B 16, B 8 and B 1 device
# batches): a 64-deep k-block of a tile of each height, a tile's
# epilogue, a split launch's finishing pass, and the rate at which its
# int32 slabs are written and read back. It splits K only below B 16,
# where few tiles leave SMs idle
KBLOCK_US = {256: 0.5, 128: 0.33}
TILE_US = {256: 2.0, 128: 1.0}
SPLIT_US, SLAB_BYTES_PER_US = 4.0, 2e6
MAX_SPLIT, MIN_SPLIT_BLOCKS = 8, 4


class Int8Act(NamedTuple):
    """A quantised activation: ``q`` (B, H, W, Cp) int8 contiguous, the
    first ``c`` channels real and the rest zero."""
    q: torch.Tensor
    c: int


class PackedInt8(NamedTuple):
    """An HWIO int8 kernel packed K-major: ``w`` (Co, kh * kw * Cp) int8
    contiguous, k = (ky * kw + kx) * Cp + ci, zeros in the padding
    channels."""
    w: torch.Tensor
    kh: int
    kw: int
    c: int

    @property
    def cp(self) -> int:
        return self.w.shape[1] // (self.kh * self.kw)

    @property
    def co(self) -> int:
        return self.w.shape[0]


def int8_cp(c: int) -> int:
    """C rounded up to the GEMM's smallest K block (64)."""
    return -(-c // 64) * 64


def pack_int8_weights(wq: torch.Tensor) -> PackedInt8:
    """The HWIO int8 kernel ``wq`` as ``PackedInt8`` (plain PyTorch, on
    wq's device; the sites pack once per weight change)."""
    kh, kw, c, co = wq.shape
    cp = int8_cp(c)
    w = F.pad(wq.permute(3, 0, 1, 2), (0, cp - c)).reshape(co, kh * kw * cp)
    return PackedInt8(w.contiguous(), kh, kw, c)


def quantize_static(x: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """clip(round(x / s), -127, 127) as int8: an f32 division (not a
    multiply by 1 / s) and round half to even, as the JAX package."""
    with torch.autocast(x.device.type, enabled=False):
        return torch.clamp(torch.round(x.float() / s.float()),
                           -127, 127).to(torch.int8)


def int8_quantize_plain(x: torch.Tensor, s: torch.Tensor) -> Int8Act:
    """``int8_quantize`` in plain PyTorch: ``quantize_static`` (int8 x as
    it is), the channels padded with zeros to Cp, contiguous."""
    c = x.shape[3]
    xq = x if x.dtype == torch.int8 else quantize_static(
        x, s.reshape(()))
    return Int8Act(F.pad(xq, (0, int8_cp(c) - c)).contiguous(), c)


def int8_quantize(x: torch.Tensor, s: torch.Tensor) -> Int8Act:
    """NHWC ``x`` quantised with the one-element f32 scale ``s`` into a
    contiguous (B, H, W, Cp) int8 tensor, Cp = C rounded up to 64, zeros
    past C."""
    if x.device.type == "cpu":
        return int8_quantize_plain(x, s)
    if x.dim() != 4 or x.dtype not in IN_CODES:
        raise ValueError(f"int8_quantize: x must be NHWC f32, bf16 or int8, "
                         f"got {tuple(x.shape)} {x.dtype}")
    b, h, w, c = x.shape
    cp = int8_cp(c)
    s = _scale(s, x.device, "int8_quantize")
    q = torch.empty((b, h, w, cp), dtype=torch.int8, device=x.device)
    lib = load_library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.cris_int8_quantize(x.data_ptr(), s.data_ptr(), q.data_ptr(),
                                     b, h, w, c, cp, IN_CODES[x.dtype],
                                     *x.stride(), stream)
    check(lib, err, "int8_quantize")
    int8_quantize.launches += 1
    return Int8Act(q, c)


int8_quantize.launches = 0


def out_shape(x_shape, w_shape, stride: int, padding: Pads):
    b, h, w, _ = x_shape
    kh, kw, _, co = w_shape
    (pt, pb), (pl, pr) = padding
    return (b, (h + pt + pb - kh) // stride + 1,
            (w + pl + pr - kw) // stride + 1, co)


@functools.lru_cache(maxsize=None)
def _plan(x_shape, w_shape, stride: int, padding: Pads, sms: int) -> dict:
    return int8_plan(x_shape, w_shape, stride, padding, sms)


def int8_plan(x_shape, w_shape, stride: int, padding: Pads,
              sms: int = H100_SMS, split: Optional[int] = None,
              bm: Optional[int] = None) -> dict:
    """The GEMM's plan for NHWC input ``x_shape`` and an HWIO kernel of
    ``w_shape``: tile rows ``bm`` (256 or 128) and ring ``stages`` (K
    blocks of 64 channels); the A ``loader``, "linear" at the 1x1
    stride-1 unpadded sites (A is the (M, Cp) matrix, a tile bm
    consecutive pixels) and "boxes" elsewhere (a tile ``rows`` output
    rows of one image by a ``wseg``-pixel stretch, one TMA box a tap and
    64 channels; ``groups`` tiles down an image, ``segs`` across it);
    ``split`` (K split into that many parts, summed exactly in int32)
    and the persistent ``grid`` over ``units`` = tiles x split. Tile and
    split minimise the model's time (``cost_us``):
    the grid's rounds of units times (k-blocks a unit + a tile's
    epilogue), plus, split, the finishing pass and the int32 slabs'
    bytes; each part keeps MIN_SPLIT_BLOCKS k-blocks. ``split`` and
    ``bm`` force one (for timing it)."""
    b, ho, wo, co = out_shape(x_shape, w_shape, stride, padding)
    kh, kw, c, _ = w_shape
    cp = int8_cp(c)
    m = b * ho * wo
    tiles_n = -(-co // TILE_N)
    kblocks = kh * kw * cp // K_BLOCK
    linear = (kh == kw == 1 and stride == 1
              and tuple(map(tuple, padding)) == ((0, 0), (0, 0)))

    def shape(rows):
        """(tiles, wseg, rows a tile, tiles down an image, across it)"""
        if linear:
            return -(-m // rows) * tiles_n, 0, 0, 0, 0
        wseg = min(wo, rows, 256 // stride)
        per_tile = min(rows // wseg, ho, 256 // stride)
        groups, segs = -(-ho // per_tile), -(-wo // wseg)
        return b * groups * segs * tiles_n, wseg, per_tile, groups, segs

    def cost_us(rows, parts):
        units = shape(rows)[0] * parts
        rounds = -(-units // min(units, sms))
        us = rounds * (-(-kblocks // parts) * KBLOCK_US[rows]
                       + TILE_US[rows])
        if parts > 1:
            us += SPLIT_US + parts * m * co * 8 / SLAB_BYTES_PER_US
        return us

    if split is not None and not 1 <= split <= kblocks:
        raise ValueError(f"int8_plan: split {split} of {kblocks} k-blocks")
    splits = [split] if split else [1] + [
        s for s in range(2, MAX_SPLIT + 1) if kblocks // s >= MIN_SPLIT_BLOCKS]
    bm, split = min(((r, s) for r in ([bm] if bm else TILE_ROWS)
                     for s in splits),
                    key=lambda rs: (cost_us(*rs), rs[1], -rs[0]))
    tiles, wseg, rows, groups, segs = shape(bm)
    units = tiles * split
    return {"bm": bm, "cp": cp, "stages": 6 if bm == 256 else 8,
            "loader": "linear" if linear else "boxes", "wseg": wseg,
            "rows": rows, "groups": groups, "segs": segs, "split": split,
            "grid": min(units, sms), "units": units, "tiles": tiles,
            "tiles_n": tiles_n, "kblocks": kblocks, "m": m, "n": co,
            "k": kh * kw * cp, "out": (b, ho, wo),
            "cost_us": cost_us(bm, split)}


def _epilogue(acc, k_scale, s, bias, relu, out_dtype, out):
    """float(acc) * (s * k_scale) [+ bias] [relu] in f32, NHWC acc."""
    acc = acc.permute(0, 3, 1, 2)
    with torch.autocast(acc.device.type, enabled=False):
        y = acc.float() * (s * k_scale.float()).reshape(1, -1, 1, 1)
        if bias is not None:
            y = y + bias.float().reshape(1, -1, 1, 1)
        if relu:
            y = torch.relu(y)
        y = y.permute(0, 2, 3, 1).to(out_dtype)
    if out is None:
        return y
    out.copy_(y)
    return out


def int8_conv_plain(x, wq, k_scale, act_scale, bias=None, stride: int = 1,
                    padding: Pads = ((0, 0), (0, 0)), relu: bool = False,
                    out_dtype: Optional[torch.dtype] = None, out=None):
    """K8's function in plain PyTorch for NHWC ``x`` and an HWIO ``wq``:
    the int32 accumulator exactly, as an f64 conv of the int8 values (every
    partial sum is below 2^53), then K8's epilogue in f32: float(acc) *
    (s * k_scale) [+ bias] [relu]."""
    out_dtype = out_dtype or _default_out(x)
    s = act_scale.reshape(()).float()
    xq = x if x.dtype == torch.int8 else quantize_static(x, s)
    return _epilogue(int8_accumulate(xq, wq, stride, padding), k_scale, s,
                     bias, relu, out_dtype, out)


def int8_conv_packed_plain(xq: Int8Act, packed: PackedInt8, k_scale,
                           act_scale, bias=None, stride: int = 1,
                           padding: Pads = ((0, 0), (0, 0)),
                           relu: bool = False,
                           out_dtype: Optional[torch.dtype] = None, out=None):
    """K8's GEMM in plain PyTorch on its own operands: an f64 implicit GEMM
    of the padded int8 activation against the packed weights, tap by tap
    (exact: every partial sum is below 2^53), then the f32 epilogue."""
    (pt, pb), (pl, pr) = padding
    kh, kw, cp = packed.kh, packed.kw, packed.cp
    b, h, w, _ = xq.q.shape
    _, ho, wo, co = out_shape(xq.q.shape, (kh, kw, cp, packed.co), stride,
                              padding)
    with torch.autocast(xq.q.device.type, enabled=False):
        xp = F.pad(xq.q.double(), (0, 0, pl, pr, pt, pb))
        wk = packed.w.double().reshape(co, kh * kw, cp)
        acc = torch.zeros((b, ho, wo, co), dtype=torch.float64,
                          device=xq.q.device)
        for tap in range(kh * kw):
            ky, kx = divmod(tap, kw)
            patch = xp[:, ky:ky + stride * (ho - 1) + 1:stride,
                       kx:kx + stride * (wo - 1) + 1:stride]
            acc += patch @ wk[:, tap].t()
    s = act_scale.reshape(()).float()
    return _epilogue(acc, k_scale, s, bias, relu, out_dtype or torch.float32,
                     out)


def int8_accumulate(xq: torch.Tensor, wq: torch.Tensor, stride: int,
                    padding: Pads) -> torch.Tensor:
    """The int32 accumulator of NHWC int8 ``xq`` and HWIO int8 ``wq``, held
    exactly in f64, NHWC."""
    (pt, pb), (pl, pr) = padding
    with torch.autocast(xq.device.type, enabled=False):
        xd = F.pad(xq.double().permute(0, 3, 1, 2), (pl, pr, pt, pb))
        acc = F.conv2d(xd, wq.double().permute(3, 2, 0, 1), None, stride)
    return acc.permute(0, 2, 3, 1)


def _default_out(x):
    if isinstance(x, Int8Act):
        return torch.float32
    return x.dtype if x.dtype in OUT_CODES else torch.float32


Act = Union[torch.Tensor, Int8Act]
Kernel = Union[torch.Tensor, PackedInt8]


def int8_conv(x: Act, wq: Kernel, k_scale: torch.Tensor,
              act_scale: torch.Tensor, bias: Optional[torch.Tensor] = None,
              stride: int = 1, padding: Pads = ((0, 0), (0, 0)),
              relu: bool = False, out_dtype: Optional[torch.dtype] = None,
              out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The int8 conv of NHWC ``x`` (a tensor or an ``Int8Act``) with the
    int8 kernel ``wq`` (HWIO or ``PackedInt8``; see the module docstring);
    returns (B, Ho, Wo, Co) in ``out_dtype`` (x's float dtype, f32 for
    int8 or quantised x, by default)."""
    out_dtype = out_dtype or _default_out(x)
    device = (x.q if isinstance(x, Int8Act) else x).device
    if device.type == "cpu":
        if torch.is_tensor(x) and torch.is_tensor(wq):
            return int8_conv_plain(x, wq, k_scale, act_scale, bias, stride,
                                   padding, relu, out_dtype, out)
        packed = wq if isinstance(wq, PackedInt8) else pack_int8_weights(wq)
        if torch.is_tensor(x):
            x = int8_quantize_plain(x, act_scale)
        return int8_conv_packed_plain(x, packed, k_scale, act_scale, bias,
                                      stride, padding, relu, out_dtype, out)
    packed = wq if isinstance(wq, PackedInt8) else pack_int8_weights(wq)
    if torch.is_tensor(x):
        x = int8_quantize(x, act_scale)
    return _launch(x, packed, k_scale, act_scale, bias, stride, padding, relu,
                   out_dtype, out)


int8_conv.launches = 0


def supports(kh: int, kw: int, stride: int, padding: Pads) -> bool:
    (pt, pb), (pl, pr) = padding
    return (1 <= kh <= 3 and 1 <= kw <= 3 and stride in (1, 2)
            and all(0 <= p < kh for p in (pt, pb))
            and all(0 <= p < kw for p in (pl, pr)))


def _vec(t, n, what, device):
    if t.shape != (n,) or t.dtype != torch.float32 or t.device != device:
        raise ValueError(f"int8_conv: {what} must be ({n},) float32 on "
                         f"{device}, got {tuple(t.shape)} {t.dtype} on "
                         f"{t.device}")
    return t.contiguous()


def _scale(s, device, what):
    s = s.reshape(-1)
    if s.numel() != 1 or s.dtype != torch.float32 or s.device != device:
        raise ValueError(f"{what}: act_scale must be one float32 on {device}")
    return s


@functools.lru_cache(maxsize=None)
def _sms(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _launch(xq: Int8Act, packed: PackedInt8, k_scale, act_scale, bias,
            stride, padding, relu, out_dtype, out):
    q = xq.q
    if q.device.type != "cuda":
        raise ValueError(f"int8_conv: no kernel for {q.device}")
    if (q.dim() != 4 or q.dtype != torch.int8 or not q.is_contiguous()
            or q.data_ptr() % 16):
        raise ValueError(f"int8_conv: the quantised x must be a contiguous "
                         f"16-byte aligned (B, H, W, Cp) int8 tensor, got "
                         f"{tuple(q.shape)} {q.dtype}")
    w = packed.w
    kh, kw, cp, co = packed.kh, packed.kw, packed.cp, packed.co
    if (w.dtype != torch.int8 or not w.is_contiguous() or w.data_ptr() % 16
            or w.device != q.device or xq.c != packed.c
            or q.shape[3] != cp):
        raise ValueError(f"int8_conv: the packed kernel {tuple(w.shape)} "
                         f"{w.dtype} ({packed.c} channels padded to {cp}) "
                         f"does not fit the quantised x {tuple(q.shape)} "
                         f"({xq.c} channels)")
    if not supports(kh, kw, stride, padding):
        raise ValueError(f"int8_conv: K8 takes kernels 1 to 3 a side, stride "
                         f"1 or 2 and paddings below the kernel; got {kh}x{kw}"
                         f" stride {stride} padding {padding}")
    if out_dtype not in OUT_CODES:
        raise ValueError(f"int8_conv: out_dtype {out_dtype}")
    shape = out_shape(q.shape, (kh, kw, cp, co), stride, padding)
    if out is None:
        out = torch.empty(shape, dtype=out_dtype, device=q.device)
    elif (tuple(out.shape) != shape or out.dtype != out_dtype
          or out.device != q.device):
        raise ValueError(f"int8_conv: out {tuple(out.shape)} {out.dtype}, "
                         f"need {shape} {out_dtype}")
    k_scale = _vec(k_scale, co, "k_scale", q.device)
    if bias is not None:
        bias = _vec(bias, co, "bias", q.device)
    s = _scale(act_scale, q.device, "int8_conv")
    plan = _plan((*q.shape[:3], packed.c), (kh, kw, packed.c, co), stride,
                 tuple(map(tuple, padding)), _sms(q.device))
    ws = (torch.empty(plan["split"] * plan["m"] * co, dtype=torch.int32,
                      device=q.device) if plan["split"] > 1 else None)
    lib = load_library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.cris_int8_conv(
            q.data_ptr(), w.data_ptr(), k_scale.data_ptr(), s.data_ptr(),
            0 if bias is None else bias.data_ptr(), out.data_ptr(),
            0 if ws is None else ws.data_ptr(),
            q.shape[0], q.shape[1], q.shape[2], cp, shape[1], shape[2], co,
            kh, kw, stride, padding[0][0], padding[1][0],
            OUT_CODES[out_dtype], int(relu), plan["bm"], plan["wseg"],
            plan["rows"], plan["split"], plan["grid"],
            *out.stride(), stream)
    check(lib, err, "int8_conv")
    int8_conv.launches += 1
    return out
