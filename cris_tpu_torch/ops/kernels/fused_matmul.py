"""K4: the fused channel matmul, [relu](x @ w + bias [+ residual]), in CUDA
for Hopper.

Replaces the TPU kernel ``fused_matmul`` (cris_tpu/ops/pallas/
fused_matmul.py:48, ``pallas_call`` at :81 with a residual and :90
without) and its 1x1-convolution form ``conv1x1_fused`` (:101). The CUDA
source is ``cris_tpu_torch/csrc/fused_matmul.cu``, two kernels picked
before each launch by ``fused_matmul_route``:

- ``"wgmma"``: bf16 x and w that TMA can address (unit stride along x's
  K and along w's N or K, 16-byte aligned bases, other strides multiples
  of 16 bytes): TMA-fed tiles in a 3-stage ring, wgmma with f32
  accumulators in registers (``csrc/gemm_sm90.cuh``), the epilogue from
  the staged accumulators. Both layouts of w take it: a contiguous (K, N)
  and the K-major ``weight.t()`` of an ``nn.Linear``. One tile per block,
  two blocks per SM: a tile's pipeline fill and epilogue overlap only the
  other block's products; a persistent grid that streams tiles through
  one ring is the next step.
- ``"staged"``: float32 (its products stay f32 FMAs: TF32 would break the
  f32 bars) and any layout TMA cannot take, such as the JAX test's ragged
  (300, 70) -> 130, whose 140-byte rows are not 16-byte multiples.
  ``block_gemm.cuh``'s 64 x 64 tiles, bound by its per-element staging.

``fused_matmul`` takes the plain version for a tensor on the CPU and
launches a kernel for a CUDA tensor (or raises); it never falls back.
``fused_matmul.launches`` counts kernel launches (``conv1x1_fused``
launches through it), ``fused_matmul.launches_by_route`` counts them per
route. No autograd: the JAX function has no VJP of its own. The JAX
function's ``block_m``, ``block_n`` and ``interpret`` arguments are the
TPU's tiling and Pallas's CPU mode; the port has neither, so they are
dropped.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from .attention import DTYPE_CODES
from .build import check, load_library


def _check_dtypes(x, w, residual):
    if w.dtype != x.dtype:
        raise ValueError(f"fused_matmul: x is {x.dtype}, w {w.dtype}; the "
                         "product takes one dtype")
    if residual is not None and residual.dtype != x.dtype:
        raise ValueError(f"fused_matmul: residual is {residual.dtype}, x "
                         f"{x.dtype}")


def fused_matmul_plain(x, w, bias, residual=None, relu=False):
    """K4's function in plain PyTorch, at the JAX kernel's rounding points
    (fused_matmul.py:24-38): x @ w summed in f32, plus the f32 bias, plus
    the residual in f32, then the ReLU, rounded once to x's dtype. Autocast
    is off inside: under it a matmul would round its output to bf16 before
    the bias."""
    _check_dtypes(x, w, residual)
    with torch.autocast(x.device.type, enabled=False):
        acc = torch.matmul(x.float(), w.float()) + bias.float()
        if residual is not None:
            acc = acc + residual.float()
        if relu:
            acc = F.relu(acc)
    return acc.to(x.dtype)


ROUTES = ("wgmma", "staged")


def _tma_rows(t: torch.Tensor, inner: int) -> bool:
    """TMA can read a 2-D bf16 tensor as rows along dim ``inner``: unit
    stride there, the other stride a multiple of 16 bytes, the base
    16-byte aligned."""
    outer = 1 - inner
    return (t.stride(inner) == 1 and (t.stride(outer) * t.element_size()) % 16 == 0
            and t.data_ptr() % 16 == 0)


def fused_matmul_route(x: torch.Tensor, w: torch.Tensor) -> str:
    """Which CUDA kernel K4 launches: "wgmma" for bf16 (M, K) x and (K, N)
    w, both non-empty, that TMA can address (x along K; w along N, a
    contiguous (K, N), or along K, a Linear weight's ``.t()``); else
    "staged". The residual plays no part: either kernel's epilogue reads
    it through its strides. Pure: reads dtypes, shapes, strides and data
    pointers only."""
    if not x.dtype == w.dtype == torch.bfloat16 or x.dim() != 2 or w.dim() != 2:
        return "staged"
    if min(x.shape[0], x.shape[1], w.shape[1]) < 1 or not _tma_rows(x, 1):
        return "staged"
    return "wgmma" if _tma_rows(w, 1) or _tma_rows(w, 0) else "staged"


def _launch(x, w, bias, residual, relu):
    if x.device.type != "cuda":
        raise ValueError(f"fused_matmul: no kernel for {x.device}")
    if x.dtype not in DTYPE_CODES:
        raise ValueError(f"fused_matmul: dtype {x.dtype}; need float32 or "
                         "bfloat16")
    _check_dtypes(x, w, residual)
    if x.dim() != 2 or w.dim() != 2 or w.shape[0] != x.shape[1]:
        raise ValueError(f"x {tuple(x.shape)} and w {tuple(w.shape)} are not "
                         "(M, K) and (K, N)")
    m, n = x.shape[0], w.shape[1]
    if bias.shape != (n,):
        raise ValueError(f"bias {tuple(bias.shape)} != {(n,)}")
    if residual is not None and residual.shape != (m, n):
        raise ValueError(f"residual {tuple(residual.shape)} != {(m, n)}")
    for t in (w, bias, residual):
        if t is not None and t.device != x.device:
            raise ValueError(f"an operand is on {t.device}, x on {x.device}")
    route = fused_matmul_route(x, w)
    out = torch.empty(m, n, dtype=x.dtype, device=x.device)
    r_strides = (0, 0) if residual is None else residual.stride()
    r_ptr = None if residual is None else residual.data_ptr()
    lib = load_library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        if route == "wgmma":
            n_major = _tma_rows(w, 1)
            err = lib.cris_fused_matmul_wgmma(
                x.data_ptr(), w.data_ptr(), bias.data_ptr(), r_ptr,
                out.data_ptr(), m, n, x.shape[1], int(relu), x.stride(0),
                int(n_major), w.stride(0 if n_major else 1), *r_strides,
                stream)
        else:
            err = lib.cris_fused_matmul(
                x.data_ptr(), w.data_ptr(), bias.data_ptr(), r_ptr,
                out.data_ptr(), m, n, x.shape[1], DTYPE_CODES[x.dtype],
                int(relu), *x.stride(), *w.stride(), *r_strides, stream)
    check(lib, err, "fused_matmul")
    fused_matmul.launches += 1
    fused_matmul.launches_by_route[route] += 1
    return out


def fused_matmul(
    x: torch.Tensor,
    w: torch.Tensor,
    bias: torch.Tensor,
    residual: Optional[torch.Tensor] = None,
    relu: bool = False,
) -> torch.Tensor:
    """[relu](x @ w + bias [+ residual]) in one pass, rounded once.

    x (M, K) and w (K, N) in one dtype (float32 or bfloat16; mixed dtypes
    raise), read through their strides; bias (N,) is taken in f32;
    residual (M, N) in x's dtype or None. Returns a contiguous (M, N) in
    x's dtype."""
    bias = bias.float().contiguous()
    if x.device.type == "cpu":
        return fused_matmul_plain(x, w, bias, residual, relu)
    return _launch(x, w, bias, residual, relu)


fused_matmul.launches = 0
fused_matmul.launches_by_route = dict.fromkeys(ROUTES, 0)


def conv1x1_fused(
    x: torch.Tensor,
    kernel: torch.Tensor,
    bias: torch.Tensor,
    residual: Optional[torch.Tensor] = None,
    relu: bool = False,
) -> torch.Tensor:
    """1x1 conv + bias [+ residual] [+ relu] in one fused pass, NHWC.

    x (B, H, W, Cin), kernel (1, 1, Cin, Cout) HWIO, bias (Cout,),
    residual (B, H, W, Cout) or None. As the JAX function
    (fused_matmul.py:101-123): the kernel is cast to x's dtype and the bias
    to f32, and the pixels are the rows of ``fused_matmul``."""
    b, h, w, cin = x.shape
    cout = kernel.shape[-1]
    r2 = None if residual is None else residual.reshape(b * h * w, cout)
    y = fused_matmul(x.reshape(b * h * w, cin), kernel[0, 0].to(x.dtype),
                     bias.float(), r2, relu)
    return y.reshape(b, h, w, cout)
