"""K4: the fused channel matmul, [relu](x @ w + bias [+ residual]), in CUDA
for Hopper.

Replaces the TPU kernel ``fused_matmul`` (cris_tpu/ops/pallas/
fused_matmul.py:48, ``pallas_call`` at :81 with a residual and :90
without) and its 1x1-convolution form ``conv1x1_fused`` (:101). The CUDA
source is ``cris_tpu_torch/csrc/fused_matmul.cu``; its header says how it
is laid out and what bounds it.

``fused_matmul`` takes the plain version for a tensor on the CPU and
launches the kernel for a CUDA tensor (or raises); it never falls back.
``fused_matmul.launches`` counts kernel launches (``conv1x1_fused``
launches through it). No autograd: the JAX function has no VJP of its
own. The JAX function's ``block_m``, ``block_n`` and ``interpret``
arguments are the TPU's tiling and Pallas's CPU mode; the port has
neither, so they are dropped.
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
    out = torch.empty(m, n, dtype=x.dtype, device=x.device)
    r_strides = (0, 0) if residual is None else residual.stride()
    lib = load_library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.cris_fused_matmul(
            x.data_ptr(), w.data_ptr(), bias.data_ptr(),
            None if residual is None else residual.data_ptr(), out.data_ptr(),
            m, n, x.shape[1], DTYPE_CODES[x.dtype], int(relu), *x.stride(),
            *w.stride(), *r_strides, stream)
    check(lib, err, "fused_matmul")
    fused_matmul.launches += 1
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
