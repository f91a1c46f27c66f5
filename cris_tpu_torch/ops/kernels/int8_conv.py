"""K8: the int8 implicit-GEMM convolution of the int8 serving sites, in
CUDA for Hopper.

Replaces no Pallas kernel: it is the counterpart of the int8
``lax.conv_general_dilated`` that cris_tpu/ops/quant.py runs through XLA
(``int8_conv2d_static`` :64, ``int8_phase_conv_static`` :101,
``int8_conv2d`` :136); PyTorch has no int8 convolution on CUDA. The
CUDA source is ``cris_tpu_torch/csrc/int8_conv.cu``; its header says how
it is laid out and what bounds it.

    xq  = clip(round_half_even(x / s), -127, 127)   (x float; int8 as is)
    acc = conv(xq, wq) in int32, stride and (asymmetric) zero padding
    y   = float(acc) * (s * k_scale) [+ bias] [relu], in out_dtype

``int8_conv`` takes NHWC activations (any strides: the model passes NHWC
views of its NCHW tensors) in f32, bf16 or int8, a per-tensor scale ``s``
as a one-element f32 tensor on x's device, an HWIO int8 kernel with its
per-output-channel f32 ``k_scale``, and an optional f32 bias. It writes
(B, Ho, Wo, Co) in ``out_dtype``, into ``out`` when given (any strides:
the phase convs write their interleaved positions). For a tensor on the
CPU it takes ``int8_conv_plain``; for a CUDA tensor it launches K8 or
raises, for a shape K8 does not take too (kernels 1 to 3 a side, stride
1 or 2, each padding below the kernel's size). ``int8_conv.launches``
counts launches.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from .build import check, load_library

IN_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
OUT_CODES = {torch.float32: 0, torch.bfloat16: 1}
Pads = Tuple[Tuple[int, int], Tuple[int, int]]


def quantize_static(x: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """clip(round(x / s), -127, 127) as int8: an f32 division (not a
    multiply by 1 / s) and round half to even, as the JAX package."""
    with torch.autocast(x.device.type, enabled=False):
        return torch.clamp(torch.round(x.float() / s.float()),
                           -127, 127).to(torch.int8)


def out_shape(x_shape, w_shape, stride: int, padding: Pads):
    b, h, w, _ = x_shape
    kh, kw, _, co = w_shape
    (pt, pb), (pl, pr) = padding
    return (b, (h + pt + pb - kh) // stride + 1,
            (w + pl + pr - kw) // stride + 1, co)


def int8_conv_plain(x, wq, k_scale, act_scale, bias=None, stride: int = 1,
                    padding: Pads = ((0, 0), (0, 0)), relu: bool = False,
                    out_dtype: Optional[torch.dtype] = None, out=None):
    """K8's function in plain PyTorch: the int32 accumulator exactly, as
    an f64 conv of the int8 values (every partial sum is below 2^53), then
    K8's epilogue in f32: float(acc) * (s * k_scale) [+ bias] [relu]."""
    out_dtype = out_dtype or _default_out(x)
    s = act_scale.reshape(()).float()
    xq = x if x.dtype == torch.int8 else quantize_static(x, s)
    acc = int8_accumulate(xq, wq, stride, padding).permute(0, 3, 1, 2)
    with torch.autocast(x.device.type, enabled=False):
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
    return x.dtype if x.dtype in OUT_CODES else torch.float32


def int8_conv(x: torch.Tensor, wq: torch.Tensor, k_scale: torch.Tensor,
              act_scale: torch.Tensor, bias: Optional[torch.Tensor] = None,
              stride: int = 1, padding: Pads = ((0, 0), (0, 0)),
              relu: bool = False, out_dtype: Optional[torch.dtype] = None,
              out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The int8 conv of NHWC ``x`` with the HWIO int8 ``wq`` (see the
    module docstring); returns (B, Ho, Wo, Co) in ``out_dtype`` (x's float
    dtype, f32 for int8 x, by default)."""
    if x.device.type == "cpu":
        return int8_conv_plain(x, wq, k_scale, act_scale, bias, stride,
                               padding, relu, out_dtype, out)
    return _launch(x, wq, k_scale, act_scale, bias, stride, padding, relu,
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


def _launch(x, wq, k_scale, act_scale, bias, stride, padding, relu,
            out_dtype, out):
    if x.device.type != "cuda":
        raise ValueError(f"int8_conv: no kernel for {x.device}")
    if x.dim() != 4 or x.dtype not in IN_CODES:
        raise ValueError(f"int8_conv: x must be NHWC f32, bf16 or int8, got "
                         f"{tuple(x.shape)} {x.dtype}")
    kh, kw, c, co = wq.shape
    if (wq.dtype != torch.int8 or c != x.shape[3] or not wq.is_contiguous()
            or wq.data_ptr() % 16 or wq.device != x.device):
        raise ValueError(f"int8_conv: wq must be a contiguous 16-byte aligned "
                         f"int8 HWIO kernel over {x.shape[3]} channels on "
                         f"{x.device}, got {tuple(wq.shape)} {wq.dtype}")
    if not supports(kh, kw, stride, padding):
        raise ValueError(f"int8_conv: K8 takes kernels 1 to 3 a side, stride "
                         f"1 or 2 and paddings below the kernel; got {kh}x{kw}"
                         f" stride {stride} padding {padding}")
    out_dtype = out_dtype or _default_out(x)
    if out_dtype not in OUT_CODES:
        raise ValueError(f"int8_conv: out_dtype {out_dtype}")
    shape = out_shape(x.shape, wq.shape, stride, padding)
    if out is None:
        out = torch.empty(shape, dtype=out_dtype, device=x.device)
    elif (tuple(out.shape) != shape or out.dtype != out_dtype
          or out.device != x.device):
        raise ValueError(f"int8_conv: out {tuple(out.shape)} {out.dtype}, "
                         f"need {shape} {out_dtype}")
    k_scale = _vec(k_scale, co, "k_scale", x.device)
    if bias is not None:
        bias = _vec(bias, co, "bias", x.device)
    s = act_scale.reshape(-1)
    if s.numel() != 1 or s.dtype != torch.float32 or s.device != x.device:
        raise ValueError("int8_conv: act_scale must be one float32 on "
                         f"{x.device}")
    lib = load_library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.cris_int8_conv(
            x.data_ptr(), wq.data_ptr(), k_scale.data_ptr(), s.data_ptr(),
            0 if bias is None else bias.data_ptr(), out.data_ptr(),
            x.shape[0], x.shape[1], x.shape[2], c, shape[1], shape[2], co,
            kh, kw, stride, padding[0][0], padding[1][0],
            IN_CODES[x.dtype], OUT_CODES[out_dtype], int(relu),
            *x.stride(), *out.stride(), stream)
    check(lib, err, "int8_conv")
    int8_conv.launches += 1
    return out
