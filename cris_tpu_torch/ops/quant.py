"""Post-training int8 for the BN-folded serving path (counterpart of
cris_tpu/ops/quant.py).

- weights: symmetric per-output-channel int8, scale = maxabs / 127 +
  1e-12;
- activations: symmetric per-tensor int8 with a calibrated (static)
  scale, or a dynamic one (maxabs of the conv input / 127 + 1e-12);
- products: int8 x int8 in int32 (K8, ``ops.kernels.int8_conv``, on the
  card; its plain version on the CPU), dequantised as
  ``float(acc) * (s * k_scale)`` and then ``+ bias``, in f32. Each site
  quantises its input once (``int8_quantize``, K8's quantise pass), as
  the JAX package does, and hands the result to K8's GEMM.

Quantisation rounds an f32 division (x / s, not x * (1 / s)) half to
even and clips to +-127, as the JAX package does, so both packages give
the same int8 operands and int32 accumulators. NHWC tensors and HWIO
kernels, as the JAX functions. The outputs are f32, as JAX's.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from .kernels.int8_conv import (PackedInt8, int8_conv, int8_quantize,
                                pack_int8_weights, quantize_static)

EPS = 1e-12


def over_127(t: torch.Tensor) -> torch.Tensor:
    """t / 127 as a true division on every device: PyTorch on CUDA turns a
    division by a Python number into a multiply by its reciprocal, which
    can differ in the last bit."""
    return t / torch.full((), 127.0, dtype=t.dtype, device=t.device)


def quantize_channelwise(k: torch.Tensor, eps: float = EPS
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-output-channel int8 of an HWIO kernel: (int8 kernel,
    f32 scale (Cout,)), k ~= kq * scale."""
    kf = k.float()
    scale = over_127(kf.abs().amax(dim=tuple(range(kf.dim() - 1)))) + eps
    kq = torch.clamp(torch.round(kf / scale), -127, 127).to(torch.int8)
    return kq.contiguous(), scale


def quantize_dynamic(x: torch.Tensor, eps: float = EPS
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-tensor int8 of an activation: (int8 x, f32 scalar
    scale), x ~= xq * scale."""
    scale = dynamic_scale(x, eps)
    return quantize_static(x, scale), scale


def dynamic_scale(x: torch.Tensor, eps: float = EPS) -> torch.Tensor:
    """maxabs(x) / 127 + eps as an f32 scalar on x's device."""
    with torch.autocast(x.device.type, enabled=False):
        return over_127(x.float().abs().amax()) + eps


def resolve_padding(padding, x_shape, k_shape, stride: int):
    """A JAX padding ("SAME", "VALID" or [(lo, hi), (lo, hi)]) as
    ((top, bottom), (left, right))."""
    if padding == "VALID":
        return ((0, 0), (0, 0))
    if padding == "SAME":
        pads = []
        for n, k in ((x_shape[1], k_shape[0]), (x_shape[2], k_shape[1])):
            total = max((-(-n // stride) - 1) * stride + k - n, 0)
            pads.append((total // 2, total - total // 2))
        return tuple(pads)
    (pt, pb), (pl, pr) = padding
    return ((int(pt), int(pb)), (int(pl), int(pr)))


def _stride(strides) -> int:
    sh, sw = (strides, strides) if isinstance(strides, int) else strides
    if sh != sw:
        raise ValueError(f"strides {strides}: the int8 conv takes one stride")
    return int(sh)


def _no_dilation(lhs_dilation):
    if tuple(lhs_dilation) != (1, 1):
        raise ValueError("lhs_dilation: the port's int8 sites use the phase "
                         "form (int8_phase_conv_static) instead")


def int8_conv2d_static(x: torch.Tensor, kernel, act_scale: torch.Tensor,
                       strides: Sequence[int] = (1, 1), padding="SAME",
                       bias: Optional[torch.Tensor] = None,
                       lhs_dilation: Sequence[int] = (1, 1),
                       out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """int8 conv with a calibrated activation scale; (B, Ho, Wo, Co) in
    ``out_dtype``. ``kernel`` is an HWIO float kernel, or the (int8
    kernel, k_scale) pair ``quantize_channelwise`` makes of one, the int8
    kernel HWIO or packed (``PackedInt8``: the model's sites quantise and
    pack once). x is quantised once (``int8_quantize``). Activations
    beyond the calibrated range saturate at +-127."""
    _no_dilation(lhs_dilation)
    kq, k_scale = quantize_packed(kernel)
    s = torch.as_tensor(act_scale, dtype=torch.float32,
                        device=x.device).reshape(1)
    stride = _stride(strides)
    pads = resolve_padding(padding, x.shape, (kq.kh, kq.kw), stride)
    return int8_conv(int8_quantize(x, s), kq, k_scale, s,
                     None if bias is None else bias.float(), stride, pads,
                     out_dtype=out_dtype)


def int8_phase_conv_static(x: torch.Tensor, pk, pads,
                           act_scale: torch.Tensor,
                           out_dtype: torch.dtype = torch.float32
                           ) -> torch.Tensor:
    """The int8 upsample-fold core as four phase convs with one calibrated
    scale: ``pk`` (2, 2, kh, kw, Ci, Co) from ``phase_kernels6/4``, or the
    four phases' (int8 kernel, k_scale) pairs in the order (0, 0), (0, 1),
    (1, 0), (1, 1), HWIO or packed; ``pads`` ``PHASE_PADS6/4`` (phase
    (di, dj) padded [pads[di], pads[dj]]). x is quantised once for the
    four (cris_tpu/ops/quant.py:121); each phase writes its interleaved
    positions of one (B, 2H, 2W, Co) output in ``out_dtype`` directly."""
    s = torch.as_tensor(act_scale, dtype=torch.float32,
                        device=x.device).reshape(1)
    phases = ((0, 0), (0, 1), (1, 0), (1, 1))
    qs = [quantize_packed(pk[di, dj]) for di, dj in phases] if (
        torch.is_tensor(pk)) else [quantize_packed(pair) for pair in pk]
    xq = int8_quantize(x, s)
    b, h, w, _ = x.shape
    out = torch.empty((b, 2 * h, 2 * w, qs[0][0].co), dtype=out_dtype,
                      device=x.device)
    for (di, dj), (kq, k_scale) in zip(phases, qs):
        int8_conv(xq, kq, k_scale, s, None, 1,
                  (tuple(pads[di]), tuple(pads[dj])), out_dtype=out_dtype,
                  out=out[:, di::2, dj::2])
    return out


def quantize_packed(kernel):
    """(PackedInt8, k_scale) of a float HWIO kernel, or of an (int8
    kernel, k_scale) pair whose kernel is HWIO or packed already: what
    the model's sites keep per weight change."""
    kq, k_scale = (quantize_channelwise(kernel) if torch.is_tensor(kernel)
                   else kernel)
    if not isinstance(kq, PackedInt8):
        kq = pack_int8_weights(kq)
    return kq, k_scale


def int8_conv2d(x: torch.Tensor, kernel: torch.Tensor,
                strides: Sequence[int] = (1, 1), padding="SAME",
                bias: Optional[torch.Tensor] = None,
                lhs_dilation: Sequence[int] = (1, 1)) -> torch.Tensor:
    """== conv2d(x, kernel) [+ bias] through int8 with a dynamic
    per-tensor activation scale; f32 (B, Ho, Wo, Co)."""
    return int8_conv2d_static(x, kernel, dynamic_scale(x), strides, padding,
                              bias, lhs_dilation)
