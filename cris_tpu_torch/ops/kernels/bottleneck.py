"""K5: the BN-folded stride-1 ResNet bottleneck in one kernel, in CUDA for
Hopper.

Replaces the TPU kernel ``fused_bottleneck``
(cris_tpu/ops/pallas/bottleneck.py:181, body ``_kernel`` at :55):

    y = relu(x + b3 + conv1x1(relu(b2 + conv3x3(relu(b1 + conv1x1(x))))))

with zero ('SAME') padding on the 3x3. The CUDA source is
``cris_tpu_torch/csrc/bottleneck.cu``; its header says how it is laid out
and what bounds it. Every intermediate stays in shared memory: device
memory sees one read of x (and its residual re-read, from L2), the
weights, and one write of y.

``fused_bottleneck`` takes the plain version for a tensor on the CPU and
launches the kernel for a CUDA tensor (or raises); it never falls back.
``fused_bottleneck.launches`` counts kernel launches. Eval only, as in
the JAX package: no backward.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .attention import DTYPE_CODES
from .build import check, load_library


def compute_dtype(x: torch.Tensor) -> torch.dtype:
    """The autocast dtype inside an autocast region on x's device, else
    x's own dtype: what the JAX module's ``dtype`` is to its kernel."""
    if torch.is_autocast_enabled(x.device.type):
        return torch.get_autocast_dtype(x.device.type)
    return x.dtype


def bottleneck_plain(x, w1, b1, w2, b2, w3, b3):
    """The kernel's function in plain PyTorch, at the JAX kernel's rounding
    points (bottleneck.py:67-120): each stage accumulates in f32 and adds
    its f32 bias; a stage's ReLU output is cast to the compute dtype (x's);
    the residual is added in f32; the output is in the compute dtype.

    x (B, H, W, C) NHWC; w1 (C, mid), w2 (9, mid, mid) from a (3, 3, mid,
    mid) HWIO kernel, w3 (mid, C); biases (mid,), (mid,), (C,)."""
    dt = x.dtype
    mid = w1.shape[1]
    with torch.autocast(x.device.type, enabled=False):
        h = F.relu(torch.matmul(x.float(), w1.float()) + b1.float()).to(dt)
        k2 = w2.float().reshape(3, 3, mid, mid).permute(3, 2, 0, 1)
        h = F.conv2d(h.float().permute(0, 3, 1, 2), k2, padding=1)
        h = F.relu(h.permute(0, 2, 3, 1) + b2.float()).to(dt)
        y = torch.matmul(h.float(), w3.float()) + b3.float() + x.float()
        return F.relu(y).to(dt)


def _launch(x, w1, b1, w2, b2, w3, b3):
    if x.dtype not in DTYPE_CODES:
        raise ValueError(f"fused_bottleneck: dtype {x.dtype}; need float32 "
                         "or bfloat16")
    if x.dim() != 4:
        raise ValueError(f"x must be (B, H, W, C), got {tuple(x.shape)}")
    b, h, w, c = x.shape
    mid = w1.shape[-1]
    want = {"w1": (c, mid), "b1": (mid,), "w2": (9, mid, mid), "b2": (mid,),
            "w3": (mid, c), "b3": (c,)}
    given = dict(w1=w1, b1=b1, w2=w2, b2=b2, w3=w3, b3=b3)
    for name, shape in want.items():
        t = given[name]
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} {tuple(t.shape)} != {shape}")
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
    out = torch.empty_like(x)  # x's layout: an NCHW-backed view stays so
    lib = load_library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.cris_bottleneck(
            x.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(),
            b2.data_ptr(), w3.data_ptr(), b3.data_ptr(), out.data_ptr(),
            b, h, w, c, mid, DTYPE_CODES[x.dtype], *x.stride(), *out.stride(),
            stream)
    check(lib, err, "fused_bottleneck")
    fused_bottleneck.launches += 1
    return out


def fused_bottleneck(x, w1, b1, w2, b2, w3, b3):
    """relu(x + b3 + conv3(relu(b2 + conv2_3x3(relu(b1 + conv1(x)))))).

    The JAX signature and layout: x (B, H, W, C) NHWC, read through its
    strides (an NHWC view of NCHW memory is not copied, and the output
    keeps x's memory layout); w1 (C, mid), w2 (9, mid, mid), w3 (mid, C),
    biases f32. x and the weights are cast to the compute dtype (float32
    or bfloat16; under autocast the autocast dtype); sums are f32."""
    dt = compute_dtype(x)
    x = x.to(dt)
    w1, w2, w3 = (t.to(dt).contiguous() for t in (w1, w2, w3))
    b1, b2, b3 = (t.float().contiguous() for t in (b1, b2, b3))
    if x.device.type == "cpu":
        return bottleneck_plain(x, w1, b1, w2, b2, w3, b3)
    return _launch(x, w1, b1, w2, b2, w3, b3)


fused_bottleneck.launches = 0
