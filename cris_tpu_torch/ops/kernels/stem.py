"""K7: the BN-folded ResNet stem and its 2x2 average pool in one kernel,
in CUDA for Hopper.

Replaces the TPU kernel ``fused_stem_pool``
(cris_tpu/ops/pallas/stem.py:145, body ``_stem_kernel`` at :114):

    avgpool2(relu(conv3(relu(conv2(relu(conv1_s2(img)))))))

three 3x3 convs with zero padding 1, the first with stride 2. The CUDA
source is ``cris_tpu_torch/csrc/stem.cu``; its header says how it is
laid out and what bounds it. The intermediates stay in shared memory:
device memory sees one read of the image and one write of the pooled map.

``fused_stem_pool`` takes the plain version for a tensor on the CPU and
launches the kernel for a CUDA tensor (or raises); it never falls back.
``fused_stem_pool.launches`` counts kernel launches. Eval only.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .attention import DTYPE_CODES
from .build import check, load_library


def pool2x2_as_jax(a: torch.Tensor) -> torch.Tensor:
    """The 2x2 average pool of (B, H, W, C) ``a`` rounded as the TPU kernel
    rounds it: the row pairs summed in f32, times 0.25, cast to a's dtype
    (stem.py:142), then the column pairs added in f32 and cast to a's dtype
    (stem.py:203, an add in the dtype). In f32 the casts are the identity
    and the sum order is the kernel's."""
    dt = a.dtype
    f = a.float()
    rows = ((f[:, 0::2] + f[:, 1::2]) * 0.25).to(dt).float()
    return (rows[:, :, 0::2] + rows[:, :, 1::2]).to(dt)


def stem_pool_plain(img, k1, b1, k2, b2, k3, b3):
    """The kernel's function in plain PyTorch, at the JAX kernel's rounding
    points (``_conv_stage``, stem.py:86-111): the image is cast to the
    compute dtype (k1's), each conv accumulates in f32, adds its f32 bias,
    applies the ReLU and is cast to the compute dtype; the pool is
    ``pool2x2_as_jax``.

    img (B, H, W, 3) NHWC; k1 (3, 3, 3, C1), k2 (3, 3, C1, C2), k3 (3, 3,
    C2, C3) HWIO; biases f32. Returns (B, H/4, W/4, C3)."""
    dt = k1.dtype
    x = img.to(dt).permute(0, 3, 1, 2)
    with torch.autocast(img.device.type, enabled=False):
        for k, b, s in ((k1, b1, 2), (k2, b2, 1), (k3, b3, 1)):
            w = k.float().permute(3, 2, 0, 1)
            x = F.relu(F.conv2d(x.float(), w, b.float(), s, 1)).to(dt)
        return pool2x2_as_jax(x.permute(0, 2, 3, 1))


def _launch(img, k1, b1, k2, b2, k3, b3):
    dt = k1.dtype
    if dt not in DTYPE_CODES:
        raise ValueError(f"fused_stem_pool: dtype {dt}; need float32 or "
                         "bfloat16")
    if img.dim() != 4 or img.shape[-1] != 3:
        raise ValueError(f"img must be (B, H, W, 3), got {tuple(img.shape)}")
    b, h, w, _ = img.shape
    if h % 4 or w % 4:
        raise ValueError(f"fused_stem_pool: H, W = {h}, {w} must be "
                         "multiples of 4")
    c1, c2, c3 = k1.shape[-1], k2.shape[-1], k3.shape[-1]
    want = {"k1": (3, 3, 3, c1), "b1": (c1,), "k2": (3, 3, c1, c2),
            "b2": (c2,), "k3": (3, 3, c2, c3), "b3": (c3,)}
    given = dict(k1=k1, b1=b1, k2=k2, b2=b2, k3=k3, b3=b3)
    for name, shape in want.items():
        t = given[name]
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} {tuple(t.shape)} != {shape}")
        if t.device != img.device:
            raise ValueError(f"{name} is on {t.device}, img on {img.device}")
    # NCHW memory seen as NHWC: the layout the next layer (layer1) reads
    out = torch.empty((b, c3, h // 4, w // 4), dtype=dt,
                      device=img.device).permute(0, 2, 3, 1)
    lib = load_library()
    with torch.cuda.device(img.device):
        stream = torch.cuda.current_stream(img.device).cuda_stream
        err = lib.cris_stem_pool(
            img.data_ptr(), k1.data_ptr(), b1.data_ptr(), k2.data_ptr(),
            b2.data_ptr(), k3.data_ptr(), b3.data_ptr(), out.data_ptr(),
            b, h, w, c1, c2, c3, DTYPE_CODES[dt], *img.stride(),
            *out.stride(), stream)
    check(lib, err, "fused_stem_pool")
    fused_stem_pool.launches += 1
    return out


def fused_stem_pool(img, k1, b1, k2, b2, k3, b3):
    """avgpool2(relu(conv3(relu(conv2(relu(conv1_s2(img))))))).

    The JAX signature: img (B, H, W, 3) NHWC, read through its strides (the
    model hands over an NHWC view of its NCHW image); HWIO kernels in the
    compute dtype (float32 or bfloat16), f32 biases. H and W must be
    multiples of 4. Returns (B, H/4, W/4, C3) in the compute dtype, an
    NHWC view of NCHW memory."""
    k1, k2, k3 = (t.contiguous() for t in (k1, k2, k3))
    b1, b2, b3 = (t.float().contiguous() for t in (b1, b2, b3))
    if img.device.type == "cpu":
        return stem_pool_plain(img, k1, b1, k2, b2, k3, b3)
    return _launch(img.float(), k1, b1, k2, b2, k3, b3)


fused_stem_pool.launches = 0
