"""K7: the BN-folded ResNet stem and its 2x2 average pool in one kernel,
in CUDA for Hopper.

Replaces the TPU kernel ``fused_stem_pool``
(cris_tpu/ops/pallas/stem.py:145, body ``_stem_kernel`` at :114):

    avgpool2(relu(conv3(relu(conv2(relu(conv1_s2(img)))))))

three 3x3 convs with zero padding 1, the first with stride 2. The CUDA
source is ``cris_tpu_torch/csrc/stem.cu``; its header says how it is
laid out and what bounds it. The intermediates stay in shared memory:
device memory sees the image once (and its tiles' halos, mostly from
L2) and one write of the pooled map. Two bodies, picked by
``stem_route`` before each launch:

- ``"tensor_cores"``: bf16 kernels whose widths C1, C2 and C3 are
  multiples of 16, contiguous and 16-byte aligned, with a smallest tile
  that fits shared memory (the R50 stem, 32/32/64): ``stem_tc_kernel``,
  a persistent grid whose blocks keep the weights in shared memory and
  walk Th x Tw tiles of conv3 outputs, a1 and a2 pixel-major, each 3x3 tap
  a row offset, products on ``mma.sync``, the pool in registers. The tile
  comes from the C side's plan (``stem_plan`` reports it).
- ``"staged"``: float32 and every shape the tensor-core body refuses:
  ``stem_kernel`` on ``block_gemm.cuh``.

``fused_stem_pool`` takes the plain version for a tensor on the CPU and
launches a kernel for a CUDA tensor (or raises); it never falls back.
``fused_stem_pool.launches`` counts kernel launches,
``fused_stem_pool.launches_by_route`` counts them per route. Eval only.
"""

from __future__ import annotations

import ctypes

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


ROUTES = ("tensor_cores", "staged")
# the tensor-core body's shared-memory limit (227 KB a block on the H100)
# and the tiles its plan chooses from (stem.cu ``stem_tc_plan``): Th even
# up to 32, Tw a multiple of 16 up to 64
_TC_MAX_SMEM = 232448
TC_TILES = tuple((th, tw) for tw in (16, 32, 48, 64)
                 for th in range(2, 33, 2))


def _tc_smem_bytes(th: int, tw: int, c1: int, c2: int, c3: int) -> int:
    """The tensor-core body's dynamic shared memory for a th x tw tile
    (stem.cu ``stem_tc_smem_bytes``): k1 (27 rows padded to 32), k2 and k3
    at C + 8 bf16 a row, the three f32 biases, a1 over (th + 4) x (tw + 4)
    pixels at C1 + 8 bf16 a pixel, the pooled tile (C3 rows of th / 2 x
    tw / 2 + 8 bf16), a2 over (th + 2) x (tw + 2) pixels at C2 + 8, and the
    f32 image patch, 3 x (2 th + 9) x (2 tw + 12)."""
    weights = (32 * (c1 + 8) + 9 * c1 * (c2 + 8) + 9 * c2 * (c3 + 8)) * 2
    a1 = (th + 4) * (tw + 4) * (c1 + 8) * 2
    pooled = c3 * (th // 2 * (tw // 2) + 8) * 2
    a2 = (th + 2) * (tw + 2) * (c2 + 8) * 2
    patch = 3 * (2 * th + 9) * (2 * tw + 12) * 4
    return weights + (c1 + c2 + c3) * 4 + a1 + pooled + a2 + patch


def _aligned(t: torch.Tensor) -> bool:
    return t.is_contiguous() and t.data_ptr() % 16 == 0


def stem_route(img: torch.Tensor, k1: torch.Tensor, k2: torch.Tensor,
               k3: torch.Tensor) -> str:
    """Which CUDA kernel K7 launches: "tensor_cores" for bf16 HWIO kernels
    whose widths C1, C2, C3 are multiples of 16 (the mma tiles), contiguous
    and 16-byte aligned, with a smallest tile (2 x 16) that fits shared
    memory; else "staged". The image is read through its strides by 4-byte
    copies, so its layout plays no part. Pure: reads dtypes, shapes,
    strides and data pointers only."""
    if not k1.dtype == k2.dtype == k3.dtype == torch.bfloat16:
        return "staged"
    if img.dim() != 4 or any(k.dim() != 4 for k in (k1, k2, k3)):
        return "staged"
    c1, c2, c3 = k1.shape[-1], k2.shape[-1], k3.shape[-1]
    if c1 % 16 or c2 % 16 or c3 % 16 or not all(
            _aligned(k) for k in (k1, k2, k3)):
        return "staged"
    fits = _tc_smem_bytes(2, 16, c1, c2, c3) <= _TC_MAX_SMEM
    return "tensor_cores" if fits else "staged"


def _launch(img, k1, b1, k2, b2, k3, b3, route=None, tile=None):
    """Launch K7 on ``route`` (default: ``stem_route``'s) and, on the
    tensor cores, on a ``tile`` (Th, Tw) of ``TC_TILES`` (default: the
    plan's)."""
    dt = k1.dtype
    if dt not in DTYPE_CODES:
        raise ValueError(f"fused_stem_pool: dtype {dt}; need float32 or "
                         "bfloat16")
    if not k2.dtype == k3.dtype == dt:
        raise ValueError(f"fused_stem_pool: kernels in {dt}, {k2.dtype}, "
                         f"{k3.dtype}; need one dtype")
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
    if route is None:
        route = stem_route(img, k1, k2, k3)
    if route not in ROUTES or (tile is not None and route != "tensor_cores"):
        raise ValueError(f"fused_stem_pool: route {route}, tile {tile}")
    th, tw = tile if tile is not None else (0, 0)
    # NCHW memory seen as NHWC: the layout the next layer (layer1) reads
    out = torch.empty((b, c3, h // 4, w // 4), dtype=dt,
                      device=img.device).permute(0, 2, 3, 1)
    lib = load_library()
    with torch.cuda.device(img.device):
        stream = torch.cuda.current_stream(img.device).cuda_stream
        err = lib.cris_stem_pool(
            img.data_ptr(), k1.data_ptr(), b1.data_ptr(), k2.data_ptr(),
            b2.data_ptr(), k3.data_ptr(), b3.data_ptr(), out.data_ptr(),
            b, h, w, c1, c2, c3, DTYPE_CODES[dt],
            int(route == "tensor_cores"), th, tw, *img.stride(),
            *out.stride(), stream)
    check(lib, err, "fused_stem_pool")
    fused_stem_pool.launches += 1
    fused_stem_pool.launches_by_route[route] += 1
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
fused_stem_pool.launches_by_route = dict.fromkeys(ROUTES, 0)


def stem_plan(img: torch.Tensor, k1: torch.Tensor, k2: torch.Tensor,
              k3: torch.Tensor, tile=None) -> dict:
    """The tensor-core body's plan for img (B, H, W, 3) and the kernels'
    widths, as its launch makes it on the current card (stem.cu
    ``stem_tc_plan``; ``tile`` (Th, Tw) evaluates that tile instead): the
    tile, its counts, the persistent grid's blocks, the shared memory and
    the model's makespan in warp mma steps. Loads the library; for reports
    on the card."""
    b, h, w, _ = img.shape
    c1, c2, c3 = k1.shape[-1], k2.shape[-1], k3.shape[-1]
    th, tw = tile if tile is not None else (0, 0)
    lib = load_library()
    plan = (ctypes.c_longlong * 7)()
    cost = ctypes.c_double()
    if lib.cris_stem_plan(b, h, w, c1, c2, c3, th, tw, plan,
                          ctypes.byref(cost)):
        raise ValueError(f"no tile of {h} x {w} x {c1}/{c2}/{c3} fits "
                         f"(requested {tile})")
    keys = ("Th", "Tw", "bands", "col_tiles", "tiles", "blocks",
            "smem_bytes")
    return dict(zip(keys, plan), cost=cost.value)
