"""K5: the BN-folded stride-1 ResNet bottleneck in one kernel, in CUDA for
Hopper.

Replaces the TPU kernel ``fused_bottleneck``
(cris_tpu/ops/pallas/bottleneck.py:181, body ``_kernel`` at :55):

    y = relu(x + b3 + conv1x1(relu(b2 + conv3x3(relu(b1 + conv1x1(x))))))

with zero ('SAME') padding on the 3x3. The CUDA source is
``cris_tpu_torch/csrc/bottleneck.cu``; its header says how it is laid out
and what bounds it. Every intermediate stays in shared memory: device
memory sees one read of x (and its residual re-read, from L2), the
weights, and one write of y. Two bodies, picked by ``bottleneck_route``
before each launch:

- ``"tensor_cores"``: bf16 with C and mid multiples of 64, contiguous
  16-byte aligned weights, and a band of one row that fits shared memory
  (every R50 tail, layer1's mid 64 included): ``bottleneck_tc_kernel``,
  y1 and y2 pixel-major in shared memory, the 3x3 as nine row offsets
  into y1's flat padded grid, products on ``mma.sync``.
- ``"staged"``: float32 (f32 products stay f32 FMAs) and every shape the
  tensor-core body refuses: ``bottleneck_kernel`` on ``block_gemm.cuh``.

``fused_bottleneck`` takes the plain version for a tensor on the CPU and
launches a kernel for a CUDA tensor (or raises); it never falls back.
``fused_bottleneck.launches`` counts kernel launches,
``fused_bottleneck.launches_by_route`` counts them per route. Eval only,
as in the JAX package: no backward.
"""

from __future__ import annotations

import ctypes

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


ROUTES = ("tensor_cores", "staged")
# the tensor-core body's shared-memory limit (227 KB a block on the H100)
# and its smallest M tile, whose one-row band the route requires to fit
_TC_MAX_SMEM = 232448
_TC_MIN_BM = 32


def _tc_rows(r: int, w: int, bm23: int, shift: int) -> tuple:
    """(M1, M2): the rows of y1 and of y2 in the tensor-core body for a
    band of r rows of width w and conv2's and conv3's M tile bm23
    (bottleneck.cu ``tc_rows``). M2 covers the band's r rows of w + 2 (the
    last two junk), rounded up to bm23. y1 row m holds padded-grid
    position m - shift (1 where x takes pixel pairs, else 0); M1 covers M2
    and the furthest 3x3 tap, 2 (w + 2) + 2 + shift rows on, rounded up
    to 16, and so the (r + 2) x (w + 2) padded grid."""
    m2 = -(-r * (w + 2) // bm23) * bm23
    return -(-(m2 + 2 * (w + 2) + 2 + shift) // 16) * 16, m2


def _tc_smem_bytes(r: int, w: int, mid: int, bm1: int, bm23: int,
                   shift: int) -> int:
    """The tensor-core body's dynamic shared memory (bottleneck.cu
    ``tc_smem_bytes``): y1 and y2 at mid + 8 bf16 a row, four 64 x 72
    bf16 weight tiles, and the larger of two 64 x (bm1 + 8) bf16 x chunks
    and conv3's bm23 x 65 f32 staging."""
    m1, m2 = _tc_rows(r, w, bm23, shift)
    return ((m1 + m2) * (mid + 8) * 2 + 4 * 64 * 72 * 2
            + max(2 * 64 * (bm1 + 8) * 2, bm23 * 65 * 4))


def _tc_pairs(x: torch.Tensor) -> bool:
    """The tensor-core body's pixel pairs (bottleneck.cu ``launch_tc``):
    x, and its output of the same layout, have unit pixel stride, an even
    width, even other strides and a 4-byte aligned base."""
    return (x.stride(2) == 1 and x.shape[2] % 2 == 0
            and all(s % 2 == 0 for s in (x.stride(0), x.stride(1),
                                         x.stride(3)))
            and x.data_ptr() % 4 == 0)


def _aligned(t: torch.Tensor) -> bool:
    return t.is_contiguous() and t.data_ptr() % 16 == 0


def bottleneck_route(x: torch.Tensor, w1: torch.Tensor, w2: torch.Tensor,
                     w3: torch.Tensor) -> str:
    """Which CUDA kernel K5 launches: "tensor_cores" for bf16 x (B, H, W,
    C) and weights with C and mid multiples of 64, contiguous 16-byte
    aligned weights, and shared memory for a band of one row at the
    smallest M tile (the body's plan then has at least that band to
    take); else "staged". x is read through its strides, so its layout
    plays no part. Pure: reads dtypes, shapes, strides and data pointers
    only."""
    if not x.dtype == w1.dtype == w2.dtype == w3.dtype == torch.bfloat16:
        return "staged"
    if x.dim() != 4 or w1.dim() != 2 or min(x.shape) < 1:
        return "staged"
    c, mid = x.shape[3], w1.shape[1]
    if c % 64 or mid % 64 or not all(_aligned(t) for t in (w1, w2, w3)):
        return "staged"
    # the larger y1 of the two row shifts
    fits = _tc_smem_bytes(1, x.shape[2], mid, _TC_MIN_BM, _TC_MIN_BM,
                          1) <= _TC_MAX_SMEM
    return "tensor_cores" if fits else "staged"


# The tails K5 takes when its switch is on: "every" stride-1 identity
# tail, or the "narrow" ones: in bf16 only tails of mid <= 128 (R50's
# 104^2 and 52^2 tails), where the per-tail table of chip_smoke.py phase 9
# has K5 ahead of the cuDNN chain and the bench's b32 A/B
# (``python3 -m cris_tpu_torch.bench --ab``) had it ahead of K5 on every
# tail in every round; wider tails reread their weights from L2 once per
# band and lose. The A/B measured bf16 alone, so other dtypes (the f32
# checks on the staged body) keep every tail under either rule.
TAIL_RULES = ("every", "narrow")
K5_TAILS = "narrow"


def bottleneck_takes(h: int, w: int, c: int, mid: int, dtype: torch.dtype,
                     tails: str = K5_TAILS) -> bool:
    """Whether K5 takes a stride-1 identity tail of (H, W, C) with width
    mid at the compute dtype, under the tail rule ``tails`` (see
    TAIL_RULES); a refused tail runs the cuDNN chain. The port's
    counterpart of the JAX gate ``supports_shape``
    (cris_tpu/ops/pallas/bottleneck.py:164), which also reads the
    spatial shape for its VMEM fit; this rule needs only mid and the
    dtype. Pure: reads integers and a dtype, no tensor."""
    if tails not in TAIL_RULES:
        raise ValueError(f"unknown K5 tail rule {tails!r}; one of {TAIL_RULES}")
    return tails == "every" or dtype != torch.bfloat16 or mid <= 128


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
    route = bottleneck_route(x, w1, w2, w3)
    out = torch.empty_like(x)  # x's layout: an NCHW-backed view stays so
    lib = load_library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.cris_bottleneck(
            x.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(),
            b2.data_ptr(), w3.data_ptr(), b3.data_ptr(), out.data_ptr(),
            b, h, w, c, mid, DTYPE_CODES[x.dtype],
            int(route == "tensor_cores"), *x.stride(), *out.stride(), stream)
    check(lib, err, "fused_bottleneck")
    fused_bottleneck.launches += 1
    fused_bottleneck.launches_by_route[route] += 1
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
fused_bottleneck.launches_by_route = dict.fromkeys(ROUTES, 0)


def bottleneck_plan(x: torch.Tensor, mid: int) -> dict:
    """The tensor-core body's plan for x (B, H, W, C) and width mid, as
    its launch makes it (bottleneck.cu ``tc_plan``): conv1's and
    conv2/conv3's M tiles, band rows, y1 and y2 rows, shared memory, and
    the plan's tensor and L2 estimates. Loads the library; for reports on
    the card."""
    b, h, w, c = x.shape
    lib = load_library()
    plan = (ctypes.c_longlong * 6)()
    times = (ctypes.c_double * 2)()
    if lib.cris_bottleneck_plan(b, h, w, c, mid, int(_tc_pairs(x)), plan,
                                times):
        raise ValueError(f"no band of {h} x {w} x {c}/{mid} fits")
    keys = ("BM1", "BM23", "R", "M1", "M2", "smem_bytes")
    return dict(zip(keys, plan), pairs=_tc_pairs(x), tensor_s=times[0],
                l2_s=times[1])
