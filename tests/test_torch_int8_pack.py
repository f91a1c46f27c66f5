"""K8's operands and plan on the CPU, at tiny shapes (no model build):

- ``int8_quantize_plain`` (the quantise pass's plain version) against the
  JAX package's quantiser, bit for bit: f32 and bf16, NCHW memory and
  channels-last views, C 10 and 64, with zeros in the channel padding;
- the packed-form plain GEMM (``int8_conv_packed_plain`` on
  ``int8_quantize_plain`` and ``pack_int8_weights``) against
  ``int8_conv_plain`` on the HWIO kernel bit for bit, and against JAX's
  ``int8_conv2d_static`` / ``int8_phase_conv_static``, for every family
  the R50 sites use;
- ``int8_plan`` at the 42 site shapes of an R50 b16 forward: the limits
  the kernel's entry checks, and, through this file's restatement of
  the kernel's index maps, every output pixel in one M tile, every M x N
  tile once, its K splits covering K exactly once;
- ``QuantConv`` packs once and packs again after a weight change.
"""

import importlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from cris_tpu.ops import quant as jq
from cris_tpu.ops import s2d as js2d
from cris_tpu.ops import upsample_conv as ju
from cris_tpu_torch.models import QuantConfig
from cris_tpu_torch.models.layers import QuantConv
from cris_tpu_torch.ops import quant as pq
from cris_tpu_torch.ops import upsample_conv as pu

# the module (the package exports its function under the same name)
k8 = importlib.import_module("cris_tpu_torch.ops.kernels.int8_conv")

RNG = np.random.RandomState(5)
S = np.float32(0.02)


def _t(a):
    return torch.from_numpy(np.array(a))


def _hwio(packed) -> torch.Tensor:
    """The (kh, kw, C, Co) int8 kernel a ``PackedInt8`` holds."""
    w = packed.w.reshape(packed.co, packed.kh, packed.kw, packed.cp)
    return w[..., :packed.c].permute(1, 2, 3, 0)


def _layout(x: torch.Tensor, layout: str) -> torch.Tensor:
    """An NHWC tensor as a view of channels-last or of NCHW memory."""
    if layout == "nchw":
        return x.permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1)
    return x.contiguous()


@pytest.mark.parametrize("scale", ["dynamic", "saturating"])
@pytest.mark.parametrize("layout", ["nhwc", "nchw"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("c", [10, 64])
def test_quantize_plain_matches_jax(c, dtype, layout, scale):
    x = (RNG.randn(2, 5, 7, c) * 3).astype(np.float32)
    xj = jnp.asarray(x, getattr(jnp, dtype))
    if scale == "dynamic":  # quant.py's quantize_dynamic
        jxq, s = jq.quantize_dynamic(xj)
    else:  # quant.py:87, the static sites' quantiser; |x / s| past 127
        s = S
        jxq = jnp.clip(jnp.round(xj.astype(jnp.float32) / s),
                       -127, 127).astype(jnp.int8)
    xt = _layout(_t(x).to(getattr(torch, dtype)), layout)
    assert xt.is_contiguous() == (layout == "nhwc")
    got = k8.int8_quantize_plain(xt, torch.tensor([np.float32(s)]))
    assert got.c == c and got.q.dtype == torch.int8
    assert got.q.shape == (2, 5, 7, 64) and got.q.is_contiguous()
    assert np.array_equal(got.q[..., :c].numpy(), np.asarray(jxq))
    assert not got.q[..., c:].any()
    if scale == "saturating":
        assert int(got.q.abs().max()) == 127
    # the wrapper takes the plain version on the CPU
    assert torch.equal(k8.int8_quantize(xt, torch.tensor([np.float32(s)])).q,
                       got.q)


def _kernel(kh, kw, c, co):
    return RNG.randn(kh, kw, c, co).astype(np.float32)


# family -> (input (B, H, W, C), HWIO kernel, strides, JAX padding)
FAMILIES = {
    "1x1": ((2, 6, 5, 24), _kernel(1, 1, 24, 20), (1, 1), "VALID"),
    "3x3 SAME": ((2, 6, 5, 24), _kernel(3, 3, 24, 20), (1, 1), "SAME"),
    "2x2 stride-2 pooled": ((2, 6, 8, 24), np.broadcast_to(
        _kernel(1, 1, 24, 20) / 4, (2, 2, 24, 20)).copy(), (2, 2), "VALID"),
    "s2d 3x3": ((2, 4, 3, 4 * 6), np.asarray(js2d.embed_conv3x3_s2d(
        _kernel(3, 3, 6, 5))), (1, 1), "SAME"),
    "C 18, 3x3 SAME": ((2, 5, 6, 18), _kernel(3, 3, 18, 12), (1, 1),
                       "SAME"),
}


@pytest.mark.parametrize("family", list(FAMILIES))
def test_packed_plain_matches_hwio_plain_and_jax(family):
    shape, kernel, strides, padding = FAMILIES[family]
    x = RNG.randn(*shape).astype(np.float32)
    bias = RNG.randn(kernel.shape[-1]).astype(np.float32)
    kq, ks = pq.quantize_channelwise(_t(kernel))
    packed = k8.pack_int8_weights(kq)
    cp = k8.int8_cp(shape[3])
    assert packed.w.shape == (kernel.shape[-1], kernel.shape[0]
                              * kernel.shape[1] * cp)
    assert packed.w.is_contiguous() and torch.equal(_hwio(packed), kq)
    assert not packed.w.reshape(-1, cp)[:, shape[3]:].any()
    s = torch.tensor([S])
    pads = pq.resolve_padding(padding, shape, kernel.shape, strides[0])
    xa = k8.int8_quantize_plain(_t(x), s)
    for relu, out_dtype in ((False, torch.float32), (True, torch.bfloat16)):
        got = k8.int8_conv_packed_plain(xa, packed, ks, s, _t(bias),
                                        strides[0], pads, relu, out_dtype)
        ref = k8.int8_conv_plain(_t(x), kq, ks, s, _t(bias), strides[0],
                                 pads, relu, out_dtype)
        assert got.dtype == out_dtype and torch.equal(got, ref)
    # the site function (one quantise, the packed GEMM) against JAX's
    got = pq.int8_conv2d_static(_t(x), (packed, ks), _t(S), strides, padding,
                                _t(bias)).numpy()
    ref = np.asarray(jq.int8_conv2d_static(x, kernel, S, strides, padding,
                                           bias))
    assert got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("k,pads", [(3, "6"), (1, "4")])
def test_packed_phase_convs_match_jax(k, pads):
    """The 3x3 phase kernels at pads (1, 1) and the 2x2 ones at their four
    asymmetric pads, through one quantise and four packed GEMMs."""
    x = RNG.randn(2, 5, 6, 24).astype(np.float32)
    kernel = _kernel(k, k, 24, 16)
    pk = np.asarray((ju.phase_kernels6 if k == 3 else ju.phase_kernels4)(
        kernel))
    phase_pads = getattr(ju, f"PHASE_PADS{pads}")
    assert phase_pads == getattr(pu, f"PHASE_PADS{pads}")
    pairs = []
    for di in (0, 1):
        for dj in (0, 1):
            kq, ks = pq.quantize_channelwise(_t(pk[di, dj]))
            pairs.append((k8.pack_int8_weights(kq), ks))
    quantised = []
    real = pq.int8_quantize

    def counted(*a, **kw):
        quantised.append(1)
        return real(*a, **kw)
    pq.int8_quantize = counted
    try:
        got = pq.int8_phase_conv_static(_t(x), pairs, phase_pads,
                                        _t(S)).numpy()
    finally:
        pq.int8_quantize = real
    assert len(quantised) == 1
    ref = np.asarray(jq.int8_phase_conv_static(x, pk, phase_pads, S))
    np.testing.assert_array_equal(got, ref)


# the 42 int8 site shapes of an R50 b16 forward at 416 px (chip_smoke.py
# phase 18(a)): (B, H, W, C) -> Co, kh, kw, stride, (top, bottom), (left,
# right)
R50_SITES = [
    ((16, 104, 104, 128), 128, 3, 3, 1, (1, 1), (1, 1)),
    ((16, 104, 104, 128), 256, 3, 3, 1, (1, 1), (1, 1)),
    ((16, 104, 104, 64), 64, 3, 3, 1, (1, 1), (1, 1)),
    ((16, 104, 104, 64), 256, 1, 1, 1, (0, 0), (0, 0)),
    ((16, 104, 104, 256), 256, 1, 1, 1, (0, 0), (0, 0)),
    ((16, 104, 104, 256), 64, 1, 1, 1, (0, 0), (0, 0)),
    ((16, 104, 104, 256), 128, 1, 1, 1, (0, 0), (0, 0)),
    ((16, 104, 104, 256), 512, 2, 2, 2, (0, 0), (0, 0)),
    ((16, 52, 52, 512), 128, 1, 1, 1, (0, 0), (0, 0)),
    ((16, 52, 52, 128), 128, 3, 3, 1, (1, 1), (1, 1)),
    ((16, 52, 52, 128), 512, 1, 1, 1, (0, 0), (0, 0)),
    ((16, 52, 52, 512), 256, 1, 1, 1, (0, 0), (0, 0)),
    ((16, 52, 52, 256), 256, 3, 3, 1, (1, 1), (1, 1)),
    ((16, 52, 52, 256), 1024, 2, 2, 2, (0, 0), (0, 0)),
    ((16, 52, 52, 512), 1024, 2, 2, 2, (0, 0), (0, 0)),
    ((16, 26, 26, 1024), 256, 1, 1, 1, (0, 0), (0, 0)),
    ((16, 26, 26, 256), 256, 3, 3, 1, (1, 1), (1, 1)),
    ((16, 26, 26, 256), 1024, 1, 1, 1, (0, 0), (0, 0)),
    ((16, 26, 26, 1024), 512, 1, 1, 1, (0, 0), (0, 0)),
    ((16, 26, 26, 512), 512, 3, 3, 1, (1, 1), (1, 1)),
    ((16, 26, 26, 512), 2048, 2, 2, 2, (0, 0), (0, 0)),
    ((16, 26, 26, 1024), 2048, 2, 2, 2, (0, 0), (0, 0)),
    ((16, 13, 13, 2048), 512, 1, 1, 1, (0, 0), (0, 0)),
    ((16, 13, 13, 512), 512, 3, 3, 1, (1, 1), (1, 1)),
    ((16, 13, 13, 512), 2048, 1, 1, 1, (0, 0), (0, 0)),
    ((16, 13, 13, 1024), 1024, 1, 1, 1, (0, 0), (0, 0)),
    ((16, 26, 26, 1024), 512, 3, 3, 1, (1, 1), (1, 1)),
    ((16, 13, 13, 1024), 512, 2, 2, 1, (1, 0), (1, 0)),
    ((16, 13, 13, 1024), 512, 2, 2, 1, (1, 0), (0, 1)),
    ((16, 13, 13, 1024), 512, 2, 2, 1, (0, 1), (1, 0)),
    ((16, 13, 13, 1024), 512, 2, 2, 1, (0, 1), (0, 1)),
    ((16, 52, 52, 512), 256, 3, 3, 1, (1, 1), (1, 1)),
    ((16, 26, 26, 768), 512, 1, 1, 1, (0, 0), (0, 0)),
    ((16, 13, 13, 1024), 512, 3, 3, 1, (1, 1), (1, 1)),
    ((16, 13, 13, 512), 512, 2, 2, 1, (1, 0), (1, 0)),
    ((16, 13, 13, 512), 512, 2, 2, 1, (1, 0), (0, 1)),
    ((16, 13, 13, 512), 512, 2, 2, 1, (0, 1), (1, 0)),
    ((16, 13, 13, 512), 512, 2, 2, 1, (0, 1), (0, 1)),
    ((16, 26, 26, 514), 512, 3, 3, 1, (1, 1), (1, 1)),
    # the phase sites of the 3x3 folds write a strided output; the same
    # GEMM shapes as the 26^2 x 512 and 52^2 x 512 -> 256 sites above
    ((16, 26, 26, 512), 512, 3, 3, 1, (1, 1), (1, 1)),
    ((16, 52, 52, 512), 256, 3, 3, 1, (1, 1), (1, 1)),
    # the s2d stem's 3x3 on NCHW memory is the first row's shape again
    ((16, 104, 104, 128), 128, 3, 3, 1, (1, 1), (1, 1)),
]


def test_r50_sites_are_42():
    assert len(R50_SITES) == 42


# int8_conv.cu's index maps, restated here for the cover tests: they are
# not the kernel, whose own cover the card checks (chip_smoke.py phase
# 18(a) holds every plan's output bit-equal to the plain version's)
def _units(plan: dict):
    """The plan's work units in ``unit_of``'s order: (M tile, n0, first
    k-block, end k-block); split j of unit u = j * tiles + tile, N tiles
    fastest within a tile."""
    tiles, tiles_n, kblocks, split = (plan["tiles"], plan["tiles_n"],
                                      plan["kblocks"], plan["split"])
    for u in range(plan["units"]):
        j, tile = divmod(u, tiles)
        tm, tn = divmod(tile, tiles_n)
        yield (tm, tn * k8.TILE_N, j * kblocks // split,
               (j + 1) * kblocks // split)


def _tile_pixels(plan: dict, tm: int) -> torch.Tensor:
    """The output pixels (M-linear: b * Ho * Wo + oy * Wo + ox) of M tile
    ``tm``, as ``pixel_of`` maps a tile's rows."""
    b, ho, wo = plan["out"]
    if plan["loader"] == "linear":
        return torch.arange(tm * plan["bm"],
                            min((tm + 1) * plan["bm"], plan["m"]))
    bg, cs = divmod(tm, plan["segs"])
    img, g = divmod(bg, plan["groups"])
    oy = torch.arange(g * plan["rows"], min((g + 1) * plan["rows"], ho))
    ox = torch.arange(cs * plan["wseg"], min((cs + 1) * plan["wseg"], wo))
    return ((img * ho + oy[:, None]) * wo + ox[None, :]).reshape(-1)


@pytest.mark.parametrize("b", [1, 8, 16])
def test_int8_plan_keeps_the_kernels_limits(b):
    """At the site shapes of every device batch the service pads to (1,
    8, 16 at R50), each plan passes ``cris_int8_conv``'s checks: a tile
    height the kernel has, a whole number of 64-channel K blocks, each box
    within the tile and TMA's 256 a side, the split within K's blocks and
    the grid within the units and the SMs."""
    for (_, h, w, c), co, kh, kw, stride, pv, ph in R50_SITES:
        x, wshape = (b, h, w, c), (kh, kw, c, co)
        plan = k8.int8_plan(x, wshape, stride, (pv, ph))
        assert plan["bm"] in k8.TILE_ROWS and plan["cp"] % k8.K_BLOCK == 0
        assert plan["k"] == plan["kblocks"] * k8.K_BLOCK
        assert 1 <= plan["split"] <= plan["kblocks"]
        assert 1 <= plan["grid"] == min(plan["units"], k8.H100_SMS)
        if plan["loader"] == "boxes":
            assert 1 <= plan["rows"] and plan["rows"] * plan["wseg"] <= \
                plan["bm"]
            assert max(plan["rows"], plan["wseg"]) * stride <= 256
        else:
            assert plan["wseg"] == 0 and (kh, kw, stride) == (1, 1, 1)


@pytest.mark.parametrize("site", R50_SITES, ids=[
    f"{i:02d}-" + "x".join(map(str, s[0])) + f"-{s[1]}-k{s[2]}s{s[4]}"
    for i, s in enumerate(R50_SITES)])
def test_int8_plan_covers_each_tile_and_k_once(site):
    """Every output pixel in exactly one M tile (the boxes' tiles: rows
    of one image by a stretch, each box within TMA's limits), every M x N
    tile once a split, and the splits covering K once."""
    (b, h, w, c), co, kh, kw, stride, pv, ph = site
    plan = k8.int8_plan((b, h, w, c), (kh, kw, c, co), stride, (pv, ph))
    cp = k8.int8_cp(c)
    assert plan["cp"] == cp and cp % k8.K_BLOCK == 0 and cp >= c
    assert plan["kblocks"] * k8.K_BLOCK == plan["k"] == kh * kw * cp
    assert plan["bm"] in k8.TILE_ROWS
    assert plan["stages"] == (6 if plan["bm"] == 256 else 8)
    linear = (kh, kw, stride, pv, ph) == (1, 1, 1, (0, 0), (0, 0))
    assert plan["loader"] == ("linear" if linear else "boxes")
    _, ho, wo, _ = k8.out_shape((b, h, w, c), (kh, kw, c, co), stride,
                                (pv, ph))
    m = b * ho * wo
    assert plan["m"] == m
    if not linear:  # one box a tile: within the tile and TMA's 256
        assert plan["rows"] * plan["wseg"] <= plan["bm"]
        assert max(plan["rows"], plan["wseg"]) * stride <= 256
    tiles_m = plan["tiles"] // plan["tiles_n"]
    assert plan["tiles_n"] == -(-co // k8.TILE_N)
    counts = torch.zeros(m, dtype=torch.int64)
    for tm in range(tiles_m):
        pixels = _tile_pixels(plan, tm)
        assert 0 < len(pixels) <= plan["bm"]
        counts += torch.bincount(pixels, minlength=m)
    assert bool((counts == 1).all())
    ranges = {}
    for tm, n0, kb0, kb1 in _units(plan):
        assert kb1 > kb0
        ranges.setdefault((tm, n0), []).append((kb0, kb1))
    assert set(ranges) == {(tm, tn * k8.TILE_N) for tm in range(tiles_m)
                           for tn in range(plan["tiles_n"])}
    for parts in ranges.values():
        parts.sort()
        assert len(parts) == plan["split"]
        assert parts[0][0] == 0 and parts[-1][1] == plan["kblocks"]
        assert all(a[1] == b[0] for a, b in zip(parts, parts[1:]))
    assert plan["units"] == plan["tiles"] * plan["split"]
    assert plan["grid"] == min(plan["units"], k8.H100_SMS)
    if plan["split"] > 1:
        assert plan["kblocks"] // plan["split"] >= k8.MIN_SPLIT_BLOCKS


@pytest.mark.parametrize("b", [1, 16])
def test_int8_plan_splits_k_where_it_pays(b):
    """The plan's tile and split are the cheapest under its model; at
    batch 1 the 13^2 3x3 site has a few tiles for 132 SMs and splits K,
    each tile's parts covering K once."""
    x, w, pads = (b, 13, 13, 512), (3, 3, 512, 512), ((1, 1), (1, 1))
    plan = k8.int8_plan(x, w, 1, pads)
    for bm in k8.TILE_ROWS:
        for split in range(1, k8.MAX_SPLIT + 1):
            if split == 1 or plan["kblocks"] // split >= k8.MIN_SPLIT_BLOCKS:
                assert k8.int8_plan(x, w, 1, pads, split=split, bm=bm)[
                    "cost_us"] >= plan["cost_us"]
    if b == 1:  # 169 pixels by 4 x 128 channels: a few tiles
        assert plan["tiles"] <= 8 and plan["split"] == k8.MAX_SPLIT
        assert plan["grid"] == plan["tiles"] * k8.MAX_SPLIT
    parts = sorted((kb0, kb1) for tm, n0, kb0, kb1 in _units(plan)
                   if (tm, n0) == (0, 0))
    assert len(parts) == plan["split"]
    assert parts[0][0] == 0 and parts[-1][1] == plan["kblocks"]
    assert all(p[1] == q[0] for p, q in zip(parts, parts[1:]))


def _site(conv, x):
    conv.eval()
    conv.quant = QuantConfig(min_ch=8, pooled_min_ch=8, upfold_min_ch=8)
    conv.act_scale = torch.tensor(0.05)
    return conv(x)


def test_quant_conv_packs_once_and_again_after_a_weight_change(monkeypatch):
    packs = []
    real = pq.pack_int8_weights

    def counted(wq, *a, **k):
        packs.append(tuple(wq.shape))
        return real(wq, *a, **k)
    monkeypatch.setattr(pq, "pack_int8_weights", counted)
    torch.manual_seed(0)
    conv = QuantConv(16, 24, 3, padding=1, family="backbone")
    x = torch.randn(2, 16, 6, 5)
    with torch.no_grad():
        y1 = _site(conv, x)
        y2 = conv(x)
    assert packs == [(3, 3, 16, 24)] and torch.equal(y1, y2)
    packed, ks, bias = conv._int8["plain"][1]
    kq = _hwio(packed)
    assert torch.equal(kq, pq.quantize_channelwise(conv._hwio())[0])
    assert packed.cp == 64
    ref = k8.int8_conv_plain(x.permute(0, 2, 3, 1), kq, ks,
                             conv.act_scale.reshape(1), bias, 1,
                             ((1, 1), (1, 1))).permute(0, 3, 1, 2)
    assert torch.equal(y1, ref)
    with torch.no_grad():
        conv.weight.add_(torch.randn_like(conv.weight))
        y3 = conv(x)
    assert len(packs) == 2 and not torch.equal(y3, y1)
    kq3 = _hwio(conv._int8["plain"][1][0])
    assert not torch.equal(kq3, kq)
    assert torch.equal(kq3, pq.quantize_channelwise(conv._hwio())[0])

    # the phase site: four packed phase kernels, once until the weights
    # change
    del packs[:]
    up = QuantConv(16, 24, 3, padding=1, family="upfold")
    up.eval()
    up.quant = QuantConfig(min_ch=8, pooled_min_ch=8, upfold_min_ch=8)
    up.act_scale = torch.tensor(0.05)
    xn = torch.randn(2, 5, 6, 16)

    def core():
        return up.phase_site(xn, torch.float32, pu.phase_kernels6,
                             pu.PHASE_PADS6, lambda: None)
    with torch.no_grad():
        c1, c2 = core(), core()
        assert len(packs) == 4 and torch.equal(c1, c2)
        up.weight.add_(0.25)
        c3 = core()
    assert len(packs) == 8 and not torch.equal(c3, c1)
    assert c3.shape == (2, 10, 12, 24)
