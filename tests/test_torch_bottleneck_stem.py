"""K5 (fused bottleneck) and K7 (fused stem + pool) in the PyTorch port
against the JAX package, on the CPU.

The plain versions, which the port's wrappers take for CPU tensors, are
held against the JAX Pallas kernels in interpret mode on the same numpy
inputs: f32 at the JAX tests' own bar (1e-4, tests/test_pallas.py:195
and :402). In bf16 both round at the same points, but their f32 sums run
in other orders, so now and then an intermediate rounds to the other
neighbouring bf16 value (2^-8 relative) and carries that into the output:
the bar there is PERF.md's bf16 bar, 2e-2 max and 2e-3 mean in units of
the reference's RMS. Then the folded visual encoder with both switches on
is held against the JAX model with both ``CRIS_PALLAS_*`` switches and
interpret mode, at tests/test_pallas.py:444's 2e-4.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cris_tpu_torch.ops.kernels import (bottleneck_plain, fused_bottleneck,
                                        fused_stem_pool, stem_pool_plain)
from cris_tpu_torch.ops.kernels.bottleneck import _tc_rows
from cris_tpu_torch.ops.kernels.stem import pool2x2_as_jax


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One torch intra-op thread: the suite runs several pytest workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _bf16_close(got, ref):
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    scale = max(1.0, float(np.sqrt(np.mean(ref ** 2))))
    err = np.abs(got - ref)
    np.testing.assert_allclose(got, ref, rtol=2e-2, atol=2e-2 * scale)
    assert err.mean() < 2e-3 * scale, (err.mean(), scale)


def _torch(x, dtype=torch.float32):
    return torch.from_numpy(np.asarray(x, np.float32)).to(dtype)


def _numpy(t):
    return t.float().numpy()


def _bottleneck_inputs(h, w, c, mid, seed=7):
    rng = np.random.RandomState(seed)
    return [rng.randn(2, h, w, c).astype(np.float32),
            rng.randn(c, mid).astype(np.float32) * 0.02,
            rng.randn(mid).astype(np.float32) * 0.1,
            rng.randn(9, mid, mid).astype(np.float32) * 0.02,
            rng.randn(mid).astype(np.float32) * 0.1,
            rng.randn(mid, c).astype(np.float32) * 0.02,
            rng.randn(c).astype(np.float32) * 0.1]


@pytest.mark.parametrize("h,w,c,mid,row_splits,dtype", [
    (16, 16, 256, 128, 4, "float32"),   # banded: halo seams in JAX
    (13, 13, 512, 128, 1, "float32"),   # odd width, whole image
    (16, 16, 256, 128, 2, "bfloat16"),
])
def test_bottleneck_plain_matches_jax_kernel(h, w, c, mid, row_splits, dtype):
    from cris_tpu.ops.pallas.bottleneck import fused_bottleneck as jax_k5

    args = _bottleneck_inputs(h, w, c, mid)
    jdt = jnp.dtype(dtype)
    tdt = getattr(torch, dtype)
    # x and weights in the compute dtype, biases f32, as the models pass them
    jargs = [jnp.asarray(a, jdt if i in (0, 1, 3, 5) else jnp.float32)
             for i, a in enumerate(args)]
    targs = [_torch(a, tdt if i in (0, 1, 3, 5) else torch.float32)
             for i, a in enumerate(args)]
    ref = np.asarray(jax_k5(*jargs, row_splits=row_splits, interpret=True)
                     .astype(jnp.float32))
    got = bottleneck_plain(*targs)
    assert got.dtype == tdt and tuple(got.shape) == (2, h, w, c)
    if dtype == "float32":
        np.testing.assert_allclose(_numpy(got), ref, rtol=1e-4, atol=1e-4)
    else:
        _bf16_close(_numpy(got), ref)
    # the CPU wrapper is the plain version, kernel counter untouched
    before = fused_bottleneck.launches
    torch.testing.assert_close(fused_bottleneck(*targs), got, rtol=0, atol=0)
    assert fused_bottleneck.launches == before


def _tc_body_emulation(x, w1, b1, w2, b2, w3, b3, r_band, bm1, bm23,
                       shift):
    """bottleneck_tc_kernel's decomposition in plain torch: bands of
    r_band rows (the last one short where H % r_band != 0); conv1 into y1,
    whose row m holds position m - shift of the band's flat padded grid
    ((r_band + 2) rows of W + 2), over conv1's M tiles of bm1 rows, 0
    outside the image; conv2 as nine products of y1 rows shifted by
    dy (W + 2) + dx + shift over the flat index of M2 rows; conv3 plus b3
    and x, the junk columns and the rows past the band dropped."""
    dt = x.dtype
    n, h, w, c = x.shape
    wp = w + 2
    m1, m2 = _tc_rows(r_band, w, bm23, shift)
    tiles1 = -(-m1 // bm1) * bm1  # conv1's last M tile may pass y1
    xf = x.float()
    out = torch.full_like(x, float("nan"))
    for r0 in range(0, h, r_band):
        rows = min(r_band, h - r0)
        p = torch.arange(tiles1) - shift
        i, j = torch.div(p, wp, rounding_mode="floor"), p % wp
        r, col = r0 - 1 + i, j - 1
        inside = (i < r_band + 2) & (r >= 0) & (r < h) & (col >= 0) & (col < w)
        inside &= i >= 0
        a = torch.zeros(n, tiles1, c)
        a[:, inside] = xf[:, r[inside], col[inside]]
        y1 = (torch.relu(a @ w1.float() + b1) * inside[:, None]).to(dt).float()
        y1 = y1[:, :m1]
        q = torch.arange(m2)
        acc = sum(y1[:, q + dy * wp + dx + shift] @ w2[3 * dy + dx].float()
                  for dy in range(3) for dx in range(3))
        y2 = torch.relu(acc + b2).to(dt).float()
        i, j = q // wp, q % wp
        keep = (i < rows) & (j < w)
        ri, cj = r0 + i[keep], j[keep]
        y = (y2 @ w3.float() + b3)[:, keep] + xf[:, ri, cj]
        out[:, ri, cj] = torch.relu(y).to(dt)
    return out


@pytest.mark.parametrize("h,w,c,mid,r_band,bm1,bm23,shift", [
    (11, 9, 128, 64, 4, 32, 32, 0),    # H % R = 3: a short last band
    (13, 13, 128, 64, 2, 64, 32, 0),   # layer4's width and tiles
    (7, 20, 64, 64, 8, 64, 128, 1),    # one band taller than the image
    (10, 12, 64, 64, 4, 128, 32, 1),   # pixel pairs, a short last band
])
def test_tc_body_decomposition_matches_plain_and_jax(h, w, c, mid, r_band,
                                                     bm1, bm23, shift):
    """The tensor-core body's bands, halo, padded grid, nine row offsets
    and junk columns, emulated on the CPU in f32, against the plain
    version and the JAX kernel in interpret mode at 1e-4: a halo, padding
    or junk-column error shows here before it reaches the card."""
    from cris_tpu.ops.pallas.bottleneck import fused_bottleneck as jax_k5

    args = _bottleneck_inputs(h, w, c, mid, seed=5)
    targs = [_torch(a) for a in args]
    got = _tc_body_emulation(*targs, r_band, bm1, bm23, shift)
    assert torch.isfinite(got).all()  # every output position written
    np.testing.assert_allclose(_numpy(got), _numpy(bottleneck_plain(*targs)),
                               rtol=1e-4, atol=1e-4)
    ref = jax_k5(*[jnp.asarray(a) for a in args], row_splits=1,
                 interpret=True)
    np.testing.assert_allclose(_numpy(got), np.asarray(ref), rtol=1e-4,
                               atol=1e-4)


def test_bottleneck_wrapper_takes_the_autocast_dtype():
    """Under autocast the compute dtype is the autocast dtype, as the JAX
    module's ``dtype`` is: f32 inputs go in and bf16 comes out, equal to
    the plain version on bf16-cast inputs."""
    args = [_torch(a) for a in _bottleneck_inputs(8, 8, 64, 16, seed=3)]
    with torch.autocast("cpu", dtype=torch.bfloat16):
        got = fused_bottleneck(*args)
    cast = [a.bfloat16() if i in (0, 1, 3, 5) else a for i, a in enumerate(args)]
    assert got.dtype == torch.bfloat16
    torch.testing.assert_close(got, bottleneck_plain(*cast), rtol=0, atol=0)


def _stem_inputs(seed=0, c=(8, 8, 16)):
    rs = np.random.RandomState(seed)
    c1, c2, c3 = c
    return [rs.randn(2, 64, 64, 3).astype(np.float32),
            rs.randn(3, 3, 3, c1).astype(np.float32) * 0.2,
            rs.randn(c1).astype(np.float32) * 0.1,
            rs.randn(3, 3, c1, c2).astype(np.float32) * 0.2,
            rs.randn(c2).astype(np.float32) * 0.1,
            rs.randn(3, 3, c2, c3).astype(np.float32) * 0.2,
            rs.randn(c3).astype(np.float32) * 0.1]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_pool2x2_as_jax_equals_the_jax_kernels_pool_bitwise(dtype):
    """K7's pool, bit for bit against the JAX kernel's own expressions on
    one seeded map: the row pairs' mean cast to the dtype in the kernel
    (cris_tpu/ops/pallas/stem.py:142), the column pairs added in the dtype
    after it (:203)."""
    jdt = jnp.dtype(dtype)
    y = np.random.RandomState(4).rand(2, 12, 10, 24).astype(np.float32) * 3
    yj = jnp.asarray(y, jdt)
    y3 = yj.astype(jnp.float32)
    rows = ((y3[:, 0::2] + y3[:, 1::2]) * 0.25).astype(jdt)
    ref = np.asarray((rows[:, :, 0::2] + rows[:, :, 1::2]).astype(jnp.float32))
    got = pool2x2_as_jax(_torch(np.asarray(yj.astype(jnp.float32)),
                                getattr(torch, dtype)))
    assert got.dtype == getattr(torch, dtype) and got.shape == (2, 6, 5, 24)
    np.testing.assert_array_equal(_numpy(got), ref)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_stem_pool_plain_matches_jax_kernel(dtype):
    from cris_tpu.ops.pallas.stem import fused_stem_pool as jax_k7

    args = _stem_inputs()
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    # the image in f32 (cast inside), kernels in the dtype, biases f32
    jargs = [jnp.asarray(a, jdt if i in (1, 3, 5) else jnp.float32)
             for i, a in enumerate(args)]
    targs = [_torch(a, tdt if i in (1, 3, 5) else torch.float32)
             for i, a in enumerate(args)]
    ref = np.asarray(jax_k7(*jargs, interpret=True).astype(jnp.float32))
    got = stem_pool_plain(*targs)
    assert got.dtype == tdt and tuple(got.shape) == (2, 16, 16, 16)
    if dtype == "float32":
        np.testing.assert_allclose(_numpy(got), ref, rtol=1e-4, atol=1e-4)
    else:
        _bf16_close(_numpy(got), ref)
    before = fused_stem_pool.launches
    torch.testing.assert_close(fused_stem_pool(*targs), got, rtol=0, atol=0)
    assert fused_stem_pool.launches == before


def _tc_stem_emulation(img, k1, b1, k2, b2, k3, b3, th, tw):
    """stem_tc_kernel's decomposition in plain torch, at k1's dtype's
    rounding points: tiles of th x tw conv3 outputs (the last band and
    column short where the map ends); a channel-major image patch of
    (2 th + 9) x (2 tw + 12) from image row 2 (u3 - 2) - 1 and column
    2 (x3 - 2) - 4, 0 outside the image, rounded to the dtype; conv1 over
    the flat a1 grid ((the + 4) rows of twe + 4, from conv-grid (u3 - 2,
    x3 - 2)) in M units of 32 rows, its A rows gathered from the patch at
    2 i pc + 2 j + 3 plus each depth k = (3 ky + kx) 3 + ci's offset
    ci pr pc + ky pc + kx (k >= 27: offset 0, zero weights), 0 outside the
    image; conv2 over the flat index
    of (the + 2) rows of twe + 2, each lane's a1 row i (twe + 4) + j plus
    the nine row offsets dy (twe + 4) + dx, units' rows past the grid
    reading row 0; conv3 over row pairs x 16-column chunks, columns past
    twe reading column twe - 1, plus dy (twe + 2) + dx; the pool's two
    roundings. torch raises if any read leaves the kernel's buffers."""
    dt = k1.dtype
    n, h, w, _ = img.shape
    h2, w2 = h // 2, w // 2
    c1, c3 = k1.shape[-1], k3.shape[-1]
    pr, pc = 2 * th + 9, 2 * tw + 12

    def rnd(x):
        return x.to(dt).float()

    k = torch.arange(32)
    tap, ci = k // 3, k % 3
    koff = torch.where(k < 27, ci * pr * pc + (tap // 3) * pc + tap % 3, 0)
    w1 = torch.zeros(32, c1)
    w1[:27] = k1.float().reshape(27, c1)
    k2f, k3f = k2.float(), k3.float()
    img_r = rnd(img.float())
    out = torch.full((n, h // 4, w // 4, c3), float("nan"))
    for u3 in range(0, h2, th):
        the = min(th, h2 - u3)
        for x3 in range(0, w2, tw):
            twe = min(tw, w2 - x3)
            ir = 2 * (u3 - 2) - 1 + torch.arange(pr)
            ic = 2 * (x3 - 2) - 4 + torch.arange(pc)
            inside = (((ir >= 0) & (ir < h))[:, None]
                      & ((ic >= 0) & (ic < w))[None, :])
            sub = img_r[:, ir.clamp(0, h - 1)][:, :, ic.clamp(0, w - 1)]
            patch = (sub * inside[..., None]).permute(0, 3, 1, 2)
            flat = patch.reshape(n, -1)

            def keep(i, j, halo):
                u, v = u3 - halo + i, x3 - halo + j
                return ((u >= 0) & (u < h2) & (v >= 0) & (v < w2))[:, None]

            wg1, m1 = twe + 4, (the + 4) * (twe + 4)
            m = torch.arange(-(-m1 // 32) * 32)
            i, j = m // wg1, m % wg1
            pbase = torch.where(m < m1, 2 * i * pc + 2 * j + 3, 0)
            acc = flat[:, pbase[:, None] + koff[None, :]] @ w1
            a1 = rnd(torch.where(keep(i, j, 2), torch.relu(acc + b1), 0.0))
            a1 = a1[:, :m1]

            wg2, m2 = twe + 2, (the + 2) * (twe + 2)
            q = torch.arange(-(-m2 // 32) * 32)
            i, j = q // wg2, q % wg2
            base = torch.where(q < m2, i * wg1 + j, 0)
            acc = sum(a1[:, base + dy * wg1 + dx] @ k2f[dy, dx]
                      for dy in range(3) for dx in range(3))
            a2 = rnd(torch.where(keep(i, j, 1), torch.relu(acc + b2), 0.0))
            a2 = a2[:, :m2]

            cols = 16 * -(-twe // 16)
            base = (torch.arange(the)[:, None] * wg2
                    + torch.arange(cols).clamp(max=twe - 1)[None, :])
            base = base.reshape(-1)
            acc = sum(a2[:, base + dy * wg2 + dx] @ k3f[dy, dx]
                      for dy in range(3) for dx in range(3))
            a3 = rnd(torch.relu(acc + b3)).reshape(n, the, cols, c3)
            r = rnd((a3[:, 0::2] + a3[:, 1::2]) * 0.25)
            y = rnd(r[:, :, 0::2] + r[:, :, 1::2])[:, :, :twe // 2]
            out[:, u3 // 2:(u3 + the) // 2, x3 // 2:(x3 + twe) // 2] = y
    return out.to(dt)


@pytest.mark.parametrize("h,w,th,tw,dtype,jax_takes", [
    (32, 48, 16, 32, "float32", True),    # a tile wider than the map
    (48, 40, 8, 16, "float32", True),     # a partial column tile
    (64, 64, 2, 64, "float32", True),     # the thinnest band, 2x the map
    (100, 76, 16, 32, "float32", False),  # partial bands and column tiles
    (36, 68, 64, 16, "float32", False),   # a tile taller than the map
    (100, 76, 16, 32, "bfloat16", False),
])
def test_tc_stem_decomposition_matches_plain_and_jax(h, w, th, tw, dtype,
                                                     jax_takes):
    """The tensor-core stem's tiles, halo, flat grids with their edge
    widths, nine row offsets, conv1's patch gather and the pool, emulated
    on the CPU, against the plain version at 1e-4 (bf16: the bf16 bar) and,
    where the JAX kernel takes the shape (H/2 a multiple of 8, W/2 + 2 <=
    210), against it in interpret mode at 1e-4: an indexing error shows
    here before it reaches the card."""
    from cris_tpu.ops.pallas.stem import fused_stem_pool as jax_k7

    rs = np.random.RandomState(h + w + th)
    args = [rs.randn(2, h, w, 3).astype(np.float32)] + _stem_inputs(
        seed=h + tw, c=(16, 16, 16))[1:]
    tdt = getattr(torch, dtype)
    targs = [_torch(a, tdt if i in (1, 3, 5) else torch.float32)
             for i, a in enumerate(args)]
    got = _tc_stem_emulation(*targs, th, tw)
    assert got.dtype == tdt and tuple(got.shape) == (2, h // 4, w // 4, 16)
    assert torch.isfinite(got).all()  # every pooled output written
    plain = stem_pool_plain(*targs)
    if dtype == "bfloat16":
        _bf16_close(_numpy(got), _numpy(plain))
        return
    np.testing.assert_allclose(_numpy(got), _numpy(plain), rtol=1e-4,
                               atol=1e-4)
    if jax_takes:
        ref = jax_k7(*[jnp.asarray(a) for a in args], interpret=True)
        np.testing.assert_allclose(_numpy(got), np.asarray(ref), rtol=1e-4,
                                   atol=1e-4)


def test_wrappers_reject_what_the_kernels_do_not_take():
    x, *wts = [_torch(a) for a in _bottleneck_inputs(8, 8, 64, 16, seed=3)]
    with pytest.raises(ValueError):
        from cris_tpu_torch.ops.kernels.bottleneck import _launch
        _launch(x, wts[0][:, :8], *wts[1:])
    img, *ks = [_torch(a) for a in _stem_inputs()]
    from cris_tpu_torch.ops.kernels.stem import _launch as stem_launch
    with pytest.raises(ValueError):
        stem_launch(img[:, :62], *ks)


def _randomize_bn(variables, seed):
    """Non-trivial BN affines and running statistics, from a seed: scale
    U(0.5, 1.5), bias N(0, 0.1), mean N(0, 0.1), var U(0.5, 1.5)."""
    rng = np.random.RandomState(seed)

    def stats(node):
        if isinstance(node, dict):
            if "mean" in node and "var" in node:
                return {"mean": rng.randn(*np.shape(node["mean"])) * 0.1,
                        "var": rng.uniform(0.5, 1.5, np.shape(node["var"]))}
            return {k: stats(v) for k, v in node.items()}
        return node

    def params(node, bn_paths, path=()):
        if isinstance(node, dict):
            if path in bn_paths:
                return {"scale": rng.uniform(0.5, 1.5, np.shape(node["scale"])),
                        "bias": rng.randn(*np.shape(node["bias"])) * 0.1}
            return {k: params(v, bn_paths, path + (k,)) for k, v in node.items()}
        return node

    def bn_paths(node, path=()):
        if isinstance(node, dict):
            if "mean" in node and "var" in node:
                return {path}
            return set().union(*[bn_paths(v, path + (k,))
                                 for k, v in node.items()] or [set()])
        return set()

    out = {"params": params(variables["params"],
                            bn_paths(variables["batch_stats"])),
           "batch_stats": stats(variables["batch_stats"])}
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), out)


def test_folded_visual_encoder_with_both_kernels_matches_jax(monkeypatch):
    """ModifiedResNet (1, 2, 2, 1), width 64, at 128 px, BN folded, both
    switches on: the port (plain versions on the CPU) against the JAX
    model with CRIS_PALLAS_STEM / CRIS_PALLAS_BOTTLENECK and interpret
    mode, on the same weights. The embedding is trained at 2 x 2 and
    pre-resized to 4 x 4 by each package's fold. At 128 px the JAX stem
    kernel runs (it needs H, W % 16) and K5 runs on the layer2 and layer3
    tails (16 x 16 x 512 / 128 and 8 x 8 x 1024 / 256)."""
    import cris_tpu.ops.pallas as pallas_pkg
    from cris_tpu.checkpoint import fold_batchnorm as jax_fold
    from cris_tpu.models.clip_resnet import ModifiedResNet as JaxResNet
    from cris_tpu_torch.checkpoint.fold import fold_batchnorm
    from cris_tpu_torch.checkpoint.from_jax import (_Emitter, _visual,
                                                    unstack_scanned)
    from cris_tpu_torch.models import clip_resnet
    from cris_tpu_torch.models.clip_resnet import ModifiedResNet

    layers = (1, 2, 2, 1)
    kw = dict(layers=layers, output_dim=64, heads=4, input_resolution=64,
              width=64)
    img = np.random.RandomState(3).randn(2, 128, 128, 3).astype(np.float32)
    jmodel = JaxResNet(**kw, dtype=None)
    variables = _randomize_bn(
        jmodel.init(jax.random.PRNGKey(0), jnp.asarray(img), train=False), 11)

    monkeypatch.setenv("CRIS_PALLAS_BOTTLENECK", "1")
    monkeypatch.setenv("CRIS_PALLAS_STEM", "1")
    monkeypatch.setattr(pallas_pkg, "pallas_mode", lambda: "interpret")
    jfolded = JaxResNet(**kw, dtype=None, fold_bn=True, fuse_pool=True,
                        pos_grid=4)
    ref = jfolded.apply(jax_fold(variables, input_resolution=128),
                        jnp.asarray(img), train=False)

    em = _Emitter()
    _visual(em, unstack_scanned(variables["params"]),
            unstack_scanned(variables["batch_stats"]), layers, "v")
    sd = fold_batchnorm({k[2:]: v for k, v in em.sd.items()},
                        input_resolution=128)
    port = ModifiedResNet(**kw, fold_bn=True, pos_grid=4,
                          fused_bottleneck=True, fused_stem=True).eval()
    port.load_state_dict(sd, strict=True)

    calls = {"k5": 0, "k7": 0}

    def spy(name, fn):
        def wrapper(*args):
            calls[name] += 1
            return fn(*args)
        return wrapper

    monkeypatch.setattr(clip_resnet, "fused_bottleneck",
                        spy("k5", clip_resnet.fused_bottleneck))
    monkeypatch.setattr(clip_resnet, "fused_stem_pool",
                        spy("k7", clip_resnet.fused_stem_pool))
    with torch.no_grad():
        got = port(torch.from_numpy(img).permute(0, 3, 1, 2))
    assert calls == {"k5": sum(layers) - len(layers), "k7": 1}
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.permute(0, 2, 3, 1).numpy(),
                                   np.asarray(r), rtol=2e-4, atol=2e-4)


def test_kernel_switches_need_the_folded_eval_model():
    from cris_tpu_torch.models import build_segmenter
    from cris_tpu_torch.utils import CfgNode

    cfg = CfgNode(dict(clip_pretrain="TINY", fpn_in=[128, 256, 64],
                       fpn_out=[32, 64, 128], vis_dim=64, num_layers=2,
                       num_head=4, dim_ffn=128, dropout=0.0))
    with pytest.raises(ValueError):
        build_segmenter(cfg, device="meta", fused_stem=True)
    with pytest.raises(ValueError):
        build_segmenter(cfg, device="meta", fold_bn=True, train=True,
                        fused_bottleneck=True)
    model = build_segmenter(cfg, device="cpu", fold_bn=True, fused_stem=True)
    model.train()
    with pytest.raises(RuntimeError):
        model.backbone.visual(torch.zeros(1, 3, 64, 64))
