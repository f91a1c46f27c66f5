"""K3, K4 and K6 of the PyTorch port on the CPU, the JAX package's public
kernel API (cris_tpu/ops/pallas/__init__.py): each port function, which
takes its plain version on a CPU tensor, against the Pallas kernel in
interpret mode on the same numpy inputs. f32 at the JAX tests' own
tolerances (1e-5 for attention and the matmul, 2e-5 for LayerNorm, 1e-4
for gradients), bf16 at 2e-2. The CUDA kernels are held against these
plain versions on the card by chip_smoke.py phase 11."""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cris_tpu.ops.pallas.attention import fused_attention as jax_attention
from cris_tpu.ops.pallas.fused_matmul import conv1x1_fused as jax_conv1x1
from cris_tpu.ops.pallas.fused_matmul import fused_matmul as jax_matmul
from cris_tpu.ops.pallas.layernorm import layer_norm as jax_layer_norm
from cris_tpu.ops.pallas.layernorm import supports as jax_supports

from cris_tpu_torch.ops.kernels import (conv1x1_fused, fused_attention,
                                        fused_matmul, fused_matmul_plain,
                                        layer_norm, layer_norm_backward)
from cris_tpu_torch.ops.kernels import layernorm as port_ln

BF16 = dict(rtol=2e-2, atol=2e-2)
T = torch.from_numpy


def _f32(x):
    return np.array(jnp.asarray(x, jnp.float32))


# ---------------------------------------------------------------- K3


def _attention_inputs(b, h, s, t, d, masked, seed=0):
    rng = np.random.RandomState(seed)
    q = rng.randn(b, h, s, d).astype(np.float32)
    k = rng.randn(b, h, t, d).astype(np.float32)
    v = rng.randn(b, h, t, d).astype(np.float32)
    valid = np.ones((b, t), bool)
    if masked:  # padded keys, never a whole row
        valid[0, t // 2:] = False
        valid[-1, t - 5:] = False
    return q, k, v, valid


@pytest.mark.parametrize("b,h,s,t,d,masked", [
    (2, 4, 50, 50, 64, False),   # decoder self-attention, small
    (2, 4, 50, 17, 64, True),    # cross-attention over padded words
    (1, 4, 100, 37, 32, True),   # odd sizes
])
def test_fused_attention_matches_jax_kernel(b, h, s, t, d, masked):
    q, k, v, valid = _attention_inputs(b, h, s, t, d, masked)
    ref = jax_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                        jnp.asarray(valid) if masked else None, None, True)
    got = fused_attention(T(q), T(k), T(v), T(valid) if masked else None)
    assert got.shape == (b, h, s, d) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)


def test_fused_attention_bf16_matches_jax_kernel():
    q, k, v, _ = _attention_inputs(1, 2, 64, 64, 64, False, seed=2)
    bf = [jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)]
    ref = jax_attention(*bf, None, None, True)
    got = fused_attention(*(T(_f32(x)).to(torch.bfloat16) for x in bf))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), _f32(ref), **BF16)


def test_fused_attention_gradients_match_jax_grad():
    """The port's autograd.Function (plain forward, plain recompute
    backward) against jax.grad through the JAX custom_vjp."""
    q, k, v, valid = _attention_inputs(1, 2, 40, 20, 32, True, seed=3)
    ct = np.random.RandomState(4).randn(1, 2, 40, 32).astype(np.float32)

    def loss(q, k, v):
        out = jax_attention(q, k, v, jnp.asarray(valid), None, True)
        return (out * jnp.asarray(ct)).sum()

    ref = jax.grad(loss, argnums=(0, 1, 2))(*(jnp.asarray(x) for x in (q, k, v)))
    qt, kt, vt = (T(x).requires_grad_() for x in (q, k, v))
    (fused_attention(qt, kt, vt, T(valid)) * T(ct)).sum().backward()
    for got, want in zip((qt.grad, kt.grad, vt.grad), ref):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                                   atol=1e-4)


# ---------------------------------------------------------------- K4


def _matmul_inputs(m, k, n, seed=5):
    rng = np.random.RandomState(seed)
    return (rng.randn(m, k).astype(np.float32),
            rng.randn(k, n).astype(np.float32),
            rng.randn(n).astype(np.float32),
            rng.randn(m, n).astype(np.float32))


@pytest.mark.parametrize("residual", [True, False])
@pytest.mark.parametrize("relu", [True, False])
def test_fused_matmul_matches_jax_kernel(residual, relu):
    """The JAX test's ragged (300, 70) -> 130."""
    x, w, b, r = _matmul_inputs(300, 70, 130)
    ref = jax_matmul(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                     jnp.asarray(r) if residual else None, relu=relu,
                     interpret=True)
    got = fused_matmul(T(x), T(w), T(b), T(r) if residual else None, relu)
    assert got.shape == (300, 130) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)


def test_fused_matmul_bf16_matches_jax_kernel():
    """bf16 x and w, f32 bias: one rounding after the f32 epilogue."""
    x, w, b, r = _matmul_inputs(96, 64, 72, seed=6)
    xb, wb, rb = (jnp.asarray(a, jnp.bfloat16) for a in (x, w, r))
    ref = jax_matmul(xb, wb, jnp.asarray(b), rb, relu=True, interpret=True)
    to_bf = lambda a: T(_f32(a)).to(torch.bfloat16)  # noqa: E731
    got = fused_matmul(to_bf(xb), to_bf(wb), T(b), to_bf(rb), True)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), _f32(ref), **BF16)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_conv1x1_fused_matches_jax(dtype):
    """A (2, 5, 7, 48) NHWC map to 96 channels with an HWIO kernel, a
    residual and the ReLU."""
    rng = np.random.RandomState(7)
    x = rng.randn(2, 5, 7, 48).astype(np.float32)
    kern = (rng.randn(1, 1, 48, 96) * 48 ** -0.5).astype(np.float32)
    bias = rng.randn(96).astype(np.float32)
    res = rng.randn(2, 5, 7, 96).astype(np.float32)
    jx, jr = (jnp.asarray(a, dtype) for a in (x, res))
    ref = jax_conv1x1(jx, jnp.asarray(kern), jnp.asarray(bias), jr, relu=True,
                      interpret=True)
    tdt = getattr(torch, dtype)
    got = conv1x1_fused(T(_f32(jx)).to(tdt), T(kern), T(bias),
                        T(_f32(jr)).to(tdt), relu=True)
    assert got.shape == (2, 5, 7, 96) and got.dtype == tdt
    tol = dict(rtol=1e-5, atol=1e-5) if dtype == "float32" else BF16
    np.testing.assert_allclose(got.float().numpy(), _f32(ref), **tol)


def test_fused_matmul_refuses_mixed_dtypes():
    x, w, b, _ = _matmul_inputs(8, 16, 8)
    for fn in (fused_matmul, fused_matmul_plain):
        with pytest.raises(ValueError):
            fn(T(x).to(torch.bfloat16), T(w), T(b))


def test_fused_matmul_rounds_once_under_autocast():
    """bf16 under CPU autocast: the same bits as without it (autocast's
    matmul would round x @ w to bf16 before the bias), within one bf16
    rounding of the exact value."""
    x, w, b, _ = _matmul_inputs(64, 256, 32, seed=8)
    xb, wb = T(x).to(torch.bfloat16), T(w).to(torch.bfloat16)
    plain = fused_matmul(xb, wb, T(b))
    with torch.autocast("cpu", dtype=torch.bfloat16):
        got = fused_matmul(xb, wb, T(b))
    assert torch.equal(got, plain)
    exact = xb.double() @ wb.double() + T(b).double()
    torch.testing.assert_close(got.double(), exact, rtol=2.0 ** -8, atol=1e-4)


# ---------------------------------------------------------------- K6


def _ln_inputs(shape, seed):
    rng = np.random.RandomState(seed)
    c = shape[-1]
    return (rng.randn(*shape).astype(np.float32) * 2 + 1,
            (1 + 0.1 * rng.randn(c)).astype(np.float32),
            (0.1 * rng.randn(c)).astype(np.float32))


def test_layer_norm_matches_jax_kernel():
    x, s, b = _ln_inputs((3, 40, 256), 21)
    ref = jax_layer_norm(jnp.asarray(x), jnp.asarray(s), jnp.asarray(b), 1e-5,
                         True)
    got = layer_norm(T(x), T(s), T(b))
    assert got.shape == x.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=2e-5,
                               atol=2e-5)


def test_layer_norm_bf16_matches_jax_kernel():
    x, s, b = _ln_inputs((2, 17, 512), 23)
    xb = jnp.asarray(x, jnp.bfloat16)
    ref = jax_layer_norm(xb, jnp.asarray(s), jnp.asarray(b), 1e-5, True)
    got = layer_norm(T(_f32(xb)).to(torch.bfloat16), T(s), T(b))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), _f32(ref), **BF16)


def test_layer_norm_gradients_match_jax_grad():
    x, s, b = _ln_inputs((2, 10, 128), 22)
    ct = np.random.RandomState(24).randn(2, 10, 128).astype(np.float32)
    ref = jax.grad(lambda *a: (jax_layer_norm(*a, 1e-5, True) * ct).sum(),
                   argnums=(0, 1, 2))(*(jnp.asarray(a) for a in (x, s, b)))
    xt, st, bt = (T(a).requires_grad_() for a in (x, s, b))
    (layer_norm(xt, st, bt) * T(ct)).sum().backward()
    for got, want in zip((xt.grad, st.grad, bt.grad), ref):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                                   atol=1e-4)


# the backward kernel's sweep threads (csrc/layernorm.cu: kSweepThreads)
SWEEP_THREADS = 256


def _bwd_schedule(x, scale, g, sms, eps=1e-5):
    """layer_norm_bwd_kernel's schedule in plain f32 torch, on a card of sms
    SMs: backward_partition's tiles of R rows, block b walking tiles b, b +
    grid, ...; each row's dx from its own statistics; dscale and dbias as
    each block sums them over its tiles in order, either fused (row slot
    i R + r of the block to row warp (i R + r) % 16, the warps added in
    order) or by the column sweep (row k of a tile to thread group
    k % groups, the groups added in order); the finish, lane l of a warp
    adding blocks l, l + 32, ... in order, then the warp's xor butterfly
    over the 32 lanes' sums. Returns dx, dscale, dbias, the (2, grid, C)
    partial rows and (R, stages, grid). Asserts that every row is summed
    once."""
    c = x.shape[-1]
    x2, g2 = x.reshape(-1, c).float(), g.reshape(-1, c).float()
    rows = x2.shape[0]
    r, stages, grid = port_ln.backward_partition(rows, c, x.element_size(),
                                                 sms)
    xc = x2 - x2.mean(-1, keepdim=True)
    rstd = torch.rsqrt((xc * xc).mean(-1, keepdim=True) + eps)
    xhat = xc * rstd
    gs = g2 * scale.float()
    dx = rstd * (gs - gs.mean(-1, keepdim=True)
                 - xhat * (gs * xhat).mean(-1, keepdim=True))
    if port_ln.backward_fused(c, r):
        groups = 2 * port_ln.BWD_ROW_WARPS
        group_of = lambda i, k: (i * r + k) % groups  # noqa: E731
    else:
        nvec = c // (16 // x.element_size())
        groups = 1 if nvec >= SWEEP_THREADS else SWEEP_THREADS // nvec
        group_of = lambda i, k: k % groups  # noqa: E731
    tiles = -(-rows // r)
    part = torch.zeros(2, grid, c)
    summed = torch.zeros(rows, dtype=torch.int64)
    for b in range(grid):
        acc = torch.zeros(groups, 2, c)
        for i, t in enumerate(range(b, tiles, grid)):
            for k in range(min(r, rows - t * r)):
                row = t * r + k
                summed[row] += 1
                acc[group_of(i, k), 0] += g2[row] * xhat[row]
                acc[group_of(i, k), 1] += g2[row]
        for grp in range(groups):
            part[:, b] += acc[grp]
    assert (summed == 1).all()
    lanes = torch.stack([_in_order(part[:, lane::32]) for lane in range(32)])
    for off in (16, 8, 4, 2, 1):
        lanes = lanes + lanes[[lane ^ off for lane in range(32)]]
    sums = lanes[0]
    return dx.to(x.dtype).reshape(x.shape), sums[0], sums[1], part, (
        r, stages, grid)


def _in_order(blocks):
    """(2, n, C) -> (2, C): the n rows added one after another, in f32."""
    total = torch.zeros(blocks.shape[0], blocks.shape[2])
    for k in range(blocks.shape[1]):
        total += blocks[:, k]
    return total


@pytest.mark.parametrize("sms", [132, 2])
@pytest.mark.parametrize("rows,want", [
    (1, {132: (1, 4, 1), 2: (1, 4, 1)}),
    (16, {132: (1, 4, 16), 2: (8, 4, 2)}),
    (100, {132: (1, 4, 100), 2: (13, 4, 2)}),
    (4224, {132: (16, 4, 132), 2: (16, 4, 2)}),
    (10816, {132: (14, 4, 132), 2: (16, 4, 2)}),  # the decoder's LN sites
])
def test_layer_norm_backward_blocks(rows, want, sms):
    """backward_partition at the decoder's width (C 512, bf16): every row in
    one tile, at most one block an SM and a tile a block, a stage of at
    most BWD_STAGE_BYTES and the ring within BWD_RING_BYTES, the blocks'
    tile counts at most one apart."""
    r, stages, grid = port_ln.backward_partition(rows, 512, 2, sms)
    assert (r, stages, grid) == want[sms]
    tiles = -(-rows // r)
    assert (tiles - 1) * r < rows <= tiles * r
    assert 1 <= grid <= min(sms, tiles)
    assert r * 2 * 512 * 2 <= port_ln.BWD_STAGE_BYTES
    assert stages * r * 2 * 512 * 2 <= port_ln.BWD_RING_BYTES
    per_block = [len(range(b, tiles, grid)) for b in range(grid)]
    assert max(per_block) - min(per_block) <= 1


@pytest.mark.parametrize("sms", [132, 2])
def test_layer_norm_backward_partials_per_block(sms):
    """100 rows of 128: each of the schedule's partial rows is its block's
    sum of g * xhat (dscale) and of g (dbias) over the tiles it walks;
    the finished sums and dx are JAX's, and layer_norm_backward's."""
    x, s, b = _ln_inputs((4, 25, 128), 25)
    g = np.random.RandomState(26).randn(4, 25, 128).astype(np.float32)
    dx, ds, db, part, (r, _, grid) = _bwd_schedule(T(x), T(s), T(g), sms)
    assert part.shape == (2, grid, 128) and part.dtype == torch.float32
    x2, g2 = x.reshape(100, 128).astype(np.float64), g.reshape(100, 128)
    xc = x2 - x2.mean(-1, keepdims=True)
    xhat = xc / np.sqrt((xc ** 2).mean(-1, keepdims=True) + 1e-5)
    tiles = -(-100 // r)
    for i in range(grid):
        mine = np.concatenate([np.arange(t * r, min(t * r + r, 100))
                               for t in range(i, tiles, grid)])
        np.testing.assert_allclose(part[0, i].numpy(),
                                   (g2 * xhat)[mine].sum(0), rtol=1e-4,
                                   atol=1e-4)
        np.testing.assert_allclose(part[1, i].numpy(), g2[mine].sum(0),
                                   rtol=1e-5, atol=1e-5)
    _, vjp = jax.vjp(lambda *a: jax_layer_norm(*a, 1e-5, True),
                     *(jnp.asarray(a) for a in (x, s, b)))
    for got, want in zip((dx, ds, db), vjp(jnp.asarray(g))):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                                   atol=1e-4)
    for got, want in zip(layer_norm_backward(T(x), T(s), T(g)), (dx, ds, db)):
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("rows,c,itemsize,fused", [
    (10816, 512, 2, True), (10816, 512, 4, True),    # the decoder's LNs
    (10816, 2048, 2, False), (10816, 2048, 4, False),  # the FFN's LN
    (272, 512, 2, False), (272, 512, 4, False),      # the text LN
])
def test_layer_norm_backward_schedule_at_sites(rows, c, itemsize, fused):
    """On 132 SMs the decoder's LNs take the fused schedule (tiles of 8 or
    more rows at C 512), the FFN's and the text encoder's the sweep."""
    r, _, _ = port_ln.backward_partition(rows, c, itemsize, 132)
    assert port_ln.backward_fused(c, r) == fused


@functools.lru_cache(maxsize=None)
def _jax_ln_vjp(rows, c, dtype):
    """Inputs (x, scale, g as numpy, x and g on the dtype's grid) and JAX
    layer_norm's vjp (dx, dscale, dbias) in interpret mode."""
    x, s, b = _ln_inputs((rows, c), 27 + rows + c)
    g = np.random.RandomState(28 + rows).randn(rows, c).astype(np.float32)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    xj, gj = jnp.asarray(x, jdt), jnp.asarray(g, jdt)
    _, vjp = jax.vjp(lambda *a: jax_layer_norm(*a, 1e-5, True), xj,
                     jnp.asarray(s), jnp.asarray(b))
    return (_f32(xj), s, _f32(gj)), tuple(_f32(t) for t in vjp(gj))


@pytest.mark.parametrize("sms", [132, 2])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("c", [128, 512, 2048])
@pytest.mark.parametrize("rows", [1, 31, 100, 272])
def test_layer_norm_backward_schedule_matches_jax(rows, c, dtype, sms):
    """The backward kernel's schedule, emulated (_bwd_schedule), against
    JAX layer_norm's vjp in interpret mode and against the plain version:
    f32 at 1e-4, bf16 at the file's BF16."""
    (x, s, g), want = _jax_ln_vjp(rows, c, dtype)
    tdt = getattr(torch, dtype)
    xt, gt = T(x).to(tdt), T(g).to(tdt)
    got = _bwd_schedule(xt, T(s), gt, sms)[:3]
    assert got[0].dtype == tdt and got[0].shape == (rows, c)
    assert got[1].dtype == got[2].dtype == torch.float32
    plain = port_ln.layer_norm_backward_plain(xt, T(s), gt)
    tol = dict(rtol=1e-4, atol=1e-4) if dtype == "float32" else BF16
    for a, w, p_ in zip(got, want, plain):
        np.testing.assert_allclose(a.float().numpy(), w, **tol)
        np.testing.assert_allclose(a.float().numpy(), p_.float().numpy(),
                                   **tol)


@pytest.mark.parametrize("c", [64, 128, 200, 2048, 8192, 8320])
def test_layer_norm_supports(c):
    """The JAX gate, and the kernel's register-held row up to 8192."""
    assert port_ln.supports(c) == (jax_supports(c) and c <= 8192)


# ---------------------------------------------------- all three kernels


def test_cpu_calls_launch_nothing():
    """Every CPU call takes the plain version: each counter stays at 0."""
    q, k, v, valid = _attention_inputs(1, 2, 8, 8, 16, True)
    qt = T(q).requires_grad_()
    fused_attention(qt, T(k), T(v), T(valid)).sum().backward()
    x, w, b, r = _matmul_inputs(8, 16, 8)
    fused_matmul(T(x), T(w), T(b), T(r), True)
    conv1x1_fused(T(x).view(2, 2, 2, 16), T(w)[None, None], T(b))
    xl = torch.randn(4, 128, requires_grad=True)
    layer_norm(xl, torch.ones(128), torch.zeros(128)).sum().backward()
    counters = (fused_attention, fused_matmul, layer_norm, layer_norm_backward)
    assert [fn.launches for fn in counters] == [0, 0, 0, 0]


def test_kernel_wrappers_refuse_other_devices():
    """A tensor neither on the CPU nor on a CUDA card is refused, never
    computed by the plain version."""
    meta = torch.empty(1, 2, 8, 16, device="meta")
    with pytest.raises(ValueError):
        fused_attention(meta, meta, meta)
    with pytest.raises(ValueError):
        fused_matmul(meta[0, 0], meta[0, 0].t(), torch.empty(8, device="meta"))
    with pytest.raises(ValueError):
        layer_norm(torch.empty(4, 128, device="meta"),
                   torch.empty(128, device="meta"),
                   torch.empty(128, device="meta"))
