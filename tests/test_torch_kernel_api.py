"""K3, K4 and K6 of the PyTorch port on the CPU, the JAX package's public
kernel API (cris_tpu/ops/pallas/__init__.py): each port function, which
takes its plain version on a CPU tensor, against the Pallas kernel in
interpret mode on the same numpy inputs. f32 at the JAX tests' own
tolerances (1e-5 for attention and the matmul, 2e-5 for LayerNorm, 1e-4
for gradients), bf16 at 2e-2. The CUDA kernels are held against these
plain versions on the card by chip_smoke.py phase 11."""

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


@pytest.mark.parametrize("rows,want", [
    (1, (1, 16)), (16, (1, 16)), (100, (7, 16)), (4224, (264, 16)),
    (10816, (264, 41)),  # the decoder's LN sites at B 16
])
def test_layer_norm_backward_blocks(rows, want):
    nb, chunk = port_ln.backward_blocks(rows)
    assert (nb, chunk) == want
    assert (nb - 1) * chunk < rows <= nb * chunk <= rows + chunk - 1


def test_layer_norm_backward_partials_per_block():
    """100 rows: six blocks of 16 and a last one of 4. Each partial row is
    its block's sum of g * xhat (dscale) and of g (dbias); their sum is
    JAX's."""
    x, s, b = _ln_inputs((4, 25, 128), 25)
    g = np.random.RandomState(26).randn(4, 25, 128).astype(np.float32)
    dx, ds, db = port_ln.layer_norm_backward_plain(T(x), T(s), T(g))
    assert ds.shape == db.shape == (7, 128) and ds.dtype == torch.float32
    x2, g2 = x.reshape(100, 128).astype(np.float64), g.reshape(100, 128)
    xc = x2 - x2.mean(-1, keepdims=True)
    xhat = xc / np.sqrt((xc ** 2).mean(-1, keepdims=True) + 1e-5)
    for i in range(7):
        rows = slice(16 * i, min(16 * i + 16, 100))
        np.testing.assert_allclose(ds[i].numpy(), (g2 * xhat)[rows].sum(0),
                                   rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(db[i].numpy(), g2[rows].sum(0), rtol=1e-5,
                                   atol=1e-5)
    _, vjp = jax.vjp(lambda *a: jax_layer_norm(*a, 1e-5, True),
                     *(jnp.asarray(a) for a in (x, s, b)))
    for got, want in zip((dx, ds.sum(0), db.sum(0)), vjp(jnp.asarray(g))):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                                   atol=1e-4)
    sums = layer_norm_backward(T(x), T(s), T(g))
    for got, want in zip(sums, (dx, ds.sum(0), db.sum(0))):
        torch.testing.assert_close(got, want, rtol=0, atol=0)


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
