"""The port's attention on the train path, on the CPU, against the JAX
package: K1's plain backward against ``jax.vjp`` of the JAX kernel
(interpret mode), the Philox keep mask and its packed form, and K2's
plain forward and backward against the JAX XLA dropout path fed the same
mask. f32 at rtol = atol = 1e-5. The Pallas dropout kernel itself cannot
run here (interpret mode has no TPU PRNG; test_pallas.py skips it), so
K2's plain backward is held to the JAX backward kernel's rounding points
directly. The CUDA kernels are held against these plain versions on the
card by chip_smoke.py (phases 5 and 6)."""

import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cris_tpu.ops.attention import dot_product_attention as jax_attention
from cris_tpu.ops.pallas.attention import fused_attention_bse as jax_fused

from cris_tpu_torch.ops import attention as port_ops
from cris_tpu_torch.ops.kernels import (attention_bse_backward_plain,
                                        attention_dropout_backward_plain,
                                        attention_dropout_plain, attention_plain,
                                        fused_attention_bse_dropout,
                                        keep_bits_packed, keep_mask)
from cris_tpu_torch.ops.kernels import dropout_mask
# the module-scoped autouse fixture that runs torch on one thread
from test_torch_train import _one_torch_thread  # noqa: F401

TOL = dict(rtol=1e-5, atol=1e-5)


def _inputs(b, h, s, t, d, padded, seed=0):
    rng = np.random.RandomState(seed)
    q = rng.randn(b, s, h * d).astype(np.float32)
    k = rng.randn(b, t, h * d).astype(np.float32)
    v = rng.randn(b, t, h * d).astype(np.float32)
    g = rng.randn(b, s, h * d).astype(np.float32)
    valid = np.ones((b, t), bool)
    if padded:
        valid[0, t // 2:] = False
        valid[-1, t - 5:] = False
    return q, k, v, g, valid


@pytest.mark.parametrize("padded", [False, True], ids=["no_mask", "key_mask"])
def test_k1_backward_plain_matches_jax_vjp(padded):
    b, h, s, t, d = 2, 4, 30, 21, 16
    q, k, v, g, valid = _inputs(b, h, s, t, d, padded, seed=1)
    kv = jnp.asarray(valid) if padded else None
    _, vjp = jax.vjp(lambda q, k, v: jax_fused(q, k, v, h, kv, None, True),
                     jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    ref = vjp(jnp.asarray(g))
    got = attention_bse_backward_plain(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), h,
        torch.from_numpy(valid) if padded else None, torch.from_numpy(g))
    for name, x, r in zip("qkv", got, ref):
        np.testing.assert_allclose(x.numpy(), np.asarray(r), err_msg=name, **TOL)


def test_k1_backward_plain_matches_autograd():
    """The recompute backward equals autograd through ``attention_plain``
    (what chip_smoke.py holds the CUDA path against)."""
    q, k, v, g, valid = _inputs(2, 4, 12, 17, 16, True, seed=2)
    qt, kt, vt = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    attention_plain(qt, kt, vt, 4, torch.from_numpy(valid)).backward(
        torch.from_numpy(g))
    got = attention_bse_backward_plain(
        *(torch.from_numpy(x) for x in (q, k, v)), 4, torch.from_numpy(valid),
        torch.from_numpy(g))
    for x, r in zip(got, (qt.grad, kt.grad, vt.grad)):
        np.testing.assert_allclose(x.numpy(), r.numpy(), **TOL)


def test_philox_known_answers():
    """Random123's known-answer vectors for Philox4x32-10."""
    cases = [
        ((0, 0, 0, 0), (0, 0),
         (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
        ((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2,
         (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
        ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344),
         (0xA4093822, 0x299F31D0),
         (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
    ]
    for ctr, key, want in cases:
        got = dropout_mask.philox4x32_10(
            *(torch.tensor(c, dtype=torch.int64) for c in ctr), *key)
        assert tuple(int(w) for w in got) == want


def test_keep_bits_follow_the_counter_layout():
    """bits[b, h, i, j] = philox((j >> 2, i, h, b), seed words)[j & 3]."""
    seed = (7 << 32) | 12345
    bits = dropout_mask.keep_bits(seed, 2, 3, 5, 10)
    assert bits.shape == (2, 3, 5, 10)
    for b, h, i, j in [(0, 0, 0, 0), (1, 2, 4, 9), (0, 1, 3, 6), (1, 0, 2, 3)]:
        words = dropout_mask.philox4x32_10(
            *(torch.tensor(c, dtype=torch.int64) for c in (j >> 2, i, h, b)),
            12345, 7)
        assert int(bits[b, h, i, j]) == int(words[j & 3])


def test_keep_mask_per_seed_and_position():
    a = keep_mask(3, 2, 2, 40, 50, 0.5)
    np.testing.assert_array_equal(a.numpy(), keep_mask(3, 2, 2, 40, 50, 0.5).numpy())
    assert (a != keep_mask(4, 2, 2, 40, 50, 0.5)).any()
    assert (a[0, 0] != a[1, 0]).any() and (a[0, 0] != a[0, 1]).any()
    assert keep_mask(3, 2, 2, 40, 50, 0.0).all()


def test_keep_fraction_and_threshold_rule():
    rate, shape = 0.1, (4, 8, 64, 100)
    bits = dropout_mask.keep_bits(11, *shape)
    keep = keep_mask(11, *shape, rate)
    thr = dropout_mask.keep_threshold(rate)
    assert thr == int(0.1 * 2**32)
    np.testing.assert_array_equal(keep.numpy(), (bits >= thr).numpy())
    assert 0 <= int(bits.min()) and int(bits.max()) < 2**32
    n = keep.numel()
    frac = keep.float().mean().item()
    assert abs(frac - 0.9) < 6 * math.sqrt(0.9 * 0.1 / n), frac
    assert dropout_mask.keep_threshold(0.0) == 0
    assert dropout_mask.keep_threshold(1.0 - 2**-40) == 2**32 - 1
    with pytest.raises(ValueError):
        dropout_mask.keep_threshold(1.0)
    with pytest.raises(ValueError):
        dropout_mask.seed_words(2**63)


@pytest.mark.parametrize("padded", [False, True], ids=["no_mask", "key_mask"])
def test_dropout_plain_matches_jax_xla_path(monkeypatch, padded):
    """Forward and gradients against cris_tpu's XLA dropout path, with
    jax.random.bernoulli returning the port's Philox mask."""
    b, h, s, t, d, rate, seed = 2, 4, 24, 19, 16, 0.25, 99
    q, k, v, g, valid = _inputs(b, h, s, t, d, padded, seed=3)
    mask = keep_mask(seed, b, h, s, t, rate).numpy()
    monkeypatch.setattr(jax.random, "bernoulli",
                        lambda key, p, shape: jnp.asarray(mask))
    kpm = jnp.asarray(~valid) if padded else None

    def jax_fn(q, k, v):
        return jax_attention(q, k, v, h, key_padding_mask=kpm,
                             dropout_rate=rate,
                             dropout_rng=jax.random.PRNGKey(0),
                             deterministic=False)

    ref, vjp = jax.vjp(jax_fn, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    ref_grads = vjp(jnp.asarray(g))
    qt, kt, vt = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = attention_dropout_plain(qt, kt, vt, h,
                                  torch.from_numpy(valid) if padded else None,
                                  rate, seed)
    out.backward(torch.from_numpy(g))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), **TOL)
    for x, r in zip((qt, kt, vt), ref_grads):
        np.testing.assert_allclose(x.grad.numpy(), np.asarray(r), **TOL)


def _jax_dropout_grads(monkeypatch, q, k, v, g, valid, h, rate, mask,
                       padded):
    """(dq, dk, dv) of cris_tpu's XLA dropout path by jax.vjp on the JAX
    arrays q, k, v, g, with jax.random.bernoulli returning ``mask``."""
    monkeypatch.setattr(jax.random, "bernoulli",
                        lambda key, p, shape: jnp.asarray(mask))
    kpm = jnp.asarray(~valid) if padded else None

    def jax_fn(q, k, v):
        return jax_attention(q, k, v, h, key_padding_mask=kpm,
                             dropout_rate=rate,
                             dropout_rng=jax.random.PRNGKey(0),
                             deterministic=False)

    return jax.vjp(jax_fn, q, k, v)[1](g)


@pytest.mark.parametrize("padded", [False, True], ids=["no_mask", "key_mask"])
def test_dropout_backward_plain_matches_jax_vjp(monkeypatch, padded):
    """K2's plain backward (the JAX backward kernel's rounding points) in
    f32, where every rounding is the identity, against jax.vjp of the XLA
    dropout path fed the port's mask, at rate 0.25."""
    b, h, s, t, d, rate, seed = 2, 4, 24, 19, 16, 0.25, 31
    q, k, v, g, valid = _inputs(b, h, s, t, d, padded, seed=6)
    mask = keep_mask(seed, b, h, s, t, rate).numpy()
    ref = _jax_dropout_grads(monkeypatch, *(jnp.asarray(x) for x in (q, k, v, g)),
                             valid, h, rate, mask, padded)
    got = attention_dropout_backward_plain(
        *(torch.from_numpy(x) for x in (q, k, v)), h,
        torch.from_numpy(valid) if padded else None, rate, seed,
        torch.from_numpy(g))
    for name, x, r in zip("qkv", got, ref):
        np.testing.assert_allclose(x.numpy(), np.asarray(r), err_msg=name, **TOL)


def _bf16(x):
    return torch.from_numpy(x).to(torch.bfloat16)


@pytest.mark.parametrize("padded", [False, True], ids=["no_mask", "key_mask"])
def test_dropout_backward_plain_bf16_matches_jax_vjp(monkeypatch, padded):
    """The same in bf16: q, k, v and g rounded to bf16 and fed to both.
    The JAX XLA path's autodiff rounds dW to bf16 where the cast of the
    weights to v's dtype sits, the JAX kernel (and so the plain backward)
    does not, so the two agree to bf16 rounding: the phase-2 bf16 bars in
    units of the reference's RMS, rtol = atol = 2e-2 and a mean |err| below
    2e-3."""
    b, h, s, t, d, rate, seed = 2, 4, 24, 19, 16, 0.25, 32
    q, k, v, g, valid = _inputs(b, h, s, t, d, padded, seed=7)
    q, k, v, g = (_bf16(x) for x in (q, k, v, g))
    mask = keep_mask(seed, b, h, s, t, rate).numpy()
    ref = _jax_dropout_grads(
        monkeypatch, *(jnp.asarray(x.float().numpy(), jnp.bfloat16)
                       for x in (q, k, v, g)), valid, h, rate, mask, padded)
    got = attention_dropout_backward_plain(
        q, k, v, h, torch.from_numpy(valid) if padded else None, rate, seed, g)
    for name, x, r in zip("qkv", got, ref):
        assert x.dtype == torch.bfloat16, name
        r = np.asarray(r.astype(jnp.float32))
        x = x.float().numpy()
        scale = max(1.0, float(np.sqrt(np.mean(r ** 2))))
        np.testing.assert_allclose(x, r, rtol=2e-2, atol=2e-2 * scale,
                                   err_msg=name)
        assert np.abs(x - r).mean() < 2e-3 * scale, name


def test_dropout_backward_plain_rounds_where_jax_rounds():
    """On bf16 inputs the plain backward differs from the f32 computation
    exactly by rounding wd, g and dS to bf16 (attention_train.py:112-133):
    a reference written out here that rounds those three tensors by hand
    gives its bits, and without the rounding the result moves. In f32 it
    is autograd through attention_dropout_plain."""
    b, h, s, t, d, rate, seed = 2, 4, 20, 17, 16, 0.3, 8
    q, k, v, g, valid = _inputs(b, h, s, t, d, True, seed=8)
    qb, kb, vb, gb = (_bf16(x) for x in (q, k, v, g))
    vt = torch.from_numpy(valid)
    got = attention_dropout_backward_plain(qb, kb, vb, h, vt, rate, seed, gb)

    def by_hand(round_them):
        rnd = ((lambda x: x.to(torch.bfloat16).float()) if round_them
               else (lambda x: x))
        qh, kh, vh, gh = (x.float().reshape(b, -1, h, d).transpose(1, 2)
                          for x in (qb, kb, vb, gb))
        logits = qh @ kh.transpose(-1, -2) * d ** -0.5
        logits = logits.masked_fill(~vt[:, None, None, :], -1e30)
        w = torch.softmax(logits, -1)
        keep = keep_mask(seed, b, h, s, t, rate)
        wd = rnd(torch.where(keep, w, 0.0) / (1 - rate))
        gr = rnd(gh)
        dv = wd.transpose(-1, -2) @ gr
        dw = torch.where(keep, gr @ vh.transpose(-1, -2), 0.0) / (1 - rate)
        ds = rnd(w * (dw - (dw * w).sum(-1, keepdim=True)))
        dq = ds @ kh * d ** -0.5
        dk = ds.transpose(-1, -2) @ qh * d ** -0.5
        return [x.transpose(1, 2).reshape(b, -1, h * d).to(torch.bfloat16)
                for x in (dq, dk, dv)]

    for name, x, r in zip("qkv", got, by_hand(True)):
        torch.testing.assert_close(x, r, rtol=0, atol=0, msg=name)
    assert any(not torch.equal(x, r) for x, r in zip(got, by_hand(False)))

    qt, kt, vt32 = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    attention_dropout_plain(qt, kt, vt32, h, vt, rate, seed).backward(
        torch.from_numpy(g))
    got32 = attention_dropout_backward_plain(
        *(torch.from_numpy(x) for x in (q, k, v)), h, vt, rate, seed,
        torch.from_numpy(g))
    for x, r in zip(got32, (qt.grad, kt.grad, vt32.grad)):
        np.testing.assert_allclose(x.numpy(), r.numpy(), **TOL)


@pytest.mark.parametrize("t", [17, 32, 37, 100])
def test_packed_keep_bits_match_keep_mask(t):
    """keep_bits_packed, the plain version of the tensor-core forward's
    bitmask: bit j % 32 of word j // 32 is keep_mask's column j, bit for
    bit, and the bits past T are 0."""
    b, h, s, seed = 2, 3, 5, (5 << 32) | 77

    def unpacked(rate):
        words = keep_bits_packed(seed, b, h, s, t, rate)
        assert words.dtype == torch.int32
        assert words.shape == (b, h, s, (t + 31) // 32)
        bits = (words.long()[..., None] >> torch.arange(32)) & 1
        return bits.reshape(b, h, s, -1).bool()

    bits = unpacked(0.3)
    np.testing.assert_array_equal(bits[..., :t].numpy(),
                                  keep_mask(seed, b, h, s, t, 0.3).numpy())
    assert not bits[..., t:].any()
    everything = unpacked(0.0)  # rate 0 keeps every weight
    assert everything[..., :t].all() and not everything[..., t:].any()


def test_dropout_rate0_equals_k1_plain():
    q, k, v, _, valid = _inputs(2, 4, 20, 13, 16, True, seed=4)
    args = [torch.from_numpy(x) for x in (q, k, v)]
    got = attention_dropout_plain(*args, 4, torch.from_numpy(valid), 0.0, 5)
    ref = attention_plain(*args, 4, torch.from_numpy(valid))
    torch.testing.assert_close(got, ref, rtol=0, atol=0)


def test_dropout_wrapper_on_cpu_is_the_plain_version():
    q, k, v, _, valid = _inputs(1, 2, 9, 7, 8, True, seed=5)
    args = [torch.from_numpy(x) for x in (q, k, v)]
    before = fused_attention_bse_dropout.launches
    got = fused_attention_bse_dropout(*args, 2, torch.from_numpy(valid), 0.3, 8)
    ref = attention_dropout_plain(*args, 2, torch.from_numpy(valid), 0.3, 8)
    torch.testing.assert_close(got, ref, rtol=0, atol=0)
    assert fused_attention_bse_dropout.launches == before
    meta = torch.empty(1, 4, 8, device="meta")
    with pytest.raises(ValueError):
        fused_attention_bse_dropout(meta, meta, meta, 2, None, 0.1, 1)


def _port_tiny(dropout):
    from cris_tpu_torch.models import CLIPConfig, CRIS, init_weights

    ccfg = CLIPConfig(64, 64, (1, 1, 1, 1), 16, None, 77, 49408, 64, 4, 2)
    model = CRIS(ccfg, fpn_in=(128, 256, 64), fpn_out=(32, 64, 128),
                 vis_dim=64, num_layers=2, num_head=4, dim_ffn=128,
                 dropout=dropout)
    return init_weights(model, 0)


def test_dispatch_routes_train_and_eval(monkeypatch):
    """In training the decoder sites take the dropout route (K2), the
    attnpool K1, the causal text encoder the plain path; in eval nothing
    takes the dropout route."""
    calls = []

    def spy(name):
        inner = getattr(port_ops, name)

        def wrapped(q, k, v, *args, **kwargs):
            calls.append((name, q.shape[1], k.shape[1]))
            return inner(q, k, v, *args, **kwargs)

        monkeypatch.setattr(port_ops, name, wrapped)

    for name in ("fused_attention_bse", "fused_attention_bse_dropout",
                 "attention_plain", "attention_dropout_plain"):
        spy(name)
    model = _port_tiny(0.1)
    rng = np.random.RandomState(0)
    img = torch.from_numpy(rng.randn(2, 3, 64, 64).astype(np.float32))
    word = torch.from_numpy(rng.randint(1, 400, (2, 17)))
    word[:, 9:] = 0
    mask = torch.from_numpy((rng.rand(2, 1, 64, 64) > 0.5).astype(np.float32))

    model.train()
    model(img, word, mask, dropout_seed=1)[2].backward()
    dec = 16  # the decoder's 4 x 4 grid at 64 px
    want = sorted([("fused_attention_bse_dropout", dec, dec)] * 2
                  + [("fused_attention_bse_dropout", dec, 17)] * 2
                  + [("fused_attention_bse", 4, 4)]
                  + [("attention_plain", 17, 17)] * 2)
    assert sorted(calls) == want

    calls.clear()
    model.eval()
    with torch.no_grad():
        model(img, word)
    assert not [c for c in calls if "dropout" in c[0]]
    assert sorted(calls) == sorted([("fused_attention_bse", dec, dec)] * 2
                                   + [("fused_attention_bse", dec, 17)] * 2
                                   + [("fused_attention_bse", 4, 4)]
                                   + [("attention_plain", 17, 17)] * 2)


def test_decoder_sites_draw_distinct_seeds(monkeypatch):
    """Each site of each layer gets its own K2 seed, fixed by the step's
    seed."""
    seen = []

    def record(q, k, v, num_heads, kv_valid, rate, seed, batch_offset=0,
               head_offset=0):
        seen.append(seed)
        return attention_dropout_plain(q, k, v, num_heads, kv_valid, rate, seed,
                                       batch_offset=batch_offset,
                                       head_offset=head_offset)

    monkeypatch.setattr(port_ops, "fused_attention_bse_dropout", record)
    model = _port_tiny(0.1).train()
    img = torch.zeros(1, 3, 64, 64)
    word = torch.ones(1, 17, dtype=torch.long)
    with torch.no_grad():
        model(img, word, dropout_seed=5)
        model(img, word, dropout_seed=5)
        model(img, word, dropout_seed=6)
    assert len(seen) == 12
    assert len(set(seen[:4])) == 4
    assert seen[:4] == seen[4:8] and seen[:4] != seen[8:]
    with pytest.raises(ValueError, match="dropout_seed"), torch.no_grad():
        model(img, word)
