"""K1 of the PyTorch port on the CPU: its plain version against the JAX
kernel (interpret mode) and the JAX attention path, f32 at atol = rtol =
1e-5. The CUDA kernel itself is checked against this plain version on the
card by chip_smoke.py (these tests import JAX, which that machine lacks)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from cris_tpu.ops.attention import causal_mask as jax_causal_mask
from cris_tpu.ops.attention import dot_product_attention as jax_attention
from cris_tpu.ops.pallas.attention import fused_attention_bse as jax_fused

from cris_tpu_torch.ops import attention as port_ops
from cris_tpu_torch.ops.kernels import attention_plain, fused_attention_bse

TOL = dict(rtol=1e-5, atol=1e-5)

# (B, H, S, T, D, padded): the main path's sites at a small size
SHAPES = {
    "self": (2, 4, 50, 50, 64, False),
    "cross_padded": (2, 4, 50, 17, 64, True),
    "attnpool": (2, 8, 49, 49, 64, False),
    "odd": (1, 4, 100, 37, 32, True),
    # head dims that the kernel pads to its 16- and 64-wide tiles
    "head_dim_16": (2, 4, 16, 17, 16, True),
    "head_dim_48": (1, 2, 30, 21, 48, True),
}


def _inputs(b, h, s, t, d, padded, seed=0):
    rng = np.random.RandomState(seed)
    q = rng.randn(b, s, h * d).astype(np.float32)
    k = rng.randn(b, t, h * d).astype(np.float32)
    v = rng.randn(b, t, h * d).astype(np.float32)
    valid = np.ones((b, t), bool)
    if padded:
        valid[0, t // 2:] = False
        valid[-1, t - 5:] = False
    return q, k, v, valid


@pytest.mark.parametrize("site", sorted(SHAPES))
def test_plain_matches_jax_kernel(site):
    """The plain K1 against the Pallas kernel in interpret mode."""
    b, h, s, t, d, padded = SHAPES[site]
    q, k, v, valid = _inputs(b, h, s, t, d, padded)
    ref = jax_fused(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), h,
                    jnp.asarray(valid) if padded else None, None, True)
    got = fused_attention_bse(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), h,
                              torch.from_numpy(valid) if padded else None)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("site", sorted(SHAPES))
def test_dispatch_matches_jax_attention(site):
    """The port's dot_product_attention against the JAX one, with the
    key-padding mask in the JAX convention (True = ignore)."""
    b, h, s, t, d, padded = SHAPES[site]
    q, k, v, valid = _inputs(b, h, s, t, d, padded, seed=1)
    kpm = ~valid if padded else None
    ref = jax_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), h,
                        key_padding_mask=None if kpm is None else jnp.asarray(kpm))
    got = port_ops.dot_product_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), h,
        key_padding_mask=None if kpm is None else torch.from_numpy(kpm))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


def test_causal_text_attention_matches_jax():
    """The text encoder's site: additive causal mask, plain path."""
    q, k, v, _ = _inputs(2, 4, 17, 17, 16, False, seed=2)
    ref = jax_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), 4,
                        attn_mask=jax_causal_mask(17))
    got = port_ops.dot_product_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), 4,
        attn_mask=port_ops.causal_mask(17))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
    np.testing.assert_array_equal(port_ops.causal_mask(17).numpy(),
                                  np.asarray(jax_causal_mask(17)))


def test_fully_masked_row_returns_mean_v():
    """Every key of sample 0 masked: the finite mask value makes the
    weights uniform, so the row is mean(V), as in the JAX XLA path."""
    q, k, v, valid = _inputs(2, 4, 20, 9, 32, False, seed=3)
    valid[0] = False
    got = fused_attention_bse(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), 4, torch.from_numpy(valid))
    ref = jax_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), 4,
                        key_padding_mask=jnp.asarray(~valid))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
    mean_v = np.broadcast_to(v[0].mean(axis=0), got[0].shape)
    np.testing.assert_allclose(got[0].numpy(), mean_v, **TOL)


def test_plain_bf16_rounds_like_the_reference():
    """bf16 inputs: f32 logits and softmax, weights cast to bf16 before the
    f32-accumulated product, output in bf16 -- the XLA path's rounding."""
    q, k, v, valid = _inputs(1, 2, 30, 11, 32, True, seed=4)
    to_bf = lambda x: torch.from_numpy(x).to(torch.bfloat16)  # noqa: E731
    got = attention_plain(to_bf(q), to_bf(k), to_bf(v), 2,
                          torch.from_numpy(valid))
    assert got.dtype == torch.bfloat16
    ref = jax_attention(jnp.asarray(q, jnp.bfloat16), jnp.asarray(k, jnp.bfloat16),
                        jnp.asarray(v, jnp.bfloat16), 2,
                        key_padding_mask=jnp.asarray(~valid))
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(ref.astype(jnp.float32)),
                               rtol=1e-2, atol=1e-2)


def test_kernel_wrapper_refuses_other_devices():
    """A tensor that is neither on the CPU nor on a CUDA card is refused,
    never silently computed by the plain version."""
    q = torch.empty(1, 4, 64, device="meta")
    with pytest.raises(ValueError):
        fused_attention_bse(q, q, q, 1)


def test_cpu_tensors_do_not_launch():
    before = fused_attention_bse.launches
    q, k, v, _ = _inputs(1, 2, 8, 8, 32, False)
    fused_attention_bse(torch.from_numpy(q), torch.from_numpy(k),
                        torch.from_numpy(v), 2)
    assert fused_attention_bse.launches == before


def test_kernel_library_is_built_lazily():
    """Importing the kernels builds nothing; the library's name hashes the
    sources and lies under build/cris_tpu_torch at the repository root."""
    from cris_tpu_torch.ops.kernels import build

    path = build.library_path()
    assert path == build.library_path()
    assert path.parent == build.BUILD_DIR
    assert build.BUILD_DIR.parts[-2:] == ("build", "cris_tpu_torch")
    assert path.name.startswith("libcris_kernels_") and path.suffix == ".so"
    assert build._library is None
