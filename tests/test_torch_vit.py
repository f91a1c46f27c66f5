"""The port's ViT image tower (models/clip_vit.py) against the JAX
package's, on the CPU, at tests/test_vit_parity.py's tiny size (width 64,
patch 8, 32 px, 2 layers; text 64 / 4 heads / 2 layers, vocabulary 100).

- the port's seeded weights carried into JAX by the JAX package's
  ``convert_clip``, and JAX's initialised weights carried into the port
  by ``clip_from_jax``: ``encode_image`` and ``encode_text`` agree at
  1e-4 (f32, rtol and atol);
- a ViT TorchScript archive written by ``save_clip_torchscript`` loads
  through ``load_clip_torchscript`` with the JAX ``infer_clip_config``'s
  architecture and the traced weights bit for bit;
- every block's attention takes K1 (``fused_attention_bse``), never the
  plain masked path, and K1 takes the ViT-B/16 sites (197 tokens, 12
  heads of 64) on its tensor-core route in bf16;
- CRIS over a ViT tower is refused with a ValueError.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cris_tpu.checkpoint import convert_clip
from cris_tpu.checkpoint.torch_convert import \
    infer_clip_config as jax_infer_clip_config
from cris_tpu.models import CLIP as JaxCLIP
from cris_tpu.models import CLIPConfig as JaxCLIPConfig
from cris_tpu_torch import cli
from cris_tpu_torch.checkpoint import clip_from_jax
from cris_tpu_torch.checkpoint.torch_convert import (infer_clip_config,
                                                     load_clip_torchscript,
                                                     save_clip_torchscript)
from cris_tpu_torch.models import (CLIP, CLIPConfig, build_segmenter,
                                   init_weights)
from cris_tpu_torch.ops import attention as attention_ops
from cris_tpu_torch.ops.kernels.attention import attention_route
from cris_tpu_torch.utils import load_cfg_from_cfg_file

TINY = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "config", "synthetic", "cris_tiny.yaml")
# (embed, resolution, layers, width, patch, context, vocab, text width,
# heads, layers): tests/test_vit_parity.py's tiny ViT CLIP
ARCH = (64, 32, 2, 64, 8, 20, 100, 64, 4, 2)
CFG = CLIPConfig(*ARCH)
TOL = dict(rtol=1e-4, atol=1e-4)


def _inputs():
    rng = np.random.RandomState(6)
    img = rng.randn(2, 32, 32, 3).astype(np.float32)
    ids = rng.randint(1, 98, (2, 10)).astype(np.int64)
    ids[:, 0], ids[:, -1] = 98, 99  # EOT the largest id
    return img, ids


def _port(img, ids, clip):
    with torch.no_grad():
        image = clip.encode_image(torch.from_numpy(img).permute(0, 3, 1, 2))
        word, state = clip.encode_text(torch.from_numpy(ids))
    return image.numpy(), word.numpy(), state.numpy()


def _jax(img, ids, variables):
    model = JaxCLIP(JaxCLIPConfig(*ARCH), dtype=None)
    image, (word, state) = model.apply(variables, jnp.asarray(img),
                                       jnp.asarray(ids.astype(np.int32)))
    return np.asarray(image), np.asarray(word), np.asarray(state)


def _seeded_port(seed=5):
    return init_weights(CLIP(CFG), seed).eval()


def test_config_is_vit_with_width_over_64_heads():
    assert CFG.is_vit and CFG.vision_heads == 1
    b16 = CLIPConfig(512, 224, 12, 768, 16, 77, 49408, 512, 8, 12)
    assert b16.vision_heads == 12
    assert not CLIPConfig(1024, 224, (3, 4, 6, 3), 64, None, 77, 49408,
                          512, 8, 12).is_vit


def test_port_weights_through_convert_clip_match_jax():
    """The port's seeded ViT CLIP, carried into JAX by convert_clip: the
    patch features (B, 16, 64), the word features and the state at
    1e-4."""
    clip = _seeded_port()
    variables, cfg = convert_clip(dict(clip.state_dict()))
    assert cfg.is_vit and cfg.vision_patch_size == 8
    img, ids = _inputs()
    got, want = _port(img, ids, clip), _jax(img, ids, variables)
    assert got[0].shape == (2, 16, 64)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, **TOL)


def test_jax_init_through_clip_from_jax_matches_jax():
    """JAX's initialised ViT CLIP carried into the port by clip_from_jax
    (every key of the port's CLIP, once): the same outputs at 1e-4."""
    img, ids = _inputs()
    variables = jax.tree_util.tree_map(np.asarray, JaxCLIP(
        JaxCLIPConfig(*ARCH), dtype=None).init(
        jax.random.PRNGKey(3), jnp.asarray(img),
        jnp.asarray(ids.astype(np.int32))))
    sd = clip_from_jax(variables)
    clip = CLIP(CFG).eval()
    assert set(sd) == set(clip.state_dict())
    clip.load_state_dict({k: torch.from_numpy(np.array(v, np.float32))
                          for k, v in sd.items()}, strict=True)
    for a, b in zip(_port(img, ids, clip), _jax(img, ids, variables)):
        np.testing.assert_allclose(a, b, **TOL)


def test_archive_round_trip_infers_the_jax_config(tmp_path):
    """A traced ViT archive: the port infers the JAX package's config
    from its state_dict (heads width // 64, as for released archives),
    the weights come back bit for bit, and the CLIP built from the
    inferred config takes them with every key matched."""
    clip = _seeded_port()
    path = save_clip_torchscript(clip, str(tmp_path / "ViT-T-8.pt"),
                                 image_resolution=32)
    sd, cfg = load_clip_torchscript(path)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(
        jax_infer_clip_config(sd))
    assert cfg == dataclasses.replace(CFG, transformer_heads=1)
    assert cfg == infer_clip_config(clip.state_dict())
    want = clip.state_dict()
    assert set(sd) == set(want)
    for k, v in want.items():
        assert torch.equal(sd[k], v), k
    CLIP(cfg).load_state_dict(sd, strict=True)


def test_vit_blocks_take_k1(monkeypatch):
    """encode_image calls K1's wrapper once a block, with no mask, and
    the masked plain path never; at ViT-B/16's sites (B 2 here, 197
    tokens, 12 heads of 64, q/k/v the packed projection's thirds) bf16
    takes the tensor-core route, within K1's length and head-dim gates."""
    calls = []
    real = attention_ops.fused_attention_bse

    def counted(q, k, v, num_heads, kv_valid=None):
        calls.append((tuple(q.shape), num_heads, kv_valid))
        return real(q, k, v, num_heads, kv_valid)

    def refused(*args, **kwargs):
        raise AssertionError("the ViT's attention took the plain path")

    monkeypatch.setattr(attention_ops, "fused_attention_bse", counted)
    monkeypatch.setattr(attention_ops, "attention_plain", refused)
    img, ids = _inputs()
    with torch.no_grad():
        _seeded_port().encode_image(torch.from_numpy(img).permute(0, 3, 1, 2))
    assert calls == [((2, 17, 64), 1, None)] * CFG.vision_layers
    qkv = torch.zeros(2, 197, 3 * 768, dtype=torch.bfloat16)
    q, k, v = qkv.chunk(3, -1)
    assert attention_route(q, k, v, 64) == "tensor_cores"
    assert 197 <= attention_ops.MAX_FUSED_LEN
    assert 64 <= attention_ops.MAX_HEAD_DIM


def test_cris_over_a_vit_tower_is_refused(tmp_path):
    """build_segmenter refuses a ViT CLIP config, and cli.build_model a
    ViT archive as clip_pretrain, naming the tower."""
    cfg = load_cfg_from_cfg_file(TINY)
    with pytest.raises(ValueError, match="ViT image tower"):
        build_segmenter(cfg, device="cpu", clip_config=CFG)
    cfg.clip_pretrain = save_clip_torchscript(
        _seeded_port(), str(tmp_path / "ViT-T-8.pt"), image_resolution=32)
    with pytest.raises(ValueError, match="three feature scales"):
        cli.build_model(cfg, "cpu")
