"""The PyTorch port's BN fold and its folded serving path, on the CPU.

- ``fold_batchnorm``: a folded port model equals the unfolded eval model
  at 1e-4 (tests/test_fold_bn.py:15-58's bar) with non-trivial BN
  statistics, and the folded state dict has exactly the folded model's
  keys; the port's fold of the JAX golden weights matches
  tests/goldens/tiny_fold_eval.npz at tests/test_golden.py:59's 1e-4.
- ``fold_pos_embed`` against the JAX package's ``_fold_pos_embed``
  (7^2 -> 13^2, the R50 grid at 416 px) at 1e-5, the resize tests' bar.
- The slice end to end: PredictService, folded, with K5 and K7 switched
  on (their plain versions on the CPU), against the JAX chain on the
  JAX-folded weights with its stem kernel in interpret mode, at the
  serving test's mask agreement (>= 0.999).
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from conftest import tiny_cris
from test_torch_bottleneck_stem import _randomize_bn

from cris_tpu_torch.checkpoint import (fold_batchnorm, fold_pos_embed,
                                       from_jax)
from cris_tpu_torch.models import CLIPConfig, CRIS, build_segmenter
from cris_tpu_torch.utils import CfgNode, load_cfg_from_cfg_file

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN_DIR = os.path.join(REPO, "tests", "goldens")
TAILS = CLIPConfig(64, 64, (1, 2, 2, 1), 16, None, 77, 49408, 64, 4, 2)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One torch intra-op thread: the suite runs several pytest workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _tiny_cfg():
    return CfgNode(dict(clip_pretrain="TINY", fpn_in=[128, 256, 64],
                        fpn_out=[32, 64, 128], vis_dim=64, num_layers=2,
                        num_head=4, dim_ffn=128, dropout=0.0))


def _randomize_port_bn(model, seed):
    """BN affines U(0.5, 1.5) / N(0, 0.1), running mean N(0, 0.1) and
    running var U(0.5, 1.5), from a seed."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for mod in model.modules():
            if hasattr(mod, "running_mean"):
                n = mod.running_mean.shape
                mod.weight.copy_(torch.rand(n, generator=gen) + 0.5)
                mod.bias.copy_(torch.randn(n, generator=gen) * 0.1)
                mod.running_mean.copy_(torch.randn(n, generator=gen) * 0.1)
                mod.running_var.copy_(torch.rand(n, generator=gen) + 0.5)
    return model


@pytest.mark.parametrize("input_resolution", [None, 128])
def test_fold_batchnorm_is_exact(input_resolution):
    """Tiny CRIS trained at 64 px, served at 128 px: the folded model
    (with the embedding pre-resized to 4 x 4 when input_resolution is
    given, resized at run time otherwise) equals the unfolded one."""
    cfg = _tiny_cfg()
    model = _randomize_port_bn(build_segmenter(cfg, device="cpu", seed=2), 5)
    grid = None if input_resolution is None else input_resolution // 32
    folded_sd = fold_batchnorm(model.state_dict(), input_resolution)
    folded = build_segmenter(cfg, device="cpu", fold_bn=True, pos_grid=grid)
    assert set(folded_sd) == set(folded.state_dict())
    assert not any(k.endswith("running_var") and "norm_layer" not in k
                   for k in folded_sd)
    folded.load_state_dict(folded_sd, strict=True)
    rng = np.random.RandomState(1)
    img = torch.from_numpy(rng.randn(2, 3, 128, 128).astype(np.float32))
    word = torch.from_numpy(rng.randint(1, 49000, (2, 17))).long()
    with torch.no_grad():
        ref = model(img, word)
        got = folded(img, word)
    torch.testing.assert_close(got, ref, rtol=1e-4, atol=1e-4)


def test_fold_matches_the_jax_golden():
    """The JAX tiny CRIS of tests/goldens (PRNGKey(42)) through from_jax and
    the port's fold: the golden's folded prediction."""
    fwd = np.load(os.path.join(GOLDEN_DIR, "tiny_forward.npz"))
    gold = np.load(os.path.join(GOLDEN_DIR, "tiny_fold_eval.npz"))
    variables = tiny_cris(dropout=0.0, dtype=None).init(
        jax.random.PRNGKey(42), jnp.asarray(fwd["img"]),
        jnp.asarray(fwd["word"]))
    sd = fold_batchnorm(from_jax(jax.tree_util.tree_map(np.asarray,
                                                        variables)), 64)
    port = CRIS(CLIPConfig(64, 64, (1, 1, 1, 1), 16, None, 77, 49408, 64, 4, 2),
                fpn_in=(128, 256, 64), fpn_out=(32, 64, 128), vis_dim=64,
                num_layers=2, num_head=4, dim_ffn=128, dropout=0.0,
                fold_bn=True, pos_grid=2).eval()
    port.load_state_dict(sd, strict=True)
    with torch.no_grad():
        pred = port(torch.from_numpy(fwd["img"]).permute(0, 3, 1, 2),
                    torch.from_numpy(fwd["word"]).long())
    np.testing.assert_allclose(pred.permute(0, 2, 3, 1).numpy(), gold["pred"],
                               rtol=1e-4, atol=1e-4)


def test_fold_pos_embed_matches_jax():
    from cris_tpu.checkpoint.fold import _fold_pos_embed

    pe = np.random.RandomState(2).randn(7 * 7 + 1, 24).astype(np.float32)
    ref = _fold_pos_embed(pe, 13)
    got = fold_pos_embed(torch.from_numpy(pe), 13)
    assert got.dtype == torch.float32 and tuple(got.shape) == (13 * 13 + 1, 24)
    np.testing.assert_array_equal(got[0].numpy(), pe[0])  # CLS row kept
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(fold_pos_embed(torch.from_numpy(pe), 7),
                               torch.from_numpy(pe), rtol=0, atol=0)


def test_folded_predict_service_with_both_kernels_matches_jax(monkeypatch):
    """A tiny CRIS whose visual encoder has tail blocks (1, 2, 2, 1), with
    non-trivial BN statistics: PredictService(fold_bn, fused_bottleneck,
    fused_stem) on the CPU against the JAX chain (cv2 warps, tokenize,
    Evaluator.predict_probs on fold_batchnorm'd variables with fold_bn,
    pos_grid, fused pools and its stem kernel in interpret mode, inverse
    warp), in f32, at buckets 1 and 4."""
    import cris_tpu.ops.pallas as pallas_pkg
    from cris_tpu.checkpoint import fold_batchnorm as jax_fold
    from cris_tpu.data import transforms as jax_tf
    from cris_tpu.engine import Evaluator as JaxEvaluator
    from cris_tpu.models import CRIS as JaxCRIS
    from cris_tpu.models import CLIPConfig as JaxCLIPConfig
    from cris_tpu.utils.tokenizer import tokenize as jax_tokenize
    from cris_tpu_torch.models import CLIP_PRESETS, clip_resnet
    from cris_tpu_torch.serving import PredictService
    from test_torch_serving import _smooth_image

    cfg = load_cfg_from_cfg_file(
        os.path.join(REPO, "config", "synthetic", "cris_tiny.yaml"))
    cfg.precision = "fp32"
    arch = dict(fpn_in=(128, 256, 64), fpn_out=(32, 64, 128), vis_dim=64,
                num_layers=2, num_head=4, dim_ffn=128, dropout=0.0)
    jccfg = JaxCLIPConfig(*dataclasses.astuple(TAILS))
    jmodel = JaxCRIS(jccfg, **arch, dtype=None)
    variables = _randomize_bn(jmodel.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)),
        jnp.zeros((1, 17), jnp.int32)), 4)

    monkeypatch.setenv("CRIS_PALLAS_STEM", "1")
    monkeypatch.setenv("CRIS_PALLAS_BOTTLENECK", "1")
    monkeypatch.setattr(pallas_pkg, "pallas_mode", lambda: "interpret")
    jfolded = JaxCRIS(jccfg, **arch, dtype=None, fold_bn=True, pos_grid=2,
                      fuse_pool=True)
    jvars = jax_fold(variables, input_resolution=64)
    jev = JaxEvaluator(jfolded, 64, batch_size=4)

    monkeypatch.setitem(CLIP_PRESETS, "TINY", TAILS)
    calls = {"k5": 0, "k7": 0}
    for name, key in (("fused_bottleneck", "k5"), ("fused_stem_pool", "k7")):
        def spy(*args, _fn=getattr(clip_resnet, name), _key=key):
            calls[_key] += 1
            return _fn(*args)
        monkeypatch.setattr(clip_resnet, name, spy)
    service = PredictService(cfg, device="cpu", max_batch=4,
                             state_dict=from_jax(variables),
                             fused_bottleneck=True, fused_stem=True)
    warm = dict(calls)
    assert warm == {"k5": 2 * 3, "k7": 3}  # buckets 1, 2, 4 at warm-up

    for hw, sents in [((48, 80), ["the red blob"]),
                      ((90, 60), ["left one", "the big square on the right",
                                  "nothing", "a thing 2", "top"])]:
        bgr = _smooth_image(*hw, seed=sum(hw))
        results = service.predict(bgr, sents)
        rgb = bgr[:, :, ::-1]
        mat, inv = jax_tf.get_transform_mats(hw, (64, 64))
        net_in = jax_tf.normalize_image(jax_tf.warp_image(rgb, mat, (64, 64)))
        probs = jev.predict_probs(jvars, np.repeat(net_in[None], len(sents), 0),
                                  jax_tokenize(sents, 17, True))
        for i, r in enumerate(results):
            ref = jax_tf.inverse_warp_prediction(probs[i], inv, hw) > 0.35
            assert r["mask"].shape == hw
            assert (r["mask"] == ref).mean() >= 0.999
    # one device batch for the first request, two (4 + 1) for the second
    assert calls["k7"] - warm["k7"] == 3
    assert calls["k5"] - warm["k5"] == 2 * 3
