"""The PyTorch port's serving path on the CPU: tokenizer and warps against
the JAX package's (regex / OpenCV) versions, PredictService against the
JAX chain on the same weights, and the port's import hygiene."""

import os
import subprocess
import sys

import cv2
import numpy as np
import pytest

import jax
import jax.numpy as jnp

from cris_tpu.data import transforms as jax_tf
from cris_tpu.utils.tokenizer import tokenize as jax_tokenize

from cris_tpu_torch.checkpoint import from_jax
from cris_tpu_torch.data import transforms as port_tf
from cris_tpu_torch.serving import PredictService, _buckets
from cris_tpu_torch.utils import load_cfg_from_cfg_file
from cris_tpu_torch.utils.tokenizer import tokenize

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

TEXTS = {
    "ascii": ["the man in the red shirt", "woman on the left holding an umbrella"],
    "digits": ["guy wearing #12 jersey", "the 2nd person from 3 zebras 2024"],
    "punctuation": ["pizza slice that isn't touched", "bottom-left (half) sandwich!?",
                    "she's wearing a blue dress; he'll wait...", "snake_case & a/b"],
    "accented": ["café au lait near the naïve façade", "Über große Straße",
                 "cafe\u0301 with a combining accent", "  spaced\tout\n text  "],
    "truncated": [" ".join(["zebra"] * 40), "a very long expression " * 6],
}
SIZES = [(333, 500), (480, 640), (427, 640), (640, 480)]


@pytest.mark.parametrize("kind", sorted(TEXTS))
def test_tokenizer_matches_jax(kind):
    texts = TEXTS[kind]
    np.testing.assert_array_equal(tokenize(texts, 17, True),
                                  jax_tokenize(texts, 17, True))
    if kind != "truncated":
        np.testing.assert_array_equal(tokenize(texts), jax_tokenize(texts))


def _smooth_image(h, w, seed):
    """A seeded photo-like uint8 image: smooth color fields plus noise."""
    rng = np.random.RandomState(seed)
    small = rng.randint(0, 256, (h // 16 + 2, w // 16 + 2, 3)).astype(np.float32)
    big = cv2.resize(small, (w, h), interpolation=cv2.INTER_LINEAR)
    return np.clip(big + rng.randn(h, w, 3) * 12, 0, 255).astype(np.uint8)


@pytest.mark.parametrize("hw", SIZES)
def test_image_warp_matches_opencv(hw):
    img = _smooth_image(*hw, seed=hw[0])
    mat, _ = jax_tf.get_transform_mats(hw, (416, 416))
    ref = jax_tf.warp_image(img, mat, (416, 416))
    got = port_tf.warp_image(img, mat, (416, 416))
    assert got.dtype == np.uint8 and got.shape == ref.shape
    assert np.abs(got.astype(int) - ref.astype(int)).max() <= 1
    np.testing.assert_array_equal(port_tf.get_transform_mats(hw, (416, 416))[0], mat)


@pytest.mark.parametrize("hw", SIZES)
def test_inverse_warp_matches_opencv(hw):
    rng = np.random.RandomState(hw[1])
    logits = cv2.resize(rng.randn(26, 26).astype(np.float32) * 4, (416, 416),
                        interpolation=cv2.INTER_CUBIC)
    probs = 1 / (1 + np.exp(-logits))
    _, inv = jax_tf.get_transform_mats(hw, (416, 416))
    ref = jax_tf.inverse_warp_prediction(probs, inv, hw)
    got = port_tf.inverse_warp_prediction(probs, inv, hw)
    assert got.shape == hw and got.dtype == np.float32
    assert np.abs(got - ref).max() <= 2e-2
    assert ((got > 0.35) == (ref > 0.35)).mean() >= 0.999


def test_buckets_match_jax():
    from cris_tpu.serving import _buckets as jax_buckets

    for n in (1, 4, 16, 24):
        assert _buckets(n) == jax_buckets(n)


def test_predict_service_matches_jax_chain():
    """Tiny CRIS, the same weights: the port's PredictService (BN folded,
    its default) against the JAX chain (cv2 warps + tokenize +
    Evaluator.predict_probs + inverse warp) on the unfolded weights, in
    f32, at buckets 1 and 4 (5 sentences = 4 + 1)."""
    from cris_tpu.engine import Evaluator as JaxEvaluator
    from cris_tpu.models import build_segmenter as jax_build

    cfg = load_cfg_from_cfg_file(
        os.path.join(REPO, "config", "synthetic", "cris_tiny.yaml"))
    cfg.precision = "fp32"
    jmodel = jax_build(cfg)
    variables = jmodel.init(jax.random.PRNGKey(0),
                            jnp.zeros((1, 64, 64, 3)), jnp.zeros((1, 17), jnp.int32))
    variables = jax.tree_util.tree_map(np.asarray, variables)
    service = PredictService(cfg, device="cpu", max_batch=4,
                             state_dict=from_jax(variables))
    assert not any(k.endswith("running_mean") and "norm_layer" not in k
                   for k in service.model.state_dict())  # served folded
    jev = JaxEvaluator(jmodel, 64, batch_size=4)

    for hw, sents in [((48, 80), ["the red blob"]),
                      ((90, 60), ["left one", "the big square on the right",
                                  "nothing", "a thing 2", "top"])]:
        bgr = _smooth_image(*hw, seed=sum(hw))
        results = service.predict(bgr, sents)
        assert [r["sentence"] for r in results] == sents

        rgb = bgr[:, :, ::-1]
        mat, inv = jax_tf.get_transform_mats(hw, (64, 64))
        net_in = jax_tf.normalize_image(jax_tf.warp_image(rgb, mat, (64, 64)))
        words = jax_tokenize(sents, 17, True)
        probs = jev.predict_probs(variables, np.repeat(net_in[None], len(sents), 0),
                                  words)
        for i, r in enumerate(results):
            ref = jax_tf.inverse_warp_prediction(probs[i], inv, hw) > 0.35
            assert r["mask"].shape == hw and r["mask"].dtype == bool
            assert r["foreground_px"] == int(r["mask"].sum())
            assert (r["mask"] == ref).mean() >= 0.999


def _tiny_cfg():
    cfg = load_cfg_from_cfg_file(
        os.path.join(REPO, "config", "synthetic", "cris_tiny.yaml"))
    cfg.precision = "fp32"
    return cfg


def test_predict_service_loads_best_model_pth(tmp_path):
    """PredictService(model_dir=...) reads best_model.pth, a trained CRIS
    checkpoint as CRIS.pytorch's train.py saves it under data parallel
    ({"state_dict": {"module." + key: tensor}}), and serves the same
    probabilities as the same weights given by state_dict=; the JAX
    package's load_cris_checkpoint reads the same file to the same
    weights (through from_jax)."""
    import torch

    from cris_tpu.checkpoint.torch_convert import \
        load_cris_checkpoint as jax_load
    from cris_tpu_torch.checkpoint import load_cris_checkpoint

    from cris_tpu_torch.models import build_segmenter

    cfg = _tiny_cfg()
    sd = build_segmenter(cfg, device="cpu", seed=3).state_dict()
    path = tmp_path / "best_model.pth"
    torch.save({"state_dict": {"module." + k: v for k, v in sd.items()},
                "epoch": 7}, path)
    loaded = load_cris_checkpoint(str(path))
    assert sorted(loaded) == sorted(sd)
    for key, value in sd.items():
        assert torch.equal(loaded[key], value), key
    jax_variables, _ = jax_load(str(path), cfg.num_layers)
    back = from_jax(jax_variables)
    assert set(back) == set(sd)
    for key, value in back.items():
        np.testing.assert_array_equal(np.asarray(value), sd[key].numpy(),
                                      err_msg=key)

    served = PredictService(cfg, model_dir=str(tmp_path), device="cpu",
                            max_batch=2)
    given = PredictService(cfg, device="cpu", max_batch=2, state_dict=sd)
    rng = np.random.RandomState(4)
    img = rng.randn(2, 3, 64, 64).astype(np.float32)
    word = rng.randint(1, 400, (2, 17))
    np.testing.assert_array_equal(served.evaluator.predict_probs(img, word),
                                  given.evaluator.predict_probs(img, word))


@pytest.mark.parametrize("prefix", ["", "module."])
def test_load_cris_checkpoint_takes_a_bare_state_dict(tmp_path, prefix):
    """A file holding the state_dict itself (no "state_dict" key), with or
    without the data-parallel prefix, loads to the unprefixed keys."""
    import torch

    from cris_tpu_torch.checkpoint import load_cris_checkpoint

    sd = {"neck.txt_proj.0.weight": torch.arange(6.0).reshape(2, 3),
          "decoder.norm.bias": torch.ones(4)}
    torch.save({prefix + k: v for k, v in sd.items()}, tmp_path / "m.pth")
    loaded = load_cris_checkpoint(str(tmp_path / "m.pth"))
    assert sorted(loaded) == sorted(sd)
    assert all(torch.equal(loaded[k], v) for k, v in sd.items())


def test_predict_service_warns_without_a_checkpoint(tmp_path, caplog):
    """An empty model_dir serves the seed-0 random init and says so, as
    cris_tpu.serving does."""
    import logging

    from cris_tpu_torch.checkpoint import fold_batchnorm
    from cris_tpu_torch.models import build_segmenter

    cfg = _tiny_cfg()
    with caplog.at_level(logging.WARNING, logger="cris_tpu_torch"):
        served = PredictService(cfg, model_dir=str(tmp_path), device="cpu",
                                max_batch=1)
    assert f"no checkpoint under '{tmp_path}' -- serving random weights" \
        in caplog.text
    want = fold_batchnorm(build_segmenter(cfg, device="cpu", seed=0)
                          .state_dict(), cfg.input_size)
    got = served.model.state_dict()
    assert sorted(got) == sorted(want)
    for key, value in want.items():
        np.testing.assert_array_equal(got[key].numpy(),
                                      np.asarray(value, np.float32),
                                      err_msg=key)


def test_profile_stage_breakdown_times_every_stage():
    """The serving profiler times each stage of real predict calls and
    puts the service's functions back afterwards."""
    from cris_tpu_torch import serving
    from cris_tpu_torch.engine import Evaluator
    from cris_tpu_torch.profile_serving import STAGES, busy_time, stage_breakdown

    cfg = load_cfg_from_cfg_file(
        os.path.join(REPO, "config", "synthetic", "cris_tiny.yaml"))
    cfg.precision = "fp32"
    service = PredictService(cfg, device="cpu", max_batch=16)
    saved = {name: getattr(serving, name) for name in STAGES}
    out = stage_breakdown(service, _smooth_image(48, 64, seed=5), runs=2)
    assert sorted(out) == [1, 8, 16]
    for rows in out.values():
        assert sorted(rows) == sorted(["request", "device batch",
                                       *STAGES.values()])
        assert all(len(v) == 2 and min(v) > 0 for v in rows.values())
        assert max(rows["device batch"]) <= max(rows["request"])
    assert {name: getattr(serving, name) for name in STAGES} == saved
    assert service.evaluator.predict_probs.__func__ is Evaluator.predict_probs
    assert busy_time([(0, 4), (2, 6), (10, 11), (3, 5)]) == 7


def test_port_imports_no_jax_opencv_yaml_or_regex():
    # torch.hub imports tqdm where it is installed, and falls back without
    # it: the subprocess hides tqdm, as the card's machine lacks it, so that
    # any import of it by the port fails
    code = (
        "import sys\n"
        "class NoTqdm:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.partition('.')[0] == 'tqdm':\n"
        "            raise ImportError(f'no module named {name!r}')\n"
        "sys.meta_path.insert(0, NoTqdm())\n"
        "import cris_tpu_torch.serving, cris_tpu_torch.ops.kernels.build\n"
        "import cris_tpu_torch.engine.trainer\n"
        "import cris_tpu_torch.ops.kernels.attention_dropout\n"
        "import cris_tpu_torch.grad_spread, cris_tpu_torch.profile_train\n"
        "import cris_tpu_torch.checkpoint.fold\n"
        "import cris_tpu_torch.ops.kernels.bottleneck\n"
        "import cris_tpu_torch.ops.kernels.stem\n"
        "import cris_tpu_torch.ops.kernels.fused_attention\n"
        "import cris_tpu_torch.ops.kernels.fused_matmul\n"
        "import cris_tpu_torch.ops.kernels.layernorm\n"
        "import cris_tpu_torch.data, cris_tpu_torch.data.codec\n"
        "import cris_tpu_torch.data.dataset, cris_tpu_torch.data.loader\n"
        "import cris_tpu_torch.data.records, cris_tpu_torch.data.synthetic\n"
        "import cris_tpu_torch.engine.evaluator, cris_tpu_torch.engine.metrics\n"
        "import cris_tpu_torch.cli, cris_tpu_torch.test\n"
        "import cris_tpu_torch.serve, cris_tpu_torch.predict\n"
        "import cris_tpu_torch.train, cris_tpu_torch.checkpoint.pth\n"
        "import cris_tpu_torch.checkpoint.torch_convert\n"
        "import cris_tpu_torch.utils.seed, cris_tpu_torch.utils.profiling\n"
        "from cris_tpu_torch.utils import ExperimentTracker\n"
        "import cris_tpu_torch.data.native, cris_tpu_torch.data.host_bench\n"
        "from cris_tpu_torch.data import decode_image, make_record\n"
        "decode_image(make_record(0)['img'])\n"
        "from cris_tpu_torch.data import batch_preprocess, make_test_jpegs\n"
        "imgs, masks = make_test_jpegs(2, (200, 150))\n"
        "assert batch_preprocess(imgs, masks, 64)[0].shape == (2, 64, 64, 3)\n"
        "import cris_tpu_torch.data.refer, cris_tpu_torch.data.lmdb_backend\n"
        "import cris_tpu_torch.data_process, cris_tpu_torch.folder2pack\n"
        "import cris_tpu_torch.prewarp\n"
        "from cris_tpu_torch.data.refer import rasterize_polygons\n"
        "assert rasterize_polygons([[1, 1, 6, 1, 6, 6]], 8, 8).sum() == 21\n"
        "bad = [m for m in ('jax', 'flax', 'cv2', 'yaml', 'regex', 'PIL',\n"
        "                   'wandb', 'tqdm', 'matplotlib', 'lmdb',\n"
        "                   'cris_tpu') if m in sys.modules]\n"
        "assert not bad, bad\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr


def test_bench_and_latency_import_no_jax_opencv_yaml_or_regex():
    """The card's entry points, the bench and latency, import none of the
    modules the card's machine lacks, nor the JAX package."""
    code = (
        "import sys\n"
        "import cris_tpu_torch.bench, cris_tpu_torch.latency\n"
        "bad = [m for m in ('jax', 'flax', 'cv2', 'yaml', 'regex', 'cris_tpu')\n"
        "       if m in sys.modules]\n"
        "assert not bad, bad\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
