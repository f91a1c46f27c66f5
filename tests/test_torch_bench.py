"""The port's bench and latency entry points, on the CPU at tiny size.

- ``config_for`` and the R50 / R101 presets equal their YAML files; R101
  at full width has the JAX init's parameter shapes.
- The bench's eval step (``Evaluator.device_probs`` on the BN-folded
  model) equals the JAX expression that ``bench.py:174-182`` scans
  (``model.apply`` on the JAX-folded weights, ``jax.nn.sigmoid``,
  ``resize2d`` bicubic with ``align_corners``) at 1e-4, in f32.
- The marginal rate and its refusal, a turn retried on a clock whose long
  loop was not slower, the seeded batch makers, and ``decide``'s rules on
  made-up turns.
- ``bench.main`` and ``latency.main`` end to end with ``--device cpu``,
  and their default device, the card, which this machine lacks.
"""

import dataclasses
import json
import os
import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from conftest import tiny_cris
from test_torch_bottleneck_stem import _randomize_bn

from cris_tpu_torch import bench, latency
from cris_tpu_torch.checkpoint import fold_batchnorm, from_jax
from cris_tpu_torch.engine import Evaluator
from cris_tpu_torch.models import build_segmenter
from cris_tpu_torch.utils import (config_for, cris_r50_refcoco,
                                  cris_r101_refcoco, load_cfg_from_cfg_file)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = os.path.join(REPO, "config", "synthetic", "cris_tiny.yaml")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One torch intra-op thread: the suite runs several pytest workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("name,preset", [
    ("cris_r50.yaml", cris_r50_refcoco), ("cris_r101.yaml", cris_r101_refcoco),
    ("cris_tiny.yaml", None)])
def test_config_for_equals_the_yaml(name, preset):
    """The two RefCOCO presets (through config_for, by a relative and an
    absolute path) equal their YAML files; another path loads its YAML."""
    folder = "synthetic" if preset is None else "refcoco"
    path = os.path.join(REPO, "config", folder, name)
    want = load_cfg_from_cfg_file(path)
    assert config_for(path) == want
    if preset is not None:
        assert preset() == want
        assert config_for(os.path.join("config", folder, name)) == want
        assert preset() is not preset()


def test_r101_parameter_shapes_match_jax():
    """CRIS-R101 at full width: the port built on the meta device has the
    JAX init's parameter shapes (as test_r50_parameter_shapes_match_jax,
    on a 64 px image)."""
    from cris_tpu.models import build_segmenter as jax_build

    cfg = cris_r101_refcoco()
    cfg.precision = "fp32"
    shapes = jax.eval_shape(
        jax_build(cfg).init, jax.random.PRNGKey(0),
        jax.ShapeDtypeStruct((1, 64, 64, 3), jnp.float32),
        jax.ShapeDtypeStruct((1, cfg.word_len), jnp.int32))
    leaves = jax.tree_util.tree_map(
        lambda s: np.broadcast_to(np.zeros((), np.float32), s.shape), shapes)
    want = {k: v.shape for k, v in from_jax(leaves).items()}
    port = build_segmenter(cfg, device="meta")
    got = {k: tuple(v.shape) for k, v in port.state_dict().items()}
    assert got == want
    # 23 blocks in layer3, R50's 6
    assert sum(k.startswith("backbone.visual.layer3.") and
               k.endswith(".conv1.weight") for k in got) == 23
    assert got["neck.f1_v_proj.0.weight"][1] == 512


def test_eval_step_matches_the_jax_bench_expression():
    """A tiny CRIS with non-trivial BN, the same weights (from_jax), in
    f32: the bench's folded eval step against bench.py's scan body on
    the JAX package's fold, per pixel and as the loop's sum."""
    from cris_tpu.checkpoint import fold_batchnorm as jax_fold
    from cris_tpu.ops.resize import resize2d as jax_resize

    cfg = load_cfg_from_cfg_file(TINY)
    cfg.precision = "fp32"
    cfg.dropout = 0.0
    jmodel = tiny_cris(dropout=0.0, dtype=None)
    variables = _randomize_bn(jax.jit(jmodel.init)(
        jax.random.PRNGKey(1), jnp.zeros((1, 64, 64, 3)),
        jnp.zeros((1, 17), jnp.int32)), 6)
    variables = jax.tree_util.tree_map(np.asarray, variables)
    rng = np.random.RandomState(3)
    img = rng.randn(2, 64, 64, 3).astype(np.float32)
    word = rng.randint(1, bench.WORD_HIGH, (2, 17)).astype(np.int32)

    jfolded = dataclasses.replace(jmodel, fold_bn=True, pos_grid=2)
    pred = jax.jit(lambda v, i, w: jfolded.apply(v, i, w, train=False))(
        jax_fold(variables, input_resolution=64), jnp.asarray(img),
        jnp.asarray(word))
    probs = jax.nn.sigmoid(pred[..., 0].astype(jnp.float32))
    ref = np.asarray(jax_resize(probs[..., None], (64, 64), "bicubic",
                                True))[..., 0]

    sd = fold_batchnorm(from_jax(variables), cfg.input_size)
    model = bench.eval_model(cfg, "cpu", sd)
    batch = {"image": torch.from_numpy(img.transpose(0, 3, 1, 2).copy()),
             "word": torch.from_numpy(word).long()}
    got = Evaluator(model, 64, None).device_probs(batch["image"],
                                                  batch["word"])
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-4, atol=1e-4)
    total = bench.eval_loop(model, cfg)([batch, batch])
    np.testing.assert_allclose(total.item(), 2 * ref.sum(), rtol=1e-4)


def test_marginal_rate():
    assert bench.marginal_rate(32, 2, 12, 1.0, 3.0) == pytest.approx(160.0)


@pytest.mark.parametrize("t1,t2,n1,n2", [(2.0, 2.0, 2, 12),
                                         (2.5, 2.0, 2, 12),
                                         (1.0, 2.0, 12, 12)])
def test_marginal_rate_refuses(t1, t2, n1, n2):
    """No rate when the longer loop took no longer, or is not longer."""
    with pytest.raises(ValueError):
        bench.marginal_rate(32, n1, n2, t1, t2)


def test_measure_takes_the_marginal_rate_of_a_timed_loop():
    """A loop whose cost is 50 ms once plus 20 ms a batch: its marginal
    rate is 4 / 0.02 = 200 images a second, whatever the 50 ms; each
    trial's rate is kept and the spread is (max - min) / median."""
    def run(batches):
        time.sleep(0.05 + 0.02 * len(batches))
        return torch.zeros(())

    out = bench.measure(run, [None] * 2, [None] * 6, 4, 3,
                        torch.device("cpu"))
    assert len(out["trials"]) == 3
    assert 100 < out["value"] < 220
    assert out["spread"] == pytest.approx(
        (max(out["trials"]) - min(out["trials"])) / out["value"])


def _fake_clock(monkeypatch, seconds):
    """bench.timed replaced by a clock that gives ``seconds(n, call)`` for
    the call-th loop (from 0) of n batches; returns the calls' lengths."""
    calls = []

    def timed(run, batches, device):
        calls.append(len(batches))
        return seconds(len(batches), len(calls) - 1), torch.zeros(())

    monkeypatch.setattr(bench, "timed", timed)
    return calls


def test_measure_retries_a_turn_whose_long_loop_was_not_slower(monkeypatch):
    """The first trial's long loop (6 batches) takes no longer than its
    short one (2 batches), as on a loaded host: the turn times both again
    and keeps each length's minimum, so the metric still comes out, at
    4 x (6 - 2) / (1.5 - 1.0) = 32 images a second."""
    script = {2: 2.0, 3: 1.5, 4: 1.0, 5: 3.0}  # after the two warm-up loops
    calls = _fake_clock(monkeypatch, lambda n, i: script.get(i, 1.0 + n / 4))
    out = bench.measure(None, [None] * 2, [None] * 6, 4, 2,
                        torch.device("cpu"))
    assert out["trials"][0] == pytest.approx(32.0)
    assert out["trials"][1] == pytest.approx(4 * 4 / 1.0)
    assert out["value"] > 0
    assert calls == [2, 6] + [2, 6] * 2 + [2, 6]


def test_measure_still_refuses_a_flat_clock(monkeypatch):
    """A long loop that is never slower: the turn tries ATTEMPTS times and
    then refuses, as marginal_rate does."""
    calls = _fake_clock(monkeypatch, lambda n, i: 1.0)
    with pytest.raises(ValueError, match="no marginal rate"):
        bench.measure(None, [None] * 2, [None] * 6, 4, 3, torch.device("cpu"))
    assert calls == [2, 6] * (1 + bench.ATTEMPTS)


def test_measure_refuses_non_finite_output():
    with pytest.raises(FloatingPointError):
        bench.measure(lambda batches: torch.tensor(float("nan")), [None],
                      [None] * 2, 4, 1, torch.device("cpu"))


@pytest.mark.parametrize("masks", [False, True])
def test_make_batches_is_seeded(masks):
    """Shapes, dtypes and ranges as bench.py draws them; one seed gives
    the same batches, another seed others."""
    a = bench.make_batches(3, 2, 16, 17, "cpu", 5, masks)
    b = bench.make_batches(3, 2, 16, 17, "cpu", 5, masks)
    c = bench.make_batches(3, 2, 16, 17, "cpu", 6, masks)
    assert len(a) == 3
    keys = {"image", "word", "mask"} if masks else {"image", "word"}
    for x, y, z in zip(a, b, c):
        assert set(x) == keys
        for key in keys:
            torch.testing.assert_close(x[key], y[key], rtol=0, atol=0)
        assert not torch.equal(x["image"], z["image"])
        assert x["image"].shape == (2, 3, 16, 16)
        assert x["image"].dtype == torch.float32
        assert x["word"].shape == (2, 17) and x["word"].dtype == torch.int64
        assert x["word"].min() >= 1 and x["word"].max() < bench.WORD_HIGH
        if masks:
            assert x["mask"].shape == (2, 1, 16, 16)
            assert x["mask"].dtype == torch.float32
            assert set(x["mask"].unique().tolist()) == {0.0, 1.0}
    assert not torch.equal(a[0]["image"], a[1]["image"])


def _lines(text):
    return [json.loads(s) for s in text.splitlines() if s.startswith("{")]


ARGS = ["--device", "cpu", "--batch", "2", "--n1", "1", "--n2", "2",
        "--trials", "2"]
DEVICE_METRICS = ["cris_r50_eval_throughput_416px_b32",
                  "cris_r50_train_throughput_416px_b32",
                  "cris_r101_eval_throughput_416px_b32"]


@pytest.fixture
def small_host(monkeypatch):
    """The host metric on 4 images (2 per sample), one run each."""
    monkeypatch.setattr(bench, "HOST_ARGS", dict(n_images=4, repeats=1,
                                                 python_images=2))


def _device_lines(lines):
    return [r for r in lines if r["metric"] in DEVICE_METRICS]


def test_bench_runs_every_metric_on_the_cpu(monkeypatch, capsys, small_host):
    """The host metric first, then the three device metrics on the tiny
    model: one JSON line each, under bench.py's names, with a positive
    value, its trials and its spread, and the host's cores to feed the
    eval rate after the eval metric; the train bench runs
    engine.train_step once per batch. The loops run on a fake clock that
    reads one second a batch, so no turn is retried (on the host clock a
    loaded machine could time the long loop no slower than the short one,
    and the retry would run more steps)."""
    monkeypatch.setattr(bench, "METRICS", tuple(
        (name, step, TINY) for name, step, _ in bench.METRICS))
    timed = bench.timed

    def one_second_a_batch(run, batches, device):
        return float(len(batches)), timed(run, batches, device)[1]

    monkeypatch.setattr(bench, "timed", one_second_a_batch)
    steps = []
    train_step = bench.engine.train_step

    def counted(*args, **kwargs):
        steps.append(args[4])
        return train_step(*args, **kwargs)

    monkeypatch.setattr(bench.engine, "train_step", counted)
    assert bench.main(ARGS) == 0
    lines = _lines(capsys.readouterr().out)
    assert [r["metric"] for r in lines] == [
        "host_input_pipeline_640x480", "cris_r50_eval_throughput_416px_b32",
        "host_cores_to_feed_r50_eval", "cris_r50_train_throughput_416px_b32",
        "cris_r101_eval_throughput_416px_b32"]
    host, cores = lines[0], lines[2]
    assert host["unit"] == "img/s" and host["card"] == "cpu"
    for key in ("value", "native_1thread_img_s", "per_sample_img_s",
                "vs_baseline", "host_cores"):
        assert host[key] > 0, key
    assert host["vs_baseline"] == host["value"] / host["per_sample_img_s"]
    assert host["cpu_model"] and host["images"] == 4
    assert cores["r50_eval_img_s"] == lines[1]["value"]
    assert cores["value"] == pytest.approx(
        lines[1]["value"] / host["native_1thread_img_s"])
    for r in _device_lines(lines):
        assert r["unit"] == "img/s" and r["card"] == "cpu"
        assert r["value"] > 0 and len(r["trials"]) == 2
        assert min(r["trials"]) <= r["value"] <= max(r["trials"])
        assert r["spread"] >= 0
    # warm-up and two trials of 1 + 2 batches, each with its own seed
    assert len(steps) == 3 * 3
    assert len(set(steps)) == len(steps)


def test_bench_reports_a_later_metric_error_and_goes_on(monkeypatch, capsys,
                                                         small_host):
    monkeypatch.setattr(bench, "METRICS", tuple(
        (name, step, TINY) for name, step, _ in bench.METRICS))

    def broken(cfg, device):
        raise RuntimeError("train broke")

    monkeypatch.setattr(bench, "train_loop", broken)
    assert bench.main(ARGS) == 0
    lines = _device_lines(_lines(capsys.readouterr().out))
    assert [r["metric"] for r in lines] == [m for m, _, _ in bench.METRICS]
    assert "train broke" in lines[1]["error"] and "value" not in lines[1]
    assert lines[2]["value"] > 0


def test_bench_fails_when_the_eval_metric_fails(monkeypatch, capsys,
                                                small_host):
    monkeypatch.setattr(bench, "METRICS", tuple(
        (name, step, TINY) for name, step, _ in bench.METRICS))
    rate = bench.marginal_rate
    monkeypatch.setattr(bench, "marginal_rate",
                        lambda b, n1, n2, t1, t2: rate(b, n1, n2, 1.0, 1.0))
    with pytest.raises(ValueError, match="no marginal rate"):
        bench.main(ARGS)
    lines = _lines(capsys.readouterr().out)
    assert [r["metric"] for r in lines] == ["host_input_pipeline_640x480"]
    assert not any("value" in r for r in _device_lines(lines))


def test_bench_host_metric_failure_is_printed_and_fails_the_run(
        monkeypatch, capsys):
    """A failing host metric prints an error line first; the device
    metrics still run, and the run exits non-zero."""
    monkeypatch.setattr(bench, "METRICS", tuple(
        (name, step, TINY) for name, step, _ in bench.METRICS))

    def broken(**kwargs):
        raise ValueError("sample 3: SOF2: progressive JPEG is not supported")

    monkeypatch.setattr(bench, "measure_host_pipeline", broken)
    assert bench.main(ARGS) == 1
    lines = _lines(capsys.readouterr().out)
    assert lines[0]["metric"] == "host_input_pipeline_640x480"
    assert "SOF2" in lines[0]["error"] and "value" not in lines[0]
    assert [r["metric"] for r in lines[1:]] == DEVICE_METRICS
    assert all(r["value"] > 0 for r in lines[1:])


def test_bench_ab_on_the_cpu(monkeypatch, capsys):
    """--ab builds the arms, prints the two pilot turns and a b c d d c b a
    per round, each with its launches per batch, then the decisions."""
    monkeypatch.setattr(bench, "R50", TINY)
    assert bench.main(ARGS[:8] + ["--ab", "--rounds", "2"]) == 0
    lines = _lines(capsys.readouterr().out)
    turns, decision = lines[:-1], lines[-1]
    assert [t["arm"] for t in turns] == list("bc" + "abcddcba" * 2)
    assert [t["round"] for t in turns] == ["pilot"] * 2 + [0] * 8 + [1] * 8
    for t in turns:
        assert t["img_s"] > 0 and t["card"] == "cpu"
        # the CPU takes the plain versions: nothing is launched
        assert t["k5_per_batch"] == t["k7_per_batch"] == 0
    assert decision["tail_rule"] in ("every", "narrow")
    assert decision["d_k5_arm"] in "bc"
    assert set(decision["median_img_s"]) == set("abcd")


def _turns(rates):
    """Made-up turns: rates[arm] = the arm's rates in turn order, two a
    round."""
    return [{"arm": arm, "round": i // 2, "img_s": r}
            for arm, rs in rates.items() for i, r in enumerate(rs)]


@pytest.mark.parametrize("case,rule,k5,k7", [
    ("clear", "narrow", True, True),
    ("one round lost", "every", True, False),
    ("inside spread", "narrow", False, False)])
def test_decide(case, rule, k5, k7):
    """c beats b in every round -> rule narrow; a switch turns on only when
    its arm wins every round by more than the larger max - min (K5: the
    rule's arm against a; K7: d against its K5 arm, here c)."""
    rates = {"a": [100, 101, 100, 101], "b": [110, 111, 110, 111],
             "c": [120, 121, 120, 121], "d": [130, 131, 130, 131]}
    if case == "one round lost":
        # c loses round 1 to b; its max - min (21) then exceeds d's gain
        rates["c"] = [120, 121, 100, 101]
    elif case == "inside spread":
        rates["b"] = [90, 135, 90, 135]
        rates["c"] = [91, 136, 91, 136]
    out = bench.decide(_turns(rates), "c")
    assert (out["tail_rule"], out["fused_bottleneck_on"],
            out["fused_stem_on"]) == (rule, k5, k7)


@pytest.mark.parametrize("module", [bench, latency])
def test_entry_points_default_to_the_card(module, capsys):
    """With no --device the entry point asks for the card; this machine
    has none, so it exits non-zero and prints no result."""
    assert module.main([]) == 1
    out = capsys.readouterr()
    assert "no CUDA device" in out.err and "{" not in out.out


@pytest.mark.parametrize("train", [False, True])
def test_latency_on_the_cpu(train, monkeypatch, capsys):
    """latency.main on the tiny config, a few iterations: the reference's
    lines, then one JSON line with parameters, FPS and no device memory."""
    if train:
        monkeypatch.setenv("CRIS_LATENCY_TRAIN", "1")
        monkeypatch.setenv("CRIS_LATENCY_BATCH", "2")
    assert latency.main(["--config", TINY, "--device", "cpu", "--iters", "3",
                         "--warmup", "1"]) == 0
    out = capsys.readouterr().out
    assert "Average Parameters : " in out and "Average FPS: " in out
    (r,) = _lines(out)
    assert r["mode"] == ("train" if train else "forward")
    assert r["batch"] == (2 if train else 1)
    assert r["params_m"] == pytest.approx(sum(
        p.numel() for p in build_segmenter(
            load_cfg_from_cfg_file(TINY), device="meta").parameters()) * 1e-6)
    assert r["fps"] > 0 and r["peak_gb"] is None and r["card"] == "cpu"
