"""The port's int8 serving slice against the JAX package, on the CPU (K8's
plain version: ROADMAP §1 item 13):

- ``quantize_channelwise`` and ``quantize_dynamic`` bit-equal;
- the plain int8 convs: int8 operands and int32 accumulators bit-equal
  to those of JAX's ``int8_conv2d_static``, ``int8_phase_conv_static``
  and ``int8_conv2d``, f32 outputs within 1e-6 relative; K8's plain
  version's epilogue (bias, ReLU, bf16 output, int8 input, a strided
  output) against the same arithmetic written out;
- calibration: the port's scales against ``calibrate_act_scales`` at
  maxabs and at the 99.9th percentile, 1e-6, on a tiny CRIS whose stage
  tails are scanned; ``.npz`` files round-trip between the packages;
- the tiny int8 model end to end against JAX's on the same weights and
  scales (the bar below);
- the quantize entry, the int8 PredictService and the test entry with
  ``--device cpu``.

The thresholds are lowered on both sides to the tiny widths (plain-conv
sites at 16 channels, pooled and upfold ones at 32).
"""

import dataclasses
import importlib
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cris_tpu.checkpoint import calibrate as jcal
from cris_tpu.checkpoint import fold_batchnorm as jax_fold
from cris_tpu.models import CLIPConfig as JaxCLIPConfig
from cris_tpu.models import CRIS as JaxCRIS
from cris_tpu.ops import quant as jq
from cris_tpu.ops import upsample_conv as ju
from cris_tpu_torch import quantize
from cris_tpu_torch import test as port_test
from cris_tpu_torch.checkpoint import (attach_act_scales,
                                       calibrate_act_scales, fold_batchnorm,
                                       from_jax, load_act_scales,
                                       quant_from_jax, save_act_scales,
                                       set_act_scales)
from cris_tpu_torch.cli import load_config
from cris_tpu_torch.models import (CLIPConfig, CRIS, QuantConfig,
                                   build_segmenter, enable_int8, int8_sites)
from cris_tpu_torch.ops import quant as pq
from cris_tpu_torch.serving import PredictService

# the module (the package exports its function under the same name)
k8 = importlib.import_module("cris_tpu_torch.ops.kernels.int8_conv")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY_YAML = os.path.join(REPO, "config", "synthetic", "cris_tiny.yaml")
# stage tails in layers 2 and 3, so the scanned tails' stacked scales
LAYERS = (1, 2, 2, 1)
KW = dict(fpn_in=(128, 256, 64), fpn_out=(32, 64, 128), vis_dim=64,
          num_layers=2, num_head=4, dim_ffn=128, dropout=0.0)
GATES = dict(min_ch=16, pooled_min_ch=32, upfold_min_ch=32)
ENV = {"CRIS_INT8_MIN_CH": "16", "CRIS_INT8_POOLED_MIN_CH": "32",
       "CRIS_INT8_UPFOLD_MIN_CH": "32", "CRIS_S2D_STEM": "1",
       "CRIS_FUSE_UPSAMPLE": "1"}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One torch intra-op thread: the suite runs several pytest workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _set_jax_env(monkeypatch):
    for key in (*ENV, "CRIS_INT8_CALIB", "CRIS_INT8_CALIB_PCT"):
        monkeypatch.setenv(key, "unset")
        monkeypatch.delenv(key)
    for key, value in ENV.items():
        monkeypatch.setenv(key, value)
    return monkeypatch


@pytest.fixture()
def jax_env(monkeypatch):
    """The JAX package's int8 and rewrite gates at the tiny thresholds;
    every variable it may set (load_act_scales sets the gates) is put
    back after the test."""
    return _set_jax_env(monkeypatch)


def _t(a):
    return torch.from_numpy(np.array(a))


RNG = np.random.RandomState(0)
X = RNG.randn(2, 9, 7, 13).astype(np.float32)
K3 = RNG.randn(3, 3, 13, 10).astype(np.float32)
K2 = RNG.randn(2, 2, 13, 10).astype(np.float32)
BIAS = RNG.randn(10).astype(np.float32)
S = np.float32(0.02)
DN = ("NHWC", "HWIO", "NHWC")


def test_quantizers_are_bit_equal():
    kq, ks = pq.quantize_channelwise(_t(K3))
    jkq, jks = jq.quantize_channelwise(K3)
    assert np.array_equal(kq.numpy(), np.asarray(jkq))
    assert np.array_equal(ks.numpy(), np.asarray(jks))
    xq, xs = pq.quantize_dynamic(_t(X))
    jxq, jxs = jq.quantize_dynamic(X)
    assert np.array_equal(xq.numpy(), np.asarray(jxq))
    assert xs.item() == float(jxs)
    assert xq.dtype == torch.int8 and int(xq.abs().max()) == 127


def _jax_acc(xq, kq, strides, padding):
    return np.asarray(jax.lax.conv_general_dilated(
        xq, kq, strides, padding, dimension_numbers=DN,
        preferred_element_type=jnp.int32))


def _check_site(x, kernel, s, strides, padding):
    """The port's operands and accumulator against JAX's; returns the
    port's padding."""
    kq, _ = pq.quantize_channelwise(_t(kernel))
    xq = k8.quantize_static(_t(x), torch.tensor(s))
    jkq, _ = jq.quantize_channelwise(kernel)
    jxq = np.clip(np.round(x / s), -127, 127).astype(np.int8)
    assert np.array_equal(kq.numpy(), np.asarray(jkq))
    assert np.array_equal(xq.numpy(), jxq)
    pads = pq.resolve_padding(padding, x.shape, kernel.shape, strides[0])
    acc = k8.int8_accumulate(xq, kq, strides[0], pads).numpy()
    assert np.array_equal(acc.astype(np.int64),
                          _jax_acc(jxq, np.asarray(jkq), strides, padding))


@pytest.mark.parametrize("kernel,strides,padding", [
    (K3, (1, 1), "SAME"), (K3, (2, 2), "SAME"), (K2, (2, 2), "VALID"),
    (K2, (1, 1), [(1, 0), (0, 1)]), (K3[:1, :1], (1, 1), "VALID")])
def test_int8_conv2d_static_matches_jax(kernel, strides, padding):
    _check_site(X, kernel, S, strides, padding)
    got = pq.int8_conv2d_static(_t(X), _t(kernel), torch.tensor(S), strides,
                                padding, _t(BIAS)).numpy()
    ref = np.asarray(jq.int8_conv2d_static(X, kernel, S, strides, padding,
                                           BIAS))
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=0)


@pytest.mark.parametrize("k,pads", [(3, "6"), (1, "4")])
def test_int8_phase_conv_static_matches_jax(k, pads):
    kernel = RNG.randn(k, k, 13, 10).astype(np.float32)
    pk = np.asarray((ju.phase_kernels6 if k == 3 else ju.phase_kernels4)(
        kernel))
    phase_pads = getattr(ju, f"PHASE_PADS{pads}")
    for di in (0, 1):
        for dj in (0, 1):
            _check_site(X, pk[di, dj], S, (1, 1),
                        [phase_pads[di], phase_pads[dj]])
    got = pq.int8_phase_conv_static(_t(X), _t(pk), phase_pads,
                                    torch.tensor(S)).numpy()
    ref = np.asarray(jq.int8_phase_conv_static(X, pk, phase_pads, S))
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=0)


def test_int8_conv2d_dynamic_matches_jax():
    _, xs = jq.quantize_dynamic(X)
    _check_site(X, K3, np.float32(xs), (1, 1), "SAME")
    got = pq.int8_conv2d(_t(X), _t(K3), (1, 1), "SAME", _t(BIAS)).numpy()
    ref = np.asarray(jq.int8_conv2d(X, K3, (1, 1), "SAME", BIAS))
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=0)


def test_k8_plain_epilogue_and_strided_output():
    """float(acc) * (s * k_scale) + bias, ReLU, cast: written out against
    the plain version; an int8 input is taken as it is; a strided out
    view receives exactly the plain output; a shape K8 does not take is
    refused by its gate."""
    kq, ks = pq.quantize_channelwise(_t(K3))
    s = torch.tensor([S])
    xq = k8.quantize_static(_t(X), s)
    acc = k8.int8_accumulate(xq, kq, 1, ((1, 1), (1, 1)))
    ref = torch.relu(acc.float() * (s * ks) + _t(BIAS)).to(torch.bfloat16)
    got = k8.int8_conv(_t(X).bfloat16().float(), kq, ks, s, _t(BIAS), 1,
                       ((1, 1), (1, 1)), True, torch.bfloat16)
    xb = _t(X).bfloat16().float()
    accb = k8.int8_accumulate(k8.quantize_static(xb, s), kq, 1,
                              ((1, 1), (1, 1)))
    refb = torch.relu(accb.float() * (s * ks) + _t(BIAS)).to(torch.bfloat16)
    assert torch.equal(got, refb)
    assert torch.equal(k8.int8_conv(xq, kq, ks, s, _t(BIAS), 1,
                                    ((1, 1), (1, 1)), True, torch.bfloat16),
                       ref)
    out = torch.zeros(2, 18, 14, 10)
    k8.int8_conv(_t(X), kq, ks, s, None, 1, ((1, 1), (1, 1)),
                 out=out[:, 1::2, ::2])
    assert torch.equal(out[:, 1::2, ::2], k8.int8_conv_plain(
        _t(X), kq, ks, s, None, 1, ((1, 1), (1, 1))))
    assert not out[:, ::2].any()
    assert k8.supports(3, 3, 1, ((1, 1), (1, 1)))
    assert k8.supports(2, 2, 1, ((1, 0), (0, 1)))
    assert not k8.supports(5, 5, 4, ((1, 0), (1, 0)))  # the s2d stem conv1
    assert not k8.supports(3, 3, 1, ((3, 3), (3, 3)))


def _jax_model():
    cfg = JaxCLIPConfig(64, 64, LAYERS, 16, None, 77, 49408, 64, 4, 2)
    return JaxCRIS(clip_config=cfg, fuse_pool=True, **KW)


@pytest.fixture(scope="module")
def tiny():
    """The JAX tiny CRIS with scanned tails: its variables (BN statistics
    made non-trivial), folded, calibration and eval batches, and the port
    model (folded, rewrites on) on the same weights."""
    rng = np.random.RandomState(4)
    img = rng.randn(2, 64, 64, 3).astype(np.float32)
    word = rng.randint(1, 49000, (2, 17)).astype(np.int32)
    model = _jax_model()
    variables = jax.tree_util.tree_map(np.asarray, jax.jit(model.init)(
        jax.random.PRNGKey(7), jnp.asarray(img), jnp.asarray(word)))
    def randomize(tree):  # running mean N(0, 0.1), var U(0.5, 1.5)
        return {k: randomize(v) if isinstance(v, dict) else (
            rng.randn(*v.shape) * 0.1 if k == "mean"
            else rng.rand(*v.shape) + 0.5).astype(np.float32)
            for k, v in tree.items()}
    variables = {"params": variables["params"],
                 "batch_stats": randomize(variables["batch_stats"])}
    folded = jax_fold(variables, input_resolution=64)
    calib = [(rng.randn(2, 64, 64, 3).astype(np.float32),
              rng.randint(1, 49000, (2, 17)).astype(np.int32))
             for _ in range(2)]
    port = CRIS(CLIPConfig(64, 64, LAYERS, 16, None, 77, 49408, 64, 4, 2),
                fold_bn=True, pos_grid=2, rewrites=True, **KW).eval()
    port.load_state_dict({k: torch.as_tensor(v) for k, v in fold_batchnorm(
        from_jax(variables), 64).items()})
    enable_int8(port, QuantConfig(**GATES))
    return dict(model=model, folded=folded, img=img, word=word, calib=calib,
                port=port)


def _port_batches(batches):
    return [(_t(a).permute(0, 3, 1, 2), _t(b).long()) for a, b in batches]


def _jax_scales(tiny, jax_env, pct=None):
    if pct:
        jax_env.setenv("CRIS_INT8_CALIB_PCT", str(pct))
    model = dataclasses.replace(tiny["model"], fold_bn=True, pos_grid=2,
                                quant_int8=True)
    scales = jcal.calibrate_act_scales(
        model, tiny["folded"], [(jnp.asarray(a), jnp.asarray(b))
                                for a, b in tiny["calib"]])
    return jax.tree_util.tree_map(np.asarray, scales)


@pytest.fixture(scope="module")
def jax_maxabs(tiny):
    """JAX's maxabs scales of the tiny model (``_jax_scales``), computed
    once for the tests that read them."""
    with pytest.MonkeyPatch.context() as mp:
        return _jax_scales(tiny, _set_jax_env(mp))


@pytest.mark.parametrize("pct", [0.0, 99.9])
def test_calibration_matches_jax(tiny, jax_env, jax_maxabs, pct):
    """Every site JAX calibrates, and no other, within 1e-6; the tails'
    scales come stacked in JAX and one a block in the port."""
    ref = quant_from_jax(_jax_scales(tiny, jax_env, pct) if pct
                         else jax_maxabs)
    got = calibrate_act_scales(tiny["port"], _port_batches(tiny["calib"]),
                               pct=pct)
    assert set(got) == set(ref)
    assert any(".layer2.1." in k for k in got)
    for name, value in ref.items():
        np.testing.assert_allclose(got[name].numpy(), value, rtol=1e-6,
                                   err_msg=name)


def test_scale_files_round_trip_between_the_packages(tiny, jax_env,
                                                     jax_maxabs, tmp_path):
    """A port file loads into cris_tpu.checkpoint.load_act_scales with the
    same per-site scales and sets its gates; a JAX file loads into the
    port with the same scales and gates."""
    scales = calibrate_act_scales(tiny["port"], _port_batches(tiny["calib"]))
    path = str(tmp_path / "port.npz")
    save_act_scales(path, scales, min_ch=16, pooled_min_ch=32,
                    upfold_min_ch=32)
    for key in ENV:
        if "INT8" in key:
            jax_env.delenv(key)
    tree = jcal.load_act_scales(path)
    assert os.environ["CRIS_INT8_MIN_CH"] == "16"
    back = quant_from_jax(jax.tree_util.tree_map(np.asarray, tree))
    assert set(back) == set(scales)
    for name, value in scales.items():
        assert np.float32(back[name]) == value.numpy(), name
    jpath = str(tmp_path / "jax.npz")
    jcal.save_act_scales(jpath, jax_maxabs, min_ch=16,
                         pooled_min_ch=32, upfold_min_ch=32)
    loaded, gates = load_act_scales(jpath)
    assert gates == GATES
    ref = quant_from_jax(jax_maxabs)
    assert {k: float(v) for k, v in loaded.items()} == {
        k: float(v) for k, v in ref.items()}
    # the port's writer gives the JAX writer's file, entry for entry
    save_act_scales(path, {k: torch.tensor(v) for k, v in loaded.items()},
                    **GATES)
    with np.load(path) as a, np.load(jpath) as b:
        assert sorted(a.files) == sorted(b.files)
        for key in a.files:
            assert np.array_equal(a[key], b[key]), key


def test_tiny_int8_model_matches_jax(tiny, jax_env, jax_maxabs, monkeypatch):
    """The two int8 models on the same weights and JAX's scales, f32.

    Bar: in f32 the packages' site inputs differ by rounding only (the
    plain tiny models agree at about 1e-6), so a site's int8 operands
    differ only where x / s falls within that rounding of a half level.
    The test records every site's int8 operands in both packages (keyed
    by the site's scale) and measures the share of flipped levels; with
    none flipped the logits are as near as the plain f32 models, and the
    bar is the f32 parity bar, 1e-4 relative L2. Measured on this seed:
    0 of 273472 levels flipped, 1.1e-6."""
    jscales = jax_maxabs
    jmodel = dataclasses.replace(tiny["model"], fold_bn=True, pos_grid=2,
                                 quant_int8=True)
    jax_q, port_q = {}, {}

    def record(store, s, xq):  # a site: its scale and input shape
        xq = np.asarray(xq)
        store.setdefault((round(float(s), 12), xq.shape), xq)

    real_static, real_phase = jq.int8_conv2d_static, jq.int8_phase_conv_static

    def jax_record(x, act_scale):
        # a callback: the stage tails' sites run inside nn.scan's trace
        jax.debug.callback(lambda s, q: record(jax_q, s, q), act_scale,
                           jnp.clip(jnp.round(x.astype(jnp.float32)
                                              / act_scale), -127, 127))

    def jax_static(x, kernel, act_scale, *a, **k):
        jax_record(x, act_scale)
        return real_static(x, kernel, act_scale, *a, **k)

    def jax_phase(x, pk, pads, act_scale):
        jax_record(x, act_scale)
        return real_phase(x, pk, pads, act_scale)

    monkeypatch.setattr(jq, "int8_conv2d_static", jax_static)
    monkeypatch.setattr(jq, "int8_phase_conv_static", jax_phase)
    ref = np.asarray(jax.jit(lambda v, i, w: jmodel.apply(
        v, i, w, train=False))({**tiny["folded"], "quant": jscales},
                               jnp.asarray(tiny["img"]),
                               jnp.asarray(tiny["word"])))
    port = tiny["port"]
    set_act_scales(port, quant_from_jax(jscales))
    real_quantize = k8.int8_quantize

    def port_quantize(x, act_scale, *a, **k):  # each site's one quantise
        xq = real_quantize(x, act_scale, *a, **k)
        record(port_q, act_scale, xq.q[..., :xq.c].float())
        return xq

    monkeypatch.setattr(pq, "int8_quantize", port_quantize)
    try:
        with torch.no_grad():
            got = port(_t(tiny["img"]).permute(0, 3, 1, 2),
                       _t(tiny["word"]).long()).permute(0, 2, 3, 1).numpy()
    finally:
        set_act_scales(port, {})
    assert set(port_q) == set(jax_q) and len(port_q) >= 25
    flipped = sum(int((port_q[s] != jax_q[s]).sum()) for s in jax_q)
    total = sum(v.size for v in jax_q.values())
    rel = float(np.linalg.norm(got - ref) / np.linalg.norm(ref))
    print(f"int8 tiny: {flipped} of {total} levels flipped, logits "
          f"relative L2 {rel:.3e}")
    assert flipped / total <= 1e-4
    assert rel <= 1e-4


@pytest.fixture(scope="module")
def entry_dir(tmp_path_factory):
    """A seed-0 tiny best_model.pth under an output folder, and the
    quant_scales.npz that python3 -m cris_tpu_torch.quantize writes for
    it (over the config's synthetic:// val split)."""
    root = tmp_path_factory.mktemp("int8_entry")
    cfg = load_config(TINY_YAML)
    sd = build_segmenter(cfg, device="cpu", seed=0).state_dict()
    (root / "CRIS_TINY").mkdir()
    torch.save({"state_dict": sd}, root / "CRIS_TINY" / "best_model.pth")
    out = quantize.main(["--config", TINY_YAML, "--device", "cpu",
                         "--batches", "1", "--batch-size", "2",
                         "--min-ch", "16", "--pooled-min-ch", "32",
                         "--upfold-min-ch", "32", "--opts",
                         "TRAIN.output_folder", str(root)])
    return root, out


def test_quantize_service_and_test_entry_on_the_cpu(entry_dir):
    """python3 -m cris_tpu_torch.quantize writes quant_scales.npz (the
    gates recorded); PredictService at precision int8 loads it, every
    site it engages has a scale, and it answers; the test entry at int8
    reads it and scores every pair."""
    entry_dir, out = entry_dir
    assert out == str(entry_dir / "CRIS_TINY" / "quant_scales.npz")
    scales, gates = load_act_scales(out)
    assert gates == GATES and len(scales) >= 25
    cfg = load_config(TINY_YAML)
    cfg.output_folder, cfg.precision = str(entry_dir), "int8"
    svc = PredictService(cfg, device="cpu", max_batch=2)
    assert svc.act_scales == len(scales)
    assert set(scales) <= set(int8_sites(svc.model))
    img = (np.random.RandomState(0).rand(50, 70, 3) * 255).astype(np.uint8)
    res = svc.predict(img, ["a cat", "the dog on the left"])
    assert [r["mask"].shape for r in res] == [(50, 70)] * 2
    iou, prec = port_test.main([
        "--config", TINY_YAML, "--device", "cpu", "--opts",
        "TRAIN.output_folder", str(entry_dir), "TRAIN.precision", "int8",
        "TEST.test_lmdb", "synthetic://4?seed=3", "TRAIN.batch_size_val",
        "4"])
    assert 0.0 <= iou <= 1.0 and 0.0 <= prec["oIoU"] <= 1.0


def test_int8_service_runs_the_sites_int8(entry_dir, monkeypatch):
    """The service's forward at int8 goes through K8's wrappers at every
    engaged site (the plain versions on the CPU), with the file's scales:
    one quantise pass a site, one GEMM a site and four a fold; the bf16
    service's does not."""
    entry_dir, path = entry_dir
    calls, quantised = [], []
    real, real_quantize = k8.int8_conv, k8.int8_quantize

    def counted(x, *a, **k):
        calls.append(tuple(x.q.shape))
        return real(x, *a, **k)

    def counted_quantize(x, *a, **k):
        quantised.append(tuple(x.shape))
        return real_quantize(x, *a, **k)

    monkeypatch.setattr(pq, "int8_conv", counted)
    monkeypatch.setattr(pq, "int8_quantize", counted_quantize)
    cfg = load_config(TINY_YAML)
    cfg.output_folder = str(entry_dir)
    PredictService(cfg, device="cpu", max_batch=1)
    assert not calls
    cfg.precision = "int8"
    svc = PredictService(cfg, device="cpu", max_batch=1)
    sites = int8_sites(svc.model)
    engaged = sum(m.act_scale is not None for m in sites.values())
    # each engaged site once a forward, the four phases of a fold four
    folds = sum(n.endswith(("f2_cat.0", "aggr.0", "vis.1.0", "vis.3.0"))
                for n, m in sites.items() if m.act_scale is not None)
    assert len(calls) == engaged + 3 * folds
    assert len(quantised) == engaged
    assert attach_act_scales(svc.model, path) == engaged


def test_bench_int8_pair_and_rewrites_ab_on_the_cpu(monkeypatch, capsys):
    """python3 -m cris_tpu_torch.bench --int8 prints the int8 pair under
    bench.py's names (calibrated on its own batches) and --ab rewrites
    the off / on turns and its decision, on the tiny model."""
    import json

    from cris_tpu_torch import bench

    monkeypatch.setattr(bench, "R50", TINY_YAML)
    monkeypatch.setattr(bench, "INT8_METRICS", tuple(
        (name, TINY_YAML, b // 8) for name, _, b in bench.INT8_METRICS))
    monkeypatch.setattr(bench, "INT8_QUANT", QuantConfig(**GATES))
    monkeypatch.setattr(bench, "CALIB_B", 2)
    calib = []
    real = bench.calibrate_act_scales

    def counted(model, batches, **kwargs):
        calib.append(len(batches))
        return real(model, batches, **kwargs)

    monkeypatch.setattr(bench, "calibrate_act_scales", counted)
    args = ["--device", "cpu", "--n1", "1", "--n2", "2", "--trials", "2"]
    assert bench.main(args + ["--int8"]) == 0
    lines = [json.loads(s) for s in capsys.readouterr().out.splitlines()
             if s.startswith("{")]
    assert [r["metric"] for r in lines] == [
        "cris_r50_eval_int8_throughput_416px_b32",
        "cris_r50_eval_int8_throughput_416px_b16"]
    assert all(r["value"] > 0 and r["k8_per_batch"] == 0 for r in lines)
    assert calib == [bench.CALIB_BATCHES] * 2
    assert bench.main(args[:2] + ["--batch", "2", "--n1", "1", "--n2", "2",
                                  "--ab", "rewrites", "--rounds", "1"]) == 0
    lines = [json.loads(s) for s in capsys.readouterr().out.splitlines()
             if s.startswith("{")]
    assert [r["arm"] for r in lines[:-1]] == ["off", "on", "on", "off"]
    assert set(lines[-1]) >= {"rewrites_on", "median_img_s", "gain"}
