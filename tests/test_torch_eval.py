"""The port's test.py path on the CPU against the JAX package: the metrics,
the host chain (the same probabilities into both packages'
_finish_sample), validate and inference end to end on the same weights
(from_jax, f32) and the same RefPack records, and
``python3 -m cris_tpu_torch.test``'s main with ``--device cpu``."""

import json
import os

import cv2
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cris_tpu.data import RefDataLoader as JaxLoader
from cris_tpu.data import RefDataset as JaxDataset
from cris_tpu.data import SyntheticBackend as JaxSynthetic
from cris_tpu.data import make_record as jax_make_record
from cris_tpu.data import write_refpack as jax_write_refpack
from cris_tpu.engine import Evaluator as JaxEvaluator
from cris_tpu.engine import metrics as jax_metrics
from cris_tpu.models import build_segmenter as jax_build

from cris_tpu_torch import test as port_test
from cris_tpu_torch.checkpoint import from_jax
from cris_tpu_torch.data import (RefDataLoader, RefDataset, decode_image,
                                 decode_mask, get_transform_mats,
                                 inverse_warp_prediction, read_mask, warp_mask)
from cris_tpu_torch.engine import Evaluator, metrics
from cris_tpu_torch.utils import load_cfg_from_cfg_file
from cris_tpu_torch.utils.logging import logger

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = os.path.join(REPO, "config", "synthetic", "cris_tiny.yaml")
BATCH = 4


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """Tiny CRIS in f32 with the JAX init's weights in both packages, the
    port's as a best_model.pth under an output folder, and a RefPack of
    the JAX make_record's records with their GT masks."""
    root = tmp_path_factory.mktemp("eval")
    cfg = load_cfg_from_cfg_file(TINY)
    cfg.precision = "fp32"
    jmodel = jax_build(cfg)
    variables = jax.jit(jmodel.init)(jax.random.PRNGKey(0),
                                     jnp.zeros((1, 64, 64, 3)),
                                     jnp.zeros((1, 17), jnp.int32))
    variables = jax.tree_util.tree_map(np.asarray, variables)
    sd = {k: torch.as_tensor(np.array(v)) for k, v in from_jax(variables).items()}
    out_dir = root / "exp" / cfg.exp_name
    out_dir.mkdir(parents=True)
    torch.save({"state_dict": {"module." + k: v for k, v in sd.items()}},
               out_dir / "best_model.pth")
    pack = str(root / "test.refpack")
    jax_write_refpack(pack, [jax_make_record(i, seed=9) for i in range(6)])
    masks = JaxSynthetic(6, seed=9).materialize_masks(str(root / "masks"))
    model = port_test.load_model(cfg, str(out_dir / "best_model.pth"),
                                 torch.device("cpu"))
    return {"root": root, "cfg": cfg, "jmodel": jmodel, "variables": variables,
            "pack": pack, "masks": masks, "model": model,
            "jev": JaxEvaluator(jmodel, 64, batch_size=BATCH),
            "ev": Evaluator(model, 64, None, batch_size=BATCH, host_workers=2)}


@pytest.fixture(autouse=True)
def _quiet_logger():
    """test.main configures the package logger; hand it back as it was."""
    saved = (list(logger.handlers), logger.level, logger.propagate)
    yield
    for handler in logger.handlers:
        if handler not in saved[0]:
            handler.close()
    logger.handlers[:] = saved[0]
    logger.setLevel(saved[1])
    logger.propagate = saved[2]


# ----------------------------------------------------------------- metrics

def test_device_metrics_match_jax():
    rng = np.random.RandomState(0)
    logits = rng.randn(3, 26, 26).astype(np.float32) * 2
    target = (rng.rand(3, 26, 26) > 0.6).astype(np.float32)
    target[2] = 0.3 * target[2]  # fractional warped values count as foreground
    np.testing.assert_allclose(
        metrics.val_metric(torch.from_numpy(logits), torch.from_numpy(target)).numpy(),
        np.asarray(jax_metrics.val_metric(logits, target)), rtol=1e-6)
    for got, want in zip(
            metrics.intersection_and_union(torch.from_numpy(logits),
                                           torch.from_numpy(target)),
            jax_metrics.intersection_and_union(logits, target)):
        assert float(got) == float(want)
    for got, want in zip(
            metrics.train_metrics(torch.from_numpy(logits), torch.from_numpy(target)),
            jax_metrics.train_metrics(logits, target)):
        assert abs(float(got) - float(want)) < 1e-4


def test_host_metrics_match_jax():
    rng = np.random.RandomState(1)
    pred = rng.rand(40, 30) > 0.5
    mask = (rng.rand(40, 30) > 0.7).astype(np.float64)
    assert metrics.mask_iou(pred, mask) == jax_metrics.mask_iou(pred, mask)
    assert metrics.mask_inter_union(pred, mask) == \
        jax_metrics.mask_inter_union(pred, mask)
    ious = rng.rand(50).tolist() + [0.5, 0.6, 0.9, 1.0]
    assert metrics.summarize_ious(ious) == jax_metrics.summarize_ious(ious)
    assert list(metrics.summarize_ious(ious)[1]) == [
        "Pr@50", "Pr@60", "Pr@70", "Pr@80", "Pr@90"]


# -------------------------------------------------------------- host chain

def _smooth_probs(seed, size=64):
    rng = np.random.RandomState(seed)
    coarse = torch.from_numpy(rng.randn(1, 1, 8, 8).astype(np.float32) * 3)
    logits = torch.nn.functional.interpolate(coarse, (size, size),
                                             mode="bicubic", align_corners=True)
    return torch.sigmoid(logits)[0, 0].numpy()


def test_host_chain_matches_jax(setup):
    """The same probabilities into both packages' _finish_sample:
    intersection and union within 0.1% of the union (the inverse warps
    differ at rounding level, which flips pixels right at 0.35)."""
    ds = JaxDataset(setup["pack"], setup["masks"], "synthetic", "val", "val",
                    64, 17)
    for i in range(len(ds)):
        s = ds[i]
        probs = _smooth_probs(i)
        args = (probs, s["inverse"], s["ori_size"], s["mask_path"])
        iou, inter, union = setup["ev"]._finish_sample(*args)
        jiou, jinter, junion = setup["jev"]._finish_sample(*args)
        print(f"host chain, ref {i}: port (inter, union) {(inter, union)}, "
              f"JAX {(jinter, junion)}")
        assert abs(inter - jinter) <= 1e-3 * junion
        assert abs(union - junion) <= 1e-3 * junion
        assert abs(iou - jiou) <= 2e-3


def test_host_chain_scores_a_perfect_prediction_near_one(setup):
    """The GT mask warped to input size, inverse-warped back and
    thresholded against the mask file: IoU near 1."""
    ds = RefDataset(setup["pack"], setup["masks"], "synthetic", "val", "val",
                    416, 17)
    for i in range(3):
        s = ds[i]
        mat, inv = get_transform_mats(tuple(s["ori_size"]), (416, 416))
        warped = warp_mask(decode_mask(ds.backend[i]["mask"]), mat, (416, 416))
        back = inverse_warp_prediction(warped, inv, tuple(s["ori_size"]))
        assert metrics.mask_iou(back > 0.35, read_mask(s["mask_path"]) / 255.0) > 0.97


def test_dispatch_puts_nhwc_in_nchw_on_the_device(setup):
    ev = setup["ev"]
    rng = np.random.RandomState(2)
    img = rng.randn(BATCH, 64, 64, 3).astype(np.float32)
    word = rng.randint(1, 400, (BATCH, 17))
    got = ev._fetch(ev._dispatch(img, word), 3)
    want = ev.predict_probs(img.transpose(0, 3, 1, 2), word)[:3]
    np.testing.assert_array_equal(got, want)


# ------------------------------------------------------------- end to end

def test_validate_matches_jax_end_to_end(setup):
    """The port's loader + validate against the JAX package's on the same
    records and weights in f32: mean IoU and oIoU within 0.5 points."""
    ours_ds = RefDataset(setup["pack"], setup["masks"], "synthetic", "val",
                         "val", 64, 17)
    theirs_ds = JaxDataset(setup["pack"], setup["masks"], "synthetic", "val",
                           "val", 64, 17)
    iou, prec = setup["ev"].validate(
        RefDataLoader(ours_ds, batch_size=BATCH, num_workers=2), epoch=1, epochs=1)
    jiou, jprec = setup["jev"].validate(
        JaxLoader(theirs_ds, batch_size=BATCH, num_workers=1),
        setup["variables"], epoch=1, epochs=1)
    print(f"validate: IoU {iou!r} vs JAX {jiou!r}, oIoU {prec['oIoU']!r} "
          f"vs JAX {jprec['oIoU']!r}")
    assert set(prec) == set(jprec) == {"Pr@50", "Pr@60", "Pr@70", "Pr@80",
                                       "Pr@90", "oIoU"}
    assert 0.0 < iou < 1.0
    assert abs(iou - jiou) <= 5e-3, (iou, jiou)
    assert abs(prec["oIoU"] - jprec["oIoU"]) <= 5e-3, (prec, jprec)
    run = setup["ev"].last_run
    assert run["pairs"] == 6 and run["batches"] == 2
    assert run["device_seconds"] is None


def _main_argv(setup, *opts):
    return ["--config", TINY, "--device", "cpu", "--opts",
            "TRAIN.output_folder", str(setup["root"] / "exp"),
            "TRAIN.precision", "fp32", "DATA.mask_root", setup["masks"],
            "TEST.test_lmdb", setup["pack"], *opts]


def test_test_main_matches_jax_inference(setup):
    """python3 -m cris_tpu_torch.test's main (best_model.pth, BN folded,
    f32, every sentence) against the JAX Evaluator.inference on the
    unfolded weights: mean IoU and oIoU within 0.5 points; the run line
    in test.log counts every pair."""
    iou, prec = port_test.main(_main_argv(setup, "TRAIN.batch_size_val", "4"))
    ds = JaxDataset(setup["pack"], setup["masks"], "synthetic", "val", "test",
                    64, 17)
    jiou, jprec = setup["jev"].inference(ds, setup["variables"], word_len=17,
                                         progress=False)
    print(f"inference: IoU {iou!r} vs JAX {jiou!r}, oIoU {prec['oIoU']!r} "
          f"vs JAX {jprec['oIoU']!r}")
    assert abs(iou - jiou) <= 5e-3, (iou, jiou)
    assert abs(prec["oIoU"] - jprec["oIoU"]) <= 5e-3, (prec, jprec)
    for key in ("Pr@50", "Pr@60", "Pr@70", "Pr@80", "Pr@90"):
        assert key in prec
    pairs = sum(len(ds[i]["sents"]) for i in range(len(ds)))
    log = (setup["root"] / "exp" / "CRIS_TINY" / "test.log").read_text()
    run = json.loads(log.rsplit("=> run: ", 1)[1].splitlines()[0])
    assert run["pairs"] == pairs and run["batches"] == -(-pairs // 4)
    assert run["card"] == "cpu" and run["pairs_per_s"] > 0
    assert f"IoU={100.0 * iou:.2f}" in log


def test_inference_visualize_dumps_every_pair(setup, tmp_path):
    ds = RefDataset(setup["pack"], setup["masks"], "synthetic", "val", "test",
                    64, 17)
    vis = tmp_path / "vis"
    vis.mkdir()
    setup["ev"].inference(ds, word_len=17, visualize=True, vis_dir=str(vis),
                          progress=False)
    names = os.listdir(vis)
    pairs = sum(len(ds[i]["sents"]) for i in range(len(ds)))
    assert len([n for n in names if "-iou=" in n]) == pairs
    assert sorted(n for n in names if n.endswith("-mask.png")) == sorted(
        f"{i}-mask.png" for i in range(len(ds)))
    np.testing.assert_array_equal(read_mask(str(vis / "0-mask.png")),
                                  read_mask(ds[0]["mask_path"]))
    # each ref's original image at quality 95, as cv2.imwrite writes it:
    # as near the original as cv2's own encode (within 0.5 dB PSNR)
    assert sorted(n for n in names if n.endswith("-img.jpg")) == sorted(
        f"{i}-img.jpg" for i in range(len(ds)))
    for i in range(len(ds)):
        ori = ds[i]["ori_img"]
        buf = (vis / f"{i}-img.jpg").read_bytes()
        got = cv2.imdecode(np.frombuffer(buf, np.uint8), cv2.IMREAD_COLOR)
        np.testing.assert_array_equal(got, decode_image(buf))
        ok, ref = cv2.imencode(".jpg", ori, [cv2.IMWRITE_JPEG_QUALITY, 95])
        assert ok and got.shape == ori.shape
        assert _psnr(got, ori) >= _psnr(
            cv2.imdecode(ref, cv2.IMREAD_COLOR), ori) - 0.5


def _psnr(a, b):
    err = np.mean((a.astype(np.float64) - b) ** 2)
    return 10 * np.log10(255.0 ** 2 / err) if err else np.inf


def test_test_main_refuses_without_card_checkpoint_or_int8(setup, tmp_path):
    """No CUDA and no --device cpu is an error, not a fallback; a missing
    best_model.pth raises as the JAX test.py does; so does a precision
    neither package knows (int8 is served since it was ported:
    tests/test_torch_int8.py)."""
    argv = _main_argv(setup)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="--device cpu"):
            port_test.main([a for a in argv if a not in ("--device", "cpu")])
    with pytest.raises(ValueError, match="no checkpoint found"):
        port_test.main(argv[:6] + [str(tmp_path)] + argv[7:])
    with pytest.raises(ValueError, match="precision 'int4'"):
        port_test.main(argv + ["TRAIN.precision", "int4"])
