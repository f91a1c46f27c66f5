"""The port's train.py path on the CPU: ``python3 -m cris_tpu_torch.train``'s
main against the JAX package's own chain of the same steps, resume,
CLIP archives, remat, and the Evaluator on a train-mode model.

The JAX side is the repository's train.py chain run by hand: one JAX init
of config/synthetic/cris_tiny.yaml (f32, dropout 0, 2 epochs of 2 steps
at batch 8, print_freq 1) written as a ``.pth`` through ``from_jax``,
``cli.load_initial_weight`` on it, ``RefDataLoader``, ``make_optimizer``,
``create_train_state``, ``train_epoch`` and ``Evaluator.validate`` each
epoch, over RefPacks of the JAX ``make_record``'s records, on the JAX
data path that gives the port's batches bit for bit. The port runs
``main([... "--device", "cpu", "--opts", "TRAIN.weight", <pth> ...])`` on
the same files. The JAX train step is compiled once for the module.
Tolerances are stated in each test.
"""

import copy
import dataclasses
import json
import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cris_tpu.data import SyntheticBackend as JaxSynthetic
from cris_tpu.data import native as jax_native
from cris_tpu.data import make_record as jax_make_record
from cris_tpu.data import write_refpack as jax_write_refpack

from cris_tpu_torch import cli
from cris_tpu_torch import test as port_test
from cris_tpu_torch import train as port_train
from cris_tpu_torch.checkpoint import (BEST_NAME, LAST_NAME, from_jax,
                                       infer_clip_config, load_clip_torchscript,
                                       load_jax_variables)
from cris_tpu_torch.checkpoint.torch_convert import save_clip_torchscript
from cris_tpu_torch.data import RefDataLoader, RefDataset
from cris_tpu_torch.engine import Evaluator, train_step
from cris_tpu_torch.engine.evaluator import to_device
from cris_tpu_torch.models import (CLIP, CLIP_PRESETS, CLIPConfig,
                                   build_segmenter, init_weights)
from cris_tpu_torch.utils import (ExperimentTracker, StepTimer,
                                  init_random_seed, load_cfg_from_cfg_file)
from cris_tpu_torch.utils.logging import logger

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = os.path.join(REPO, "config", "synthetic", "cris_tiny.yaml")
# the JAX package's train-chain opts: f32, no dropout, 16 train refs at
# batch 8 (2 steps an epoch), 8 val refs, a progress line every step, and
# test_three_step_loss_trajectory's base_lr 1e-4
CHAIN_OPTS = ["TRAIN.dropout", "0.0", "TRAIN.precision", "fp32",
              "TRAIN.base_lr", "0.0001",
              "TRAIN.print_freq", "1", "TRAIN.workers", "2",
              "TRAIN.workers_val", "2"]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One torch intra-op thread, as tests/test_torch_train.py runs."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _logger_as_it_was():
    """main configures the package logger; hand it back as it was."""
    saved = (list(logger.handlers), logger.level, logger.propagate)
    yield
    for handler in logger.handlers:
        if handler not in saved[0]:
            handler.close()
    logger.handlers[:] = saved[0]
    logger.setLevel(saved[1])
    logger.propagate = saved[2]


# the module's fixtures (``chain`` runs main) and each test
_module_logger = pytest.fixture(scope="module", autouse=True)(
    _logger_as_it_was)
_quiet_logger = pytest.fixture(autouse=True)(_logger_as_it_was)


class Recorder:
    """Stands in for ExperimentTracker; keeps (step, metrics) of each log."""

    instances = []

    def __init__(self, enabled=True, **kwargs):
        self.logs = []
        Recorder.instances.append(self)

    def log(self, metrics, step=None):
        self.logs.append((step, dict(metrics)))

    def finish(self):
        pass


def _jax_chain(cfg, pth):
    """The repository's train.py loop, one process and no mesh, from the
    weights of ``pth``: per-step tracker logs, per-epoch validate results,
    the final variables, and the model and evaluator."""
    from cris_tpu import cli as jax_cli
    from cris_tpu.data import RefDataLoader as JaxLoader
    from cris_tpu.data import RefDataset as JaxDataset
    from cris_tpu.engine import (Evaluator as JaxEvaluator,
                                 create_train_state, make_jitted_train_step,
                                 make_optimizer, train_epoch)
    from cris_tpu.utils import root_key

    model, variables = jax_cli.build_model_and_variables(cfg)
    cfg.weight = pth
    variables = jax_cli.load_initial_weight(cfg, variables)
    train_loader = JaxLoader(
        JaxDataset(cfg.train_lmdb, cfg.mask_root, cfg.dataset, cfg.train_split,
                   "train", cfg.input_size, cfg.word_len),
        batch_size=cfg.batch_size, shuffle=True, seed=cfg.manual_seed,
        drop_last=True, num_workers=2)
    val_loader = JaxLoader(
        JaxDataset(cfg.val_lmdb, cfg.mask_root, cfg.dataset, cfg.val_split,
                   "val", cfg.input_size, cfg.word_len),
        batch_size=cfg.batch_size_val, shuffle=False, num_workers=2)
    state = create_train_state(model, variables,
                               make_optimizer(cfg, len(train_loader)))
    step = make_jitted_train_step(donate=False)
    evaluator = JaxEvaluator(model, cfg.input_size, None, cfg.batch_size_val)
    rng = root_key(cfg.manual_seed)
    tracker, validated = Recorder(), []
    for epoch in range(1, cfg.epochs + 1):
        train_loader.set_epoch(epoch)
        state = train_epoch(state, train_loader, step, rng, epoch, cfg, None,
                            tracker)
        validated.append(evaluator.validate(
            val_loader, {"params": state.params,
                         "batch_stats": state.batch_stats}, epoch, cfg.epochs))
    final = jax.tree_util.tree_map(
        np.asarray, {"params": state.params, "batch_stats": state.batch_stats})
    return {"model": model, "evaluator": evaluator, "val_loader": val_loader,
            "logs": tracker.logs, "validated": validated, "final": final}


@pytest.fixture(scope="module")
def chain(tmp_path_factory):
    """The JAX chain and the port's main on one JAX init and the same
    RefPacks."""
    from cris_tpu import cli as jax_cli
    from cris_tpu.utils.config import load_cfg_from_cfg_file as jax_cfg_file
    from cris_tpu.utils.config import merge_cfg_from_list as jax_merge

    root = tmp_path_factory.mktemp("train_entry")
    train_pack = str(root / "train.refpack")
    val_pack = str(root / "val.refpack")
    jax_write_refpack(train_pack,
                      [jax_make_record(i, seed=1) for i in range(16)])
    jax_write_refpack(val_pack, [jax_make_record(i, seed=2) for i in range(8)])
    masks = JaxSynthetic(8, seed=2).materialize_masks(str(root / "masks"))
    data_opts = ["DATA.train_lmdb", train_pack, "DATA.val_lmdb", val_pack,
                 "DATA.mask_root", masks]
    cfg = jax_merge(jax_cfg_file(TINY), CHAIN_OPTS + data_opts)

    _, variables = jax_cli.build_model_and_variables(cfg)
    pth = str(root / "init.pth")
    torch.save({"state_dict": {k: torch.from_numpy(np.array(v))
                               for k, v in from_jax(variables).items()}}, pth)
    # the JAX package's per-sample data path, whose cv2 warps the port's
    # numpy warps reproduce bit for bit; its native batch plane rounds
    # otherwise (up to 2 uint8 levels)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_native, "available", lambda: False)
        jax_run = _jax_chain(cfg, pth)

    validated = []
    real_validate = Evaluator.validate

    def validate(self, *args, **kwargs):
        validated.append(real_validate(self, *args, **kwargs))
        return validated[-1]

    out = root / "exp"
    Recorder.instances.clear()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(port_train, "ExperimentTracker", Recorder)
        mp.setattr(Evaluator, "validate", validate)
        result = port_train.main(
            ["--config", TINY, "--device", "cpu", "--opts",
             "TRAIN.output_folder", str(out), "TRAIN.weight", pth,
             *CHAIN_OPTS, *data_opts])
    port = {"result": result, "logs": Recorder.instances[-1].logs,
            "validated": validated, "out_dir": out / cfg.exp_name}
    return {"jax": jax_run, "port": port, "cfg": cfg, "variables": variables,
            "root": root, "data_opts": data_opts, "masks": masks,
            "train_pack": train_pack, "val_pack": val_pack}


# ----------------------------------------------- the slice against JAX

def test_entry_losses_and_logs_match_jax(chain):
    """The tracker's keys and steps equal the JAX train_epoch's, and the
    logged lr. The first step's loss, which depends only on the weights
    and the batch, within rtol 1e-3 (test_three_step_loss_trajectory's
    bar). The later steps' within rtol 5e-3: Adam's first step is about
    lr x sign(g) on every element, and at this init JAX's own f32
    gradient is 3e-2 off the f64 one in global relative L2 where the
    port's is 2e-5 (test_port_gradient_is_the_nearer_one_to_f64), so the
    elements whose sign that error flips move the next loss by 1.7e-3
    (measured) in JAX against the port, where the port moves by 2e-6
    against itself with oneDNN off."""
    ours, theirs = chain["port"]["logs"], chain["jax"]["logs"]
    # step = epoch x steps an epoch + step in the epoch, as the JAX logs it
    assert [s for s, _ in ours] == [s for s, _ in theirs] == [3, 4, 5, 6]
    rel = []
    for (_, got), (_, want) in zip(ours, theirs):
        assert sorted(got) == sorted(want)
        assert got["training/lr"] == pytest.approx(want["training/lr"])
        rel.append(abs(got["training/loss"] - want["training/loss"])
                   / abs(want["training/loss"]))
        print(f"loss {got['training/loss']!r} vs JAX "
              f"{want['training/loss']!r} (rel {rel[-1]:.3e})")
    assert rel[0] <= 1e-3 and max(rel) <= 5e-3, rel
    assert [m["training/lr"] for _, m in ours] == pytest.approx(
        [1e-4, 1e-4, 1e-5, 1e-5])


def _first_batch(chain):
    """The entry's first train batch (epoch 1), as the loader gives it."""
    cfg = load_cfg_from_cfg_file(TINY)
    loader = RefDataLoader(
        RefDataset(chain["train_pack"], None, "synthetic", "train", "train",
                   64, 17), batch_size=8, shuffle=True, seed=cfg.manual_seed,
        drop_last=True, num_workers=1)
    loader.set_epoch(1)
    batch = next(iter(loader))
    return batch, {k: to_device(batch[k], "cpu", nchw=k != "word")
                   for k in ("image", "word", "mask")}


def _f64_forms(monkeypatch):
    """BatchNorm, LayerNorm and the BCE in the forward's own dtype, so
    that a model cast to f64 computes in f64 throughout (BatchNorm in the
    JAX package's E[x^2] - E[x]^2 form)."""
    import torch.nn.functional as F

    from cris_tpu_torch.models import layers, segmenter

    def bn64(self, x):
        dims = [0] + list(range(2, x.dim()))
        mean = x.mean(dims)
        var = torch.clamp(x.square().mean(dims) - mean.square(), min=0.0)
        inv = torch.rsqrt(var + self.eps) * self.weight
        shape = (1, -1) + (1,) * (x.dim() - 2)
        return x * inv.view(shape) + (self.bias - mean * inv).view(shape)

    monkeypatch.setattr(layers.BatchNorm, "forward", bn64)
    monkeypatch.setattr(layers.LayerNormF32, "forward", lambda self, x: (
        F.layer_norm(x, self.normalized_shape, self.weight, self.bias,
                     self.eps)))
    monkeypatch.setattr(segmenter, "bce_with_logits", lambda x, z: (
        F.relu(x) - x * z + torch.log1p(torch.exp(-x.abs()))).mean())


def _port_model(chain, dtype):
    cfg = load_cfg_from_cfg_file(TINY)
    cfg.dropout = 0.0
    return load_jax_variables(build_segmenter(cfg, device="cpu", train=True),
                              chain["variables"]).to(dtype)


def test_port_gradient_is_the_nearer_one_to_f64(chain, monkeypatch):
    """The gradient at the JAX init on the entry's first batch (dropout
    0): the port's in f32 against the port's forward in f64 with
    BatchNorm, LayerNorm and the BCE taken in f64 too, within 1e-4 in
    global relative L2; JAX's f32 gradient is at least 1e-2 from it
    (3.1e-2 measured), the reason for the later steps' loss bar, and
    test_jax_gradient_gap_starts_in_batchnorm_statistics its cause."""
    batch, torch_batch = _first_batch(chain)
    variables = chain["variables"]

    def jax_loss(params):
        (_, _, loss), _ = chain["jax"]["model"].apply(
            {"params": params, "batch_stats": variables["batch_stats"]},
            jnp.asarray(batch["image"]), jnp.asarray(batch["word"]),
            jnp.asarray(batch["mask"]), train=True, mutable=["batch_stats"])
        return loss

    jax_grads = from_jax({"params": jax.jit(jax.grad(jax_loss))(
                              variables["params"]),
                          "batch_stats": variables["batch_stats"]})

    def grads(dtype):
        model = _port_model(chain, dtype)
        _, _, loss = model(torch_batch["image"].to(dtype),
                           torch_batch["word"].long(),
                           torch_batch["mask"].to(dtype))
        loss.backward()
        return {n: p.grad.double().numpy()
                for n, p in model.named_parameters() if p.grad is not None}

    f32 = grads(torch.float32)
    _f64_forms(monkeypatch)
    f64 = grads(torch.float64)
    names = [n for n in f64 if n in jax_grads]

    def rel(g):
        return np.sqrt(sum(np.sum((g[n] - f64[n]) ** 2) for n in names)
                       / sum(np.sum(f64[n] ** 2) for n in names))

    print(f"gradient at the JAX init, global rel L2 from f64: port f32 "
          f"{rel(f32):.3e}, JAX f32 {rel(jax_grads):.3e}")
    assert len(names) > 100 and rel(f32) <= 1e-4
    # the reason for the later steps' loss bar: should the JAX gradient
    # come nearer to f64, that bar no longer has one
    assert rel(jax_grads) >= 1e-2, rel(jax_grads)


def test_jax_gradient_gap_starts_in_batchnorm_statistics(chain, monkeypatch):
    """Where the JAX package's f32 gap from f64 comes from, on the same
    batch and weights: XLA on the CPU takes a per-channel f32 mean with a
    larger rounding error than torch's cascaded sum, and BatchNorm's
    E[x^2] - E[x]^2 magnifies that error by E[x^2] / var.

    - The visual stem's conv1 output is as near the port's f64 one in both
      packages (rel L2 within 2x of each other; 1.1e-7 both, measured),
      and its first BatchNorm's output is at least 10x further from it in
      JAX than in the port (1.2e-5 against 1.3e-7, measured).
    - Per-channel statistics of an (8, 32, 32, 8) f32 input of mean 1 and
      std 0.1 (the stem's shape): XLA's E[x^2] is at least 4x further from
      f64 than torch's, and the variance from it at least 4x further too
      (the worst channel's relative error, measured: 1.9e-6 against
      1.3e-7, and 5.9e-4 against 2.3e-5)."""
    batch, torch_batch = _first_batch(chain)
    variables = chain["variables"]
    _, state = chain["jax"]["model"].apply(
        variables, jnp.asarray(batch["image"]), jnp.asarray(batch["word"]),
        jnp.asarray(batch["mask"]), train=True,
        mutable=["batch_stats", "intermediates"], capture_intermediates=True)
    stem = state["intermediates"]["backbone"]["visual"]
    jax_out = {k: np.asarray(stem[k]["__call__"][0], np.float64)
               .transpose(0, 3, 1, 2) for k in ("conv1", "bn1")}

    def stem_outputs(dtype):
        model, out = _port_model(chain, dtype), {}
        for name in ("conv1", "bn1"):
            getattr(model.backbone.visual, name).register_forward_hook(
                lambda mod, args, y, name=name: out.__setitem__(
                    name, y.detach().double().numpy()))
        model(torch_batch["image"].to(dtype), torch_batch["word"].long(),
              torch_batch["mask"].to(dtype))
        return out

    f32 = stem_outputs(torch.float32)
    _f64_forms(monkeypatch)
    f64 = stem_outputs(torch.float64)

    def rel(a, b):
        return np.linalg.norm(a - b) / np.linalg.norm(b)

    errs = {k: (rel(jax_out[k], f64[k]), rel(f32[k], f64[k]))
            for k in ("conv1", "bn1")}
    print(f"stem against f64, (JAX f32, port f32): {errs}")
    assert 0.5 <= errs["conv1"][0] / errs["conv1"][1] <= 2.0, errs
    assert errs["bn1"][0] >= 10 * errs["bn1"][1], errs

    rng = np.random.RandomState(0)
    x = (rng.randn(8, 32, 32, 8) * 0.1 + 1.0).astype(np.float32)  # NHWC
    x64, xt = x.astype(np.float64), torch.from_numpy(x.transpose(0, 3, 1, 2))
    sq = {"xla": np.asarray(jax.jit(lambda a: jnp.mean(
              jnp.square(a), axis=(0, 1, 2)))(x), np.float64),
          "torch": xt.square().mean((0, 2, 3)).double().numpy()}
    mean = {"xla": np.asarray(jax.jit(lambda a: jnp.mean(
                a, axis=(0, 1, 2)))(x), np.float64),
            "torch": xt.mean((0, 2, 3)).double().numpy()}
    sq64, var64 = np.mean(x64 ** 2, (0, 1, 2)), x64.var((0, 1, 2))
    sq_err = {k: np.max(np.abs(v - sq64) / sq64) for k, v in sq.items()}
    var_err = {k: np.max(np.abs(sq[k] - mean[k] ** 2 - var64) / var64)
               for k in sq}
    print(f"E[x^2] rel err {sq_err}, var rel err {var_err}")
    assert sq_err["xla"] >= 4 * sq_err["torch"], sq_err
    assert var_err["xla"] >= 4 * var_err["torch"], var_err


def test_entry_validate_matches_jax(chain):
    """Each epoch's validate IoU and oIoU against the JAX Evaluator's after
    the same steps, within 1e-3 (0.1 points): a pixel flipped at the 0.35
    threshold moves a ref's IoU by about one over its union, and the host
    chains alone differ by up to 0.1% of the union
    (tests/test_torch_eval.py::test_host_chain_matches_jax). Measured:
    4e-6 and 1e-5 on weights 1.2e-4 apart (the final-weights test)."""
    ours, theirs = chain["port"]["validated"], chain["jax"]["validated"]
    assert len(ours) == len(theirs) == 2
    for (iou, prec), (jiou, jprec) in zip(ours, theirs):
        print(f"validate IoU {iou!r} vs JAX {jiou!r}, oIoU {prec['oIoU']!r} "
              f"vs {jprec['oIoU']!r}")
        assert 0.0 < iou < 1.0
        assert abs(iou - jiou) <= 1e-3, (iou, jiou)
        assert abs(prec["oIoU"] - jprec["oIoU"]) <= 1e-3, (prec, jprec)


def test_entry_final_weights_match_jax(chain):
    """last_model.pth's state_dict against from_jax of the JAX state after
    the same 4 steps: global relative L2 <= 1e-3."""
    want = from_jax(chain["jax"]["final"])
    ckpt = torch.load(chain["port"]["out_dir"] / LAST_NAME, weights_only=False)
    got = ckpt["state_dict"]
    assert set(want) <= set(got)
    diff = sum(float(np.sum((got[k].numpy().astype(np.float64)
                             - want[k].astype(np.float64)) ** 2))
               for k in want)
    norm = sum(float(np.sum(want[k].astype(np.float64) ** 2)) for k in want)
    print(f"final weights: global rel L2 {np.sqrt(diff / norm):.3e}")
    assert np.sqrt(diff / norm) <= 1e-3


def test_jax_reads_the_ports_best_model(chain):
    """The JAX package's load_cris_checkpoint reads best_model.pth, and
    the JAX forward on it gives the port's logits within 1e-4 (rtol and
    atol, f32)."""
    from cris_tpu.checkpoint import load_cris_checkpoint as jax_load

    path = str(chain["port"]["out_dir"] / BEST_NAME)
    variables, _ = jax_load(path, 2)
    rng = np.random.RandomState(5)
    img = rng.randn(2, 64, 64, 3).astype(np.float32)
    word = rng.randint(1, 400, (2, 17))
    word[:, 9:] = 0
    want = chain["jax"]["model"].apply(variables, jnp.asarray(img),
                                       jnp.asarray(word), train=False)
    cfg = load_cfg_from_cfg_file(TINY)
    cfg.fold_bn_eval = False
    model = port_test.load_model(cfg, path, torch.device("cpu"))
    with torch.no_grad():
        got = model(torch.from_numpy(img.transpose(0, 3, 1, 2).copy()),
                    torch.from_numpy(word))
    np.testing.assert_allclose(got.numpy().transpose(0, 2, 3, 1),
                               np.asarray(want), rtol=1e-4, atol=1e-4)


def test_entry_writes_the_reference_format(chain):
    """main returns (best IoU, last epoch); last_model.pth holds
    CRIS.pytorch's keys, best_model.pth the best epoch's; train.log ends
    with the best IoU, the training time and the run line; the port's
    test.py entry evaluates best_model.pth."""
    best, last = chain["port"]["result"]
    out = chain["port"]["out_dir"]
    ckpt = torch.load(out / LAST_NAME, weights_only=False)
    assert sorted(ckpt) == ["best_iou", "cur_iou", "epoch", "optimizer",
                            "prec", "scheduler", "state_dict"]
    assert ckpt["epoch"] == last == 2
    assert ckpt["best_iou"] == best == max(
        iou for iou, _ in chain["port"]["validated"])
    assert ckpt["scheduler"]["last_epoch"] == 4
    assert sorted(ckpt["prec"]) == ["Pr@50", "Pr@60", "Pr@70", "Pr@80",
                                    "Pr@90", "oIoU"]
    assert os.path.isfile(out / BEST_NAME)
    log = (out / "train.log").read_text()
    assert f"* Best IoU={best} *" in log and "* Training time " in log
    run = json.loads(log.rsplit("=> run: ", 1)[1].splitlines()[0])
    assert run["steps"] == 4 and run["images"] == 32 and run["card"] == "cpu"
    assert run["step_event_seconds"] is None and run["traced"] is None
    assert run["images_per_s"] > 0

    iou, prec = port_test.main(
        ["--config", TINY, "--device", "cpu", "--opts",
         "TRAIN.output_folder", str(out.parent), "TRAIN.precision", "fp32",
         "DATA.mask_root", chain["masks"], "TEST.test_lmdb",
         chain["val_pack"]])
    assert 0.0 <= iou <= 1.0 and np.isfinite(prec["oIoU"])


# ------------------------------------------------------------- resume

def _main(out, *opts):
    return port_train.main(
        ["--config", TINY, "--device", "cpu", "--opts",
         "TRAIN.output_folder", str(out), "TRAIN.precision", "fp32",
         "DATA.train_lmdb", "synthetic://16?seed=1",
         "DATA.val_lmdb", "synthetic://8?seed=2", "TRAIN.workers", "2",
         "TRAIN.workers_val", "2", *opts])


def _assert_same_tree(a, b, path=""):
    if isinstance(a, torch.Tensor):
        assert torch.equal(a, b), path
    elif isinstance(a, dict):
        assert sorted(a, key=str) == sorted(b, key=str), path
        for k in a:
            _assert_same_tree(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_same_tree(x, y, f"{path}/{i}")
    else:
        assert a == b, (path, a, b)


def test_resume_equals_an_uninterrupted_run(tmp_path):
    """Dropout 0.1, f32: 2 epochs in one run, and 1 epoch then a resume
    for 1 more, give the same last_model.pth bit for bit (every
    state_dict tensor, the optimizer and scheduler state, best IoU). The
    resumed main's optimizer equals the saved one before its first step."""
    whole, part = tmp_path / "whole", tmp_path / "part"
    assert _main(whole, "TRAIN.epochs", "2")[1] == 2
    assert _main(part, "TRAIN.epochs", "1")[1] == 1
    saved = torch.load(part / "CRIS_TINY" / LAST_NAME, weights_only=False)
    seen = []
    real_epoch = port_train.train_epoch

    def first_epoch(model, optimizer, *args, **kwargs):
        if not seen:
            seen.append(copy.deepcopy(optimizer.state_dict()))
        return real_epoch(model, optimizer, *args, **kwargs)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(port_train, "train_epoch", first_epoch)
        best, last = _main(part, "TRAIN.epochs", "2", "TRAIN.resume",
                           str(part / "CRIS_TINY" / LAST_NAME))
    assert last == 2
    _assert_same_tree(seen[0], saved["optimizer"])
    log = (part / "CRIS_TINY" / "train.log").read_text()
    assert "(epoch 1)" in log
    a = torch.load(whole / "CRIS_TINY" / LAST_NAME, weights_only=False)
    b = torch.load(part / "CRIS_TINY" / LAST_NAME, weights_only=False)
    assert b["best_iou"] == best
    _assert_same_tree(a, b)


def test_resume_refuses_a_missing_file_and_weight_a_directory(tmp_path):
    """A missing resume file raises with the JAX package's message; an
    orbax directory as TRAIN.weight raises (the port reads .pth files)."""
    with pytest.raises(ValueError, match="=> resume failed! no checkpoint "
                                         "found at"):
        _main(tmp_path, "TRAIN.epochs", "1", "TRAIN.resume",
              str(tmp_path / "nothing.pth"))
    with pytest.raises(ValueError, match=r"only from \.pth files"):
        _main(tmp_path, "TRAIN.epochs", "1", "TRAIN.weight", str(tmp_path))


# ----------------------------------------------------------- archives

@pytest.fixture(scope="module")
def archive(tmp_path_factory):
    """The port's seeded TINY CLIP traced into a TorchScript archive with
    a released archive's keys."""
    clip = init_weights(CLIP(CLIP_PRESETS["TINY"]), 11).eval()
    with torch.no_grad():
        for name, buf in clip.named_buffers():  # non-trivial BN statistics
            buf.copy_(torch.rand_like(buf) + 0.5)
    path = save_clip_torchscript(
        clip, str(tmp_path_factory.mktemp("archive") / "clip_tiny.pt"), 64)
    return path, clip


def test_archive_loads_into_the_same_weights_in_both_packages(archive):
    """load_clip_torchscript in the port and in the JAX package: the same
    inferred config (transformer_heads = width // 64 = 1 by the released
    rule, overridden to the traced model's 4 in both, as
    tests/test_convert_tool.py does), and the JAX CLIP forward on the
    converted tree equals the port's CLIP forward on its state_dict within
    1e-4 (rtol and atol, f32): image features and text features."""
    from cris_tpu.checkpoint import infer_clip_config as jax_infer
    from cris_tpu.checkpoint import load_clip_torchscript as jax_load
    from cris_tpu.models import CLIP as JaxCLIP

    path, clip = archive
    sd, ccfg = load_clip_torchscript(path)
    variables, jcfg = jax_load(path)
    fields = [f.name for f in dataclasses.fields(ccfg)]
    assert {f: getattr(jcfg, f) for f in fields} == dataclasses.asdict(ccfg)
    assert {f: getattr(jax_infer(sd), f) for f in fields} == \
        dataclasses.asdict(infer_clip_config(sd))
    assert ccfg.transformer_heads == 1
    ccfg = dataclasses.replace(ccfg, transformer_heads=4)
    assert ccfg == CLIP_PRESETS["TINY"]
    assert not any(k in sd for k in ("input_resolution", "context_length",
                                     "vocab_size"))
    want = clip.state_dict()
    assert sorted(sd) == sorted(want)
    for k in want:
        assert torch.equal(sd[k], want[k]), k

    port = CLIP(ccfg).eval()
    port.load_state_dict(sd)
    jclip = JaxCLIP(dataclasses.replace(jcfg, transformer_heads=4), dtype=None)
    rng = np.random.RandomState(3)
    img = rng.randn(2, 64, 64, 3).astype(np.float32)
    ids = rng.randint(1, 400, (2, 17))
    ids[:, 12:] = 0
    (j2, j3, j4), (jword, jstate) = jclip.apply(variables, jnp.asarray(img),
                                                 jnp.asarray(ids))
    with torch.no_grad():
        x2, x3, x4 = port.encode_image(
            torch.from_numpy(img.transpose(0, 3, 1, 2).copy()))
        word, state = port.encode_text(torch.from_numpy(ids))
    for got, ref in ((x2, j2), (x3, j3), (x4, j4)):
        np.testing.assert_allclose(got.numpy().transpose(0, 2, 3, 1),
                                   np.asarray(ref), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(word.numpy(), np.asarray(jword), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(state.numpy(), np.asarray(jstate), rtol=1e-4,
                               atol=1e-4)


def test_build_model_takes_the_archive_or_the_seeded_preset(archive):
    """build_model with clip_pretrain an archive: backbone.* is the
    archive's bit for bit and the head the seeded init's; with a preset
    name: all of it the seeded init's. A ViT state dict gives its ViT
    config, and a ViT archive is refused with a ValueError naming the
    tower."""
    path, clip = archive
    cfg = load_cfg_from_cfg_file(TINY)
    seeded = build_segmenter(cfg, device="cpu", seed=cfg.manual_seed,
                             train=True).state_dict()
    preset = cli.build_model(cfg, "cpu").state_dict()
    _assert_same_tree(preset, seeded)
    cfg.clip_pretrain = path
    model = cli.build_model(cfg, "cpu")
    assert model.training
    got = model.state_dict()
    for k, v in clip.state_dict().items():
        assert torch.equal(got["backbone." + k], v), k
    for k, v in seeded.items():
        if not k.startswith("backbone."):
            assert torch.equal(got[k], v), k
    vit = init_weights(CLIP(CLIPConfig(64, 32, 2, 64, 8, 77, 49408, 64, 1,
                                       2)), 1)
    vit_cfg = infer_clip_config(vit.state_dict())
    assert vit_cfg.is_vit and vit_cfg.vision_layers == 2
    assert vit_cfg.image_resolution == 32 and vit_cfg.vision_patch_size == 8
    cfg.clip_pretrain = save_clip_torchscript(vit, path + ".vit.pt",
                                              image_resolution=32)
    with pytest.raises(ValueError, match="ViT image tower"):
        cli.build_model(cfg, "cpu")


# -------------------------------------------------------------- remat

def test_remat_keeps_gradients_and_bn_statistics(monkeypatch):
    """Dropout 0.1, one seed, f32: a train step with remat on gives the
    gradients, loss and BN running statistics of one with remat off, bit
    for bit; remat runs each bottleneck, text block and decoder layer
    once a step, and nothing in eval."""
    import torch.utils.checkpoint as ckpt

    cfg = load_cfg_from_cfg_file(TINY)
    rng = np.random.RandomState(4)
    word = rng.randint(1, 400, (4, 17))
    word[:2, 10:] = 0
    batch = {"image": rng.randn(4, 3, 64, 64).astype(np.float32),
             "word": word,
             "mask": (rng.rand(4, 1, 64, 64) > 0.6).astype(np.float32)}
    calls = []
    real = ckpt.checkpoint
    monkeypatch.setattr(ckpt, "checkpoint",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    runs = []
    for remat in (False, True):
        cfg.remat = remat
        model = build_segmenter(cfg, device="cpu", seed=3, train=True)
        opt = torch.optim.SGD(model.parameters(), lr=0.0)
        calls.clear()
        loss = train_step(model, opt, torch.optim.lr_scheduler.LambdaLR(
            opt, lambda s: 1.0), batch, step_seed=7)["loss"]
        runs.append((loss, {n: p.grad for n, p in model.named_parameters()
                            if p.grad is not None},
                     {n: b for n, b in model.named_buffers()}, len(calls)))
        model.eval()
        with torch.no_grad():
            model(torch.from_numpy(batch["image"]), torch.from_numpy(word))
        assert len(calls) == runs[-1][3]
    (loss0, g0, b0, n0), (loss1, g1, b1, n1) = runs
    assert n0 == 0 and n1 == 4 + 2 + 2  # 4 bottlenecks, 2 blocks, 2 layers
    assert torch.equal(loss0, loss1)
    _assert_same_tree(g0, g1)
    _assert_same_tree(b0, b1)


# ---------------------------------------------- validate on a train model

def test_validate_on_a_train_mode_model_matches_jax(chain):
    """A train-mode port model at dropout 0.1 with the JAX init's weights:
    Evaluator.validate evaluates it as the JAX Evaluator does (train=False):
    IoU and oIoU within 1e-3, test_entry_validate_matches_jax's bar;
    the model comes back in train mode with its BN buffers unchanged."""
    cfg = load_cfg_from_cfg_file(TINY)
    model = load_jax_variables(build_segmenter(cfg, device="cpu"),
                               chain["variables"]).train()
    buffers = {n: b.clone() for n, b in model.named_buffers()}
    loader = RefDataLoader(
        RefDataset(chain["val_pack"], chain["masks"], "synthetic", "val",
                   "val", 64, 17), batch_size=8, num_workers=2)
    iou, prec = Evaluator(model, 64, None, batch_size=8,
                          host_workers=2).validate(loader)
    jev = chain["jax"]["evaluator"]
    jiou, jprec = jev.validate(chain["jax"]["val_loader"], chain["variables"])
    print(f"train-mode model: IoU {iou!r} vs JAX {jiou!r}")
    assert abs(iou - jiou) <= 1e-3, (iou, jiou)
    assert abs(prec["oIoU"] - jprec["oIoU"]) <= 1e-3, (prec, jprec)
    assert model.training and all(m.training for m in model.modules())
    _assert_same_tree(buffers, dict(model.named_buffers()))


# ---------------------------------------------------------- the rest

def test_entry_refuses_without_a_card(tmp_path):
    """No CUDA and no --device cpu is an error, not a fallback."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="--device cpu"):
        port_train.main(["--config", TINY, "--opts", "TRAIN.output_folder",
                         str(tmp_path)])


def test_host_helpers(monkeypatch, tmp_path):
    """ExperimentTracker is a no-op without wandb; init_random_seed keeps
    a configured seed and draws one otherwise; StepTimer writes a Chrome
    trace of its window and measures it (its steps and wall time; the
    card's busy time only on a card); to_device puts a loader's NHWC
    batches in NCHW, contiguous."""
    monkeypatch.setitem(sys.modules, "wandb", None)  # import fails
    tracker = ExperimentTracker(enabled=True, project="CRIS")
    tracker.log({"training/loss": 1.0}, step=1)
    tracker.finish()
    assert tracker._run is None

    assert init_random_seed(7) == 7
    seed = init_random_seed(None)
    assert isinstance(seed, int) and 0 <= seed < 2**31

    for steps, stop in ((3, 3), (6, 4)):  # closed by the loop's end, by stop
        timer = StepTimer(str(tmp_path / f"prof{steps}"), start=1, stop=stop)
        x = torch.ones(8, 8)
        for i in range(steps):
            timer.step(i)
            x = x @ x
        timer.close()
        with open(tmp_path / f"prof{steps}" / "trace.json") as f:
            assert json.load(f)["traceEvents"]
        window = timer.window
        assert window["steps"] == min(steps, stop) - 1 and window["wall_ms"] > 0
        assert window["device_busy_ms"] is None
        assert window["device_busy_share"] is None
    assert StepTimer(None).window is None

    rng = np.random.RandomState(0)
    batch = {"image": rng.rand(2, 5, 6, 3).astype(np.float32),
             "word": rng.randint(0, 9, (2, 4)),
             "mask": rng.rand(2, 5, 6, 1).astype(np.float32)}
    got = {k: to_device(batch[k], "cpu", nchw=k != "word") for k in batch}
    for key in ("image", "mask"):
        np.testing.assert_array_equal(got[key].numpy(),
                                      batch[key].transpose(0, 3, 1, 2))
        assert got[key].is_contiguous()
    assert torch.equal(got["word"], torch.from_numpy(batch["word"]))
    assert to_device(batch["word"], "cpu", torch.long).dtype == torch.long
