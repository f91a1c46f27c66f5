"""The port's train step against the JAX package, on the CPU in f32.

Tiny CRIS (``conftest.tiny_cris``) is initialised in JAX with
PRNGKey(42) on the inputs of tests/goldens/tiny_forward.npz and loaded
into the port with ``from_jax``; both take one train step on the same
batch at dropout 0 with the optimizer of ``conftest.tiny_train_cfg``.
Loss, IoU, every gradient, the per-leaf digest of the updated
parameters and the BN running statistics are compared; the loss and IoU
also against tests/goldens/tiny_train_step.npz. The JAX step is compiled
once per module (module-scoped fixture). Tolerances: rtol 1e-4 on the
loss and atol 1e-3 on the IoU (the golden's own bars), the gradients per
leaf in RMS (see test_train_step_gradients) and 1e-4 in global relative
L2, the digest at the golden's rtol 1e-4 / atol 1e-7, the running
statistics at 1e-5.
"""

import os
import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from conftest import param_digest, tiny_cris, tiny_train_cfg

from cris_tpu_torch.checkpoint import from_jax, load_jax_variables
from cris_tpu_torch.engine import (apply_gradients, lr_at_epoch,
                                   make_optimizer,
                                   multistep_schedule, train_metrics,
                                   train_step)
from cris_tpu_torch.models import (BatchNorm, CLIPConfig, CRIS,
                                   bce_with_logits, param_group_label)
from cris_tpu_torch.utils import CfgNode

GOLDEN_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "goldens")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One torch intra-op thread for this module: the suite runs several
    pytest workers on the machine's cores, and torch's OpenMP pool slows
    by tens of times when its threads contend with the other workers'."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _port_tiny(dropout=0.0):
    ccfg = CLIPConfig(64, 64, (1, 1, 1, 1), 16, None, 77, 49408, 64, 4, 2)
    return CRIS(ccfg, fpn_in=(128, 256, 64), fpn_out=(32, 64, 128),
                vis_dim=64, num_layers=2, num_head=4, dim_ffn=128,
                dropout=dropout)


def _port_cfg(**overrides):
    return CfgNode(dict(tiny_train_cfg(**overrides)))


def _batch():
    fwd = np.load(os.path.join(GOLDEN_DIR, "tiny_forward.npz"))
    gold = np.load(os.path.join(GOLDEN_DIR, "tiny_train_step.npz"))
    return fwd["img"], fwd["word"], gold["mask"], gold


def _port_batch(img, word, mask):
    return {"image": np.ascontiguousarray(img.transpose(0, 3, 1, 2)),
            "word": word,
            "mask": np.ascontiguousarray(mask.transpose(0, 3, 1, 2))}


def _to_jax_params(sd, num_layers=2):
    from cris_tpu.checkpoint.torch_convert import convert_cris_state_dict

    variables, _ = convert_cris_state_dict(
        {k: v.detach().clone() for k, v in sd.items()},
        num_decoder_layers=num_layers)
    return variables["params"]


def _jax_init():
    img, word, mask, _ = _batch()
    model = tiny_cris(dropout=0.0, dtype=None)
    variables = model.init(jax.random.PRNGKey(42), jnp.asarray(img),
                           jnp.asarray(word), jnp.asarray(mask), train=False)
    batch = {"image": jnp.asarray(img), "word": jnp.asarray(word),
             "mask": jnp.asarray(mask)}
    return model, jax.tree_util.tree_map(np.asarray, variables), batch


def _jax_state(model, variables, cfg):
    from cris_tpu.engine import create_train_state, make_optimizer as jax_opt

    return create_train_state(model, variables,
                              jax_opt(cfg, steps_per_epoch=2))


@pytest.fixture(scope="module")
def jax_run():
    """One JAX train step from PRNGKey(42) weights (one compile), with its
    gradients."""
    from cris_tpu.engine import train_step as jax_train_step

    model, variables, batch = _jax_init()
    state = _jax_state(model, variables, tiny_train_cfg())

    def step_and_grads(state, batch, rng):
        def loss_fn(params):
            (_, _, loss), _ = state.apply_fn(
                {"params": params, "batch_stats": state.batch_stats},
                batch["image"], batch["word"], batch["mask"], train=True,
                mutable=["batch_stats"], rngs={"dropout": rng})
            return loss

        grads = jax.grad(loss_fn)(state.params)
        new_state, metrics = jax_train_step(state, batch, rng)
        return new_state, metrics, grads

    state, metrics, grads = jax.jit(step_and_grads)(
        state, batch, jax.random.PRNGKey(1))
    np_tree = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    return dict(variables=variables, state=np_tree(state),
                metrics={k: float(v) for k, v in metrics.items()},
                grads=np_tree(grads), gold=_batch()[3])


def _port_steps(variables, cfg, steps):
    img, word, mask, _ = _batch()
    model = load_jax_variables(_port_tiny(), variables).train()
    optimizer, scheduler = make_optimizer(model, CfgNode(dict(cfg)),
                                          steps_per_epoch=2)
    batch = _port_batch(img, word, mask)
    metrics = [{k: float(v) for k, v in train_step(
        model, optimizer, scheduler, batch, step_seed=i).items()}
        for i in range(steps)]
    return model, metrics


@pytest.fixture(scope="module")
def port_run(jax_run):
    model, metrics = _port_steps(jax_run["variables"], tiny_train_cfg(), 1)
    return dict(metrics=metrics[0],
                grads={n: p.grad.numpy().copy()
                       for n, p in model.named_parameters()},
                sd={k: v.clone() for k, v in model.state_dict().items()})


def test_train_step_loss_and_iou(jax_run, port_run):
    got, ref, gold = port_run["metrics"], jax_run["metrics"], jax_run["gold"]
    np.testing.assert_allclose(got["loss"], ref["loss"], rtol=1e-4)
    np.testing.assert_allclose(got["iou"], ref["iou"], atol=1e-3)
    np.testing.assert_allclose(got["prec@50"], ref["prec@50"], atol=1e-3)
    np.testing.assert_allclose(got["loss"], gold["loss"], rtol=1e-4)
    np.testing.assert_allclose(got["iou"], gold["iou"], atol=1e-3)


def _rms(x):
    return float(np.sqrt(np.mean(np.square(x, dtype=np.float64))))


def test_train_step_gradients(jax_run, port_run):
    """Each gradient leaf within 1e-4 + 1e-3 x its RMS, in RMS. The bar is
    per leaf and not per element: train-mode BN over this batch of 2 (the
    neck's txt_proj normalises over 2 values) amplifies f32 summation
    order, so the port differs from itself by ~6e-5 of a leaf's RMS when
    only oneDNN is switched off, the same size as its difference from JAX;
    the relative 1e-3 is chip_smoke.py's card-vs-CPU gradient bar."""
    ref = from_jax({"params": jax_run["grads"],
                    "batch_stats": jax_run["variables"]["batch_stats"]})
    got = port_run["grads"]
    assert set(got) <= set(ref)
    for name, g in got.items():
        err = _rms(g - ref[name])
        assert err <= 1e-4 + 1e-3 * _rms(ref[name]), (name, err)
    total = np.sqrt(sum(np.sum(np.square(g - ref[n], dtype=np.float64))
                        for n, g in got.items()))
    norm = np.sqrt(sum(np.sum(np.square(ref[n], dtype=np.float64))
                       for n in got))
    assert total <= 1e-4 * norm, total / norm
    assert not got["backbone.logit_scale"].any()  # unused: zero, as in JAX


def _leaves(tree):
    """(path, array) pairs in param_digest's order."""
    return sorted(((jax.tree_util.keystr(p), np.asarray(x))
                   for p, x in jax.tree_util.tree_leaves_with_path(tree)),
                  key=lambda kv: kv[0])


def test_train_step_param_digest(jax_run, port_run):
    """The per-leaf (mean, mean|.|, rms) digest of the updated parameters
    at the golden's rtol 1e-4 / atol 1e-7, plus what rounding alone can
    move. Adam's first step is lr * g / (|g| + eps), about lr * sign(g):
    an element whose gradient differs from JAX's and is below 1e-6 or
    agrees with it to worse than 1e-3 (the key biases' gradients are zero
    in exact arithmetic, so pure rounding) can step anywhere in [-lr, lr]
    in either package. A
    leaf with k such elements of n gets 2 lr k / n more room on mean and
    mean|.| and 2 lr sqrt(k / n) on rms; every other leaf is held to the
    bar alone."""
    from cris_tpu.models import param_group_label as jax_label

    gold = jax_run["gold"]
    paths, want = param_digest(jax_run["state"].params)
    got_paths, got = param_digest(_to_jax_params(port_run["sd"]))
    np.testing.assert_array_equal(got_paths, paths)
    np.testing.assert_array_equal(got_paths, gold["paths"])
    # the port's gradients in the JAX layout: parameters swapped for them
    port_grads = _to_jax_params({
        **port_run["sd"],
        **{n: torch.from_numpy(g) for n, g in port_run["grads"].items()}})
    lrs = {"backbone": 1e-3 * 0.1, "head": 1e-3}  # tiny_train_cfg's groups
    labels = {jax.tree_util.keystr(p): jax_label(p)
              for p, _ in jax.tree_util.tree_leaves_with_path(jax_run["grads"])}
    slack = np.zeros_like(want)
    n_loose = n_all = 0
    for i, ((path, gj), (path_p, gp)) in enumerate(
            zip(_leaves(jax_run["grads"]), _leaves(port_grads))):
        assert path == path_p == paths[i]
        loose = (gp != gj) & ((np.abs(gj) < 1e-6)
                              | (np.abs(gp - gj) > 1e-3 * np.abs(gj)))
        frac, lr = loose.mean(), lrs[labels[path]]
        n_loose, n_all = n_loose + loose.sum(), n_all + loose.size
        slack[i] = (2 * lr * frac, 2 * lr * frac, 2 * lr * np.sqrt(frac))
    for ref in (want, gold["digest"]):
        err = np.abs(got - ref)
        bound = 1e-7 + 1e-4 * np.abs(ref) + slack
        bad = np.argwhere(err > bound)
        assert not len(bad), [(paths[i], j, err[i, j], bound[i, j])
                              for i, j in bad[:5]]
    assert n_loose < 0.05 * n_all, n_loose / n_all  # measured: 1.7%


def test_train_step_bn_running_stats(jax_run, port_run):
    state = jax_run["state"]
    ref = from_jax({"params": state.params, "batch_stats": state.batch_stats})
    stats = [k for k in port_run["sd"] if k.endswith(("running_mean", "running_var"))]
    assert len(stats) > 40
    for key in stats:
        np.testing.assert_allclose(port_run["sd"][key].numpy(), ref[key],
                                   rtol=1e-5, atol=1e-5, err_msg=key)


def test_three_step_loss_trajectory():
    """Three steps at base_lr 1e-4 against the JAX train step (its own
    compile): the losses within 1e-3. At tiny_train_cfg's 1e-3 the third
    loss moves by 2e-3 between two runs of the port itself (oneDNN on and
    off), so that rate measures rounding, not the port."""
    from cris_tpu.engine import train_step as jax_train_step

    cfg = tiny_train_cfg(base_lr=1e-4)
    model, variables, batch = _jax_init()
    state = _jax_state(model, variables, cfg)
    step = jax.jit(jax_train_step)
    ref = []
    for _ in range(3):
        state, m = step(state, batch, jax.random.PRNGKey(1))
        ref.append(float(m["loss"]))
    _, metrics = _port_steps(variables, cfg, 3)
    got = [m["loss"] for m in metrics]
    np.testing.assert_allclose(got, ref, rtol=1e-3, atol=1e-3)
    assert got[0] != got[1] != got[2]


def test_same_seed_same_losses_at_dropout():
    """Dropout 0.1: two runs from one seed give identical losses; another
    seed gives another loss."""
    img, word, mask, _ = _batch()
    batch = _port_batch(img, word, mask)

    def run(seeds):
        torch.manual_seed(0)
        from cris_tpu_torch.models import init_weights

        model = init_weights(_port_tiny(0.1), 3).train()
        opt, sched = make_optimizer(model, _port_cfg(), 2)
        return [float(train_step(model, opt, sched, batch, s)["loss"])
                for s in seeds]

    a, b, c = run([10, 11]), run([10, 11]), run([12, 13])
    assert a == b
    assert a[0] != c[0]


class _Lines:
    """Stands in for a package logger; keeps what ``info`` was given."""

    def __init__(self):
        self.lines = []

    def info(self, msg):
        self.lines.append(msg)


def test_train_epoch_drains_device_metrics(monkeypatch):
    """train_epoch over three loader batches at dropout 0.1: the same
    parameters as three train_step calls with step_seed(seed, step), the
    epoch's averages of their metrics, and a progress line every
    print_freq steps in the JAX meters' format. ``precision: fp32`` in the
    config runs it without autocast, as train_step with no dtype."""
    import cris_tpu.utils.logging as jax_logging

    import cris_tpu_torch.utils.logging as port_logging
    from cris_tpu_torch.engine import step_seed, train_epoch
    from cris_tpu_torch.models import init_weights

    port_log, jax_log = _Lines(), _Lines()
    monkeypatch.setattr(port_logging, "logger", port_log)
    monkeypatch.setattr(jax_logging, "logger", jax_log)
    img, word, mask, _ = _batch()
    # the loader's batches: NHWC images and masks, as the dataset makes them
    loader = [{"image": img, "word": word, "mask": mask}] * 3
    cfg = _port_cfg(print_freq=2, precision="fp32")
    models = [init_weights(_port_tiny(0.1), 3).train() for _ in range(2)]
    opts = [make_optimizer(m, cfg, len(loader)) for m in models]
    avg = train_epoch(models[0], *opts[0], loader, 1, cfg, seed=9)
    steps = [train_step(models[1], *opts[1], _port_batch(img, word, mask),
                        step_seed(9, i)) for i in range(len(loader))]
    for key in ("loss", "iou", "prec@50"):
        np.testing.assert_allclose(
            avg[key], np.mean([float(m[key]) for m in steps]), rtol=1e-6)
    for a, b in zip(models[0].parameters(), models[1].parameters()):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert len(port_log.lines) == 1
    assert port_log.lines[0].startswith("Training: Epoch=[1/3] [2/3]")

    for mod in (port_logging, jax_logging):
        loss, lr = mod.AverageMeter("Loss", ":2.4f"), mod.AverageMeter("Lr", ":1.6f")
        loss.update(0.5, 2)
        loss.update(0.25, 1)
        lr.update(1e-4)
        mod.ProgressMeter(12, [loss, lr], prefix="p ").display(3)
    assert port_log.lines[-1] == jax_log.lines[-1]


def test_train_epoch_leaves_the_profiler_window_out_of_its_seconds(
        tmp_path, monkeypatch):
    """The profiler window's stop, measurement and trace export are
    profiler_seconds, not the epoch's host seconds (its img/s)."""
    from cris_tpu_torch.engine import train_epoch
    from cris_tpu_torch.engine import trainer
    from cris_tpu_torch.models import init_weights

    close = trainer.StepTimer.close

    def slow_close(self):
        if self._prof is not None:
            time.sleep(0.5)
        close(self)

    monkeypatch.setattr(trainer.StepTimer, "close", slow_close)
    img, word, mask, _ = _batch()
    loader = [{"image": img, "word": word, "mask": mask}] * 12
    cfg = _port_cfg(print_freq=100, precision="fp32",
                    profile_dir=str(tmp_path / "prof"))
    model = init_weights(_port_tiny(0.1), 3).train()
    t0 = time.time()
    run = train_epoch(model, *make_optimizer(model, cfg, len(loader)), loader,
                      1, cfg, seed=9)["run"]
    wall = time.time() - t0
    assert run["traced"]["steps"] == 2  # steps 10 and 11
    assert (tmp_path / "prof" / "trace.json").is_file()
    assert run["profiler_seconds"] >= 0.5
    assert run["seconds"] <= wall - run["profiler_seconds"]


def test_batchnorm_train_matches_jax():
    from cris_tpu.models.layers import BatchNorm as JaxBatchNorm

    rng = np.random.RandomState(0)
    x = (rng.randn(4, 6, 5, 3) * 2 + 0.5).astype(np.float32)  # NHWC
    scale = rng.rand(3).astype(np.float32) + 0.5
    bias = rng.randn(3).astype(np.float32)
    mean0 = rng.randn(3).astype(np.float32)
    var0 = rng.rand(3).astype(np.float32) + 0.5
    variables = {"params": {"scale": scale, "bias": bias},
                 "batch_stats": {"mean": mean0, "var": var0}}
    ref, upd = JaxBatchNorm(3).apply(variables, jnp.asarray(x), True,
                                     mutable=["batch_stats"])
    bn = BatchNorm(3).train()
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(scale))
        bn.bias.copy_(torch.from_numpy(bias))
        bn.running_mean.copy_(torch.from_numpy(mean0))
        bn.running_var.copy_(torch.from_numpy(var0))
    got = bn(torch.from_numpy(x.transpose(0, 3, 1, 2).copy()))
    np.testing.assert_allclose(got.detach().numpy().transpose(0, 2, 3, 1),
                               np.asarray(ref), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(bn.running_mean.numpy(),
                               np.asarray(upd["batch_stats"]["mean"]),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(bn.running_var.numpy(),
                               np.asarray(upd["batch_stats"]["var"]),
                               rtol=1e-5, atol=1e-5)
    bn.eval()  # eval: the running statistics, nothing updated
    before = bn.running_mean.clone()
    eval_ref = JaxBatchNorm(3).apply(
        {"params": variables["params"], "batch_stats": upd["batch_stats"]},
        jnp.asarray(x), False)
    got = bn(torch.from_numpy(x.transpose(0, 3, 1, 2).copy()))
    torch.testing.assert_close(bn.running_mean, before, rtol=0, atol=0)
    np.testing.assert_allclose(got.detach().numpy().transpose(0, 2, 3, 1),
                               np.asarray(eval_ref), rtol=1e-5, atol=1e-5)


def test_bce_and_train_metrics_match_jax():
    from cris_tpu.engine.metrics import train_metrics as jax_metrics
    from cris_tpu.models.segmenter import bce_with_logits as jax_bce

    rng = np.random.RandomState(1)
    logits = (rng.randn(3, 1, 16, 16) * 4).astype(np.float32)
    target = (rng.rand(3, 1, 16, 16) > 0.6).astype(np.float32)
    target[2] *= 0.5  # fractional foreground counts as foreground
    nhwc = lambda a: jnp.asarray(a.transpose(0, 2, 3, 1))  # noqa: E731
    np.testing.assert_allclose(
        bce_with_logits(torch.from_numpy(logits), torch.from_numpy(target)).item(),
        float(jax_bce(nhwc(logits), nhwc(target))), rtol=1e-6, atol=1e-6)
    got = train_metrics(torch.from_numpy(logits), torch.from_numpy(target))
    ref = jax_metrics(nhwc(logits), nhwc(target))
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.item(), float(r), rtol=1e-6, atol=1e-6)


def test_param_group_labels_match_jax(jax_run):
    """Every tiny-model parameter's group against the JAX labels: each JAX
    leaf is filled with its label's code and mapped through from_jax."""
    from cris_tpu.models import param_group_label as jax_label

    codes = {"backbone": 0.0, "head": 1.0}
    variables = jax_run["variables"]
    labelled = jax.tree_util.tree_map_with_path(
        lambda path, leaf: np.full(np.shape(leaf), codes[jax_label(path)],
                                   np.float32), variables["params"])
    mapped = from_jax({"params": labelled,
                       "batch_stats": variables["batch_stats"]})
    model = _port_tiny()
    seen = set()
    for name, _ in model.named_parameters():
        label = param_group_label(name)
        seen.add(label)
        assert np.all(mapped[name] == codes[label]), name
    assert seen == {"backbone", "head"}
    assert param_group_label("backbone.positional_embedding") == "head"
    assert param_group_label("backbone.visual.attnpool.positional_embedding") == "head"
    assert param_group_label("backbone.visual.conv1.weight") == "backbone"


def test_lr_schedule_matches_jax():
    from cris_tpu.engine.trainer import multistep_schedule as jax_schedule

    cfg = _port_cfg(milestones=[1, 3], lr_decay=0.5)
    model = _port_tiny()
    optimizer, scheduler = make_optimizer(model, cfg, steps_per_epoch=2)
    ref_head = jax_schedule(cfg.base_lr, cfg.milestones, cfg.lr_decay, 2)
    ref_bb = jax_schedule(cfg.base_lr * cfg.lr_multi, cfg.milestones,
                          cfg.lr_decay, 2)
    ours = multistep_schedule(cfg.base_lr, cfg.milestones, cfg.lr_decay, 2)
    for step in range(9):
        backbone, head = (g["lr"] for g in optimizer.param_groups)
        np.testing.assert_allclose(head, float(ref_head(step)), rtol=1e-6)
        np.testing.assert_allclose(backbone, float(ref_bb(step)), rtol=1e-6)
        np.testing.assert_allclose(ours(step), float(ref_head(step)), rtol=1e-6)
        optimizer.step()
        scheduler.step()
    assert lr_at_epoch(1.0, [1, 3], 0.5, 4) == 0.25


@pytest.mark.parametrize("weight_decay,max_norm", [(0.0, 0.0), (0.01, 100.0)],
                         ids=["plain", "decay_and_clip"])
def test_adam_steps_match_optax(jax_run, weight_decay, max_norm):
    """Two Adam steps on fixed gradients against the JAX make_optimizer."""
    import optax

    from cris_tpu.engine import make_optimizer as jax_opt

    cfg = tiny_train_cfg(weight_decay=weight_decay, max_norm=max_norm)
    variables = jax_run["variables"]
    params = variables["params"]
    # |g| in [0.05, 0.1]: clipped by about 1/2 (the global norm is ~190),
    # it stays above the 1e-2 * |p| of the decay, so no sum cancels and
    # rounding cannot turn an Adam step around
    rng = np.random.RandomState(2)
    grads = [jax.tree_util.tree_map(
        lambda p: np.asarray(rng.choice([-1.0, 1.0], np.shape(p))
                             * rng.uniform(0.05, 0.1, np.shape(p)), np.float32),
        params) for _ in range(2)]
    tx = jax_opt(cfg, steps_per_epoch=2)

    @jax.jit
    def step(g, opt_state, params):
        updates, opt_state = tx.update(g, opt_state, params)
        return optax.apply_updates(params, updates), opt_state

    opt_state = tx.init(params)
    ref = params
    for g in grads:
        ref, opt_state = step(g, opt_state, ref)

    model = load_jax_variables(_port_tiny(), variables)
    optimizer, scheduler = make_optimizer(model, CfgNode(dict(cfg)), 2)
    named = dict(model.named_parameters())
    for g in grads:
        mapped = from_jax({"params": g, "batch_stats": variables["batch_stats"]})
        for name, p in named.items():
            p.grad = torch.from_numpy(np.array(mapped[name]))
        apply_gradients(optimizer, scheduler)
    want = from_jax({"params": ref, "batch_stats": variables["batch_stats"]})
    for name, p in named.items():
        np.testing.assert_allclose(p.detach().numpy(), want[name], rtol=1e-6,
                                   atol=1e-6, err_msg=name)


def test_profile_train_helpers():
    """The train profiler's seeded batches and its own-kernel shares."""
    from cris_tpu_torch.profile_train import make_batches, own_shares

    a = make_batches(2, 3, 32, 17, "cpu", seed=4)
    b = make_batches(2, 3, 32, 17, "cpu", seed=4)
    assert len(a) == 2 and a[0]["image"].shape == (3, 3, 32, 32)
    assert a[0]["mask"].shape == (3, 1, 32, 32) and a[0]["word"].shape == (3, 17)
    for x, y in zip(a, b):
        for key in x:
            assert torch.equal(x[key], y[key])
    pad = (a[1]["word"] == 0).int()
    assert not pad[:, :3].any()  # at least 3 tokens
    assert torch.equal(pad.cummax(1).values, pad)  # then padding only
    rows = [{"name": "void ns::dropout_fwd_kernel<float, 64>", "device_ms": 2.0},
            {"name": "void ns::dropout_bwd_dq_kernel<float, 64>", "device_ms": 3.0},
            {"name": "void ns::dropout_bwd_delta_kernel<float>", "device_ms": 1.0},
            {"name": "void ns::attention_bse_kernel<float, 64>", "device_ms": 4.0},
            {"name": "void ns::attention_tc_kernel<64>", "device_ms": 1.0},
            {"name": "void ns::dropout_tc_fwd_kernel<64>", "device_ms": 2.0},
            {"name": "void ns::dropout_tc_bwd_dq_kernel<64>", "device_ms": 1.0},
            {"name": "void ns::dropout_tc_bwd_dkdv_kernel<64>",
             "device_ms": 3.0},
            {"name": "cutlass gemm", "device_ms": 10.0}]
    shares = own_shares(rows, 40.0)
    assert shares == {"K1": (5.0, 0.125), "K2 forward": (4.0, 0.1),
                      "K2 backward": (8.0, 0.2)}


def test_grad_spread_bars_and_step():
    """Phase 7's gradient bars (cris_tpu_torch.grad_spread): errors of the
    own spread's size pass, and the planted kinds of fault fail;
    step_grads runs one train step and returns every gradient and
    txt_proj's BN input."""
    from cris_tpu_torch.grad_spread import (grad_faults, grad_rel, step_grads,
                                            tensor_need)
    from cris_tpu_torch.models import init_weights

    base = init_weights(_port_tiny(), 0).train()
    img, word, mask, _ = _batch()
    batch = _port_batch(img, word, mask)
    loss, ref, _, bn_in = step_grads(base, _port_cfg(), batch, "cpu")
    assert np.isfinite(loss) and bn_in.shape[0] == len(img)
    names = [n for n, _ in base.named_parameters()]
    assert list(ref) == names
    assert all(p.grad is None for p in base.parameters())  # a copy stepped
    head = [n for n in names if not n.startswith("backbone.")]
    gen = torch.Generator().manual_seed(0)

    def jitter(scale):
        return {n: g + scale * g.abs().mean() * torch.randn(g.shape, generator=gen)
                for n, g in ref.items()}

    alt, got = jitter(1e-2), jitter(1e-2)
    assert grad_rel(alt, ref, names) > 1e-3
    assert not grad_faults(got, ref, alt, names, head)
    assert tensor_need(got, ref, alt, names) < 2.0
    for n in head:
        if ref[n].abs().sum() > 0:
            assert grad_faults(dict(got, **{n: got[n] * 0.0}), ref, alt, names,
                               head)
    assert grad_faults({n: g * 0.9 for n, g in got.items()}, ref, alt, names,
                       head)
