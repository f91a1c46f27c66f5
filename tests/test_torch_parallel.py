"""The PyTorch package's data parallel on the CPU: two gloo ranks against
one process of the port and against the JAX package's single-device
train step.

One module-scoped fixture starts the jobs together: the two ranks of
``torch_parallel_worker.py`` (seed broadcast, loader shards, a
DistributedDataParallel step of tiny CRIS with synced BatchNorm at
dropout 0 in f32 on the golden batch split one row a rank, a clipped
second step, the dropout generators, validate and inference with their
gathers), a two-rank ``torchrun`` of ``python3 -m cris_tpu_torch.train
--device cpu`` (then a resume of it), and a process that asks for NCCL
on the CPU. While they run it computes the same step on one process of
the port and in JAX (``jax.value_and_grad`` of the JAX package's loss,
the JAX init of tests/test_torch_train.py on the same batch).

Bars: the loss within 2e-5 relative of one process and of JAX; each
gradient within tests/test_torch_train.py's per-leaf bar (1e-4 + 1e-3 x
its RMS, in RMS) and 1e-4 in global relative L2; the BN running
statistics equal on both ranks, within 1e-5 (that test's bar) of one
process and 2e-5 of JAX (test_syncbn_running_stats_equal_on_both_ranks);
validate and inference's IoU, Pr@50..90 and oIoU within 1e-6 of one
process and the gathered IoUs the same multiset.
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from conftest import tiny_cris
from torch_parallel_worker import (CLIP_MAX_NORM, TEST_BATCH, TEST_REFS,
                                   TINY, VAL_BATCH, VAL_REFS, decoder_output,
                                   golden_batch, port_tiny, shard, two_steps)

from cris_tpu_torch import cli
from cris_tpu_torch.checkpoint import (from_jax, load_cris_checkpoint,
                                       load_jax_variables)
from cris_tpu_torch.data import RefDataLoader, RefDataset
from cris_tpu_torch.engine import Evaluator
from cris_tpu_torch.models import build_segmenter
from cris_tpu_torch.models import decoder as decoder_module
from cris_tpu_torch.ops.kernels.attention_dropout import (
    attention_dropout_backward_plain, attention_dropout_plain,
    fused_attention_bse_dropout)
from cris_tpu_torch.ops.kernels.dropout_mask import (keep_bits,
                                                     keep_bits_packed,
                                                     keep_mask)
from cris_tpu_torch.parallel import (data_parallel, data_parallel_size,
                                     init_distributed, process_count)
from cris_tpu_torch.utils import load_cfg_from_cfg_file

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
WORKER = os.path.join(HERE, "torch_parallel_worker.py")
TIMEOUT = 300


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _env():
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("JAX_", "XLA_"))}
    env.update(OMP_NUM_THREADS="1", PYTHONPATH=REPO)
    return env


def _torchrun(*args):
    return [sys.executable, "-m", "torch.distributed.run", "--standalone",
            "--nproc_per_node=2", "-m", "cris_tpu_torch.train", "--config",
            TINY, "--device", "cpu", "--opts", *args]


def _train_script(out):
    """A two-rank train run, then its resume to epoch 2, in one shell."""
    args = ["TRAIN.output_folder", out, "TRAIN.epochs", "1",
            "DATA.train_lmdb", "synthetic://16?seed=1",
            "DATA.val_lmdb", "synthetic://8?seed=2",
            "TRAIN.batch_size", "4", "TRAIN.batch_size_val", "4",
            "TRAIN.workers", "1", "TRAIN.workers_val", "1",
            "TRAIN.precision", "fp32", "TRAIN.print_freq", "1"]
    last = os.path.join(out, "CRIS_TINY", "last_model.pth")
    first = subprocess.list2cmdline(_torchrun(*args))
    resume = subprocess.list2cmdline(_torchrun(
        *args, "TRAIN.epochs", "2", "TRAIN.resume", last))
    return f"{first} && cp {last} {out}/epoch1.pth && {resume}"


NCCL_ON_CPU = """
import os
os.environ.update(RANK="0", WORLD_SIZE="1", MASTER_ADDR="localhost",
                  MASTER_PORT="{port}")
from cris_tpu_torch.parallel import init_distributed, process_count
init_distributed("cpu", backend="nccl")
print("joined", process_count())
"""


def _jax_step(variables):
    """Loss, gradients and new BN statistics of the JAX package's train
    loss on the golden batch (f32, dropout 0)."""
    model = tiny_cris(dropout=0.0, dtype=None)
    fwd = np.load(os.path.join(HERE, "goldens", "tiny_forward.npz"))
    gold = np.load(os.path.join(HERE, "goldens", "tiny_train_step.npz"))

    def loss_fn(params):
        (_, _, loss), mutated = model.apply(
            {"params": params, "batch_stats": variables["batch_stats"]},
            jnp.asarray(fwd["img"]), jnp.asarray(fwd["word"]),
            jnp.asarray(gold["mask"]), train=True, mutable=["batch_stats"],
            rngs={"dropout": jax.random.PRNGKey(1)})
        return loss, mutated["batch_stats"]

    (loss, stats), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        variables["params"])
    np_tree = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    grads = from_jax({"params": np_tree(grads),
                      "batch_stats": variables["batch_stats"]})
    stats = from_jax({"params": variables["params"],
                      "batch_stats": np_tree(stats)})
    return {"loss": float(loss), "grads": grads,
            "stats": {k: v for k, v in stats.items()
                      if k.endswith(("running_mean", "running_var"))}}


def _evaluate_one_process(gathered):
    cfg = load_cfg_from_cfg_file(TINY)
    model = build_segmenter(cfg, device="cpu", seed=0)
    ev = Evaluator(model, cfg.input_size, None, batch_size=TEST_BATCH,
                   host_workers=1)
    real = Evaluator._allgather
    ev._allgather = lambda *a: gathered.append(real(*a)) or gathered[-1]
    val = RefDataset(f"synthetic://{VAL_REFS}?seed=3", None, "synthetic",
                     "val", "val", cfg.input_size, cfg.word_len)
    test = RefDataset(f"synthetic://{TEST_REFS}?seed=4", None, "synthetic",
                      "val", "test", cfg.input_size, cfg.word_len)
    return (ev.validate(RefDataLoader(val, batch_size=VAL_BATCH,
                                      num_workers=1)),
            ev.inference(test, cfg.word_len, progress=False))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every job's results; the two ranks, the torchrun runs and the NCCL
    probe run while this process takes the one-process and JAX steps."""
    work = tmp_path_factory.mktemp("torch_parallel")
    out = str(work / "exp")
    procs = {"train": subprocess.Popen(
        ["bash", "-c", _train_script(out)], cwd=str(work), env=_env(),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
        "nccl": subprocess.Popen(
            [sys.executable, "-c", NCCL_ON_CPU.format(port=_free_port())],
            cwd=REPO, env=_env(), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)}
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        fwd = np.load(os.path.join(HERE, "goldens", "tiny_forward.npz"))
        variables = tiny_cris(dropout=0.0, dtype=None).init(
            jax.random.PRNGKey(42), jnp.asarray(fwd["img"]),
            jnp.asarray(fwd["word"]), train=False)
        variables = jax.tree_util.tree_map(np.asarray, variables)
        torch.save(load_jax_variables(port_tiny(), variables).state_dict(),
                   work / "init.pt")
        port = _free_port()
        for rank in range(2):
            procs[rank] = subprocess.Popen(
                [sys.executable, WORKER, str(rank), "2", str(port), str(work)],
                cwd=REPO, env=_env(), stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True)
        single = two_steps(load_jax_variables(port_tiny(), variables).train(),
                           golden_batch())
        single["decoded"] = {}
        rank_of = decoder_module.data_rank
        for rank in range(2):  # the decoder as rank r of 2 would run it
            decoder_module.data_rank = lambda r=rank: r
            try:
                single["decoded"][rank] = decoder_output().detach()
            finally:
                decoder_module.data_rank = rank_of
        gathered = []
        single["validate"], single["inference"] = _evaluate_one_process(
            gathered)
        single["gathered"] = gathered
        jax_run = _jax_step(variables)
    finally:
        torch.set_num_threads(threads)
        logs = {}
        for name, p in procs.items():
            try:
                logs[name] = p.communicate(timeout=TIMEOUT)[0]
            except subprocess.TimeoutExpired:
                for q in procs.values():
                    q.kill()
                raise
    for rank in range(2):
        assert procs[rank].returncode == 0, logs[rank][-4000:]
    assert procs["train"].returncode == 0, logs["train"][-4000:]
    ranks = [json.load(open(work / f"rank{r}.json")) for r in range(2)]
    tensors = [torch.load(work / f"rank{r}.pt") for r in range(2)]
    return {"work": work, "out": out, "ranks": ranks, "tensors": tensors,
            "single": single, "jax": jax_run, "logs": logs,
            "nccl_rc": procs["nccl"].returncode}


def _rms(x):
    return float(np.sqrt(np.mean(np.square(np.asarray(x, np.float64)))))


def _assert_grads_close(got, ref):
    """tests/test_torch_train.py's gradient bars."""
    for name, g in got.items():
        g, r = np.asarray(g), np.asarray(ref[name])
        assert _rms(g - r) <= 1e-4 + 1e-3 * _rms(r), (name, _rms(g - r))
    total = np.sqrt(sum(np.sum(np.square(np.asarray(g, np.float64)
                                         - np.asarray(ref[n], np.float64)))
                        for n, g in got.items()))
    norm = np.sqrt(sum(np.sum(np.square(np.asarray(ref[n], np.float64)))
                       for n in got))
    assert total <= 1e-4 * norm, total / norm


# ------------------------------------------------------------ the ranks

def test_seed_broadcast_from_rank_zero(runs):
    r0, r1 = runs["ranks"]
    assert (r0["rank"], r1["rank"]) == (0, 1)
    assert r0["world"] == r1["world"] == 2
    np.random.seed(1000)  # what rank 0 drew
    assert r0["seed"] == r1["seed"] == int(np.random.randint(2**31))


def test_loader_shards_cover_the_epoch(runs):
    """Strided shards of one shuffle: disjoint and the whole epoch when
    the world divides the set; the wrap-around pad repeats one sample
    when it does not (DistributedSampler's rule, as in the JAX loader)."""
    r0, r1 = (r["shards"] for r in runs["ranks"])
    assert sorted(r0["10"] + r1["10"]) == list(range(10))
    assert len(r0["11"]) == len(r1["11"]) == 6
    assert set(r0["11"] + r1["11"]) == set(range(11))
    assert r0["10"] == shard(10, 0, 2) and r1["11"] == shard(11, 1, 2)


def test_ddp_syncbn_step_matches_one_process_and_jax(runs):
    """Loss (the ranks' mean, each over its row) within 2e-5 of one
    process and of JAX; gradients within the train test's bars of both."""
    ranks, single, ref = runs["tensors"], runs["single"], runs["jax"]
    assert all(r["wrapped"] == "DistributedDataParallel" for r in ranks)
    assert single["wrapped"] == "CRIS"  # one process: no wrapper
    loss = np.mean([r["loss"] for r in ranks])
    for want in (single["loss"], ref["loss"]):
        assert abs(loss - want) <= 2e-5 * abs(want), (loss, want)
    grads = {n: g.numpy() for n, g in ranks[0]["grads"].items()}
    for r in ranks[1:]:  # DDP leaves every rank the same gradient
        for n, g in r["grads"].items():
            assert torch.equal(g, ranks[0]["grads"][n]), n
    _assert_grads_close(grads, {n: g.numpy()
                                for n, g in single["grads"].items()})
    _assert_grads_close(grads, ref["grads"])
    assert not grads["backbone.logit_scale"].any()  # unreached: zero fill


def test_clip_sees_the_global_gradient(runs):
    """A step with max_norm clips the averaged gradient: every rank holds
    one process's clipped gradient, of norm CLIP_MAX_NORM."""
    ranks, single = runs["tensors"], runs["single"]
    for r in ranks:
        norm = torch.sqrt(sum(g.double().square().sum()
                              for g in r["clipped"].values()))
        assert abs(norm.item() - CLIP_MAX_NORM) <= 1e-6, norm
        _assert_grads_close({n: g.numpy() for n, g in r["clipped"].items()},
                            {n: g.numpy()
                             for n, g in single["clipped"].items()})
    assert abs(np.mean([r["clipped_loss"] for r in ranks])
               - single["clipped_loss"]) <= 2e-5 * abs(single["clipped_loss"])


def test_syncbn_running_stats_equal_on_both_ranks(runs):
    """Equal on both ranks; within tests/test_torch_train.py's 1e-5 of one
    process, and within twice that of JAX: the running variance of the
    neck's BN over the 2 sentence states (E[x^2] - E[x]^2 of 2 values, which
    cancels) moves by 1.2e-5 between one process and JAX and by as much
    again between one process and two ranks on this test's inputs, and
    the two gaps add."""
    r0, r1 = (r["stats"] for r in runs["tensors"])
    stats = [k for k in r0 if k.endswith(("running_mean", "running_var"))]
    assert len(stats) > 40
    for key in r0:
        assert torch.equal(r0[key], r1[key]), key
    for key in stats:
        for want, bar in ((runs["single"]["stats"][key].numpy(), 1e-5),
                          (runs["jax"]["stats"][key], 2e-5)):
            np.testing.assert_allclose(r0[key].numpy(), want, rtol=bar,
                                       atol=bar, err_msg=key)


def test_elementwise_masks_differ_across_ranks(runs):
    """K2's seeds are the step's on every rank; the elementwise masks'
    generator has the rank folded in; the decoder draws K2's mask for
    its global rows and its elementwise masks as rank r of 2."""
    r0, r1 = runs["ranks"]
    assert r0["k2_seeds"] == r1["k2_seeds"]
    assert r0["elementwise"] != r1["elementwise"]
    gen = torch.Generator().manual_seed(1234)  # rank 0 keeps the step seed
    assert r0["elementwise"] == torch.rand(16, generator=gen).tolist()
    d0, d1 = (r["decoded"] for r in runs["tensors"])
    assert not torch.allclose(d0, d1)
    for rank, got in enumerate((d0, d1)):
        torch.testing.assert_close(got, runs["single"]["decoded"][rank],
                                   rtol=1e-5, atol=1e-6)


def test_validate_and_inference_gather_one_process(runs):
    """Both ranks return one process's IoU, Pr@50..90 and oIoU (1e-6),
    from the same per-sample IoUs as a multiset; the last val batch's
    padding rows are not scored; test mode's round-robin shards are
    uneven (4 and 3 refs) and cover every pair."""
    single = runs["single"]
    for r in runs["ranks"]:
        for key in ("validate", "inference"):
            iou, prec = r[key]
            want_iou, want_prec = single[key]
            assert abs(iou - want_iou) <= 1e-6, (key, iou, want_iou)
            assert set(prec) == set(want_prec)
            for k, v in prec.items():
                assert abs(v - want_prec[k]) <= 1e-6, (key, k)
        for got, want in zip(r["gathered"], single["gathered"]):
            np.testing.assert_allclose(sorted(got[0]), sorted(want[0]),
                                       rtol=0, atol=1e-6)
            np.testing.assert_allclose(got[1:], want[1:], rtol=1e-9)
    r0, r1 = runs["ranks"]
    assert r0["val_pairs"] + r1["val_pairs"] == VAL_REFS
    assert r0["test_pairs"] != r1["test_pairs"]
    assert len(r0["gathered"][1][0]) == r0["test_pairs"] + r1["test_pairs"]


def test_allgather_takes_lists_of_any_length(runs):
    for r in runs["ranks"]:
        assert r["floats"] == [[0.25], [1.25, 1.25, 1.25]]
        assert r["no_rows"] == [[0.5], 6.0, 8.0]  # rank 1 sent no IoU


# -------------------------------------------------------------- the entry

def test_two_rank_train_entry_writes_one_checkpoint_from_rank_zero(runs):
    """torchrun --nproc_per_node=2 -m cris_tpu_torch.train --device cpu:
    one run line (rank 0 logs) with the images of both ranks, one
    last_model.pth in CRIS.pytorch's keys that loads into one process,
    and a resume on both ranks that carries on from it."""
    log, out = runs["logs"]["train"], os.path.join(runs["out"], "CRIS_TINY")
    assert log.count("=> run: ") == 2, log[-3000:]  # one per torchrun
    run = json.loads(log.split("=> run: ", 2)[1].splitlines()[0])
    assert run["world_size"] == 2 and run["steps"] == 4
    assert run["images"] == 16 and run["card"] == "cpu"
    assert set(run["launches"]) == {"K1", "K2 fwd", "K2 bwd"}
    assert all(len(c) == 2 for k in run["launches"].values()
               for c in k.values())
    assert sorted(os.listdir(out)) == ["best_model.pth", "last_model.pth",
                                       "train.log"]
    with open(os.path.join(out, "train.log")) as f:
        text = f.read()
    assert text.count("=> run: ") == 2 and "rank 1 of 2" not in text
    assert "rank 0 of 2" in text
    sd = load_cris_checkpoint(os.path.join(runs["out"], "epoch1.pth"))
    assert not any(k.startswith("module.") for k in sd)
    cfg = load_cfg_from_cfg_file(TINY)
    build_segmenter(cfg, device="cpu", train=True).load_state_dict(
        sd, strict=True)
    ckpt = torch.load(os.path.join(out, "last_model.pth"), weights_only=False)
    assert ckpt["epoch"] == 2 and ckpt["scheduler"]["last_epoch"] == 8
    assert "=> loaded checkpoint" in text and "(epoch 1)" in text


# ------------------------------------------------------- no fallback, tp

def test_nccl_on_the_cpu_raises(runs):
    assert runs["nccl_rc"] != 0
    assert "joined" not in runs["logs"]["nccl"]
    assert "NCCL" in runs["logs"]["nccl"], runs["logs"]["nccl"][-2000:]


def test_incomplete_launch_environment_raises(monkeypatch):
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("RANK", "1")
    monkeypatch.delenv("MASTER_ADDR", raising=False)
    with pytest.raises(RuntimeError, match="torchrun"):
        init_distributed("cpu")
    monkeypatch.delenv("WORLD_SIZE")
    assert init_distributed("cpu") == torch.device("cpu")
    assert process_count() == 1


def test_tp_size_2_raises():
    """tp 2 is accepted wherever it divides the ranks (the grid's data
    size is what is left); it raises where it does not, as on one
    process, and so does a dp x tp that is not the world."""
    assert data_parallel_size(-1, 2, world=2) == 1
    assert data_parallel_size(-1, 2, world=4) == 2
    assert data_parallel_size(2, 2, world=4) == 2
    with pytest.raises(ValueError, match="dp=3"):
        data_parallel_size(3, 1, world=2)
    with pytest.raises(ValueError, match="dp=1"):
        data_parallel_size(1, 2, world=4)
    with pytest.raises(ValueError, match="does not divide"):
        data_parallel_size(-1, 2, world=3)
    assert data_parallel_size(-1, 1, world=4) == 4
    assert data_parallel_size(2, 1, world=2) == 2
    cfg = cli.get_parser(argv=["--config", TINY, "--device", "cpu", "--opts",
                               "Distributed.tp_size", "2"])
    with pytest.raises(ValueError, match="does not divide 1"):
        cli.init_device(cfg, "train")


def test_one_process_takes_no_wrapper():
    model = port_tiny()
    assert data_parallel(model) is model


# ------------------------------------------------------ K2's batch offset

def test_keep_bits_with_an_offset_are_the_global_rows():
    want = keep_bits(77, 6, 2, 5, 9)
    for offset in (0, 2, 4):
        torch.testing.assert_close(keep_bits(77, 2, 2, 5, 9,
                                             batch_offset=offset),
                                   want[offset:offset + 2], rtol=0, atol=0)
    assert torch.equal(keep_mask(77, 3, 2, 5, 40, 0.1, batch_offset=3),
                       keep_mask(77, 6, 2, 5, 40, 0.1)[3:])
    assert torch.equal(keep_bits_packed(77, 3, 2, 5, 40, 0.1, batch_offset=3),
                       keep_bits_packed(77, 6, 2, 5, 40, 0.1)[3:])
    with pytest.raises(ValueError):
        keep_bits(77, 2, 2, 5, 9, batch_offset=-1)
    with pytest.raises(ValueError):
        keep_bits(77, 2, 2, 5, 9, batch_offset=2**31 - 2)


def test_plain_k2_with_an_offset_is_the_global_batch():
    """K2's plain forward and backward on rows 2:4 with batch_offset 2
    equal the global batch's rows 2:4 (f32, masked keys); so does the
    wrapper, which takes the plain version for CPU tensors."""
    gen = torch.Generator().manual_seed(3)
    q, k, v = (torch.randn(4, n, 32, generator=gen) for n in (9, 7, 7))
    g = torch.randn(4, 9, 32, generator=gen)
    valid = torch.ones(4, 7, dtype=torch.bool)
    valid[1, 4:] = valid[3, 2:] = False
    want = attention_dropout_plain(q, k, v, 4, valid, 0.3, 11)
    want_grads = attention_dropout_backward_plain(q, k, v, 4, valid, 0.3, 11,
                                                  g)
    rows = slice(2, 4)
    args = (q[rows], k[rows], v[rows], 4, valid[rows], 0.3, 11)
    for fn in (attention_dropout_plain, fused_attention_bse_dropout):
        got = fn(*args, batch_offset=2)
        torch.testing.assert_close(got, want[rows], rtol=1e-6, atol=1e-6)
    assert not torch.allclose(attention_dropout_plain(*args), want[rows])
    got = attention_dropout_backward_plain(*args, g[rows], batch_offset=2)
    for a, b in zip(got, want_grads):
        torch.testing.assert_close(a, b[rows], rtol=1e-6, atol=1e-6)
