"""The PyTorch package's tensor parallel on the CPU: gloo ranks on a
(data, model) grid against one process of the port and against the JAX
package's step on its ('data', 'model') mesh.

One module-scoped fixture starts the jobs together: the 2 ranks of a
dp1 x tp2 grid and the 4 of a dp2 x tp2 grid, each running every check
of ``torch_tp_worker.py`` in one launch (tiny CRIS at ``tp_state``, f32,
the rows of ``tp_batch`` that its data rank owns), and a 4-rank
``torchrun`` of ``python3 -m cris_tpu_torch.train --device cpu`` at
``Distributed.tp_size 4``, then of ``.test`` at ``tp_size`` 2 and 4 on
what it wrote. While they run it takes the same steps on one process of
the port and the gradient of the JAX package's loss on ``make_mesh(4,
2)``, the virtual 8-device mesh, with the JAX rules' shardings.

Beside them run 3 ranks of dp1 x tp3 that only call
``sync_replicated_grads_`` on planted gradients, and, after the test
entry, ``python3 -m cris_tpu_torch.quantize`` and the test entry at
precision int8 at tp 1, 2 and 4 on the same best_model.pth.

Bars (tests/test_torch_parallel.py's, and JAX's own for the loss,
tests/test_parallel.py:153-193): the loss within 1e-4 relative of one
process and of JAX; each gathered gradient within 1e-4 + 1e-3 x its RMS
(in RMS) and 1e-4 in global relative L2; the BN running statistics
within 1e-5 of one process and 2e-5 of JAX; at dropout 0.1 the dp1 x
tp2 loss within 1e-5 relative of one process, whose masks it draws. Each
planted fault must fail them.
"""

import json
import os
import re
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from conftest import tiny_cris
from test_torch_parallel import _assert_grads_close
from torch_parallel_worker import (CLIP_MAX_NORM, TEST_BATCH, TEST_REFS,
                                   TINY, VAL_BATCH, VAL_REFS)
from torch_tp_worker import STEP_SEED, model_at, step, tp_batch, tp_state

from cris_tpu_torch.checkpoint import from_jax, load_cris_checkpoint
from cris_tpu_torch.data import RefDataLoader, RefDataset
from cris_tpu_torch.engine import Evaluator
from cris_tpu_torch.models import build_segmenter, shard_model
from cris_tpu_torch.ops.kernels.attention_dropout import (
    attention_dropout_backward_plain, attention_dropout_plain,
    fused_attention_bse_dropout)
from cris_tpu_torch.ops.kernels.dropout_mask import (keep_bits,
                                                     keep_bits_packed,
                                                     keep_mask)
from cris_tpu_torch.parallel import Grid, grid, init_grid
from cris_tpu_torch.parallel.tensor import Shard, param_spec
from cris_tpu_torch.utils import load_cfg_from_cfg_file

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
WORKER = os.path.join(HERE, "torch_tp_worker.py")
TIMEOUT = 240  # seconds for every job of the fixture
LAYOUTS = {"dp1xtp2": (2, 2), "dp2xtp2": (4, 2)}  # (world, tp)
SYNC_LAYOUT = (3, 3)  # dp1 x tp3: sync_replicated_grads_ alone
INT8_MARK = "== the int8 test entry =="  # starts the entry log's int8 part
INT8_TPS = (1, 2, 4)
IOU_BAR = 0.5  # points: the int8 test entry at tp 2 and 4 against tp 1
DROPOUT_BAR = 1e-5  # relative: the same masks, f32 rounding alone


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _env():
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("JAX_", "XLA_"))}
    env.update(OMP_NUM_THREADS="1", PYTHONPATH=REPO)
    return env


def _entry_script(out):
    """torchrun of the train entry at dp1 x tp4, then of the test entry
    at dp2 x tp2 and at dp1 x tp4 on its best_model.pth, in one shell;
    then python3 -m cris_tpu_torch.quantize writes quant_scales.npz beside
    it and the test entry runs at precision int8 at dp1 x tp1 (one
    process), tp2 and tp4."""
    def torchrun(module, *opts, nproc=4):
        return subprocess.list2cmdline([
            sys.executable, "-m", "torch.distributed.run", "--standalone",
            f"--nproc_per_node={nproc}", "-m", module, "--config", TINY,
            "--device", "cpu", "--opts", "TRAIN.output_folder", out, *opts])

    common = ["TRAIN.workers", "1", "TRAIN.workers_val", "1",
              "TRAIN.precision", "fp32", "TRAIN.batch_size_val", "4"]
    train = torchrun("cris_tpu_torch.train", *common, "TRAIN.epochs", "1",
                     "DATA.train_lmdb", "synthetic://8?seed=1",
                     "DATA.val_lmdb", "synthetic://4?seed=2",
                     "TRAIN.batch_size", "4", "TRAIN.print_freq", "1",
                     "Distributed.tp_size", "4")
    test = [torchrun("cris_tpu_torch.test", *common,
                     "TEST.test_lmdb", "synthetic://6?seed=4",
                     "Distributed.tp_size", str(tp)) for tp in (2, 4)]
    quantize = subprocess.list2cmdline([
        sys.executable, "-m", "cris_tpu_torch.quantize", "--config", TINY,
        "--device", "cpu", "--batches", "1", "--batch-size", "2",
        "--min-ch", "16", "--pooled-min-ch", "32", "--upfold-min-ch", "32",
        "--opts", "TRAIN.output_folder", out])
    int8 = [torchrun("cris_tpu_torch.test", *common, "TRAIN.precision", "int8",
                     "TEST.test_lmdb", "synthetic://6?seed=4",
                     "Distributed.tp_size", str(tp), nproc=tp)
            for tp in INT8_TPS]
    return " && ".join([train, *test, f"echo '{INT8_MARK}'", quantize,
                        *int8])


def _jax_variables():
    """The JAX tree of ``tp_state`` (the converter of the JAX package)."""
    from cris_tpu.checkpoint.torch_convert import convert_cris_state_dict

    sd = {k: v.numpy() for k, v in tp_state().items()}
    variables, _ = convert_cris_state_dict(sd, num_decoder_layers=2)
    return jax.tree_util.tree_map(np.asarray, variables)


def _jax_mesh_step(variables):
    """Loss, gradients and new BN statistics of the JAX package's train
    loss on ``tp_batch`` (f32, dropout 0) over ``make_mesh(4, 2)``, with
    ``make_param_shardings``' shardings, in the port's keys."""
    from cris_tpu.parallel import (batch_sharding, make_mesh,
                                   make_param_shardings)

    model = tiny_cris(dropout=0.0, dtype=None)
    batch = tp_batch()
    img = batch["image"].transpose(0, 2, 3, 1)
    mask = batch["mask"].transpose(0, 2, 3, 1)
    mesh = make_mesh(4, 2)
    placed = jax.device_put(variables, make_param_shardings(mesh, variables))
    rows = batch_sharding(mesh)

    def loss_fn(params, stats, img, word, mask):
        (_, _, loss), mutated = model.apply(
            {"params": params, "batch_stats": stats}, img, word, mask,
            train=True, mutable=["batch_stats"],
            rngs={"dropout": jax.random.PRNGKey(1)})
        return loss, mutated["batch_stats"]

    with mesh:
        (loss, stats), grads = jax.jit(jax.value_and_grad(
            loss_fn, has_aux=True))(
            placed["params"], placed["batch_stats"],
            *(jax.device_put(jnp.asarray(x), rows)
              for x in (img, batch["word"], mask)))
    np_tree = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    grads = from_jax({"params": np_tree(grads),
                      "batch_stats": variables["batch_stats"]})
    stats = from_jax({"params": variables["params"],
                      "batch_stats": np_tree(stats)})
    return {"loss": float(loss), "grads": grads,
            "stats": {k: v for k, v in stats.items()
                      if k.endswith(("running_mean", "running_var"))}}


def _one_process_eval():
    cfg = load_cfg_from_cfg_file(TINY)
    model = build_segmenter(cfg, device="cpu", seed=0)
    ev = Evaluator(model, cfg.input_size, None, batch_size=TEST_BATCH,
                   host_workers=1)
    val = RefDataset(f"synthetic://{VAL_REFS}?seed=3", None, "synthetic",
                     "val", "val", cfg.input_size, cfg.word_len)
    test = RefDataset(f"synthetic://{TEST_REFS}?seed=4", None, "synthetic",
                      "val", "test", cfg.input_size, cfg.word_len)
    return (ev.validate(RefDataLoader(val, batch_size=VAL_BATCH,
                                      num_workers=1)),
            ev.inference(test, cfg.word_len, progress=False))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every job's results; the ranks and the torchrun entries run while
    this process takes the one-process steps and the JAX mesh's."""
    work = tmp_path_factory.mktemp("torch_tp")
    out = str(work / "exp")
    procs = {"entry": subprocess.Popen(
        ["bash", "-c", _entry_script(out)], cwd=str(work), env=_env(),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)}
    jobs = [(name, world, tp, ()) for name, (world, tp) in LAYOUTS.items()]
    jobs.append(("sync", *SYNC_LAYOUT, ("sync",)))
    for name, world, tp, extra in jobs:
        port = _free_port()
        for rank in range(world):
            procs[name, rank] = subprocess.Popen(
                [sys.executable, WORKER, str(rank), str(world), str(tp),
                 str(port), str(work), *extra],
                cwd=REPO, env=_env(), stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        state, batch = tp_state(), tp_batch()
        single = {"f32": step(model_at(state), batch),
                  "clipped": step(model_at(state), batch,
                                  max_norm=CLIP_MAX_NORM)["grads"],
                  "dropout": step(model_at(state, 0.1), batch,
                                  dropout_seed=STEP_SEED)["loss"]}
        single["validate"], single["inference"] = _one_process_eval()
        variables = _jax_variables()
        jax_run = _jax_mesh_step(variables)
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
    for name, p in procs.items():
        assert p.returncode == 0, (name, logs[name][-4000:])
    ranks = {name: [torch.load(work / f"w{world}tp{tp}_rank{r}.pt",
                               weights_only=False) for r in range(world)]
             for name, (world, tp) in LAYOUTS.items()}
    world, tp = SYNC_LAYOUT
    ranks["sync"] = [torch.load(work / f"sync_w{world}tp{tp}_rank{r}.pt",
                                weights_only=False) for r in range(world)]
    return {"work": work, "out": out, "ranks": ranks, "single": single,
            "jax": jax_run, "variables": variables, "logs": logs,
            "state": state}


def _grads_within(got, ref) -> bool:
    try:
        _assert_grads_close({n: g.numpy() for n, g in got.items()},
                            {n: np.asarray(g) for n, g in ref.items()})
    except AssertionError:
        return False
    return True


def _rel(a, b) -> float:
    return abs(a - b) / abs(b)


# ------------------------------------------------------------ the rules

@pytest.mark.parametrize("tp", [2, 4, 8])
def test_param_spec_is_the_jax_mesh_spec_of_every_parameter(tp):
    """Each JAX leaf is tagged with its index along the axis that
    ``make_param_shardings`` shards over 'model' on make_mesh(8 / tp, tp)
    (0 where it replicates), and carried to the port's keys by the
    converter (``from_jax``: unstacking, transposes, q/k/v packing). Every
    port key's ``param_spec`` must split exactly the tagged dim, block by
    block, and replicate the untagged keys: the projector's generator
    (289 outputs) stays replicated, as in JAX."""
    from cris_tpu.parallel import make_mesh, make_param_shardings

    variables = _jax_variables()
    shardings = make_param_shardings(make_mesh(8 // tp, tp), variables)

    def tag(x, sharding):
        axes = [i for i, a in enumerate(sharding.spec) if a == "model"]
        if not axes:
            return np.zeros(x.shape)
        shape = [1] * x.ndim
        shape[axes[0]] = x.shape[axes[0]]
        index = np.arange(1, x.shape[axes[0]] + 1, dtype=np.float64)
        return np.broadcast_to(index.reshape(shape), x.shape).copy()

    tags = from_jax(jax.tree_util.tree_map(tag, variables, shardings))
    sharded = []
    for key, t in tags.items():
        spec = param_spec(key, t.shape, tp)
        if not t.any():
            assert spec is None, (key, spec)
            continue
        assert spec is not None, key
        n = t.shape[spec.dim] // spec.blocks
        index = np.tile(np.arange(1, n + 1, dtype=np.float64), spec.blocks)
        shape = [1] * t.ndim
        shape[spec.dim] = t.shape[spec.dim]
        np.testing.assert_array_equal(
            t, np.broadcast_to(index.reshape(shape), t.shape), err_msg=key)
        sharded.append(key)
    assert "proj.txt.weight" in tags and "proj.txt.weight" not in sharded
    assert "backbone.token_embedding.weight" in sharded
    assert "decoder.layers.1.self_attn.in_proj_weight" in sharded
    assert len(sharded) == 2 * 11 + 2 * 3 + 1  # decoder, text MLPs, vocab


def test_projector_generator_stays_replicated_where_it_does_not_divide():
    """in_dim * 3 * 3 + 1 outputs: 2305 at R50 and R101, odd, so no tp
    splits it; a width that divides would be split by its rule."""
    for tp in (2, 4, 8):
        for shape in ((2305, 1024), (2305,), (289, 64)):
            name = "proj.txt." + ("weight" if len(shape) == 2 else "bias")
            assert param_spec(name, shape, tp) is None
        assert param_spec("proj.txt.weight", (2304, 1024), tp) == Shard(0)
    assert param_spec("decoder.layers.0.ffn.4.bias", (512,), 2) is None
    assert param_spec("decoder.layers.0.self_attn.in_proj_bias", (3 * 48,),
                      2) == Shard(0, 3)
    assert param_spec("decoder.layers.0.self_attn.in_proj_bias", (3 * 50,),
                      4) is None
    assert param_spec("decoder.layers.0.ffn.0.weight", (128, 64), 1) is None


def test_grid_and_plan_of_the_ranks(runs):
    """Rank r is data rank r // tp and model rank r % tp (make_mesh's
    layout); every planned key holds a 1 / tp slice, the projector's
    generator the whole."""
    for name, (world, tp) in LAYOUTS.items():
        for r, got in enumerate(runs["ranks"][name]):
            assert got["grid"] == (r // tp, world // tp, r % tp, tp)
            state = runs["state"]
            for key, shape in got["local_shapes"].items():
                spec = got["plan"].get(key)
                want = list(state[key].shape)
                if spec is not None:
                    want[spec.dim] //= tp
                assert list(shape) == want, key
            assert "proj.txt.weight" not in got["plan"]


def test_gather_of_shard_is_the_state_dict_bit_for_bit(runs):
    for name in LAYOUTS:
        for got in runs["ranks"][name]:
            assert got["roundtrip_equal"] and got["gathered_equal"], name


# ------------------------------------------------------------ the steps

@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_f32_step_matches_one_process_and_the_jax_mesh(runs, layout):
    """dropout 0, f32: the loss (the data ranks' mean) within 1e-4 of one
    process and of JAX's make_mesh(4, 2) step; the gathered gradients and
    the BN statistics at test_torch_parallel.py's bars; every rank of the
    grid holds the same gradients and statistics."""
    ranks, single, ref = (runs["ranks"][layout], runs["single"]["f32"],
                          runs["jax"])
    loss = np.mean([r["f32"]["loss"] for r in ranks])
    assert _rel(loss, single["loss"]) <= 1e-4
    assert _rel(loss, ref["loss"]) <= 1e-4
    got = ranks[0]["f32"]
    for r in ranks[1:]:
        for part in ("grads", "stats"):
            for n, g in r["f32"][part].items():
                assert torch.equal(g, got[part][n]), (part, n)
    assert _grads_within(got["grads"], single["grads"])
    assert _grads_within(got["grads"], ref["grads"])
    assert not got["grads"]["backbone.logit_scale"].any()
    assert len(got["stats"]) > 40
    for key, x in got["stats"].items():
        np.testing.assert_allclose(x.numpy(), single["stats"][key].numpy(),
                                   rtol=1e-5, atol=1e-5, err_msg=key)
        np.testing.assert_allclose(x.numpy(), ref["stats"][key], rtol=2e-5,
                                   atol=2e-5, err_msg=key)
    wrapped = "DistributedDataParallel" if len(ranks) == 4 else "CRIS"
    assert got["wrapped"] == wrapped


def test_row_parallel_bias_added_on_every_rank_fails_the_bars(runs):
    """The planted fault: each rank adds out_proj's, fc2's and c_proj's
    bias before the sum, so the sum holds it tp times."""
    bad, single = runs["ranks"]["dp1xtp2"][0]["fault_bias"], \
        runs["single"]["f32"]
    assert (_rel(bad["loss"], single["loss"]) > 1e-4
            or not _grads_within(bad["grads"], single["grads"]))


def test_dropout_step_draws_the_one_process_masks(runs):
    """dp1 x tp2 at dropout 0.1 and the step's seed: the loss of one
    process to f32 rounding (K2 keyed on the global head, the elementwise
    masks from the data rank's generator, the FFN's columns of the full
    mask); K2 keyed on the local head (the planted fault) parts from it."""
    got = runs["ranks"]["dp1xtp2"][0]
    want = runs["single"]["dropout"]
    assert _rel(got["dropout"], want) <= DROPOUT_BAR, (got["dropout"], want)
    assert _rel(got["fault_head_offset"], want) > 100 * DROPOUT_BAR


def test_clip_sees_the_global_norm(runs):
    """A step with max_norm: the gathered clipped gradient has the norm
    CLIP_MAX_NORM and is one process's clipped gradient."""
    for layout in LAYOUTS:
        clipped = runs["ranks"][layout][0]["clipped"]
        norm = torch.sqrt(sum(g.double().square().sum()
                              for g in clipped.values()))
        assert abs(norm.item() - CLIP_MAX_NORM) <= 1e-6, norm
        assert _grads_within(clipped, runs["single"]["clipped"])


def test_heads_that_do_not_divide_attend_whole(runs):
    """A decoder layer of 3 heads split over 2 model ranks gathers q, k, v
    and attends whole: output, input gradient and gathered parameter
    gradients are the unsplit layer's at dropout 0.1."""
    out_gap, in_gap, param_gap = runs["ranks"]["dp1xtp2"][0]["heads"]
    assert out_gap <= 1e-5 and in_gap <= 1e-5 and param_gap <= 1e-4


# ------------------------------------------------------- K2's head offset

def test_keep_bits_with_a_head_offset_are_the_full_launchs_heads():
    want = keep_bits(77, 3, 8, 5, 9, batch_offset=2)
    for offset in (0, 2, 4, 6):
        assert torch.equal(keep_bits(77, 3, 2, 5, 9, batch_offset=2,
                                     head_offset=offset),
                           want[:, offset:offset + 2])
    assert torch.equal(keep_mask(77, 2, 4, 5, 40, 0.1, head_offset=4),
                       keep_mask(77, 2, 8, 5, 40, 0.1)[:, 4:])
    assert torch.equal(keep_bits_packed(77, 2, 4, 5, 40, 0.1, head_offset=4),
                       keep_bits_packed(77, 2, 8, 5, 40, 0.1)[:, 4:])
    with pytest.raises(ValueError):
        keep_bits(77, 2, 2, 5, 9, head_offset=-1)
    with pytest.raises(ValueError):
        keep_bits(77, 2, 2, 5, 9, head_offset=2**31 - 2)


def test_plain_k2_with_a_head_offset_is_the_full_launchs_heads():
    """K2's plain forward and backward on heads 2:4 of 4 (their columns of
    q, k, v) with head_offset 2 equal those columns of the 4-head call
    (f32, masked keys); so does the wrapper on CPU tensors."""
    gen = torch.Generator().manual_seed(3)
    q, k, v = (torch.randn(2, n, 32, generator=gen) for n in (9, 7, 7))
    g = torch.randn(2, 9, 32, generator=gen)
    valid = torch.ones(2, 7, dtype=torch.bool)
    valid[1, 4:] = False
    want = attention_dropout_plain(q, k, v, 4, valid, 0.3, 11)
    want_grads = attention_dropout_backward_plain(q, k, v, 4, valid, 0.3, 11,
                                                  g)
    cols = slice(16, 32)
    args = (q[..., cols], k[..., cols], v[..., cols], 2, valid, 0.3, 11)
    for fn in (attention_dropout_plain, fused_attention_bse_dropout):
        got = fn(*args, head_offset=2)
        torch.testing.assert_close(got, want[..., cols], rtol=1e-6,
                                   atol=1e-6)
    assert not torch.allclose(attention_dropout_plain(*args),
                              want[..., cols])
    got = attention_dropout_backward_plain(*args, g[..., cols], head_offset=2)
    for a, b in zip(got, want_grads):
        torch.testing.assert_close(a, b[..., cols], rtol=1e-6, atol=1e-6)


# ------------------------------------------------- evaluation, checkpoints

def test_validate_and_inference_over_dp2_tp2_equal_one_process(runs):
    """Every rank returns one process's IoU, Pr@50..90 and oIoU (1e-6);
    the IoUs gathered over the data group are one process's, each pair
    once; the ranks of a model group score the same refs."""
    single = runs["single"]
    ranks = runs["ranks"]["dp2xtp2"]
    for r in ranks:
        for key in ("validate", "inference"):
            iou, prec = r[key]
            want_iou, want_prec = single[key]
            assert abs(iou - want_iou) <= 1e-6, (key, iou, want_iou)
            for k, v in prec.items():
                assert abs(v - want_prec[k]) <= 1e-6, (key, k)
    assert ranks[0]["test_pairs"] == ranks[1]["test_pairs"]
    assert ranks[2]["test_pairs"] == ranks[3]["test_pairs"]
    assert (ranks[0]["test_pairs"] + ranks[2]["test_pairs"]
            == len(ranks[0]["gathered"][1][0]))
    assert ranks[0]["val_pairs"] + ranks[2]["val_pairs"] == VAL_REFS


def test_tp2_checkpoint_loads_into_one_process(runs):
    """tp.pth, written by rank 0 after a step under tp2, holds the full
    CRIS.pytorch state (every key, full shapes) and Adam's full moments,
    those the ranks gathered, bit for bit: it loads into one process with
    every key matched."""
    from cris_tpu_torch.checkpoint import load_train_checkpoint
    from cris_tpu_torch.engine import make_optimizer
    from cris_tpu_torch.utils import CfgNode
    from torch_parallel_worker import TRAIN_CFG, port_tiny

    path = runs["work"] / "tp.pth"
    sd = load_cris_checkpoint(str(path))
    state = runs["state"]
    assert list(sd) == list(state)
    assert all(sd[k].shape == state[k].shape for k in sd)
    model = port_tiny().train()
    opt, sched = make_optimizer(model, CfgNode(TRAIN_CFG), 2)
    load_train_checkpoint(str(path), model, opt, sched)
    moments = opt.state_dict()["state"]
    params = [p for group in opt.param_groups for p in group["params"]]
    assert len(moments) == len(params)
    for i, p in enumerate(params):
        assert moments[i]["exp_avg"].shape == p.shape
    saved = runs["ranks"]["dp1xtp2"][0]["checkpoints"]["saved"]
    for k, v in saved["state"].items():
        assert torch.equal(sd[k], v), k
    ckpt = torch.load(path, weights_only=False)
    for i, st in saved["optimizer"]["state"].items():
        for k, v in st.items():
            assert torch.equal(ckpt["optimizer"]["state"][i][k], v), (i, k)


def test_one_process_checkpoint_resumes_under_tp2(runs):
    """single.pth, one process's, resumed on both ranks of dp1 x tp2: the
    gathered state and moments are the file's bit for bit, and the next
    step's loss is one process's after the same resume."""
    from cris_tpu_torch.checkpoint import load_train_checkpoint
    from cris_tpu_torch.engine import make_optimizer, train_step
    from cris_tpu_torch.utils import CfgNode
    from torch_parallel_worker import TRAIN_CFG, port_tiny

    path = str(runs["work"] / "single.pth")
    ckpt = torch.load(path, weights_only=False)
    got = runs["ranks"]["dp1xtp2"][0]["checkpoints"]
    for k, v in ckpt["state_dict"].items():
        assert torch.equal(got["state"][k], v), k
    for i, st in ckpt["optimizer"]["state"].items():
        for k, v in st.items():
            assert torch.equal(got["optimizer"]["state"][i][k], v), (i, k)
    assert got["scheduler"] == ckpt["scheduler"]
    model = port_tiny().train()
    opt, sched = make_optimizer(model, CfgNode(TRAIN_CFG), 2)
    load_train_checkpoint(path, model, opt, sched)
    loss = float(train_step(model, opt, sched, tp_batch(),
                            step_seed=0)["loss"])
    assert _rel(got["loss"], loss) <= 1e-4, (got["loss"], loss)


# --------------------------------------------------------------- entries

def test_train_at_tp4_and_test_at_tp2_under_torchrun(runs):
    """torchrun -m cris_tpu_torch.train at dp1 x tp4, then -m .test at dp2
    x tp2 and at dp1 x tp4 on its best_model.pth: each logs one run line
    (rank 0) with its grid, the two tests the same pairs and IoU; the
    checkpoint is whole and loads into one process."""
    log = runs["logs"]["entry"]
    assert log.count(INT8_MARK) == 1, log[-3000:]
    log = log.split(INT8_MARK)[0]
    assert log.count("=> run: ") == 3, log[-3000:]
    train, test2, test4 = (json.loads(part.splitlines()[0])
                           for part in log.split("=> run: ")[1:])
    assert (train["world_size"], train["dp"], train["tp"]) == (4, 1, 4)
    assert train["steps"] == 2 and train["images"] == 8
    assert (test2["world_size"], test2["dp"], test2["tp"]) == (4, 2, 2)
    assert (test4["world_size"], test4["dp"], test4["tp"]) == (4, 1, 4)
    assert test2["pairs"] == test4["pairs"] > 0
    ious = re.findall(r" - IoU=(\S+)", log)  # the test entry's result line
    assert len(ious) == 2 and ious[0] == ious[1], ious
    out = os.path.join(runs["out"], "CRIS_TINY")
    sd = load_cris_checkpoint(os.path.join(out, "best_model.pth"))
    cfg = load_cfg_from_cfg_file(TINY)
    build_segmenter(cfg, device="cpu", train=True).load_state_dict(
        sd, strict=True)
    with open(os.path.join(out, "test.log")) as f:
        assert "IoU=" in f.read()


def test_shard_model_keeps_the_model_in_its_mode():
    """Split in eval (the test entry splits the loaded eval model) every
    module stays in eval, so the FFN's column dropout is off; split in
    training every module trains. Slicing needs no process group."""
    cfg = load_cfg_from_cfg_file(TINY)
    for train in (False, True):
        model = build_segmenter(cfg, device="cpu", seed=0, train=train)
        shard_model(model, Grid(model_rank=1, model_size=2))
        assert all(m.training == train for m in model.modules())
        assert type(model.decoder.layers[0].ffn[2]).__name__ == \
            "ColumnDropout"


def test_tp_size_1_leaves_the_model_and_the_grid_whole():
    """tp_size 1 is data parallel's own path: no group is made, the grid
    is the process group's, and the model is not split."""
    assert init_grid(-1, 1) == Grid() == grid()
    cfg = load_cfg_from_cfg_file(TINY)
    model = build_segmenter(cfg, device="cpu", seed=0, grid=grid())
    assert not hasattr(model, "tp_plan")
    assert type(model.decoder.layers[0].ffn[0]) is torch.nn.Linear


# --------------------------------------------- tp 3, int8 under the split

def test_sync_replicated_grads_is_exact_at_tp3(runs):
    """dp1 x tp3 over gloo: replicated gradients equal in value on every
    rank come out bit-equal to them on every rank; gradients that differ
    in their last bits (model rank r's moved to the r-th next float) come
    out as model rank 0's on every rank; a sharded parameter's gradient
    is left as it is. The average it replaces would not keep equal
    gradients: ((g + g) + g) / 3 differs from g in f32."""
    ranks = runs["ranks"]["sync"]
    base = ranks[0]["sync"]["base"]
    for r, got in enumerate(ranks):
        assert got["grid"] == (0, 1, r, 3)
        sync = got["sync"]
        assert all(torch.equal(a, b) for a, b in zip(sync["base"], base))
        if r:
            assert not any(torch.equal(a, b) for a, b in zip(
                sync["moved_input"], base))
        for case in ("equal", "moved"):
            grads, own = sync[case]
            for g, b in zip(grads, base):
                assert torch.equal(g, b), (r, case)
            assert torch.equal(own, torch.full((5,), float(r))), (r, case)
    g = base[0]
    assert not torch.equal((g + g + g) / 3, g)


def test_int8_test_entry_under_tp_matches_one_process(runs):
    """python3 -m cris_tpu_torch.quantize writes quant_scales.npz beside
    the tiny best_model.pth; the test entry at precision int8 reads it at
    tp 1 (one process), 2 and 4, each with its grid in its run line and
    every pair scored, and the IoUs agree within 0.5 points. The int8
    sites are convs, which shard_model does not split."""
    from cris_tpu_torch.checkpoint import load_act_scales

    log = runs["logs"]["entry"].split(INT8_MARK)[1]
    scales, gates = load_act_scales(os.path.join(
        runs["out"], "CRIS_TINY", "quant_scales.npz"))
    assert gates == dict(min_ch=16, pooled_min_ch=32, upfold_min_ch=32)
    assert len(scales) >= 10
    assert log.count(f"({len(scales)} sites)") == len(INT8_TPS), log[-3000:]
    lines = [json.loads(part.splitlines()[0])
             for part in log.split("=> run: ")[1:]]
    assert [(r["world_size"], r["dp"], r["tp"]) for r in lines] == [
        (tp, 1, tp) for tp in INT8_TPS]
    assert len({r["pairs"] for r in lines}) == 1
    ious = [float(x) for x in re.findall(r" - IoU=(\S+)", log)]
    print(f"int8 test entry IoU at tp {INT8_TPS}: {ious}")
    assert len(ious) == len(INT8_TPS)
    assert all(abs(x - ious[0]) <= IOU_BAR for x in ious)
