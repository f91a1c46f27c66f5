"""Worker process for tests/test_torch_tensor_parallel.py: one rank of a
tensor-parallel job of the PyTorch package over gloo on the CPU.

    python torch_tp_worker.py <rank> <world> <tp> <port> <workdir> [sync]

Joins the process group through ``parallel.init_distributed`` (the
environment torchrun would set, on localhost:<port>), lays the ranks out
on a (world / tp) x tp grid (``parallel.init_grid``) and runs, on tiny
CRIS split over its model group (f32, the weights of ``tp_state``):

- the state dict: the split model's gathered state and
  ``gather_state_dict(shard_state_dict(...))`` against the full one;
- train steps on this data rank's rows of ``tp_batch``: at dropout 0, at
  dropout 0.1, with the clip, and each planted fault of the test (the
  row-parallel bias added on every rank; K2 without ``head_offset``);
- with one data rank: a checkpoint written under tensor parallel, and a
  resume from one process's checkpoint, then a step;
- a decoder layer whose heads the model group does not divide;
- with two data ranks: ``Evaluator.validate`` and ``inference``.

Writes ``<workdir>/w<world>tp<tp>_rank<rank>.pt``. With ``sync`` it only
runs ``sync_replicated_grads_`` on planted gradients (``sync_grads``) and
writes ``<workdir>/sync_w<world>tp<tp>_rank<rank>.pt``.
"""

import os
import sys

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
if REPO not in sys.path:
    sys.path.insert(0, REPO)
if HERE not in sys.path:
    sys.path.insert(0, HERE)

from torch_parallel_worker import (CLIP_MAX_NORM, TEST_BATCH,  # noqa: E402
                                   TEST_REFS, TINY, TRAIN_CFG, VAL_BATCH,
                                   VAL_REFS, port_tiny)

BATCH = 4  # tp_batch's rows: one a data rank of the JAX mesh (4, 2)
STEP_SEED = 5  # the dropout steps' seed


def tp_state(seed=0):
    """tiny CRIS's seeded init with every bias and norm scale moved off
    its init value (a bias added twice must show), as a full state dict."""
    from cris_tpu_torch.models import init_weights

    sd = init_weights(port_tiny(), seed).state_dict()
    gen = torch.Generator().manual_seed(seed + 1)
    for k, v in sd.items():
        if k.endswith(".bias"):
            v.copy_(0.05 * torch.randn(v.shape, generator=gen))
        elif k.endswith((".weight",)) and v.dim() == 1:
            v.add_(0.1 * torch.randn(v.shape, generator=gen))
    return sd


def tp_batch():
    """BATCH rows of images, token ids (padded, EOT the largest id) and
    masks, from a numpy seed, in the port's NCHW layout."""
    rng = np.random.default_rng(20)
    img = rng.standard_normal((BATCH, 3, 64, 64)).astype(np.float32)
    word = np.zeros((BATCH, 17), np.int64)
    for i in range(BATCH):
        n = 4 + 3 * i
        word[i, :n] = rng.integers(1, 49407, n)
        word[i, n - 1] = 49407
    mask = (rng.random((BATCH, 1, 64, 64)) > 0.5).astype(np.float32)
    return {"image": img, "word": word, "mask": mask}


def rows(batch, rank, size):
    per = BATCH // size
    return {k: v[rank * per:(rank + 1) * per] for k, v in batch.items()}


def model_at(state, dropout=0.0, grid=None):
    """tiny CRIS in train mode at ``state``, split over ``grid``."""
    from cris_tpu_torch.models import shard_model

    model = port_tiny(dropout)
    model.load_state_dict(state)
    if grid is not None:
        shard_model(model, grid)
    return model.train()


def step(model, batch, grid=None, max_norm=0.0, dropout_seed=0):
    """One train step: (loss, gradients, BN running statistics), all
    full (gathered over the model group when ``grid`` splits the model)."""
    from cris_tpu_torch.engine import make_optimizer, train_step
    from cris_tpu_torch.parallel import data_parallel
    from cris_tpu_torch.parallel.tensor import gather_state_dict
    from cris_tpu_torch.utils import CfgNode

    opt, sched = make_optimizer(
        model, CfgNode(dict(TRAIN_CFG, max_norm=max_norm)), 2)
    wrapped = data_parallel(model, None if grid is None else grid.data_group)
    loss = float(train_step(wrapped, opt, sched, batch,
                            step_seed=dropout_seed)["loss"])
    grads = {n: p.grad.detach().clone() for n, p in model.named_parameters()}
    if grid is not None and grid.model_size > 1:
        grads = gather_state_dict(grads, grid, model.tp_plan)
    stats = {n: b.detach().clone() for n, b in model.named_buffers()
             if n.endswith(("running_mean", "running_var"))}
    return {"loss": loss, "grads": grads, "stats": stats,
            "wrapped": type(wrapped).__name__}


def heads_that_do_not_divide(grid):
    """A decoder layer of 3 heads (E 48) at dropout 0.1 in training, whole
    and split over the model group by ``shard_model`` (the layer held at
    its CRIS key, ``decoder.layers.0``, which the rules read): (max
    |output gap|, max |input gradient gap|, max |parameter gradient
    gap|)."""
    import copy

    from torch import nn

    from cris_tpu_torch.models import TransformerDecoderLayer, shard_model
    from cris_tpu_torch.models.decoder import dropout_rng
    from cris_tpu_torch.parallel.tensor import gather_state_dict

    gen = torch.Generator().manual_seed(9)
    whole = nn.Module()
    whole.decoder = nn.Module()
    whole.decoder.layers = nn.ModuleList(
        [TransformerDecoderLayer(48, 3, 64, 0.1).train()])
    with torch.no_grad():
        for p in whole.parameters():
            p.copy_(0.2 * torch.randn(p.shape, generator=gen))
    vis = torch.randn(2, 9, 48, generator=gen)
    txt = torch.randn(2, 5, 48, generator=gen)
    vis_pos, txt_pos = (torch.randn(n, 48, generator=gen) for n in (9, 5))
    pad = torch.zeros(2, 5, dtype=torch.bool)
    pad[1, 3:] = True
    split = shard_model(copy.deepcopy(whole), grid)
    outs = []
    for model in (whole, split):
        x = vis.clone().requires_grad_()
        y = model.decoder.layers[0](x, txt, vis_pos, txt_pos, pad,
                                    dropout_rng(3, "cpu"))
        y.square().sum().backward()
        grads = {n: p.grad for n, p in model.named_parameters()}
        if model is split:
            grads = gather_state_dict(grads, grid, split.tp_plan)
        outs.append((y.detach(), x.grad, grads))
    return [float((outs[0][0] - outs[1][0]).abs().max()),
            float((outs[0][1] - outs[1][1]).abs().max()),
            max(float((outs[0][2][n] - g).abs().max())
                for n, g in outs[1][2].items())]


def evaluate(grid):
    """validate at a global batch of VAL_BATCH and inference over the
    test refs, on this data rank's shard, the seed-0 model split over the
    model group; each with its pairs and what ``_allgather`` returned."""
    from cris_tpu_torch.data import RefDataLoader, RefDataset
    from cris_tpu_torch.engine import Evaluator
    from cris_tpu_torch.models import build_segmenter
    from cris_tpu_torch.utils import load_cfg_from_cfg_file

    cfg = load_cfg_from_cfg_file(TINY)
    model = build_segmenter(cfg, device="cpu", seed=0, grid=grid)
    ev = Evaluator(model, cfg.input_size, None, batch_size=TEST_BATCH,
                   host_workers=1)
    gathered = []
    real = Evaluator._allgather
    ev._allgather = lambda *a: gathered.append(real(*a)) or gathered[-1]
    val = RefDataset(f"synthetic://{VAL_REFS}?seed=3", None, "synthetic",
                     "val", "val", cfg.input_size, cfg.word_len)
    test = RefDataset(f"synthetic://{TEST_REFS}?seed=4", None, "synthetic",
                      "val", "test", cfg.input_size, cfg.word_len)
    loader = RefDataLoader(val, batch_size=VAL_BATCH // grid.data_size,
                           num_workers=1, process_index=grid.data_rank,
                           process_count=grid.data_size)
    out = {"validate": ev.validate(loader), "val_pairs":
           ev.last_run["pairs"]}
    out["inference"] = ev.inference(test, cfg.word_len, progress=False)
    out["test_pairs"] = ev.last_run["pairs"]
    out["gathered"] = gathered
    return out


def checkpoints(work, grid, state, batch):
    """With one data rank: a step under tensor parallel, saved (rank 0
    writes tp.pth, gathered); then rank 0 writes one process's checkpoint
    of the same step (single.pth) and every rank resumes from it. Returns
    the gathered state and moments that tp.pth was written from, what the
    resumed state and moments were, gathered, and the loss of one more
    step after the resume."""
    import copy

    from cris_tpu_torch.checkpoint import (load_train_checkpoint,
                                           save_checkpoint)
    from cris_tpu_torch.engine import make_optimizer, train_step
    from cris_tpu_torch.parallel import barrier
    from cris_tpu_torch.parallel.tensor import (full_optimizer_state,
                                                full_state_dict)
    from cris_tpu_torch.utils import CfgNode

    cfg = CfgNode(TRAIN_CFG)
    model = model_at(state, grid=grid)
    opt, sched = make_optimizer(model, cfg, 2)
    train_step(model, opt, sched, batch, step_seed=0)
    saved = copy.deepcopy({"state": full_state_dict(model),
                           "optimizer": full_optimizer_state(opt, model)})
    save_checkpoint(work, "tp.pth", model, opt, sched, 1, 0.5, 0.5,
                    {"oIoU": 0.5}, write=grid.model_rank == 0)
    if grid.model_rank == 0:
        single = model_at(state)
        opt1, sched1 = make_optimizer(single, cfg, 2)
        train_step(single, opt1, sched1, batch, step_seed=0)
        save_checkpoint(work, "single.pth", single, opt1, sched1, 1, 0.5,
                        0.5, {"oIoU": 0.5})
    barrier()
    model = model_at(state, grid=grid)
    opt, sched = make_optimizer(model, cfg, 2)
    load_train_checkpoint(os.path.join(work, "single.pth"), model, opt, sched)
    resumed = copy.deepcopy({"state": full_state_dict(model),
                             "optimizer": full_optimizer_state(opt, model),
                             "scheduler": sched.state_dict()})
    resumed["loss"] = float(train_step(model, opt, sched, batch,
                                       step_seed=0)["loss"])
    resumed["saved"] = saved
    return resumed


def sync_grads(grid):
    """``sync_replicated_grads_`` over this rank's model group on three
    replicated gradients: equal in value on every rank, then moved by
    model rank r to the r-th next float (last bits that differ), beside a
    sharded parameter's gradient, which it leaves as it is."""
    from cris_tpu_torch.parallel.tensor import Shard, sync_replicated_grads_

    gen = torch.Generator().manual_seed(11)
    base = [torch.randn(shape, generator=gen)
            for shape in ((4096,), (64, 33), (7,))]

    def synced(grads):
        params = []
        for g in grads:
            param = torch.nn.Parameter(torch.zeros_like(g))
            param.grad = g.clone()
            params.append(param)
        own = torch.nn.Parameter(torch.zeros(5))
        own.grad = torch.full((5,), float(grid.model_rank))
        own.tp_shard = Shard(0)
        sync_replicated_grads_(params + [own], grid)
        return [p.grad for p in params], own.grad

    def moved(g):
        for _ in range(grid.model_rank):
            g = torch.nextafter(g, torch.full_like(g, float("inf")))
        return g

    return {"base": base, "equal": synced(base),
            "moved_input": [moved(g) for g in base],
            "moved": synced([moved(g) for g in base])}


def main(rank, world, tp, port, work, what="all"):
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(world),
                      MASTER_ADDR="localhost", MASTER_PORT=str(port))
    torch.set_num_threads(1)
    from cris_tpu_torch.models import decoder as decoder_module
    from cris_tpu_torch.parallel import (close_distributed, init_distributed,
                                         init_grid)
    from cris_tpu_torch.parallel import tensor
    from cris_tpu_torch.parallel.tensor import (full_state_dict,
                                                gather_state_dict,
                                                shard_state_dict)

    init_distributed("cpu")
    grid = init_grid(-1, tp)
    out = {"grid": (grid.data_rank, grid.data_size, grid.model_rank,
                    grid.model_size)}
    if what == "sync":
        out["sync"] = sync_grads(grid)
        close_distributed()
        torch.save(out, os.path.join(work, f"sync_w{world}tp{tp}_rank{rank}"
                                           ".pt"))
        return
    state = tp_state()
    batch = rows(tp_batch(), grid.data_rank, grid.data_size)

    split = model_at(state, grid=grid)
    out["plan"] = dict(split.tp_plan)
    out["local_shapes"] = {k: tuple(v.shape)
                           for k, v in split.state_dict().items()}
    full = full_state_dict(split)
    out["gathered_equal"] = all(torch.equal(full[k], v)
                                for k, v in state.items())
    roundtrip = gather_state_dict(shard_state_dict(state, grid), grid,
                                  split.tp_plan)
    out["roundtrip_equal"] = (list(roundtrip) == list(state) and all(
        torch.equal(roundtrip[k], v) for k, v in state.items()))
    del split, full, roundtrip

    out["f32"] = step(model_at(state, grid=grid), batch, grid)
    out["clipped"] = step(model_at(state, grid=grid), batch, grid,
                          max_norm=CLIP_MAX_NORM)["grads"]
    if grid.data_size == 1:
        out["dropout"] = step(model_at(state, 0.1, grid), batch, grid,
                              dropout_seed=STEP_SEED)["loss"]
        # planted: K2 keyed on the local head (no head offset)
        real_dpa = decoder_module.dot_product_attention
        decoder_module.dot_product_attention = (
            lambda *a, **k: real_dpa(*a, **dict(k, head_offset=0)))
        try:
            out["fault_head_offset"] = step(
                model_at(state, 0.1, grid), batch, grid,
                dropout_seed=STEP_SEED)["loss"]
        finally:
            decoder_module.dot_product_attention = real_dpa
        # planted: the row-parallel bias added on every rank, before the sum
        real_row = tensor.RowParallelLinear.forward
        tensor.RowParallelLinear.forward = lambda self, x: (
            tensor.reduce_from_model(
                torch.nn.functional.linear(x, self.weight, self.bias),
                self.grid))
        try:
            out["fault_bias"] = step(model_at(state, grid=grid), batch, grid)
        finally:
            tensor.RowParallelLinear.forward = real_row
        out["checkpoints"] = checkpoints(work, grid, state, batch)
        out["heads"] = heads_that_do_not_divide(grid)
    else:
        out.update(evaluate(grid))
    close_distributed()
    torch.save(out, os.path.join(work, f"w{world}tp{tp}_rank{rank}.pt"))


if __name__ == "__main__":
    main(*(int(a) for a in sys.argv[1:5]), *sys.argv[5:])
