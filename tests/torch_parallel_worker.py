"""Worker process for tests/test_torch_parallel.py: one rank of a
data-parallel job of the PyTorch package over gloo on the CPU.

    python torch_parallel_worker.py <rank> <world> <port> <workdir>

Joins the process group through ``parallel.init_distributed`` (the
environment torchrun would set, on localhost:<port>) and runs every path
that communicates only when there is more than one rank: the seed
broadcast, the loader's shard, a DistributedDataParallel train step with
the BatchNorms synced over the global batch (tiny CRIS, f32, dropout 0,
the weights in ``<workdir>/init.pt``, this rank's rows of the golden
batch), a second step with the gradient clipped, the decoder's dropout
generators and its train-mode forward, ``Evaluator.validate`` and
``inference`` with their gathers, and ``allgather_floats`` on lists of
unequal length. Writes ``<workdir>/rank<rank>.json`` and ``.pt``.
"""

import json
import os
import sys

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
GOLDEN_DIR = os.path.join(HERE, "goldens")
TINY = os.path.join(REPO, "config", "synthetic", "cris_tiny.yaml")
# tests/conftest.py's tiny_train_cfg, without importing the JAX package
TRAIN_CFG = dict(base_lr=1e-3, lr_multi=0.1, lr_decay=0.1, milestones=[2],
                 weight_decay=0.0, max_norm=0.0, epochs=3)
CLIP_MAX_NORM = 0.05  # the second step's clip: below the gradient's norm
VAL_REFS, TEST_REFS, VAL_BATCH, TEST_BATCH = 6, 7, 4, 2

if REPO not in sys.path:
    sys.path.insert(0, REPO)


def port_tiny(dropout=0.0):
    """tests/test_torch_train.py's tiny CRIS (conftest.tiny_cris's shapes)."""
    from cris_tpu_torch.models import CLIPConfig, CRIS

    ccfg = CLIPConfig(64, 64, (1, 1, 1, 1), 16, None, 77, 49408, 64, 4, 2)
    return CRIS(ccfg, fpn_in=(128, 256, 64), fpn_out=(32, 64, 128),
                vis_dim=64, num_layers=2, num_head=4, dim_ffn=128,
                dropout=dropout)


def golden_batch(rows=slice(None)):
    """The golden train batch (2 rows) in the port's NCHW layout."""
    fwd = np.load(os.path.join(GOLDEN_DIR, "tiny_forward.npz"))
    gold = np.load(os.path.join(GOLDEN_DIR, "tiny_train_step.npz"))
    return {"image": np.ascontiguousarray(fwd["img"][rows].transpose(0, 3, 1, 2)),
            "word": fwd["word"][rows],
            "mask": np.ascontiguousarray(gold["mask"][rows].transpose(0, 3, 1, 2))}


def two_steps(model, batch):
    """A step at TRAIN_CFG (loss, gradients, BN statistics), then one from
    the same weights with the gradient clipped to CLIP_MAX_NORM (its
    clipped gradients)."""
    from cris_tpu_torch.engine import make_optimizer, train_step
    from cris_tpu_torch.parallel import data_parallel
    from cris_tpu_torch.utils import CfgNode

    raw = model
    start = {n: p.detach().clone() for n, p in raw.named_parameters()}
    model = data_parallel(raw)
    out = {"wrapped": type(model).__name__}
    for max_norm in (TRAIN_CFG["max_norm"], CLIP_MAX_NORM):
        with torch.no_grad():
            for n, p in raw.named_parameters():
                p.copy_(start[n])
        opt, sched = make_optimizer(
            raw, CfgNode(dict(TRAIN_CFG, max_norm=max_norm)), 2)
        loss = float(train_step(model, opt, sched, batch, step_seed=0)["loss"])
        grads = {n: p.grad.detach().clone() for n, p in raw.named_parameters()}
        if not max_norm:
            out.update(loss=loss, grads=grads, stats={
                n: b.detach().clone() for n, b in raw.named_buffers()})
        else:
            out.update(clipped_loss=loss, clipped=grads)
    return out


def decoder_output(seed=5):
    """A one-layer decoder at dropout 0.1 in training on inputs drawn from
    a fixed seed: the same on every rank but for the dropout masks."""
    from cris_tpu_torch.models import TransformerDecoder

    gen = torch.Generator().manual_seed(seed)
    dec = TransformerDecoder(1, 64, 4, 128, 0.1)
    with torch.no_grad():
        for p in dec.parameters():
            p.copy_(torch.randn(p.shape, generator=gen) * 0.2)
    vis = torch.randn(2, 64, 4, 4, generator=gen)
    txt = torch.randn(2, 5, 64, generator=gen)
    pad = torch.zeros(2, 5, dtype=torch.bool)
    pad[1, 3:] = True
    return dec.train()(vis, txt, pad, dropout_seed=seed)


class IndexSet:
    """A dataset of n samples whose batch is its indices."""

    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def get_batch(self, idxs, rngs):
        return [{"index": int(i)} for i in idxs]


def shard(n, rank, world, batch=2):
    """The indices this rank's loader yields in epoch 1 (valid rows)."""
    from cris_tpu_torch.data import RefDataLoader

    loader = RefDataLoader(IndexSet(n), batch_size=batch, shuffle=True,
                           seed=7, num_workers=1, process_index=rank,
                           process_count=world)
    loader.set_epoch(1)
    return [int(i) for b in loader for i in b["index"][b["valid"]]]


def evaluate(rank, world, gathered):
    """validate over the val refs at a global batch of VAL_BATCH and
    inference over the test refs, on this rank's shard; ``gathered``
    collects what ``Evaluator._allgather`` returns."""
    from cris_tpu_torch.data import RefDataLoader, RefDataset
    from cris_tpu_torch.engine import Evaluator
    from cris_tpu_torch.models import build_segmenter
    from cris_tpu_torch.utils import load_cfg_from_cfg_file

    cfg = load_cfg_from_cfg_file(TINY)
    model = build_segmenter(cfg, device="cpu", seed=0)
    ev = Evaluator(model, cfg.input_size, None, batch_size=TEST_BATCH,
                   host_workers=1)
    real = Evaluator._allgather

    def recording(*args):
        out = real(*args)
        gathered.append(out)
        return out

    ev._allgather = recording
    val = RefDataset(f"synthetic://{VAL_REFS}?seed=3", None, "synthetic",
                     "val", "val", cfg.input_size, cfg.word_len)
    test = RefDataset(f"synthetic://{TEST_REFS}?seed=4", None, "synthetic",
                      "val", "test", cfg.input_size, cfg.word_len)
    loader = RefDataLoader(val, batch_size=VAL_BATCH // world, num_workers=1,
                           process_index=rank, process_count=world)
    iou, prec = ev.validate(loader)
    pairs = ev.last_run["pairs"]
    iou_t, prec_t = ev.inference(test, cfg.word_len, progress=False)
    return {"validate": [iou, prec], "val_pairs": pairs,
            "inference": [iou_t, prec_t],
            "test_pairs": ev.last_run["pairs"]}


def main(rank, world, port, work):
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(world),
                      MASTER_ADDR="localhost", MASTER_PORT=str(port))
    torch.set_num_threads(1)
    from cris_tpu_torch.engine import Evaluator
    from cris_tpu_torch.models.decoder import draw_seed, dropout_rng
    from cris_tpu_torch.parallel import (allgather_floats, barrier,
                                         close_distributed, init_distributed,
                                         process_count, process_index)
    from cris_tpu_torch.utils import init_random_seed

    device = init_distributed("cpu")
    out = {"rank": process_index(), "world": process_count(),
           "device": str(device)}
    np.random.seed(1000 + rank)  # each rank would draw another seed
    out["seed"] = init_random_seed(None)
    out["shards"] = {str(n): shard(n, rank, world) for n in (10, 11)}

    per = 2 // world
    model = port_tiny()
    model.load_state_dict(torch.load(os.path.join(work, "init.pt")))
    steps = two_steps(model.train(), golden_batch(slice(rank * per,
                                                        (rank + 1) * per)))

    cpu_gen, dev_gen = dropout_rng(1234, "cpu", rank)
    out["k2_seeds"] = [draw_seed(cpu_gen) for _ in range(4)]
    out["elementwise"] = torch.rand(16, generator=dev_gen).tolist()
    decoded = decoder_output().detach()

    gathered = []
    out.update(evaluate(rank, world, gathered))
    out["gathered"] = gathered
    out["floats"] = allgather_floats([rank + 0.25] * (2 * rank + 1))
    out["no_rows"] = Evaluator._allgather([] if rank else [0.5], 3.0, 4.0)
    barrier()
    close_distributed()
    torch.save({**steps, "decoded": decoded},
               os.path.join(work, f"rank{rank}.pt"))
    with open(os.path.join(work, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
