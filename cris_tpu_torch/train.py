"""Training entry point of the port (counterpart of the repository's
train.py:40-229), on one process or data parallel over several:

    python3 -m cris_tpu_torch.train --config config/refcoco/cris_r50.yaml \\
        [--device cpu] --opts TRAIN.epochs 2 ...
    torchrun --nproc_per_node=N -m cris_tpu_torch.train --config ... \\
        [--device cpu] --opts [Distributed.tp_size T] ...

Under torchrun each rank takes ``cuda:{LOCAL_RANK}`` and joins the
process group (NCCL; gloo with ``--device cpu``), and the N ranks form
a grid of N / T data ranks by T model ranks (``Distributed.tp_size``,
1 by default; ``cli.init_device``). ``batch_size`` and
``batch_size_val`` are the global batches: each data rank loads its
share of every batch (a batch that does not divide raises), the model
trains under DistributedDataParallel over the data group with the
BatchNorms synced over the global batch, and validation gathers every
data rank's IoUs. With T > 1 each model group runs its data rank's rows
through the model split over its T ranks (``models.shard_model``: the
decoder's heads and FFN, the text MLPs, the token embedding). Rank 0
alone logs, tracks, profiles and writes the checkpoints, whole (every
rank of its model group gathers them); every rank resumes from them.

Seeds the run, builds CRIS (CLIP from the TorchScript archive
``clip_pretrain`` when that file exists, else the seeded preset; then
the ``.pth`` of ``weight``, if any), the train and val datasets and
loaders, the two-group Adam and its per-step MultiStepLR, and resumes
from ``resume`` (a ``last_model.pth``) when it is set. Each epoch trains,
validates, updates the best IoU before saving (so a resume restores the
true best), writes ``last_model.pth`` and copies it to ``best_model.pth``
on a new best, in ``{output_folder}/{exp_name}``. Runs on the card unless
``--device cpu`` is given (no card and no ``--device cpu`` is an error).

Logs to stderr and ``train.log`` in the output directory, ending with
the best IoU, the training time and a line ``=> run: {...}``: the train
steps, images, host seconds in the train epochs (less the profiler
window's own start, stop and trace export, ``profiler_seconds``), images
per second (the images summed over the data ranks, the seconds rank
0's, and ``world_size`` with its grid, ``dp`` x ``tp``), the seconds
spent validating, on the card the
seconds between CUDA events around each step and their share of the
host seconds (the events hold the card's waits for the host inside a
step too: an upper bound on its busy share), the peak memory, the card's name and power limit, and
under ``traced`` the profiler window's ``StepTimer.window`` when
``profile_dir`` is set and epoch 1 runs more than 10 steps: the card's
busy time over steps 10-15 (the union of its kernels and copies) and its
share of the window's wall time; and under ``launches`` each rank's
K1 and K2 (forward and backward) launches in this run, by route.
"""

from __future__ import annotations

import datetime
import json
import os
import time

import torch

from . import cli
from .bench import card
from .checkpoint import (LAST_NAME, load_train_checkpoint, promote_best,
                         save_checkpoint)
from .data import RefDataLoader, RefDataset
from .engine import Evaluator, make_optimizer, train_epoch
from .models import resolve_dtype
from .ops.kernels import (attention_dropout_backward, fused_attention_bse,
                          fused_attention_bse_dropout)
from .parallel import (allgather_floats, barrier, close_distributed,
                       data_parallel, grid, process_count, process_index)
from .utils import ExperimentTracker, init_random_seed
from .utils.logging import log_exceptions, logger, setup_logger

# the kernels of the train path, whose launches the run line reports
KERNELS = {"K1": fused_attention_bse, "K2 fwd": fused_attention_bse_dropout,
           "K2 bwd": attention_dropout_backward}


def _launches() -> list:
    """The kernels' launch counts by route, flat, in KERNELS' order."""
    return [n for fn in KERNELS.values()
            for n in fn.launches_by_route.values()]


def _launches_by_rank(start: list) -> dict:
    """Each rank's launches since ``start``: {kernel: {route: [count of
    rank 0, 1, ...]}}."""
    counts = allgather_floats([b - a for a, b in zip(start, _launches())])
    out, i = {}, 0
    for name, fn in KERNELS.items():
        out[name] = {}
        for route in fn.launches_by_route:
            out[name][route] = [int(c[i]) for c in counts]
            i += 1
    return out


@log_exceptions
def main(argv=None):
    """Train; returns (best IoU, the last epoch trained)."""
    cfg = cli.get_parser("CRIS training (PyTorch port)", argv)
    device = cli.init_device(cfg, "train")
    rank, world, layout = process_index(), process_count(), grid()
    dp = layout.data_size
    if cfg.batch_size % dp or cfg.batch_size_val % dp:
        raise ValueError(f"batch sizes ({cfg.batch_size}/"
                         f"{cfg.batch_size_val}) must divide evenly over "
                         f"{dp} data ranks")
    launches = _launches()
    cfg.manual_seed = init_random_seed(cfg.get("manual_seed"))
    cfg.output_dir = os.path.join(cfg.output_folder, cfg.exp_name)
    setup_logger(cfg.output_dir, process_index=rank, filename="train.log",
                 mode="a")
    logger.info(f"device: {device} ({card(device)}), rank {rank} of {world}"
                f" (data {layout.data_rank} of {dp}, model "
                f"{layout.model_rank} of {layout.model_size})")
    if rank != 0:  # the profiler window is rank 0's
        cfg.profile_dir = None
    tracker = ExperimentTracker(
        enabled=cfg.get("wandb", False) and rank == 0, job_type="training",
        config=dict(cfg), project="CRIS", name=cfg.exp_name,
        tags=[cfg.dataset, cfg.clip_pretrain])

    model = cli.build_model(cfg, device, train=True)
    cli.load_initial_weight(cfg, model)
    logger.info(model)

    train_data = RefDataset(cfg.train_lmdb, cfg.mask_root, cfg.dataset,
                            cfg.train_split, "train", cfg.input_size,
                            cfg.word_len)
    val_data = RefDataset(cfg.val_lmdb, cfg.mask_root, cfg.dataset,
                          cfg.val_split, "val", cfg.input_size, cfg.word_len)
    train_loader = RefDataLoader(train_data,
                                 batch_size=cfg.batch_size // dp,
                                 shuffle=True, seed=cfg.manual_seed,
                                 drop_last=True,
                                 num_workers=cfg.get("workers", 8),
                                 process_index=layout.data_rank,
                                 process_count=dp)
    val_loader = RefDataLoader(val_data,
                               batch_size=cfg.batch_size_val // dp,
                               shuffle=False,
                               num_workers=cfg.get("workers_val", 4),
                               process_index=layout.data_rank,
                               process_count=dp)

    optimizer, scheduler = make_optimizer(model, cfg, len(train_loader))
    evaluator = Evaluator(model, cfg.input_size,
                          resolve_dtype(cfg.get("precision", "bf16")),
                          batch_size=cfg.batch_size_val // dp)

    best_iou = 0.0
    start_epoch = last_epoch = cfg.get("start_epoch", 0)
    if cfg.get("resume"):
        logger.info(f"=> loading checkpoint '{cfg.resume}'")
        ckpt = load_train_checkpoint(cfg.resume, model, optimizer, scheduler)
        start_epoch = last_epoch = int(ckpt["epoch"])
        best_iou = float(ckpt["best_iou"])
        logger.info(f"=> loaded checkpoint '{cfg.resume}' (epoch "
                    f"{start_epoch})")
    # the model itself with one data rank
    trained = data_parallel(model, layout.data_group)

    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    totals = {"steps": 0, "images": 0, "seconds": 0.0,
              "step_event_seconds": 0.0, "profiler_seconds": 0.0,
              "val_seconds": 0.0}
    traced = None
    start_time = time.time()
    for epoch in range(start_epoch, cfg.epochs):
        last_epoch = epoch + 1
        train_loader.set_epoch(last_epoch)
        stats = train_epoch(trained, optimizer, scheduler, train_loader,
                            last_epoch, cfg, seed=cfg.manual_seed,
                            tracker=tracker)
        traced = stats["run"].pop("traced") or traced
        for key, value in stats["run"].items():
            totals[key] += value or 0
        iou, prec = evaluator.validate(val_loader, last_epoch, cfg.epochs)
        totals["val_seconds"] += evaluator.last_run["seconds"]

        # update best BEFORE saving so a resume restores the true best
        is_best = iou >= best_iou
        best_iou = max(best_iou, iou)
        barrier()
        # every rank gathers a split model's state; rank 0 writes it
        save_checkpoint(cfg.output_dir, LAST_NAME, model, optimizer,
                        scheduler, epoch=last_epoch, cur_iou=iou,
                        best_iou=best_iou, prec=prec, write=rank == 0)
        if rank == 0 and is_best:
            promote_best(cfg.output_dir)
        barrier()

    tracker.finish()
    logger.info(f"* Best IoU={best_iou} *")
    total = str(datetime.timedelta(seconds=int(time.time() - start_time)))
    logger.info(f"* Training time {total} *")
    run = dict(totals)
    run["images"] = int(sum(r[0] for r in allgather_floats(
        [run["images"]], layout.data_group)))
    run.update(world_size=world, dp=dp, tp=layout.model_size)
    run["images_per_s"] = (run["images"] / run["seconds"] if run["seconds"]
                           else None)
    if device.type == "cuda":
        run["step_event_share"] = (run["step_event_seconds"] / run["seconds"]
                                   if run["seconds"] else None)
        run["peak_gib"] = torch.cuda.max_memory_allocated(device) / 2**30
    else:
        run.update(step_event_seconds=None, step_event_share=None,
                   peak_gib=None)
    run["card"] = card(device)
    run["traced"] = traced
    run["launches"] = _launches_by_rank(launches)
    logger.info(f"=> run: {json.dumps(run)}")
    return best_iou, last_epoch


if __name__ == "__main__":
    try:
        main()
    finally:
        close_distributed()
