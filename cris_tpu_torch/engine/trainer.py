"""Optimizer, LR schedule, and the train step (counterpart of
cris_tpu/engine/trainer.py).

- Adam with two LR groups: the CLIP backbone at ``lr_multi x base_lr`` and
  the head at ``base_lr``, positional embeddings counted as head
  (``models.param_group_label``). The backbone runs at its multiple from
  step 0, as in the JAX package (not the reference's first-epoch quirk
  that trainer.py:8-13 describes).
- betas (0.9, 0.999), eps 1e-8; ``weight_decay`` is torch Adam's L2,
  added to the gradient before the moments, as ``optax.add_decayed_weights``
  before ``scale_by_adam``.
- ``max_norm`` clips the raw gradients' global norm before the optimizer,
  as ``optax.chain(clip_by_global_norm, tx)`` does.
- MultiStepLR's epoch milestones as a per-step ``LambdaLR``.
- bf16 autocast over f32 parameters when the config says ``precision:
  bf16``; no GradScaler (bf16 keeps f32's exponent range).

A parameter that the loss does not reach (CLIP's ``logit_scale``) gets a
zero gradient, as ``jax.grad`` gives it, so that Adam and weight decay
treat it as the JAX optimizer does.
"""

from __future__ import annotations

import bisect
import time
from typing import Callable, Dict, Optional, Sequence, Tuple

import torch

from ..models import param_group_label, resolve_dtype
from ..utils.logging import AverageMeter, ExperimentTracker, ProgressMeter
from ..utils.profiling import StepTimer
from .evaluator import to_device
from .metrics import train_metrics


def multistep_factor(milestones: Sequence[int], gamma: float,
                     steps_per_epoch: int) -> Callable[[int], float]:
    """step -> gamma ** (number of milestone epochs passed)."""
    boundaries = sorted(int(m) * steps_per_epoch for m in milestones)

    def factor(step: int) -> float:
        return gamma ** bisect.bisect_right(boundaries, step)

    return factor


def multistep_schedule(base_lr: float, milestones: Sequence[int], gamma: float,
                       steps_per_epoch: int) -> Callable[[int], float]:
    """lr(step) = base_lr * gamma^(#milestone epochs passed) (torch
    MultiStepLR semantics, trainer.py:39-52)."""
    factor = multistep_factor(milestones, gamma, steps_per_epoch)
    return lambda step: base_lr * factor(step)


def lr_at_epoch(base_lr, milestones, gamma, epoch) -> float:
    """Host-side mirror of the schedule for logging."""
    return base_lr * gamma ** bisect.bisect_right(sorted(milestones), epoch - 1)


def make_optimizer(model: torch.nn.Module, cfg, steps_per_epoch: int
                   ) -> Tuple[torch.optim.Adam, torch.optim.lr_scheduler.LambdaLR]:
    """Two-group Adam and its per-step schedule. ``max_norm`` rides in the
    param groups, where ``train_step`` reads it."""
    groups = {"backbone": [], "head": []}
    for name, param in model.named_parameters():
        if param.requires_grad:
            groups[param_group_label(name)].append(param)
    base_lr = float(cfg.base_lr)
    max_norm = float(cfg.get("max_norm", 0.0) or 0.0)
    optimizer = torch.optim.Adam(
        [{"params": groups["backbone"],
          "lr": base_lr * float(cfg.get("lr_multi", 1.0)),
          "max_norm": max_norm},
         {"params": groups["head"], "lr": base_lr, "max_norm": max_norm}],
        lr=base_lr, betas=(0.9, 0.999), eps=1e-8,
        weight_decay=float(cfg.get("weight_decay", 0.0) or 0.0))
    scheduler = torch.optim.lr_scheduler.LambdaLR(
        optimizer, multistep_factor(cfg.get("milestones", []),
                                    cfg.get("lr_decay", 0.1), steps_per_epoch))
    return optimizer, scheduler


def _device_batch(batch, device, nchw: bool = False
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(image, word, mask) of ``batch`` on ``device``; ``nchw`` puts a
    loader's (B, H, W, C) images and masks in (B, C, H, W) there."""
    return (to_device(batch["image"], device, torch.float32, nchw),
            to_device(batch["word"], device, torch.long),
            to_device(batch["mask"], device, torch.float32, nchw))


def apply_gradients(optimizer: torch.optim.Optimizer, scheduler) -> None:
    """The JAX ``apply_gradients`` on the parameters' ``.grad``: a missing
    gradient becomes zeros, the global norm is clipped to the groups'
    ``max_norm`` when it is set, then one Adam step and one schedule step."""
    params = [p for group in optimizer.param_groups for p in group["params"]]
    for param in params:
        if param.grad is None:
            param.grad = torch.zeros_like(param)
    max_norm = optimizer.param_groups[0].get("max_norm", 0.0)
    if max_norm:
        torch.nn.utils.clip_grad_norm_(params, max_norm)
    optimizer.step()
    scheduler.step()


def train_step(model: torch.nn.Module, optimizer: torch.optim.Optimizer,
               scheduler, batch: Dict, step_seed: int,
               dtype: Optional[torch.dtype] = None) -> Dict[str, torch.Tensor]:
    """One optimisation step on ``batch`` = {"image" (B, 3, H, W) f32,
    "word" (B, L) ids, "mask" (B, 1, H, W) in [0, 1]}, numpy or torch.

    ``step_seed`` seeds the decoder's dropout; ``dtype`` = torch.bfloat16
    runs forward and backward under autocast. Returns 0-dim device
    tensors {loss, iou, prec@50}; nothing waits for the device."""
    params = [p for group in optimizer.param_groups for p in group["params"]]
    device = params[0].device
    img, word, mask = _device_batch(batch, device)
    model.train()
    optimizer.zero_grad(set_to_none=True)
    with torch.autocast(device.type, dtype=dtype or torch.bfloat16,
                        enabled=dtype is not None):
        pred, target, loss = model(img, word, mask, dropout_seed=step_seed)
    loss.backward()
    apply_gradients(optimizer, scheduler)
    iou, pr50 = train_metrics(pred, target)
    return {"loss": loss.detach(), "iou": iou, "prec@50": pr50}


def step_seed(seed: int, step: int) -> int:
    """The dropout seed of a global step (the JAX ``fold_in(rng, step)``):
    the run's seed in the high word, the step in the low one."""
    return ((int(seed) & 0x7FFFFFFF) << 32) | (int(step) & 0xFFFFFFFF)


def train_epoch(model: torch.nn.Module, optimizer, scheduler, loader,
                epoch: int, cfg, seed: int = 0,
                tracker: Optional[ExperimentTracker] = None) -> Dict:
    """One epoch of the reference train loop (engine/engine.py:17-87) over
    the loader's batches ((B, H, W, 3) images, (B, L) ids, (B, H, W, 1)
    masks, as the dataset makes them), each copied to the model's device
    and put in NCHW there: meters and a progress line every ``print_freq``
    steps, with the JAX package's keys logged to ``tracker`` there
    (cris_tpu/engine/trainer.py:252-264), under autocast to
    ``cfg.precision`` (bf16 by default, as in the JAX package), and a
    ``torch.profiler`` trace of steps 10-15 of epoch 1 when
    ``cfg.profile_dir`` is set. Per-step metrics stay on the device and
    are drained (one copy to the host) at each progress line and at the
    end, so the host never waits for the device between steps.

    Returns the epoch's averages {loss, iou, prec@50} and under "run"
    what it counted: steps, images, host seconds (first batch fetched to
    the last step done, less the profiler window's own start, stop,
    measurement and trace export, which are "profiler_seconds"), on the
    card the seconds between CUDA events recorded around each step (None
    on the CPU; they hold the card's waits for the host inside a step too,
    so they bound its busy time from above), and the profiler window's
    ``StepTimer.window`` (None when no window closed in this epoch)."""
    dtype = resolve_dtype(cfg.get("precision", "bf16"))
    timer = StepTimer(cfg.get("profile_dir") if epoch == 1 else None)
    batch_time = AverageMeter("Batch", ":2.2f")
    data_time = AverageMeter("Data", ":2.2f")
    lr_meter = AverageMeter("Lr", ":1.6f")
    loss_meter = AverageMeter("Loss", ":2.4f")
    iou_meter = AverageMeter("IoU", ":2.2f")
    pr_meter = AverageMeter("Prec@50", ":2.2f")
    progress = ProgressMeter(
        len(loader),
        [batch_time, data_time, lr_meter, loss_meter, iou_meter, pr_meter],
        prefix=f"Training: Epoch=[{epoch}/{cfg.epochs}] ")
    cur_lr = lr_at_epoch(cfg.base_lr, cfg.get("milestones", []),
                         cfg.get("lr_decay", 0.1), epoch)
    print_freq = int(cfg.get("print_freq", 100))
    device = next(model.parameters()).device
    on_card = device.type == "cuda"
    pending = []  # [(batch size, device metrics), ...]
    events = []  # [(start, end) CUDA events of each step]
    steps = images = 0

    def drain():
        if not pending:
            return
        values = torch.stack([torch.stack([m["loss"], m["iou"], m["prec@50"]])
                              for _, m in pending]).tolist()
        for (n, _), (loss, iou, pr50) in zip(pending, values):
            loss_meter.update(loss, n)
            iou_meter.update(iou, n)
            pr_meter.update(pr50, n)
        pending.clear()

    t0 = end = time.time()
    profiler_s = 0.0  # the window's start, stop, measurement and export
    for i, batch in enumerate(loader):
        t = time.time()
        timer.step(i)
        spent = time.time() - t
        profiler_s, end = profiler_s + spent, end + spent
        data_time.update(time.time() - end)
        image, word, mask = _device_batch(batch, device, nchw=True)
        step = scheduler.last_epoch
        if on_card:
            events.append((torch.cuda.Event(enable_timing=True),
                           torch.cuda.Event(enable_timing=True)))
            events[-1][0].record()
        metrics = train_step(model, optimizer, scheduler,
                             {"image": image, "word": word, "mask": mask},
                             step_seed(seed, step), dtype)
        if on_card:
            events[-1][1].record()
        n = len(image)
        steps, images = steps + 1, images + n
        pending.append((n, metrics))
        lr_meter.update(cur_lr)
        batch_time.update(time.time() - end)
        end = time.time()
        if (i + 1) % print_freq == 0:
            drain()
            progress.display(i + 1)
            if tracker is not None:
                tracker.log({
                    "time/batch": batch_time.val,
                    "time/data": data_time.val,
                    "training/lr": lr_meter.val,
                    "training/loss": loss_meter.val,
                    "training/iou": iou_meter.val,
                    "training/prec@50": pr_meter.val,
                }, step=epoch * len(loader) + (i + 1))
    drain()
    event_s = None
    if events:
        events[-1][1].synchronize()
        event_s = sum(a.elapsed_time(b) for a, b in events) / 1e3
    seconds = time.time() - t0 - profiler_s
    t = time.time()
    timer.close()
    profiler_s += time.time() - t
    run = {"steps": steps, "images": images, "seconds": seconds,
           "step_event_seconds": event_s, "profiler_seconds": profiler_s,
           "traced": timer.window}
    return {"loss": loss_meter.avg, "iou": iou_meter.avg,
            "prec@50": pr_meter.avg, "run": run}
