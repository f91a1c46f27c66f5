"""CRIS ``.pth`` checkpoints in CRIS.pytorch's own format.

The port keeps CRIS.pytorch's module names, so a checkpoint written by
its ``train.py`` (``{"state_dict": model.state_dict(), ...}``, under
``module.`` when the model was wrapped for data parallel) loads with the
prefix stripped and nothing converted: the port's counterpart of
``cris_tpu.checkpoint.torch_convert.load_cris_checkpoint``
(cris_tpu/checkpoint/torch_convert.py:331-337), which converts the same
file to the JAX tree.

The training entry writes that format too, every epoch: ``epoch``,
``cur_iou``, ``best_iou``, ``prec``, ``state_dict``, ``optimizer`` and
``scheduler`` through ``torch.save``, to ``last_model.pth``, copied to
``best_model.pth`` on a new best; ``cfg.resume`` reads it back. This is
the counterpart of cris_tpu/checkpoint/orbax_io.py:23-114, which writes
orbax directories instead. Under data parallel rank 0 writes (the
caller's rule), the unwrapped model's keys, and every rank reads a
resume through the CPU onto its own device. Under tensor parallel the
file is the same: every rank of the model group gathers the full state
dict and Adam's full moments (``parallel.tensor.full_state_dict``,
``full_optimizer_state``), rank 0 writes them, and a load or a resume
gives each rank its slices, so a file of any layout loads into any
other.
"""

from __future__ import annotations

import os
import re
import shutil
from typing import Dict

import torch

from ..parallel.tensor import (full_optimizer_state, full_state_dict,
                               load_full_state_dict, shard_optimizer_state)

BEST_NAME = "best_model.pth"  # what serving looks for under a model_dir
LAST_NAME = "last_model.pth"


def _load(path: str) -> dict:
    """A ``.pth`` file on the CPU. It is unpickled (``weights_only=False``,
    as the JAX package reads it), so load only checkpoints from a trusted
    source."""
    return torch.load(path, map_location="cpu", weights_only=False)


def _strip(sd) -> Dict[str, torch.Tensor]:
    return {re.sub(r"^module\.", "", k): v for k, v in sd.items()}


def load_cris_checkpoint(path: str) -> Dict[str, torch.Tensor]:
    """The state_dict of a trained CRIS ``.pth`` file, on the CPU, with a
    leading ``module.`` stripped from every key."""
    ckpt = _load(path)
    return _strip(ckpt.get("state_dict", ckpt))


def _replace(write, path: str) -> str:
    """``write(tmp)`` to a temporary name beside ``path``, then rename it
    into place, so a reader never sees half a file."""
    tmp = f"{path}.tmp{os.getpid()}"
    try:
        write(tmp)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return path


def save_checkpoint(output_dir: str, name: str, model: torch.nn.Module,
                    optimizer: torch.optim.Optimizer, scheduler, epoch: int,
                    cur_iou: float, best_iou: float,
                    prec: Dict[str, float], write: bool = True) -> str:
    """Write ``output_dir/name`` in CRIS.pytorch's format, with the keys
    of the model that a DistributedDataParallel ``model`` wraps, the
    whole model's state and Adam's moments; returns its path. A model
    split over a model group is gathered first, a collective: every rank
    of the group calls this, and only those with ``write`` write."""
    if isinstance(model, torch.nn.parallel.DistributedDataParallel):
        model = model.module
    path = os.path.join(output_dir, name)
    ckpt = {"epoch": int(epoch), "cur_iou": float(cur_iou),
            "best_iou": float(best_iou),
            "prec": {k: float(v) for k, v in prec.items()},
            "state_dict": full_state_dict(model),
            "optimizer": full_optimizer_state(optimizer, model),
            "scheduler": scheduler.state_dict()}
    if not write:
        return path
    os.makedirs(output_dir, exist_ok=True)
    return _replace(lambda tmp: torch.save(ckpt, tmp), path)


def promote_best(output_dir: str) -> str:
    """Copy ``last_model.pth`` to ``best_model.pth``."""
    return _replace(
        lambda tmp: shutil.copyfile(os.path.join(output_dir, LAST_NAME), tmp),
        os.path.join(output_dir, BEST_NAME))


def load_train_checkpoint(path: str, model: torch.nn.Module,
                          optimizer: torch.optim.Optimizer, scheduler) -> dict:
    """Restore a checkpoint of ``save_checkpoint`` into ``model`` (every
    key matched), ``optimizer`` and ``scheduler`` (its step count; the
    schedule itself is the caller's, rebuilt from the config), onto their
    devices: the file is read onto the CPU (not onto the device that wrote
    it, which another rank does not own) and each tensor is copied to its
    parameter's device, but Adam's step counts, which stay on the CPU. A
    model split over a model group takes its slices of the parameters and
    of the moments. Returns the file's dict (``epoch``, ``best_iou``,
    ...)."""
    if not os.path.isfile(path):
        raise ValueError(f"=> resume failed! no checkpoint found at '{path}'")
    ckpt = _load(path)
    load_full_state_dict(model, _strip(ckpt["state_dict"]), strict=True)
    optimizer.load_state_dict(shard_optimizer_state(ckpt["optimizer"],
                                                    optimizer, model))
    scheduler.load_state_dict(ckpt["scheduler"])
    return ckpt
