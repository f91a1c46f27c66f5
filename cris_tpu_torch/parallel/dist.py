"""Data-parallel processes (counterpart of cris_tpu/parallel/mesh.py and
``maybe_init_distributed``, cris_tpu/cli.py:29-57).

The JAX package runs one program over a ('data', 'model') mesh and lets
XLA insert the collectives. Here each data-parallel rank is a process,
started by ``torchrun`` (or any launcher that sets its environment:
``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT`` and, on the
card, ``LOCAL_RANK``), and the collectives are explicit:

- ``init_distributed`` joins the process group: NCCL on the card, gloo on
  the CPU, or the backend the caller names. A rendezvous or a backend
  that fails raises; nothing carries on as a single process.
- ``data_parallel_size`` checks ``dp_size`` and ``tp_size`` against the
  world as ``make_mesh`` does; tensor parallel is not ported.
- ``data_parallel`` wraps the training model in DistributedDataParallel,
  which averages the gradients over the ranks in the backward.
- ``all_reduce_sum`` sums a tensor over the ranks, differentiably (the
  synced BatchNorm's statistics); ``barrier``, ``broadcast_int`` and
  ``allgather_floats`` serve the seed, the checkpoints and the
  evaluator's gather.

Without a process group (one process, no launcher) every function here
is the identity or a no-op and nothing is communicated. A process group
of one rank communicates nothing either.
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence

import torch
import torch.distributed as dist

_LAUNCH_ENV = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")


def process_index() -> int:
    """This process's rank (0 without a process group)."""
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    """The number of ranks (1 without a process group)."""
    return dist.get_world_size() if dist.is_initialized() else 1


def local_process_count() -> int:
    """Ranks on this host, as the launcher says (``LOCAL_WORLD_SIZE``)."""
    return int(os.environ.get("LOCAL_WORLD_SIZE", "1"))


def init_distributed(device, backend: Optional[str] = None) -> torch.device:
    """Join the launcher's process group when its environment names one,
    and return this rank's device: ``cuda:{LOCAL_RANK}`` for a ``device``
    of "cuda" without an index, else ``device`` as given. Without the
    launcher's environment (no ``WORLD_SIZE``) it returns ``device`` and
    joins nothing. ``backend`` defaults to "nccl" on the card and "gloo"
    on the CPU; "gloo" puts several ranks on one card, which NCCL
    refuses. Raises when the environment is incomplete, the backend is
    not available or the rendezvous fails."""
    device = torch.device(device)
    if "WORLD_SIZE" not in os.environ:
        return device
    missing = [k for k in _LAUNCH_ENV if k not in os.environ]
    if missing:
        raise RuntimeError(f"WORLD_SIZE is set but not {missing}: start the "
                           "ranks with torchrun")
    if dist.is_initialized():
        raise RuntimeError("the process group is already initialised")
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    if device.type == "cuda":
        if device.index is None:
            device = torch.device("cuda", int(os.environ.get("LOCAL_RANK",
                                                             "0")))
        torch.cuda.set_device(device)
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    dist.init_process_group(backend, init_method="env://", rank=rank,
                            world_size=world)
    return device


def close_distributed() -> None:
    """Leave the process group, if this process joined one."""
    if dist.is_initialized():
        dist.destroy_process_group()


def data_parallel_size(dp_size: int = -1, tp_size: int = 1,
                       world: Optional[int] = None) -> int:
    """The data-parallel size for ``world`` ranks (the process group's by
    default), checked as ``make_mesh`` checks its ('data', 'model') grid:
    ``dp_size`` -1 (or 0, None) takes every rank, else dp x tp must equal
    the world. ``tp_size`` > 1 raises: tensor parallel is not ported."""
    world = process_count() if world is None else int(world)
    tp_size = max(1, int(tp_size or 1))
    if tp_size > 1:
        raise NotImplementedError(
            f"tp_size {tp_size}: tensor parallel is not ported to the "
            "PyTorch package yet (ROADMAP.md §1 item 10); use tp_size 1")
    if dp_size in (-1, 0, None):
        return world
    if int(dp_size) * tp_size != world:
        raise ValueError(f"dp={dp_size} x tp={tp_size} != {world} processes")
    return int(dp_size)


def data_parallel(model: torch.nn.Module) -> torch.nn.Module:
    """``model`` under DistributedDataParallel when there is more than one
    rank, else ``model`` itself. Gradients are averaged over the ranks in
    the backward (so the clip in ``apply_gradients`` sees the global
    gradient); buffers are not broadcast, since the synced BatchNorm keeps
    its running statistics equal on every rank. The parameters the loss
    never reaches (the model's ``unreached_params`` names) are left to
    ``apply_gradients``' zero fill on every rank instead of the reducer,
    which would wait for them."""
    if process_count() == 1:
        return model
    from torch.nn.parallel import DistributedDataParallel

    DistributedDataParallel._set_params_and_buffers_to_ignore_for_model(
        model, list(getattr(model, "unreached_params", ())))
    device = next(model.parameters()).device
    return DistributedDataParallel(
        model, device_ids=[device] if device.type == "cuda" else None,
        broadcast_buffers=False)


def _comm_device() -> torch.device:
    """Where the host's small collectives run: the card under NCCL, which
    takes CUDA tensors only, else the CPU."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        out = x.clone()
        dist.all_reduce(out)
        return out

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g)
        return g


def all_reduce_sum(x: torch.Tensor) -> torch.Tensor:
    """The sum of ``x`` over the ranks, on every rank; the gradient flows
    back through it (summed over the ranks in turn)."""
    if process_count() == 1:
        return x
    return _AllReduceSum.apply(x)


def barrier() -> None:
    """Every rank waits here for the others."""
    if process_count() > 1:
        dist.barrier()


def broadcast_int(value: int, src: int = 0) -> int:
    """Rank ``src``'s ``value`` on every rank."""
    if process_count() == 1:
        return int(value)
    t = torch.tensor([int(value)], dtype=torch.int64, device=_comm_device())
    dist.broadcast(t, src)
    return int(t.item())


def allgather_floats(values: Sequence[float]) -> List[List[float]]:
    """Every rank's list of floats, in rank order, on every rank; the
    lists may differ in length. The lengths are summed into a (world,)
    vector, then each list, padded to the longest, into its row of a
    (world, longest) float64 matrix: a sum with zeros, so every value
    arrives exactly, on any backend."""
    if process_count() == 1:
        return [[float(v) for v in values]]
    rank, world, dev = process_index(), process_count(), _comm_device()
    counts = torch.zeros(world, dtype=torch.int64, device=dev)
    counts[rank] = len(values)
    dist.all_reduce(counts)
    counts = counts.tolist()
    rows = torch.zeros(world, max(max(counts), 1), dtype=torch.float64,
                       device=dev)
    rows[rank, :len(values)] = torch.as_tensor(values, dtype=torch.float64)
    dist.all_reduce(rows)
    rows = rows.cpu()
    return [rows[r, :n].tolist() for r, n in enumerate(counts)]
