"""Processes over a (data, model) rank grid (counterpart of
cris_tpu/parallel/mesh.py and ``maybe_init_distributed``,
cris_tpu/cli.py:29-57).

The JAX package runs one program over a ('data', 'model') mesh and lets
XLA insert the collectives. Here each device of that mesh is a process,
started by ``torchrun`` (or any launcher that sets its environment:
``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT`` and, on the
card, ``LOCAL_RANK``), and the collectives are explicit:

- ``init_distributed`` joins the process group: NCCL on the card, gloo on
  the CPU, or the backend the caller names. A rendezvous or a backend
  that fails raises; nothing carries on as a single process.
- ``data_parallel_size`` checks ``dp_size`` and ``tp_size`` against the
  world as ``make_mesh`` does, and ``init_grid`` lays the ranks out as
  ``make_mesh`` lays out its devices: rank ``r`` is data rank ``r // tp``
  and model rank ``r % tp``, so a model group is a run of consecutive
  ranks (NVLink neighbours on one node) and a data group the ranks that
  share a model rank. ``grid()`` is this process's ``Grid``.
- ``data_parallel`` wraps the training model in DistributedDataParallel
  over the data group, which averages the gradients over it in the
  backward; its ranks hold the same shards (``parallel.tensor``).
- ``all_reduce_sum`` sums a tensor over a group (the world by default),
  differentiably (the synced BatchNorm's statistics over the data
  group); ``all_gather`` concatenates a tensor over a group;
  ``barrier``, ``broadcast_int`` and ``allgather_floats`` serve the seed,
  the checkpoints and the evaluator's gather.

Without a process group (one process, no launcher) every function here
is the identity or a no-op and nothing is communicated. A process group
of one rank, or a group of one rank within it, communicates nothing
either.
With ``tp_size`` 1 the data group is the world's own group and nothing
is split: the code path of data parallel alone.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, List, Optional, Sequence

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
    """Leave the process group, if this process joined one, and the grid."""
    global _GRID
    _GRID = None
    if dist.is_initialized():
        dist.destroy_process_group()


def data_parallel_size(dp_size: int = -1, tp_size: int = 1,
                       world: Optional[int] = None) -> int:
    """The data-parallel size for ``world`` ranks (the process group's by
    default), checked as ``make_mesh`` checks its ('data', 'model') grid:
    ``tp_size`` must divide the world; ``dp_size`` -1 (or 0, None) takes
    every rank that is left, else dp x tp must equal the world."""
    world = process_count() if world is None else int(world)
    tp_size = max(1, int(tp_size or 1))
    if world % tp_size:
        raise ValueError(f"tp_size {tp_size} does not divide {world} "
                         "processes")
    if dp_size in (-1, 0, None):
        return world // tp_size
    if int(dp_size) * tp_size != world:
        raise ValueError(f"dp={dp_size} x tp={tp_size} != {world} processes")
    return int(dp_size)


@dataclasses.dataclass(frozen=True)
class Grid:
    """This rank's place in the (data, model) grid, and its two groups
    (process groups of ``torch.distributed``). With ``model_size`` 1 both
    are None: the data group is the world's own, and nothing uses the
    model group."""

    data_rank: int = 0
    data_size: int = 1
    model_rank: int = 0
    model_size: int = 1
    data_group: Any = None
    model_group: Any = None

    def __deepcopy__(self, memo) -> "Grid":
        return self  # the groups are this process's, not a model's


_GRID: Optional[Grid] = None


def grid() -> Grid:
    """This process's grid: the one ``init_grid`` built, else every rank
    of the process group a data rank (one rank without a group)."""
    if _GRID is not None:
        return _GRID
    return Grid(data_rank=process_index(), data_size=process_count())


def init_grid(dp_size: int = -1, tp_size: int = 1) -> Grid:
    """Lay the world's ranks out as ``make_mesh`` lays out its devices
    (``grid[d, m]`` is rank ``d * tp + m``) and make this process's grid.
    Every rank creates every group, in the same order: the dp model groups
    (runs of tp consecutive ranks), then the tp data groups (ranks m, m +
    tp, ...). With ``tp_size`` 1 no group is made: the data group is the
    world's, as without a grid. Raises as ``data_parallel_size`` does."""
    global _GRID
    tp = max(1, int(tp_size or 1))
    dp = data_parallel_size(dp_size, tp)
    rank = process_index()
    if tp == 1:
        _GRID = None  # every rank a data rank of the world's group
        return grid()
    model_groups = [dist.new_group(list(range(d * tp, (d + 1) * tp)))
                    for d in range(dp)]
    data_groups = [dist.new_group(list(range(m, dp * tp, tp)))
                   for m in range(tp)]
    d, m = divmod(rank, tp)
    _GRID = Grid(data_rank=d, data_size=dp, model_rank=m, model_size=tp,
                 data_group=data_groups[m], model_group=model_groups[d])
    return _GRID


def data_rank() -> int:
    """This process's data rank: its shard of the global batch."""
    return grid().data_rank



def _group_size(group) -> int:
    return dist.get_world_size(group) if dist.is_initialized() else 1


def data_parallel(model: torch.nn.Module, group=None) -> torch.nn.Module:
    """``model`` under DistributedDataParallel over ``group`` (the world
    by default; the grid's data group under tensor parallel) when that has
    more than one rank, else ``model`` itself. Gradients are averaged over
    the group in the backward (so the clip in ``apply_gradients`` sees the
    global gradient); buffers are not broadcast, since the synced
    BatchNorm keeps its running statistics equal on every rank. The
    parameters the loss never reaches (the model's ``unreached_params``
    names) are left to ``apply_gradients``' zero fill on every rank
    instead of the reducer, which would wait for them."""
    if _group_size(group) == 1:
        return model
    from torch.nn.parallel import DistributedDataParallel

    DistributedDataParallel._set_params_and_buffers_to_ignore_for_model(
        model, list(getattr(model, "unreached_params", ())))
    device = next(model.parameters()).device
    return DistributedDataParallel(
        model, device_ids=[device] if device.type == "cuda" else None,
        broadcast_buffers=False, process_group=group)


def _comm_device() -> torch.device:
    """Where the host's small collectives run: the card under NCCL, which
    takes CUDA tensors only, else the CPU."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = x.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def all_reduce_sum(x: torch.Tensor, group=None) -> torch.Tensor:
    """The sum of ``x`` over ``group``'s ranks (the world by default), on
    every one of them; the gradient flows back through it (summed over
    the group in turn)."""
    if _group_size(group) == 1:
        return x
    return _AllReduceSum.apply(x, group)


def all_gather(x: torch.Tensor, group, dim: int = -1) -> torch.Tensor:
    """``x`` of every rank of ``group``, concatenated along ``dim`` in
    rank order, on every rank, exactly (no autograd). Under gloo a CUDA
    tensor goes through the host, as gloo's own collectives do."""
    size = _group_size(group)
    if size == 1:
        return x
    via_host = x.device.type == "cuda" and dist.get_backend(group) == "gloo"
    y = (x.cpu() if via_host else x).contiguous()
    parts = [torch.empty_like(y) for _ in range(size)]
    dist.all_gather(parts, y, group=group)
    return torch.cat(parts, dim).to(x.device)


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


def allgather_floats(values: Sequence[float],
                     group=None) -> List[List[float]]:
    """Every rank's list of floats, in rank order, on every rank of
    ``group`` (the world by default); the lists may differ in length. The
    lengths are summed into a (ranks,) vector, then each list, padded to
    the longest, into its row of a (ranks, longest) float64 matrix: a sum
    with zeros, so every value arrives exactly, on any backend."""
    world = _group_size(group)
    if world == 1:
        return [[float(v) for v in values]]
    rank, dev = dist.get_rank(group), _comm_device()
    counts = torch.zeros(world, dtype=torch.int64, device=dev)
    counts[rank] = len(values)
    dist.all_reduce(counts, group=group)
    counts = counts.tolist()
    rows = torch.zeros(world, max(max(counts), 1), dtype=torch.float64,
                       device=dev)
    rows[rank, :len(values)] = torch.as_tensor(values, dtype=torch.float64)
    dist.all_reduce(rows, group=group)
    rows = rows.cpu()
    return [rows[r, :n].tolist() for r, n in enumerate(counts)]
