"""Tensor parallel over the grid's model group (counterpart of
cris_tpu/parallel/mesh.py:87-143).

The JAX package states which parameters shard over its 'model' axis and
lets GSPMD partition the program. Here the same rules (``TP_RULES``, over
the port's CRIS.pytorch keys) decide which parameters a rank holds a
slice of, and the layers below write each collective themselves, in the
Megatron form: a column-parallel layer takes its input through
``copy_to_model`` (the identity forward, a sum over the model group
backward) and gives a slice of the output columns; a row-parallel layer
takes such a slice and sums its partial product over the model group
(``reduce_from_model``: the sum forward, the identity backward) before it
adds its bias, once. Every model rank then holds the same activations,
and the replicated parameters the same gradients, as one process on the
model group's batch; ``sync_replicated_grads_`` gives every rank the
group's first rank's copy of the latter, so that bits the card's backward
does not reproduce cannot make the replicas part.

Parameters are always initialised or loaded full and then sliced
(``shard_state_dict``), and gathered full again to be saved
(``gather_state_dict``), so one ``.pth`` format serves every layout. A
rule shards a dimension only where the model group divides it, as
``make_param_shardings`` falls back to replication. The packed attention
projection ``in_proj_*`` holds q, k and v as three row blocks: a rank
takes its rows of each block (``Shard.blocks`` 3), not a third of the
tensor.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Dict, Iterable, Mapping, Optional, Sequence

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from .dist import Grid, all_gather, all_reduce_sum


@dataclasses.dataclass(frozen=True)
class Shard:
    """A parameter split over the model group along ``dim``, in each of
    its ``blocks`` equal blocks along that dim."""

    dim: int
    blocks: int = 1


_LAYER = r"^decoder\.layers\.\d+\."
_TEXT = r"^backbone\.transformer\.resblocks\.\d+\.mlp\."

# (regex over a port key, its shard), one for each rule of mesh.py's
# _TP_RULES; a torch Linear's weight is (out, in), so a JAX kernel's
# column split (its out features) is the torch weight's dim 0
TP_RULES = (
    # decoder FFN: fc1 (ffn.0) by output, its LayerNorm (ffn.3), fc2
    # (ffn.4) by input
    (_LAYER + r"ffn\.0\.(weight|bias)$", Shard(0)),
    (_LAYER + r"ffn\.3\.(weight|bias)$", Shard(0)),
    (_LAYER + r"ffn\.4\.weight$", Shard(1)),
    # decoder attention: q/k/v by output (heads), out_proj by input
    (_LAYER + r"(self_attn|multihead_attn)\.in_proj_(weight|bias)$",
     Shard(0, 3)),
    (_LAYER + r"(self_attn|multihead_attn)\.out_proj\.weight$", Shard(1)),
    # CLIP text transformer MLP
    (_TEXT + r"c_fc\.(weight|bias)$", Shard(0)),
    (_TEXT + r"c_proj\.weight$", Shard(1)),
    # projector kernel generator: (C*k*k+1, word_dim) by output
    (r"^proj\.txt\.(weight|bias)$", Shard(0)),
    # token embedding: the vocab axis
    (r"^backbone\.token_embedding\.weight$", Shard(0)),
)


def param_spec(name: str, shape: Sequence[int], tp: int) -> Optional[Shard]:
    """The shard of parameter ``name`` of ``shape`` over ``tp`` model
    ranks, or None (replicated): the first rule that matches, where the
    model group divides each block of its dimension, as
    ``make_param_shardings`` verifies divisibility (mesh.py:129-143)."""
    if tp <= 1:
        return None
    for pattern, spec in TP_RULES:
        if re.search(pattern, name):
            if spec.dim >= len(shape):
                return None
            n = shape[spec.dim]
            if n % spec.blocks or (n // spec.blocks) % tp:
                return None
            return spec
    return None


def make_plan(shapes: Mapping[str, Sequence[int]], tp: int
              ) -> Dict[str, Shard]:
    """{name: Shard} of the parameters of full ``shapes`` that shard over
    ``tp`` model ranks; every other name is replicated."""
    plan = {}
    for name, shape in shapes.items():
        spec = param_spec(name, tuple(shape), tp)
        if spec is not None:
            plan[name] = spec
    return plan


def shard_tensor(full: torch.Tensor, spec: Shard, tp: int,
                 rank: int) -> torch.Tensor:
    """Model rank ``rank``'s slice of ``full``: its ``1 / tp`` of each of
    the spec's blocks along its dim, concatenated (a copy)."""
    return torch.cat([block.chunk(tp, spec.dim)[rank]
                      for block in full.chunk(spec.blocks, spec.dim)],
                     spec.dim).clone()


def gather_tensor(local: torch.Tensor, spec: Shard, grid: Grid
                  ) -> torch.Tensor:
    """The full tensor of the model group's slices of it (a collective
    over the model group; the inverse of ``shard_tensor``, exactly)."""
    return torch.cat([all_gather(block, grid.model_group, spec.dim)
                      for block in local.chunk(spec.blocks, spec.dim)],
                     spec.dim)


def shard_state_dict(full: Mapping[str, torch.Tensor], grid: Grid,
                     plan: Optional[Mapping[str, Shard]] = None
                     ) -> Dict[str, torch.Tensor]:
    """This model rank's state of a full state_dict: the planned entries
    sliced (``plan`` defaults to ``make_plan`` of ``full``'s shapes), the
    rest as they are."""
    if plan is None:
        plan = make_plan({k: v.shape for k, v in full.items()},
                         grid.model_size)
    return {k: (shard_tensor(v, plan[k], grid.model_size, grid.model_rank)
                if k in plan else v) for k, v in full.items()}


def gather_state_dict(local: Mapping[str, torch.Tensor], grid: Grid,
                      plan: Mapping[str, Shard]) -> Dict[str, torch.Tensor]:
    """The full state_dict of the model group's local ones (a collective
    over the model group, in ``local``'s key order on every rank): the
    planned entries gathered, the rest as they are."""
    return {k: gather_tensor(v, plan[k], grid) if k in plan else v
            for k, v in local.items()}


def _unwrapped(model: nn.Module) -> nn.Module:
    return getattr(model, "module", model)  # DistributedDataParallel's


def full_state_dict(model: nn.Module) -> Dict[str, torch.Tensor]:
    """The state_dict of the whole model, gathered over the model group
    when ``model`` (or the model DistributedDataParallel wraps) is
    sharded: a collective for every rank of the group."""
    model = _unwrapped(model)
    plan = getattr(model, "tp_plan", None)
    if not plan:
        return model.state_dict()
    return gather_state_dict(model.state_dict(), model.tp_grid, plan)


def load_full_state_dict(model: nn.Module, full: Mapping[str, torch.Tensor],
                         strict: bool = True):
    """Load a full state_dict into ``model``, each sharded parameter
    taking its slice; ``load_state_dict``'s result."""
    model = _unwrapped(model)
    plan = getattr(model, "tp_plan", None)
    if plan:
        full = shard_state_dict(full, model.tp_grid, plan)
    return model.load_state_dict(full, strict=strict)


def _optimizer_plan(optimizer, model: nn.Module) -> Dict[int, Shard]:
    """{index in ``optimizer.state_dict()``: Shard} of the sharded
    parameters the optimizer steps."""
    model = _unwrapped(model)
    plan = getattr(model, "tp_plan", None) or {}
    names = {id(p): n for n, p in model.named_parameters()}
    params = [p for group in optimizer.param_groups for p in group["params"]]
    return {i: plan[names[id(p)]] for i, p in enumerate(params)
            if names.get(id(p)) in plan}


def _map_moments(state: Mapping, specs: Mapping[int, Shard], fn) -> dict:
    """``optimizer.state_dict()`` with ``fn(tensor, spec)`` applied to the
    per-parameter tensors (Adam's moments; not its 0-dim step) of the
    sharded parameters, in index order."""
    out = dict(state)
    out["state"] = {
        i: ({k: fn(v, specs[i]) if torch.is_tensor(v) and v.dim() else v
             for k, v in st.items()} if i in specs else st)
        for i, st in sorted(state["state"].items())}
    return out


def full_optimizer_state(optimizer, model: nn.Module) -> dict:
    """``optimizer.state_dict()`` with the moments of the sharded
    parameters gathered full over the model group (a collective), so that
    the state loads into any layout."""
    specs = _optimizer_plan(optimizer, model)
    if not specs:
        return optimizer.state_dict()
    grid = _unwrapped(model).tp_grid
    return _map_moments(optimizer.state_dict(), specs,
                        lambda v, spec: gather_tensor(v, spec, grid))


def shard_optimizer_state(full: Mapping, optimizer, model: nn.Module) -> dict:
    """A full optimizer state (``full_optimizer_state``'s, or one
    process's) with the moments of the sharded parameters sliced for
    this model rank."""
    specs = _optimizer_plan(optimizer, model)
    if not specs:
        return dict(full)
    grid = _unwrapped(model).tp_grid
    return _map_moments(full, specs, lambda v, spec: shard_tensor(
        v, spec, grid.model_size, grid.model_rank))


# ----------------------------------------------------------- collectives

def _sum_over(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``x`` over ``group``, a new tensor; 16-bit floats are
    summed in f32 and rounded once."""
    y = x.float() if x.dtype in (torch.float16, torch.bfloat16) else x.clone()
    dist.all_reduce(y, group=group)
    return y.to(x.dtype)


def _local_columns(x: torch.Tensor, grid: Grid) -> torch.Tensor:
    return x.chunk(grid.model_size, -1)[grid.model_rank].contiguous()


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, grid):
        ctx.grid = grid
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _sum_over(g, ctx.grid.model_group), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, grid):
        return _sum_over(x, grid.model_group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, grid):
        ctx.grid = grid
        return all_gather(x, grid.model_group, -1)

    @staticmethod
    def backward(ctx, g):
        return _local_columns(g, ctx.grid), None


class _ScatterToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, grid):
        ctx.grid = grid
        return _local_columns(x, grid)

    @staticmethod
    def backward(ctx, g):
        return all_gather(g.contiguous(), ctx.grid.model_group, -1), None


def copy_to_model(x: torch.Tensor, grid: Grid) -> torch.Tensor:
    """A replicated input entering column-parallel work: the identity;
    its gradient, partial on each model rank, is summed over the group."""
    return _CopyToModel.apply(x, grid)


def reduce_from_model(x: torch.Tensor, grid: Grid) -> torch.Tensor:
    """Partial results summed over the model group, on every rank; the
    gradient of the replicated sum passes unchanged."""
    return _ReduceFromModel.apply(x, grid)


def gather_from_model(x: torch.Tensor, grid: Grid) -> torch.Tensor:
    """Each rank's last-dim columns concatenated in model-rank order; the
    gradient is sliced back to this rank's columns."""
    return _GatherFromModel.apply(x, grid)


def scatter_to_model(x: torch.Tensor, grid: Grid) -> torch.Tensor:
    """This rank's slice of a replicated tensor's last-dim columns; the
    gradients of the slices are gathered."""
    return _ScatterToModel.apply(x, grid)


# --------------------------------------------------------------- layers

def shard_parameter(param: nn.Parameter, spec: Shard, grid: Grid
                    ) -> nn.Parameter:
    """This rank's slice of a full parameter, as a parameter marked with
    its ``tp_shard`` and ``tp_grid`` (the step reads them: ``split_grid``)."""
    out = nn.Parameter(shard_tensor(param.data, spec, grid.model_size,
                                    grid.model_rank),
                       requires_grad=param.requires_grad)
    out.tp_shard, out.tp_grid = spec, grid
    return out


def split_grid(params: Iterable[torch.Tensor]) -> Optional[Grid]:
    """The grid of the model group that ``params`` are split over, or None
    when none of them is a slice (a model that is whole)."""
    return next((p.tp_grid for p in params
                 if getattr(p, "tp_shard", None) is not None), None)


class ColumnParallelLinear(nn.Linear):
    """A Linear holding this model rank's output features (weight and
    bias rows); the input enters through ``copy_to_model``. With
    ``gather`` the output columns are gathered to the full width on every
    rank, else each rank keeps its slice."""

    def __init__(self, full: nn.Linear, grid: Grid, gather: bool = False):
        super().__init__(full.in_features,
                         full.out_features // grid.model_size,
                         bias=full.bias is not None, device="meta")
        self.grid, self.gather = grid, gather
        self.weight = shard_parameter(full.weight, Shard(0), grid)
        if full.bias is not None:
            self.bias = shard_parameter(full.bias, Shard(0), grid)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = super().forward(copy_to_model(x, self.grid))
        return gather_from_model(y, self.grid) if self.gather else y


class RowParallelLinear(nn.Linear):
    """A Linear holding this model rank's input features (weight
    columns) and the full bias: the partial products are summed over the
    model group, then the bias is added once."""

    def __init__(self, full: nn.Linear, grid: Grid):
        super().__init__(full.in_features // grid.model_size,
                         full.out_features, bias=full.bias is not None,
                         device="meta")
        self.grid = grid
        self.weight = shard_parameter(full.weight, Shard(1), grid)
        if full.bias is not None:
            self.bias = nn.Parameter(full.bias.data.clone(),
                                     requires_grad=full.bias.requires_grad)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = reduce_from_model(F.linear(x, self.weight), self.grid)
        return y if self.bias is None else y + self.bias.to(y.dtype)


class VocabParallelEmbedding(nn.Embedding):
    """An Embedding holding this model rank's rows of the vocabulary: ids
    outside them give zero rows, and the rows are summed over the model
    group, so every id gets its one row exactly."""

    def __init__(self, full: nn.Embedding, grid: Grid):
        super().__init__(full.num_embeddings // grid.model_size,
                         full.embedding_dim, device="meta")
        self.grid = grid
        self.start = grid.model_rank * self.num_embeddings
        self.weight = shard_parameter(full.weight, Shard(0), grid)

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        local = ids - self.start
        outside = (local < 0) | (local >= self.num_embeddings)
        rows = F.embedding(local.masked_fill(outside, 0), self.weight)
        rows = rows.masked_fill(outside[..., None], 0.0)
        return reduce_from_model(rows, self.grid)


class ShardedLayerNormF32(nn.LayerNorm):
    """``models.layers.LayerNormF32`` over a last dim split across the
    model group: this rank's columns of the input, scale and bias; the
    row mean and then the centred sum of squares are summed over the
    group in f32, so each row is normalised by the statistics of its full
    width, with ``F.layer_norm``'s biased variance and eps; cast back to
    the input dtype."""

    def __init__(self, full: nn.LayerNorm, grid: Grid):
        width = full.normalized_shape[-1]
        super().__init__(width // grid.model_size, eps=full.eps,
                         device="meta")
        self.grid, self.width = grid, width
        self.weight = shard_parameter(full.weight, Shard(0), grid)
        self.bias = shard_parameter(full.bias, Shard(0), grid)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        group = self.grid.model_group
        with torch.autocast(x.device.type, enabled=False):
            x32 = x.float()
            mean = all_reduce_sum(x32.sum(-1, keepdim=True),
                                  group) / self.width
            xc = x32 - mean
            var = all_reduce_sum(xc.square().sum(-1, keepdim=True),
                                 group) / self.width
            y = xc * torch.rsqrt(var + self.eps)
            y = y * self.weight.float() + self.bias.float()
        return y.to(x.dtype)


class ColumnDropout(nn.Module):
    """``models.layers.Dropout`` on this model rank's columns of a
    tensor whose last dim is split over the group: the full mask is drawn
    from the generator, as one process draws it, and this rank keeps its
    columns, so every rank's generator stays in step."""

    def __init__(self, p: float, grid: Grid):
        super().__init__()
        self.p, self.grid = float(p), grid

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        if not self.training or self.p == 0.0:
            return x
        shape = x.shape[:-1] + (x.shape[-1] * self.grid.model_size,)
        rand = torch.rand(shape, generator=generator, device=x.device)
        keep = _local_columns(rand, self.grid) >= self.p
        return torch.where(keep, x / (1.0 - self.p), torch.zeros_like(x))


def sync_replicated_grads_(params: Iterable[torch.Tensor],
                           grid: Grid) -> None:
    """Give every model rank the replicated parameters' gradients of the
    model group's first rank, in one broadcast of their concatenation.
    Every rank computes them from the same values, but the card's
    backward is not bitwise reproducible (atomics in cuDNN's and
    interpolate's backward), and replicas stepped with gradients that
    differ in their last bits would part; with one rank's bits on every
    rank they stay one model, at any tp (an average over the group would
    round where tp is not a power of two, even where every rank holds
    the same gradient). A grid of one model rank returns at once."""
    if grid.model_size == 1:
        return
    grads = [p.grad for p in params if p.grad is not None
             and getattr(p, "tp_shard", None) is None]
    if not grads:
        return
    flat = torch.cat([g.reshape(-1).float() for g in grads])
    # the model group's first rank: grid[d, 0] is global rank d * tp
    dist.broadcast(flat, src=grid.data_rank * grid.model_size,
                   group=grid.model_group)
    for g, part in zip(grads, flat.split([g.numel() for g in grads])):
        g.copy_(part.view_as(g))


def clip_global_norm_(params: Iterable[torch.Tensor], max_norm: float,
                      grid: Grid) -> torch.Tensor:
    """``clip_grad_norm_`` by the norm of the whole model's gradient:
    the squares of the sharded parameters' gradients summed over the
    model group, those of the replicated ones counted once. Returns that
    norm."""
    params = [p for p in params if p.grad is not None]
    grads = [p.grad for p in params]
    zero = grads[0].new_zeros((), dtype=torch.float32)

    def squares(sharded: bool) -> torch.Tensor:
        return sum((torch.linalg.vector_norm(p.grad.float()).square()
                    for p in params
                    if (getattr(p, "tp_shard", None) is not None) == sharded),
                   zero)

    total = torch.sqrt(all_reduce_sum(squares(True), grid.model_group)
                       + squares(False))
    coef = torch.clamp(max_norm / (total + 1e-6), max=1.0)
    torch._foreach_mul_(grads, coef)
    return total
