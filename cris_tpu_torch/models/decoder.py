"""Vision-language transformer decoder (counterpart of
cris_tpu/models/decoder.py:31-191).

The 676 visual tokens self-attend with fixed 2-D sincos positions, then
cross-attend to the word features (1-D sincos positions on the keys,
key-padding mask from token id 0), then pass an FFN with an internal
LayerNorm; each sublayer is pre-LN with an extra LayerNorm before the
residual add. Both attention sites go through K1, or in training with
dropout through K2.

Randomness in training: the decoder's forward takes a seed and builds
two generators from it, one on the CPU and one on the model's device.
Each attention site of each layer draws its own K2 seed from the CPU one
(no host-device sync), as ``nn.scan(split_rngs={"dropout": True})`` gives
each JAX layer its own stream; the elementwise dropouts draw their masks
from the device one. Under data parallel, where the JAX package draws
every mask over the global batch, each rank keeps the same K2 seeds and
hands K2 its first global row (data rank x local batch), so that K2 keys
each global row's mask on that row; the device generator's seed has the
data rank folded in, so that no two data ranks draw one elementwise mask
(data rank 0 and a single process keep the step's seed). Under ``remat``
a layer draws its two seeds and notes the device generator's state
before the checkpointed call, and the call restores that state, so the
recomputed forward in the backward draws the masks of the first.

Tensor parallel (``shard``, from ``models.shard_model``; the JAX
package's column split of q/k/v and row split of out_proj and the FFN,
cris_tpu/parallel/mesh.py:87-110): each rank of a model group projects
and attends over its own heads, K2 keyed on their global heads
(``head_offset``: model rank x local heads), and the row-parallel
out_proj sums the heads' contributions over the group. The FFN's fc1
and its LayerNorm hold the rank's hidden columns, its inner dropout
keeps the rank's columns of the full mask, and fc2 sums over the group.
The ranks of a model group share a data rank, hence the generators: the
residual stream's masks are one process's on every rank. Where the heads
do not divide over the group, q, k and v are gathered and the attention
runs whole on every rank (head offset 0), then each keeps its columns.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import dot_product_attention
from ..ops.kernels.dropout_mask import MAX_SEED
from ..ops.posenc import sincos_1d, sincos_2d
from ..parallel import Grid, data_rank
from ..parallel.tensor import (RowParallelLinear, Shard, copy_to_model,
                               gather_from_model, scatter_to_model,
                               shard_parameter)
from .layers import Dropout, LayerNormF32, remat

# (CPU generator for the attention seeds, device generator for the masks)
Rng = Tuple[torch.Generator, torch.Generator]


# an odd 64-bit stride (the golden ratio's): rank r's elementwise seed is
# the step seed plus r strides, mod 2**64, distinct for every rank
_RANK_STRIDE = 0x9E3779B97F4A7C15


def draw_seed(gen: torch.Generator) -> int:
    """One attention-dropout seed in [0, 2**63) from a CPU generator."""
    return int(torch.randint(0, MAX_SEED, (), generator=gen))


def dropout_rng(seed: int, device, rank: int = 0) -> Rng:
    """The decoder's generators for a step's ``seed`` on data-parallel
    rank ``rank``: the CPU one (K2's seeds, the same on every rank) from
    ``seed``, the device one (the elementwise masks) from ``seed`` with
    the rank folded in."""
    seed = int(seed)
    return (torch.Generator().manual_seed(seed),
            torch.Generator(device=device).manual_seed(
                (seed + rank * _RANK_STRIDE) % 2**64))


class MultiheadAttention(nn.Module):
    """torch ``nn.MultiheadAttention``'s parameters (packed
    ``in_proj_weight``/``in_proj_bias``, ``out_proj``), so state_dict keys
    match CRIS.pytorch. The forward projects q/k/v with ``F.linear`` on the
    packed slices and calls the shared attention core (K1, or K2 in
    training with dropout), never ``nn.MultiheadAttention.forward``."""

    tp: Optional[Grid] = None  # the model group, once ``shard`` split it

    def __init__(self, d_model: int, num_heads: int, dropout: float = 0.0):
        super().__init__()
        self.d_model = d_model
        self.num_heads = num_heads
        self.dropout = float(dropout)
        self.in_proj_weight = nn.Parameter(torch.empty(3 * d_model, d_model))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * d_model))
        self.out_proj = nn.Linear(d_model, d_model)

    def shard(self, grid: Grid) -> None:
        """Keep this model rank's rows of each of the q, k and v blocks of
        ``in_proj_*`` (its heads' columns of q, k and v) and its columns
        of ``out_proj``, which becomes row-parallel."""
        spec = Shard(0, 3)
        self.in_proj_weight = shard_parameter(self.in_proj_weight, spec, grid)
        self.in_proj_bias = shard_parameter(self.in_proj_bias, spec, grid)
        self.out_proj = RowParallelLinear(self.out_proj, grid)
        self.tp = grid

    def forward(self, query: torch.Tensor, key: torch.Tensor,
                value: torch.Tensor,
                key_padding_mask: Optional[torch.Tensor] = None,
                dropout_seed: Optional[int] = None,
                batch_offset: int = 0) -> torch.Tensor:
        grid, heads, head_offset = self.tp, self.num_heads, 0
        if grid is not None:
            same = key is query
            query = copy_to_model(query, grid)
            key = query if same else copy_to_model(key, grid)
            value = copy_to_model(value, grid)
        w, b = self.in_proj_weight, self.in_proj_bias
        e = w.shape[0] // 3  # this rank's columns of each of q, k, v
        q = F.linear(query, w[:e], b[:e])
        k = F.linear(key, w[e:2 * e], b[e:2 * e])
        v = F.linear(value, w[2 * e:], b[2 * e:])
        whole = grid is not None and heads % grid.model_size != 0
        if whole:
            q, k, v = (gather_from_model(x, grid) for x in (q, k, v))
        elif grid is not None:
            heads //= grid.model_size
            head_offset = grid.model_rank * heads
        rate = self.dropout if self.training else 0.0
        out = dot_product_attention(q, k, v, heads,
                                    key_padding_mask=key_padding_mask,
                                    dropout_rate=rate,
                                    dropout_seed=dropout_seed,
                                    batch_offset=batch_offset,
                                    head_offset=head_offset)
        if whole:
            out = scatter_to_model(out, grid)
        return self.out_proj(out)


class TransformerDecoderLayer(nn.Module):
    """``remat`` (set by ``build_segmenter`` from ``cfg.remat``): in
    training with gradients on, the layer's activations are recomputed in
    the backward (cris_tpu/models/decoder.py:165-166)."""

    remat = False

    def __init__(self, d_model: int = 512, nhead: int = 8,
                 dim_feedforward: int = 2048, dropout: float = 0.1):
        super().__init__()
        self.self_attn = MultiheadAttention(d_model, nhead, dropout)
        self.multihead_attn = MultiheadAttention(d_model, nhead, dropout)
        self.ffn = nn.Sequential(
            nn.Linear(d_model, dim_feedforward),
            nn.ReLU(True),
            Dropout(dropout),
            LayerNormF32(dim_feedforward),
            nn.Linear(dim_feedforward, d_model),
        )
        self.norm1 = LayerNormF32(d_model)
        self.norm2 = LayerNormF32(d_model)
        self.norm3 = LayerNormF32(d_model)
        self.self_attn_norm = LayerNormF32(d_model)
        self.cross_attn_norm = LayerNormF32(d_model)
        self.dropout1 = Dropout(dropout)
        self.dropout2 = Dropout(dropout)
        self.dropout3 = Dropout(dropout)

    def forward(self, vis: torch.Tensor, txt: torch.Tensor,
                vis_pos: torch.Tensor, txt_pos: torch.Tensor,
                pad_mask: torch.Tensor, rng: Optional[Rng] = None,
                batch_offset: int = 0) -> torch.Tensor:
        """rng: the decoder's generators; needed in training with dropout.
        batch_offset: the global row of batch row 0, for K2's masks."""
        seeds, gen = (None, None), None
        if rng is not None:
            seeds = (draw_seed(rng[0]), draw_seed(rng[0]))
            gen = rng[1]
        if not (self.remat and self.training and torch.is_grad_enabled()):
            return self._body(vis, txt, vis_pos, txt_pos, pad_mask, seeds, gen,
                              batch_offset)
        start = None if gen is None else gen.get_state()

        def body(vis, txt, vis_pos, txt_pos):
            if start is not None:
                gen.set_state(start)
            return self._body(vis, txt, vis_pos, txt_pos, pad_mask, seeds, gen,
                              batch_offset)

        return remat(body, vis, txt, vis_pos, txt_pos)

    def _body(self, vis, txt, vis_pos, txt_pos, pad_mask, seeds, gen,
              batch_offset):
        y = self.norm1(vis)
        q = y + vis_pos
        y = self.self_attn(q, q, y, dropout_seed=seeds[0],
                           batch_offset=batch_offset)
        vis = vis + self.dropout1(self.self_attn_norm(y), gen)

        y = self.norm2(vis)
        y = self.multihead_attn(y + vis_pos, txt + txt_pos, txt,
                                key_padding_mask=pad_mask,
                                dropout_seed=seeds[1],
                                batch_offset=batch_offset)
        vis = vis + self.dropout2(self.cross_attn_norm(y), gen)

        fc1, relu, drop, norm, fc2 = self.ffn
        y = fc2(norm(drop(relu(fc1(self.norm3(vis))), gen)))
        return vis + self.dropout3(y, gen)


class TransformerDecoder(nn.Module):
    def __init__(self, num_layers: int, d_model: int, nhead: int,
                 dim_ffn: int, dropout: float):
        super().__init__()
        self.dropout = float(dropout)
        self.layers = nn.ModuleList([
            TransformerDecoderLayer(d_model, nhead, dim_ffn, dropout)
            for _ in range(num_layers)
        ])
        self.norm = LayerNormF32(d_model)

    def forward(self, vis: torch.Tensor, txt: torch.Tensor,
                pad_mask: torch.Tensor,
                dropout_seed: Optional[int] = None) -> torch.Tensor:
        """vis (B, D, H, W), txt (B, L, D), pad_mask (B, L) True = padding
        -> (B, D, H, W). In training with dropout the masks come from
        ``dropout_seed``, which is then required; under data parallel this
        batch is rows ``data rank x B ..`` of the global batch."""
        b, d, h, w = vis.shape
        vis_pos = torch.from_numpy(sincos_2d(d, h, w)).to(vis.device)
        txt_pos = torch.from_numpy(sincos_1d(d, txt.shape[1])).to(vis.device)
        rng, offset = None, 0
        if self.training and self.dropout > 0.0:
            if dropout_seed is None:
                raise ValueError("decoder dropout in training needs a dropout_seed")
            rank = data_rank()
            rng, offset = dropout_rng(dropout_seed, vis.device, rank), rank * b
        x = vis.flatten(2).transpose(1, 2)
        for layer in self.layers:
            x = layer(x, txt, vis_pos.to(x.dtype), txt_pos.to(x.dtype),
                      pad_mask, rng, offset)
        return self.norm(x).transpose(1, 2).reshape(b, d, h, w)
