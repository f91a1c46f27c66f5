"""Vision-language transformer decoder (counterpart of
cris_tpu/models/decoder.py:31-191).

The 676 visual tokens self-attend with fixed 2-D sincos positions, then
cross-attend to the word features (1-D sincos positions on the keys,
key-padding mask from token id 0), then pass an FFN with an internal
LayerNorm; each sublayer is pre-LN with an extra LayerNorm before the
residual add. Both attention sites go through K1.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import dot_product_attention
from ..ops.posenc import sincos_1d, sincos_2d
from .layers import LayerNormF32


class MultiheadAttention(nn.Module):
    """torch ``nn.MultiheadAttention``'s parameters (packed
    ``in_proj_weight``/``in_proj_bias``, ``out_proj``), so state_dict keys
    match CRIS.pytorch. The forward projects q/k/v with ``F.linear`` on the
    packed slices and calls the shared attention core (K1), never
    ``nn.MultiheadAttention.forward``."""

    def __init__(self, d_model: int, num_heads: int):
        super().__init__()
        self.d_model = d_model
        self.num_heads = num_heads
        self.in_proj_weight = nn.Parameter(torch.empty(3 * d_model, d_model))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * d_model))
        self.out_proj = nn.Linear(d_model, d_model)

    def forward(self, query: torch.Tensor, key: torch.Tensor,
                value: torch.Tensor,
                key_padding_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        w, b, e = self.in_proj_weight, self.in_proj_bias, self.d_model
        q = F.linear(query, w[:e], b[:e])
        k = F.linear(key, w[e:2 * e], b[e:2 * e])
        v = F.linear(value, w[2 * e:], b[2 * e:])
        out = dot_product_attention(q, k, v, self.num_heads,
                                    key_padding_mask=key_padding_mask)
        return self.out_proj(out)


class TransformerDecoderLayer(nn.Module):
    def __init__(self, d_model: int = 512, nhead: int = 8,
                 dim_feedforward: int = 2048, dropout: float = 0.1):
        super().__init__()
        self.self_attn = MultiheadAttention(d_model, nhead)
        self.multihead_attn = MultiheadAttention(d_model, nhead)
        self.ffn = nn.Sequential(
            nn.Linear(d_model, dim_feedforward),
            nn.ReLU(True),
            nn.Dropout(dropout),
            LayerNormF32(dim_feedforward),
            nn.Linear(dim_feedforward, d_model),
        )
        self.norm1 = LayerNormF32(d_model)
        self.norm2 = LayerNormF32(d_model)
        self.norm3 = LayerNormF32(d_model)
        self.self_attn_norm = LayerNormF32(d_model)
        self.cross_attn_norm = LayerNormF32(d_model)

    def forward(self, vis: torch.Tensor, txt: torch.Tensor,
                vis_pos: torch.Tensor, txt_pos: torch.Tensor,
                pad_mask: torch.Tensor) -> torch.Tensor:
        y = self.norm1(vis)
        q = y + vis_pos
        y = self.self_attn(q, q, y)
        vis = vis + self.self_attn_norm(y)

        y = self.norm2(vis)
        y = self.multihead_attn(y + vis_pos, txt + txt_pos, txt,
                                key_padding_mask=pad_mask)
        vis = vis + self.cross_attn_norm(y)

        return vis + self.ffn(self.norm3(vis))


class TransformerDecoder(nn.Module):
    def __init__(self, num_layers: int, d_model: int, nhead: int,
                 dim_ffn: int, dropout: float):
        super().__init__()
        self.layers = nn.ModuleList([
            TransformerDecoderLayer(d_model, nhead, dim_ffn, dropout)
            for _ in range(num_layers)
        ])
        self.norm = LayerNormF32(d_model)

    def forward(self, vis: torch.Tensor, txt: torch.Tensor,
                pad_mask: torch.Tensor) -> torch.Tensor:
        """vis (B, D, H, W), txt (B, L, D), pad_mask (B, L) True = padding
        -> (B, D, H, W)."""
        b, d, h, w = vis.shape
        vis_pos = torch.from_numpy(sincos_2d(d, h, w)).to(vis.device)
        txt_pos = torch.from_numpy(sincos_1d(d, txt.shape[1])).to(vis.device)
        x = vis.flatten(2).transpose(1, 2)
        for layer in self.layers:
            x = layer(x, txt, vis_pos.to(x.dtype), txt_pos.to(x.dtype), pad_mask)
        return self.norm(x).transpose(1, 2).reshape(b, d, h, w)
