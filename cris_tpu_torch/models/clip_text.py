"""CLIP text transformer (counterpart of cris_tpu/models/clip_text.py:24-154).

Pre-LN residual blocks with torch's packed attention parameters
(``attn.in_proj_weight``/``attn.in_proj_bias``/``attn.out_proj``) and
QuickGELU MLPs, a causal mask sized to the sequence, ``ln_final``, and the
EOT token's state projected by ``text_projection``. The causal mask is
additive, so this attention stays on the plain path.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import causal_mask, dot_product_attention
from .layers import LayerNormF32, QuickGELU, remat


class PackedAttention(nn.Module):
    """torch MultiheadAttention's parameters; the forward splits the packed
    projection and calls the shared attention core."""

    def __init__(self, d_model: int, n_head: int):
        super().__init__()
        self.num_heads = n_head
        self.in_proj_weight = nn.Parameter(torch.empty(3 * d_model, d_model))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * d_model))
        self.out_proj = nn.Linear(d_model, d_model)

    def forward(self, x: torch.Tensor, attn_mask=None) -> torch.Tensor:
        q, k, v = F.linear(x, self.in_proj_weight, self.in_proj_bias).chunk(3, -1)
        y = dot_product_attention(q, k, v, self.num_heads, attn_mask=attn_mask)
        return self.out_proj(y)


class ResidualAttentionBlock(nn.Module):
    """``remat`` (set by ``build_segmenter`` from ``cfg.remat``): in
    training with gradients on, the block's activations are recomputed in
    the backward (cris_tpu/models/clip_text.py:81-82)."""

    remat = False

    def __init__(self, d_model: int, n_head: int):
        super().__init__()
        self.attn = PackedAttention(d_model, n_head)
        self.ln_1 = LayerNormF32(d_model)
        self.mlp = nn.Sequential(OrderedDict([
            ("c_fc", nn.Linear(d_model, d_model * 4)),
            ("gelu", QuickGELU()),
            ("c_proj", nn.Linear(d_model * 4, d_model)),
        ]))
        self.ln_2 = LayerNormF32(d_model)

    def forward(self, x: torch.Tensor, attn_mask=None) -> torch.Tensor:
        if self.remat and self.training and torch.is_grad_enabled():
            return remat(self._body, x, attn_mask)
        return self._body(x, attn_mask)

    def _body(self, x: torch.Tensor, attn_mask=None) -> torch.Tensor:
        x = x + self.attn(self.ln_1(x), attn_mask)
        return x + self.mlp(self.ln_2(x))


class Transformer(nn.Module):
    def __init__(self, width: int, layers: int, heads: int):
        super().__init__()
        self.resblocks = nn.Sequential(
            *[ResidualAttentionBlock(width, heads) for _ in range(layers)])

    def forward(self, x: torch.Tensor, attn_mask=None) -> torch.Tensor:
        for block in self.resblocks:
            x = block(x, attn_mask)
        return x


def encode_text(m: nn.Module, text: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Token ids (B, L) -> (word features (B, L, width), state (B, embed)).

    ``m`` holds token_embedding, positional_embedding, transformer,
    ln_final and text_projection: in CLIP these sit at the top level of
    the model (``models/clip.py``), which keeps the state_dict keys."""
    seq_len = text.shape[1]
    x = m.token_embedding(text) + m.positional_embedding[:seq_len]
    x = m.transformer(x, causal_mask(seq_len, device=x.device))
    word = m.ln_final(x)
    eot = word[torch.arange(text.shape[0], device=text.device), text.argmax(-1)]
    with torch.autocast(text.device.type, enabled=False):
        state = eot.float() @ m.text_projection.float()
    return word, state.to(word.dtype)
