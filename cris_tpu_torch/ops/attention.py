"""Multi-head scaled dot-product attention over (B, S, E) projections.

Counterpart of ``cris_tpu.ops.attention``: the same dispatch, with K1 in
CUDA where the JAX package has its Pallas kernel. Sites without an
additive mask, with head_dim <= 128 and S, T <= 2048 (decoder self- and
cross-attention, attnpool) take ``fused_attention_bse``, which launches
the CUDA kernel for a CUDA tensor and runs its plain version on the CPU.
The causal text encoder carries an additive mask and stays on the plain
path, as it does in the JAX package. Dropout comes with the train path.
"""

from __future__ import annotations

from typing import Optional

import torch

from .kernels.attention import (MAX_HEAD_DIM, NEG_INF, attention_plain,
                                fused_attention_bse, merge_heads, split_heads)

# The JAX dispatch's length gate, kept so that both packages route the same
# sites to their kernel. It bounds the Pallas kernel's (block_q, T) logits
# buffer in VMEM; the CUDA kernel streams 64-key tiles and has no such
# limit, so a later PR may lift it for CUDA tensors.
MAX_FUSED_LEN = 2048

__all__ = ["NEG_INF", "causal_mask", "dot_product_attention", "merge_heads",
           "split_heads"]


def dot_product_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    num_heads: int,
    attn_mask: Optional[torch.Tensor] = None,
    key_padding_mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Attention over projected q (B, S, E) and k/v (B, T, E).

    attn_mask: additive (S, T) float mask (the causal mask).
    key_padding_mask: (B, T) bool, True = ignore that key.
    Softmax is computed in float32 whatever the input dtype."""
    head_dim = q.shape[-1] // num_heads
    kv_valid = None if key_padding_mask is None else ~key_padding_mask
    if (attn_mask is None and head_dim <= MAX_HEAD_DIM
            and q.shape[1] <= MAX_FUSED_LEN and k.shape[1] <= MAX_FUSED_LEN):
        return fused_attention_bse(q, k, v, num_heads, kv_valid)
    return attention_plain(q, k, v, num_heads, kv_valid, attn_mask)


def causal_mask(length: int, device=None, dtype=torch.float32) -> torch.Tensor:
    """Additive causal mask: 0 on and below the diagonal, NEG_INF above."""
    mask = torch.full((length, length), NEG_INF, device=device, dtype=dtype)
    return torch.triu(mask, diagonal=1)
