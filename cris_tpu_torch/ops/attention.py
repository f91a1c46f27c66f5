"""Multi-head scaled dot-product attention over (B, S, E) projections.

Counterpart of ``cris_tpu.ops.attention``: the same dispatch, with K1 and
K2 in CUDA where the JAX package has its Pallas kernels. Sites without an
additive mask, with head_dim <= 128 and S, T <= 2048 (decoder self- and
cross-attention, attnpool) take ``fused_attention_bse`` (K1), or in
training with attention dropout ``fused_attention_bse_dropout`` (K2); each
launches its CUDA kernel for a CUDA tensor and runs its plain version on
the CPU. The causal text encoder carries an additive mask and stays on
the plain path, as it does in the JAX package.
"""

from __future__ import annotations

from typing import Optional

import torch

from .kernels.attention import (MAX_HEAD_DIM, NEG_INF, attention_plain,
                                fused_attention_bse, merge_heads, split_heads)
from .kernels.attention_dropout import (attention_dropout_plain,
                                        fused_attention_bse_dropout)

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
    dropout_rate: float = 0.0,
    dropout_seed: Optional[int] = None,
    batch_offset: int = 0,
    head_offset: int = 0,
) -> torch.Tensor:
    """Attention over projected q (B, S, E) and k/v (B, T, E).

    attn_mask: additive (S, T) float mask (the causal mask).
    key_padding_mask: (B, T) bool, True = ignore that key.
    dropout_rate, dropout_seed: inverted dropout on the weights, for
    training only (the caller passes a rate only in training); the keep
    mask is drawn from the seed, an int in [0, 2**63), for global batch
    rows ``batch_offset ..`` (a data-parallel rank's first row; 0 on one
    process) and global heads ``head_offset ..`` (a tensor-parallel rank's
    first head; 0 on one process).
    Softmax is computed in float32 whatever the input dtype."""
    head_dim = q.shape[-1] // num_heads
    kv_valid = None if key_padding_mask is None else ~key_padding_mask
    # The JAX dispatch also asks the dropout kernel's ``supports_shape``
    # (attention_train.py:155), which encodes the TPU's 128-lane blocks.
    # The CUDA kernel takes any head dim up to 128, as K1 does, so
    # cris_tiny's 4 x 16 heads take the XLA bernoulli path in JAX and K2
    # here.
    fused = (attn_mask is None and head_dim <= MAX_HEAD_DIM
             and q.shape[1] <= MAX_FUSED_LEN and k.shape[1] <= MAX_FUSED_LEN)
    if dropout_rate > 0.0:
        if dropout_seed is None:
            raise ValueError("attention dropout needs a dropout_seed")
        if fused:
            return fused_attention_bse_dropout(q, k, v, num_heads, kv_valid,
                                               dropout_rate, dropout_seed,
                                               batch_offset, head_offset)
        return attention_dropout_plain(q, k, v, num_heads, kv_valid,
                                       dropout_rate, dropout_seed, attn_mask,
                                       batch_offset, head_offset)
    if fused:
        return fused_attention_bse(q, k, v, num_heads, kv_valid)
    return attention_plain(q, k, v, num_heads, kv_valid, attn_mask)


def causal_mask(length: int, device=None, dtype=torch.float32) -> torch.Tensor:
    """Additive causal mask: 0 on and below the diagonal, NEG_INF above."""
    mask = torch.full((length, length), NEG_INF, device=device, dtype=dtype)
    return torch.triu(mask, diagonal=1)
