"""K2: fused multi-head attention with attention-weight dropout, forward
and backward, in CUDA for Hopper.

Replaces the TPU kernels of ``fused_attention_bse_dropout``
(cris_tpu/ops/pallas/attention_train.py:185; forward ``pallas_call`` :218,
backward :248). The CUDA source is
``cris_tpu_torch/csrc/attention_bse_dropout.cu``; its header says how it
is laid out and what bounds it on the card. The keep mask is Philox4x32-10
keyed on (seed, batch, head, query row, key column)
(``dropout_mask.py``); kernel and plain version draw the same bits.

``fused_attention_bse_dropout`` takes the plain version for a tensor on
the CPU and launches the kernels for a CUDA tensor (or raises); it never
falls back. On CUDA it is a ``torch.autograd.Function`` whose backward
launches the backward kernels. It saves q, k, v, the key mask, the output
O and the row log-sum-exp, and the seed: the JAX rule saves only q, k, v,
the mask and the seed and recomputes everything, while the port keeps O
(for rowsum(dO o O)) and the log-sum-exp (for P without a second softmax
pass), (B, S, E) + (B, H, S) f32 per site. ``.launches`` on
``fused_attention_bse_dropout`` counts forward launches and
``attention_dropout_backward.launches`` backward launches.
"""

from __future__ import annotations

from typing import Optional

import torch

from .attention import (DTYPE_CODES, NEG_INF, _rows, check_cuda_inputs,
                        merge_heads, split_heads)
from .build import check, load_library
from .dropout_mask import keep_mask, keep_threshold, seed_words


def attention_dropout_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    num_heads: int,
    kv_valid: Optional[torch.Tensor] = None,
    rate: float = 0.0,
    seed: int = 0,
    attn_mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Plain PyTorch attention with inverted dropout on the weights.

    The JAX XLA path (cris_tpu/ops/attention.py:106-131): f32 logits
    scaled by head_dim**-0.5, optional additive ``attn_mask``, masked keys
    set to NEG_INF, f32 softmax, ``weights * keep / (1 - rate)`` with the
    materialised Philox keep mask, weights cast to v's dtype, f32
    accumulation, output in q's dtype. Autocast is off inside; autograd is
    its backward."""
    d = q.shape[-1] // num_heads
    threshold = keep_threshold(rate)
    with torch.autocast(q.device.type, enabled=False):
        qh = split_heads(q, num_heads).float()
        kh = split_heads(k, num_heads).float()
        vh = split_heads(v, num_heads)
        logits = torch.matmul(qh, kh.transpose(-1, -2)) * (d ** -0.5)
        if attn_mask is not None:
            logits = logits + attn_mask.float()
        if kv_valid is not None:
            logits = logits.masked_fill(~kv_valid.bool()[:, None, None, :], NEG_INF)
        weights = torch.softmax(logits, dim=-1)
        if threshold:
            b, h, s, t = weights.shape
            keep = keep_mask(seed, b, h, s, t, rate, weights.device)
            weights = weights * keep / (1.0 - rate)
        out = torch.matmul(weights.to(vh.dtype).float(), vh.float())
    return merge_heads(out.to(q.dtype))


def _scalars(d, rate, seed):
    seed_lo, seed_hi = seed_words(seed)
    return (float(d ** -0.5), float(1.0 / (1.0 - rate)), keep_threshold(rate),
            seed_lo, seed_hi)


def attention_dropout_forward(q, k, v, num_heads, kv_valid, rate, seed):
    """(out, row log-sum-exp (B, H, S) f32, kv_valid as contiguous uint8 or
    None) from the forward kernel, for CUDA tensors."""
    b, s, t, d, kv_valid = check_cuda_inputs(
        q, k, v, num_heads, kv_valid, "fused_attention_bse_dropout")
    strides = (*_rows(q, "q"), *_rows(k, "k"), *_rows(v, "v"))
    lib = load_library()
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    lse = torch.empty((b, num_heads, s), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.cris_attention_dropout_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            None if kv_valid is None else kv_valid.data_ptr(),
            out.data_ptr(), lse.data_ptr(), b, s, t, num_heads, d,
            DTYPE_CODES[q.dtype], *strides,
            *_scalars(d, rate, seed), stream,
        )
    check(lib, err, "fused_attention_bse_dropout")
    fused_attention_bse_dropout.launches += 1
    return out, lse, kv_valid


def attention_dropout_backward(q, k, v, num_heads, kv_valid, rate, seed,
                               out, lse, g):
    """(dq, dk, dv) from the backward kernels, for CUDA tensors saved by
    the forward (``kv_valid`` as contiguous uint8 or None)."""
    b, s, t, d, kv_valid = check_cuda_inputs(
        q, k, v, num_heads, kv_valid, "attention_dropout_backward")
    if g.shape != q.shape or g.dtype != q.dtype:
        raise ValueError(f"output gradient {tuple(g.shape)} {g.dtype} does "
                         f"not match q {tuple(q.shape)} {q.dtype}")
    g = g.contiguous()
    strides = (*_rows(q, "q"), *_rows(k, "k"), *_rows(v, "v"))
    lib = load_library()
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    dk = torch.empty(k.shape, dtype=k.dtype, device=q.device)
    dv = torch.empty(v.shape, dtype=v.dtype, device=q.device)
    delta = torch.empty((b, num_heads, s), dtype=torch.float32,
                        device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.cris_attention_dropout_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            None if kv_valid is None else kv_valid.data_ptr(),
            out.data_ptr(), lse.data_ptr(), g.data_ptr(), delta.data_ptr(),
            dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), b, s, t, num_heads,
            d, DTYPE_CODES[q.dtype], *strides,
            *_scalars(d, rate, seed), stream,
        )
    check(lib, err, "attention_dropout_backward")
    attention_dropout_backward.launches += 1
    return dq, dk, dv


attention_dropout_backward.launches = 0


class _FusedAttentionDropout(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, num_heads, kv_valid, rate, seed):
        out, lse, kv_valid = attention_dropout_forward(
            q, k, v, num_heads, kv_valid, rate, seed)
        ctx.num_heads, ctx.rate, ctx.seed = num_heads, rate, seed
        ctx.save_for_backward(q, k, v, kv_valid, out, lse)
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, kv_valid, out, lse = ctx.saved_tensors
        dq, dk, dv = attention_dropout_backward(
            q, k, v, ctx.num_heads, kv_valid, ctx.rate, ctx.seed, out, lse, g)
        return dq, dk, dv, None, None, None, None


def fused_attention_bse_dropout(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    num_heads: int,
    kv_valid: Optional[torch.Tensor],
    rate: float,
    seed: int,
) -> torch.Tensor:
    """Multi-head attention over (B, S, E) with inverted dropout at
    ``rate`` on the normalised weights, the keep mask drawn from ``seed``
    (an int in [0, 2**63)). Differentiable in q, k and v; the same seed
    gives the same mask in the forward and the backward."""
    keep_threshold(rate)
    seed_words(seed)
    if q.device.type == "cpu":
        return attention_dropout_plain(q, k, v, num_heads, kv_valid, rate,
                                       seed)
    return _FusedAttentionDropout.apply(q, k, v, num_heads, kv_valid,
                                        float(rate), int(seed))


fused_attention_bse_dropout.launches = 0
