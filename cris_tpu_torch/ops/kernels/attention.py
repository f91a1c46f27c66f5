"""K1: fused multi-head attention over (B, S, E), in CUDA for Hopper.

Replaces the TPU kernel ``fused_attention_bse``
(cris_tpu/ops/pallas/attention.py:165, body ``_attn_bse_kernel`` at :132).
The CUDA source is ``cris_tpu_torch/csrc/attention_bse.cu``; its header
says how it is laid out and what bounds it on the card: this first
version computes both products with f32 FMAs on the CUDA cores, so it is
bound by FMA issue and shared-memory reads rather than by device memory.

``fused_attention_bse`` takes the plain version for a tensor on the CPU
and launches the kernel for a CUDA tensor (or raises); it never falls
back. ``fused_attention_bse.launches`` counts kernel launches.
"""

from __future__ import annotations

from typing import Optional

import torch

from .build import check, load_library

NEG_INF = -1e30  # finite: a fully masked row averages V instead of NaN
MAX_HEAD_DIM = 128  # the kernel runs any head dim from 1 to this
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def split_heads(x: torch.Tensor, num_heads: int) -> torch.Tensor:
    """(B, S, E) -> (B, num_heads, S, head_dim)."""
    b, s, e = x.shape
    return x.reshape(b, s, num_heads, e // num_heads).transpose(1, 2)


def merge_heads(x: torch.Tensor) -> torch.Tensor:
    """(B, H, S, D) -> (B, S, E)."""
    b, h, s, d = x.shape
    return x.transpose(1, 2).reshape(b, s, h * d)


def attention_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    num_heads: int,
    kv_valid: Optional[torch.Tensor] = None,
    attn_mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Plain PyTorch softmax attention over (B, S, E) q and (B, T, E) k/v.

    The math of ``cris_tpu.ops.attention.dot_product_attention``'s XLA
    path: f32 logits scaled by head_dim**-0.5, an optional additive
    ``attn_mask`` (S, T), masked keys (``kv_valid`` == 0) replaced by
    NEG_INF, f32 softmax, weights cast to v's dtype, f32 accumulation,
    output in q's dtype. Autocast is off inside, so a bf16 autocast region
    around it changes nothing here."""
    d = q.shape[-1] // num_heads
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
        out = torch.matmul(weights.to(vh.dtype).float(), vh.float())
    return merge_heads(out.to(q.dtype))


def _rows(x: torch.Tensor, name: str):
    if x.dim() != 3 or x.stride(2) != 1:
        raise ValueError(f"{name} must be (B, L, E) with unit column stride")
    return x.stride(0), x.stride(1)


def fused_attention_bse(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    num_heads: int,
    kv_valid: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """softmax(q k^T / sqrt(d), masked keys = -1e30) v per head, (B, S, E).

    kv_valid: optional (B, T), nonzero = valid key. A row with every key
    masked returns mean(V) over the T keys, as the JAX XLA path's finite
    mask gives (the Pallas kernel averages over its padded key count);
    the JAX package calls such rows undefined and the model never
    produces them."""
    if q.device.type == "cpu":
        return attention_plain(q, k, v, num_heads, kv_valid)
    if q.device.type != "cuda":
        raise ValueError(f"fused_attention_bse: no kernel for {q.device}")
    b, s, e = q.shape
    t = k.shape[1]
    d = e // num_heads
    if e % num_heads or not 1 <= d <= MAX_HEAD_DIM:
        raise ValueError(f"head dim {e}/{num_heads}: need a whole number "
                         f"from 1 to {MAX_HEAD_DIM}")
    if q.dtype not in _DTYPES or not (q.dtype == k.dtype == v.dtype):
        raise ValueError(f"q/k/v dtypes {q.dtype}/{k.dtype}/{v.dtype}: need "
                         "one of float32, bfloat16 for all three")
    if k.shape != (b, t, e) or v.shape != (b, t, e) or t == 0:
        raise ValueError(f"k/v shapes {tuple(k.shape)}/{tuple(v.shape)} do "
                         f"not match q {tuple(q.shape)}")
    if not (k.device == v.device == q.device):
        raise ValueError("q, k and v must be on one device")
    valid_ptr = None
    if kv_valid is not None:
        if kv_valid.shape != (b, t):
            raise ValueError(f"kv_valid {tuple(kv_valid.shape)} != {(b, t)}")
        kv_valid = kv_valid.to(device=q.device, dtype=torch.uint8).contiguous()
        valid_ptr = kv_valid.data_ptr()
    q_sb, q_ss = _rows(q, "q")
    k_sb, k_ss = _rows(k, "k")
    v_sb, v_ss = _rows(v, "v")

    lib = load_library()
    out = torch.empty((b, s, e), dtype=q.dtype, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.cris_attention_bse(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), valid_ptr,
            out.data_ptr(), b, s, t, num_heads, d, _DTYPES[q.dtype],
            q_sb, q_ss, k_sb, k_ss, v_sb, v_ss, float(d ** -0.5), stream,
        )
    check(lib, err, "fused_attention_bse")
    fused_attention_bse.launches += 1
    return out


fused_attention_bse.launches = 0
