"""K3: fused softmax attention over (B, H, S, D) tensors, in CUDA for Hopper.

Replaces the TPU kernel ``fused_attention`` (cris_tpu/ops/pallas/
attention.py:57, ``pallas_call`` at :101, body ``_attn_kernel`` at :31).
It is K1's math on another layout, so it runs K1's CUDA bodies
(``cris_tpu_torch/csrc/attention_bse.cu``, entry ``cris_fused_attention``),
which address q, k, v and the output through (batch, head, row)
strides: a (B, H, S, D) view of any strides with unit column stride is
read in place. K1's ``attention_route`` picks the body: the tensor-core
one for bf16 with aligned strides and a head dim that is a multiple of 8,
the scalar one otherwise; the source's header says what bounds each.

``fused_attention`` takes the plain version for a tensor on the CPU and
launches a kernel for a CUDA tensor (or raises); it never falls back.
``fused_attention.launches`` counts kernel launches and
``fused_attention.launches_by_route`` counts them per route. It is a
``torch.autograd.Function`` on both: the backward is the plain recompute
``attention_heads_backward_plain``, as the JAX package's backward
(``_fused_attention_bwd``, attention.py:309-346) is XLA.

The JAX function's ``block_q`` and ``interpret`` arguments are the TPU's
query tiling and Pallas's CPU mode; the port has neither, so they are
dropped. A row whose keys are all masked returns mean(V) over its T keys,
as K1 (the Pallas kernel averages over its key count padded to 128).
"""

from __future__ import annotations

from typing import Optional

import torch

from .attention import (BODY_CODES, DTYPE_CODES, MAX_HEAD_DIM, ROUTES,
                        attention_heads_backward_plain, attention_heads_plain,
                        attention_route)
from .build import check, load_library


# K3's function in plain PyTorch, the math it shares with K1: the XLA
# path's (softmax, then the weights in v's dtype). The Pallas kernel divides
# by the row sum after the product instead, which differs only in rounding.
fused_attention_plain = attention_heads_plain


def _launch(q, k, v, kv_valid):
    if q.device.type != "cuda":
        raise ValueError(f"fused_attention: no kernel for {q.device}")
    if q.dim() != 4:
        raise ValueError(f"q must be (B, H, S, D), got {tuple(q.shape)}")
    b, h, s, d = q.shape
    t = k.shape[2]
    if k.shape != (b, h, t, d) or v.shape != (b, h, t, d) or t == 0:
        raise ValueError(f"k/v shapes {tuple(k.shape)}/{tuple(v.shape)} do "
                         f"not match q {tuple(q.shape)}")
    if not 1 <= d <= MAX_HEAD_DIM:
        raise ValueError(f"head dim {d}: need 1 to {MAX_HEAD_DIM}")
    if q.dtype not in DTYPE_CODES or not (q.dtype == k.dtype == v.dtype):
        raise ValueError(f"q/k/v dtypes {q.dtype}/{k.dtype}/{v.dtype}: need "
                         "one of float32, bfloat16 for all three")
    if not (k.device == v.device == q.device):
        raise ValueError("q, k and v must be on one device")
    if any(x.stride(3) != 1 for x in (q, k, v)):
        raise ValueError("q, k and v need unit column stride")
    if kv_valid is not None:
        if kv_valid.shape != (b, t):
            raise ValueError(f"kv_valid {tuple(kv_valid.shape)} != {(b, t)}")
        kv_valid = kv_valid.to(device=q.device, dtype=torch.uint8).contiguous()
    route = attention_route(q, k, v, d)
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    lib = load_library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.cris_fused_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            None if kv_valid is None else kv_valid.data_ptr(),
            out.data_ptr(), b, s, t, h, d, DTYPE_CODES[q.dtype],
            BODY_CODES[route], *q.stride()[:3], *k.stride()[:3],
            *v.stride()[:3], *out.stride()[:3], float(d ** -0.5), stream)
    check(lib, err, "fused_attention")
    fused_attention.launches += 1
    fused_attention.launches_by_route[route] += 1
    return out


class _FusedAttention(torch.autograd.Function):
    """K3's forward (the kernel on the card, the plain version on the CPU)
    with the plain recompute backward."""

    @staticmethod
    def forward(ctx, q, k, v, kv_valid):
        ctx.save_for_backward(q, k, v, kv_valid)
        if q.device.type == "cpu":
            return fused_attention_plain(q, k, v, kv_valid)
        return _launch(q, k, v, kv_valid)

    @staticmethod
    def backward(ctx, g):
        q, k, v, kv_valid = ctx.saved_tensors
        return (*attention_heads_backward_plain(q, k, v, kv_valid, g), None)


def fused_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    kv_valid: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """softmax(q k^T / sqrt(D), masked keys = -1e30) v per (batch, head).

    q (B, H, S, D), k/v (B, H, T, D), float32 or bfloat16, D <= 128;
    kv_valid: optional (B, T), nonzero = valid key. Returns (B, H, S, D) in
    q's dtype. Differentiable in q, k and v."""
    return _FusedAttention.apply(q, k, v, kv_valid)


fused_attention.launches = 0
fused_attention.launches_by_route = dict.fromkeys(ROUTES, 0)
