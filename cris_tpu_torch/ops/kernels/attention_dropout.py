"""K2: fused multi-head attention with attention-weight dropout, forward
and backward, in CUDA for Hopper.

Replaces the TPU kernels of ``fused_attention_bse_dropout``
(cris_tpu/ops/pallas/attention_train.py:185; forward ``pallas_call`` :218,
backward :248). The CUDA source is
``cris_tpu_torch/csrc/attention_bse_dropout.cu``; its header says how it
is laid out and what bounds it on the card. The keep mask is Philox4x32-10
keyed on (seed, batch, head, query row, key column)
(``dropout_mask.py``); kernel and plain version draw the same bits. The
batch word is the row's place in the data-parallel global batch: every
function here takes ``batch_offset``, the global row of batch row 0 (0 on
one process), which the kernels add to the batch row where they draw the
bits and nowhere else. The head word is the head's place among the heads
that tensor parallel splits over the ranks: ``head_offset``, the global
head of head 0 (0 on one process), is added to the head in the same
places.

Two bodies, picked before each launch by ``attention_dropout_route`` with
K1's gate (``attention_route``):

- ``"tensor_cores"``: bf16 q/k/v with a head dim that is a multiple of 8
  up to 128 and 16-byte aligned rows, which every model site meets under
  bf16 autocast. Flash-attention kernels on ``mma.sync`` (K1's body plus
  the keep bits); the forward also writes the keep mask packed to bits
  (``dropout_mask.keep_bits_packed``), which the two backward kernels
  read instead of drawing Philox again.
- ``"scalar"``: float32, and any layout the gate refuses: the scalar f32
  FMA kernels, which regenerate the mask in every kernel.

``fused_attention_bse_dropout`` takes the plain version for a tensor on
the CPU and launches the kernels for a CUDA tensor (or raises); it never
falls back, and a route is never changed after a failure. On CUDA it is a
``torch.autograd.Function`` whose backward launches the backward kernels.
It saves q, k, v, the key mask, the row log-sum-exp (for P without a
second softmax pass, (B, H, S) f32) and the seed, and by route: on the
tensor-core route the packed keep mask ((B, H, S, ceil(T / 32)) int32,
which the backward reads instead of drawing Philox again; its dQ kernel
sums delta = rowsum(dW o W) itself), on the scalar route the output O
((B, S, E), for delta = rowsum(dO o O)). The JAX rule saves only q, k, v,
the mask and the seed and recomputes everything. ``.launches`` and
``.launches_by_route`` on ``fused_attention_bse_dropout`` count forward
launches, those on ``attention_dropout_backward`` backward launches.
"""

from __future__ import annotations

from typing import Optional

import torch

from .attention import (BODY_CODES, DTYPE_CODES, NEG_INF, ROUTES, _rows,
                        attention_route, check_cuda_inputs, merge_heads,
                        split_heads)
from .build import check, load_library
from .dropout_mask import (check_batch_offset, check_head_offset, keep_mask,
                           keep_threshold, mask_words, seed_words)


def attention_dropout_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    num_heads: int,
    kv_valid: Optional[torch.Tensor] = None,
    rate: float = 0.0,
    seed: int = 0,
    attn_mask: Optional[torch.Tensor] = None,
    batch_offset: int = 0,
    head_offset: int = 0,
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
            keep = keep_mask(seed, b, h, s, t, rate, weights.device,
                             batch_offset, head_offset)
            weights = weights * keep / (1.0 - rate)
        out = torch.matmul(weights.to(vh.dtype).float(), vh.float())
    return merge_heads(out.to(q.dtype))


def attention_dropout_backward_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    num_heads: int,
    kv_valid: Optional[torch.Tensor],
    rate: float,
    seed: int,
    g: torch.Tensor,
    batch_offset: int = 0,
    head_offset: int = 0,
):
    """(dq, dk, dv) of ``attention_dropout_plain`` for the output gradient
    g, at the JAX backward kernel's rounding points (``_bwd_kernel``,
    cris_tpu/ops/pallas/attention_train.py:92-136): W recomputed in f32,
    dV = round(W o keep / (1 - rate)) round(g) with the rounds to v's
    dtype (:112-118); dW = keep o (round(g) V^T) / (1 - rate) in f32
    (:120-124); dS = W o (dW - rowsum(dW o W)); dQ = round(dS) K * scale
    and dK = round(dS)^T Q * scale with dS rounded to k's and q's dtype
    (:126-133); f32 accumulation, each gradient cast to its input's dtype.
    In f32 every round is the identity and this is autograd through the
    plain forward. A masked key has W = 0, so dS = 0 there, except on a
    row whose keys are all masked (uniform W), where this follows the JAX
    kernel (as ``attention_heads_backward_plain`` does); the model never
    produces such rows. Autocast is off inside."""
    d = q.shape[-1] // num_heads
    scale = d ** -0.5
    inv_keep = 1.0 / (1.0 - rate)
    with torch.autocast(q.device.type, enabled=False):
        qh, kh, vh, gh = (split_heads(x, num_heads) for x in (q, k, v, g))
        qf, kf, vf = qh.float(), kh.float(), vh.float()
        logits = torch.matmul(qf, kf.transpose(-1, -2)) * scale
        if kv_valid is not None:
            logits = logits.masked_fill(~kv_valid.bool()[:, None, None, :],
                                        NEG_INF)
        w = torch.softmax(logits, dim=-1)
        b, h, s, t = w.shape
        keep = keep_mask(seed, b, h, s, t, rate, w.device, batch_offset,
                         head_offset)
        g_r = gh.to(v.dtype).float()
        wd = (torch.where(keep, w, 0.0) * inv_keep).to(v.dtype).float()
        dv = torch.matmul(wd.transpose(-1, -2), g_r)
        dw = torch.where(keep, torch.matmul(g_r, vf.transpose(-1, -2)),
                         0.0) * inv_keep
        ds = w * (dw - (dw * w).sum(dim=-1, keepdim=True))
        dq = torch.matmul(ds.to(k.dtype).float(), kf) * scale
        dk = torch.matmul(ds.to(q.dtype).float().transpose(-1, -2), qf) * scale
    return (merge_heads(dq.to(q.dtype)), merge_heads(dk.to(k.dtype)),
            merge_heads(dv.to(v.dtype)))


def attention_dropout_route(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, num_heads: int) -> str:
    """Which CUDA kernels K2 launches for these (B, L, E) inputs: K1's gate
    (``attention_route``) at head dim E / num_heads: "tensor_cores" for bf16
    with a head dim that is a multiple of 8 up to 128 and 16-byte aligned
    bases and row strides, else "scalar". Pure: reads dtypes, shapes,
    strides and data pointers only."""
    return attention_route(q, k, v, q.shape[-1] // num_heads)


def _scalars(d, rate, seed, batch, batch_offset, heads, head_offset):
    seed_lo, seed_hi = seed_words(seed)
    return (float(d ** -0.5), float(1.0 / (1.0 - rate)), keep_threshold(rate),
            seed_lo, seed_hi, check_batch_offset(batch_offset, batch),
            check_head_offset(head_offset, heads))


def _ptr(x):
    return None if x is None else x.data_ptr()


def attention_dropout_forward(q, k, v, num_heads, kv_valid, rate, seed,
                              batch_offset=0, head_offset=0):
    """(out, row log-sum-exp (B, H, S) f32, kv_valid as contiguous uint8 or
    None, packed keep mask (B, H, S, ceil(T / 32)) int32 on the tensor-core
    route or None) from the forward kernel, for CUDA tensors."""
    b, s, t, d, kv_valid = check_cuda_inputs(
        q, k, v, num_heads, kv_valid, "fused_attention_bse_dropout")
    strides = (*_rows(q, "q"), *_rows(k, "k"), *_rows(v, "v"))
    route = attention_dropout_route(q, k, v, num_heads)
    lib = load_library()
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    lse = torch.empty((b, num_heads, s), dtype=torch.float32, device=q.device)
    bits = None
    if route == "tensor_cores":
        bits = torch.empty((b, num_heads, s, mask_words(t)), dtype=torch.int32,
                           device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.cris_attention_dropout_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(kv_valid),
            out.data_ptr(), lse.data_ptr(), _ptr(bits), b, s, t, num_heads,
            d, DTYPE_CODES[q.dtype], BODY_CODES[route], *strides,
            *_scalars(d, rate, seed, b, batch_offset, num_heads, head_offset),
            stream,
        )
    check(lib, err, "fused_attention_bse_dropout")
    fused_attention_bse_dropout.launches += 1
    fused_attention_bse_dropout.launches_by_route[route] += 1
    return out, lse, kv_valid, bits


def attention_dropout_backward(q, k, v, num_heads, kv_valid, rate, seed,
                               out, lse, bits, g, batch_offset=0,
                               head_offset=0):
    """(dq, dk, dv) from the backward kernels, for CUDA tensors saved by
    the forward (``kv_valid`` as contiguous uint8 or None); the scalar
    route reads the forward's output ``out``, the tensor-core route the
    packed keep mask ``bits`` that its forward wrote (the other may be
    None)."""
    b, s, t, d, kv_valid = check_cuda_inputs(
        q, k, v, num_heads, kv_valid, "attention_dropout_backward")
    if g.shape != q.shape or g.dtype != q.dtype:
        raise ValueError(f"output gradient {tuple(g.shape)} {g.dtype} does "
                         f"not match q {tuple(q.shape)} {q.dtype}")
    route = attention_dropout_route(q, k, v, num_heads)
    if route == "tensor_cores" and (
            bits is None or bits.shape != (b, num_heads, s, mask_words(t))):
        raise ValueError("attention_dropout_backward: the tensor-core route "
                         "needs the forward's packed keep mask")
    if route == "scalar" and (out is None or out.shape != q.shape):
        raise ValueError("attention_dropout_backward: the scalar route needs "
                         "the forward's output")
    g = g.contiguous()
    if g.data_ptr() % 16:  # a view off a 16-byte boundary: whole rows again
        g = g.clone()
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
            q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(kv_valid),
            _ptr(out) if route == "scalar" else None, lse.data_ptr(),
            _ptr(bits) if route == "tensor_cores" else None, g.data_ptr(),
            delta.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), b,
            s, t, num_heads, d, DTYPE_CODES[q.dtype], BODY_CODES[route],
            *strides,
            *_scalars(d, rate, seed, b, batch_offset, num_heads, head_offset),
            stream,
        )
    check(lib, err, "attention_dropout_backward")
    attention_dropout_backward.launches += 1
    attention_dropout_backward.launches_by_route[route] += 1
    return dq, dk, dv


attention_dropout_backward.launches = 0
attention_dropout_backward.launches_by_route = dict.fromkeys(ROUTES, 0)


class _FusedAttentionDropout(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, num_heads, kv_valid, rate, seed, batch_offset,
                head_offset):
        out, lse, kv_valid, bits = attention_dropout_forward(
            q, k, v, num_heads, kv_valid, rate, seed, batch_offset,
            head_offset)
        ctx.num_heads, ctx.rate, ctx.seed = num_heads, rate, seed
        ctx.batch_offset, ctx.head_offset = batch_offset, head_offset
        # the scalar backward reads O; the tensor-core one reads the bits
        ctx.save_for_backward(q, k, v, kv_valid, out if bits is None else None,
                              lse, bits)
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, kv_valid, out, lse, bits = ctx.saved_tensors
        dq, dk, dv = attention_dropout_backward(
            q, k, v, ctx.num_heads, kv_valid, ctx.rate, ctx.seed, out, lse,
            bits, g, ctx.batch_offset, ctx.head_offset)
        return dq, dk, dv, None, None, None, None, None, None


def fused_attention_bse_dropout(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    num_heads: int,
    kv_valid: Optional[torch.Tensor],
    rate: float,
    seed: int,
    batch_offset: int = 0,
    head_offset: int = 0,
) -> torch.Tensor:
    """Multi-head attention over (B, S, E) with inverted dropout at
    ``rate`` on the normalised weights, the keep mask drawn from ``seed``
    (an int in [0, 2**63)) for global batch rows ``batch_offset ..
    batch_offset + B - 1`` and global heads ``head_offset .. head_offset +
    num_heads - 1``. Differentiable in q, k and v; the same seed gives the
    same mask in the forward and the backward."""
    keep_threshold(rate)
    seed_words(seed)
    batch_offset = check_batch_offset(batch_offset, q.shape[0])
    head_offset = check_head_offset(head_offset, num_heads)
    if q.device.type == "cpu":
        return attention_dropout_plain(q, k, v, num_heads, kv_valid, rate,
                                       seed, batch_offset=batch_offset,
                                       head_offset=head_offset)
    return _FusedAttentionDropout.apply(q, k, v, num_heads, kv_valid,
                                        float(rate), int(seed), batch_offset,
                                        head_offset)


fused_attention_bse_dropout.launches = 0
fused_attention_bse_dropout.launches_by_route = dict.fromkeys(ROUTES, 0)
