"""K1: fused multi-head attention over (B, S, E), in CUDA for Hopper.

Replaces the TPU kernel ``fused_attention_bse``
(cris_tpu/ops/pallas/attention.py:165, body ``_attn_bse_kernel`` at :132).
The CUDA source is ``cris_tpu_torch/csrc/attention_bse.cu``, two bodies
that K1 and K3 share, picked before each launch by ``attention_route``:

- ``"tensor_cores"``: bf16 q/k/v whose head dim is a multiple of 8 up to
  128 and whose bases, head offsets and row strides are multiples of 8
  elements, which every model site meets (contiguous (B, L, E)
  projections). A flash-attention body on ``mma.sync`` m16n8k16 with
  ``cp.async``-fed K/V tiles and the softmax in registers; P is rounded to
  bf16 before P V, as the JAX kernels round it to v's dtype. Its bound is
  the tensor cores' rate; what holds it from that is in PERF.md.
- ``"scalar"``: float32 (its products stay f32 FMAs: TF32 would break the
  f32 bars), and any bf16 layout the tensor-core body cannot take. The
  latency of its one-element staging loads bounds it (PERF.md).

The next step is wgmma for the two products, if the tensor-core body
stays far from its bound.

``fused_attention_bse`` takes the plain version for a tensor on the CPU
and launches a kernel for a CUDA tensor (or raises); it never falls back.
``fused_attention_bse.launches`` counts kernel launches, and
``fused_attention_bse.launches_by_route`` counts them per route.

On CUDA it is a ``torch.autograd.Function``: the forward is the kernel,
the backward is ``attention_bse_backward_plain``, a torch port of the JAX
package's XLA backward (``_fused_attention_bse_bwd``,
cris_tpu/ops/pallas/attention.py:259-298) that recomputes P in f32. The
JAX package has no backward kernel for K1, so neither has the port.
"""

from __future__ import annotations

from typing import Optional

import torch

from .build import check, load_library

NEG_INF = -1e30  # finite: a fully masked row averages V instead of NaN
MAX_HEAD_DIM = 128  # the kernel runs any head dim from 1 to this
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}  # the kernels' dtype codes


def split_heads(x: torch.Tensor, num_heads: int) -> torch.Tensor:
    """(B, S, E) -> (B, num_heads, S, head_dim)."""
    b, s, e = x.shape
    return x.reshape(b, s, num_heads, e // num_heads).transpose(1, 2)


def merge_heads(x: torch.Tensor) -> torch.Tensor:
    """(B, H, S, D) -> (B, S, E)."""
    b, h, s, d = x.shape
    return x.transpose(1, 2).reshape(b, s, h * d)


def attention_heads_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    kv_valid: Optional[torch.Tensor] = None,
    attn_mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Plain PyTorch softmax attention over (B, H, S, D) q and (B, H, T, D)
    k/v, the math that K1 and K3 share.

    The math of ``cris_tpu.ops.attention.dot_product_attention``'s XLA
    path: f32 logits scaled by head_dim**-0.5, an optional additive
    ``attn_mask`` (S, T), masked keys (``kv_valid`` (B, T) == 0) replaced
    by NEG_INF, f32 softmax, weights cast to v's dtype, f32 accumulation,
    output in q's dtype. Autocast is off inside, so a bf16 autocast region
    around it changes nothing here."""
    d = q.shape[-1]
    with torch.autocast(q.device.type, enabled=False):
        logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * (d ** -0.5)
        if attn_mask is not None:
            logits = logits + attn_mask.float()
        if kv_valid is not None:
            logits = logits.masked_fill(~kv_valid.bool()[:, None, None, :], NEG_INF)
        weights = torch.softmax(logits, dim=-1)
        out = torch.matmul(weights.to(v.dtype).float(), v.float())
    return out.to(q.dtype)


def attention_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    num_heads: int,
    kv_valid: Optional[torch.Tensor] = None,
    attn_mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """``attention_heads_plain`` over (B, S, E) q and (B, T, E) k/v: the
    heads are views of the rows, the output is (B, S, E)."""
    return merge_heads(attention_heads_plain(
        split_heads(q, num_heads), split_heads(k, num_heads),
        split_heads(v, num_heads), kv_valid, attn_mask))


def attention_heads_backward_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    kv_valid: Optional[torch.Tensor],
    g: torch.Tensor,
):
    """(dq, dk, dv) of softmax attention over (B, H, S, D) q and (B, H, T,
    D) k/v for the output gradient g, the backward that K1 and K3 share.

    The JAX package's XLA backward (``_fused_attention_bwd``,
    cris_tpu/ops/pallas/attention.py:309-346) in torch: P recomputed in f32
    from q and k, dV = P^T g, dP = g V^T, dS = P o (dP - rowsum(dP o P)),
    dQ = dS K * scale, dK = dS^T Q * scale, all in f32 with autocast off,
    each gradient cast to its input's dtype. A masked key has P = 0, so dS
    = 0 there, except on a row whose keys are all masked (uniform P), where
    this follows the JAX backward and not autograd through the plain
    forward; the model never produces such rows."""
    scale = q.shape[-1] ** -0.5
    with torch.autocast(q.device.type, enabled=False):
        qf, kf, vf, gf = q.float(), k.float(), v.float(), g.float()
        logits = torch.matmul(qf, kf.transpose(-1, -2)) * scale
        if kv_valid is not None:
            logits = logits.masked_fill(~kv_valid.bool()[:, None, None, :],
                                        NEG_INF)
        p = torch.softmax(logits, dim=-1)
        dv = torch.matmul(p.transpose(-1, -2), gf)
        dp = torch.matmul(gf, vf.transpose(-1, -2))
        ds = p * (dp - (dp * p).sum(dim=-1, keepdim=True))
        dq = torch.matmul(ds, kf) * scale
        dk = torch.matmul(ds.transpose(-1, -2), qf) * scale
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def attention_bse_backward_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    num_heads: int,
    kv_valid: Optional[torch.Tensor],
    g: torch.Tensor,
):
    """(dq, dk, dv) of ``fused_attention_bse`` for the output gradient g:
    ``attention_heads_backward_plain`` on head views of the (B, S, E) rows
    (the JAX package's ``_fused_attention_bse_bwd``,
    cris_tpu/ops/pallas/attention.py:259-298, is the same math)."""
    grads = attention_heads_backward_plain(
        *(split_heads(x, num_heads) for x in (q, k, v)), kv_valid,
        split_heads(g, num_heads))
    return tuple(merge_heads(x) for x in grads)


ROUTES = ("tensor_cores", "scalar")
BODY_CODES = {"scalar": 0, "tensor_cores": 1}  # the CUDA entries' body codes


def attention_route(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    head_dim: int) -> str:
    """Which CUDA body K1 and K3 launch for these inputs: "tensor_cores"
    for bf16 q, k and v with a head dim that is a multiple of 8 up to
    MAX_HEAD_DIM, unit column stride, 16-byte aligned bases and every other
    stride a multiple of 8 elements (so each head's rows are whole 16-byte
    copies; K1's head offsets h * head_dim are then aligned too); else
    "scalar". Pure: reads dtypes, strides and data pointers only."""
    if not q.dtype == k.dtype == v.dtype == torch.bfloat16:
        return "scalar"
    if head_dim % 8 or not 8 <= head_dim <= MAX_HEAD_DIM:
        return "scalar"
    for x in (q, k, v):
        if x.stride(-1) != 1 or x.data_ptr() % 16:
            return "scalar"
        if any(st % 8 for st in x.stride()[:-1]):
            return "scalar"
    return "tensor_cores"


def _rows(x: torch.Tensor, name: str):
    if x.dim() != 3 or x.stride(2) != 1:
        raise ValueError(f"{name} must be (B, L, E) with unit column stride")
    return x.stride(0), x.stride(1)


def check_cuda_inputs(q, k, v, num_heads, kv_valid, what):
    """Validate q/k/v for a CUDA attention kernel; returns (b, s, t, d,
    kv_valid as contiguous uint8 on the card or None)."""
    if q.device.type != "cuda":
        raise ValueError(f"{what}: no kernel for {q.device}")
    b, s, e = q.shape
    t = k.shape[1]
    d = e // num_heads
    if e % num_heads or not 1 <= d <= MAX_HEAD_DIM:
        raise ValueError(f"head dim {e}/{num_heads}: need a whole number "
                         f"from 1 to {MAX_HEAD_DIM}")
    if q.dtype not in DTYPE_CODES or not (q.dtype == k.dtype == v.dtype):
        raise ValueError(f"q/k/v dtypes {q.dtype}/{k.dtype}/{v.dtype}: need "
                         "one of float32, bfloat16 for all three")
    if k.shape != (b, t, e) or v.shape != (b, t, e) or t == 0:
        raise ValueError(f"k/v shapes {tuple(k.shape)}/{tuple(v.shape)} do "
                         f"not match q {tuple(q.shape)}")
    if not (k.device == v.device == q.device):
        raise ValueError("q, k and v must be on one device")
    if kv_valid is not None:
        if kv_valid.shape != (b, t):
            raise ValueError(f"kv_valid {tuple(kv_valid.shape)} != {(b, t)}")
        kv_valid = kv_valid.to(device=q.device, dtype=torch.uint8).contiguous()
    return b, s, t, d, kv_valid


def _launch(q, k, v, num_heads, kv_valid):
    b, s, t, d, kv_valid = check_cuda_inputs(q, k, v, num_heads, kv_valid,
                                             "fused_attention_bse")
    q_sb, q_ss = _rows(q, "q")
    k_sb, k_ss = _rows(k, "k")
    v_sb, v_ss = _rows(v, "v")
    route = attention_route(q, k, v, d)
    lib = load_library()
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.cris_attention_bse(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            None if kv_valid is None else kv_valid.data_ptr(),
            out.data_ptr(), b, s, t, num_heads, d, DTYPE_CODES[q.dtype],
            BODY_CODES[route], q_sb, q_ss, k_sb, k_ss, v_sb, v_ss,
            float(d ** -0.5), stream,
        )
    check(lib, err, "fused_attention_bse")
    fused_attention_bse.launches += 1
    fused_attention_bse.launches_by_route[route] += 1
    return out


class _FusedAttentionBSE(torch.autograd.Function):
    """K1's kernel forward with the plain recompute backward."""

    @staticmethod
    def forward(ctx, q, k, v, num_heads, kv_valid):
        ctx.num_heads = num_heads
        ctx.save_for_backward(q, k, v, kv_valid)
        return _launch(q, k, v, num_heads, kv_valid)

    @staticmethod
    def backward(ctx, g):
        q, k, v, kv_valid = ctx.saved_tensors
        dq, dk, dv = attention_bse_backward_plain(q, k, v, ctx.num_heads,
                                                  kv_valid, g)
        return dq, dk, dv, None, None


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
    produces them. Differentiable in q, k and v."""
    if q.device.type == "cpu":
        return attention_plain(q, k, v, num_heads, kv_valid)
    return _FusedAttentionBSE.apply(q, k, v, num_heads, kv_valid)


fused_attention_bse.launches = 0
fused_attention_bse.launches_by_route = dict.fromkeys(ROUTES, 0)
