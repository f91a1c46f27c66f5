"""The attention-dropout keep mask, counter-based, in plain torch integer ops.

Replaces the TPU PRNG draw of ``cris_tpu/ops/pallas/attention_train.py``
(``_keep_mask`` :47-52, re-seeded per (batch, head) at :66-68). The
TPU's bits cannot be reproduced off the TPU; what carries over is the
rule: a weight is kept iff its 32 random bits are
``>= min(int(rate * 2**32), 2**32 - 1)``, and the forward and the
backward regenerate the same bits from the seed instead of storing them.

The bits come from Philox4x32-10 (Salmon et al., "Parallel random
numbers: as easy as 1, 2, 3", SC 2011; the Random123 library's
definition). For the weight of query row ``i`` on key column ``j`` of
head ``h`` in batch row ``b``:

    counter = (j >> 2, i, h, b)                (four 32-bit words)
    key     = (seed mod 2**32, seed >> 32)     (seed in [0, 2**63))
    bits    = philox4x32_10(counter, key)[j & 3]

so four neighbouring key columns share one Philox call. Under data
parallel ``b`` is the row's place in the global batch: a process whose
batch starts at global row ``batch_offset`` draws rows
``batch_offset + 0, 1, ...``, the JAX package's per-(global row, head)
seeding (attention_train.py:66-68), so that no two ranks share a mask.
Under tensor parallel ``h`` is likewise the head's place among all the
heads: a rank whose heads start at global head ``head_offset`` draws heads
``head_offset + 0, 1, ...``, the matching heads of the full launch's mask.
The CUDA kernel
(``cris_tpu_torch/csrc/attention_bse_dropout.cu``) computes the same bits
with the same definition; the two must agree bit for bit. Its tensor-core
forward also stores the mask packed to bits for its backward
(``keep_bits_packed`` is that tensor's plain version). Here uint32
arithmetic is carried in int64 tensors, with the 32 x 32 -> 64-bit
products split into 16-bit halves so that nothing overflows.
"""

from __future__ import annotations

import torch

_M32 = 0xFFFFFFFF
PHILOX_M0, PHILOX_M1 = 0xD2511F53, 0xCD9E8D57  # round multipliers
PHILOX_W0, PHILOX_W1 = 0x9E3779B9, 0xBB67AE85  # key increments (Weyl)
PHILOX_ROUNDS = 10
MAX_SEED = 2**63 - 1


def keep_threshold(rate: float) -> int:
    """The JAX kernel's threshold (attention_train.py:51): keep iff
    ``bits >= threshold``."""
    if not 0.0 <= rate < 1.0:
        raise ValueError(f"dropout rate {rate} outside [0, 1)")
    return min(int(rate * 2**32), 2**32 - 1)


def seed_words(seed: int):
    """A seed in [0, 2**63) -> the two 32-bit Philox key words."""
    seed = int(seed)
    if not 0 <= seed <= MAX_SEED:
        raise ValueError(f"dropout seed {seed} outside [0, 2**63)")
    return seed & _M32, seed >> 32


def _mulhilo(a: torch.Tensor, m: int):
    """(hi, lo) 32-bit words of a * m, for a in [0, 2**32) held in int64."""
    p_lo = a * (m & 0xFFFF)  # < 2**48
    p_hi = a * (m >> 16)     # < 2**48
    t = p_lo + ((p_hi & 0xFFFF) << 16)
    return (p_hi >> 16) + (t >> 32), t & _M32


def philox4x32_10(c0, c1, c2, c3, k0: int, k1: int):
    """Philox4x32-10 on int64 tensors of 32-bit counter words (broadcast
    together); returns the four 32-bit output words as int64 tensors."""
    for r in range(PHILOX_ROUNDS):
        if r:
            k0 = (k0 + PHILOX_W0) & _M32
            k1 = (k1 + PHILOX_W1) & _M32
        hi0, lo0 = _mulhilo(c0, PHILOX_M0)
        hi1, lo1 = _mulhilo(c2, PHILOX_M1)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def check_batch_offset(batch_offset: int, batch: int) -> int:
    """``batch_offset`` as an int, when rows ``batch_offset .. + batch``
    fit the counter's 32-bit batch word as the CUDA kernels' int."""
    batch_offset = int(batch_offset)
    if batch_offset < 0 or batch_offset + batch > 2**31 - 1:
        raise ValueError(f"batch rows {batch_offset}..{batch_offset + batch}"
                         " outside [0, 2**31)")
    return batch_offset


def check_head_offset(head_offset: int, heads: int) -> int:
    """``head_offset`` as an int, when heads ``head_offset .. + heads``
    fit the counter's 32-bit head word as the CUDA kernels' int."""
    head_offset = int(head_offset)
    if head_offset < 0 or head_offset + heads > 2**31 - 1:
        raise ValueError(f"heads {head_offset}..{head_offset + heads}"
                         " outside [0, 2**31)")
    return head_offset


def keep_bits(seed: int, batch: int, heads: int, rows: int, cols: int,
              device=None, batch_offset: int = 0,
              head_offset: int = 0) -> torch.Tensor:
    """(batch, heads, rows, cols) int64 tensor of the 32-bit keep bits of
    global batch rows ``batch_offset .. batch_offset + batch - 1`` and
    global heads ``head_offset .. head_offset + heads - 1``: rows
    ``o:o + batch`` and heads ``g:g + heads`` of
    ``keep_bits(seed, o + batch, g + heads, ...)``, bit for bit."""
    k0, k1 = seed_words(seed)
    batch_offset = check_batch_offset(batch_offset, batch)
    head_offset = check_head_offset(head_offset, heads)
    ar = lambda n: torch.arange(n, dtype=torch.int64, device=device)  # noqa: E731
    groups = (cols + 3) // 4
    words = philox4x32_10(
        ar(groups)[None, None, None, :], ar(rows)[None, None, :, None],
        (ar(heads) + head_offset)[None, :, None, None],
        (ar(batch) + batch_offset)[:, None, None, None], k0, k1)
    words = [w.expand(batch, heads, rows, groups) for w in words]
    return torch.stack(words, dim=-1).reshape(batch, heads, rows,
                                              4 * groups)[..., :cols]


def keep_mask(seed: int, batch: int, heads: int, rows: int, cols: int,
              rate: float, device=None, batch_offset: int = 0,
              head_offset: int = 0) -> torch.Tensor:
    """(batch, heads, rows, cols) bool: True = the weight is kept."""
    threshold = keep_threshold(rate)
    return keep_bits(seed, batch, heads, rows, cols, device,
                     batch_offset, head_offset) >= threshold


def mask_words(cols: int) -> int:
    """32-bit words per row of the packed keep mask."""
    return (cols + 31) // 32


def keep_bits_packed(seed: int, batch: int, heads: int, rows: int, cols: int,
                     rate: float, device=None, batch_offset: int = 0,
                     head_offset: int = 0) -> torch.Tensor:
    """The keep mask packed to bits, as the tensor-core kernels write it:
    (batch, heads, rows, mask_words(cols)) int32 holding the uint32 words,
    bit ``j % 32`` of word ``j // 32`` set iff key column j is kept; the
    bits past ``cols`` are 0."""
    keep = keep_mask(seed, batch, heads, rows, cols, rate, device,
                     batch_offset, head_offset)
    nw = mask_words(cols)
    keep = torch.nn.functional.pad(keep, (0, 32 * nw - cols))
    weights = 1 << torch.arange(32, dtype=torch.int64, device=keep.device)
    words = (keep.reshape(batch, heads, rows, nw, 32).long() * weights).sum(-1)
    return torch.where(words >= 2**31, words - 2**32, words).to(torch.int32)
