// K2: fused multi-head softmax attention over (B, S, E) projections with
// inverted dropout on the attention weights, forward and backward.
//
// Replaces the TPU kernels of `fused_attention_bse_dropout`
// (cris_tpu/ops/pallas/attention_train.py:185): the forward `pallas_call`
// at :218 (body `_fwd_kernel` :71) and the backward one at :248 (body
// `_bwd_kernel` :92). Same math, per head h with D columns:
//   W = softmax(q k^T * D^-1/2, masked keys = -1e30)      (f32)
//   O = (keep o W) V / (1 - rate)
// where keep is the dropout mask. Its bits come from Philox4x32-10 with
// counter (j >> 2, i, h, b) and key (seed mod 2^32, seed >> 32), word
// j & 3, for query row i and key column j; b is the batch row plus
// batch_offset, its row in the data-parallel global batch (0 on one
// process), so that no two ranks draw one mask, and h is the head plus
// head_offset, its head among all the heads that tensor parallel splits
// over the ranks (0 on one process). A weight is kept iff its
// bits are >= min(int(rate * 2^32), 2^32 - 1), the JAX kernel's threshold.
// cris_tpu_torch/ops/kernels/dropout_mask.py computes the same bits in
// torch integer ops (the plain version's mask); the two agree bit for
// bit. The TPU's own bits cannot be reproduced here.
//
// The TPU kernels hold one (batch, head pair)'s whole (S_pad, T_pad) f32
// logits in VMEM: 768 x 768 x 4 B = 2.4 MB per head at the decoder's
// self-attention, ten times a block's 227 KB of shared memory. Here every
// kernel streams 64-row tiles through shared memory. Two bodies; the
// Python wrapper picks one before the launch (ops/kernels/
// attention_dropout.py, attention_dropout_route: K1's gate):
//
// - "tensor_cores" (dropout_tc_*): bf16 with a head dim that is a multiple
//   of 8 up to 128 and 16-byte aligned rows, which every model site meets
//   under bf16 autocast. Flash-attention kernels on mma.sync.m16n8k16
//   (bf16 x bf16 -> f32), on the helpers of mma_sm90.cuh that K1 shares:
//   4 warps x 16 rows a block, 64-row tiles by 16-byte cp.async into a
//   double-buffered ring (rows padded by 16 bytes for ldmatrix), the
//   accumulators of one product rounded to bf16 in registers as the A
//   operand of the next. Each operand is rounded where the JAX kernels
//   round it:
//   - forward (dropout_tc_fwd_kernel, one block per 64 query rows):
//     mma_sm90.cuh's flash_fwd_body, K1's and K3's body, with dropout on:
//     the online softmax's max and sum run over the undropped weights;
//     then each accumulator element takes its keep bit, and P o keep,
//     rounded to bf16, is the A operand of P V (`_fwd_kernel` :85); out =
//     acc / l / (1 - rate). The mma layout gives lane l rows l / 4 and
//     l / 4 + 8 and, of each 8-key column tile, keys 2 (l % 4) and + 1, so
//     lanes l and l ^ 1 share a 4-key Philox group: each draws the group
//     of one of its two rows and passes two bits of each group across with
//     one shuffle a key tile, one Philox call per (row, 4-key group). The
//     forward also writes the row log-sum-exp (B, H, S) f32 and the keep
//     mask packed to bits, uint32 words (B, H, S, ceil(T / 32)), bit j % 32
//     of word j / 32 (0 past T). At rate 0 it gives K1's bits.
//   - backward, two kernels with no atomics, so that the gradients are the
//     same bits from run to run. dropout_tc_bwd_dq_kernel (one block per
//     64 query rows) runs two passes over the key tiles, recomputing S =
//     Q K^T, dP = dO V^T and W from the log-sum-exp with keep from the
//     packed mask: the first sums delta = rowsum(dW o W) with dW = keep o
//     dP / (1 - rate) in f32, as `_bwd_kernel` :124-125 does; the second
//     forms dS = W o (dW - delta) and dQ += round(dS) K. Taking delta as
//     rowsum(dO o O) from the stored bf16 O instead (one pass, as flash
//     attention does) adds O's rounding to every dS of the row; where few
//     keys are valid, W is large and, with dS rounded to bf16 besides, dK
//     at the train batch's cross-attention (3 to 17 of 17 keys valid)
//     missed chip_smoke.py's bf16 bar. dropout_tc_bwd_dkdv_kernel (one
//     block per 64 keys) then loops over the query tiles: S^T = K Q^T,
//     dP^T = V dO^T, W^T from the log-sum-exp, dV += round(keep o W /
//     (1 - rate))^T round(dO) (`_bwd_kernel` :112-118) and dK +=
//     round(dS)^T Q (:126-133), with delta from the dQ kernel.
//   The backward reads the packed mask, 4 bytes per 32 weights, instead of
//   drawing Philox again in both kernels: at the B 32 self-attention the
//   mask is 15.2 MB a site, 4.5 us of device memory, where one more draw
//   of its 29 M Philox calls is about 0.07 ms of integer work (below).
// - "scalar" (dropout_fwd_kernel, dropout_bwd_delta_kernel,
//   dropout_bwd_dkdv_kernel, dropout_bwd_dq_kernel): float32, and any
//   layout the gate refuses. Scalar f32 FMAs on the CUDA cores, 128
//   threads per 64 x 64 tile, thread t owning 4 rows and 8 columns (key
//   columns 4 (t % 8) + {0..3} and + 32, so that one Philox call gives the
//   bits of 4 neighbouring keys); shared rows padded by one float. Every
//   kernel draws the keep bits itself; the backward is a delta kernel
//   (rowsum(dO o O) from the stored output), a dK/dV kernel and a dQ
//   kernel, without atomics. P o keep, keep o P / (1 - rate) and dS are
//   rounded to the input dtype before their products, where the JAX
//   kernels round them (the identity in f32).
//
// What bounds it on the card (B 32 bf16 self-attention, 676 x 676, 8 x
// 64): the forward's tensor work is 4 * 32 * 8 * 676^2 * 64 = 30 GFLOP,
// 0.030 ms at 989 TFLOP/s, but its 29 M Philox calls are about 0.07 ms
// of integer work: each call's 40 multiply results (IMAD, on the FMA
// pipe) at 64 a clock per SM, while its 20 three-input XORs and 4
// compares issue to the ALU pipe beside them. The forward is bound by
// Philox, and its draws are interleaved with the products. The
// backward's five products are 0.076 ms at the tensor cores' rate; the dQ
// kernel runs S and dP twice (delta, then dS), so the backward runs 9
// products. PERF.md has the times.
//
// Masking: masked keys get the finite logit -1e30 and keys past T get
// weight 0. A row whose keys are all masked has uniform weights 1/T (K1's
// mean(V) semantics, then dropout); its log-sum-exp rounds to -1e30, so
// the backward recognises it and uses 1/T. Gradients never flow through a
// masked logit (dS = 0 there), as through the plain version's
// masked_fill.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma_sm90.cuh"

namespace {

constexpr int kBlock = 64;  // query and key tile
constexpr int kThreads = 128;
constexpr int kRows = 4;  // tile rows per thread
constexpr int kCols = 8;  // tile columns per thread
constexpr float kAllMaskedLse = -5e29f;  // below: every key of the row masked

__device__ __forceinline__ uint32_t word(const uint4& r, int u) {
  return u == 0 ? r.x : u == 1 ? r.y : u == 2 ? r.z : r.w;
}

// key column of a thread's j-th column in a 64-key tile (keys side)
__device__ __forceinline__ int key_col(int cg, int j) {
  return 4 * cg + (j & 3) + 32 * (j >> 2);
}

struct Params {
  int S, T, D;
  long long q_sb, q_ss, k_sb, k_ss, v_sb, v_ss;
  float scale, inv_keep;
  uint32_t threshold, k0, k1;
  int b0;  // Philox's batch word of batch row 0; pointers stay local
  int h0;  // Philox's head word of head 0; pointers stay local
};

// ---------------------------------------------------------------- forward

template <int DP>
constexpr size_t fwd_smem() {
  // Qs[BQ][DP+1], Ks[BK][DP+1], Vs[BK][DP], Ps[BQ][BK+1], valid[BK]
  return sizeof(float) * (kBlock * (DP + 1) * 2 + kBlock * DP +
                          kBlock * (kBlock + 1) + kBlock);
}

template <typename scalar_t, int DP>
__global__ void __launch_bounds__(kThreads)
dropout_fwd_kernel(const scalar_t* __restrict__ q,
                   const scalar_t* __restrict__ k,
                   const scalar_t* __restrict__ v,
                   const uint8_t* __restrict__ kv_valid,
                   scalar_t* __restrict__ out, float* __restrict__ lse,
                   Params p) {
  constexpr int kOut = DP / 8;
  extern __shared__ float smem[];
  float* Qs = smem;                        // [BQ][DP+1]
  float* Ks = Qs + kBlock * (DP + 1);      // [BK][DP+1]
  float* Vs = Ks + kBlock * (DP + 1);      // [BK][DP]
  float* Ps = Vs + kBlock * DP;            // [BQ][BK+1], keep o p
  float* Vld = Ps + kBlock * (kBlock + 1);  // [BK], 1 = valid key

  const int tid = threadIdx.x, rg = tid >> 3, cg = tid & 7;
  const int q0 = blockIdx.x * kBlock, h = blockIdx.y, b = blockIdx.z;
  const int H = gridDim.y, D = p.D, S = p.S, T = p.T;
  const scalar_t* qb = q + b * p.q_sb + h * D;
  const scalar_t* kb = k + b * p.k_sb + h * D;
  const scalar_t* vb = v + b * p.v_sb + h * D;

  for (int idx = tid; idx < kBlock * DP; idx += kThreads) {
    const int r = idx / DP, d = idx % DP, row = q0 + r;
    Qs[r * (DP + 1) + d] =
        (row < S && d < D) ? load_f32(qb + row * p.q_ss + d) : 0.f;
  }

  float m_run[kRows], l_run[kRows], acc[kRows][kOut];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m_run[i] = -INFINITY;
    l_run[i] = 0.f;
#pragma unroll
    for (int j = 0; j < kOut; ++j) acc[i][j] = 0.f;
  }

  for (int k0 = 0; k0 < T; k0 += kBlock) {
    const int kmax = min(kBlock, T - k0);
    for (int idx = tid; idx < kBlock * DP; idx += kThreads) {
      const int r = idx / DP, d = idx % DP;
      const bool in = r < kmax && d < D;
      Ks[r * (DP + 1) + d] = in ? load_f32(kb + (k0 + r) * p.k_ss + d) : 0.f;
      Vs[r * DP + d] = in ? load_f32(vb + (k0 + r) * p.v_ss + d) : 0.f;
    }
    for (int r = tid; r < kBlock; r += kThreads) {
      Vld[r] = (r < kmax && (kv_valid == nullptr ||
                             kv_valid[(long long)b * T + k0 + r] != 0))
                   ? 1.f
                   : 0.f;
    }
    __syncthreads();

    float s[kRows][kCols];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kCols; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < DP; ++d) {
      float a[kRows], bk[kCols];
#pragma unroll
      for (int i = 0; i < kRows; ++i) a[i] = Qs[(rg * kRows + i) * (DP + 1) + d];
#pragma unroll
      for (int j = 0; j < kCols; ++j) bk[j] = Ks[key_col(cg, j) * (DP + 1) + d];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kCols; ++j) s[i][j] = fmaf(a[i], bk[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int r = rg * kRows + i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int c = key_col(cg, j);
        const float val = c >= kmax ? -INFINITY  // past T: weight exactly 0
                          : Vld[c] != 0.f ? s[i][j] * p.scale
                                          : kMaskedLogit;
        s[i][j] = val;
        mx = fmaxf(mx, val);
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
      // column k0 is always in range, so m_new is finite
      const float m_new = fmaxf(m_run[i], mx);
      const float alpha = expf(m_run[i] - m_new);  // 0 on the first tile
      const uint4 lo =
          keep_bits((k0 >> 2) + cg, q0 + r, h + p.h0, b + p.b0, p.k0, p.k1);
      const uint4 hi =
          keep_bits((k0 >> 2) + 8 + cg, q0 + r, h + p.h0, b + p.b0, p.k0, p.k1);
      float rowsum = 0.f;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const float e = expf(s[i][j] - m_new);
        rowsum += e;  // the statistics use the undropped weights
        const uint32_t bits = word(j < 4 ? lo : hi, j & 3);
        // P o keep rounded to the input dtype before P V, as `_fwd_kernel`
        // rounds it
        Ps[r * (kBlock + 1) + key_col(cg, j)] =
            bits >= p.threshold ? round_to<scalar_t>(e) : 0.f;
      }
      rowsum += __shfl_xor_sync(0xffffffffu, rowsum, 1);
      rowsum += __shfl_xor_sync(0xffffffffu, rowsum, 2);
      rowsum += __shfl_xor_sync(0xffffffffu, rowsum, 4);
      l_run[i] = l_run[i] * alpha + rowsum;
      m_run[i] = m_new;
#pragma unroll
      for (int j = 0; j < kOut; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();

    for (int kk = 0; kk < kmax; ++kk) {
      float pk[kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
        pk[i] = Ps[(rg * kRows + i) * (kBlock + 1) + kk];
#pragma unroll
      for (int j = 0; j < kOut; ++j) {
        const float vv = Vs[kk * DP + cg + 8 * j];
#pragma unroll
        for (int i = 0; i < kRows; ++i) acc[i][j] = fmaf(pk[i], vv, acc[i][j]);
      }
    }
    __syncthreads();  // the next tile overwrites Ks, Vs, Ps
  }

  const int E = H * D;
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int row = q0 + rg * kRows + i;
    if (row >= S) continue;
    const float inv = 1.f / l_run[i];
    scalar_t* orow = out + ((long long)b * S + row) * E + h * D;
#pragma unroll
    for (int j = 0; j < kOut; ++j) {
      const int col = cg + 8 * j;
      if (col < D) store_from_f32(orow + col, acc[i][j] * inv * p.inv_keep);
    }
    if (cg == 0)
      lse[((long long)b * H + h) * S + row] = m_run[i] + logf(l_run[i]);
  }
}

// --------------------------------------------------------------- backward

// D_i = dO_i . O_i per (batch, head, row), f32; one warp per row
template <typename scalar_t>
__global__ void __launch_bounds__(kThreads)
dropout_bwd_delta_kernel(const scalar_t* __restrict__ out,
                         const scalar_t* __restrict__ dout,
                         float* __restrict__ delta, int S, int D) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5);
  const int h = blockIdx.y, b = blockIdx.z, H = gridDim.y;
  if (row >= S) return;
  const long long base = ((long long)b * S + row) * (H * D) + h * D;
  float sum = 0.f;
  for (int d = lane; d < D; d += 32)
    sum += load_f32(out + base + d) * load_f32(dout + base + d);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    sum += __shfl_xor_sync(0xffffffffu, sum, off);
  if (lane == 0) delta[((long long)b * H + h) * S + row] = sum;
}

// the recomputed weight P and the dropped-weight gradient factors of one
// (query row, key) pair: pd = keep P / (1 - rate) and ds = dS (0 on a
// masked key), each rounded to the input dtype, as `_bwd_kernel` rounds
// them before the products dV = pd^T dO, dQ = dS K and dK = dS^T Q
template <typename scalar_t>
__device__ __forceinline__ void weight_and_grad(
    float s, float dp, float lse, float delta, bool key_valid, bool kept,
    float inv_T, const Params& p, float& pd, float& ds) {
  float w;
  if (lse < kAllMaskedLse) {
    w = inv_T;  // every key of the row masked: uniform weights
  } else {
    w = key_valid ? expf(s * p.scale - lse) : 0.f;
  }
  pd = round_to<scalar_t>(kept ? w * p.inv_keep : 0.f);
  ds = round_to<scalar_t>(
      key_valid ? w * ((kept ? dp * p.inv_keep : 0.f) - delta) : 0.f);
}

template <int DP>
constexpr size_t dkdv_smem() {
  // Ks, Vs, Qs, dOs [64][DP+1]; PdT, dST [BK][BQ+1]; lse, delta, rowok [BQ]
  return sizeof(float) * (4 * kBlock * (DP + 1) + 2 * kBlock * (kBlock + 1) +
                          3 * kBlock);
}

template <typename scalar_t, int DP>
__global__ void __launch_bounds__(kThreads)
dropout_bwd_dkdv_kernel(const scalar_t* __restrict__ q,
                        const scalar_t* __restrict__ k,
                        const scalar_t* __restrict__ v,
                        const uint8_t* __restrict__ kv_valid,
                        const scalar_t* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta,
                        scalar_t* __restrict__ dk, scalar_t* __restrict__ dv,
                        Params p) {
  constexpr int kOut = DP / 8;
  extern __shared__ float smem[];
  float* Ks = smem;                          // [BK][DP+1]
  float* Vs = Ks + kBlock * (DP + 1);        // [BK][DP+1]
  float* Qs = Vs + kBlock * (DP + 1);        // [BQ][DP+1]
  float* dOs = Qs + kBlock * (DP + 1);       // [BQ][DP+1]
  float* PdT = dOs + kBlock * (DP + 1);      // [BK][BQ+1], keep P/(1-rate)
  float* dST = PdT + kBlock * (kBlock + 1);  // [BK][BQ+1], dS
  float* Ls = dST + kBlock * (kBlock + 1);   // [BQ] log-sum-exp
  float* Ds = Ls + kBlock;                   // [BQ] delta
  float* Rok = Ds + kBlock;                  // [BQ], 1 = row < S

  const int tid = threadIdx.x, rg = tid >> 3, cg = tid & 7;
  const int k0 = blockIdx.x * kBlock, h = blockIdx.y, b = blockIdx.z;
  const int H = gridDim.y, D = p.D, S = p.S, T = p.T, E = H * D;
  const int kmax = min(kBlock, T - k0);
  const scalar_t* qb = q + b * p.q_sb + h * D;
  const scalar_t* kb = k + b * p.k_sb + h * D;
  const scalar_t* vb = v + b * p.v_sb + h * D;
  const scalar_t* gb = dout + (long long)b * S * E + h * D;
  const float* lse_bh = lse + ((long long)b * H + h) * S;
  const float* delta_bh = delta + ((long long)b * H + h) * S;
  const float inv_T = 1.f / (float)T;

  for (int idx = tid; idx < kBlock * DP; idx += kThreads) {
    const int r = idx / DP, d = idx % DP;
    const bool in = r < kmax && d < D;
    Ks[r * (DP + 1) + d] = in ? load_f32(kb + (k0 + r) * p.k_ss + d) : 0.f;
    Vs[r * (DP + 1) + d] = in ? load_f32(vb + (k0 + r) * p.v_ss + d) : 0.f;
  }
  // this thread's keys: 4 rg + i, all in one Philox group
  bool kval[kRows];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int c = rg * kRows + i;
    kval[i] = c < kmax && (kv_valid == nullptr ||
                           kv_valid[(long long)b * T + k0 + c] != 0);
  }

  float dk_acc[kRows][kOut], dv_acc[kRows][kOut];
#pragma unroll
  for (int i = 0; i < kRows; ++i)
#pragma unroll
    for (int j = 0; j < kOut; ++j) dk_acc[i][j] = dv_acc[i][j] = 0.f;

  for (int q0 = 0; q0 < S; q0 += kBlock) {
    const int qmax = min(kBlock, S - q0);
    for (int idx = tid; idx < kBlock * DP; idx += kThreads) {
      const int r = idx / DP, d = idx % DP;
      const bool in = r < qmax && d < D;
      Qs[r * (DP + 1) + d] = in ? load_f32(qb + (q0 + r) * p.q_ss + d) : 0.f;
      dOs[r * (DP + 1) + d] = in ? load_f32(gb + (long long)(q0 + r) * E + d)
                                 : 0.f;
    }
    for (int r = tid; r < kBlock; r += kThreads) {
      const bool in = r < qmax;
      Ls[r] = in ? lse_bh[q0 + r] : 0.f;
      Ds[r] = in ? delta_bh[q0 + r] : 0.f;
      Rok[r] = in ? 1.f : 0.f;
    }
    __syncthreads();

    // S^T and (dO V^T)^T for keys 4 rg + i and query columns cg + 8 j
    float s[kRows][kCols], dp[kRows][kCols];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kCols; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < DP; ++d) {
      float kk[kRows], vv[kRows], qq[kCols], gg[kCols];
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        kk[i] = Ks[(rg * kRows + i) * (DP + 1) + d];
        vv[i] = Vs[(rg * kRows + i) * (DP + 1) + d];
      }
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        qq[j] = Qs[(cg + 8 * j) * (DP + 1) + d];
        gg[j] = dOs[(cg + 8 * j) * (DP + 1) + d];
      }
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kCols; ++j) {
          s[i][j] = fmaf(kk[i], qq[j], s[i][j]);
          dp[i][j] = fmaf(vv[i], gg[j], dp[i][j]);
        }
    }

#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      const int r = cg + 8 * j;  // query row within the tile
      const bool row_ok = Rok[r] != 0.f;
      const uint4 bits =
          keep_bits((k0 >> 2) + rg, q0 + r, h + p.h0, b + p.b0, p.k0, p.k1);
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        float pd = 0.f, ds = 0.f;
        if (row_ok && rg * kRows + i < kmax)
          weight_and_grad<scalar_t>(s[i][j], dp[i][j], Ls[r], Ds[r],
                                    kval[i], word(bits, i) >= p.threshold,
                                    inv_T, p, pd, ds);
        PdT[(rg * kRows + i) * (kBlock + 1) + r] = pd;
        dST[(rg * kRows + i) * (kBlock + 1) + r] = ds;
      }
    }
    __syncthreads();

    // dV += (keep P / (1 - rate))^T dO ; dK += dS^T Q
    for (int r = 0; r < qmax; ++r) {
      float pd[kRows], ds[kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        pd[i] = PdT[(rg * kRows + i) * (kBlock + 1) + r];
        ds[i] = dST[(rg * kRows + i) * (kBlock + 1) + r];
      }
#pragma unroll
      for (int j = 0; j < kOut; ++j) {
        const float g = dOs[r * (DP + 1) + cg + 8 * j];
        const float qq = Qs[r * (DP + 1) + cg + 8 * j];
#pragma unroll
        for (int i = 0; i < kRows; ++i) {
          dv_acc[i][j] = fmaf(pd[i], g, dv_acc[i][j]);
          dk_acc[i][j] = fmaf(ds[i], qq, dk_acc[i][j]);
        }
      }
    }
    __syncthreads();  // the next query tile overwrites Qs, dOs, PdT, dST
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int c = rg * kRows + i;
    if (c >= kmax) continue;
    const long long off = ((long long)b * T + k0 + c) * E + h * D;
#pragma unroll
    for (int j = 0; j < kOut; ++j) {
      const int col = cg + 8 * j;
      if (col < D) {
        store_from_f32(dk + off + col, dk_acc[i][j] * p.scale);
        store_from_f32(dv + off + col, dv_acc[i][j]);
      }
    }
  }
}

template <int DP>
constexpr size_t dq_smem() {
  // Qs, dOs, Ks, Vs [64][DP+1]; dSs [BQ][BK+1]; valid [BK]
  return sizeof(float) * (4 * kBlock * (DP + 1) + kBlock * (kBlock + 1) +
                          kBlock);
}

template <typename scalar_t, int DP>
__global__ void __launch_bounds__(kThreads)
dropout_bwd_dq_kernel(const scalar_t* __restrict__ q,
                      const scalar_t* __restrict__ k,
                      const scalar_t* __restrict__ v,
                      const uint8_t* __restrict__ kv_valid,
                      const scalar_t* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta,
                      scalar_t* __restrict__ dq, Params p) {
  constexpr int kOut = DP / 8;
  extern __shared__ float smem[];
  float* Qs = smem;                        // [BQ][DP+1]
  float* dOs = Qs + kBlock * (DP + 1);     // [BQ][DP+1]
  float* Ks = dOs + kBlock * (DP + 1);     // [BK][DP+1]
  float* Vs = Ks + kBlock * (DP + 1);      // [BK][DP+1]
  float* dSs = Vs + kBlock * (DP + 1);     // [BQ][BK+1]
  float* Vld = dSs + kBlock * (kBlock + 1);  // [BK]

  const int tid = threadIdx.x, rg = tid >> 3, cg = tid & 7;
  const int q0 = blockIdx.x * kBlock, h = blockIdx.y, b = blockIdx.z;
  const int H = gridDim.y, D = p.D, S = p.S, T = p.T, E = H * D;
  const scalar_t* qb = q + b * p.q_sb + h * D;
  const scalar_t* kb = k + b * p.k_sb + h * D;
  const scalar_t* vb = v + b * p.v_sb + h * D;
  const scalar_t* gb = dout + (long long)b * S * E + h * D;
  const float inv_T = 1.f / (float)T;

  for (int idx = tid; idx < kBlock * DP; idx += kThreads) {
    const int r = idx / DP, d = idx % DP, row = q0 + r;
    const bool in = row < S && d < D;
    Qs[r * (DP + 1) + d] = in ? load_f32(qb + row * p.q_ss + d) : 0.f;
    dOs[r * (DP + 1) + d] = in ? load_f32(gb + (long long)row * E + d) : 0.f;
  }
  float lse_r[kRows], delta_r[kRows];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int row = q0 + rg * kRows + i;
    const long long at = ((long long)b * H + h) * S + row;
    lse_r[i] = row < S ? lse[at] : 0.f;
    delta_r[i] = row < S ? delta[at] : 0.f;
  }

  float acc[kRows][kOut];
#pragma unroll
  for (int i = 0; i < kRows; ++i)
#pragma unroll
    for (int j = 0; j < kOut; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < T; k0 += kBlock) {
    const int kmax = min(kBlock, T - k0);
    for (int idx = tid; idx < kBlock * DP; idx += kThreads) {
      const int r = idx / DP, d = idx % DP;
      const bool in = r < kmax && d < D;
      Ks[r * (DP + 1) + d] = in ? load_f32(kb + (k0 + r) * p.k_ss + d) : 0.f;
      Vs[r * (DP + 1) + d] = in ? load_f32(vb + (k0 + r) * p.v_ss + d) : 0.f;
    }
    for (int r = tid; r < kBlock; r += kThreads) {
      Vld[r] = (r < kmax && (kv_valid == nullptr ||
                             kv_valid[(long long)b * T + k0 + r] != 0))
                   ? 1.f
                   : 0.f;
    }
    __syncthreads();

    float s[kRows][kCols], dp[kRows][kCols];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kCols; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < DP; ++d) {
      float qq[kRows], gg[kRows], kk[kCols], vv[kCols];
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        qq[i] = Qs[(rg * kRows + i) * (DP + 1) + d];
        gg[i] = dOs[(rg * kRows + i) * (DP + 1) + d];
      }
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        kk[j] = Ks[key_col(cg, j) * (DP + 1) + d];
        vv[j] = Vs[key_col(cg, j) * (DP + 1) + d];
      }
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kCols; ++j) {
          s[i][j] = fmaf(qq[i], kk[j], s[i][j]);
          dp[i][j] = fmaf(gg[i], vv[j], dp[i][j]);
        }
    }

#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int r = rg * kRows + i, row = q0 + r;
      const uint4 lo =
          keep_bits((k0 >> 2) + cg, row, h + p.h0, b + p.b0, p.k0, p.k1);
      const uint4 hi =
          keep_bits((k0 >> 2) + 8 + cg, row, h + p.h0, b + p.b0, p.k0, p.k1);
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int c = key_col(cg, j);
        float pd = 0.f, ds = 0.f;
        if (row < S && c < kmax)
          weight_and_grad<scalar_t>(
              s[i][j], dp[i][j], lse_r[i], delta_r[i], Vld[c] != 0.f,
              word(j < 4 ? lo : hi, j & 3) >= p.threshold, inv_T, p, pd, ds);
        dSs[r * (kBlock + 1) + c] = ds;
      }
    }
    __syncthreads();

    // dQ += dS K over the keys of this tile
    for (int c = 0; c < kmax; ++c) {
      float ds[kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
        ds[i] = dSs[(rg * kRows + i) * (kBlock + 1) + c];
#pragma unroll
      for (int j = 0; j < kOut; ++j) {
        const float kk = Ks[c * (DP + 1) + cg + 8 * j];
#pragma unroll
        for (int i = 0; i < kRows; ++i) acc[i][j] = fmaf(ds[i], kk, acc[i][j]);
      }
    }
    __syncthreads();  // the next tile overwrites Ks, Vs, dSs
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int row = q0 + rg * kRows + i;
    if (row >= S) continue;
    scalar_t* drow = dq + ((long long)b * S + row) * E + h * D;
#pragma unroll
    for (int j = 0; j < kOut; ++j) {
      const int col = cg + 8 * j;
      if (col < D) store_from_f32(drow + col, acc[i][j] * p.scale);
    }
  }
}

// ------------------------------------------- tensor-core bodies (bf16)

// Forward: mma_sm90.cuh's flash_fwd_body with dropout. One block per (64
// query rows, head, batch); the body that K1 and K3 run without it. Up to
// head dim 64, three blocks an SM (at most 168 registers a thread, where
// the compiler would take 184 and fit two), so that more warps hide the
// latency of the Philox draws; at 128 that cap would spill.
template <int DP>
__global__ void __launch_bounds__(kTcThreads, DP <= 64 ? 3 : 1)
dropout_tc_fwd_kernel(const __nv_bfloat16* __restrict__ q,
                      const __nv_bfloat16* __restrict__ k,
                      const __nv_bfloat16* __restrict__ v,
                      const uint8_t* __restrict__ kv_valid,
                      __nv_bfloat16* __restrict__ out, int S, int T, int D,
                      Strides qs, Strides ks, Strides vs, Strides os,
                      float scale_log2, FlashDropout dr) {
  flash_fwd_body<DP, true>(q, k, v, kv_valid, out, S, T, D, qs, ks, vs, os,
                           scale_log2, dr);
}

template <int DP>
struct TcDqSmem {
  // Q, dO, K[2], V[2], then the key flags [2][64]
  static constexpr size_t kBytes = 6 * TcTile<DP>::kBytes + 2 * 64;
};

// Backward, dQ. One block per (64 query rows, head, batch), warps as in the
// forward. Two passes over the 64-key tiles, each recomputing S = Q K^T
// and dP = dO V^T on the tensor cores and W from the saved log-sum-exp,
// with keep read from the packed mask: the first sums delta = rowsum(dW o
// W) with dW = keep o dP / (1 - rate), in f32 as the JAX kernel does
// (stored for the dK/dV kernel, which runs after this one); the second
// forms dS = W o (dW - delta) and dQ += dS K with dS rounded to bf16.
// dQ = scale dQ, rounded once.
template <int DP>
__global__ void __launch_bounds__(kTcThreads)
dropout_tc_bwd_dq_kernel(const __nv_bfloat16* __restrict__ q,
                         const __nv_bfloat16* __restrict__ k,
                         const __nv_bfloat16* __restrict__ v,
                         const uint8_t* __restrict__ kv_valid,
                         const __nv_bfloat16* __restrict__ dout,
                         const float* __restrict__ lse,
                         const uint32_t* __restrict__ bits,
                         float* __restrict__ delta,
                         __nv_bfloat16* __restrict__ dq, Params p) {
  using Tile = TcTile<DP>;
  constexpr int KS = DP / 16, ND = DP / 8;
  constexpr uint32_t kTileBytes = Tile::kBytes;
  extern __shared__ __align__(16) __nv_bfloat16 tc_smem[];
  uint8_t* flags = reinterpret_cast<uint8_t*>(tc_smem + 6 * Tile::kElems);
  const uint32_t q_addr = smem_u32(tc_smem);
  const uint32_t g_addr = q_addr + kTileBytes;
  const uint32_t k_addr = g_addr + kTileBytes;
  const uint32_t v_addr = k_addr + 2 * kTileBytes;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int q0 = blockIdx.x * 64, h = blockIdx.y, b = blockIdx.z;
  const int H = gridDim.y, S = p.S, T = p.T, D = p.D, E = H * D;
  const long long bh = (long long)b * H + h;
  const __nv_bfloat16* qb = q + b * p.q_sb + h * D;
  const __nv_bfloat16* kb = k + b * p.k_sb + h * D;
  const __nv_bfloat16* vb = v + b * p.v_sb + h * D;
  const __nv_bfloat16* gb = dout + (long long)b * S * E + h * D;
  const uint8_t* valid =
      kv_valid == nullptr ? nullptr : kv_valid + (long long)b * T;
  const float scale_log2 = p.scale * kLog2e;
  const int nw = mask_words(T);

  load_tile<DP>(q_addr, qb, p.q_ss, q0, S, D);
  load_tile<DP>(g_addr, gb, E, q0, S, D);
  load_tile<DP>(k_addr, kb, p.k_ss, 0, T, D);
  load_tile<DP>(v_addr, vb, p.v_ss, 0, T, D);
  cp_async_commit();
  if (threadIdx.x < 64) flags[threadIdx.x] = key_flag(valid, threadIdx.x, T);

  const int c2 = 2 * (lane & 3);
  const int row0 = q0 + warp * 16 + (lane >> 2);
  float lse2[2], dlt[2] = {0.f, 0.f};
#pragma unroll
  for (int r = 0; r < 2; ++r)
    lse2[r] = row0 + 8 * r < S ? lse[bh * S + row0 + 8 * r] * kLog2e : 0.f;

  uint32_t qf[KS][4], gf[KS][4];
  float acc[ND][4];
#pragma unroll
  for (int j = 0; j < ND; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  // step i runs key tile i % nt of pass i / nt
  const int nt = (T + 63) / 64;
  for (int step = 0; step < 2 * nt; ++step) {
    const int it = step % nt, buf = step & 1;
    const bool second = step >= nt;
    cp_async_wait_all();
    __syncthreads();  // tile landed; every warp is done with the last one
    if (step == 0) {
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        ldsm_a<DP>(qf[kk], q_addr, warp, lane, kk);
        ldsm_a<DP>(gf[kk], g_addr, warp, lane, kk);
      }
    }
    if (step == nt) {  // delta complete: summed over the quad, stored
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        dlt[r] += __shfl_xor_sync(0xffffffffu, dlt[r], 1);
        dlt[r] += __shfl_xor_sync(0xffffffffu, dlt[r], 2);
        if ((lane & 3) == 0 && row0 + 8 * r < S)
          delta[bh * S + row0 + 8 * r] = dlt[r];
      }
    }
    uint8_t next_flag = 0;
    if (step + 1 < 2 * nt) {
      const int k1 = ((step + 1) % nt) * 64;
      load_tile<DP>(k_addr + (buf ^ 1) * kTileBytes, kb, p.k_ss, k1, T, D);
      load_tile<DP>(v_addr + (buf ^ 1) * kTileBytes, vb, p.v_ss, k1, T, D);
      cp_async_commit();
      if (threadIdx.x < 64) next_flag = key_flag(valid, k1 + threadIdx.x, T);
    }
    // this tile's keep words (2 it, 2 it + 1) of rows row0 and row0 + 8
    uint32_t kw[2][2];
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int w = 0; w < 2; ++w) {
        const int row = row0 + 8 * r, word = 2 * it + w;
        kw[r][w] = row < S && word < nw ? bits[(bh * S + row) * nw + word] : 0u;
      }

    // S = Q K^T and dP = dO V^T for this warp's 16 rows x 64 keys
    float sc[8][4], dp[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[j][e] = dp[j][e] = 0.f;
    const uint32_t kt = k_addr + buf * kTileBytes;
    const uint32_t vt = v_addr + buf * kTileBytes;
#pragma unroll
    for (int pp = 0; pp < 4; ++pp) {
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        uint32_t r[4];
        ldsm_b_rows<DP>(r, kt, lane, pp, kk);
        mma_bf16(sc[2 * pp], qf[kk], r[0], r[1]);
        mma_bf16(sc[2 * pp + 1], qf[kk], r[2], r[3]);
        ldsm_b_rows<DP>(r, vt, lane, pp, kk);
        mma_bf16(dp[2 * pp], gf[kk], r[0], r[1]);
        mma_bf16(dp[2 * pp + 1], gf[kk], r[2], r[3]);
      }
    }

    // W = 0 on masked keys and keys past T (so a row whose keys are all
    // masked takes no gradient); dW = keep o dP / (1 - rate)
    const uint8_t* fl = flags + buf * 64;
    const bool plain_tile = valid == nullptr && it * 64 + 64 <= T;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1, col = 8 * j + c2 + (e & 1);
        float x = sc[j][e] * scale_log2;
        if (!plain_tile && fl[col] != 2) x = -INFINITY;
        const float w = fast_exp2(x - lse2[r]);
        const bool kept = (kw[r][j >> 2] >> (8 * (j & 3) + c2 + (e & 1))) & 1u;
        const float dw = kept ? dp[j][e] * p.inv_keep : 0.f;
        if (second)
          sc[j][e] = w * (dw - dlt[r]);
        else
          dlt[r] = fmaf(dw, w, dlt[r]);
      }
    }

    if (second) {  // dQ += dS K: dS rounded to bf16 as the A operand
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint32_t a[4] = {pack_bf16(sc[2 * kk][0], sc[2 * kk][1]),
                               pack_bf16(sc[2 * kk][2], sc[2 * kk][3]),
                               pack_bf16(sc[2 * kk + 1][0], sc[2 * kk + 1][1]),
                               pack_bf16(sc[2 * kk + 1][2], sc[2 * kk + 1][3])};
#pragma unroll
        for (int jj = 0; jj < KS; ++jj) {
          uint32_t r[4];
          ldsm_b_cols<DP>(r, kt, lane, kk, jj);
          mma_bf16(acc[2 * jj], a, r[0], r[1]);
          mma_bf16(acc[2 * jj + 1], a, r[2], r[3]);
        }
      }
    }
    if (step + 1 < 2 * nt && threadIdx.x < 64)
      flags[(buf ^ 1) * 64 + threadIdx.x] = next_flag;
  }

  store_rows<DP>(acc, p.scale, p.scale, tc_smem + warp * 16 * Tile::kLd,
                 dq + (long long)b * S * E + h * D, E, q0 + warp * 16, S, D,
                 lane);
}

template <int DP>
struct TcDkdvSmem {
  // K, V, Q[2], dO[2], then lse [2][64] and delta [2][64] f32, the keep
  // words [2][64][2] and the key flags [64]
  static constexpr size_t kBytes =
      6 * TcTile<DP>::kBytes + 4 * 64 * 4 + 2 * 128 * 4 + 64;
};

// Backward, dK and dV. One block per (64 keys, head, batch); warp w owns
// keys 16 w .. + 15 and loops over 64-query tiles (Q, dO, their
// log-sum-exp, delta and keep words in a double-buffered cp.async ring):
// S^T = K Q^T and dP^T = V dO^T on the tensor cores, P^T from the saved
// log-sum-exp, then dV += (keep o P / (1 - rate))^T dO and dK += dS^T Q,
// both A operands rounded to bf16 from the accumulator registers.
// dK = scale dK; both rounded once.
template <int DP>
__global__ void __launch_bounds__(kTcThreads)
dropout_tc_bwd_dkdv_kernel(const __nv_bfloat16* __restrict__ q,
                           const __nv_bfloat16* __restrict__ k,
                           const __nv_bfloat16* __restrict__ v,
                           const uint8_t* __restrict__ kv_valid,
                           const __nv_bfloat16* __restrict__ dout,
                           const float* __restrict__ lse,
                           const float* __restrict__ delta,
                           const uint32_t* __restrict__ bits,
                           __nv_bfloat16* __restrict__ dk,
                           __nv_bfloat16* __restrict__ dv, Params p) {
  using Tile = TcTile<DP>;
  constexpr int KS = DP / 16, ND = DP / 8;
  constexpr uint32_t kTileBytes = Tile::kBytes;
  extern __shared__ __align__(16) __nv_bfloat16 tc_smem[];
  float* ls = reinterpret_cast<float*>(tc_smem + 6 * Tile::kElems);  // [2][64]
  float* dls = ls + 2 * 64;                                          // [2][64]
  uint32_t* ws = reinterpret_cast<uint32_t*>(dls + 2 * 64);  // [2][64][2]
  uint8_t* flags = reinterpret_cast<uint8_t*>(ws + 2 * 128);  // [64]
  const uint32_t k_addr = smem_u32(tc_smem);
  const uint32_t v_addr = k_addr + kTileBytes;
  const uint32_t q_addr = v_addr + kTileBytes;
  const uint32_t g_addr = q_addr + 2 * kTileBytes;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int k0 = blockIdx.x * 64, h = blockIdx.y, b = blockIdx.z;
  const int H = gridDim.y, S = p.S, T = p.T, D = p.D, E = H * D;
  const long long bh = (long long)b * H + h;
  const __nv_bfloat16* qb = q + b * p.q_sb + h * D;
  const __nv_bfloat16* kb = k + b * p.k_sb + h * D;
  const __nv_bfloat16* vb = v + b * p.v_sb + h * D;
  const __nv_bfloat16* gb = dout + (long long)b * S * E + h * D;
  const float* lse_bh = lse + bh * S;
  const float* delta_bh = delta + bh * S;
  const int nw = mask_words(T);
  const uint32_t* bits_bh = bits + bh * S * nw;
  const uint8_t* valid =
      kv_valid == nullptr ? nullptr : kv_valid + (long long)b * T;
  const float scale_log2 = p.scale * kLog2e;

  // Q, dO, log-sum-exp, delta and the keep words of the block's keys
  // (words k0 / 32 and k0 / 32 + 1) for query tile `it`, into slot buf
  auto load_queries = [&](int it, int buf) {
    const int s0 = it * 64, t = threadIdx.x;
    load_tile<DP>(q_addr + buf * kTileBytes, qb, p.q_ss, s0, S, D);
    load_tile<DP>(g_addr + buf * kTileBytes, gb, E, s0, S, D);
    const int r = t & 63;
    const bool in = s0 + r < S;
    cp_async4(smem_u32((t < 64 ? ls : dls) + buf * 64 + r),
              (t < 64 ? lse_bh : delta_bh) + (in ? s0 + r : 0), in);
    const int row = s0 + (t >> 1), word = (k0 >> 5) + (t & 1);
    const bool win = row < S && word < nw;
    cp_async4(smem_u32(ws + buf * 128 + t),
              bits_bh + (win ? (long long)row * nw + word : 0), win);
  };

  load_tile<DP>(k_addr, kb, p.k_ss, k0, T, D);
  load_tile<DP>(v_addr, vb, p.v_ss, k0, T, D);
  load_queries(0, 0);
  cp_async_commit();
  if (threadIdx.x < 64)
    flags[threadIdx.x] = key_flag(valid, k0 + threadIdx.x, T);
  // every key of this batch row masked: each row's weights are 1/T (K1's
  // mean(V) semantics, then dropout) and dS = 0; the forward's log-sum-exp
  // says so for every row alike
  const bool dead = lse_bh[0] < kAllMaskedLse;
  const float inv_T = 1.f / (float)T;

  // this lane's keys kl and kl + 8 (in the block) lie in one keep word
  const int c2 = 2 * (lane & 3);
  const int kl = warp * 16 + (lane >> 2), wl = kl >> 5;
  const int kbit[2] = {kl & 31, (kl + 8) & 31};
  uint8_t fk[2] = {0, 0};

  float dk_acc[ND][4], dv_acc[ND][4];
#pragma unroll
  for (int j = 0; j < ND; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[j][e] = dv_acc[j][e] = 0.f;

  const int nt = (S + 63) / 64;
  for (int it = 0; it < nt; ++it) {
    const int buf = it & 1;
    cp_async_wait_all();
    __syncthreads();  // tile it landed; every warp is done with tile it - 1
    if (it == 0) {
      fk[0] = flags[kl];
      fk[1] = flags[kl + 8];
    }
    if (it + 1 < nt) {
      load_queries(it + 1, buf ^ 1);
      cp_async_commit();
    }

    // S^T = K Q^T and dP^T = V dO^T for this warp's 16 keys x 64 queries
    float sc[8][4], dp[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[j][e] = dp[j][e] = 0.f;
    const uint32_t qt = q_addr + buf * kTileBytes;
    const uint32_t gt = g_addr + buf * kTileBytes;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      uint32_t ka[4], va[4];
      ldsm_a<DP>(ka, k_addr, warp, lane, kk);
      ldsm_a<DP>(va, v_addr, warp, lane, kk);
#pragma unroll
      for (int pp = 0; pp < 4; ++pp) {
        uint32_t r[4];
        ldsm_b_rows<DP>(r, qt, lane, pp, kk);
        mma_bf16(sc[2 * pp], ka, r[0], r[1]);
        mma_bf16(sc[2 * pp + 1], ka, r[2], r[3]);
        ldsm_b_rows<DP>(r, gt, lane, pp, kk);
        mma_bf16(dp[2 * pp], va, r[0], r[1]);
        mma_bf16(dp[2 * pp + 1], va, r[2], r[3]);
      }
    }

    // per (key, query): W from the log-sum-exp, then sc <- dS^T and
    // dp <- keep o W / (1 - rate)
    const float* lt = ls + buf * 64;
    const float* dt = dls + buf * 64;
    const uint32_t* wt = ws + buf * 128;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e2 = 0; e2 < 2; ++e2) {
        const int col = 8 * j + c2 + e2;
        const float lse2 = lt[col] * kLog2e, dlt = dt[col];
        const uint32_t word = wt[2 * col + wl];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int e = 2 * r + e2;
          const bool kept = (word >> kbit[r]) & 1u;
          float w, dsv;
          if (dead) {
            w = fk[r] != 0 ? inv_T : 0.f;
            dsv = 0.f;
          } else {
            w = fast_exp2((fk[r] == 2 ? sc[j][e] * scale_log2 : -INFINITY) -
                          lse2);
            dsv = w * ((kept ? dp[j][e] * p.inv_keep : 0.f) - dlt);
          }
          sc[j][e] = dsv;
          dp[j][e] = kept ? w * p.inv_keep : 0.f;
        }
      }
    }

    // dV += (keep o W / (1 - rate))^T dO and dK += dS^T Q, 16 queries a
    // step, the A operands rounded to bf16
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint32_t aw[4] = {pack_bf16(dp[2 * kk][0], dp[2 * kk][1]),
                              pack_bf16(dp[2 * kk][2], dp[2 * kk][3]),
                              pack_bf16(dp[2 * kk + 1][0], dp[2 * kk + 1][1]),
                              pack_bf16(dp[2 * kk + 1][2], dp[2 * kk + 1][3])};
      const uint32_t as[4] = {pack_bf16(sc[2 * kk][0], sc[2 * kk][1]),
                              pack_bf16(sc[2 * kk][2], sc[2 * kk][3]),
                              pack_bf16(sc[2 * kk + 1][0], sc[2 * kk + 1][1]),
                              pack_bf16(sc[2 * kk + 1][2], sc[2 * kk + 1][3])};
#pragma unroll
      for (int jj = 0; jj < KS; ++jj) {
        uint32_t r[4];
        ldsm_b_cols<DP>(r, gt, lane, kk, jj);
        mma_bf16(dv_acc[2 * jj], aw, r[0], r[1]);
        mma_bf16(dv_acc[2 * jj + 1], aw, r[2], r[3]);
        ldsm_b_cols<DP>(r, qt, lane, kk, jj);
        mma_bf16(dk_acc[2 * jj], as, r[0], r[1]);
        mma_bf16(dk_acc[2 * jj + 1], as, r[2], r[3]);
      }
    }
  }

  // staged in this warp's own rows of the K and V tiles
  const long long off = (long long)b * T * E + h * D;
  store_rows<DP>(dk_acc, p.scale, p.scale, tc_smem + warp * 16 * Tile::kLd,
                 dk + off, E, k0 + warp * 16, T, D, lane);
  store_rows<DP>(dv_acc, 1.f, 1.f,
                 tc_smem + Tile::kElems + warp * 16 * Tile::kLd, dv + off, E,
                 k0 + warp * 16, T, D, lane);
}

// ------------------------------------------------------------- launchers

struct Ptrs {
  const void *q, *k, *v, *kv_valid, *out, *dout;
  void *lse, *delta, *dq, *dk, *dv, *o, *bits;
};

template <int DP>
cudaError_t launch_tc_fwd(const Ptrs& t, int B, int H, const Params& p,
                          cudaStream_t st) {
  auto kern = dropout_tc_fwd_kernel<DP>;
  constexpr size_t smem = TcFlashSmem<DP>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const long long E = (long long)H * p.D;
  kern<<<dim3((p.S + 63) / 64, H, B), kTcThreads, smem, st>>>(
      static_cast<const __nv_bfloat16*>(t.q),
      static_cast<const __nv_bfloat16*>(t.k),
      static_cast<const __nv_bfloat16*>(t.v),
      static_cast<const uint8_t*>(t.kv_valid),
      static_cast<__nv_bfloat16*>(t.o), p.S, p.T, p.D,
      Strides{p.q_sb, p.D, p.q_ss}, Strides{p.k_sb, p.D, p.k_ss},
      Strides{p.v_sb, p.D, p.v_ss}, Strides{p.S * E, p.D, E},
      p.scale * kLog2e,
      FlashDropout{static_cast<float*>(t.lse), static_cast<uint32_t*>(t.bits),
                   p.threshold, p.k0, p.k1, p.inv_keep, p.b0, p.h0});
  return cudaGetLastError();
}

// dQ first: its prologue writes the delta that the dK/dV kernel reads
template <int DP>
cudaError_t launch_tc_bwd(const Ptrs& t, int B, int H, const Params& p,
                          cudaStream_t st) {
  auto dqk = dropout_tc_bwd_dq_kernel<DP>;
  constexpr size_t smem_q = TcDqSmem<DP>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      dqk, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_q);
  if (err != cudaSuccess) return err;
  dqk<<<dim3((p.S + 63) / 64, H, B), kTcThreads, smem_q, st>>>(
      static_cast<const __nv_bfloat16*>(t.q),
      static_cast<const __nv_bfloat16*>(t.k),
      static_cast<const __nv_bfloat16*>(t.v),
      static_cast<const uint8_t*>(t.kv_valid),
      static_cast<const __nv_bfloat16*>(t.dout),
      static_cast<const float*>(t.lse), static_cast<const uint32_t*>(t.bits),
      static_cast<float*>(t.delta), static_cast<__nv_bfloat16*>(t.dq), p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  auto dkdv = dropout_tc_bwd_dkdv_kernel<DP>;
  constexpr size_t smem_kv = TcDkdvSmem<DP>::kBytes;
  err = cudaFuncSetAttribute(
      dkdv, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_kv);
  if (err != cudaSuccess) return err;
  dkdv<<<dim3((p.T + 63) / 64, H, B), kTcThreads, smem_kv, st>>>(
      static_cast<const __nv_bfloat16*>(t.q),
      static_cast<const __nv_bfloat16*>(t.k),
      static_cast<const __nv_bfloat16*>(t.v),
      static_cast<const uint8_t*>(t.kv_valid),
      static_cast<const __nv_bfloat16*>(t.dout),
      static_cast<const float*>(t.lse), static_cast<const float*>(t.delta),
      static_cast<const uint32_t*>(t.bits),
      static_cast<__nv_bfloat16*>(t.dk), static_cast<__nv_bfloat16*>(t.dv),
      p);
  return cudaGetLastError();
}

template <typename scalar_t, int DP>
cudaError_t launch_fwd(const Ptrs& t, int B, int H, const Params& p,
                       cudaStream_t st) {
  auto kern = dropout_fwd_kernel<scalar_t, DP>;
  constexpr size_t smem = fwd_smem<DP>();
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((p.S + kBlock - 1) / kBlock, H, B);
  kern<<<grid, kThreads, smem, st>>>(
      static_cast<const scalar_t*>(t.q), static_cast<const scalar_t*>(t.k),
      static_cast<const scalar_t*>(t.v),
      static_cast<const uint8_t*>(t.kv_valid), static_cast<scalar_t*>(t.o),
      static_cast<float*>(t.lse), p);
  return cudaGetLastError();
}

template <typename scalar_t, int DP>
cudaError_t launch_bwd(const Ptrs& t, int B, int H, const Params& p,
                       cudaStream_t st) {
  dropout_bwd_delta_kernel<scalar_t>
      <<<dim3((p.S + 3) / 4, H, B), kThreads, 0, st>>>(
          static_cast<const scalar_t*>(t.out),
          static_cast<const scalar_t*>(t.dout), static_cast<float*>(t.delta),
          p.S, p.D);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  auto dkdv = dropout_bwd_dkdv_kernel<scalar_t, DP>;
  constexpr size_t smem_kv = dkdv_smem<DP>();
  err = cudaFuncSetAttribute(
      dkdv, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_kv);
  if (err != cudaSuccess) return err;
  dkdv<<<dim3((p.T + kBlock - 1) / kBlock, H, B), kThreads, smem_kv, st>>>(
      static_cast<const scalar_t*>(t.q), static_cast<const scalar_t*>(t.k),
      static_cast<const scalar_t*>(t.v),
      static_cast<const uint8_t*>(t.kv_valid),
      static_cast<const scalar_t*>(t.dout), static_cast<const float*>(t.lse),
      static_cast<const float*>(t.delta), static_cast<scalar_t*>(t.dk),
      static_cast<scalar_t*>(t.dv), p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  auto dqk = dropout_bwd_dq_kernel<scalar_t, DP>;
  constexpr size_t smem_q = dq_smem<DP>();
  err = cudaFuncSetAttribute(
      dqk, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_q);
  if (err != cudaSuccess) return err;
  dqk<<<dim3((p.S + kBlock - 1) / kBlock, H, B), kThreads, smem_q, st>>>(
      static_cast<const scalar_t*>(t.q), static_cast<const scalar_t*>(t.k),
      static_cast<const scalar_t*>(t.v),
      static_cast<const uint8_t*>(t.kv_valid),
      static_cast<const scalar_t*>(t.dout), static_cast<const float*>(t.lse),
      static_cast<const float*>(t.delta), static_cast<scalar_t*>(t.dq), p);
  return cudaGetLastError();
}

bool aligned16(const void* x) {
  return reinterpret_cast<uintptr_t>(x) % 16 == 0;
}

// what the Python route admits for the tensor-core body; anything else is
// refused, not computed
bool tc_admits(const Ptrs& t, const Params& p, bool backward) {
  if (p.D < 8 || p.D > 128 || p.D % 8) return false;
  if ((p.q_sb | p.q_ss | p.k_sb | p.k_ss | p.v_sb | p.v_ss) % 8) return false;
  if (!aligned16(t.q) || !aligned16(t.k) || !aligned16(t.v) ||
      t.bits == nullptr)
    return false;
  if (backward)
    return aligned16(t.dout) && aligned16(t.dq) && aligned16(t.dk) &&
           aligned16(t.dv);
  return aligned16(t.o);
}

template <bool kBackward>
cudaError_t dispatch_tc(const Ptrs& t, int B, int H, const Params& p,
                        cudaStream_t st) {
  if (!tc_admits(t, p, kBackward)) return cudaErrorInvalidValue;
  if (p.D <= 16)
    return kBackward ? launch_tc_bwd<16>(t, B, H, p, st)
                     : launch_tc_fwd<16>(t, B, H, p, st);
  if (p.D <= 32)
    return kBackward ? launch_tc_bwd<32>(t, B, H, p, st)
                     : launch_tc_fwd<32>(t, B, H, p, st);
  if (p.D <= 64)
    return kBackward ? launch_tc_bwd<64>(t, B, H, p, st)
                     : launch_tc_fwd<64>(t, B, H, p, st);
  return kBackward ? launch_tc_bwd<128>(t, B, H, p, st)
                   : launch_tc_fwd<128>(t, B, H, p, st);
}

template <typename scalar_t, bool kBackward>
cudaError_t dispatch(const Ptrs& t, int B, int H, const Params& p,
                     cudaStream_t st) {
  // the smallest compiled tile width that holds the head dim; the
  // backward reads the forward's output for delta
  if (p.D < 1 || p.D > 128 || (kBackward && t.out == nullptr))
    return cudaErrorInvalidValue;
  if (p.D <= 16)
    return kBackward ? launch_bwd<scalar_t, 16>(t, B, H, p, st)
                     : launch_fwd<scalar_t, 16>(t, B, H, p, st);
  if (p.D <= 32)
    return kBackward ? launch_bwd<scalar_t, 32>(t, B, H, p, st)
                     : launch_fwd<scalar_t, 32>(t, B, H, p, st);
  if (p.D <= 64)
    return kBackward ? launch_bwd<scalar_t, 64>(t, B, H, p, st)
                     : launch_fwd<scalar_t, 64>(t, B, H, p, st);
  return kBackward ? launch_bwd<scalar_t, 128>(t, B, H, p, st)
                   : launch_fwd<scalar_t, 128>(t, B, H, p, st);
}

template <bool kBackward>
int run(int dtype, int body, const Ptrs& t, int B, int H, const Params& p,
        void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (body == 1) {
    if (dtype != 1) return (int)cudaErrorInvalidValue;
    return (int)dispatch_tc<kBackward>(t, B, H, p, st);
  }
  if (body != 0) return (int)cudaErrorInvalidValue;
  if (dtype == 0) return (int)dispatch<float, kBackward>(t, B, H, p, st);
  if (dtype == 1)
    return (int)dispatch<__nv_bfloat16, kBackward>(t, B, H, p, st);
  return (int)cudaErrorInvalidValue;
}

Params make_params(int S, int T, int D, long long q_sb, long long q_ss,
                   long long k_sb, long long k_ss, long long v_sb,
                   long long v_ss, float scale, float inv_keep,
                   unsigned threshold, unsigned seed_lo, unsigned seed_hi,
                   int batch_offset, int head_offset) {
  Params p;
  p.S = S; p.T = T; p.D = D;
  p.q_sb = q_sb; p.q_ss = q_ss; p.k_sb = k_sb; p.k_ss = k_ss;
  p.v_sb = v_sb; p.v_ss = v_ss;
  p.scale = scale; p.inv_keep = inv_keep;
  p.threshold = threshold; p.k0 = seed_lo; p.k1 = seed_hi;
  p.b0 = batch_offset;
  p.h0 = head_offset;
  return p;
}

}  // namespace

// Plain C entry points, bound with ctypes. Pointers are device pointers;
// q/k/v rows are (batch stride, row stride) addressed with unit column
// stride; out, dout, dq, dk and dv are contiguous (B, L, H*D); lse and
// delta are contiguous (B, H, S) f32; kv_valid is (B, T) uint8 or null;
// bits is the packed keep mask (B, H, S, ceil(T / 32)) uint32, written by
// the tensor-core forward and read by the tensor-core backward (null on
// the scalar body); the backward's out, the forward's output, is read by
// the scalar backward only (null on the tensor-core body). dtype: 0 = float32, 1 = bfloat16; body: 0 = the scalar
// kernels, 1 = the tensor-core kernels (bf16 only, D a multiple of 8 up to
// 128, 16-byte aligned bases, strides multiples of 8 elements; anything
// else returns cudaErrorInvalidValue). batch_offset is added to the batch
// row wherever the keep bits are drawn: the global row of batch row 0 under
// data parallel, 0 on one process; head_offset likewise to the head: the
// global head of head 0 under tensor parallel, 0 on one process. Each returns the cudaError_t of its
// launches (the scalar backward launches three kernels: delta, dK/dV, dQ;
// the tensor-core one two: dQ with delta, then dK/dV).
extern "C" int cris_attention_dropout_fwd(
    const void* q, const void* k, const void* v, const void* kv_valid,
    void* out, void* lse, void* bits, int B, int S, int T, int H, int D,
    int dtype, int body, long long q_sb, long long q_ss, long long k_sb,
    long long k_ss, long long v_sb, long long v_ss, float scale,
    float inv_keep, unsigned threshold, unsigned seed_lo, unsigned seed_hi,
    int batch_offset, int head_offset, void* stream) {
  Ptrs t{};
  t.q = q; t.k = k; t.v = v; t.kv_valid = kv_valid; t.o = out; t.lse = lse;
  t.bits = bits;
  return run<false>(dtype, body, t, B, H,
                    make_params(S, T, D, q_sb, q_ss, k_sb, k_ss, v_sb, v_ss,
                                scale, inv_keep, threshold, seed_lo, seed_hi,
                                batch_offset, head_offset),
                    stream);
}

extern "C" int cris_attention_dropout_bwd(
    const void* q, const void* k, const void* v, const void* kv_valid,
    const void* out, const void* lse, const void* bits, const void* dout,
    void* delta, void* dq, void* dk, void* dv, int B, int S, int T, int H,
    int D, int dtype, int body, long long q_sb, long long q_ss,
    long long k_sb, long long k_ss, long long v_sb, long long v_ss,
    float scale, float inv_keep, unsigned threshold, unsigned seed_lo,
    unsigned seed_hi, int batch_offset, int head_offset, void* stream) {
  Ptrs t{};
  t.q = q; t.k = k; t.v = v; t.kv_valid = kv_valid; t.out = out;
  t.lse = const_cast<void*>(lse); t.dout = dout; t.delta = delta;
  t.dq = dq; t.dk = dk; t.dv = dv; t.bits = const_cast<void*>(bits);
  return run<true>(dtype, body, t, B, H,
                   make_params(S, T, D, q_sb, q_ss, k_sb, k_ss, v_sb, v_ss,
                               scale, inv_keep, threshold, seed_lo, seed_hi,
                               batch_offset, head_offset),
                   stream);
}
