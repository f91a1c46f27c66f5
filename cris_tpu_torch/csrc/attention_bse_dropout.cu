// K2: fused multi-head softmax attention over (B, S, E) projections with
// inverted dropout on the attention weights, forward and backward.
//
// Replaces the TPU kernels of `fused_attention_bse_dropout`
// (cris_tpu/ops/pallas/attention_train.py:185): the forward `pallas_call`
// at :218 (body `_fwd_kernel` :71) and the backward one at :248 (body
// `_bwd_kernel` :92). Same math, per head h with D columns:
//   P = softmax(q k^T * D^-1/2, masked keys = -1e30)      (f32)
//   O = (keep o P) V / (1 - rate)
// where keep is the dropout mask. Forward and backward regenerate keep
// from the seed and never store it. The bits come from Philox4x32-10 with
// counter (j >> 2, i, h, b) and key (seed mod 2^32, seed >> 32), word
// j & 3, for query row i and key column j; a weight is kept iff its bits
// are >= min(int(rate * 2^32), 2^32 - 1), the JAX kernel's threshold.
// cris_tpu_torch/ops/kernels/dropout_mask.py computes the same bits in
// torch integer ops (the plain version's mask); the two agree bit for
// bit. The TPU's own bits cannot be reproduced here.
//
// Design for Hopper (not a copy of the TPU blocking):
// - The TPU kernels hold one (batch, head pair)'s whole (S_pad, T_pad) f32
//   logits in VMEM: 768 x 768 x 4 B = 2.4 MB per head at the decoder's
//   self-attention, ten times a block's 227 KB of shared memory. Here every
//   kernel streams 64 x 64 tiles through shared memory.
// - Forward: one block per (batch, head, 64-query tile) loops over 64-key
//   tiles with an online softmax, as K1 does. The running max and sum come
//   from the undropped weights; the P V product takes keep o p; the output
//   is acc / l / (1 - rate). The row log-sum-exp (B, H, S) is written in
//   f32 for the backward.
// - Backward: with W the normalised weights and dW the gradient of the
//   dropped weights, rowsum(dW o W) = rowsum(dO o O), with dropout too. So
//   a first kernel computes D_i = dO_i . O_i (B, H, S), and
//     dS = P o (keep o (dO V^T) / (1 - rate) - D),
//   P recomputed from the saved log-sum-exp. A second kernel, one block per
//   (batch, head, 64-key tile), loops over the query tiles and accumulates
//   dK and dV in registers; a third, one block per (batch, head, 64-query
//   tile), loops over the key tiles for dQ. No atomics: the gradients are
//   the same bits from run to run.
// - Thread layout (128 threads): thread t owns 4 rows of its tile,
//   4 * (t / 8) .. + 3, and 8 columns of the 64-wide other side. Where the
//   columns are keys they are 4 (t % 8) + {0..3} and 32 + 4 (t % 8) +
//   {0..3}, so that one Philox call gives the bits of 4 neighbouring key
//   columns; in the dK/dV kernel the 4 rows are 4 neighbouring keys, so
//   one call gives a row's 4 bits there too. Shared rows are padded by
//   one float so that the strided reads fall in distinct banks.
//
// What bounds it on the card: as K1, the products are scalar f32 FMAs on
// the CUDA cores (no tensor cores, no TMA), so the kernels are bound by
// FMA issue and shared-memory reads, not by device memory. The backward
// does 3.5 times the forward's FMAs (S and dO V^T are recomputed in both
// backward kernels); Philox adds about 10 multiply pairs per 4 weights,
// well under the 128 FMAs each weight costs at D = 64. Moving the products
// to wgmma is later work.
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

namespace {

constexpr int kBlock = 64;  // query and key tile
constexpr int kThreads = 128;
constexpr int kRows = 4;  // tile rows per thread
constexpr int kCols = 8;  // tile columns per thread
constexpr float kMaskedLogit = -1e30f;
constexpr float kAllMaskedLse = -5e29f;  // below: every key of the row masked

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_from_f32(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_from_f32(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint32_t k0,
                                               uint32_t k1) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r) {
      k0 += 0x9E3779B9u;
      k1 += 0xBB67AE85u;
    }
    const uint32_t lo0 = 0xD2511F53u * c.x, hi0 = __umulhi(0xD2511F53u, c.x);
    const uint32_t lo1 = 0xCD9E8D57u * c.z, hi1 = __umulhi(0xCD9E8D57u, c.z);
    c = make_uint4(hi1 ^ c.y ^ k0, lo1, hi0 ^ c.w ^ k1, lo0);
  }
  return c;
}

__device__ __forceinline__ uint32_t word(const uint4& r, int u) {
  return u == 0 ? r.x : u == 1 ? r.y : u == 2 ? r.z : r.w;
}

// the bits of key columns 4g .. 4g+3 on query row i
__device__ __forceinline__ uint4 keep_bits(int g, int i, int h, int b,
                                           uint32_t k0, uint32_t k1) {
  return philox4x32_10(
      make_uint4((uint32_t)g, (uint32_t)i, (uint32_t)h, (uint32_t)b), k0, k1);
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
      const uint4 lo = keep_bits((k0 >> 2) + cg, q0 + r, h, b, p.k0, p.k1);
      const uint4 hi = keep_bits((k0 >> 2) + 8 + cg, q0 + r, h, b, p.k0, p.k1);
      float rowsum = 0.f;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const float e = expf(s[i][j] - m_new);
        rowsum += e;  // the statistics use the undropped weights
        const uint32_t bits = word(j < 4 ? lo : hi, j & 3);
        Ps[r * (kBlock + 1) + key_col(cg, j)] = bits >= p.threshold ? e : 0.f;
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
// masked key)
__device__ __forceinline__ void weight_and_grad(
    float s, float dp, float lse, float delta, bool key_valid, bool kept,
    float inv_T, const Params& p, float& pd, float& ds) {
  float w;
  if (lse < kAllMaskedLse) {
    w = inv_T;  // every key of the row masked: uniform weights
  } else {
    w = key_valid ? expf(s * p.scale - lse) : 0.f;
  }
  pd = kept ? w * p.inv_keep : 0.f;
  ds = key_valid ? w * ((kept ? dp * p.inv_keep : 0.f) - delta) : 0.f;
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
          keep_bits((k0 >> 2) + rg, q0 + r, h, b, p.k0, p.k1);
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        float pd = 0.f, ds = 0.f;
        if (row_ok && rg * kRows + i < kmax)
          weight_and_grad(s[i][j], dp[i][j], Ls[r], Ds[r], kval[i],
                          word(bits, i) >= p.threshold, inv_T, p, pd, ds);
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
      const uint4 lo = keep_bits((k0 >> 2) + cg, row, h, b, p.k0, p.k1);
      const uint4 hi = keep_bits((k0 >> 2) + 8 + cg, row, h, b, p.k0, p.k1);
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int c = key_col(cg, j);
        float pd = 0.f, ds = 0.f;
        if (row < S && c < kmax)
          weight_and_grad(s[i][j], dp[i][j], lse_r[i], delta_r[i],
                          Vld[c] != 0.f,
                          word(j < 4 ? lo : hi, j & 3) >= p.threshold, inv_T,
                          p, pd, ds);
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

// ------------------------------------------------------------- launchers

struct Ptrs {
  const void *q, *k, *v, *kv_valid, *out, *dout;
  void *lse, *delta, *dq, *dk, *dv, *o;
};

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

template <typename scalar_t, bool kBackward>
cudaError_t dispatch(const Ptrs& t, int B, int H, const Params& p,
                     cudaStream_t st) {
  // the smallest compiled tile width that holds the head dim
  if (p.D < 1 || p.D > 128) return cudaErrorInvalidValue;
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
int run(int dtype, const Ptrs& t, int B, int H, const Params& p,
        void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)dispatch<float, kBackward>(t, B, H, p, st);
  if (dtype == 1)
    return (int)dispatch<__nv_bfloat16, kBackward>(t, B, H, p, st);
  return (int)cudaErrorInvalidValue;
}

Params make_params(int S, int T, int D, long long q_sb, long long q_ss,
                   long long k_sb, long long k_ss, long long v_sb,
                   long long v_ss, float scale, float inv_keep,
                   unsigned threshold, unsigned seed_lo, unsigned seed_hi) {
  Params p;
  p.S = S; p.T = T; p.D = D;
  p.q_sb = q_sb; p.q_ss = q_ss; p.k_sb = k_sb; p.k_ss = k_ss;
  p.v_sb = v_sb; p.v_ss = v_ss;
  p.scale = scale; p.inv_keep = inv_keep;
  p.threshold = threshold; p.k0 = seed_lo; p.k1 = seed_hi;
  return p;
}

}  // namespace

// Plain C entry points, bound with ctypes. Pointers are device pointers;
// q/k/v rows are (batch stride, row stride) addressed with unit column
// stride; out, dout, dq, dk and dv are contiguous (B, L, H*D); lse and
// delta are contiguous (B, H, S) f32; kv_valid is (B, T) uint8 or null.
// dtype: 0 = float32, 1 = bfloat16. Each returns the cudaError_t of its
// launches (the backward launches three kernels: delta, dK/dV, dQ).
extern "C" int cris_attention_dropout_fwd(
    const void* q, const void* k, const void* v, const void* kv_valid,
    void* out, void* lse, int B, int S, int T, int H, int D, int dtype,
    long long q_sb, long long q_ss, long long k_sb, long long k_ss,
    long long v_sb, long long v_ss, float scale, float inv_keep,
    unsigned threshold, unsigned seed_lo, unsigned seed_hi, void* stream) {
  Ptrs t{};
  t.q = q; t.k = k; t.v = v; t.kv_valid = kv_valid; t.o = out; t.lse = lse;
  return run<false>(dtype, t, B, H,
                    make_params(S, T, D, q_sb, q_ss, k_sb, k_ss, v_sb, v_ss,
                                scale, inv_keep, threshold, seed_lo, seed_hi),
                    stream);
}

extern "C" int cris_attention_dropout_bwd(
    const void* q, const void* k, const void* v, const void* kv_valid,
    const void* out, const void* lse, const void* dout, void* delta,
    void* dq, void* dk, void* dv, int B, int S, int T, int H, int D,
    int dtype, long long q_sb, long long q_ss, long long k_sb, long long k_ss,
    long long v_sb, long long v_ss, float scale, float inv_keep,
    unsigned threshold, unsigned seed_lo, unsigned seed_hi, void* stream) {
  Ptrs t{};
  t.q = q; t.k = k; t.v = v; t.kv_valid = kv_valid; t.out = out;
  t.lse = const_cast<void*>(lse); t.dout = dout; t.delta = delta;
  t.dq = dq; t.dk = dk; t.dv = dv;
  return run<true>(dtype, t, B, H,
                   make_params(S, T, D, q_sb, q_ss, k_sb, k_ss, v_sb, v_ss,
                               scale, inv_keep, threshold, seed_lo, seed_hi),
                   stream);
}
