// K1: fused multi-head softmax attention over (B, S, E) projections.
//
// Replaces the TPU kernel `fused_attention_bse` (cris_tpu/ops/pallas/
// attention.py:165, body `_attn_bse_kernel` at :132). Same math:
//   out[b, s, h*D:(h+1)*D] = softmax(q_h k_h^T * D^-1/2, masked keys = -1e30) v_h
// with f32 logits, f32 softmax statistics and f32 accumulation; the output
// is stored in the input's dtype (f32 or bf16). Any head dim D <= 128
// runs: the kernel is compiled for tile widths DP = 16, 32, 64 and 128,
// takes the real D at run time, and zero-fills the columns D..DP-1 of its
// shared tiles, which adds nothing to the logits and is never stored.
//
// Design for Hopper (not a copy of the TPU blocking):
// - The TPU kernel holds all of K/V for a batch row in VMEM and runs a
//   single-pass softmax. At T = 676 that is 346 KB of f32 K+V per head
//   group, above the 227 KB of shared memory a block can have. Here one
//   block owns one (batch, head, 64-query tile) and loops over 64-key
//   tiles staged in shared memory, with an online softmax: a running row
//   max and row sum, and the output accumulator rescaled in registers.
// - Each head's D-column span is read straight from the (B, S, E) rows
//   (row strides are arguments), so there are no head split/merge copies.
// - 128 threads; thread t owns query rows 4*(t/8) .. +3 of the tile, the
//   logit columns (t%8) + 8j and the output columns (t%8) + 8j. The 8
//   threads that share a row are neighbouring lanes, so row max and row sum
//   are three xor-shuffles. Shared rows are padded by one float so that
//   the strided reads fall in distinct banks. Columns are counted in DP.
//
// What bounds it on the card: the decoder self-attention (676 x 676, 8 x 64)
// is the largest site, 2*2*676*676*64 = 117 MFLOP per (batch, head); this
// first version does its products with scalar f32 FMAs on the CUDA cores
// (no tensor cores, no TMA), so it is bound by FMA issue and shared-memory
// reads, not by device memory: each Q/K/V element is read from device
// memory once per 64-query tile. Moving the two products to wgmma with
// TMA-fed tiles is later work.
//
// Masking: a masked key gets the finite logit -1e30, as in the TPU kernel.
// A row whose keys are all masked therefore has uniform weights and
// returns mean(V) over the T keys (not NaN), as the JAX XLA path gives
// with its finite mask value; the Pallas kernel instead averages over its
// key count padded to a multiple of 128, with zero V in the padding. The
// JAX package calls such rows undefined and the model never produces
// them. Keys past T (the ragged last tile) get weight 0 exactly.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBlockQ = 64;
constexpr int kBlockK = 64;
constexpr int kThreads = 128;
constexpr int kRows = 4;  // query rows per thread
constexpr float kMaskedLogit = -1e30f;

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_from_f32(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_from_f32(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

template <int DP>
constexpr size_t smem_bytes() {
  // Qs[BQ][DP+1], Ks[BK][DP+1], Vs[BK][DP], Ps[BQ][BK+1], valid[BK]
  return sizeof(float) * (kBlockQ * (DP + 1) + kBlockK * (DP + 1) +
                          kBlockK * DP + kBlockQ * (kBlockK + 1) + kBlockK);
}

// DP: the compiled tile width, a multiple of 8; D <= DP: the head dim.
template <typename scalar_t, int DP>
__global__ void __launch_bounds__(kThreads)
attention_bse_kernel(const scalar_t* __restrict__ q,
                     const scalar_t* __restrict__ k,
                     const scalar_t* __restrict__ v,
                     const uint8_t* __restrict__ kv_valid,
                     scalar_t* __restrict__ out, int S, int T, int D,
                     long long q_sb, long long q_ss, long long k_sb,
                     long long k_ss, long long v_sb, long long v_ss,
                     float scale) {
  static_assert(DP % 8 == 0, "tile width must be a multiple of 8");
  constexpr int kCols = kBlockK / 8;  // logit columns per thread
  constexpr int kOut = DP / 8;        // output columns per thread

  extern __shared__ float smem[];
  float* Qs = smem;                          // [BQ][DP+1]
  float* Ks = Qs + kBlockQ * (DP + 1);       // [BK][DP+1]
  float* Vs = Ks + kBlockK * (DP + 1);       // [BK][DP]
  float* Ps = Vs + kBlockK * DP;             // [BQ][BK+1]
  float* Vld = Ps + kBlockQ * (kBlockK + 1);  // [BK], 1 = valid key

  const int tid = threadIdx.x;
  const int rg = tid >> 3;  // row group: rows rg*4 .. rg*4+3
  const int cg = tid & 7;   // column lane within the row group
  const int q0 = blockIdx.x * kBlockQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int E = gridDim.y * D;

  const scalar_t* qb = q + b * q_sb + h * D;
  const scalar_t* kb = k + b * k_sb + h * D;
  const scalar_t* vb = v + b * v_sb + h * D;

  for (int idx = tid; idx < kBlockQ * DP; idx += kThreads) {
    const int r = idx / DP, d = idx % DP;
    const int row = q0 + r;
    Qs[r * (DP + 1) + d] =
        (row < S && d < D) ? load_f32(qb + row * q_ss + d) : 0.f;
  }

  float m_run[kRows], l_run[kRows], acc[kRows][kOut];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m_run[i] = -INFINITY;
    l_run[i] = 0.f;
#pragma unroll
    for (int j = 0; j < kOut; ++j) acc[i][j] = 0.f;
  }

  for (int k0 = 0; k0 < T; k0 += kBlockK) {
    const int kmax = min(kBlockK, T - k0);
    for (int idx = tid; idx < kBlockK * DP; idx += kThreads) {
      const int r = idx / DP, d = idx % DP;
      const bool in = r < kmax && d < D;
      Ks[r * (DP + 1) + d] = in ? load_f32(kb + (k0 + r) * k_ss + d) : 0.f;
      Vs[r * DP + d] = in ? load_f32(vb + (k0 + r) * v_ss + d) : 0.f;
    }
    for (int r = tid; r < kBlockK; r += kThreads) {
      Vld[r] = (r < kmax && (kv_valid == nullptr ||
                             kv_valid[(long long)b * T + k0 + r] != 0))
                   ? 1.f
                   : 0.f;
    }
    __syncthreads();

    // logits for this thread's 4 x 8 slice of the 64 x 64 tile
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
      for (int j = 0; j < kCols; ++j) bk[j] = Ks[(cg + 8 * j) * (DP + 1) + d];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kCols; ++j) s[i][j] = fmaf(a[i], bk[j], s[i][j]);
    }

    // online softmax update, row by row
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int c = cg + 8 * j;
        float val;
        if (c >= kmax) {
          val = -INFINITY;  // past T: weight exactly 0
        } else {
          val = Vld[c] != 0.f ? s[i][j] * scale : kMaskedLogit;
        }
        s[i][j] = val;
        mx = fmaxf(mx, val);
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
      // column k0 is always in range, so m_new is finite
      const float m_new = fmaxf(m_run[i], mx);
      const float alpha = expf(m_run[i] - m_new);  // 0 on the first tile
      float rowsum = 0.f;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const float p = expf(s[i][j] - m_new);
        rowsum += p;
        Ps[(rg * kRows + i) * (kBlockK + 1) + cg + 8 * j] = p;
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

    // acc += P V over the keys of this tile
    for (int kk = 0; kk < kmax; ++kk) {
      float p[kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
        p[i] = Ps[(rg * kRows + i) * (kBlockK + 1) + kk];
#pragma unroll
      for (int j = 0; j < kOut; ++j) {
        const float vv = Vs[kk * DP + cg + 8 * j];
#pragma unroll
        for (int i = 0; i < kRows; ++i) acc[i][j] = fmaf(p[i], vv, acc[i][j]);
      }
    }
    __syncthreads();  // the next tile overwrites Ks, Vs, Ps
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int row = q0 + rg * kRows + i;
    if (row >= S) continue;
    const float inv = 1.f / l_run[i];
    scalar_t* orow = out + ((long long)b * S + row) * E + h * D;
#pragma unroll
    for (int j = 0; j < kOut; ++j) {
      const int col = cg + 8 * j;
      if (col < D) store_from_f32(orow + col, acc[i][j] * inv);
    }
  }
}

template <typename scalar_t, int DP>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* kv_valid, void* out, int B, int S, int T,
                   int H, int D, long long q_sb, long long q_ss,
                   long long k_sb, long long k_ss, long long v_sb,
                   long long v_ss, float scale, cudaStream_t stream) {
  auto kern = attention_bse_kernel<scalar_t, DP>;
  constexpr size_t smem = smem_bytes<DP>();
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((S + kBlockQ - 1) / kBlockQ, H, B);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const scalar_t*>(q), static_cast<const scalar_t*>(k),
      static_cast<const scalar_t*>(v),
      static_cast<const uint8_t*>(kv_valid), static_cast<scalar_t*>(out), S,
      T, D, q_sb, q_ss, k_sb, k_ss, v_sb, v_ss, scale);
  return cudaGetLastError();
}

template <typename scalar_t>
cudaError_t dispatch_d(int D, const void* q, const void* k, const void* v,
                       const void* kv_valid, void* out, int B, int S, int T,
                       int H, long long q_sb, long long q_ss, long long k_sb,
                       long long k_ss, long long v_sb, long long v_ss,
                       float scale, cudaStream_t stream) {
  // the smallest compiled tile width that holds the head dim
  if (D < 1 || D > 128) return cudaErrorInvalidValue;
  if (D <= 16)
    return launch<scalar_t, 16>(q, k, v, kv_valid, out, B, S, T, H, D, q_sb,
                                q_ss, k_sb, k_ss, v_sb, v_ss, scale, stream);
  if (D <= 32)
    return launch<scalar_t, 32>(q, k, v, kv_valid, out, B, S, T, H, D, q_sb,
                                q_ss, k_sb, k_ss, v_sb, v_ss, scale, stream);
  if (D <= 64)
    return launch<scalar_t, 64>(q, k, v, kv_valid, out, B, S, T, H, D, q_sb,
                                q_ss, k_sb, k_ss, v_sb, v_ss, scale, stream);
  return launch<scalar_t, 128>(q, k, v, kv_valid, out, B, S, T, H, D, q_sb,
                               q_ss, k_sb, k_ss, v_sb, v_ss, scale, stream);
}

}  // namespace

// Plain C entry point, bound with ctypes. Pointers are device pointers;
// q/k/v rows are (batch stride, row stride) addressed with unit column
// stride; out is contiguous (B, S, H*D); kv_valid is (B, T) uint8 or null.
// dtype: 0 = float32, 1 = bfloat16. Returns the cudaError_t of the launch.
extern "C" int cris_attention_bse(const void* q, const void* k, const void* v,
                                  const void* kv_valid, void* out, int B,
                                  int S, int T, int H, int D, int dtype,
                                  long long q_sb, long long q_ss,
                                  long long k_sb, long long k_ss,
                                  long long v_sb, long long v_ss, float scale,
                                  void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)dispatch_d<float>(D, q, k, v, kv_valid, out, B, S, T, H, q_sb,
                                  q_ss, k_sb, k_ss, v_sb, v_ss, scale, st);
  if (dtype == 1)
    return (int)dispatch_d<__nv_bfloat16>(D, q, k, v, kv_valid, out, B, S, T,
                                          H, q_sb, q_ss, k_sb, k_ss, v_sb,
                                          v_ss, scale, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* cris_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
