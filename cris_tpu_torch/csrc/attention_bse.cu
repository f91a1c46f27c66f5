// K1 and K3: fused multi-head softmax attention, one body for two layouts.
//
// Replaces the TPU kernels `fused_attention_bse` (K1, cris_tpu/ops/pallas/
// attention.py:165, body `_attn_bse_kernel` at :132), over (B, S, E)
// projections, and `fused_attention` (K3, attention.py:57, body
// `_attn_kernel` at :31), over (B, H, S, D) tensors. Same math:
//   out[b, h, s, :] = softmax(q_bh k_bh^T * D^-1/2, masked keys = -1e30) v_bh
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
// - q, k, v and out are addressed through (batch, head, row) strides with
//   unit column stride: K1 passes (S*E, D, E) for its (B, S, E) rows, so
//   each head's D-column span is read in place with no head split/merge
//   copies; K3 passes its (B, H, L, D) tensors' own strides.
// - 128 threads; thread t owns query rows 4*(t/8) .. +3 of the tile, the
//   logit columns (t%8) + 8j and the output columns (t%8) + 8j. The 8
//   threads that share a row are neighbouring lanes, so row max and row sum
//   are three xor-shuffles. Shared rows are padded by one float so that
//   the strided reads fall in distinct banks. Columns are counted in DP.
//
// What bounds it on the card: the decoder self-attention (676 x 676, 8 x 64)
// is the largest site, 2*2*676*676*64 = 117 MFLOP per (batch, head); this
// first version does its products with scalar f32 FMAs on the CUDA cores
// (no tensor cores, no TMA), and stages K and V one element per thread at
// a time: the compiled loop keeps only a K and a V load in flight, so the
// loads' latency, more than FMA issue, sets its pace (with the strides as
// six scalars the compiler issued one load at a time, and the kernel took
// twice as long). Each Q/K/V element is read from device memory once per
// 64-query tile. Moving the two products to wgmma with TMA-fed tiles is
// later work.
//
// Masking: a masked key gets the finite logit -1e30, as in the TPU kernel.
// A row whose keys are all masked therefore has uniform weights and
// returns mean(V) over the T keys (not NaN), as the JAX XLA path gives
// with its finite mask value; the Pallas kernels (K1 and K3 alike) instead
// average over their key count padded to a multiple of 128, with zero V
// in the padding. The JAX package calls such rows undefined and the model
// never produces them. Keys past T (the ragged last tile) get weight 0
// exactly.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kBlockQ = 64;
constexpr int kBlockK = 64;
constexpr int kThreads = 128;
constexpr int kRows = 4;  // query rows per thread
constexpr float kMaskedLogit = -1e30f;

// (batch, head, row) strides of a (B, H, L, D) view, in elements; the
// column stride is 1
struct Strides {
  long long b, h, s;
};

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
                     Strides qs, Strides ks, Strides vs, Strides os,
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

  const scalar_t* qb = q + b * qs.b + h * qs.h;
  const scalar_t* kb = k + b * ks.b + h * ks.h;
  const scalar_t* vb = v + b * vs.b + h * vs.h;

  for (int idx = tid; idx < kBlockQ * DP; idx += kThreads) {
    const int r = idx / DP, d = idx % DP;
    const int row = q0 + r;
    Qs[r * (DP + 1) + d] =
        (row < S && d < D) ? load_f32(qb + row * qs.s + d) : 0.f;
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
      Ks[r * (DP + 1) + d] = in ? load_f32(kb + (k0 + r) * ks.s + d) : 0.f;
      Vs[r * DP + d] = in ? load_f32(vb + (k0 + r) * vs.s + d) : 0.f;
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
    scalar_t* orow = out + b * os.b + h * os.h + row * os.s;
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
                   int H, int D, Strides qs, Strides ks, Strides vs,
                   Strides os, float scale, cudaStream_t stream) {
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
      T, D, qs, ks, vs, os, scale);
  return cudaGetLastError();
}

template <typename scalar_t>
cudaError_t dispatch_d(const void* q, const void* k, const void* v,
                       const void* kv_valid, void* out, int B, int S, int T,
                       int H, int D, Strides qs, Strides ks, Strides vs,
                       Strides os, float scale, cudaStream_t stream) {
  // the smallest compiled tile width that holds the head dim
  if (D < 1 || D > 128) return cudaErrorInvalidValue;
  auto run = [&](auto width) {
    return launch<scalar_t, decltype(width)::value>(
        q, k, v, kv_valid, out, B, S, T, H, D, qs, ks, vs, os, scale, stream);
  };
  if (D <= 16) return run(std::integral_constant<int, 16>());
  if (D <= 32) return run(std::integral_constant<int, 32>());
  if (D <= 64) return run(std::integral_constant<int, 64>());
  return run(std::integral_constant<int, 128>());
}

int dispatch(int dtype, const void* q, const void* k, const void* v,
             const void* kv_valid, void* out, int B, int S, int T, int H,
             int D, Strides qs, Strides ks, Strides vs, Strides os,
             float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)dispatch_d<float>(q, k, v, kv_valid, out, B, S, T, H, D, qs,
                                  ks, vs, os, scale, st);
  if (dtype == 1)
    return (int)dispatch_d<__nv_bfloat16>(q, k, v, kv_valid, out, B, S, T, H,
                                          D, qs, ks, vs, os, scale, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Plain C entry points, bound with ctypes. Pointers are device pointers;
// kv_valid is (B, T) uint8 or null; dtype: 0 = float32, 1 = bfloat16.
// Each returns the cudaError_t of the launch.
//
// K1: q/k/v rows are (batch stride, row stride) addressed with unit column
// stride, head h at column h*D; out is contiguous (B, S, H*D).
extern "C" int cris_attention_bse(const void* q, const void* k, const void* v,
                                  const void* kv_valid, void* out, int B,
                                  int S, int T, int H, int D, int dtype,
                                  long long q_sb, long long q_ss,
                                  long long k_sb, long long k_ss,
                                  long long v_sb, long long v_ss, float scale,
                                  void* stream) {
  const long long E = (long long)H * D;
  return dispatch(dtype, q, k, v, kv_valid, out, B, S, T, H, D,
                  Strides{q_sb, D, q_ss}, Strides{k_sb, D, k_ss},
                  Strides{v_sb, D, v_ss}, Strides{S * E, D, E}, scale, stream);
}

// K3: q (B, H, S, D), k/v (B, H, T, D) and out (B, H, S, D), each addressed
// through its (batch, head, row) strides with unit column stride.
extern "C" int cris_fused_attention(
    const void* q, const void* k, const void* v, const void* kv_valid,
    void* out, int B, int S, int T, int H, int D, int dtype, long long q_sb,
    long long q_sh, long long q_ss, long long k_sb, long long k_sh,
    long long k_ss, long long v_sb, long long v_sh, long long v_ss,
    long long o_sb, long long o_sh, long long o_ss, float scale,
    void* stream) {
  return dispatch(dtype, q, k, v, kv_valid, out, B, S, T, H, D,
                  Strides{q_sb, q_sh, q_ss}, Strides{k_sb, k_sh, k_ss},
                  Strides{v_sb, v_sh, v_ss}, Strides{o_sb, o_sh, o_ss}, scale,
                  stream);
}

extern "C" const char* cris_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
