// K1 and K3: fused multi-head softmax attention, one body per dtype, for
// two layouts.
//
// Replaces the TPU kernels `fused_attention_bse` (K1, cris_tpu/ops/pallas/
// attention.py:165, body `_attn_bse_kernel` at :132), over (B, S, E)
// projections, and `fused_attention` (K3, attention.py:57, body
// `_attn_kernel` at :31), over (B, H, S, D) tensors. Same math:
//   out[b, h, s, :] = softmax(q_bh k_bh^T * D^-1/2, masked keys = -1e30) v_bh
// with f32 logits, f32 softmax statistics and f32 accumulation; the output
// is stored in the input's dtype. q, k, v and out are addressed through
// (batch, head, row) strides with unit column stride: K1 passes (S*E, D,
// E) for its (B, S, E) rows, so each head's D columns are read in place
// with no head split or merge; K3 passes its (B, H, L, D) tensors' own.
// Both entries reach the same two bodies, so K3 on head views of K1's rows
// gives K1's bits.
//
// Two bodies; the Python wrappers pick one before the launch
// (ops/kernels/attention.py, attention_route):
//
// - "tensor_cores" (attention_tc_kernel): bf16, head dims that are
//   multiples of 8 up to 128, bases, head offsets and row strides that are
//   multiples of 8 elements (16 bytes). A flash-attention body on
//   mma.sync.m16n8k16 (bf16 x bf16 -> f32). One block of 4 warps per
//   (batch, head, 64 query rows), 16 rows a warp. Q's fragments are loaded
//   once with ldmatrix; K and V come in 64-key tiles by 16-byte cp.async
//   into a double-buffered ring in shared memory (rows padded by 16 bytes,
//   so that ldmatrix's 8 row addresses fall in distinct banks), the next
//   tile in flight while this one computes. Per tile: S = Q K^T in f32
//   registers, scaled (in log2 units, for exp2); an online softmax whose
//   row max runs over the 4 lanes of a quad (two shuffles), the row sum
//   kept per thread and summed over the quad once at the end; P rounded to
//   bf16 in registers and reused as the A operand of P V, with V's
//   fragments by ldmatrix.trans. Rounding P to v's dtype before the second
//   product is what the JAX kernels do (`p.astype(v.dtype)`, attention.py
//   :46 and :157); the row sum is taken from the f32 p, and out = acc / l
//   is rounded once, staged through shared memory and stored 16 bytes a
//   thread. Head dims are padded to a compiled width DP of 16, 32, 64 or
//   128 with zero-filled columns, which add nothing and are never stored.
//   mma.sync and not wgmma: the products per key tile are small (64 x 64 x
//   D), P lives in registers, and the softmax and the loads weigh as much
//   as the products; wgmma is the step after if this body stays far from
//   its bound.
// - "scalar" (attention_bse_kernel): float32, and any bf16 layout the
//   tensor-core body cannot take. f32 logits and products as scalar FMAs
//   on the CUDA cores (f32 has no tensor-core form but TF32, which would
//   break the f32 bars), P kept in f32. 128 threads per (batch, head, 64
//   queries); thread t owns query rows 4*(t/8) .. +3 and the logit and
//   output columns (t%8) + 8j; K and V staged one element per thread at a
//   time, so the latency of those loads sets its pace (PERF.md).
//   Any head dim up to 128, at compiled tile widths 16, 32, 64, 128.
//
// What bounds it on the card: the decoder self-attention (676 x 676, 8 x
// 64) is the largest model site, 2*2*676*676*64 = 117 MFLOP per (batch,
// head): the tensor cores' 989 TFLOP/s bound it (15 us at B 16), far
// above the 2.6 MB a (batch, head) reads. The tensor-core body reads each
// K and V tile once per 64 query rows, from L2 after the first block.
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

// ---------------------------------------------------------------- the
// tensor-core body (bf16)

constexpr int kTcThreads = 128;  // 4 warps x 16 query rows

template <int DP>
struct TcSmem {
  static constexpr int kLd = DP + 8;  // padded row, in bf16
  static constexpr int kTileElems = 64 * kLd;
  // Q, K[2], V[2], then the key flags [2][64]
  static constexpr size_t kBytes = 5 * kTileElems * 2 + 2 * 64;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared, or 16 zero bytes when !in
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(in ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// c (16 x 8, f32) += a (16 x 16, bf16, row) b (16 x 8, bf16, col)
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 2^x on the special function unit (2^-inf = 0)
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Rows r0 .. r0 + 63 of a head's (rows, D) view into a padded 64-row tile,
// 16 bytes a copy, neighbouring threads on neighbouring chunks of a row;
// rows past `rows` and columns past D are zero-filled.
template <int DP>
__device__ __forceinline__ void load_tile(uint32_t dst,
                                          const __nv_bfloat16* base,
                                          long long row_stride, int r0,
                                          int rows, int D) {
  constexpr int kChunks = DP / 8;
#pragma unroll
  for (int i = 0; i < 64 * kChunks / kTcThreads; ++i) {
    const int c = threadIdx.x + i * kTcThreads;
    const int r = c / kChunks, ch = c % kChunks;
    const bool in = r0 + r < rows && ch * 8 < D;
    const __nv_bfloat16* src =
        in ? base + (long long)(r0 + r) * row_stride + ch * 8 : base;
    cp_async16(dst + (r * TcSmem<DP>::kLd + ch * 8) * 2, src, in);
  }
}

// One block per (64 query rows, head, batch); warp w owns rows 16 w .. +15.
// mma fragments: lane l holds rows l / 4 and l / 4 + 8 of its warp's 16,
// columns 8 j + 2 (l % 4) and + 1 of each 8-column tile j.
template <int DP>
__global__ void __launch_bounds__(kTcThreads)
attention_tc_kernel(const __nv_bfloat16* __restrict__ q,
                    const __nv_bfloat16* __restrict__ k,
                    const __nv_bfloat16* __restrict__ v,
                    const uint8_t* __restrict__ kv_valid,
                    __nv_bfloat16* __restrict__ out, int S, int T, int D,
                    Strides qs, Strides ks, Strides vs, Strides os,
                    float scale_log2) {
  using Sm = TcSmem<DP>;
  constexpr int kLd = Sm::kLd;
  constexpr int KS = DP / 16;  // k16 steps over the head dim
  constexpr int ND = DP / 8;   // 8-column tiles over the head dim
  constexpr uint32_t kTileBytes = Sm::kTileElems * 2;
  extern __shared__ __align__(16) __nv_bfloat16 tc_smem[];
  __nv_bfloat16* Qs = tc_smem;
  uint8_t* flags = reinterpret_cast<uint8_t*>(tc_smem + 5 * Sm::kTileElems);
  const uint32_t q_addr = smem_u32(Qs);
  const uint32_t k_addr = q_addr + kTileBytes;
  const uint32_t v_addr = k_addr + 2 * kTileBytes;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int q0 = blockIdx.x * 64, h = blockIdx.y, b = blockIdx.z;
  const __nv_bfloat16* qb = q + b * qs.b + h * qs.h;
  const __nv_bfloat16* kb = k + b * ks.b + h * ks.h;
  const __nv_bfloat16* vb = v + b * vs.b + h * vs.h;
  const uint8_t* valid = kv_valid == nullptr ? nullptr : kv_valid + (long long)b * T;
  // 0: past T (weight 0), 1: masked (logit -1e30), 2: valid
  auto key_flag = [&](int key) -> uint8_t {
    if (key >= T) return 0;
    return (valid != nullptr && valid[key] == 0) ? 1 : 2;
  };

  load_tile<DP>(q_addr, qb, qs.s, q0, S, D);
  load_tile<DP>(k_addr, kb, ks.s, 0, T, D);
  load_tile<DP>(v_addr, vb, vs.s, 0, T, D);
  cp_async_commit();
  if (threadIdx.x < 64) flags[threadIdx.x] = key_flag(threadIdx.x);

  uint32_t qf[KS][4];
  float o[ND][4];
#pragma unroll
  for (int j = 0; j < ND; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f};

  const int nt = (T + 63) / 64;
  for (int it = 0; it < nt; ++it) {
    const int buf = it & 1;
    cp_async_wait_all();
    __syncthreads();  // tile it landed; every warp is done with tile it - 1
    if (it == 0) {
#pragma unroll
      for (int kk = 0; kk < KS; ++kk)
        ldsm_x4(qf[kk], q_addr + ((warp * 16 + (lane & 15)) * kLd +
                                  (2 * kk + (lane >> 4)) * 8) * 2);
    }
    uint8_t next_flag = 0;
    if (it + 1 < nt) {  // the next tile flies while this one computes
      const int k1 = (it + 1) * 64;
      load_tile<DP>(k_addr + (buf ^ 1) * kTileBytes, kb, ks.s, k1, T, D);
      load_tile<DP>(v_addr + (buf ^ 1) * kTileBytes, vb, vs.s, k1, T, D);
      cp_async_commit();
      if (threadIdx.x < 64) next_flag = key_flag(k1 + threadIdx.x);
    }

    // S = Q K^T for this warp's 16 rows x 64 keys
    float sc[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[j][e] = 0.f;
    const uint32_t kt = k_addr + buf * kTileBytes;
#pragma unroll
    for (int p = 0; p < 4; ++p) {
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        uint32_t r[4];
        ldsm_x4(r, kt + ((16 * p + (lane & 7) + ((lane >> 4) << 3)) * kLd +
                         (2 * kk + ((lane >> 3) & 1)) * 8) * 2);
        mma_bf16(sc[2 * p], qf[kk], r[0], r[1]);
        mma_bf16(sc[2 * p + 1], qf[kk], r[2], r[3]);
      }
    }

    // scale and mask (log2 units), then the online softmax; a tile of 64
    // in-range keys with no mask skips the key flags
    const uint8_t* fl = flags + buf * 64;
    const bool plain_tile = valid == nullptr && it * 64 + 64 <= T;
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = sc[j][e] * scale_log2;
        if (!plain_tile) {
          const uint8_t f = fl[8 * j + 2 * (lane & 3) + (e & 1)];
          x = f == 2 ? x : (f == 1 ? kMaskedLogit : -INFINITY);
        }
        sc[j][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      // key k0 is always in range, so the new max is finite
      const float m_new = fmaxf(m_run[r], mx[r]);
      alpha[r] = fast_exp2(m_run[r] - m_new);  // 0 on the first tile
      m_run[r] = m_new;
      l_run[r] *= alpha[r];
    }
#pragma unroll
    for (int j = 0; j < ND; ++j) {
      o[j][0] *= alpha[0];
      o[j][1] *= alpha[0];
      o[j][2] *= alpha[1];
      o[j][3] *= alpha[1];
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = fast_exp2(sc[j][e] - m_run[e >> 1]);
        l_run[e >> 1] += p;  // f32 p: the row sum before rounding
        sc[j][e] = p;
      }
    }

    // O += P V: P rounded to bf16 as the A operand, 16 keys a step
    const uint32_t vt = v_addr + buf * kTileBytes;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint32_t a[4] = {pack_bf16(sc[2 * kk][0], sc[2 * kk][1]),
                             pack_bf16(sc[2 * kk][2], sc[2 * kk][3]),
                             pack_bf16(sc[2 * kk + 1][0], sc[2 * kk + 1][1]),
                             pack_bf16(sc[2 * kk + 1][2], sc[2 * kk + 1][3])};
#pragma unroll
      for (int jj = 0; jj < KS; ++jj) {
        uint32_t r[4];
        ldsm_x4_trans(r, vt + ((16 * kk + (lane & 15)) * kLd +
                               (2 * jj + (lane >> 4)) * 8) * 2);
        mma_bf16(o[2 * jj], a, r[0], r[1]);
        mma_bf16(o[2 * jj + 1], a, r[2], r[3]);
      }
    }
    if (it + 1 < nt && threadIdx.x < 64)
      flags[(buf ^ 1) * 64 + threadIdx.x] = next_flag;
  }

  // out = O / l, rounded once, staged in this warp's own rows of Q's tile
  // (no other warp reads them), then stored 16 bytes a thread
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 1);
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 2);
  }
  const float inv0 = 1.f / l_run[0], inv1 = 1.f / l_run[1];
  __nv_bfloat16* st = Qs + warp * 16 * kLd;
  const int g = lane >> 2, c2 = 2 * (lane & 3);
#pragma unroll
  for (int j = 0; j < ND; ++j) {
    *reinterpret_cast<uint32_t*>(&st[g * kLd + 8 * j + c2]) =
        pack_bf16(o[j][0] * inv0, o[j][1] * inv0);
    *reinterpret_cast<uint32_t*>(&st[(g + 8) * kLd + 8 * j + c2]) =
        pack_bf16(o[j][2] * inv1, o[j][3] * inv1);
  }
  __syncwarp();
  __nv_bfloat16* ob = out + b * os.b + h * os.h;
#pragma unroll
  for (int i = 0; i < 16 * ND / 32; ++i) {
    const int c = lane + 32 * i;
    const int r = c / ND, ch = c % ND;
    const int row = q0 + warp * 16 + r;
    if (row < S && ch * 8 < D)
      *reinterpret_cast<uint4*>(ob + row * os.s + ch * 8) =
          *reinterpret_cast<const uint4*>(&st[r * kLd + ch * 8]);
  }
}

template <int DP>
cudaError_t launch_tc(const void* q, const void* k, const void* v,
                      const void* kv_valid, void* out, int B, int S, int T,
                      int H, int D, Strides qs, Strides ks, Strides vs,
                      Strides os, float scale, cudaStream_t stream) {
  auto kern = attention_tc_kernel<DP>;
  constexpr size_t smem = TcSmem<DP>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((S + 63) / 64, H, B);
  kern<<<grid, kTcThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v),
      static_cast<const uint8_t*>(kv_valid),
      static_cast<__nv_bfloat16*>(out), S, T, D, qs, ks, vs, os,
      scale * 1.4426950408889634f);
  return cudaGetLastError();
}

bool aligned16(const void* p, Strides s) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && s.b % 8 == 0 &&
         s.h % 8 == 0 && s.s % 8 == 0;
}

cudaError_t dispatch_tc(const void* q, const void* k, const void* v,
                        const void* kv_valid, void* out, int B, int S, int T,
                        int H, int D, Strides qs, Strides ks, Strides vs,
                        Strides os, float scale, cudaStream_t stream) {
  // what the Python route admits; anything else is refused, not computed
  if (D < 8 || D > 128 || D % 8 || !aligned16(q, qs) || !aligned16(k, ks) ||
      !aligned16(v, vs) || !aligned16(out, os))
    return cudaErrorInvalidValue;
  auto run = [&](auto width) {
    return launch_tc<decltype(width)::value>(q, k, v, kv_valid, out, B, S, T,
                                             H, D, qs, ks, vs, os, scale,
                                             stream);
  };
  if (D <= 16) return run(std::integral_constant<int, 16>());
  if (D <= 32) return run(std::integral_constant<int, 32>());
  if (D <= 64) return run(std::integral_constant<int, 64>());
  return run(std::integral_constant<int, 128>());
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

int dispatch(int dtype, int body, const void* q, const void* k,
             const void* v, const void* kv_valid, void* out, int B, int S,
             int T, int H, int D, Strides qs, Strides ks, Strides vs,
             Strides os, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (body == 1) {
    if (dtype != 1) return (int)cudaErrorInvalidValue;
    return (int)dispatch_tc(q, k, v, kv_valid, out, B, S, T, H, D, qs, ks, vs,
                            os, scale, st);
  }
  if (body != 0) return (int)cudaErrorInvalidValue;
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
// kv_valid is (B, T) uint8 or null; dtype: 0 = float32, 1 = bfloat16;
// body: 0 = the scalar body, 1 = the tensor-core body (bf16 only, D a
// multiple of 8, bases and strides multiples of 8 elements; anything else
// returns cudaErrorInvalidValue). Each returns the cudaError_t of the
// launch.
//
// K1: q/k/v rows are (batch stride, row stride) addressed with unit column
// stride, head h at column h*D; out is contiguous (B, S, H*D).
extern "C" int cris_attention_bse(const void* q, const void* k, const void* v,
                                  const void* kv_valid, void* out, int B,
                                  int S, int T, int H, int D, int dtype,
                                  int body, long long q_sb, long long q_ss,
                                  long long k_sb, long long k_ss,
                                  long long v_sb, long long v_ss, float scale,
                                  void* stream) {
  const long long E = (long long)H * D;
  return dispatch(dtype, body, q, k, v, kv_valid, out, B, S, T, H, D,
                  Strides{q_sb, D, q_ss}, Strides{k_sb, D, k_ss},
                  Strides{v_sb, D, v_ss}, Strides{S * E, D, E}, scale, stream);
}

// K3: q (B, H, S, D), k/v (B, H, T, D) and out (B, H, S, D), each addressed
// through its (batch, head, row) strides with unit column stride.
extern "C" int cris_fused_attention(
    const void* q, const void* k, const void* v, const void* kv_valid,
    void* out, int B, int S, int T, int H, int D, int dtype, int body,
    long long q_sb, long long q_sh, long long q_ss, long long k_sb, long long k_sh,
    long long k_ss, long long v_sb, long long v_sh, long long v_ss,
    long long o_sb, long long o_sh, long long o_ss, float scale,
    void* stream) {
  return dispatch(dtype, body, q, k, v, kv_valid, out, B, S, T, H, D,
                  Strides{q_sb, q_sh, q_ss}, Strides{k_sb, k_sh, k_ss},
                  Strides{v_sb, v_sh, v_ss}, Strides{o_sb, o_sh, o_ss}, scale,
                  stream);
}

extern "C" const char* cris_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
