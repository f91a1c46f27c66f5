// A thread block's own matrix product, out[p][n] = sum_k A(p, k) B(k, n),
// shared by K5 (bottleneck.cu) and K7 (stem.cu), in two forms.
//
// Both walk the block's output in tiles. For each tile they stage a slice
// of the depth of A and B in shared memory, through functors that read
// them from wherever they live (device memory through strides, or an
// earlier stage's shared buffer) and return f32; out-of-range rows,
// columns and depths are staged as 0 and never handed to the epilogue,
// which receives (p, n, f32 sum) for every in-range output.
//
// - block_gemm (float32 inputs): scalar f32 FMAs. TP x TN tiles (TP * TN
//   = 4096), depth 16 per step; each of the 256 threads accumulates a
//   (TP/16) x (TN/16) sub-tile in registers, rows tx + 16 i and columns
//   ty + 16 j (tx = tid % 16, ty = tid / 16), so 16 neighbouring lanes
//   hold 16 neighbouring rows (pixels) and the epilogue's stores to an
//   NCHW map are coalesced. Per 16 FMAs a thread issues TP/16 + TN/16
//   shared loads (8 at 64 x 64): shared-memory issue sets the pace, far
//   below the 67 TFLOP/s of f32 FMA.
// - block_gemm_tc (bfloat16 inputs): the tensor cores through WMMA
//   (mma.sync, 16 x 16 x 16 bf16 tiles, f32 accumulators), 8 warps in a
//   WM x WN grid, each holding FM x FN accumulator tiles, depth 32 per
//   step. The staged values are bf16 already (inputs, weights and the
//   stages' dtype-rounded outputs), so the products are exact and the sums
//   f32, as the JAX kernels' preferred_element_type=f32 dots. The
//   accumulators go through shared memory (column-major, so that
//   neighbouring threads take neighbouring pixels) to the epilogue. The
//   per-element functor staging, not the tensor cores, bounds it; TMA-fed
//   wgmma tiles are the step after.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

namespace cris {

constexpr int kGemmThreads = 256;
constexpr int kKC = 16;  // depth staged per step

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}
// x rounded to T and back, as the JAX kernels' .astype(dtype)
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_f32(from_f32<T>(x));
}

// One thread's share of a staged ROWS x depth slice: element idx = tid +
// c * 256 is row idx % ROWS, depth idx / ROWS (rows fastest, so that
// neighbouring lanes read neighbouring pixels). The loads are unrolled and
// independent, so they are all in flight at once; the caller issues them
// for step s + 1 before it computes step s.
template <int COUNT, int ROWS, typename Load>
__device__ __forceinline__ void fetch(float (&v)[COUNT], Load load, int r0,
                                      int rows, int k0, int depth) {
#pragma unroll
  for (int c = 0; c < COUNT; ++c) {
    const int idx = threadIdx.x + c * kGemmThreads;
    const int r = idx % ROWS, k = idx / ROWS;
    v[c] = (r0 + r < rows && k0 + k < depth) ? load(r0 + r, k0 + k) : 0.f;
  }
}

template <int TP>
__host__ __device__ constexpr int scalar_stage_floats() {
  return kKC * (TP + 4096 / TP);
}

// WM x WN warps, each with FM x FN 16 x 16 accumulator tiles
template <int WM, int WN, int FM, int FN>
struct TcTile {
  static constexpr int TP = 16 * WM * FM, TN = 16 * WN * FN, KC = 32;
  // padded leading dimensions: multiples of 8 bf16 / 4 f32, as WMMA needs
  static constexpr int LDA = TP + 8, LDB = TN + 8, LDC = TP + 4;
  static constexpr int kStageFloats = KC * (LDA + LDB) / 2 + TN * LDC;
};

template <int TP, typename LoadA, typename LoadB, typename Epilogue>
__device__ void block_gemm(int P, int N, int K, LoadA load_a, LoadB load_b,
                           Epilogue epilogue, float* stage) {
  constexpr int TN = 4096 / TP;
  constexpr int TI = TP / 16, TJ = TN / 16;
  static_assert(TP % 16 == 0 && TN % 16 == 0, "tile edges: multiples of 16");
  constexpr int NA = TP * kKC / kGemmThreads, NB = TN * kKC / kGemmThreads;
  static_assert(NA * kGemmThreads == TP * kKC && NB * kGemmThreads == TN * kKC,
                "whole staging shares");
  float* As = stage;           // [KC][TP]
  float* Bs = stage + kKC * TP;  // [KC][TN]
  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  auto load_bt = [&](int n, int k) { return load_b(k, n); };

  for (int p0 = 0; p0 < P; p0 += TP) {
    for (int n0 = 0; n0 < N; n0 += TN) {
      float acc[TI][TJ];
#pragma unroll
      for (int i = 0; i < TI; ++i)
#pragma unroll
        for (int j = 0; j < TJ; ++j) acc[i][j] = 0.f;

      float va[NA], vb[NB];
      fetch<NA, TP>(va, load_a, p0, P, 0, K);
      fetch<NB, TN>(vb, load_bt, n0, N, 0, K);
      for (int k0 = 0; k0 < K; k0 += kKC) {
#pragma unroll
        for (int c = 0; c < NA; ++c) As[tid + c * kGemmThreads] = va[c];
#pragma unroll
        for (int c = 0; c < NB; ++c) Bs[tid + c * kGemmThreads] = vb[c];
        __syncthreads();
        if (k0 + kKC < K) {  // the next step's loads fly during this one
          fetch<NA, TP>(va, load_a, p0, P, k0 + kKC, K);
          fetch<NB, TN>(vb, load_bt, n0, N, k0 + kKC, K);
        }
#pragma unroll
        for (int kk = 0; kk < kKC; ++kk) {
          float a[TI], b[TJ];
#pragma unroll
          for (int i = 0; i < TI; ++i) a[i] = As[kk * TP + tx + 16 * i];
#pragma unroll
          for (int j = 0; j < TJ; ++j) b[j] = Bs[kk * TN + ty + 16 * j];
#pragma unroll
          for (int i = 0; i < TI; ++i)
#pragma unroll
            for (int j = 0; j < TJ; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
        }
        __syncthreads();  // the next step overwrites As, Bs
      }
#pragma unroll
      for (int i = 0; i < TI; ++i) {
        const int p = p0 + tx + 16 * i;
#pragma unroll
        for (int j = 0; j < TJ; ++j) {
          const int n = n0 + ty + 16 * j;
          if (p < P && n < N) epilogue(p, n, acc[i][j]);
        }
      }
    }
  }
}

template <int WM, int WN, int FM, int FN, typename LoadA, typename LoadB,
          typename Epilogue>
__device__ void block_gemm_tc(int P, int N, int K, LoadA load_a, LoadB load_b,
                              Epilogue epilogue, float* stage) {
  using namespace nvcuda;
  using Tile = TcTile<WM, WN, FM, FN>;
  constexpr int TP = Tile::TP, TN = Tile::TN, KC = Tile::KC;
  constexpr int LDA = Tile::LDA, LDB = Tile::LDB, LDC = Tile::LDC;
  static_assert(WM * WN * 32 == kGemmThreads, "one warp per sub-tile");
  // A column-major ([k][p]), B row-major ([k][n]), C column-major ([n][p]):
  // every staging store and epilogue read is unit-stride across lanes
  __nv_bfloat16* As = reinterpret_cast<__nv_bfloat16*>(stage);
  __nv_bfloat16* Bs = As + KC * LDA;
  float* Cs = stage + KC * (LDA + LDB) / 2;
  constexpr int NA = TP * KC / kGemmThreads, NB = TN * KC / kGemmThreads;
  static_assert(NA * kGemmThreads == TP * KC && NB * kGemmThreads == TN * KC,
                "whole staging shares");
  const int tid = threadIdx.x, warp = tid >> 5;
  const int wm = warp % WM, wn = warp / WM;
  auto load_bt = [&](int n, int k) { return load_b(k, n); };

  for (int p0 = 0; p0 < P; p0 += TP) {
    for (int n0 = 0; n0 < N; n0 += TN) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[FM][FN];
#pragma unroll
      for (int i = 0; i < FM; ++i)
#pragma unroll
        for (int j = 0; j < FN; ++j) wmma::fill_fragment(acc[i][j], 0.f);

      float va[NA], vb[NB];
      fetch<NA, TP>(va, load_a, p0, P, 0, K);
      fetch<NB, TN>(vb, load_bt, n0, N, 0, K);
      for (int k0 = 0; k0 < K; k0 += KC) {
#pragma unroll
        for (int c = 0; c < NA; ++c) {
          const int idx = tid + c * kGemmThreads;
          As[(idx / TP) * LDA + idx % TP] = __float2bfloat16(va[c]);
        }
#pragma unroll
        for (int c = 0; c < NB; ++c) {
          const int idx = tid + c * kGemmThreads;
          Bs[(idx / TN) * LDB + idx % TN] = __float2bfloat16(vb[c]);
        }
        __syncthreads();
        if (k0 + KC < K) {  // the next step's loads fly during this one
          fetch<NA, TP>(va, load_a, p0, P, k0 + KC, K);
          fetch<NB, TN>(vb, load_bt, n0, N, k0 + KC, K);
        }
#pragma unroll
        for (int kk = 0; kk < KC; kk += 16) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                         wmma::col_major> a[FM];
          wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                         wmma::row_major> b[FN];
#pragma unroll
          for (int i = 0; i < FM; ++i)
            wmma::load_matrix_sync(a[i], As + kk * LDA + (wm * FM + i) * 16,
                                   LDA);
#pragma unroll
          for (int j = 0; j < FN; ++j)
            wmma::load_matrix_sync(b[j], Bs + kk * LDB + (wn * FN + j) * 16,
                                   LDB);
#pragma unroll
          for (int i = 0; i < FM; ++i)
#pragma unroll
            for (int j = 0; j < FN; ++j)
              wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
        }
        __syncthreads();  // the next step overwrites As, Bs
      }
#pragma unroll
      for (int i = 0; i < FM; ++i)
#pragma unroll
        for (int j = 0; j < FN; ++j)
          wmma::store_matrix_sync(
              Cs + (wn * FN + j) * 16 * LDC + (wm * FM + i) * 16, acc[i][j],
              LDC, wmma::mem_col_major);
      __syncthreads();
      for (int idx = tid; idx < TP * TN; idx += kGemmThreads) {
        const int p = idx % TP, n = idx / TP;
        if (p0 + p < P && n0 + n < N) epilogue(p0 + p, n0 + n, Cs[n * LDC + p]);
      }
      __syncthreads();  // the next tile overwrites Cs
    }
  }
}

template <typename T>
struct IsF32 {
  static constexpr bool value = false;
};
template <>
struct IsF32<float> {
  static constexpr bool value = true;
};

// The product for dtype T at a TP-row tile: scalar FMAs for float32, the
// tensor cores for bfloat16 (TP 128: 128 x 32 tiles, 64: 64 x 64, 32:
// 32 x 128, 16: 16 x 128).
template <typename T, int TP>
struct Gemm {
  using Tc = TcTile<TP == 128 ? 8 : TP == 64 ? 4 : TP == 32 ? 2 : 1,
                    TP == 128 ? 1 : TP == 64 ? 2 : TP == 32 ? 4 : 8, 1,
                    TP == 128 ? 2 : TP == 64 ? 2 : TP == 32 ? 2 : 1>;
  static_assert(IsF32<T>::value || Tc::TP == TP, "no tensor-core tile");

  __host__ __device__ static constexpr int stage_floats() {
    return IsF32<T>::value ? scalar_stage_floats<TP>() : Tc::kStageFloats;
  }

  template <typename LoadA, typename LoadB, typename Epilogue>
  __device__ static void run(int P, int N, int K, LoadA load_a, LoadB load_b,
                             Epilogue epilogue, float* stage) {
    if constexpr (IsF32<T>::value) {
      block_gemm<TP>(P, N, K, load_a, load_b, epilogue, stage);
    } else {
      constexpr int WM = TP == 128 ? 8 : TP == 64 ? 4 : TP == 32 ? 2 : 1;
      constexpr int WN = 8 / WM;
      constexpr int FN = Tc::TN / (16 * WN);
      block_gemm_tc<WM, WN, 1, FN>(P, N, K, load_a, load_b, epilogue, stage);
    }
  }
};

}  // namespace cris
