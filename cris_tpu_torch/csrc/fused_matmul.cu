// K4: the fused channel matmul, out = [relu](x w + bias [+ residual]).
//
// Replaces the TPU kernel `fused_matmul` (cris_tpu/ops/pallas/
// fused_matmul.py:48, `pallas_call`s at :81 with a residual, body
// `_kernel_residual` at :24, and :90 without, body `_kernel_plain` at
// :33). Same function and rounding: the product is summed in f32, the f32
// bias and the residual (cast to f32) are added in that order, then the
// ReLU, and the result is rounded once to x's dtype (f32 or bf16). A 1x1
// convolution on NHWC maps (`conv1x1_fused`, :101) is this product over
// the B*H*W pixels.
//
// Two routes, both hand-written; the Python wrapper picks one before the
// launch (ops/kernels/fused_matmul.py, fused_matmul_route):
//
// - "wgmma" (cris_fused_matmul_wgmma): bf16 operands that TMA can address
//   (16-byte aligned bases, unit stride along x's K and along w's N or K,
//   the other strides multiples of 16 bytes). gemm_sm90.cuh's TMA-fed
//   wgmma tile: a 3-stage ring of 128-byte swizzled tiles, one producer
//   warp, wgmma m64n128k16 with f32 accumulators in registers. w N-major
//   (a contiguous (K, N)) and K-major (nn.Linear's weight.t()) are two
//   instantiations (the wgmma B operand transposed or not). Two blocks
//   share an SM, so one's epilogue overlaps the other's products. Tile rule:
//   128 x 128 tiles (two consumer warpgroups) unless they number fewer
//   than the card's SMs, then 64 x 128 (one): layer4's 13^2 conv1 (M 2704,
//   N 512) gets 172 blocks instead of 88. The epilogue reads the staged
//   accumulators a row segment of 8 columns a thread, adds the bias, the
//   residual (any strides) and the ReLU, rounds once and stores 16 bytes
//   a thread, neighbouring threads on neighbouring columns.
// - "staged" (cris_fused_matmul): float32, and any layout TMA cannot take
//   (the JAX test's ragged (300, 70) -> 130: x's rows are 140 bytes). One
//   64 x 64 tile of block_gemm.cuh per block, computed transposed (out^T =
//   w^T x^T) so that w, the residual and the output are coalesced; x, w and
//   the residual through their strides; float32 as scalar FMAs (f32
//   products summed in f32 have no tensor-core form but TF32, which would
//   round the inputs), bf16 as WMMA. Ragged M, N and K are staged as 0.
//
// What bounds it on the card: at the decoder FFN's fc1 (M 10 816, K 512,
// N 2048) the product is 22.7 GFLOP against 36 MB of bf16 traffic, so the
// bound is the tensor cores' 989 TFLOP/s (23 us). The wgmma route runs one
// tile per block, two blocks per SM: a tile's pipeline fill and epilogue
// overlap only the other block's products, and each tile's 8 k-steps (K
// 512) leave the fill a large share. A persistent grid that streams tiles
// through one ring is the step after; the staged route stays bound by its
// per-element functor staging (19.6 TFLOP/s at fc1, PERF.md).

#include <stdint.h>

#include "block_gemm.cuh"
#include "gemm_sm90.cuh"

namespace {

using cris::Gemm;
using cris::from_f32;
using cris::kGemmThreads;
using cris::to_f32;

constexpr int kTile = 64;  // output tile edge, both ways

template <typename T>
__global__ void __launch_bounds__(kGemmThreads)
fused_matmul_kernel(const T* __restrict__ x, const T* __restrict__ w,
                    const float* __restrict__ bias,
                    const T* __restrict__ residual, T* __restrict__ out,
                    int M, int N, int K, int relu, long long xs_m,
                    long long xs_k, long long ws_k, long long ws_n,
                    long long rs_m, long long rs_n) {
  extern __shared__ __align__(128) float stage[];
  const int m0 = blockIdx.x * kTile;
  const int n0 = blockIdx.y * kTile;
  // the product's "rows" are output columns n0 + p, its "columns" output
  // rows m0 + q: out^T[p][q] = sum_k w[k][n0 + p] x[m0 + q][k]
  Gemm<T, kTile>::run(
      min(kTile, N - n0), min(kTile, M - m0), K,
      [&](int p, int k) { return to_f32(w[k * ws_k + (n0 + p) * ws_n]); },
      [&](int k, int q) { return to_f32(x[(m0 + q) * xs_m + k * xs_k]); },
      [&](int p, int q, float acc) {
        const int n = n0 + p;
        const long long m = m0 + q;
        float y = acc + bias[n];
        if (residual != nullptr) y += to_f32(residual[m * rs_m + n * rs_n]);
        if (relu) y = fmaxf(y, 0.f);
        out[m * N + n] = from_f32<T>(y);
      },
      stage);
}

template <typename T>
cudaError_t launch(const void* x, const void* w, const void* bias,
                   const void* residual, void* out, int M, int N, int K,
                   int relu, const long long* s, cudaStream_t stream) {
  constexpr size_t smem = sizeof(float) * Gemm<T, kTile>::stage_floats();
  dim3 grid((M + kTile - 1) / kTile, (N + kTile - 1) / kTile);
  fused_matmul_kernel<T><<<grid, kGemmThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w),
      static_cast<const float*>(bias), static_cast<const T*>(residual),
      static_cast<T*>(out), M, N, K, relu, s[0], s[1], s[2], s[3], s[4],
      s[5]);
  return cudaGetLastError();
}

// The wgmma route: gemm_sm90.cuh's tile, then the epilogue from the staged
// f32 accumulators.
template <int NC, bool B_NMAJOR>
__global__ void __launch_bounds__(cris::sm90::GemmTile<NC>::kThreads, 2)
fused_matmul_wgmma_kernel(const __grid_constant__ CUtensorMap ta,
                          const __grid_constant__ CUtensorMap tb,
                          const float* __restrict__ bias,
                          const __nv_bfloat16* __restrict__ residual,
                          __nv_bfloat16* __restrict__ out, int M, int N, int K,
                          int relu, long long rs_m, long long rs_n) {
  using namespace cris::sm90;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const int m0 = blockIdx.x * GemmTile<NC>::kBM;
  const int n0 = blockIdx.y * kBN;
  float* cbuf;
  const int wg = gemm_tile<NC, B_NMAJOR>(&ta, &tb, m0, n0, K, smem, &cbuf);
  if (wg == NC) return;  // the producer warp

  // 64 rows x 16 segments of 8 columns, 8 segments a thread; 16
  // neighbouring threads cover one row's 128 columns
  const float* c = cbuf + wg * 64 * kLdc;
  const bool vec = (N % 8) == 0;  // 16-byte aligned output rows
  for (int i = threadIdx.x % 128; i < 64 * 16; i += 128) {
    const int r = i / 16, cc = (i % 16) * 8;
    const long long m = m0 + wg * 64 + r;
    const int n = n0 + cc;
    if (m >= M || n >= N) continue;
    const float4 lo = *reinterpret_cast<const float4*>(&c[r * kLdc + cc]);
    const float4 hi = *reinterpret_cast<const float4*>(&c[r * kLdc + cc + 4]);
    float y[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      if (n + e < N) {
        y[e] += bias[n + e];
        if (residual != nullptr)
          y[e] += __bfloat162float(residual[m * rs_m + (n + e) * rs_n]);
        if (relu) y[e] = fmaxf(y[e], 0.f);
      }
    }
    __nv_bfloat16* dst = out + m * N + n;
    if (vec && n + 8 <= N) {
      uint32_t w[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const __nv_bfloat162 pair = __floats2bfloat162_rn(y[2 * e], y[2 * e + 1]);
        w[e] = *reinterpret_cast<const uint32_t*>(&pair);
      }
      *reinterpret_cast<uint4*>(dst) = make_uint4(w[0], w[1], w[2], w[3]);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e)
        if (n + e < N) dst[e] = __float2bfloat16(y[e]);
    }
  }
}

template <int NC, bool B_NMAJOR>
cudaError_t launch_wgmma(const CUtensorMap& ta, const CUtensorMap& tb,
                         const void* bias, const void* residual, void* out,
                         int M, int N, int K, int relu, long long rs_m,
                         long long rs_n, cudaStream_t stream) {
  using Tile = cris::sm90::GemmTile<NC>;
  auto kern = fused_matmul_wgmma_kernel<NC, B_NMAJOR>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, Tile::kSmemBytes);
  if (err != cudaSuccess) return err;
  dim3 grid((M + Tile::kBM - 1) / Tile::kBM,
            (N + cris::sm90::kBN - 1) / cris::sm90::kBN);
  kern<<<grid, Tile::kThreads, Tile::kSmemBytes, stream>>>(
      ta, tb, static_cast<const float*>(bias),
      static_cast<const __nv_bfloat16*>(residual),
      static_cast<__nv_bfloat16*>(out), M, N, K, relu, rs_m, rs_n);
  return cudaGetLastError();
}

int sm_count() {
  int dev = 0, n = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess)
    return 132;
  return n;
}

}  // namespace

// Plain C entry point, bound with ctypes. Pointers are device pointers; x
// (M, K), w (K, N) and residual (M, N, or null) in the dtype, addressed
// through the given (row, column) strides in elements; bias (N) f32; out
// contiguous (M, N) in the dtype. dtype: 0 = float32, 1 = bfloat16; relu:
// 0 or 1. Returns the cudaError_t of the launch.
extern "C" int cris_fused_matmul(const void* x, const void* w,
                                 const void* bias, const void* residual,
                                 void* out, int M, int N, int K, int dtype,
                                 int relu, long long xs_m, long long xs_k,
                                 long long ws_k, long long ws_n,
                                 long long rs_m, long long rs_n,
                                 void* stream) {
  if (M < 1 || N < 1 || K < 0 || N > 65535 * kTile)
    return (int)cudaErrorInvalidValue;
  const long long s[6] = {xs_m, xs_k, ws_k, ws_n, rs_m, rs_n};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)launch<float>(x, w, bias, residual, out, M, N, K, relu, s, st);
  if (dtype == 1)
    return (int)launch<__nv_bfloat16>(x, w, bias, residual, out, M, N, K, relu,
                                      s, st);
  return (int)cudaErrorInvalidValue;
}

// The wgmma route, bf16 only. x (M, K) with unit stride along K and row
// stride xs_m; w (K, N) with unit stride along N (w_nmajor = 1, row stride
// ws) or along K (w_nmajor = 0, column stride ws); bases 16-byte aligned
// and strides multiples of 8 elements, or cudaErrorInvalidValue (the
// Python route sends nothing else here). bias (N) f32; residual (M, N)
// bf16 through (rs_m, rs_n), or null; out contiguous (M, N) bf16.
extern "C" int cris_fused_matmul_wgmma(const void* x, const void* w,
                                       const void* bias, const void* residual,
                                       void* out, int M, int N, int K,
                                       int relu, long long xs_m, int w_nmajor,
                                       long long ws, long long rs_m,
                                       long long rs_n, void* stream) {
  using namespace cris::sm90;
  if (M < 1 || N < 1 || K < 1 || xs_m % 8 || ws % 8 ||
      reinterpret_cast<uintptr_t>(x) % 16 ||
      reinterpret_cast<uintptr_t>(w) % 16 || N > 65535 * kBN)
    return (int)cudaErrorInvalidValue;
  CUtensorMap ta, tb;
  // one consumer warpgroup (64-row tiles) when 128-row tiles would not
  // give every SM a block
  const long long tiles128 =
      (long long)((M + 127) / 128) * ((N + kBN - 1) / kBN);
  const int nc = tiles128 < sm_count() ? 1 : 2;
  if (!make_tmap_2d(&ta, x, K, M, xs_m * 2, kBK, 64 * nc))
    return (int)cudaErrorInvalidValue;
  const bool ok = w_nmajor ? make_tmap_2d(&tb, w, N, K, ws * 2, 64, kBK)
                           : make_tmap_2d(&tb, w, K, N, ws * 2, kBK, kBN);
  if (!ok) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (nc == 1)
    return (int)(w_nmajor ? launch_wgmma<1, true>(ta, tb, bias, residual, out,
                                                  M, N, K, relu, rs_m, rs_n, st)
                          : launch_wgmma<1, false>(ta, tb, bias, residual, out,
                                                   M, N, K, relu, rs_m, rs_n,
                                                   st));
  return (int)(w_nmajor ? launch_wgmma<2, true>(ta, tb, bias, residual, out, M,
                                                N, K, relu, rs_m, rs_n, st)
                        : launch_wgmma<2, false>(ta, tb, bias, residual, out,
                                                 M, N, K, relu, rs_m, rs_n,
                                                 st));
}
