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
// Design for Hopper (not the TPU's (256, K) x (K, 512) VMEM blocks padded
// to 128):
// - One block of 256 threads per 64 x 64 output tile; the product is
//   block_gemm.cuh's (bfloat16: the tensor cores through WMMA, 16 x 16 x 16
//   mma.sync tiles with f32 accumulators, so bf16 products are exact and
//   the sums f32; float32: scalar f32 FMAs, since f32 products summed in
//   f32 have no tensor-core form but TF32, which rounds the inputs).
// - The block computes the tile transposed, out^T = w^T x^T: the tile's
//   fast index is the output column, so neighbouring threads read
//   neighbouring columns of w and of the residual and store neighbouring
//   output elements. x is read through its (row, depth) strides, a row's
//   depth slice per thread, from L1 and L2.
// - Ragged M, N and K (the JAX test's 70 -> 130, layer1's 64 channels) need
//   no padding: out-of-range rows, columns and depths are staged as 0 and
//   never stored.
//
// What bounds it on the card: at the decoder FFN's fc1 (M 10 816, K 512,
// N 2048) the product is 22.7 GFLOP against 36 MB of bf16 traffic, so the
// bound is the tensor cores' 989 TFLOP/s (23 us); this kernel is bound by
// its per-element functor staging into shared memory, as K5 is. TMA-fed
// wgmma tiles are the step after.

#include <stdint.h>

#include "block_gemm.cuh"

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
