// K5: the BN-folded stride-1 ResNet bottleneck, one kernel per block.
//
// Replaces the TPU kernel `fused_bottleneck` (cris_tpu/ops/pallas/
// bottleneck.py:181, body `_kernel` at :55). Same function and rounding:
//   y1 = dt(relu(b1 + x w1))                 1x1, C -> mid
//   y2 = dt(relu(b2 + conv3x3(y1)))          zero padding on y1, mid -> mid
//   y  = dt(relu(b3 + y2 w3 + f32(x)))       1x1, mid -> C, residual in f32
// with f32 sums and f32 biases; dt is the input's dtype (f32 or bf16).
//
// Design for Hopper (not the TPU's flat-buffer windows and row-split VMEM
// arithmetic, which exist for Mosaic's alignment rules):
// - One block per (image, band of R output rows), R 4, 2 or 1: the band
//   whose blocks keep the most of the card busy per unit of work, counting
//   the blocks that fit an SM's shared memory and conv1's halo rows.
// - conv1 runs over the band's rows and one halo row above and below,
//   those inside the image, into y1 (shared, [mid][R+2][W+2], compute
//   dtype). y1 is zeroed first, so its border columns and any halo row
//   outside the image stay 0: conv2's padding is zero on conv1's OUTPUT,
//   not relu(b1), which is the JAX kernel's `top`/`bot`/`valid` masking.
// - conv2 (3x3) is a product of depth 9 * mid over shifted reads of y1,
//   into y2 (shared, [mid][R*W]); conv3 reads y2, adds b3 and the residual
//   (x re-read through its strides, from L2), applies the ReLU and stores.
//   A last band shorter than R (H % R != 0) runs with its own row count.
// - x and the output are addressed through (batch, row, column, channel)
//   strides, so the model hands an NHWC view of its NCHW maps and nothing
//   is transposed; the weights stream from device memory (L2 holds even
//   layer4's 8.9 MB of bf16 weights).
// - The three products are block_gemm.cuh's: for bf16 the tensor cores
//   through WMMA (16 x 16 x 16 mma.sync tiles, f32 accumulators; row tiles
//   of 64, 32 or 16 pixels as W fills them), for f32 scalar FMAs (f32
//   accumulation of f32 products has no tensor-core form but TF32, which
//   rounds the inputs). Every R50 tail block is 1.5 GFLOP per image and
//   moves at most 11 MB per image in bf16, so its bound on the H100 is
//   24-53 us per B 16 launch (memory at 104^2, operations from 26^2 on).
//   What bounds this kernel is its staging: each element of A and B is
//   fetched one at a time through an index functor into shared memory
//   before the tensor cores see it. TMA-fed wgmma tiles are the next step.

#include <stdint.h>

#include <algorithm>

#include "block_gemm.cuh"

namespace {

using cris::Gemm;
using cris::from_f32;
using cris::kGemmThreads;
using cris::to_f32;

// H100 SXM: 132 SMs with 228 KB of shared memory each, at most 227 KB a
// block, 1 KB of each block's share reserved
constexpr long long kSMs = 132;
constexpr size_t kSmemPerSM = 228 * 1024;
constexpr size_t kMaxSmem = 227 * 1024;
constexpr size_t kSmemReserved = 1024;
// __launch_bounds__(256, 2): at most 128 registers, two blocks per SM
constexpr long long kMaxResident = 2;

template <typename T, int TP>
size_t smem_bytes(int R, int W, int mid) {
  return sizeof(float) * Gemm<T, TP>::stage_floats() +
         sizeof(T) * (size_t)mid * ((R + 2) * (W + 2) + R * W);
}

template <typename T, int TP>
__global__ void __launch_bounds__(kGemmThreads, 2)
bottleneck_kernel(const T* __restrict__ x, const T* __restrict__ w1,
                  const float* __restrict__ b1, const T* __restrict__ w2,
                  const float* __restrict__ b2, const T* __restrict__ w3,
                  const float* __restrict__ b3, T* __restrict__ out, int H,
                  int W, int C, int mid, int R, long long xsb, long long xsh,
                  long long xsw, long long xsc, long long osb, long long osh,
                  long long osw, long long osc) {
  extern __shared__ __align__(128) float smem[];
  float* stage = smem;
  using G = Gemm<T, TP>;
  T* y1 = reinterpret_cast<T*>(smem + G::stage_floats());
  const int W2 = W + 2;
  const int plane1 = (R + 2) * W2;  // y1: [mid][R+2][W+2]
  T* y2 = y1 + (size_t)mid * plane1;
  const int plane2 = R * W;         // y2: [mid][R*W]

  const int r0 = blockIdx.x * R;
  const int rows = min(R, H - r0);
  const T* xb = x + blockIdx.y * xsb;
  T* ob = out + blockIdx.y * osb;

  for (int i = threadIdx.x; i < mid * plane1; i += kGemmThreads)
    y1[i] = from_f32<T>(0.f);
  __syncthreads();

  // conv1 over image rows [lo, hi): the band and its halo inside the image
  const int lo = max(r0 - 1, 0), hi = min(r0 + rows + 1, H);
  G::run(
      (hi - lo) * W, mid, C,
      [&](int p, int k) {
        const int r = p / W, c = p - r * W;
        return to_f32(xb[(lo + r) * xsh + c * xsw + k * xsc]);
      },
      [&](int k, int n) { return to_f32(w1[(size_t)k * mid + n]); },
      [&](int p, int n, float acc) {
        const int r = p / W, c = p - r * W;
        y1[(size_t)n * plane1 + (lo + r - r0 + 1) * W2 + c + 1] =
            from_f32<T>(fmaxf(acc + b1[n], 0.f));
      },
      stage);
  __syncthreads();

  // conv2: depth index k = tap * mid + ci, tap = 3 * dy + dx (HWIO order)
  G::run(
      rows * W, mid, 9 * mid,
      [&](int p, int k) {
        const int i = p / W, j = p - i * W;
        const int tap = k / mid, ci = k - tap * mid;
        const int dy = tap / 3, dx = tap - 3 * dy;
        return to_f32(y1[(size_t)ci * plane1 + (i + dy) * W2 + j + dx]);
      },
      [&](int k, int n) { return to_f32(w2[(size_t)k * mid + n]); },
      [&](int p, int n, float acc) {
        y2[(size_t)n * plane2 + p] = from_f32<T>(fmaxf(acc + b2[n], 0.f));
      },
      stage);
  __syncthreads();

  // conv3 + bias + residual in f32 + ReLU
  G::run(
      rows * W, C, mid,
      [&](int p, int k) { return to_f32(y2[(size_t)k * plane2 + p]); },
      [&](int k, int n) { return to_f32(w3[(size_t)k * C + n]); },
      [&](int p, int n, float acc) {
        const int i = p / W, j = p - i * W;
        const int row = r0 + i;
        const float v =
            acc + b3[n] + to_f32(xb[row * xsh + j * xsw + n * xsc]);
        ob[row * osh + j * osw + n * osc] = from_f32<T>(fmaxf(v, 0.f));
      },
      stage);
}

template <typename T, int TP>
cudaError_t launch(const void* x, const void* w1, const void* b1,
                   const void* w2, const void* b2, const void* w3,
                   const void* b3, void* out, int B, int H, int W, int C,
                   int mid, const long long* xs, const long long* os,
                   cudaStream_t stream) {
  // The band that keeps the most blocks resident on the card per unit of
  // work: conv1's share of the work runs over R + 2 rows, the rest over R.
  // Ties go to the larger band.
  const double conv1_share = (double)C * mid / (2.0 * C * mid + 9.0 * mid * mid);
  int R = 0;
  size_t smem = 0;
  double best = 0.0;
  for (int r = 4; r >= 1; r /= 2) {
    const size_t bytes = smem_bytes<T, TP>(r, W, mid);
    if (bytes > kMaxSmem) continue;
    const long long resident = std::min<long long>(
        kMaxResident, kSmemPerSM / (bytes + kSmemReserved));
    const long long busy =
        std::min<long long>((long long)B * ((H + r - 1) / r), kSMs * resident);
    const double score = busy / (1.0 + conv1_share * 2.0 / r);
    if (score > best * 1.0001) {
      best = score;
      R = r;
      smem = bytes;
    }
  }
  if (R == 0) return cudaErrorInvalidValue;
  auto kern = bottleneck_kernel<T, TP>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((H + R - 1) / R, B);
  kern<<<grid, kGemmThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w1),
      static_cast<const float*>(b1), static_cast<const T*>(w2),
      static_cast<const float*>(b2), static_cast<const T*>(w3),
      static_cast<const float*>(b3), static_cast<T*>(out), H, W, C, mid, R,
      xs[0], xs[1], xs[2], xs[3], os[0], os[1], os[2], os[3]);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* x, const void* w1, const void* b1,
                     const void* w2, const void* b2, const void* w3,
                     const void* b3, void* out, int B, int H, int W, int C,
                     int mid, const long long* xs, const long long* os,
                     cudaStream_t stream) {
  // row tiles that the band's W-pixel rows fill (the scalar f32 product
  // keeps 32: its 16 x 256 tile would load as much as it computes)
  if (W <= 16 && !cris::IsF32<T>::value)
    return launch<T, 16>(x, w1, b1, w2, b2, w3, b3, out, B, H, W, C, mid, xs,
                         os, stream);
  if (W <= 32)
    return launch<T, 32>(x, w1, b1, w2, b2, w3, b3, out, B, H, W, C, mid, xs,
                         os, stream);
  return launch<T, 64>(x, w1, b1, w2, b2, w3, b3, out, B, H, W, C, mid, xs,
                       os, stream);
}

}  // namespace

// Plain C entry point, bound with ctypes. Pointers are device pointers;
// x and out are (B, H, W, C) addressed through the given strides (in
// elements); w1 (C, mid), w2 (9, mid, mid), w3 (mid, C) contiguous in the
// dtype; b1, b2 (mid) and b3 (C) f32. dtype: 0 = float32, 1 = bfloat16.
// Returns the cudaError_t of the launch.
extern "C" int cris_bottleneck(const void* x, const void* w1, const void* b1,
                               const void* w2, const void* b2, const void* w3,
                               const void* b3, void* out, int B, int H, int W,
                               int C, int mid, int dtype, long long xsb,
                               long long xsh, long long xsw, long long xsc,
                               long long osb, long long osh, long long osw,
                               long long osc, void* stream) {
  if (B < 1 || H < 1 || W < 1 || C < 1 || mid < 1 || B > 65535)
    return (int)cudaErrorInvalidValue;
  const long long xs[4] = {xsb, xsh, xsw, xsc};
  const long long os[4] = {osb, osh, osw, osc};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)dispatch<float>(x, w1, b1, w2, b2, w3, b3, out, B, H, W, C,
                                mid, xs, os, st);
  if (dtype == 1)
    return (int)dispatch<__nv_bfloat16>(x, w1, b1, w2, b2, w3, b3, out, B, H,
                                        W, C, mid, xs, os, st);
  return (int)cudaErrorInvalidValue;
}
