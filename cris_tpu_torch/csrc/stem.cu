// K7: the BN-folded ResNet stem and its 2x2 average pool, one kernel.
//
// Replaces the TPU kernel `fused_stem_pool` (cris_tpu/ops/pallas/stem.py:145,
// body `_stem_kernel` at :114). Same function and rounding (`_conv_stage`,
// stem.py:86-111):
//   a1 = dt(relu(b1 + conv1_3x3_s2(dt(img))))    3 -> C1, H/2 x W/2
//   a2 = dt(relu(b2 + conv2_3x3(a1)))            C1 -> C2
//   a3 = dt(relu(b3 + conv3_3x3(a2)))            C2 -> C3
//   r  = dt((a3[2i][c] + a3[2i+1][c]) * 0.25)     the row pairs, f32 sums
//   y  = dt(r[i][2j] + r[i][2j+1])               the column pairs, H/4 x W/4
// all convs with zero padding 1, f32 sums, f32 biases; dt is the kernels'
// dtype (f32 or bf16). The pool rounds where the TPU kernel does: its
// row-pair mean is cast to dt in the kernel (stem.py:142) and the column
// pair is added in dt after it (:203).
//
// Design for Hopper (the TPU kernel's space-to-depth embedding of conv1
// and its 210-wide flat frames are there for the TPU's matrix unit and
// VMEM tiling; neither is needed here):
// - One block per (image, 8 x 8 tile of pooled output). It computes conv1
//   over the tile's 16 x 16 conv3 grid plus a 2-pixel halo (20 x 20, the
//   plain stride-2 conv read straight from the image through its strides,
//   cast to dt on load), conv2 over 18 x 18, conv3 over 16 x 16, and the
//   pool; every intermediate lives in shared memory ([C][rows][cols] in
//   dt; R50 f32 117 KB, bf16 63 KB) and only the pooled map is written.
// - A conv's input is zero outside [0, H/2) x [0, W/2): halo positions of
//   a1 and a2 outside the image are stored as 0, not relu(bias), which is
//   the JAX kernel's `keep` mask.
// - The convs are block_gemm.cuh's products (128 pixels x 32 channels per
//   tile), depth 27, 9 * C1 and 9 * C2: WMMA tensor-core tiles in bf16,
//   scalar FMAs in f32. On R50 at 416 px and B 16 the stem is 39.5 GFLOP
//   and 55 MB in bf16, bound by operations at 40 us; the halo adds 56% to
//   conv1 and 27% to conv2, and the per-element staging into shared memory
//   bounds the kernel, as in K5.

#include <stdint.h>

#include "block_gemm.cuh"

namespace {

using cris::Gemm;
using cris::from_f32;
using cris::kGemmThreads;
using cris::round_to;
using cris::to_f32;

constexpr int kTP = 128;    // pixels per product tile
constexpr int kTile = 8;    // pooled outputs per block edge
constexpr int kE3 = 2 * kTile;  // conv3 grid edge: 16
constexpr int kE2 = kE3 + 2;    // conv2 grid edge: 18
constexpr int kE1 = kE3 + 4;    // conv1 grid edge: 20
constexpr size_t kMaxSmem = 227 * 1024;

__host__ __device__ size_t a1_elems(int C1, int C3) {
  // a1 [C1][20][20], later reused for a3 [C3][16][16]
  const int n1 = C1 * kE1 * kE1, n3 = C3 * kE3 * kE3;
  return (size_t)(n1 > n3 ? n1 : n3);
}

template <typename T>
size_t smem_bytes(int C1, int C2, int C3) {
  return sizeof(float) * Gemm<T, kTP>::stage_floats() +
         sizeof(T) * (a1_elems(C1, C3) + (size_t)C2 * kE2 * kE2);
}

template <typename T>
__global__ void __launch_bounds__(kGemmThreads, 2)
stem_kernel(const float* __restrict__ img, const T* __restrict__ k1,
            const float* __restrict__ b1, const T* __restrict__ k2,
            const float* __restrict__ b2, const T* __restrict__ k3,
            const float* __restrict__ b3, T* __restrict__ out, int H, int W,
            int C1, int C2, int C3, long long isb, long long ish,
            long long isw, long long isc, long long osb, long long osh,
            long long osw, long long osc) {
  extern __shared__ __align__(128) float smem[];
  float* stage = smem;
  using G = Gemm<T, kTP>;
  T* a1 = reinterpret_cast<T*>(smem + G::stage_floats());
  T* a3 = a1;  // a1 is dead once conv2 has run
  T* a2 = a1 + a1_elems(C1, C3);

  const int H2 = H / 2, W2 = W / 2, H4 = H / 4, W4 = W / 4;
  const int q0 = blockIdx.y * kTile, v0 = blockIdx.x * kTile;
  const int u3 = 2 * q0, x3 = 2 * v0;  // conv3 grid origin, in H/2 x W/2
  const float* ib = img + blockIdx.z * isb;
  T* ob = out + blockIdx.z * osb;

  // conv1, stride 2, over conv-grid rows [u3-2, u3+18) x cols [x3-2, x3+18);
  // depth index k = (3 * ky + kx) * 3 + ci (HWIO order)
  G::run(
      kE1 * kE1, C1, 27,
      [&](int p, int k) {
        const int i = p / kE1, j = p - i * kE1;
        const int tap = k / 3, ci = k - 3 * tap;
        const int ky = tap / 3, kx = tap - 3 * ky;
        const int ih = 2 * (u3 - 2 + i) - 1 + ky;
        const int iw = 2 * (x3 - 2 + j) - 1 + kx;
        if (ih < 0 || ih >= H || iw < 0 || iw >= W) return 0.f;
        return round_to<T>(ib[ih * ish + iw * isw + ci * isc]);
      },
      [&](int k, int n) { return to_f32(k1[(size_t)k * C1 + n]); },
      [&](int p, int n, float acc) {
        const int i = p / kE1, j = p - i * kE1;
        const int u = u3 - 2 + i, v = x3 - 2 + j;
        const bool in = u >= 0 && u < H2 && v >= 0 && v < W2;
        a1[(size_t)n * kE1 * kE1 + p] =
            from_f32<T>(in ? fmaxf(acc + b1[n], 0.f) : 0.f);
      },
      stage);
  __syncthreads();

  // conv2 over rows [u3-1, u3+17): output (i, j) reads a1 at (i+ky, j+kx)
  G::run(
      kE2 * kE2, C2, 9 * C1,
      [&](int p, int k) {
        const int i = p / kE2, j = p - i * kE2;
        const int tap = k / C1, ci = k - tap * C1;
        const int ky = tap / 3, kx = tap - 3 * ky;
        return to_f32(a1[(size_t)ci * kE1 * kE1 + (i + ky) * kE1 + j + kx]);
      },
      [&](int k, int n) { return to_f32(k2[(size_t)k * C2 + n]); },
      [&](int p, int n, float acc) {
        const int i = p / kE2, j = p - i * kE2;
        const int u = u3 - 1 + i, v = x3 - 1 + j;
        const bool in = u >= 0 && u < H2 && v >= 0 && v < W2;
        a2[(size_t)n * kE2 * kE2 + p] =
            from_f32<T>(in ? fmaxf(acc + b2[n], 0.f) : 0.f);
      },
      stage);
  __syncthreads();

  // conv3 over rows [u3, u3+16)
  G::run(
      kE3 * kE3, C3, 9 * C2,
      [&](int p, int k) {
        const int i = p / kE3, j = p - i * kE3;
        const int tap = k / C2, ci = k - tap * C2;
        const int ky = tap / 3, kx = tap - 3 * ky;
        return to_f32(a2[(size_t)ci * kE2 * kE2 + (i + ky) * kE2 + j + kx]);
      },
      [&](int k, int n) { return to_f32(k3[(size_t)k * C3 + n]); },
      [&](int p, int n, float acc) {
        a3[(size_t)n * kE3 * kE3 + p] = from_f32<T>(fmaxf(acc + b3[n], 0.f));
      },
      stage);
  __syncthreads();

  // 2x2 average pool, rounded as the TPU kernel rounds: each column's
  // row-pair mean to dt, then the two columns added (in f32, rounded to
  // dt); neighbouring threads take neighbouring columns
  for (int idx = threadIdx.x; idx < C3 * kTile * kTile;
       idx += kGemmThreads) {
    const int c = idx / (kTile * kTile), pp = idx - c * kTile * kTile;
    const int pi = pp / kTile, pj = pp - pi * kTile;
    const int q = q0 + pi, w = v0 + pj;
    if (q >= H4 || w >= W4) continue;
    const T* a = a3 + (size_t)c * kE3 * kE3 + (2 * pi) * kE3 + 2 * pj;
    const T r0 = from_f32<T>((to_f32(a[0]) + to_f32(a[kE3])) * 0.25f);
    const T r1 = from_f32<T>((to_f32(a[1]) + to_f32(a[kE3 + 1])) * 0.25f);
    ob[q * osh + w * osw + c * osc] = from_f32<T>(to_f32(r0) + to_f32(r1));
  }
}

template <typename T>
cudaError_t launch(const void* img, const void* k1, const void* b1,
                   const void* k2, const void* b2, const void* k3,
                   const void* b3, void* out, int B, int H, int W, int C1,
                   int C2, int C3, const long long* is, const long long* os,
                   cudaStream_t stream) {
  const size_t smem = smem_bytes<T>(C1, C2, C3);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  auto kern = stem_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((W / 4 + kTile - 1) / kTile, (H / 4 + kTile - 1) / kTile, B);
  kern<<<grid, kGemmThreads, smem, stream>>>(
      static_cast<const float*>(img), static_cast<const T*>(k1),
      static_cast<const float*>(b1), static_cast<const T*>(k2),
      static_cast<const float*>(b2), static_cast<const T*>(k3),
      static_cast<const float*>(b3), static_cast<T*>(out), H, W, C1, C2, C3,
      is[0], is[1], is[2], is[3], os[0], os[1], os[2], os[3]);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point, bound with ctypes. Pointers are device pointers;
// img is f32 (B, H, W, 3) and out (B, H/4, W/4, C3), both addressed through
// the given strides (in elements); k1 (3, 3, 3, C1), k2 (3, 3, C1, C2),
// k3 (3, 3, C2, C3) contiguous HWIO in the dtype; biases f32. H and W are
// multiples of 4. dtype: 0 = float32, 1 = bfloat16. Returns the
// cudaError_t of the launch.
extern "C" int cris_stem_pool(const void* img, const void* k1, const void* b1,
                              const void* k2, const void* b2, const void* k3,
                              const void* b3, void* out, int B, int H, int W,
                              int C1, int C2, int C3, int dtype,
                              long long isb, long long ish, long long isw,
                              long long isc, long long osb, long long osh,
                              long long osw, long long osc, void* stream) {
  if (B < 1 || B > 65535 || H < 4 || W < 4 || H % 4 || W % 4 || C1 < 1 ||
      C2 < 1 || C3 < 1)
    return (int)cudaErrorInvalidValue;
  const long long is[4] = {isb, ish, isw, isc};
  const long long os[4] = {osb, osh, osw, osc};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)launch<float>(img, k1, b1, k2, b2, k3, b3, out, B, H, W, C1,
                              C2, C3, is, os, st);
  if (dtype == 1)
    return (int)launch<__nv_bfloat16>(img, k1, b1, k2, b2, k3, b3, out, B, H,
                                      W, C1, C2, C3, is, os, st);
  return (int)cudaErrorInvalidValue;
}
