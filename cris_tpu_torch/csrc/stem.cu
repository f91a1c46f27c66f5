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
// pair is added in dt after it (:203). A conv's input is zero outside
// [0, H/2) x [0, W/2): a1 and a2 positions outside the image are stored as
// 0, not relu(bias), which is the JAX kernel's `keep` mask. On R50 at 416 px
// and B 16 the stem is 39.5 GFLOP (conv1 3%, conv2 32%, conv3 65%) and
// moves 33.2 MB of f32 image in and 22.2 MB of bf16 map out: bound by
// operations at 40 us. The TPU kernel's space-to-depth embedding of conv1
// and its 210-wide flat frames serve the TPU's matrix unit; neither is
// needed here. Two bodies, picked by the wrapper's `stem_route`:
//
// "tensor_cores", stem_tc_kernel (bf16, C1, C2, C3 multiples of 16,
// contiguous 16-byte aligned weights, a plan that fits shared memory):
// - A persistent grid, one block of 16 warps an SM. Each block copies k1,
//   k2, k3 and the biases into shared memory once (cp.async, rows padded
//   by 16 bytes; 67 KB at R50 widths), then walks its tiles (image, Th x
//   Tw conv3 outputs) round-robin: with a block per tile, every block
//   would re-read the weights from L2, the traffic that binds K5 at
//   layer4.
// - Each grid is flat in shared memory, pixel-major, one row of C + 8 bf16
//   a pixel (ldmatrix's 8 row addresses in distinct banks): a1 over the
//   tile plus a 2-pixel halo, (Th + 4) x (Tw + 4); a2 over (Th + 2) x
//   (Tw + 2). Every product runs on mma.sync.m16n8k16 (bf16 -> f32); a
//   lane's ldmatrix row address is its output pixel's (row, column) in the
//   grid it reads, so a 3x3 tap (dy, dx) is the row offset dy W + dx of
//   that grid, the same for every lane, and no column is computed that no
//   one reads. The taps are unrolled, the channel chunks advance by
//   increments (unrolled too at R50's widths): no integer division in the
//   k steps.
// - conv1 (stride 2, depth 27 in k1's HWIO order (3 ky + kx) 3 + ci,
//   padded to 32 with zero weights) reads its A fragments straight from an
//   f32 image patch of 3 x (2 Th + 9) x (2 Tw + 12), rounding each value
//   to bf16 as it packs it (the JAX img.astype(dtype)). The patch of the
//   next tile is fetched by cp.async (zero outside the image) while this
//   tile's conv2 and conv3 run, 16 bytes a copy where the image's strides
//   allow it: a patch row starts at an image column that is a multiple of
//   4. The image is NCHW f32 seen as NHWC: a warp copies one channel row.
// - conv1 and conv2 take M units of 32 flat positions x 32 channels (the
//   last round of conv2's units split in two, so that every warp has a
//   share), conv3 units of 2 rows x 16 columns x 32 channels (a row pair
//   of the pool); the warps take units round-robin, with no barrier inside
//   a conv. The pool runs in conv3's registers: the two rows' bf16 ReLU
//   outputs summed in f32, times 0.25, rounded; the column pair is the
//   lane 4 apart (__shfl_xor), added and rounded into the pooled tile in
//   shared memory, which goes out by 16-byte stores through the output's
//   strides (an NHWC view of the NCHW map that layer1 reads; one value a
//   store where they refuse it).
// - Two barriers a tile: conv2 (with the last tile's pooled stores), then
//   conv3 together with the next tile's conv1, whose patch landed during
//   conv2 and whose a1 conv2 no longer reads. The conv3 and conv1 units
//   alternate in blocks of four warps, so that each SM sub-partition's
//   warps mix products with conv1's gathers and the epilogues.
// - Edge tiles are smaller (the last band and column tile may be short):
//   their flat widths and unit counts shrink with them, and columns past
//   the map are never stored.
// - The plan (`stem_tc_plan`) picks (Th, Tw) from Th in 2..32 (even) and
//   Tw in {16, 32, 48, 64}: the least makespan of the round-robin walk,
//   each tile costed by its units per conv (halo and rounding to whole
//   rounds of the warps included) and its patch rows, with weights fitted
//   to the measured time of every tile, under the 227 KB shared-memory
//   cap. Every plan gives the same bits: a sum's order depends on the taps
//   and channels alone.
// - What binds it (NVIDIA H100 80GB HBM3, 700 W; PERF.md §6): the
//   epilogues (bias, ReLU, rounding, masks and shared stores), conv1's
//   gathers and the patch copies take about as long as the products, and
//   the barriers between the convs keep much of them from overlapping;
//   16 warps (128 registers) and two barriers a tile instead of four hide
//   more of it.
//
// "staged", stem_kernel (f32, and bf16 shapes the route refuses):
// - One block per (image, 8 x 8 tile of pooled output). It computes conv1
//   over the tile's 16 x 16 conv3 grid plus a 2-pixel halo (20 x 20, the
//   plain stride-2 conv read straight from the image through its strides,
//   cast to dt on load), conv2 over 18 x 18, conv3 over 16 x 16, and the
//   pool; every intermediate lives in shared memory ([C][rows][cols] in
//   dt; R50 f32 117 KB, bf16 63 KB) and only the pooled map is written.
// - The convs are block_gemm.cuh's products (128 pixels x 32 channels per
//   tile), depth 27, 9 * C1 and 9 * C2: WMMA tensor-core tiles in bf16,
//   scalar FMAs in f32. The halo adds 56% to conv1 and 27% to conv2, and
//   the per-element staging into shared memory bounds the kernel, as in
//   K5's staged body.

#include <stdint.h>

#include <algorithm>
#include <mutex>
#include <type_traits>

#include "block_gemm.cuh"
#include "mma_sm90.cuh"

namespace {

using cris::Gemm;
using cris::from_f32;
using cris::kGemmThreads;
using cris::to_f32;

// the H100's shared memory a block can use
constexpr size_t kMaxSmem = 232448;

constexpr int kTP = 128;    // pixels per product tile
constexpr int kTile = 8;    // pooled outputs per block edge
constexpr int kE3 = 2 * kTile;  // conv3 grid edge: 16
constexpr int kE2 = kE3 + 2;    // conv2 grid edge: 18
constexpr int kE1 = kE3 + 4;    // conv1 grid edge: 20

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
        return cris::round_to<T>(ib[ih * ish + iw * isw + ci * isc]);
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


// ------------------------------------------- the tensor-core body (bf16)

using bf16 = __nv_bfloat16;

constexpr int kStemThreads = 512;  // 16 warps, at most 128 registers each
constexpr int kStemWarps = kStemThreads / 32;
constexpr int kK1 = 32;            // conv1's depth 27, padded to two k16 steps
constexpr int kUnit = 32;          // conv1's and conv2's M unit: 2 m16 tiles
// the plan's candidates: Th in 2..kThMax (even), Tw in kTws
constexpr int kThMax = 32;
constexpr int kTws[4] = {16, 32, 48, 64};
// the plan's model, in conv3 mma steps a warp: one conv1 step (its A
// gathered from the patch by scalar loads) and one conv2 step cost about
// kConv1Step and kConv2Step of them (conv2's phase also carries the last
// tile's pooled stores), each tile kTileCost more and each patch row a
// warp copies kRowCost: a least-squares fit to the device time of every
// R50 tile that chip_smoke.py phase 9 times on the H100 (PERF.md §6; its
// costs and times correlate at 0.996)
constexpr double kConv1Step = 2.32;
constexpr double kConv2Step = 0.281;
constexpr double kTileCost = 63.5;
constexpr double kRowCost = 8.52;

// dynamic shared memory of the body for a Th x Tw tile: the three weights
// (rows padded by 8), a1, a2 and the f32 image patch; mirrored by
// ops/kernels/stem.py `_tc_smem_bytes`
inline size_t stem_tc_smem_bytes(int th, int tw, int c1, int c2, int c3) {
  const size_t w = ((size_t)kK1 * (c1 + 8) + (size_t)9 * c1 * (c2 + 8) +
                    (size_t)9 * c2 * (c3 + 8)) * 2;
  const size_t bias = (size_t)(c1 + c2 + c3) * 4;
  const size_t a1 = (size_t)(th + 4) * (tw + 4) * (c1 + 8) * 2;
  const size_t pooled = (size_t)c3 * (th / 2 * (tw / 2) + 8) * 2;
  const size_t a2 = (size_t)(th + 2) * (tw + 2) * (c2 + 8) * 2;
  const size_t patch = (size_t)3 * (2 * th + 9) * (2 * tw + 12) * 4;
  return w + bias + a1 + pooled + a2 + patch;
}

struct StemTcArgs {
  const float* img;
  const bf16 *k1, *k2, *k3;
  const float *b1, *b2, *b3;
  bf16* out;
  int H, W, C1, C2, C3;
  int th, tw, bands, ctiles, tiles;  // the plan's tile and tile counts
  long long isb, ish, isw, isc, osb, osh, osw, osc;
  // img takes 16-byte copies (unit column stride, the other strides and
  // the base 16-byte aligned); out takes 16-byte stores (the same)
  int img_vec, out_vec;
};

// rows x C of a contiguous (rows, C) bf16 weight into shared rows of ld
__device__ __forceinline__ void load_weight(bf16* dst, const bf16* src,
                                            int rows, int C, int ld) {
  const int chunks = C / 8;
  for (int idx = threadIdx.x; idx < rows * chunks; idx += kStemThreads) {
    const int row = idx / chunks, ch = idx - row * chunks;
    cp_async16(smem_u32(dst + row * ld + ch * 8), src + (size_t)row * C + ch * 8,
               true);
  }
}

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

// acc += a 3x3 conv's products over a flat pixel-major grid of width wflat
// and cin channels: arow[i] is this lane's ldmatrix row address (its output
// pixel's tap (0, 0) row, and its half of a k16 chunk) for m16 tile i, wl
// the weight rows' (k = tap * cin + ci) address of this lane and its N
// chunk. Tap (dy, dx) is the row offset dy wflat + dx for every lane.
template <int TM, int TN, int CIN>
__device__ __forceinline__ void conv3x3_mma(float (&acc)[TM][TN][4],
                                            const uint32_t (&arow)[TM],
                                            int lda, int wflat, int cin_rt,
                                            uint32_t wl, int ldw) {
  const int cin = CIN > 0 ? CIN : cin_rt;
#pragma unroll
  for (int tap = 0; tap < 9; ++tap) {
    const uint32_t off = ((tap / 3) * wflat + tap % 3) * lda * 2;
    uint32_t wk = wl + tap * cin * ldw * 2;
#pragma unroll
    for (int ci = 0; ci < cin; ci += 16, wk += 16 * ldw * 2) {
      uint32_t af[TM][4];
#pragma unroll
      for (int i = 0; i < TM; ++i) ldsm_x4(af[i], arow[i] + off + ci * 2);
#pragma unroll
      for (int jj = 0; jj < TN / 2; ++jj) {
        uint32_t bq[4];
        ldsm_x4_trans(bq, wk + jj * 32);
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          mma_bf16(acc[i][2 * jj], af[i], bq[0], bq[1]);
          mma_bf16(acc[i][2 * jj + 1], af[i], bq[2], bq[3]);
        }
      }
    }
  }
}

template <int TM, int TN>
__device__ __forceinline__ void zero_acc(float (&acc)[TM][TN][4]) {
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
}

// A tile's place and extent: image b, conv3 grid origin (u3, x3), the x
// twe outputs (the last band and column may be short); a1 is the flat
// (the + 4) x (twe + 4) grid from conv-grid (u3 - 2, x3 - 2), a2 the
// (the + 2) x (twe + 2) one from (u3 - 1, x3 - 1). q / W for q < 2^16 is
// (q + 0.5) (1 / W): at least 0.5 / W from an integer, far beyond the
// float product's error.
struct StemTile {
  int b, u3, x3, the, twe, W1, M1, Wg2, M2;
  float rW1, rWg2;
};

// The body. N1, N2, N3: the output channels of one warp's unit in conv1,
// conv2 and conv3; CI2, CI3: conv2's and conv3's input channels where
// they are known when compiled (their k steps then unroll), else 0.
template <int N1, int N2, int N3, int CI2, int CI3>
__global__ void __launch_bounds__(kStemThreads, 1)
    stem_tc_kernel(const StemTcArgs a) {
  extern __shared__ __align__(16) unsigned char stem_smem[];
  constexpr int TN1 = N1 / 8, TN2 = N2 / 8, TN3 = N3 / 8;
  const int C1 = a.C1, C2 = a.C2, C3 = a.C3;
  const int ld1 = C1 + 8, ld2 = C2 + 8, ld3 = C3 + 8;
  bf16* w1 = reinterpret_cast<bf16*>(stem_smem);  // [32][C1 + 8]
  bf16* w2 = w1 + kK1 * ld1;                       // [9 C1][C2 + 8]
  bf16* w3 = w2 + 9 * C1 * ld2;                    // [9 C2][C3 + 8]
  float* bias = reinterpret_cast<float*>(w3 + 9 * C2 * ld3);  // b1 b2 b3
  bf16* a1 = reinterpret_cast<bf16*>(bias + C1 + C2 + C3);
  // a1 [(Th + 4) (Tw + 4)][C1 + 8]; the pooled tile [C3][ps], ps = Th / 2
  // x Tw / 2 + 8 (16-byte rows); a2 [(Th + 2) (Tw + 2)][C2 + 8]
  const int pwid = a.tw / 2, ps = a.th / 2 * pwid + 8;
  bf16* pooled = a1 + (a.th + 4) * (a.tw + 4) * ld1;
  bf16* a2 = pooled + C3 * ps;
  // the patch [3][2 Th + 9][2 Tw + 12]: image columns from 2 (x3 - 2) - 4,
  // a multiple of 4 (x3 is a multiple of 16), so that 16-byte copies land
  // on 16-byte rows; conv1's first column is column 3 of a row
  float* patch = reinterpret_cast<float*>(a2 + (a.th + 2) * (a.tw + 2) * ld2);
  const int pr = 2 * a.th + 9, pc = 2 * a.tw + 12, prc = pr * pc;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, c = lane & 3;
  const int H2 = a.H / 2, W2 = a.W / 2;
  const int per_image = a.bands * a.ctiles;

  load_weight(w1, a.k1, 27, C1, ld1);
  load_weight(w2, a.k2, 9 * C1, C2, ld2);
  load_weight(w3, a.k3, 9 * C2, C3, ld3);
  for (int idx = threadIdx.x; idx < 5 * ld1; idx += kStemThreads)
    w1[27 * ld1 + idx] = __float2bfloat16(0.f);
  for (int idx = threadIdx.x; idx < C1 + C2 + C3; idx += kStemThreads)
    bias[idx] = idx < C1 ? a.b1[idx]
                         : idx < C1 + C2 ? a.b2[idx - C1] : a.b3[idx - C1 - C2];
  const float *b1s = bias, *b2s = bias + C1, *b3s = bias + C1 + C2;

  auto tile_at = [&](int t) {
    StemTile s;
    s.b = t / per_image;
    const int r = t - s.b * per_image, band = r / a.ctiles;
    s.u3 = band * a.th;
    s.x3 = (r - band * a.ctiles) * a.tw;
    s.the = min(a.th, H2 - s.u3);
    s.twe = min(a.tw, W2 - s.x3);
    s.W1 = s.twe + 4;
    s.M1 = (s.the + 4) * s.W1;
    s.Wg2 = s.twe + 2;
    s.M2 = (s.the + 2) * s.Wg2;
    s.rW1 = 1.f / s.W1;
    s.rWg2 = 1.f / s.Wg2;
    return s;
  };

  // the image patch of tile s: image rows 2 (u3 - 2) - 1 .. + 2 Th + 8
  // and columns 2 (x3 - 2) - 4 .. + 2 Tw + 7 of each channel, 0 outside
  // the image; one warp a channel row, its lanes on neighbouring 16-byte
  // chunks (W is a multiple of 4: a chunk is wholly inside or outside),
  // or on neighbouring columns where the image's strides refuse 16-byte
  // copies
  auto fetch_patch = [&](const StemTile& s) {
    const int ir0 = 2 * (s.u3 - 2) - 1, ic0 = 2 * (s.x3 - 2) - 4;
    const float* ib = a.img + s.b * a.isb;
    for (int cr = warp; cr < 3 * pr; cr += kStemWarps) {
      const int ci = cr / pr, row = cr - ci * pr, ih = ir0 + row;
      const bool row_in = ih >= 0 && ih < a.H;
      const float* src = ib + ci * a.isc + ih * a.ish;
      const uint32_t dst = smem_u32(patch + cr * pc);
      if (a.img_vec) {
        for (int ch = lane; ch < pc / 4; ch += 32) {
          const int iw = ic0 + 4 * ch;
          const bool in = row_in && iw >= 0 && iw < a.W;
          cp_async16(dst + ch * 16, in ? src + iw : a.img, in);
        }
      } else {
        for (int col = lane; col < pc; col += 32) {
          const int iw = ic0 + col;
          const bool in = row_in && iw >= 0 && iw < a.W;
          cp_async4(dst + col * 4, in ? src + iw * a.isw : a.img, in);
        }
      }
    }
    cp_async_commit();
  };

  // conv1's depth offsets in the patch for this lane's A fragment columns:
  // k = 16 s + 2 c + (e & 1) + 8 (e >> 1), k = (3 ky + kx) 3 + ci; the
  // padding k >= 27 reads the pixel itself (finite; its weight row is 0)
  int koff[2][4];
#pragma unroll
  for (int s = 0; s < 2; ++s)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int k = 16 * s + 2 * c + (e & 1) + 8 * (e >> 1);
      const int tap = k / 3, ci = k - 3 * tap, ky = tap / 3, kx = tap - 3 * ky;
      koff[s][e] = k < 27 ? ci * prc + ky * pc + kx : 0;
    }

  // conv1's units: M units of 32 flat a1 positions x N1 channels
  auto conv1_units = [&](const StemTile& s) {
    return (s.M1 + kUnit - 1) / kUnit * (C1 / N1);
  };
  // conv1 unit u of tile s: a1 = dt(relu(b1 + patch x k1)) inside the
  // image, 0 outside
  auto conv1_unit = [&](const StemTile& s, int u) {
    const int chunks = C1 / N1;
    const int mu = u / chunks, n0 = (u - mu * chunks) * N1;
    int pbase[2][2], mrow[2][2];
    bool keep[2][2];
#pragma unroll
    for (int tm = 0; tm < 2; ++tm)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = mu * kUnit + 16 * tm + g + 8 * h;
        const int i = __float2int_rz((m + 0.5f) * s.rW1), j = m - i * s.W1;
        const int uu = s.u3 - 2 + i, vv = s.x3 - 2 + j;
        mrow[tm][h] = m;
        pbase[tm][h] = m < s.M1 ? 2 * i * pc + 2 * j + 3 : 0;
        keep[tm][h] = uu >= 0 && uu < H2 && vv >= 0 && vv < W2;
      }
    float acc[2][TN1][4];
    zero_acc(acc);
    const uint32_t wl =
        smem_u32(w1) + ((lane & 15) * ld1 + n0 + (lane >> 4) * 8) * 2;
#pragma unroll
    for (int ks = 0; ks < 2; ++ks) {
      uint32_t af[2][4];
#pragma unroll
      for (int tm = 0; tm < 2; ++tm) {
        const float* p0 = patch + pbase[tm][0];
        const float* p1 = patch + pbase[tm][1];
        af[tm][0] = pack_bf16(p0[koff[ks][0]], p0[koff[ks][1]]);
        af[tm][1] = pack_bf16(p1[koff[ks][0]], p1[koff[ks][1]]);
        af[tm][2] = pack_bf16(p0[koff[ks][2]], p0[koff[ks][3]]);
        af[tm][3] = pack_bf16(p1[koff[ks][2]], p1[koff[ks][3]]);
      }
#pragma unroll
      for (int jj = 0; jj < TN1 / 2; ++jj) {
        uint32_t bq[4];
        ldsm_x4_trans(bq, wl + (16 * ks * ld1 + jj * 16) * 2);
#pragma unroll
        for (int tm = 0; tm < 2; ++tm) {
          mma_bf16(acc[tm][2 * jj], af[tm], bq[0], bq[1]);
          mma_bf16(acc[tm][2 * jj + 1], af[tm], bq[2], bq[3]);
        }
      }
    }
#pragma unroll
    for (int tm = 0; tm < 2; ++tm)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = mrow[tm][h];
        if (m >= s.M1) continue;
#pragma unroll
        for (int nt = 0; nt < TN1; ++nt) {
          const int n = n0 + 8 * nt + 2 * c;
          const float v0 = fmaxf(acc[tm][nt][2 * h] + b1s[n], 0.f);
          const float v1 = fmaxf(acc[tm][nt][2 * h + 1] + b1s[n + 1], 0.f);
          *reinterpret_cast<uint32_t*>(a1 + m * ld1 + n) =
              keep[tm][h] ? pack_bf16(v0, v1) : 0u;
        }
      }
  };

  // conv2 of tile s: a2 = dt(relu(b2 + conv3x3(a1))) inside the image, 0
  // outside, over the flat index q of (the + 2) rows of twe + 2. Units of
  // 32 rows fill whole rounds of the warps; the rest are split into units
  // of 16 rows, so that the last round is shared by every warp.
  auto conv2 = [&](const StemTile& s) {
    const int chunks = C2 / N2, units = (s.M2 + kUnit - 1) / kUnit * chunks;
    const int whole = units / kStemWarps * kStemWarps;
    const uint32_t a1l = smem_u32(a1) + (lane >> 4) * 16;
    const uint32_t wl =
        smem_u32(w2) + ((lane & 15) * ld2 + (lane >> 4) * 8) * 2;
    auto unit = [&](auto tm_count, int m0, int n0) {
      constexpr int TM = decltype(tm_count)::value;
      uint32_t arow[TM];
#pragma unroll
      for (int tm = 0; tm < TM; ++tm) {
        const int q = m0 + 16 * tm + (lane & 15);
        const int i = __float2int_rz((q + 0.5f) * s.rWg2), j = q - i * s.Wg2;
        arow[tm] = a1l + (q < s.M2 ? i * s.W1 + j : 0) * ld1 * 2;
      }
      float acc[TM][TN2][4];
      zero_acc(acc);
      conv3x3_mma<TM, TN2, CI2>(acc, arow, ld1, s.W1, C1, wl + n0 * 2, ld2);
#pragma unroll
      for (int tm = 0; tm < TM; ++tm)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int q = m0 + 16 * tm + g + 8 * h;
          if (q >= s.M2) continue;
          const int i = __float2int_rz((q + 0.5f) * s.rWg2), j = q - i * s.Wg2;
          const int uu = s.u3 - 1 + i, vv = s.x3 - 1 + j;
          const bool keep = uu >= 0 && uu < H2 && vv >= 0 && vv < W2;
#pragma unroll
          for (int nt = 0; nt < TN2; ++nt) {
            const int n = n0 + 8 * nt + 2 * c;
            const float v0 = fmaxf(acc[tm][nt][2 * h] + b2s[n], 0.f);
            const float v1 = fmaxf(acc[tm][nt][2 * h + 1] + b2s[n + 1], 0.f);
            *reinterpret_cast<uint32_t*>(a2 + q * ld2 + n) =
                keep ? pack_bf16(v0, v1) : 0u;
          }
        }
    };
    for (int u = warp; u < whole; u += kStemWarps) {
      const int mu = u / chunks;
      unit(std::integral_constant<int, 2>(), mu * kUnit,
           (u - mu * chunks) * N2);
    }
    for (int v = warp; v < 2 * (units - whole); v += kStemWarps) {
      const int u = whole + v / 2, mu = u / chunks;
      unit(std::integral_constant<int, 1>(), mu * kUnit + 16 * (v & 1),
           (u - mu * chunks) * N2);
    }
  };

  // conv3's units: rows 2 p and 2 p + 1, columns 16 jc .. + 15 of the
  // tile (lanes past its width read its last column), N3 channels
  auto conv3_units = [&](const StemTile& s) {
    return s.the / 2 * ((s.twe + 15) / 16) * (C3 / N3);
  };
  // conv3 unit u of tile s and its share of the pool: a3 = dt(relu(acc +
  // b3)) on both rows; the row pair's f32 sum x 0.25 to dt; the column
  // pair (lanes g and g ^ 1) added in f32 and rounded into the pooled
  // tile: the even lane writes channel n, the odd one n + 1
  auto conv3_unit = [&](const StemTile& s, int u) {
    const int chunks = C3 / N3, per_pair = (s.twe + 15) / 16 * chunks;
    const int p = u / per_pair, rem = u - p * per_pair;
    const int jc = rem / chunks, n0 = (rem - jc * chunks) * N3;
    const int jrow = min(16 * jc + (lane & 15), s.twe - 1);
    const uint32_t a2l = smem_u32(a2) + (lane >> 4) * 16;
    const uint32_t wl =
        smem_u32(w3) + ((lane & 15) * ld3 + n0 + (lane >> 4) * 8) * 2;
    uint32_t arow[2];
#pragma unroll
    for (int tm = 0; tm < 2; ++tm)
      arow[tm] = a2l + ((2 * p + tm) * s.Wg2 + jrow) * ld2 * 2;
    float acc[2][TN3][4];
    zero_acc(acc);
    conv3x3_mma<2, TN3, CI3>(acc, arow, ld2, s.Wg2, C2, wl, ld3);
    const int odd = g & 1;
    bf16* prow = pooled + p * pwid;
#pragma unroll
    for (int nt = 0; nt < TN3; ++nt) {
      const int n = n0 + 8 * nt + 2 * c;
      const float bb0 = b3s[n], bb1 = b3s[n + 1];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float r0 = round_bf16(
            (round_bf16(fmaxf(acc[0][nt][2 * h] + bb0, 0.f)) +
             round_bf16(fmaxf(acc[1][nt][2 * h] + bb0, 0.f))) * 0.25f);
        const float r1 = round_bf16(
            (round_bf16(fmaxf(acc[0][nt][2 * h + 1] + bb1, 0.f)) +
             round_bf16(fmaxf(acc[1][nt][2 * h + 1] + bb1, 0.f))) * 0.25f);
        const float o0 = __shfl_xor_sync(0xffffffffu, r0, 4);
        const float o1 = __shfl_xor_sync(0xffffffffu, r1, 4);
        const int jl = 16 * jc + (g & ~1) + 8 * h;  // the pair's left column
        if (jl < s.twe)
          prow[(n + odd) * ps + jl / 2] =
              __float2bfloat16(odd ? o1 + r1 : r0 + o0);
      }
    }
  };

  // the pooled tile of s to the output, 16 bytes a store where the
  // output's strides allow it and the tile's width is a multiple of 8,
  // else one value a store; neighbouring threads on neighbouring columns
  auto store_pooled = [&](const StemTile& s) {
    const int ph = s.the / 2, pw = s.twe / 2;
    bf16* ob = a.out + s.b * a.osb + (long long)(s.u3 / 2) * a.osh +
               (long long)(s.x3 / 2) * a.osw;
    if (a.out_vec && pw % 8 == 0) {
      const int cw = pw / 8, per_ch = ph * cw;
      for (int idx = threadIdx.x; idx < C3 * per_ch; idx += kStemThreads) {
        const int n = idx / per_ch, rem = idx - n * per_ch;
        const int p = rem / cw, k = rem - p * cw;
        *reinterpret_cast<uint4*>(ob + n * a.osc + p * a.osh + 8 * k) =
            *reinterpret_cast<const uint4*>(pooled + n * ps + p * pwid + 8 * k);
      }
    } else {
      const int per_ch = ph * pw;
      for (int idx = threadIdx.x; idx < C3 * per_ch; idx += kStemThreads) {
        const int n = idx / per_ch, rem = idx - n * per_ch;
        const int p = rem / pw, k = rem - p * pw;
        ob[n * a.osc + p * a.osh + k * a.osw] = pooled[n * ps + p * pwid + k];
      }
    }
  };

  // Two barriers a tile. Tile t's conv3 shares a phase with the next
  // tile's conv1 (a1 is free once conv2 has read it, and the next patch
  // landed during conv2), and tile t's pooled tile goes out while the next
  // tile's conv2 runs: in each phase the warps of an SM mix products with
  // gathers, masks and stores.
  int t = blockIdx.x;
  StemTile cur = tile_at(t);
  fetch_patch(cur);
  cp_async_wait_all();
  __syncthreads();  // the weights and the first patch landed
  for (int u = warp; u < conv1_units(cur); u += kStemWarps) conv1_unit(cur, u);
  __syncthreads();  // a1 complete; the patch is free
  for (bool first = true;; first = false) {
    const int tn = t + gridDim.x;
    const bool more = tn < a.tiles;
    const StemTile nxt = more ? tile_at(tn) : cur;
    if (more) fetch_patch(nxt);
    if (!first) store_pooled(tile_at(t - gridDim.x));
    conv2(cur);
    cp_async_wait_all();
    __syncthreads();  // a2 complete; the next patch landed; the pooled
                      // tile stored
    // conv3 of this tile and conv1 of the next, interleaved in blocks of
    // four positions so that each SM sub-partition's warps mix the two
    const int n3 = conv3_units(cur), n1 = more ? conv1_units(nxt) : 0;
    const int m4 = min(n3, n1) / 4 * 4;
    for (int pos = warp; pos < n3 + n1; pos += kStemWarps) {
      if (pos < 2 * m4) {
        const int blk = pos >> 2, u = (blk >> 1) * 4 + (pos & 3);
        if (blk & 1)
          conv1_unit(nxt, u);
        else
          conv3_unit(cur, u);
      } else if (pos - 2 * m4 < n3 - m4) {
        conv3_unit(cur, m4 + pos - 2 * m4);
      } else {
        conv1_unit(nxt, m4 + pos - 2 * m4 - (n3 - m4));
      }
    }
    __syncthreads();  // the pooled tile complete; the next a1 complete
    if (!more) break;
    t = tn;
    cur = nxt;
  }
  store_pooled(cur);
}


// The body's plan for a shape: the tile, its counts, the shared memory and
// the model's makespan (warp mma steps of the busiest block).
struct StemPlan {
  int th, tw, bands, ctiles, tiles, blocks;
  size_t smem;
  double cost;
};

// conv1's, conv2's and conv3's unit width for the channel widths: 32
// where conv2's and conv3's input widths are R50's 32 (their k steps
// compiled unrolled), else 16
inline int unit_width(int C1, int C2, int C3) {
  return C1 == 32 && C2 == 32 && C3 % 32 == 0 ? 32 : 16;
}

// one tile of the x twe conv3 outputs (the plan's tile th x tw) in the
// model's unit: conv2's units in whole rounds of the warps (its last round
// in half units), conv3's and the next tile's conv1's, which share a
// phase, spread over the warps, and the patch rows a warp copies,
// 3 (2 th + 9) / 16
double stem_tile_cost(int the, int twe, int th, int C1, int C2, int C3) {
  const int N = unit_width(C1, C2, C3);
  const long long u1 = ((the + 4LL) * (twe + 4) + kUnit - 1) / kUnit * (C1 / N);
  const long long u2 = ((the + 2LL) * (twe + 2) + kUnit - 1) / kUnit * (C2 / N);
  const long long u3 = (the / 2LL) * ((twe + 15) / 16) * (C3 / N);
  // mma steps of a unit: 2 m16 tiles x N / 8 n8 tiles x the k16 steps
  const double s1 = 2.0 * (N / 8) * 2, s2 = 2.0 * (N / 8) * (9 * C1 / 16),
               s3 = 2.0 * (N / 8) * (9 * C2 / 16);
  const double rounds2 = (double)(u2 / kStemWarps) +
                         0.5 * ((2 * (u2 % kStemWarps) + kStemWarps - 1) / kStemWarps);
  return kConv1Step * u1 * s1 / kStemWarps + kConv2Step * rounds2 * s2 +
         u3 * s3 / kStemWarps + kTileCost +
         kRowCost * 3.0 * (2 * th + 9) / kStemWarps;
}

// the candidate (th, tw) for a shape: false where it does not fit
bool stem_tc_candidate(int B, int H, int W, int C1, int C2, int C3, int sms,
                       int th, int tw, StemPlan* out) {
  const size_t smem = stem_tc_smem_bytes(th, tw, C1, C2, C3);
  if (th < 2 || th % 2 || tw < 16 || tw % 16 || smem > kMaxSmem) return false;
  const int H2 = H / 2, W2 = W / 2;
  const int bands = (H2 + th - 1) / th, ctiles = (W2 + tw - 1) / tw;
  const long long per = (long long)bands * ctiles, tiles = B * per;
  if (tiles > 0x7fffffff) return false;
  const int blocks = (int)std::min<long long>(tiles, sms);
  // the makespan of the round-robin walk: tile t goes to block t % blocks;
  // tiles in the last band or column may be short
  double cost[2][2];
  for (int lb = 0; lb < 2; ++lb)
    for (int lc = 0; lc < 2; ++lc)
      cost[lb][lc] = stem_tile_cost(lb ? H2 - (bands - 1) * th : th,
                                    lc ? W2 - (ctiles - 1) * tw : tw, th, C1,
                                    C2, C3);
  double worst = 0.0;
  for (int blk = 0; blk < blocks; ++blk) {
    double sum = 0.0;
    for (long long t = blk; t < tiles; t += blocks) {
      const long long r = t % per;
      const int band = (int)(r / ctiles), ct = (int)(r - (long long)band * ctiles);
      sum += cost[band == bands - 1][ct == ctiles - 1];
    }
    worst = std::max(worst, sum);
  }
  *out = StemPlan{th, tw, bands, ctiles, (int)tiles, blocks, smem, worst};
  return true;
}

// the least makespan over the candidates (ties to the earlier), or the
// requested tile where th > 0; false if none fits. Plans are cached by
// shape: the makespan walks every tile.
bool stem_tc_plan(int B, int H, int W, int C1, int C2, int C3, int sms,
                  int th_req, int tw_req, StemPlan* out) {
  if (th_req > 0)
    return stem_tc_candidate(B, H, W, C1, C2, C3, sms, th_req, tw_req, out);
  static std::mutex lock;
  static long long keys[8][7];
  static StemPlan plans[8];
  static int cached = 0, next = 0;
  const long long key[7] = {B, H, W, C1, C2, C3, sms};
  std::lock_guard<std::mutex> guard(lock);
  for (int i = 0; i < cached; ++i)
    if (std::equal(key, key + 7, keys[i])) {
      *out = plans[i];
      return true;
    }
  bool found = false;
  for (int tw : kTws)
    for (int th = 2; th <= kThMax; th += 2) {
      StemPlan p;
      if (!stem_tc_candidate(B, H, W, C1, C2, C3, sms, th, tw, &p)) continue;
      if (!found || p.cost < out->cost * 0.9999) *out = p;
      found = true;
    }
  if (!found) return false;
  std::copy(key, key + 7, keys[next]);
  plans[next] = *out;
  next = (next + 1) % 8;
  cached = std::min(cached + 1, 8);
  return true;
}

int sm_count() {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess)
    return 0;
  return sms;
}

template <int N1, int N2, int N3, int CI2, int CI3>
cudaError_t launch_tc_widths(const StemTcArgs& a, const StemPlan& p,
                             cudaStream_t stream) {
  auto kern = stem_tc_kernel<N1, N2, N3, CI2, CI3>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)p.smem);
  if (err != cudaSuccess) return err;
  kern<<<p.blocks, kStemThreads, p.smem, stream>>>(a);
  return cudaGetLastError();
}

cudaError_t launch_tc(StemTcArgs a, int B, int th, int tw,
                      cudaStream_t stream) {
  if (a.C1 % 16 || a.C2 % 16 || a.C3 % 16) return cudaErrorInvalidValue;
  const uintptr_t wbits = reinterpret_cast<uintptr_t>(a.k1) |
                          reinterpret_cast<uintptr_t>(a.k2) |
                          reinterpret_cast<uintptr_t>(a.k3);
  if (wbits % 16) return cudaErrorInvalidValue;
  const int sms = sm_count();
  StemPlan p;
  if (sms < 1 ||
      !stem_tc_plan(B, a.H, a.W, a.C1, a.C2, a.C3, sms, th, tw, &p))
    return cudaErrorInvalidValue;
  a.th = p.th;
  a.tw = p.tw;
  a.bands = p.bands;
  a.ctiles = p.ctiles;
  a.tiles = p.tiles;
  const uintptr_t ib = reinterpret_cast<uintptr_t>(a.img);
  const uintptr_t ob = reinterpret_cast<uintptr_t>(a.out);
  a.img_vec = a.isw == 1 && (a.isb | a.ish | a.isc) % 4 == 0 && ib % 16 == 0;
  a.out_vec = a.osw == 1 && (a.osb | a.osh | a.osc) % 8 == 0 && ob % 16 == 0;
  if (unit_width(a.C1, a.C2, a.C3) == 32)
    return launch_tc_widths<32, 32, 32, 32, 32>(a, p, stream);
  return launch_tc_widths<16, 16, 16, 0, 0>(a, p, stream);
}

}  // namespace

// Plain C entry points, bound with ctypes. Pointers are device pointers;
// img is f32 (B, H, W, 3) and out (B, H/4, W/4, C3), both addressed through
// the given strides (in elements); k1 (3, 3, 3, C1), k2 (3, 3, C1, C2),
// k3 (3, 3, C2, C3) contiguous HWIO in the dtype; biases f32. H and W are
// multiples of 4. dtype: 0 = float32, 1 = bfloat16; body: 0 = the staged
// body, 1 = the tensor-core body (bf16 only, widths multiples of 16,
// 16-byte aligned weights) on the plan's tile, or on th x tw where th > 0.
// Returns the cudaError_t of the launch.
extern "C" int cris_stem_pool(const void* img, const void* k1, const void* b1,
                              const void* k2, const void* b2, const void* k3,
                              const void* b3, void* out, int B, int H, int W,
                              int C1, int C2, int C3, int dtype, int body,
                              int th, int tw, long long isb, long long ish,
                              long long isw, long long isc, long long osb,
                              long long osh, long long osw, long long osc,
                              void* stream) {
  if (B < 1 || H < 4 || W < 4 || H % 4 || W % 4 || C1 < 1 || C2 < 1 ||
      C3 < 1)
    return (int)cudaErrorInvalidValue;
  const long long is[4] = {isb, ish, isw, isc};
  const long long os[4] = {osb, osh, osw, osc};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (body == 1) {
    if (dtype != 1) return (int)cudaErrorInvalidValue;
    const StemTcArgs a{
        static_cast<const float*>(img), static_cast<const bf16*>(k1),
        static_cast<const bf16*>(k2),   static_cast<const bf16*>(k3),
        static_cast<const float*>(b1),  static_cast<const float*>(b2),
        static_cast<const float*>(b3),  static_cast<bf16*>(out),
        H, W, C1, C2, C3, 0, 0, 0, 0, 0,
        isb, ish, isw, isc, osb, osh, osw, osc, 0, 0};
    return (int)launch_tc(a, B, th, tw, st);
  }
  if (body != 0 || B > 65535) return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return (int)launch<float>(img, k1, b1, k2, b2, k3, b3, out, B, H, W, C1,
                              C2, C3, is, os, st);
  if (dtype == 1)
    return (int)launch<__nv_bfloat16>(img, k1, b1, k2, b2, k3, b3, out, B, H,
                                      W, C1, C2, C3, is, os, st);
  return (int)cudaErrorInvalidValue;
}

// The tensor-core body's plan for a shape on the current device, for
// reports: th x tw as requested where th > 0, else the plan's choice.
// plan[0..6] = Th, Tw, bands, column tiles, tiles, blocks, shared memory
// bytes; *cost = the model's makespan in warp mma steps. Returns 0, or 1
// if no tile fits.
extern "C" int cris_stem_plan(int B, int H, int W, int C1, int C2, int C3,
                              int th, int tw, long long* plan, double* cost) {
  StemPlan p;
  const int sms = sm_count();
  if (sms < 1 || !stem_tc_plan(B, H, W, C1, C2, C3, sms, th, tw, &p)) return 1;
  const long long v[7] = {p.th, p.tw, p.bands, p.ctiles, p.tiles, p.blocks,
                          (long long)p.smem};
  std::copy(v, v + 7, plan);
  *cost = p.cost;
  return 0;
}
