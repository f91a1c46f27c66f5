// K5: the BN-folded stride-1 ResNet bottleneck, one kernel per block.
//
// Replaces the TPU kernel `fused_bottleneck` (cris_tpu/ops/pallas/
// bottleneck.py:181, body `_kernel` at :55). Same function and rounding:
//   y1 = dt(relu(b1 + x w1))                 1x1, C -> mid
//   y2 = dt(relu(b2 + conv3x3(y1)))          zero padding on y1, mid -> mid
//   y  = dt(relu(b3 + y2 w3 + f32(x)))       1x1, mid -> C, residual in f32
// with f32 sums and f32 biases; dt is the input's dtype (f32 or bf16).
// Every R50 tail block is 1.5 GFLOP per image and moves at most 11 MB per
// image in bf16, so its bound on the H100 is 24-53 us per B 16 launch
// (memory at 104^2 and 52^2, operations at 26^2 and 13^2).
//
// Two bodies, picked by the wrapper's `bottleneck_route`:
//
// "tensor_cores", bottleneck_tc_kernel (bf16, C and mid multiples of 64,
// 16-byte aligned contiguous weights, a band that fits shared memory):
// - One block of 8 warps per (image, band of R output rows). y1 and y2
//   live in shared memory in bf16, pixel-major with the channels
//   contiguous ([pixel][mid + 8], rows padded by 16 bytes so that
//   ldmatrix's 8 row addresses fall in distinct banks). Device memory sees
//   x (the halo rows and the residual re-read mostly from L2), the
//   weights and y once.
// - y1 lies on the band's flat padded grid: (R + 2) rows (the band and a
//   halo row above and below) of W + 2 columns, column 0 and W + 1 the
//   3x3's zero padding. conv1 runs over that whole grid and writes 0 for
//   every position outside the image (and for the tail past the grid), so
//   the padding is zero on conv1's OUTPUT, not relu(b1): the JAX kernel's
//   `top` / `bot` / `valid` masking.
// - conv2 runs over the flat index q of R rows of W + 2 (the last two
//   columns of each row junk, never stored), so every M tile is a
//   contiguous run, and the 3x3 is nine row offsets: tap (dy, dx) reads
//   y1 row q + dy (W + 2) + dx (+ 1 where y1 is shifted by a row for
//   pixel pairs, below), an offset in each lane's ldmatrix address.
// - Products on mma.sync.m16n8k16 (bf16 -> f32, mma_sm90.cuh's helpers):
//   M is pixels, N output channels, K input channels (x 9 taps for conv2),
//   in BM x 64 block tiles, k64 steps, with conv1's BM1 and conv2's and
//   conv3's BM23 each 32 (2 x 4 warps of 16 x 16), 64 (4 x 2 of 16 x 32)
//   or 128 (4 x 2 of 32 x 32). The weights stream in k64 x 64 tiles
//   through a 4-stage cp.async ring (B fragments by ldmatrix.trans); A
//   comes from y1 / y2 by ldmatrix. Every loop cursor advances by
//   increments: an integer division in the step loop costs more issue
//   slots than the step's products.
// - conv1's A is x staged as [channel][BM1 + 8] (ldmatrix.trans). x is an
//   NHWC view of NCHW memory whose plane stride (338 bytes at 13^2) no
//   16-byte copy can address, so plain loads along pixels (a warp's
//   lanes on neighbouring pixels of one channel) fetch the next chunk
//   into registers while this one computes. Where W and the strides are
//   even (R50's 104^2 to 26^2), a thread loads a pixel pair as one 4-byte
//   word: y1 row m then holds grid position m - 1, so that the rows from
//   an even m are an even image column and its neighbour. conv1 keeps up
//   to 64 accumulators a thread (2 to 8 N tiles), so one x chunk serves
//   that many N tiles.
// - conv3 loads the tile's residual x into registers before its k steps,
//   stages (acc + b3) in f32 through shared memory, then adds f32(x) and
//   stores along pixels (pairs where x takes them), by the strides: the
//   same arithmetic for either layout.
// - Band and tiles (`tc_plan`): every block reads all the weights once per
//   M tile from L2, and x once per group of conv1's N tiles. The plan
//   takes the (BM1, BM23, R) whose larger of tensor time (at the tile's
//   ldmatrix-bound share of the peak: 1/4, 1/3, 1/2) and L2 time (at
//   kL2BytesPerS), times the wave quantization of one block an SM, is
//   least. R50 at B 16 (NVIDIA H100 80GB HBM3, 700 W, chip_smoke.py
//   phase 9; every plan timed and bit-equal to the chosen one): layer1
//   128/128 R 2 and layer2 128/128 R 2, the best measured; layer3 64/64 R
//   4, within 0.3% of the best; layer4 64/32 R 2, the best. The time is
//   what the tensor and L2 terms leave out: one block of 8 warps an SM
//   overlaps little of x's loads, the products and conv3's stores, and
//   mma.sync from shared memory reaches a fraction of the tensor peak.
//   At layer4 the L2 weight traffic binds (112 blocks x 8.9 MB; about
//   0.27 ms at the measured L2 rate): clusters with TMA multicast of the
//   weight tiles would divide it; wgmma does not fit the one-pixel tap
//   shifts without a copy per tap.
//
// "staged", bottleneck_kernel (f32, and bf16 shapes the route refuses):
// - One block per (image, band of R output rows), R 4, 2 or 1: the band
//   whose blocks keep the most of the card busy per unit of work, counting
//   the blocks that fit an SM's shared memory and conv1's halo rows.
// - conv1 runs over the band's rows and one halo row above and below,
//   those inside the image, into y1 (shared, [mid][R+2][W+2], compute
//   dtype), zeroed first; conv2 (3x3) is a product of depth 9 * mid over
//   shifted reads of y1, into y2 (shared, [mid][R*W]); conv3 reads y2,
//   adds b3 and the residual and stores. x and the output are addressed
//   through (batch, row, column, channel) strides.
// - The three products are block_gemm.cuh's: WMMA tiles for bf16, scalar
//   FMAs for f32 (f32 accumulation of f32 products has no tensor-core
//   form but TF32, which rounds the inputs). Each element of A and B is
//   fetched one at a time through an index functor into shared memory
//   before the product sees it; that staging bounds it.

#include <stdint.h>

#include <algorithm>
#include <cmath>

#include "block_gemm.cuh"
#include "mma_sm90.cuh"

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

// ------------------------------------------- the tensor-core body (bf16)

using bf16 = __nv_bfloat16;

constexpr int kTcBodyThreads = 256;  // 8 warps
constexpr int kBK = 64;              // depth of a k step
constexpr int kBN = 64;              // output channels of a block tile
constexpr int kWLd = kBN + 8;        // a weight tile row, padded
constexpr int kWTile = kBK * kWLd;   // elements of one weight tile
constexpr int kStages = 4;           // weight tiles in the ring
constexpr int kSLd = kBN + 1;        // conv3's f32 staging row
// L2 rate the plan assumes: a copy that stays in L2 on the H100 SXM
// (chip_smoke.py phase 9 measures it)
constexpr double kL2BytesPerS = 3.6e12;
constexpr double kSmHz = 1.755e9;  // the H100 SXM's SM clock under load

// A warp grid of WM x (8 / WM) warps, each TM m16 tiles x TN n8 tiles:
// block tiles of BM = WM TM 16 pixels x 64 channels. conv1 keeps up to
// kNTMax such tiles' accumulators (64 floats a thread), so that one x
// chunk serves that many N tiles.
template <int WM, int TM, int TN>
struct TcCfg {
  static constexpr int kWM = WM, kTM = TM, kTN = TN, kWN = 8 / WM;
  static constexpr int kBM = WM * TM * 16;
  static constexpr int kNTMax = 64 / (TM * TN * 4);
  static_assert(kWN * TN * 8 == kBN && TN % 2 == 0, "a 64-column tile");
};
using TcCfg32 = TcCfg<2, 1, 2>;   // 2 x 4 warps of 16 x 16
using TcCfg64 = TcCfg<4, 1, 4>;   // 4 x 2 warps of 16 x 32
using TcCfg128 = TcCfg<4, 2, 4>;  // 4 x 2 warps of 32 x 32

// the rows of y1 (M1) and of y2 (M2, conv2's and conv3's M tile BM23)
// for a band of R rows of width W: y1 row m holds padded-grid position
// m - shift (shift 1 with pixel pairs, so that the rows from an even m
// are a pair of pixels from an even image column; else 0), and conv2's
// tap (2, 2) from y2's last row reads y1 row M2 - 1 + 2 (W + 2) + 2 +
// shift; M1 is rounded to the mma tile, 16, and conv1's last M tile may
// run past it; mirrored by ops/kernels/bottleneck.py `_tc_rows`
__host__ __device__ inline void tc_rows(int R, int W, int BM23, int shift,
                                        int* M1, int* M2) {
  const int Wp = W + 2;
  *M2 = (R * Wp + BM23 - 1) / BM23 * BM23;
  *M1 = (*M2 + 2 * Wp + 2 + shift + 15) / 16 * 16;
}

// padded-grid position p of a band (p = i (W + 2) + j, i = -1 before the
// grid): inside the image iff image row r0 - 1 + i and column j - 1 are
__device__ __forceinline__ bool grid_in_image(int p, int Wp, int R, int r0,
                                              int H, int W, int* r, int* c) {
  const int i = p < 0 ? -1 : p / Wp, j = p - i * Wp;
  *r = r0 - 1 + i;
  *c = j - 1;
  return i >= 0 && i < R + 2 && *r >= 0 && *r < H && *c >= 0 && *c < W;
}

// dynamic shared memory of the body; mirrored by `_tc_smem_bytes`
inline size_t tc_smem_bytes(int R, int W, int mid, int BM1, int BM23,
                            int shift) {
  int M1, M2;
  tc_rows(R, W, BM23, shift, &M1, &M2);
  const size_t xring = 2 * (size_t)kBK * (BM1 + 8) * 2;
  const size_t stage = (size_t)BM23 * kSLd * 4;
  return (size_t)(M1 + M2) * (mid + 8) * 2 + kStages * (size_t)kWTile * 2 +
         std::max(xring, stage);
}

// wait until at most N of this thread's cp.async groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

struct TcArgs {
  const bf16 *x, *w1, *w2, *w3;
  const float *b1, *b2, *b3;
  bf16* out;
  int H, W, C, mid, R, M1, M2;
  long long xsb, xsh, xsw, xsc, osb, osh, osw, osc;
  // x and out take 4-byte loads and stores of pixel pairs: unit pixel
  // stride, even W and even other strides, 4-byte aligned bases; y1 row
  // m then holds padded-grid position m - 1, else m
  int pairs;
};

// weight tile (k step kc, N tile nb) of a (K, N) weight into a ring slot:
// 64 rows of 128 bytes, two 16-byte copies a thread
__device__ __forceinline__ void load_w_tile(bf16* slot, const bf16* w, int N,
                                            int kc, int nb) {
  const bf16* src = w + (size_t)kc * kBK * N + nb * kBN;
  const uint32_t dst = smem_u32(slot);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int c = threadIdx.x + i * kTcBodyThreads, row = c >> 3, ch = c & 7;
    cp_async16(dst + (row * kWLd + ch * 8) * 2, src + (size_t)row * N + ch * 8,
               true);
  }
}

// acc += A B over one k step: A's fragments from load_a(af, kk), B's from
// the weight tile at wt (ldmatrix.trans), this warp's TN n8 tiles
template <int TM, int TN, class LoadA>
__device__ __forceinline__ void mma_k64(float (&acc)[TM][TN][4],
                                        const LoadA& load_a, uint32_t wt,
                                        int lane, int wn) {
#pragma unroll
  for (int kk = 0; kk < kBK / 16; ++kk) {
    uint32_t af[TM][4];
    load_a(af, kk);
#pragma unroll
    for (int jj = 0; jj < TN / 2; ++jj) {
      uint32_t b[4];
      ldsm_b_cols<kBN>(b, wt, lane, kk, wn * TN / 2 + jj);
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        mma_bf16(acc[i][2 * jj], af[i], b[0], b[1]);
        mma_bf16(acc[i][2 * jj + 1], af[i], b[2], b[3]);
      }
    }
  }
}

template <int TM, int TN>
__device__ __forceinline__ void zero(float (&acc)[TM][TN][4]) {
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
}

// conv1, x -> y1 over the band's padded grid (M1 rows). The steps nest M
// tile, N group, k step, then the group's N tiles (ntg <= kNTMax, their
// accumulators all in registers), so one x chunk (BM pixels x 64
// channels) serves ntg steps: its plain loads for the next chunk are
// issued at this chunk's first step and stored to shared memory after
// its last. The weights stream through the kStages ring, issued
// kStages - 1 steps ahead; every cursor advances by increments, with no
// division in the loop.
template <class G>
__device__ __forceinline__ void tc_conv1(const TcArgs& a, int r0, bf16* y1,
                                         bf16* ws, unsigned char* scratch) {
  constexpr int BM = G::kBM, TM = G::kTM, TN = G::kTN, NTM = G::kNTMax;
  constexpr int kXLd = BM + 8;                 // x chunk row: BM pixels
  constexpr int kXStep = kTcBodyThreads / BM;  // channels per pass
  constexpr int kXLoads = kBK / kXStep;        // x loads per thread
  const int nt = a.mid / kBN, kt = a.C / kBK, mt = (a.M1 + BM - 1) / BM;
  int ntg = NTM < nt ? NTM : nt;
  while (nt % ntg) --ntg;
  const int ngs = nt / ntg;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wm = warp % G::kWM, wn = warp / G::kWM;
  const int Wp = a.W + 2, ldy = a.mid + 8;
  const int g = lane >> 2, c2 = 2 * (lane & 3);
  const unsigned short* xb =
      reinterpret_cast<const unsigned short*>(a.x + blockIdx.y * a.xsb);
  bf16* xs = reinterpret_cast<bf16*>(scratch);

  // the weight cursor: the next tile to issue, (M tile, N group, k step,
  // N tile in the group)
  int pm = 0, pg = 0, pk = 0, pu = 0;
  auto issue = [&](int slot) {
    if (pm < mt) {
      load_w_tile(ws + slot * kWTile, a.w1, a.mid, pk, pg * ntg + pu);
      if (++pu == ntg) {
        pu = 0;
        if (++pk == kt) {
          pk = 0;
          if (++pg == ngs) pg = 0, ++pm;
        }
      }
    }
    cp_async_commit();
  };

  // x chunk (M tile mb, k step kc), 0 outside the image and past the
  // padded grid. One pixel a thread (xpl, channels xcg + kXStep s), or
  // with a.pairs one pixel pair (pixels 2 xpp and 2 xpp + 1 of the tile,
  // rows m of y1 whose grid positions m - 1 start at an even image
  // column, so that the pair is one aligned 4-byte word; channels xpg +
  // 2 kXStep s)
  const int xpl = tid % BM, xcg = tid / BM;
  const int xpp = tid % (BM / 2), xpg = tid / (BM / 2);
  bool x_in = false;
  long long x_off = 0;
  uint32_t xr[kXLoads];
  auto fetch_x = [&](int mb, int kc, bool new_tile) {
    const int pix = a.pairs ? 2 * xpp : xpl;
    if (new_tile) {
      int r, col;
      x_in = grid_in_image(mb * BM + pix - a.pairs, Wp, a.R, r0, a.H, a.W,
                           &r, &col);
      x_off = x_in ? r * a.xsh + col * a.xsw : 0;
    }
    if (a.pairs) {
      const uint32_t* src = reinterpret_cast<const uint32_t*>(
          xb + x_off + (long long)(kc * kBK + xpg) * a.xsc);
      const long long step = kXStep * a.xsc;  // 2 kXStep channels, in words
#pragma unroll
      for (int s = 0; s < kXLoads / 2; ++s)
        xr[s] = x_in ? __ldg(src + s * step) : 0u;
    } else {
      const unsigned short* src =
          xb + x_off + (long long)(kc * kBK + xcg) * a.xsc;
      const long long step = (long long)kXStep * a.xsc;
#pragma unroll
      for (int s = 0; s < kXLoads; ++s) xr[s] = x_in ? __ldg(src + s * step) : 0;
    }
  };
  auto store_x = [&](int slot) {
    bf16* dst = xs + slot * kBK * kXLd;
    if (a.pairs) {
#pragma unroll
      for (int s = 0; s < kXLoads / 2; ++s)
        *reinterpret_cast<uint32_t*>(
            dst + (xpg + 2 * s * kXStep) * kXLd + 2 * xpp) = xr[s];
    } else {
#pragma unroll
      for (int s = 0; s < kXLoads; ++s)
        reinterpret_cast<unsigned short*>(dst)[(xcg + s * kXStep) * kXLd + xpl] =
            (unsigned short)xr[s];
    }
  };

  float acc[NTM][TM][TN][4];
#pragma unroll
  for (int u = 0; u < NTM; ++u) zero(acc[u]);

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) issue(s);
  fetch_x(0, 0, true);
  store_x(0);
  int slot = 0, pslot = kStages - 1, xslot = 0;
  // ldmatrix.trans offsets of this lane in an x chunk ([channel][pixel])
  const int xa_lane = (((lane & 7) + ((lane >> 4) << 3)) * kXLd +
                       wm * TM * 16 + ((lane >> 3) & 1) * 8) * 2;
  for (int mb = 0; mb < mt; ++mb) {
    for (int ng = 0; ng < ngs; ++ng) {
      for (int kc = 0; kc < kt; ++kc) {
        // the chunk after this one, if any
        int xm = mb, xk = kc + 1;
        if (xk == kt) xk = 0, xm += ng + 1 == ngs ? 1 : 0;
        const bool more = xm < mt;
        const uint32_t xa = smem_u32(xs + xslot * kBK * kXLd) + xa_lane;
        for (int u = 0; u < ntg; ++u) {
          cp_async_wait<kStages - 2>();
          __syncthreads();  // step's tiles landed; every warp done with the last
          issue(pslot);
          pslot = pslot + 1 == kStages ? 0 : pslot + 1;
          if (u == 0 && more) fetch_x(xm, xk, xm != mb);

          auto load_a = [&](uint32_t (&af)[TM][4], int kk) {
#pragma unroll
            for (int i = 0; i < TM; ++i)
              ldsm_x4_trans(af[i], xa + (kk * 16 * kXLd + i * 16) * 2);
          };
          const uint32_t wt = smem_u32(ws + slot * kWTile);
          slot = slot + 1 == kStages ? 0 : slot + 1;
#pragma unroll
          for (int v = 0; v < NTM; ++v)
            if (v == u) mma_k64<TM, TN>(acc[v], load_a, wt, lane, wn);
          if (u == ntg - 1 && more) store_x(xslot ^ 1);
          if (kc != kt - 1) continue;

          // y1 = dt(relu(acc + b1)) inside the image, 0 elsewhere (conv2's
          // zero padding and the tail past the padded grid)
          const int col0 = (ng * ntg + u) * kBN + wn * TN * 8 + c2;
#pragma unroll
          for (int v = 0; v < NTM; ++v) {
            if (v != u) continue;
#pragma unroll
            for (int i = 0; i < TM; ++i)
#pragma unroll
              for (int h = 0; h < 2; ++h) {
                const int p = mb * BM + wm * TM * 16 + i * 16 + g + 8 * h;
                int r, col;
                const bool in =
                    grid_in_image(p - a.pairs, Wp, a.R, r0, a.H, a.W, &r, &col);
                if (p >= a.M1) continue;  // the last M tile past y1
#pragma unroll
                for (int j = 0; j < TN; ++j) {
                  const int n = col0 + j * 8;
                  const float v0 = fmaxf(acc[v][i][j][2 * h] + a.b1[n], 0.f);
                  const float v1 =
                      fmaxf(acc[v][i][j][2 * h + 1] + a.b1[n + 1], 0.f);
                  *reinterpret_cast<uint32_t*>(y1 + (size_t)p * ldy + n) =
                      in ? pack_bf16(v0, v1) : 0u;
                }
              }
            zero(acc[v]);
          }
        }
        xslot ^= 1;
      }
    }
  }
}

// conv2 (kStage 2: nine taps of y1 -> y2) or conv3 (kStage 3: y2 -> out,
// + b3 + f32(x)), over the flat index q of the band's R rows of W + 2
// (M2 rows). The steps nest M tile, N tile, k step, with the weight ring
// as in conv1. conv2's k step is a tap and 64 of its channels, whose A
// rows are y1's shifted by dy (W + 2) + dx (+ 1 with pixel pairs).
// conv3 loads the tile's
// residual x into registers before its k steps, stages acc + b3 in f32
// through shared memory, and stores along pixels: a thread holds one
// pixel of the tile and every (256 / BM)-th channel.
template <class G, int kStage>
__device__ __forceinline__ void tc_conv23(const TcArgs& a, int r0, int rows,
                                          const bf16* y1, bf16* y2, bf16* ws,
                                          unsigned char* scratch) {
  constexpr int BM = G::kBM, TM = G::kTM, TN = G::kTN;
  constexpr int kCStep = kTcBodyThreads / BM;  // conv3: channel stride
  constexpr int kPer = kBN / kCStep;           // conv3: outputs a thread
  const int N = kStage == 3 ? a.C : a.mid;
  const int K = kStage == 2 ? 9 * a.mid : a.mid;
  const bf16* w = kStage == 2 ? a.w2 : a.w3;
  const int mt = a.M2 / BM, nt = N / kBN, kt = K / kBK;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wm = warp % G::kWM, wn = warp / G::kWM;
  const int Wp = a.W + 2, ldy = a.mid + 8;
  const int g = lane >> 2, c2 = 2 * (lane & 3);

  int pm = 0, pn = 0, pk = 0;  // the weight cursor: the next tile to issue
  auto issue = [&](int slot) {
    if (pm < mt) {
      load_w_tile(ws + slot * kWTile, w, N, pk, pn);
      if (++pk == kt) {
        pk = 0;
        if (++pn == nt) pn = 0, ++pm;
      }
    }
    cp_async_commit();
  };

  // conv3: this thread's pixel of the tile (epl) and its first channel
  // (ec0), every kCStep-th after; with a.pairs its pixel pair (2 epp,
  // 2 epp + 1, an even image column: q = i (W + 2) + column) and every
  // 2 kCStep-th channel from ecp
  const int epl = tid % BM, ec0 = tid / BM;
  const int epp = tid % (BM / 2), ecp = tid / (BM / 2);
  const int e_pix = a.pairs ? 2 * epp : epl, e_ch = a.pairs ? ecp : ec0;
  const unsigned short* xb =
      reinterpret_cast<const unsigned short*>(a.x + blockIdx.y * a.xsb);
  bf16* ob = a.out + blockIdx.y * a.osb;
  uint32_t rx[kPer];  // conv3: the tile's residual x (pairs: kPer / 2)

  // ldmatrix offsets of this lane in y1 / y2
  const uint32_t ya = smem_u32(kStage == 2 ? y1 : y2) +
                      ((wm * TM * 16 + (lane & 15)) * ldy + (lane >> 4) * 8) * 2;
  float acc[TM][TN][4];
  zero(acc);
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) issue(s);
  int slot = 0, pslot = kStages - 1;
  for (int mb = 0; mb < mt; ++mb) {
    // conv3: this thread's output pixel (pair) of M tile mb
    const int q = mb * BM + e_pix, qi = q / Wp, qj = q - qi * Wp;
    const bool q_in = qi < rows && qj < a.W;
    const long long xpix = (r0 + qi) * a.xsh + qj * a.xsw;
    const long long opix = (r0 + qi) * a.osh + qj * a.osw;
    for (int nb = 0; nb < nt; ++nb) {
      if (kStage == 3) {
        const unsigned short* src =
            xb + xpix + (long long)(nb * kBN + e_ch) * a.xsc;
        if (a.pairs) {
#pragma unroll
          for (int u = 0; u < kPer / 2; ++u)
            rx[u] = q_in ? __ldg(reinterpret_cast<const uint32_t*>(
                               src + (long long)u * 2 * kCStep * a.xsc))
                         : 0u;
        } else {
#pragma unroll
          for (int u = 0; u < kPer; ++u)
            rx[u] = q_in ? __ldg(src + (long long)u * kCStep * a.xsc) : 0;
        }
      }
      int ci = 0, dy = 0, dx = 0;  // conv2: k step kc's tap and channels
      for (int kc = 0; kc < kt; ++kc) {
        cp_async_wait<kStages - 2>();
        __syncthreads();  // step's tile landed; every warp done with the last
        issue(pslot);
        pslot = pslot + 1 == kStages ? 0 : pslot + 1;

        const int row0 = mb * BM + (kStage == 2 ? dy * Wp + dx + a.pairs : 0);
        const int col0 = kStage == 2 ? ci : kc * kBK;
        const uint32_t abase = ya + (row0 * ldy + col0) * 2;
        auto load_a = [&](uint32_t (&af)[TM][4], int kk) {
#pragma unroll
          for (int i = 0; i < TM; ++i)
            ldsm_x4(af[i], abase + (i * 16 * ldy + kk * 16) * 2);
        };
        mma_k64<TM, TN>(acc, load_a, smem_u32(ws + slot * kWTile), lane, wn);
        slot = slot + 1 == kStages ? 0 : slot + 1;
        if (kStage == 2) {
          ci += kBK;
          if (ci == a.mid) {
            ci = 0;
            if (++dx == 3) dx = 0, ++dy;
          }
        }
      }

      if constexpr (kStage == 2) {
        // y2 = dt(relu(acc + b2)), junk columns included (conv3 drops them)
        const int col0 = nb * kBN + wn * TN * 8 + c2;
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int q2 = mb * BM + wm * TM * 16 + i * 16 + g + 8 * h;
#pragma unroll
            for (int j = 0; j < TN; ++j) {
              const int n = col0 + j * 8;
              *reinterpret_cast<uint32_t*>(y2 + (size_t)q2 * ldy + n) =
                  pack_bf16(fmaxf(acc[i][j][2 * h] + a.b2[n], 0.f),
                            fmaxf(acc[i][j][2 * h + 1] + a.b2[n + 1], 0.f));
            }
          }
      } else {
        // out = dt(relu(acc + b3 + f32(x))), staged in f32
        float* st = reinterpret_cast<float*>(scratch);
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int lr = wm * TM * 16 + i * 16 + g + 8 * h;
#pragma unroll
            for (int j = 0; j < TN; ++j) {
              const int lc = wn * TN * 8 + j * 8 + c2, n = nb * kBN + lc;
              st[lr * kSLd + lc] = acc[i][j][2 * h] + a.b3[n];
              st[lr * kSLd + lc + 1] = acc[i][j][2 * h + 1] + a.b3[n + 1];
            }
          }
        __syncthreads();
        bf16* dst = ob + opix + (long long)(nb * kBN + e_ch) * a.osc;
        if (q_in && a.pairs) {
#pragma unroll
          for (int u = 0; u < kPer / 2; ++u) {
            const int lc = e_ch + 2 * u * kCStep;
            const float v0 = st[e_pix * kSLd + lc] +
                             __bfloat162float(__ushort_as_bfloat16(
                                 (unsigned short)(rx[u] & 0xFFFFu)));
            const float v1 = st[(e_pix + 1) * kSLd + lc] +
                             __bfloat162float(__ushort_as_bfloat16(
                                 (unsigned short)(rx[u] >> 16)));
            *reinterpret_cast<uint32_t*>(dst + (long long)u * 2 * kCStep *
                                                   a.osc) =
                pack_bf16(fmaxf(v0, 0.f), fmaxf(v1, 0.f));
          }
        } else if (q_in) {
#pragma unroll
          for (int u = 0; u < kPer; ++u) {
            const float v = st[epl * kSLd + ec0 + u * kCStep] +
                            __bfloat162float(__ushort_as_bfloat16(
                                (unsigned short)rx[u]));
            dst[(long long)u * kCStep * a.osc] = __float2bfloat16(fmaxf(v, 0.f));
          }
        }
      }
      zero(acc);
    }
  }
}

template <class G1, class G23>
__global__ void __launch_bounds__(kTcBodyThreads, 1)
    bottleneck_tc_kernel(const TcArgs a) {
  extern __shared__ __align__(16) unsigned char tc_smem_raw[];
  bf16* y1 = reinterpret_cast<bf16*>(tc_smem_raw);
  bf16* y2 = y1 + (size_t)a.M1 * (a.mid + 8);
  bf16* ws = y2 + (size_t)a.M2 * (a.mid + 8);
  unsigned char* scratch =
      reinterpret_cast<unsigned char*>(ws + kStages * kWTile);
  const int r0 = blockIdx.x * a.R, rows = min(a.R, a.H - r0);
  tc_conv1<G1>(a, r0, y1, ws, scratch);
  __syncthreads();
  tc_conv23<G23, 2>(a, r0, rows, y1, y2, ws, scratch);
  __syncthreads();
  tc_conv23<G23, 3>(a, r0, rows, y1, y2, ws, scratch);
}

// The body's plan for a shape: conv1's M tile BM1 and conv2/conv3's BM23
// (each 32, 64 or 128), band R, rows M1, M2 and the shared memory; false
// if no band fits. Each candidate's time is the larger of its tensor time
// (mma.sync tiles at the ldmatrix-bound share of one per clock per SM:
// 1/4, 1/3, 1/2 for M tiles of 32, 64, 128) and its L2 time (blocks x
// the bytes a block reads: the weights once per M tile, and x once per
// group of N tiles whose accumulators conv1 keeps, over kL2BytesPerS),
// times the wave quantization of one block an SM; the least wins, ties
// to the earlier.
struct TcPlan {
  int BM1, BM23, R, M1, M2;
  size_t smem;
  double tensor_s, l2_s;
};

bool tc_plan(int B, int H, int W, int C, int mid, int shift, TcPlan* out) {
  const int bms[3] = {32, 64, 128};
  const int ntmax[3] = {TcCfg32::kNTMax, TcCfg64::kNTMax, TcCfg128::kNTMax};
  const double share[3] = {0.25, 1.0 / 3.0, 0.5};
  double best = 0.0;
  bool found = false;
  const int nt = mid / kBN;
  for (int i1 = 0; i1 < 3; ++i1) {
    int ntg = std::min(ntmax[i1], nt);
    while (nt % ntg) --ntg;
    for (int i23 = 0; i23 < 3; ++i23) {
      for (int R = 1; R <= 16; R *= 2) {
        if (R > 1 && R / 2 >= H) break;
        const int BM1 = bms[i1], BM23 = bms[i23];
        const size_t smem = tc_smem_bytes(R, W, mid, BM1, BM23, shift);
        if (smem > kMaxSmem) continue;
        int M1, M2;
        tc_rows(R, W, BM23, shift, &M1, &M2);
        const int mt1 = (M1 + BM1 - 1) / BM1;
        const double blocks = (double)B * ((H + R - 1) / R);
        const double mma1 = (double)mt1 * BM1 * C * mid / 2048.0;
        const double mma23 = (double)M2 * (9.0 * mid * mid + mid * C) / 2048.0;
        const double tensor_s = blocks * (mma1 / share[i1] + mma23 / share[i23]) /
                                (kSMs * kSmHz);
        const double bytes =
            2.0 * ((double)mt1 * C * mid +
                   (double)(M2 / BM23) * (9.0 * mid * mid + mid * C) +
                   (double)mt1 * BM1 * C * (nt / ntg));
        const double l2_s = blocks * bytes / kL2BytesPerS;
        const double waves = std::ceil(blocks / kSMs) * kSMs / blocks;
        const double cost = waves * std::max(tensor_s, l2_s);
        if (!found || cost < best * 0.9999) {
          found = true;
          best = cost;
          *out = TcPlan{BM1, BM23, R, M1, M2, smem, tensor_s, l2_s};
        }
      }
    }
  }
  return found;
}

template <class G1, class G23>
cudaError_t launch_tc_cfg(const TcArgs& a, int B, const TcPlan& p,
                          cudaStream_t stream) {
  auto kern = bottleneck_tc_kernel<G1, G23>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)p.smem);
  if (err != cudaSuccess) return err;
  dim3 grid((a.H + p.R - 1) / p.R, B);
  kern<<<grid, kTcBodyThreads, p.smem, stream>>>(a);
  return cudaGetLastError();
}

template <class G1>
cudaError_t launch_tc_bm23(const TcArgs& a, int B, const TcPlan& p,
                           cudaStream_t stream) {
  if (p.BM23 == 32) return launch_tc_cfg<G1, TcCfg32>(a, B, p, stream);
  if (p.BM23 == 64) return launch_tc_cfg<G1, TcCfg64>(a, B, p, stream);
  return launch_tc_cfg<G1, TcCfg128>(a, B, p, stream);
}

cudaError_t launch_tc(TcArgs a, int B, cudaStream_t stream) {
  if (a.C % 64 || a.mid % 64) return cudaErrorInvalidValue;
  const uintptr_t wbits = reinterpret_cast<uintptr_t>(a.w1) |
                          reinterpret_cast<uintptr_t>(a.w2) |
                          reinterpret_cast<uintptr_t>(a.w3);
  if (wbits % 16) return cudaErrorInvalidValue;
  const uintptr_t xo = reinterpret_cast<uintptr_t>(a.x) |
                       reinterpret_cast<uintptr_t>(a.out);
  a.pairs = a.xsw == 1 && a.osw == 1 && a.W % 2 == 0 && xo % 4 == 0 &&
            (a.xsb | a.xsh | a.xsc | a.osb | a.osh | a.osc) % 2 == 0;
  TcPlan p;
  if (!tc_plan(B, a.H, a.W, a.C, a.mid, a.pairs, &p))
    return cudaErrorInvalidValue;
  a.R = p.R;
  a.M1 = p.M1;
  a.M2 = p.M2;
  if (p.BM1 == 32) return launch_tc_bm23<TcCfg32>(a, B, p, stream);
  if (p.BM1 == 64) return launch_tc_bm23<TcCfg64>(a, B, p, stream);
  return launch_tc_bm23<TcCfg128>(a, B, p, stream);
}

}  // namespace

// Plain C entry points, bound with ctypes. Pointers are device pointers;
// x and out are (B, H, W, C) addressed through the given strides (in
// elements); w1 (C, mid), w2 (9, mid, mid), w3 (mid, C) contiguous in the
// dtype; b1, b2 (mid) and b3 (C) f32. dtype: 0 = float32, 1 = bfloat16;
// body: 0 = the staged body, 1 = the tensor-core body (bf16 only, C and
// mid multiples of 64, 16-byte aligned weights, a band that fits).
// Returns the cudaError_t of the launch.
extern "C" int cris_bottleneck(const void* x, const void* w1, const void* b1,
                               const void* w2, const void* b2, const void* w3,
                               const void* b3, void* out, int B, int H, int W,
                               int C, int mid, int dtype, int body,
                               long long xsb, long long xsh, long long xsw,
                               long long xsc, long long osb, long long osh,
                               long long osw, long long osc, void* stream) {
  if (B < 1 || H < 1 || W < 1 || C < 1 || mid < 1 || B > 65535)
    return (int)cudaErrorInvalidValue;
  const long long xs[4] = {xsb, xsh, xsw, xsc};
  const long long os[4] = {osb, osh, osw, osc};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (body == 1) {
    if (dtype != 1) return (int)cudaErrorInvalidValue;
    const TcArgs a{static_cast<const bf16*>(x), static_cast<const bf16*>(w1),
                   static_cast<const bf16*>(w2), static_cast<const bf16*>(w3),
                   static_cast<const float*>(b1), static_cast<const float*>(b2),
                   static_cast<const float*>(b3), static_cast<bf16*>(out),
                   H, W, C, mid, 0, 0, 0, xsb, xsh, xsw, xsc, osb, osh, osw,
                   osc, 0};
    return (int)launch_tc(a, B, st);
  }
  if (body != 0) return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return (int)dispatch<float>(x, w1, b1, w2, b2, w3, b3, out, B, H, W, C,
                                mid, xs, os, st);
  if (dtype == 1)
    return (int)dispatch<__nv_bfloat16>(x, w1, b1, w2, b2, w3, b3, out, B, H,
                                        W, C, mid, xs, os, st);
  return (int)cudaErrorInvalidValue;
}

// The tensor-core body's plan for a shape, for reports (pairs: x and out
// take pixel pairs, as the launch decides it): plan[0..5] = BM1, BM23, R,
// M1, M2, shared memory bytes; times[0..1] = the plan's tensor and L2
// seconds. Returns 0, or 1 if no band fits.
extern "C" int cris_bottleneck_plan(int B, int H, int W, int C, int mid,
                                    int pairs, long long* plan,
                                    double* times) {
  TcPlan p;
  if (!tc_plan(B, H, W, C, mid, pairs, &p)) return 1;
  plan[0] = p.BM1;
  plan[1] = p.BM23;
  plan[2] = p.R;
  plan[3] = p.M1;
  plan[4] = p.M2;
  plan[5] = (long long)p.smem;
  times[0] = p.tensor_s;
  times[1] = p.l2_s;
  return 0;
}
