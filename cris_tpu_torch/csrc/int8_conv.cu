// K8: the int8 implicit-GEMM convolution of the int8 serving sites, and
// the quantise pass that feeds it.
//
// Replaces no Pallas kernel: it is the counterpart of the int8
// `lax.conv_general_dilated(..., preferred_element_type=int32)` that
// cris_tpu/ops/quant.py runs through XLA (`int8_conv2d_static` :64,
// `int8_phase_conv_static` :101, `int8_conv2d` :136). PyTorch has no
// int8 convolution on CUDA, so the port writes its own.
//
//   xq  = clip(round_half_even(x / s), -127, 127)      per-tensor s
//   acc = sum over (ky, kx, ci) of xq[b, oy*st - pt + ky, ox*st - pl + kx, ci]
//                                   * wq[ky, kx, ci, co]      (int32)
//   y   = float(acc) * (s * k_scale[co]) [+ bias[co]] [relu]
//
// Two kernels, as the JAX package quantises once per site (quant.py:87,
// and :121 for the four phase convs of an upsample fold):
//
// - `int8_quantize`: x (NHWC, any strides; f32, bf16 or int8) -> a
//   contiguous (B, H, W, Cp) int8 tensor, Cp = C rounded up to 64, the
//   padding zero. `__fdiv_rn` then `__float2int_rn` (the f32 division and
//   round-half-to-even of the JAX package) and the clamp. Channels-last
//   input is read 16 channels a thread (16-byte loads of bf16); input on
//   NCHW memory (the s2d stem's 3x3 site, CoordConv's 514 channels) goes
//   through a 32-pixel x 64-channel shared-memory tile, so that the reads
//   run along W and the writes along C, both coalesced.
// - `int8_gemm`: the implicit GEMM, M = B*Ho*Wo output pixels by N = Co
//   by K = kh*kw*Cp, walked tap by tap and 64 channels (one 64-byte
//   swizzle row) at a time. The weights come packed once per site as
//   K-major (Co, kh*kw*Cp) int8 (`pack_int8_weights`).
//   * A persistent grid, one block an SM, walks tiles of 128 H rows by
//     128 channels, H = 2 or 1 (`int8_plan` in ops/kernels/int8_conv.py
//     picks it). One producer thread (its warpgroup `setmaxnreg` down to
//     40 registers) keeps a ring of 144 KB (H = 2: 6 stages) or 128 KB
//     (H = 1: 8) in flight through TMA, each stage with one full and one
//     empty mbarrier; two consumer warpgroups (up to 232 registers) each
//     issue 2 H `wgmma.mma_async` m64n128k32 .s32.s8.s8 a stage, A and B
//     both K-major with 64-byte swizzle, keep one stage's products in
//     flight and release the stage before it. The producer runs ahead
//     into the next tile while the consumers write the last one out.
//   * B (weights): a 2-D TMA map over the packed weights, box 64 x 128.
//   * A (activations), two TMA loaders, one box a stage. At the 1x1
//     stride-1 sites A is the quantised tensor itself, an (M, Cp)
//     matrix: a 2-D map, a tile 128 H consecutive pixels. Everywhere else
//     (3x3, the 2x2 stride-2 pooled convs, the 2x2 and 3x3 phase convs
//     with their asymmetric pads) a 4-D map over (Cp, W, H, B) with the
//     conv's stride as the element stride along W and H, and a tile of
//     `rows` output rows of one image by a `wseg`-pixel stretch (the full
//     width up to 128 H and 256 / stride pixels): the box for tap (ky,
//     kx) starts at input pixel (oy0 * stride - pt + ky, ox0 * stride -
//     pl + kx), and its zero fill past the map is the conv's zero
//     padding. The tile's last rows go unused where rows * wseg falls
//     short of 128 H or the image ends (R50 at 256-row tiles: 81% of the
//     rows hold pixels at 104^2 and 52^2, 88% at 26^2), and the epilogue
//     skips them. Two earlier loaders ran the same products slower on an
//     H100: 16-byte `cp.async` gathers of M-linear tiles (every row used)
//     at about half the TMA loader's rate, and one box a row (12 to 16
//     small boxes a stage at 13^2 and 26^2) slower still.
//   * Split-K where the model finds it pays (few tiles for 132 SMs: the
//     B 1 and B 8 device batches a server pads small requests to; at
//     R50 B 1 the 13^2 sites have 8 tiles): each split stores its int32
//     partial sums into its own (M, Co) slab, and a second kernel adds
//     the slabs in order (int32: exact) and applies the epilogue. On an
//     H100 at 700 W the split plans ran 1.9x (B 1) and 1.5x (B 8)
//     faster than the best unsplit ones at the shapes where the model
//     splits (chip_smoke.py phase 18(a)).
//   * Epilogue: `__fmul_rn(__int2float_rn(acc), s * k_scale)` (the
//     factor rounded once, as the plain version's), then `__fadd_rn` of
//     the bias, then the ReLU: no FMA contraction, so the output equals
//     the plain version's bit for bit. bf16 output: computed in the
//     registers, staged per warpgroup in shared memory and stored 16
//     channel-contiguous bytes a thread, with any output strides (the
//     phase convs write `out[:, di::2, dj::2]`); f32 output (the f32
//     forward) straight from the registers, 8 bytes a thread.
//
// What bounds it on the card: device memory at the 1x1 sites (104^2 x
// 256 -> 256 at B 16: 44 MB of int8 in, 89 MB of bf16 out, against 45
// G int8 operations, 23 us at 1,979 TOPS) and the tensor cores at the
// large 3x3 sites (104^2 x 128 -> 256: 102 G operations, 52 us, against
// 22 MB in and 89 MB out). The quantise pass is bound by its bytes (3 a
// channel: bf16 in, int8 out). chip_smoke.py phase 18 times each site
// against both bounds and against the other tiles and splits.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <type_traits>

#include "gemm_sm90.cuh"

namespace {

using cris::sm90::encode_tiled;
using cris::sm90::mbar_arrive;
using cris::sm90::mbar_expect_tx;
using cris::sm90::mbar_init;
using cris::sm90::mbar_wait;
using cris::sm90::named_barrier_sync;
using cris::sm90::smem_u32;
using cris::sm90::tma_load_2d;
using cris::sm90::wgmma_commit;
using cris::sm90::wgmma_fence;
using cris::sm90::wgmma_wait;

// ------------------------------------------------------------ quantise

__device__ __forceinline__ int8_t quantize(float v, float s) {
  int q = __float2int_rn(__fdiv_rn(v, s));
  return (int8_t)min(max(q, -127), 127);
}

__device__ __forceinline__ uint32_t pack4(float a, float b, float c, float d,
                                          float s) {
  return (uint32_t)(uint8_t)quantize(a, s) |
         ((uint32_t)(uint8_t)quantize(b, s) << 8) |
         ((uint32_t)(uint8_t)quantize(c, s) << 16) |
         ((uint32_t)(uint8_t)quantize(d, s) << 24);
}

template <typename T>
__device__ __forceinline__ int8_t load_q(const T* x, long long off, float s);

template <>
__device__ __forceinline__ int8_t load_q<float>(const float* x, long long off,
                                                float s) {
  return quantize(x[off], s);
}

template <>
__device__ __forceinline__ int8_t load_q<__nv_bfloat16>(
    const __nv_bfloat16* x, long long off, float s) {
  return quantize(__bfloat162float(x[off]), s);
}

template <>
__device__ __forceinline__ int8_t load_q<int8_t>(const int8_t* x,
                                                 long long off, float) {
  return x[off];
}

// 8 consecutive channels at x + off (16-byte aligned f32 / bf16, 8-byte
// aligned int8), quantised and packed little-endian
template <typename T>
__device__ __forceinline__ uint2 load_q8(const T* x, long long off, float s);

template <>
__device__ __forceinline__ uint2 load_q8<float>(const float* x, long long off,
                                                float s) {
  const float4 a = *reinterpret_cast<const float4*>(x + off);
  const float4 b = *reinterpret_cast<const float4*>(x + off + 4);
  return make_uint2(pack4(a.x, a.y, a.z, a.w, s),
                    pack4(b.x, b.y, b.z, b.w, s));
}

template <>
__device__ __forceinline__ uint2 load_q8<__nv_bfloat16>(
    const __nv_bfloat16* x, long long off, float s) {
  const uint4 v = *reinterpret_cast<const uint4*>(x + off);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
  float2 f0 = __bfloat1622float2(h[0]), f1 = __bfloat1622float2(h[1]);
  float2 f2 = __bfloat1622float2(h[2]), f3 = __bfloat1622float2(h[3]);
  return make_uint2(pack4(f0.x, f0.y, f1.x, f1.y, s),
                    pack4(f2.x, f2.y, f3.x, f3.y, s));
}

template <>
__device__ __forceinline__ uint2 load_q8<int8_t>(const int8_t* x,
                                                 long long off, float) {
  return *reinterpret_cast<const uint2*>(x + off);
}

struct Quant {
  const void* x;
  const float* act_scale;
  int8_t* q;
  int B, H, W, C, Cp, dense;
  long long xs_b, xs_h, xs_w, xs_c;
};

// Channels-last x (xs_c == 1): 16 channels of one pixel a thread, one
// thread an item (every load in flight at once), padding channels written
// as 0. kVec: C, the strides and the base allow 8-channel vector loads;
// dense: x is contiguous NHWC, so pixel p starts at p * C.
template <typename T, bool kVec>
__global__ void __launch_bounds__(256) quantize_cl_kernel(Quant p) {
  const T* __restrict__ x = static_cast<const T*>(p.x);
  const float s = *p.act_scale;
  const unsigned segs = p.Cp / 16;
  const unsigned total = (unsigned)p.B * p.H * p.W * segs;
  const unsigned i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < total) {
    const unsigned pix = i / segs, c = (i - pix * segs) * 16;
    long long off;
    if (p.dense) {
      off = (long long)pix * p.C;
    } else {
      const unsigned w = pix % p.W, t = pix / p.W, h = t % p.H, b = t / p.H;
      off = b * p.xs_b + h * p.xs_h + w * p.xs_w;
    }
    uint2 lo = make_uint2(0, 0), hi = make_uint2(0, 0);
    if (kVec) {
      if (c < (unsigned)p.C) {
        lo = load_q8<T>(x, off + c, s);
        hi = load_q8<T>(x, off + c + 8, s);
      }
    } else {
      uint32_t w4[4] = {0, 0, 0, 0};
#pragma unroll
      for (int e = 0; e < 16; ++e) {
        if (c + e < (unsigned)p.C)
          w4[e / 4] |= (uint32_t)(uint8_t)load_q<T>(x, off + (c + e) * p.xs_c,
                                                     s)
                       << (8 * (e % 4));
      }
      lo = make_uint2(w4[0], w4[1]);
      hi = make_uint2(w4[2], w4[3]);
    }
    *reinterpret_cast<uint4*>(p.q + (size_t)pix * p.Cp + c) =
        make_uint4(lo.x, lo.y, hi.x, hi.y);
  }
}

// Any other layout (NCHW memory: W of unit stride): one block a 32-pixel
// stretch of one image row by 64 channels, read along W (a warp: 32
// neighbouring pixels of one channel) into a shared tile, and written
// along C (a warp: two pixels' 64 channels, 4 bytes a thread).
template <typename T>
__global__ void __launch_bounds__(256) quantize_tiled_kernel(Quant p) {
  __shared__ int tile[64][33];
  const T* x = static_cast<const T*>(p.x);
  const float s = *p.act_scale;
  const int tiles_w = (p.W + 31) / 32, tiles_c = p.Cp / 64;
  int blk = blockIdx.x;
  const int tc = blk % tiles_c;
  blk /= tiles_c;
  const int tw = blk % tiles_w;
  const int row = blk / tiles_w;  // b * H + h
  const int b = row / p.H, h = row - b * p.H;
  const int w0 = tw * 32, c0 = tc * 64;
  const int tx = threadIdx.x % 32, ty = threadIdx.x / 32;
  const long long base = b * p.xs_b + h * p.xs_h;
  for (int k = ty; k < 64; k += 8) {
    const int c = c0 + k, w = w0 + tx;
    int v = 0;
    if (c < p.C && w < p.W) v = load_q<T>(x, base + w * p.xs_w + c * p.xs_c, s);
    tile[k][tx] = v;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < 32 * 16; i += 256) {
    const int px = i / 16, q = i % 16, w = w0 + px;
    if (w >= p.W) continue;
    const uint32_t word = (uint32_t)(uint8_t)tile[4 * q][px] |
                          ((uint32_t)(uint8_t)tile[4 * q + 1][px] << 8) |
                          ((uint32_t)(uint8_t)tile[4 * q + 2][px] << 16) |
                          ((uint32_t)(uint8_t)tile[4 * q + 3][px] << 24);
    *reinterpret_cast<uint32_t*>(p.q + ((size_t)row * p.W + w) * p.Cp + c0 +
                                 4 * q) = word;
  }
}

template <typename T>
cudaError_t launch_quantize(const Quant& p, cudaStream_t st) {
  if (p.xs_c == 1) {
    const bool vec = p.C % 16 == 0 && p.xs_w % 8 == 0 && p.xs_h % 8 == 0 &&
                     p.xs_b % 8 == 0 &&
                     reinterpret_cast<uintptr_t>(p.x) % 16 == 0;
    const long long total = (long long)p.B * p.H * p.W * (p.Cp / 16);
    const int blocks = (int)((total + 255) / 256);  // 16 channels a thread
    if (vec)
      quantize_cl_kernel<T, true><<<blocks, 256, 0, st>>>(p);
    else
      quantize_cl_kernel<T, false><<<blocks, 256, 0, st>>>(p);
  } else {
    const long long blocks =
        (long long)p.B * p.H * ((p.W + 31) / 32) * (p.Cp / 64);
    quantize_tiled_kernel<T><<<(unsigned)blocks, 256, 0, st>>>(p);
  }
  return cudaGetLastError();
}

// ---------------------------------------------------------------- GEMM

constexpr int kBN = 128, kBK = 64;  // output channels, K bytes a stage
constexpr int kConsumers = 2;  // warpgroups, 64 * H rows (H m64 halves) each
constexpr int kThreads = 128 * (kConsumers + 1);  // + the producer warpgroup
constexpr int kLdo = kBN + 8;  // staged bf16 output row stride, elements

// The tile is (128 H) x 128: H = 2 where 256-row tiles fill the card, 1
// where they would leave SMs idle.
template <int H>
struct Ring {
  static constexpr int kBM = 128 * H;
  static constexpr int kRowsPerWg = 64 * H;
  // 144 KB of ring at H = 2 (6 stages), 128 KB at H = 1 (8 stages)
  static constexpr int kStages = H == 2 ? 6 : 8;
  static constexpr int kABytes = kBM * kBK;
  static constexpr int kBBytes = kBN * kBK;
  static constexpr int kStageBytes = kABytes + kBBytes;
  // per consumer warpgroup: its bf16 output rows, each row's output
  // offset, and the tile's per-channel factors
  static constexpr int kOutBytes = kRowsPerWg * kLdo * 2;
  static constexpr int kWgBytes = kOutBytes + kRowsPerWg * 8 + 2 * kBN * 4;
  // + 1024: the dynamic base is rounded up to a 1024-byte boundary
  static constexpr int kSmemBytes = kStages * kStageBytes +
                                    kConsumers * kWgBytes + 2 * kStages * 8 +
                                    1024;
  static_assert(kSmemBytes <= 232448, "fits the SM's shared memory");
};

struct Gemm {
  const float* k_scale;
  const float* act_scale;
  const float* bias;
  void* out;
  int* ws;  // (split, M, Co) int32 partial sums when split > 1
  int Ho, Wo, Co, kw, stride, pad_t, pad_l, relu, vec;
  int M, kblocks, cpb, tiles_n, tiles, split, units;
  // the box loader: a tile is `rows` output rows of one image by a
  // `wseg`-pixel stretch, tile row i = (i / wseg, i % wseg); `groups`
  // tiles down an image, `segs` across it
  int rows, wseg, groups, segs;
  long long os_b, os_h, os_w, os_c;
};

// A K-major shared-memory matrix descriptor for rows of 64 bytes with
// 64-byte swizzle (layout type 2); 8-row groups 512 bytes apart.
__device__ __forceinline__ uint64_t desc_k(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>((kBK * 8) >> 4) << 32) |
         (static_cast<uint64_t>(2) << 62);
}

// d (64 x 128, s32) += A (64 x 32 s8, K-major) B (32 x 128 s8, K-major)
__device__ __forceinline__ void wgmma_s8(int (&d)[64], uint64_t da,
                                         uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, "
      "%43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, "
      "%57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]),
        "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]),
        "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]),
        "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]),
        "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void fence_acc(int (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// 4-D TMA load of one box at (c0, c1, c2, c3), innermost first.
__device__ __forceinline__ void tma_load_4d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

// A unit of work: tile rows m0 .. (linear loader: output pixels m0 ..;
// boxes: output rows from m0 = b * Ho + oy0, columns from ox0), output
// channels n0 .., k-blocks [kb0, kb1).
struct Unit {
  int m0, ox0, n0, kb0, kb1;
};

// unit u: split u / tiles, then tile u % tiles, N tiles fastest (the
// blocks in flight share A's rows); split j takes k-blocks [j * kblocks /
// split, (j + 1) * kblocks / split).
template <bool kRows>
__device__ __forceinline__ Unit unit_of(const Gemm& p, int u, int bm) {
  const int j = u / p.tiles, tile = u - j * p.tiles;
  const int tm = tile / p.tiles_n, tn = tile - tm * p.tiles_n;
  const int kb0 = j * p.kblocks / p.split, kb1 = (j + 1) * p.kblocks / p.split;
  if (!kRows) return {tm * bm, 0, tn * kBN, kb0, kb1};
  const int cs = tm % p.segs, bg = tm / p.segs;
  const int b = bg / p.groups, g = bg - b * p.groups;
  return {b * p.Ho + g * p.rows, cs * p.wseg, tn * kBN, kb0, kb1};
}

// The output pixel of tile row i (M-linear, in 0 .. M), or -1 for a row
// the tile leaves unused.
template <bool kRows>
__device__ __forceinline__ int pixel_of(const Gemm& p, const Unit& t, int i) {
  if (!kRows) return t.m0 + i < p.M ? t.m0 + i : -1;
  const int r = i / p.wseg, ox = t.ox0 + (i - r * p.wseg);
  if (r >= p.rows || t.m0 % p.Ho + r >= p.Ho || ox >= p.Wo) return -1;
  return (t.m0 + r) * p.Wo + ox;
}

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// The output offset of pixel m (elements), through the output strides.
__device__ __forceinline__ long long out_offset(const Gemm& p, int m) {
  const int ox = m % p.Wo, t = m / p.Wo, oy = t % p.Ho, b = t / p.Ho;
  return b * p.os_b + oy * p.os_h + ox * p.os_w;
}

// The exact epilogue of one sum: float(acc) * scale (scale = s *
// k_scale[n], rounded once, as the plain version's s * k_scale), then +
// bias where there is one, then the ReLU.
__device__ __forceinline__ float epilogue(const Gemm& p, int acc, float scale,
                                          float bias) {
  float y = __fmul_rn(__int2float_rn(acc), scale);
  if (p.bias != nullptr) y = __fadd_rn(y, bias);
  if (p.relu) y = fmaxf(y, 0.0f);
  return y;
}

// s * k_scale[n] and bias[n] (0 past Co).
__device__ __forceinline__ void channel_factor(const Gemm& p, float s, int n,
                                               float* scale, float* bias) {
  const bool in = n < p.Co;
  *scale = in ? __fmul_rn(s, p.k_scale[n]) : 0.f;
  *bias = in && p.bias != nullptr ? p.bias[n] : 0.f;
}

// kRows: A through one box a stage of a 4-D map over (Cp, W, H, B); else
// A is an (M, Cp) matrix under a 2-D map (the 1x1 stride-1 sites).
template <int H, bool kRows, typename Tout>
__global__ void __launch_bounds__(kThreads, 1)
    int8_gemm_kernel(const __grid_constant__ CUtensorMap ta,
                     const __grid_constant__ CUtensorMap tb, const Gemm p) {
  using R = Ring<H>;
  constexpr int S = R::kStages, kRowsPerWg = R::kRowsPerWg;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* wg_mem = smem + S * R::kStageBytes;  // [kConsumers][kWgBytes]
  uint64_t* full =
      reinterpret_cast<uint64_t*>(wg_mem + kConsumers * R::kWgBytes);
  uint64_t* empty = full + S;
  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(smem_u32(&full[s]), 1);  // the producer's expect_tx
      mbar_init(smem_u32(&empty[s]), 4 * kConsumers);  // lane 0 a warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == kConsumers) {  // the producer warpgroup: one thread loads
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (tid != 0) return;
    // bytes a stage: a box counts whole, zero-filled past the map
    const uint32_t a_bytes =
        kRows ? (uint32_t)(p.rows * p.wseg * kBK) : (uint32_t)R::kABytes;
    int it = 0;
    for (int u = blockIdx.x; u < p.units; u += gridDim.x) {
      const Unit t = unit_of<kRows>(p, u, R::kBM);
      for (int kb = t.kb0; kb < t.kb1; ++kb, ++it) {
        const int s = it % S;
        if (it >= S) mbar_wait(smem_u32(&empty[s]), ((it / S) - 1) & 1);
        const uint32_t bar = smem_u32(&full[s]);
        const uint32_t a = smem_u32(smem + s * R::kStageBytes);
        mbar_expect_tx(bar, a_bytes + R::kBBytes);
        tma_load_2d(a + R::kABytes, &tb, bar, kb * kBK, t.n0);
        if (!kRows) {
          tma_load_2d(a, &ta, bar, kb * kBK, t.m0);
        } else {
          // the tile's rows x wseg pixels (every stride-th along both) of
          // image b from input pixel (oy0 * stride - pt + ky, ox0 *
          // stride - pl + kx), this k-block's 64 channels; padding falls
          // outside the map and reads as zeros
          const int tap = kb / p.cpb, c0 = (kb - tap * p.cpb) * kBK;
          const int ky = tap / p.kw, kx = tap - ky * p.kw;
          const int b = t.m0 / p.Ho, oy0 = t.m0 - b * p.Ho;
          tma_load_4d(a, &ta, bar, c0, t.ox0 * p.stride - p.pad_l + kx,
                      oy0 * p.stride - p.pad_t + ky, b);
        }
      }
    }
    return;
  }

  // consumers: warpgroup wg computes rows 64 H wg .. + 64 H - 1 of each
  // tile, as H m64 halves
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int lane = threadIdx.x & 31, warp = tid / 32;
  const float s_act = *p.act_scale;
  uint8_t* mine = wg_mem + wg * R::kWgBytes;
  __nv_bfloat16* staged = reinterpret_cast<__nv_bfloat16*>(mine);
  long long* rows = reinterpret_cast<long long*>(mine + R::kOutBytes);
  float* scales = reinterpret_cast<float*>(rows + kRowsPerWg);
  float* biases = scales + kBN;
  int it = 0;
  for (int u = blockIdx.x; u < p.units; u += gridDim.x) {
    const Unit t = unit_of<kRows>(p, u, R::kBM);
    int acc[H][64];
#pragma unroll
    for (int i = 0; i < H; ++i) {
#pragma unroll
      for (int e = 0; e < 64; ++e) acc[i][e] = 0;
      fence_acc(acc[i]);
    }
    for (int kb = t.kb0; kb < t.kb1; ++kb, ++it) {
      const int s = it % S;
      mbar_wait(smem_u32(&full[s]), (it / S) & 1);
      const uint32_t a =
          smem_u32(smem + s * R::kStageBytes) + wg * kRowsPerWg * kBK;
      const uint32_t bt = smem_u32(smem + s * R::kStageBytes) + R::kABytes;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBK / 32; ++kk) {
        const uint64_t db = desc_k(bt + kk * 32);
#pragma unroll
        for (int i = 0; i < H; ++i)
          wgmma_s8(acc[i], desc_k(a + i * 64 * kBK + kk * 32), db);
      }
      wgmma_commit();
      wgmma_wait<1>();  // the stage before this one has been read
      if (kb > t.kb0 && lane == 0)
        mbar_arrive(smem_u32(&empty[(it - 1) % S]));
    }
    wgmma_wait<0>();
#pragma unroll
    for (int i = 0; i < H; ++i) fence_acc(acc[i]);
    if (lane == 0) mbar_arrive(smem_u32(&empty[(it - 1) % S]));

    // each of this warpgroup's rows: its output offset (a split's slab:
    // pixel * Co), or -1; the tile's channel factors
    named_barrier_sync(2 + wg, 128);  // the last tile's reads are done
    if (tid < kRowsPerWg) {
      const int m = pixel_of<kRows>(p, t, wg * kRowsPerWg + tid);
      rows[tid] = m < 0 ? -1
                        : (p.split > 1 ? (long long)m * p.Co
                                       : out_offset(p, m));
    }
    channel_factor(p, s_act, t.n0 + tid, &scales[tid], &biases[tid]);
    named_barrier_sync(2 + wg, 128);

    // accumulator fragment of half i: warp w holds rows 64 i + 16 w +
    // lane / 4 (and + 8), columns 8 j + 2 (lane % 4) (and + 1), j < 16
    const int col = 2 * (lane % 4);
    if (p.split > 1 || !std::is_same<Tout, __nv_bfloat16>::value) {
      // straight from the registers: split j's int32 sums into its (M,
      // Co) slab of ws (int8_finish_kernel adds the slabs and writes
      // out), or the f32 output, 8 bytes a thread, 32 a quad
      int* slab = p.ws + (size_t)(u / p.tiles) * p.M * p.Co;
#pragma unroll
      for (int i = 0; i < H; ++i) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const long long o = rows[64 * i + 16 * warp + lane / 4 + 8 * h];
          if (o < 0) continue;
#pragma unroll
          for (int j = 0; j < 16; ++j) {
            const int c = 8 * j + col, n = t.n0 + c;
            const int v0 = acc[i][4 * j + 2 * h];
            const int v1 = acc[i][4 * j + 2 * h + 1];
            if (p.split > 1) {
              if ((p.Co & 1) == 0 && n < p.Co) {
                *reinterpret_cast<int2*>(slab + o + n) = make_int2(v0, v1);
              } else {
                if (n < p.Co) slab[o + n] = v0;
                if (n + 1 < p.Co) slab[o + n + 1] = v1;
              }
            } else {
              Tout* dst = static_cast<Tout*>(p.out) + o + n * p.os_c;
              const float y0 = epilogue(p, v0, scales[c], biases[c]);
              const float y1 = epilogue(p, v1, scales[c + 1], biases[c + 1]);
              if (p.vec && n + 1 < p.Co) {
                *reinterpret_cast<float2*>(dst) = make_float2(y0, y1);
              } else {
                if (n < p.Co) store(dst, y0);
                if (n + 1 < p.Co) store(dst + p.os_c, y1);
              }
            }
          }
        }
      }
      continue;
    }
    // bf16: the epilogue in registers, the tile staged as bf16, then 16
    // channel-contiguous bytes a thread
#pragma unroll
    for (int i = 0; i < H; ++i) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = 64 * i + 16 * warp + lane / 4 + 8 * h;
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          const int c = 8 * j + col;
          const __nv_bfloat162 pair = __floats2bfloat162_rn(
              epilogue(p, acc[i][4 * j + 2 * h], scales[c], biases[c]),
              epilogue(p, acc[i][4 * j + 2 * h + 1], scales[c + 1],
                       biases[c + 1]));
          *reinterpret_cast<__nv_bfloat162*>(&staged[r * kLdo + c]) = pair;
        }
      }
    }
    named_barrier_sync(2 + wg, 128);
    const int cc = (tid % 16) * 8, n = t.n0 + cc;
    for (int rr = tid / 16; rr < kRowsPerWg && n < p.Co; rr += 8) {
      const long long o = rows[rr];
      if (o < 0) continue;
      __nv_bfloat16* dst = static_cast<__nv_bfloat16*>(p.out) + o + n * p.os_c;
      const uint4 v = *reinterpret_cast<const uint4*>(&staged[rr * kLdo + cc]);
      if (p.vec && n + 8 <= p.Co) {
        *reinterpret_cast<uint4*>(dst) = v;
      } else {
        const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&v);
        for (int k = 0; k < 8 && n + k < p.Co; ++k) dst[k * p.os_c] = e[k];
      }
    }
  }
}

// The epilogue of a split-K launch: the splits' (M, Co) int32 slabs
// added in order (exact), then written out as by the GEMM, 8 channels a
// thread.
template <typename Tout>
__global__ void __launch_bounds__(256) int8_finish_kernel(const Gemm p) {
  const float s = *p.act_scale;
  const unsigned segs = (p.Co + 7) / 8;
  const unsigned total = (unsigned)p.M * segs;
  const size_t slab = (size_t)p.M * p.Co;
  for (unsigned i = blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += gridDim.x * blockDim.x) {
    const int m = i / segs, n = (i - m * segs) * 8;
    const int* w = p.ws + (size_t)m * p.Co + n;
    int v[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) v[e] = 0;
    for (int j = 0; j < p.split; ++j, w += slab) {
#pragma unroll
      for (int e = 0; e < 8; ++e)
        if (n + e < p.Co) v[e] += w[e];
    }
    Tout* dst = static_cast<Tout*>(p.out) + out_offset(p, m) + n * p.os_c;
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      if (n + e < p.Co) {
        float sc, b;
        channel_factor(p, s, n + e, &sc, &b);
        store(dst + e * p.os_c, epilogue(p, v[e], sc, b));
      }
    }
  }
}

// An int8 tensor map with 64-byte boxes of channels, 64-byte swizzle and
// zero fill past the edges: rank 2 over `outer` rows of `inner` bytes
// (dims[0], dims[1]), or rank 4 over (Cp, W, H, B) with element strides
// (1, stride, stride, 1). False if the encoding is refused.
bool make_tmap_s8(CUtensorMap* map, const void* base, int rank,
                  const cuuint64_t* dims, const cuuint64_t* strides,
                  const cuuint32_t* box, const cuuint32_t* elem) {
  cris::sm90::EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return false;
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, rank,
                const_cast<void*>(base), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_64B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int H, bool kRows, typename Tout>
cudaError_t launch_gemm(const CUtensorMap& ta, const CUtensorMap& tb,
                        const Gemm& p, int grid, cudaStream_t st) {
  using R = Ring<H>;
  auto kern = int8_gemm_kernel<H, kRows, Tout>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, R::kSmemBytes);
  if (err != cudaSuccess) return err;
  kern<<<grid, kThreads, R::kSmemBytes, st>>>(ta, tb, p);
  err = cudaGetLastError();
  if (err != cudaSuccess || p.split == 1) return err;
  const long long items = (long long)p.M * ((p.Co + 7) / 8);
  const int blocks = (int)std::min<long long>((items + 255) / 256, 132 * 16);
  int8_finish_kernel<Tout><<<blocks, 256, 0, st>>>(p);
  return cudaGetLastError();
}

template <typename Tout>
cudaError_t dispatch(const CUtensorMap& ta, const CUtensorMap& tb,
                     const Gemm& p, int bm, bool row_boxes, int grid,
                     cudaStream_t st) {
  if (bm == 256)
    return row_boxes ? launch_gemm<2, true, Tout>(ta, tb, p, grid, st)
                     : launch_gemm<2, false, Tout>(ta, tb, p, grid, st);
  return row_boxes ? launch_gemm<1, true, Tout>(ta, tb, p, grid, st)
                   : launch_gemm<1, false, Tout>(ta, tb, p, grid, st);
}

}  // namespace

// Plain C entry points, bound with ctypes.
//
// cris_int8_quantize: x (B, H, W, C) on the device through the given
// element strides, f32 (in_dtype 0), bf16 (1) or int8 (2, copied as it
// is); act_scale (1) f32; q contiguous (B, H, W, Cp) int8, Cp a multiple
// of 64 and at least C. Returns the launch's cudaError_t.
extern "C" int cris_int8_quantize(const void* x, const void* act_scale,
                                  void* q, int B, int H, int W, int C, int Cp,
                                  int in_dtype, long long xs_b, long long xs_h,
                                  long long xs_w, long long xs_c,
                                  void* stream) {
  if (B < 1 || H < 1 || W < 1 || C < 1 || Cp < C || Cp % 64 ||
      (long long)B * H * W * Cp > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const int dense = xs_c == 1 && xs_w == C && xs_h == (long long)W * C &&
                    xs_b == (long long)H * W * C;
  Quant p{x, static_cast<const float*>(act_scale), static_cast<int8_t*>(q),
          B, H, W, C, Cp, dense, xs_b, xs_h, xs_w, xs_c};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (in_dtype == 0) return (int)launch_quantize<float>(p, st);
  if (in_dtype == 1) return (int)launch_quantize<__nv_bfloat16>(p, st);
  if (in_dtype == 2) return (int)launch_quantize<int8_t>(p, st);
  return (int)cudaErrorInvalidValue;
}

// cris_int8_conv: the GEMM of the quantised xq (B, H, W, Cp) contiguous
// int8 with the packed weights w (Co, kh * kw * Cp) int8 (K-major: k =
// (ky * kw + kx) * Cp + c), both 16-byte aligned, Cp a multiple of 64;
// k_scale, bias (Co) and act_scale (1) f32, bias may be null; out (B, Ho,
// Wo, Co) f32 (out_dtype 0) or bf16 (1) through the given element
// strides. The plan (int8_plan in ops/kernels/int8_conv.py): bm the
// tile's rows (256 or 128); wseg 0 for the linear loader (the 1x1
// stride-1 unpadded sites), else the boxes' width in output pixels and
// rows their height (wseg * rows at most bm, each times stride at most
// 256); split >= 1 and grid blocks; ws (split, M, Co) int32
// scratch when split > 1, else null. Kernels 1..3 a side, stride 1 or 2,
// paddings below the kernel's size. Returns the launches' cudaError_t.
extern "C" int cris_int8_conv(const void* xq, const void* w,
                              const void* k_scale, const void* act_scale,
                              const void* bias, void* out, void* ws, int B,
                              int H, int W, int Cp, int Ho, int Wo, int Co,
                              int kh, int kw, int stride, int pad_t, int pad_l,
                              int out_dtype, int relu, int bm, int wseg,
                              int rows, int split, int grid, long long os_b,
                              long long os_h, long long os_w, long long os_c,
                              void* stream) {
  const long long M = (long long)B * Ho * Wo;
  const bool row_boxes = wseg > 0;
  if (B < 1 || H < 1 || W < 1 || Ho < 1 || Wo < 1 || Co < 1 || kh < 1 ||
      kh > 3 || kw < 1 || kw > 3 || stride < 1 || stride > 2 || pad_t < 0 ||
      pad_t >= kh || pad_l < 0 || pad_l >= kw || M > 0x7fffffffLL ||
      out_dtype < 0 || out_dtype > 1 || (bm != 128 && bm != 256) ||
      Cp < kBK || Cp % kBK || split < 1 || grid < 1 ||
      (split > 1 && ws == nullptr) || wseg < 0 ||
      (wseg > 0 && (rows < 1 || wseg * rows > bm || wseg * stride > 256 ||
                    rows * stride > 256)) ||
      (!row_boxes && (kh != 1 || kw != 1 || stride != 1 || pad_t || pad_l ||
                      Ho != H || Wo != W)) ||
      reinterpret_cast<uintptr_t>(xq) % 16 ||
      reinterpret_cast<uintptr_t>(w) % 16)
    return (int)cudaErrorInvalidValue;
  const int kblocks = kh * kw * (Cp / kBK);
  const int tiles_n = (Co + kBN - 1) / kBN;
  const int groups = row_boxes ? (Ho + rows - 1) / rows : 0;
  const int segs = row_boxes ? (Wo + wseg - 1) / wseg : 0;
  const long long tiles_m =
      row_boxes ? (long long)B * groups * segs : (M + bm - 1) / bm;
  if (split > kblocks || tiles_m * tiles_n * split > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const int tiles = (int)tiles_m * tiles_n;
  const int vsize = out_dtype == 0 ? 4 : 8;  // output elements a 16 bytes
  const int vec = os_c == 1 && os_b % vsize == 0 && os_h % vsize == 0 &&
                  os_w % vsize == 0 &&
                  reinterpret_cast<uintptr_t>(out) % 16 == 0;
  Gemm p{static_cast<const float*>(k_scale),
         static_cast<const float*>(act_scale), static_cast<const float*>(bias),
         out, static_cast<int*>(ws), Ho, Wo, Co, kw, stride, pad_t, pad_l,
         relu, vec, (int)M, kblocks, Cp / kBK, tiles_n, tiles, split,
         tiles * split, rows, wseg, groups, segs, os_b, os_h, os_w, os_c};
  CUtensorMap ta, tb;
  const cuuint32_t one[4] = {1, 1, 1, 1};
  {
    const cuuint64_t kp = (cuuint64_t)kh * kw * Cp;
    const cuuint64_t dims[2] = {kp, (cuuint64_t)Co}, strides[1] = {kp};
    const cuuint32_t box[2] = {kBK, kBN};
    if (!make_tmap_s8(&tb, w, 2, dims, strides, box, one))
      return (int)cudaErrorInvalidValue;
  }
  if (row_boxes) {
    const cuuint64_t dims[4] = {(cuuint64_t)Cp, (cuuint64_t)W, (cuuint64_t)H,
                                (cuuint64_t)B};
    const cuuint64_t strides[3] = {(cuuint64_t)Cp, (cuuint64_t)W * Cp,
                                   (cuuint64_t)H * W * Cp};
    const cuuint32_t box[4] = {kBK, (cuuint32_t)(wseg * stride),
                               (cuuint32_t)(rows * stride), 1};
    const cuuint32_t elem[4] = {1, (cuuint32_t)stride, (cuuint32_t)stride, 1};
    if (!make_tmap_s8(&ta, xq, 4, dims, strides, box, elem))
      return (int)cudaErrorInvalidValue;
  } else {
    const cuuint64_t dims[2] = {(cuuint64_t)Cp, (cuuint64_t)M};
    const cuuint64_t strides[1] = {(cuuint64_t)Cp};
    const cuuint32_t box[2] = {kBK, (cuuint32_t)bm};
    if (!make_tmap_s8(&ta, xq, 2, dims, strides, box, one))
      return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  grid = std::min(grid, p.units);
  if (out_dtype == 0)
    return (int)dispatch<float>(ta, tb, p, bm, row_boxes, grid, st);
  return (int)dispatch<__nv_bfloat16>(ta, tb, p, bm, row_boxes, grid, st);
}
