// K8: int8 implicit-GEMM convolution for the int8 serving sites.
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
// x is NHWC (any strides: the model hands NHWC views of NCHW memory) in
// f32 or bf16, quantised as it is loaded (`__fdiv_rn`, `__float2int_rn`:
// the JAX package's f32 division and round-half-to-even), or int8 as it
// is. wq is HWIO int8, k_scale, bias and s f32 (s read from device memory,
// so a dynamic scale needs no copy to the host). The epilogue uses
// `__fmul_rn` / `__fadd_rn`, so nothing is contracted into an FMA and the
// output equals the plain version's bit for bit. Out is f32 or bf16, any
// strides (the phase convs write their interleaved positions directly).
//
// Design (a simple kernel first): the GEMM is M = B*Ho*Wo pixels by
// N = Co by K = kh*kw*C. A block of 8 warps computes a 128 x 128 tile,
// each warp 32 x 64 as 2 x 8 `mma.sync.m16n8k32` s8.s8 -> s32 tiles. For
// each 32-deep K step the block gathers the 128 x 32 input patch tile
// (quantising on load, zero outside the image) and the 32 x 128 weight
// tile into shared memory, both k-contiguous per row so that each
// fragment register is one 32-bit load; rows are padded to 48 bytes,
// which puts the 8 rows a fragment load touches in distinct banks. A
// channels-last input with C a multiple of 8 is gathered 8 channels at a
// time (one 16-byte load of bf16, two of f32, one 8-byte load of int8,
// quantised to one 8-byte shared store); any other layout element by
// element, pixels fastest when the channels are not, so that neighbouring
// threads read neighbouring addresses either way. No cp.async pipeline
// and no wgmma yet: loads and products overlap only across the two or
// three blocks an SM holds.
//
// What bounds it on the card: the tensor cores at the large sites (an
// R50 3x3 site at 104^2 does 2 * M * N * K = 13.6 G int8 operations a
// sample, 7 us at 1,979 TOPS) and device memory at the 1x1 ones. This
// body reaches neither: it issues more instructions gathering and
// quantising than the tensor cores need to multiply (chip_smoke.py phase
// 18 times each site against both bounds).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBM = 128, kBN = 128, kBK = 32, kThreads = 256;
constexpr int kRow = 48;  // bytes a row of a shared tile takes (32 + pad)
constexpr int kFar = 1 << 28;  // an offset that lands outside any image

struct Conv {
  const void* x;
  const int8_t* w;
  const float* k_scale;
  const float* act_scale;
  const float* bias;
  void* out;
  int B, H, W, C, Ho, Wo, Co, kh, kw, stride, pad_t, pad_l, relu;
  long long xs_b, xs_h, xs_w, xs_c, os_b, os_h, os_w, os_c;
};

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

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

__device__ __forceinline__ void mma_s8(int* c, const uint32_t* a,
                                       const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// kVec: x is channels-last with C and the strides multiples of 8 and
// 16-byte aligned, so 8 channels of one tap are one vector load
template <typename Tin, typename Tout, bool kVec>
__global__ void __launch_bounds__(kThreads) int8_conv_kernel(Conv p) {
  __shared__ __align__(16) int8_t a_tile[kBM * kRow];  // [pixel][k]
  __shared__ __align__(16) int8_t b_tile[kBN * kRow];  // [co][k]
  __shared__ long long pix_off[kBM], out_off[kBM];
  __shared__ int pix_y[kBM], pix_x[kBM];
  __shared__ long long k_off[kBK];
  __shared__ int k_dy[kBK], k_dx[kBK];

  const Tin* x = static_cast<const Tin*>(p.x);
  const int tid = threadIdx.x;
  const int M = p.B * p.Ho * p.Wo;
  const int K = p.kh * p.kw * p.C;
  const int m0 = blockIdx.x * kBM, n0 = blockIdx.y * kBN;
  const float s = *p.act_scale;

  if (tid < kBM) {
    const int m = m0 + tid;
    if (m < M) {
      const int ox = m % p.Wo, t = m / p.Wo, oy = t % p.Ho, b = t / p.Ho;
      const int iy = oy * p.stride - p.pad_t, ix = ox * p.stride - p.pad_l;
      pix_y[tid] = iy;
      pix_x[tid] = ix;
      pix_off[tid] = b * p.xs_b + iy * p.xs_h + ix * p.xs_w;
      out_off[tid] = b * p.os_b + oy * p.os_h + ox * p.os_w;
    } else {
      pix_y[tid] = -kFar;
      pix_x[tid] = -kFar;
      pix_off[tid] = 0;
      out_off[tid] = -1;
    }
  }

  const int warp = tid / 32, lane = tid % 32, g = lane / 4, tig = lane % 4;
  const int wm = (warp / 2) * 32, wn = (warp % 2) * 64;
  // channels-last input: channels fastest; otherwise pixels fastest
  const bool pixels_fastest = p.xs_c != 1;
  const bool w_vec = p.Co % 16 == 0;
  int acc[2][8][4] = {};

  for (int k0 = 0; k0 < K; k0 += kBK) {
    __syncthreads();  // the last step's fragments are read
    if (!kVec && tid < kBK) {
      const int k = k0 + tid;
      if (k < K) {
        const int ci = k % p.C, t = k / p.C, kx = t % p.kw, ky = t / p.kw;
        k_dy[tid] = ky;
        k_dx[tid] = kx;
        k_off[tid] = ky * p.xs_h + kx * p.xs_w + ci * p.xs_c;
      } else {
        k_dy[tid] = kFar;
        k_dx[tid] = kFar;
        k_off[tid] = 0;
      }
    }
    {  // weights: 16 consecutive output channels of one k row a thread
      const int kk = tid / 8, nn = (tid % 8) * 16, k = k0 + kk;
      int8_t v[16];
      if (k < K && w_vec && n0 + nn + 16 <= p.Co) {
        const int4 q = *reinterpret_cast<const int4*>(
            p.w + (long long)k * p.Co + n0 + nn);
        *reinterpret_cast<int4*>(v) = q;
      } else {
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          const int n = n0 + nn + j;
          v[j] = (k < K && n < p.Co) ? p.w[(long long)k * p.Co + n] : 0;
        }
      }
#pragma unroll
      for (int j = 0; j < 16; ++j) b_tile[(nn + j) * kRow + kk] = v[j];
    }
    if constexpr (kVec) {
#pragma unroll
      for (int j = 0; j < kBM * kBK / 8 / kThreads; ++j) {
        const int c = tid + j * kThreads;
        const int mm = c / (kBK / 8), kk = (c % (kBK / 8)) * 8, k = k0 + kk;
        uint2 q = make_uint2(0, 0);
        if (k < K) {
          const int ci = k % p.C, t = k / p.C, kx = t % p.kw, ky = t / p.kw;
          const int iy = pix_y[mm] + ky, ix = pix_x[mm] + kx;
          if ((unsigned)iy < (unsigned)p.H && (unsigned)ix < (unsigned)p.W)
            q = load_q8<Tin>(x, pix_off[mm] + ky * p.xs_h + kx * p.xs_w + ci,
                             s);
        }
        *reinterpret_cast<uint2*>(a_tile + mm * kRow + kk) = q;
      }
    } else {
      __syncthreads();  // the k tables are written
#pragma unroll 4
      for (int j = 0; j < kBM * kBK / kThreads; ++j) {
        const int i = tid + j * kThreads;
        const int mm = pixels_fastest ? i % kBM : i / kBK;
        const int kk = pixels_fastest ? i / kBM : i % kBK;
        const int iy = pix_y[mm] + k_dy[kk], ix = pix_x[mm] + k_dx[kk];
        int8_t q = 0;
        if ((unsigned)iy < (unsigned)p.H && (unsigned)ix < (unsigned)p.W)
          q = load_q<Tin>(x, pix_off[mm] + k_off[kk], s);
        a_tile[mm * kRow + kk] = q;
      }
    }
    __syncthreads();  // both tiles are written

    uint32_t af[2][4], bf[8][2];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      const int8_t* r0 = a_tile + (wm + mt * 16 + g) * kRow + tig * 4;
      const int8_t* r8 = r0 + 8 * kRow;
      af[mt][0] = *reinterpret_cast<const uint32_t*>(r0);
      af[mt][1] = *reinterpret_cast<const uint32_t*>(r8);
      af[mt][2] = *reinterpret_cast<const uint32_t*>(r0 + 16);
      af[mt][3] = *reinterpret_cast<const uint32_t*>(r8 + 16);
    }
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const int8_t* c = b_tile + (wn + nt * 8 + g) * kRow + tig * 4;
      bf[nt][0] = *reinterpret_cast<const uint32_t*>(c);
      bf[nt][1] = *reinterpret_cast<const uint32_t*>(c + 16);
    }
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) mma_s8(acc[mt][nt], af[mt], bf[nt]);
  }

  Tout* out = static_cast<Tout*>(p.out);
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = wm + mt * 16 + g + (i / 2) * 8;
        const int n = n0 + wn + nt * 8 + tig * 2 + (i % 2);
        const long long o = out_off[row];
        if (o < 0 || n >= p.Co) continue;
        float y = __fmul_rn(__int2float_rn(acc[mt][nt][i]),
                            __fmul_rn(s, p.k_scale[n]));
        if (p.bias != nullptr) y = __fadd_rn(y, p.bias[n]);
        if (p.relu) y = fmaxf(y, 0.0f);
        store(out + o + n * p.os_c, y);
      }
}

template <typename Tin, bool kVec>
cudaError_t launch_in(const Conv& p, int out_dtype, cudaStream_t st) {
  const int M = p.B * p.Ho * p.Wo;
  dim3 grid((M + kBM - 1) / kBM, (p.Co + kBN - 1) / kBN);
  if (out_dtype == 0)
    int8_conv_kernel<Tin, float, kVec><<<grid, kThreads, 0, st>>>(p);
  else
    int8_conv_kernel<Tin, __nv_bfloat16, kVec><<<grid, kThreads, 0, st>>>(p);
  return cudaGetLastError();
}

template <typename Tin>
cudaError_t launch(const Conv& p, int out_dtype, cudaStream_t st) {
  const bool vec = p.xs_c == 1 && p.C % 8 == 0 && p.xs_w % 8 == 0 &&
                   p.xs_h % 8 == 0 && p.xs_b % 8 == 0 &&
                   reinterpret_cast<uintptr_t>(p.x) % 16 == 0;
  return vec ? launch_in<Tin, true>(p, out_dtype, st)
             : launch_in<Tin, false>(p, out_dtype, st);
}

}  // namespace

// Plain C entry point, bound with ctypes. x (B, H, W, C) and out (B, Ho,
// Wo, Co) are device pointers with the given element strides; w (kh, kw,
// C, Co) int8 contiguous and 16-byte aligned; k_scale, bias (Co) and
// act_scale (1) f32, bias may be null. in_dtype 0 = f32, 1 = bf16, 2 =
// int8; out_dtype 0 = f32, 1 = bf16. Kernels 1..3 a side, stride 1 or 2,
// paddings below the kernel's size. Returns the launch's cudaError_t.
extern "C" int cris_int8_conv(const void* x, const void* w,
                              const void* k_scale, const void* act_scale,
                              const void* bias, void* out, int B, int H,
                              int W, int C, int Ho, int Wo, int Co, int kh,
                              int kw, int stride, int pad_t, int pad_l,
                              int in_dtype, int out_dtype, int relu,
                              long long xs_b, long long xs_h, long long xs_w,
                              long long xs_c, long long os_b, long long os_h,
                              long long os_w, long long os_c, void* stream) {
  if (B < 1 || H < 1 || W < 1 || C < 1 || Ho < 1 || Wo < 1 || Co < 1 ||
      kh < 1 || kh > 3 || kw < 1 || kw > 3 || stride < 1 || stride > 2 ||
      pad_t < 0 || pad_t >= kh || pad_l < 0 || pad_l >= kw ||
      (long long)B * Ho * Wo > 0x7fffffffLL || out_dtype < 0 || out_dtype > 1)
    return (int)cudaErrorInvalidValue;
  Conv p{x, static_cast<const int8_t*>(w), static_cast<const float*>(k_scale),
         static_cast<const float*>(act_scale), static_cast<const float*>(bias),
         out, B, H, W, C, Ho, Wo, Co, kh, kw, stride, pad_t, pad_l, relu,
         xs_b, xs_h, xs_w, xs_c, os_b, os_h, os_w, os_c};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (in_dtype == 0) return (int)launch<float>(p, out_dtype, st);
  if (in_dtype == 1) return (int)launch<__nv_bfloat16>(p, out_dtype, st);
  if (in_dtype == 2) return (int)launch<int8_t>(p, out_dtype, st);
  return (int)cudaErrorInvalidValue;
}
