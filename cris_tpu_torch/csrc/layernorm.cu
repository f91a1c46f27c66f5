// K6: LayerNorm over the last axis, forward and backward.
//
// Replaces the TPU kernels of `layer_norm` (cris_tpu/ops/pallas/
// layernorm.py:77): the forward `pallas_call` at :92 (body `_fwd_kernel`
// at :40) and the backward one at :123 (body `_bwd_kernel` at :49). Same
// math and rounding points, all in f32 on the input's values:
//   mean = sum(x) / C, xc = x - mean, var = sum(xc * xc) / C (centred and
//   biased, not E[x^2] - mean^2), rstd = rsqrt(var + eps), xhat = xc * rstd
//   forward:  y = xhat * scale + bias, rounded once to x's dtype
//   backward: gs = g * scale,
//             dx = rstd * (gs - mean(gs) - xhat * mean(gs * xhat)),
//             dscale = sum over rows of g * xhat, dbias = sum of g
// scale and bias are f32; x, g, y and dx are f32 or bf16.
//
// Design for Hopper (not the TPU's 512-row VMEM blocks):
// - A row is held in registers: 16 values per thread, read and written as
//   16-byte vectors (4 f32 or 8 bf16), neighbouring threads on
//   neighbouring vectors. One warp holds 512 columns, so a row of C
//   columns takes ceil(C / 512) warps (a row group): the decoder's 512-wide
//   LNs one warp a row, 8 rows a 256-thread block; the FFN's 2048-wide LN
//   4 warps a row. Row sums are xor-shuffles within a warp and, across a
//   group's warps, a pass through shared memory. The row is read from
//   device memory once per direction.
// - The backward walks a contiguous chunk of rows per block (the wrapper
//   picks the chunk so that at most 264 blocks, two per SM, run). Each
//   thread owns the same columns in every row of its group, so it keeps
//   the running dscale and dbias of its columns in registers; at the end
//   the block's groups add theirs in a fixed order through shared memory
//   and the block writes one f32 partial row of each, (nb, C) in all. The
//   wrapper sums the partials with torch.sum, as the JAX wrapper sums its
//   (nb, 8, C) partials (layernorm.py:149). No atomics: the result is the
//   same bits on every run.
//
// What bounds it on the card: device memory. The forward reads x and
// writes y; the backward reads x and g and writes dx (the scale, bias and
// partial rows are a few hundred KB at most, from L2): at 10 816 x 512 bf16
// that is 22 MB and 33 MB, 6.6 and 9.9 us at 3.35 TB/s; its f32 arithmetic
// is about 10 operations a value, far below the card's 67 TFLOP/s.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kPerLane = 16;          // values a thread holds of a row
constexpr int kWarpCols = 32 * kPerLane;  // columns a warp holds
constexpr int kMaxThreads = 512;      // a block; a row group of 16 warps at most
constexpr int kGroupThreads = 256;    // a block of row groups of <= 8 warps

// 16 bytes of T: 4 f32 or 8 bf16
template <typename T>
struct Vec {
  static constexpr int n = 16 / sizeof(T);
};

template <typename T>
__device__ __forceinline__ void load_vec(const T* p, float* v) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  if constexpr (std::is_same<T, float>::value) {
    v[0] = __uint_as_float(raw.x);
    v[1] = __uint_as_float(raw.y);
    v[2] = __uint_as_float(raw.z);
    v[3] = __uint_as_float(raw.w);
  } else {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      v[2 * i] = f.x;
      v[2 * i + 1] = f.y;
    }
  }
}

template <typename T>
__device__ __forceinline__ void store_vec(T* p, const float* v) {
  uint4 raw;
  if constexpr (std::is_same<T, float>::value) {
    raw.x = __float_as_uint(v[0]);
    raw.y = __float_as_uint(v[1]);
    raw.z = __float_as_uint(v[2]);
    raw.w = __float_as_uint(v[3]);
  } else {
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
  }
  *reinterpret_cast<uint4*>(p) = raw;
}

// The f32 values p[0 .. n) (n a multiple of 4, p 16-byte aligned)
template <int N>
__device__ __forceinline__ void load_f32(const float* p, float* v) {
#pragma unroll
  for (int i = 0; i < N / 4; ++i) {
    const float4 f = reinterpret_cast<const float4*>(p)[i];
    v[4 * i] = f.x;
    v[4 * i + 1] = f.y;
    v[4 * i + 2] = f.z;
    v[4 * i + 3] = f.w;
  }
}

// Where a thread sits: a row group of 32 * wpr threads holds one row
struct Place {
  int rt, groups, group, t;
  __device__ Place(int wpr)
      : rt(32 * wpr),
        groups(blockDim.x / (32 * wpr)),
        group(threadIdx.x / (32 * wpr)),
        t(threadIdx.x % (32 * wpr)) {}
  // the first column of this thread's j-th vector of V values
  __device__ int col(int j, int V) const { return (j * rt + t) * V; }
};

// Sums each v[n] over the row group's threads; every thread gets the sums.
// Every thread of the block calls it, the same number of times.
template <int N>
__device__ __forceinline__ void row_sum(float (&v)[N], float* red, int wpr) {
#pragma unroll
  for (int n = 0; n < N; ++n)
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      v[n] += __shfl_xor_sync(0xffffffffu, v[n], off);
  if (wpr > 1) {
    const int warp = threadIdx.x >> 5;
    const int first = warp - warp % wpr;  // the group's first warp
    if ((threadIdx.x & 31) == 0)
#pragma unroll
      for (int n = 0; n < N; ++n) red[warp * N + n] = v[n];
    __syncthreads();
#pragma unroll
    for (int n = 0; n < N; ++n) {
      float s = 0.f;
      for (int w = 0; w < wpr; ++w) s += red[(first + w) * N + n];
      v[n] = s;
    }
    __syncthreads();  // red is reused by the next call
  }
}

// Loads a row (zeros where col >= C or the row is inactive) and returns
// its statistics: xc = x - mean in place (0 outside the row), and rstd.
template <typename T, int NV>
__device__ __forceinline__ float centre(const T* row, bool active, int C,
                                        const Place& at, float (&x)[NV][Vec<T>::n],
                                        float eps, float* red, int wpr) {
  constexpr int V = Vec<T>::n;
  float s[1] = {0.f};
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const int c = at.col(j, V);
    if (active && c < C) {
      load_vec(row + c, x[j]);
    } else {
#pragma unroll
      for (int e = 0; e < V; ++e) x[j][e] = 0.f;
    }
#pragma unroll
    for (int e = 0; e < V; ++e) s[0] += x[j][e];
  }
  row_sum(s, red, wpr);
  const float mean = s[0] / C;
  float q[1] = {0.f};
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    if (at.col(j, V) >= C) continue;
#pragma unroll
    for (int e = 0; e < V; ++e) {
      x[j][e] -= mean;
      q[0] += x[j][e] * x[j][e];
    }
  }
  row_sum(q, red, wpr);
  return rsqrtf(q[0] / C + eps);
}

template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
layer_norm_fwd_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                      const float* __restrict__ bias, T* __restrict__ y,
                      int rows, int C, int wpr, float eps) {
  constexpr int V = Vec<T>::n, NV = kPerLane / V;
  __shared__ float red[kMaxThreads / 32];
  const Place at(wpr);
  const long long row = (long long)blockIdx.x * at.groups + at.group;
  const bool active = row < rows;
  float v[NV][V];
  const float rstd = centre<T, NV>(x + row * C, active, C, at, v, eps, red, wpr);
  if (!active) return;
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const int c = at.col(j, V);
    if (c >= C) continue;
    float sc[V], bi[V];
    load_f32<V>(scale + c, sc);
    load_f32<V>(bias + c, bi);
#pragma unroll
    for (int e = 0; e < V; ++e) v[j][e] = v[j][e] * rstd * sc[e] + bi[e];
    store_vec(y + row * C + c, v[j]);
  }
}

template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
layer_norm_bwd_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                      const T* __restrict__ g, T* __restrict__ dx,
                      float* __restrict__ dscale_part,
                      float* __restrict__ dbias_part, int rows, int C, int wpr,
                      int chunk, float eps) {
  constexpr int V = Vec<T>::n, NV = kPerLane / V;
  __shared__ float red[2 * kMaxThreads / 32];
  extern __shared__ float part[];  // [groups][2][C] when groups > 1
  const Place at(wpr);
  const long long start = (long long)blockIdx.x * chunk;
  const long long end = min(start + chunk, (long long)rows);
  float ds[NV][V], db[NV][V];
#pragma unroll
  for (int j = 0; j < NV; ++j)
#pragma unroll
    for (int e = 0; e < V; ++e) ds[j][e] = db[j][e] = 0.f;

  const int iters = (chunk + at.groups - 1) / at.groups;
  for (int it = 0; it < iters; ++it) {
    const long long row = start + (long long)it * at.groups + at.group;
    const bool active = row < end;
    float xh[NV][V], gs[NV][V];
    const float rstd =
        centre<T, NV>(x + row * C, active, C, at, xh, eps, red, wpr);
    float m[2] = {0.f, 0.f};  // sum(gs), sum(gs * xhat)
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      const int c = at.col(j, V);
      float gv[V], sc[V];
      if (active && c < C) {
        load_vec(g + row * C + c, gv);
        load_f32<V>(scale + c, sc);
      } else {
#pragma unroll
        for (int e = 0; e < V; ++e) gv[e] = sc[e] = 0.f;
      }
#pragma unroll
      for (int e = 0; e < V; ++e) {
        xh[j][e] *= rstd;
        gs[j][e] = gv[e] * sc[e];
        m[0] += gs[j][e];
        m[1] += gs[j][e] * xh[j][e];
        ds[j][e] += gv[e] * xh[j][e];
        db[j][e] += gv[e];
      }
    }
    row_sum(m, red, wpr);
    if (!active) continue;
    const float mg = m[0] / C, mgx = m[1] / C;
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      const int c = at.col(j, V);
      if (c >= C) continue;
#pragma unroll
      for (int e = 0; e < V; ++e)
        gs[j][e] = rstd * (gs[j][e] - mg - xh[j][e] * mgx);
      store_vec(dx + row * C + c, gs[j]);
    }
  }

  float* ds_out = dscale_part + (long long)blockIdx.x * C;
  float* db_out = dbias_part + (long long)blockIdx.x * C;
  float* mine = at.groups > 1 ? part + (size_t)at.group * 2 * C : nullptr;
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const int c = at.col(j, V);
    if (c >= C) continue;
#pragma unroll
    for (int e = 0; e < V; ++e) {
      if (mine) {
        mine[c + e] = ds[j][e];
        mine[C + c + e] = db[j][e];
      } else {
        ds_out[c + e] = ds[j][e];
        db_out[c + e] = db[j][e];
      }
    }
  }
  if (at.groups == 1) return;
  __syncthreads();
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    float a = 0.f, b = 0.f;
    for (int k = 0; k < at.groups; ++k) {  // groups in order: deterministic
      a += part[(size_t)k * 2 * C + c];
      b += part[(size_t)k * 2 * C + C + c];
    }
    ds_out[c] = a;
    db_out[c] = b;
  }
}

// Row groups of wpr warps: 256-thread blocks of 8 / wpr groups while a
// group fits, else one group of wpr warps a block
int block_threads(int wpr) {
  return 32 * wpr <= kGroupThreads ? kGroupThreads - kGroupThreads % (32 * wpr)
                                   : 32 * wpr;
}

template <typename T>
cudaError_t launch_fwd(const void* x, const void* scale, const void* bias,
                       void* y, int rows, int C, float eps,
                       cudaStream_t stream) {
  const int wpr = (C + kWarpCols - 1) / kWarpCols;
  const int threads = block_threads(wpr);
  const int groups = threads / (32 * wpr);
  layer_norm_fwd_kernel<T><<<(rows + groups - 1) / groups, threads, 0,
                             stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(scale),
      static_cast<const float*>(bias), static_cast<T*>(y), rows, C, wpr, eps);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_bwd(const void* x, const void* scale, const void* g,
                       void* dx, void* dscale_part, void* dbias_part, int rows,
                       int C, int blocks, int chunk, float eps,
                       cudaStream_t stream) {
  const int wpr = (C + kWarpCols - 1) / kWarpCols;
  const int threads = block_threads(wpr);
  const int groups = threads / (32 * wpr);
  const size_t smem = groups > 1 ? sizeof(float) * groups * 2 * C : 0;
  layer_norm_bwd_kernel<T><<<blocks, threads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(scale),
      static_cast<const T*>(g), static_cast<T*>(dx),
      static_cast<float*>(dscale_part), static_cast<float*>(dbias_part), rows,
      C, wpr, chunk, eps);
  return cudaGetLastError();
}

bool bad_shape(int rows, int C) {
  return rows < 1 || C < 1 || C % 128 != 0 ||
         C > kWarpCols * (kMaxThreads / 32);
}

}  // namespace

// Plain C entry points, bound with ctypes. Pointers are device pointers to
// contiguous, 16-byte aligned memory: x, y, g, dx (rows, C) in the dtype
// (0 = float32, 1 = bfloat16); scale, bias (C) f32; the partials (blocks,
// C) f32. C is a multiple of 128 up to 8192. The backward's block b sums
// rows [b * chunk, min((b + 1) * chunk, rows)). Each returns the
// cudaError_t of the launch.
extern "C" int cris_layer_norm_fwd(const void* x, const void* scale,
                                   const void* bias, void* y, int rows, int C,
                                   int dtype, float eps, void* stream) {
  if (bad_shape(rows, C)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)launch_fwd<float>(x, scale, bias, y, rows, C, eps, st);
  if (dtype == 1)
    return (int)launch_fwd<__nv_bfloat16>(x, scale, bias, y, rows, C, eps, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" int cris_layer_norm_bwd(const void* x, const void* scale,
                                   const void* g, void* dx, void* dscale_part,
                                   void* dbias_part, int rows, int C,
                                   int blocks, int chunk, int dtype, float eps,
                                   void* stream) {
  if (bad_shape(rows, C) || blocks < 1 || chunk < 1 ||
      (long long)blocks * chunk < rows)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)launch_bwd<float>(x, scale, g, dx, dscale_part, dbias_part,
                                  rows, C, blocks, chunk, eps, st);
  if (dtype == 1)
    return (int)launch_bwd<__nv_bfloat16>(x, scale, g, dx, dscale_part,
                                          dbias_part, rows, C, blocks, chunk,
                                          eps, st);
  return (int)cudaErrorInvalidValue;
}
