// K6: LayerNorm over the last axis, forward and backward.
//
// Replaces the TPU kernels of `layer_norm` (cris_tpu/ops/pallas/
// layernorm.py:77): the forward `pallas_call` at :92 (body `_fwd_kernel`
// at :40) and the backward one at :123 (body `_bwd_kernel` at :49, the
// wrapper's sum of its partial rows at :149). Same math and rounding
// points, all in f32 on the input's values:
//   mean = sum(x) / C, xc = x - mean, var = sum(xc * xc) / C (centred and
//   biased, not E[x^2] - mean^2), rstd = rsqrt(var + eps), xhat = xc * rstd
//   forward:  y = xhat * scale + bias, rounded once to x's dtype
//   backward: gs = g * scale,
//             dx = rstd * (gs - mean(gs) - xhat * mean(gs * xhat)),
//             dscale = sum over rows of g * xhat, dbias = sum of g
// scale and bias are f32; x, g, y and dx are f32 or bf16.
//
// The forward (not the TPU's 512-row VMEM blocks): a row is held in
// registers, 16 values per thread, read and written as 16-byte vectors (4
// f32 or 8 bf16), neighbouring threads on neighbouring vectors. One warp
// holds 512 columns, so a row of C columns takes ceil(C / 512) warps (a row
// group): the decoder's 512-wide LNs one warp a row, 8 rows a 256-thread
// block; the FFN's 2048-wide LN 4 warps a row. Row sums are xor-shuffles
// within a warp and, across a group's warps, a pass through shared memory.
// It reads x once and writes y once.
//
// The backward, for Hopper's memory system:
// - A persistent, cooperative grid of min(SMs, tiles) blocks. The wrapper
//   cuts the rows into tiles of R contiguous rows; block b walks tiles b,
//   b + grid, ... in order. R, the stages S and the grid depend only on
//   (rows, C, dtype, SMs) (`backward_partition`, ops/kernels/
//   layernorm.py).
// - A ring of S shared-memory stages fed by TMA: one producer thread copies
//   a tile's x and g with one bulk copy each (a row block is contiguous;
//   the scale comes with the first tile), each stage with a full, a
//   statistics and an empty mbarrier. The bytes in flight come from the
//   ring (S x about 32 KB), not from registers.
// - One warp a row at every width: 8 row warps take the block's rows in
//   turn and read each from its stage: at C <= 1024 once, into registers
//   (bf16 converted by shifts), else once a pass. Passes for the mean, the
//   centred variance, mean(gs) and mean(gs * xhat), then dx; row sums are
//   warp shuffles only; dx goes out in 16-byte stores, each row's (mean,
//   rstd) to shared memory. No block barrier per row.
// - dscale and dbias by a column sweep: once a stage's statistics are in,
//   8 sweep warps read the stage by columns; each thread owns fixed 16-byte
//   column vectors and sums g * xhat and g over all the block's tiles in
//   registers (where a row has fewer vectors than the sweep has threads,
//   groups of threads take every groups-th row and are added in group
//   order), then writes one f32 partial row of each, (2, grid, C) in all.
//   Where a lane holds at most 16 values of a row (C <= 512) and a tile
//   has 8 rows or more (the decoder's LNs), the schedule is fused: all 16
//   warps take rows and sum g * xhat and g of their lanes' columns in
//   registers as they go, and the warps' partial rows are added in warp
//   order; a row warp is latency-bound, so twice the warps on rows beat
//   the sweep.
// - One deterministic finish: the blocks meet at a counter (an integer
//   add each; no float atomics), then each sums its share of the columns
//   over the partial rows, a warp a column: each lane every 32nd block in
//   block order, all loads in flight at once, then the lanes by a fixed
//   xor butterfly. The same bits on every call. The counter is the
//   caller's, one per stream and grid size.
//
// What bounds it on the card: device memory. The forward reads x and
// writes y; the backward reads x and g and writes dx (scale and the
// partial rows are a few hundred KB at most, from L2): at 10 816 x 512 bf16
// that is 22 MB and 33 MB, 6.6 and 9.9 us at 3.35 TB/s; its f32 arithmetic
// is about 20 operations a value, far below the card's 67 TFLOP/s. What
// holds the backward from that bound (PERF.md): each row is a chain of
// three warp reductions, so a warp takes about a microsecond a row, and
// the blocks' meeting and the finish add a few microseconds at the end.

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

// ------------------------------------------------------------ backward

constexpr int kRowWarps = 8;     // warps that take rows: statistics and dx
constexpr int kSweepWarps = 8;   // warps that sweep columns: dscale, dbias
constexpr int kSweepThreads = 32 * kSweepWarps;
constexpr int kBwdThreads = 32 * (kRowWarps + kSweepWarps + 1);  // + producer
// where a lane holds at most 16 values of a row (C <= 512) and a tile has
// at least kRowWarps rows, all 16 consumer warps take rows and sum dscale
// and dbias themselves, with no sweep (fused)
constexpr int kFusedWarps = kRowWarps + kSweepWarps;
constexpr int kFusedMaxC = 512;
constexpr int kMaxStages = 4;
constexpr int kSweepValues = 32;  // columns a sweep thread holds at most
constexpr int kMaxRun = 8;  // blocks a lane of the finish adds, at most
constexpr size_t kMaxSmem = 232448;  // dynamic shared memory of a block
// a wait on the ring or the other blocks that outlasts this traps: a fault
// the caller sees, never a hung card
constexpr unsigned long long kWaitLimitNs = 2000000000ull;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ unsigned long long now_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
  return t;
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ bool mbar_done(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n"
      "}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done;
}

// Wait until the phase of the given parity has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_done(bar, parity)) return;
  const unsigned long long t0 = now_ns();
  while (!mbar_done(bar, parity))
    if (now_ns() - t0 > kWaitLimitNs) __trap();
}

// One bulk copy of bytes (a multiple of 16) from global to shared memory;
// completion is reported to bar as transferred bytes.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

__device__ __forceinline__ unsigned long long ld_acquire(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.acquire.gpu.global.u64 %0, [%1];\n"
               : "=l"(v)
               : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ unsigned long long add_acq_rel(
    unsigned long long* p, unsigned long long v) {
  unsigned long long old;
  asm volatile("atom.acq_rel.gpu.global.add.u64 %0, [%1], %2;\n"
               : "=l"(old)
               : "l"(p), "l"(v)
               : "memory");
  return old;
}

// 16 bytes of T to floats and back, for the backward: bf16 by shifts and a
// cvt.rn.bf16x2.f32 a pair (load_vec's and store_vec's bits), all in
// registers.
template <typename T>
__device__ __forceinline__ void load16(const T* p, float* v) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if constexpr (std::is_same<T, float>::value) {
      v[i] = __uint_as_float(w[i]);
    } else {
      v[2 * i] = __uint_as_float(w[i] << 16);
      v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
}

template <typename T>
__device__ __forceinline__ void store16(T* p, const float* v) {
  uint32_t w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if constexpr (std::is_same<T, float>::value)
      w[i] = __float_as_uint(v[i]);
    else
      asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n"
          : "=r"(w[i])
          : "f"(v[2 * i + 1]), "f"(v[2 * i]));
  }
  *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
}

// Sums each v[n] over the warp; every lane gets the same bits.
template <int N>
__device__ __forceinline__ void warp_sums(float (&v)[N]) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
#pragma unroll
    for (int n = 0; n < N; ++n) v[n] += __shfl_xor_sync(0xffffffffu, v[n], off);
}

// x / C as the rows' means need it: a multiply where C is a power of two
// (the same bits), else the division.
__device__ __forceinline__ float over(float x, int C) {
  return (C & (C - 1)) == 0 ? x * (1.f / C) : x / C;
}

// One row by one warp, read from the ring, the scale from shared memory:
// the row's statistics, then its dx written to device memory in 16-byte
// stores. Returns (mean, rstd). Each lane holds its NV vectors of the row
// (j = lane + 32 u) in registers, converted once; a lane's sums run in two
// chains (even and odd columns of a vector), added at the end. With ACC
// the lane also adds g * xhat and g of its columns to ds and db.
template <typename T, int NV, bool ACC>
__device__ __forceinline__ float2 bwd_row(const T* xs, const T* gs,
                                          const float* sc_s,
                                          T* __restrict__ dxr, int C, int lane,
                                          float eps,
                                          float (&ds)[NV][Vec<T>::n],
                                          float (&db)[NV][Vec<T>::n]) {
  constexpr int V = Vec<T>::n;
  const int nvec = C / V;
  float xc[NV][V];   // x - mean, then xhat
  float gsc[NV][V];  // g, then g * scale, then dx
  float a[2] = {0.f, 0.f}, m[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int u = 0; u < NV; ++u) {
    const int j = lane + 32 * u;
    if (j < nvec) {
      load16(xs + j * V, xc[u]);
      load16(gs + j * V, gsc[u]);
#pragma unroll
      for (int e = 0; e < V; ++e) a[e & 1] += xc[u][e];
    }
  }
  float s[1] = {a[0] + a[1]};
  warp_sums(s);
  const float mean = over(s[0], C);
  a[0] = a[1] = 0.f;
#pragma unroll
  for (int u = 0; u < NV; ++u)
    if (lane + 32 * u < nvec)
#pragma unroll
      for (int e = 0; e < V; ++e) {
        xc[u][e] -= mean;
        a[e & 1] += xc[u][e] * xc[u][e];
      }
  s[0] = a[0] + a[1];
  warp_sums(s);
  const float rstd = rsqrtf(over(s[0], C) + eps);
#pragma unroll
  for (int u = 0; u < NV; ++u) {
    const int j = lane + 32 * u;
    if (j < nvec) {
      float sc[V];
      load_f32<V>(sc_s + j * V, sc);
#pragma unroll
      for (int e = 0; e < V; ++e) {
        xc[u][e] *= rstd;
        if constexpr (ACC) {
          ds[u][e] += gsc[u][e] * xc[u][e];
          db[u][e] += gsc[u][e];
        }
        gsc[u][e] *= sc[e];
        m[e & 1] += gsc[u][e];                    // sum(gs)
        m[2 + (e & 1)] += gsc[u][e] * xc[u][e];  // sum(gs * xhat)
      }
    }
  }
  float mm[2] = {m[0] + m[1], m[2] + m[3]};
  warp_sums(mm);
  const float mg = over(mm[0], C), mgx = over(mm[1], C);
#pragma unroll
  for (int u = 0; u < NV; ++u) {
    const int j = lane + 32 * u;
    if (j < nvec) {
#pragma unroll
      for (int e = 0; e < V; ++e)
        gsc[u][e] = rstd * (gsc[u][e] - mg - xc[u][e] * mgx);
      store16(dxr + j * V, gsc[u]);
    }
  }
  return make_float2(mean, rstd);
}

// One row wider than the registers hold (C > 1024), read from the stage
// again in every pass; otherwise as bwd_row.
template <typename T>
__device__ __forceinline__ float2 bwd_row_streamed(const T* xs, const T* gs,
                                                   const float* sc_s,
                                                   T* __restrict__ dxr, int C,
                                                   int lane, float eps) {
  constexpr int V = Vec<T>::n;
  const int nvec = C / V;
  float s[1] = {0.f}, m[2] = {0.f, 0.f};
  for (int j = lane; j < nvec; j += 32) {
    float v[V];
    load16(xs + j * V, v);
#pragma unroll
    for (int e = 0; e < V; ++e) s[0] += v[e];
  }
  warp_sums(s);
  const float mean = over(s[0], C);
  s[0] = 0.f;
  for (int j = lane; j < nvec; j += 32) {
    float v[V];
    load16(xs + j * V, v);
#pragma unroll
    for (int e = 0; e < V; ++e) {
      const float d = v[e] - mean;
      s[0] += d * d;
    }
  }
  warp_sums(s);
  const float rstd = rsqrtf(over(s[0], C) + eps);
  for (int j = lane; j < nvec; j += 32) {
    float xv[V], gv[V], sc[V];
    load16(xs + j * V, xv);
    load16(gs + j * V, gv);
    load_f32<V>(sc_s + j * V, sc);
#pragma unroll
    for (int e = 0; e < V; ++e) {
      const float xh = (xv[e] - mean) * rstd, gsc = gv[e] * sc[e];
      m[0] += gsc;
      m[1] += gsc * xh;
    }
  }
  warp_sums(m);
  const float mg = over(m[0], C), mgx = over(m[1], C);
  for (int j = lane; j < nvec; j += 32) {
    float xv[V], gv[V], sc[V];
    load16(xs + j * V, xv);
    load16(gs + j * V, gv);
    load_f32<V>(sc_s + j * V, sc);
#pragma unroll
    for (int e = 0; e < V; ++e) {
      const float xh = (xv[e] - mean) * rstd, gsc = gv[e] * sc[e];
      xv[e] = rstd * (gsc - mg - xh * mgx);
    }
    store16(dxr + j * V, xv);
  }
  return make_float2(mean, rstd);
}

// Shared memory: the ring (S stages of R rows of x, then R rows of g), the
// scale, 3 S mbarriers, S R row statistics, and the partial rows that are
// added in order into the block's: each row warp's where they sum dscale
// and dbias (fused), else each sweep group's where the sweep splits the
// rows among groups of threads.
__host__ __device__ inline int sweep_groups(int nvec) {
  return nvec >= kSweepThreads ? 1 : kSweepThreads / nvec;
}

__host__ __device__ inline size_t bwd_smem_bytes(int C, int R, int S, int elem,
                                                 bool fused) {
  const int groups = fused ? kFusedWarps : sweep_groups(C * elem / 16);
  return (size_t)S * 2 * R * C * elem + sizeof(float) * C +
         3 * S * sizeof(uint64_t) + (size_t)S * R * sizeof(float2) +
         (groups > 1 ? (size_t)groups * 2 * C * sizeof(float) : 0);
}

template <typename T, int NV, bool FUSED>
__global__ void __launch_bounds__(kBwdThreads, 1)
layer_norm_bwd_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                      const T* __restrict__ g, T* __restrict__ dx,
                      float* __restrict__ sums, float* __restrict__ part,
                      unsigned long long* __restrict__ sync, int rows, int C,
                      int R, int S, float eps) {
  // a sweep thread's column vectors: at most one where the rows fit the
  // registers (C <= 1024: 256 vectors or fewer), else up to kSweepValues
  // columns
  constexpr int V = Vec<T>::n, NS = NV > 0 ? 1 : kSweepValues / V;
  constexpr int kRows = FUSED ? kFusedWarps : kRowWarps;  // row warps
  extern __shared__ __align__(128) unsigned char smem[];
  const int grid = gridDim.x, b = blockIdx.x;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const size_t half = (size_t)R * C * sizeof(T);  // one tensor's rows
  unsigned char* ring = smem;
  float* sc_s = reinterpret_cast<float*>(smem + (size_t)S * 2 * half);
  uint64_t* bars = reinterpret_cast<uint64_t*>(sc_s + C);
  // full[s] = bars[s] (the copies), stat[s] = bars[S + s] (the row warps),
  // empty[s] = bars[2 S + s] (the sweep warps, or the row warps if fused)
  float2* stats = reinterpret_cast<float2*>(bars + 3 * S);
  float* comb = reinterpret_cast<float*>(stats + S * R);
  const int tiles = (rows + R - 1) / R;
  const int nt = (tiles - b + grid - 1) / grid;  // tiles b, b + grid, ...
  const int nvec = C / V;

  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(smem_u32(bars + s), 1);
      mbar_init(smem_u32(bars + S + s), kRowWarps);
      mbar_init(smem_u32(bars + 2 * S + s), FUSED ? kRows : kSweepWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == kRowWarps + kSweepWarps) {
    // the producer: one thread keeps the ring full; the scale comes with
    // the first tile
    if (lane == 0) {
      for (int i = 0; i < nt; ++i) {
        const int s = i % S;
        if (i >= S) mbar_wait(smem_u32(bars + 2 * S + s), (i / S - 1) & 1);
        const long long r0 = ((long long)b + (long long)i * grid) * R;
        const int n = (int)min((long long)R, rows - r0);
        const uint32_t bytes = (uint32_t)((size_t)n * C * sizeof(T));
        const uint32_t full = smem_u32(bars + s);
        mbar_expect_tx(full, 2 * bytes + (i == 0 ? 4 * C : 0));
        if (i == 0) bulk_load(smem_u32(sc_s), scale, 4 * C, full);
        bulk_load(smem_u32(ring + s * 2 * half), x + r0 * C, bytes, full);
        bulk_load(smem_u32(ring + s * 2 * half + half), g + r0 * C, bytes,
                  full);
      }
    }
    __syncwarp();
  } else if (warp < kRows) {
    // the rows: the block's row slots i R + r go to the row warps in turn;
    // every row warp waits for every tile, so none runs a phase ahead
    float ds[NV > 0 ? NV : 1][V], db[NV > 0 ? NV : 1][V];
#pragma unroll
    for (int u = 0; u < (NV > 0 ? NV : 1); ++u)
#pragma unroll
      for (int e = 0; e < V; ++e) ds[u][e] = db[u][e] = 0.f;
    for (int i = 0; i < nt; ++i) {
      const int s = i % S;
      mbar_wait(smem_u32(bars + s), (i / S) & 1);
      const long long r0 = ((long long)b + (long long)i * grid) * R;
      const int n = (int)min((long long)R, rows - r0);
      const T* xs = reinterpret_cast<const T*>(ring + s * 2 * half);
      const T* gs = reinterpret_cast<const T*>(ring + s * 2 * half + half);
      for (int r = (warp - (i * R) % kRows + kRows) % kRows; r < n;
           r += kRows) {
        const T* xr = xs + (size_t)r * C;
        const T* gr = gs + (size_t)r * C;
        T* dxr = dx + (r0 + r) * C;
        float2 st;
        if constexpr (NV > 0)
          st = bwd_row<T, NV, FUSED>(xr, gr, sc_s, dxr, C, lane, eps, ds, db);
        else
          st = bwd_row_streamed<T>(xr, gr, sc_s, dxr, C, lane, eps);
        if (!FUSED && lane == 0) stats[s * R + r] = st;
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(smem_u32(bars + (FUSED ? 2 * S : S) + s));
    }
    if constexpr (FUSED) {
      // this warp's partial rows, added in warp order below
#pragma unroll
      for (int u = 0; u < NV; ++u) {
        const int j = lane + 32 * u;
        if (j < nvec)
#pragma unroll
          for (int e = 0; e < V; ++e) {
            comb[(size_t)2 * warp * C + j * V + e] = ds[u][e];
            comb[(size_t)(2 * warp + 1) * C + j * V + e] = db[u][e];
          }
      }
    }
  } else if constexpr (!FUSED) {
    // the column sweep: each thread owns fixed 16-byte column vectors and
    // sums g * xhat and g over the block's rows in order; where a row has
    // fewer vectors than the sweep has threads, groups of threads take
    // every groups-th row of a tile
    const int q = threadIdx.x - 32 * kRowWarps;
    const int groups = sweep_groups(nvec);
    const int grp = groups > 1 ? q / nvec : 0;
    const int first = groups > 1 ? q % nvec : q;
    float ds[NS][V], db[NS][V];
#pragma unroll
    for (int u = 0; u < NS; ++u)
#pragma unroll
      for (int e = 0; e < V; ++e) ds[u][e] = db[u][e] = 0.f;
    for (int i = 0; i < nt; ++i) {
      const int s = i % S;
      mbar_wait(smem_u32(bars + s), (i / S) & 1);
      mbar_wait(smem_u32(bars + S + s), (i / S) & 1);
      const long long r0 = ((long long)b + (long long)i * grid) * R;
      const int n = (int)min((long long)R, rows - r0);
      const T* xs = reinterpret_cast<const T*>(ring + s * 2 * half);
      const T* gs = reinterpret_cast<const T*>(ring + s * 2 * half + half);
      if (grp < groups) {
        for (int r = grp; r < n; r += groups) {
          const float2 st = stats[s * R + r];
#pragma unroll
          for (int u = 0; u < NS; ++u) {
            const int v = first + u * kSweepThreads;
            if (v < nvec) {
              float xv[V], gv[V];
              load16(xs + (size_t)r * C + v * V, xv);
              load16(gs + (size_t)r * C + v * V, gv);
#pragma unroll
              for (int e = 0; e < V; ++e) {
                const float xh = (xv[e] - st.x) * st.y;
                ds[u][e] += gv[e] * xh;
                db[u][e] += gv[e];
              }
            }
          }
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(smem_u32(bars + 2 * S + s));
    }
    // the block's partial rows: part[0][b] (dscale), part[1][b] (dbias)
    float* ds_out = part + (size_t)b * C;
    float* db_out = part + ((size_t)grid + b) * C;
    if (groups == 1) {
#pragma unroll
      for (int u = 0; u < NS; ++u) {
        const int v = first + u * kSweepThreads;
        if (v < nvec)
#pragma unroll
          for (int e = 0; e < V; ++e) {
            ds_out[v * V + e] = ds[u][e];
            db_out[v * V + e] = db[u][e];
          }
      }
    } else {
      if (grp < groups)
#pragma unroll
        for (int e = 0; e < V; ++e) {
          comb[(size_t)2 * grp * C + first * V + e] = ds[0][e];
          comb[(size_t)(2 * grp + 1) * C + first * V + e] = db[0][e];
        }
      asm volatile("bar.sync 1, %0;\n" ::"n"(kSweepThreads) : "memory");
      for (int c = q; c < C; c += kSweepThreads) {
        float a = 0.f, d = 0.f;
        for (int k = 0; k < groups; ++k) {  // groups in order
          a += comb[(size_t)2 * k * C + c];
          d += comb[(size_t)(2 * k + 1) * C + c];
        }
        ds_out[c] = a;
        db_out[c] = d;
      }
    }
  }

  if constexpr (FUSED) {
    // the block's partial rows: the row warps' in warp order
    __syncthreads();
    for (int c = threadIdx.x; c < C; c += kBwdThreads) {
      float a = 0.f, d = 0.f;
      for (int k = 0; k < kRows; ++k) {
        a += comb[(size_t)2 * k * C + c];
        d += comb[(size_t)(2 * k + 1) * C + c];
      }
      part[(size_t)b * C + c] = a;
      part[((size_t)grid + b) * C + c] = d;
    }
  }

  // every block's partial rows are written before any block sums them:
  // the grid is co-resident (a cooperative launch), so the blocks meet at
  // sync, a counter of the caller's that only calls of this grid size on
  // this stream add to, so that it is a multiple of grid when a call
  // starts: an acquire-release add after the block's barrier publishes its
  // rows, and the block goes on once the count reaches the next multiple
  __syncthreads();
  if (threadIdx.x == 0) {
    const unsigned long long old = add_acq_rel(sync, 1ull);
    const unsigned long long next = (old / grid + 1) * grid;
    if (old + 1 != next && ld_acquire(sync) < next) {
      const unsigned long long t0 = now_ns();
      while (ld_acquire(sync) < next)
        if (now_ns() - t0 > kWaitLimitNs) __trap();
    }
  }
  __syncthreads();

  // the finish: block b sums its share of the 2 C columns of sums (dscale,
  // then dbias) over the grid's partial rows, a warp a column: lane l adds
  // blocks l, l + 32, ... in order, all its loads in flight at once, and
  // the lanes' sums are added by the xor butterfly of warp_sums. The same
  // bits on every call.
  const int cols = 2 * C, per = (cols + grid - 1) / grid;
  const int c0 = b * per, width = max(0, min(c0 + per, cols) - c0);
  for (int j = warp; j < width; j += kBwdThreads / 32) {
    const int col = c0 + j;
    const float* src = part + (size_t)(col / C) * grid * C + col % C;
    float v[kMaxRun];
#pragma unroll
    for (int k = 0; k < kMaxRun; ++k)
      v[k] = lane + 32 * k < grid ? __ldcg(src + (size_t)(lane + 32 * k) * C)
                                  : 0.f;
    float t[1] = {0.f};
#pragma unroll
    for (int k = 0; k < kMaxRun; ++k)
      if (lane + 32 * k < grid) t[0] += v[k];
    warp_sums(t);
    if (lane == 0) sums[col] = t[0];
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

// Lets layer_norm_bwd_kernel<T, NV, FUSED> take smem bytes of dynamic
// shared memory on the current device: set once, and again only for more.
template <typename T, int NV, bool FUSED>
cudaError_t allow_smem(size_t smem) {
  constexpr int kDevices = 64;
  static int allowed[kDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kDevices && allowed[dev] >= (int)smem) return cudaSuccess;
  err = cudaFuncSetAttribute(layer_norm_bwd_kernel<T, NV, FUSED>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err == cudaSuccess && dev < kDevices) allowed[dev] = (int)smem;
  return err;
}

template <typename T, int NV, bool FUSED = false>
cudaError_t launch_bwd_nv(const void* x, const void* scale, const void* g,
                          void* dx, void* sums, void* part, void* sync,
                          int rows, int C, int R, int S, int grid, float eps,
                          cudaStream_t stream) {
  static_assert(!FUSED || (NV > 0 && NV * Vec<T>::n <= 16), "fused rows");
  const size_t smem = bwd_smem_bytes(C, R, S, sizeof(T), FUSED);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  const cudaError_t err = allow_smem<T, NV, FUSED>(smem);
  if (err != cudaSuccess) return err;
  const T* xp = static_cast<const T*>(x);
  const float* sp = static_cast<const float*>(scale);
  const T* gp = static_cast<const T*>(g);
  T* dxp = static_cast<T*>(dx);
  float* sums_p = static_cast<float*>(sums);
  float* part_p = static_cast<float*>(part);
  unsigned long long* sync_p = static_cast<unsigned long long*>(sync);
  void* args[] = {&xp, &sp, &gp, &dxp, &sums_p, &part_p, &sync_p,
                  &rows, &C, &R, &S, &eps};
  // cooperative: the launch fails, rather than the blocks wait for ever,
  // unless the whole grid is resident at once
  return cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(&layer_norm_bwd_kernel<T, NV, FUSED>),
      dim3(grid), dim3(kBwdThreads), args, smem, stream);
}

// The row warps hold a row in registers where a lane's vectors, NV of 16
// bytes, are at most 32 values (C <= 1024); wider rows stream from the
// ring (NV = 0). At C <= kFusedMaxC with tiles of kRowWarps rows or more,
// the fused schedule.
template <typename T>
cudaError_t launch_bwd(const void* x, const void* scale, const void* g,
                       void* dx, void* sums, void* part, void* sync, int rows,
                       int C, int R, int S, int grid, float eps,
                       cudaStream_t stream) {
  constexpr int V = Vec<T>::n, NF = 16 / V;  // NF: a fused row's vectors
  const int per_lane = (C / V + 31) / 32;
  if (C <= kFusedMaxC && R >= kRowWarps)
    return launch_bwd_nv<T, NF, true>(x, scale, g, dx, sums, part, sync, rows,
                                      C, R, S, grid, eps, stream);
  if (per_lane <= 2)
    return launch_bwd_nv<T, 2>(x, scale, g, dx, sums, part, sync, rows, C, R,
                               S, grid, eps, stream);
  if (per_lane <= 4)
    return launch_bwd_nv<T, 4>(x, scale, g, dx, sums, part, sync, rows, C, R,
                               S, grid, eps, stream);
  if (V == 4 && per_lane <= 8)
    return launch_bwd_nv<T, 32 / V>(x, scale, g, dx, sums, part, sync, rows,
                                    C, R, S, grid, eps, stream);
  return launch_bwd_nv<T, 0>(x, scale, g, dx, sums, part, sync, rows, C, R, S,
                             grid, eps, stream);
}

bool bad_shape(int rows, int C) {
  return rows < 1 || C < 1 || C % 128 != 0 ||
         C > kWarpCols * (kMaxThreads / 32);
}

}  // namespace

// Plain C entry points, bound with ctypes. Pointers are device pointers to
// contiguous, 16-byte aligned memory: x, y, g, dx (rows, C) in the dtype
// (0 = float32, 1 = bfloat16); scale, bias (C) f32. C is a multiple of 128
// up to 8192. Each returns the cudaError_t of the launch.
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

// The backward: sums (2, C) f32 receives dscale then dbias; part is (2,
// grid, C) f32 scratch; sync one 64-bit counter, a multiple of grid on
// entry, that only calls of this grid size on this stream use.
// Tiles of R rows, S stages (1..4), grid blocks (at most the tiles, and
// all resident at once).
extern "C" int cris_layer_norm_bwd(const void* x, const void* scale,
                                   const void* g, void* dx, void* sums,
                                   void* part, void* sync, int rows, int C,
                                   int R, int stages, int grid, int dtype,
                                   float eps, void* stream) {
  if (bad_shape(rows, C) || R < 1 || stages < 1 || stages > kMaxStages ||
      grid < 1 || grid > ((long long)rows + R - 1) / R ||
      grid > 32 * kMaxRun)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)launch_bwd<float>(x, scale, g, dx, sums, part, sync, rows, C,
                                  R, stages, grid, eps, st);
  if (dtype == 1)
    return (int)launch_bwd<__nv_bfloat16>(x, scale, g, dx, sums, part, sync,
                                          rows, C, R, stages, grid, eps, st);
  return (int)cudaErrorInvalidValue;
}
