// Code shared by the attention kernels (attention_bse.cu: K1 and K3;
// attention_bse_dropout.cu: K2): the scalar bodies' loads and rounding,
// the Philox keep bits, the warp-level tensor-core helpers, and the one
// flash-attention forward body (flash_fwd_body) that K1, K3 and K2's
// tensor-core forward all run.
//
// The tensor-core bodies are flash-attention bodies on mma.sync.m16n8k16
// (bf16 x bf16 -> f32): one block of 4 warps per 64 rows, 16 rows a warp;
// operands come from 64-row tiles in shared memory, filled by 16-byte
// cp.async copies and read by ldmatrix (.trans for an operand whose
// reduction runs along its rows). A tile row holds DP bf16 columns padded
// by 16 bytes, so that ldmatrix's 8 row addresses fall in distinct banks.
//
// mma fragment layout (m16n8k16): lane l holds rows l / 4 and l / 4 + 8 of
// its warp's 16 and columns 8 j + 2 (l % 4) and + 1 of each 8-column tile
// j of the f32 accumulator; the same registers, rounded to bf16 in pairs
// (pack_bf16), are the A operand of a following product over those
// columns.

#pragma once

#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

// (batch, head, row) strides of a (B, H, L, D) view, in elements; the
// column stride is 1
struct Strides {
  long long b, h, s;
};

// ------------------------------------------------- the scalar bodies' I/O

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_from_f32(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_from_f32(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}
// x rounded to scalar_t and back (the identity for f32)
template <typename scalar_t>
__device__ __forceinline__ float round_to(float x) {
  return std::is_same<scalar_t, float>::value
             ? x
             : __bfloat162float(__float2bfloat16(x));
}

// ------------------------------------------------------ the keep bits (K2)

__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint32_t k0,
                                               uint32_t k1) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r) {
      k0 += 0x9E3779B9u;
      k1 += 0xBB67AE85u;
    }
    const uint32_t lo0 = 0xD2511F53u * c.x, hi0 = __umulhi(0xD2511F53u, c.x);
    const uint32_t lo1 = 0xCD9E8D57u * c.z, hi1 = __umulhi(0xCD9E8D57u, c.z);
    c = make_uint4(hi1 ^ c.y ^ k0, lo1, hi0 ^ c.w ^ k1, lo0);
  }
  return c;
}

// the bits of key columns 4g .. 4g+3 on query row i
__device__ __forceinline__ uint4 keep_bits(int g, int i, int h, int b,
                                           uint32_t k0, uint32_t k1) {
  return philox4x32_10(
      make_uint4((uint32_t)g, (uint32_t)i, (uint32_t)h, (uint32_t)b), k0, k1);
}

// uint32 words of the packed keep mask per (batch, head, query row): bit
// j % 32 of word j / 32 is key column j's keep bit (0 past T)
__host__ __device__ __forceinline__ int mask_words(int T) {
  return (T + 31) >> 5;
}

// ------------------------------------------------ the tensor-core helpers

constexpr int kTcThreads = 128;  // 4 warps x 16 rows
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// A 64-row tile of DP bf16 columns, rows padded by 8 elements (16 bytes)
template <int DP>
struct TcTile {
  static constexpr int kLd = DP + 8;
  static constexpr int kElems = 64 * kLd;
  static constexpr uint32_t kBytes = kElems * 2;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared, or 16 zero bytes when !in
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(in ? 16 : 0)
               : "memory");
}
// 4 bytes from global to shared, or 4 zero bytes when !in
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          bool in) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(in ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// c (16 x 8, f32) += a (16 x 16, bf16, row) b (16 x 8, bf16, col)
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 2^x on the special function unit (2^-inf = 0)
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The A fragment (16 x 16, k step kk) of the 16 rows this warp owns in a
// tile at `tile`: rows 16 w .. + 15, columns 16 kk .. + 15.
template <int DP>
__device__ __forceinline__ void ldsm_a(uint32_t (&r)[4], uint32_t tile,
                                       int warp, int lane, int kk) {
  ldsm_x4(r, tile + ((warp * 16 + (lane & 15)) * TcTile<DP>::kLd +
                     (2 * kk + (lane >> 4)) * 8) * 2);
}

// B fragments of two 8-column tiles (2 p, 2 p + 1) for a product whose
// reduction runs along the tile's columns (k step kk): rows 16 p .. + 15
// of the tile are the output columns.
template <int DP>
__device__ __forceinline__ void ldsm_b_rows(uint32_t (&r)[4], uint32_t tile,
                                            int lane, int p, int kk) {
  ldsm_x4(r, tile + ((16 * p + (lane & 7) + ((lane >> 4) << 3)) *
                         TcTile<DP>::kLd +
                     (2 * kk + ((lane >> 3) & 1)) * 8) * 2);
}

// B fragments of two 8-column tiles (2 jj, 2 jj + 1) for a product whose
// reduction runs along the tile's rows (k step kk over rows 16 kk .. + 15).
template <int DP>
__device__ __forceinline__ void ldsm_b_cols(uint32_t (&r)[4], uint32_t tile,
                                            int lane, int kk, int jj) {
  ldsm_x4_trans(r, tile + ((16 * kk + (lane & 15)) * TcTile<DP>::kLd +
                           (2 * jj + (lane >> 4)) * 8) * 2);
}

// Rows r0 .. r0 + 63 of a head's (rows, D) view into a padded 64-row tile,
// 16 bytes a copy, neighbouring threads on neighbouring chunks of a row;
// rows past `rows` and columns past D are zero-filled.
template <int DP>
__device__ __forceinline__ void load_tile(uint32_t dst,
                                          const __nv_bfloat16* base,
                                          long long row_stride, int r0,
                                          int rows, int D) {
  constexpr int kChunks = DP / 8;
#pragma unroll
  for (int i = 0; i < 64 * kChunks / kTcThreads; ++i) {
    const int c = threadIdx.x + i * kTcThreads;
    const int r = c / kChunks, ch = c % kChunks;
    const bool in = r0 + r < rows && ch * 8 < D;
    const __nv_bfloat16* src =
        in ? base + (long long)(r0 + r) * row_stride + ch * 8 : base;
    cp_async16(dst + (r * TcTile<DP>::kLd + ch * 8) * 2, src, in);
  }
}

// ------------------------------------------- the flash-attention forward

constexpr float kMaskedLogit = -1e30f;  // finite: an all-masked row -> 1/T

// Shared memory of a forward body: Q, K[2], V[2], then the key flags [2][64]
template <int DP>
struct TcFlashSmem {
  static constexpr size_t kBytes = 5 * TcTile<DP>::kBytes + 2 * 64;
};

// 0: past T (weight 0), 1: masked key (logit -1e30), 2: valid key
__device__ __forceinline__ uint8_t key_flag(const uint8_t* valid, int key,
                                            int T) {
  if (key >= T) return 0;
  return (valid != nullptr && valid[key] == 0) ? 1 : 2;
}

// One 64-key tile of the online softmax over a warp's 16 rows: sc holds
// S = Q K^T in fragment layout. Scales it to log2 units (for exp2), masks
// it by the tile's key flags fl (unless the tile has 64 in-range keys and
// no mask), updates the running max over the 4 lanes of a quad and the
// running sum, rescales the output accumulator o, and leaves the f32
// p = 2^(x - max) in sc; the running sum is kept per lane, to be summed
// over the quad at the end.
template <int ND>
__device__ __forceinline__ void online_softmax_tile(
    float (&sc)[8][4], float (&o)[ND][4], float (&m_run)[2],
    float (&l_run)[2], const uint8_t* fl, bool plain_tile, float scale_log2,
    int lane) {
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float x = sc[j][e] * scale_log2;
      if (!plain_tile) {
        const uint8_t f = fl[8 * j + 2 * (lane & 3) + (e & 1)];
        x = f == 2 ? x : (f == 1 ? kMaskedLogit : -INFINITY);
      }
      sc[j][e] = x;
      mx[e >> 1] = fmaxf(mx[e >> 1], x);
    }
  }
  float alpha[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    // key k0 is always in range, so the new max is finite
    const float m_new = fmaxf(m_run[r], mx[r]);
    alpha[r] = fast_exp2(m_run[r] - m_new);  // 0 on the first tile
    m_run[r] = m_new;
    l_run[r] *= alpha[r];
  }
#pragma unroll
  for (int j = 0; j < ND; ++j) {
    o[j][0] *= alpha[0];
    o[j][1] *= alpha[0];
    o[j][2] *= alpha[1];
    o[j][3] *= alpha[1];
  }
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float p = fast_exp2(sc[j][e] - m_run[e >> 1]);
      l_run[e >> 1] += p;  // f32 p: the row sum before rounding
      sc[j][e] = p;
    }
  }
}

// A warp's 16 rows of an f32 accumulator (16 x DP, fragment layout),
// times `scale`, rounded to bf16 and stored 16 bytes a lane: staged in
// `stage` (this warp's own 16 padded rows, which no other warp reads),
// then copied to rows row0 .. row0 + 15 of `dst` (row stride `ld`), those
// below `rows` and columns below D.
template <int DP>
__device__ __forceinline__ void store_rows(const float (&acc)[DP / 8][4],
                                           float scale0, float scale1,
                                           __nv_bfloat16* stage,
                                           __nv_bfloat16* dst, long long ld,
                                           int row0, int rows, int D,
                                           int lane) {
  constexpr int ND = DP / 8, kLd = TcTile<DP>::kLd;
  const int g = lane >> 2, c2 = 2 * (lane & 3);
#pragma unroll
  for (int j = 0; j < ND; ++j) {
    *reinterpret_cast<uint32_t*>(&stage[g * kLd + 8 * j + c2]) =
        pack_bf16(acc[j][0] * scale0, acc[j][1] * scale0);
    *reinterpret_cast<uint32_t*>(&stage[(g + 8) * kLd + 8 * j + c2]) =
        pack_bf16(acc[j][2] * scale1, acc[j][3] * scale1);
  }
  __syncwarp();
#pragma unroll
  for (int i = 0; i < 16 * ND / 32; ++i) {
    const int c = lane + 32 * i;
    const int r = c / ND, ch = c % ND;
    if (row0 + r < rows && ch * 8 < D)
      *reinterpret_cast<uint4*>(dst + (long long)(row0 + r) * ld + ch * 8) =
          *reinterpret_cast<const uint4*>(&stage[r * kLd + ch * 8]);
  }
}

// Dropout on the weights of flash_fwd_body<DP, true> (K2's forward)
struct FlashDropout {
  float* lse;          // (B, H, S) f32: the row log-sum-exp, natural units
  uint32_t* bits;      // (B, H, S, mask_words(T)): the packed keep mask
  uint32_t threshold;  // a weight is kept iff its Philox bits >= threshold
  uint32_t k0, k1;     // the Philox key (seed lo, seed hi)
  float inv_keep;      // 1 / (1 - rate)
  int b0;              // the Philox batch word of batch row 0 (its row in
                       // the data-parallel global batch); pointers stay local
  int h0;              // the Philox head word of head 0 (its head among the
                       // heads tensor parallel splits); pointers stay local
};

// The flash-attention forward, on a grid of (64 query rows, head, batch)
// blocks of kTcThreads; warp w owns rows 16 w .. + 15. bf16 q, k, v and
// out are addressed through (batch, head, row) strides with unit column
// stride; DP (16, 32, 64 or 128) is the compiled width, D <= DP the head
// dim, both a multiple of 8, every base and stride a multiple of 8
// elements. Shared memory: TcFlashSmem<DP>::kBytes, dynamic.
//
// Per 64-key tile: S = Q K^T (f32), an online softmax in log2 units whose
// max and sum run over the undropped p, P rounded to bf16 as the A
// operand of P V. kDropout adds K2's dropout: each p first takes its keep
// bit (P o keep is what is rounded, as `_fwd_kernel` rounds it); the row
// log-sum-exp and the packed keep mask are written; out = acc / l /
// (1 - rate). Without it the body is K1's and K3's: out = acc / l, so K2
// at rate 0 gives their bits.
template <int DP, bool kDropout>
__device__ __forceinline__ void flash_fwd_body(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const uint8_t* __restrict__ kv_valid,
    __nv_bfloat16* __restrict__ out, int S, int T, int D, Strides qs,
    Strides ks, Strides vs, Strides os, float scale_log2, FlashDropout dr) {
  using Tile = TcTile<DP>;
  constexpr int KS = DP / 16;  // k16 steps over the head dim
  constexpr int ND = DP / 8;   // 8-column tiles over the head dim
  constexpr uint32_t kTileBytes = Tile::kBytes;
  extern __shared__ __align__(16) __nv_bfloat16 tc_smem[];
  uint8_t* flags = reinterpret_cast<uint8_t*>(tc_smem + 5 * Tile::kElems);
  const uint32_t q_addr = smem_u32(tc_smem);
  const uint32_t k_addr = q_addr + kTileBytes;
  const uint32_t v_addr = k_addr + 2 * kTileBytes;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int q0 = blockIdx.x * 64, h = blockIdx.y, b = blockIdx.z;
  const long long bh = (long long)b * gridDim.y + h;
  const __nv_bfloat16* qb = q + b * qs.b + h * qs.h;
  const __nv_bfloat16* kb = k + b * ks.b + h * ks.h;
  const __nv_bfloat16* vb = v + b * vs.b + h * vs.h;
  const uint8_t* valid =
      kv_valid == nullptr ? nullptr : kv_valid + (long long)b * T;

  load_tile<DP>(q_addr, qb, qs.s, q0, S, D);
  load_tile<DP>(k_addr, kb, ks.s, 0, T, D);
  load_tile<DP>(v_addr, vb, vs.s, 0, T, D);
  cp_async_commit();
  if (threadIdx.x < 64) flags[threadIdx.x] = key_flag(valid, threadIdx.x, T);

  // Dropout: lanes l and l ^ 1 cover the same 4-key Philox group of each
  // column tile (l even: its words 0, 1; l odd: words 2, 3) on the same
  // two rows. Each draws the group of one row (even: row0, odd: row0 + 8)
  // and hands the two words the other needs across with one shuffle a key
  // tile: one Philox call per (row, 4-key group), the least there can be.
  const int row0 = q0 + warp * 16 + (lane >> 2);
  const bool odd = lane & 1;
  const int my_row = row0 + (odd ? 8 : 0);
  const int grp_off = (lane >> 1) & 1;
  const int nw = mask_words(T);

  uint32_t qf[KS][4];
  float o[ND][4];
#pragma unroll
  for (int j = 0; j < ND; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f};

  const int nt = (T + 63) / 64;
  for (int it = 0; it < nt; ++it) {
    const int buf = it & 1;
    cp_async_wait_all();
    __syncthreads();  // tile it landed; every warp is done with tile it - 1
    if (it == 0) {
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) ldsm_a<DP>(qf[kk], q_addr, warp, lane, kk);
    }
    uint8_t next_flag = 0;
    if (it + 1 < nt) {  // the next tile flies while this one computes
      const int k1 = (it + 1) * 64;
      load_tile<DP>(k_addr + (buf ^ 1) * kTileBytes, kb, ks.s, k1, T, D);
      load_tile<DP>(v_addr + (buf ^ 1) * kTileBytes, vb, vs.s, k1, T, D);
      cp_async_commit();
      if (threadIdx.x < 64) next_flag = key_flag(valid, k1 + threadIdx.x, T);
    }

    // keep bits: bit 2 j + e of keep[r] is column 8 j + 2 (l % 4) + e of row
    // row0 + 8 r; drawn before the products so that the integer pipes
    // overlap the tensor cores
    uint32_t keep[2] = {0xFFFFu, 0xFFFFu};
    if (kDropout && dr.threshold != 0) {
      uint32_t mine = 0, send = 0;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const uint4 w = keep_bits(it * 16 + 2 * j + grp_off, my_row,
                                  h + dr.h0, b + dr.b0, dr.k0, dr.k1);
        const uint32_t k4 = (w.x >= dr.threshold ? 1u : 0u) |
                            (w.y >= dr.threshold ? 2u : 0u) |
                            (w.z >= dr.threshold ? 4u : 0u) |
                            (w.w >= dr.threshold ? 8u : 0u);
        mine |= (odd ? k4 >> 2 : k4 & 3u) << (2 * j);
        send |= (odd ? k4 & 3u : k4 >> 2) << (2 * j);
      }
      const uint32_t recv = __shfl_xor_sync(0xffffffffu, send, 1);
      keep[0] = odd ? recv : mine;
      keep[1] = odd ? mine : recv;
    }

    // S = Q K^T for this warp's 16 rows x 64 keys
    float sc[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[j][e] = 0.f;
    const uint32_t kt = k_addr + buf * kTileBytes;
#pragma unroll
    for (int p = 0; p < 4; ++p) {
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        uint32_t r[4];
        ldsm_b_rows<DP>(r, kt, lane, p, kk);
        mma_bf16(sc[2 * p], qf[kk], r[0], r[1]);
        mma_bf16(sc[2 * p + 1], qf[kk], r[2], r[3]);
      }
    }

    // the online softmax (log2 units) over the undropped p; a tile of 64
    // in-range keys with no mask skips the key flags. Then each p takes
    // its keep bit.
    online_softmax_tile<ND>(sc, o, m_run, l_run, flags + buf * 64,
                            valid == nullptr && it * 64 + 64 <= T, scale_log2,
                            lane);
    if (kDropout) {
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (!((keep[e >> 1] >> (2 * j + (e & 1))) & 1u)) sc[j][e] = 0.f;
    }

    // O += P V: P rounded to bf16 as the A operand, 16 keys a step
    const uint32_t vt = v_addr + buf * kTileBytes;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint32_t a[4] = {pack_bf16(sc[2 * kk][0], sc[2 * kk][1]),
                             pack_bf16(sc[2 * kk][2], sc[2 * kk][3]),
                             pack_bf16(sc[2 * kk + 1][0], sc[2 * kk + 1][1]),
                             pack_bf16(sc[2 * kk + 1][2], sc[2 * kk + 1][3])};
#pragma unroll
      for (int jj = 0; jj < KS; ++jj) {
        uint32_t r[4];
        ldsm_b_cols<DP>(r, vt, lane, kk, jj);
        mma_bf16(o[2 * jj], a, r[0], r[1]);
        mma_bf16(o[2 * jj + 1], a, r[2], r[3]);
      }
    }

    // the packed keep mask of this key tile: lane l % 4 stores word
    // 2 it + l % 2 of row row0 + 8 ((l % 4) / 2). It gathers the quad's
    // keep bits of both rows (bits 16 r + 2 j + e of lane c: column
    // 8 j + 2 c + e of row r), and spreads byte l % 2 of each, 4 two-bit
    // fields, to bit positions 8 jj + 2 c + {0, 1}.
    if (kDropout) {
      const uint32_t both = keep[0] | (keep[1] << 16);
      const int r = (lane >> 1) & 1, w = lane & 1, row = row0 + 8 * r;
      uint32_t val = 0;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const uint32_t from_c = __shfl_sync(0xffffffffu, both, (lane & ~3) | c);
        const uint32_t x = (from_c >> (16 * r + 8 * w)) & 0xFFu;
        val |= ((x & 3u) | ((x & 0xCu) << 6) | ((x & 0x30u) << 12) |
                ((x & 0xC0u) << 18))
               << (2 * c);
      }
      const int word = 2 * it + w, cols = T - 32 * word;  // keys left
      if (cols < 32) val &= cols > 0 ? (1u << cols) - 1u : 0u;
      if (row < S && word < nw) dr.bits[(bh * S + row) * nw + word] = val;
    }
    if (it + 1 < nt && threadIdx.x < 64)
      flags[(buf ^ 1) * 64 + threadIdx.x] = next_flag;
  }

  // out = O / l (/ (1 - rate) with dropout), rounded once, staged in this
  // warp's own rows of Q's tile (no other warp reads them), then stored 16
  // bytes a thread; with dropout the row log-sum-exp in natural units, as
  // K2's scalar forward writes it
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 1);
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 2);
    const int row = row0 + 8 * r;
    if (kDropout && (lane & 3) == 0 && row < S)
      dr.lse[bh * S + row] = (m_run[r] + log2f(l_run[r])) * kLn2;
  }
  const float num = kDropout ? dr.inv_keep : 1.f;
  store_rows<DP>(o, num / l_run[0], num / l_run[1],
                 tc_smem + warp * 16 * Tile::kLd, out + b * os.b + h * os.h,
                 os.s, q0 + warp * 16, S, D, lane);
}

}  // namespace
