// A bf16 matrix product for Hopper's tensor cores, fed by TMA: one output
// tile of a C = A B product per thread block, with the f32 accumulators
// staged in shared memory for the caller's epilogue. K4 (fused_matmul.cu)
// runs on it; K5 and K7 are to move onto it from block_gemm.cuh.
//
// - A (M, K) is K-major (unit stride along K); B (K, N) is either N-major
//   (unit stride along N: a contiguous (K, N)) or K-major (unit stride
//   along K: the transposed view of an nn.Linear weight). Both are read
//   through 2-D TMA tensor maps, built on the host by make_tmap_2d.
// - Tiles: BM x 128 outputs, BM = 64 x NC for NC consumer warpgroups (1
//   or 2), at a depth of 64 per stage. A ring of kStages stages in shared
//   memory, each holding A's BM x 64 and B's 64 x 128 tiles with 128-byte
//   swizzle, one "full" and one "empty" mbarrier per stage.
// - One producer warp (after the consumers) issues the TMA loads: one
//   thread waits for a stage to be empty, arms its full barrier with the
//   byte count, and loads A and B (B N-major as two 64-column boxes, since
//   a 128-byte swizzle row holds 64 bf16). TMA fills boxes that run past
//   M, N or K with zeros, so ragged edges need no padding.
// - Each consumer warpgroup issues wgmma.mma_async m64n128k16 (bf16 x bf16
//   -> f32, A and B from shared memory through matrix descriptors, the
//   accumulators in 64 registers a thread), 4 per stage, keeps one stage's
//   group in flight, and releases the stage before it.
// - When every consumer has drained the ring (a named barrier of the
//   consumer threads), each warpgroup writes its 64 x 128 f32
//   accumulators to its own slice of the ring's memory (row stride kLdc =
//   136 floats: the float2 writes and the float4 reads of the epilogue
//   are free of bank conflicts) and syncs on a named barrier of its 128
//   threads. With 3 stages and no separate staging buffer a block takes
//   98 KB, so two blocks share an SM and one's epilogue and pipeline fill
//   run under the other's products.
//
// The descriptors: for a 128-byte swizzled K-major operand the stride
// byte offset (SBO) is 1024 (8 rows of 128 bytes) and a k16 step adds 32
// bytes to the start address; for the N-major B the leading byte offset
// (LBO) is the 8192 bytes between the two 64-column boxes, SBO the 1024
// between groups of 8 k-rows, and a k16 step adds 16 rows (2048 bytes).
// Every tile base is 1024-byte aligned, so TMA's swizzle and wgmma's agree.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cris {
namespace sm90 {

constexpr int kBK = 64;      // depth per stage: one 128-byte swizzle row
constexpr int kBN = 128;     // output tile width
constexpr int kStages = 3;   // the TMA ring
constexpr int kLdc = kBN + 8;  // staged accumulator row stride, floats

template <int NC>
struct GemmTile {
  static constexpr int kBM = 64 * NC;
  static constexpr int kThreads = 128 * NC + 32;  // consumers + producer
  static constexpr int kABytes = kBM * kBK * 2;
  static constexpr int kBBytes = kBN * kBK * 2;
  static constexpr int kStageBytes = kABytes + kBBytes;
  // the staged accumulators reuse the drained ring
  static constexpr int kCBytes = NC * 64 * kLdc * 4;
  static_assert(kCBytes <= kStages * kStageBytes, "staging fits the ring");
  // + 1024: the dynamic base is rounded up to a 1024-byte boundary; two
  // blocks fit an SM (98 KB at NC = 2, 74 KB at NC = 1)
  static constexpr int kSmemBytes = kStages * kStageBytes + 2 * kStages * 8 + 1024;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
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

// Wait until the phase of the given parity has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

// 2-D TMA load of one box at (c0 = inner, c1 = outer) into shared memory;
// completion is reported to bar as transferred bytes.
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// A shared-memory matrix descriptor for a 128-byte swizzled operand.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) |
         (static_cast<uint64_t>(1) << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// d (64 x 128, f32) += A (64 x 16, K-major) B (16 x 128); TNSPB = 1 for an
// N-major B, 0 for a K-major one.
template <int TNSPB>
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t da,
                                                 uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, "
      "%43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, "
      "%57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, %67;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1), "n"(TNSPB));
}

// Pin the accumulators around the asynchronous products: the compiler
// may not move their reads or writes across this point.
__device__ __forceinline__ void fence_operands(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ void named_barrier_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// The block's (m0, n0) output tile of A B. Every thread of the block calls
// it; on return, in consumer warpgroup wg (< NC), c_stage + wg * 64 * kLdc
// holds rows m0 + 64 wg .. + 63 of the f32 product (kLdc floats a row),
// visible to that warpgroup's 128 threads, and the function returns wg.
// The producer warp returns NC and must not touch the staging buffer.
template <int NC, bool B_NMAJOR>
__device__ int gemm_tile(const CUtensorMap* ta, const CUtensorMap* tb, int m0,
                         int n0, int K, uint8_t* smem, float** c_stage) {
  using Tile = GemmTile<NC>;
  uint8_t* stages = smem;
  float* cbuf = reinterpret_cast<float*>(smem);  // after the ring drains
  uint64_t* full =
      reinterpret_cast<uint64_t*>(smem + kStages * Tile::kStageBytes);
  uint64_t* empty = full + kStages;
  const int nk = (K + kBK - 1) / kBK;
  const int wg = threadIdx.x / 128;
  *c_stage = cbuf;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(smem_u32(&full[s]), 1);
      mbar_init(smem_u32(&empty[s]), 4 * NC);  // lane 0 of each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == NC) {  // the producer warp
    if (threadIdx.x == 128 * NC) {
      for (int kb = 0; kb < nk; ++kb) {
        const int s = kb % kStages;
        if (kb >= kStages) mbar_wait(smem_u32(&empty[s]), ((kb / kStages) - 1) & 1);
        const uint32_t bar = smem_u32(&full[s]);
        const uint32_t a = smem_u32(stages + s * Tile::kStageBytes);
        const uint32_t b = a + Tile::kABytes;
        mbar_expect_tx(bar, Tile::kStageBytes);
        tma_load_2d(a, ta, bar, kb * kBK, m0);
        if (B_NMAJOR) {
          tma_load_2d(b, tb, bar, n0, kb * kBK);
          tma_load_2d(b + kBK * 128, tb, bar, n0 + 64, kb * kBK);
        } else {
          tma_load_2d(b, tb, bar, kb * kBK, n0);
        }
      }
    }
    return NC;
  }

  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  fence_operands(acc);
  const int lane = threadIdx.x & 31;
  for (int kb = 0; kb < nk; ++kb) {
    const int s = kb % kStages;
    mbar_wait(smem_u32(&full[s]), (kb / kStages) & 1);
    const uint32_t a = smem_u32(stages + s * Tile::kStageBytes) + wg * 64 * 128;
    const uint32_t b = smem_u32(stages + s * Tile::kStageBytes) + Tile::kABytes;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      const uint64_t da = desc_sw128(a + kk * 32, 16, 1024);
      if (B_NMAJOR) {
        wgmma_m64n128k16<1>(acc, da, desc_sw128(b + kk * 2048, 64 * 128, 1024));
      } else {
        wgmma_m64n128k16<0>(acc, da, desc_sw128(b + kk * 32, 16, 1024));
      }
    }
    wgmma_commit();
    wgmma_wait<1>();  // the stage before this one has been read
    if (kb > 0 && lane == 0) mbar_arrive(smem_u32(&empty[(kb - 1) % kStages]));
  }
  wgmma_wait<0>();
  fence_operands(acc);
  // every consumer is done reading the ring (and every load has landed)
  // before any of them writes its accumulators over it
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  named_barrier_sync(1, 128 * NC);

  // accumulator fragment: warp w of the group holds rows 16 w + lane / 4
  // (and + 8), columns 8 j + 2 (lane % 4) (and + 1), j = 0 .. 15
  float* c = cbuf + wg * 64 * kLdc;
  const int r = 16 * ((threadIdx.x / 32) % 4) + lane / 4;
  const int col = 2 * (lane % 4);
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    *reinterpret_cast<float2*>(&c[r * kLdc + 8 * j + col]) =
        make_float2(acc[4 * j], acc[4 * j + 1]);
    *reinterpret_cast<float2*>(&c[(r + 8) * kLdc + 8 * j + col]) =
        make_float2(acc[4 * j + 2], acc[4 * j + 3]);
  }
  named_barrier_sync(2 + wg, 128);
  return wg;
}

// ---------------------------------------------------------------- host

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up through the CUDA runtime, so the
// library needs no -lcuda.
inline EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult status;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &status);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                              cudaEnableDefault, &status);
#endif
    if (err == cudaSuccess && status == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// A 2-D bf16 tensor map over `outer` rows of `inner` elements, rows
// outer_stride_bytes apart, boxes of box_outer rows x box_inner elements
// (box_inner * 2 <= 128) with 128-byte swizzle and zero fill past the
// edges. False if the encoding is refused (alignment, strides).
inline bool make_tmap_2d(CUtensorMap* map, const void* base, uint64_t inner,
                         uint64_t outer, uint64_t outer_stride_bytes,
                         uint32_t box_inner, uint32_t box_outer) {
  EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {inner, outer};
  const cuuint64_t strides[1] = {outer_stride_bytes};
  const cuuint32_t box[2] = {box_inner, box_outer};
  const cuuint32_t elem[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                const_cast<void*>(base), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace sm90
}  // namespace cris
