// Hopper (sm_90a) building blocks shared by the wgmma flash-attention
// kernels, as inline PTX: mbarriers, TMA tile loads (cp.async.bulk.tensor),
// setmaxnreg, named barriers, wgmma (descriptors, fence/commit/wait, the SS
// and RS products), the epilogue that writes an accumulator out through
// shared memory, and the host-side tensor-map encoder.
//
// Shared-memory tiles are the TMA's 128-byte swizzle: a [rows, D] 16-bit
// tile is stored as D / 64 column chunks, each [rows][64] with 128-byte rows,
// where 16-byte unit u of row r sits at unit u ^ (r % 8). Every chunk starts
// 1024-byte aligned, so a wgmma descriptor with the 128-byte swizzle mode
// reads it as it is:
// * K-major (the contraction dimension is the tile's columns): 8-row groups
//   1024 bytes apart (SBO); the k-step of 16 columns moves the start address
//   by 32 bytes inside the 128-byte row, and by a chunk every 64 columns.
// * MN-major (the contraction dimension is the tile's rows, "transpose"
//   bit set): 8-row groups 1024 bytes apart (SBO), 64-column chunks LBO =
//   rows * 128 bytes apart; the k-step of 16 rows moves the start by 2048.
//
// Tensor maps reach the kernels as `const __grid_constant__ CUtensorMap`
// parameters, encoded on the host per call by cuTensorMapEncodeTiled, which
// is looked up through cudaGetDriverEntryPoint so that nothing links against
// libcuda.

#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace ds_hopper {

// the warp-specialised kernels' common shape: a producer warpgroup and two
// consumer warpgroups, a two-stage ring of tiles
constexpr int WG_STAGES = 2;     // tiles in flight
constexpr int WG_THREADS = 384;  // producer warpgroup + two consumer warpgroups

constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---------------------------------------------------------------------------
// mbarriers
// ---------------------------------------------------------------------------
__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count)
               : "memory");
}

// makes the initialised barriers visible to the async proxy (TMA)
__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// arrive and add `bytes` to the transaction count the phase waits for
__device__ __forceinline__ void mbar_arrive_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

// Spin until the phase of parity `parity` has completed. A phase that never
// completes (a lost arrival or transaction byte) traps after 2^26 tries (over
// a second), so the launch fails with an error instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  for (uint32_t tries = 0;; ++tries) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (tries == (1u << 26)) __trap();
  }
}

// ---------------------------------------------------------------------------
// TMA, warp specialisation, named barriers
// ---------------------------------------------------------------------------
// One box of a 4-D tensor map into shared memory; completion is counted in
// bytes on `bar`. Coordinates are innermost first; rows past the tensor's
// end arrive zero-filled.
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1, int c2,
                                            int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3)
      : "memory");
}

// All four warps of a warpgroup hand registers back (dec) or take them (inc).
template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

// a barrier among `threads` threads only (id 0 is __syncthreads')
__device__ __forceinline__ void named_bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// ---------------------------------------------------------------------------
// wgmma
// ---------------------------------------------------------------------------
// Shared-memory matrix descriptor, 128-byte swizzle (layout type 1).
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo_bytes,
                                               uint32_t sbo_bytes) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo_bytes >> 4) << 16) |
         (static_cast<uint64_t>(sbo_bytes >> 4) << 32) | (1ull << 62);
}

// A k-step moves a descriptor by adding its byte offset / 16 to the start
// address field. `opaque` hides a loop-invariant descriptor from the
// optimiser, so that the per-k-step descriptors are formed where they are
// used instead of being hoisted out of the loop into many live registers.
__device__ __forceinline__ uint64_t opaque(uint64_t desc) {
  asm volatile("" : "+l"(desc));
  return desc;
}

// byte offset / 16 of k-step kk (16 columns) in a K-major [D/64][rows][64]
// tile
__device__ __forceinline__ uint64_t kmajor_step(int rows, int kk) {
  return static_cast<uint64_t>(((kk >> 2) * rows * 128 + (kk & 3) * 32) >> 4);
}

// byte offset / 16 of k-step kk (16 rows) in an MN-major tile
__device__ __forceinline__ uint64_t mnmajor_step(int kk) {
  return static_cast<uint64_t>(kk * 16 * 128 >> 4);
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

// Pins an accumulator's registers in program order: called right after
// wgmma_wait, it keeps the compiler from moving their first reads above it.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define DS_WGMMA_D16 \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}"
#define DS_WGMMA_D32                                                        \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31}"
#define DS_WGMMA_D64                                                        \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "  \
  "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "  \
  "%58, %59, %60, %61, %62, %63}"
#define DS_WGMMA_ACC16(d)                                                   \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),   \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),          \
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
#define DS_WGMMA_ACC32(d)                                                   \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),   \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),          \
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),      \
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),      \
      "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),      \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),      \
      "+f"(d[31])
#define DS_WGMMA_ACC64(d)                                                   \
  DS_WGMMA_ACC32(d), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),    \
      "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]),      \
      "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]),      \
      "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]),      \
      "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),      \
      "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),      \
      "+f"(d[61]), "+f"(d[62]), "+f"(d[63])

// d (+)= A B with A and B from shared memory, both K-major; d is zeroed
// first when scale_d is 0. S, A, B name the operand numbers of scale_d, a, b.
#define DS_WGMMA_SS(SHAPE, TY, REGS, ACC, A, B, S)                            \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %" S ", 0;\n"                \
               "wgmma.mma_async.sync.aligned." SHAPE ".f32." TY " " REGS     \
               ", %" A ", %" B ", p, 1, 1, 0, 0;\n}\n"                        \
               : ACC(d)                                                       \
               : "l"(a), "l"(b), "r"(scale_d))

// d += A B with A from registers (the m16n8k16 A-fragment layout, per warp
// 16 of the 64 rows) and B from shared memory, MN-major (transposed).
#define DS_WGMMA_RS(SHAPE, TY, REGS, ACC, A0, A1, A2, A3, B, S)               \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %" S ", 0;\n"                \
               "wgmma.mma_async.sync.aligned." SHAPE ".f32." TY " " REGS     \
               ", {%" A0 ", %" A1 ", %" A2 ", %" A3 "}, %" B                 \
               ", p, 1, 1, 1;\n}\n"                                           \
               : ACC(d)                                                       \
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1))

// m64nNk16, f32 accumulators (N / 2 per thread: element 4j + e is row
// 16 * warp + lane / 4 + 8 * (e >> 1), column 8j + 2 * (lane % 4) + (e & 1)).
template <int N, bool kF16>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t a, uint64_t b,
                                         int scale_d) {
  if constexpr (N == 128) {
    if constexpr (kF16) {
      DS_WGMMA_SS("m64n128k16", "f16.f16", DS_WGMMA_D64, DS_WGMMA_ACC64, "64", "65", "66");
    } else {
      DS_WGMMA_SS("m64n128k16", "bf16.bf16", DS_WGMMA_D64, DS_WGMMA_ACC64, "64", "65", "66");
    }
  } else if constexpr (N == 64) {
    if constexpr (kF16) {
      DS_WGMMA_SS("m64n64k16", "f16.f16", DS_WGMMA_D32, DS_WGMMA_ACC32, "32", "33", "34");
    } else {
      DS_WGMMA_SS("m64n64k16", "bf16.bf16", DS_WGMMA_D32, DS_WGMMA_ACC32, "32", "33", "34");
    }
  } else {
    static_assert(N == 32, "wgmma_ss: N is 32, 64 or 128");
    if constexpr (kF16) {
      DS_WGMMA_SS("m64n32k16", "f16.f16", DS_WGMMA_D16, DS_WGMMA_ACC16, "16", "17", "18");
    } else {
      DS_WGMMA_SS("m64n32k16", "bf16.bf16", DS_WGMMA_D16, DS_WGMMA_ACC16, "16", "17", "18");
    }
  }
}

template <int N, bool kF16>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4],
                                         uint64_t b) {
  if constexpr (N == 128) {
    if constexpr (kF16) {
      DS_WGMMA_RS("m64n128k16", "f16.f16", DS_WGMMA_D64, DS_WGMMA_ACC64, "64", "65", "66",
                  "67", "68", "69");
    } else {
      DS_WGMMA_RS("m64n128k16", "bf16.bf16", DS_WGMMA_D64, DS_WGMMA_ACC64, "64", "65",
                  "66", "67", "68", "69");
    }
  } else {
    static_assert(N == 64, "wgmma_rs: N is 64 or 128");
    if constexpr (kF16) {
      DS_WGMMA_RS("m64n64k16", "f16.f16", DS_WGMMA_D32, DS_WGMMA_ACC32, "32", "33", "34",
                  "35", "36", "37");
    } else {
      DS_WGMMA_RS("m64n64k16", "bf16.bf16", DS_WGMMA_D32, DS_WGMMA_ACC32, "32", "33",
                  "34", "35", "36", "37");
    }
  }
}

#undef DS_WGMMA_SS
#undef DS_WGMMA_RS

// Byte offset of 16-byte unit `unit` (0..D/8-1) of row `row` in a swizzled
// [D/64][rows][64] tile.
__device__ __forceinline__ uint32_t sw128_offset(int rows, int row, int unit) {
  return static_cast<uint32_t>((unit >> 3) * rows * 128 + row * 128 +
                               (((unit & 7) ^ (row & 7)) << 4));
}

// ---------------------------------------------------------------------------
// epilogue: accumulator -> shared memory -> 16-byte global stores
// ---------------------------------------------------------------------------
// Writes this warpgroup's m64nD accumulator, row half i times mul[i], as
// 16-bit pairs into rows row0..row0+63 of a swizzled [D/64][rows][64] tile.
template <typename Op, int D>
__device__ __forceinline__ void stage_acc(unsigned char* tile, int rows, int row0,
                                          const float (&acc)[D / 2], const float (&mul)[2]) {
  const int t = threadIdx.x & 127, lane = t & 31;
  const int r = row0 + 16 * (t >> 5) + (lane >> 2);
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = r + 8 * half;
      *reinterpret_cast<uint32_t*>(tile + sw128_offset(rows, row, j) + (lane & 3) * 4) =
          Op::pack(acc[4 * j + 2 * half] * mul[half], acc[4 * j + 2 * half + 1] * mul[half]);
    }
  }
}

// Copies rows row0..row0+63 of the tile to dst + i * row_stride (elements)
// for i < valid, 16 bytes per thread and store; the warpgroup's 128 threads
// share the work.
template <int D>
__device__ __forceinline__ void copy_rows_out(const unsigned char* tile, int rows,
                                              int row0, uint16_t* dst,
                                              long long row_stride, int valid) {
  const int t = threadIdx.x & 127;
  for (int u = t; u < 64 * (D / 8); u += 128) {
    const int i = u / (D / 8), unit = u % (D / 8);
    if (i < valid) {
      *reinterpret_cast<uint4*>(dst + i * row_stride + unit * 8) =
          *reinterpret_cast<const uint4*>(tile + sw128_offset(rows, row0 + i, unit));
    }
  }
}

// ---------------------------------------------------------------------------
// host: tensor maps
// ---------------------------------------------------------------------------
using EncodeTiledFn = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                   const cuuint64_t*, const cuuint64_t*,
                                   const cuuint32_t*, const cuuint32_t*,
                                   CUtensorMapInterleave, CUtensorMapSwizzle,
                                   CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiledFn encode_tiled() {
  static const EncodeTiledFn fn = [] {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault,
                                &found) != cudaSuccess ||
        found != cudaDriverEntryPointSuccess) {
      return static_cast<EncodeTiledFn>(nullptr);
    }
    return reinterpret_cast<EncodeTiledFn>(ptr);
  }();
  return fn;
}

// A map over a [B, T, H, D] 16-bit tensor with element strides sb, st, sh
// (head_dim contiguous), as dims (D, H, T, B) innermost first, whose box is
// `rows` positions of one head by 64 columns: one swizzled chunk.
inline cudaError_t make_tile_map(CUtensorMap* map, const void* base, bool f16, int B,
                                 int T, int H, int D, long long sb, long long st,
                                 long long sh, int rows) {
  const EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return cudaErrorSymbolNotFound;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D), static_cast<cuuint64_t>(H),
                              static_cast<cuuint64_t>(T), static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(sh) * 2,
                                 static_cast<cuuint64_t>(st) * 2,
                                 static_cast<cuuint64_t>(sb) * 2};
  const cuuint32_t box[4] = {64, 1, static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t elem_strides[4] = {1, 1, 1, 1};
  const CUresult r =
      fn(map, f16 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
         const_cast<void*>(base), dims, strides, box, elem_strides,
         CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
         CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

}  // namespace ds_hopper
