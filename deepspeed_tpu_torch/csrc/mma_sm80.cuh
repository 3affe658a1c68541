// mma.sync helpers shared by the flash-attention kernels (forward and
// backward): the m16n8k16 bf16/f16 tensor-core product with f32
// accumulation, fragment packing, and 16-byte tile staging into shared
// memory. Fragment layout (PTX ISA, mma.m16n8k16): with lane = 4 * g + tq,
//   A (16 x 16, row-major): a0 = (row g,   cols 2tq, 2tq+1)
//                           a1 = (row g+8, cols 2tq, 2tq+1)
//                           a2 = (row g,   cols 2tq+8, 2tq+9)
//                           a3 = (row g+8, cols 2tq+8, 2tq+9)
//   B (16 x 8, col-major):  b0 = (rows 2tq, 2tq+1 of col g), b1 = rows +8
//   C (16 x 8, f32):        c0, c1 = (row g, cols 2tq, 2tq+1), c2, c3 = row g+8
// so the C fragments of two neighbouring n-tiles re-pack directly into the
// A fragment of one 16-wide k-step.

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

namespace ds_mma {

constexpr float NEG_INF = -1e30f;

struct Bf16 {
  static constexpr bool kF16 = false;  // picks the wgmma operand type
  __device__ static void mma(float c[4], const uint32_t a[4],
                             const uint32_t b[2]) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  }
  __device__ static uint32_t pack(float lo, float hi) {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  }
};

struct Fp16 {
  static constexpr bool kF16 = true;
  __device__ static void mma(float c[4], const uint32_t a[4],
                             const uint32_t b[2]) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  }
  __device__ static uint32_t pack(float lo, float hi) {
    __half2 v = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  }
};

__device__ __forceinline__ uint32_t ld32(const uint16_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Two 16-bit values one row apart (a column pair of a row-major tile):
// the B fragment of a product whose k index runs down the rows.
__device__ __forceinline__ uint32_t ld_col2(const uint16_t* p, int ld) {
  return static_cast<uint32_t>(p[0]) | (static_cast<uint32_t>(p[ld]) << 16);
}

// Stage `rows` rows of a [.., T, .., D] operand into shared memory with
// 16-byte loads; rows at or past T are zero-filled.
template <int D, int LD>
__device__ __forceinline__ void load_tile16(uint16_t* dst, const uint16_t* src,
                                            long long st, int t0, int T,
                                            int rows) {
  constexpr int CH = D / 8;  // 16-byte chunks per row
  for (int i = threadIdx.x; i < rows * CH; i += blockDim.x) {
    const int r = i / CH, c = i % CH;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (t0 + r < T) {
      val = *reinterpret_cast<const uint4*>(src + (t0 + r) * st + c * 8);
    }
    *reinterpret_cast<uint4*>(dst + r * LD + c * 8) = val;
  }
}

}  // namespace ds_mma
