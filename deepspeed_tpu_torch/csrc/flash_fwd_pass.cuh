// The consumer pass of the wgmma attention forward, shared by the flash
// forward (B1, flash_attention_fwd.cu) and the block-sparse forward (B5,
// block_sparse_attention.cu). The two kernels differ only in which K/V tiles
// they walk: B1 walks the tiles from the first to the causal diagonal, B5
// walks a query block's active key blocks from its index table.
//
// The shape both share: one block = 128 query rows of one (batch, head) and
// three warpgroups. A producer warp loads Q once and then 128-key K/V tiles
// through a two-stage ring by TMA (128-byte swizzle, a full mbarrier with
// transaction bytes and an empty mbarrier with one arrival per consumer per
// stage). Two consumer warpgroups own 64 rows each and use a tile in two
// passes of 64 keys (`fwd_pass`): S = Q K^T as SS wgmma m64n64k16 (both
// operands K-major), the online softmax in f32 registers in log2 units, P
// rounded to the input type and re-packed from the accumulator as the
// register A operand of O += P V, an RS wgmma that reads V from shared
// memory with the transpose bit. A pass runs the per-element compare/select
// only when the caller says it may hold a masked pair; a masked score takes
// the finite NEG_INF, so a masked key gets exactly zero weight once the row
// has seen a visible key.

#pragma once

#include <stdint.h>

#include "hopper.cuh"
#include "mma_sm80.cuh"

namespace ds_fwd {

using namespace ds_hopper;
using ds_mma::NEG_INF;

constexpr float LN2 = 0.6931471805599453f;

constexpr int WG_BM = 128;  // query rows per block: two consumers x 64
constexpr int WG_BN = 128;  // keys per K/V tile
constexpr int WG_KH = 64;   // keys per softmax pass over a tile

// byte offsets from the 1024-aligned start of dynamic shared memory
template <int D>
struct FwdLayout {
  static constexpr int kTile = WG_BN * D * 2;  // one K or V tile (and the Q tile)
  static constexpr int kQ = 0;
  static constexpr int kKV = kQ + WG_BM * D * 2;  // stage s: K, then V
  static constexpr int kSeg = kKV + WG_STAGES * 2 * kTile;  // [stage][key] ids
  static constexpr int kBar = kSeg + WG_STAGES * WG_BN * 4;  // q, full[], empty[]
  static constexpr int kBytes = kBar + 8 * (1 + 2 * WG_STAGES) + 1024;  // + align
};

// One consumer thread's rows r0 and r0 + 8 (r0 = first row + 16 * warp +
// lane / 4): the running max in log2 units, its partial row sums and its
// D / 2 accumulators of O (element 4 j + e at row r0 + 8 (e >> 1), column
// 8 j + 2 tq + (e & 1), tq = lane % 4).
template <int D>
struct FwdRows {
  float m[2];
  float l[2];
  float o[D / 2];
  int tq;

  __device__ __forceinline__ void init() {
    tq = threadIdx.x & 3;
    m[0] = m[1] = NEG_INF;
    l[0] = l[1] = 0.f;
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  }

  // Sums l over the four threads of each row. Then per row: the factor
  // that turns the accumulators into O (0 for a row that saw no key, so
  // its O is 0) and the logsumexp in natural-log units (NEG_INF there).
  __device__ __forceinline__ void finish(float (&inv)[2], float (&lse)[2]) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
      const bool seen = l[i] > 0.f;
      inv[i] = seen ? 1.f / l[i] : 0.f;
      lse[i] = seen ? m[i] * LN2 + logf(l[i]) : NEG_INF;
    }
  }
};

// Pass hk (keys hk * WG_KH ..) of the K/V tile at shared addresses ka, va
// for the consumer whose Q rows `q_desc` describes. `sl2` = scale * log2 e.
// With `masked`, ok(kl, e) says whether accumulator element e of key
// column kl (0..WG_BN-1 within the tile) is visible; without it every pair
// is. Keep ok cheap (a compare against a per-row limit): it runs per
// element.
template <typename Op, int D, typename Ok>
__device__ __forceinline__ void fwd_pass(FwdRows<D>& st, uint64_t q_desc, uint32_t ka,
                                         uint32_t va, int hk, float sl2, bool masked,
                                         Ok ok) {
  const int tq = st.tq;
  const uint64_t qd = opaque(q_desc);
  const uint64_t kd = opaque(desc_sw128(ka, 16, 1024)) + ((hk * WG_KH * 128) >> 4);
  float sc[WG_KH / 2];
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    wgmma_ss<WG_KH, Op::kF16>(sc, qd + kmajor_step(WG_BM, kk), kd + kmajor_step(WG_BN, kk),
                              kk > 0);
  }
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(sc);

  if (masked) {
#pragma unroll
    for (int jn = 0; jn < WG_KH / 8; ++jn) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kl = hk * WG_KH + jn * 8 + tq * 2 + (e & 1);
        sc[4 * jn + e] = ok(kl, e) ? sc[4 * jn + e] * sl2 : NEG_INF;
      }
    }
  } else {
#pragma unroll
    for (int i = 0; i < WG_KH / 2; ++i) sc[i] *= sl2;
  }

  // online softmax; element 4 jn + e sits at row r0 + 8 (e >> 1)
  float mx[2] = {st.m[0], st.m[1]};
#pragma unroll
  for (int jn = 0; jn < WG_KH / 8; ++jn) {
    mx[0] = fmaxf(mx[0], fmaxf(sc[4 * jn], sc[4 * jn + 1]));
    mx[1] = fmaxf(mx[1], fmaxf(sc[4 * jn + 2], sc[4 * jn + 3]));
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
  }
  const float alpha[2] = {exp2f(st.m[0] - mx[0]), exp2f(st.m[1] - mx[1])};
  st.m[0] = mx[0];
  st.m[1] = mx[1];
  float rs[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < WG_KH / 2; ++i) {
    sc[i] = exp2f(sc[i] - mx[(i >> 1) & 1]);
    rs[(i >> 1) & 1] += sc[i];
  }
  st.l[0] = st.l[0] * alpha[0] + rs[0];
  st.l[1] = st.l[1] * alpha[1] + rs[1];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) st.o[i] *= alpha[(i >> 1) & 1];

  // O += P V: the accumulators of key columns 16kk..16kk+15 are the A
  // fragment of k-step kk
  uint32_t pa[WG_KH / 16][4];
#pragma unroll
  for (int kk = 0; kk < WG_KH / 16; ++kk) {
#pragma unroll
    for (int r = 0; r < 4; ++r) pa[kk][r] = Op::pack(sc[8 * kk + 2 * r], sc[8 * kk + 2 * r + 1]);
  }
  const uint64_t vd = opaque(desc_sw128(va, WG_BN * 128, 1024));
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < WG_KH / 16; ++kk) {
    wgmma_rs<D, Op::kF16>(st.o, pa[kk], vd + mnmajor_step(hk * WG_KH / 16 + kk));
  }
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(st.o);
}

}  // namespace ds_fwd
