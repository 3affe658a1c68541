// What the wgmma attention backward kernels share: the flash backward (B2
// and B3, flash_attention_bwd.cu) and the block-sparse backward (B6 and B7,
// block_sparse_attention.cu). The kernels differ in which tiles they walk:
// the flash kernels the tiles up to (dQ) or from (dK, dV) the causal
// diagonal, the block-sparse kernels a query block's active key blocks (dQ)
// or a key block's active query blocks (dK, dV) from their index tables.
//
// dQ (B2, B6; `dq_pass`): one block = 128 query rows of one (batch, head)
// and three warpgroups. A producer warp stages the rows' lse (times log2 e)
// and delta, loads Q and dO once by TMA, then 128-key K/V tiles through a
// two-stage ring. Two consumer warpgroups own 64 rows each, hold dQ in
// registers and use a tile in two passes of 64 keys: S = Q K^T and dP =
// dO V^T as SS wgmma m64n64k16, P = exp2(S scale log2 e - lse log2 e) and
// dS = P (dP - delta) in f32, dS rounded to the input type and re-packed as
// the register A operand of dQ += dS K, an RS wgmma that reads K with the
// transpose bit. A pass's dQ product runs on while the next pass's S and
// dP are issued. A pass runs the per-element compare/select only when the
// caller says it may hold a masked pair; a masked pair gets P = 0 exactly,
// and a row whose lse is staged as +infinity (a row that sees no key at
// all) gets P = exp2(-inf) = 0 and dS = 0 without any compare.
//
// dK, dV (B3, B7): one block = 128 keys, K and V resident, 64-row Q and dO
// tiles streamed through the ring (`DkvLayout`). The two kernels keep their
// own copies of the per-tile consumer body: B3 called through a shared
// function spilled more and ran 5-9% slower than its inline body on an H100
// (chip_smoke.py --against), while B7 ran the same either way.

#pragma once

#include <stdint.h>

#include "hopper.cuh"

namespace ds_bwd {

using namespace ds_hopper;

// dK/dV: keys per block (two consumers x 64), query rows per streamed tile,
// query columns per pass over a tile
constexpr int WG_BK = 128;
constexpr int WG_BQ = 64;
constexpr int WG_QH = 32;
// dQ: query rows per block (two consumers x 64), keys per K/V tile, keys
// per pass over a tile
constexpr int DQ_BM = 128;
constexpr int DQ_BN = 128;
constexpr int DQ_KH = 64;

// byte offsets from the 1024-aligned start of dynamic shared memory
template <int D>
struct DkvLayout {
  static constexpr int kKV = WG_BK * D * 2;  // the K (and the V) tile
  static constexpr int kQ = WG_BQ * D * 2;   // one Q (and one dO) tile
  static constexpr int kK = 0;
  static constexpr int kV = kK + kKV;
  static constexpr int kStage = kV + kKV;    // stage s: Q, then dO
  // [stage][lse * log2 e, delta, segment id][row]
  static constexpr int kRows = kStage + WG_STAGES * 2 * kQ;
  static constexpr int kBar = kRows + WG_STAGES * 3 * WG_BQ * 4;  // kv, full[], empty[]
  static constexpr int kBytes = kBar + 8 * (1 + 2 * WG_STAGES) + 1024;  // + align
};

template <int D>
struct DqLayout {
  static constexpr int kTile = DQ_BN * D * 2;  // one K or V tile
  static constexpr int kQ = 0;
  static constexpr int kDO = kQ + DQ_BM * D * 2;
  static constexpr int kKV = kDO + DQ_BM * D * 2;  // stage s: K, then V
  // [lse * log2 e, delta][row]
  static constexpr int kRows = kKV + WG_STAGES * 2 * kTile;
  static constexpr int kSeg = kRows + 2 * DQ_BM * 4;  // [stage][key] ids
  static constexpr int kBar = kSeg + WG_STAGES * DQ_BN * 4;  // q, full[], empty[]
  static constexpr int kBytes = kBar + 8 * (1 + 2 * WG_STAGES) + 1024;  // + align
};

// Pass hk (keys hk * DQ_KH ..) of the K/V tile at shared addresses ka, va
// for the consumer whose Q and dO rows `q_desc`, `do_desc` describe; its
// rows' lse (times log2 e) and delta are lse2, delta; `sl2` = scale * log2 e.
// `retired()` runs once the S and dP products are waited for, which also
// retires the previous pass's dQ products. With `masked`, ok(kl, e) says
// whether accumulator element e of key column kl (0..DQ_BN-1 within the
// tile) is visible; keep it to a compare against a per-row limit. The pass's
// dQ products are left in flight.
template <typename Op, int D, typename Ok, typename Retired>
__device__ __forceinline__ void dq_pass(float (&dq)[D / 2], uint64_t q_desc,
                                        uint64_t do_desc, uint32_t ka, uint32_t va, int hk,
                                        float sl2, const float (&lse2)[2],
                                        const float (&delta)[2], int tq, bool masked, Ok ok,
                                        Retired retired) {
  // S = Q K^T and dP = dO V^T over the pass's keys
  const uint64_t first = (hk * DQ_KH * 128) >> 4;  // its first key row
  const uint64_t qd = opaque(q_desc), dd = opaque(do_desc);
  const uint64_t kd = opaque(desc_sw128(ka, 16, 1024)) + first;
  const uint64_t vd = opaque(desc_sw128(va, 16, 1024)) + first;
  float sc[DQ_KH / 2], dp[DQ_KH / 2];
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    wgmma_ss<DQ_KH, Op::kF16>(sc, qd + kmajor_step(DQ_BM, kk), kd + kmajor_step(DQ_BN, kk),
                              kk > 0);
  }
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    wgmma_ss<DQ_KH, Op::kF16>(dp, dd + kmajor_step(DQ_BM, kk), vd + kmajor_step(DQ_BN, kk),
                              kk > 0);
  }
  wgmma_commit();
  wgmma_wait<0>();  // also retires the previous pass's dQ products
  fence_regs(sc);
  fence_regs(dp);
  retired();

  // P = exp2(S scale log2 e - lse log2 e), exactly 0 where masked;
  // dS = P (dP - delta). Element 4 jn + e sits at row r0 + 8 (e >> 1).
#pragma unroll
  for (int jn = 0; jn < DQ_KH / 8; ++jn) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = 4 * jn + e;
      float pr = exp2f(sc[i] * sl2 - lse2[e >> 1]);
      if (masked) {
        const int kl = hk * DQ_KH + jn * 8 + tq * 2 + (e & 1);
        pr = ok(kl, e) ? pr : 0.f;
      }
      sc[i] = pr * (dp[i] - delta[e >> 1]);
    }
  }
  // dQ += dS K: dS rounded to the input type and re-packed from the
  // accumulator as the A fragments; K read with the transpose bit
  uint32_t dsa[DQ_KH / 16][4];
#pragma unroll
  for (int kk = 0; kk < DQ_KH / 16; ++kk) {
#pragma unroll
    for (int r = 0; r < 4; ++r) dsa[kk][r] = Op::pack(sc[8 * kk + 2 * r], sc[8 * kk + 2 * r + 1]);
  }
  const uint64_t kt = opaque(desc_sw128(ka, DQ_BN * 128, 1024));
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < DQ_KH / 16; ++kk) {
    wgmma_rs<D, Op::kF16>(dq, dsa[kk], kt + mnmajor_step(hk * DQ_KH / 16 + kk));
  }
  wgmma_commit();
}

}  // namespace ds_bwd
