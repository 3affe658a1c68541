// Block-sparse attention for Hopper (sm_90a): forward, dQ and dK/dV.
//
// Replaces the Pallas TPU kernels of deepspeed_tpu/ops/sparse_attention/
// sparse_self_attention.py: `_fwd_kernel` (line 84; B5), `_dq_kernel`
// (line 129; B6) and `_dkv_kernel` (line 168; B7), launched by `_build_op`
// (line 221). Attention over [B, T, H, D] restricted to the active
// [block, block] tiles of a layout: B5 streams each query row's active key
// blocks with an online softmax and writes O and the per-row logsumexp; the
// backward recomputes P = exp(scale * Q K^T - lse) from it, with
// delta = rowsum(O * dO) computed beforehand (by the caller, in f32):
//   dQ = scale * dS K,   dK = scale * dS^T Q,   dV = P^T dO,
//   dS = P * (dO V^T - delta).
//
// What bounds it on an H100: at BERT-Large's BigBird shape (B=1, T=4096,
// H=16, D=64, block 128, 183 of 1024 tiles active) B5 does 12.3 GFLOP of
// tensor-core work against 33.8 MB of q, k, v, o and lse: 12.4 us at
// 989 TFLOP/s, 10.1 us at 3.35 TB/s; B6 and B7 do 1.5x and 2x the products.
// The grid is small (16 x 32 query blocks) and the work per block uneven
// (a BigBird global row walks all 32 key blocks, a band row 4-5), so the
// slowest row sets the time unless the long rows are cut up. Scores and
// probabilities never leave the chip, and only active tiles are ever
// loaded or multiplied.
//
// Index tables instead of the TPU's padded scalar-prefetch rows: `idx`
// [HL, n_blocks, width] lists each row's (B5, B6) or column's (B7) active
// blocks in ascending order and `cnt` [HL, n_blocks] their count; head h
// reads table h % HL. Each block loops over its own row's count, not the
// widest row's.
//
// At block 128 in bf16, D = 64 and 128, all three are Hopper kernels on the
// flash kernels' consumer passes, with the dense tile loop replaced by a
// walk over the table:
// * B5 (`sparse_fwd_wgmma_kernel`): B1's design (flash_fwd_pass.cuh). One
//   block = 128 query rows of one (batch, head) and three warpgroups: a
//   producer thread loads Q by TMA once, reads the row's active blocks from
//   the table and TMA-loads each active K/V block at that block's coordinate
//   through a two-stage ring; two consumer warpgroups own 64 rows each and
//   use each block in two 64-key passes (S as SS wgmma, online softmax in
//   log2 units, P rounded, O += P V as RS wgmma with V read by the
//   transpose bit).
// * B6 (`sparse_dq_wgmma_kernel`): B2's design (flash_bwd_pass.cuh,
//   `dq_pass`). One block = one query block: Q, dO, lse (times log2 e) and
//   delta loaded once, the row's active K/V blocks through the ring, dQ in
//   registers; per 64-key pass S and dP as SS wgmma, dQ += dS K as RS wgmma.
// * B7 (`sparse_dkv_wgmma_kernel`): B3's design, with its own copy of B3's
//   consumer body. One block = one key block: K and V loaded once and
//   resident, the column's active query blocks streamed as 64-row Q/dO
//   tiles with their lse and delta, dK and dV in registers; per 32-query
//   pass S^T and dP^T as SS wgmma, dV += P^T dO and dK += dS^T Q as RS
//   wgmma.
// * The layout is the mask: bidirectional blocks run no compare at all;
//   under causal only the diagonal block compares (one int compare per
//   element against a per-row last key or per-key first query), B5's and
//   B6's walks end at the first block past the diagonal and B7's starts at
//   the diagonal.
// * A row that sees no key (lse = NEG_INF) is staged by B6's and B7's
//   producers with lse (times log2 e) = +infinity, so P = exp2(s - inf) = 0
//   and dS = 0 without a compare.
// * Grid order (`order`, built on the host per layout and cached with the
//   tables): the table rows (B5, B6) or columns (B7) with the most active
//   blocks go first, so a BigBird global row or column starts at once and
//   the band blocks fill the tail. With that order, cutting the global rows
//   into chunks merged by their last block gained at most 1% for B5 on an
//   H100 at BERT-Large's BigBird layout (and lost 5-20% with 6-8 chunks),
//   so every row and column stays whole.
//
// The other blocks (16, 32, 64) keep the first design of this port: one
// CUDA block = one query block (B5, B6) or key block (B7) of one (batch,
// head), one warp per 16 rows. mma.sync.m16n8k16 with f32 accumulators
// exactly as the flash kernels' first design (Q or K/V fragments held in
// registers, P and dS re-packed from C fragments into A fragments without
// touching shared memory); f32 inputs take plain FMA kernels over 16 x 16
// tiles. B6 and B7 read B5's lse in natural-log units.
// * No atomics: B6 owns a q-tile and B7 owns a k-tile, and each walks its
//   active tiles in a fixed order, so every gradient element is written
//   once and the backward is bit-reproducible; B5 writes each output row
//   from one block too.
// * Masks: the layout (inactive tiles are never visited), and with `causal`
//   q_pos >= k_pos; sub-tiles wholly in the future are skipped, which is
//   exact. A masked pair gets P = 0 exactly. A row with no visible key yet
//   contributes nothing; a row with none at all ends with O = 0 and
//   lse = NEG_INF, and the backward gives 0 there, never NaN.
// * q, k, v are read in [B, T, H, D] through their strides (views into the
//   fused qkv projection); dO, O, dQ, dK and dV are [B, T, H, D] contiguous,
//   lse and delta [B, H, T] f32. T is a multiple of `block`.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "flash_bwd_pass.cuh"
#include "flash_fwd_pass.cuh"
#include "hopper.cuh"
#include "mma_sm80.cuh"

namespace {

using namespace ds_hopper;
using namespace ds_bwd;
using namespace ds_fwd;
using ds_mma::Bf16;
using ds_mma::ld32;
using ds_mma::ld_col2;
using ds_mma::load_tile16;
using ds_mma::NEG_INF;

// a score at or below this is masked (the finite NEG_INF or a sum with it)
constexpr float MASKED = 0.5f * NEG_INF;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;    // [B, T, H, D] contiguous (backward)
  const float* lse;    // [B, H, T]: written by B5, read by B6 and B7
  const float* delta;  // [B, H, T] (backward)
  void* o;             // B5: O; B6: dQ; B7: dK
  void* o2;            // B7: dV
  const int* idx;      // [HL, nb, width] active blocks, ascending
  const int* cnt;      // [HL, nb]
  int width, HL, block;
  const int* order;    // [HL * nb] at block 128: table rows, longest first
  int B, T, H;
  long long q_sb, q_st, q_sh;
  long long k_sb, k_st, k_sh;
  long long v_sb, v_st, v_sh;
  float scale;
  int causal;
};

// The active list of table row `r` (a q-block for B5/B6, a k-block for B7)
// of head h.
struct Active {
  const int* blocks;
  int n;
};

__device__ __forceinline__ Active active_of(const Params& p, int h, int r) {
  const long long row = static_cast<long long>(h % p.HL) * (p.T / p.block) + r;
  return {p.idx + row * p.width, p.cnt[row]};
}

// ---------------------------------------------------------------------------
// 16-bit path: mma.sync m16n8k16, f32 accumulate
// ---------------------------------------------------------------------------

// B5: one block = one query block (TILE = block rows) of one (batch, head).
template <typename Op, int D, int TILE>
__global__ void __launch_bounds__(TILE * 2) sparse_fwd_mma_kernel(const Params p) {
  constexpr int LD = D + 8;  // padded row: 16-byte aligned, staggers banks
  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint16_t* sQ = reinterpret_cast<uint16_t*>(smem_raw);
  uint16_t* sK = sQ + TILE * LD;
  uint16_t* sV = sK + TILE * LD;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int bh = blockIdx.x, b = bh / p.H, h = bh % p.H;
  const int q0 = blockIdx.y * TILE;
  const int T = p.T;

  const uint16_t* Q = static_cast<const uint16_t*>(p.q) + b * p.q_sb + h * p.q_sh;
  const uint16_t* K = static_cast<const uint16_t*>(p.k) + b * p.k_sb + h * p.k_sh;
  const uint16_t* V = static_cast<const uint16_t*>(p.v) + b * p.v_sb + h * p.v_sh;

  load_tile16<D, LD>(sQ, Q, p.q_st, q0, T, TILE);
  __syncthreads();

  uint32_t qa[D / 16][4];
  const int r0 = warp * 16 + g;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int c = kk * 16 + tq * 2;
    qa[kk][0] = ld32(sQ + r0 * LD + c);
    qa[kk][1] = ld32(sQ + (r0 + 8) * LD + c);
    qa[kk][2] = ld32(sQ + r0 * LD + c + 8);
    qa[kk][3] = ld32(sQ + (r0 + 8) * LD + c + 8);
  }
  const int qrow[2] = {q0 + r0, q0 + r0 + 8};

  float m_r[2] = {NEG_INF, NEG_INF};
  float l_r[2] = {0.f, 0.f};  // this thread's partial row sums
  float acc[D / 8][4];
#pragma unroll
  for (int dn = 0; dn < D / 8; ++dn) {
    acc[dn][0] = acc[dn][1] = acc[dn][2] = acc[dn][3] = 0.f;
  }

  const Active act = active_of(p, h, q0 / p.block);
  for (int a = 0; a < act.n; ++a) {
    const int k0 = act.blocks[a] * TILE;
    if (p.causal && k0 > q0 + TILE - 1) break;  // this and later keys are future
    __syncthreads();  // every warp is done with the previous tile
    load_tile16<D, LD>(sK, K, p.k_st, k0, T, TILE);
    load_tile16<D, LD>(sV, V, p.v_st, k0, T, TILE);
    __syncthreads();

    float s[TILE / 8][4];
#pragma unroll
    for (int jn = 0; jn < TILE / 8; ++jn) {
      s[jn][0] = s[jn][1] = s[jn][2] = s[jn][3] = 0.f;
      const uint16_t* krow = sK + (jn * 8 + g) * LD + tq * 2;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t kb[2] = {ld32(krow + kk * 16), ld32(krow + kk * 16 + 8)};
        Op::mma(s[jn], qa[kk], kb);
      }
    }

    // scale and mask; element e sits at row qrow[e >> 1], key col + (e & 1)
    float mx[2] = {m_r[0], m_r[1]};
#pragma unroll
    for (int jn = 0; jn < TILE / 8; ++jn) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = k0 + jn * 8 + tq * 2 + (e & 1);
        const bool ok = !p.causal || col <= qrow[e >> 1];
        s[jn][e] = ok ? s[jn][e] * p.scale : NEG_INF;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[jn][e]);
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
    }
    // a row with no visible key yet keeps alpha = exp(0) = 1 on zeros
    const float alpha[2] = {__expf(m_r[0] - mx[0]), __expf(m_r[1] - mx[1])};
    m_r[0] = mx[0];
    m_r[1] = mx[1];

    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int jn = 0; jn < TILE / 8; ++jn) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[jn][e] = s[jn][e] > MASKED ? __expf(s[jn][e] - mx[e >> 1]) : 0.f;
        rs[e >> 1] += s[jn][e];
      }
    }
    l_r[0] = l_r[0] * alpha[0] + rs[0];
    l_r[1] = l_r[1] * alpha[1] + rs[1];
#pragma unroll
    for (int dn = 0; dn < D / 8; ++dn) {
      acc[dn][0] *= alpha[0];
      acc[dn][1] *= alpha[0];
      acc[dn][2] *= alpha[1];
      acc[dn][3] *= alpha[1];
    }

    // O += P V: the C fragments of n-tiles 2kk, 2kk+1 are the A fragment
    // of k-step kk; V is read as B with k = key, n = head column
#pragma unroll
    for (int kk = 0; kk < TILE / 16; ++kk) {
      const uint32_t pa[4] = {
          Op::pack(s[2 * kk][0], s[2 * kk][1]),
          Op::pack(s[2 * kk][2], s[2 * kk][3]),
          Op::pack(s[2 * kk + 1][0], s[2 * kk + 1][1]),
          Op::pack(s[2 * kk + 1][2], s[2 * kk + 1][3]),
      };
      const uint16_t* vrow = sV + (kk * 16 + tq * 2) * LD + g;
#pragma unroll
      for (int dn = 0; dn < D / 8; ++dn) {
        const uint16_t* vp = vrow + dn * 8;
        const uint32_t vb[2] = {ld_col2(vp, LD), ld_col2(vp + 8 * LD, LD)};
        Op::mma(acc[dn], pa, vb);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l_r[i] += __shfl_xor_sync(0xffffffffu, l_r[i], 1);
    l_r[i] += __shfl_xor_sync(0xffffffffu, l_r[i], 2);
  }
  uint16_t* O = static_cast<uint16_t*>(p.o);
  float* lse = const_cast<float*>(p.lse);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = qrow[i];
    const bool seen = l_r[i] > 0.f;
    const float inv = seen ? 1.f / l_r[i] : 0.f;
    uint16_t* orow = O + ((static_cast<long long>(b) * T + row) * p.H + h) * D;
#pragma unroll
    for (int dn = 0; dn < D / 8; ++dn) {
      *reinterpret_cast<uint32_t*>(orow + dn * 8 + tq * 2) =
          Op::pack(acc[dn][2 * i] * inv, acc[dn][2 * i + 1] * inv);
    }
    if (tq == 0) {
      lse[static_cast<long long>(bh) * T + row] = seen ? m_r[i] + logf(l_r[i]) : NEG_INF;
    }
  }
}

// The row or column of the table that block blockIdx.x takes at block 128:
// the table rows (B5, B6) or columns (B7) in `order`, longest first, each
// run for every batch row and every head that shares its layout, one after
// another in the grid.
struct Walk {
  int b, h, blk;      // batch row, head, this block's q-block (B6) or k-block (B7)
  const int* blocks;  // its active blocks, ascending
  int n;
};

__device__ __forceinline__ Walk walk_of(const Params& p, int per_table) {
  const int x = blockIdx.x, G = p.H / p.HL, per = p.B * G;
  const int row = p.order[x / per];
  return {(x % per) / G, row / per_table + p.HL * (x % G), row % per_table,
          p.idx + static_cast<long long>(row) * p.width, p.cnt[row]};
}

// B5 at block 128, D = 64 and 128: wgmma + TMA, warp-specialised, on the
// consumer pass it shares with B1 (flash_fwd_pass.cuh). One block = one
// query block of one (batch, head), taken from the row order table.
template <typename Op, int D>
__global__ void __launch_bounds__(WG_THREADS, 1)
    sparse_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap map_q,
                            const __grid_constant__ CUtensorMap map_k,
                            const __grid_constant__ CUtensorMap map_v, const Params p) {
  using L = FwdLayout<D>;
  extern __shared__ __align__(16) unsigned char smem_raw[];  // aligned below
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* smem = smem_raw + (base - raw);
  const uint32_t bar_q = base + L::kBar;
  const uint32_t bar_full = bar_q + 8, bar_empty = bar_full + 8 * WG_STAGES;

  const int T = p.T;
  const Walk w = walk_of(p, T / WG_BM);
  const int b = w.b, h = w.h, qb = w.blk, q0 = qb * WG_BM;
  const int* blocks = w.blocks;
  // causal: the walk ends at the first block past the diagonal (the entries
  // ascend)
  int n = w.n;
  if (p.causal) {
    int seen = 0;
    while (seen < n && blocks[seen] <= qb) ++seen;
    n = seen;
  }

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < WG_STAGES; ++s) {
      mbar_init(bar_full + 8 * s, 1);
      mbar_init(bar_empty + 8 * s, 2);  // one arrival per consumer warpgroup
    }
    fence_barrier_init();
  }
  __syncthreads();

  const int wg = __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x) / 128, 0);
  if (wg == 0) {
    // producer: one thread loads Q, then the active K/V blocks through the
    // ring, each at its own block's coordinate
    setmaxnreg_dec<24>();
    if (threadIdx.x == 0) {
      mbar_arrive_expect_tx(bar_q, WG_BM * D * 2);
      for (int c = 0; c < D / 64; ++c) {
        tma_load_4d(base + L::kQ + c * WG_BM * 128, &map_q, bar_q, c * 64, h, q0, b);
      }
      for (int j = 0; j < n; ++j) {
        const int s = j % WG_STAGES, k0 = blocks[j] * WG_BN;
        mbar_wait(bar_empty + 8 * s, ((j / WG_STAGES) & 1) ^ 1);
        const uint32_t full = bar_full + 8 * s;
        const uint32_t dst = base + L::kKV + s * 2 * L::kTile;
        mbar_arrive_expect_tx(full, 2 * L::kTile);
        for (int c = 0; c < D / 64; ++c) {
          tma_load_4d(dst + c * WG_BN * 128, &map_k, full, c * 64, h, k0, b);
          tma_load_4d(dst + L::kTile + c * WG_BN * 128, &map_v, full, c * 64, h, k0, b);
        }
      }
    }
  } else {
    // consumers: warpgroup c owns rows q0 + 64c .. q0 + 64c + 63
    setmaxnreg_inc<240>();
    const int c = wg - 1;
    const int t = threadIdx.x & 127, lane = t & 31;
    const int r0 = q0 + 64 * c + 16 * (t >> 5) + (lane >> 2);  // rows r0, r0 + 8
    const int first_row = q0 + 64 * c;
    const float sl2 = p.scale * LOG2E;
    const bool causal = p.causal;
    FwdRows<D> st;
    st.init();
    const uint64_t q_desc = desc_sw128(base + L::kQ + 64 * c * 128, 16, 1024);

    mbar_wait(bar_q, 0);
    for (int j = 0; j < n; ++j) {
      const int s = j % WG_STAGES, k0 = blocks[j] * WG_BN;
      mbar_wait(bar_full + 8 * s, (j / WG_STAGES) & 1);
      const uint32_t ka = base + L::kKV + s * 2 * L::kTile, va = ka + L::kTile;
      // the layout is the mask: only the causal diagonal block compares,
      // each row against its own position
      const bool diag = causal && k0 == q0;
      const int last[2] = {r0 - k0, r0 + 8 - k0};
#pragma unroll
      for (int hk = 0; hk < WG_BN / WG_KH; ++hk) {
        const int kp = k0 + hk * WG_KH;
        if (diag && kp > first_row + 63) continue;  // every key after every row
        fwd_pass<Op, D>(st, q_desc, ka, va, hk, sl2, diag && kp + WG_KH - 1 > first_row,
                        [&](int kl, int e) { return kl <= last[e >> 1]; });
      }
      if (t == 0) mbar_arrive(bar_empty + 8 * s);
    }

    // O / l through this warpgroup's own rows of the Q tile, then 16-byte
    // stores; a row that saw no key gets O = 0 and lse = NEG_INF
    float inv[2], lse[2];
    st.finish(inv, lse);
    stage_acc<Op, D>(smem + L::kQ, WG_BM, 64 * c, st.o, inv);
    named_bar_sync(1 + c, 128);
    copy_rows_out<D>(smem + L::kQ, WG_BM, 64 * c,
                     static_cast<uint16_t*>(p.o) +
                         (static_cast<long long>(b) * T + first_row) * p.H * D + h * D,
                     static_cast<long long>(p.H) * D, 64);
    if (st.tq == 0) {
      float* out = const_cast<float*>(p.lse) + static_cast<long long>(b * p.H + h) * T;
      out[r0] = lse[0];
      out[r0 + 8] = lse[1];
    }
  }
}

// B6: one block = one query block (TILE = block rows) of one (batch, head),
// over the row's active key blocks.
template <typename Op, int D, int TILE>
__global__ void __launch_bounds__(TILE * 2) sparse_dq_mma_kernel(const Params p) {
  constexpr int LD = D + 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint16_t* sQ = reinterpret_cast<uint16_t*>(smem_raw);
  uint16_t* sdO = sQ + TILE * LD;
  uint16_t* sK = sdO + TILE * LD;
  uint16_t* sV = sK + TILE * LD;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int bh = blockIdx.x, b = bh / p.H, h = bh % p.H;
  const int q0 = blockIdx.y * TILE;
  const int T = p.T;
  const long long dst = static_cast<long long>(p.H) * D;  // row stride of dO

  const uint16_t* Q = static_cast<const uint16_t*>(p.q) + b * p.q_sb + h * p.q_sh;
  const uint16_t* K = static_cast<const uint16_t*>(p.k) + b * p.k_sb + h * p.k_sh;
  const uint16_t* V = static_cast<const uint16_t*>(p.v) + b * p.v_sb + h * p.v_sh;
  const uint16_t* dO = static_cast<const uint16_t*>(p.dout) +
                       static_cast<long long>(b) * T * dst + h * D;

  load_tile16<D, LD>(sQ, Q, p.q_st, q0, T, TILE);
  load_tile16<D, LD>(sdO, dO, dst, q0, T, TILE);
  __syncthreads();

  uint32_t qa[D / 16][4], da[D / 16][4];
  const int r0 = warp * 16 + g;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int c = kk * 16 + tq * 2;
    qa[kk][0] = ld32(sQ + r0 * LD + c);
    qa[kk][1] = ld32(sQ + (r0 + 8) * LD + c);
    qa[kk][2] = ld32(sQ + r0 * LD + c + 8);
    qa[kk][3] = ld32(sQ + (r0 + 8) * LD + c + 8);
    da[kk][0] = ld32(sdO + r0 * LD + c);
    da[kk][1] = ld32(sdO + (r0 + 8) * LD + c);
    da[kk][2] = ld32(sdO + r0 * LD + c + 8);
    da[kk][3] = ld32(sdO + (r0 + 8) * LD + c + 8);
  }

  const int qrow[2] = {q0 + r0, q0 + r0 + 8};
  float lse_r[2], delta_r[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const long long at = static_cast<long long>(bh) * T + qrow[i];
    lse_r[i] = p.lse[at];
    delta_r[i] = p.delta[at];
  }

  float acc[D / 8][4];
#pragma unroll
  for (int dn = 0; dn < D / 8; ++dn) {
    acc[dn][0] = acc[dn][1] = acc[dn][2] = acc[dn][3] = 0.f;
  }

  const Active act = active_of(p, h, q0 / p.block);
  for (int a = 0; a < act.n; ++a) {
    const int k0 = act.blocks[a] * TILE;
    if (p.causal && k0 > q0 + TILE - 1) break;
    __syncthreads();
    load_tile16<D, LD>(sK, K, p.k_st, k0, T, TILE);
    load_tile16<D, LD>(sV, V, p.v_st, k0, T, TILE);
    __syncthreads();

    // 16 keys at a time: S and dP for two n-tiles, then dS as one A fragment
#pragma unroll 1
    for (int kk = 0; kk < TILE / 16; ++kk) {
      float s[2][4], dp[2][4];
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        s[half][0] = s[half][1] = s[half][2] = s[half][3] = 0.f;
        dp[half][0] = dp[half][1] = dp[half][2] = dp[half][3] = 0.f;
        const int key = (2 * kk + half) * 8 + g;
        const uint16_t* krow = sK + key * LD + tq * 2;
        const uint16_t* vrow = sV + key * LD + tq * 2;
#pragma unroll
        for (int dd = 0; dd < D / 16; ++dd) {
          const uint32_t kb[2] = {ld32(krow + dd * 16), ld32(krow + dd * 16 + 8)};
          const uint32_t vb[2] = {ld32(vrow + dd * 16), ld32(vrow + dd * 16 + 8)};
          Op::mma(s[half], qa[dd], kb);
          Op::mma(dp[half], da[dd], vb);
        }
      }
#pragma unroll
      for (int half = 0; half < 2; ++half) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = k0 + (2 * kk + half) * 8 + tq * 2 + (e & 1);
          const bool ok = (!p.causal || col <= qrow[e >> 1]) && lse_r[e >> 1] > MASKED;
          const float pr = ok ? __expf(s[half][e] * p.scale - lse_r[e >> 1]) : 0.f;
          s[half][e] = pr * (dp[half][e] - delta_r[e >> 1]);
        }
      }
      const uint32_t dsa[4] = {
          Op::pack(s[0][0], s[0][1]), Op::pack(s[0][2], s[0][3]),
          Op::pack(s[1][0], s[1][1]), Op::pack(s[1][2], s[1][3])};
      // dQ += dS K: K read as B with k = key, n = head column
      const uint16_t* kcol = sK + (kk * 16 + tq * 2) * LD + g;
#pragma unroll
      for (int dn = 0; dn < D / 8; ++dn) {
        const uint16_t* kp = kcol + dn * 8;
        const uint32_t kb[2] = {ld_col2(kp, LD), ld_col2(kp + 8 * LD, LD)};
        Op::mma(acc[dn], dsa, kb);
      }
    }
  }

  uint16_t* dQ = static_cast<uint16_t*>(p.o);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    uint16_t* out = dQ + ((static_cast<long long>(b) * T + qrow[i]) * p.H + h) * D;
#pragma unroll
    for (int dn = 0; dn < D / 8; ++dn) {
      *reinterpret_cast<uint32_t*>(out + dn * 8 + tq * 2) =
          Op::pack(acc[dn][2 * i] * p.scale, acc[dn][2 * i + 1] * p.scale);
    }
  }
}

// B7: one block = one key block (TILE = block keys) of one (batch, head),
// over the active q-blocks of the key block's column; each warp owns 16 keys and computes the
// transposed scores S^T = K Q^T, so keys are the M dimension.
template <typename Op, int D, int TILE>
__global__ void __launch_bounds__(TILE * 2) sparse_dkv_mma_kernel(const Params p) {
  constexpr int LD = D + 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint16_t* sK = reinterpret_cast<uint16_t*>(smem_raw);
  uint16_t* sV = sK + TILE * LD;
  uint16_t* sQ = sV + TILE * LD;
  uint16_t* sdO = sQ + TILE * LD;
  float* sLse = reinterpret_cast<float*>(sdO + TILE * LD);
  float* sDelta = sLse + TILE;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int bh = blockIdx.x, b = bh / p.H, h = bh % p.H;
  const int k0 = blockIdx.y * TILE;
  const int T = p.T;
  const long long dst = static_cast<long long>(p.H) * D;

  const uint16_t* Q = static_cast<const uint16_t*>(p.q) + b * p.q_sb + h * p.q_sh;
  const uint16_t* K = static_cast<const uint16_t*>(p.k) + b * p.k_sb + h * p.k_sh;
  const uint16_t* V = static_cast<const uint16_t*>(p.v) + b * p.v_sb + h * p.v_sh;
  const uint16_t* dO = static_cast<const uint16_t*>(p.dout) +
                       static_cast<long long>(b) * T * dst + h * D;

  load_tile16<D, LD>(sK, K, p.k_st, k0, T, TILE);
  load_tile16<D, LD>(sV, V, p.v_st, k0, T, TILE);

  const int r0 = warp * 16 + g;  // this thread's key rows r0 and r0 + 8
  const int krow[2] = {k0 + r0, k0 + r0 + 8};

  float dk[D / 8][4], dv[D / 8][4];
#pragma unroll
  for (int dn = 0; dn < D / 8; ++dn) {
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[dn][e] = dv[dn][e] = 0.f;
  }

  const Active act = active_of(p, h, k0 / p.block);
  for (int a = 0; a < act.n; ++a) {
    const int q0 = act.blocks[a] * TILE;
    if (p.causal && q0 + TILE - 1 < k0) continue;  // every query precedes every key
    __syncthreads();  // every warp is done with the previous q-tile
    load_tile16<D, LD>(sQ, Q, p.q_st, q0, T, TILE);
    load_tile16<D, LD>(sdO, dO, dst, q0, T, TILE);
    for (int i = threadIdx.x; i < TILE; i += blockDim.x) {
      const long long at = static_cast<long long>(bh) * T + q0 + i;
      sLse[i] = p.lse[at];
      sDelta[i] = p.delta[at];
    }
    __syncthreads();

#pragma unroll 1
    for (int kk = 0; kk < TILE / 16; ++kk) {
      // S^T and dP^T for 16 queries (two n-tiles of 8)
      float s[2][4], dp[2][4];
#pragma unroll
      for (int half = 0; half < 2; ++half) {
#pragma unroll
        for (int e = 0; e < 4; ++e) s[half][e] = dp[half][e] = 0.f;
      }
#pragma unroll
      for (int dd = 0; dd < D / 16; ++dd) {
        const int c = dd * 16 + tq * 2;
        const uint32_t ka[4] = {ld32(sK + r0 * LD + c), ld32(sK + (r0 + 8) * LD + c),
                                ld32(sK + r0 * LD + c + 8),
                                ld32(sK + (r0 + 8) * LD + c + 8)};
        const uint32_t va[4] = {ld32(sV + r0 * LD + c), ld32(sV + (r0 + 8) * LD + c),
                                ld32(sV + r0 * LD + c + 8),
                                ld32(sV + (r0 + 8) * LD + c + 8)};
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int ql = (2 * kk + half) * 8 + g;
          const uint32_t qb[2] = {ld32(sQ + ql * LD + c), ld32(sQ + ql * LD + c + 8)};
          const uint32_t db[2] = {ld32(sdO + ql * LD + c), ld32(sdO + ql * LD + c + 8)};
          Op::mma(s[half], ka, qb);
          Op::mma(dp[half], va, db);
        }
      }
      // element e sits at key krow[e >> 1], query column ql
#pragma unroll
      for (int half = 0; half < 2; ++half) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int ql = (2 * kk + half) * 8 + tq * 2 + (e & 1);
          const float lse = sLse[ql];
          const bool ok = (!p.causal || krow[e >> 1] <= q0 + ql) && lse > MASKED;
          const float pr = ok ? __expf(s[half][e] * p.scale - lse) : 0.f;
          s[half][e] = pr;
          dp[half][e] = pr * (dp[half][e] - sDelta[ql]);
        }
      }
      const uint32_t pa[4] = {
          Op::pack(s[0][0], s[0][1]), Op::pack(s[0][2], s[0][3]),
          Op::pack(s[1][0], s[1][1]), Op::pack(s[1][2], s[1][3])};
      const uint32_t dsa[4] = {
          Op::pack(dp[0][0], dp[0][1]), Op::pack(dp[0][2], dp[0][3]),
          Op::pack(dp[1][0], dp[1][1]), Op::pack(dp[1][2], dp[1][3])};
      // dV += P^T dO and dK += dS^T Q: dO and Q read as B with k = query
      const uint16_t* docol = sdO + (kk * 16 + tq * 2) * LD + g;
      const uint16_t* qcol = sQ + (kk * 16 + tq * 2) * LD + g;
#pragma unroll
      for (int dn = 0; dn < D / 8; ++dn) {
        const uint16_t* op = docol + dn * 8;
        const uint16_t* qp = qcol + dn * 8;
        const uint32_t ob[2] = {ld_col2(op, LD), ld_col2(op + 8 * LD, LD)};
        const uint32_t qb[2] = {ld_col2(qp, LD), ld_col2(qp + 8 * LD, LD)};
        Op::mma(dv[dn], pa, ob);
        Op::mma(dk[dn], dsa, qb);
      }
    }
  }

  uint16_t* dK = static_cast<uint16_t*>(p.o);
  uint16_t* dV = static_cast<uint16_t*>(p.o2);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const long long off = ((static_cast<long long>(b) * T + krow[i]) * p.H + h) * D;
#pragma unroll
    for (int dn = 0; dn < D / 8; ++dn) {
      const int c = dn * 8 + tq * 2;
      *reinterpret_cast<uint32_t*>(dK + off + c) =
          Op::pack(dk[dn][2 * i] * p.scale, dk[dn][2 * i + 1] * p.scale);
      *reinterpret_cast<uint32_t*>(dV + off + c) =
          Op::pack(dv[dn][2 * i], dv[dn][2 * i + 1]);
    }
  }
}

// B6 at block 128, D = 64 and 128: wgmma + TMA, warp-specialised, on the
// consumer pass it shares with B2 (flash_bwd_pass.cuh). One block = one
// query block of one (batch, head), taken from the row order table; the
// producer walks the row's active key blocks.
template <typename Op, int D>
__global__ void __launch_bounds__(WG_THREADS, 1)
    sparse_dq_wgmma_kernel(const __grid_constant__ CUtensorMap map_q,
                           const __grid_constant__ CUtensorMap map_k,
                           const __grid_constant__ CUtensorMap map_v,
                           const __grid_constant__ CUtensorMap map_do, const Params p) {
  using L = DqLayout<D>;
  extern __shared__ __align__(16) unsigned char smem_raw[];  // aligned below
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* smem = smem_raw + (base - raw);
  const uint32_t bar_q = base + L::kBar;
  const uint32_t bar_full = bar_q + 8, bar_empty = bar_full + 8 * WG_STAGES;

  const int T = p.T;
  const Walk w = walk_of(p, T / DQ_BM);
  const int b = w.b, h = w.h, qb = w.blk, q0 = qb * DQ_BM;
  const int* blocks = w.blocks;
  // causal: the walk ends at the first block past the diagonal (the entries
  // ascend)
  int n = w.n;
  if (p.causal) {
    int seen = 0;
    while (seen < n && blocks[seen] <= qb) ++seen;
    n = seen;
  }

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < WG_STAGES; ++s) {
      mbar_init(bar_full + 8 * s, 1);
      mbar_init(bar_empty + 8 * s, 2);  // one arrival per consumer warpgroup
    }
    fence_barrier_init();
  }
  __syncthreads();

  float* rows = reinterpret_cast<float*>(smem + L::kRows);
  const int wg = __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x) / 128, 0);
  if (wg == 0) {
    // producer: warp 0 stages the block's lse * log2 e and delta, loads Q
    // and dO, then the active K/V blocks through the ring, each at its own
    // block's coordinate
    setmaxnreg_dec<24>();
    const int lane = threadIdx.x;
    if (lane < 32) {
      for (int i = lane; i < DQ_BM; i += 32) {
        const long long at = static_cast<long long>(b * p.H + h) * T + q0 + i;
        const float lse = p.lse[at];
        // a row that sees no key: +inf makes P = exp2(s - inf) = 0 exactly
        rows[i] = lse > MASKED ? lse * LOG2E : INFINITY;
        rows[DQ_BM + i] = p.delta[at];
      }
      __syncwarp();  // the rows are written before lane 0 arrives
      if (lane == 0) {
        mbar_arrive_expect_tx(bar_q, 2 * DQ_BM * D * 2);
        for (int c = 0; c < D / 64; ++c) {
          tma_load_4d(base + L::kQ + c * DQ_BM * 128, &map_q, bar_q, c * 64, h, q0, b);
          tma_load_4d(base + L::kDO + c * DQ_BM * 128, &map_do, bar_q, c * 64, h, q0, b);
        }
        for (int j = 0; j < n; ++j) {
          const int s = j % WG_STAGES, k0 = blocks[j] * DQ_BN;
          mbar_wait(bar_empty + 8 * s, ((j / WG_STAGES) & 1) ^ 1);
          const uint32_t full = bar_full + 8 * s;
          const uint32_t dst = base + L::kKV + s * 2 * L::kTile;
          mbar_arrive_expect_tx(full, 2 * L::kTile);
          for (int c = 0; c < D / 64; ++c) {
            tma_load_4d(dst + c * DQ_BN * 128, &map_k, full, c * 64, h, k0, b);
            tma_load_4d(dst + L::kTile + c * DQ_BN * 128, &map_v, full, c * 64, h, k0, b);
          }
        }
      }
    }
  } else {
    // consumers: warpgroup c owns rows q0 + 64c .. q0 + 64c + 63
    setmaxnreg_inc<240>();
    const int c = wg - 1;
    const int t = threadIdx.x & 127, lane = t & 31;
    const int tq = lane & 3;
    const int lr = 64 * c + 16 * (t >> 5) + (lane >> 2);  // rows lr, lr + 8 of the block
    const int r0 = q0 + lr;
    const float sl2 = p.scale * LOG2E;
    const bool causal = p.causal;
    float dq[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dq[i] = 0.f;
    const uint64_t q_desc = desc_sw128(base + L::kQ + 64 * c * 128, 16, 1024);
    const uint64_t do_desc = desc_sw128(base + L::kDO + 64 * c * 128, 16, 1024);
    const int first_row = q0 + 64 * c;

    mbar_wait(bar_q, 0);
    const float lse2[2] = {rows[lr], rows[lr + 8]};
    const float delta[2] = {rows[DQ_BM + lr], rows[DQ_BM + lr + 8]};
    // a stage is handed back once the dQ products that read its K have
    // retired: at the next block's first wait (each consumer runs the first
    // pass of every block: only the diagonal block skips a pass, its second)
    int release = -1;
    for (int j = 0; j < n; ++j) {
      const int s = j % WG_STAGES, k0 = blocks[j] * DQ_BN;
      mbar_wait(bar_full + 8 * s, (j / WG_STAGES) & 1);
      const uint32_t ka = base + L::kKV + s * 2 * L::kTile, va = ka + L::kTile;
      // the layout is the mask: only the causal diagonal block compares,
      // each row against its own position
      const bool diag = causal && k0 == q0;
      const int last[2] = {r0 - k0, r0 + 8 - k0};
#pragma unroll
      for (int hk = 0; hk < DQ_BN / DQ_KH; ++hk) {
        const int kp = k0 + hk * DQ_KH;  // the pass's first key
        if (diag && kp > first_row + 63) continue;  // every key after every row
        dq_pass<Op, D>(
            dq, q_desc, do_desc, ka, va, hk, sl2, lse2, delta, tq,
            diag && kp + DQ_KH - 1 > first_row,
            [&](int kl, int e) { return kl <= last[e >> 1]; },
            [&] {
              if (release >= 0) {
                if (t == 0) mbar_arrive(bar_empty + 8 * release);
                release = -1;
              }
            });
      }
      release = s;
    }
    wgmma_wait<0>();
    fence_regs(dq);

    // scale * dQ through this warpgroup's own rows of the Q tile, then
    // 16-byte stores (a row with no active block writes 0)
    const float mul[2] = {p.scale, p.scale};
    stage_acc<Op, D>(smem + L::kQ, DQ_BM, 64 * c, dq, mul);
    named_bar_sync(1 + c, 128);
    copy_rows_out<D>(smem + L::kQ, DQ_BM, 64 * c,
                     static_cast<uint16_t*>(p.o) +
                         (static_cast<long long>(b) * T + first_row) * p.H * D + h * D,
                     static_cast<long long>(p.H) * D, 64);
  }
}

// B7 at block 128, D = 64 and 128: wgmma + TMA, warp-specialised, B3's
// design with its own copy of B3's consumer body (see flash_attention_bwd.cu
// for why B3 does not share it). One block = one key
// block of one (batch, head), taken from the column order table; K and V
// stay resident while the producer walks the column's active query blocks,
// each as two 64-row Q/dO tiles.
template <typename Op, int D>
__global__ void __launch_bounds__(WG_THREADS, 1)
    sparse_dkv_wgmma_kernel(const __grid_constant__ CUtensorMap map_q,
                            const __grid_constant__ CUtensorMap map_k,
                            const __grid_constant__ CUtensorMap map_v,
                            const __grid_constant__ CUtensorMap map_do, const Params p) {
  using L = DkvLayout<D>;
  constexpr int kHalves = WG_BK / WG_BQ;  // q-tiles per query block
  extern __shared__ __align__(16) unsigned char smem_raw[];  // aligned below
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* smem = smem_raw + (base - raw);
  const uint32_t bar_kv = base + L::kBar;
  const uint32_t bar_full = bar_kv + 8, bar_empty = bar_full + 8 * WG_STAGES;

  const int T = p.T;
  const Walk w = walk_of(p, T / WG_BK);
  const int b = w.b, h = w.h, kb = w.blk, k0 = kb * WG_BK;
  const int* blocks = w.blocks;
  // causal: the walk starts at the first query block not before the key
  // block (the entries ascend)
  int j0 = 0;
  if (p.causal) {
    while (j0 < w.n && blocks[j0] < kb) ++j0;
  }
  const int n_it = kHalves * (w.n - j0);

  if (threadIdx.x == 0) {
    mbar_init(bar_kv, 1);
    for (int s = 0; s < WG_STAGES; ++s) {
      mbar_init(bar_full + 8 * s, 1);
      mbar_init(bar_empty + 8 * s, 2);  // one arrival per consumer warpgroup
    }
    fence_barrier_init();
  }
  __syncthreads();

  float* rows = reinterpret_cast<float*>(smem + L::kRows);
  const int wg = __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x) / 128, 0);
  if (wg == 0) {
    // producer: warp 0 loads K and V, then walks the active query blocks'
    // Q/dO tiles through the ring with their per-row values
    setmaxnreg_dec<24>();
    const int lane = threadIdx.x;
    if (lane < 32) {
      if (lane == 0) {
        mbar_arrive_expect_tx(bar_kv, 2 * L::kKV);
        for (int c = 0; c < D / 64; ++c) {
          tma_load_4d(base + L::kK + c * WG_BK * 128, &map_k, bar_kv, c * 64, h, k0, b);
          tma_load_4d(base + L::kV + c * WG_BK * 128, &map_v, bar_kv, c * 64, h, k0, b);
        }
      }
      for (int it = 0; it < n_it; ++it) {
        const int s = it % WG_STAGES;
        const int q0 = blocks[j0 + it / kHalves] * WG_BK + (it % kHalves) * WG_BQ;
        mbar_wait(bar_empty + 8 * s, ((it / WG_STAGES) & 1) ^ 1);
        float* r = rows + s * 3 * WG_BQ;
        for (int i = lane; i < WG_BQ; i += 32) {
          const long long at = static_cast<long long>(b * p.H + h) * T + q0 + i;
          const float lse = p.lse[at];
          // a row that sees no key: +inf makes P = exp2(s - inf) = 0 exactly
          r[i] = lse > MASKED ? lse * LOG2E : INFINITY;
          r[WG_BQ + i] = p.delta[at];
        }
        __syncwarp();  // the rows are written before lane 0 arrives
        if (lane == 0) {
          const uint32_t full = bar_full + 8 * s;
          const uint32_t dst = base + L::kStage + s * 2 * L::kQ;
          mbar_arrive_expect_tx(full, 2 * L::kQ);
          for (int c = 0; c < D / 64; ++c) {
            tma_load_4d(dst + c * WG_BQ * 128, &map_q, full, c * 64, h, q0, b);
            tma_load_4d(dst + L::kQ + c * WG_BQ * 128, &map_do, full, c * 64, h, q0, b);
          }
        }
      }
    }
  } else {
    // consumers: warpgroup c owns keys k0 + 64c .. k0 + 64c + 63
    setmaxnreg_inc<240>();
    const int c = wg - 1;
    const int t = threadIdx.x & 127, lane = t & 31;
    const int tq = lane & 3;
    const int kc0 = k0 + 64 * c;
    const int kr = kc0 + 16 * (t >> 5) + (lane >> 2);  // this thread's keys kr, kr + 8
    const float sl2 = p.scale * LOG2E;
    const bool causal = p.causal;
    float dk[D / 2], dv[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dk[i] = dv[i] = 0.f;
    const uint64_t k_desc = desc_sw128(base + L::kK + 64 * c * 128, 16, 1024);
    const uint64_t v_desc = desc_sw128(base + L::kV + 64 * c * 128, 16, 1024);

    mbar_wait(bar_kv, 0);
    for (int it = 0; it < n_it; ++it) {
      const int s = it % WG_STAGES;
      const int q0 = blocks[j0 + it / kHalves] * WG_BK + (it % kHalves) * WG_BQ;
      mbar_wait(bar_full + 8 * s, (it / WG_STAGES) & 1);
      if (causal && q0 + WG_BQ - 1 < kc0) {  // every query before every key
        if (t == 0) mbar_arrive(bar_empty + 8 * s);
        continue;
      }
      const uint32_t qs = base + L::kStage + s * 2 * L::kQ;
      const float* lse2 = rows + s * 3 * WG_BQ;
      const float* delta = lse2 + WG_BQ;
      // the layout is the mask: only a q-tile on the causal diagonal
      // compares; key kr + 8i sees the tile's query columns from first[i] on
      const bool masked = causal && q0 < kc0 + 63;
      const int first[2] = {kr - q0, kr + 8 - q0};
      // the tile's queries in halves: a half's S^T, dP^T and their packed
      // P^T, dS^T are all a thread holds beside the dK and dV accumulators
#pragma unroll
      for (int hq = 0; hq < WG_BQ / WG_QH; ++hq) {
        // S^T and dP^T: keys are the M dimension, the half's queries N
        const uint64_t fq = (hq * WG_QH * 128) >> 4;  // its first query row
        const uint64_t kd = opaque(k_desc), vd = opaque(v_desc);
        const uint64_t qd = opaque(desc_sw128(qs, 16, 1024)) + fq;
        const uint64_t dod = opaque(desc_sw128(qs + L::kQ, 16, 1024)) + fq;
        float st[WG_QH / 2], dp[WG_QH / 2];
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          wgmma_ss<WG_QH, Op::kF16>(st, kd + kmajor_step(WG_BK, kk),
                                    qd + kmajor_step(WG_BQ, kk), kk > 0);
        }
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          wgmma_ss<WG_QH, Op::kF16>(dp, vd + kmajor_step(WG_BK, kk),
                                    dod + kmajor_step(WG_BQ, kk), kk > 0);
        }
        wgmma_commit();
        wgmma_wait<0>();  // also retires the previous half's dV, dK products
        fence_regs(st);
        fence_regs(dp);

        // P^T = exp2(S^T scale log2 e - lse log2 e), exactly 0 where
        // masked; dS^T = P^T (dP^T - delta). Element 4 jn + e sits at key
        // kr + 8 (e >> 1), query column ql
#pragma unroll
        for (int jn = 0; jn < WG_QH / 8; ++jn) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = 4 * jn + e, ql = hq * WG_QH + jn * 8 + tq * 2 + (e & 1);
            float pr = exp2f(st[i] * sl2 - lse2[ql]);
            if (masked) pr = ql >= first[e >> 1] ? pr : 0.f;
            st[i] = pr;
            dp[i] = pr * (dp[i] - delta[ql]);
          }
        }
        // the accumulators of query columns 16kk..16kk+15 are the A fragment
        // of k-step kk; dO and Q are read with the transpose bit
        uint32_t pa[WG_QH / 16][4], dsa[WG_QH / 16][4];
#pragma unroll
        for (int kk = 0; kk < WG_QH / 16; ++kk) {
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            pa[kk][r] = Op::pack(st[8 * kk + 2 * r], st[8 * kk + 2 * r + 1]);
            dsa[kk][r] = Op::pack(dp[8 * kk + 2 * r], dp[8 * kk + 2 * r + 1]);
          }
        }
        const uint64_t dov = opaque(desc_sw128(qs + L::kQ, WG_BQ * 128, 1024));
        const uint64_t qv = opaque(desc_sw128(qs, WG_BQ * 128, 1024));
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < WG_QH / 16; ++kk) {
          wgmma_rs<D, Op::kF16>(dv, pa[kk], dov + mnmajor_step(hq * WG_QH / 16 + kk));
        }
#pragma unroll
        for (int kk = 0; kk < WG_QH / 16; ++kk) {
          wgmma_rs<D, Op::kF16>(dk, dsa[kk], qv + mnmajor_step(hq * WG_QH / 16 + kk));
        }
        wgmma_commit();
      }
      wgmma_wait<0>();
      fence_regs(dk);
      fence_regs(dv);
      if (t == 0) mbar_arrive(bar_empty + 8 * s);
    }

    // scale * dK and dV through this warpgroup's own rows of the K and V
    // tiles, then 16-byte stores (a key with no active block writes 0)
    const float mul_k[2] = {p.scale, p.scale}, mul_v[2] = {1.f, 1.f};
    stage_acc<Op, D>(smem + L::kK, WG_BK, 64 * c, dk, mul_k);
    stage_acc<Op, D>(smem + L::kV, WG_BK, 64 * c, dv, mul_v);
    named_bar_sync(1 + c, 128);
    const long long off = (static_cast<long long>(b) * T + kc0) * p.H * D + h * D;
    const long long stride = static_cast<long long>(p.H) * D;
    copy_rows_out<D>(smem + L::kK, WG_BK, 64 * c, static_cast<uint16_t*>(p.o) + off, stride,
                     64);
    copy_rows_out<D>(smem + L::kV, WG_BK, 64 * c, static_cast<uint16_t*>(p.o2) + off, stride,
                     64);
  }
}

// ---------------------------------------------------------------------------
// f32 path: plain FMA over 16 x 16 tiles (every block size is a multiple)
// ---------------------------------------------------------------------------
constexpr int FT = 16;
constexpr int F32_THREADS = 128;

template <int D>
__device__ __forceinline__ void load_tile32(float (*dst)[D + 1], const float* src,
                                            long long st, int t0) {
  for (int i = threadIdx.x; i < FT * D; i += blockDim.x) {
    const int r = i / D, c = i % D;
    dst[r][c] = src[(t0 + r) * st + c];
  }
}

template <int D>
__device__ __forceinline__ float dot_rows(const float* a, const float* b) {
  float s = 0.f;
#pragma unroll 8
  for (int d = 0; d < D; ++d) s = fmaf(a[d], b[d], s);
  return s;
}

template <int D>
__global__ void __launch_bounds__(F32_THREADS) sparse_fwd_f32_kernel(const Params p) {
  __shared__ float sQ[FT][D + 1], sK[FT][D + 1], sV[FT][D + 1];
  __shared__ float sS[FT][FT];
  __shared__ float sM[FT], sL[FT], sAlpha[FT];

  const int tid = threadIdx.x;
  const int bh = blockIdx.x, b = bh / p.H, h = bh % p.H;
  const int q0 = blockIdx.y * FT;
  const int T = p.T;
  const float* Q = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh;
  const float* K = static_cast<const float*>(p.k) + b * p.k_sb + h * p.k_sh;
  const float* V = static_cast<const float*>(p.v) + b * p.v_sb + h * p.v_sh;

  load_tile32<D>(sQ, Q, p.q_st, q0);
  if (tid < FT) {
    sM[tid] = NEG_INF;
    sL[tid] = 0.f;
  }
  // this thread owns output row `orow`, columns ocol + 8 * c
  const int orow = tid / 8, ocol = tid % 8;
  float acc[D / 8];
#pragma unroll
  for (int c = 0; c < D / 8; ++c) acc[c] = 0.f;

  const Active act = active_of(p, h, q0 / p.block);
  const int subs = p.block / FT;
  for (int a = 0; a < act.n; ++a) {
    for (int sub = 0; sub < subs; ++sub) {
      const int k0 = act.blocks[a] * p.block + sub * FT;
      if (p.causal && k0 > q0 + FT - 1) break;
      __syncthreads();
      load_tile32<D>(sK, K, p.k_st, k0);
      load_tile32<D>(sV, V, p.v_st, k0);
      __syncthreads();

      for (int i = tid; i < FT * FT; i += F32_THREADS) {
        const int r = i / FT, c = i % FT;
        const bool ok = !p.causal || k0 + c <= q0 + r;
        sS[r][c] = ok ? dot_rows<D>(sQ[r], sK[c]) * p.scale : NEG_INF;
      }
      __syncthreads();

      if (tid < FT) {
        float mx = sM[tid];
        for (int c = 0; c < FT; ++c) mx = fmaxf(mx, sS[tid][c]);
        float sum = 0.f;
        for (int c = 0; c < FT; ++c) {
          const float e = sS[tid][c] > MASKED ? expf(sS[tid][c] - mx) : 0.f;
          sS[tid][c] = e;
          sum += e;
        }
        const float alpha = expf(sM[tid] - mx);
        sAlpha[tid] = alpha;
        sL[tid] = sL[tid] * alpha + sum;
        sM[tid] = mx;
      }
      __syncthreads();

      const float alpha = sAlpha[orow];
#pragma unroll
      for (int c = 0; c < D / 8; ++c) {
        float x = acc[c] * alpha;
        for (int kc = 0; kc < FT; ++kc) x = fmaf(sS[orow][kc], sV[kc][ocol + 8 * c], x);
        acc[c] = x;
      }
    }
  }
  __syncthreads();

  const int row = q0 + orow;
  const float l = sL[orow];
  const float inv = l > 0.f ? 1.f / l : 0.f;
  float* O = static_cast<float*>(p.o) + ((static_cast<long long>(b) * T + row) * p.H + h) * D;
#pragma unroll
  for (int c = 0; c < D / 8; ++c) O[ocol + 8 * c] = acc[c] * inv;
  if (ocol == 0) {
    const_cast<float*>(p.lse)[static_cast<long long>(bh) * T + row] =
        l > 0.f ? sM[orow] + logf(l) : NEG_INF;
  }
}

template <int D>
__global__ void __launch_bounds__(F32_THREADS) sparse_dq_f32_kernel(const Params p) {
  __shared__ float sQ[FT][D + 1], sdO[FT][D + 1];
  __shared__ float sK[FT][D + 1], sV[FT][D + 1];
  __shared__ float sdS[FT][FT];
  __shared__ float sLse[FT], sDelta[FT];

  const int tid = threadIdx.x;
  const int bh = blockIdx.x, b = bh / p.H, h = bh % p.H;
  const int q0 = blockIdx.y * FT;
  const int T = p.T;
  const long long dst = static_cast<long long>(p.H) * D;
  const float* Q = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh;
  const float* K = static_cast<const float*>(p.k) + b * p.k_sb + h * p.k_sh;
  const float* V = static_cast<const float*>(p.v) + b * p.v_sb + h * p.v_sh;
  const float* dO = static_cast<const float*>(p.dout) +
                    static_cast<long long>(b) * T * dst + h * D;

  load_tile32<D>(sQ, Q, p.q_st, q0);
  load_tile32<D>(sdO, dO, dst, q0);
  if (tid < FT) {
    const long long at = static_cast<long long>(bh) * T + q0 + tid;
    sLse[tid] = p.lse[at];
    sDelta[tid] = p.delta[at];
  }
  const int orow = tid / 8, ocol = tid % 8;
  float acc[D / 8];
#pragma unroll
  for (int c = 0; c < D / 8; ++c) acc[c] = 0.f;

  const Active act = active_of(p, h, q0 / p.block);
  const int subs = p.block / FT;
  for (int a = 0; a < act.n; ++a) {
    for (int sub = 0; sub < subs; ++sub) {
      const int k0 = act.blocks[a] * p.block + sub * FT;
      if (p.causal && k0 > q0 + FT - 1) break;
      __syncthreads();
      load_tile32<D>(sK, K, p.k_st, k0);
      load_tile32<D>(sV, V, p.v_st, k0);
      __syncthreads();

      for (int i = tid; i < FT * FT; i += F32_THREADS) {
        const int r = i / FT, c = i % FT;
        const bool ok = (!p.causal || k0 + c <= q0 + r) && sLse[r] > MASKED;
        float ds = 0.f;
        if (ok) {
          const float pr = expf(dot_rows<D>(sQ[r], sK[c]) * p.scale - sLse[r]);
          ds = pr * (dot_rows<D>(sdO[r], sV[c]) - sDelta[r]);
        }
        sdS[r][c] = ds;
      }
      __syncthreads();

#pragma unroll
      for (int c = 0; c < D / 8; ++c) {
        float x = acc[c];
        for (int kc = 0; kc < FT; ++kc) x = fmaf(sdS[orow][kc], sK[kc][ocol + 8 * c], x);
        acc[c] = x;
      }
    }
  }

  float* out = static_cast<float*>(p.o) +
               ((static_cast<long long>(b) * T + q0 + orow) * p.H + h) * D;
#pragma unroll
  for (int c = 0; c < D / 8; ++c) out[ocol + 8 * c] = acc[c] * p.scale;
}

template <int D>
__global__ void __launch_bounds__(F32_THREADS) sparse_dkv_f32_kernel(const Params p) {
  __shared__ float sK[FT][D + 1], sV[FT][D + 1];
  __shared__ float sQ[FT][D + 1], sdO[FT][D + 1];
  __shared__ float sP[FT][FT], sdS[FT][FT];  // [key][query]
  __shared__ float sLse[FT], sDelta[FT];

  const int tid = threadIdx.x;
  const int bh = blockIdx.x, b = bh / p.H, h = bh % p.H;
  const int k0 = blockIdx.y * FT;
  const int T = p.T;
  const long long dst = static_cast<long long>(p.H) * D;
  const float* Q = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh;
  const float* K = static_cast<const float*>(p.k) + b * p.k_sb + h * p.k_sh;
  const float* V = static_cast<const float*>(p.v) + b * p.v_sb + h * p.v_sh;
  const float* dO = static_cast<const float*>(p.dout) +
                    static_cast<long long>(b) * T * dst + h * D;

  load_tile32<D>(sK, K, p.k_st, k0);
  load_tile32<D>(sV, V, p.v_st, k0);
  const int orow = tid / 8, ocol = tid % 8;
  float dk[D / 8], dv[D / 8];
#pragma unroll
  for (int c = 0; c < D / 8; ++c) dk[c] = dv[c] = 0.f;

  const Active act = active_of(p, h, k0 / p.block);
  const int subs = p.block / FT;
  for (int a = 0; a < act.n; ++a) {
    for (int sub = 0; sub < subs; ++sub) {
      const int q0 = act.blocks[a] * p.block + sub * FT;
      if (p.causal && q0 + FT - 1 < k0) continue;
      __syncthreads();
      load_tile32<D>(sQ, Q, p.q_st, q0);
      load_tile32<D>(sdO, dO, dst, q0);
      if (tid < FT) {
        const long long at = static_cast<long long>(bh) * T + q0 + tid;
        sLse[tid] = p.lse[at];
        sDelta[tid] = p.delta[at];
      }
      __syncthreads();

      for (int i = tid; i < FT * FT; i += F32_THREADS) {
        const int c = i / FT, r = i % FT;  // key c, query r
        const bool ok = (!p.causal || k0 + c <= q0 + r) && sLse[r] > MASKED;
        float pr = 0.f, ds = 0.f;
        if (ok) {
          pr = expf(dot_rows<D>(sQ[r], sK[c]) * p.scale - sLse[r]);
          ds = pr * (dot_rows<D>(sdO[r], sV[c]) - sDelta[r]);
        }
        sP[c][r] = pr;
        sdS[c][r] = ds;
      }
      __syncthreads();

#pragma unroll
      for (int c = 0; c < D / 8; ++c) {
        float x = dv[c], y = dk[c];
        for (int r = 0; r < FT; ++r) {
          x = fmaf(sP[orow][r], sdO[r][ocol + 8 * c], x);
          y = fmaf(sdS[orow][r], sQ[r][ocol + 8 * c], y);
        }
        dv[c] = x;
        dk[c] = y;
      }
    }
  }

  const long long off = ((static_cast<long long>(b) * T + k0 + orow) * p.H + h) * D;
  float* outk = static_cast<float*>(p.o) + off;
  float* outv = static_cast<float*>(p.o2) + off;
#pragma unroll
  for (int c = 0; c < D / 8; ++c) {
    outk[ocol + 8 * c] = dk[c] * p.scale;
    outv[ocol + 8 * c] = dv[c];
  }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------
enum Which { FWD = 0, DQ = 1, DKV = 2 };

template <typename Kernel>
cudaError_t launch(Kernel kernel, dim3 grid, int threads, int smem, const Params& p,
                   cudaStream_t stream) {
  if (smem > 0) {
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  kernel<<<grid, threads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int D, int TILE>
cudaError_t launch_mma(const Params& p, Which which, cudaStream_t stream) {
  constexpr int LD = D + 8;
  constexpr int tile_bytes = TILE * LD * static_cast<int>(sizeof(uint16_t));
  const dim3 grid(p.B * p.H, p.T / TILE);
  switch (which) {
    case FWD:
      return launch(sparse_fwd_mma_kernel<Bf16, D, TILE>, grid, TILE * 2, 3 * tile_bytes, p, stream);
    case DQ:
      return launch(sparse_dq_mma_kernel<Bf16, D, TILE>, grid, TILE * 2, 4 * tile_bytes, p, stream);
    case DKV:
      return launch(sparse_dkv_mma_kernel<Bf16, D, TILE>, grid, TILE * 2,
                    4 * tile_bytes + 2 * TILE * static_cast<int>(sizeof(float)), p, stream);
  }
  return cudaErrorInvalidValue;
}

template <int D>
cudaError_t launch_f32(const Params& p, Which which, cudaStream_t stream) {
  const dim3 grid(p.B * p.H, p.T / FT);
  switch (which) {
    case FWD: return launch(sparse_fwd_f32_kernel<D>, grid, F32_THREADS, 0, p, stream);
    case DQ: return launch(sparse_dq_f32_kernel<D>, grid, F32_THREADS, 0, p, stream);
    case DKV: return launch(sparse_dkv_f32_kernel<D>, grid, F32_THREADS, 0, p, stream);
  }
  return cudaErrorInvalidValue;
}

// The block-128 kernels' tensor maps: q, k, v through their strides, dO
// [B, T, H, D] contiguous; `q_rows` and `kv_rows` are the boxes' rows.
template <int D>
cudaError_t make_maps(const Params& p, int q_rows, int kv_rows, CUtensorMap* map_q,
                      CUtensorMap* map_k, CUtensorMap* map_v, CUtensorMap* map_do) {
  cudaError_t err = make_tile_map(map_q, p.q, false, p.B, p.T, p.H, D, p.q_sb, p.q_st,
                                  p.q_sh, q_rows);
  if (err == cudaSuccess) {
    err = make_tile_map(map_k, p.k, false, p.B, p.T, p.H, D, p.k_sb, p.k_st, p.k_sh, kv_rows);
  }
  if (err == cudaSuccess) {
    err = make_tile_map(map_v, p.v, false, p.B, p.T, p.H, D, p.v_sb, p.v_st, p.v_sh, kv_rows);
  }
  if (err == cudaSuccess && map_do != nullptr) {
    const long long HD = static_cast<long long>(p.H) * D;
    err = make_tile_map(map_do, p.dout, false, p.B, p.T, p.H, D, p.T * HD, HD, D, q_rows);
  }
  return err;
}

// B5, B6 or B7 at block 128 (bf16): one block per table row or column, B * H
// * T / 128 in all, in `order`.
template <int D>
cudaError_t launch_wgmma(const Params& p, Which which, cudaStream_t stream) {
  if (p.order == nullptr) return cudaErrorInvalidValue;
  CUtensorMap map_q, map_k, map_v, map_do;
  const unsigned grid = static_cast<unsigned>(p.T / 128) * p.B * p.H;
  cudaError_t err;
  if (which == FWD) {
    err = make_maps<D>(p, WG_BM, WG_BN, &map_q, &map_k, &map_v, nullptr);
    if (err != cudaSuccess) return err;
    constexpr int smem = FwdLayout<D>::kBytes;
    err = cudaFuncSetAttribute(sparse_fwd_wgmma_kernel<Bf16, D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    sparse_fwd_wgmma_kernel<Bf16, D><<<grid, WG_THREADS, smem, stream>>>(map_q, map_k, map_v, p);
  } else if (which == DQ) {
    err = make_maps<D>(p, DQ_BM, DQ_BN, &map_q, &map_k, &map_v, &map_do);
    if (err != cudaSuccess) return err;
    constexpr int smem = DqLayout<D>::kBytes;
    err = cudaFuncSetAttribute(sparse_dq_wgmma_kernel<Bf16, D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    sparse_dq_wgmma_kernel<Bf16, D>
        <<<grid, WG_THREADS, smem, stream>>>(map_q, map_k, map_v, map_do, p);
  } else {
    err = make_maps<D>(p, WG_BQ, WG_BK, &map_q, &map_k, &map_v, &map_do);
    if (err != cudaSuccess) return err;
    constexpr int smem = DkvLayout<D>::kBytes;
    err = cudaFuncSetAttribute(sparse_dkv_wgmma_kernel<Bf16, D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    sparse_dkv_wgmma_kernel<Bf16, D>
        <<<grid, WG_THREADS, smem, stream>>>(map_q, map_k, map_v, map_do, p);
  }
  return cudaGetLastError();
}

// Which design runs a given block and dtype (every kernel, B5-B7, takes
// the same one); -1 where nothing is instantiated.
enum Variant { FMA = 0, MMA_SYNC = 1, WGMMA = 2 };

int variant_of(int block, int dtype) {
  if (block != 16 && block != 32 && block != 64 && block != 128) return -1;
  if (dtype == 0) return FMA;
  if (dtype != 1) return -1;
  return block == 128 ? WGMMA : MMA_SYNC;
}

template <int D>
cudaError_t dispatch(const Params& p, Which which, int dtype, cudaStream_t stream) {
  switch (variant_of(p.block, dtype)) {
    case FMA: return launch_f32<D>(p, which, stream);
    case WGMMA: return launch_wgmma<D>(p, which, stream);
    case MMA_SYNC:
      switch (p.block) {
        case 16: return launch_mma<D, 16>(p, which, stream);
        case 32: return launch_mma<D, 32>(p, which, stream);
        default: return launch_mma<D, 64>(p, which, stream);
      }
    default: return cudaErrorInvalidValue;
  }
}

int run(Which which, const void* q, const void* k, const void* v, const void* dout,
        const void* lse, const void* delta, void* out, void* out2, const void* idx,
        const void* cnt, int width, int HL, int block, int B, int T, int H, int D,
        const long long* strides, float scale, int causal, int dtype, void* stream,
        const void* order) {
  Params p = {};
  p.order = static_cast<const int*>(order);
  p.q = q;
  p.k = k;
  p.v = v;
  p.dout = dout;
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<const float*>(delta);
  p.o = out;
  p.o2 = out2;
  p.idx = static_cast<const int*>(idx);
  p.cnt = static_cast<const int*>(cnt);
  p.width = width;
  p.HL = HL;
  p.block = block;
  p.B = B;
  p.T = T;
  p.H = H;
  p.q_sb = strides[0]; p.q_st = strides[1]; p.q_sh = strides[2];
  p.k_sb = strides[3]; p.k_st = strides[4]; p.k_sh = strides[5];
  p.v_sb = strides[6]; p.v_st = strides[7]; p.v_sh = strides[8];
  p.scale = scale;
  p.causal = causal;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (D) {
    case 64: err = dispatch<64>(p, which, dtype, s); break;
    case 128: err = dispatch<128>(p, which, dtype, s); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. `strides` holds the batch, sequence and
// head strides of q, k and v (9 values, in elements). `idx`/`cnt` are the
// row tables (key blocks of each q-block) for the forward and dq, the column
// tables (q-blocks of each key block) for dkv; `order` [HL * n_blocks] lists
// those tables' rows (or columns) longest first, the order in which the
// block-128 kernels take them (required there, read nowhere else). `lse` is
// written by the forward and read by the backward. Each returns a
// cudaError_t.
extern "C" int ds_block_sparse_fwd(const void* q, const void* k, const void* v, void* o,
                                   void* lse, const void* idx, const void* cnt, int width,
                                   int HL, int block, int B, int T, int H, int D,
                                   const long long* strides, float scale, int causal,
                                   int dtype, void* stream, const void* order) {
  return run(FWD, q, k, v, nullptr, lse, nullptr, o, nullptr, idx, cnt, width, HL, block,
             B, T, H, D, strides, scale, causal, dtype, stream, order);
}

extern "C" int ds_block_sparse_dq(const void* q, const void* k, const void* v,
                                  const void* dout, const void* lse, const void* delta,
                                  void* dq, const void* idx, const void* cnt, int width,
                                  int HL, int block, int B, int T, int H, int D,
                                  const long long* strides, float scale, int causal,
                                  int dtype, void* stream, const void* order) {
  return run(DQ, q, k, v, dout, lse, delta, dq, nullptr, idx, cnt, width, HL, block, B, T,
             H, D, strides, scale, causal, dtype, stream, order);
}

extern "C" int ds_block_sparse_dkv(const void* q, const void* k, const void* v,
                                   const void* dout, const void* lse, const void* delta,
                                   void* dk, void* dv, const void* idx, const void* cnt,
                                   int width, int HL, int block, int B, int T, int H, int D,
                                   const long long* strides, float scale, int causal,
                                   int dtype, void* stream, const void* order) {
  return run(DKV, q, k, v, dout, lse, delta, dk, dv, idx, cnt, width, HL, block, B, T, H,
             D, strides, scale, causal, dtype, stream, order);
}

// The design the kernels above launch at `block` for `dtype`: 0 plain FMA,
// 1 mma.sync, 2 wgmma + TMA + warp specialisation; -1 for none.
extern "C" int ds_block_sparse_variant(int block, int dtype) {
  return variant_of(block, dtype);
}
