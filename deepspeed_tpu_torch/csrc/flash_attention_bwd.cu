// Flash-attention backward for Hopper (sm_90a): dQ and dK/dV.
//
// Replaces the Pallas TPU kernels of deepspeed_tpu/ops/pallas/
// flash_attention.py: `_bwd_dq_kernel` (line 157; B2) and `_bwd_dkv_kernel`
// (line 207; B3), launched by `_bwd_impl` (line 267). Both recompute the
// probabilities P = exp(scale * Q K^T - lse) from the forward's saved
// per-row logsumexp instead of storing them, with delta = rowsum(O * dO)
// computed beforehand (by the caller, in f32):
//   dQ  = scale * dS K           dS = P * (dP - delta),  dP = dO V^T
//   dK  = scale * dS^T Q         dV = P^T dO
//
// What bounds it on an H100: at the training shape of GPT-2 1.3B (B=4,
// T=1024, H=16, D=128, causal, bf16) B2 does 3 products over the visible
// (query, key) pairs (6 * pairs * H * D = 25.8 GFLOP) and B3 four (34.4
// GFLOP), while they move 84 and 101 MB (each input read once, each output
// written once), so both are bound by the tensor cores (26 and 35 us at 989
// TFLOP/s) rather than by HBM (25 and 30 us at 3.35 TB/s). P and dS never
// leave the chip.
//
// Two kernels, no atomics: B2 owns a q-tile and loops over the K/V tiles up
// to the diagonal; B3 owns a key tile and loops over the q tiles from the
// diagonal to the end. Every output element is written by exactly one block
// in a fixed order, so gradients are bit-reproducible.
//
// B2's consumer pass at D = 64 and 128 lives in flash_bwd_pass.cuh
// (`dq_pass`), shared with the block-sparse dQ (B6), which walks an index
// table instead of the causal range. B3 keeps its own consumer body: called
// through a shared function, the same code spilled 580 instead of 516 bytes
// at D 128 and ran 5-9% slower (chip_smoke.py --against), so the block-sparse
// dK/dV (B7) has its own copy of it.
//
// B2, 16-bit inputs at D = 64 and 128 (`bwd_dq_wgmma_kernel`), B3's design
// turned around:
// * One block = 128 query rows of one (batch, head) and three warpgroups. A
//   producer warp (setmaxnreg 24) stages the block's lse (times log2 e) and
//   delta, loads its Q and dO tiles once by TMA (Q through a map over the
//   strided view, dO over the contiguous [B, T, H, D]), then streams 128-key
//   K and V tiles through a two-stage ring (full/empty mbarriers), with each
//   tile's key segment ids under segments. Two consumer warpgroups
//   (setmaxnreg 240) own 64 rows each; the dQ accumulator (D / 2 f32 per
//   thread) stays in registers for the whole loop.
// * Per K/V tile, in two passes of 64 keys: S = Q K^T and dP = dO V^T as SS
//   wgmma (m64n64k16, all operands K-major in shared memory);
//   P = exp2(S scale log2 e - lse log2 e) and dS = P * (dP - delta) in f32
//   registers; dS rounded to the input type (as in the TPU kernel) and
//   re-packed from the accumulator as the register A operand of dQ += dS K,
//   an RS wgmma that reads K from shared memory with the transpose bit. A
//   pass's dQ product runs on while the next pass's S and dP products are
//   issued; a stage goes back to the producer once the products that read
//   it have retired.
// * Causal: the key loop ends at the diagonal tile; a pass wholly after a
//   warpgroup's rows is skipped, and only passes that cross the diagonal,
//   the end of T, or any pass under segments run the compare/select. A
//   masked pair gets P = 0 exactly, never exp of a huge negative. The
//   longest causal rows go first in the grid.
// * The epilogue writes scale * dQ through the consumer's own rows of the
//   Q tile in shared memory and out with 16-byte stores.
//
// B3, 16-bit inputs at D = 64 and 128 (`flash_bwd_dkv_wgmma_kernel`):
// * One block = 128 keys of one (batch, head) and three warpgroups. K and V
//   come in once by TMA and stay in shared memory. A producer warp
//   (setmaxnreg 24) streams 64-row Q and dO tiles by TMA through a two-stage
//   ring (full/empty mbarriers), and stages each tile's lse (times log2 e),
//   delta and query segment ids beside them. Two consumer warpgroups
//   (setmaxnreg 240) own 64 keys each, so the dK and dV accumulators (2 x
//   D / 2 f32 per thread) stay in registers for the whole loop.
// * Per q-tile, in two passes of 32 queries (so that a pass's S^T, dP^T,
//   P^T and dS^T fit beside the accumulators): S^T = K Q^T and dP^T = V dO^T
//   as SS wgmma (m64n32k16, all operands K-major in shared memory);
//   P^T = exp2(S^T scale log2 e - lse log2 e) and dS^T = P^T * (dP^T -
//   delta) in registers; then dV += P^T dO and dK += dS^T Q as RS wgmma,
//   P^T and dS^T re-packed from the accumulators as register A operands
//   (rounded to the input type, as in the TPU kernel) and dO, Q read from
//   shared memory with the transpose bit. The second pass's S^T and dP^T
//   products queue behind the first pass's dV and dK products, without a
//   wait between them.
// * Causal: the loop starts at the diagonal q-tile; a warpgroup skips a tile
//   wholly before its keys, and only tiles that cross its diagonal (or the
//   end of T, or any tile under segments) run the compare/select. A masked
//   pair contributes exactly 0 (P is set to 0, never exp of a huge negative),
//   so fully masked tiles and ragged tails give 0 and never NaN.
// * The epilogue writes scale * dK and dV through the block's own K and V
//   tiles in shared memory and out with 16-byte stores.
// B2 and B3 at the other head dims (32, 80, 96) keep the first design of
// this port (`bwd_dq_mma_kernel`, `bwd_dkv_mma_kernel`): 4 warps per block,
// 16 rows (B2) or 16 keys (B3) per warp, mma.sync m16n8k16 with f32
// accumulators, tiles staged by plain 16-byte loads; P and dS re-pack from C
// fragments as the A fragment of the next product. f32 inputs take plain FMA
// kernels over 16 x 16 tiles with scores in shared memory, since TF32 tensor
// cores would not hold the f32 tolerance.
//
// q, k, v are read in [B, T, H, D] through their strides (views into the
// fused projection); dO, dQ, dK and dV are [B, T, H, D] contiguous and lse
// and delta [B, H, T] f32. Masks are those of the forward: causal,
// same-segment, and positions past T.

#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_bwd_pass.cuh"
#include "hopper.cuh"
#include "mma_sm80.cuh"

namespace {

using ds_mma::Bf16;
using ds_mma::Fp16;
using ds_mma::ld32;
using ds_mma::ld_col2;
using ds_mma::load_tile16;
using namespace ds_hopper;
using namespace ds_bwd;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const int* seg;      // [B, T] or nullptr
  const void* dout;    // [B, T, H, D] contiguous
  const float* lse;    // [B, H, T]
  const float* delta;  // [B, H, T]
  void* dq;            // [B, T, H, D] contiguous
  void* dk;
  void* dv;
  int B, T, H;
  long long q_sb, q_st, q_sh;
  long long k_sb, k_st, k_sh;
  long long v_sb, v_st, v_sh;
  float scale;
  int causal;
};

// ---------------------------------------------------------------------------
// 16-bit path
// ---------------------------------------------------------------------------
constexpr int BM = 64;  // query rows per tile
constexpr int BN = 64;  // keys per tile
constexpr int MMA_THREADS = 128;

template <int D>
constexpr size_t mma_smem_bytes() {
  return 4 * 64 * (D + 8) * sizeof(uint16_t) + 3 * 64 * sizeof(float);
}

// B2: one block = one (batch*head, 64-row q-tile).
template <typename Op, int D>
__global__ void __launch_bounds__(MMA_THREADS)
    bwd_dq_mma_kernel(const Params p) {
  constexpr int LD = D + 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint16_t* sQ = reinterpret_cast<uint16_t*>(smem_raw);
  uint16_t* sdO = sQ + BM * LD;
  uint16_t* sK = sdO + BM * LD;
  uint16_t* sV = sK + BN * LD;
  int* sSeg = reinterpret_cast<int*>(sV + BN * LD);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int bh = blockIdx.x, b = bh / p.H, h = bh % p.H;
  // longest causal rows first, so the short tiles fill the tail of the grid
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BM;
  const int T = p.T;
  const long long dst = static_cast<long long>(p.H) * D;  // row stride of dO

  const uint16_t* Q = static_cast<const uint16_t*>(p.q) + b * p.q_sb + h * p.q_sh;
  const uint16_t* K = static_cast<const uint16_t*>(p.k) + b * p.k_sb + h * p.k_sh;
  const uint16_t* V = static_cast<const uint16_t*>(p.v) + b * p.v_sb + h * p.v_sh;
  const uint16_t* dO = static_cast<const uint16_t*>(p.dout) +
                       static_cast<long long>(b) * T * dst + h * D;

  load_tile16<D, LD>(sQ, Q, p.q_st, q0, T, BM);
  load_tile16<D, LD>(sdO, dO, dst, q0, T, BM);
  __syncthreads();

  // Q and dO as A fragments of this warp's 16 rows
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
  int qseg[2] = {0, 0};
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const bool in = qrow[i] < T;
    const long long at = static_cast<long long>(bh) * T + qrow[i];
    lse_r[i] = in ? p.lse[at] : 0.f;
    delta_r[i] = in ? p.delta[at] : 0.f;
    if (p.seg != nullptr) qseg[i] = in ? p.seg[b * T + qrow[i]] : -1;
  }

  float acc[D / 8][4];
#pragma unroll
  for (int dn = 0; dn < D / 8; ++dn) {
    acc[dn][0] = acc[dn][1] = acc[dn][2] = acc[dn][3] = 0.f;
  }

  int n_kv = (T + BN - 1) / BN;
  if (p.causal) n_kv = min(n_kv, (q0 + BM + BN - 1) / BN);

  for (int j = 0; j < n_kv; ++j) {
    const int k0 = j * BN;
    __syncthreads();  // every warp is done with the previous tile
    load_tile16<D, LD>(sK, K, p.k_st, k0, T, BN);
    load_tile16<D, LD>(sV, V, p.v_st, k0, T, BN);
    if (p.seg != nullptr && threadIdx.x < BN) {
      sSeg[threadIdx.x] = k0 + threadIdx.x < T ? p.seg[b * T + k0 + threadIdx.x] : 0;
    }
    __syncthreads();

    // 16 keys at a time: S and dP for two n-tiles, then dS as one A fragment
#pragma unroll 1
    for (int kk = 0; kk < BN / 16; ++kk) {
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
      // element e sits at row qrow[e >> 1], key kl + (e & 1)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kl = (2 * kk + half) * 8 + tq * 2 + (e & 1);
          const int col = k0 + kl, row = qrow[e >> 1];
          bool ok = col < T && row < T;
          if (p.causal) ok = ok && col <= row;
          if (p.seg != nullptr) ok = ok && sSeg[kl] == qseg[e >> 1];
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

  uint16_t* dQ = static_cast<uint16_t*>(p.dq);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = qrow[i];
    if (row >= T) continue;
    uint16_t* out = dQ + ((static_cast<long long>(b) * T + row) * p.H + h) * D;
#pragma unroll
    for (int dn = 0; dn < D / 8; ++dn) {
      *reinterpret_cast<uint32_t*>(out + dn * 8 + tq * 2) =
          Op::pack(acc[dn][2 * i] * p.scale, acc[dn][2 * i + 1] * p.scale);
    }
  }
}

// B3 at D = 64 and 128: wgmma + TMA, warp-specialised (see the top note).
template <typename Op, int D>
__global__ void __launch_bounds__(WG_THREADS, 1)
    flash_bwd_dkv_wgmma_kernel(const __grid_constant__ CUtensorMap map_q,
                               const __grid_constant__ CUtensorMap map_k,
                               const __grid_constant__ CUtensorMap map_v,
                               const __grid_constant__ CUtensorMap map_do,
                               const Params p) {
  using L = DkvLayout<D>;
  extern __shared__ __align__(16) unsigned char smem_raw[];  // aligned below
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* smem = smem_raw + (base - raw);
  const uint32_t bar_kv = base + L::kBar;
  const uint32_t bar_full = bar_kv + 8, bar_empty = bar_full + 8 * WG_STAGES;

  const int T = p.T, bh = blockIdx.x, b = bh / p.H, h = bh % p.H;
  // the first key tiles see the most q-tiles under the causal mask: issue
  // them first
  const int k0 = blockIdx.y * WG_BK;
  // q-tiles wholly before this key tile's diagonal see none of its keys
  const int j0 = p.causal ? k0 / WG_BQ : 0;
  const int n_it = (T + WG_BQ - 1) / WG_BQ - j0;

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
  // the warpgroup's role, warp-uniform; the shuffle lets the compiler see
  // that (as CUTLASS's canonical_warp_group_idx does)
  const int wg = __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x) / 128, 0);
  if (wg == 0) {
    // producer: warp 0 loads K and V, then walks the Q/dO tiles through the
    // ring with their per-row values
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
        const int s = it % WG_STAGES, q0 = (j0 + it) * WG_BQ;
        mbar_wait(bar_empty + 8 * s, ((it / WG_STAGES) & 1) ^ 1);
        float* r = rows + s * 3 * WG_BQ;
        for (int i = lane; i < WG_BQ; i += 32) {
          const int row = q0 + i;
          const bool in = row < T;
          const long long at = static_cast<long long>(bh) * T + row;
          r[i] = in ? p.lse[at] * LOG2E : 0.f;
          r[WG_BQ + i] = in ? p.delta[at] : 0.f;
          reinterpret_cast<int*>(r)[2 * WG_BQ + i] =
              (p.seg != nullptr && in) ? p.seg[b * T + row] : -1;
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
    const int g = lane >> 2, tq = lane & 3;
    const int kc0 = k0 + 64 * c;
    const int kr = kc0 + 16 * (t >> 5) + g;  // this thread's keys kr, kr + 8
    int kseg[2] = {0, 0};
    if (p.seg != nullptr) {
#pragma unroll
      for (int i = 0; i < 2; ++i) kseg[i] = kr + 8 * i < T ? p.seg[b * T + kr + 8 * i] : -2;
    }
    const float sl2 = p.scale * LOG2E;
    float dk[D / 2], dv[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dk[i] = dv[i] = 0.f;
    const uint64_t k_desc = desc_sw128(base + L::kK + 64 * c * 128, 16, 1024);
    const uint64_t v_desc = desc_sw128(base + L::kV + 64 * c * 128, 16, 1024);

    mbar_wait(bar_kv, 0);
    for (int it = 0; it < n_it; ++it) {
      const int s = it % WG_STAGES, q0 = (j0 + it) * WG_BQ;
      mbar_wait(bar_full + 8 * s, (it / WG_STAGES) & 1);
      if (p.causal && q0 + WG_BQ - 1 < kc0) {  // every query before every key
        if (t == 0) mbar_arrive(bar_empty + 8 * s);
        continue;
      }
      const uint32_t qs = base + L::kStage + s * 2 * L::kQ;
      const float* lse2 = rows + s * 3 * WG_BQ;
      const float* delta = lse2 + WG_BQ;
      const int* qseg = reinterpret_cast<const int*>(lse2 + 2 * WG_BQ);
      const bool masked = p.seg != nullptr || q0 + WG_BQ > T || kc0 + 64 > T ||
                          (p.causal && q0 < kc0 + 63);
      // the tile's queries in halves: a half's S^T, dP^T and their packed
      // P^T, dS^T are all a thread holds beside the dK and dV accumulators
#pragma unroll
      for (int hq = 0; hq < WG_BQ / WG_QH; ++hq) {
        // S^T and dP^T: keys are the M dimension, the half's queries N
        const uint64_t first = (hq * WG_QH * 128) >> 4;  // its first query row
        const uint64_t kd = opaque(k_desc), vd = opaque(v_desc);
        const uint64_t qd = opaque(desc_sw128(qs, 16, 1024)) + first;
        const uint64_t dod = opaque(desc_sw128(qs + L::kQ, 16, 1024)) + first;
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

        // element 4 jn + e sits at key kr + 8 (e >> 1), query column ql
#pragma unroll
        for (int jn = 0; jn < WG_QH / 8; ++jn) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = 4 * jn + e, ql = hq * WG_QH + jn * 8 + tq * 2 + (e & 1);
            float pr = exp2f(st[i] * sl2 - lse2[ql]);
            if (masked) {
              const int q = q0 + ql, key = kr + 8 * (e >> 1);
              bool ok = q < T && key < T;
              if (p.causal) ok = ok && key <= q;
              if (p.seg != nullptr) ok = ok && qseg[ql] == kseg[e >> 1];
              pr = ok ? pr : 0.f;
            }
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
    // tiles, then 16-byte stores
    const float mul_k[2] = {p.scale, p.scale}, mul_v[2] = {1.f, 1.f};
    stage_acc<Op, D>(smem + L::kK, WG_BK, 64 * c, dk, mul_k);
    stage_acc<Op, D>(smem + L::kV, WG_BK, 64 * c, dv, mul_v);
    named_bar_sync(1 + c, 128);
    const long long off = (static_cast<long long>(b) * T + kc0) * p.H * D + h * D;
    const long long stride = static_cast<long long>(p.H) * D;
    const int valid = min(64, T - kc0);
    copy_rows_out<D>(smem + L::kK, WG_BK, 64 * c, static_cast<uint16_t*>(p.dk) + off,
                     stride, valid);
    copy_rows_out<D>(smem + L::kV, WG_BK, 64 * c, static_cast<uint16_t*>(p.dv) + off,
                     stride, valid);
  }
}

// B2 at D = 64 and 128: wgmma + TMA, warp-specialised (see the top note);
// the consumer pass is ds_bwd::dq_pass (flash_bwd_pass.cuh).
template <typename Op, int D>
__global__ void __launch_bounds__(WG_THREADS, 1)
    bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap map_q,
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

  const int T = p.T, bh = blockIdx.x, b = bh / p.H, h = bh % p.H;
  // longest causal rows first, so the short tiles fill the tail of the grid
  const int q0 = (gridDim.y - 1 - blockIdx.y) * DQ_BM;
  int n_kv = (T + DQ_BN - 1) / DQ_BN;
  if (p.causal) n_kv = min(n_kv, (q0 + DQ_BM + DQ_BN - 1) / DQ_BN);

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
  int* sseg = reinterpret_cast<int*>(smem + L::kSeg);
  // the warpgroup's role, warp-uniform; the shuffle lets the compiler see
  // that (as CUTLASS's canonical_warp_group_idx does)
  const int wg = __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x) / 128, 0);
  if (wg == 0) {
    // producer: warp 0 stages the block's lse * log2 e and delta, loads Q
    // and dO, then walks the K/V tiles through the ring
    setmaxnreg_dec<24>();
    const int lane = threadIdx.x;
    if (lane < 32) {
      for (int i = lane; i < DQ_BM; i += 32) {
        const int row = q0 + i;
        const bool in = row < T;
        const long long at = static_cast<long long>(bh) * T + row;
        rows[i] = in ? p.lse[at] * LOG2E : 0.f;
        rows[DQ_BM + i] = in ? p.delta[at] : 0.f;
      }
      __syncwarp();  // the rows are written before lane 0 arrives
      if (lane == 0) {
        mbar_arrive_expect_tx(bar_q, 2 * DQ_BM * D * 2);
        for (int c = 0; c < D / 64; ++c) {
          tma_load_4d(base + L::kQ + c * DQ_BM * 128, &map_q, bar_q, c * 64, h, q0, b);
          tma_load_4d(base + L::kDO + c * DQ_BM * 128, &map_do, bar_q, c * 64, h, q0, b);
        }
      }
      for (int j = 0; j < n_kv; ++j) {
        const int s = j % WG_STAGES;
        mbar_wait(bar_empty + 8 * s, ((j / WG_STAGES) & 1) ^ 1);
        if (p.seg != nullptr) {
          for (int i = lane; i < DQ_BN; i += 32) {
            const int key = j * DQ_BN + i;
            sseg[s * DQ_BN + i] = key < T ? p.seg[b * T + key] : -1;
          }
          __syncwarp();  // the ids are written before lane 0 arrives
        }
        if (lane == 0) {
          const uint32_t full = bar_full + 8 * s;
          const uint32_t dst = base + L::kKV + s * 2 * L::kTile;
          mbar_arrive_expect_tx(full, 2 * L::kTile);
          for (int c = 0; c < D / 64; ++c) {
            tma_load_4d(dst + c * DQ_BN * 128, &map_k, full, c * 64, h, j * DQ_BN, b);
            tma_load_4d(dst + L::kTile + c * DQ_BN * 128, &map_v, full, c * 64, h,
                        j * DQ_BN, b);
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
    int qseg[2] = {0, 0};
    if (p.seg != nullptr) {
#pragma unroll
      for (int i = 0; i < 2; ++i) qseg[i] = r0 + 8 * i < T ? p.seg[b * T + r0 + 8 * i] : -2;
    }
    const float sl2 = p.scale * LOG2E;
    const bool causal = p.causal, has_seg = p.seg != nullptr;
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
    // retired: at the next tile's first wait (each consumer runs at least
    // one pass of every tile: only passes past the diagonal are skipped,
    // and the diagonal tile's first pass always runs)
    int release = -1;
    for (int j = 0; j < n_kv; ++j) {
      const int s = j % WG_STAGES, k0 = j * DQ_BN;
      mbar_wait(bar_full + 8 * s, (j / WG_STAGES) & 1);
      const uint32_t ka = base + L::kKV + s * 2 * L::kTile, va = ka + L::kTile;
      const int* tseg = sseg + s * DQ_BN;
      // per row, the last key column of this tile it may see: before T,
      // and under causal not after the row
      const int last[2] = {(causal ? min(T - 1, r0) : T - 1) - k0,
                           (causal ? min(T - 1, r0 + 8) : T - 1) - k0};
#pragma unroll
      for (int hk = 0; hk < DQ_BN / DQ_KH; ++hk) {
        const int kp = k0 + hk * DQ_KH;  // the pass's first key
        // every key after every row: P = 0, nothing to add
        if (causal && kp > first_row + 63) continue;
        const bool masked =
            has_seg || kp + DQ_KH > T || (causal && kp + DQ_KH - 1 > first_row);
        dq_pass<Op, D>(
            dq, q_desc, do_desc, ka, va, hk, sl2, lse2, delta, tq, masked,
            [&](int kl, int e) {
              return kl <= last[e >> 1] && (!has_seg || tseg[kl] == qseg[e >> 1]);
            },
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
    // 16-byte stores
    const float mul[2] = {p.scale, p.scale};
    stage_acc<Op, D>(smem + L::kQ, DQ_BM, 64 * c, dq, mul);
    named_bar_sync(1 + c, 128);
    copy_rows_out<D>(smem + L::kQ, DQ_BM, 64 * c,
                     static_cast<uint16_t*>(p.dq) +
                         (static_cast<long long>(b) * T + first_row) * p.H * D + h * D,
                     static_cast<long long>(p.H) * D, min(64, T - first_row));
  }
}

// B3 at D = 32, 80, 96: one block = one (batch*head, 64-key tile); each warp
// owns 16 keys and computes the transposed scores S^T = K Q^T, so keys are
// the M dimension.
template <typename Op, int D>
__global__ void __launch_bounds__(MMA_THREADS)
    bwd_dkv_mma_kernel(const Params p) {
  constexpr int LD = D + 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint16_t* sK = reinterpret_cast<uint16_t*>(smem_raw);
  uint16_t* sV = sK + BN * LD;
  uint16_t* sQ = sV + BN * LD;
  uint16_t* sdO = sQ + BM * LD;
  float* sLse = reinterpret_cast<float*>(sdO + BM * LD);
  float* sDelta = sLse + BM;
  int* sQSeg = reinterpret_cast<int*>(sDelta + BM);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int bh = blockIdx.x, b = bh / p.H, h = bh % p.H;
  // the first k-tiles see the most q-tiles under the causal mask: issue
  // them first
  const int k0 = blockIdx.y * BN;
  const int T = p.T;
  const long long dst = static_cast<long long>(p.H) * D;

  const uint16_t* Q = static_cast<const uint16_t*>(p.q) + b * p.q_sb + h * p.q_sh;
  const uint16_t* K = static_cast<const uint16_t*>(p.k) + b * p.k_sb + h * p.k_sh;
  const uint16_t* V = static_cast<const uint16_t*>(p.v) + b * p.v_sb + h * p.v_sh;
  const uint16_t* dO = static_cast<const uint16_t*>(p.dout) +
                       static_cast<long long>(b) * T * dst + h * D;

  load_tile16<D, LD>(sK, K, p.k_st, k0, T, BN);
  load_tile16<D, LD>(sV, V, p.v_st, k0, T, BN);

  const int r0 = warp * 16 + g;  // this thread's key rows r0 and r0 + 8
  const int krow[2] = {k0 + r0, k0 + r0 + 8};
  int kseg[2] = {0, 0};
  if (p.seg != nullptr) {
#pragma unroll
    for (int i = 0; i < 2; ++i) kseg[i] = krow[i] < T ? p.seg[b * T + krow[i]] : -2;
  }

  float dk[D / 8][4], dv[D / 8][4];
#pragma unroll
  for (int dn = 0; dn < D / 8; ++dn) {
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[dn][e] = dv[dn][e] = 0.f;
  }

  const int n_q = (T + BM - 1) / BM;
  // q-tiles wholly before this k-tile's diagonal see none of its keys
  const int j0 = p.causal ? k0 / BM : 0;
  for (int j = j0; j < n_q; ++j) {
    const int q0 = j * BM;
    __syncthreads();  // every warp is done with the previous q-tile
    load_tile16<D, LD>(sQ, Q, p.q_st, q0, T, BM);
    load_tile16<D, LD>(sdO, dO, dst, q0, T, BM);
    if (threadIdx.x < BM) {
      const int row = q0 + threadIdx.x;
      const bool in = row < T;
      const long long at = static_cast<long long>(bh) * T + row;
      sLse[threadIdx.x] = in ? p.lse[at] : 0.f;
      sDelta[threadIdx.x] = in ? p.delta[at] : 0.f;
      sQSeg[threadIdx.x] = (p.seg != nullptr && in) ? p.seg[b * T + row] : -1;
    }
    __syncthreads();

#pragma unroll 1
    for (int kk = 0; kk < BM / 16; ++kk) {
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
          const int qi = q0 + ql, ki = krow[e >> 1];
          bool ok = qi < T && ki < T;
          if (p.causal) ok = ok && ki <= qi;
          if (p.seg != nullptr) ok = ok && sQSeg[ql] == kseg[e >> 1];
          const float pr = ok ? __expf(s[half][e] * p.scale - sLse[ql]) : 0.f;
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

  uint16_t* dK = static_cast<uint16_t*>(p.dk);
  uint16_t* dV = static_cast<uint16_t*>(p.dv);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = krow[i];
    if (row >= T) continue;
    const long long off = ((static_cast<long long>(b) * T + row) * p.H + h) * D;
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

// ---------------------------------------------------------------------------
// f32 path: plain FMA over 16 x 16 tiles
// ---------------------------------------------------------------------------
constexpr int FT = 16;  // rows (or keys) per tile
constexpr int F32_THREADS = 128;

// Stage `rows` rows of an f32 [.., T, .., D] operand; rows past T are 0.
template <int D>
__device__ __forceinline__ void load_tile32(float (*dst)[D + 1], const float* src,
                                            long long st, int t0, int T) {
  for (int i = threadIdx.x; i < FT * D; i += blockDim.x) {
    const int r = i / D, c = i % D;
    dst[r][c] = t0 + r < T ? src[(t0 + r) * st + c] : 0.f;
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
__global__ void __launch_bounds__(F32_THREADS) bwd_dq_f32_kernel(const Params p) {
  __shared__ float sQ[FT][D + 1], sdO[FT][D + 1];  // +1: rows on other banks
  __shared__ float sK[FT][D + 1], sV[FT][D + 1];
  __shared__ float sdS[FT][FT];
  __shared__ float sLse[FT], sDelta[FT];
  __shared__ int sQSeg[FT], sSeg[FT];

  const int tid = threadIdx.x;
  const int bh = blockIdx.x, b = bh / p.H, h = bh % p.H;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * FT;
  const int T = p.T;
  const long long dst = static_cast<long long>(p.H) * D;
  const float* Q = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh;
  const float* K = static_cast<const float*>(p.k) + b * p.k_sb + h * p.k_sh;
  const float* V = static_cast<const float*>(p.v) + b * p.v_sb + h * p.v_sh;
  const float* dO = static_cast<const float*>(p.dout) +
                    static_cast<long long>(b) * T * dst + h * D;

  load_tile32<D>(sQ, Q, p.q_st, q0, T);
  load_tile32<D>(sdO, dO, dst, q0, T);
  if (tid < FT) {
    const int row = q0 + tid;
    const bool in = row < T;
    const long long at = static_cast<long long>(bh) * T + row;
    sLse[tid] = in ? p.lse[at] : 0.f;
    sDelta[tid] = in ? p.delta[at] : 0.f;
    sQSeg[tid] = (p.seg != nullptr && in) ? p.seg[b * T + row] : -1;
  }

  // this thread owns dQ row `orow`, columns ocol + 8 * c
  const int orow = tid / 8, ocol = tid % 8;
  float acc[D / 8];
#pragma unroll
  for (int c = 0; c < D / 8; ++c) acc[c] = 0.f;

  int n_kv = (T + FT - 1) / FT;
  if (p.causal) n_kv = min(n_kv, (q0 + 2 * FT - 1) / FT);

  for (int j = 0; j < n_kv; ++j) {
    const int k0 = j * FT;
    __syncthreads();
    load_tile32<D>(sK, K, p.k_st, k0, T);
    load_tile32<D>(sV, V, p.v_st, k0, T);
    if (p.seg != nullptr && tid < FT) {
      sSeg[tid] = k0 + tid < T ? p.seg[b * T + k0 + tid] : 0;
    }
    __syncthreads();

    for (int i = tid; i < FT * FT; i += F32_THREADS) {
      const int r = i / FT, c = i % FT;
      const int row = q0 + r, col = k0 + c;
      bool ok = col < T && row < T;
      if (p.causal) ok = ok && col <= row;
      if (p.seg != nullptr) ok = ok && sSeg[c] == sQSeg[r];
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
      float a = acc[c];
      for (int kc = 0; kc < FT; ++kc) a = fmaf(sdS[orow][kc], sK[kc][ocol + 8 * c], a);
      acc[c] = a;
    }
  }

  const int row = q0 + orow;
  if (row < T) {
    float* out = static_cast<float*>(p.dq) +
                 ((static_cast<long long>(b) * T + row) * p.H + h) * D;
#pragma unroll
    for (int c = 0; c < D / 8; ++c) out[ocol + 8 * c] = acc[c] * p.scale;
  }
}

template <int D>
__global__ void __launch_bounds__(F32_THREADS) bwd_dkv_f32_kernel(const Params p) {
  __shared__ float sK[FT][D + 1], sV[FT][D + 1];
  __shared__ float sQ[FT][D + 1], sdO[FT][D + 1];
  __shared__ float sP[FT][FT], sdS[FT][FT];  // [key][query]
  __shared__ float sLse[FT], sDelta[FT];
  __shared__ int sQSeg[FT], sKSeg[FT];

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

  load_tile32<D>(sK, K, p.k_st, k0, T);
  load_tile32<D>(sV, V, p.v_st, k0, T);
  if (tid < FT) {
    sKSeg[tid] = (p.seg != nullptr && k0 + tid < T) ? p.seg[b * T + k0 + tid] : -2;
  }

  // this thread owns dK/dV key row `orow`, columns ocol + 8 * c
  const int orow = tid / 8, ocol = tid % 8;
  float dk[D / 8], dv[D / 8];
#pragma unroll
  for (int c = 0; c < D / 8; ++c) dk[c] = dv[c] = 0.f;

  const int n_q = (T + FT - 1) / FT;
  const int j0 = p.causal ? k0 / FT : 0;
  for (int j = j0; j < n_q; ++j) {
    const int q0 = j * FT;
    __syncthreads();
    load_tile32<D>(sQ, Q, p.q_st, q0, T);
    load_tile32<D>(sdO, dO, dst, q0, T);
    if (tid < FT) {
      const int row = q0 + tid;
      const bool in = row < T;
      const long long at = static_cast<long long>(bh) * T + row;
      sLse[tid] = in ? p.lse[at] : 0.f;
      sDelta[tid] = in ? p.delta[at] : 0.f;
      sQSeg[tid] = (p.seg != nullptr && in) ? p.seg[b * T + row] : -1;
    }
    __syncthreads();

    for (int i = tid; i < FT * FT; i += F32_THREADS) {
      const int c = i / FT, r = i % FT;  // key c, query r
      const int row = q0 + r, col = k0 + c;
      bool ok = col < T && row < T;
      if (p.causal) ok = ok && col <= row;
      if (p.seg != nullptr) ok = ok && sKSeg[c] == sQSeg[r];
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
      float a = dv[c], s = dk[c];
      for (int r = 0; r < FT; ++r) {
        a = fmaf(sP[orow][r], sdO[r][ocol + 8 * c], a);
        s = fmaf(sdS[orow][r], sQ[r][ocol + 8 * c], s);
      }
      dv[c] = a;
      dk[c] = s;
    }
  }

  const int row = k0 + orow;
  if (row < T) {
    const long long off = ((static_cast<long long>(b) * T + row) * p.H + h) * D;
    float* outk = static_cast<float*>(p.dk) + off;
    float* outv = static_cast<float*>(p.dv) + off;
#pragma unroll
    for (int c = 0; c < D / 8; ++c) {
      outk[ocol + 8 * c] = dk[c] * p.scale;
      outv[ocol + 8 * c] = dv[c];
    }
  }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------
enum Which { DQ = 0, DKV = 1 };

template <typename Op, int D>
cudaError_t launch_dkv_wgmma(const Params& p, cudaStream_t stream) {
  const long long HD = static_cast<long long>(p.H) * D;
  CUtensorMap map_q, map_k, map_v, map_do;
  cudaError_t err = make_tile_map(&map_q, p.q, Op::kF16, p.B, p.T, p.H, D, p.q_sb,
                                  p.q_st, p.q_sh, WG_BQ);
  if (err == cudaSuccess) {
    err = make_tile_map(&map_k, p.k, Op::kF16, p.B, p.T, p.H, D, p.k_sb, p.k_st, p.k_sh,
                        WG_BK);
  }
  if (err == cudaSuccess) {
    err = make_tile_map(&map_v, p.v, Op::kF16, p.B, p.T, p.H, D, p.v_sb, p.v_st, p.v_sh,
                        WG_BK);
  }
  if (err == cudaSuccess) {
    err = make_tile_map(&map_do, p.dout, Op::kF16, p.B, p.T, p.H, D, p.T * HD, HD, D,
                        WG_BQ);
  }
  if (err != cudaSuccess) return err;
  constexpr int smem = DkvLayout<D>::kBytes;
  err = cudaFuncSetAttribute(flash_bwd_dkv_wgmma_kernel<Op, D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(p.B * p.H, (p.T + WG_BK - 1) / WG_BK);
  flash_bwd_dkv_wgmma_kernel<Op, D><<<grid, WG_THREADS, smem, stream>>>(map_q, map_k, map_v, map_do, p);
  return cudaGetLastError();
}

template <typename Op, int D>
cudaError_t launch_dq_wgmma(const Params& p, cudaStream_t stream) {
  const long long HD = static_cast<long long>(p.H) * D;
  CUtensorMap map_q, map_k, map_v, map_do;
  cudaError_t err = make_tile_map(&map_q, p.q, Op::kF16, p.B, p.T, p.H, D, p.q_sb,
                                  p.q_st, p.q_sh, DQ_BM);
  if (err == cudaSuccess) {
    err = make_tile_map(&map_k, p.k, Op::kF16, p.B, p.T, p.H, D, p.k_sb, p.k_st, p.k_sh,
                        DQ_BN);
  }
  if (err == cudaSuccess) {
    err = make_tile_map(&map_v, p.v, Op::kF16, p.B, p.T, p.H, D, p.v_sb, p.v_st, p.v_sh,
                        DQ_BN);
  }
  if (err == cudaSuccess) {
    err = make_tile_map(&map_do, p.dout, Op::kF16, p.B, p.T, p.H, D, p.T * HD, HD, D,
                        DQ_BM);
  }
  if (err != cudaSuccess) return err;
  constexpr int smem = DqLayout<D>::kBytes;
  err = cudaFuncSetAttribute(bwd_dq_wgmma_kernel<Op, D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(p.B * p.H, (p.T + DQ_BM - 1) / DQ_BM);
  bwd_dq_wgmma_kernel<Op, D><<<grid, WG_THREADS, smem, stream>>>(map_q, map_k, map_v, map_do, p);
  return cudaGetLastError();
}

// 16-bit inputs: the wgmma kernels at D = 64 and 128, mma.sync at the others
template <typename Op, int D>
cudaError_t launch_mma(const Params& p, Which which, cudaStream_t stream) {
  const int smem = static_cast<int>(mma_smem_bytes<D>());
  const dim3 grid(p.B * p.H, (p.T + BM - 1) / BM);
  if constexpr (D == 64 || D == 128) {
    return which == DQ ? launch_dq_wgmma<Op, D>(p, stream) : launch_dkv_wgmma<Op, D>(p, stream);
  } else if (which == DQ) {
    cudaError_t err = cudaFuncSetAttribute(
        bwd_dq_mma_kernel<Op, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    bwd_dq_mma_kernel<Op, D><<<grid, MMA_THREADS, smem, stream>>>(p);
  } else {
    cudaError_t err = cudaFuncSetAttribute(
        bwd_dkv_mma_kernel<Op, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    bwd_dkv_mma_kernel<Op, D><<<grid, MMA_THREADS, smem, stream>>>(p);
  }
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_f32(const Params& p, Which which, cudaStream_t stream) {
  const dim3 grid(p.B * p.H, (p.T + FT - 1) / FT);
  if (which == DQ) {
    bwd_dq_f32_kernel<D><<<grid, F32_THREADS, 0, stream>>>(p);
  } else {
    bwd_dkv_f32_kernel<D><<<grid, F32_THREADS, 0, stream>>>(p);
  }
  return cudaGetLastError();
}

template <int D>
cudaError_t dispatch_dtype(const Params& p, Which which, int dtype,
                           cudaStream_t stream) {
  switch (dtype) {
    case 0: return launch_f32<D>(p, which, stream);
    case 1: return launch_mma<Bf16, D>(p, which, stream);
    case 2: return launch_mma<Fp16, D>(p, which, stream);
    default: return cudaErrorInvalidValue;
  }
}

int run(const Params& p, Which which, int D, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (D) {
    case 32: err = dispatch_dtype<32>(p, which, dtype, s); break;
    case 64: err = dispatch_dtype<64>(p, which, dtype, s); break;
    case 80: err = dispatch_dtype<80>(p, which, dtype, s); break;
    case 96: err = dispatch_dtype<96>(p, which, dtype, s); break;
    case 128: err = dispatch_dtype<128>(p, which, dtype, s); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

Params make_params(const void* q, const void* k, const void* v, const void* seg,
                   const void* dout, const void* lse, const void* delta, int B,
                   int T, int H, const long long* strides, float scale, int causal) {
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.seg = static_cast<const int*>(seg);
  p.dout = dout;
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<const float*>(delta);
  p.dq = p.dk = p.dv = nullptr;
  p.B = B;
  p.T = T;
  p.H = H;
  p.q_sb = strides[0]; p.q_st = strides[1]; p.q_sh = strides[2];
  p.k_sb = strides[3]; p.k_st = strides[4]; p.k_sh = strides[5];
  p.v_sb = strides[6]; p.v_st = strides[7]; p.v_sh = strides[8];
  p.scale = scale;
  p.causal = causal;
  return p;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, 2 = float16. `strides` holds the batch,
// sequence and head strides of q, k and v (9 values, in elements). Each
// returns a cudaError_t.
extern "C" int ds_flash_attention_bwd_dq(
    const void* q, const void* k, const void* v, const void* seg,
    const void* dout, const void* lse, const void* delta, void* dq, int B,
    int T, int H, int D, const long long* strides, float scale, int causal,
    int dtype, void* stream) {
  Params p = make_params(q, k, v, seg, dout, lse, delta, B, T, H, strides,
                         scale, causal);
  p.dq = dq;
  return run(p, DQ, D, dtype, stream);
}

extern "C" int ds_flash_attention_bwd_dkv(
    const void* q, const void* k, const void* v, const void* seg,
    const void* dout, const void* lse, const void* delta, void* dk, void* dv,
    int B, int T, int H, int D, const long long* strides, float scale,
    int causal, int dtype, void* stream) {
  Params p = make_params(q, k, v, seg, dout, lse, delta, B, T, H, strides,
                         scale, causal);
  p.dk = dk;
  p.dv = dv;
  return run(p, DKV, D, dtype, stream);
}
