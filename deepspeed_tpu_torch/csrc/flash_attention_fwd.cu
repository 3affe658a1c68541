// Flash-attention forward for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel deepspeed_tpu/ops/pallas/flash_attention.py
// `_fwd_kernel` (line 53, launched by `_fwd` at line 114): causal or full
// attention with an online softmax and an optional same-segment mask,
// writing O and the per-row logsumexp.
//
// What bounds it on an H100: at the serving shape of GPT-2 1.3B (B=4,
// T=1024, H=16, D=128, causal, bf16) one call does ~17.2 GFLOP of tensor-core
// work (QK^T and PV over the causal half) and must move ~67 MB (q, k, v read
// once, O written once). At 989 TFLOP/s and 3.35 TB/s both bounds are near
// 20 us, so neither the tensor cores nor HBM can be left idle: the [T, T]
// score matrix never leaves the chip, and each K/V tile is reused by the 128
// query rows of its block.
//
// Design, 16-bit inputs at D = 64 and 128 (`flash_fwd_wgmma_kernel`; its
// consumer pass, `ds_fwd::fwd_pass` in flash_fwd_pass.cuh, is shared with the
// block-sparse forward B5, which walks a table instead of 0..diagonal):
// * One block = 128 query rows of one (batch, head) and three warpgroups. A
//   producer warp (registers cut to 24 with setmaxnreg) issues the TMA loads:
//   Q once, then 128-key K/V tiles into a two-stage ring in shared memory
//   (128-byte swizzle), each stage with a full mbarrier (transaction bytes)
//   and an empty mbarrier (one arrival per consumer), so the next tile lands
//   while the current one is used. Two consumer warpgroups (setmaxnreg
//   240) own 64 rows each.
// * A tile is used in two passes of 64 keys, so that a pass's scores (32
//   f32 per thread) and packed P fit beside the O accumulator (D / 2 f32)
//   without spilling (one 128-key pass spilled and was 12% slower). S = Q K^T
//   is one wgmma.m64n64k16 per 16 columns of D, both operands K-major in
//   shared memory. The online softmax stays in registers in f32, in log2
//   units (exp2 of scale * log2(e) * s). P is rounded to the input type and
//   re-packed from the accumulator as the register A operand of O += P V,
//   an RS wgmma that reads V from shared memory with the transpose bit (V's
//   contraction dimension is the key), so V is never transposed.
// * Causal: the key loop stops at the diagonal tile; a pass whose keys all
//   lie after the warpgroup's rows is skipped (it would add exactly
//   nothing), and only passes that cross the diagonal (or the end of T, or
//   any pass when segment ids are given; the producer stages the tile's key
//   segment ids) run the compare/select; the others only scale. Masked
//   scores take the finite NEG_INF = -1e30, so a masked key gets exactly
//   zero weight and a segment-0 pad row still sees its own diagonal. Rows
//   and keys past T arrive zero-filled from TMA and are masked; no row past
//   T is written.
// * q, k, v are read as [B, T, H, D] through their strides by 4-D tensor maps
//   (D, H, T, B), so the fused-qkv views need no copy. The epilogue writes
//   O / l through the block's own Q tile in shared memory and out with
//   16-byte stores; lse [B, H, T] is f32.
// * Not yet: overlapping one tile's softmax with the next tile's QK^T
//   (intra-warpgroup pipelining, consumer ping-pong), a deeper ring, a
//   persistent grid.
// Other 16-bit head dims (32, 80, 96) keep the first design of this port,
// `flash_fwd_mma_kernel` (mma.sync m16n8k16, 64 rows per block, K/V tiles
// staged by plain 16-byte loads): the entry point switches on D. f32 inputs
// take a plain FMA kernel (16 query rows, 32-key tiles, scores in shared
// memory) that keeps full f32 arithmetic; TF32 would not hold its tolerance.

#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_fwd_pass.cuh"
#include "hopper.cuh"
#include "mma_sm80.cuh"

namespace {

using ds_mma::Bf16;
using ds_mma::Fp16;
using ds_mma::ld32;
using ds_mma::load_tile16;
using ds_mma::NEG_INF;
using namespace ds_hopper;
using namespace ds_fwd;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const int* seg;  // [B, T] or nullptr
  void* o;         // [B, T, H, D] contiguous
  float* lse;      // [B, H, T] contiguous
  int B, T, H;
  long long q_sb, q_st, q_sh;
  long long k_sb, k_st, k_sh;
  long long v_sb, v_st, v_sh;
  float scale;
  int causal;
};

// ---------------------------------------------------------------------------
// 16-bit path, D = 64 and 128: wgmma + TMA, warp-specialised; the consumer
// pass is ds_fwd::fwd_pass (flash_fwd_pass.cuh), shared with B5
// ---------------------------------------------------------------------------
template <typename Op, int D>
__global__ void __launch_bounds__(WG_THREADS, 1)
    flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap map_q,
                           const __grid_constant__ CUtensorMap map_k,
                           const __grid_constant__ CUtensorMap map_v, const Params p) {
  using L = FwdLayout<D>;
  extern __shared__ __align__(16) unsigned char smem_raw[];  // aligned below
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* smem = smem_raw + (base - raw);
  const uint32_t bar_q = base + L::kBar;
  const uint32_t bar_full = bar_q + 8, bar_empty = bar_full + 8 * WG_STAGES;

  const int T = p.T, bh = blockIdx.x, b = bh / p.H, h = bh % p.H;
  // longest causal rows first, so the short tiles fill the tail of the grid
  const int q0 = (gridDim.y - 1 - blockIdx.y) * WG_BM;
  int n_kv = (T + WG_BN - 1) / WG_BN;
  if (p.causal) n_kv = min(n_kv, (q0 + WG_BM + WG_BN - 1) / WG_BN);

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < WG_STAGES; ++s) {
      mbar_init(bar_full + 8 * s, 1);
      mbar_init(bar_empty + 8 * s, 2);  // one arrival per consumer warpgroup
    }
    fence_barrier_init();
  }
  __syncthreads();

  int* sseg = reinterpret_cast<int*>(smem + L::kSeg);
  // the warpgroup's role, warp-uniform; the shuffle lets the compiler see
  // that (as CUTLASS's canonical_warp_group_idx does)
  const int wg = __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x) / 128, 0);
  if (wg == 0) {
    // producer: warp 0 loads Q, then walks the K/V tiles through the ring
    setmaxnreg_dec<24>();
    const int lane = threadIdx.x;
    if (lane < 32) {
      if (lane == 0) {
        mbar_arrive_expect_tx(bar_q, WG_BM * D * 2);
        for (int c = 0; c < D / 64; ++c) {
          tma_load_4d(base + L::kQ + c * WG_BM * 128, &map_q, bar_q, c * 64, h, q0, b);
        }
      }
      for (int j = 0; j < n_kv; ++j) {
        const int s = j % WG_STAGES;
        mbar_wait(bar_empty + 8 * s, ((j / WG_STAGES) & 1) ^ 1);
        if (p.seg != nullptr) {
          for (int i = lane; i < WG_BN; i += 32) {
            const int key = j * WG_BN + i;
            sseg[s * WG_BN + i] = key < T ? p.seg[b * T + key] : -1;
          }
          __syncwarp();  // the ids are written before lane 0 arrives
        }
        if (lane == 0) {
          const uint32_t full = bar_full + 8 * s;
          const uint32_t dst = base + L::kKV + s * 2 * L::kTile;
          mbar_arrive_expect_tx(full, 2 * L::kTile);
          for (int c = 0; c < D / 64; ++c) {
            tma_load_4d(dst + c * WG_BN * 128, &map_k, full, c * 64, h, j * WG_BN, b);
            tma_load_4d(dst + L::kTile + c * WG_BN * 128, &map_v, full, c * 64, h,
                        j * WG_BN, b);
          }
        }
      }
    }
  } else {
    // consumers: warpgroup c owns rows q0 + 64c .. q0 + 64c + 63
    setmaxnreg_inc<240>();
    const int c = wg - 1;
    const int t = threadIdx.x & 127, lane = t & 31;
    const int r0 = q0 + 64 * c + 16 * (t >> 5) + (lane >> 2);  // rows r0, r0 + 8
    int qseg[2] = {0, 0};
    if (p.seg != nullptr) {
#pragma unroll
      for (int i = 0; i < 2; ++i) qseg[i] = r0 + 8 * i < T ? p.seg[b * T + r0 + 8 * i] : -2;
    }
    const float sl2 = p.scale * LOG2E;  // scores in log2 units
    const bool causal = p.causal, has_seg = p.seg != nullptr;
    FwdRows<D> st;
    st.init();
    const uint64_t q_desc = desc_sw128(base + L::kQ + 64 * c * 128, 16, 1024);
    // a pass needs the compare/select only if it crosses the diagonal of
    // this warpgroup's rows, the end of T, or segments are given
    const int first_row = q0 + 64 * c;

    mbar_wait(bar_q, 0);
    for (int j = 0; j < n_kv; ++j) {
      const int s = j % WG_STAGES, k0 = j * WG_BN;
      mbar_wait(bar_full + 8 * s, (j / WG_STAGES) & 1);
      const uint32_t ka = base + L::kKV + s * 2 * L::kTile, va = ka + L::kTile;
      const int* tseg = sseg + s * WG_BN;
      // per row, the last key column of this tile it may see: before T,
      // and under causal not after the row
      const int last[2] = {(causal ? min(T - 1, r0) : T - 1) - k0,
                           (causal ? min(T - 1, r0 + 8) : T - 1) - k0};
#pragma unroll
      for (int hk = 0; hk < WG_BN / WG_KH; ++hk) {
        const int kp = k0 + hk * WG_KH;  // the pass's first key
        // every key after every row: exactly nothing to add (P = 0, alpha =
        // 1), since each row has seen its own key by now
        if (causal && kp > first_row + 63) continue;
        const bool masked =
            has_seg || kp + WG_KH > T || (causal && kp + WG_KH - 1 > first_row);
        fwd_pass<Op, D>(st, q_desc, ka, va, hk, sl2, masked, [&](int kl, int e) {
          return kl <= last[e >> 1] && (!has_seg || tseg[kl] == qseg[e >> 1]);
        });
      }
      if (t == 0) mbar_arrive(bar_empty + 8 * s);
    }

    float inv[2], lse[2];
    st.finish(inv, lse);
    // O / l through this warpgroup's own rows of the Q tile, then 16-byte stores
    stage_acc<Op, D>(smem + L::kQ, WG_BM, 64 * c, st.o, inv);
    named_bar_sync(1 + c, 128);
    copy_rows_out<D>(smem + L::kQ, WG_BM, 64 * c,
                     static_cast<uint16_t*>(p.o) +
                         (static_cast<long long>(b) * T + first_row) * p.H * D + h * D,
                     static_cast<long long>(p.H) * D, min(64, T - first_row));
    if (st.tq == 0) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int row = r0 + 8 * i;
        if (row < T) p.lse[static_cast<long long>(bh) * T + row] = lse[i];
      }
    }
  }
}

// ---------------------------------------------------------------------------
// 16-bit path, other head dims: mma.sync m16n8k16, f32 accumulate
// ---------------------------------------------------------------------------
constexpr int BM = 64;  // query rows per block
constexpr int BN = 64;  // keys per K/V tile
constexpr int MMA_THREADS = 128;

template <typename Op, int D>
__global__ void __launch_bounds__(MMA_THREADS)
    flash_fwd_mma_kernel(const Params p) {
  constexpr int LD = D + 8;  // padded row: 16-byte aligned, staggers banks
  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint16_t* sQ = reinterpret_cast<uint16_t*>(smem_raw);
  uint16_t* sK = sQ + BM * LD;
  uint16_t* sV = sK + BN * LD;
  int* sSeg = reinterpret_cast<int*>(sV + BN * LD);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int bh = blockIdx.x, b = bh / p.H, h = bh % p.H;
  // longest causal rows first, so the short tiles fill the tail of the grid
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BM;
  const int T = p.T;

  const uint16_t* Q = static_cast<const uint16_t*>(p.q) + b * p.q_sb + h * p.q_sh;
  const uint16_t* K = static_cast<const uint16_t*>(p.k) + b * p.k_sb + h * p.k_sh;
  const uint16_t* V = static_cast<const uint16_t*>(p.v) + b * p.v_sb + h * p.v_sh;

  load_tile16<D, LD>(sQ, Q, p.q_st, q0, T, BM);
  __syncthreads();

  // Q as A fragments: rows g / g+8 of this warp's 16, k-step kk of 16 columns
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
  int qseg[2] = {0, 0};
  if (p.seg != nullptr) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      qseg[i] = qrow[i] < T ? p.seg[b * T + qrow[i]] : -1;
    }
  }

  float m_r[2] = {NEG_INF, NEG_INF};
  float l_r[2] = {0.f, 0.f};  // this thread's partial row sums
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

    // S = Q K^T for this warp's 16 rows x 64 keys (8 n-tiles of 8 keys)
    float s[BN / 8][4];
#pragma unroll
    for (int jn = 0; jn < BN / 8; ++jn) {
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
    for (int jn = 0; jn < BN / 8; ++jn) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kl = jn * 8 + tq * 2 + (e & 1);
        const int col = k0 + kl;
        bool ok = col < T;
        if (p.causal) ok = ok && col <= qrow[e >> 1];
        if (p.seg != nullptr) ok = ok && sSeg[kl] == qseg[e >> 1];
        s[jn][e] = ok ? s[jn][e] * p.scale : NEG_INF;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[jn][e]);
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
    }
    const float alpha[2] = {__expf(m_r[0] - mx[0]), __expf(m_r[1] - mx[1])};
    m_r[0] = mx[0];
    m_r[1] = mx[1];

    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int jn = 0; jn < BN / 8; ++jn) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[jn][e] = __expf(s[jn][e] - mx[e >> 1]);
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

    // O += P V: the S accumulators of n-tiles 2kk, 2kk+1 are exactly the A
    // fragment of k-step kk; V is read as B with k = key, n = head column
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
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
        const uint32_t vb[2] = {
            static_cast<uint32_t>(vp[0]) | (static_cast<uint32_t>(vp[LD]) << 16),
            static_cast<uint32_t>(vp[8 * LD]) |
                (static_cast<uint32_t>(vp[9 * LD]) << 16),
        };
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
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = qrow[i];
    if (row >= T) continue;
    uint16_t* orow = O + ((static_cast<long long>(b) * T + row) * p.H + h) * D;
#pragma unroll
    for (int dn = 0; dn < D / 8; ++dn) {
      *reinterpret_cast<uint32_t*>(orow + dn * 8 + tq * 2) =
          Op::pack(acc[dn][2 * i] / l_r[i], acc[dn][2 * i + 1] / l_r[i]);
    }
    if (tq == 0) {
      p.lse[static_cast<long long>(bh) * T + row] = m_r[i] + logf(l_r[i]);
    }
  }
}

// ---------------------------------------------------------------------------
// f32 path: plain FMA
// ---------------------------------------------------------------------------
constexpr int FBM = 16;  // query rows per block
constexpr int FBN = 32;  // keys per tile
constexpr int F32_THREADS = 128;

template <int D>
__global__ void __launch_bounds__(F32_THREADS) flash_fwd_f32_kernel(const Params p) {
  __shared__ float sQ[FBM][D];
  __shared__ float sK[FBN][D + 1];  // +1: a warp reads 32 keys at one column
  __shared__ float sV[FBN][D];
  __shared__ float sS[FBM][FBN];
  __shared__ float sM[FBM], sL[FBM], sAlpha[FBM];
  __shared__ int sSeg[FBN];
  __shared__ int sQSeg[FBM];

  const int tid = threadIdx.x;
  const int bh = blockIdx.x, b = bh / p.H, h = bh % p.H;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * FBM;
  const int T = p.T;
  const float* Q = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh;
  const float* K = static_cast<const float*>(p.k) + b * p.k_sb + h * p.k_sh;
  const float* V = static_cast<const float*>(p.v) + b * p.v_sb + h * p.v_sh;

  for (int i = tid; i < FBM * D; i += F32_THREADS) {
    const int r = i / D, c = i % D;
    sQ[r][c] = q0 + r < T ? Q[(q0 + r) * p.q_st + c] : 0.f;
  }
  if (tid < FBM) {
    sM[tid] = NEG_INF;
    sL[tid] = 0.f;
    sQSeg[tid] = (p.seg != nullptr && q0 + tid < T) ? p.seg[b * T + q0 + tid] : -1;
  }

  // this thread owns output row `orow`, columns ocol + 8 * c
  const int orow = tid / 8, ocol = tid % 8;
  float acc[D / 8];
#pragma unroll
  for (int c = 0; c < D / 8; ++c) acc[c] = 0.f;

  int n_kv = (T + FBN - 1) / FBN;
  if (p.causal) n_kv = min(n_kv, (q0 + FBM + FBN - 1) / FBN);

  for (int j = 0; j < n_kv; ++j) {
    const int k0 = j * FBN;
    __syncthreads();
    for (int i = tid; i < FBN * D; i += F32_THREADS) {
      const int r = i / D, c = i % D;
      const bool in = k0 + r < T;
      sK[r][c] = in ? K[(k0 + r) * p.k_st + c] : 0.f;
      sV[r][c] = in ? V[(k0 + r) * p.v_st + c] : 0.f;
    }
    if (p.seg != nullptr && tid < FBN) {
      sSeg[tid] = k0 + tid < T ? p.seg[b * T + k0 + tid] : 0;
    }
    __syncthreads();

    for (int i = tid; i < FBM * FBN; i += F32_THREADS) {
      const int r = i / FBN, c = i % FBN;
      float dot = 0.f;
#pragma unroll 8
      for (int d = 0; d < D; ++d) dot = fmaf(sQ[r][d], sK[c][d], dot);
      const int col = k0 + c, row = q0 + r;
      bool ok = col < T;
      if (p.causal) ok = ok && col <= row;
      if (p.seg != nullptr) ok = ok && sSeg[c] == sQSeg[r];
      sS[r][c] = ok ? dot * p.scale : NEG_INF;
    }
    __syncthreads();

    if (tid < FBM) {
      float mx = sM[tid];
      for (int c = 0; c < FBN; ++c) mx = fmaxf(mx, sS[tid][c]);
      float sum = 0.f;
      for (int c = 0; c < FBN; ++c) {
        const float e = expf(sS[tid][c] - mx);
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
      float a = acc[c] * alpha;
      for (int kc = 0; kc < FBN; ++kc) a = fmaf(sS[orow][kc], sV[kc][ocol + 8 * c], a);
      acc[c] = a;
    }
  }
  __syncthreads();

  const int row = q0 + orow;
  if (row < T) {
    float* O = static_cast<float*>(p.o) + ((static_cast<long long>(b) * T + row) * p.H + h) * D;
    const float l = sL[orow];
#pragma unroll
    for (int c = 0; c < D / 8; ++c) O[ocol + 8 * c] = acc[c] / l;
    if (ocol == 0) {
      p.lse[static_cast<long long>(bh) * T + row] = sM[orow] + logf(l);
    }
  }
}

template <typename Op, int D>
cudaError_t launch_mma(const Params& p, cudaStream_t stream) {
  constexpr int LD = D + 8;
  const size_t smem = (BM + 2 * BN) * LD * sizeof(uint16_t) + BN * sizeof(int);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_mma_kernel<Op, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(p.B * p.H, (p.T + BM - 1) / BM);
  flash_fwd_mma_kernel<Op, D><<<grid, MMA_THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename Op, int D>
cudaError_t launch_wgmma(const Params& p, cudaStream_t stream) {
  CUtensorMap map_q, map_k, map_v;
  cudaError_t err = make_tile_map(&map_q, p.q, Op::kF16, p.B, p.T, p.H, D, p.q_sb,
                                  p.q_st, p.q_sh, WG_BM);
  if (err == cudaSuccess) {
    err = make_tile_map(&map_k, p.k, Op::kF16, p.B, p.T, p.H, D, p.k_sb, p.k_st, p.k_sh,
                        WG_BN);
  }
  if (err == cudaSuccess) {
    err = make_tile_map(&map_v, p.v, Op::kF16, p.B, p.T, p.H, D, p.v_sb, p.v_st, p.v_sh,
                        WG_BN);
  }
  if (err != cudaSuccess) return err;
  constexpr int smem = FwdLayout<D>::kBytes;
  err = cudaFuncSetAttribute(flash_fwd_wgmma_kernel<Op, D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(p.B * p.H, (p.T + WG_BM - 1) / WG_BM);
  flash_fwd_wgmma_kernel<Op, D><<<grid, WG_THREADS, smem, stream>>>(map_q, map_k, map_v, p);
  return cudaGetLastError();
}

// 16-bit inputs: the wgmma kernel at D = 64 and 128, mma.sync at the others
template <typename Op, int D>
cudaError_t launch_16(const Params& p, cudaStream_t stream) {
  if constexpr (D == 64 || D == 128) {
    return launch_wgmma<Op, D>(p, stream);
  } else {
    return launch_mma<Op, D>(p, stream);
  }
}

template <int D>
cudaError_t launch_f32(const Params& p, cudaStream_t stream) {
  const dim3 grid(p.B * p.H, (p.T + FBM - 1) / FBM);
  flash_fwd_f32_kernel<D><<<grid, F32_THREADS, 0, stream>>>(p);
  return cudaGetLastError();
}

template <int D>
cudaError_t dispatch_dtype(const Params& p, int dtype, cudaStream_t stream) {
  switch (dtype) {
    case 0: return launch_f32<D>(p, stream);
    case 1: return launch_16<Bf16, D>(p, stream);
    case 2: return launch_16<Fp16, D>(p, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, 2 = float16. Returns a cudaError_t.
extern "C" int ds_flash_attention_fwd(
    const void* q, const void* k, const void* v, const void* seg, void* o,
    void* lse, int B, int T, int H, int D, long long q_sb, long long q_st,
    long long q_sh, long long k_sb, long long k_st, long long k_sh,
    long long v_sb, long long v_st, long long v_sh, float scale, int causal,
    int dtype, void* stream) {
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.seg = static_cast<const int*>(seg);
  p.o = o;
  p.lse = static_cast<float*>(lse);
  p.B = B;
  p.T = T;
  p.H = H;
  p.q_sb = q_sb; p.q_st = q_st; p.q_sh = q_sh;
  p.k_sb = k_sb; p.k_st = k_st; p.k_sh = k_sh;
  p.v_sb = v_sb; p.v_st = v_st; p.v_sh = v_sh;
  p.scale = scale;
  p.causal = causal;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (D) {
    case 32: err = dispatch_dtype<32>(p, dtype, s); break;
    case 64: err = dispatch_dtype<64>(p, dtype, s); break;
    case 80: err = dispatch_dtype<80>(p, dtype, s); break;
    case 96: err = dispatch_dtype<96>(p, dtype, s); break;
    case 128: err = dispatch_dtype<128>(p, dtype, s); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
