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
// TFLOP/s) rather than by HBM (25 and 30 us at 3.35 TB/s). The design keeps every product on
// mma.sync with f32 accumulation and keeps P and dS out of device memory.
//
// Design (simple and correct first; ldmatrix, cp.async/TMA pipelining and
// wgmma are later work):
// * Two kernels, no atomics: B2 owns a 64-row q-tile and loops over the K/V
//   tiles up to the diagonal; B3 owns a 64-key tile and loops over the q
//   tiles from the diagonal to the end. Every output element is written by
//   exactly one block in a fixed order, so gradients are bit-reproducible.
// * 16-bit inputs: 4 warps per block, 16 rows (B2) or 16 keys (B3) per warp,
//   m16n8k16 bf16/f16 products with f32 accumulators. P and dS are built 16
//   columns at a time from C fragments and re-packed in registers as the A
//   fragment of the next product (the forward kernel's trick), so the only
//   f32 arrays a thread carries are its accumulators. In B3 that is dK and dV
//   (2 x 64 floats at D = 128); to leave room for them K and V stay in shared
//   memory and their A fragments are re-read per k-step instead of being
//   held in registers.
// * f32 inputs: plain FMA kernels over 16 x 16 tiles with scores in shared
//   memory, since TF32 tensor cores would not hold the f32 tolerance.
// * q, k, v are read in [B, T, H, D] through their strides (views into the
//   fused projection); dO, dQ, dK and dV are [B, T, H, D] contiguous and lse
//   and delta [B, H, T] f32. Masks are those of the forward: causal,
//   same-segment, and positions past T. A masked pair contributes exactly 0
//   (P is set to 0, never exp of a huge negative), so fully masked tiles and
//   ragged tails give 0 and never NaN.

#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_sm80.cuh"

namespace {

using ds_mma::Bf16;
using ds_mma::Fp16;
using ds_mma::ld32;
using ds_mma::ld_col2;
using ds_mma::load_tile16;

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

// B3: one block = one (batch*head, 64-key tile); each warp owns 16 keys and
// computes the transposed scores S^T = K Q^T, so keys are the M dimension.
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
cudaError_t launch_mma(const Params& p, Which which, cudaStream_t stream) {
  const int smem = static_cast<int>(mma_smem_bytes<D>());
  const dim3 grid(p.B * p.H, (p.T + BM - 1) / BM);
  if (which == DQ) {
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
