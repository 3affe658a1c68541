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
// score matrix never leaves the chip, and each K/V tile is reused by the 64
// query rows of its block.
//
// Design (simple and correct first; wgmma, TMA and warp specialisation are
// later work):
// * 16-bit inputs: one block = 4 warps = 64 query rows of one (batch, head),
//   16 rows per warp. Q lives in registers as mma.sync A fragments; a loop
//   walks 64-key K/V tiles staged in shared memory (the TPU's sequential grid
//   axis becomes this loop). S = Q K^T and O += P V use
//   mma.sync.m16n8k16 with f32 accumulators; the running max m, sum l and the
//   O accumulator stay in registers, in f32.
// * f32 inputs: a plain FMA kernel (16 query rows, 32-key tiles, scores in
//   shared memory) that keeps full f32 arithmetic.
// * q, k, v are read in [B, T, H, D] through their strides (no transposes);
//   O is written [B, T, H, D] in the input dtype and lse [B, H, T] in f32.
// * Causal: the key loop stops at the diagonal tile. Masked scores take the
//   finite NEG_INF = -1e30, so a masked key gets exactly zero weight and a
//   segment-0 pad row still sees its own diagonal. Any T works: rows and keys
//   past T are zero-filled in shared memory and masked.

#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_sm80.cuh"

namespace {

using ds_mma::Bf16;
using ds_mma::Fp16;
using ds_mma::ld32;
using ds_mma::load_tile16;
using ds_mma::NEG_INF;

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
// 16-bit path: mma.sync m16n8k16, f32 accumulate
// ---------------------------------------------------------------------------
constexpr int BM = 64;  // query rows per block
constexpr int BN = 64;  // keys per K/V tile
constexpr int MMA_THREADS = 128;

template <typename Op, int D>
__global__ void __launch_bounds__(MMA_THREADS)
    fwd_mma_kernel(const Params p) {
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
__global__ void __launch_bounds__(F32_THREADS) fwd_f32_kernel(const Params p) {
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
      fwd_mma_kernel<Op, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(p.B * p.H, (p.T + BM - 1) / BM);
  fwd_mma_kernel<Op, D><<<grid, MMA_THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_f32(const Params& p, cudaStream_t stream) {
  const dim3 grid(p.B * p.H, (p.T + FBM - 1) / FBM);
  fwd_f32_kernel<D><<<grid, F32_THREADS, 0, stream>>>(p);
  return cudaGetLastError();
}

template <int D>
cudaError_t dispatch_dtype(const Params& p, int dtype, cudaStream_t stream) {
  switch (dtype) {
    case 0: return launch_f32<D>(p, stream);
    case 1: return launch_mma<Bf16, D>(p, stream);
    case 2: return launch_mma<Fp16, D>(p, stream);
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
