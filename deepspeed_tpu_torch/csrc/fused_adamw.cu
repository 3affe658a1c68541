// Multi-tensor fused AdamW for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel deepspeed_tpu/ops/pallas/fused_adam.py
// `_adamw_kernel` (line 26, launched by `fused_adamw_update` at line 45 once
// per parameter leaf): one pass that reads p, g, m, v and writes p, m, v in
// place, with
//   m = b1 m + (1 - b1) g,   v = b2 v + (1 - b2) g g        (m, v in f32)
//   p = p - lr ((m / c1) / (sqrt(v / c2) + eps) + wd p)     (in f32)
// and the bias corrections c1 = 1 - b1^t, c2 = 1 - b2^t computed on the host.
// lr, c1, c2 and a skip flag are read from a device f32 buffer, as the Pallas
// kernel reads lr_ref, c1_ref and c2_ref (fused_adam.py:26-32): the host
// writes them before each step, so a captured CUDA graph replays with the
// step's values, and the step function sets the skip flag on the card (the
// fp16 overflow skip, the JAX step's lax.cond), whereupon every block returns
// before touching p, m and v.
//
// What bounds it on an H100: ~10 flops per element against 22 bytes moved
// (bf16 p and g read, f32 m and v read and written, bf16 p written), so it
// is bound by HBM bandwidth: ~28.9 GB for GPT-2 1.3B's 1.31 B parameters,
// ~8.6 ms at 3.35 TB/s. The design therefore reads and writes each buffer
// exactly once and makes the whole update ONE launch (DeepSpeed's
// multi_tensor_adam.cu layout), instead of the JAX wrapper's launch per leaf
// plus its flattening and padding copies:
// * the caller passes a device table of (p, g, m, v, numel, first chunk)
//   rows, one per tensor; block c of the grid finds its tensor by binary
//   search over the first-chunk column and updates one CHUNK of it;
// * every thread moves 8 elements per step with 16-byte vector loads and
//   stores when all four buffers of the tensor are 16-byte aligned, and one
//   element at a time otherwise and in the tail;
// * each operation is rounded as its own IEEE f32 step (__fmul_rn etc.), so
//   the result matches the plain PyTorch version op for op instead of
//   depending on where the compiler contracts into FMAs.
// Templated on the parameter dtype and the gradient dtype (f32, bf16, f16).

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int VEC = 8;

struct Hyper {
  float lr, b1, omb1, b2, omb2, c1, c2, eps, wd;  // omb = 1 - b, on the host
};

// the step's scalars in device memory (f32 each)
enum { S_LR, S_C1, S_C2, S_SKIP, N_SCALARS };

// one row of the tensor table (int64 each)
struct Entry {
  long long p, g, m, v, numel, chunk0;
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f(__half x) { return __half2float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}
template <> __device__ __forceinline__ __half from_f<__half>(float x) {
  return __float2half_rn(x);
}

// 8 consecutive elements through 16-byte accesses (ptr 16-byte aligned)
template <typename T>
__device__ __forceinline__ void load8(const T* ptr, float out[VEC]) {
  constexpr int PER = 16 / sizeof(T);  // elements per 16 bytes
#pragma unroll
  for (int w = 0; w < VEC / PER; ++w) {
    const uint4 raw = reinterpret_cast<const uint4*>(ptr)[w];
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int i = 0; i < PER; ++i) out[w * PER + i] = to_f(e[i]);
  }
}

template <typename T>
__device__ __forceinline__ void store8(T* ptr, const float in[VEC]) {
  constexpr int PER = 16 / sizeof(T);
#pragma unroll
  for (int w = 0; w < VEC / PER; ++w) {
    uint4 raw;
    T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
    for (int i = 0; i < PER; ++i) e[i] = from_f<T>(in[w * PER + i]);
    reinterpret_cast<uint4*>(ptr)[w] = raw;
  }
}

// the update of one element, each operation rounded on its own
__device__ __forceinline__ void adamw(float& p, float g, float& m, float& v,
                                      const Hyper& hp) {
  m = __fadd_rn(__fmul_rn(hp.b1, m), __fmul_rn(hp.omb1, g));
  v = __fadd_rn(__fmul_rn(hp.b2, v), __fmul_rn(__fmul_rn(hp.omb2, g), g));
  const float update = __fdiv_rn(__fdiv_rn(m, hp.c1),
                                 __fadd_rn(__fsqrt_rn(__fdiv_rn(v, hp.c2)), hp.eps));
  p = __fsub_rn(p, __fmul_rn(hp.lr, __fadd_rn(update, __fmul_rn(hp.wd, p))));
}

template <typename P, typename G>
__global__ void __launch_bounds__(THREADS)
    adamw_kernel(const Entry* table, int n_tensors, long long chunk, Hyper hp,
                 const float* scalars) {
  if (scalars[S_SKIP] != 0.f) return;  // a skipped step leaves p, m, v alone
  hp.lr = scalars[S_LR];
  hp.c1 = scalars[S_C1];
  hp.c2 = scalars[S_C2];
  const long long c = blockIdx.x;
  // the tensor this chunk belongs to: the last row with chunk0 <= c
  int lo = 0, hi = n_tensors - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (table[mid].chunk0 <= c) lo = mid; else hi = mid - 1;
  }
  const Entry e = table[lo];
  P* p = reinterpret_cast<P*>(e.p);
  const G* g = reinterpret_cast<const G*>(e.g);
  float* m = reinterpret_cast<float*>(e.m);
  float* v = reinterpret_cast<float*>(e.v);
  const long long begin = (c - e.chunk0) * chunk;
  const long long end = min(begin + chunk, e.numel);

  long long vec_end = begin;  // [begin, vec_end) goes 8 elements at a time
  if (((e.p | e.g | e.m | e.v) & 15) == 0) {
    vec_end = begin + (end - begin) / VEC * VEC;  // chunk is a multiple of VEC
    for (long long i = begin + static_cast<long long>(threadIdx.x) * VEC;
         i < vec_end; i += static_cast<long long>(THREADS) * VEC) {
      float pf[VEC], gf[VEC], mf[VEC], vf[VEC];
      load8(p + i, pf);
      load8(g + i, gf);
      load8(m + i, mf);
      load8(v + i, vf);
#pragma unroll
      for (int k = 0; k < VEC; ++k) adamw(pf[k], gf[k], mf[k], vf[k], hp);
      store8(p + i, pf);
      store8(m + i, mf);
      store8(v + i, vf);
    }
  }
  for (long long i = vec_end + threadIdx.x; i < end; i += THREADS) {
    float pf = to_f(p[i]), mf = m[i], vf = v[i];
    adamw(pf, to_f(g[i]), mf, vf, hp);
    p[i] = from_f<P>(pf);
    m[i] = mf;
    v[i] = vf;
  }
}

template <typename P>
cudaError_t dispatch_g(int g_dtype, const Entry* table, int n, long long chunks,
                       long long chunk, const Hyper& hp, const float* sc,
                       cudaStream_t s) {
  const dim3 grid(static_cast<unsigned>(chunks));
  switch (g_dtype) {
    case 0: adamw_kernel<P, float><<<grid, THREADS, 0, s>>>(table, n, chunk, hp, sc); break;
    case 1: adamw_kernel<P, __nv_bfloat16><<<grid, THREADS, 0, s>>>(table, n, chunk, hp, sc); break;
    case 2: adamw_kernel<P, __half><<<grid, THREADS, 0, s>>>(table, n, chunk, hp, sc); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

// table: device array of n_tensors rows (p, g, m, v, numel, first chunk) of
// int64, rows in chunk order; total_chunks = chunks of all rows; chunk = the
// elements per chunk (a multiple of 8). dtypes: 0 = float32, 1 = bfloat16,
// 2 = float16. scalars: device f32 [lr, c1, c2, skip], read when the kernel
// runs; a nonzero skip leaves every tensor unchanged. Returns a cudaError_t.
extern "C" int ds_fused_adamw(const void* table, int n_tensors,
                              long long total_chunks, long long chunk,
                              int p_dtype, int g_dtype, const void* scalars,
                              float b1, float omb1, float b2, float omb2,
                              float eps, float wd, void* stream) {
  if (n_tensors <= 0 || total_chunks <= 0 || total_chunks >= (1LL << 31) ||
      chunk <= 0 || chunk % VEC || scalars == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // lr, c1 and c2 come from `scalars` in the kernel
  const Hyper hp{0.f, b1, omb1, b2, omb2, 0.f, 0.f, eps, wd};
  const Entry* t = static_cast<const Entry*>(table);
  const float* sc = static_cast<const float*>(scalars);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (p_dtype) {
    case 0: err = dispatch_g<float>(g_dtype, t, n_tensors, total_chunks, chunk, hp, sc, s); break;
    case 1: err = dispatch_g<__nv_bfloat16>(g_dtype, t, n_tensors, total_chunks, chunk, hp, sc, s); break;
    case 2: err = dispatch_g<__half>(g_dtype, t, n_tensors, total_chunks, chunk, hp, sc, s); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
