// Row gather of a (L, d) matrix, in three modes:
//   gather_rows:   out[m] = W[idx[m]]                        (any element type)
//   gather_decode: y[n]   = sum_j vals[n, j] * W[idx[n, j]]  (fp32 or bf16 W)
//   splice_decode: an attribution chunk's F corrupted SAE splices, read from
//                  one top-(k+1) pool per token (below)
//
// Replaces the Pallas TPU kernel multimodal_sae_tpu/ops/pallas_gather.py::
// pallas_gather_rows (body _gather_kernel), whose contract is the first mode.
// The gather serves the SAE decode (multimodal_sae_tpu/ops/sparse_decode.py::
// gather_decode: rows of W_dec weighted by the top-k activations and summed),
// so the second mode fuses the weighted sum into the gather and never writes
// the (N, k, d) rows out.  The TPU kernel's limits (d a multiple of 2048, M a
// multiple of 8) come from its tiling and are not kept: any L and M, and d a
// multiple of the 16-byte vector (4 fp32, 8 bf16).  An index outside [0, L)
// reads nothing: its row is written as zeros (copy mode) or adds nothing
// (decode modes).
//
// Bound on an H100: bytes.  Copy mode moves M rows in and out; decode mode
// must read each distinct row of W that idx names once, plus idx, vals and y,
// over 3.35 TB/s.  Without reuse it reads N * k rows (10.2 GB for 2432 tokens
// at k = 256, d = 4096 fp32); the L2 cache (50 MB) is what separates the two.
// Design, kept simple: 16-byte vector loads and stores, neighbouring threads
// on neighbouring addresses of one row.  Copy mode walks the (M, d / vec)
// vectors grid-stride.  Decode mode runs one block of 256 threads per token
// (and per 1,024 vectors of d), stages the token's idx and vals in shared
// memory 256 at a time, and accumulates in fp32 registers in the fixed order
// j = 0 .. k-1, so the result is deterministic: equal inputs give equal bits.
//
// splice_decode.  Token n has a pool of kw latents (pool_idx, pool_vals)[n],
// its top-(k+1) in descending order (kw = k when k is the SAE's width), and
// drop[f, n] is the pool position of chunk feature f (kw where it is absent).
// Feature f's list is the pool without position drop[f, n], cut to its first
// k entries, closed by a zero slot (0, pool_idx[n, kw - 1]) when kw == k and
// f was in the pool.  Row f * N + n of the output is
//     O(T(T(sum over the list of vals * W[idx]) + b))
// with the sum in fp32 from 0 in list order, T the type of W and O that of
// clean: gather_decode of the list, + b in T, then a cast, bit for bit.
// Where drop[f, n] >= k the list is the pool's first k entries, the clean
// top-k, and the row equals clean[n], which the caller decoded with
// gather_decode: the kernel copies it.  A drop outside [0, kw] breaks the
// contract and its row is undefined (the wrapper refuses one only on the CPU,
// where the check costs no wait for the card).
// Bound on an H100: the larger of the bytes (the output, clean, drop, the
// pool of each token with a hit, and each distinct row of W that such a
// token names, over 3.35 TB/s) and the FMAs (hits * k * d in fp32 over
// 33.5 T FMA/s, the CUDA cores' 67 TFLOP/s: TF32 would break the bits).
// Design: one block of
// 128 threads per token and per 2 KB slice of a row (16 bytes a thread).
// Warp 0 reads the token's F drop positions and lists its hits (drop < k) in
// order with a ballot.  Every other feature is a copy: each thread loads its
// piece of clean[n] once and stores it to those rows.  The hit features share
// one pass over the pool, at most 8 at a time: pool row j's slice is read
// once and added into each hit feature's fp32 accumulators but the one that
// dropped j, so each keeps its own list order and bits.  Rows are read with
// 16-byte loads through the read-only path, four pool rows unrolled, so
// several rows are in flight while the FMAs run; a per-thread cp.async ring
// (cp.async.cg skips L1, and each thread waits for its own oldest copy) ran
// at half the rate.  The bias, the roundings and the cast run in the
// epilogue, so the output is written once in O.  No atomics: equal inputs
// give equal bits.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int THREADS = 256;
constexpr int VPT = 4;       // decode mode: 16-byte vectors per thread
constexpr int KCHUNK = 256;  // decode mode: (idx, vals) staged per round

__global__ void __launch_bounds__(THREADS)
    gather_rows_kernel(const uint4* __restrict__ w, const int* __restrict__ idx,
                       uint4* __restrict__ out, long long L, int vecs, long long total) {
  for (long long e = (long long)blockIdx.x * THREADS + threadIdx.x; e < total;
       e += (long long)gridDim.x * THREADS) {
    const long long m = e / vecs;
    const int c = (int)(e - m * vecs);
    const int row = idx[m];
    uint4 v = make_uint4(0, 0, 0, 0);
    if (row >= 0 && row < L) v = w[(long long)row * vecs + c];
    out[e] = v;
  }
}

template <typename T>
struct Vec;

template <>
struct Vec<float> {
  static constexpr int N = 4;
  __device__ static void add(float* acc, float s, const uint4& u) {
    const float* f = reinterpret_cast<const float*>(&u);
#pragma unroll
    for (int i = 0; i < N; ++i) acc[i] = fmaf(s, f[i], acc[i]);
  }
  __device__ static float load(const float* p) { return *p; }
  __device__ static uint4 pack(const float* acc) {
    uint4 u;
    float* f = reinterpret_cast<float*>(&u);
#pragma unroll
    for (int i = 0; i < N; ++i) f[i] = acc[i];
    return u;
  }
};

template <>
struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ static void add(float* acc, float s, const uint4& u) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < N / 2; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      acc[2 * i] = fmaf(s, f.x, acc[2 * i]);
      acc[2 * i + 1] = fmaf(s, f.y, acc[2 * i + 1]);
    }
  }
  __device__ static float load(const __nv_bfloat16* p) { return __bfloat162float(*p); }
  __device__ static uint4 pack(const float* acc) {
    uint4 u;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < N / 2; ++i) h[i] = __floats2bfloat162_rn(acc[2 * i], acc[2 * i + 1]);
    return u;
  }
};

template <typename T>
__global__ void __launch_bounds__(THREADS)
    gather_decode_kernel(const uint4* __restrict__ w, const int* __restrict__ idx,
                         const T* __restrict__ vals, uint4* __restrict__ y, long long L,
                         int vecs, int k) {
  constexpr int E = Vec<T>::N;
  __shared__ int idx_s[KCHUNK];
  __shared__ float val_s[KCHUNK];
  const long long n = blockIdx.x;
  const int c0 = blockIdx.y * THREADS * VPT + threadIdx.x;
  float acc[VPT][E];
#pragma unroll
  for (int u = 0; u < VPT; ++u) {
#pragma unroll
    for (int i = 0; i < E; ++i) acc[u][i] = 0.f;
  }
  for (int j0 = 0; j0 < k; j0 += KCHUNK) {
    const int nj = min(KCHUNK, k - j0);
    __syncthreads();  // the previous round's reads are done
    for (int j = threadIdx.x; j < nj; j += THREADS) {
      idx_s[j] = idx[n * k + j0 + j];
      val_s[j] = Vec<T>::load(vals + n * k + j0 + j);
    }
    __syncthreads();
#pragma unroll 4
    for (int j = 0; j < nj; ++j) {
      const int row = idx_s[j];
      if (row < 0 || row >= L) continue;
      const float s = val_s[j];
      const uint4* wr = w + (long long)row * vecs;
#pragma unroll
      for (int u = 0; u < VPT; ++u) {
        const int c = c0 + u * THREADS;
        if (c < vecs) Vec<T>::add(acc[u], s, wr[c]);
      }
    }
  }
#pragma unroll
  for (int u = 0; u < VPT; ++u) {
    const int c = c0 + u * THREADS;
    if (c < vecs) y[n * vecs + c] = Vec<T>::pack(acc[u]);
  }
}

// splice_decode: one block per (token, SPLICE_THREADS-vector slice of a row).
constexpr int SPLICE_THREADS = 128;
constexpr int SPLICE_GROUP = 8;  // hit features summed in one pass

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T narrow(float x);
template <>
__device__ __forceinline__ float narrow<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 narrow<__nv_bfloat16>(float x) { return __float2bfloat16_rn(x); }

// E elements of O, loaded and stored as 8-byte or 16-byte vectors.
template <typename O, int E>
struct Chunk {
  static constexpr int BYTES = E * (int)sizeof(O);
  using V = typename std::conditional<(BYTES >= 16), uint4, uint2>::type;
  static constexpr int NV = BYTES >= 16 ? BYTES / 16 : 1;
  V v[NV];
  __device__ O* elems() { return reinterpret_cast<O*>(v); }
  __device__ void load(const O* p) {
#pragma unroll
    for (int i = 0; i < NV; ++i) v[i] = reinterpret_cast<const V*>(p)[i];
  }
  __device__ void store(O* p) const {
#pragma unroll
    for (int i = 0; i < NV; ++i) reinterpret_cast<V*>(p)[i] = v[i];
  }
};

template <typename T, typename O>
struct SpliceArgs {
  const uint4* w;        // (L, d) of T
  const int* pool_idx;   // (N, kw)
  const T* pool_vals;    // (N, kw)
  const int* drop;       // (F, N)
  const T* b;            // (d,)
  const O* clean;        // (N, d)
  O* out;                // (F * N, d)
  long long L;
  int vecs;  // 16-byte vectors of T in a row
  int N, F, k, kw;
};

// One pass over token n's pool for the NG hit features (f_s[g], dropped
// position p_s[g]), g < nact <= NG, at the thread's vector c of each row.
template <typename T, typename O, int NG>
__device__ __forceinline__ void splice_pass(const SpliceArgs<T, O> a, int n, int c, const int* idx_s,
                                            const float* val_s, const int* f_s, const int* p_s, int nact,
                                            const uint4 bias) {
  constexpr int E = Vec<T>::N;
  int p[NG];
  bool act[NG];
  float acc[NG][E];
#pragma unroll
  for (int g = 0; g < NG; ++g) {
    act[g] = g < nact;
    p[g] = act[g] ? p_s[g] : -1;
#pragma unroll
    for (int i = 0; i < E; ++i) acc[g][i] = 0.f;
  }
  const bool zero_slot = a.kw == a.k;
#pragma unroll 4
  for (int j = 0; j < a.kw; ++j) {
    const int row = idx_s[j];
    const bool ok = row >= 0 && row < a.L;  // a row outside W adds nothing
    const float s = val_s[j];
    const uint4 v = ok ? __ldg(a.w + (long long)row * a.vecs + c) : make_uint4(0, 0, 0, 0);
#pragma unroll
    for (int g = 0; g < NG; ++g)
      if (ok && act[g] && j != p[g]) Vec<T>::add(acc[g], s, v);
    if (ok && zero_slot && j == a.kw - 1) {
#pragma unroll
      for (int g = 0; g < NG; ++g)
        if (act[g]) Vec<T>::add(acc[g], 0.f, v);
    }
  }
  const T* bt = reinterpret_cast<const T*>(&bias);
  const long long d = (long long)a.vecs * E;
#pragma unroll
  for (int g = 0; g < NG; ++g) {
    if (!act[g]) continue;
    Chunk<O, E> out;
#pragma unroll
    for (int i = 0; i < E; ++i) {
      const T y = narrow<T>(acc[g][i]);                            // gather_decode's output
      const T yb = narrow<T>(__fadd_rn(widen(y), widen(bt[i])));   // + b in T
      out.elems()[i] = narrow<O>(widen(yb));                        // .to(clean's dtype)
    }
    out.store(a.out + ((long long)f_s[g] * a.N + n) * d + (long long)c * E);
  }
}

template <typename T, typename O>
__global__ void __launch_bounds__(SPLICE_THREADS) splice_decode_kernel(const SpliceArgs<T, O> a) {
  constexpr int E = Vec<T>::N;
  extern __shared__ int smem[];
  int* idx_s = smem;
  float* val_s = reinterpret_cast<float*>(idx_s + a.kw);
  int* drop_s = reinterpret_cast<int*>(val_s + a.kw);
  int* f_s = drop_s + a.F;
  int* p_s = f_s + a.F;
  __shared__ int nhit_s;
  const int n = blockIdx.x;
  const int tid = threadIdx.x;
  const int c = blockIdx.y * SPLICE_THREADS + tid;

  if (tid < 32) {  // the token's drop positions, and its hits in feature order
    int count = 0;
    for (int f0 = 0; f0 < a.F; f0 += 32) {
      const int f = f0 + tid;
      const int p = f < a.F ? a.drop[(long long)f * a.N + n] : a.k;
      if (f < a.F) drop_s[f] = p;
      const bool hit = p >= 0 && p < a.k;
      const unsigned hits = __ballot_sync(0xffffffffu, hit);
      if (hit) {
        const int at = count + __popc(hits & ((1u << tid) - 1u));
        f_s[at] = f;
        p_s[at] = p;
      }
      count += __popc(hits);
    }
    if (tid == 0) nhit_s = count;
  }
  __syncthreads();
  const int nhit = nhit_s;
  if (nhit > 0) {  // block-uniform
    for (int j = tid; j < a.kw; j += SPLICE_THREADS) {
      idx_s[j] = a.pool_idx[(long long)n * a.kw + j];
      val_s[j] = Vec<T>::load(a.pool_vals + (long long)n * a.kw + j);
    }
    __syncthreads();
  }
  if (c >= a.vecs) return;
  const long long d = (long long)a.vecs * E;
  if (nhit < a.F) {  // the copies
    Chunk<O, E> piece;
    piece.load(a.clean + n * d + (long long)c * E);
    for (int f = 0; f < a.F; ++f)
      if (drop_s[f] >= a.k || drop_s[f] < 0) piece.store(a.out + ((long long)f * a.N + n) * d + (long long)c * E);
  }
  if (nhit == 0) return;
  const uint4 bias = reinterpret_cast<const uint4*>(a.b)[c];
  for (int g0 = 0; g0 < nhit; g0 += SPLICE_GROUP) {
    const int nact = min(SPLICE_GROUP, nhit - g0);
    if (nact == 1)
      splice_pass<T, O, 1>(a, n, c, idx_s, val_s, f_s + g0, p_s + g0, nact, bias);
    else if (nact == 2)
      splice_pass<T, O, 2>(a, n, c, idx_s, val_s, f_s + g0, p_s + g0, nact, bias);
    else if (nact <= 4)
      splice_pass<T, O, 4>(a, n, c, idx_s, val_s, f_s + g0, p_s + g0, nact, bias);
    else
      splice_pass<T, O, SPLICE_GROUP>(a, n, c, idx_s, val_s, f_s + g0, p_s + g0, nact, bias);
  }
}

template <typename T, typename O>
int launch_splice(const void* w, const void* pool_idx, const void* pool_vals, const void* drop, const void* b,
                  const void* clean, void* out, long long L, int N, int F, int vecs, int k, int kw,
                  cudaStream_t st) {
  const SpliceArgs<T, O> a{reinterpret_cast<const uint4*>(w), reinterpret_cast<const int*>(pool_idx),
                           reinterpret_cast<const T*>(pool_vals), reinterpret_cast<const int*>(drop),
                           reinterpret_cast<const T*>(b), reinterpret_cast<const O*>(clean),
                           reinterpret_cast<O*>(out), L, vecs, N, F, k, kw};
  const size_t smem = (size_t)kw * 8 + (size_t)F * 12;
  if (smem > 227 * 1024) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(splice_decode_kernel<T, O>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((unsigned)N, (vecs + SPLICE_THREADS - 1) / SPLICE_THREADS);
  splice_decode_kernel<T, O><<<grid, SPLICE_THREADS, smem, st>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// w: (L, row_bytes / elem) contiguous, row_bytes a multiple of 16; idx: (M,)
// int32; out: (M, row_bytes / elem) of w's type.  Returns a CUDA error code.
int gather_rows(const void* w, const void* idx, void* out, long long L, long long M,
                int row_bytes, void* stream) {
  if (row_bytes % 16) return (int)cudaErrorInvalidValue;
  const int vecs = row_bytes / 16;
  const long long total = M * vecs;
  if (total == 0) return 0;
  const long long want = (total + THREADS - 1) / THREADS;
  const int blocks = (int)(want < 132LL * 64 ? want : 132LL * 64);
  gather_rows_kernel<<<blocks, THREADS, 0, reinterpret_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const uint4*>(w), reinterpret_cast<const int*>(idx),
      reinterpret_cast<uint4*>(out), L, vecs, total);
  return (int)cudaGetLastError();
}

// w: (L, d) fp32 (bf16 = 0) or bf16 (bf16 = 1), d a multiple of 16 bytes;
// idx: (N, k) int32; vals: (N, k) of w's type; y: (N, d) of w's type.
// Returns a CUDA error code.
int gather_decode(const void* w, const void* idx, const void* vals, void* y, long long L,
                  long long N, int d, int k, int bf16, void* stream) {
  const int elem = bf16 ? 2 : 4;
  if ((d * elem) % 16 || N > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const int vecs = d * elem / 16;
  if (N == 0 || vecs == 0) return 0;
  dim3 grid((unsigned)N, (vecs + THREADS * VPT - 1) / (THREADS * VPT));
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (bf16) {
    gather_decode_kernel<__nv_bfloat16><<<grid, THREADS, 0, st>>>(
        reinterpret_cast<const uint4*>(w), reinterpret_cast<const int*>(idx),
        reinterpret_cast<const __nv_bfloat16*>(vals), reinterpret_cast<uint4*>(y), L, vecs, k);
  } else {
    gather_decode_kernel<float><<<grid, THREADS, 0, st>>>(
        reinterpret_cast<const uint4*>(w), reinterpret_cast<const int*>(idx),
        reinterpret_cast<const float*>(vals), reinterpret_cast<uint4*>(y), L, vecs, k);
  }
  return (int)cudaGetLastError();
}

// The attribution chunk's splices.  w: (L, d) fp32 (w_bf16 = 0) or bf16
// (w_bf16 = 1), d a multiple of 16 bytes; pool_idx: (N, kw) int32; pool_vals:
// (N, kw) and b: (d,) of w's type; drop: (F, N) int32 in [0, kw]; clean: (N,
// d) and out: (F * N, d), fp32 (out_bf16 = 0) or bf16 (out_bf16 = 1); k <=
// kw <= k + 1.  Returns a CUDA error code.
int splice_decode(const void* w, const void* pool_idx, const void* pool_vals, const void* drop, const void* b,
                  const void* clean, void* out, long long L, long long N, int F, int d, int k, int kw,
                  int w_bf16, int out_bf16, void* stream) {
  const int elem = w_bf16 ? 2 : 4;
  if ((d * elem) % 16 || N > 0x7fffffffLL || k < 1 || kw < k || kw > k + 1) return (int)cudaErrorInvalidValue;
  const int vecs = d * elem / 16;
  if (N == 0 || F == 0 || vecs == 0) return 0;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (w_bf16 && out_bf16)
    return launch_splice<__nv_bfloat16, __nv_bfloat16>(w, pool_idx, pool_vals, drop, b, clean, out, L, (int)N, F,
                                                       vecs, k, kw, st);
  if (w_bf16)
    return launch_splice<__nv_bfloat16, float>(w, pool_idx, pool_vals, drop, b, clean, out, L, (int)N, F, vecs,
                                               k, kw, st);
  if (out_bf16)
    return launch_splice<float, __nv_bfloat16>(w, pool_idx, pool_vals, drop, b, clean, out, L, (int)N, F, vecs,
                                               k, kw, st);
  return launch_splice<float, float>(w, pool_idx, pool_vals, drop, b, clean, out, L, (int)N, F, vecs, k, kw, st);
}

}  // extern "C"
