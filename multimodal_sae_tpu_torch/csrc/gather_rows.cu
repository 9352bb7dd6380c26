// Row gather of a (L, d) matrix, in two modes:
//   gather_rows:   out[m] = W[idx[m]]                        (any element type)
//   gather_decode: y[n]   = sum_j vals[n, j] * W[idx[n, j]]  (fp32 or bf16 W)
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
// (decode mode).
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

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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

}  // extern "C"
