// Block max: (N, W) -> (N, W / block), the max of each contiguous
// `block`-wide slice of each row.  Bit-exact; NaN propagates.
//
// Replaces multimodal_sae_tpu/ops/pallas_topk.py::pallas_block_max (Pallas,
// TPU).  That kernel only takes block 128; this one takes block 8, 16, 32,
// 64 or 128 (dividing W), because the exact wide top-k reduces at block 64
// over (N, 131072) and at block 8 over the (N, 16384) level-1 candidates
// (ops/topk.py).
//
// Bound on an H100: memory.  The kernel reads N*W elements once and writes
// N*W/block, so it cannot beat (N*W + N*W/block) * itemsize / 3.35 TB/s:
// about 2.6 ms for (16384, 131072) fp32 at block 64 (8.6 GB read).
// Design: W % block == 0 makes the input a flat (M, block) array with
// M = N*W/block, so no block crosses a row.  Each output is reduced by a
// group of T lanes (T = min(block / vec, 32), a power of two dividing 32):
// every lane reads 16-byte vectors, neighbouring lanes neighbouring vectors
// (fully coalesced), reduces them in registers, and the group finishes with
// xor shuffles.  Lane 0 of the group writes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// max that propagates NaN (a bare fmaxf drops it).
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a != a || a > b) ? a : b;
}

template <typename VecLoad>
__global__ void block_max_kernel(const uint4* __restrict__ x,
                                 void* __restrict__ out, long long n_out,
                                 int vecs_per_block, int lanes) {
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long g = tid / lanes;  // output index
  const int lane = (int)(tid % lanes);
  float m = -INFINITY;
  if (g < n_out) {
    const uint4* row = x + g * vecs_per_block;
    for (int v = lane; v < vecs_per_block; v += lanes) {
      m = nan_max(m, VecLoad::reduce(__ldg(row + v)));
    }
  }
  // Every lane of the warp takes part in the shuffles, in range or not.
  for (int o = lanes >> 1; o > 0; o >>= 1) {
    m = nan_max(m, __shfl_xor_sync(0xffffffffu, m, o));
  }
  if (g < n_out && lane == 0) {
    VecLoad::store(out, g, m);
  }
}

struct F32x4 {
  __device__ __forceinline__ static void store(void* out, long long i, float m) {
    reinterpret_cast<float*>(out)[i] = m;
  }
  __device__ __forceinline__ static float reduce(uint4 u) {
    return nan_max(nan_max(__uint_as_float(u.x), __uint_as_float(u.y)),
                   nan_max(__uint_as_float(u.z), __uint_as_float(u.w)));
  }
};

struct Bf16x8 {
  // m is a bf16 value widened exactly, so narrowing it is exact.
  __device__ __forceinline__ static void store(void* out, long long i, float m) {
    reinterpret_cast<__nv_bfloat16*>(out)[i] = __float2bfloat16(m);
  }
  __device__ __forceinline__ static float lo(unsigned w) {
    return __uint_as_float(w << 16);
  }
  __device__ __forceinline__ static float hi(unsigned w) {
    return __uint_as_float(w & 0xffff0000u);
  }
  __device__ __forceinline__ static float reduce(uint4 u) {
    float a = nan_max(nan_max(lo(u.x), hi(u.x)), nan_max(lo(u.y), hi(u.y)));
    float b = nan_max(nan_max(lo(u.z), hi(u.z)), nan_max(lo(u.w), hi(u.w)));
    return nan_max(a, b);
  }
};

int launch(const void* x, void* out, long long n_out, int block, int itemsize,
           void* stream) {
  const int per_vec = 16 / itemsize;  // elements in one 16-byte vector
  const int vecs = block / per_vec;
  const int lanes = vecs < 32 ? vecs : 32;
  const int threads = 256;
  const long long total = n_out * lanes;
  const long long grid = (total + threads - 1) / threads;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (itemsize == 4) {
    block_max_kernel<F32x4><<<(unsigned)grid, threads, 0, s>>>(
        reinterpret_cast<const uint4*>(x), out, n_out, vecs, lanes);
  } else {
    block_max_kernel<Bf16x8><<<(unsigned)grid, threads, 0, s>>>(
        reinterpret_cast<const uint4*>(x), out, n_out, vecs, lanes);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// x: (n_out * block) contiguous f32, 16-byte aligned; out: (n_out,) f32.
// block: 8, 16, 32, 64 or 128.  Returns cudaGetLastError().
int block_max_f32(const void* x, void* out, long long n_out, int block,
                  void* stream) {
  return launch(x, out, n_out, block, 4, stream);
}

// Same for bf16 input and output.
int block_max_bf16(const void* x, void* out, long long n_out, int block,
                   void* stream) {
  return launch(x, out, n_out, block, 2, stream);
}

}  // extern "C"
