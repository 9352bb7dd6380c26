// SAE encoder pre-activations, relu((x - b_dec) @ W_enc + b_enc), in fp32
// on the tensor cores: a product over a three-way bf16 split of both
// operands that keeps fp32's precision, with bias and ReLU in its epilogue.
//
// Replaces no TPU kernel (no Pallas kernel computes it): the JAX package
// leaves this product to XLA at Precision.HIGHEST
// (multimodal_sae_tpu/sae/model.py::pre_acts).  Added because the port's
// fp32 product ran on the CUDA cores (cuBLAS's SIMT sgemm, near its 67
// TFLOP/s peak) and was the largest single cost of a cache batch, while the
// tensor cores, which take no fp32 operand short of TF32's 10-bit mantissa,
// sat idle.
//
// The split.  Each fp32 value a becomes three bf16 values a0 + a1 + a2 == a
// exactly (csrc below, `split3`): a0 = bf16(a), a1 = bf16(a - a0), a2 =
// a - a0 - a1, each difference exact in fp32, for |a| >= 2^-110 (below
// that the last bits fall under bf16's subnormals: an absolute error under
// 2^-133 a value).  |a1| <= 2^-8 |a|, |a2| <= 2^-16 |a|.  Each bf16 product
// is exact in fp32.  Six products, a0b0 + (a0b1 + a1b0 + a0b2 + a1b1 +
// a2b0), give every term to within 2^-24 of |ab| (the three dropped,
// a1b2, a2b1, a2b2, are at most 2^-24, 2^-24 and 2^-32 of it).  Every
// product runs all six terms: nothing depends on the values.
//
// Summation.  A tensor core sums a product into its accumulator with the
// addends aligned and truncated, not rounded (Ootomo & Yokota, IJHPCA
// 2022): small terms added to a large running sum lose their low bits, and
// the loss is one-sided.  So a0b0 goes into a main accumulator and the five
// correction terms into a second one, both started afresh every FLUSH
// K-slices of 32 and then added, correction first, into an fp32 register
// sum with round-to-nearest adds.  The truncation then acts only on
// window sums, never on the running total.  FLUSH is 4 (a window of 128 of
// K): measured on an H100 at the text batch, 4 ran as fast as 8 (657, 660
// ms) and faster than 1 or 2 (853, 790: the flush's adds cost power), with
// its max and mean error against float64 a quarter and a third of the fp32
// sgemm's (PERF.md).
//
// Bound on an H100: tensor-core operations, six bf16 products of 2*M*K*L
// FLOPs over 989 TFLOP/s: at the text cache's (65,536 x 4,096) x (4,096 x
// 131,072), 422 TFLOP, 0.43 s.  The output is written once at 3.35 TB/s
// (34 GB, 10 ms), the split planes read many times from L2.  Measured, the
// kernel runs at the card's 700 W power limit with its clock near 1.3 GHz.
//
// Design (Hopper: wgmma fed by a cp.async ring, building blocks in sm90.cuh;
// warp-specialised, persistent).  A block of three warpgroups owns one SM
// and walks output tiles of 128 rows x 128 latents, grouped 16 row tiles
// at a time so that concurrent blocks share their operands in L2.  The
// producer warpgroup (setmaxnreg down to 56) copies a stage per K-slice of
// 32: the three planes of the 128 x 32 A tile (x - b_dec, K-major, rows of
// 64 bytes in wgmma's 64-byte swizzle) and of the 32 x 128 B tile (W_enc as
// stored, read MN-major through sm90.cuh's 128-byte swizzle), 48 KB a
// stage; four stages fill 192 KB of shared memory, and the producer keeps
// three in flight, handing each over when it lands.  The tiles are sized
// by two budgets: 128 FLOP a byte of planes, so at the tensor cores' peak
// the L2 has to deliver 7.7 TB/s (a ring of two 64-deep stages was
// load-bound: loads alone took 0.67 s of its 0.97 s), and three register
// sets a consumer thread.  Each consumer warpgroup (setmaxnreg up to 224)
// owns 64 rows of the tile and holds three register sets of 64 x 128 fp32
// (main, correction, sum: 192 registers a thread); per K-slice it issues
// the 12 m64n128k16 products (six terms, two k-steps) with A and B from
// shared memory, waits, hands the stage back, and every FLUSH slices adds
// both accumulators into the sum.  The two consumers take each stage
// through barriers of their own, so one's flush and epilogue run under the
// other's products, and the producer loads the next tile's first stages
// under both epilogues.  The epilogue adds b_enc, applies ReLU and stores
// the fp32 (M, L) pre-activations with streaming stores; rows past M are
// zero-filled on load and never stored.  Any M; K a multiple of 32, L of
// 128.  No atomics: the output is deterministic.
//
// The split pass (`split3_*`): x (fp32 or bf16) less an optional fp32 row
// vector into three bf16 planes, 8 values a thread, for the A operand of
// every call and, once per weight, the B operand.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90.cuh"

namespace {

using namespace sm90;

typedef __nv_bfloat16 bf16;

constexpr int WG = 128;               // threads a warpgroup
constexpr int PRODUCER_REGS = 56;     // registers a thread after setmaxnreg
constexpr int CONSUMER_REGS = 224;
constexpr int BM = 128;               // rows a tile: two consumers of 64
constexpr int BN = 128;               // latents a tile (wgmma N)
constexpr int BK = 32;                // contraction a stage: A rows of 64 bytes
constexpr int STAGES = 4;             // ring depth
constexpr int LAG = STAGES - 2;       // stages the producer keeps in flight behind the one it hands over
constexpr int GROUP_M = 16;           // row tiles a raster group
constexpr int FLUSH = 4;              // K-slices a window (see the head)
constexpr int PLANE_A = BM * BK * 2;  // bytes of one plane's A tile
constexpr int PLANE_B = BK * BN * 2;  // bytes of one plane's B tile
constexpr int STAGE_BYTES = 3 * PLANE_A + 3 * PLANE_B;
constexpr int SMEM_BYTES = 1024 + STAGES * STAGE_BYTES;

// Named barriers (0 is __syncthreads'): full(s, w) hands stage s from the
// producer to consumer w (2 WG threads); empty(s) hands it back from both
// consumers to the producer (3 WG threads).
__device__ __forceinline__ int full_id(int s, int w) { return 1 + w * STAGES + s; }
__device__ __forceinline__ int empty_id(int s) { return 1 + 2 * STAGES + s; }
__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// The A tile, (BM, BK) K-major, takes wgmma's 64-byte swizzle: row r at
// r * 64 bytes, its 16-byte chunk c stored at position c ^ ((r / 2) % 4)
// (address bits [4, 6) from bits [7, 9)), so a tile starts on a 512-byte
// boundary.  Its descriptor: 8-row groups 512 bytes apart, k-step kk 32
// bytes into the row (the hardware swizzles the absolute address).  The B
// tile, (BK, BN) MN-major, is sm90.cuh's 128-byte-swizzled tile read
// through desc_mn_major.
__device__ __forceinline__ uint64_t desc_k_sw64(uint32_t tile, int kk) {
  const uint32_t addr = tile + kk * 32;
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (1ull << 16) | ((uint64_t)(512 >> 4) << 32) | (2ull << 62);
}

// Output tile t as (row tile, latent tile): GROUP_M row tiles at a time,
// the latent tile moving slowest inside a group.
__device__ __forceinline__ void tile_coords(int t, int n_m, int n_n, int& mt, int& nt) {
  const int per_group = GROUP_M * n_n;
  const int first_m = (t / per_group) * GROUP_M;
  const int gm = min(n_m - first_m, GROUP_M);
  const int in = t % per_group;
  mt = first_m + in % gm;
  nt = in / gm;
}

__device__ __forceinline__ float relu(float v) { return v < 0.f ? 0.f : v; }

// a: three (M, K) bf16 planes one after another; w: three (K, L) planes;
// bias: (L,) fp32; out: (M, L) fp32.
__global__ void __launch_bounds__(3 * WG, 1)
    sae_encode_kernel(const bf16* __restrict__ a, const bf16* __restrict__ w,
                      const float* __restrict__ bias, float* __restrict__ out, int M, int K, int L) {
  extern __shared__ unsigned char smem[];
  const uint32_t ring = (smem_u32(smem) + 1023) & ~1023u;
  const int n_m = (M + BM - 1) / BM, n_n = L / BN, nk = K / BK;
  const int n_tiles = n_m * n_n;
  const int my_tiles = (int)blockIdx.x < n_tiles ? (n_tiles - 1 - (int)blockIdx.x) / (int)gridDim.x + 1 : 0;
  const int total = my_tiles * nk;  // stages this block runs
  const int tid = threadIdx.x;

  if (tid >= 2 * WG) {
    // The producer: stage `it` into ring slot it % STAGES once both
    // consumers have released stage it - STAGES there; stage it - LAG
    // handed over once it has landed, so LAG + 1 stages are in flight.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    // This thread's 16-byte chunks: of each A plane, rows ar + 32 j (j <
    // 4), chunk ac; of each B plane, rows br + 8 j, chunk bc.
    const int ptid = tid - 2 * WG;
    const int ar = ptid / 4, ac = ptid % 4, br = ptid / 16, bc = ptid % 16;
    const uint32_t a_off = ar * 64 + ((ac ^ ((ar >> 1) & 3)) << 4);
    const uint32_t b_off = (bc / 8) * (BK * 128) + br * 128 + (((bc % 8) ^ (br % 8)) << 4);
    const size_t a_plane = (size_t)M * K, w_plane = (size_t)K * L, a_step = (size_t)32 * K, b_step = (size_t)8 * L;
    auto hand_over = [&](int j) {
      bar_arrive(full_id(j % STAGES, 0), 2 * WG);
      bar_arrive(full_id(j % STAGES, 1), 2 * WG);
    };
    int it = 0;
    for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
      int mt, nt;
      tile_coords(t, n_m, n_n, mt, nt);
      const int rows_left = M - mt * BM - ar;  // row ar + 32 j exists while 32 j < rows_left
      const bf16* ap = a + (size_t)(mt * BM + ar) * K + ac * 8;
      const bf16* wp = w + (size_t)br * L + nt * BN + bc * 8;
      for (int ks = 0; ks < nk; ++ks, ++it) {
        const uint32_t st = ring + (it % STAGES) * STAGE_BYTES;
        if (it >= STAGES) bar_sync(empty_id(it % STAGES), 3 * WG);
#pragma unroll 1
        for (int p = 0; p < 3; ++p) {
          const bf16* src_a = ap + p * a_plane + ks * BK;
          const bf16* src_b = wp + p * w_plane + (size_t)ks * BK * L;
          const uint32_t dst_a = st + p * PLANE_A + a_off, dst_b = st + 3 * PLANE_A + p * PLANE_B + b_off;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const bool ok = 32 * j < rows_left;
            cp_async16(dst_a + 2048 * j, ok ? src_a + j * a_step : a, ok);
          }
#pragma unroll
          for (int j = 0; j < 4; ++j) cp_async16(dst_b + 1024 * j, src_b + j * b_step, true);
        }
        cp_async_commit();
        if (it >= LAG) {
          cp_async_wait<LAG>();
          fence_proxy_async();
          hand_over(it - LAG);
        }
      }
    }
    cp_async_wait<0>();
    fence_proxy_async();
    for (int j = it > LAG ? it - LAG : 0; j < it; ++j) hand_over(j);
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));

  // Consumer wg: rows 64 wg .. 64 wg + 63 of each tile.
  const int wg = tid / WG, warp = (tid % WG) / 32, lane = tid % 32;
  float c0[BN / 2], c1[BN / 2], sum[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) c0[i] = c1[i] = 0.f;
  fence_regs(c0);
  fence_regs(c1);
  int it = 0;
  for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
    int mt, nt;
    tile_coords(t, n_m, n_n, mt, nt);
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) sum[i] = 0.f;
    for (int ks = 0; ks < nk; ++ks, ++it) {
      const int s = it % STAGES;
      const uint32_t st = ring + s * STAGE_BYTES;
      const uint32_t a0 = st + wg * (64 * BK * 2), a1 = a0 + PLANE_A, a2 = a1 + PLANE_A;
      const uint32_t b0 = st + 3 * PLANE_A, b1 = b0 + PLANE_B, b2 = b1 + PLANE_B;
      // 0 on a window's first slice: its first k-step overwrites both
      // accumulators.
      const int keep = ks % FLUSH != 0;
      bar_sync(full_id(s, wg), 2 * WG);  // stage `it` has landed
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        const uint64_t da0 = desc_k_sw64(a0, kk), da1 = desc_k_sw64(a1, kk), da2 = desc_k_sw64(a2, kk);
        const uint64_t db0 = desc_mn_major<BK>(b0, kk), db1 = desc_mn_major<BK>(b1, kk),
                       db2 = desc_mn_major<BK>(b2, kk);
        const int acc = kk > 0 || keep;
        wgmma_ss<BN, 1>(c0, da0, db0, acc);
        wgmma_ss<BN, 1>(c1, da0, db1, acc);
        wgmma_ss<BN, 1>(c1, da1, db0, 1);
        wgmma_ss<BN, 1>(c1, da0, db2, 1);
        wgmma_ss<BN, 1>(c1, da1, db1, 1);
        wgmma_ss<BN, 1>(c1, da2, db0, 1);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(c0);
      fence_regs(c1);
      // Done with the stage; the producer refills it with stage it + STAGES.
      if (it + STAGES < total) bar_arrive(empty_id(s), 3 * WG);
      if (ks % FLUSH == FLUSH - 1 || ks == nk - 1) {
#pragma unroll
        for (int i = 0; i < BN / 2; ++i) sum[i] += c0[i] + c1[i];
      }
    }

    // Epilogue: + b_enc, ReLU (NaN passes through, as torch's relu_), store.
    const int r0 = mt * BM + wg * 64 + acc_row(0, lane, warp), r1 = r0 + 8;
    const int n0 = nt * BN;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int col = n0 + 8 * j + 2 * (lane % 4);
      const float2 b = __ldg(reinterpret_cast<const float2*>(bias + col));
      if (r0 < M)
        __stcs(reinterpret_cast<float2*>(out + (size_t)r0 * L + col),
               make_float2(relu(sum[4 * j] + b.x), relu(sum[4 * j + 1] + b.y)));
      if (r1 < M)
        __stcs(reinterpret_cast<float2*>(out + (size_t)r1 * L + col),
               make_float2(relu(sum[4 * j + 2] + b.x), relu(sum[4 * j + 3] + b.y)));
    }
  }
}

int launch(const void* a, const void* w, const void* bias, void* out, int M, int K, int L, cudaStream_t stream) {
  cudaError_t err =
      cudaFuncSetAttribute(sae_encode_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  int dev = 0, sms = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const long long n_tiles = (long long)((M + BM - 1) / BM) * (L / BN);
  const int grid = (int)(n_tiles < sms ? n_tiles : sms);
  sae_encode_kernel<<<grid, 3 * WG, SMEM_BYTES, stream>>>(
      reinterpret_cast<const bf16*>(a), reinterpret_cast<const bf16*>(w), reinterpret_cast<const float*>(bias),
      reinterpret_cast<float*>(out), M, K, L);
  return (int)cudaGetLastError();
}

// a = a0 + a1 + a2 exactly (see the head): round to nearest, except where
// that would overflow to infinity (|a| within half a bf16 step of
// FLT_MAX), where a0 is a truncated to bf16 instead.
__device__ __forceinline__ void split3(float x, bf16& h0, bf16& h1, bf16& h2) {
  bf16 x0 = __float2bfloat16_rn(x);
  const bool overflow = (__bfloat16_as_ushort(x0) & 0x7FFFu) == 0x7F80u && (__float_as_uint(x) & 0x7F800000u) != 0x7F800000u;
  if (overflow) x0 = __ushort_as_bfloat16((unsigned short)(__float_as_uint(x) >> 16));
  const float r1 = x - __bfloat162float(x0);
  const bf16 x1 = __float2bfloat16_rn(r1);
  h0 = x0;
  h1 = x1;
  h2 = __float2bfloat16_rn(r1 - __bfloat162float(x1));
}

__device__ __forceinline__ void load8(const float* p, float (&v)[8]) {
  const float4 u = *reinterpret_cast<const float4*>(p), w = *reinterpret_cast<const float4*>(p + 4);
  v[0] = u.x, v[1] = u.y, v[2] = u.z, v[3] = u.w, v[4] = w.x, v[5] = w.y, v[6] = w.z, v[7] = w.w;
}

__device__ __forceinline__ void load8(const bf16* p, float (&v)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* e = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const float2 f = __bfloat1622float2(e[q]);
    v[2 * q] = f.x;
    v[2 * q + 1] = f.y;
  }
}

// out: three planes of n bf16 values, plane p at out + p * n; value i is
// split3(x[i] - sub[i % cols]) (no subtraction when sub is null).
template <typename T>
__global__ void split3_kernel(const T* __restrict__ x, const float* __restrict__ sub, bf16* __restrict__ out,
                              size_t n, int cols) {
  const size_t step = (size_t)gridDim.x * blockDim.x;
  for (size_t v = (size_t)blockIdx.x * blockDim.x + threadIdx.x; v < n / 8; v += step) {
    const size_t i = v * 8;
    float f[8];
    load8(x + i, f);
    if (sub != nullptr) {
      float s[8];
      load8(sub + i % cols, s);
#pragma unroll
      for (int u = 0; u < 8; ++u) f[u] -= s[u];
    }
    uint32_t h[3][4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      bf16 lo[3], hi[3];
      split3(f[2 * q], lo[0], lo[1], lo[2]);
      split3(f[2 * q + 1], hi[0], hi[1], hi[2]);
#pragma unroll
      for (int p = 0; p < 3; ++p)
        h[p][q] = (uint32_t)__bfloat16_as_ushort(lo[p]) | ((uint32_t)__bfloat16_as_ushort(hi[p]) << 16);
    }
#pragma unroll
    for (int p = 0; p < 3; ++p)
      *reinterpret_cast<uint4*>(out + p * n + i) = make_uint4(h[p][0], h[p][1], h[p][2], h[p][3]);
  }
}

template <typename T>
int launch_split(const void* x, const void* sub, void* out, long long n, int cols, cudaStream_t stream) {
  if (n % 8 != 0 || cols % 8 != 0 || n % cols != 0) return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = (n / 8 + 255) / 256;
  const int grid = (int)(blocks < 8LL * sms ? blocks : 8LL * sms);
  if (grid > 0)
    split3_kernel<T><<<grid, 256, 0, stream>>>(reinterpret_cast<const T*>(x), reinterpret_cast<const float*>(sub),
                                               reinterpret_cast<bf16*>(out), (size_t)n, cols);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// a_planes: three (M, K) bf16 planes, contiguous, one after another;
// w_planes: three (K, L); bias: (L,) fp32; out: (M, L) fp32.  K a multiple
// of 32, L of 128, M >= 1; all 16-byte aligned.  Returns
// cudaGetLastError(), or cudaErrorInvalidValue for a shape it does not
// take.
int sae_encode_f32(const void* a_planes, const void* w_planes, const void* bias, void* out, int M, int K, int L,
                   void* stream) {
  if (M < 1 || K < BK || K % BK != 0 || L < BN || L % BN != 0) return (int)cudaErrorInvalidValue;
  return launch(a_planes, w_planes, bias, out, M, K, L, reinterpret_cast<cudaStream_t>(stream));
}

// The three bf16 planes of x - sub (sub: (cols,) fp32, or NULL for x
// itself): x (n / cols, cols) contiguous, cols and n multiples of 8, every
// pointer 16-byte aligned; out: 3 n bf16.
int split3_f32(const void* x, const void* sub, void* out, long long n, int cols, void* stream) {
  return launch_split<float>(x, sub, out, n, cols, reinterpret_cast<cudaStream_t>(stream));
}

int split3_bf16(const void* x, const void* sub, void* out, long long n, int cols, void* stream) {
  return launch_split<bf16>(x, sub, out, n, cols, reinterpret_cast<cudaStream_t>(stream));
}

}  // extern "C"
