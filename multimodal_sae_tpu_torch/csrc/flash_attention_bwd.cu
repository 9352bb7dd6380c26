// Causal flash-attention backward over (B, H, S, hd) bf16, hd 64 or 128, with
// grouped key/value heads and an optional key pad mask: dq, dk, dv from q, k,
// v, the forward's output o, its row logsumexp lse and the output gradient do.
//
// Replaces the backward of jax's shipped Pallas TPU kernel
// (jax.experimental.pallas.ops.tpu.flash_attention: _flash_attention_bwd_dkv,
// its pallas_call at flash_attention.py:1121, and _flash_attention_bwd_dq, at
// :1456), the custom VJP of the attention that
// multimodal_sae_tpu/models/llama.py::flash_attention calls.
//
// Semantics, those of jax's mha_reference_bwd: with qs = bf16(q * scale) (the
// forward folds the scale into q in bf16), s = qs . k over keys j <= i with
// kv_valid[b, j] != 0, and P = exp(s - lse) rebuilt from the saved lse:
//   dv = P^T do,  dp = do v^T,  D = rowsum(o * do),  ds = P (dp - D),
//   dk = ds^T qs,  dq = bf16(bf16(ds k) * scale)
// (dq is taken with respect to the unscaled q, through the bf16 multiply by
// the scale, rounded twice as the JAX side rounds it).  dk and dv of kv head
// g sum over its H / kvH query heads in fp32, in a fixed order.  A row with
// no valid key (a leading pad query under left padding) has lse = +inf: its
// P is 0, so it gets dq = 0 and adds nothing to dk or dv.  jax's reference
// spreads such a row's do over all keys instead; the two agree whenever do is
// 0 on those rows, which is what every caller gives them (no real position
// reads them).
//
// Bound on an H100: tensor-core operations, 5 products of 2 * hd per causal
// (query, valid key) pair (QK^T, dO V^T, P^T dO, dS^T Q, dS K) over
// 989 TFLOP/s, about 0.98 ms at B=8, H=32, S=2432, hd=128.  The kernels run
// 7: the dQ kernel recomputes S and dP.  FlashAttention-2's single kernel
// saves those two by adding each block's dQ into an fp32 buffer with
// atomicAdd, but the order of those adds changes from run to run and so do
// dq's bits; the attribution checks rely on equal inputs giving equal bits,
// so the split stays and nothing here uses atomics.
//
// Design (Hopper: wgmma fed by a cp.async ring; building blocks in sm90.cuh):
// (1) The D pass, one warp per row: D = rowsum(o * do) in fp32, and
// qs = bf16(q * scale) written once for both product kernels.
// (2) dK/dV: one warpgroup per (b, kv head, 64-key tile); the grid puts key
// tile 0 (the most query tiles) of every (b, kv head) first.  K and V load
// once into 128-byte-swizzled shared tiles; dK and dV accumulate in fp32
// registers.  The loop runs over the group's H / kvH query heads and, in
// each, the 64-query tiles from the diagonal down, through a 2-stage ring
// holding each tile's qs, dO, lse and D; tile i + 1's cp.async copies are in
// flight while tile i computes.  Per tile: S^T = K qs^T and dP^T = V dO^T as
// wgmma with both operands in shared memory (N = 64); P^T = exp2(S^T log2 e
// - lse log2 e), masked only on the diagonal tile and the ragged tail;
// dS^T = P^T (dP^T - D); both rounded to bf16 in registers, where the
// accumulator layout already is wgmma's A-fragment layout; then dV += P^T dO
// and dK += dS^T qs as wgmma with A from registers and B read MN-major from
// the same qs and dO tiles (N = hd), so no transposed copy is written.  A
// key with kv_valid = 0 gets dk = dv = 0 in the epilogue: its row of P^T
// touches only its own row of dK and dV.
// (3) dQ: one warpgroup per (b, h, 64-query tile); the grid puts the last
// query tile (the most key tiles) of every (b, h) first.  qs and dO load
// once; K and V tiles come through a 2-stage ring up to the diagonal.  S =
// qs K^T and dP = dO V^T from shared memory, dS in registers, dQ += dS K with
// K read MN-major from the same tile.
// Each block is one warpgroup of 128 threads, two blocks per SM.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "sm90.cuh"

namespace {

using namespace sm90;

typedef __nv_bfloat16 bf16;

constexpr int THREADS = 128;  // one warpgroup a block
constexpr int STAGES = 2;     // ring depth
constexpr int KB = 64;        // dK/dV kernel: keys a block (wgmma M)
constexpr int QT = 64;        // dK/dV kernel: queries a ring tile
constexpr int QB = 64;        // dQ kernel: queries a block (wgmma M)
constexpr int KT = 64;        // dQ kernel: keys a ring tile
constexpr float LOG2E = 1.4426950408889634f;
static_assert(THREADS == 2 * QT, "one thread copies each lse and D value of a tile");

// D[row] = sum_c o[row, c] * do[row, c] in fp32 and qs[row] = bf16(q[row] *
// scale), one warp per row.
__global__ void __launch_bounds__(THREADS)
    delta_kernel(const bf16* __restrict__ q, const bf16* __restrict__ o,
                 const bf16* __restrict__ dout, float* __restrict__ delta,
                 bf16* __restrict__ qs, int rows, int hd, float scale) {
  const int row = blockIdx.x * (THREADS / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  const size_t off = (size_t)row * hd;
  float s = 0.f;
  for (int c = 2 * lane; c < hd; c += 64) {
    const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(o + off + c));
    const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(dout + off + c));
    s += a.x * b.x + a.y * b.y;
    const float2 x = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(q + off + c));
    *reinterpret_cast<__nv_bfloat162*>(qs + off + c) = __floats2bfloat162_rn(x.x * scale, x.y * scale);
  }
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) s += __shfl_xor_sync(0xffffffffu, s, m);
  if (lane == 0) delta[row] = s;
}

// Dynamic shared memory of the dK/dV kernel: K and V tiles, then STAGES ring
// stages of (qs tile, dO tile, lse and D of the tile's queries), each stage
// padded to 1024 bytes so every tile starts on a swizzle boundary; 1024
// bytes of slack to align the start.
template <int HD>
struct DkdvSmem {
  static constexpr int KV_TILE = KB * HD * 2;
  static constexpr int Q_TILE = QT * HD * 2;
  static constexpr int STAGE = 2 * Q_TILE + 1024;
  static constexpr int BYTES = 1024 + 2 * KV_TILE + STAGES * STAGE;
};

template <int HD>
__global__ void __launch_bounds__(THREADS, 2)
    dkdv_kernel(const bf16* __restrict__ qs, const bf16* __restrict__ k,
                const bf16* __restrict__ v, const int* __restrict__ kv_valid,
                const float* __restrict__ lse, const bf16* __restrict__ dout,
                const float* __restrict__ delta, bf16* __restrict__ dk,
                bf16* __restrict__ dv, int BK, int H, int kvH, int S) {
  using L = DkdvSmem<HD>;
  extern __shared__ unsigned char smem[];
  const uint32_t raw = smem_u32(smem);
  const uint32_t base = (raw + 1023) & ~1023u;
  const unsigned char* base_p = smem + (base - raw);
  const uint32_t Ks = base, Vs = base + L::KV_TILE, ring = base + 2 * L::KV_TILE;

  const int bk = blockIdx.x % BK;  // b * kvH + kv head
  const int k0 = (blockIdx.x / BK) * KB;
  const int b = bk / kvH;
  const int rep = H / kvH;
  const int head0 = b * H + (bk % kvH) * rep;  // b * H + the group's first query head
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int per_head = (S - k0 + QT - 1) / QT;  // query tiles from the diagonal (q0 = k0) down
  const int n_tiles = rep * per_head;

  // Ring tile `it`: query head it / per_head of the group, queries from
  // k0 + (it % per_head) * QT; zero past S (lse and D too: the tile's
  // masking drops those queries).
  auto prefetch = [&](int it) {
    const size_t bh = head0 + it / per_head;
    const int q0 = k0 + (it % per_head) * QT;
    const uint32_t st = ring + (it % STAGES) * L::STAGE;
    load_tile<QT, HD, THREADS>(st, qs + bh * S * HD, q0, S, tid);
    load_tile<QT, HD, THREADS>(st + L::Q_TILE, dout + bh * S * HD, q0, S, tid);
    const int r = tid % QT;
    const bool ok = q0 + r < S;
    cp_async4(st + 2 * L::Q_TILE + tid * 4, (tid < QT ? lse : delta) + bh * S + (ok ? q0 + r : 0), ok);
  };

  load_tile<KB, HD, THREADS>(Ks, k + (size_t)bk * S * HD, k0, S, tid);
  load_tile<KB, HD, THREADS>(Vs, v + (size_t)bk * S * HD, k0, S, tid);
  prefetch(0);
  cp_async_commit();

  float dk_acc[HD / 2], dv_acc[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;
  fence_regs(dk_acc);
  fence_regs(dv_acc);

  for (int it = 0; it < n_tiles; ++it) {
    cp_async_wait<0>();
    fence_proxy_async();
    __syncthreads();  // tile it has landed; every thread is done with tile it - 1
    if (it + 1 < n_tiles) prefetch(it + 1);
    cp_async_commit();

    const int q0 = k0 + (it % per_head) * QT;
    const uint32_t Qs = ring + (it % STAGES) * L::STAGE, dOs = Qs + L::Q_TILE;
    const float* lse_s = reinterpret_cast<const float*>(base_p + (Qs - base) + 2 * L::Q_TILE);
    const float* d_s = lse_s + QT;

    // S^T = K qs^T and dP^T = V dO^T (64 keys x QT queries).
    float s[QT / 2], dp[QT / 2];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)
      wgmma_ss<QT, 0>(s, desc_k_major<KB>(Ks, kk), desc_k_major<QT>(Qs, kk), kk);
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)
      wgmma_ss<QT, 0>(dp, desc_k_major<KB>(Vs, kk), desc_k_major<QT>(dOs, kk), kk);
    wgmma_commit();

    // P^T from lse while dP^T is still in flight.  Only the diagonal tile
    // and the ragged tail need the causal and end-of-sequence masks.
    wgmma_wait<1>();
    fence_regs(s);
    const bool edge = q0 < k0 + KB || q0 + QT > S;
#pragma unroll
    for (int i = 0; i < QT / 2; ++i) {
      const int c = acc_col(i, lane);
      float p = exp2f(s[i] * LOG2E - lse_s[c] * LOG2E);
      if (edge && !(k0 + acc_row(i, lane, warp) <= q0 + c && q0 + c < S)) p = 0.f;
      s[i] = p;
    }
    wgmma_wait<0>();
    fence_regs(dp);
#pragma unroll
    for (int i = 0; i < QT / 2; ++i) dp[i] = s[i] * (dp[i] - d_s[acc_col(i, lane)]);

    // dV += P^T dO and dK += dS^T qs, A from registers, B MN-major.
    uint32_t pa[QT / 16][4], da[QT / 16][4];
#pragma unroll
    for (int kq = 0; kq < QT / 16; ++kq) {
      acc_to_a(pa[kq], s, kq);
      acc_to_a(da[kq], dp, kq);
    }
    wgmma_fence();
#pragma unroll
    for (int kq = 0; kq < QT / 16; ++kq) wgmma_rs<HD, 1>(dv_acc, pa[kq], desc_mn_major<QT>(dOs, kq), 1);
#pragma unroll
    for (int kq = 0; kq < QT / 16; ++kq) wgmma_rs<HD, 1>(dk_acc, da[kq], desc_mn_major<QT>(Qs, kq), 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dv_acc);
    fence_regs(dk_acc);
  }

  // Epilogue: bf16 dk and dv; 0 for a key the pad mask drops.
  const int r0 = k0 + acc_row(0, lane, warp), r1 = r0 + 8;
  const bool ok0 = r0 < S && (kv_valid == nullptr || kv_valid[(size_t)b * S + r0] != 0);
  const bool ok1 = r1 < S && (kv_valid == nullptr || kv_valid[(size_t)b * S + r1] != 0);
  bf16* dkp = dk + (size_t)bk * S * HD;
  bf16* dvp = dv + (size_t)bk * S * HD;
#pragma unroll
  for (int i = 0; i < HD / 2; i += 2) {
    const int row = (i & 2) ? r1 : r0;
    const bool ok = (i & 2) ? ok1 : ok0;
    if (row < S) {
      const size_t at = (size_t)row * HD + acc_col(i, lane);
      *reinterpret_cast<uint32_t*>(dkp + at) = ok ? pack_bf16(dk_acc[i], dk_acc[i + 1]) : 0u;
      *reinterpret_cast<uint32_t*>(dvp + at) = ok ? pack_bf16(dv_acc[i], dv_acc[i + 1]) : 0u;
    }
  }
}

// Dynamic shared memory of the dQ kernel: qs and dO tiles of the block's
// queries, then STAGES ring stages of (K tile, V tile, kv_valid of the
// tile's keys), each padded to 1024 bytes; 1024 bytes of slack.
template <int HD>
struct DqSmem {
  static constexpr int Q_TILE = QB * HD * 2;
  static constexpr int KV_TILE = KT * HD * 2;
  static constexpr int STAGE = 2 * KV_TILE + 1024;
  static constexpr int BYTES = 1024 + 2 * Q_TILE + STAGES * STAGE;
};

template <int HD>
__global__ void __launch_bounds__(THREADS, 2)
    dq_kernel(const bf16* __restrict__ qs, const bf16* __restrict__ k,
              const bf16* __restrict__ v, const int* __restrict__ kv_valid,
              const float* __restrict__ lse, const bf16* __restrict__ dout,
              const float* __restrict__ delta, bf16* __restrict__ dq, int BH, int H,
              int kvH, int S, float scale) {
  using L = DqSmem<HD>;
  extern __shared__ unsigned char smem[];
  const uint32_t raw = smem_u32(smem);
  const uint32_t base = (raw + 1023) & ~1023u;
  const unsigned char* base_p = smem + (base - raw);
  const uint32_t Qs = base, dOs = base + L::Q_TILE, ring = base + 2 * L::Q_TILE;

  const int n_q_tiles = (S + QB - 1) / QB;
  const int bh = blockIdx.x % BH;
  const int q0 = (n_q_tiles - 1 - blockIdx.x / BH) * QB;
  const int b = bh / H;
  const size_t bkv = (size_t)b * kvH + (bh % H) / (H / kvH);
  const bf16* kp = k + bkv * S * HD;
  const bf16* vp = v + bkv * S * HD;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int n_tiles = (min(S, q0 + QB) - 1) / KT + 1;  // key tiles up to the diagonal

  // Ring tile j: keys j * KT .. j * KT + KT - 1, zero past S.
  auto prefetch = [&](int j) {
    const uint32_t st = ring + (j % STAGES) * L::STAGE;
    load_tile<KT, HD, THREADS>(st, kp, j * KT, S, tid);
    load_tile<KT, HD, THREADS>(st + L::KV_TILE, vp, j * KT, S, tid);
    if (kv_valid != nullptr && tid < KT) {
      const int key = j * KT + tid;
      cp_async4(st + 2 * L::KV_TILE + tid * 4, kv_valid + (size_t)b * S + (key < S ? key : 0), key < S);
    }
  };

  load_tile<QB, HD, THREADS>(Qs, qs + (size_t)bh * S * HD, q0, S, tid);
  load_tile<QB, HD, THREADS>(dOs, dout + (size_t)bh * S * HD, q0, S, tid);
  prefetch(0);
  cp_async_commit();

  // This thread's two query rows, their lse (in log2 units) and D.
  const int r0 = q0 + acc_row(0, lane, warp), r1 = r0 + 8;
  const float l0 = (r0 < S ? lse[(size_t)bh * S + r0] : INFINITY) * LOG2E;
  const float l1 = (r1 < S ? lse[(size_t)bh * S + r1] : INFINITY) * LOG2E;
  const float d0 = r0 < S ? delta[(size_t)bh * S + r0] : 0.f;
  const float d1 = r1 < S ? delta[(size_t)bh * S + r1] : 0.f;

  float acc[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) acc[i] = 0.f;
  fence_regs(acc);

  for (int j = 0; j < n_tiles; ++j) {
    cp_async_wait<0>();
    fence_proxy_async();
    __syncthreads();  // tile j has landed; every thread is done with tile j - 1
    if (j + 1 < n_tiles) prefetch(j + 1);
    cp_async_commit();

    const int k0 = j * KT;
    const uint32_t Ks = ring + (j % STAGES) * L::STAGE, Vs = Ks + L::KV_TILE;
    const int* key_ok = reinterpret_cast<const int*>(base_p + (Ks - base) + 2 * L::KV_TILE);

    // S = qs K^T and dP = dO V^T (64 queries x KT keys).
    float s[KT / 2], dp[KT / 2];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)
      wgmma_ss<KT, 0>(s, desc_k_major<QB>(Qs, kk), desc_k_major<KT>(Ks, kk), kk);
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)
      wgmma_ss<KT, 0>(dp, desc_k_major<QB>(dOs, kk), desc_k_major<KT>(Vs, kk), kk);
    wgmma_commit();

    // P from lse; the causal mask only on the diagonal tile (which also
    // holds every key past S), the pad mask wherever one is given.
    wgmma_wait<1>();
    fence_regs(s);
    const bool edge = k0 + KT - 1 > q0 || kv_valid != nullptr;
#pragma unroll
    for (int i = 0; i < KT / 2; ++i) {
      float p = exp2f(s[i] * LOG2E - ((i & 2) ? l1 : l0));
      if (edge) {
        const int c = acc_col(i, lane);
        if (k0 + c > ((i & 2) ? r1 : r0) || (kv_valid != nullptr && key_ok[c] == 0)) p = 0.f;
      }
      s[i] = p;
    }
    wgmma_wait<0>();
    fence_regs(dp);
#pragma unroll
    for (int i = 0; i < KT / 2; ++i) dp[i] = s[i] * (dp[i] - ((i & 2) ? d1 : d0));

    // dQ += dS K, A from registers, B (the K tile) MN-major.
    uint32_t da[KT / 16][4];
#pragma unroll
    for (int kq = 0; kq < KT / 16; ++kq) acc_to_a(da[kq], dp, kq);
    wgmma_fence();
#pragma unroll
    for (int kq = 0; kq < KT / 16; ++kq) wgmma_rs<HD, 1>(acc, da[kq], desc_mn_major<KT>(Ks, kq), 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
  }

  // dq = bf16(bf16(dS K) * scale): the VJP of the forward's bf16 q * scale.
  bf16* dqp = dq + (size_t)bh * S * HD;
  const bf16 scale_b = __float2bfloat16(scale);
  const __nv_bfloat162 sc = __halves2bfloat162(scale_b, scale_b);
#pragma unroll
  for (int i = 0; i < HD / 2; i += 2) {
    const int row = (i & 2) ? r1 : r0;
    if (row < S) {
      const __nv_bfloat162 x = __hmul2(__floats2bfloat162_rn(acc[i], acc[i + 1]), sc);
      *reinterpret_cast<__nv_bfloat162*>(dqp + (size_t)row * HD + acc_col(i, lane)) = x;
    }
  }
}

template <int HD>
int launch_dkdv(const void* qs, const void* k, const void* v, const void* kv_valid,
                const void* lse, const void* dout, const void* delta, void* dk, void* dv,
                int B, int H, int kvH, int S, cudaStream_t stream) {
  constexpr int smem = DkdvSmem<HD>::BYTES;
  cudaError_t err =
      cudaFuncSetAttribute(dkdv_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int BK = B * kvH;
  dkdv_kernel<HD><<<((S + KB - 1) / KB) * BK, THREADS, smem, stream>>>(
      reinterpret_cast<const bf16*>(qs), reinterpret_cast<const bf16*>(k),
      reinterpret_cast<const bf16*>(v), reinterpret_cast<const int*>(kv_valid),
      reinterpret_cast<const float*>(lse), reinterpret_cast<const bf16*>(dout),
      reinterpret_cast<const float*>(delta), reinterpret_cast<bf16*>(dk),
      reinterpret_cast<bf16*>(dv), BK, H, kvH, S);
  return (int)cudaGetLastError();
}

template <int HD>
int launch_dq(const void* qs, const void* k, const void* v, const void* kv_valid,
              const void* lse, const void* dout, const void* delta, void* dq, int B, int H,
              int kvH, int S, float scale, cudaStream_t stream) {
  constexpr int smem = DqSmem<HD>::BYTES;
  cudaError_t err =
      cudaFuncSetAttribute(dq_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int BH = B * H;
  dq_kernel<HD><<<((S + QB - 1) / QB) * BH, THREADS, smem, stream>>>(
      reinterpret_cast<const bf16*>(qs), reinterpret_cast<const bf16*>(k),
      reinterpret_cast<const bf16*>(v), reinterpret_cast<const int*>(kv_valid),
      reinterpret_cast<const float*>(lse), reinterpret_cast<const bf16*>(dout),
      reinterpret_cast<const float*>(delta), reinterpret_cast<bf16*>(dq), BH, H, kvH, S, scale);
  return (int)cudaGetLastError();
}

// Registers a thread, dynamic shared memory a block and resident blocks an
// SM of one kernel.
template <typename Kernel>
int kernel_resources(Kernel kernel, int smem, int* out) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, kernel);
  if (err == cudaSuccess) err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[2], kernel, THREADS, smem);
  out[0] = attr.numRegs;
  out[1] = smem;
  return (int)err;
}

}  // namespace

extern "C" {

// q, o, do, qs: (rows, hd) bf16 contiguous, hd 64 or 128; delta: (rows,)
// fp32.  Launches the D pass: delta[r] = sum_c o[r, c] * do[r, c] and qs =
// bf16(q * scale), scale already rounded to bf16.  Returns a CUDA error code
// (0 on success), or cudaErrorInvalidValue for another hd.
int flash_attention_bwd_delta_bf16(const void* q, const void* o, const void* dout, void* delta,
                                   void* qs, int rows, int hd, float scale, void* stream) {
  if (hd != 128 && hd != 64) return (int)cudaErrorInvalidValue;
  delta_kernel<<<(rows + THREADS / 32 - 1) / (THREADS / 32), THREADS, 0,
                 reinterpret_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const bf16*>(q), reinterpret_cast<const bf16*>(o),
      reinterpret_cast<const bf16*>(dout), reinterpret_cast<float*>(delta),
      reinterpret_cast<bf16*>(qs), rows, hd, scale);
  return (int)cudaGetLastError();
}

// qs, do: (B, H, S, hd) bf16 contiguous, qs from the D pass; k, v, dk, dv:
// (B, kvH, S, hd) bf16 contiguous with H % kvH == 0; hd 64 or 128; kv_valid:
// (B, S) int32 or NULL (all valid); lse, delta: (B, H, S) fp32, delta from
// the D pass.  Launches the dK/dV kernel.  Returns a CUDA error code (0 on
// success), or cudaErrorInvalidValue for another hd.
int flash_attention_bwd_dkdv_bf16(const void* qs, const void* k, const void* v,
                                  const void* kv_valid, const void* lse, const void* dout,
                                  const void* delta, void* dk, void* dv, int B, int H, int kvH,
                                  int S, int hd, void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (hd == 128) return launch_dkdv<128>(qs, k, v, kv_valid, lse, dout, delta, dk, dv, B, H, kvH, S, st);
  if (hd == 64) return launch_dkdv<64>(qs, k, v, kv_valid, lse, dout, delta, dk, dv, B, H, kvH, S, st);
  return (int)cudaErrorInvalidValue;
}

// Shapes as above; scale: the softmax scale rounded to bf16; dq: (B, H, S,
// hd) bf16, the gradient with respect to the unscaled q.  Launches the dQ
// kernel.
int flash_attention_bwd_dq_bf16(const void* qs, const void* k, const void* v,
                                const void* kv_valid, const void* lse, const void* dout,
                                const void* delta, void* dq, int B, int H, int kvH, int S,
                                int hd, float scale, void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (hd == 128) return launch_dq<128>(qs, k, v, kv_valid, lse, dout, delta, dq, B, H, kvH, S, scale, st);
  if (hd == 64) return launch_dq<64>(qs, k, v, kv_valid, lse, dout, delta, dq, B, H, kvH, S, scale, st);
  return (int)cudaErrorInvalidValue;
}

// Resources of the product kernels at head dim hd, for reports: out[0..2] =
// registers a thread, dynamic shared memory bytes a block and resident
// blocks an SM of the dK/dV kernel, out[3..5] the same of the dQ kernel.
int flash_attention_bwd_resources(int hd, int* out) {
  if (hd == 128) {
    const int err = kernel_resources(dkdv_kernel<128>, DkdvSmem<128>::BYTES, out);
    return err ? err : kernel_resources(dq_kernel<128>, DqSmem<128>::BYTES, out + 3);
  }
  if (hd == 64) {
    const int err = kernel_resources(dkdv_kernel<64>, DkdvSmem<64>::BYTES, out);
    return err ? err : kernel_resources(dq_kernel<64>, DqSmem<64>::BYTES, out + 3);
  }
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
