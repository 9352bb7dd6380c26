// Causal flash-attention forward over (B, H, S, hd) bf16, hd 64 or 128, with
// grouped key/value heads and an optional key pad mask.
//
// Replaces the forward of jax's shipped Pallas TPU kernel
// (jax.experimental.pallas.ops.tpu.flash_attention.flash_attention), called
// from multimodal_sae_tpu/models/llama.py::flash_attention.
//
// Semantics, those of jax's mha_reference with its finite additive mask:
// out[b, h, i] = softmax_j(q[b, h, i] . k[b, h / (H / kvH), j]) over keys
// j <= i with kv_valid[b, j] != 0, times v.  The softmax scale is folded into
// q in bf16 before the product (llama.py:330 does the same), so both packages
// round alike.  A query with no valid key at all (a leading pad query under
// left padding) gets what the JAX wrapper gives it: its finite mask of
// -0.7 * FLT_MAX makes the weights equal over the S keys padded to a multiple
// of 128 (zero v past S), so the output is sum(v) / round_up(S, 128).  No
// real position reads such a row.  QK^T, the online softmax and the
// PV sum run in fp32; P is rounded to bf16 for the PV product.  Any S: the
// kernel masks its own ragged edge.
//
// Bound on an H100: tensor-core operations, 2*B*H*S^2*hd causal FLOPs over
// 989 TFLOP/s (bf16 dense), about 0.28 ms per layer at B=8, H=32, S=2048,
// hd=128; the bytes (q, k, v read once, o written once) take far less.
//
// Design (Hopper: wgmma fed by a cp.async ring, building blocks in sm90.cuh;
// warp-specialised).  A block holds two query heads of one GQA group at the
// same 64-query tile (one head where the group's size is odd): one consumer
// warpgroup of 128 threads per head, and a producer warpgroup that does
// nothing but copy.  setmaxnreg moves registers from the producer (72) to
// the consumers (216).  The grid puts the last query tile (the most key
// tiles) of every head first.
// The producer copies K and V tiles of 64 keys, each 128-byte swizzled, and
// the kv_valid flags of the tile's keys, through a 3-stage cp.async ring up
// to the diagonal, two tiles in flight.  Each tile serves both heads, so
// the group's K and V cross from L2 once per two query heads.  Named
// barriers hand a landed stage to each consumer on its own (full) and the
// stage back once both are done with it (empty): the consumers never wait
// for each other, so one's softmax runs while the other's products do.
// A consumer loads its q tile once into registers as the A fragments of the
// S product, scaled in bf16 on the way (bf16(q * bf16(scale))).  Per tile:
// S = qs K^T as wgmma with qs from registers and K read K-major (N = 64);
// the online softmax in fp32 registers in log2 units (one FFMA and one
// ex2.approx a logit), its row max and sum reduced over the 4 threads that
// share a row of the accumulator; then O += P V as wgmma with P from
// registers (the accumulator layout is the A fragment's) and V read
// MN-major from its row-major tile, so no transposed copy is written.  The
// causal and end-of-sequence masks run only on the diagonal tile (which
// holds every key past S), the pad mask only on a tile that holds an
// invalid key.  No atomics: the output is deterministic.  PERF.md has the
// designs measured against this one.
//
// Optional output for the backward (csrc/flash_attention_bwd.cu): lse, the
// fp32 natural-log logsumexp of each row's scaled, masked logits, (B, H, S);
// +inf for a row with no valid key, so the backward's rebuilt weights are 0
// there.  With a null pointer nothing extra is written.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "sm90.cuh"

namespace {

using namespace sm90;

typedef __nv_bfloat16 bf16;

constexpr int WG = 128;          // threads a warpgroup
constexpr int PRODUCER_REGS = 72;   // registers a thread after setmaxnreg
constexpr int CONSUMER_REGS = 216;
constexpr int STAGES = 3;        // ring depth
constexpr int QB = 64;           // queries a warpgroup (wgmma M)
constexpr int KT = 64;           // keys a ring tile
constexpr int PAD_BUCKET = 128;  // the JAX wrapper's sequence padding
constexpr float LOG2E = 1.4426950408889634f;

// 2^x, one MUFU op: 0 at -inf, relative error about 2^-22.
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Named barriers (0 is __syncthreads'; 15 at most): full(s, w) hands ring
// stage s from the producer warpgroup to consumer warpgroup w (2 WG
// threads); empty(s) hands it back from every consumer to the producer
// (all the block's threads); group(w) is warpgroup w's own (WG threads).
__device__ __forceinline__ int full_id(int s, int w) { return 1 + w * STAGES + s; }
__device__ __forceinline__ int empty_id(int s) { return 1 + 2 * STAGES + s; }
__device__ __forceinline__ int group_id(int w) { return 1 + 3 * STAGES + w; }
__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// Dynamic shared memory: STAGES ring stages of (K tile, V tile, kv_valid of
// the tile's keys), each stage padded to 1024 bytes so every tile starts on
// a swizzle boundary, then each warpgroup's scratch for the empty-row sums;
// 1024 bytes of slack to align the start.
template <int HD, int HEADS>
struct FwdSmem {
  static constexpr int KV_TILE = KT * HD * 2;
  static constexpr int STAGE = 2 * KV_TILE + 1024;
  static constexpr int PART = HEADS * WG * 8 * 4;
  static constexpr int BYTES = 1024 + STAGES * STAGE + PART;
};

// Compiled for three warpgroups a block whatever HEADS is, so the register
// count the launch starts from (168) is the same for both forms; setmaxnreg
// then moves registers from the producer to the consumers.
template <int HD, int HEADS>
__global__ void __launch_bounds__(3 * WG, 1)
    flash_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, const int* __restrict__ kv_valid,
                     bf16* __restrict__ o, float* __restrict__ lse, int BH, int H, int kvH,
                     int S, float scale) {
  using L = FwdSmem<HD, HEADS>;
  constexpr int CONSUMERS = HEADS * WG;
  constexpr int CH = HD / 8;  // 16-byte chunks a row of v
  extern __shared__ unsigned char smem[];
  __shared__ float v_mean[HEADS][HD];
  __shared__ int any_empty[HEADS];
  const uint32_t raw = smem_u32(smem);
  const uint32_t ring = (raw + 1023) & ~1023u;
  unsigned char* ring_p = smem + (ring - raw);

  const int n_q_tiles = (S + QB - 1) / QB;
  const int bh0 = (blockIdx.x % (BH / HEADS)) * HEADS;  // b * H + the block's first head
  const int q0 = (n_q_tiles - 1 - blockIdx.x / (BH / HEADS)) * QB;
  const int b = bh0 / H;
  const size_t bkv = (size_t)b * kvH + (bh0 % H) / (H / kvH);
  const bf16* kp = k + bkv * S * HD;
  const bf16* vp = v + bkv * S * HD;
  const int tid = threadIdx.x;
  const int n_tiles = (min(S, q0 + QB) - 1) / KT + 1;  // key tiles up to the diagonal
  auto stage = [&](int j) { return ring + (j % STAGES) * L::STAGE; };
  auto key_ok = [&](int j) {
    return reinterpret_cast<const int*>(ring_p + (j % STAGES) * L::STAGE + 2 * L::KV_TILE);
  };
  if (tid < HEADS) any_empty[tid] = 0;
  __syncthreads();

  if (tid >= CONSUMERS) {
    // The producer warpgroup: ring tile j (keys j * KT .. j * KT + KT - 1,
    // zero past S) into stage j % STAGES once every consumer has released
    // tile j - STAGES there; tile j - 1 handed to the consumers once it
    // lands, so two tiles are in flight.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    const int ptid = tid - CONSUMERS;
    for (int j = 0; j < n_tiles; ++j) {
      if (j >= STAGES) bar_sync(empty_id(j % STAGES), (HEADS + 1) * WG);
      load_tile<KT, HD, WG>(stage(j), kp, j * KT, S, ptid);
      load_tile<KT, HD, WG>(stage(j) + L::KV_TILE, vp, j * KT, S, ptid);
      if (kv_valid != nullptr && ptid < KT) {
        const int key = j * KT + ptid;
        cp_async4(stage(j) + 2 * L::KV_TILE + ptid * 4, kv_valid + (size_t)b * S + (key < S ? key : 0), key < S);
      }
      cp_async_commit();
      if (j >= 1) {
        cp_async_wait<1>();
        fence_proxy_async();
        for (int w = 0; w < HEADS; ++w) bar_arrive(full_id((j - 1) % STAGES, w), 2 * WG);
      }
    }
    cp_async_wait<0>();
    fence_proxy_async();
    for (int w = 0; w < HEADS; ++w) bar_arrive(full_id((n_tiles - 1) % STAGES, w), 2 * WG);
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));

  // Consumer warpgroup wg: query head bh0 + wg.
  const int wg = tid / WG, lane = tid % 32, warp = (tid % WG) / 32;
  const int bh = bh0 + wg;

  // This thread's two query rows, their running max (log2 units) and sum.
  const int r0 = q0 + acc_row(0, lane, warp), r1 = r0 + 8;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
  float acc[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) acc[i] = 0.f;
  fence_regs(acc);

  // qs = bf16(q * scale) of the tile's 64 queries as the A fragments of
  // the S product (the accumulator layout, columns 16 kk .. 16 kk + 15);
  // zero past S.
  uint32_t qa[HD / 16][4];
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = (e & 1) ? r1 : r0, col = 16 * kk + 2 * (lane % 4) + ((e & 2) ? 8 : 0);
      uint32_t x = 0u;
      if (row < S) {
        const float2 f =
            __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(q + ((size_t)bh * S + row) * HD + col));
        x = pack_bf16(f.x * scale, f.y * scale);
      }
      qa[kk][e] = x;
    }
  }

  for (int j = 0; j < n_tiles; ++j) {
    const int k0 = j * KT;
    const uint32_t Ks = stage(j), Vs = Ks + L::KV_TILE;
    const int* ok = key_ok(j);
    bar_sync(full_id(j % STAGES, wg), 2 * WG);  // tile j has landed
    bool all_valid = true;
    if (kv_valid != nullptr) {
#pragma unroll
      for (int t = lane; t < KT; t += 32) all_valid = all_valid && ok[t] != 0;
      all_valid = __all_sync(0xffffffffu, all_valid);
    }

    // S = qs K^T (64 queries x KT keys).
    float s[KT / 2];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)
      wgmma_rs<KT, 0>(s, qa[kk], desc_k_major<KT>(Ks, kk), kk);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);

    // The masks, then the tile's row maxima of the raw logits.
    if (k0 + KT - 1 > q0 || !all_valid) {
#pragma unroll
      for (int i = 0; i < KT / 2; ++i) {
        const int c = acc_col(i, lane);
        if (k0 + c > ((i & 2) ? r1 : r0) || (kv_valid != nullptr && ok[c] == 0)) s[i] = -INFINITY;
      }
    }
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int i = 0; i < KT / 2; ++i) {
      if (i & 2) mx1 = fmaxf(mx1, s[i]);
      else mx0 = fmaxf(mx0, s[i]);
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    const float mn0 = fmaxf(m0, mx0 * LOG2E), mn1 = fmaxf(m1, mx1 * LOG2E);
    // A row with no valid key yet keeps max -inf: subtract 0 instead, so
    // its p (all 2^-inf) and its alpha stay 0, never NaN.
    const float mu0 = mn0 == -INFINITY ? 0.f : mn0;
    const float mu1 = mn1 == -INFINITY ? 0.f : mn1;
    const float alpha0 = ex2(m0 - mu0), alpha1 = ex2(m1 - mu1);
    float ls0 = 0.f, ls1 = 0.f;
#pragma unroll
    for (int i = 0; i < KT / 2; ++i) {
      const float p = ex2(fmaf(s[i], LOG2E, (i & 2) ? -mu1 : -mu0));
      s[i] = p;
      if (i & 2) ls1 += p;
      else ls0 += p;
    }
    ls0 += __shfl_xor_sync(0xffffffffu, ls0, 1);
    ls0 += __shfl_xor_sync(0xffffffffu, ls0, 2);
    ls1 += __shfl_xor_sync(0xffffffffu, ls1, 1);
    ls1 += __shfl_xor_sync(0xffffffffu, ls1, 2);
    l0 = l0 * alpha0 + ls0;
    l1 = l1 * alpha1 + ls1;
    m0 = mn0;
    m1 = mn1;
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) acc[i] *= (i & 2) ? alpha1 : alpha0;

    // O += P V, P rounded to bf16 in registers, V MN-major.
    uint32_t pa[KT / 16][4];
#pragma unroll
    for (int kq = 0; kq < KT / 16; ++kq) acc_to_a(pa[kq], s, kq);
    wgmma_fence();
#pragma unroll
    for (int kq = 0; kq < KT / 16; ++kq) wgmma_rs<HD, 1>(acc, pa[kq], desc_mn_major<KT>(Vs, kq), 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
    // Done with tile j's stage; the producer refills it with tile j + STAGES.
    if (j + STAGES < n_tiles) bar_arrive(empty_id(j % STAGES), (HEADS + 1) * WG);
  }

  // Every row with a valid key has l >= 1 (its max contributes 2^0).
  const bool empty0 = r0 < S && l0 == 0.f;
  const bool empty1 = r1 < S && l1 == 0.f;
  if (empty0 || empty1) any_empty[wg] = 1;
  bar_sync(group_id(wg), WG);
  if (any_empty[wg]) {
    // Rare (blocks holding leading pad queries): the column sums of v over
    // all S keys in fp32, each thread summing 8 columns of a strided set
    // of keys into its warpgroup's scratch, then one thread a column adding
    // those.
    const int t = tid % WG, ch = t % CH;
    float* part = reinterpret_cast<float*>(ring_p + STAGES * L::STAGE) + wg * WG * 8;
    float sum[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
#pragma unroll 4
    for (int key = t / CH; key < S; key += WG / CH) {
      uint4 x = *reinterpret_cast<const uint4*>(vp + (size_t)key * HD + ch * 8);
      const __nv_bfloat162* e = reinterpret_cast<const __nv_bfloat162*>(&x);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float2 f = __bfloat1622float2(e[u]);
        sum[2 * u] += f.x;
        sum[2 * u + 1] += f.y;
      }
    }
#pragma unroll
    for (int u = 0; u < 8; ++u) part[t * 8 + u] = sum[u];
    bar_sync(group_id(wg), WG);
    const float padded_len = (float)((S + PAD_BUCKET - 1) / PAD_BUCKET * PAD_BUCKET);
    for (int c = t; c < HD; c += WG) {
      float total = 0.f;
      for (int u = c / 8; u < WG; u += CH) total += part[u * 8 + c % 8];
      v_mean[wg][c] = total / padded_len;
    }
    bar_sync(group_id(wg), WG);
  }

  if (lse != nullptr && lane % 4 == 0) {
    float* lp = lse + (size_t)bh * S;
    if (r0 < S) lp[r0] = empty0 ? INFINITY : (m0 + log2f(l0)) / LOG2E;
    if (r1 < S) lp[r1] = empty1 ? INFINITY : (m1 + log2f(l1)) / LOG2E;
  }

  const float inv0 = l0 > 0.f ? 1.f / l0 : 0.f;
  const float inv1 = l1 > 0.f ? 1.f / l1 : 0.f;
  bf16* op = o + (size_t)bh * S * HD;
#pragma unroll
  for (int i = 0; i < HD / 2; i += 2) {
    const bool second = (i & 2) != 0;
    const int row = second ? r1 : r0;
    if (row < S) {
      const int c = acc_col(i, lane);
      const float inv = second ? inv1 : inv0;
      *reinterpret_cast<uint32_t*>(op + (size_t)row * HD + c) =
          (second ? empty1 : empty0) ? pack_bf16(v_mean[wg][c], v_mean[wg][c + 1])
                                     : pack_bf16(acc[i] * inv, acc[i + 1] * inv);
    }
  }
}

template <int HD, int HEADS>
int launch(const void* q, const void* k, const void* v, const void* kv_valid, void* o,
           void* lse, int B, int H, int kvH, int S, float scale, cudaStream_t stream) {
  constexpr int smem = FwdSmem<HD, HEADS>::BYTES;
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel<HD, HEADS>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int BH = B * H;
  flash_fwd_kernel<HD, HEADS><<<((S + QB - 1) / QB) * (BH / HEADS), (HEADS + 1) * WG, smem, stream>>>(
      reinterpret_cast<const bf16*>(q), reinterpret_cast<const bf16*>(k),
      reinterpret_cast<const bf16*>(v), reinterpret_cast<const int*>(kv_valid),
      reinterpret_cast<bf16*>(o), reinterpret_cast<float*>(lse), BH, H, kvH, S, scale);
  return (int)cudaGetLastError();
}

// Two query heads a block where a GQA group holds an even number of them.
template <int HD>
int launch_any(const void* q, const void* k, const void* v, const void* kv_valid, void* o,
               void* lse, int B, int H, int kvH, int S, float scale, cudaStream_t stream) {
  if ((H / kvH) % 2 == 0) return launch<HD, 2>(q, k, v, kv_valid, o, lse, B, H, kvH, S, scale, stream);
  return launch<HD, 1>(q, k, v, kv_valid, o, lse, B, H, kvH, S, scale, stream);
}

// Registers a thread, dynamic shared memory a block and resident blocks an
// SM of the two-head form (the main path's).
template <int HD>
int kernel_resources(int* out) {
  constexpr int smem = FwdSmem<HD, 2>::BYTES;
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel<HD, 2>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, flash_fwd_kernel<HD, 2>);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[2], flash_fwd_kernel<HD, 2>, 3 * WG, smem);
  out[0] = attr.numRegs;
  out[1] = smem;
  return (int)err;
}

}  // namespace

extern "C" {

// q, o: (B, H, S, hd) bf16 contiguous; k, v: (B, kvH, S, hd) bf16
// contiguous with H % kvH == 0; hd 64 or 128; kv_valid: (B, S) int32 or NULL
// (all valid); lse: (B, H, S) fp32 or NULL (not written).  scale: the
// softmax scale already rounded to bf16.  Returns cudaGetLastError(), or
// cudaErrorInvalidValue for another hd.
int flash_attention_fwd_bf16(const void* q, const void* k, const void* v,
                             const void* kv_valid, void* o, void* lse, int B,
                             int H, int kvH, int S, int hd, float scale,
                             void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (hd == 128) return launch_any<128>(q, k, v, kv_valid, o, lse, B, H, kvH, S, scale, st);
  if (hd == 64) return launch_any<64>(q, k, v, kv_valid, o, lse, B, H, kvH, S, scale, st);
  return (int)cudaErrorInvalidValue;
}

// Resources of the kernel at head dim hd, for reports: out[0..2] =
// registers a thread, dynamic shared memory bytes a block and resident
// blocks an SM.
int flash_attention_fwd_resources(int hd, int* out) {
  if (hd == 128) return kernel_resources<128>(out);
  if (hd == 64) return kernel_resources<64>(out);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
