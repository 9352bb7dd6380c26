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
// Design, kept simple (FlashAttention-2's register layout without its
// pipelining): one block of 4 warps per (b, h, 64-query tile); each warp owns
// 16 query rows and keeps its Q fragments, running max, running sum and O
// accumulator in registers.  K tiles (64 x hd) sit in shared memory
// row-major, V tiles transposed, both padded by 8 elements a row so fragment
// reads hit distinct banks.  Products are mma.sync m16n8k16 (bf16 in, fp32
// accumulate); the QK^T accumulator layout is reused as the PV A-operand
// without a shared-memory round trip.  The key loop stops at the tile holding
// the block's last query.
//
// Optional output for the backward (csrc/flash_attention_bwd.cu): lse, the
// fp32 natural-log logsumexp of each row's scaled, masked logits, (B, H, S);
// +inf for a row with no valid key, so the backward's rebuilt weights are 0
// there.  With a null pointer nothing extra is written.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;       // queries per block (16 per warp)
constexpr int BN = 64;       // keys per tile
constexpr int VS = BN + 8;   // transposed-V row stride (elements)
constexpr int THREADS = 128;
constexpr int PAD_BUCKET = 128;  // the JAX wrapper's sequence padding
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&p);
}

// d += a * b for one m16n8k16 tile (A row-major 16x16, B column-major 16x8).
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Two neighbouring q elements of row r, scaled in bf16 (zero past the end).
template <int HD>
__device__ __forceinline__ uint32_t load_q_pair(const __nv_bfloat16* qp, int r,
                                                int c, int S, float scale) {
  if (r >= S) return 0u;
  __nv_bfloat162 p =
      *reinterpret_cast<const __nv_bfloat162*>(qp + (size_t)r * HD + c);
  float2 f = __bfloat1622float2(p);
  return pack_bf16(f.x * scale, f.y * scale);
}

template <int HD>
__global__ void __launch_bounds__(THREADS)
    flash_fwd_kernel(const __nv_bfloat16* __restrict__ q,
                     const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v,
                     const int* __restrict__ kv_valid,
                     __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                     int H, int kvH, int S, float scale) {
  constexpr int KS = HD + 8;  // K row stride in shared memory (elements)
  __shared__ __align__(16) __nv_bfloat16 Ks[BN * KS];
  __shared__ __align__(16) __nv_bfloat16 Vt[HD * VS];
  __shared__ int key_ok[BN];
  __shared__ float v_mean[HD];
  __shared__ int any_empty;

  const int bh = blockIdx.y;
  const int b = bh / H;
  const int kvh = (bh % H) / (H / kvH);
  const __nv_bfloat16* qp = q + (size_t)bh * S * HD;
  const __nv_bfloat16* kp = k + (size_t)(b * kvH + kvh) * S * HD;
  const __nv_bfloat16* vp = v + (size_t)(b * kvH + kvh) * S * HD;
  __nv_bfloat16* op = o + (size_t)bh * S * HD;
  const int* valid = kv_valid ? kv_valid + (size_t)b * S : nullptr;

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;  // fragment row group
  const int t = lane & 3;   // thread within the group
  const int q0 = blockIdx.x * BM;
  const int r0 = q0 + warp * 16 + g;  // this thread's two query rows
  const int r1 = r0 + 8;
  if (threadIdx.x == 0) any_empty = 0;  // ordered by the loop's first barrier

  uint32_t qf[HD / 16][4];
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    const int c = kk * 16 + 2 * t;
    qf[kk][0] = load_q_pair<HD>(qp, r0, c, S, scale);
    qf[kk][1] = load_q_pair<HD>(qp, r1, c, S, scale);
    qf[kk][2] = load_q_pair<HD>(qp, r0, c + 8, S, scale);
    qf[kk][3] = load_q_pair<HD>(qp, r1, c + 8, S, scale);
  }

  float acc[HD / 8][4];
#pragma unroll
  for (int nd = 0; nd < HD / 8; ++nd) {
    acc[nd][0] = acc[nd][1] = acc[nd][2] = acc[nd][3] = 0.f;
  }
  float m0 = -INFINITY, m1 = -INFINITY;  // running max (log2 units)
  float l0 = 0.f, l1 = 0.f;              // running sum

  const int q_last = min(S, q0 + BM) - 1;
  const int n_tiles = q_last / BN + 1;
  for (int j = 0; j < n_tiles; ++j) {
    const int k0 = j * BN;
    __syncthreads();  // the previous tile's reads are done
    // K: coalesced 16-byte rows.  V: one key per thread, stored transposed.
    for (int i = threadIdx.x; i < BN * HD / 8; i += THREADS) {
      const int r = i / (HD / 8), c = (i % (HD / 8)) * 8;
      uint4 kv4 = make_uint4(0, 0, 0, 0);
      if (k0 + r < S) kv4 = *reinterpret_cast<const uint4*>(kp + (size_t)(k0 + r) * HD + c);
      *reinterpret_cast<uint4*>(Ks + r * KS + c) = kv4;
    }
    for (int i = threadIdx.x; i < BN * HD / 8; i += THREADS) {
      const int r = i % BN, c = (i / BN) * 8;
      uint4 vv = make_uint4(0, 0, 0, 0);
      if (k0 + r < S) vv = *reinterpret_cast<const uint4*>(vp + (size_t)(k0 + r) * HD + c);
      const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&vv);
#pragma unroll
      for (int u = 0; u < 8; ++u) Vt[(c + u) * VS + r] = e[u];
    }
    if (threadIdx.x < BN) {
      const int key = k0 + threadIdx.x;
      key_ok[threadIdx.x] = key < S && (valid == nullptr || valid[key] != 0);
    }
    __syncthreads();

    float s[BN / 8][4];
#pragma unroll
    for (int nt = 0; nt < BN / 8; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
#pragma unroll
      for (int nt = 0; nt < BN / 8; ++nt) {
        const __nv_bfloat16* kr = Ks + (nt * 8 + g) * KS + kk * 16 + 2 * t;
        mma_bf16(s[nt], qf[kk], ld32(kr), ld32(kr + 8));
      }
    }

    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int nt = 0; nt < BN / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kl = nt * 8 + 2 * t + (e & 1);
        const int row = e < 2 ? r0 : r1;
        const bool ok = key_ok[kl] && k0 + kl <= row;
        s[nt][e] = ok ? s[nt][e] * LOG2E : -INFINITY;
      }
      mx0 = fmaxf(mx0, fmaxf(s[nt][0], s[nt][1]));
      mx1 = fmaxf(mx1, fmaxf(s[nt][2], s[nt][3]));
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    // A row with no valid key yet keeps max -inf: subtract 0 instead, so
    // its p (all exp2(-inf)) and its alpha stay 0, never NaN.
    const float mu0 = mn0 == -INFINITY ? 0.f : mn0;
    const float mu1 = mn1 == -INFINITY ? 0.f : mn1;
    const float alpha0 = exp2f(m0 - mu0), alpha1 = exp2f(m1 - mu1);
    float ls0 = 0.f, ls1 = 0.f;
#pragma unroll
    for (int nt = 0; nt < BN / 8; ++nt) {
      s[nt][0] = exp2f(s[nt][0] - mu0);
      s[nt][1] = exp2f(s[nt][1] - mu0);
      s[nt][2] = exp2f(s[nt][2] - mu1);
      s[nt][3] = exp2f(s[nt][3] - mu1);
      ls0 += s[nt][0] + s[nt][1];
      ls1 += s[nt][2] + s[nt][3];
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
    for (int nd = 0; nd < HD / 8; ++nd) {
      acc[nd][0] *= alpha0;
      acc[nd][1] *= alpha0;
      acc[nd][2] *= alpha1;
      acc[nd][3] *= alpha1;
    }

#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
      uint32_t pa[4];
      pa[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      pa[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      pa[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      pa[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      for (int nd = 0; nd < HD / 8; ++nd) {
        const __nv_bfloat16* vr = Vt + (nd * 8 + g) * VS + kk * 16 + 2 * t;
        mma_bf16(acc[nd], pa, ld32(vr), ld32(vr + 8));
      }
    }
  }

  // Every row with a valid key has l >= 1 (its max contributes exp2(0)).
  const bool empty0 = r0 < S && l0 == 0.f;
  const bool empty1 = r1 < S && l1 == 0.f;
  if (empty0 || empty1) any_empty = 1;
  __syncthreads();
  if (any_empty) {
    // Rare (blocks holding leading pad queries): one column per thread,
    // summed over all S keys in fp32.
    const float padded_len = (float)((S + PAD_BUCKET - 1) / PAD_BUCKET * PAD_BUCKET);
    for (int c = threadIdx.x; c < HD; c += THREADS) {
      float sum = 0.f;
      for (int key = 0; key < S; ++key) sum += __bfloat162float(vp[(size_t)key * HD + c]);
      v_mean[c] = sum / padded_len;
    }
    __syncthreads();
  }

  if (lse != nullptr && t == 0) {
    float* lp = lse + (size_t)bh * S;
    if (r0 < S) lp[r0] = empty0 ? INFINITY : (m0 + log2f(l0)) / LOG2E;
    if (r1 < S) lp[r1] = empty1 ? INFINITY : (m1 + log2f(l1)) / LOG2E;
  }

  const float inv0 = l0 > 0.f ? 1.f / l0 : 0.f;
  const float inv1 = l1 > 0.f ? 1.f / l1 : 0.f;
#pragma unroll
  for (int nd = 0; nd < HD / 8; ++nd) {
    const int c = nd * 8 + 2 * t;
    if (r0 < S)
      *reinterpret_cast<uint32_t*>(op + (size_t)r0 * HD + c) =
          empty0 ? pack_bf16(v_mean[c], v_mean[c + 1])
                 : pack_bf16(acc[nd][0] * inv0, acc[nd][1] * inv0);
    if (r1 < S)
      *reinterpret_cast<uint32_t*>(op + (size_t)r1 * HD + c) =
          empty1 ? pack_bf16(v_mean[c], v_mean[c + 1])
                 : pack_bf16(acc[nd][2] * inv1, acc[nd][3] * inv1);
  }
}

template <int HD>
int launch(const void* q, const void* k, const void* v, const void* kv_valid,
           void* o, void* lse, int B, int H, int kvH, int S, float scale,
           void* stream) {
  dim3 grid((S + BM - 1) / BM, B * H);
  flash_fwd_kernel<HD><<<grid, THREADS, 0, reinterpret_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const __nv_bfloat16*>(q),
      reinterpret_cast<const __nv_bfloat16*>(k),
      reinterpret_cast<const __nv_bfloat16*>(v),
      reinterpret_cast<const int*>(kv_valid),
      reinterpret_cast<__nv_bfloat16*>(o), reinterpret_cast<float*>(lse), H, kvH,
      S, scale);
  return (int)cudaGetLastError();
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
  if (hd == 128) return launch<128>(q, k, v, kv_valid, o, lse, B, H, kvH, S, scale, stream);
  if (hd == 64) return launch<64>(q, k, v, kv_valid, o, lse, B, H, kvH, S, scale, stream);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
