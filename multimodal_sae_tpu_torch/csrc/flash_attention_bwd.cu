// Causal flash-attention backward over (B, H, S, hd) bf16, hd 64 or 128, with
// grouped key/value heads and an optional key pad mask: dq, dk, dv from q, k,
// v, the forward's output o, its row logsumexp lse and the output gradient do.
//
// Replaces the backward of jax's shipped Pallas TPU kernel
// (jax.experimental.pallas.ops.tpu.flash_attention: _flash_attention_bwd_dkv
// and _flash_attention_bwd_dq), the custom VJP of the attention that
// multimodal_sae_tpu/models/llama.py::flash_attention calls.
//
// Semantics, those of jax's mha_reference_bwd: with qs = bf16(q * scale) (the
// forward folds the scale into q in bf16), s = qs . k over keys j <= i with
// kv_valid[b, j] != 0, and P = exp(s - lse) rebuilt from the saved lse:
//   dv = P^T do,  dp = do v^T,  D = rowsum(o * do),  ds = P (dp - D),
//   dk = ds^T qs,  dq = bf16(bf16(ds k) * scale)
// (dq is taken with respect to the unscaled q, through the bf16 multiply by
// the scale, rounded twice as the JAX side rounds it).  dk and dv of kv head
// g sum over its H / kvH query heads in fp32.  A row with no valid key (a
// leading pad query under left padding) has lse = +inf: its P is 0, so it
// gets dq = 0 and adds nothing to dk or dv.  jax's reference spreads such a
// row's do over all keys instead; the two agree whenever do is 0 on those
// rows, which is what every caller gives them (no real position reads them).
//
// Bound on an H100: tensor-core operations, 5 products of 2 * hd per causal
// (query, valid key) pair (QK^T, dO V^T, P^T dO, dS^T Q, dS K) over
// 989 TFLOP/s, about 0.98 ms at B=8, H=32, S=2432, hd=128.
// Design, kept simple (FlashAttention-2's split without its pipelining):
// three kernels, each launched by its own C entry point.  (1) D =
// rowsum(o * do) in fp32, one warp per row.
// (2) dK/dV: one block of 4 warps per (b, kv head, 64-key tile), each warp
// owning 16 keys whose dK and dV accumulate in fp32 registers; it loops over
// the H / kvH query heads of its group and over 32-query tiles from the
// diagonal down, recomputing S^T = K Q^T and P^T from lse.  No atomics, so
// the result is deterministic.  (3) dQ: one block per (b, h, 64-query tile),
// 16 query rows a warp, looping over the key tiles up to the diagonal.
// Products are mma.sync m16n8k16 (bf16 in, fp32 accumulate); P and dS are
// rounded to bf16 as the A operand of the products that consume them.  Tiles
// whose fragments are read along the other axis are stored transposed in
// shared memory (rows padded by 8 elements, so fragment reads hit distinct
// banks).  No cp.async/TMA, no wgmma.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;
constexpr int KB = 64;   // dK/dV kernel: keys per block (16 per warp)
constexpr int QT = 32;   // dK/dV kernel: queries per tile
constexpr int QB = 64;   // dQ kernel: queries per block (16 per warp)
constexpr int KT = 64;   // dQ kernel: keys per tile
constexpr float LOG2E = 1.4426950408889634f;

typedef __nv_bfloat16 bf16;

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

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// The A fragment of rows [row0, row0 + 16) and columns [c0, c0 + 16) of a
// row-major shared tile with row stride `ld` (elements).
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const bf16* base, int ld,
                                       int row0, int c0, int g, int t) {
  const bf16* p = base + (row0 + g) * ld + c0 + 2 * t;
  a[0] = ld32(p);
  a[1] = ld32(p + 8 * ld);
  a[2] = ld32(p + 8);
  a[3] = ld32(p + 8 * ld + 8);
}

// Accumulator tiles c[2 kk], c[2 kk + 1] (16 x 16) as a bf16 A fragment.
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[4], const float (&c0)[4],
                                         const float (&c1)[4]) {
  a[0] = pack_bf16(c0[0], c0[1]);
  a[1] = pack_bf16(c0[2], c0[3]);
  a[2] = pack_bf16(c1[0], c1[1]);
  a[3] = pack_bf16(c1[2], c1[3]);
}

// Copy rows [r0, r0 + rows) of a (S, HD) bf16 matrix into shared memory,
// row-major with stride `ld` and/or transposed ([HD][rows + 8]), zero past S,
// multiplied by `scale` in bf16 when `scaled`.
template <int HD>
__device__ __forceinline__ void load_tile(const bf16* src, int r0, int rows, int S,
                                          bf16* row_major, int ld, bf16* transposed,
                                          bool scaled, float scale) {
  const int tld = rows + 8;
  for (int i = threadIdx.x; i < rows * HD / 8; i += THREADS) {
    const int r = i / (HD / 8), c = (i % (HD / 8)) * 8;
    uint4 v4 = make_uint4(0, 0, 0, 0);
    if (r0 + r < S) v4 = *reinterpret_cast<const uint4*>(src + (size_t)(r0 + r) * HD + c);
    bf16* e = reinterpret_cast<bf16*>(&v4);
    if (scaled) {
#pragma unroll
      for (int u = 0; u < 8; ++u) e[u] = __float2bfloat16(__bfloat162float(e[u]) * scale);
    }
    if (row_major) *reinterpret_cast<uint4*>(row_major + r * ld + c) = v4;
    if (transposed) {
#pragma unroll
      for (int u = 0; u < 8; ++u) transposed[(c + u) * tld + r] = e[u];
    }
  }
}

// D[row] = sum_c o[row, c] * do[row, c] in fp32, one warp per row.
__global__ void __launch_bounds__(THREADS)
    delta_kernel(const bf16* __restrict__ o, const bf16* __restrict__ dout,
                 float* __restrict__ delta, int rows, int hd) {
  const int row = blockIdx.x * (THREADS / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  const bf16* op = o + (size_t)row * hd;
  const bf16* dp = dout + (size_t)row * hd;
  float s = 0.f;
  for (int c = 2 * lane; c < hd; c += 64) {
    const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(op + c));
    const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(dp + c));
    s += a.x * b.x + a.y * b.y;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
  if (lane == 0) delta[row] = s;
}

template <int HD>
constexpr int dkdv_smem_bytes() {
  // Ks, Vs (KB x (HD + 8)); Qs, dOs (QT x (HD + 8)); Qt, dOt (HD x (QT + 8));
  // lse, D (QT floats); key_ok (KB ints).
  return (2 * KB * (HD + 8) + 2 * QT * (HD + 8) + 2 * HD * (QT + 8)) * 2 +
         (2 * QT + KB) * 4;
}

template <int HD>
__global__ void __launch_bounds__(THREADS)
    dkdv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                const bf16* __restrict__ v, const int* __restrict__ kv_valid,
                const float* __restrict__ lse, const bf16* __restrict__ dout,
                const float* __restrict__ delta, bf16* __restrict__ dk,
                bf16* __restrict__ dv, int H, int kvH, int S, float scale) {
  constexpr int LD = HD + 8;   // row-major stride
  constexpr int TLD = QT + 8;  // transposed stride
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* Ks = reinterpret_cast<bf16*>(smem);
  bf16* Vs = Ks + KB * LD;
  bf16* Qs = Vs + KB * LD;
  bf16* dOs = Qs + QT * LD;
  bf16* Qt = dOs + QT * LD;
  bf16* dOt = Qt + HD * TLD;
  float* lse_s = reinterpret_cast<float*>(dOt + HD * TLD);
  float* d_s = lse_s + QT;
  int* key_ok = reinterpret_cast<int*>(d_s + QT);

  const int bk = blockIdx.y;  // b * kvH + kv head
  const int b = bk / kvH;
  const int kvh = bk % kvH;
  const int rep = H / kvH;
  const int k0 = blockIdx.x * KB;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int wrow = warp * 16;  // this warp's first key row in the tile

  load_tile<HD>(k + (size_t)bk * S * HD, k0, KB, S, Ks, LD, nullptr, false, 0.f);
  load_tile<HD>(v + (size_t)bk * S * HD, k0, KB, S, Vs, LD, nullptr, false, 0.f);
  if (threadIdx.x < KB) {
    const int key = k0 + threadIdx.x;
    key_ok[threadIdx.x] =
        key < S && (kv_valid == nullptr || kv_valid[(size_t)b * S + key] != 0);
  }

  float dk_acc[HD / 8][4], dv_acc[HD / 8][4];
#pragma unroll
  for (int nd = 0; nd < HD / 8; ++nd) {
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[nd][e] = dv_acc[nd][e] = 0.f;
  }

  for (int hr = 0; hr < rep; ++hr) {
    const int bh = b * H + kvh * rep + hr;
    const bf16* qp = q + (size_t)bh * S * HD;
    const bf16* dop = dout + (size_t)bh * S * HD;
    for (int q0 = (k0 / QT) * QT; q0 < S; q0 += QT) {
      __syncthreads();  // the previous tile's reads are done
      load_tile<HD>(qp, q0, QT, S, Qs, LD, Qt, true, scale);
      load_tile<HD>(dop, q0, QT, S, dOs, LD, dOt, false, 0.f);
      if (threadIdx.x < QT) {
        const int i = q0 + threadIdx.x;
        lse_s[threadIdx.x] = i < S ? lse[(size_t)bh * S + i] : INFINITY;
        d_s[threadIdx.x] = i < S ? delta[(size_t)bh * S + i] : 0.f;
      }
      __syncthreads();

      // S^T (16 keys x 32 queries a warp) and dP^T = V dO^T.
      float st[QT / 8][4], dpt[QT / 8][4];
#pragma unroll
      for (int nq = 0; nq < QT / 8; ++nq) {
#pragma unroll
        for (int e = 0; e < 4; ++e) st[nq][e] = dpt[nq][e] = 0.f;
      }
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        uint32_t ka[4], va[4];
        load_a(ka, Ks, LD, wrow, kk * 16, g, t);
        load_a(va, Vs, LD, wrow, kk * 16, g, t);
#pragma unroll
        for (int nq = 0; nq < QT / 8; ++nq) {
          const bf16* qr = Qs + (nq * 8 + g) * LD + kk * 16 + 2 * t;
          mma_bf16(st[nq], ka, ld32(qr), ld32(qr + 8));
          const bf16* dr = dOs + (nq * 8 + g) * LD + kk * 16 + 2 * t;
          mma_bf16(dpt[nq], va, ld32(dr), ld32(dr + 8));
        }
      }
      // P^T from lse, and dS^T = P^T (dP^T - D).
#pragma unroll
      for (int nq = 0; nq < QT / 8; ++nq) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kl = wrow + g + (e >= 2 ? 8 : 0);
          const int ql = nq * 8 + 2 * t + (e & 1);
          const bool ok = key_ok[kl] && k0 + kl <= q0 + ql;
          const float p = ok ? exp2f((st[nq][e] - lse_s[ql]) * LOG2E) : 0.f;
          st[nq][e] = p;
          dpt[nq][e] = p * (dpt[nq][e] - d_s[ql]);
        }
      }
      // dV += P^T dO and dK += dS^T Qs, over the tile's 32 queries.
#pragma unroll
      for (int kq = 0; kq < QT / 16; ++kq) {
        uint32_t pa[4], sa[4];
        acc_to_a(pa, st[2 * kq], st[2 * kq + 1]);
        acc_to_a(sa, dpt[2 * kq], dpt[2 * kq + 1]);
#pragma unroll
        for (int nd = 0; nd < HD / 8; ++nd) {
          const bf16* dr = dOt + (nd * 8 + g) * TLD + kq * 16 + 2 * t;
          mma_bf16(dv_acc[nd], pa, ld32(dr), ld32(dr + 8));
          const bf16* qr = Qt + (nd * 8 + g) * TLD + kq * 16 + 2 * t;
          mma_bf16(dk_acc[nd], sa, ld32(qr), ld32(qr + 8));
        }
      }
    }
  }

  const int r0 = k0 + wrow + g, r1 = r0 + 8;
  bf16* dkp = dk + (size_t)bk * S * HD;
  bf16* dvp = dv + (size_t)bk * S * HD;
#pragma unroll
  for (int nd = 0; nd < HD / 8; ++nd) {
    const int c = nd * 8 + 2 * t;
    if (r0 < S) {
      *reinterpret_cast<uint32_t*>(dkp + (size_t)r0 * HD + c) = pack_bf16(dk_acc[nd][0], dk_acc[nd][1]);
      *reinterpret_cast<uint32_t*>(dvp + (size_t)r0 * HD + c) = pack_bf16(dv_acc[nd][0], dv_acc[nd][1]);
    }
    if (r1 < S) {
      *reinterpret_cast<uint32_t*>(dkp + (size_t)r1 * HD + c) = pack_bf16(dk_acc[nd][2], dk_acc[nd][3]);
      *reinterpret_cast<uint32_t*>(dvp + (size_t)r1 * HD + c) = pack_bf16(dv_acc[nd][2], dv_acc[nd][3]);
    }
  }
}

template <int HD>
constexpr int dq_smem_bytes() {
  // Qs, dOs (QB x (HD + 8)); Ks, Vs (KT x (HD + 8)); Kt (HD x (KT + 8));
  // key_ok (KT ints).
  return (2 * QB * (HD + 8) + 2 * KT * (HD + 8) + HD * (KT + 8)) * 2 + KT * 4;
}

template <int HD>
__global__ void __launch_bounds__(THREADS)
    dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
              const bf16* __restrict__ v, const int* __restrict__ kv_valid,
              const float* __restrict__ lse, const bf16* __restrict__ dout,
              const float* __restrict__ delta, bf16* __restrict__ dq, int H,
              int kvH, int S, float scale) {
  constexpr int LD = HD + 8;
  constexpr int TLD = KT + 8;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* dOs = Qs + QB * LD;
  bf16* Ks = dOs + QB * LD;
  bf16* Vs = Ks + KT * LD;
  bf16* Kt = Vs + KT * LD;
  int* key_ok = reinterpret_cast<int*>(Kt + HD * TLD);

  const int bh = blockIdx.y;
  const int b = bh / H;
  const int kvh = (bh % H) / (H / kvH);
  const bf16* kp = k + (size_t)(b * kvH + kvh) * S * HD;
  const bf16* vp = v + (size_t)(b * kvH + kvh) * S * HD;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int q0 = blockIdx.x * QB;
  const int wrow = warp * 16;
  const int r0 = q0 + wrow + g, r1 = r0 + 8;

  load_tile<HD>(q + (size_t)bh * S * HD, q0, QB, S, Qs, LD, nullptr, true, scale);
  load_tile<HD>(dout + (size_t)bh * S * HD, q0, QB, S, dOs, LD, nullptr, false, 0.f);
  const float lse0 = r0 < S ? lse[(size_t)bh * S + r0] : INFINITY;
  const float lse1 = r1 < S ? lse[(size_t)bh * S + r1] : INFINITY;
  const float d0 = r0 < S ? delta[(size_t)bh * S + r0] : 0.f;
  const float d1 = r1 < S ? delta[(size_t)bh * S + r1] : 0.f;

  float acc[HD / 8][4];
#pragma unroll
  for (int nd = 0; nd < HD / 8; ++nd) acc[nd][0] = acc[nd][1] = acc[nd][2] = acc[nd][3] = 0.f;

  const int q_last = min(S, q0 + QB) - 1;
  const int n_tiles = q_last / KT + 1;
  for (int j = 0; j < n_tiles; ++j) {
    const int k0 = j * KT;
    __syncthreads();  // the previous tile's reads are done
    load_tile<HD>(kp, k0, KT, S, Ks, LD, Kt, false, 0.f);
    load_tile<HD>(vp, k0, KT, S, Vs, LD, nullptr, false, 0.f);
    if (threadIdx.x < KT) {
      const int key = k0 + threadIdx.x;
      key_ok[threadIdx.x] =
          key < S && (kv_valid == nullptr || kv_valid[(size_t)b * S + key] != 0);
    }
    __syncthreads();

    float s[KT / 8][4], dp[KT / 8][4];
#pragma unroll
    for (int nt = 0; nt < KT / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = dp[nt][e] = 0.f;
    }
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      uint32_t qa[4], da[4];
      load_a(qa, Qs, LD, wrow, kk * 16, g, t);
      load_a(da, dOs, LD, wrow, kk * 16, g, t);
#pragma unroll
      for (int nt = 0; nt < KT / 8; ++nt) {
        const bf16* kr = Ks + (nt * 8 + g) * LD + kk * 16 + 2 * t;
        mma_bf16(s[nt], qa, ld32(kr), ld32(kr + 8));
        const bf16* vr = Vs + (nt * 8 + g) * LD + kk * 16 + 2 * t;
        mma_bf16(dp[nt], da, ld32(vr), ld32(vr + 8));
      }
    }
#pragma unroll
    for (int nt = 0; nt < KT / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kl = nt * 8 + 2 * t + (e & 1);
        const int row = e < 2 ? r0 : r1;
        const float l = e < 2 ? lse0 : lse1;
        const float d = e < 2 ? d0 : d1;
        const bool ok = key_ok[kl] && k0 + kl <= row;
        const float p = ok ? exp2f((s[nt][e] - l) * LOG2E) : 0.f;
        s[nt][e] = p * (dp[nt][e] - d);  // dS
      }
    }
#pragma unroll
    for (int kk = 0; kk < KT / 16; ++kk) {
      uint32_t sa[4];
      acc_to_a(sa, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
      for (int nd = 0; nd < HD / 8; ++nd) {
        const bf16* kr = Kt + (nd * 8 + g) * TLD + kk * 16 + 2 * t;
        mma_bf16(acc[nd], sa, ld32(kr), ld32(kr + 8));
      }
    }
  }

  // dq = bf16(bf16(dS K) * scale): the VJP of the forward's bf16 q * scale.
  bf16* dqp = dq + (size_t)bh * S * HD;
  const bf16 scale_b = __float2bfloat16(scale);
#pragma unroll
  for (int nd = 0; nd < HD / 8; ++nd) {
    const int c = nd * 8 + 2 * t;
    __nv_bfloat162 lo = __floats2bfloat162_rn(acc[nd][0], acc[nd][1]);
    __nv_bfloat162 hi = __floats2bfloat162_rn(acc[nd][2], acc[nd][3]);
    const __nv_bfloat162 sc = __halves2bfloat162(scale_b, scale_b);
    lo = __hmul2(lo, sc);
    hi = __hmul2(hi, sc);
    if (r0 < S) *reinterpret_cast<__nv_bfloat162*>(dqp + (size_t)r0 * HD + c) = lo;
    if (r1 < S) *reinterpret_cast<__nv_bfloat162*>(dqp + (size_t)r1 * HD + c) = hi;
  }
}

template <int HD>
int launch_dkdv(const void* q, const void* k, const void* v, const void* kv_valid,
                const void* lse, const void* dout, const void* delta, void* dk,
                void* dv, int B, int H, int kvH, int S, float scale,
                cudaStream_t stream) {
  constexpr int smem = dkdv_smem_bytes<HD>();
  cudaError_t err =
      cudaFuncSetAttribute(dkdv_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((S + KB - 1) / KB, B * kvH);
  dkdv_kernel<HD><<<grid, THREADS, smem, stream>>>(
      reinterpret_cast<const bf16*>(q), reinterpret_cast<const bf16*>(k),
      reinterpret_cast<const bf16*>(v), reinterpret_cast<const int*>(kv_valid),
      reinterpret_cast<const float*>(lse), reinterpret_cast<const bf16*>(dout),
      reinterpret_cast<const float*>(delta), reinterpret_cast<bf16*>(dk),
      reinterpret_cast<bf16*>(dv), H, kvH, S, scale);
  return (int)cudaGetLastError();
}

template <int HD>
int launch_dq(const void* q, const void* k, const void* v, const void* kv_valid,
              const void* lse, const void* dout, const void* delta, void* dq, int B,
              int H, int kvH, int S, float scale, cudaStream_t stream) {
  constexpr int smem = dq_smem_bytes<HD>();
  cudaError_t err =
      cudaFuncSetAttribute(dq_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((S + QB - 1) / QB, B * H);
  dq_kernel<HD><<<grid, THREADS, smem, stream>>>(
      reinterpret_cast<const bf16*>(q), reinterpret_cast<const bf16*>(k),
      reinterpret_cast<const bf16*>(v), reinterpret_cast<const int*>(kv_valid),
      reinterpret_cast<const float*>(lse), reinterpret_cast<const bf16*>(dout),
      reinterpret_cast<const float*>(delta), reinterpret_cast<bf16*>(dq), H, kvH, S,
      scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// o, do: (rows, hd) bf16 contiguous, hd 64 or 128; delta: (rows,) fp32.
// Launches the D pass, delta[r] = sum_c o[r, c] * do[r, c].  Returns a CUDA
// error code (0 on success), or cudaErrorInvalidValue for another hd.
int flash_attention_bwd_delta_bf16(const void* o, const void* dout, void* delta, int rows,
                                   int hd, void* stream) {
  if (hd != 128 && hd != 64) return (int)cudaErrorInvalidValue;
  delta_kernel<<<(rows + THREADS / 32 - 1) / (THREADS / 32), THREADS, 0,
                 reinterpret_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const bf16*>(o), reinterpret_cast<const bf16*>(dout),
      reinterpret_cast<float*>(delta), rows, hd);
  return (int)cudaGetLastError();
}

// q, do: (B, H, S, hd) bf16 contiguous; k, v, dk, dv: (B, kvH, S, hd) bf16
// contiguous with H % kvH == 0; hd 64 or 128; kv_valid: (B, S) int32 or NULL
// (all valid); lse, delta: (B, H, S) fp32, delta from the D pass.  scale: the
// softmax scale already rounded to bf16.  Launches the dK/dV kernel.
// Returns a CUDA error code (0 on success), or cudaErrorInvalidValue for
// another hd.
int flash_attention_bwd_dkdv_bf16(const void* q, const void* k, const void* v,
                                  const void* kv_valid, const void* lse, const void* dout,
                                  const void* delta, void* dk, void* dv, int B, int H,
                                  int kvH, int S, int hd, float scale, void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (hd == 128)
    return launch_dkdv<128>(q, k, v, kv_valid, lse, dout, delta, dk, dv, B, H, kvH, S, scale, st);
  if (hd == 64)
    return launch_dkdv<64>(q, k, v, kv_valid, lse, dout, delta, dk, dv, B, H, kvH, S, scale, st);
  return (int)cudaErrorInvalidValue;
}

// Shapes as above; delta from the D pass; dq:
// (B, H, S, hd) bf16, the gradient with respect to the unscaled q.
int flash_attention_bwd_dq_bf16(const void* q, const void* k, const void* v,
                                const void* kv_valid, const void* lse, const void* dout,
                                const void* delta, void* dq, int B, int H, int kvH, int S,
                                int hd, float scale, void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (hd == 128) return launch_dq<128>(q, k, v, kv_valid, lse, dout, delta, dq, B, H, kvH, S, scale, st);
  if (hd == 64) return launch_dq<64>(q, k, v, kv_valid, lse, dout, delta, dq, B, H, kvH, S, scale, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
