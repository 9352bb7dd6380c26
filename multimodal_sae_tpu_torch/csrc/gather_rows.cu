// Row gather of a (L, d) matrix, in four modes:
//   gather_rows:   out[m] = W[idx[m]]                        (any element type)
//   gather_decode: y[n]   = sum_j vals[n, j] * W[idx[n, j]]  (fp32 or bf16 W)
//   splice_decode: an attribution chunk's F corrupted SAE splices, read from
//                  one top-(k+1) pool per token (below)
//   decode_dvals:  dvals[n, j] = g[n] . W[idx[n, j]]         (the decode's
//                  backward for its values, below)
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
// Bound on an H100.  Copy mode: bytes, M rows in and out over 3.35 TB/s.
// The decode and dvals modes: the larger of the bytes (each distinct row of
// W that idx names read once, plus idx, vals or g and the output, over 3.35
// TB/s) and the FMAs (N * k * d in fp32 over 33.5 T FMA/s, the CUDA cores'
// 67 TFLOP/s).  Copy mode walks the (M, d / vec) vectors grid-stride with
// 16-byte loads and stores.
//
// The L2 cache.  Tokens share rows: one prompt's 2,432 tokens at k = 256
// name about 21k distinct rows of 131,072 for their 622k (token, j) pairs.
// A kernel that reads each pair's row for its token alone (the first design,
// kept below as the direct path) reads N * k rows, 10.2 GB there, and runs at
// the rate of the L2 cache (50 MB) that keeps most of them from HBM, about 7
// TB/s.  So the decode mode takes tiles of T consecutive tokens and stages
// the rows a tile shares in shared memory once, where every token of the
// tile reads them.  A 128-byte slice of 227 KB holds under 1,800 rows, while
// a tile of 32 prompt tokens names about 2,900: the ROWS (900) most used are
// staged and the others read for their pair alone.  The dvals mode keeps the
// first design (below).
//
// Tiles (tile_union_kernel, one block a tile, T * k <= 8192).  The block
// sorts the tile's (row, pair) keys (32 bits when L <= 2^19) with a bitonic
// sort whose small strides run in registers, finds each distinct row and the
// number of pairs that name it, and stages the `cap` most used (counts
// above CMAX rank alike; ties by row): warp ballots count the rows of each
// use count and one warp finds the count at the cut.  The staged rows are
// listed in row order (`rows`); each pair gets a code (`code`, (N, k)): its
// row's slot when staged, -(row + 1) when not, INVALID for a row outside [0,
// L).  info[4 * tile ...]: the staged count, whether the tile takes the
// staged path (its staged rows cover at least MIN_COVER percent of its
// valid pairs), the number of distinct rows and the pairs covered.  A tile
// whose rows are seldom shared (uniform random indices) takes the direct
// path and loses only the pre-pass.  For the decode the pre-pass also writes
// each step's (code, value) token-minor (`meta`) and, for each chunk of DJ
// steps and each warp's four tokens, the rows of the pairs not staged
// (`trows`, up to TR; their code becomes ROWS + place; any past TR keep
// -(row + 1)).  Sorts, scans and ballots, no atomics: equal inputs give
// equal codes.  The decode's tile (decode_tile) keeps a tile's (chunk, warp)
// items to SLOTS, so that every k fits one shared-memory layout; its scratch
// (decode_scratch) is one int32 buffer that the caller allocates at the size
// gather_decode_scratch reports.
//
// gather_decode.  The contract is bits: each output element is the fp32
// chain acc = fmaf(vals[n, j], W[idx[n, j], c], acc) for j = 0 .. k-1 in
// order, from 0.f, a row outside [0, L) skipped, packed to W's type.  The
// splice mode computes its hit rows with the same chain and is held equal to
// this mode bit for bit, so no other order is allowed: no tensor-core or
// TF32 product, no row-centric scatter, no atomics.  Staged path
// (decode_tile_kernel): one block per (tile, 128-byte slice of a row), a
// warp per four tokens, a thread per (token, 16-byte vector).  The block
// copies the tile's row ids into shared memory, then its staged rows'
// slices, with cp.async, and meets once at a barrier.  Then each warp runs
// alone: it copies its own chunks' transient rows and (code, value)s with
// cp.async two chunks ahead and waits for them with __syncwarp, so that no
// warp waits for another; in a chunk every load issues before the FMAs,
// which run in step order.  A step past a chunk's TR transient rows reads
// W directly.  Direct path (gather_decode_kernel, the first design): one
// block of 256 threads per token (and per 1,024 vectors of d) reads the
// token's rows with 16-byte loads, its idx and vals staged 256 at a time, in
// the same chain.  Either way equal inputs give equal bits.
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
//
// decode_dvals.  The backward of the SAE decode for its values
// (multimodal_sae_tpu/ops/sparse_decode.py::_sparse_decode_bwd, dvals as an
// einsum over the gathered rows): dvals[n, j] = sum_d g[n, d] * W[idx[n, j],
// d], g fp32, W fp32 or bf16, summed in fp32, written in O (the dtype of the
// decode's values).  An index outside [0, L) gives 0.
// Bound on an H100: the larger of the bytes (each distinct row of W that idx
// names, g, idx and the output, over 3.35 TB/s) and the FMAs (N * k * d in
// fp32 over 33.5 T FMA/s).
// Design, kept simple: one block of 256 threads (8 warps) per token holds
// g[n] in shared memory; each warp takes four of the token's rows at a time
// (rows j0 .. j0 + 3, then 32 rows on), its lanes reading 16-byte vectors of
// them through the read-only path as the splice does, all four rows in
// flight while the FMAs run; each lane sums its vectors in column order and
// the warp adds its lanes with a fixed butterfly of shuffles.  No atomics:
// equal inputs give equal bits.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "sm90.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int VPT = 4;       // direct decode: 16-byte vectors per thread
constexpr int KCHUNK = 256;  // direct decode: (idx, vals) staged per round

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
  // acc + sum_i g[i] * u[i], in order i = 0 .. N-1; g 16-byte aligned.
  __device__ static float dot(float acc, const float* g, const uint4& u) {
    const float4 gv = *reinterpret_cast<const float4*>(g);
    const float* f = reinterpret_cast<const float*>(&u);
    acc = fmaf(gv.x, f[0], acc);
    acc = fmaf(gv.y, f[1], acc);
    acc = fmaf(gv.z, f[2], acc);
    return fmaf(gv.w, f[3], acc);
  }
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
  __device__ static float dot(float acc, const float* g, const uint4& u) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const float4 gv = reinterpret_cast<const float4*>(g)[half];
      const float2 a = __bfloat1622float2(h[2 * half]);
      const float2 b = __bfloat1622float2(h[2 * half + 1]);
      acc = fmaf(gv.x, a.x, acc);
      acc = fmaf(gv.y, a.y, acc);
      acc = fmaf(gv.z, b.x, acc);
      acc = fmaf(gv.w, b.y, acc);
    }
    return acc;
  }
  __device__ static uint4 pack(const float* acc) {
    uint4 u;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < N / 2; ++i) h[i] = __floats2bfloat162_rn(acc[2 * i], acc[2 * i + 1]);
    return u;
  }
};

// ---- Tiles of tokens, for the decode ----

constexpr int TU_THREADS = 1024;
constexpr int TU_PAIRS = 8192;                 // T * k at most: the keys fit in shared memory
constexpr int TU_PER = TU_PAIRS / TU_THREADS;  // keys, and runs, a thread owns at most
constexpr int PAIR_BITS = 13;                  // a pair's place in its tile, < TU_PAIRS
constexpr int CMAX = 32;                       // uses counted up to this, for the ranking
constexpr int INVALID = -2147483647 - 1;       // the code of a row outside [0, L)
constexpr int SLICE = 8;                       // 16-byte vectors of a row in a slice: 128 bytes
constexpr int GROUP = 4;                       // staged decode: tokens a warp, SLICE lanes each
constexpr int DJ = 16;                         // staged decode: chain steps a chunk
constexpr int DNB = 3;                         // staged decode: chunk buffers a warp, two in flight
constexpr int ROWS = 900;                      // staged decode: rows a tile stages at most
constexpr int TR = 28;                         // staged decode: transient rows a warp and chunk
constexpr int TILE_MAX = 32;                   // staged decode: tokens a tile (GROUP a warp, 8 warps)
constexpr int SLOTS = 128;                     // staged decode: (chunk, warp) items a tile at most
constexpr int MIN_COVER = 50;                  // a tile is staged when its staged rows cover this % of its pairs

// Sort keys: (row, pair), with the row NO_ROW for a row outside [0, L) and
// for padding.  32 bits when every row fits 19 bits, else 64.
template <typename K>
struct Key;
template <>
struct Key<unsigned> {
  static constexpr unsigned NO_ROW = (1u << (32 - PAIR_BITS)) - 1;
  __device__ static unsigned make(unsigned row, int e) { return row << PAIR_BITS | (unsigned)e; }
  __device__ static unsigned row(unsigned k) { return k >> PAIR_BITS; }
  __device__ static int pair(unsigned k) { return (int)(k & ((1u << PAIR_BITS) - 1)); }
};
template <>
struct Key<unsigned long long> {
  static constexpr unsigned NO_ROW = 0xffffffffu;
  __device__ static unsigned long long make(unsigned row, int e) {
    return (unsigned long long)row << 32 | (unsigned)e;
  }
  __device__ static unsigned row(unsigned long long k) { return (unsigned)(k >> 32); }
  __device__ static int pair(unsigned long long k) { return (int)(unsigned)k; }
};

// A thread's `per` consecutive keys (or ints) from a + base, to or from
// registers.  Neighbouring threads' segments lie `per` apart, so they move
// 16 bytes at a time where the segment allows, which keeps the banks apart.
__device__ __forceinline__ void unpack(const uint4& v, unsigned* r) {
  r[0] = v.x;
  r[1] = v.y;
  r[2] = v.z;
  r[3] = v.w;
}
__device__ __forceinline__ void unpack(const uint4& v, unsigned long long* r) {
  r[0] = (unsigned long long)v.y << 32 | v.x;
  r[1] = (unsigned long long)v.w << 32 | v.z;
}
__device__ __forceinline__ uint4 pack4(const unsigned* r) { return make_uint4(r[0], r[1], r[2], r[3]); }
__device__ __forceinline__ uint4 pack4(const unsigned long long* r) {
  return make_uint4((unsigned)r[0], (unsigned)(r[0] >> 32), (unsigned)r[1], (unsigned)(r[1] >> 32));
}
__device__ __forceinline__ uint4 pack4(const int* r) {
  return make_uint4((unsigned)r[0], (unsigned)r[1], (unsigned)r[2], (unsigned)r[3]);
}

template <typename K>
__device__ __forceinline__ void load_seg(const K* a, int base, int per, K (&r)[TU_PER]) {
  constexpr int V = 16 / sizeof(K);
#pragma unroll
  for (int x = 0; x < TU_PER; x += V) {
    if (per >= V && x < per) {
      unpack(*reinterpret_cast<const uint4*>(a + base + x), r + x);
    } else {
#pragma unroll
      for (int y = x; y < x + V; ++y)
        if (y < per) r[y] = a[base + y];
    }
  }
}

template <typename K>
__device__ __forceinline__ void store_seg(K* a, int base, int per, const K (&r)[TU_PER]) {
  constexpr int V = 16 / sizeof(K);
#pragma unroll
  for (int x = 0; x < TU_PER; x += V) {
    if (per >= V && x < per) {
      *reinterpret_cast<uint4*>(a + base + x) = pack4(r + x);
    } else {
#pragma unroll
      for (int y = x; y < x + V; ++y)
        if (y < per) a[base + y] = r[y];
    }
  }
}

// Ascending bitonic sort of a[0 .. n) by the block, n a power of 2 and at
// least blockDim.x.  Thread t owns a[t * per .. + per), per = n / blockDim.x
// <= TU_PER: the stages whose pairs lie within one thread's keys run in its
// registers, the others through shared memory with a barrier each.
template <typename K>
__device__ void block_sort(K* a, int n) {
  const int per = n / blockDim.x;
  const int base = threadIdx.x * per;
  __syncthreads();
  for (int size = 2; size <= n; size <<= 1) {
    for (int stride = size >> 1; stride >= per; stride >>= 1) {
      for (int i = threadIdx.x; i < n / 2; i += blockDim.x) {
        const int lo = 2 * i - (i & (stride - 1));
        const K x = a[lo], y = a[lo + stride];
        if ((x > y) == ((lo & size) == 0)) {
          a[lo] = y;
          a[lo + stride] = x;
        }
      }
      __syncthreads();
    }
    if (per > 1) {
      K r[TU_PER];
      load_seg(a, base, per, r);
#pragma unroll
      for (int st = TU_PER / 2; st > 0; st >>= 1) {
        if (st >= per || st >= size) continue;
#pragma unroll
        for (int x = 0; x < TU_PER; ++x) {
          if (x >= per || (x & st)) continue;
          const K lo = r[x], hi = r[x + st];
          if ((lo > hi) == (((base + x) & size) == 0)) {
            r[x] = hi;
            r[x + st] = lo;
          }
        }
      }
      store_seg(a, base, per, r);
      __syncthreads();
    }
  }
}

// Exclusive prefix sum of x over the block (blockDim.x a multiple of 32),
// and the block's total.  Every thread calls it; it ends on a barrier.
__device__ int block_scan(int x, int& total) {
  __shared__ int warp_sums[32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nwarps = blockDim.x >> 5;
  int inc = x;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, inc, o);
    if (lane >= o) inc += y;
  }
  if (lane == 31) warp_sums[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    int s = lane < nwarps ? warp_sums[lane] : 0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, s, o);
      if (lane >= o) s += y;
    }
    warp_sums[lane] = s;
  }
  __syncthreads();
  const int before = (warp ? warp_sums[warp - 1] : 0) + inc - x;
  total = warp_sums[nwarps - 1];
  __syncthreads();
  return before;
}

struct TileArgs {
  const int* idx;    // (N, k)
  const void* vals;  // (N, k), fp32 or bf16 (vals_bf16); read with meta
  int* code;         // (N, k)
  int* rows;         // (tiles, cap)
  int* info;         // (tiles, 4)
  // The staged decode's chunks (null for tile_union):
  int2* meta;   // (tiles, k, TP): step j of token t, (its code there, fp32 bits of vals)
  int* trows;   // (tiles, chunks, groups, TR): each chunk's rows of a group's steps alone
  int* tcount;  // (tiles, chunks, groups): how many
  long long L;
  int N, k, T, cap, vals_bf16;
  int sortn;  // a power of 2, >= T * k and >= TU_THREADS
};

template <typename K>
__global__ void __launch_bounds__(TU_THREADS) tile_union_kernel(const TileArgs a) {
  using KK = Key<K>;
  extern __shared__ int4 tu_smem[];
  K* key = reinterpret_cast<K*>(tu_smem);            // sortn (row, pair) keys
  int* rid = reinterpret_cast<int*>(key + a.sortn);  // sortn: the run of each sorted pair
  int* start = rid + a.sortn;                        // sortn + 1: each run's first sorted pair, then `valid`
  int* slot = start + a.sortn + 1;                   // sortn: each run's staged slot, or -1
  __shared__ int hist[32][32];                       // per warp: its runs of each use count
  __shared__ int cut_s[2];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tile = blockIdx.x;
  const long long n0 = (long long)tile * a.T;
  const int np = (int)min((long long)a.T, (long long)a.N - n0) * a.k;
  const int* ti = a.idx + n0 * a.k;
  for (int e = tid; e < a.sortn; e += TU_THREADS) {
    unsigned row = KK::NO_ROW;
    if (e < np) {
      const int r = ti[e];
      if (r >= 0 && r < a.L) row = (unsigned)r;
    }
    key[e] = KK::make(row, e < np ? e : TU_PAIRS - 1);
  }
  block_sort(key, a.sortn);

  // Runs of one row among the valid pairs, which sort first; thread t walks
  // keys [t * per, t * per + per).
  const int per = a.sortn / TU_THREADS;
  const int i0 = tid * per;
  K mykeys[TU_PER];
  load_seg(key, i0, per, mykeys);
  bool first[TU_PER];
  int starts = 0, valid_mine = 0;
  unsigned prev = i0 > 0 ? KK::row(key[i0 - 1]) : 0xffffffffu;
#pragma unroll
  for (int x = 0; x < TU_PER; ++x) {
    const unsigned row = x < per ? KK::row(mykeys[x]) : KK::NO_ROW;
    first[x] = row != KK::NO_ROW && row != prev;
    valid_mine += row != KK::NO_ROW;
    starts += first[x];
    prev = row;
  }
  int U, valid;
  int r = block_scan(starts, U) - 1;
  block_scan(valid_mine, valid);
  int myrid[TU_PER];
#pragma unroll
  for (int x = 0; x < TU_PER; ++x) {
    if (first[x]) start[++r] = i0 + x;
    myrid[x] = x < per && KK::row(mykeys[x]) != KK::NO_ROW ? r : -1;
  }
  store_seg(rid, i0, per, myrid);
  if (tid == 0) start[U] = valid;
  __syncthreads();

  // Thread t owns runs [t * per, t * per + per); each run's use count, up to CMAX.
  int cnt[TU_PER];
#pragma unroll
  for (int m = 0; m < TU_PER; ++m) {
    const int q = i0 + m;
    cnt[m] = m < per && q < U ? min(start[q + 1] - start[q], CMAX) : 0;
  }
  // The staged runs: the `cap` most used, equal counts in row order.  Lane c
  // of each warp counts the warp's runs used c + 1 times; warp 0 finds the
  // count at the cut and how many runs of that count are staged.
  int mine = 0;
#pragma unroll
  for (int m = 0; m < TU_PER; ++m) {
    if (__ballot_sync(0xffffffffu, cnt[m] != 0) == 0u) continue;  // no run of the warp's here
#pragma unroll
    for (int c = 0; c < CMAX; ++c) {
      const int votes = __popc(__ballot_sync(0xffffffffu, cnt[m] == c + 1));
      if (lane == c) mine += votes;
    }
  }
  hist[warp][lane] = mine;
  __syncthreads();
  if (warp == 0) {
    int at = 0;
    for (int w = 0; w < TU_THREADS / 32; ++w) at += hist[w][lane];
    int from = at;  // runs used lane + 1 times or more
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_down_sync(0xffffffffu, from, o);
      if (lane + o < 32) from += y;
    }
    const int above = from - at;
    const bool cut = above < a.cap && a.cap <= from;
    if (cut) {
      cut_s[0] = lane + 1;
      cut_s[1] = a.cap - above;
    }
    if (__ballot_sync(0xffffffffu, cut) == 0u && lane == 0) {  // every run fits, or cap is 0
      cut_s[0] = a.cap > 0 ? 1 : CMAX + 1;
      cut_s[1] = 0x7fffffff;
    }
  }
  __syncthreads();
  const int cstar = cut_s[0], need = cut_s[1];
  int at_cut = 0;
#pragma unroll
  for (int m = 0; m < TU_PER; ++m) at_cut += cnt[m] == cstar;
  int at_cut_total;
  int rank = block_scan(at_cut, at_cut_total);
  bool stg[TU_PER];
  int st_mine = 0;
#pragma unroll
  for (int m = 0; m < TU_PER; ++m) {
    stg[m] = cnt[m] > cstar || (cnt[m] == cstar && rank++ < need);
    st_mine += stg[m];
  }
  int staged;
  int s = block_scan(st_mine, staged);
  int* tile_rows = a.rows + (long long)tile * a.cap;
  int covered = 0;
#pragma unroll
  for (int m = 0; m < TU_PER; ++m) {
    const int q = i0 + m;
    if (m < per && q < U) {
      slot[q] = stg[m] ? s : -1;
      if (stg[m]) {
        tile_rows[s++] = (int)KK::row(key[start[q]]);
        covered += start[q + 1] - start[q];
      }
    }
  }
  int cover;
  block_scan(covered, cover);  // its barriers also publish slot[]

  int* tile_code = a.code + n0 * a.k;
  for (int i = tid; i < np; i += TU_THREADS) {  // the tile's np keys sort before the padding
    const K kk = key[i];
    const unsigned row = KK::row(kk);
    int c = INVALID;
    if (row != KK::NO_ROW) {
      const int p = slot[rid[i]];
      c = p >= 0 ? p : -(int)row - 1;
    }
    tile_code[KK::pair(kk)] = c;
  }
  if (tid == 0) {
    int* inf = a.info + 4 * tile;
    inf[0] = staged;
    inf[1] = valid > 0 && (long long)cover * 100 >= (long long)MIN_COVER * valid;
    inf[2] = U;
    inf[3] = cover;
  }
  if (a.meta == nullptr) return;

  // The staged decode's chunks: for each chunk of DJ steps and group of
  // GROUP tokens (one warp of the decode), the group's pairs whose row is
  // not staged, step-major, take the first TR transient slots (code cap +
  // slot); the rest keep -(row + 1).  A warp takes one (chunk, group) at a
  // time and ranks its pairs with ballots.
  __syncthreads();  // the tile's codes are written
  const int TP = (a.T + GROUP - 1) / GROUP * GROUP;
  const int groups = TP / GROUP;
  const int chunks = (a.k + DJ - 1) / DJ;
  for (int item = warp; item < chunks * groups; item += TU_THREADS / 32) {
    const int ch = item / groups, g = item % groups;
    const long long slot0 = ((long long)tile * chunks + ch) * groups + g;
    int taken = 0;
    for (int q0 = 0; q0 < GROUP * DJ; q0 += 32) {
      const int q = q0 + lane;
      const int t = g * GROUP + q % GROUP, j = ch * DJ + q / GROUP;
      const bool here = q < GROUP * DJ && j < a.k && t < a.T && n0 + t < a.N;
      int c = here ? tile_code[t * a.k + j] : INVALID;
      const bool direct = here && c < 0 && c != INVALID;
      const unsigned votes = __ballot_sync(0xffffffffu, direct);
      const int at = taken + __popc(votes & ((1u << lane) - 1u));
      taken += __popc(votes);
      if (direct && at < TR) {
        a.trows[slot0 * TR + at] = -(c + 1);
        c = a.cap + at;
      }
      if (here) {
        const long long pos = (n0 + t) * a.k + j;
        const float v = a.vals_bf16 ? __bfloat162float(reinterpret_cast<const __nv_bfloat16*>(a.vals)[pos])
                                    : reinterpret_cast<const float*>(a.vals)[pos];
        a.meta[((long long)tile * a.k + j) * TP + t] = make_int2(c, __float_as_int(v));
      }
    }
    if (lane == 0) a.tcount[slot0] = min(taken, TR);
  }
}

int launch_tiles(TileArgs a, cudaStream_t st) {
  if (a.T < 1 || a.k < 1 || (long long)a.T * a.k > TU_PAIRS || a.cap < 0)
    return (int)cudaErrorInvalidValue;
  a.sortn = TU_THREADS;
  while (a.sortn < a.T * a.k) a.sortn <<= 1;
  const bool narrow_keys = a.L <= (long long)Key<unsigned>::NO_ROW;
  const size_t smem = (size_t)a.sortn * ((narrow_keys ? 4 : 8) + 12) + 4;
  const void* kernel = narrow_keys ? (const void*)tile_union_kernel<unsigned>
                                   : (const void*)tile_union_kernel<unsigned long long>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const unsigned tiles = (unsigned)((a.N + a.T - 1) / a.T);
  if (narrow_keys)
    tile_union_kernel<unsigned><<<tiles, TU_THREADS, smem, st>>>(a);
  else
    tile_union_kernel<unsigned long long><<<tiles, TU_THREADS, smem, st>>>(a);
  return (int)cudaGetLastError();
}

// Copies the slices (vectors v0 .. v0 + SLICE) of the n rows of W listed in
// ids into dst, SLICE vectors a row, with cp.async by the block's threads;
// each thread reads eight row ids ahead of their copies.  Only starts the
// copies: commit, wait and a barrier come after.
__device__ __forceinline__ void stage_slices(uint4* dst, const int* __restrict__ ids, int n,
                                             const uint4* __restrict__ w, int vecs, int v0) {
  const int total = n * SLICE;
  for (int i0 = threadIdx.x; i0 < total; i0 += 8 * blockDim.x) {
    int r[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int i = i0 + u * blockDim.x;
      r[u] = i < total ? ids[i / SLICE] : 0;
    }
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int i = i0 + u * blockDim.x;
      const int c = v0 + (i & (SLICE - 1));
      if (i < total)
        sm90::cp_async16(sm90::smem_u32(dst + i), w + (long long)r[u] * vecs + (c < vecs ? c : 0), c < vecs);
    }
  }
}

// ---- gather_decode ----

// Direct path: one block per token (and per THREADS * VPT vectors of d);
// a token of a staged tile is left to decode_tile_kernel.
template <typename T>
__global__ void __launch_bounds__(THREADS)
    gather_decode_kernel(const uint4* __restrict__ w, const int* __restrict__ idx,
                         const T* __restrict__ vals, uint4* __restrict__ y, long long L,
                         int vecs, int k, const int* __restrict__ info, int tile) {
  constexpr int E = Vec<T>::N;
  __shared__ int idx_s[KCHUNK];
  __shared__ float val_s[KCHUNK];
  const long long n = blockIdx.x;
  if (info != nullptr && info[4 * (n / tile) + 1]) return;
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

// Shared memory of the staged decode, in bytes: the ROWS staged rows'
// slices; for each of `groups` warps, DNB buffers of a chunk's TR transient
// rows and of its steps' (code, value)s; the tile's row ids and transient
// counts.  It grows with groups and with groups * chunks, which decode_tile
// keeps to TILE_MAX / GROUP and SLOTS.
constexpr size_t decode_smem(int groups, int chunks) {
  return (size_t)ROWS * SLICE * 16 + (size_t)groups * DNB * ((size_t)TR * SLICE * 16 + (size_t)DJ * GROUP * 8) +
         ((size_t)ROWS + (size_t)chunks * groups * (TR + 1)) * 4;
}
static_assert(decode_smem(TILE_MAX / GROUP, SLOTS / (TILE_MAX / GROUP)) <= 227 * 1024, "the staged decode's layout");
static_assert(ROWS % 4 == 0 && TR % 4 == 0 && TR <= GROUP * DJ, "16-byte copies of row ids; a chunk's pairs");

// Tokens a decode tile takes at k: a multiple of GROUP, at most TILE_MAX,
// with at most SLOTS (chunk, warp) items (so T * k <= 16 * SLOTS * GROUP =
// TU_PAIRS); 0, the direct path alone, when k is outside [1, DJ * SLOTS].
int decode_tile(int k) { return k >= 1 ? min(TILE_MAX, GROUP * (SLOTS / ((k + DJ - 1) / DJ))) : 0; }

// The decode's scratch: one int32 buffer, each part at a 16-byte offset from
// its start (the caller's, 16-byte aligned): code (N, k); meta (tiles, k, T)
// of int2; rows (tiles, ROWS); trows (tiles, chunks, groups, TR); tcount
// (tiles, chunks, groups); info (tiles, 4).  Offsets and the total in words.
struct DecodeScratch {
  long long code, meta, rows, trows, tcount, info, words;
};

DecodeScratch decode_scratch(long long N, int k, int tile) {
  auto up4 = [](long long x) { return (x + 3) / 4 * 4; };
  const long long tiles = (N + tile - 1) / tile, items = tiles * ((k + DJ - 1) / DJ) * (tile / GROUP);
  DecodeScratch s;
  s.code = 0;
  s.meta = up4(N * k);
  s.rows = s.meta + tiles * k * tile * 2;
  s.trows = s.rows + tiles * ROWS;
  s.tcount = s.trows + items * TR;
  s.info = s.tcount + up4(items);
  s.words = s.info + tiles * 4;
  return s;
}

// Staged path: one block per (tile, slice of SLICE vectors); warp w takes
// tokens GROUP * w .. + GROUP - 1, thread (t, cv) running token t's chain at
// vector cv of the slice, DJ steps a chunk.  The block copies the tile's row
// ids and transient counts into shared memory, then the staged rows'
// slices, and meets once at a barrier; from there each warp runs alone: it
// copies its own chunks' transient rows and (code, value)s with cp.async
// DNB - 1 chunks ahead and waits for them with __syncwarp.  A chunk's loads
// all issue before its FMAs, which run in step order.
template <typename T>
__global__ void __launch_bounds__(32 * SLICE, 1)
    decode_tile_kernel(const uint4* __restrict__ w, const int2* __restrict__ meta, const int* __restrict__ rows,
                       const int* __restrict__ trows, const int* __restrict__ tcount, const int* __restrict__ info,
                       uint4* __restrict__ y, int N, int vecs, int k, int tile) {
  constexpr int E = Vec<T>::N;
  extern __shared__ uint4 dec_s[];
  const int TP = (tile + GROUP - 1) / GROUP * GROUP, groups = TP / GROUP;
  const int chunks = (k + DJ - 1) / DJ;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  uint4* res_s = dec_s;                // ROWS * SLICE
  uint4* ring = res_s + ROWS * SLICE;  // per warp: DNB * (TR * SLICE + DJ * GROUP / 2)
  const int ring_vecs = DNB * (TR * SLICE + DJ * GROUP / 2);
  int* rid_s = reinterpret_cast<int*>(ring + groups * ring_vecs);  // ROWS staged row ids
  int* tid_s = rid_s + ROWS;                                       // (chunks, groups, TR) transient row ids
  int* cnt_s = tid_s + chunks * groups * TR;                       // (chunks, groups) transient counts
  const int* inf = info + 4 * blockIdx.x;
  if (!inf[1]) return;  // a direct tile
  const int v0 = blockIdx.y * SLICE;
  const long long first_slot = (long long)blockIdx.x * chunks * groups;

  // The ids and counts first (ROWS and TR are multiples of 4), so that no
  // copy of a row waits on a load from global memory.
  const int* g_rows = rows + (long long)blockIdx.x * ROWS;
  const int* g_trows = trows + first_slot * TR;
  for (int i = threadIdx.x; i < ROWS / 4; i += blockDim.x)
    sm90::cp_async16(sm90::smem_u32(rid_s + 4 * i), g_rows + 4 * i, true);
  for (int i = threadIdx.x; i < chunks * groups * TR / 4; i += blockDim.x)
    sm90::cp_async16(sm90::smem_u32(tid_s + 4 * i), g_trows + 4 * i, true);
  for (int i = threadIdx.x; i < chunks * groups; i += blockDim.x)
    sm90::cp_async4(sm90::smem_u32(cnt_s + i), tcount + first_slot + i, true);
  sm90::cp_async_commit();
  sm90::cp_async_wait<0>();
  __syncthreads();

  // This warp's chunk buffers: DNB of (TR rows' slices, then DJ * GROUP (code, value)s).
  uint4* my_ring = ring + warp * ring_vecs;
  const int2* tile_meta = meta + (long long)blockIdx.x * k * TP + warp * GROUP;
  auto stage_chunk = [&](int ch) {
    if (ch < chunks) {
      uint4* buf = my_ring + (ch % DNB) * (TR * SLICE + DJ * GROUP / 2);
      const int n = cnt_s[ch * groups + warp];
      const int* ids = tid_s + (ch * groups + warp) * TR;
      for (int i = lane; i < n * SLICE; i += 32) {
        const int c = v0 + (i & (SLICE - 1));
        sm90::cp_async16(sm90::smem_u32(buf + i), w + (long long)ids[i / SLICE] * vecs + (c < vecs ? c : 0),
                         c < vecs);
      }
      // Step j's GROUP (code, value)s are 32 bytes: two 16-byte copies.
      const int nj = min(DJ, k - ch * DJ);
      for (int i = lane; i < nj * 2; i += 32)
        sm90::cp_async16(sm90::smem_u32(buf + TR * SLICE + i),
                         reinterpret_cast<const uint4*>(tile_meta + (long long)(ch * DJ + i / 2) * TP) + (i & 1), true);
    }
    sm90::cp_async_commit();  // one group a chunk, empty past the end
  };
  stage_slices(res_s, rid_s, inf[0], w, vecs, v0);
  sm90::cp_async_commit();
  for (int ch = 0; ch < DNB - 1; ++ch) stage_chunk(ch);
  sm90::cp_async_wait<DNB - 1>();  // the staged rows are in, for every thread after the barrier
  __syncthreads();

  const int tl = lane / SLICE, cv = lane % SLICE;
  const long long n = (long long)blockIdx.x * tile + warp * GROUP + tl;
  const int c = v0 + cv;
  const bool live = warp * GROUP + tl < tile && n < N && c < vecs;
  const uint4* wc = w + c;
  const uint4* rs = res_s + cv;
  const int2 none = make_int2(INVALID, 0);
  float acc[E];
#pragma unroll
  for (int i = 0; i < E; ++i) acc[i] = 0.f;
  for (int ch = 0; ch < chunks; ++ch) {
    sm90::cp_async_wait<DNB - 2>();  // this lane's copies of the chunk are in
    __syncwarp();                    // ... and every lane's; the warp is done with the last chunk
    stage_chunk(ch + DNB - 1);
    const uint4* buf = my_ring + (ch % DNB) * (TR * SLICE + DJ * GROUP / 2);
    const int2* ms = reinterpret_cast<const int2*>(buf + TR * SLICE) + tl;
    const uint4* ts = buf - ROWS * SLICE + cv;  // transient code c at ts[c * SLICE]
    const int nj = min(DJ, k - ch * DJ);
    int2 e[DJ];
#pragma unroll
    for (int u = 0; u < DJ; ++u) e[u] = live && u < nj ? ms[u * GROUP] : none;
    uint4 x[DJ];
    bool far = false;  // a step whose row is in neither place, read from W
#pragma unroll
    for (int u = 0; u < DJ; ++u) {
      const int cd = e[u].x;
      far |= cd < 0 && cd != INVALID;
      x[u] = *(cd >= ROWS ? ts + cd * SLICE : rs + (cd > 0 ? cd : 0) * SLICE);
    }
    if (far) {
#pragma unroll
      for (int u = 0; u < DJ; ++u)
        if (e[u].x < 0 && e[u].x != INVALID) x[u] = __ldg(wc + (long long)(-(e[u].x + 1)) * vecs);
    }
#pragma unroll
    for (int u = 0; u < DJ; ++u)  // the chunk's steps, in order; a row outside W adds nothing
      if (e[u].x != INVALID) Vec<T>::add(acc, __int_as_float(e[u].y), x[u]);
  }
  if (live) y[n * vecs + c] = Vec<T>::pack(acc);
}

template <typename T>
int launch_decode(const void* w, const void* idx, const void* vals, void* y, long long L, int N, int vecs, int k,
                  int* scratch, cudaStream_t st) {
  const int tile = decode_tile(k);
  const int* direct_info = nullptr;
  if (tile > 0) {
    const DecodeScratch at = decode_scratch(N, k, tile);
    const int groups = tile / GROUP, chunks = (k + DJ - 1) / DJ;
    const size_t smem = decode_smem(groups, chunks);
    const TileArgs a{reinterpret_cast<const int*>(idx), vals, scratch + at.code, scratch + at.rows,
                     scratch + at.info, reinterpret_cast<int2*>(scratch + at.meta), scratch + at.trows,
                     scratch + at.tcount, L, N, k, tile, ROWS, (int)std::is_same<T, __nv_bfloat16>::value, 0};
    int e = launch_tiles(a, st);
    if (e != 0) return e;
    e = (int)cudaFuncSetAttribute(decode_tile_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != 0) return e;
    const dim3 grid((unsigned)((N + tile - 1) / tile), (vecs + SLICE - 1) / SLICE);
    decode_tile_kernel<T><<<grid, groups * 32, smem, st>>>(
        reinterpret_cast<const uint4*>(w), a.meta, a.rows, a.trows, a.tcount, a.info, reinterpret_cast<uint4*>(y), N,
        vecs, k, tile);
    e = (int)cudaGetLastError();
    if (e != 0) return e;
    direct_info = a.info;
  }
  const dim3 grid((unsigned)N, (vecs + THREADS * VPT - 1) / (THREADS * VPT));
  gather_decode_kernel<T><<<grid, THREADS, 0, st>>>(reinterpret_cast<const uint4*>(w),
                                                     reinterpret_cast<const int*>(idx),
                                                     reinterpret_cast<const T*>(vals), reinterpret_cast<uint4*>(y),
                                                     L, vecs, k, direct_info, tile);
  return (int)cudaGetLastError();
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

// ---- decode_dvals ----

// decode_dvals: one block of DV_THREADS per token.
constexpr int DV_THREADS = 256;
constexpr int DV_WARPS = DV_THREADS / 32;
constexpr int DV_UNROLL = 4;  // rows a warp has in flight

template <typename T, typename O>
__global__ void __launch_bounds__(DV_THREADS)
    decode_dvals_kernel(const uint4* __restrict__ w, const int* __restrict__ idx, const float* __restrict__ g,
                        O* __restrict__ out, long long L, int vecs, int k) {
  constexpr int E = Vec<T>::N;
  extern __shared__ float4 g_s4[];  // the token's g, vecs * E floats
  const float* g_s = reinterpret_cast<const float*>(g_s4);
  const long long n = blockIdx.x;
  const int d4 = vecs * E / 4;
  const float4* gn = reinterpret_cast<const float4*>(g) + n * d4;
  for (int i = threadIdx.x; i < d4; i += DV_THREADS) g_s4[i] = gn[i];
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int j0 = warp * DV_UNROLL; j0 < k; j0 += DV_WARPS * DV_UNROLL) {
    const uint4* wr[DV_UNROLL];
    bool ok[DV_UNROLL];
    float acc[DV_UNROLL];
#pragma unroll
    for (int u = 0; u < DV_UNROLL; ++u) {
      const int j = j0 + u;
      const int row = j < k ? idx[n * k + j] : -1;
      ok[u] = row >= 0 && row < L;  // a row outside W gives 0
      wr[u] = w + (long long)(ok[u] ? row : 0) * vecs;
      acc[u] = 0.f;
    }
    for (int c = lane; c < vecs; c += 32) {
      uint4 v[DV_UNROLL];
#pragma unroll
      for (int u = 0; u < DV_UNROLL; ++u) v[u] = ok[u] ? __ldg(wr[u] + c) : make_uint4(0, 0, 0, 0);
#pragma unroll
      for (int u = 0; u < DV_UNROLL; ++u) acc[u] = Vec<T>::dot(acc[u], g_s + c * E, v[u]);
    }
#pragma unroll
    for (int u = 0; u < DV_UNROLL; ++u) {
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) acc[u] += __shfl_xor_sync(0xffffffffu, acc[u], o);
    }
    if (lane == 0) {
#pragma unroll
      for (int u = 0; u < DV_UNROLL; ++u)
        if (j0 + u < k) out[n * k + j0 + u] = narrow<O>(acc[u]);
    }
  }
}

template <typename T, typename O>
int launch_dvals(const void* w, const void* idx, const void* g, void* out, long long L, int N, int vecs, int k,
                 cudaStream_t st) {
  const size_t smem = (size_t)vecs * Vec<T>::N * sizeof(float);
  if (smem > 227 * 1024) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(decode_dvals_kernel<T, O>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  decode_dvals_kernel<T, O><<<(unsigned)N, DV_THREADS, smem, st>>>(
      reinterpret_cast<const uint4*>(w), reinterpret_cast<const int*>(idx), reinterpret_cast<const float*>(g),
      reinterpret_cast<O*>(out), L, vecs, k);
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

// The pre-pass alone (a check of the decode's tiles).  idx: (N, k) int32;
// tiles of `tile` tokens, tile * k <= 8192, up to `cap` rows staged; code:
// (N, k), rows: (tiles, cap) and info: (tiles, 4) int32, written as the head
// of this file says (rows past a tile's staged count are not written).
// Returns a CUDA error code.
int tile_union(const void* idx, long long L, long long N, int k, int tile, int cap, void* code, void* rows,
               void* info, void* stream) {
  if (N > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  if (N == 0) return 0;
  const TileArgs a{reinterpret_cast<const int*>(idx), nullptr, reinterpret_cast<int*>(code),
                   reinterpret_cast<int*>(rows), reinterpret_cast<int*>(info), nullptr, nullptr, nullptr,
                   L, (int)N, k, tile, cap, 0, 0};
  return launch_tiles(a, reinterpret_cast<cudaStream_t>(stream));
}

// The decode's tiling at (N, k): tiling[0] the tokens a tile takes (0: the
// direct path alone), tiling[1] the rows it stages at most; returns the int32
// words of scratch gather_decode needs (0 for the direct path).
long long gather_decode_scratch(long long N, int k, int* tiling) {
  tiling[0] = decode_tile(k);
  tiling[1] = ROWS;
  return tiling[0] > 0 && N > 0 ? decode_scratch(N, k, tiling[0]).words : 0;
}

// w: (L, d) fp32 (bf16 = 0) or bf16 (bf16 = 1), d a multiple of 16 bytes;
// idx: (N, k) int32; vals: (N, k) of w's type; y: (N, d) of w's type;
// scratch: gather_decode_scratch(N, k) int32 words, 16-byte aligned.
// Returns a CUDA error code.
int gather_decode(const void* w, const void* idx, const void* vals, void* y, long long L, long long N, int d, int k,
                  int bf16, void* scratch, void* stream) {
  const int elem = bf16 ? 2 : 4;
  if ((d * elem) % 16 || N > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const int vecs = d * elem / 16;
  if (N == 0 || vecs == 0) return 0;
  if (decode_tile(k) > 0 && reinterpret_cast<uintptr_t>(scratch) % 16) return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  int* s = reinterpret_cast<int*>(scratch);
  if (bf16) return launch_decode<__nv_bfloat16>(w, idx, vals, y, L, (int)N, vecs, k, s, st);
  return launch_decode<float>(w, idx, vals, y, L, (int)N, vecs, k, s, st);
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

// The decode's dvals.  w: (L, d) fp32 (w_bf16 = 0) or bf16 (w_bf16 = 1), d a
// multiple of 16 bytes of w and of 4; idx: (N, k) int32; g: (N, d) fp32, 16-byte
// aligned; out: (N, k), fp32 (out_bf16 = 0) or bf16 (out_bf16 = 1).  Returns
// a CUDA error code.
int decode_dvals(const void* w, const void* idx, const void* g, void* out, long long L, long long N, int d, int k,
                 int w_bf16, int out_bf16, void* stream) {
  const int elem = w_bf16 ? 2 : 4;
  if ((d * elem) % 16 || d % 4 || N > 0x7fffffffLL || k < 0) return (int)cudaErrorInvalidValue;
  const int vecs = d * elem / 16;
  if (N == 0 || k == 0) return 0;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (w_bf16 && out_bf16)
    return launch_dvals<__nv_bfloat16, __nv_bfloat16>(w, idx, g, out, L, (int)N, vecs, k, st);
  if (w_bf16) return launch_dvals<__nv_bfloat16, float>(w, idx, g, out, L, (int)N, vecs, k, st);
  if (out_bf16) return launch_dvals<float, __nv_bfloat16>(w, idx, g, out, L, (int)N, vecs, k, st);
  return launch_dvals<float, float>(w, idx, g, out, L, (int)N, vecs, k, st);
}

}  // extern "C"
