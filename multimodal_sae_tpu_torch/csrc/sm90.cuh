// Hopper (sm_90a) building blocks for the port's hand-written kernels: a
// 128-byte-swizzled shared-memory tile filled by cp.async, the wgmma matrix
// descriptors that read it either way round, and warpgroup products
// (wgmma.mma_async m64nNk16, bf16 in, fp32 accumulate) with A from shared
// memory or from registers.  A header of device functions, no library of its
// own: each source that includes it builds it in.
//
// The tile.  A (ROWS, HD) bf16 matrix, HD a multiple of 64, is stored as
// HD / 64 atoms of [ROWS][64] one after another (atom a at byte a * ROWS *
// 128).  Row r of an atom is 128 bytes: eight 16-byte chunks, chunk c stored
// at position c ^ (r % 8).  This is wgmma's 128-byte swizzle, which the
// hardware applies to address bits [4, 7) from bits [7, 10), so a tile must
// start on a 1024-byte boundary.  Each 16-byte chunk is one cp.async.cg, so
// neighbouring threads copy neighbouring chunks of a row.
//
// One tile, two operands.  Seen with its HD axis as the contraction, the tile
// is a K-major operand (rows are M or N).  Seen with its ROWS axis as the
// contraction, the same bytes are an MN-major operand (N = HD contiguous):
// wgmma's transposed-B form reads it through another descriptor, so no
// transposed copy is ever written.
//
// Ordering.  cp.async writes shared memory through the generic proxy, wgmma
// reads it through the async proxy: after cp.async.wait_group and before the
// barrier that releases the tile to wgmma, every writing thread runs
// fence_proxy_async(), or wgmma may now and then read stale bytes.  The same
// holds after ordinary shared-memory stores.  wgmma_fence() goes before the
// first wgmma of a batch whose register operands other instructions wrote;
// fence_regs() pins accumulator registers in place around the asynchronous
// product, so the compiler neither reads them before wgmma_wait() nor moves
// their initialisation past the start of the product.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace sm90 {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, bypassing L1; zero-filled when !valid (src is
// then not read, but must be a valid address).
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}

// 4 bytes global -> shared, zero-filled when !valid.
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's committed cp.async groups are pending.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Byte offset of 16-byte chunk `ch` (of HD / 8) of row r in a swizzled tile
// of `rows` rows.
__device__ __forceinline__ uint32_t sw128_chunk(int r, int ch, int rows) {
  return (ch / 8) * (rows * 128) + r * 128 + (((ch % 8) ^ (r % 8)) << 4);
}

// Copy rows [r0, r0 + ROWS) of a row-major (S, HD) bf16 matrix into the
// swizzled tile at shared address `tile`, zero past row S, with the block's
// THREADS threads (thread `tid`).  Only starts the cp.async copies: commit
// and wait are the caller's.
template <int ROWS, int HD, int THREADS>
__device__ __forceinline__ void load_tile(uint32_t tile, const __nv_bfloat16* src, int r0, int S,
                                          int tid) {
  constexpr int CH = HD / 8;
  static_assert(HD % 64 == 0 && (ROWS * CH) % THREADS == 0, "tile shape");
#pragma unroll
  for (int j = 0; j < ROWS * CH / THREADS; ++j) {
    const int i = tid + j * THREADS;
    const int r = i / CH, ch = i % CH;
    const bool ok = r0 + r < S;
    cp_async16(tile + sw128_chunk(r, ch, ROWS), src + (size_t)(ok ? r0 + r : 0) * HD + ch * 8, ok);
  }
}

// A wgmma shared-memory matrix descriptor with the 128-byte swizzle: start
// address, leading and stride byte offsets (16-byte units), base offset 0.
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lead_bytes,
                                              uint32_t stride_bytes) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)((lead_bytes >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((stride_bytes >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

// The tile of ROWS rows as a K-major operand (contraction along HD), k-step
// kk (columns 16 kk .. 16 kk + 15): 8-row groups 1024 bytes apart; inside an
// atom the step moves the start by 32 bytes (the hardware swizzles the
// absolute address, so the offset stays unswizzled).
template <int ROWS>
__device__ __forceinline__ uint64_t desc_k_major(uint32_t tile, int kk) {
  return make_desc(tile + (kk / 4) * (ROWS * 128) + (kk % 4) * 32, 16, 1024);
}

// The tile of ROWS rows as an MN-major operand (contraction along ROWS, N
// along HD; wgmma's transposed B), k-step kk (rows 16 kk .. 16 kk + 15):
// 8-row groups 1024 bytes apart along the contraction (stride offset),
// 64-column atoms ROWS * 128 bytes apart along N (leading offset).
template <int ROWS>
__device__ __forceinline__ uint64_t desc_mn_major(uint32_t tile, int kk) {
  return make_desc(tile + kk * 2048, ROWS * 128, 1024);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// Wait until at most N committed wgmma groups of this warpgroup are pending.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&p);
}

// Accumulator layout of an m64nN product (N / 2 floats a thread): warp w of
// the warpgroup holds rows 16 w + g and 16 w + g + 8 (g = lane / 4); element
// 4 j + e is column 8 j + 2 (lane % 4) + (e & 1), of the second row when
// e >= 2.  acc_row / acc_col give a thread's coordinates of element i.
__device__ __forceinline__ int acc_row(int i, int lane, int warp) {
  return warp * 16 + lane / 4 + ((i & 2) ? 8 : 0);
}
__device__ __forceinline__ int acc_col(int i, int lane) { return 8 * (i / 4) + 2 * (lane % 4) + (i & 1); }

// Columns 16 kk .. 16 kk + 15 of an fp32 accumulator, rounded to bf16, as the
// register A operand of an m64nNk16 product: the accumulator's layout is the
// A fragment's, so no data leaves the thread.
template <int R>
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[4], const float (&acc)[R], int kk) {
  a[0] = pack_bf16(acc[8 * kk + 0], acc[8 * kk + 1]);
  a[1] = pack_bf16(acc[8 * kk + 2], acc[8 * kk + 3]);
  a[2] = pack_bf16(acc[8 * kk + 4], acc[8 * kk + 5]);
  a[3] = pack_bf16(acc[8 * kk + 6], acc[8 * kk + 7]);
}

#define SM90_ACC8(d, i)                                                                      \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]), "+f"(d[i + 5]), \
      "+f"(d[i + 6]), "+f"(d[i + 7])
#define SM90_ACC32(d) SM90_ACC8(d, 0), SM90_ACC8(d, 8), SM90_ACC8(d, 16), SM90_ACC8(d, 24)
#define SM90_ACC64(d)                                                                    \
  SM90_ACC32(d), SM90_ACC8(d, 32), SM90_ACC8(d, 40), SM90_ACC8(d, 48), SM90_ACC8(d, 56)

// One warpgroup product m64nNk16, N = 64 or 128: d = A B when accumulate is
// 0, d += A B otherwise.  TRANS_B = 0 reads B K-major (desc_k_major), 1
// MN-major (desc_mn_major).  The accumulator registers are spelled out
// because inline PTX takes no arrays.
template <int N>
struct Wgmma;

template <> struct Wgmma<64> {
  // d (+)= A B, A from shared memory (K-major), B from shared memory.
  template <int TRANS_B>
  static __device__ __forceinline__ void ss(float (&d)[32], uint64_t desc_a, uint64_t desc_b, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
        "}, %32, %33, p, 1, 1, 0, %35;\n}\n"
        : SM90_ACC32(d)
        : "l"(desc_a), "l"(desc_b), "r"(accumulate), "n"(TRANS_B));
  }
  // d += A B, A from registers (the m16n8k16 A fragment of each warp's 16 rows).
  template <int TRANS_B>
  static __device__ __forceinline__ void rs(float (&d)[32], const uint32_t (&a)[4], uint64_t desc_b, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
        "}, {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
        : SM90_ACC32(d)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(accumulate), "n"(TRANS_B));
  }
};

template <> struct Wgmma<128> {
  // d (+)= A B, A from shared memory (K-major), B from shared memory.
  template <int TRANS_B>
  static __device__ __forceinline__ void ss(float (&d)[64], uint64_t desc_a, uint64_t desc_b, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
        "}, %64, %65, p, 1, 1, 0, %67;\n}\n"
        : SM90_ACC64(d)
        : "l"(desc_a), "l"(desc_b), "r"(accumulate), "n"(TRANS_B));
  }
  // d += A B, A from registers (the m16n8k16 A fragment of each warp's 16 rows).
  template <int TRANS_B>
  static __device__ __forceinline__ void rs(float (&d)[64], const uint32_t (&a)[4], uint64_t desc_b, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
        "}, {%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
        : SM90_ACC64(d)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(accumulate), "n"(TRANS_B));
  }
};
// d (+)= A B with A and B from shared memory.
template <int N, int TRANS_B>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t desc_a, uint64_t desc_b,
                                         int accumulate) {
  Wgmma<N>::template ss<TRANS_B>(d, desc_a, desc_b, accumulate);
}

// d (+)= A B with A from registers, B from shared memory.
template <int N, int TRANS_B>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4],
                                         uint64_t desc_b, int accumulate) {
  Wgmma<N>::template rs<TRANS_B>(d, a, desc_b, accumulate);
}

#undef SM90_ACC8
#undef SM90_ACC32
#undef SM90_ACC64

}  // namespace sm90
