// What the tensor-core attention kernels share (attention_fwd_tc.cuh,
// attention_bwd_tc.cuh): the PTX wrappers of sm_90a's `cp.async`,
// `wgmma.mma_async` and their fences; the shared-memory descriptors of
// 64 x 64 bf16 tiles in the 128-byte swizzle; the two products every pass
// is built from (S = A B^T over D = 64, and d += frag B over 64 rows of B
// with the A operand in registers); tile staging (`load_tile`,
// `scale_own_chunks`); the SFU exp; the accumulator layout; the flat grid.
//
// Every tile is 64 rows of 64 bf16 values, one warpgroup (128 threads)
// works on it, and a CTA owns one 64-row tile of one (batch, head).
#pragma once

#include "dtype.cuh"

namespace dl4jt {
namespace tc {

constexpr int kTile = 64;                      // rows of every tile
constexpr int kThreads = 128;                  // one warpgroup
constexpr int kTileBytes = kTile * 64 * 2;     // 64 x 64 bf16: 8 KB
constexpr int kStages = 2;

// ------------------------------------------------------- PTX wrappers

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte copy, zero-filled when `valid` is false (src-size 0)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// generic-proxy writes (cp.async, st.shared) made visible to wgmma's
// async-proxy reads; a __syncthreads() follows
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// keeps the compiler from moving accumulator reads or writes across the
// asynchronous wgmma
__device__ __forceinline__ void fence_acc(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Shared-memory matrix descriptor of a swizzled 64-column bf16 tile:
// start address >> 4, leading and stride byte offsets >> 4, 128-byte
// swizzle (layout type 1 in bits 62-63). The stride byte offset is the
// 1024 bytes between groups of 8 rows. K-major operands take no leading
// offset (their 16-wide K step lies inside one 128-byte row); MN-major
// ones, whose N = 64 is one swizzle atom wide, get the same 1024.
__device__ __forceinline__ uint64_t desc_kmajor(const void* tile) {
  return static_cast<uint64_t>((smem_addr(tile) & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) |
         (static_cast<uint64_t>(1) << 62);
}

__device__ __forceinline__ uint64_t desc_mnmajor(const void* tile) {
  return static_cast<uint64_t>((smem_addr(tile) & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(1024 >> 4) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) |
         (static_cast<uint64_t>(1) << 62);
}

// d (64 x 64, fp32) (+)= A (64 x 16) B (16 x 64), both from shared memory,
// both K-major; `accumulate` 0 overwrites d
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da,
                                         uint64_t db, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (64 x 64, fp32) += A (64 x 16, bf16 fragment in 4 registers) B
// (16 x 64) from shared memory, MN-major (transpose bit set)
__device__ __forceinline__ void wgmma_rs_mn(float (&d)[32],
                                            const uint32_t (&a)[4],
                                            uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// S = A B^T over D = 64 (four K steps of 16, 32 bytes along the row)
__device__ __forceinline__ void product_dd(float (&d)[32], const void* a,
                                           const void* b) {
  const uint64_t da = desc_kmajor(a);
  const uint64_t db = desc_kmajor(b);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    wgmma_ss(d, da + 2 * kk, db + 2 * kk, kk);
  }
}

// d += frag B over 64 rows of B (four K steps of 16 rows, 2048 bytes)
__device__ __forceinline__ void product_rows(float (&d)[32],
                                             const uint32_t (&frag)[16],
                                             const void* b) {
  const uint64_t db = desc_mnmajor(b);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint32_t a[4] = {frag[4 * kk], frag[4 * kk + 1], frag[4 * kk + 2],
                           frag[4 * kk + 3]};
    wgmma_rs_mn(d, a, db + kk * (2048 >> 4));
  }
}

// the D = 64 dot product of row 0 of two swizzled tiles (row 0 is not
// permuted), summed in sequence with fmaf from d = 0, as the FMA kernels
// and the plain version's fp32 matmul sum it
__device__ __forceinline__ float dot_row0(const uint8_t* a,
                                          const uint8_t* b) {
  const __nv_bfloat16* x = reinterpret_cast<const __nv_bfloat16*>(a);
  const __nv_bfloat16* y = reinterpret_cast<const __nv_bfloat16*>(b);
  float acc = 0.f;
#pragma unroll 8
  for (int d = 0; d < 64; ++d) {
    acc = fmaf(__bfloat162float(x[d]), __bfloat162float(y[d]), acc);
  }
  return acc;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// ---------------------------------------------------------- tile staging

// byte offset of 16-byte chunk c of row r in a swizzled tile
__device__ __forceinline__ int swz(int r, int c) {
  return r * 128 + ((c ^ (r & 7)) << 4);
}

// rows row0..row0+63 of one head (row stride `stride` elements) into a
// swizzled tile; rows >= seq are zero-filled
__device__ __forceinline__ void load_tile(uint8_t* tile,
                                          const __nv_bfloat16* src,
                                          long long stride, int row0,
                                          int seq) {
#pragma unroll
  for (int i = 0; i < kTile * 8 / kThreads; ++i) {
    const int idx = threadIdx.x + i * kThreads;
    const int r = idx >> 3;
    const int c = idx & 7;
    const bool ok = row0 + r < seq;
    const __nv_bfloat16* g = src + (ok ? (row0 + r) * stride : 0) + c * 8;
    cp_async16(tile + swz(r, c), g, ok);
  }
}

// this thread's chunks of a tile it loaded with load_tile (the same
// (row, chunk) map), times `scale` and rounded to bf16 in place: qs. A
// thread touches only what its own copies wrote, so no barrier is needed
// between its cp.async wait and this pass.
__device__ __forceinline__ void scale_own_chunks(uint8_t* tile,
                                                 float scale) {
#pragma unroll
  for (int i = 0; i < kTile * 8 / kThreads; ++i) {
    const int idx = threadIdx.x + i * kThreads;
    uint4* p = reinterpret_cast<uint4*>(tile + swz(idx >> 3, idx & 7));
    uint4 w = *p;
    uint32_t* u = reinterpret_cast<uint32_t*>(&w);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const __nv_bfloat162 v =
          *reinterpret_cast<const __nv_bfloat162*>(&u[j]);
      u[j] = pack_bf16(__bfloat162float(v.x) * scale,
                       __bfloat162float(v.y) * scale);
    }
    *p = w;
  }
}

__device__ __forceinline__ uint8_t* align1024(uint8_t* p) {
  const uint32_t a = smem_addr(p);
  return p + ((1024 - (a & 1023)) & 1023);
}

// ------------------------------------------------------- the arithmetic

// e^x as 2^(x log2 e) on the SFU (ex2.approx, flushing to 0 below the
// normal range). It moves p by a few fp32 ulps from the plain version's
// expf, which the per-element bounds cover; exp(0) stays exactly 1.
__device__ __forceinline__ float exp_tc(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n"
      : "=f"(y)
      : "f"(x * 1.4426950408889634f));
  return y;
}

// prob() on the SFU: p = exp(s - lse) in p's dtype
__device__ __forceinline__ float prob_tc(float s, float lse, int p_bf16) {
  if (p_bf16) {
    return round_to<__nv_bfloat16>(exp_tc(round_to<__nv_bfloat16>(s - lse)));
  }
  return exp_tc(s - lse);
}

// Accumulator element i of thread (warp w, lane): row 16 w + lane / 4 +
// 8 ((i / 2) % 2), column 8 (i / 4) + 2 (lane % 4) + i % 2. The A
// fragment of K step kk is elements 8 kk .. 8 kk + 7, pairwise packed.
__device__ __forceinline__ int acc_row(int i) {
  return 16 * (threadIdx.x >> 5) + ((threadIdx.x & 31) >> 2) +
         8 * ((i >> 1) & 1);
}
__device__ __forceinline__ int acc_col(int i) {
  return 8 * (i >> 2) + 2 * (threadIdx.x & 3) + (i & 1);
}

// one CTA: (tile, batch * head); `reverse` puts the longest causal query
// tiles (the last) first
template <typename Args>
__device__ __forceinline__ void tile_of_block(const Args& a, bool reverse,
                                              int& tile, int& b, int& h) {
  const int bh_count = a.batch * a.heads;
  const int rank = blockIdx.x / bh_count;
  const int bh = blockIdx.x % bh_count;
  const int n_tiles = (a.seq + kTile - 1) / kTile;
  tile = reverse ? n_tiles - 1 - rank : rank;
  b = bh / a.heads;
  h = bh % a.heads;
}

}  // namespace tc
}  // namespace dl4jt
