// Fused paged decode attention for sm_90a, split over the positions
// ("flash-decoding").
//
// Replaces the Pallas kernel `_paged_decode_kernel` (called from
// `paged_decode_attention`, deeplearning4j_tpu/ops/pallas_kernels.py):
// one query token per slot attends over the K/V its block-table row names
// in the shared block pool, positions 0..pos[s] inclusive, with optional
// int8 dequantization by per-token, per-head fp32 scales in the same pass.
// The gathered (S, L, H, D) view is never materialized.
//
// What bounds it here: a decode step reads every live position's K and V
// once (2*(pos+1)*H*D*itemsize bytes per slot) and does ~4 flops per
// element read, so it is bound by HBM bytes: at the serving shapes (16
// slots, 12 heads, up to 512 positions of 64 bf16 dims) a call moves a few
// MB, a few microseconds at 3.35 TB/s, so latency (the dependent table and
// K/V loads, the launch) sets its time.
//
// Design: the TPU kernel lets a scalar-prefetched table drive the DMA and
// carries m/l/acc across a sequential grid in scratch. One CTA per (slot,
// head) walking its blocks in order leaves ~32 dependent block steps in
// the slowest slot. Here the positions are cut into splits of a fixed run
// of whole blocks (64 positions; the host plans it from the table's width
// and the block size, never from pos, so a call needs no host sync and
// replays in a CUDA graph). Grid (split, head, slot); a split past pos[s]
// exits at once. Inside a split:
// - the split's table entries are read once into shared memory;
// - each row (one position's D values of this head) is read by kLpr lanes
//   with one 16-byte load each (a 64-dim bf16 row: 8 lanes, 4 rows per
//   warp load; int8 rows are dequantized by their scale on the way in), and
//   every lane issues kUnroll rows of K and V before any math;
// - scores are reduced across a row's lanes by warp shuffles, the online
//   softmax runs in fp32 registers per row group, and for P.V each lane owns
//   its 16-byte slice of D; no __syncthreads per block;
// - row groups merge by shuffles, warps once through shared memory.
// A split writes its (m, l, acc[D]) partial in fp32; a second launch merges
// a slot's live splits in split-index order, so the output is the same bit
// for bit from run to run. A table of one split skips the merge and writes
// o itself. Any 1 <= D <= 1024 runs, built for the padded widths 16, 32,
// 64, 128 and 1024 (a row of more than 32 16-byte slices gives each lane
// several); dims past D load as zeros. Wider heads run on
// `paged_decode_wide_kernel`, 1024-dim chunks of the output a CTA, the
// scores summed over the whole row in every chunk's CTA alike (the score
// work is ceil(D / 1024) x). Blocks past pos are never read;
// dead slots (all-zero table row, pos 0) read position 0 of scratch block
// 0 and emit a finite row; pos < 0 gives zeros.
#include "dtype.cuh"

namespace dl4jt {
namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kUnroll = 4;            // rows of K and V in flight per lane
constexpr int kMaxSplitBlocks = 64;   // table entries of one split
constexpr int kMaxHeadDim = 1024;     // the widest instance, and
                                      // the wide kernel's chunk

// the storage word of one pool element, for the scalar (unaligned) path
template <typename T> struct Bits;
template <> struct Bits<float> { using type = uint32_t; };
template <> struct Bits<__nv_bfloat16> { using type = uint16_t; };
template <> struct Bits<int8_t> { using type = uint8_t; };

// 16 bytes of pool elements as floats
template <typename T>
__device__ __forceinline__ void unpack(const uint4& raw, float* out);
template <>
__device__ __forceinline__ void unpack<float>(const uint4& raw, float* out) {
  out[0] = __uint_as_float(raw.x);
  out[1] = __uint_as_float(raw.y);
  out[2] = __uint_as_float(raw.z);
  out[3] = __uint_as_float(raw.w);
}
template <>
__device__ __forceinline__ void unpack<__nv_bfloat16>(const uint4& raw,
                                                      float* out) {
  const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    out[2 * i] = __uint_as_float(w[i] << 16);
    out[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}
template <>
__device__ __forceinline__ void unpack<int8_t>(const uint4& raw, float* out) {
  const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      out[4 * i + j] = static_cast<float>(
          static_cast<int8_t>(static_cast<uint8_t>(w[i] >> (8 * j))));
    }
  }
}

// Elements d0 .. d0 + 16/sizeof(T) - 1 of a row as 16 raw bytes; dims at
// or past `dims` read as zeros. `vec`: one 16-byte load (the row is
// 16-byte aligned and `dims` a multiple of the vector), else element loads.
template <typename T>
__device__ __forceinline__ uint4 load_slice(const T* __restrict__ row,
                                            int d0, int dims, bool vec) {
  constexpr int kVec = 16 / sizeof(T);
  using W = typename Bits<T>::type;
  if (vec) {
    return d0 < dims ? __ldg(reinterpret_cast<const uint4*>(row + d0))
                     : make_uint4(0u, 0u, 0u, 0u);
  }
  const W* src = reinterpret_cast<const W*>(row);
  uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int e = 0; e < kVec; ++e) {
    const int d = d0 + e;
    const uint32_t bits = d < dims ? static_cast<uint32_t>(src[d]) : 0u;
    w[(e * sizeof(W)) / 4] |= bits << (8 * ((e * sizeof(W)) % 4));
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

template <typename TQ, typename TKV>
struct PagedArgs {
  const TQ* q;
  const TKV* k_pool;
  const TKV* v_pool;
  const float* k_scale;   // (num_blocks, block_size, heads), or null
  const float* v_scale;
  const int* tables;
  const int* pos;
  TQ* o;
  float* part_m;          // (slots, heads, n_splits)
  float* part_l;
  float* part_acc;        // (slots, heads, n_splits, head_dim)
  int heads, head_dim, num_blocks, block_size, nbmax;
  int blocks_per_split, n_splits, vec;
  float scale;
};

template <typename TQ, typename TKV, int DP>
__global__ void __launch_bounds__(kThreads)
paged_decode_split_kernel(const PagedArgs<TQ, TKV> a) {
  constexpr int kVec = 16 / sizeof(TKV);                  // per 16-byte load
  constexpr int kLpr = DP / kVec < 32 ? DP / kVec : 32;   // lanes per row
  constexpr int kPer = DP / (kVec * kLpr);   // 16-byte slices per lane
  constexpr int kDims = kPer * kVec;         // dims a lane owns
  constexpr int kGroups = 32 / kLpr;         // rows per warp load
  constexpr int kU = kPer >= kUnroll ? 1 : kUnroll / kPer;   // rows a lane
  constexpr int kRowsPerIter = kWarps * kGroups * kU;        // has in flight
  static_assert(kLpr >= 1 && kDims * kLpr == DP, "a row spans 1..32 lanes");
  __shared__ int tbl[kMaxSplitBlocks];
  __shared__ float red_m[kWarps];
  __shared__ float red_l[kWarps];
  __shared__ float red_acc[kWarps][DP];

  const int split = blockIdx.x;
  const int h = blockIdx.y;
  const int s = blockIdx.z;
  const int B = a.block_size;
  const int D = a.head_dim;
  const bool direct = a.n_splits == 1;
  const int p = a.pos[s];
  const int blk0 = split * a.blocks_per_split;
  const int first = blk0 * B;
  // an empty split writes nothing: the merge reads only splits <= pos
  if (!direct && (p < 0 || first > p)) return;
  const int n_blk = min(a.blocks_per_split, a.nbmax - blk0);
  // positions first .. first + rows - 1 of this split are attended
  const int rows = p < 0 ? 0 : min(p - first + 1, n_blk * B);
  const int need = rows > 0 ? (rows - 1) / B + 1 : 0;
  for (int j = threadIdx.x; j < need; j += kThreads) {
    int phys = a.tables[static_cast<long long>(s) * a.nbmax + blk0 + j];
    // an out-of-range entry is read as the reference's gather reads it: a
    // negative id counts from the end (numpy indexing), then XLA clamps
    // into [0, num_blocks); the engine never writes one
    if (phys < 0) phys += a.num_blocks;
    tbl[j] = min(max(phys, 0), a.num_blocks - 1);
  }

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane / kLpr;
  // slice j of this lane holds dims (j * kLpr + c) * kVec .. + kVec - 1:
  // neighbouring lanes read neighbouring 16 bytes of the row
  const int c = lane % kLpr;
  const TQ* qh = a.q + (static_cast<long long>(s) * a.heads + h) * D;
  float qv[kDims];
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
#pragma unroll
    for (int e = 0; e < kVec; ++e) {
      const int d = (j * kLpr + c) * kVec + e;
      qv[j * kVec + e] = d < D ? to_f(qh[d]) * a.scale : 0.f;
    }
  }
  __syncthreads();   // tbl

  // this lane's row group: running max, denominator, and its slices of acc
  float m = kNegInf;
  float l = 0.f;
  float acc[kDims];
#pragma unroll
  for (int e = 0; e < kDims; ++e) acc[e] = 0.f;
  const bool quant = a.k_scale != nullptr;
  const bool vec = a.vec != 0;
  for (int r0 = 0; r0 < rows; r0 += kRowsPerIter) {
    uint4 kr[kU][kPer], vr[kU][kPer];
    float ks[kU], vs[kU];
    bool ok[kU];
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int r = r0 + (u * kWarps + warp) * kGroups + g;
      ok[u] = r < rows;
      ks[u] = vs[u] = 1.f;
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        kr[u][j] = vr[u][j] = make_uint4(0u, 0u, 0u, 0u);
      }
      if (ok[u]) {
        const int jb = r / B;
        const long long row =
            (static_cast<long long>(tbl[jb]) * B + (r - jb * B)) * a.heads +
            h;
#pragma unroll
        for (int j = 0; j < kPer; ++j) {
          const int d0 = (j * kLpr + c) * kVec;
          kr[u][j] = load_slice(a.k_pool + row * D, d0, D, vec);
          vr[u][j] = load_slice(a.v_pool + row * D, d0, D, vec);
        }
        if (quant) {
          ks[u] = __ldg(a.k_scale + row);
          vs[u] = __ldg(a.v_scale + row);
        }
      }
    }
    float sc[kU];
    float mx = m;
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      float dot = 0.f;
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        float kf[kVec];
        unpack<TKV>(kr[u][j], kf);
#pragma unroll
        for (int e = 0; e < kVec; ++e) {
          dot = fmaf(qv[j * kVec + e], kf[e], dot);
        }
      }
#pragma unroll
      for (int off = kLpr / 2; off > 0; off >>= 1) {
        dot += __shfl_xor_sync(0xffffffffu, dot, off);
      }
      sc[u] = ok[u] ? dot * ks[u] : kNegInf;
      mx = fmaxf(mx, sc[u]);
    }
    const float alpha = expf(m - mx);
    l *= alpha;
#pragma unroll
    for (int e = 0; e < kDims; ++e) acc[e] *= alpha;
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      // a masked row adds nothing, also while m is still the -1e30 of a
      // row group that has seen no live position
      const float pu = ok[u] ? expf(sc[u] - mx) : 0.f;
      l += pu;
      const float pv = pu * vs[u];
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        float vf[kVec];
        unpack<TKV>(vr[u][j], vf);
#pragma unroll
        for (int e = 0; e < kVec; ++e) {
          acc[j * kVec + e] = fmaf(pv, vf[e], acc[j * kVec + e]);
        }
      }
    }
    m = mx;
  }

  // merge the warp's row groups (lanes kLpr, 2 kLpr, ... apart)
#pragma unroll
  for (int off = kLpr; off < 32; off <<= 1) {
    const float mo = __shfl_xor_sync(0xffffffffu, m, off);
    const float lo = __shfl_xor_sync(0xffffffffu, l, off);
    const float mn = fmaxf(m, mo);
    const float e1 = expf(m - mn);
    const float e2 = expf(mo - mn);
    l = l * e1 + lo * e2;
#pragma unroll
    for (int e = 0; e < kDims; ++e) {
      const float ao = __shfl_xor_sync(0xffffffffu, acc[e], off);
      acc[e] = acc[e] * e1 + ao * e2;
    }
    m = mn;
  }
  if (lane < kLpr) {
    if (lane == 0) {
      red_m[warp] = m;
      red_l[warp] = l;
    }
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
#pragma unroll
      for (int e = 0; e < kVec; ++e) {
        red_acc[warp][(j * kLpr + c) * kVec + e] = acc[j * kVec + e];
      }
    }
  }
  __syncthreads();
  // then the warps, in order
  float mm = red_m[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) mm = fmaxf(mm, red_m[w]);
  float ew[kWarps];
  float ll = 0.f;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    ew[w] = expf(red_m[w] - mm);
    ll += red_l[w] * ew[w];
  }
  const long long sh = static_cast<long long>(s) * a.heads + h;
  const long long part = sh * a.n_splits + split;
  for (int d = threadIdx.x; d < D; d += kThreads) {
    float aa = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) aa += red_acc[w][d] * ew[w];
    if (direct) {
      a.o[sh * D + d] = from_f<TQ>(aa / fmaxf(ll, 1e-30f));
    } else {
      a.part_acc[part * D + d] = aa;
    }
  }
  if (!direct && threadIdx.x == 0) {
    a.part_m[part] = mm;
    a.part_l[part] = ll;
  }
}

// Heads wider than kMaxHeadDim: grid (split, head * n_chunks + chunk,
// slot); the CTA owns the output dims chunk * 1024 .. + 1023. Each warp
// takes the split's positions round robin; for a position all 32 lanes
// take its full D-long score (lane l the dims l, l + 32, ..., then a
// butterfly sum), so every chunk's CTA reaches the same scores, m and l
// bit for bit; then each lane's 32 dims of its chunk take p v. The warps
// merge through shared memory in order, as above, and chunk 0 writes the
// split's m and l. Element loads, not 16-byte vectors: no main path runs
// these widths.
template <typename TQ, typename TKV>
__global__ void __launch_bounds__(kThreads)
paged_decode_wide_kernel(const PagedArgs<TQ, TKV> a, int n_chunks) {
  constexpr int DP = kMaxHeadDim;
  constexpr int kDims = DP / 32;   // dims of the chunk a lane owns
  __shared__ int tbl[kMaxSplitBlocks];
  __shared__ float red_m[kWarps];
  __shared__ float red_l[kWarps];
  __shared__ float red_acc[kWarps][DP];

  const int split = blockIdx.x;
  const int h = blockIdx.y / n_chunks;
  const int own0 = (blockIdx.y % n_chunks) * DP;
  const int s = blockIdx.z;
  const int B = a.block_size;
  const int D = a.head_dim;
  const bool direct = a.n_splits == 1;
  const int p = a.pos[s];
  const int blk0 = split * a.blocks_per_split;
  const int first = blk0 * B;
  if (!direct && (p < 0 || first > p)) return;
  const int n_blk = min(a.blocks_per_split, a.nbmax - blk0);
  const int rows = p < 0 ? 0 : min(p - first + 1, n_blk * B);
  const int need = rows > 0 ? (rows - 1) / B + 1 : 0;
  for (int j = threadIdx.x; j < need; j += kThreads) {
    int phys = a.tables[static_cast<long long>(s) * a.nbmax + blk0 + j];
    if (phys < 0) phys += a.num_blocks;
    tbl[j] = min(max(phys, 0), a.num_blocks - 1);
  }
  __syncthreads();   // tbl

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const TQ* qh = a.q + (static_cast<long long>(s) * a.heads + h) * D;
  const bool quant = a.k_scale != nullptr;
  float m = kNegInf;
  float l = 0.f;
  float acc[kDims];
#pragma unroll
  for (int e = 0; e < kDims; ++e) acc[e] = 0.f;
  for (int r = warp; r < rows; r += kWarps) {
    const int jb = r / B;
    const long long row =
        (static_cast<long long>(tbl[jb]) * B + (r - jb * B)) * a.heads + h;
    const TKV* kr = a.k_pool + row * D;
    const TKV* vr = a.v_pool + row * D;
    float dot = 0.f;
    for (int d = lane; d < D; d += 32) {
      dot = fmaf(to_f(qh[d]) * a.scale, to_f(kr[d]), dot);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      dot += __shfl_xor_sync(0xffffffffu, dot, off);
    }
    const float sc = quant ? dot * __ldg(a.k_scale + row) : dot;
    const float mx = fmaxf(m, sc);
    const float alpha = expf(m - mx);
    const float pu = expf(sc - mx);
    l = l * alpha + pu;
    const float pv = quant ? pu * __ldg(a.v_scale + row) : pu;
#pragma unroll
    for (int e = 0; e < kDims; ++e) {
      const int d = own0 + lane + 32 * e;
      acc[e] = fmaf(pv, d < D ? to_f(vr[d]) : 0.f, acc[e] * alpha);
    }
    m = mx;
  }
  if (lane == 0) {
    red_m[warp] = m;
    red_l[warp] = l;
  }
#pragma unroll
  for (int e = 0; e < kDims; ++e) red_acc[warp][lane + 32 * e] = acc[e];
  __syncthreads();
  float mm = red_m[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) mm = fmaxf(mm, red_m[w]);
  float ew[kWarps];
  float ll = 0.f;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    ew[w] = expf(red_m[w] - mm);
    ll += red_l[w] * ew[w];
  }
  const long long sh = static_cast<long long>(s) * a.heads + h;
  const long long part = sh * a.n_splits + split;
  for (int d = threadIdx.x; d < DP && own0 + d < D; d += kThreads) {
    float aa = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) aa += red_acc[w][d] * ew[w];
    if (direct) {
      a.o[sh * D + own0 + d] = from_f<TQ>(aa / fmaxf(ll, 1e-30f));
    } else {
      a.part_acc[part * D + own0 + d] = aa;
    }
  }
  if (!direct && threadIdx.x == 0 && own0 == 0) {
    a.part_m[part] = mm;
    a.part_l[part] = ll;
  }
}

// One CTA per (head, slot), threads over the output dims: the slot's live
// splits (those starting at or before pos) merged in split-index order.
template <typename TQ>
__global__ void __launch_bounds__(kThreads)
paged_decode_combine_kernel(const float* __restrict__ part_m,
                            const float* __restrict__ part_l,
                            const float* __restrict__ part_acc,
                            const int* __restrict__ pos, TQ* __restrict__ o,
                            int heads, int head_dim, int n_splits,
                            int split_positions) {
  const int h = blockIdx.x;
  const int s = blockIdx.y;
  const int p = pos[s];
  const int live = p < 0 ? 0 : min(n_splits, p / split_positions + 1);
  const long long sh = static_cast<long long>(s) * heads + h;
  const long long base = sh * n_splits;
  float mm = kNegInf;
  for (int i = 0; i < live; ++i) mm = fmaxf(mm, part_m[base + i]);
  float ll = 0.f;
  for (int i = 0; i < live; ++i) {
    ll += part_l[base + i] * expf(part_m[base + i] - mm);
  }
  for (int d = threadIdx.x; d < head_dim; d += kThreads) {
    float aa = 0.f;
    for (int i = 0; i < live; ++i) {
      aa += part_acc[(base + i) * head_dim + d] *
            expf(part_m[base + i] - mm);
    }
    o[sh * head_dim + d] = from_f<TQ>(aa / fmaxf(ll, 1e-30f));
  }
}

template <typename TQ, typename TKV>
int launch(const PagedArgs<TQ, TKV>& a, int slots, cudaStream_t stream) {
  const dim3 grid(a.n_splits, a.heads, slots);
  if (a.head_dim <= 16) {
    paged_decode_split_kernel<TQ, TKV, 16><<<grid, kThreads, 0, stream>>>(a);
  } else if (a.head_dim <= 32) {
    paged_decode_split_kernel<TQ, TKV, 32><<<grid, kThreads, 0, stream>>>(a);
  } else if (a.head_dim <= 64) {
    paged_decode_split_kernel<TQ, TKV, 64><<<grid, kThreads, 0, stream>>>(a);
  } else if (a.head_dim <= 128) {
    paged_decode_split_kernel<TQ, TKV, 128><<<grid, kThreads, 0, stream>>>(
        a);
  } else if (a.head_dim <= kMaxHeadDim) {
    // each lane holds several 16-byte slices of a row
    paged_decode_split_kernel<TQ, TKV, kMaxHeadDim>
        <<<grid, kThreads, 0, stream>>>(a);
  } else {
    const int n_chunks = (a.head_dim + kMaxHeadDim - 1) / kMaxHeadDim;
    if (static_cast<long long>(a.heads) * n_chunks > 65535) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    paged_decode_wide_kernel<TQ, TKV>
        <<<dim3(a.n_splits, a.heads * n_chunks, slots), kThreads, 0,
           stream>>>(a, n_chunks);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || a.n_splits == 1) return static_cast<int>(err);
  paged_decode_combine_kernel<TQ>
      <<<dim3(a.heads, slots), kThreads, 0, stream>>>(
          a.part_m, a.part_l, a.part_acc, a.pos, a.o, a.heads, a.head_dim,
          a.n_splits, a.blocks_per_split * a.block_size);
  return static_cast<int>(cudaGetLastError());
}

template <typename TQ, typename TKV>
int launch_args(const void* q, const void* k_pool, const void* v_pool,
                const void* k_scale, const void* v_scale, const void* tables,
                const void* pos, void* o, void* workspace, int slots,
                int heads, int head_dim, int num_blocks, int block_size,
                int nbmax, int blocks_per_split, int n_splits, float scale,
                cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(TKV);
  const bool aligned = ((reinterpret_cast<uintptr_t>(k_pool) |
                         reinterpret_cast<uintptr_t>(v_pool)) & 15) == 0;
  // the workspace: m, then l, then acc of every (slot, head, split)
  float* ws = static_cast<float*>(workspace);
  const long long parts = static_cast<long long>(slots) * heads * n_splits;
  float* part_l = ws == nullptr ? nullptr : ws + parts;
  float* part_acc = ws == nullptr ? nullptr : ws + 2 * parts;
  const PagedArgs<TQ, TKV> a{
      static_cast<const TQ*>(q), static_cast<const TKV*>(k_pool),
      static_cast<const TKV*>(v_pool), static_cast<const float*>(k_scale),
      static_cast<const float*>(v_scale), static_cast<const int*>(tables),
      static_cast<const int*>(pos), static_cast<TQ*>(o), ws, part_l,
      part_acc, heads, head_dim, num_blocks, block_size, nbmax,
      blocks_per_split, n_splits,
      static_cast<int>(aligned && head_dim % kVec == 0), scale};
  return launch<TQ, TKV>(a, slots, stream);
}

template <typename TQ>
int launch_kv(int kv_dtype, const void* q, const void* k_pool,
              const void* v_pool, const void* k_scale, const void* v_scale,
              const void* tables, const void* pos, void* o, void* workspace,
              int slots, int heads, int head_dim, int num_blocks,
              int block_size, int nbmax, int blocks_per_split, int n_splits,
              float scale, cudaStream_t stream) {
  switch (kv_dtype) {
    case kF32:
      return launch_args<TQ, float>(
          q, k_pool, v_pool, k_scale, v_scale, tables, pos, o, workspace,
          slots, heads, head_dim, num_blocks, block_size, nbmax,
          blocks_per_split, n_splits, scale, stream);
    case kBF16:
      return launch_args<TQ, __nv_bfloat16>(
          q, k_pool, v_pool, k_scale, v_scale, tables, pos, o, workspace,
          slots, heads, head_dim, num_blocks, block_size, nbmax,
          blocks_per_split, n_splits, scale, stream);
    case kI8:
      return launch_args<TQ, int8_t>(
          q, k_pool, v_pool, k_scale, v_scale, tables, pos, o, workspace,
          slots, heads, head_dim, num_blocks, block_size, nbmax,
          blocks_per_split, n_splits, scale, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace
}  // namespace dl4jt

extern "C" {

// q, o: (slots, heads, head_dim) dtype `q_dtype` (0 fp32, 1 bf16);
// k_pool, v_pool: (num_blocks, block_size, heads, head_dim) dtype
// `kv_dtype` (0 fp32, 1 bf16, 2 int8); k_scale, v_scale: (num_blocks,
// block_size, heads) fp32 for int8 pools, else null; tables: (slots,
// nbmax) int32; pos: (slots,) int32. All contiguous. The positions are cut
// into n_splits splits of blocks_per_split blocks (at most 64 blocks);
// workspace: fp32 scratch of slots * heads * n_splits * (head_dim + 2)
// elements when n_splits > 1 (else unused). Any head_dim >= 1. Returns a
// cudaError_t.
int paged_decode(const void* q, const void* k_pool, const void* v_pool,
                 const void* k_scale, const void* v_scale, const void* tables,
                 const void* pos, void* o, void* workspace, int slots,
                 int heads, int head_dim, int num_blocks, int block_size,
                 int nbmax, int blocks_per_split, int n_splits, float scale,
                 int q_dtype, int kv_dtype, void* stream) {
  if (slots < 1 || heads < 1 || head_dim < 1 || num_blocks < 1 || block_size < 1 || blocks_per_split < 1 ||
      blocks_per_split > dl4jt::kMaxSplitBlocks || n_splits < 1 ||
      heads > 65535 || slots > 65535 ||
      static_cast<long long>(n_splits) * blocks_per_split <
          static_cast<long long>(nbmax) ||
      (n_splits > 1 && workspace == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (q_dtype == dl4jt::kF32) {
    return dl4jt::launch_kv<float>(
        kv_dtype, q, k_pool, v_pool, k_scale, v_scale, tables, pos, o,
        workspace, slots, heads, head_dim, num_blocks, block_size, nbmax,
        blocks_per_split, n_splits, scale, st);
  }
  if (q_dtype == dl4jt::kBF16) {
    return dl4jt::launch_kv<__nv_bfloat16>(
        kv_dtype, q, k_pool, v_pool, k_scale, v_scale, tables, pos, o,
        workspace, slots, heads, head_dim, num_blocks, block_size, nbmax,
        blocks_per_split, n_splits, scale, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* paged_decode_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
