// The attention forward shared by the packed kernel (mha_packed_fwd.cu)
// and the streamed kernel (flash_fwd.cu): per head, o = softmax(scale *
// q k^T [causal]) v and lse = m + log l, on the packed (B, T, H*D)
// projection layout, fp32 accumulation, optional bf16 probabilities. The
// streamed (BH, T, D) layout is the packed one with one head.
//
// bf16 operands at head_dim 64 (every main path: the MLM step, the T=8192
// step, the serving prefill) take the tensor-core kernel of
// attention_fwd_tc.cuh, whose note gives the bound and the design. The
// template below serves the rest: fp32 operands (tests and the fp32 parity
// runs; fp32 products on tensor cores would need TF32, which the package
// turns off) and bf16 at every other head dim, which no main path runs.
//
// Head dims: every D >= 1 runs. D is a run-time argument; up to 256 the
// template is built for the padded width DP in {16, 32, 64, 128, 256},
// the least one >= D. Dims D..DP-1 load as zeros (they add nothing to q.k
// and give no output dims), only the first D dims of o are written, and
// the caller's scale is 1/sqrt(D) of the real D. The tiles live in
// dynamic shared memory sized from DP (`FwdSmem`): at DP = 256 they take
// 84 KB, past the 48 KB a block gets without opting in, and the query
// rows move from registers (DP floats a thread) to shared memory too.
// Wider heads are cut into 256-wide chunks (`attention_fwd_chunked_kernel`
// below), which keeps every CTA at the 256-wide instance's 84 KB.
//
// The FMA template: the TPU kernels hold a whole head's (T, T) scores in
// VMEM (the packed one) or stream 512-key blocks through it (the streamed
// one); an SM has at most 227 KB, so this kernel streams K/V in tiles of
// BN keys through shared memory with the online-softmax recurrence
// (running max m, denominator l, accumulator acc) and never materializes
// the scores. Grid (q-tile of kRows rows, head, batch); each query row is
// served by kLanes threads: for the scores a lane takes every kLanes-th
// key of the tile (full D-long dot products, row max and sum by warp
// shuffles), for P.V a lane owns every kLanes-th output dimension and
// reads the row's probabilities back from shared memory. Heads are
// addressed through the packed row stride H*D at column h*D, so no head
// transpose is made. Causal CTAs stop at the diagonal tile.
#pragma once

#include <type_traits>

#include "attention_fwd_tc.cuh"

namespace dl4jt {

constexpr int kFwdRows = 16;                     // query rows per CTA
constexpr int kFwdLanes = 8;                     // threads per query row
constexpr int kFwdThreads = kFwdRows * kFwdLanes;   // 128

// Shared-memory layout of one forward CTA at padded width D and BN-key
// tiles, in floats: k_s[BN][D + 1], v_s[BN][D], p_s[kFwdRows][BN + 1],
// and, for D > 128, the scaled query rows q_s[kFwdRows][D + 1]. The +1
// pads: lanes of a row read different keys at the same d (k_s), the 4
// rows of a warp read the same key of different rows (p_s) and the same
// d of different rows (q_s).
template <int D, int BN>
struct FwdSmem {
  static constexpr bool kQShared = D > 128;
  static constexpr int kK = 0;
  static constexpr int kV = kK + BN * (D + 1);
  static constexpr int kP = kV + BN * D;
  static constexpr int kQ = kP + kFwdRows * (BN + 1);
  static constexpr int kFloats = kQ + (kQShared ? kFwdRows * (D + 1) : 0);
  static constexpr int kBytes = kFloats * 4;
};

template <typename Elt, int D, int BN>
__global__ void __launch_bounds__(kFwdThreads)
attention_fwd_kernel(const Elt* __restrict__ q, const Elt* __restrict__ k,
                     const Elt* __restrict__ v, Elt* __restrict__ o,
                     float* __restrict__ lse, int seq, int heads,
                     int head_dim, float scale, int causal, int p_bf16,
                     int clamp_l) {
  // D: the padded width this instance is built for; head_dim <= D the
  // real one (dims past it are zeros)
  constexpr int kRows = kFwdRows;
  constexpr int kLanes = kFwdLanes;
  constexpr int kThreads = kFwdThreads;
  constexpr int kKeysPerLane = BN / kLanes;
  constexpr int kDimsPerLane = D / kLanes;
  // the D-long dot products unroll fully up to D = 128; the 256-wide
  // instance by 16 (the same sums in the same order), which keeps its code
  // and build time in bounds
  constexpr int kUnroll = D > 128 ? 16 : D;
  using Smem = FwdSmem<D, BN>;
  extern __shared__ __align__(16) float fma_smem[];
  float(*k_s)[D + 1] = reinterpret_cast<float(*)[D + 1]>(fma_smem + Smem::kK);
  float(*v_s)[D] = reinterpret_cast<float(*)[D]>(fma_smem + Smem::kV);
  float(*p_s)[BN + 1] =
      reinterpret_cast<float(*)[BN + 1]>(fma_smem + Smem::kP);
  float(*q_s)[D + 1] = reinterpret_cast<float(*)[D + 1]>(fma_smem + Smem::kQ);

  const int tid = threadIdx.x;
  const int r = tid / kLanes;
  const int lane = tid % kLanes;
  const int q0 = blockIdx.x * kRows;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int row = q0 + r;
  const bool row_ok = row < seq;
  const long long stride = static_cast<long long>(heads) * head_dim;
  const long long base = static_cast<long long>(b) * seq * stride +
                         static_cast<long long>(h) * head_dim;

  // scale folded into q and rounded back to the input dtype, as the
  // reference does before its q.k^T dot; in registers up to D = 128, in
  // shared memory (visible after the first tile's barriers) above
  float qr[Smem::kQShared ? 1 : D];
  if constexpr (Smem::kQShared) {
    for (int idx = tid; idx < kRows * D; idx += kThreads) {
      const int rr = idx / D;
      const int d = idx % D;
      const int qrow = q0 + rr;
      q_s[rr][d] =
          qrow < seq && d < head_dim
              ? round_to<Elt>(to_f(q[base + qrow * stride + d]) * scale)
              : 0.f;
    }
  } else {
#pragma unroll
    for (int d = 0; d < D; ++d) {
      qr[d] = row_ok && d < head_dim
                  ? round_to<Elt>(to_f(q[base + row * stride + d]) * scale)
                  : 0.f;
    }
  }
  float acc[kDimsPerLane];
#pragma unroll
  for (int e = 0; e < kDimsPerLane; ++e) acc[e] = 0.f;
  float m = kNegInf;
  float l = 0.f;

  const int kv_end = causal ? min(seq, q0 + kRows) : seq;
  const int n_tiles = (kv_end + BN - 1) / BN;
  for (int tile = 0; tile < n_tiles; ++tile) {
    const int k0 = tile * BN;
    __syncthreads();   // the previous tile's readers are done
    for (int idx = tid; idx < BN * D; idx += kThreads) {
      const int kk = idx / D;
      const int d = idx % D;
      const int key = k0 + kk;
      float kv = 0.f, vv = 0.f;
      if (key < seq && d < head_dim) {
        kv = to_f(k[base + key * stride + d]);
        vv = to_f(v[base + key * stride + d]);
      }
      k_s[kk][d] = kv;
      v_s[kk][d] = vv;
    }
    __syncthreads();

    float s[kKeysPerLane];
    float tile_max = kNegInf;
#pragma unroll
    for (int i = 0; i < kKeysPerLane; ++i) {
      const int kk = lane + i * kLanes;
      const int key = k0 + kk;
      float dot = 0.f;
      if constexpr (Smem::kQShared) {
#pragma unroll (kUnroll)
        for (int d = 0; d < D; ++d) dot = fmaf(q_s[r][d], k_s[kk][d], dot);
      } else {
#pragma unroll
        for (int d = 0; d < D; ++d) dot = fmaf(qr[d], k_s[kk][d], dot);
      }
      const bool ok = key < seq && (!causal || key <= row);
      s[i] = ok ? dot : kNegInf;
      tile_max = fmaxf(tile_max, s[i]);
    }
#pragma unroll
    for (int off = kLanes / 2; off > 0; off >>= 1) {
      tile_max = fmaxf(tile_max, __shfl_xor_sync(0xffffffffu, tile_max, off));
    }
    // tile 0 holds key 0, which every row sees: m is a real score from
    // the first tile on, so masked scores exp to exactly 0
    const float m_new = fmaxf(m, tile_max);
    const float alpha = expf(m - m_new);
    float l_part = 0.f;
#pragma unroll
    for (int i = 0; i < kKeysPerLane; ++i) {
      float p;
      if (p_bf16) {
        p = round_to<__nv_bfloat16>(
            expf(round_to<__nv_bfloat16>(s[i] - m_new)));
      } else {
        p = expf(s[i] - m_new);
      }
      l_part += p;
      // the P.V product takes p in the input dtype, the row sum does not
      p_s[r][lane + i * kLanes] = round_to<Elt>(p);
    }
#pragma unroll
    for (int off = kLanes / 2; off > 0; off >>= 1) {
      l_part += __shfl_xor_sync(0xffffffffu, l_part, off);
    }
    l = l * alpha + l_part;
    m = m_new;
    __syncthreads();   // p_s complete
#pragma unroll
    for (int e = 0; e < kDimsPerLane; ++e) {
      const int d = lane + e * kLanes;
      float a = acc[e] * alpha;
#pragma unroll 8
      for (int kk = 0; kk < BN; ++kk) a = fmaf(p_s[r][kk], v_s[kk][d], a);
      acc[e] = a;
    }
  }

  // the streamed reference floors l at 1e-30 before o and lse
  if (clamp_l) l = fmaxf(l, 1e-30f);
  if (row_ok) {
#pragma unroll
    for (int e = 0; e < kDimsPerLane; ++e) {
      const int d = lane + e * kLanes;
      if (d < head_dim) o[base + row * stride + d] = from_f<Elt>(acc[e] / l);
    }
    if (lane == 0) {
      lse[(static_cast<long long>(b) * heads + h) * seq + row] = m + logf(l);
    }
  }
}

// One FMA instance: opt it into its shared memory, then launch.
template <typename Elt, int D, int BN>
int launch_fwd_fma(const dim3& grid, const Elt* q, const Elt* k,
                   const Elt* v, Elt* o, float* lse, int seq, int heads,
                   int head_dim, float scale, int causal, int p_bf16,
                   int clamp_l, cudaStream_t stream) {
  constexpr int kBytes = FwdSmem<D, BN>::kBytes;
  const cudaError_t err =
      reserve_smem<attention_fwd_kernel<Elt, D, BN>>(kBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  attention_fwd_kernel<Elt, D, BN><<<grid, kFwdThreads, kBytes, stream>>>(
      q, k, v, o, lse, seq, heads, head_dim, scale, causal, p_bf16,
      clamp_l);
  return static_cast<int>(cudaGetLastError());
}

// Heads wider than 256, cut into chunks of kFwdChunk dims. The CTA of
// chunk c (grid z = batch * n_chunks + c) owns o's dims c * 256 .. c * 256
// + 255 and stages one chunk at a time through the 256-wide instance's
// tiles: for each BN-key tile it sums the scores over the chunks in order
// (S = sum_c q_c k_c^T, each chunk's q and k passing through q_s and k_s),
// staging its own chunk of v beside the first; then the online softmax and
// P.V for its own dims, as above. Every chunk's CTA of a row computes the
// same scores in the same order, so m, l and lse agree bit for bit between
// them; chunk 0 writes lse. Shared memory is FwdSmem<256, BN> whatever the
// width, and the score work (and the q and k reads) is n_chunks times one
// CTA's: ceil(D / 256) x at D > 256.
constexpr int kFwdChunk = 256;

template <typename Elt, int BN>
__global__ void __launch_bounds__(kFwdThreads)
attention_fwd_chunked_kernel(const Elt* __restrict__ q,
                             const Elt* __restrict__ k,
                             const Elt* __restrict__ v, Elt* __restrict__ o,
                             float* __restrict__ lse, int seq, int heads,
                             int head_dim, int n_chunks, float scale,
                             int causal, int p_bf16, int clamp_l) {
  constexpr int D = kFwdChunk;
  constexpr int kRows = kFwdRows;
  constexpr int kLanes = kFwdLanes;
  constexpr int kThreads = kFwdThreads;
  constexpr int kKeysPerLane = BN / kLanes;
  constexpr int kDimsPerLane = D / kLanes;
  using Smem = FwdSmem<D, BN>;
  static_assert(Smem::kQShared, "the chunk's query rows live in q_s");
  extern __shared__ __align__(16) float fma_smem[];
  float(*k_s)[D + 1] = reinterpret_cast<float(*)[D + 1]>(fma_smem + Smem::kK);
  float(*v_s)[D] = reinterpret_cast<float(*)[D]>(fma_smem + Smem::kV);
  float(*p_s)[BN + 1] =
      reinterpret_cast<float(*)[BN + 1]>(fma_smem + Smem::kP);
  float(*q_s)[D + 1] = reinterpret_cast<float(*)[D + 1]>(fma_smem + Smem::kQ);

  const int tid = threadIdx.x;
  const int r = tid / kLanes;
  const int lane = tid % kLanes;
  const int q0 = blockIdx.x * kRows;
  const int h = blockIdx.y;
  const int b = blockIdx.z / n_chunks;
  const int own0 = (blockIdx.z % n_chunks) * D;   // this CTA's dims of o
  const int row = q0 + r;
  const bool row_ok = row < seq;
  const long long stride = static_cast<long long>(heads) * head_dim;
  const long long base = static_cast<long long>(b) * seq * stride +
                         static_cast<long long>(h) * head_dim;

  float acc[kDimsPerLane];
#pragma unroll
  for (int e = 0; e < kDimsPerLane; ++e) acc[e] = 0.f;
  float m = kNegInf;
  float l = 0.f;

  const int kv_end = causal ? min(seq, q0 + kRows) : seq;
  const int n_tiles = (kv_end + BN - 1) / BN;
  for (int tile = 0; tile < n_tiles; ++tile) {
    const int k0 = tile * BN;
    float s[kKeysPerLane];
#pragma unroll
    for (int i = 0; i < kKeysPerLane; ++i) s[i] = 0.f;
    for (int c0 = 0; c0 < head_dim; c0 += D) {
      __syncthreads();   // the previous chunk's (or tile's) readers are done
      for (int idx = tid; idx < kRows * D; idx += kThreads) {
        const int rr = idx / D;
        const int d = c0 + idx % D;
        const int qrow = q0 + rr;
        q_s[rr][idx % D] =
            qrow < seq && d < head_dim
                ? round_to<Elt>(to_f(q[base + qrow * stride + d]) * scale)
                : 0.f;
      }
      for (int idx = tid; idx < BN * D; idx += kThreads) {
        const int kk = idx / D;
        const int dd = idx % D;
        const int key = k0 + kk;
        k_s[kk][dd] = key < seq && c0 + dd < head_dim
                          ? to_f(k[base + key * stride + c0 + dd])
                          : 0.f;
        if (c0 == 0) {
          v_s[kk][dd] = key < seq && own0 + dd < head_dim
                            ? to_f(v[base + key * stride + own0 + dd])
                            : 0.f;
        }
      }
      __syncthreads();
#pragma unroll
      for (int i = 0; i < kKeysPerLane; ++i) {
        const int kk = lane + i * kLanes;
        float dot = s[i];
#pragma unroll 16
        for (int d = 0; d < D; ++d) dot = fmaf(q_s[r][d], k_s[kk][d], dot);
        s[i] = dot;
      }
    }

    float tile_max = kNegInf;
#pragma unroll
    for (int i = 0; i < kKeysPerLane; ++i) {
      const int key = k0 + lane + i * kLanes;
      const bool ok = key < seq && (!causal || key <= row);
      s[i] = ok ? s[i] : kNegInf;
      tile_max = fmaxf(tile_max, s[i]);
    }
#pragma unroll
    for (int off = kLanes / 2; off > 0; off >>= 1) {
      tile_max = fmaxf(tile_max, __shfl_xor_sync(0xffffffffu, tile_max, off));
    }
    const float m_new = fmaxf(m, tile_max);
    const float alpha = expf(m - m_new);
    float l_part = 0.f;
#pragma unroll
    for (int i = 0; i < kKeysPerLane; ++i) {
      float p;
      if (p_bf16) {
        p = round_to<__nv_bfloat16>(
            expf(round_to<__nv_bfloat16>(s[i] - m_new)));
      } else {
        p = expf(s[i] - m_new);
      }
      l_part += p;
      p_s[r][lane + i * kLanes] = round_to<Elt>(p);
    }
#pragma unroll
    for (int off = kLanes / 2; off > 0; off >>= 1) {
      l_part += __shfl_xor_sync(0xffffffffu, l_part, off);
    }
    l = l * alpha + l_part;
    m = m_new;
    __syncthreads();   // p_s complete
#pragma unroll
    for (int e = 0; e < kDimsPerLane; ++e) {
      const int d = lane + e * kLanes;
      float a = acc[e] * alpha;
#pragma unroll 8
      for (int kk = 0; kk < BN; ++kk) a = fmaf(p_s[r][kk], v_s[kk][d], a);
      acc[e] = a;
    }
  }

  if (clamp_l) l = fmaxf(l, 1e-30f);
  if (row_ok) {
#pragma unroll
    for (int e = 0; e < kDimsPerLane; ++e) {
      const int d = own0 + lane + e * kLanes;
      if (d < head_dim) o[base + row * stride + d] = from_f<Elt>(acc[e] / l);
    }
    if (lane == 0 && own0 == 0) {
      lse[(static_cast<long long>(b) * heads + h) * seq + row] = m + logf(l);
    }
  }
}

template <typename Elt, int BN>
int launch_fwd_chunked(int batch, int seq, int heads, const Elt* q,
                       const Elt* k, const Elt* v, Elt* o, float* lse,
                       int head_dim, float scale, int causal, int p_bf16,
                       int clamp_l, cudaStream_t stream) {
  const int n_chunks = (head_dim + kFwdChunk - 1) / kFwdChunk;
  const long long z = static_cast<long long>(batch) * n_chunks;
  if (z > 65535) return static_cast<int>(cudaErrorInvalidValue);
  constexpr int kBytes = FwdSmem<kFwdChunk, BN>::kBytes;
  const cudaError_t err =
      reserve_smem<attention_fwd_chunked_kernel<Elt, BN>>(kBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((seq + kFwdRows - 1) / kFwdRows, heads,
                  static_cast<unsigned>(z));
  attention_fwd_chunked_kernel<Elt, BN>
      <<<grid, kFwdThreads, kBytes, stream>>>(q, k, v, o, lse, seq, heads,
                                             head_dim, n_chunks, scale,
                                             causal, p_bf16, clamp_l);
  return static_cast<int>(cudaGetLastError());
}

// Launch the forward for one dtype; returns the launch's cudaError_t.
// bf16 at head_dim 64 launches the tensor-core kernel, head dims up to 256
// the FMA template at the least built width >= head_dim, wider heads the
// chunked kernel.
template <typename Elt>
int launch_attention_fwd(const void* q, const void* k, const void* v,
                         void* o, void* lse, int batch, int seq, int heads,
                         int head_dim, float scale, int causal, int p_bf16,
                         int clamp_l, cudaStream_t stream) {
  const dim3 grid((seq + kFwdRows - 1) / kFwdRows, heads, batch);
  const Elt* qp = static_cast<const Elt*>(q);
  const Elt* kp = static_cast<const Elt*>(k);
  const Elt* vp = static_cast<const Elt*>(v);
  Elt* op = static_cast<Elt*>(o);
  float* lp = static_cast<float*>(lse);
  if (head_dim < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (head_dim > kFwdChunk) {
    return launch_fwd_chunked<Elt, 32>(batch, seq, heads, qp, kp, vp, op, lp,
                                       head_dim, scale, causal, p_bf16,
                                       clamp_l, stream);
  }
  if constexpr (std::is_same<Elt, __nv_bfloat16>::value) {
    if (head_dim == 64) {
      const tc::FwdArgs a{qp, kp, vp, op, lp, batch, seq, heads, scale,
                          causal, clamp_l};
      return tc::launch_attention_fwd_tc(a, p_bf16, stream);
    }
  }
#define DL4JT_FWD(DP, BN)                                                 \
  return launch_fwd_fma<Elt, DP, BN>(grid, qp, kp, vp, op, lp, seq, heads, \
                                     head_dim, scale, causal, p_bf16,     \
                                     clamp_l, stream)
  if (head_dim <= 16) DL4JT_FWD(16, 64);
  if (head_dim <= 32) DL4JT_FWD(32, 64);
  if (head_dim <= 64) DL4JT_FWD(64, 64);
  if (head_dim <= 128) DL4JT_FWD(128, 32);   // under the 48 KB default
  DL4JT_FWD(256, 32);                          // 84 KB, opted in
#undef DL4JT_FWD
}

}  // namespace dl4jt
