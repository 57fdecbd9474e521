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
// turns off) and bf16 at head dims 16, 32 and 128, which no main path runs.
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

template <typename Elt, int D, int BN>
__global__ void __launch_bounds__(kFwdThreads)
attention_fwd_kernel(const Elt* __restrict__ q, const Elt* __restrict__ k,
                     const Elt* __restrict__ v, Elt* __restrict__ o,
                     float* __restrict__ lse, int seq, int heads,
                     float scale, int causal, int p_bf16, int clamp_l) {
  constexpr int kRows = kFwdRows;
  constexpr int kLanes = kFwdLanes;
  constexpr int kThreads = kFwdThreads;
  constexpr int kKeysPerLane = BN / kLanes;
  constexpr int kDimsPerLane = D / kLanes;
  // +1 pads: lanes of a row read different keys at the same d (k_s) and
  // the 4 rows of a warp read the same key of different rows (p_s)
  __shared__ float k_s[BN][D + 1];
  __shared__ float v_s[BN][D];
  __shared__ float p_s[kRows][BN + 1];

  const int tid = threadIdx.x;
  const int r = tid / kLanes;
  const int lane = tid % kLanes;
  const int q0 = blockIdx.x * kRows;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int row = q0 + r;
  const bool row_ok = row < seq;
  const long long stride = static_cast<long long>(heads) * D;
  const long long base =
      static_cast<long long>(b) * seq * stride + static_cast<long long>(h) * D;

  // scale folded into q and rounded back to the input dtype, as the
  // reference does before its q.k^T dot
  float qr[D];
#pragma unroll
  for (int d = 0; d < D; ++d) {
    qr[d] = row_ok ? round_to<Elt>(to_f(q[base + row * stride + d]) * scale)
                   : 0.f;
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
      if (key < seq) {
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
#pragma unroll
      for (int d = 0; d < D; ++d) dot = fmaf(qr[d], k_s[kk][d], dot);
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
      o[base + row * stride + lane + e * kLanes] = from_f<Elt>(acc[e] / l);
    }
    if (lane == 0) {
      lse[(static_cast<long long>(b) * heads + h) * seq + row] = m + logf(l);
    }
  }
}

// Launch the forward for one dtype; returns the launch's cudaError_t.
// bf16 at head_dim 64 launches the tensor-core kernel, everything else the
// FMA template.
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
  switch (head_dim) {
    case 16:
      attention_fwd_kernel<Elt, 16, 64><<<grid, kFwdThreads, 0, stream>>>(
          qp, kp, vp, op, lp, seq, heads, scale, causal, p_bf16, clamp_l);
      break;
    case 32:
      attention_fwd_kernel<Elt, 32, 64><<<grid, kFwdThreads, 0, stream>>>(
          qp, kp, vp, op, lp, seq, heads, scale, causal, p_bf16, clamp_l);
      break;
    case 64:
      if constexpr (std::is_same<Elt, __nv_bfloat16>::value) {
        const tc::FwdArgs a{qp, kp, vp, op, lp, batch, seq, heads, scale,
                            causal, clamp_l};
        return tc::launch_attention_fwd_tc(a, p_bf16, stream);
      } else {
        attention_fwd_kernel<Elt, 64, 64><<<grid, kFwdThreads, 0, stream>>>(
            qp, kp, vp, op, lp, seq, heads, scale, causal, p_bf16, clamp_l);
      }
      break;
    case 128:   // 32-key tiles keep shared memory under the 48 KB static cap
      attention_fwd_kernel<Elt, 128, 32><<<grid, kFwdThreads, 0, stream>>>(
          qp, kp, vp, op, lp, seq, heads, scale, causal, p_bf16, clamp_l);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace dl4jt
