// Attention backward for sm_90a: dq, dk, dv from q, k, v, dO and the
// forward's lse, on the packed (B, T, H*D) layout (the streamed (BH, T, D)
// layout is the packed one with one head).
//
// Replaces three Pallas kernels of deeplearning4j_tpu/ops/pallas_kernels.py:
// - `_mha_packed_bwd_kernel` (called from `_mha_packed_bwd_rule`): entry
//   `mha_packed_bwd`; delta_i = sum_j p_ij dp_ij is taken over the whole
//   row inside the kernel, p in fp32 or bf16;
// - `_flash_bwd_dq_kernel` (`_launch_bwd_dq`): entry `flash_bwd_dq`, delta
//   given (the caller's rowsum(dO * O)), fp32 p;
// - `_flash_bwd_dkv_kernel` (`_launch_bwd_dkv`): entry `flash_bwd_dkv`.
// Each rebuilds p = exp(s - lse) from the saved lse; ds = p (dp - delta)
// in the input dtype (or pb * (dp - delta) rounded, for bf16 p);
// dq = scale * ds k, dk = ds^T (scale q), dv = pb^T dO.
//
// The TPU kernel holds a head's whole (T, T) block in VMEM and
// accumulates dk/dv and dq in one pass; an SM has 227 KB, and CTAs run in
// parallel with nothing carried between them. So the work is split into
// two deterministic passes without atomics:
// 1. dq pass, one CTA per query tile: when delta is not given, a first
//    sweep over the K/V tiles takes delta from p rebuilt in p's dtype
//    (exactly the TPU's delta) and writes it for pass 2; a second sweep
//    accumulates dq from ds.
// 2. dk/dv pass, one CTA per key tile: it sweeps the query tiles (causal
//    CTAs start at their diagonal) and accumulates dk and dv.
//
// bf16 operands at head_dim 64 (every training path) take the tensor-core
// kernels of attention_bwd_tc.cuh, whose note gives the bound and the
// design. fp32 operands (tests and the fp32 parity runs; fp32 products on
// tensor cores would need TF32, which the package turns off) and bf16 at
// every other head dim take the FMA loops below. They tile 16 rows per CTA
// with 8 lanes per row; a lane takes every 8th key (or query) of a tile for
// the D-long dot products and owns every 8th output dimension for the sums;
// +1 pads keep the shared-memory reads free of bank conflicts.
//
// Head dims: every D >= 1 runs, as in the forward (attention_fwd.cuh). Up
// to 256 the FMA templates are built for the padded width DP in {16, 32,
// 64, 128, 256}, the least one >= D, take D at run time, load dims
// D..DP-1 as zeros and write only the first D dims of dq, dk and dv. Their
// tiles live in dynamic shared memory sized from DP and the tile
// (`DqSmem`, `DkvSmem`): at DP = 256 the dq pass takes 100 KB and the
// dk/dv pass, with 64-query tiles, 169 KB (1 CTA an SM), both opted in
// past the 48 KB default. A 512-wide head would need 329 KB in the dk/dv
// pass at those tiles, over the H100's 227 KB a block, so wider heads are
// cut into 256-wide chunks instead (the chunked passes below): each CTA
// owns one chunk of its rows' output dims, sums the scores and dp over
// every chunk in one fixed order through the 256-wide tiles, and stages
// its own chunk again for its sums. Shared memory stays the 256-wide
// instance's at any width; the score work is ceil(D / 256) x.
#include "attention_bwd_tc.cuh"

namespace dl4jt {
namespace {

constexpr int kRows = 16;                  // queries (dq) or keys (dk/dv)
constexpr int kLanes = 8;                  // threads per row
constexpr int kThreads = kRows * kLanes;   // 128

// full unroll up to D = 128; by 16 at 256 (the same sum in the same
// order), which keeps the 256-wide instances' code and build time in bounds
template <int D>
__device__ __forceinline__ float dot_acc(const float* a, const float* b,
                                        float acc) {
  constexpr int kUnroll = D > 128 ? 16 : D;
#pragma unroll (kUnroll)
  for (int d = 0; d < D; ++d) acc = fmaf(a[d], b[d], acc);
  return acc;
}

template <int D>
__device__ __forceinline__ float dot_rows(const float* a, const float* b) {
  return dot_acc<D>(a, b, 0.f);
}

// Shared-memory layouts, in floats, of the dq pass (BN-key tiles) and the
// dk/dv pass (BM-query tiles) at padded width D; +1 pads keep the reads
// free of bank conflicts
template <int D, int BN>
struct DqSmem {
  static constexpr int kQ = 0;                          // q_s[kRows][D + 1]
  static constexpr int kDo = kQ + kRows * (D + 1);      // do_s[kRows][D + 1]
  static constexpr int kK = kDo + kRows * (D + 1);      // k_s[BN][D + 1]
  static constexpr int kV = kK + BN * (D + 1);          // v_s[BN][D + 1]
  static constexpr int kDs = kV + BN * (D + 1);         // ds_s[kRows][BN + 1]
  static constexpr int kBytes = (kDs + kRows * (BN + 1)) * 4;
};

template <int D, int BM>
struct DkvSmem {
  static constexpr int kK = 0;                          // k_s[kRows][D + 1]
  static constexpr int kV = kK + kRows * (D + 1);       // v_s[kRows][D + 1]
  static constexpr int kQ = kV + kRows * (D + 1);       // q_s[BM][D + 1]
  static constexpr int kDo = kQ + BM * (D + 1);         // do_s[BM][D + 1]
  static constexpr int kP = kDo + BM * (D + 1);         // p_s[kRows][BM + 1]
  static constexpr int kDs = kP + kRows * (BM + 1);     // ds_s[kRows][BM + 1]
  static constexpr int kLse = kDs + kRows * (BM + 1);   // lse_s[BM]
  static constexpr int kDelta = kLse + BM;              // delta_s[BM]
  static constexpr int kBytes = (kDelta + BM) * 4;
};

// D: the padded width of the instance; head_dim <= D the real one
template <typename Elt, int D, int BN>
__global__ void __launch_bounds__(kThreads)
attention_bwd_dq_kernel(BwdArgs a, int head_dim) {
  constexpr int kKeysPerLane = BN / kLanes;
  constexpr int kDimsPerLane = D / kLanes;
  using Smem = DqSmem<D, BN>;
  extern __shared__ __align__(16) float fma_smem[];
  float(*q_s)[D + 1] = reinterpret_cast<float(*)[D + 1]>(fma_smem + Smem::kQ);
  float(*do_s)[D + 1] =
      reinterpret_cast<float(*)[D + 1]>(fma_smem + Smem::kDo);
  float(*k_s)[D + 1] = reinterpret_cast<float(*)[D + 1]>(fma_smem + Smem::kK);
  float(*v_s)[D + 1] = reinterpret_cast<float(*)[D + 1]>(fma_smem + Smem::kV);
  float(*ds_s)[BN + 1] =
      reinterpret_cast<float(*)[BN + 1]>(fma_smem + Smem::kDs);

  const Elt* q = static_cast<const Elt*>(a.q);
  const Elt* k = static_cast<const Elt*>(a.k);
  const Elt* v = static_cast<const Elt*>(a.v);
  const Elt* dout = static_cast<const Elt*>(a.dout);
  const int seq = a.seq;
  const int causal = a.causal;
  const int tid = threadIdx.x;
  const int r = tid / kLanes;
  const int lane = tid % kLanes;
  const int q0 = blockIdx.x * kRows;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int row = q0 + r;
  const bool row_ok = row < seq;
  const long long stride = static_cast<long long>(a.heads) * head_dim;
  const long long base = static_cast<long long>(b) * seq * stride +
                         static_cast<long long>(h) * head_dim;
  const long long vi =
      (static_cast<long long>(b) * a.heads + h) * seq + row;

  // this CTA's query rows: q scaled and rounded to the input dtype, as the
  // reference's qs, and dO
  for (int idx = tid; idx < kRows * D; idx += kThreads) {
    const int rr = idx / D;
    const int d = idx % D;
    const int qrow = q0 + rr;
    float qv = 0.f, dv = 0.f;
    if (qrow < seq && d < head_dim) {
      qv = round_to<Elt>(to_f(q[base + qrow * stride + d]) * a.scale);
      dv = to_f(dout[base + qrow * stride + d]);
    }
    q_s[rr][d] = qv;
    do_s[rr][d] = dv;
  }
  const float lse_r = row_ok ? a.lse[vi] : 0.f;
  const int kv_end = causal ? min(seq, q0 + kRows) : seq;
  const int n_tiles = (kv_end + BN - 1) / BN;

  auto load_tile = [&](int k0) {
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
  };

  float delta_r;
  if (a.compute_delta) {
    // sweep 1: delta over the whole row, from p in p's dtype
    float part = 0.f;
    for (int tile = 0; tile < n_tiles; ++tile) {
      const int k0 = tile * BN;
      load_tile(k0);
#pragma unroll
      for (int i = 0; i < kKeysPerLane; ++i) {
        const int kk = lane + i * kLanes;
        const int key = k0 + kk;
        if (row_ok && key < seq && (!causal || key <= row)) {
          const float p = prob(dot_rows<D>(q_s[r], k_s[kk]), lse_r, a.p_bf16);
          part += p * dot_rows<D>(do_s[r], v_s[kk]);
        }
      }
    }
#pragma unroll
    for (int off = kLanes / 2; off > 0; off >>= 1) {
      part += __shfl_xor_sync(0xffffffffu, part, off);
    }
    delta_r = part;
    if (row_ok && lane == 0) a.delta[vi] = delta_r;
  } else {
    delta_r = row_ok ? a.delta[vi] : 0.f;
  }

  // sweep 2: ds tile by tile, dq += ds k
  float acc[kDimsPerLane];
#pragma unroll
  for (int e = 0; e < kDimsPerLane; ++e) acc[e] = 0.f;
  for (int tile = 0; tile < n_tiles; ++tile) {
    const int k0 = tile * BN;
    load_tile(k0);
#pragma unroll
    for (int i = 0; i < kKeysPerLane; ++i) {
      const int kk = lane + i * kLanes;
      const int key = k0 + kk;
      float ds = 0.f;
      if (row_ok && key < seq && (!causal || key <= row)) {
        const float p = prob(dot_rows<D>(q_s[r], k_s[kk]), lse_r, a.p_bf16);
        const float dp = dot_rows<D>(do_s[r], v_s[kk]);
        ds = dscore<Elt>(p, dp, delta_r, a.p_bf16);
      }
      ds_s[r][kk] = ds;
    }
    __syncthreads();   // ds_s complete
#pragma unroll
    for (int e = 0; e < kDimsPerLane; ++e) {
      const int d = lane + e * kLanes;
      float s = acc[e];
#pragma unroll 8
      for (int kk = 0; kk < BN; ++kk) s = fmaf(ds_s[r][kk], k_s[kk][d], s);
      acc[e] = s;
    }
  }
  if (row_ok) {
    Elt* dq = static_cast<Elt*>(a.dq);
#pragma unroll
    for (int e = 0; e < kDimsPerLane; ++e) {
      const int d = lane + e * kLanes;
      if (d < head_dim) {
        dq[base + row * stride + d] = from_f<Elt>(acc[e] * a.scale);
      }
    }
  }
}

template <typename Elt, int D, int BM>
__global__ void __launch_bounds__(kThreads)
attention_bwd_dkv_kernel(BwdArgs a, int head_dim) {
  constexpr int kQueriesPerLane = BM / kLanes;
  constexpr int kDimsPerLane = D / kLanes;
  using Smem = DkvSmem<D, BM>;
  extern __shared__ __align__(16) float fma_smem[];
  float(*k_s)[D + 1] = reinterpret_cast<float(*)[D + 1]>(fma_smem + Smem::kK);
  float(*v_s)[D + 1] = reinterpret_cast<float(*)[D + 1]>(fma_smem + Smem::kV);
  float(*q_s)[D + 1] = reinterpret_cast<float(*)[D + 1]>(fma_smem + Smem::kQ);
  float(*do_s)[D + 1] =
      reinterpret_cast<float(*)[D + 1]>(fma_smem + Smem::kDo);
  float(*p_s)[BM + 1] = reinterpret_cast<float(*)[BM + 1]>(fma_smem + Smem::kP);
  float(*ds_s)[BM + 1] =
      reinterpret_cast<float(*)[BM + 1]>(fma_smem + Smem::kDs);
  float* lse_s = fma_smem + Smem::kLse;
  float* delta_s = fma_smem + Smem::kDelta;

  const Elt* q = static_cast<const Elt*>(a.q);
  const Elt* k = static_cast<const Elt*>(a.k);
  const Elt* v = static_cast<const Elt*>(a.v);
  const Elt* dout = static_cast<const Elt*>(a.dout);
  const int seq = a.seq;
  const int causal = a.causal;
  const int tid = threadIdx.x;
  const int r = tid / kLanes;
  const int lane = tid % kLanes;
  const int k0 = blockIdx.x * kRows;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int key = k0 + r;
  const bool key_ok = key < seq;
  const long long stride = static_cast<long long>(a.heads) * head_dim;
  const long long base = static_cast<long long>(b) * seq * stride +
                         static_cast<long long>(h) * head_dim;
  const long long vbase = (static_cast<long long>(b) * a.heads + h) * seq;

  for (int idx = tid; idx < kRows * D; idx += kThreads) {
    const int rr = idx / D;
    const int d = idx % D;
    const int krow = k0 + rr;
    float kv = 0.f, vv = 0.f;
    if (krow < seq && d < head_dim) {
      kv = to_f(k[base + krow * stride + d]);
      vv = to_f(v[base + krow * stride + d]);
    }
    k_s[rr][d] = kv;
    v_s[rr][d] = vv;
  }
  float dk_acc[kDimsPerLane];
  float dv_acc[kDimsPerLane];
#pragma unroll
  for (int e = 0; e < kDimsPerLane; ++e) dk_acc[e] = dv_acc[e] = 0.f;

  // causal: queries before this tile's first key see none of it
  const int q_begin = causal ? (k0 / BM) * BM : 0;
  for (int qt0 = q_begin; qt0 < seq; qt0 += BM) {
    __syncthreads();   // k_s/v_s written, or the previous tile's readers done
    for (int idx = tid; idx < BM * D; idx += kThreads) {
      const int ii = idx / D;
      const int d = idx % D;
      const int qi = qt0 + ii;
      float qv = 0.f, dv = 0.f;
      if (qi < seq && d < head_dim) {
        qv = round_to<Elt>(to_f(q[base + qi * stride + d]) * a.scale);
        dv = to_f(dout[base + qi * stride + d]);
      }
      q_s[ii][d] = qv;
      do_s[ii][d] = dv;
    }
    for (int ii = tid; ii < BM; ii += kThreads) {
      const int qi = qt0 + ii;
      lse_s[ii] = qi < seq ? a.lse[vbase + qi] : 0.f;
      delta_s[ii] = qi < seq ? a.delta[vbase + qi] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < kQueriesPerLane; ++j) {
      const int ii = lane + j * kLanes;
      const int qi = qt0 + ii;
      float p = 0.f, ds = 0.f;
      if (key_ok && qi < seq && (!causal || key <= qi)) {
        p = prob(dot_rows<D>(q_s[ii], k_s[r]), lse_s[ii], a.p_bf16);
        const float dp = dot_rows<D>(do_s[ii], v_s[r]);
        ds = dscore<Elt>(p, dp, delta_s[ii], a.p_bf16);
      }
      p_s[r][ii] = round_to<Elt>(p);   // dv takes p in the input dtype
      ds_s[r][ii] = ds;
    }
    __syncthreads();   // p_s, ds_s complete
#pragma unroll
    for (int e = 0; e < kDimsPerLane; ++e) {
      const int d = lane + e * kLanes;
      float sk = dk_acc[e];
      float sv = dv_acc[e];
#pragma unroll 8
      for (int ii = 0; ii < BM; ++ii) {
        sv = fmaf(p_s[r][ii], do_s[ii][d], sv);
        sk = fmaf(ds_s[r][ii], q_s[ii][d], sk);
      }
      dk_acc[e] = sk;
      dv_acc[e] = sv;
    }
  }
  if (key_ok) {
    Elt* dk = static_cast<Elt*>(a.dk);
    Elt* dv = static_cast<Elt*>(a.dv);
#pragma unroll
    for (int e = 0; e < kDimsPerLane; ++e) {
      const int d = lane + e * kLanes;
      if (d >= head_dim) continue;
      const long long off = base + key * stride + d;
      // dk = ds^T (scale q): q was staged pre-scaled, no extra factor
      dk[off] = from_f<Elt>(dk_acc[e]);
      dv[off] = from_f<Elt>(dv_acc[e]);
    }
  }
}

// ---------------------------------------------------- heads wider than 256
// The chunk width of the chunked passes: the 256-wide instance's tiles.
constexpr int kChunk = 256;

// The dq pass for head_dim > 256: grid z = batch * n_chunks + chunk; the
// CTA writes dq's dims chunk * 256 .. + 255 of its 16 query rows. Scores
// and dp of a key tile are summed over the chunks in order (each chunk's
// q, dO, k and v pass through the 256-wide tiles); delta, when taken
// here, is the same sum in every chunk's CTA, and chunk 0 writes it.
template <typename Elt, int BN>
__global__ void __launch_bounds__(kThreads)
attention_bwd_dq_chunked_kernel(BwdArgs a, int head_dim, int n_chunks) {
  constexpr int D = kChunk;
  constexpr int kKeysPerLane = BN / kLanes;
  constexpr int kDimsPerLane = D / kLanes;
  using Smem = DqSmem<D, BN>;
  extern __shared__ __align__(16) float fma_smem[];
  float(*q_s)[D + 1] = reinterpret_cast<float(*)[D + 1]>(fma_smem + Smem::kQ);
  float(*do_s)[D + 1] =
      reinterpret_cast<float(*)[D + 1]>(fma_smem + Smem::kDo);
  float(*k_s)[D + 1] = reinterpret_cast<float(*)[D + 1]>(fma_smem + Smem::kK);
  float(*v_s)[D + 1] = reinterpret_cast<float(*)[D + 1]>(fma_smem + Smem::kV);
  float(*ds_s)[BN + 1] =
      reinterpret_cast<float(*)[BN + 1]>(fma_smem + Smem::kDs);

  const Elt* q = static_cast<const Elt*>(a.q);
  const Elt* k = static_cast<const Elt*>(a.k);
  const Elt* v = static_cast<const Elt*>(a.v);
  const Elt* dout = static_cast<const Elt*>(a.dout);
  const int seq = a.seq;
  const int causal = a.causal;
  const int tid = threadIdx.x;
  const int r = tid / kLanes;
  const int lane = tid % kLanes;
  const int q0 = blockIdx.x * kRows;
  const int h = blockIdx.y;
  const int b = blockIdx.z / n_chunks;
  const int own0 = (blockIdx.z % n_chunks) * D;
  const int row = q0 + r;
  const bool row_ok = row < seq;
  const long long stride = static_cast<long long>(a.heads) * head_dim;
  const long long base = static_cast<long long>(b) * seq * stride +
                         static_cast<long long>(h) * head_dim;
  const long long vi =
      (static_cast<long long>(b) * a.heads + h) * seq + row;
  const float lse_r = row_ok ? a.lse[vi] : 0.f;
  const int kv_end = causal ? min(seq, q0 + kRows) : seq;
  const int n_tiles = (kv_end + BN - 1) / BN;

  // the scores and dp of this lane's keys of the tile at k0, each summed
  // over the head's chunks in order
  auto tile_dots = [&](int k0, float* sd, float* pd) {
#pragma unroll
    for (int i = 0; i < kKeysPerLane; ++i) sd[i] = pd[i] = 0.f;
    for (int c0 = 0; c0 < head_dim; c0 += D) {
      __syncthreads();   // the previous chunk's (or tile's) readers are done
      for (int idx = tid; idx < kRows * D; idx += kThreads) {
        const int rr = idx / D;
        const int dd = idx % D;
        const int qrow = q0 + rr;
        float qv = 0.f, dv = 0.f;
        if (qrow < seq && c0 + dd < head_dim) {
          const long long off = base + qrow * stride + c0 + dd;
          qv = round_to<Elt>(to_f(q[off]) * a.scale);
          dv = to_f(dout[off]);
        }
        q_s[rr][dd] = qv;
        do_s[rr][dd] = dv;
      }
      for (int idx = tid; idx < BN * D; idx += kThreads) {
        const int kk = idx / D;
        const int dd = idx % D;
        const int key = k0 + kk;
        float kv = 0.f, vv = 0.f;
        if (key < seq && c0 + dd < head_dim) {
          kv = to_f(k[base + key * stride + c0 + dd]);
          vv = to_f(v[base + key * stride + c0 + dd]);
        }
        k_s[kk][dd] = kv;
        v_s[kk][dd] = vv;
      }
      __syncthreads();
#pragma unroll
      for (int i = 0; i < kKeysPerLane; ++i) {
        const int kk = lane + i * kLanes;
        sd[i] = dot_acc<D>(q_s[r], k_s[kk], sd[i]);
        pd[i] = dot_acc<D>(do_s[r], v_s[kk], pd[i]);
      }
    }
  };

  float sd[kKeysPerLane], pd[kKeysPerLane];
  float delta_r;
  if (a.compute_delta) {
    float part = 0.f;
    for (int tile = 0; tile < n_tiles; ++tile) {
      const int k0 = tile * BN;
      tile_dots(k0, sd, pd);
#pragma unroll
      for (int i = 0; i < kKeysPerLane; ++i) {
        const int key = k0 + lane + i * kLanes;
        if (row_ok && key < seq && (!causal || key <= row)) {
          part += prob(sd[i], lse_r, a.p_bf16) * pd[i];
        }
      }
    }
#pragma unroll
    for (int off = kLanes / 2; off > 0; off >>= 1) {
      part += __shfl_xor_sync(0xffffffffu, part, off);
    }
    delta_r = part;
    if (row_ok && lane == 0 && own0 == 0) a.delta[vi] = delta_r;
  } else {
    delta_r = row_ok ? a.delta[vi] : 0.f;
  }

  float acc[kDimsPerLane];
#pragma unroll
  for (int e = 0; e < kDimsPerLane; ++e) acc[e] = 0.f;
  for (int tile = 0; tile < n_tiles; ++tile) {
    const int k0 = tile * BN;
    tile_dots(k0, sd, pd);
#pragma unroll
    for (int i = 0; i < kKeysPerLane; ++i) {
      const int kk = lane + i * kLanes;
      const int key = k0 + kk;
      float ds = 0.f;
      if (row_ok && key < seq && (!causal || key <= row)) {
        ds = dscore<Elt>(prob(sd[i], lse_r, a.p_bf16), pd[i], delta_r,
                         a.p_bf16);
      }
      ds_s[r][kk] = ds;
    }
    __syncthreads();   // the last chunk's readers of k_s are done
    for (int idx = tid; idx < BN * D; idx += kThreads) {
      const int kk = idx / D;
      const int dd = idx % D;
      const int key = k0 + kk;
      k_s[kk][dd] = key < seq && own0 + dd < head_dim
                        ? to_f(k[base + key * stride + own0 + dd])
                        : 0.f;
    }
    __syncthreads();   // ds_s and this chunk's k complete
#pragma unroll
    for (int e = 0; e < kDimsPerLane; ++e) {
      const int d = lane + e * kLanes;
      float s = acc[e];
#pragma unroll 8
      for (int kk = 0; kk < BN; ++kk) s = fmaf(ds_s[r][kk], k_s[kk][d], s);
      acc[e] = s;
    }
  }
  if (row_ok) {
    Elt* dq = static_cast<Elt*>(a.dq);
#pragma unroll
    for (int e = 0; e < kDimsPerLane; ++e) {
      const int d = own0 + lane + e * kLanes;
      if (d < head_dim) {
        dq[base + row * stride + d] = from_f<Elt>(acc[e] * a.scale);
      }
    }
  }
}

// The dk/dv pass for head_dim > 256: grid z = batch * n_chunks + chunk;
// the CTA writes dk's and dv's dims chunk * 256 .. + 255 of its 16 keys.
// Per query tile, the scores and dp are summed over the chunks in order,
// then the tile's q and dO of this CTA's own chunk are staged again for
// dk += ds^T q and dv += p^T dO.
template <typename Elt, int BM>
__global__ void __launch_bounds__(kThreads)
attention_bwd_dkv_chunked_kernel(BwdArgs a, int head_dim, int n_chunks) {
  constexpr int D = kChunk;
  constexpr int kQueriesPerLane = BM / kLanes;
  constexpr int kDimsPerLane = D / kLanes;
  using Smem = DkvSmem<D, BM>;
  extern __shared__ __align__(16) float fma_smem[];
  float(*k_s)[D + 1] = reinterpret_cast<float(*)[D + 1]>(fma_smem + Smem::kK);
  float(*v_s)[D + 1] = reinterpret_cast<float(*)[D + 1]>(fma_smem + Smem::kV);
  float(*q_s)[D + 1] = reinterpret_cast<float(*)[D + 1]>(fma_smem + Smem::kQ);
  float(*do_s)[D + 1] =
      reinterpret_cast<float(*)[D + 1]>(fma_smem + Smem::kDo);
  float(*p_s)[BM + 1] = reinterpret_cast<float(*)[BM + 1]>(fma_smem + Smem::kP);
  float(*ds_s)[BM + 1] =
      reinterpret_cast<float(*)[BM + 1]>(fma_smem + Smem::kDs);
  float* lse_s = fma_smem + Smem::kLse;
  float* delta_s = fma_smem + Smem::kDelta;

  const Elt* q = static_cast<const Elt*>(a.q);
  const Elt* k = static_cast<const Elt*>(a.k);
  const Elt* v = static_cast<const Elt*>(a.v);
  const Elt* dout = static_cast<const Elt*>(a.dout);
  const int seq = a.seq;
  const int causal = a.causal;
  const int tid = threadIdx.x;
  const int r = tid / kLanes;
  const int lane = tid % kLanes;
  const int k0 = blockIdx.x * kRows;
  const int h = blockIdx.y;
  const int b = blockIdx.z / n_chunks;
  const int own0 = (blockIdx.z % n_chunks) * D;
  const int key = k0 + r;
  const bool key_ok = key < seq;
  const long long stride = static_cast<long long>(a.heads) * head_dim;
  const long long base = static_cast<long long>(b) * seq * stride +
                         static_cast<long long>(h) * head_dim;
  const long long vbase = (static_cast<long long>(b) * a.heads + h) * seq;

  // the tile's q (scaled) and dO rows, dims c0 .. c0 + 255
  auto stage_queries = [&](int qt0, int c0) {
    for (int idx = tid; idx < BM * D; idx += kThreads) {
      const int ii = idx / D;
      const int dd = idx % D;
      const int qi = qt0 + ii;
      float qv = 0.f, dv = 0.f;
      if (qi < seq && c0 + dd < head_dim) {
        const long long off = base + qi * stride + c0 + dd;
        qv = round_to<Elt>(to_f(q[off]) * a.scale);
        dv = to_f(dout[off]);
      }
      q_s[ii][dd] = qv;
      do_s[ii][dd] = dv;
    }
  };

  float dk_acc[kDimsPerLane];
  float dv_acc[kDimsPerLane];
#pragma unroll
  for (int e = 0; e < kDimsPerLane; ++e) dk_acc[e] = dv_acc[e] = 0.f;

  const int q_begin = causal ? (k0 / BM) * BM : 0;
  for (int qt0 = q_begin; qt0 < seq; qt0 += BM) {
    float sd[kQueriesPerLane], pd[kQueriesPerLane];
#pragma unroll
    for (int j = 0; j < kQueriesPerLane; ++j) sd[j] = pd[j] = 0.f;
    for (int c0 = 0; c0 < head_dim; c0 += D) {
      __syncthreads();   // the previous chunk's (or tile's) readers are done
      for (int idx = tid; idx < kRows * D; idx += kThreads) {
        const int rr = idx / D;
        const int dd = idx % D;
        const int krow = k0 + rr;
        float kv = 0.f, vv = 0.f;
        if (krow < seq && c0 + dd < head_dim) {
          kv = to_f(k[base + krow * stride + c0 + dd]);
          vv = to_f(v[base + krow * stride + c0 + dd]);
        }
        k_s[rr][dd] = kv;
        v_s[rr][dd] = vv;
      }
      stage_queries(qt0, c0);
      if (c0 == 0) {
        for (int ii = tid; ii < BM; ii += kThreads) {
          const int qi = qt0 + ii;
          lse_s[ii] = qi < seq ? a.lse[vbase + qi] : 0.f;
          delta_s[ii] = qi < seq ? a.delta[vbase + qi] : 0.f;
        }
      }
      __syncthreads();
#pragma unroll
      for (int j = 0; j < kQueriesPerLane; ++j) {
        const int ii = lane + j * kLanes;
        sd[j] = dot_acc<D>(q_s[ii], k_s[r], sd[j]);
        pd[j] = dot_acc<D>(do_s[ii], v_s[r], pd[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < kQueriesPerLane; ++j) {
      const int ii = lane + j * kLanes;
      const int qi = qt0 + ii;
      float p = 0.f, ds = 0.f;
      if (key_ok && qi < seq && (!causal || key <= qi)) {
        p = prob(sd[j], lse_s[ii], a.p_bf16);
        ds = dscore<Elt>(p, pd[j], delta_s[ii], a.p_bf16);
      }
      p_s[r][ii] = round_to<Elt>(p);   // dv takes p in the input dtype
      ds_s[r][ii] = ds;
    }
    __syncthreads();   // the last chunk's readers of q_s and do_s are done
    stage_queries(qt0, own0);
    __syncthreads();   // p_s, ds_s and this chunk's q and dO complete
#pragma unroll
    for (int e = 0; e < kDimsPerLane; ++e) {
      const int d = lane + e * kLanes;
      float sk = dk_acc[e];
      float sv = dv_acc[e];
#pragma unroll 8
      for (int ii = 0; ii < BM; ++ii) {
        sv = fmaf(p_s[r][ii], do_s[ii][d], sv);
        sk = fmaf(ds_s[r][ii], q_s[ii][d], sk);
      }
      dk_acc[e] = sk;
      dv_acc[e] = sv;
    }
  }
  if (key_ok) {
    Elt* dk = static_cast<Elt*>(a.dk);
    Elt* dv = static_cast<Elt*>(a.dv);
#pragma unroll
    for (int e = 0; e < kDimsPerLane; ++e) {
      const int d = own0 + lane + e * kLanes;
      if (d >= head_dim) continue;
      const long long off = base + key * stride + d;
      dk[off] = from_f<Elt>(dk_acc[e]);
      dv[off] = from_f<Elt>(dv_acc[e]);
    }
  }
}

constexpr int kPassDq = 1;
constexpr int kPassDkv = 2;

// The chunked passes: BN keys per dq tile, BM queries per dk/dv tile, the
// 256-wide instance's tiles and shared memory
template <typename Elt, int BN, int BM>
int launch_chunked_passes(const BwdArgs& a, int head_dim, int passes,
                          cudaStream_t stream) {
  const int n_chunks = (head_dim + kChunk - 1) / kChunk;
  const long long z = static_cast<long long>(a.batch) * n_chunks;
  if (z > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((a.seq + kRows - 1) / kRows, a.heads,
                  static_cast<unsigned>(z));
  cudaError_t err;
  if (passes & kPassDq) {
    constexpr int kBytes = DqSmem<kChunk, BN>::kBytes;
    err = reserve_smem<attention_bwd_dq_chunked_kernel<Elt, BN>>(kBytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    attention_bwd_dq_chunked_kernel<Elt, BN>
        <<<grid, kThreads, kBytes, stream>>>(a, head_dim, n_chunks);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (passes & kPassDkv) {
    constexpr int kBytes = DkvSmem<kChunk, BM>::kBytes;
    err = reserve_smem<attention_bwd_dkv_chunked_kernel<Elt, BM>>(kBytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    attention_bwd_dkv_chunked_kernel<Elt, BM>
        <<<grid, kThreads, kBytes, stream>>>(a, head_dim, n_chunks);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

// BN keys per dq tile, BM queries per dk/dv tile; each pass opts into its
// dynamic shared memory where that passes the 48 KB default
template <typename Elt, int D, int BN, int BM>
int launch_passes(const BwdArgs& a, int head_dim, int passes,
                  cudaStream_t stream) {
  const dim3 grid((a.seq + kRows - 1) / kRows, a.heads, a.batch);
  cudaError_t err;
  if (passes & kPassDq) {
    constexpr int kBytes = DqSmem<D, BN>::kBytes;
    err = reserve_smem<attention_bwd_dq_kernel<Elt, D, BN>>(kBytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    attention_bwd_dq_kernel<Elt, D, BN><<<grid, kThreads, kBytes, stream>>>(
        a, head_dim);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (passes & kPassDkv) {
    constexpr int kBytes = DkvSmem<D, BM>::kBytes;
    err = reserve_smem<attention_bwd_dkv_kernel<Elt, D, BM>>(kBytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    attention_bwd_dkv_kernel<Elt, D, BM>
        <<<grid, kThreads, kBytes, stream>>>(a, head_dim);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

// The FMA passes at the least built width >= head_dim (1..256), and the
// chunked passes above. Up to width 128 the tiles keep each pass under the
// 48 KB default (at 128 they shrink to 16 keys and 16 queries); the
// 256-wide and chunked passes take 32-key and 64-query tiles from
// opted-in shared memory.
template <typename Elt>
int dispatch_head_dim(const BwdArgs& a, int head_dim, int passes,
                      cudaStream_t stream) {
  if (head_dim < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (head_dim > kChunk) {
    return launch_chunked_passes<Elt, 32, 64>(a, head_dim, passes, stream);
  }
  if (head_dim <= 16) {
    return launch_passes<Elt, 16, 64, 32>(a, head_dim, passes, stream);
  }
  if (head_dim <= 32) {
    return launch_passes<Elt, 32, 64, 32>(a, head_dim, passes, stream);
  }
  if (head_dim <= 64) {
    return launch_passes<Elt, 64, 64, 32>(a, head_dim, passes, stream);
  }
  if (head_dim <= 128) {
    return launch_passes<Elt, 128, 16, 16>(a, head_dim, passes, stream);
  }
  return launch_passes<Elt, 256, 32, 64>(a, head_dim, passes, stream);
}

// The bf16 passes on the tensor cores (attention_bwd_tc.cuh), one CTA
// of 128 threads per 64-row tile and head, with ~50 KB of dynamic shared
// memory each.
int launch_tc(const BwdArgs& a, int passes, cudaStream_t stream) {
  const long long blocks =
      static_cast<long long>((a.seq + tc::kTile - 1) / tc::kTile) * a.batch *
      a.heads;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(blocks));
  cudaError_t err;
  if (passes & kPassDq) {
    err = cudaFuncSetAttribute(tc::attention_bwd_dq_tc_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               tc::kDqSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    tc::attention_bwd_dq_tc_kernel<<<grid, tc::kThreads, tc::kDqSmem,
                                     stream>>>(a);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (passes & kPassDkv) {
    err = cudaFuncSetAttribute(tc::attention_bwd_dkv_tc_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               tc::kDkvSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    tc::attention_bwd_dkv_tc_kernel<<<grid, tc::kThreads, tc::kDkvSmem,
                                      stream>>>(a);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

// bf16 at head_dim 64 takes the tensor cores; fp32, and bf16 at any other
// head dim, the FMA loops
int run(const BwdArgs& a, int head_dim, int dtype, int passes, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kF32) return dispatch_head_dim<float>(a, head_dim, passes, s);
  if (dtype == kBF16) {
    if (head_dim == 64) return launch_tc(a, passes, s);
    return dispatch_head_dim<__nv_bfloat16>(a, head_dim, passes, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace
}  // namespace dl4jt

extern "C" {

// q, k, v, dout, dq, dk, dv: (batch, seq, heads*head_dim) contiguous,
// dtype `dtype` (0 fp32, 1 bf16); lse: (batch, heads, seq) fp32; delta:
// (batch, heads, seq) fp32 scratch the dq pass writes. Two launches (dq
// pass, then dk/dv pass) on `stream`. Returns a cudaError_t.
int mha_packed_bwd(const void* q, const void* k, const void* v,
                   const void* dout, const void* lse, void* delta, void* dq,
                   void* dk, void* dv, int batch, int seq, int heads,
                   int head_dim, float scale, int causal, int p_bf16,
                   int dtype, void* stream) {
  const dl4jt::BwdArgs a{q, k, v, dout, static_cast<const float*>(lse),
                         static_cast<float*>(delta), dq, dk, dv, batch, seq,
                         heads, scale, causal, p_bf16, 1};
  return dl4jt::run(a, head_dim, dtype, dl4jt::kPassDq | dl4jt::kPassDkv,
                    stream);
}

// q, k, v, dout, dq: (bh, seq, head_dim) contiguous; lse, delta: (bh, 1,
// seq) fp32 in the global softmax frame. fp32 p. Returns a cudaError_t.
int flash_bwd_dq(const void* q, const void* k, const void* v,
                 const void* dout, const void* lse, const void* delta,
                 void* dq, int bh, int seq, int head_dim, float scale,
                 int causal, int dtype, void* stream) {
  const dl4jt::BwdArgs a{q, k, v, dout, static_cast<const float*>(lse),
                         const_cast<float*>(static_cast<const float*>(delta)),
                         dq, nullptr, nullptr, bh, seq, 1, scale, causal, 0,
                         0};
  return dl4jt::run(a, head_dim, dtype, dl4jt::kPassDq, stream);
}

// As flash_bwd_dq, writing dk and dv. Returns a cudaError_t.
int flash_bwd_dkv(const void* q, const void* k, const void* v,
                  const void* dout, const void* lse, const void* delta,
                  void* dk, void* dv, int bh, int seq, int head_dim,
                  float scale, int causal, int dtype, void* stream) {
  const dl4jt::BwdArgs a{q, k, v, dout, static_cast<const float*>(lse),
                         const_cast<float*>(static_cast<const float*>(delta)),
                         nullptr, dk, dv, bh, seq, 1, scale, causal, 0, 0};
  return dl4jt::run(a, head_dim, dtype, dl4jt::kPassDkv, stream);
}

const char* attention_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
