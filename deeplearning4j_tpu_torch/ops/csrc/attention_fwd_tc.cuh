// Attention forward on Hopper's tensor cores: the bf16, head_dim-64
// instance of attention_fwd.cuh's forward (entries mha_packed_fwd and
// flash_fwd), o = softmax(scale q k^T [causal]) v and lse = m + log l per
// head. The fp32 instances and the bf16 head dims 16, 32 and 128 keep the
// FMA template there: fp32 products on tensor cores would need TF32, which
// the package turns off, and no main path runs the other head dims.
//
// Replaces, with attention_fwd.cuh, the Pallas kernels
// `_mha_packed_fwd_kernel` (`_mha_packed_forward`) and `_flash_kernel`
// (`_flash_forward`) of deeplearning4j_tpu/ops/pallas_kernels.py.
//
// Bound on the H100 SXM (989 TFLOP/s bf16, 3.35 TB/s), counting the two
// (T, T, D) products once (causal work halved), each input read once and
// each output written once:
// - packed, B=96 T=512 H=12 D=64: bytes, 0.0909 ms (q, k, v and o of
//   75.5 MB each and 2.4 MB of lse; its 77.3 GFLOP take 0.0782 ms);
// - streamed, B*H=24 T=8192 causal: operations, 0.2085 ms (206 GFLOP).
//
// Design. A CTA is one warpgroup (128 threads) that owns a 64-row query
// tile of one (batch, head) on a flat grid (`fwd_tile_of_block`) and
// streams the 64-key tiles of K and V through a 2-stage `cp.async` ring,
// zero-filled past `seq`. Per key tile, in order:
// 1. S = qs k^T, four `wgmma` m64n64k16 from shared memory (both operands
//    K-major); qs = bf16(q scale) is staged once, scaled in place;
// 2. masks only on the ragged last tile and the causal diagonal tile;
// 3. the online softmax: row max over the quad of lanes that share a row,
//    alpha = e^(m - m_new), p = e^(s - m_new) on the SFU (`exp_tc`), or
//    `prob_tc`'s two bf16 roundings with bf16 p; l = l alpha + sum p, each
//    thread keeping its own part of the row's sum until the epilogue;
// 4. p leaves the accumulator in the layout of wgmma's A fragment and is
//    packed to bf16 in registers, with no trip through shared memory;
// 5. O = O alpha, then O += P V, four `wgmma` with V MN-major (transpose
//    bit).
// The epilogue floors l at 1e-30 (streamed only), stores o = O / l in
// bf16 for rows below `seq` and lse = m + log l once per row.
// The grid is head-major without the causal mask: a head's query tiles
// are adjacent, so the CTAs that read the same K and V run together and
// take them from HBM once. Tile-major order (every head's tile 0 first)
// runs them about two waves apart, and at B=96 T=512 the first wave alone
// touches 67 MB of K/V, more than the 50 MB L2: K and V then come from
// HBM once per query tile, 1.2 GB against 0.15 GB. Causal launches keep
// `tile_of_block`'s tile-major order, the longest tiles (the last) first,
// which balances the last wave; at T=8192 all 24 heads' 48 MB of K/V
// stay in L2, and head-major order was the slower there.
// About 41 KB of shared memory (1024 alignment, 8 KB qs, 2 x 16 KB K/V)
// and at most 128 registers a thread: four CTAs share an SM and hide each
// other's softmax and loads.
//
// Rounding is the reference's: qs rounds to bf16 before the product, P V
// takes p in bf16, the row sum fp32 p (or bf16 p). The causal first row
// sees one key; its score is summed again in sequence (`dot_row0`), so m
// is that score, p = exp_tc(0) = 1, l = 1 and lse is the score itself,
// bit for bit the value the backward and the plain version recompute: the
// backward, fed this lse, gives that row's dq exactly 0.
#pragma once

#include "wgmma.cuh"

namespace dl4jt {
namespace tc {

// q, k, v, o: (batch, seq, heads * 64) bf16; lse: (batch, heads, seq)
struct FwdArgs {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  __nv_bfloat16* o;
  float* lse;
  int batch, seq, heads;
  float scale;
  int causal, clamp_l;
};

constexpr int kFwdSmem = 1024 + kTileBytes + kStages * 2 * kTileBytes;

// one CTA: (query tile, batch * head); causal launches take
// `tile_of_block`'s tile-major order, longest tiles first, the others
// head-major, so a head's K and V are read from HBM once
__device__ __forceinline__ void fwd_tile_of_block(const FwdArgs& a, int& tile,
                                                  int& b, int& h) {
  if (a.causal) {
    tile_of_block(a, true, tile, b, h);
    return;
  }
  const int n_tiles = (a.seq + kTile - 1) / kTile;
  const int bh = blockIdx.x / n_tiles;
  tile = blockIdx.x % n_tiles;
  b = bh / a.heads;
  h = bh % a.heads;
}

// kProbBf16: p rounded to bf16 before the row sum (the bf16-p mode)
template <bool kProbBf16>
__global__ void __launch_bounds__(kThreads, 4)
attention_fwd_tc_kernel(FwdArgs a) {
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  uint8_t* q_s = smem;
  // the ring: stage st holds k at tile 1 + 2 st and v at 2 + 2 st
  auto k_s = [&](int st) { return smem + (1 + 2 * st) * kTileBytes; };
  auto v_s = [&](int st) { return smem + (2 + 2 * st) * kTileBytes; };

  int qt, b, h;
  fwd_tile_of_block(a, qt, b, h);
  const int seq = a.seq;
  const int q0 = qt * kTile;
  const long long stride = static_cast<long long>(a.heads) * 64;
  const long long base =
      static_cast<long long>(b) * seq * stride + static_cast<long long>(h) * 64;
  const int kv_end = a.causal ? min(seq, q0 + kTile) : seq;
  const int n_tiles = (kv_end + kTile - 1) / kTile;

  auto load_kv = [&](int tile, int stage) {
    load_tile(k_s(stage), a.k + base, stride, tile * kTile, seq);
    load_tile(v_s(stage), a.v + base, stride, tile * kTile, seq);
  };
  // the CTA's own q with key tile 0, one group; scaled to qs once landed
  load_tile(q_s, a.q + base, stride, q0, seq);
  load_kv(0, 0);
  cp_async_commit();

  // this thread's two query rows
  const int r0 = q0 + acc_row(0);
  const int r1 = q0 + acc_row(2);
  // The first query of a causal head sees one key. Its score (thread 0's
  // accumulator element 0) is summed again in sequence, as the backward
  // and the plain version sum it, so that lse is exactly that score.
  const bool first_row = a.causal && q0 == 0;

  float m0 = kNegInf, m1 = kNegInf;   // running row maxima
  float l0 = 0.f, l1 = 0.f;           // this thread's part of the row sums
  float s[32], o[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = o[i] = 0.f;

  for (int t = 0; t < n_tiles; ++t) {
    const int st = t & 1;
    if (t + 1 < n_tiles) load_kv(t + 1, st ^ 1);
    cp_async_commit();
    cp_async_wait<1>();
    if (t == 0) scale_own_chunks(q_s, a.scale);   // qs = bf16(q * scale)
    fence_proxy_async();
    __syncthreads();

    fence_acc(s);
    wgmma_fence();
    product_dd(s, q_s, k_s(st));
    wgmma_commit();
    wgmma_wait_all();
    fence_acc(s);
    if (first_row && t == 0 && threadIdx.x == 0) {
      s[0] = dot_row0(q_s, k_s(0));
    }

    const int k0 = t * kTile;
    if (k0 + kTile > seq || (a.causal && k0 + kTile > q0 + 1)) {
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int key = k0 + acc_col(i);
        const int row = (i & 2) ? r1 : r0;
        if (key >= seq || (a.causal && key > row)) s[i] = kNegInf;
      }
    }

    // the new row maxima over the row's four lanes; every row sees a key
    // of every tile it visits, so m is a real score from tile 0 on and
    // masked scores exp to exactly 0
    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      if (i & 2) {
        mx1 = fmaxf(mx1, s[i]);
      } else {
        mx0 = fmaxf(mx0, s[i]);
      }
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    const float alpha0 = exp_tc(m0 - mx0);
    const float alpha1 = exp_tc(m1 - mx1);
    m0 = mx0;
    m1 = mx1;

    // p, its row sums, and p in bf16 as the A fragment of P V
    uint32_t frag[16];
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int i = 0; i < 32; i += 2) {
      const bool lo = (i & 2) == 0;
      const float m = lo ? m0 : m1;
      const float p0 = kProbBf16 ? prob_tc(s[i], m, 1) : exp_tc(s[i] - m);
      const float p1 =
          kProbBf16 ? prob_tc(s[i + 1], m, 1) : exp_tc(s[i + 1] - m);
      if (lo) {
        sum0 += p0;
        sum0 += p1;
      } else {
        sum1 += p0;
        sum1 += p1;
      }
      frag[i / 2] = pack_bf16(p0, p1);
    }
    l0 = l0 * alpha0 + sum0;
    l1 = l1 * alpha1 + sum1;

    fence_acc(o);
#pragma unroll
    for (int i = 0; i < 32; ++i) o[i] *= (i & 2) ? alpha1 : alpha0;
    wgmma_fence();
    product_rows(o, frag, v_s(st));
    wgmma_commit();
    wgmma_wait_all();
    fence_acc(o);
    __syncthreads();   // stage st is refilled in the next iteration
  }

  // the whole rows' sums, from the four lanes' parts
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  // the streamed reference floors l at 1e-30 before o and lse
  if (a.clamp_l) {
    l0 = fmaxf(l0, 1e-30f);
    l1 = fmaxf(l1, 1e-30f);
  }
#pragma unroll
  for (int i = 0; i < 32; i += 2) {
    const int row = q0 + acc_row(i);
    const float l = (i & 2) ? l1 : l0;
    if (row < seq) {
      *reinterpret_cast<uint32_t*>(a.o + base + row * stride + acc_col(i)) =
          pack_bf16(o[i] / l, o[i + 1] / l);
    }
  }
  if ((threadIdx.x & 3) == 0) {
    const long long vbase = (static_cast<long long>(b) * a.heads + h) * seq;
    if (r0 < seq) a.lse[vbase + r0] = m0 + logf(l0);
    if (r1 < seq) a.lse[vbase + r1] = m1 + logf(l1);
  }
}

template <bool kProbBf16>
int launch_fwd_tc_instance(const FwdArgs& a, dim3 grid, cudaStream_t stream) {
  const cudaError_t err = cudaFuncSetAttribute(
      attention_fwd_tc_kernel<kProbBf16>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, kFwdSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  attention_fwd_tc_kernel<kProbBf16><<<grid, kThreads, kFwdSmem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// Launch the tensor-core forward, one CTA per 64-row query tile and head;
// returns the launch's cudaError_t.
inline int launch_attention_fwd_tc(const FwdArgs& a, int p_bf16,
                                   cudaStream_t stream) {
  const long long blocks =
      static_cast<long long>((a.seq + kTile - 1) / kTile) * a.batch * a.heads;
  if (blocks <= 0 || blocks > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid(static_cast<unsigned>(blocks));
  return p_bf16 ? launch_fwd_tc_instance<true>(a, grid, stream)
                : launch_fwd_tc_instance<false>(a, grid, stream);
}

}  // namespace tc
}  // namespace dl4jt
