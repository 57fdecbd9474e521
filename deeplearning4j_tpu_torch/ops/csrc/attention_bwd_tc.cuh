// Attention backward on Hopper's tensor cores: the bf16 instances of the
// dq and dk/dv passes of attention_bwd.cu (entries mha_packed_bwd,
// flash_bwd_dq, flash_bwd_dkv). The fp32 instances keep the FMA loops
// there: fp32 products on tensor cores would need TF32, which the package
// turns off.
//
// Replaces, with attention_bwd.cu, the Pallas kernels
// `_mha_packed_bwd_kernel` (`_mha_packed_bwd_rule`), `_flash_bwd_dq_kernel`
// (`_launch_bwd_dq`) and `_flash_bwd_dkv_kernel` (`_launch_bwd_dkv`) of
// deeplearning4j_tpu/ops/pallas_kernels.py.
//
// Bound on the H100 SXM (989 TFLOP/s bf16, 3.35 TB/s): operations, at both
// main shapes. The bound counts the five (T, T, D) products once:
// - packed, B=96 T=512 H=12 D=64: 0.195 ms for both passes;
// - streamed, B*H=24 T=8192 causal: dq 0.313 ms (3 products), dk/dv
//   0.417 ms (4 products).
// The two passes recompute what the other needs instead of sharing it
// through atomics, so they do more: the dq pass 3 products per tile
// (S = qs k^T, dP = dO v^T, dq += ds k), 5 under `compute_delta` (its
// first sweep takes S and dP again for delta); the dk/dv pass 4 (S^T =
// k qs^T, dP^T = v dO^T, dv += p^T dO, dk += ds^T qs).
//
// Design. Every product is one warpgroup's `wgmma.mma_async` m64n64k16,
// bf16 x bf16 -> fp32, over 64-row tiles: a CTA is one warpgroup (128
// threads) that owns a 64-row tile of queries (dq pass) or keys (dk/dv
// pass) and streams the other side's 64-row tiles.
// - Operands in shared memory are 64 x 64 bf16 tiles, 128 bytes a row,
//   in the 128-byte swizzle that `wgmma` descriptors read (16-byte chunk
//   c of row r at chunk c ^ (r % 8)), each tile 1024-byte aligned.
//   S and dP read both operands K-major (D contiguous); the sums read
//   their B operand (k, qs, dO: key or query rows, D contiguous) MN-major
//   through the transpose bit.
// - The A operand of the sums comes from registers: ds (dq pass), p^T
//   and ds^T (dk/dv pass, which computes S^T and dP^T with keys as rows)
//   leave the fp32 accumulator in exactly the layout of wgmma's A
//   fragment, so they are rounded and packed to bf16 in place, with no
//   trip through shared memory.
// - The streamed tiles (k, v in the dq pass; q, dO, lse, delta in the
//   dk/dv pass) go through a 2-stage ring filled by `cp.async` 16-byte
//   copies (4-byte for lse and delta): tile t + 1 loads while tile t
//   computes. Rows past `seq` are zero-filled by the copy and masked.
// - Causal: a query tile walks key tiles 0..i, a key tile query tiles
//   j..n-1; the flat grid puts the longest tiles of every head first, so
//   the last wave is short.
// - Per tile, the elementwise work (an exp and the ds arithmetic for each
//   of the 4096 scores) costs about as many instruction slots as the
//   products.
//   Interior tiles skip every mask and round ds once in the bf16x2 pack;
//   only the causal diagonal and the ragged last tile take the masked,
//   element-by-element path.
// About 50 KB of shared memory and 128 (dq) or at most 168 (dk/dv, held
// there by its launch bounds) registers a thread: four or three CTAs share
// an SM and hide each other's elementwise work and loads.
//
// Rounding is the reference's, element for element: qs = bf16(q * scale)
// is staged in shared memory before it enters S or dk; p = exp(s - lse)
// in fp32 (or `prob()`'s two roundings for bf16 p); ds rounds once to
// bf16 (`dscore`); dv takes bf16(p); dq is scaled after its sum. The exp
// is the SFU's exp2 of (s - lse) log2(e) (`exp_tc`), a few fp32 ulps from
// the plain version's expf; otherwise only the order of the fp32 sums
// differs: the products of bf16 values are exact in fp32.
#pragma once

#include "wgmma.cuh"

namespace dl4jt {

// The arguments of both passes, fp32 or bf16 (attention_bwd.cu's C entry
// points fill them): q, k, v, dout, dq, dk, dv (batch, seq, heads * 64);
// lse and delta (batch, heads, seq) fp32.
struct BwdArgs {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse;
  float* delta;   // (batch, heads, seq): written by pass 1 or given
  void* dq;
  void* dk;
  void* dv;
  int batch, seq, heads;
  float scale;
  int causal, p_bf16, compute_delta;
};

// The reference's arithmetic for the FMA kernels (attention_bwd.cu):
// p = exp(s - lse) in p's dtype, bf16 rounding s - lse and the exp. The
// tensor-core kernels below take the same p on the SFU (`prob_tc`,
// wgmma.cuh); both take ds from `dscore`.
__device__ __forceinline__ float prob(float s, float lse, int p_bf16) {
  if (p_bf16) {
    return round_to<__nv_bfloat16>(expf(round_to<__nv_bfloat16>(s - lse)));
  }
  return expf(s - lse);
}

// ds in the input dtype: (p (dp - delta)) rounded for fp32 p, and
// pb * (dp - delta) in the input dtype for bf16 p
template <typename Elt>
__device__ __forceinline__ float dscore(float p, float dp, float delta,
                                        int p_bf16) {
  if (p_bf16) {
    return round_to<Elt>(round_to<Elt>(p) * round_to<Elt>(dp - delta));
  }
  return round_to<Elt>(p * (dp - delta));
}

namespace tc {

// shared memory of the two passes (1024 bytes of alignment slack, the
// CTA's own tiles, the ring)
constexpr int kDqSmem = 1024 + 2 * kTileBytes + kStages * 2 * kTileBytes;
constexpr int kDkvSmem = 1024 + 2 * kTileBytes +
                         kStages * (2 * kTileBytes + 2 * kTile * 4);

// ------------------------------------------------------------- dq pass
//
// Per key tile: S = qs k^T and dP = dO v^T (eight wgmma), then per
// element p and ds, then dq += ds k (four wgmma, ds from registers).
// Interior tiles (every key < seq and, causal, every key <= every row)
// take no mask and, with fp32 p, round ds once in the bf16x2 pack; rows
// >= seq are computed on zero-filled q and dO and never stored. Edge
// tiles and bf16 p take the element-by-element path.

__global__ void __launch_bounds__(kThreads)
attention_bwd_dq_tc_kernel(BwdArgs a) {
  using bf16 = __nv_bfloat16;
  const bf16* q = static_cast<const bf16*>(a.q);
  const bf16* k = static_cast<const bf16*>(a.k);
  const bf16* v = static_cast<const bf16*>(a.v);
  const bf16* dout = static_cast<const bf16*>(a.dout);
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  uint8_t* q_s = smem;
  uint8_t* do_s = smem + kTileBytes;
  // the ring: stage st holds k at tile 2 + 2 st and v at 3 + 2 st
  auto k_s = [&](int st) { return smem + (2 + 2 * st) * kTileBytes; };
  auto v_s = [&](int st) { return smem + (3 + 2 * st) * kTileBytes; };

  int qt, b, h;
  tile_of_block(a, a.causal != 0, qt, b, h);
  const int seq = a.seq;
  const int q0 = qt * kTile;
  const long long stride = static_cast<long long>(a.heads) * 64;
  const long long base =
      static_cast<long long>(b) * seq * stride + static_cast<long long>(h) * 64;
  const long long vbase = (static_cast<long long>(b) * a.heads + h) * seq;
  const int kv_end = a.causal ? min(seq, q0 + kTile) : seq;
  const int n_tiles = (kv_end + kTile - 1) / kTile;

  // this thread's two query rows
  const int r0 = q0 + acc_row(0);
  const int r1 = q0 + acc_row(2);
  const float lse0 = r0 < seq ? a.lse[vbase + r0] : 0.f;
  const float lse1 = r1 < seq ? a.lse[vbase + r1] : 0.f;

  auto load_kv = [&](int tile, int stage) {
    load_tile(k_s(stage), k + base, stride, tile * kTile, seq);
    load_tile(v_s(stage), v + base, stride, tile * kTile, seq);
  };

  // the CTA's own q (scaled to qs in place) and dO, with key tile 0
  load_tile(q_s, q + base, stride, q0, seq);
  load_tile(do_s, dout + base, stride, q0, seq);
  load_kv(0, 0);
  cp_async_commit();
  cp_async_wait<0>();
  scale_own_chunks(q_s, a.scale);
  fence_proxy_async();
  __syncthreads();

  float s[32], dp[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.f;

  // The first query of a causal head sees one key: its softmax is 1 and
  // its gradient is rounding alone (exactly 0 when delta is taken here).
  // The reference gets that 0 from s and dp summed in sequence (its lse
  // comes from the same sums); the tensor cores sum in another order and
  // would leave a few ulps where the reference has none. So that one
  // element (thread 0's accumulator element 0) is summed again in sequence.
  const bool first_row = a.causal && q0 == 0;

  // one sweep over the key tiles; tile 0's copies are in flight. per_tile
  // gets the tile's first key, its stage and whether it needs masks.
  auto sweep = [&](auto&& per_tile) {
    for (int t = 0; t < n_tiles; ++t) {
      const int st = t & 1;
      if (t + 1 < n_tiles) load_kv(t + 1, st ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
      fence_proxy_async();
      __syncthreads();
      fence_acc(s);
      fence_acc(dp);
      wgmma_fence();
      product_dd(s, q_s, k_s(st));
      product_dd(dp, do_s, v_s(st));
      wgmma_commit();
      wgmma_wait_all();
      fence_acc(s);
      fence_acc(dp);
      if (first_row && t == 0 && threadIdx.x == 0) {
        s[0] = dot_row0(q_s, k_s(0));
        dp[0] = dot_row0(do_s, v_s(0));
      }
      const int k0 = t * kTile;
      const bool edge = k0 + kTile > seq || (a.causal && k0 + kTile > q0 + 1);
      per_tile(k0, st, edge || a.p_bf16);
      __syncthreads();   // stage st is refilled in the next iteration
    }
  };
  auto keep = [&](int key, int row) {
    return row < seq && key < seq && (!a.causal || key <= row);
  };

  float delta0, delta1;
  if (a.compute_delta) {
    // sweep 1: delta over the whole row, from p in p's dtype
    float part0 = 0.f, part1 = 0.f;
    sweep([&](int k0, int, bool slow) {
      if (slow) {
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const bool lo = (i & 2) == 0;
          if (keep(k0 + acc_col(i), lo ? r0 : r1)) {
            const float p = prob_tc(s[i], lo ? lse0 : lse1, a.p_bf16);
            if (lo) {
              part0 += p * dp[i];
            } else {
              part1 += p * dp[i];
            }
          }
        }
      } else {
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          if ((i & 2) == 0) {
            part0 += exp_tc(s[i] - lse0) * dp[i];
          } else {
            part1 += exp_tc(s[i] - lse1) * dp[i];
          }
        }
      }
    });
    // the row's four lanes
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      part0 += __shfl_xor_sync(0xffffffffu, part0, off);
      part1 += __shfl_xor_sync(0xffffffffu, part1, off);
    }
    delta0 = part0;
    delta1 = part1;
    if ((threadIdx.x & 3) == 0) {
      if (r0 < seq) a.delta[vbase + r0] = delta0;
      if (r1 < seq) a.delta[vbase + r1] = delta1;
    }
    load_kv(0, 0);   // sweep 2 starts over
    cp_async_commit();
  } else {
    delta0 = r0 < seq ? a.delta[vbase + r0] : 0.f;
    delta1 = r1 < seq ? a.delta[vbase + r1] : 0.f;
  }

  // sweep 2: ds, then dq += ds k with ds as the register A operand
  float acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;
  sweep([&](int k0, int st, bool slow) {
    uint32_t frag[16];
    if (slow) {
#pragma unroll
      for (int i = 0; i < 32; i += 2) {
        const bool lo = (i & 2) == 0;
        float ds[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          ds[e] = 0.f;
          if (keep(k0 + acc_col(i + e), lo ? r0 : r1)) {
            const float p = prob_tc(s[i + e], lo ? lse0 : lse1, a.p_bf16);
            ds[e] = dscore<__nv_bfloat16>(p, dp[i + e],
                                          lo ? delta0 : delta1, a.p_bf16);
          }
        }
        frag[i / 2] = pack_bf16(ds[0], ds[1]);
      }
    } else {
      // ds = p (dp - delta), rounded once to bf16 by the pack
#pragma unroll
      for (int i = 0; i < 32; i += 2) {
        const bool lo = (i & 2) == 0;
        const float l = lo ? lse0 : lse1;
        const float d = lo ? delta0 : delta1;
        frag[i / 2] = pack_bf16(exp_tc(s[i] - l) * (dp[i] - d),
                                exp_tc(s[i + 1] - l) * (dp[i + 1] - d));
      }
    }
    fence_acc(acc);
    wgmma_fence();
    product_rows(acc, frag, k_s(st));
    wgmma_commit();
    wgmma_wait_all();
    fence_acc(acc);
  });

#pragma unroll
  for (int i = 0; i < 32; i += 2) {
    const int row = q0 + acc_row(i);
    if (row < seq) {
      *reinterpret_cast<uint32_t*>(static_cast<bf16*>(a.dq) + base +
                                    row * stride + acc_col(i)) =
          pack_bf16(acc[i] * a.scale, acc[i + 1] * a.scale);
    }
  }
}

// ---------------------------------------------------------- dk/dv pass
//
// Per query tile: S^T = k qs^T and dP^T = v dO^T (eight wgmma, keys as
// rows), then per element p^T and ds^T, then dv += p^T dO and dk += ds^T
// qs (eight wgmma, p^T and ds^T from registers). Interior tiles (every
// query < seq and, causal, every query >= every key) take no mask; key
// rows >= seq see zero-filled k and v and are never stored.

__global__ void __launch_bounds__(kThreads, 3)
attention_bwd_dkv_tc_kernel(BwdArgs a) {
  using bf16 = __nv_bfloat16;
  const bf16* q = static_cast<const bf16*>(a.q);
  const bf16* k = static_cast<const bf16*>(a.k);
  const bf16* v = static_cast<const bf16*>(a.v);
  const bf16* dout = static_cast<const bf16*>(a.dout);
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  uint8_t* k_s = smem;
  uint8_t* v_s = smem + kTileBytes;
  // the ring: stage st holds q at tile 2 + 2 st, dO at 3 + 2 st, then its
  // 64 lse and 64 delta values after all the tiles
  auto q_s = [&](int st) { return smem + (2 + 2 * st) * kTileBytes; };
  auto do_s = [&](int st) { return smem + (3 + 2 * st) * kTileBytes; };
  auto lse_s = [&](int st) {
    return reinterpret_cast<float*>(smem + (2 + 2 * kStages) * kTileBytes) +
           st * 2 * kTile;
  };
  auto delta_s = [&](int st) { return lse_s(st) + kTile; };

  int kt, b, h;
  tile_of_block(a, false, kt, b, h);
  const int seq = a.seq;
  const int k0 = kt * kTile;
  const long long stride = static_cast<long long>(a.heads) * 64;
  const long long base =
      static_cast<long long>(b) * seq * stride + static_cast<long long>(h) * 64;
  const long long vbase = (static_cast<long long>(b) * a.heads + h) * seq;
  // causal: queries before this tile's first key see none of it
  const int first = a.causal ? kt : 0;
  const int n_qt = (seq + kTile - 1) / kTile;

  auto load_q = [&](int tile, int stage) {
    const int row0 = tile * kTile;
    load_tile(q_s(stage), q + base, stride, row0, seq);
    load_tile(do_s(stage), dout + base, stride, row0, seq);
    const int i = threadIdx.x & (kTile - 1);
    const bool ok = row0 + i < seq;
    const long long at = vbase + (ok ? row0 + i : 0);
    if (threadIdx.x < kTile) {
      cp_async4(lse_s(stage) + i, a.lse + at, ok);
    } else {
      cp_async4(delta_s(stage) + i, a.delta + at, ok);
    }
  };

  load_tile(k_s, k + base, stride, k0, seq);
  load_tile(v_s, v + base, stride, k0, seq);
  load_q(first, 0);
  cp_async_commit();

  // this thread's two key rows
  const int key0 = k0 + acc_row(0);
  const int key1 = k0 + acc_row(2);

  float s[32], dp[32], dk[32], dv[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = dp[i] = dk[i] = dv[i] = 0.f;

  for (int t = first; t < n_qt; ++t) {
    const int st = (t - first) & 1;
    if (t + 1 < n_qt) load_q(t + 1, st ^ 1);
    cp_async_commit();
    cp_async_wait<1>();
    scale_own_chunks(q_s(st), a.scale);   // qs = bf16(q * scale)
    fence_proxy_async();
    __syncthreads();

    fence_acc(s);
    fence_acc(dp);
    wgmma_fence();
    product_dd(s, k_s, q_s(st));
    product_dd(dp, v_s, do_s(st));
    wgmma_commit();
    wgmma_wait_all();
    fence_acc(s);
    fence_acc(dp);

    const int q0 = t * kTile;
    const float* lse_t = lse_s(st);
    const float* delta_t = delta_s(st);
    const bool slow =
        q0 + kTile > seq || (a.causal && q0 < k0 + kTile - 1) || a.p_bf16;
    uint32_t pf[16], dsf[16];
    if (slow) {
#pragma unroll
      for (int i = 0; i < 32; i += 2) {
        const int key = (i & 2) ? key1 : key0;
        float p[2], ds[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = acc_col(i + e);
          const int query = q0 + c;
          p[e] = ds[e] = 0.f;
          if (key < seq && query < seq && (!a.causal || key <= query)) {
            p[e] = prob_tc(s[i + e], lse_t[c], a.p_bf16);
            ds[e] = dscore<__nv_bfloat16>(p[e], dp[i + e], delta_t[c],
                                          a.p_bf16);
          }
        }
        pf[i / 2] = pack_bf16(p[0], p[1]);   // dv takes p in bf16
        dsf[i / 2] = pack_bf16(ds[0], ds[1]);
      }
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        // the two queries of columns 8 j + 2 (lane % 4) + {0, 1}
        const int c = 8 * j + 2 * (threadIdx.x & 3);
        const float2 l = *reinterpret_cast<const float2*>(lse_t + c);
        const float2 d = *reinterpret_cast<const float2*>(delta_t + c);
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int i = 4 * j + 2 * half;
          const float p0 = exp_tc(s[i] - l.x);
          const float p1 = exp_tc(s[i + 1] - l.y);
          pf[i / 2] = pack_bf16(p0, p1);
          // ds = p (dp - delta), rounded once to bf16 by the pack
          dsf[i / 2] = pack_bf16(p0 * (dp[i] - d.x), p1 * (dp[i + 1] - d.y));
        }
      }
    }
    fence_acc(dv);
    fence_acc(dk);
    wgmma_fence();
    product_rows(dv, pf, do_s(st));
    product_rows(dk, dsf, q_s(st));
    wgmma_commit();
    wgmma_wait_all();
    fence_acc(dv);
    fence_acc(dk);
    __syncthreads();   // stage st is refilled in the next iteration
  }

#pragma unroll
  for (int i = 0; i < 32; i += 2) {
    const int key = k0 + acc_row(i);
    if (key < seq) {
      const long long off = base + key * stride + acc_col(i);
      // dk = ds^T qs: q was staged pre-scaled, no extra factor
      *reinterpret_cast<uint32_t*>(static_cast<bf16*>(a.dk) + off) =
          pack_bf16(dk[i], dk[i + 1]);
      *reinterpret_cast<uint32_t*>(static_cast<bf16*>(a.dv) + off) =
          pack_bf16(dv[i], dv[i + 1]);
    }
  }
}

}  // namespace tc
}  // namespace dl4jt
