// Fused paged decode attention for sm_90a.
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
// element read, so it is bound by HBM bytes; at the serving shapes (16
// slots, a few hundred positions) a call moves a few MB and latency
// (block-table lookups, dependent loads) dominates.
//
// Design: the TPU kernel lets a scalar-prefetched table drive the DMA and
// carries m/l/acc across a sequential grid in scratch; Hopper has neither.
// Here one CTA per (slot, head) reads pos[s], loops over the slot's blocks
// j = 0..pos/B itself, looks up tables[s, j], stages that block's K and V
// for head h into shared memory (dequantizing int8 on the way, skipping
// positions past pos), and runs the online softmax in fp32: one thread per
// position for the scores, one thread per head dimension for P.V. Blocks
// past pos are never read. Dead slots (all-zero table row, pos 0) read
// position 0 of scratch block 0 and emit a finite row. No split over
// blocks (flash-decoding) in this version.
#include "dtype.cuh"

namespace dl4jt {
namespace {

template <typename TQ, typename TKV>
__global__ void paged_decode_kernel(
    const TQ* __restrict__ q, const TKV* __restrict__ k_pool,
    const TKV* __restrict__ v_pool, const float* __restrict__ k_scale,
    const float* __restrict__ v_scale, const int* __restrict__ tables,
    const int* __restrict__ pos, TQ* __restrict__ o, int heads, int head_dim,
    int num_blocks, int block_size, int nbmax, float scale) {
  extern __shared__ float smem[];
  const int D = head_dim;
  const int B = block_size;
  float* q_s = smem;                  // D
  float* k_s = q_s + D;               // B x (D + 1): +1 pad, threads read rows
  float* v_s = k_s + B * (D + 1);     // B x D
  float* s_s = v_s + B * D;           // B scores

  const int s = blockIdx.x;
  const int h = blockIdx.y;
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const long long qo = (static_cast<long long>(s) * heads + h) * D;
  for (int d = tid; d < D; d += nthreads) q_s[d] = to_f(q[qo + d]) * scale;

  const int p = pos[s];
  // blocks 0..p/B, clipped to the table width (the reference grid's
  // extent); p < 0 attends nothing and emits zeros, as the reference does
  const int n_blocks = p < 0 ? 0 : min(nbmax, p / B + 1);
  float m = kNegInf;
  float l = 0.f;
  float acc = 0.f;   // output dimension tid (tid < D)
  for (int j = 0; j < n_blocks; ++j) {
    int phys = tables[static_cast<long long>(s) * nbmax + j];
    // an out-of-range entry is clamped, as XLA clamps the gather the
    // reference routes use; the engine never writes one
    phys = min(max(phys, 0), num_blocks - 1);
    __syncthreads();   // q_s written / previous block's readers done
    for (int idx = tid; idx < B * D; idx += nthreads) {
      const int t = idx / D;
      const int d = idx - t * D;
      float kf = 0.f, vf = 0.f;
      if (j * B + t <= p) {
        const long long row = (static_cast<long long>(phys) * B + t) * heads + h;
        kf = to_f(k_pool[row * D + d]);
        vf = to_f(v_pool[row * D + d]);
        if (k_scale != nullptr) {
          kf *= k_scale[row];
          vf *= v_scale[row];
        }
      }
      k_s[t * (D + 1) + d] = kf;
      v_s[t * D + d] = vf;
    }
    __syncthreads();
    for (int t = tid; t < B; t += nthreads) {
      float dot = 0.f;
      for (int d = 0; d < D; ++d) dot = fmaf(q_s[d], k_s[t * (D + 1) + d], dot);
      s_s[t] = (j * B + t <= p) ? dot : kNegInf;
    }
    __syncthreads();
    float blk_max = kNegInf;
    for (int t = 0; t < B; ++t) blk_max = fmaxf(blk_max, s_s[t]);
    // block 0 holds position 0 <= p: m is real from the first block on
    const float m_new = fmaxf(m, blk_max);
    const float alpha = expf(m - m_new);
    float l_blk = 0.f;
    float a = 0.f;
    for (int t = 0; t < B; ++t) {
      const float pt = expf(s_s[t] - m_new);
      l_blk += pt;
      if (tid < D) a = fmaf(pt, v_s[t * D + tid], a);
    }
    l = l * alpha + l_blk;
    acc = acc * alpha + a;
    m = m_new;
  }
  if (tid < D) o[qo + tid] = from_f<TQ>(acc / fmaxf(l, 1e-30f));
}

template <typename TQ, typename TKV>
int launch(const void* q, const void* k_pool, const void* v_pool,
           const void* k_scale, const void* v_scale, const void* tables,
           const void* pos, void* o, int slots, int heads, int head_dim,
           int num_blocks, int block_size, int nbmax, float scale,
           cudaStream_t stream) {
  const int width = head_dim > block_size ? head_dim : block_size;
  const int threads = ((width + 31) / 32) * 32;
  const size_t smem = sizeof(float) *
      (static_cast<size_t>(head_dim) + block_size * (head_dim + 1) +
       static_cast<size_t>(block_size) * head_dim + block_size);
  const dim3 grid(slots, heads);
  paged_decode_kernel<TQ, TKV><<<grid, threads, smem, stream>>>(
      static_cast<const TQ*>(q), static_cast<const TKV*>(k_pool),
      static_cast<const TKV*>(v_pool), static_cast<const float*>(k_scale),
      static_cast<const float*>(v_scale), static_cast<const int*>(tables),
      static_cast<const int*>(pos), static_cast<TQ*>(o), heads, head_dim,
      num_blocks, block_size, nbmax, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename TQ>
int launch_kv(int kv_dtype, const void* q, const void* k_pool,
              const void* v_pool, const void* k_scale, const void* v_scale,
              const void* tables, const void* pos, void* o, int slots,
              int heads, int head_dim, int num_blocks, int block_size,
              int nbmax, float scale, cudaStream_t stream) {
  switch (kv_dtype) {
    case kF32:
      return launch<TQ, float>(q, k_pool, v_pool, k_scale, v_scale, tables,
                               pos, o, slots, heads, head_dim, num_blocks,
                               block_size, nbmax, scale, stream);
    case kBF16:
      return launch<TQ, __nv_bfloat16>(q, k_pool, v_pool, k_scale, v_scale,
                                       tables, pos, o, slots, heads, head_dim,
                                       num_blocks, block_size, nbmax, scale,
                                       stream);
    case kI8:
      return launch<TQ, int8_t>(q, k_pool, v_pool, k_scale, v_scale, tables,
                                pos, o, slots, heads, head_dim, num_blocks,
                                block_size, nbmax, scale, stream);
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
// nbmax) int32; pos: (slots,) int32. All contiguous. Returns a cudaError_t.
int paged_decode(const void* q, const void* k_pool, const void* v_pool,
                 const void* k_scale, const void* v_scale, const void* tables,
                 const void* pos, void* o, int slots, int heads, int head_dim,
                 int num_blocks, int block_size, int nbmax, float scale,
                 int q_dtype, int kv_dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (q_dtype == dl4jt::kF32) {
    return dl4jt::launch_kv<float>(kv_dtype, q, k_pool, v_pool, k_scale,
                                   v_scale, tables, pos, o, slots, heads,
                                   head_dim, num_blocks, block_size, nbmax,
                                   scale, st);
  }
  if (q_dtype == dl4jt::kBF16) {
    return dl4jt::launch_kv<__nv_bfloat16>(kv_dtype, q, k_pool, v_pool,
                                           k_scale, v_scale, tables, pos, o,
                                           slots, heads, head_dim, num_blocks,
                                           block_size, nbmax, scale, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* paged_decode_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
