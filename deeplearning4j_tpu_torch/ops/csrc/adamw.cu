// Fused in-place AdamW over every leaf of a parameter tree, for sm_90a.
//
// Replaces the Pallas kernel `_adamw_kernel` (called from `_adamw_leaf`,
// deeplearning4j_tpu/ops/pallas_updaters.py) and the jnp path beside it,
// at optax.adamw's semantics: with the count already incremented and
// bc1 = 1 - b1^t, bc2 = 1 - b2^t,
//   m = b1 m + (1 - b1) g,  v = b2 v + (1 - b2) g^2,
//   p = p - lr ((m / bc1) / (sqrt(v / bc2) + eps) + wd p),
// in fp32 whatever each operand's dtype, each result cast back to its own
// operand's dtype (fp32 or bf16), p, m and v updated in place.
//
// What bounds it here: each element reads p, g, m, v and writes p, m, v
// (28 bytes in fp32) for ~15 fp32 operations: HBM bytes. Over BERT-base's
// 132,331,008 parameters that is 3.71 GB, 1.11 ms at 3.35 TB/s.
//
// Design: the TPU runs one pallas_call per leaf of at least 65536 elements
// that divides into 128 lanes, and jnp for the other leaves. A CUDA kernel
// has no lane constraint, so one launch covers every leaf: a device table
// holds each leaf's p, m, v pointers, size, dtype codes and first chunk
// (built once per leaf set by the wrapper, as p, m and v are updated in
// place and keep their addresses), a second array the step's gradient
// pointers. Each CTA takes one chunk of `chunk` elements (the wrapper's
// choice, a multiple of 4), finds its leaf by binary search over the first
// chunks, and sweeps the chunk with 16-byte vector loads where all four
// operands are fp32 and 16-byte aligned, scalar loads otherwise. Every
// operation is written with an explicitly rounded intrinsic (__fmul_rn,
// __fadd_rn, __fdiv_rn, __fsqrt_rn), so nvcc contracts nothing into an FMA
// and each step rounds as PyTorch's elementwise operations round it in the
// plain version.
#include "dtype.cuh"

namespace dl4jt {
namespace {

constexpr int kThreads = 256;

// One leaf. Every field is 64-bit so the wrapper fills the table as an
// int64 tensor of 9 columns.
struct AdamwLeaf {
  long long p, m, v;          // device pointers
  long long numel;
  long long chunk0;           // the leaf's first chunk
  long long p_dtype, g_dtype, m_dtype, v_dtype;
};

struct AdamwArgs {
  float lr, b1, b2, one_minus_b1, one_minus_b2, eps, wd, bc1, bc2;
};

__device__ __forceinline__ float load(long long ptr, long long dtype,
                                      long long i) {
  if (dtype == kBF16) {
    return __bfloat162float(reinterpret_cast<const __nv_bfloat16*>(ptr)[i]);
  }
  return reinterpret_cast<const float*>(ptr)[i];
}

__device__ __forceinline__ void store(long long ptr, long long dtype,
                                      long long i, float x) {
  if (dtype == kBF16) {
    reinterpret_cast<__nv_bfloat16*>(ptr)[i] = __float2bfloat16_rn(x);
  } else {
    reinterpret_cast<float*>(ptr)[i] = x;
  }
}

// One element, in the plain version's order of operations.
__device__ __forceinline__ void update(const AdamwArgs& a, float& p, float g,
                                       float& m, float& v) {
  m = __fadd_rn(__fmul_rn(a.b1, m), __fmul_rn(a.one_minus_b1, g));
  v = __fadd_rn(__fmul_rn(a.b2, v),
                __fmul_rn(a.one_minus_b2, __fmul_rn(g, g)));
  const float u = __fdiv_rn(
      __fdiv_rn(m, a.bc1),
      __fadd_rn(__fsqrt_rn(__fdiv_rn(v, a.bc2)), a.eps));
  p = __fsub_rn(p, __fmul_rn(a.lr, __fadd_rn(u, __fmul_rn(a.wd, p))));
}

__global__ void __launch_bounds__(kThreads)
    adamw_kernel(const AdamwLeaf* __restrict__ leaves,
                 const long long* __restrict__ grads, int n_leaves,
                 long long chunk, AdamwArgs a) {
  const long long c = blockIdx.x;
  // the last leaf whose first chunk is <= c (empty leaves share their
  // successor's first chunk and are skipped)
  int lo = 0, hi = n_leaves - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) / 2;
    if (leaves[mid].chunk0 <= c) lo = mid; else hi = mid - 1;
  }
  const AdamwLeaf L = leaves[lo];
  const long long g = grads[lo];
  const long long start = (c - L.chunk0) * chunk;
  const long long end = min(start + chunk, L.numel);
  long long i = start + threadIdx.x;

  const bool all_f32 = L.p_dtype == kF32 && L.g_dtype == kF32 &&
                       L.m_dtype == kF32 && L.v_dtype == kF32;
  if (all_f32 && ((L.p | L.m | L.v | g) & 15) == 0) {
    // start is a multiple of chunk, so every float4 below is aligned
    const long long n4 = (end - start) / 4;
    float4* p4 = reinterpret_cast<float4*>(L.p) + start / 4;
    float4* m4 = reinterpret_cast<float4*>(L.m) + start / 4;
    float4* v4 = reinterpret_cast<float4*>(L.v) + start / 4;
    const float4* g4 = reinterpret_cast<const float4*>(g) + start / 4;
    for (long long j = threadIdx.x; j < n4; j += kThreads) {
      float4 p = p4[j], m = m4[j], v = v4[j];
      const float4 gg = g4[j];
      update(a, p.x, gg.x, m.x, v.x);
      update(a, p.y, gg.y, m.y, v.y);
      update(a, p.z, gg.z, m.z, v.z);
      update(a, p.w, gg.w, m.w, v.w);
      p4[j] = p;
      m4[j] = m;
      v4[j] = v;
    }
    i = start + 4 * n4 + threadIdx.x;
  }
  for (; i < end; i += kThreads) {
    float p = load(L.p, L.p_dtype, i);
    float m = load(L.m, L.m_dtype, i);
    float v = load(L.v, L.v_dtype, i);
    update(a, p, load(g, L.g_dtype, i), m, v);
    store(L.p, L.p_dtype, i, p);
    store(L.m, L.m_dtype, i, m);
    store(L.v, L.v_dtype, i, v);
  }
}

}  // namespace
}  // namespace dl4jt

extern "C" {

// leaves: (n_leaves, 9) int64 on the device, one AdamwLeaf per row (p, m, v,
// numel, chunk0, then the dtype codes of p, g, m and v: 0 fp32, 1 bf16);
// grads: (n_leaves,) int64 device pointers of the gradients, each shaped
// like its leaf and contiguous; chunk: elements per CTA, a multiple of 4;
// total_chunks: the sum of ceil(numel / chunk) over the leaves. bc1 and bc2
// are the bias corrections of this step. Returns a cudaError_t.
int adamw(const void* leaves, const void* grads, int n_leaves,
          long long chunk, long long total_chunks, float lr, float b1,
          float b2, float one_minus_b1, float one_minus_b2, float eps,
          float wd, float bc1, float bc2, void* stream) {
  if (n_leaves <= 0 || chunk <= 0 || chunk % 4 || total_chunks <= 0 ||
      total_chunks > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dl4jt::AdamwArgs a{lr, b1, b2, one_minus_b1, one_minus_b2,
                           eps, wd, bc1, bc2};
  dl4jt::adamw_kernel<<<static_cast<unsigned>(total_chunks), dl4jt::kThreads,
                        0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const dl4jt::AdamwLeaf*>(leaves),
      static_cast<const long long*>(grads), n_leaves, chunk, a);
  return static_cast<int>(cudaGetLastError());
}

const char* adamw_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
