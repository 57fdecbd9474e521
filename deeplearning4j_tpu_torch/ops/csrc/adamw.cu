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
// has no lane constraint, so one launch covers up to kMaxLeaves leaves
// (larger trees take one launch per kMaxLeaves): the leaves' p, g, m, v
// pointers, sizes, dtype codes and first chunks travel in the kernel's
// parameter struct (__grid_constant__, read from the constant bank; CUDA
// 12.1+ takes up to 32 KB of parameters), filled by the C entry point
// from a host table, so a step needs no device table, no pinned buffer and
// no host-to-device copy. Each CTA takes one chunk of `chunk` elements
// (the wrapper's choice, a multiple of 4), finds its leaf by binary search
// over the first chunks in that struct, and sweeps the chunk four elements
// at a time (one 16-byte fp32 or 8-byte bf16 load per operand, each
// operand by its own dtype; two such groups in flight per thread before
// any store), scalar loads for a misaligned leaf and the tail. Every
// operation is written with an explicitly rounded intrinsic (__fmul_rn,
// __fadd_rn, __fdiv_rn, __fsqrt_rn), so nvcc contracts nothing into an FMA
// and each step rounds as PyTorch's elementwise operations round it in the
// plain version.
#include "dtype.cuh"

namespace dl4jt {
namespace {

constexpr int kThreads = 256;
// leaves per launch: 64 bytes each, 16 KB of kernel parameters
constexpr int kMaxLeaves = 256;

// One leaf: device pointers, size, first chunk (of this launch) and the
// dtype codes of p, g, m and v (0 fp32, 1 bf16).
struct AdamwLeaf {
  void* p;
  const void* g;
  void* m;
  void* v;
  long long numel;
  long long chunk0;
  int p_dtype, g_dtype, m_dtype, v_dtype;
};

struct AdamwArgs {
  float lr, b1, b2, one_minus_b1, one_minus_b2, eps, wd, bc1, bc2;
};

struct AdamwParams {
  AdamwArgs a;
  long long chunk;
  int n_leaves;
  AdamwLeaf leaves[kMaxLeaves];
};

__device__ __forceinline__ float load(const void* ptr, int dtype,
                                      long long i) {
  if (dtype == kBF16) {
    return __bfloat162float(static_cast<const __nv_bfloat16*>(ptr)[i]);
  }
  return static_cast<const float*>(ptr)[i];
}

__device__ __forceinline__ void store(void* ptr, int dtype, long long i,
                                      float x) {
  if (dtype == kBF16) {
    static_cast<__nv_bfloat16*>(ptr)[i] = __float2bfloat16_rn(x);
  } else {
    static_cast<float*>(ptr)[i] = x;
  }
}

// elements 4 i4 .. 4 i4 + 3: one 16-byte (fp32) or 8-byte (bf16) access
__device__ __forceinline__ float4 load4(const void* __restrict__ ptr,
                                        int dtype, long long i4) {
  if (dtype == kBF16) {
    const uint2 r = static_cast<const uint2*>(ptr)[i4];
    return make_float4(__uint_as_float(r.x << 16),
                       __uint_as_float(r.x & 0xffff0000u),
                       __uint_as_float(r.y << 16),
                       __uint_as_float(r.y & 0xffff0000u));
  }
  return static_cast<const float4*>(ptr)[i4];
}

__device__ __forceinline__ uint32_t bf16_pair(float lo, float hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(lo))) |
         (static_cast<uint32_t>(
              __bfloat16_as_ushort(__float2bfloat16_rn(hi))) << 16);
}

__device__ __forceinline__ void store4(void* __restrict__ ptr, int dtype,
                                       long long i4, const float4& x) {
  if (dtype == kBF16) {
    static_cast<uint2*>(ptr)[i4] =
        make_uint2(bf16_pair(x.x, x.y), bf16_pair(x.z, x.w));
  } else {
    static_cast<float4*>(ptr)[i4] = x;
  }
}

__device__ __forceinline__ bool aligned4(const void* ptr, int dtype) {
  return (reinterpret_cast<uintptr_t>(ptr) & (dtype == kBF16 ? 7 : 15)) == 0;
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

__device__ __forceinline__ void update4(const AdamwArgs& a, float4& p,
                                        const float4& g, float4& m,
                                        float4& v) {
  update(a, p.x, g.x, m.x, v.x);
  update(a, p.y, g.y, m.y, v.y);
  update(a, p.z, g.z, m.z, v.z);
  update(a, p.w, g.w, m.w, v.w);
}

// elements [start, end) of one leaf, 4 at a time, two groups of 4 per
// thread loaded before either is stored
__device__ __forceinline__ void sweep4(
    const AdamwArgs& a, void* __restrict__ p, const void* __restrict__ g,
    void* __restrict__ m, void* __restrict__ v, int pd, int gd, int md,
    int vd, long long start4, long long n4) {
  for (long long j = threadIdx.x; j < n4; j += 2 * kThreads) {
    const long long i0 = start4 + j;
    const long long i1 = i0 + kThreads;
    const bool two = j + kThreads < n4;
    float4 p0 = load4(p, pd, i0), m0 = load4(m, md, i0),
           v0 = load4(v, vd, i0);
    const float4 g0 = load4(g, gd, i0);
    float4 p1 = p0, m1 = m0, v1 = v0, g1 = g0;
    if (two) {
      p1 = load4(p, pd, i1);
      m1 = load4(m, md, i1);
      v1 = load4(v, vd, i1);
      g1 = load4(g, gd, i1);
    }
    update4(a, p0, g0, m0, v0);
    store4(p, pd, i0, p0);
    store4(m, md, i0, m0);
    store4(v, vd, i0, v0);
    if (two) {
      update4(a, p1, g1, m1, v1);
      store4(p, pd, i1, p1);
      store4(m, md, i1, m1);
      store4(v, vd, i1, v1);
    }
  }
}

__global__ void __launch_bounds__(kThreads)
    adamw_kernel(const __grid_constant__ AdamwParams P) {
  const long long c = blockIdx.x;
  // the last leaf whose first chunk is <= c (the struct holds no empty
  // leaf, so first chunks rise strictly)
  int lo = 0, hi = P.n_leaves - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) / 2;
    if (P.leaves[mid].chunk0 <= c) lo = mid; else hi = mid - 1;
  }
  const AdamwLeaf& L = P.leaves[lo];
  const long long start = (c - L.chunk0) * P.chunk;
  const long long end = min(start + P.chunk, L.numel);
  long long i = start + threadIdx.x;
  if (aligned4(L.p, L.p_dtype) && aligned4(L.g, L.g_dtype) &&
      aligned4(L.m, L.m_dtype) && aligned4(L.v, L.v_dtype)) {
    // start is a multiple of chunk, so every 4-group below is aligned
    const long long n4 = (end - start) / 4;
    sweep4(P.a, L.p, L.g, L.m, L.v, L.p_dtype, L.g_dtype, L.m_dtype,
           L.v_dtype, start / 4, n4);
    i = start + 4 * n4 + threadIdx.x;
  }
  for (; i < end; i += kThreads) {
    float p = load(L.p, L.p_dtype, i);
    float m = load(L.m, L.m_dtype, i);
    float v = load(L.v, L.v_dtype, i);
    update(P.a, p, load(L.g, L.g_dtype, i), m, v);
    store(L.p, L.p_dtype, i, p);
    store(L.m, L.m_dtype, i, m);
    store(L.v, L.v_dtype, i, v);
  }
}

}  // namespace
}  // namespace dl4jt

extern "C" {

// table: (n_leaves, 6) int64 in HOST memory, one row per leaf: the device
// pointers of p, g, m and v (each contiguous, g shaped like p), numel, and
// the dtype codes of p, g, m, v packed one per byte (p lowest; 0 fp32,
// 1 bf16). chunk: elements per CTA, a multiple of 4. bc1 and bc2 are the
// bias corrections of this step. The leaves go in launches of up to
// kMaxLeaves non-empty leaves, each its own parameter struct. Returns a
// cudaError_t.
int adamw(const long long* table, int n_leaves, long long chunk, float lr,
          float b1, float b2, float one_minus_b1, float one_minus_b2,
          float eps, float wd, float bc1, float bc2, void* stream) {
  if (n_leaves < 0 || chunk <= 0 || chunk % 4 || table == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  using dl4jt::AdamwLeaf;
  // 16 KB: not on the caller's stack; one per calling thread
  static thread_local dl4jt::AdamwParams P;
  P.a = dl4jt::AdamwArgs{lr, b1, b2, one_minus_b1, one_minus_b2,
                         eps, wd, bc1, bc2};
  P.chunk = chunk;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  int k = 0;
  while (k < n_leaves) {
    int n = 0;
    long long chunks = 0;
    for (; k < n_leaves && n < dl4jt::kMaxLeaves; ++k) {
      const long long* row = table + 6LL * k;
      const long long numel = row[4];
      if (numel <= 0) continue;
      const long long codes = row[5];
      AdamwLeaf& L = P.leaves[n++];
      L.p = reinterpret_cast<void*>(row[0]);
      L.g = reinterpret_cast<const void*>(row[1]);
      L.m = reinterpret_cast<void*>(row[2]);
      L.v = reinterpret_cast<void*>(row[3]);
      L.numel = numel;
      L.chunk0 = chunks;
      L.p_dtype = static_cast<int>(codes & 0xff);
      L.g_dtype = static_cast<int>((codes >> 8) & 0xff);
      L.m_dtype = static_cast<int>((codes >> 16) & 0xff);
      L.v_dtype = static_cast<int>((codes >> 24) & 0xff);
      chunks += (numel + chunk - 1) / chunk;
    }
    if (n == 0) break;
    if (chunks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
    P.n_leaves = n;
    dl4jt::adamw_kernel<<<static_cast<unsigned>(chunks), dl4jt::kThreads, 0,
                          st>>>(P);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

const char* adamw_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
