// Fused softmax cross-entropy, forward and backward, for sm_90a.
//
// Replaces the Pallas kernels `_xent_fwd_kernel` (called from
// `_xent_forward`) and `_xent_bwd_kernel` (called from `_xent_bwd_rule`),
// deeplearning4j_tpu/ops/pallas_kernels.py:
//   forward:  lse = m + log(sum(exp(x - m))), m the row max, and
//             loss = lse - x[t] per row of (N, V) logits, fp32 whatever the
//             logits' dtype; the target logit is a masked sum, so a target
//             outside [0, V) contributes 0 and the loss is lse;
//   backward: grad = (exp(x - lse) - onehot(t)) * g per element, computed in
//             fp32 and cast to the logits' dtype.
//
// What bounds it here: one read of the logits (forward), one read and one
// write (backward), a handful of fp32 operations per element: HBM bytes.
// At the MLM step's shape (N = 96 x 512, V = 30522, bf16) that is 3.0 GB
// (0.90 ms at 3.35 TB/s) forward and 6.0 GB (1.79 ms) backward.
//
// Design: the TPU kernel holds 8 whole rows in VMEM and reduces them with
// one max and one exp-sum. Here one CTA of 256 threads takes one row and
// streams it once: each thread keeps an online (max, sum) pair in fp32 over
// the 16-byte vectors it reads, rescaling once per vector, and the pairs
// merge through warp shuffles and shared memory. A bf16 row of V = 30522 is
// 61,044 bytes, so rows after the first start 4-byte but not 16-byte
// aligned: each row is split into a scalar head up to its first 16-byte
// boundary, a body of 16-byte vector loads, and a scalar tail. Thread 0
// reads the target logit when the target is in range (the wrapper maps every
// out-of-range target to -1). The backward recomputes exp(x - lse) from the
// saved lse on the same row split; its output row has the same alignment as
// its input row whenever both tensors start at the same offset modulo 16
// (fresh allocations), and takes the scalar path otherwise.
#include <math.h>

#include "dtype.cuh"

namespace dl4jt {
namespace {

constexpr int kThreads = 256;

// 16 bytes of T as fp32 values, and back (round to nearest even for bf16)
template <typename T>
struct Vec16;

template <>
struct Vec16<float> {
  static constexpr int kWidth = 4;
  __device__ __forceinline__ static void load(const float* p, float* f) {
    const float4 u = *reinterpret_cast<const float4*>(p);
    f[0] = u.x; f[1] = u.y; f[2] = u.z; f[3] = u.w;
  }
  __device__ __forceinline__ static void store(float* p, const float* f) {
    *reinterpret_cast<float4*>(p) = make_float4(f[0], f[1], f[2], f[3]);
  }
};

template <>
struct Vec16<__nv_bfloat16> {
  static constexpr int kWidth = 8;
  __device__ __forceinline__ static void load(const __nv_bfloat16* p,
                                              float* f) {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 x = __bfloat1622float2(h[i]);
      f[2 * i] = x.x;
      f[2 * i + 1] = x.y;
    }
  }
  __device__ __forceinline__ static void store(__nv_bfloat16* p,
                                               const float* f) {
    uint4 u;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      h[i] = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
    }
    *reinterpret_cast<uint4*>(p) = u;
  }
};

// A row of v elements at p: `head` scalar elements up to the first 16-byte
// boundary, `vecs` 16-byte vectors, then scalars from `tail` to v.
struct RowSplit {
  int head, vecs, tail;
};

template <typename T>
__device__ __forceinline__ RowSplit split_row(const T* p, int v) {
  constexpr int W = Vec16<T>::kWidth;
  const int mis = static_cast<int>(reinterpret_cast<uintptr_t>(p) & 15);
  const int head = min(((16 - mis) & 15) / static_cast<int>(sizeof(T)), v);
  const int vecs = (v - head) / W;
  return {head, vecs, head + vecs * W};
}

// (m, s) += the elements f[0..n), s kept relative to m. Elements that are all
// -inf so far leave the pair empty (m = -inf, s = 0) instead of making NaN
// from -inf - -inf; a NaN element still makes s NaN, as in the reference
// (fmaxf drops NaN from the max, the exp-sum does not).
__device__ __forceinline__ void online_add(float& m, float& s, const float* f,
                                           int n) {
  float vm = f[0];
  for (int i = 1; i < n; ++i) vm = fmaxf(vm, f[i]);
  const float mn = fmaxf(m, vm);
  if (mn == -INFINITY) {
    if (isnan(vm)) s = vm;
    return;
  }
  float acc = 0.f;
  for (int i = 0; i < n; ++i) acc += expf(f[i] - mn);
  s = s * expf(m - mn) + acc;
  m = mn;
}

__device__ __forceinline__ void merge(float& m, float& s, float m2, float s2) {
  const float mn = fmaxf(m, m2);
  if (mn == -INFINITY) {   // both empty: s and s2 are each 0 or NaN
    s += s2;
    return;
  }
  s = s * expf(m - mn) + s2 * expf(m2 - mn);
  m = mn;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    xent_fwd_kernel(const T* __restrict__ logits,
                    const int* __restrict__ targets, float* __restrict__ loss,
                    float* __restrict__ lse_out, int v) {
  using V16 = Vec16<T>;
  constexpr int W = V16::kWidth;
  const int row = blockIdx.x;
  const int tid = threadIdx.x;
  const T* x = logits + static_cast<long long>(row) * v;
  const RowSplit sp = split_row(x, v);

  float m = -INFINITY, s = 0.f;
  for (int i = tid; i < sp.head; i += kThreads) {
    const float f = to_f(x[i]);
    online_add(m, s, &f, 1);
  }
  const T* body = x + sp.head;
#pragma unroll 2
  for (int j = tid; j < sp.vecs; j += kThreads) {
    float f[W];
    V16::load(body + static_cast<long long>(j) * W, f);
    online_add(m, s, f, W);
  }
  for (int i = sp.tail + tid; i < v; i += kThreads) {
    const float f = to_f(x[i]);
    online_add(m, s, &f, 1);
  }

  // warp, then CTA
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float m2 = __shfl_xor_sync(0xffffffffu, m, off);
    const float s2 = __shfl_xor_sync(0xffffffffu, s, off);
    merge(m, s, m2, s2);
  }
  __shared__ float m_s[kThreads / 32], s_s[kThreads / 32];
  const int warp = tid / 32, lane = tid % 32;
  if (lane == 0) {
    m_s[warp] = m;
    s_s[warp] = s;
  }
  __syncthreads();
  if (tid == 0) {
    m = m_s[0];
    s = s_s[0];
    for (int w = 1; w < kThreads / 32; ++w) merge(m, s, m_s[w], s_s[w]);
    const float lse = logf(s) + m;
    const int t = targets[row];
    const float tgt = (t >= 0 && t < v) ? to_f(x[t]) : 0.f;
    loss[row] = lse - tgt;
    lse_out[row] = lse;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    xent_bwd_kernel(const T* __restrict__ logits,
                    const int* __restrict__ targets,
                    const float* __restrict__ lse, const float* __restrict__ g,
                    T* __restrict__ grad, int v) {
  using V16 = Vec16<T>;
  constexpr int W = V16::kWidth;
  const int row = blockIdx.x;
  const int tid = threadIdx.x;
  const long long base = static_cast<long long>(row) * v;
  const T* x = logits + base;
  T* y = grad + base;
  const float l = lse[row];
  const float gr = g[row];
  const int t = targets[row];
  // (p - onehot) * g, as the reference orders it
  auto val = [&](float xv, int col) {
    return (expf(xv - l) - (col == t ? 1.f : 0.f)) * gr;
  };

  const bool same_alignment = ((reinterpret_cast<uintptr_t>(x) ^
                                reinterpret_cast<uintptr_t>(y)) & 15) == 0;
  const RowSplit sp = same_alignment ? split_row(x, v) : RowSplit{v, 0, v};
  for (int i = tid; i < sp.head; i += kThreads) {
    y[i] = from_f<T>(val(to_f(x[i]), i));
  }
#pragma unroll 2
  for (int j = tid; j < sp.vecs; j += kThreads) {
    const int c0 = sp.head + j * W;
    float f[W];
    V16::load(x + c0, f);
#pragma unroll
    for (int k = 0; k < W; ++k) f[k] = val(f[k], c0 + k);
    V16::store(y + c0, f);
  }
  for (int i = sp.tail + tid; i < v; i += kThreads) {
    y[i] = from_f<T>(val(to_f(x[i]), i));
  }
}

}  // namespace
}  // namespace dl4jt

extern "C" {

// logits: (n, v) contiguous, dtype `dtype` (0 fp32, 1 bf16); targets: (n,)
// int32, every out-of-range target given as -1; loss, lse: (n,) fp32.
// Returns a cudaError_t.
int xent_fwd(const void* logits, const void* targets, void* loss, void* lse,
             int n, int v, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* t = static_cast<const int*>(targets);
  float* lo = static_cast<float*>(loss);
  float* ls = static_cast<float*>(lse);
  if (dtype == dl4jt::kF32) {
    dl4jt::xent_fwd_kernel<float><<<n, dl4jt::kThreads, 0, st>>>(
        static_cast<const float*>(logits), t, lo, ls, v);
  } else if (dtype == dl4jt::kBF16) {
    dl4jt::xent_fwd_kernel<__nv_bfloat16><<<n, dl4jt::kThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(logits), t, lo, ls, v);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// logits, grad: (n, v) contiguous, dtype `dtype`; targets: (n,) int32 as for
// xent_fwd; lse (from xent_fwd) and g: (n,) fp32. Returns a cudaError_t.
int xent_bwd(const void* logits, const void* targets, const void* lse,
             const void* g, void* grad, int n, int v, int dtype,
             void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* t = static_cast<const int*>(targets);
  const float* ls = static_cast<const float*>(lse);
  const float* gg = static_cast<const float*>(g);
  if (dtype == dl4jt::kF32) {
    dl4jt::xent_bwd_kernel<float><<<n, dl4jt::kThreads, 0, st>>>(
        static_cast<const float*>(logits), t, ls, gg,
        static_cast<float*>(grad), v);
  } else if (dtype == dl4jt::kBF16) {
    dl4jt::xent_bwd_kernel<__nv_bfloat16><<<n, dl4jt::kThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(logits), t, ls, gg,
        static_cast<__nv_bfloat16*>(grad), v);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* xent_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
