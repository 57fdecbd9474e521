// Element-type helpers shared by the attention kernels: every kernel
// computes in fp32 and converts at load and store.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace dl4jt {

// dtype codes of the C interfaces (the Python wrappers pass these)
enum DtypeCode : int { kF32 = 0, kBF16 = 1, kI8 = 2 };

// the -1e30 mask value of the reference kernels (not -inf: a masked
// score minus a real running max stays finite and exps to exactly 0)
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f(int8_t x) {
  return static_cast<float>(x);
}

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);   // round to nearest even, like XLA
}

// x rounded to T's precision, back in fp32 (identity for float)
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_f(from_f<T>(x));
}

}  // namespace dl4jt
