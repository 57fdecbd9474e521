// Element-type helpers shared by the attention kernels: every kernel
// computes in fp32 and converts at load and store. Also the opt-in to
// dynamic shared memory above the 48 KB default (`reserve_smem`).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

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

// Shared memory a block may take without opting in, and at most (the
// H100's 227 KB per block)
constexpr int kDefaultSmemBytes = 48 * 1024;
constexpr int kMaxSmemBytes = 232448;

// Let `Kernel` launch with `bytes` of dynamic shared memory: above the
// 48 KB default the runtime needs cudaFuncSetAttribute first, once per
// kernel instance and device (a bit per device; a repeated call is
// harmless). Returns the runtime's error. The unnamed namespace keeps the
// flag inside each library: the forward's libraries (mha_packed_fwd,
// flash_fwd) each hold their own copy of the same kernel, and a flag
// shared through one process-wide symbol would let the second library
// launch without its opt-in.
namespace {
template <auto Kernel>
cudaError_t reserve_smem(int bytes) {
  static std::atomic<unsigned> done{0};
  if (bytes <= kDefaultSmemBytes) return cudaSuccess;
  if (bytes > kMaxSmemBytes) return cudaErrorInvalidValue;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned bit = dev < 32 ? 1u << dev : 0u;
  if (bit != 0u && (done.load() & bit) != 0u) return cudaSuccess;
  err = cudaFuncSetAttribute(Kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes);
  if (err == cudaSuccess) done.fetch_or(bit);
  return err;
}
}  // namespace

}  // namespace dl4jt
