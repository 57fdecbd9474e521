// Packed-layout multi-head attention forward for sm_90a.
//
// Replaces the Pallas kernel `_mha_packed_fwd_kernel` (called from
// `_mha_packed_forward`, deeplearning4j_tpu/ops/pallas_kernels.py): per
// head, o = softmax(scale * q k^T [causal]) v and lse = m + log l, on the
// packed (B, T, H*D) projection layout, fp32 accumulation, optional bf16
// probabilities (p rounded to bf16 before the row sum and the P.V
// product).
//
// What bounds it here: at the serving shapes (B=1, T<=512, H=12, D=64,
// bf16) the work is ~2*B*H*T^2*D flops over 4*B*T*H*D*2 bytes, far below
// the card's ~295 flop/byte ridge at small T, so launch latency and the
// per-thread dependent FMA chain dominate, not HBM or tensor cores. At
// the training shape (B=96, T=512) the bound is the tensor-core rate,
// which plain FMA loops cannot reach.
//
// Design: attention_fwd.cuh (K/V streamed through shared memory with the
// online softmax, heads addressed through the packed row stride).
#include "attention_fwd.cuh"

extern "C" {

// q, k, v, o: (batch, seq, heads*head_dim) contiguous, dtype `dtype`
// (0 fp32, 1 bf16); lse: (batch, heads, seq) fp32. Returns a cudaError_t.
int mha_packed_fwd(const void* q, const void* k, const void* v, void* o,
                   void* lse, int batch, int seq, int heads, int head_dim,
                   float scale, int causal, int p_bf16, int dtype,
                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == dl4jt::kF32) {
    return dl4jt::launch_attention_fwd<float>(
        q, k, v, o, lse, batch, seq, heads, head_dim, scale, causal, p_bf16,
        0, s);
  }
  if (dtype == dl4jt::kBF16) {
    return dl4jt::launch_attention_fwd<__nv_bfloat16>(
        q, k, v, o, lse, batch, seq, heads, head_dim, scale, causal, p_bf16,
        0, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* mha_packed_fwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
