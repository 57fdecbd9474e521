// Packed-layout multi-head attention forward for sm_90a.
//
// Replaces the Pallas kernel `_mha_packed_fwd_kernel` (called from
// `_mha_packed_forward`, deeplearning4j_tpu/ops/pallas_kernels.py): per
// head, o = softmax(scale * q k^T [causal]) v and lse = m + log l, on the
// packed (B, T, H*D) projection layout, fp32 accumulation, optional bf16
// probabilities (p rounded to bf16 before the row sum and the P.V
// product).
//
// What bounds it on the H100 SXM (3.35 TB/s, 989 TFLOP/s bf16): at the
// MLM step's shape (B=96, T=512, H=12, D=64, bf16) the bytes, 0.0909 ms:
// q, k, v and o of 75.5 MB each and 2.4 MB of lse, against 0.0782 ms for
// its 77.3 GFLOP (the products outweigh the bytes only above T = 595).
// At the serving shapes (B=1, T <= 512) the work is a few microseconds of
// either, and launch latency dominates.
//
// Design: attention_fwd.cuh dispatches bf16 at head_dim 64 to the
// tensor-core kernel of attention_fwd_tc.cuh (one warpgroup per 64-row
// query tile, `wgmma` for S = qs k^T and O += P V, K/V through a 2-stage
// cp.async ring, the online softmax in registers) and everything else to
// its FMA template; heads are read through the packed row stride.
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
