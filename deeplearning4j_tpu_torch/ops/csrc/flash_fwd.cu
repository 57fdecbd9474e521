// Streamed attention forward for sm_90a, on the (BH, T, D) layout.
//
// Replaces the Pallas kernel `_flash_kernel` (called from `_flash_forward`,
// deeplearning4j_tpu/ops/pallas_kernels.py): the online-softmax forward
// of `flash_attention`, o and lse (BH, 1, T) fp32, fp32 probabilities
// rounded to the input dtype only for P.V, and the row sum floored at
// 1e-30 before o and lse.
//
// What bounds it on the H100 SXM (3.35 TB/s, 989 TFLOP/s bf16): at the
// long-context shape (B=2, H=12, T=8192, D=64, causal, bf16) the
// operations, 0.2085 ms: the two causal products are 206 GFLOP over 101 MB
// of q, k, v, o and lse (0.0303 ms), far above the card's ~295 flop/byte
// ridge.
//
// Design: the TPU kernel streams 512-key blocks through VMEM (a VMEM
// choice); this is the same recurrence as the packed forward, so it runs
// that kernel (attention_fwd.cuh, with its tensor-core instance for bf16
// at head_dim 64) with one head, fp32 p and the l floor, tiled at its own
// 64 keys. Results differ from the TPU's block order only by the
// reassociation of the running sums.
#include "attention_fwd.cuh"

extern "C" {

// q, k, v, o: (bh, seq, head_dim) contiguous, dtype `dtype` (0 fp32,
// 1 bf16); lse: (bh, 1, seq) fp32. Returns a cudaError_t.
int flash_fwd(const void* q, const void* k, const void* v, void* o,
              void* lse, int bh, int seq, int head_dim, float scale,
              int causal, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == dl4jt::kF32) {
    return dl4jt::launch_attention_fwd<float>(
        q, k, v, o, lse, bh, seq, 1, head_dim, scale, causal, 0, 1, s);
  }
  if (dtype == dl4jt::kBF16) {
    return dl4jt::launch_attention_fwd<__nv_bfloat16>(
        q, k, v, o, lse, bh, seq, 1, head_dim, scale, causal, 0, 1, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* flash_fwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
