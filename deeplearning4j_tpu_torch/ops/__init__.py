"""Hand-written CUDA kernels of the port and their plain PyTorch versions
(counterpart: ``deeplearning4j_tpu/ops/pallas_kernels.py``)."""
from deeplearning4j_tpu_torch.ops.attention_kernels import (  # noqa: F401
    mha_attention_packed, mha_packed_forward, mha_packed_forward_reference,
    packed_kernel_shape_ok, paged_decode_attention,
    paged_decode_attention_reference,
)
