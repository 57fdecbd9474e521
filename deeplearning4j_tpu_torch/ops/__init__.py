"""Hand-written CUDA kernels of the port and their plain PyTorch versions
(counterparts: ``deeplearning4j_tpu/ops/pallas_kernels.py`` and
``deeplearning4j_tpu/ops/pallas_updaters.py``)."""
from deeplearning4j_tpu_torch.ops.attention_kernels import (  # noqa: F401
    auto_flash_block, flash_attention, flash_bwd_dkv,
    flash_bwd_dkv_reference, flash_bwd_dq, flash_bwd_dq_reference,
    flash_envelope_ok, flash_forward, flash_forward_reference,
    higher_order_attention, kernel_head_dim_ok, mha_attention,
    mha_attention_packed, mha_packed_backward, mha_packed_backward_reference,
    mha_packed_forward, mha_packed_forward_reference, packed_kernel_shape_ok,
    paged_decode_attention, paged_decode_attention_reference,
    paged_decode_plan,
)
from deeplearning4j_tpu_torch.ops.updaters import (  # noqa: F401
    FusedAdamW, adamw_reference, fused_adamw, tree_leaves,
)
from deeplearning4j_tpu_torch.ops.xent_kernels import (  # noqa: F401
    softmax_cross_entropy, softmax_cross_entropy_backward,
    softmax_cross_entropy_forward, xent_backward_reference,
    xent_forward_reference,
)
