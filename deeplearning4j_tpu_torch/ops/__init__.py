"""Op surface of the port: the registry and its eager namespaces
(counterpart: ``deeplearning4j_tpu/ops/__init__.py``), and the
hand-written CUDA kernels with their plain PyTorch versions
(counterparts: ``deeplearning4j_tpu/ops/pallas_kernels.py`` and
``deeplearning4j_tpu/ops/pallas_updaters.py``).

Importing it builds no kernel: a kernel library is built on its first
launch."""
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
from deeplearning4j_tpu_torch.ops.pallas_updaters import (  # noqa: F401
    FusedAdamW, adamw_reference, fused_adamw, tree_leaves,
)
from deeplearning4j_tpu_torch.ops.xent_kernels import (  # noqa: F401
    softmax_cross_entropy, softmax_cross_entropy_backward,
    softmax_cross_entropy_forward, xent_backward_reference,
    xent_forward_reference,
)
from deeplearning4j_tpu_torch.ops.registry import (  # noqa: F401
    REGISTRY,
    EagerNamespace,
    OpSpec,
    coverage_report,
    get,
    mark_validated,
    op,
)

# importing definitions populates the registry, in the reference's order
from deeplearning4j_tpu_torch.ops import math_defs as _math_defs  # noqa: F401,E402
from deeplearning4j_tpu_torch.ops import nn_defs as _nn_defs  # noqa: F401,E402
from deeplearning4j_tpu_torch.ops import extra_defs as _extra_defs  # noqa: F401,E402
from deeplearning4j_tpu_torch.ops import more_defs as _more_defs  # noqa: F401,E402
from deeplearning4j_tpu_torch.ops import wide_defs as _wide_defs  # noqa: F401,E402

math = EagerNamespace("math")
reduce = EagerNamespace("reduce")
shape = EagerNamespace("shape")
bitwise = EagerNamespace("bitwise")
linalg = EagerNamespace("linalg")
nn = EagerNamespace("nn")
cnn = EagerNamespace("cnn")
rnn = EagerNamespace("rnn")
loss = EagerNamespace("loss")
image = EagerNamespace("image")
random = EagerNamespace("random")
updaters = EagerNamespace("updaters")
