"""The flagship transformer (BERT-class encoder / causal LM) in PyTorch —
counterpart of ``deeplearning4j_tpu/models``: the forward pass and the
paged generation functions the serving engine drives."""
from deeplearning4j_tpu_torch.models.bert import (  # noqa: F401
    BERT_BASE,
    KV_DTYPES,
    TransformerConfig,
    compute_params,
    forward,
    grow_block_table,
    init_kv_cache,
    init_params,
    make_paged_decode_logits,
    make_paged_decode_step,
    make_paged_prefill,
    params_from_numpy,
    quantize_kv,
    sample_token,
    sample_tokens,
    validate_block_size,
    validate_kv_dtype,
)
