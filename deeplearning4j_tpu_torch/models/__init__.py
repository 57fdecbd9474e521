"""The flagship transformer (BERT-class encoder / causal LM) in PyTorch —
counterpart of ``deeplearning4j_tpu/models``: the forward pass, the loss
and training step, and the paged generation functions the serving engine
drives: the paged and contiguous caches, the speculative draft and
verify steps."""
from deeplearning4j_tpu_torch.models.bert import (  # noqa: F401
    BERT_BASE,
    KV_DTYPES,
    TransformerConfig,
    compute_params,
    forward,
    grow_block_table,
    init_draft_kv_cache,
    init_kv_cache,
    init_params,
    lm_loss,
    loss_from_logits,
    make_decode_step,
    make_draft_prefill,
    make_draft_step,
    make_infer_last_logits,
    make_paged_decode_logits,
    make_paged_decode_step,
    make_paged_prefill,
    make_prefill,
    make_train_step,
    make_verify_step,
    params_from_numpy,
    quantize_kv,
    sample_token,
    sample_tokens,
    validate_block_size,
    validate_kv_dtype,
)
