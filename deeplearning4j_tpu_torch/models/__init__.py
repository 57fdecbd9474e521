"""The flagship transformer (BERT-class encoder / causal LM) in PyTorch —
counterpart of ``deeplearning4j_tpu/models``: the forward pass, the loss
and training step (on one device or a mesh of ranks), and the paged
generation functions the serving engine drives: the paged and contiguous
caches, the speculative draft and verify steps."""
from deeplearning4j_tpu_torch.models.bert import (  # noqa: F401
    BERT_BASE,
    KV_DTYPES,
    TransformerConfig,
    batch_pspec,
    compute_params,
    forward,
    gather_params,
    grow_block_table,
    init_draft_kv_cache,
    init_kv_cache,
    init_params,
    lm_loss,
    local_batch,
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
    param_pspecs,
    params_from_numpy,
    place_params,
    quantize_kv,
    sample_token,
    sample_tokens,
    validate_block_size,
    validate_kv_dtype,
)
