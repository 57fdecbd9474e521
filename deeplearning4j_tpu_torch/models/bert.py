"""BERT-class transformer (bidirectional MLM or causal LM): its training
step and its paged generation functions — the PyTorch counterpart of
``deeplearning4j_tpu/models/bert.py`` without a mesh.

Parameters are a plain nested dict of fp32 tensors with the JAX package's
names and layouts (kernel matrices ``(in, out)``, used as ``x @ W``).
Compute runs in ``cfg.dtype`` (bf16 at full width) with a cast of each
operand at its matmul, as the reference's ``_block`` does; layernorm and
softmax run in fp32.

Training (:func:`make_train_step`) takes gradients with ``torch.autograd``
through the attention kernels' autograd Functions and applies AdamW with
optax's semantics to the fp32 master params IN PLACE (the reference
donates them to a jitted executable and returns new ones).

Generation keeps the JAX package's paged design (vLLM's block pool): K/V
live in a shared pool of fixed-size blocks addressed through per-slot
block tables held on the host. There is no jit here: the prefill and
decode functions run eagerly and update the pool IN PLACE (the reference
donates it to a jitted executable and returns the new one); they still
return the cache so the call shapes match.
"""
from __future__ import annotations

import dataclasses
import logging
import math
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from deeplearning4j_tpu_torch import default_device
from deeplearning4j_tpu_torch.models.random import as_key, fold_in, gumbel
from deeplearning4j_tpu_torch.ops.attention_kernels import (
    flash_attention, flash_envelope_ok, mha_attention_packed,
    packed_kernel_shape_ok, paged_decode_attention)
from deeplearning4j_tpu_torch.ops.updaters import tree_leaves as _leaves

_log = logging.getLogger(__name__)
_flash_fallback_warned: set = set()


def _warn_flash_fallback(reason: str) -> None:
    """One-time notice when attention_impl='flash' routes to the einsum
    path anyway (the reference's warning, same text)."""
    if reason not in _flash_fallback_warned:
        _flash_fallback_warned.add(reason)
        _log.warning(
            "attention_impl='flash' falling back to the XLA einsum path: %s",
            reason)


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    vocab_size: int = 30522
    hidden: int = 768
    layers: int = 12
    heads: int = 12
    mlp_dim: int = 3072
    max_seq: int = 512
    dropout: float = 0.0
    causal: bool = False            # False = BERT (bidirectional MLM); True = GPT-style LM
    dtype: torch.dtype = torch.bfloat16   # compute dtype (params stay fp32)
    # 'full' | 'flash' (the packed kernel at T <= 1024, the streamed one
    # beyond) | 'ring' | 'ulysses' (without a mesh both are 'full', as in
    # the reference)
    attention_impl: str = "full"
    remat: bool = True              # checkpoint each block when training
    # softmax probability dtype of both attention paths: the einsum path's
    # softmax and the packed kernel's p_dtype
    softmax_dtype: torch.dtype = torch.float32

    @property
    def head_dim(self) -> int:
        return self.hidden // self.heads


BERT_BASE = TransformerConfig()

# layernorm parameters stay fp32 in every copy of the weights: the
# reference applies them to fp32 activations
_LN_KEYS = ("ln1", "ln2", "ln_f")


def init_params(cfg: TransformerConfig, seed: int = 0,
                device=None) -> Dict[str, Any]:
    """Parameter tree with the reference's names and shapes: dense weights
    normal(0, 0.02), layernorm scale 1 and bias 0, biases 0. Drawn on the
    host from ``torch.Generator().manual_seed(seed)``, so the weights are
    the same whichever device they land on (not the JAX package's numbers
    — tests hand both packages the same numpy arrays instead)."""
    dev = default_device(device)
    g = torch.Generator().manual_seed(int(seed))

    def dense(*shape):
        return (torch.randn(shape, generator=g, dtype=torch.float32)
                * 0.02).to(dev)

    def zeros(n):
        return torch.zeros(n, dtype=torch.float32, device=dev)

    def ln():
        return {"scale": torch.ones(cfg.hidden, dtype=torch.float32,
                                    device=dev),
                "bias": zeros(cfg.hidden)}

    params: Dict[str, Any] = {
        "tok_emb": dense(cfg.vocab_size, cfg.hidden),
        "pos_emb": dense(cfg.max_seq, cfg.hidden),
        "ln_f": ln(),
        "lm_head": dense(cfg.hidden, cfg.vocab_size),
        "blocks": [],
    }
    for _ in range(cfg.layers):
        params["blocks"].append({
            "ln1": ln(),
            "qkv": {"kernel": dense(cfg.hidden, 3 * cfg.hidden),
                    "bias": zeros(3 * cfg.hidden)},
            "attn_out": {"kernel": dense(cfg.hidden, cfg.hidden),
                         "bias": zeros(cfg.hidden)},
            "ln2": ln(),
            "mlp_in": {"kernel": dense(cfg.hidden, cfg.mlp_dim),
                       "bias": zeros(cfg.mlp_dim)},
            "mlp_out": {"kernel": dense(cfg.mlp_dim, cfg.hidden),
                        "bias": zeros(cfg.hidden)},
        })
    return params


def params_from_numpy(tree, device=None):
    """The JAX package's params (as numpy arrays, same nesting and names)
    as the port's tensor tree on ``device``."""
    dev = default_device(device)

    def conv(x):
        if isinstance(x, dict):
            return {k: conv(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return [conv(v) for v in x]
        return torch.from_numpy(np.array(x, copy=True)).to(dev)

    return conv(tree)


def compute_params(params, cfg: TransformerConfig, device=None):
    """One compute-dtype copy of the weights: every leaf outside the
    layernorms cast to ``cfg.dtype`` on ``device``. The forward casts each
    operand to the activation dtype at its matmul; with this copy those
    casts are no-ops, so each decode step stops re-reading the fp32
    master weights. Results are bitwise those of the master weights."""
    dev = default_device(device)

    def conv(x, keep_fp32):
        if isinstance(x, dict):
            return {k: conv(v, keep_fp32 or k in _LN_KEYS)
                    for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return [conv(v, keep_fp32) for v in x]
        return x.to(device=dev, dtype=torch.float32 if keep_fp32
                    else cfg.dtype)

    return conv(params, False)


def _layernorm(x, p, eps=1e-12):
    x32 = x.float()
    mu = x32.mean(-1, keepdim=True)
    var = x32.var(-1, unbiased=False, keepdim=True)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    return (y * p["scale"] + p["bias"]).to(x.dtype)


def _dense(x, p):
    return x @ p["kernel"].to(x.dtype) + p["bias"].to(x.dtype)


def _full_attention(q, k, v, causal: bool,
                    softmax_dtype: torch.dtype = torch.float32):
    # q, k, v: (B, H, T, D)
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.einsum("bhqd,bhkd->bhqk", q, k) * scale
    if causal:
        T = q.shape[2]
        mask = torch.ones(T, T, dtype=torch.bool, device=q.device).tril()
        s = s.masked_fill(~mask, torch.finfo(s.dtype).min)
    p = torch.softmax(s.to(softmax_dtype), dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bhkd->bhqd", p, v)


def _use_packed_kernel(cfg: TransformerConfig, T: int) -> bool:
    """True when attention routes to the packed-layout kernel: the
    (B, T, H*D) projections feed it directly, so no head transpose is
    made. Same envelope as the reference (no mesh in the port)."""
    return cfg.attention_impl == "flash" and packed_kernel_shape_ok(T)


def _attention(q, k, v, cfg: TransformerConfig):
    """(B, H, T, D) attention as the reference's ``_attention`` routes it
    with no mesh: ``"flash"`` takes the streamed kernels where
    :func:`flash_envelope_ok` holds and the einsum path (with a one-time
    warning) where it does not; every other impl is the einsum path."""
    if cfg.attention_impl == "flash":
        T = q.shape[2]
        if flash_envelope_ok(T):
            return flash_attention(q, k, v, cfg.causal)
        _warn_flash_fallback(
            f"streamed kernel unavailable for T={T} under mesh None")
    return _full_attention(q, k, v, cfg.causal, cfg.softmax_dtype)


def _block(params, x, cfg: TransformerConfig, return_kv: bool = False):
    B, T, H = x.shape
    h = _layernorm(x, params["ln1"])
    qkv = _dense(h, params["qkv"])
    q, k, v = qkv.split(H, dim=-1)
    if return_kv:
        # (B, T, heads, head_dim) — the KV-cache layout, a free view of
        # the head-contiguous packed projection
        kv_out = (k.reshape(B, T, cfg.heads, cfg.head_dim),
                  v.reshape(B, T, cfg.heads, cfg.head_dim))
    if _use_packed_kernel(cfg, T):
        o = mha_attention_packed(q.contiguous(), k.contiguous(),
                                 v.contiguous(), cfg.heads, cfg.causal, None,
                                 cfg.softmax_dtype)
    else:
        def heads(t):  # (B, T, H) -> (B, heads, T, D)
            return t.reshape(B, T, cfg.heads, cfg.head_dim).transpose(1, 2)
        o = _attention(heads(q), heads(k), heads(v), cfg)
        o = o.transpose(1, 2).reshape(B, T, H)
    x = x + _dense(o, params["attn_out"])
    h = _layernorm(x, params["ln2"])
    h = F.gelu(_dense(h, params["mlp_in"]), approximate="tanh")
    x = x + _dense(h, params["mlp_out"])
    if return_kv:
        return x, kv_out[0], kv_out[1]
    return x


def _embed(params, token_ids, positions, cfg: TransformerConfig):
    return params["tok_emb"][token_ids].to(cfg.dtype) \
        + params["pos_emb"][positions].to(cfg.dtype)


def encode(params, token_ids, cfg: TransformerConfig):
    """Embeddings + transformer stack + final layernorm (no lm_head). With
    ``cfg.remat`` and autograd recording, each block runs under
    ``torch.utils.checkpoint``: its activations are recomputed in the
    backward (the reference's ``jax.checkpoint``; its policy changes
    memory, not results), so each block's attention forward launches
    twice per training step."""
    _, T = token_ids.shape
    x = _embed(params, token_ids,
               torch.arange(T, device=token_ids.device)[None], cfg)
    remat = cfg.remat and torch.is_grad_enabled()
    for bp in params["blocks"]:
        if remat:
            x = torch.utils.checkpoint.checkpoint(_block, bp, x, cfg,
                                                  use_reentrant=False)
        else:
            x = _block(bp, x, cfg)
    return _layernorm(x, params["ln_f"])


def _forward_raw(params, token_ids, cfg: TransformerConfig):
    """Logits in the COMPUTE dtype: the loss upcasts them, as the
    reference's loss path does."""
    x = encode(params, token_ids, cfg)
    return x @ params["lm_head"].to(x.dtype)


@torch.no_grad()
def forward(params, token_ids, cfg: TransformerConfig):
    """token_ids (B, T) integer -> logits (B, T, vocab) fp32."""
    return _forward_raw(params, token_ids.long(), cfg).float()


def loss_from_logits(logits, batch):
    """Weighted LM cross-entropy from compute-dtype logits, as
    logsumexp(logits) - logits[target] with fp32 accumulation."""
    lse = torch.logsumexp(logits.float(), dim=-1)
    tgt = logits.gather(-1, batch["targets"].long()[..., None])[..., 0]
    w = batch["weights"]
    return ((lse - tgt.float()) * w).sum() / w.sum().clamp_min(1.0)


def lm_loss(params, batch, cfg: TransformerConfig):
    """Masked/causal LM cross-entropy. batch = {'tokens': (B, T) int,
    'targets': (B, T) int, 'weights': (B, T) float} — weights zero out
    unmasked positions (MLM) or padding."""
    return loss_from_logits(
        _forward_raw(params, batch["tokens"].long(), cfg), batch)


def make_infer_last_logits(cfg: TransformerConfig):
    """Token ids (B, T) -> last-position logits (B, vocab) fp32, without
    autograd (the reference returns a jitted function; the port runs
    eagerly)."""

    @torch.no_grad()
    def last_logits(params, tokens):
        return forward(params, tokens, cfg)[:, -1, :]

    return last_logits


def grad_aliases(params):
    """``(tree, leaves)``: a copy of ``params`` whose tensors are detached
    aliases that require grad, and those aliases in :func:`_leaves`
    order. Differentiate a loss of ``tree`` w.r.t. ``leaves``; the
    caller's tensors never require grad, and the storage is shared."""
    leaves = [p.detach().requires_grad_() for p in _leaves(params)]
    it = iter(leaves)

    def rebuild(tree):
        if isinstance(tree, dict):
            return {k: rebuild(tree[k]) for k in sorted(tree)}
        if isinstance(tree, (list, tuple)):
            return [rebuild(x) for x in tree]
        return next(it)

    return rebuild(params), leaves


def _batch_on(batch, device):
    return {k: (v if isinstance(v, torch.Tensor)
                else torch.as_tensor(np.asarray(v))).to(device)
            for k, v in batch.items()}


def make_train_step(cfg: TransformerConfig, learning_rate: float = 1e-4,
                    weight_decay: float = 0.01):
    """Build ``(init_state, step)``; ``step(params, opt_state, batch) ->
    (params, opt_state, loss)``, the reference's single-device step.

    Gradients of :func:`lm_loss` come from ``torch.autograd`` (compute in
    ``cfg.dtype`` over the fp32 master params). AdamW follows
    ``optax.adamw(learning_rate, weight_decay=weight_decay)``: b1 0.9,
    b2 0.999, eps 1e-8 outside the sqrt, eps_root 0; the moments update
    as ``(1 - b) * g + b * m``, the count is incremented first and the
    bias corrections ``1 - b ** count`` divide the moments; the decoupled
    decay ``wd * p`` is added to the update of EVERY leaf (optax's mask
    is None), then the update is scaled by ``-lr``. Params and state are
    updated IN PLACE and returned (the reference donates them)."""
    b1, b2, eps = 0.9, 0.999, 1e-8

    def init_state(params):
        leaves = _leaves(params)
        return {"count": 0,
                "mu": [torch.zeros_like(p) for p in leaves],
                "nu": [torch.zeros_like(p) for p in leaves]}

    def step(params, opt_state, batch):
        leaves = _leaves(params)
        tree, xs = grad_aliases(params)
        loss = lm_loss(tree, _batch_on(batch, leaves[0].device), cfg)
        grads = torch.autograd.grad(loss, xs)
        count = opt_state["count"] + 1
        bc1 = 1 - b1 ** count
        bc2 = 1 - b2 ** count
        # the range names the eager AdamW tail in a torch.profiler trace
        with torch.no_grad(), \
                torch.profiler.record_function("make_train_step.adamw"):
            for p, g, mu, nu in zip(leaves, grads, opt_state["mu"],
                                    opt_state["nu"]):
                mu.mul_(b1).add_(g * (1 - b1))
                nu.mul_(b2).add_(g * g * (1 - b2))
                u = (mu / bc1) / (torch.sqrt(nu / bc2) + eps)
                u = u + weight_decay * p
                p.add_(-learning_rate * u)
        opt_state["count"] = count
        return params, opt_state, loss.detach()

    return init_state, step


# --------------------------------------------------------------------------
# Paged generation: block-pool KV cache, block-table prefill and decode
# --------------------------------------------------------------------------


def validate_block_size(block_size, max_len: int) -> int:
    """A paged-cache block size as a plain int: a positive power of two
    no larger than ``max_len``."""
    if not isinstance(block_size, (int, np.integer)) or block_size <= 0 \
            or (int(block_size) & (int(block_size) - 1)) != 0:
        raise ValueError(
            f"block_size must be a positive power of two (the in-kernel "
            f"block index math is a shift/mask), got {block_size!r}")
    if block_size > max_len:
        raise ValueError(
            f"block_size {block_size} exceeds max_len {max_len}: a block "
            "larger than a slot's whole capacity can never be filled and "
            "defeats paging")
    return int(block_size)


KV_DTYPES = ("float32", "int8")


def validate_kv_dtype(kv_dtype: str, block_size) -> str:
    """The KV storage mode: ``"float32"`` keeps full precision in the
    cache dtype, ``"int8"`` stores quantized values with per-token,
    per-head fp32 scales (paged layout only)."""
    if kv_dtype not in KV_DTYPES:
        raise ValueError(
            f"kv_dtype must be one of {KV_DTYPES}, got {kv_dtype!r}")
    if kv_dtype == "int8" and block_size is None:
        raise ValueError(
            "kv_dtype='int8' requires the paged KV cache (pass "
            "block_size): the per-block scale tensors and on-read "
            "dequant are block-pool concepts")
    return kv_dtype


def quantize_kv(x):
    """Symmetric per-token-per-head int8 quantization over the trailing
    head_dim axis: ``(int8 values, fp32 scales)`` with ``x ~= values *
    scales[..., None]``; rounds half to even like ``jnp.round``."""
    xf = x.float()
    amax = xf.abs().amax(-1)
    scale = amax.clamp_min(1e-8) / 127.0
    q = torch.clamp(torch.round(xf / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale


def init_kv_cache(cfg: TransformerConfig, slots: int, max_len: int,
                  dtype: Optional[torch.dtype] = None,
                  block_size: int = 16, num_blocks: Optional[int] = None,
                  kv_dtype: str = "float32", device=None) -> Dict[str, Any]:
    """Allocate the paged block pool ``{"layers": [{"k", "v"}: (num_blocks,
    block_size, heads, head_dim)]}`` in ``dtype`` (default the compute
    dtype), plus ``{"k_scale", "v_scale"}: (num_blocks, block_size,
    heads)`` fp32 for ``kv_dtype="int8"`` (values int8). Block 0 is the
    reserved scratch block: dead-slot writes land there and it is never
    given to a stream. ``num_blocks`` defaults to ``slots *
    ceil(max_len / block_size) + 1``. Only the paged layout is ported."""
    if max_len > cfg.max_seq:
        raise ValueError(
            f"max_len {max_len} exceeds the model's positional table "
            f"max_seq={cfg.max_seq}")
    if slots <= 0:
        raise ValueError(f"slots must be positive, got {slots}")
    if max_len <= 0:
        raise ValueError(f"max_len must be positive, got {max_len}")
    validate_kv_dtype(kv_dtype, block_size)
    dev = default_device(device)
    dt = cfg.dtype if dtype is None else dtype
    block_size = validate_block_size(block_size, max_len)
    if num_blocks is None:
        num_blocks = slots * -(-max_len // block_size) + 1
    if num_blocks < 2:
        raise ValueError(
            f"num_blocks must be >= 2 (block 0 is the reserved scratch "
            f"block), got {num_blocks}")
    shape = (num_blocks, block_size, cfg.heads, cfg.head_dim)
    if kv_dtype == "int8":
        sshape = shape[:3]
        return {"layers": [
            {"k": torch.zeros(shape, dtype=torch.int8, device=dev),
             "v": torch.zeros(shape, dtype=torch.int8, device=dev),
             "k_scale": torch.zeros(sshape, dtype=torch.float32, device=dev),
             "v_scale": torch.zeros(sshape, dtype=torch.float32, device=dev)}
            for _ in range(cfg.layers)]}
    return {"layers": [
        {"k": torch.zeros(shape, dtype=dt, device=dev),
         "v": torch.zeros(shape, dtype=dt, device=dev)}
        for _ in range(cfg.layers)]}


def grow_block_table(tables: np.ndarray, slot: int, n_entries: int,
                     block: int) -> int:
    """Append one physical block to a slot's row of the host-side block
    table (fixed width, zero-padded to the scratch block); returns the new
    entry count and raises when the row is full."""
    if not 0 <= n_entries < tables.shape[1]:
        raise ValueError(
            f"slot {slot} block-table row is full ({n_entries} of "
            f"{tables.shape[1]} entries) — cannot map block {block}")
    tables[slot, n_entries] = block
    return n_entries + 1


def sample_tokens(logits, keys, steps, temperatures, top_ks):
    """Sample one token per row of ``logits`` (S, V): greedy where
    ``temperature <= 0``, else gumbel-max over ``filtered / temperature``,
    with top-k filtering where ``top_k > 0`` — ``_sample_at`` of the
    reference row by row. Row i's noise is ``gumbel(fold_in(keys[i],
    steps[i]))``, so a stream's draws depend only on (key, step), never on
    its neighbours. ``keys`` (S, 2) uint32 words, ``steps``,
    ``temperatures`` and ``top_ks`` (S,) host arrays. Returns (S,) int64
    on the logits' device. Greedy rows draw no noise: it cannot change
    their argmax."""
    logits = logits.float()
    S, V = logits.shape
    dev = logits.device
    temps = np.asarray(temperatures, np.float32).reshape(S)
    top_ks = np.asarray(top_ks, np.int64).reshape(S)
    filtered = logits
    if (top_ks > 0).any():
        desc = torch.sort(logits, dim=-1, descending=True).values
        kth_idx = torch.as_tensor(np.clip(top_ks - 1, 0, V - 1), device=dev)
        kth = desc.gather(1, kth_idx[:, None])
        on = torch.as_tensor(top_ks > 0, device=dev)[:, None]
        thresh = torch.where(on, kth, torch.full_like(kth, -math.inf))
        filtered = torch.where(logits >= thresh, logits,
                               torch.full_like(logits, -math.inf))
    z = filtered
    rows = np.flatnonzero(temps > 0)
    if rows.size:
        keys = np.asarray(keys, np.uint32).reshape(S, 2)
        steps = np.asarray(steps, np.int64).reshape(S)
        noise = gumbel(fold_in(as_key(keys[rows], dev),
                               torch.as_tensor(steps[rows], device=dev)), V)
        idx = torch.as_tensor(rows, device=dev)
        t = torch.as_tensor(temps[rows], device=dev)[:, None]
        z = filtered.clone()
        z[idx] = filtered[idx] / t + noise
    return torch.argmax(z, dim=-1)


def sample_token(logits, key, temperature, top_k, step: int = 0):
    """One stream's token from (V,) logits at sample index ``step``."""
    return sample_tokens(logits[None], np.asarray(key)[None], [step],
                         [temperature], [top_k])[0]


def _require_causal(cfg: TransformerConfig):
    if not cfg.causal:
        raise ValueError("generation needs a causal LM: set "
                         "TransformerConfig(causal=True)")


def make_paged_prefill(cfg: TransformerConfig, block_size: int,
                       kv_dtype: str = "float32"):
    """The paged prefill: one padded prompt through the standard forward
    (the same ``_block``), its per-layer K/V written into the physical
    blocks named by ``block_row``, and token 0 sampled.

    ``prefill(params, cache, tokens, block_row, length, key, temperature,
    top_k, step) -> (cache, token0)`` with tokens (1, T_bucket) integer,
    ``block_row`` (ceil(T_bucket/block_size),) physical block ids whose
    entries past the prompt's blocks name scratch block 0, ``length`` the
    real prompt length and ``step`` the sample index the draw folds into
    the key. The pool is updated in place; int8 pools quantize on write."""
    _require_causal(cfg)
    validate_kv_dtype(kv_dtype, block_size)

    @torch.no_grad()
    def prefill(params, cache, tokens, block_row, length, key, temperature,
                top_k, step):
        dev = params["tok_emb"].device
        tokens = torch.as_tensor(np.asarray(tokens), device=dev).long()
        block_row = torch.as_tensor(np.asarray(block_row),
                                    device=dev).long()
        _, T = tokens.shape
        nb = block_row.shape[0]
        pad = nb * block_size - T
        x = _embed(params, tokens, torch.arange(T, device=dev)[None], cfg)
        for bp, lc in zip(params["blocks"], cache["layers"]):
            x, k, v = _block(bp, x, cfg, return_kv=True)
            kb = F.pad(k[0], (0, 0, 0, 0, 0, pad)).reshape(
                nb, block_size, cfg.heads, cfg.head_dim)
            vb = F.pad(v[0], (0, 0, 0, 0, 0, pad)).reshape(
                nb, block_size, cfg.heads, cfg.head_dim)
            if kv_dtype == "int8":
                kq, ks = quantize_kv(kb)
                vq, vs = quantize_kv(vb)
                lc["k"][block_row] = kq
                lc["v"][block_row] = vq
                lc["k_scale"][block_row] = ks
                lc["v_scale"][block_row] = vs
            else:
                lc["k"][block_row] = kb.to(lc["k"].dtype)
                lc["v"][block_row] = vb.to(lc["v"].dtype)
        x = _layernorm(x, params["ln_f"])
        last = x[0, int(length) - 1]
        logits = (last @ params["lm_head"].to(last.dtype)).float()
        token0 = sample_token(logits, key, temperature, top_k, step)
        return cache, token0

    return prefill


def make_paged_decode_logits(cfg: TransformerConfig, block_size: int,
                             kv_dtype: str = "float32",
                             paged_attention: str = "gather"):
    """The paged decode step up to the logits: one token for every slot.

    ``decode_logits(params, cache, tables, lengths, tokens, cow_src,
    cow_dst) -> logits`` (slots, vocab) fp32. ``tables`` (slots,
    max_blocks) block ids (a dead slot's row is all scratch block 0),
    ``lengths`` (slots,) host-tracked token counts (the write position),
    ``cow_src``/``cow_dst`` (slots,) the copy-on-write pairs applied before
    this step's write and read (src == dst is a no-op). Per layer: the
    new K/V is written into the pool in place, then attention reads it
    through ``paged_attention``:

    - ``"gather"``: materialize ``pool[tables]`` as (slots, L, heads, D)
      and run the einsum attention (the reference's default route);
    - ``"fused"``: the :func:`paged_decode_attention` kernel walks each
      slot's blocks without materializing the gathered view, with int8
      dequantization in the same pass."""
    _require_causal(cfg)
    validate_kv_dtype(kv_dtype, block_size)
    if paged_attention not in ("gather", "fused"):
        raise ValueError(
            f"paged_attention must be 'gather' or 'fused', "
            f"got {paged_attention!r}")
    quantized = kv_dtype == "int8"
    scale = 1.0 / math.sqrt(cfg.head_dim)

    def attend(q, lc, tables, pos):
        S = q.shape[0]
        L = tables.shape[1] * block_size
        if paged_attention == "fused":
            return paged_decode_attention(
                q, lc["k"], lc["v"], tables, pos, block_size=block_size,
                scale=scale, k_scale=lc["k_scale"] if quantized else None,
                v_scale=lc["v_scale"] if quantized else None)
        tl = tables.long()
        gk = lc["k"][tl].reshape(S, L, cfg.heads, cfg.head_dim)
        gv = lc["v"][tl].reshape(S, L, cfg.heads, cfg.head_dim)
        if quantized:
            gk = (gk.float() * lc["k_scale"][tl].reshape(
                S, L, cfg.heads)[..., None]).to(q.dtype)
            gv = (gv.float() * lc["v_scale"][tl].reshape(
                S, L, cfg.heads)[..., None]).to(q.dtype)
        s = torch.einsum("shd,slhd->shl", q, gk.to(q.dtype)) * scale
        mask = torch.arange(L, device=q.device)[None, :] <= pos[:, None]
        s = s.masked_fill(~mask[:, None, :], torch.finfo(s.dtype).min)
        p = torch.softmax(s.to(cfg.softmax_dtype), dim=-1).to(q.dtype)
        return torch.einsum("shl,slhd->shd", p, gv.to(p.dtype))

    @torch.no_grad()
    def decode_logits(params, cache, tables, lengths, tokens, cow_src,
                      cow_dst):
        dev = params["tok_emb"].device
        tables_np = np.asarray(tables, np.int32)
        S = tables_np.shape[0]
        L = tables_np.shape[1] * block_size
        pos_np = np.clip(np.asarray(lengths, np.int64), 0,
                         min(L, cfg.max_seq) - 1)
        blk = tables_np[np.arange(S), pos_np // block_size]
        cow_src = np.asarray(cow_src, np.int64)
        cow_dst = np.asarray(cow_dst, np.int64)
        cow = np.flatnonzero(cow_src != cow_dst)
        tables_t = torch.as_tensor(tables_np, device=dev)
        pos_t = torch.as_tensor(pos_np.astype(np.int32), device=dev)
        pb = torch.as_tensor(blk.astype(np.int64), device=dev)
        off = torch.as_tensor(pos_np % block_size, device=dev)
        x = _embed(params, torch.as_tensor(np.asarray(tokens, np.int64),
                                           device=dev), pos_t.long(), cfg)
        H = cfg.hidden
        for bp, lc in zip(params["blocks"], cache["layers"]):
            if cow.size:
                src = torch.as_tensor(cow_src[cow], device=dev)
                dst = torch.as_tensor(cow_dst[cow], device=dev)
                for name in lc:
                    lc[name][dst] = lc[name][src]
            h = _layernorm(x, bp["ln1"])
            q, k, v = _dense(h, bp["qkv"]).split(H, dim=-1)
            q = q.reshape(S, cfg.heads, cfg.head_dim).contiguous()
            k = k.reshape(S, cfg.heads, cfg.head_dim)
            v = v.reshape(S, cfg.heads, cfg.head_dim)
            if quantized:
                kq, ks = quantize_kv(k)
                vq, vs = quantize_kv(v)
                lc["k"][pb, off] = kq
                lc["v"][pb, off] = vq
                lc["k_scale"][pb, off] = ks
                lc["v_scale"][pb, off] = vs
            else:
                lc["k"][pb, off] = k.to(lc["k"].dtype)
                lc["v"][pb, off] = v.to(lc["v"].dtype)
            o = attend(q, lc, tables_t, pos_t).reshape(S, H).to(x.dtype)
            x = x + _dense(o, bp["attn_out"])
            h = _layernorm(x, bp["ln2"])
            h = F.gelu(_dense(h, bp["mlp_in"]), approximate="tanh")
            x = x + _dense(h, bp["mlp_out"])
        x = _layernorm(x, params["ln_f"])
        return (x @ params["lm_head"].to(x.dtype)).float()

    return decode_logits


def make_paged_decode_step(cfg: TransformerConfig, block_size: int,
                           kv_dtype: str = "float32",
                           paged_attention: str = "gather"):
    """THE paged decode step: :func:`make_paged_decode_logits` followed by
    per-slot sampling, as the reference's ``decode_step`` is built.

    ``decode_step(params, cache, tables, lengths, tokens, keys, steps,
    temperatures, top_ks, cow_src, cow_dst) -> (cache, next_tokens)``
    with the pool updated in place and next_tokens (slots,) int64 on the
    params' device."""
    decode_logits = make_paged_decode_logits(cfg, block_size, kv_dtype,
                                             paged_attention)

    def decode_step(params, cache, tables, lengths, tokens, keys, steps,
                    temperatures, top_ks, cow_src, cow_dst):
        logits = decode_logits(params, cache, tables, lengths, tokens,
                               cow_src, cow_dst)
        return cache, sample_tokens(logits, keys, steps, temperatures,
                                    top_ks)

    return decode_step
