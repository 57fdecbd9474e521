"""BERT-class transformer (bidirectional MLM or causal LM): its training
step, over one device or a ``(data, model, context)`` mesh of ranks, and
its paged generation functions — the PyTorch counterpart of
``deeplearning4j_tpu/models/bert.py``.

Parameters are a plain nested dict of fp32 tensors with the JAX package's
names and layouts (kernel matrices ``(in, out)``, used as ``x @ W``).
Compute runs in ``cfg.dtype`` (bf16 at full width) with a cast of each
operand at its matmul, as the reference's ``_block`` does; layernorm and
softmax run in fp32.

Training (:func:`make_train_step`) takes gradients with ``torch.autograd``
through the attention kernels' autograd Functions and applies AdamW with
optax's semantics to the fp32 master params IN PLACE (the reference
donates them to a jitted executable and returns new ones).

Under a mesh (:mod:`deeplearning4j_tpu_torch.parallel.mesh`) the model
runs per rank as explicit Megatron over local shards (the JAX package's
shard_map bodies, with the collectives GSPMD inserts written out): every
rank holds its :func:`place_params` shards and its (data, context) block
of the batch (:func:`local_batch`). ``model`` splits the heads, the MLP
hidden width and the vocabulary; ``context`` the sequence (ring or
Ulysses attention); ``data`` the batch. Gradients sum over data and
context.

Generation keeps the JAX package's two cache layouts: the paged design
(vLLM's block pool), whose K/V live in a shared pool of fixed-size blocks
addressed through per-slot block tables held on the host, and the
contiguous per-slot layout with its lengths on the device. Speculative
decoding adds the draft model's contiguous cache (lengths on the host)
and the paged verify step. There is no jit here: the prefill, decode,
draft and verify functions run eagerly and update the cache IN PLACE (the
reference donates it to a jitted executable and returns the new one);
they still return the cache so the call shapes match.
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
from deeplearning4j_tpu_torch.ops.pallas_updaters import tree_leaves as _leaves
from deeplearning4j_tpu_torch.parallel.mesh import (
    CONTEXT_AXIS, DATA_AXIS, MODEL_AXIS, Mesh, NamedSharding, P, copy_to,
    gather_last, reduce_sum, tree_shardings)
from deeplearning4j_tpu_torch.parallel.sequence_parallel import (
    gather_sequence, ring_attention, ring_flash_attention, ulysses_attention)

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


def param_pspecs(cfg: TransformerConfig) -> Dict[str, Any]:
    """Megatron-style tensor-parallel PartitionSpecs over the 'model' axis,
    the JAX package's. Column-parallel (output features split): qkv,
    mlp_in, lm_head. Row-parallel (input features split): attn_out,
    mlp_out, whose output is summed over the axis. The token embedding
    splits the vocabulary; layernorms and the positions are whole. The
    fused qkv's column split is per third: :func:`place_params` gives each
    rank its heads of q, of k and of v."""
    ln = {"scale": P(), "bias": P()}
    block = {
        "ln1": ln, "ln2": ln,
        "qkv": {"kernel": P(None, MODEL_AXIS), "bias": P(MODEL_AXIS)},
        "attn_out": {"kernel": P(MODEL_AXIS, None), "bias": P()},
        "mlp_in": {"kernel": P(None, MODEL_AXIS), "bias": P(MODEL_AXIS)},
        "mlp_out": {"kernel": P(MODEL_AXIS, None), "bias": P()},
    }
    return {
        "tok_emb": P(MODEL_AXIS, None),
        "pos_emb": P(),
        "ln_f": ln,
        "lm_head": P(None, MODEL_AXIS),
        "blocks": [block for _ in range(cfg.layers)],
    }


def _shardings(cfg: TransformerConfig, mesh: Mesh):
    """param_pspecs as a matching tree of NamedShardings; axes absent from
    the mesh (a pure-DP mesh with no 'model') degrade to whole dims."""
    return tree_shardings(mesh, param_pspecs(cfg))


def _map_shardings(params, cfg: TransformerConfig, mesh: Mesh, fn):
    """``fn(sharding, leaf)`` over the parameter tree and its shardings.
    The fused qkv leaves go through their (..., 3, hidden) view with the
    'model' split on the last dim, so a rank's block holds the same heads
    of q, of k and of v (a plain column split of the fused matrix would
    give rank 0 all of q and half of k)."""
    def walk(p, s, qkv):
        if isinstance(p, dict):
            return {k: walk(p[k], s[k], qkv or k == "qkv") for k in p}
        if isinstance(p, (list, tuple)):
            return [walk(a, b, qkv) for a, b in zip(p, s)]
        if not qkv:
            return fn(s, p)
        spec = P(*s.spec[:-1], None, s.spec[-1])
        return fn(NamedSharding(mesh, spec),
                  p.unflatten(-1, (3, -1))).flatten(-2)

    return walk(params, _shardings(cfg, mesh), False)


def _padded_vocab(cfg: TransformerConfig, tp: int) -> int:
    """The vocabulary rounded up to a multiple of the 'model' axis."""
    return -(-cfg.vocab_size // tp) * tp


def place_params(params, cfg: TransformerConfig, mesh: Mesh):
    """This rank's shards of a global parameter tree (every rank passes
    the same tree), per :func:`param_pspecs`, as new tensors. Raises when
    the 'model' axis does not divide the heads or the MLP width. A
    vocabulary it does not divide (BERT's 30522 over 4) is zero-padded to
    the next multiple first (Megatron's vocabulary padding): the token
    table's padded rows are never looked up, and the logits of the
    lm_head's padded columns are cut off after their gather."""
    tp = mesh.axis_size(MODEL_AXIS)
    for n, what in ((cfg.heads, "heads"), (cfg.mlp_dim, "mlp_dim")):
        if n % tp:
            raise ValueError(f"{what}={n} does not split over "
                             f"{MODEL_AXIS}={tp}")
    pad = _padded_vocab(cfg, tp) - cfg.vocab_size
    if pad:
        params = dict(params,
                      tok_emb=F.pad(params["tok_emb"], (0, 0, 0, pad)),
                      lm_head=F.pad(params["lm_head"], (0, pad)))
    return _map_shardings(params, cfg, mesh,
                          lambda s, x: s.shard(x).clone())


def gather_params(params, cfg: TransformerConfig, mesh: Mesh):
    """The global parameter tree from every rank's :func:`place_params`
    shards (a collective: every rank of the mesh calls it), a padded
    vocabulary cut back."""
    out = _map_shardings(params, cfg, mesh, lambda s, x: s.gather(x))
    V = cfg.vocab_size
    return dict(out, tok_emb=out["tok_emb"][:V],
                lm_head=out["lm_head"][:, :V])


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
                    softmax_dtype: torch.dtype = torch.float32,
                    q_offset: int = 0):
    # q: (B, H, Tq, D), k, v: (B, H, Tk, D); query i sits at position
    # q_offset + i of the keys (a context rank's block of the sequence)
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.einsum("bhqd,bhkd->bhqk", q, k) * scale
    if causal:
        Tq, Tk = q.shape[2], k.shape[2]
        mask = torch.ones(Tq, Tk, dtype=torch.bool,
                          device=q.device).tril(q_offset)
        s = s.masked_fill(~mask, torch.finfo(s.dtype).min)
    p = torch.softmax(s.to(softmax_dtype), dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bhkd->bhqd", p, v)


def _axes(mesh: Optional[Mesh]):
    """(data, model, context) sizes; all 1 without a mesh."""
    if mesh is None:
        return 1, 1, 1
    return (mesh.axis_size(DATA_AXIS), mesh.axis_size(MODEL_AXIS),
            mesh.axis_size(CONTEXT_AXIS))


def _packed_mesh_spec(cfg: TransformerConfig, mesh: Mesh, B: int):
    """(PartitionSpec, local head count) of the packed kernel run per rank
    under ``mesh`` — batch on 'data', heads on 'model', no collective —
    or None where the kernel cannot run that way: the sequence is split
    over 'context', or the global batch ``B`` or the heads do not divide
    their axes (then the einsum or ring routes serve)."""
    if mesh.axis_size(CONTEXT_AXIS) > 1:
        return None   # the sequence is split: ring / Ulysses own that
    dp, tp = mesh.axis_size(DATA_AXIS), mesh.axis_size(MODEL_AXIS)
    if B % dp or cfg.heads % tp:
        return None
    spec = P(DATA_AXIS if DATA_AXIS in mesh.shape else None, None,
             MODEL_AXIS if MODEL_AXIS in mesh.shape else None)
    return spec, cfg.heads // tp


def _use_packed_kernel(cfg: TransformerConfig, mesh: Optional[Mesh],
                       B: int, T: int) -> bool:
    """True when attention routes to the packed-layout kernel: the
    (B, T, H*D) projections feed it directly, so no head transpose is
    made. ``B`` and ``T`` are global. Same envelope as the JAX package:
    ``attention_impl="flash"``, :func:`packed_kernel_shape_ok`, and under
    a mesh :func:`_packed_mesh_spec` (per rank on its heads)."""
    if cfg.attention_impl != "flash" or not packed_kernel_shape_ok(T):
        return False
    return mesh is None or _packed_mesh_spec(cfg, mesh, B) is not None


def _attention(q, k, v, cfg: TransformerConfig,
               mesh: Optional[Mesh] = None):
    """(B, H, T, D) attention of this rank's shards (local batch and
    heads; under a 'context' split, T is the rank's block), routed as the
    JAX package's ``_attention``:

    - ``"flash"`` with the sequence whole: the streamed kernels where
      :func:`flash_envelope_ok` holds, else the einsum path with a
      one-time warning;
    - ``"full"``, or any impl with the sequence whole: the einsum path
      (under a 'context' split on K/V gathered over the axis, the rank's
      queries at their global positions);
    - a 'context' split: ``"ulysses"`` takes :func:`ulysses_attention`;
      ``"ring"`` and ``"flash"`` take :func:`ring_flash_attention` where
      the block's length is inside the kernel envelope, else the einsum
      :func:`ring_attention`."""
    impl = cfg.attention_impl
    cp = _axes(mesh)[2]
    if impl == "flash" and cp == 1:
        T = q.shape[2]
        if flash_envelope_ok(T):
            return flash_attention(q, k, v, cfg.causal)
        _warn_flash_fallback(
            f"streamed kernel unavailable for T={T} under mesh "
            f"{dict(mesh.shape) if mesh is not None else None}")
    if cp == 1:
        return _full_attention(q, k, v, cfg.causal, cfg.softmax_dtype)
    group = mesh.group(CONTEXT_AXIS)
    if impl == "full":
        return _full_attention(
            q, gather_sequence(k, group), gather_sequence(v, group),
            cfg.causal, cfg.softmax_dtype,
            q_offset=mesh.axis_index(CONTEXT_AXIS) * q.shape[2])
    if impl == "ulysses":
        return ulysses_attention(q, k, v, group, cfg.causal)
    fn = ring_flash_attention if flash_envelope_ok(q.shape[2]) \
        else ring_attention
    return fn(q, k, v, group, cfg.causal)


# --------------------------------------------------------------------------
# Per-rank step bodies
# --------------------------------------------------------------------------
#
# Under a mesh a step runs per rank: the heads, the MLP's hidden width and
# the vocabulary ride 'model'. A step's body is a generator: where a rank
# needs the whole of a value the ranks hold parts of, it yields a request
# and resumes with the answer —
#
#   ("sum", x)     the ranks' partials x summed (a row-parallel product,
#                  the vocabulary-split embedding);
#   ("gather", x)  the ranks' blocks of x's last dim in rank order (the
#                  vocabulary-split logits);
#   ("copy", x)    x whole on every rank, its gradient summed over the
#                  ranks (a column-parallel layer's input, for training).
#
# :func:`_drive` answers them with the model axis' collectives (without a
# mesh, with x itself); :func:`drive_ranks` answers them for virtual ranks
# in one process. The distributed step and the one-process loop run the
# same body.


def _drive(body, mesh: Optional[Mesh]):
    """Run one rank's step ``body`` (a started-or-not generator), each
    request answered over this rank's 'model' group; returns the body's
    result. Without autograd a sum is reduced in place (a body yields a
    partial it made for the request and no longer holds), and a 'model'
    group of one rank answers every request with x itself: it has
    nothing to sum or gather, and the bits are the same."""
    group = None if mesh is None else mesh.group(MODEL_AXIS)
    if group is not None and not torch.is_grad_enabled() \
            and torch.distributed.get_world_size(group) == 1:
        group = None
    try:
        req = next(body)
        while True:
            kind, x = req
            if group is not None:
                if kind == "sum" and not torch.is_grad_enabled():
                    torch.distributed.all_reduce(x, group=group)
                elif kind == "sum":
                    x = reduce_sum(x, [group])
                elif kind == "gather":
                    x = gather_last(x, group)
                else:
                    x = copy_to(x, group)
            req = body.send(x)
    except StopIteration as done:
        return done.value


def drive_ranks(bodies):
    """Run the bodies of one step's virtual 'model' ranks in one process,
    in lockstep: each ``"sum"`` adds the ranks' partials in rank order
    (``((x0 + x1) + x2) + ...``), each ``"gather"`` concatenates their
    blocks in rank order, each ``"copy"`` hands every rank its own x.
    Returns every rank's result, in rank order."""
    reqs = []
    for b in bodies:
        try:
            reqs.append(next(b))
        except StopIteration as done:
            reqs.append(done)
    while True:
        done = [r for r in reqs if isinstance(r, StopIteration)]
        if done:
            if len(done) != len(reqs):
                raise RuntimeError("virtual ranks left the step apart")
            return [r.value for r in reqs]
        kinds = {r[0] for r in reqs}
        if len(kinds) != 1:
            raise RuntimeError(f"virtual ranks asked {sorted(kinds)} at "
                               "one point of the step")
        kind = reqs[0][0]
        xs = [x for _, x in reqs]
        if kind == "sum":
            total = xs[0]
            for x in xs[1:]:
                total = total + x
            answers = [total] * len(xs)
        elif kind == "gather":
            answers = [torch.cat(xs, dim=-1)] * len(xs)
        else:
            answers = xs
        nxt = []
        for b, a in zip(bodies, answers):
            try:
                nxt.append(b.send(a))
            except StopIteration as stop:
                nxt.append(stop)
        reqs = nxt


def _row_out(x, p):
    """Body steps of a row-parallel layer: the rank's partial product
    summed over 'model', then the bias, added once (without a mesh,
    exactly :func:`_dense`)."""
    s = yield ("sum", x @ p["kernel"].to(x.dtype))
    return s + p["bias"].to(x.dtype)


def _logits_steps(x, params, cfg: TransformerConfig):
    """Body steps of the lm_head: the rank's vocabulary block of the
    logits gathered over 'model' in rank order, in the compute dtype, cut
    to ``cfg.vocab_size`` (a vocabulary :func:`place_params` padded to
    split evenly)."""
    out = yield ("gather", x @ params["lm_head"].to(x.dtype))
    return out[..., :cfg.vocab_size]


def _to_model(x, mesh: Optional[Mesh]):
    """The input of a column-parallel layer: whole on every 'model' rank,
    its gradient summed over them."""
    return x if mesh is None else copy_to(x, mesh.group(MODEL_AXIS))


def _local_heads(cfg: TransformerConfig, mesh: Optional[Mesh]) -> int:
    """The heads a rank holds: ``cfg.heads`` over the 'model' axis."""
    tp = _axes(mesh)[1]
    if cfg.heads % tp:
        raise ValueError(f"heads={cfg.heads} does not split over "
                         f"{MODEL_AXIS}={tp}")
    return cfg.heads // tp


def _block_steps(params, x, cfg: TransformerConfig,
                 mesh: Optional[Mesh] = None, return_kv: bool = False):
    """One transformer block as a rank's body (see :func:`_drive`): the
    rank's heads of attention and its block of the MLP."""
    B, T, _ = x.shape
    dp, tp, cp = _axes(mesh)
    heads = cfg.heads // tp
    width = heads * cfg.head_dim
    h = yield ("copy", _layernorm(x, params["ln1"]))
    qkv = _dense(h, params["qkv"])
    q, k, v = qkv.split(width, dim=-1)
    if return_kv:
        # (B, T, heads, head_dim) — the KV-cache layout, a free view of
        # the head-contiguous packed projection
        kv_out = (k.reshape(B, T, heads, cfg.head_dim),
                  v.reshape(B, T, heads, cfg.head_dim))
    if _use_packed_kernel(cfg, mesh, B * dp, T * cp):
        o = mha_attention_packed(q.contiguous(), k.contiguous(),
                                 v.contiguous(), heads, cfg.causal, None,
                                 cfg.softmax_dtype)
    else:
        def split(t):  # (B, T, width) -> (B, heads, T, D)
            return t.reshape(B, T, heads, cfg.head_dim).transpose(1, 2)
        o = _attention(split(q), split(k), split(v), cfg, mesh)
        o = o.transpose(1, 2).reshape(B, T, width)
    x = x + (yield from _row_out(o, params["attn_out"]))
    h = yield ("copy", _layernorm(x, params["ln2"]))
    h = F.gelu(_dense(h, params["mlp_in"]), approximate="tanh")
    x = x + (yield from _row_out(h, params["mlp_out"]))
    if return_kv:
        return x, kv_out[0], kv_out[1]
    return x


def _block(params, x, cfg: TransformerConfig, mesh: Optional[Mesh] = None,
           return_kv: bool = False):
    return _drive(_block_steps(params, x, cfg, mesh, return_kv), mesh)


def _embed_steps(params, token_ids, positions, cfg: TransformerConfig,
                 mesh: Optional[Mesh] = None):
    """Token plus position embeddings in the compute dtype, as a rank's
    body. Under a mesh the token table is this rank's block of the
    vocabulary: ids outside it give zero rows, and the rows sum over
    'model' (in the table's dtype)."""
    emb = params["tok_emb"]
    if mesh is None:
        tok = emb[token_ids]
    else:
        V = emb.shape[0]
        local = token_ids - mesh.axis_index(MODEL_AXIS) * V
        inside = (local >= 0) & (local < V)
        tok = yield ("sum", emb[local.clamp(0, V - 1)] * inside[..., None])
    return tok.to(cfg.dtype) + params["pos_emb"][positions].to(cfg.dtype)


def _embed(params, token_ids, positions, cfg: TransformerConfig,
           mesh: Optional[Mesh] = None):
    return _drive(_embed_steps(params, token_ids, positions, cfg, mesh),
                  mesh)


def encode(params, token_ids, cfg: TransformerConfig,
           mesh: Optional[Mesh] = None):
    """Embeddings + transformer stack + final layernorm (no lm_head). With
    ``cfg.remat`` and autograd recording, each block runs under
    ``torch.utils.checkpoint``: its activations are recomputed in the
    backward (the reference's ``jax.checkpoint``; its policy changes
    memory, not results), so each block's attention forward launches
    twice per training step (and under a mesh its collectives run again
    on every rank alike).

    Under ``mesh`` this runs per rank: ``token_ids`` is the rank's
    (data, context) block (:func:`local_batch`), ``params`` its
    :func:`place_params` shards, and the positions those of the block,
    ``[c * T_local, (c + 1) * T_local)`` on context rank c."""
    _, T = token_ids.shape
    offset = 0 if mesh is None else mesh.axis_index(CONTEXT_AXIS) * T
    x = _embed(params, token_ids,
               (torch.arange(T, device=token_ids.device) + offset)[None],
               cfg, mesh)
    remat = cfg.remat and torch.is_grad_enabled()
    for bp in params["blocks"]:
        if remat:
            x = torch.utils.checkpoint.checkpoint(_block, bp, x, cfg, mesh,
                                                  use_reentrant=False)
        else:
            x = _block(bp, x, cfg, mesh)
    return _layernorm(x, params["ln_f"])


def _forward_raw(params, token_ids, cfg: TransformerConfig,
                 mesh: Optional[Mesh] = None):
    """Logits in the COMPUTE dtype: the loss upcasts them, as the
    reference's loss path does. Under ``mesh``, per rank (as
    :func:`encode`): the vocabulary-split ``lm_head`` products are
    gathered over 'model', so every model rank holds the block's whole
    logits (the loss then runs unchanged; a vocabulary-parallel
    logsumexp would save that (B, T, vocab) memory)."""
    x = _to_model(encode(params, token_ids, cfg, mesh), mesh)
    logits = x @ params["lm_head"].to(x.dtype)
    return logits if mesh is None else gather_last(
        logits, mesh.group(MODEL_AXIS))[..., :cfg.vocab_size]


@torch.no_grad()
def forward(params, token_ids, cfg: TransformerConfig,
            mesh: Optional[Mesh] = None):
    """token_ids (B, T) integer -> logits (B, T, vocab) fp32; under
    ``mesh`` per rank, on its block (see :func:`encode`)."""
    return _forward_raw(params, token_ids.long(), cfg, mesh).float()


def loss_from_logits(logits, batch, mesh: Optional[Mesh] = None):
    """Weighted LM cross-entropy from compute-dtype logits, as
    logsumexp(logits) - logits[target] with fp32 accumulation. Under
    ``mesh`` the weighted sum and the weight sum each add over 'data'
    and 'context': every rank returns the global weighted mean, whose
    gradient on a rank is its block's share."""
    lse = torch.logsumexp(logits.float(), dim=-1)
    tgt = logits.gather(-1, batch["targets"].long()[..., None])[..., 0]
    w = batch["weights"]
    num = ((lse - tgt.float()) * w).sum()
    den = w.sum()
    if mesh is not None:
        groups = [mesh.group(DATA_AXIS), mesh.group(CONTEXT_AXIS)]
        num = reduce_sum(num, groups)
        den = reduce_sum(den.detach(), groups)
    return num / den.clamp_min(1.0)


def lm_loss(params, batch, cfg: TransformerConfig,
            mesh: Optional[Mesh] = None):
    """Masked/causal LM cross-entropy. batch = {'tokens': (B, T) int,
    'targets': (B, T) int, 'weights': (B, T) float} — weights zero out
    unmasked positions (MLM) or padding. Under ``mesh`` per rank: the
    rank's shards and batch block; the loss is the global mean."""
    return loss_from_logits(
        _forward_raw(params, batch["tokens"].long(), cfg, mesh), batch,
        mesh)


def batch_pspec(mesh: Mesh) -> P:
    """Tokens (B, T): batch over 'data', sequence over 'context'."""
    return P(DATA_AXIS if DATA_AXIS in mesh.shape else None,
             CONTEXT_AXIS if CONTEXT_AXIS in mesh.shape else None)


def local_batch(mesh: Mesh, batch):
    """This rank's (data, context) block of each (B, T) array of a global
    batch, per :func:`batch_pspec` (every rank passes the same batch)."""
    sh = NamedSharding(mesh, batch_pspec(mesh))
    return {k: sh.shard(v) for k, v in batch.items()}


def make_infer_last_logits(cfg: TransformerConfig,
                           mesh: Optional[Mesh] = None):
    """Token ids (B, T) -> last-position logits (B, vocab) fp32, without
    autograd (the reference returns a jitted function; the port runs
    eagerly). Under ``mesh`` every rank passes the same global tokens and
    ``place_params`` shards, and gets the whole (B, vocab): the last
    context rank's rows, gathered over 'data'."""

    @torch.no_grad()
    def last_logits(params, tokens):
        if mesh is None:
            return forward(params, tokens, cfg)[:, -1, :]
        out = forward(params, local_batch(mesh, {"t": tokens})["t"], cfg,
                      mesh)[:, -1, :]
        if mesh.axis_index(CONTEXT_AXIS) != mesh.axis_size(CONTEXT_AXIS) - 1:
            out = torch.zeros_like(out)
        out = reduce_sum(out, [mesh.group(CONTEXT_AXIS)])
        return NamedSharding(mesh, P(DATA_AXIS)).gather(out)

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


def _sum_grads(grads, mesh: Mesh):
    """Every leaf's gradient summed over 'data' and 'context', in one
    flat buffer (one all-reduce per axis). Leaves split over 'model' hold
    their block's whole gradient already; whole leaves hold the same
    gradient on every model rank (the column-parallel inputs' gradients
    were summed in the backward)."""
    groups = [g for g in (mesh.group(DATA_AXIS), mesh.group(CONTEXT_AXIS))
              if g is not None]
    if not groups:
        return grads
    flat = torch.cat([g.reshape(-1) for g in grads])
    for group in groups:
        torch.distributed.all_reduce(flat, group=group)
    out, at = [], 0
    for g in grads:
        out.append(flat[at:at + g.numel()].view_as(g))
        at += g.numel()
    return out


def make_train_step(cfg: TransformerConfig, mesh: Optional[Mesh] = None,
                    learning_rate: float = 1e-4, weight_decay: float = 0.01):
    """Build ``(init_state, step)``; ``step(params, opt_state, batch) ->
    (params, opt_state, loss)``, the reference's step.

    Gradients of :func:`lm_loss` come from ``torch.autograd`` (compute in
    ``cfg.dtype`` over the fp32 master params). AdamW follows
    ``optax.adamw(learning_rate, weight_decay=weight_decay)``: b1 0.9,
    b2 0.999, eps 1e-8 outside the sqrt, eps_root 0; the moments update
    as ``(1 - b) * g + b * m``, the count is incremented first and the
    bias corrections ``1 - b ** count`` divide the moments; the decoupled
    decay ``wd * p`` is added to the update of EVERY leaf (optax's mask
    is None), then the update is scaled by ``-lr``. Params and state are
    updated IN PLACE and returned (the reference donates them).

    Under ``mesh`` every rank of the mesh calls ``step`` with its
    :func:`place_params` shards and state, and with the same GLOBAL batch
    (as the reference's jitted step takes it): each rank takes its
    (data, context) block, the loss is the global weighted mean, each
    gradient is summed over data and context (:func:`_sum_grads`), and
    AdamW runs on the local shards. ``init_state`` takes the shards too."""
    b1, b2, eps = 0.9, 0.999, 1e-8

    def init_state(params):
        leaves = _leaves(params)
        return {"count": 0,
                "mu": [torch.zeros_like(p) for p in leaves],
                "nu": [torch.zeros_like(p) for p in leaves]}

    def step(params, opt_state, batch):
        leaves = _leaves(params)
        tree, xs = grad_aliases(params)
        batch = _batch_on(batch, leaves[0].device)
        if mesh is not None:
            batch = local_batch(mesh, batch)
        loss = lm_loss(tree, batch, cfg, mesh)
        grads = torch.autograd.grad(loss, xs)
        if mesh is not None:
            grads = _sum_grads(grads, mesh)
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
                  block_size: Optional[int] = None,
                  num_blocks: Optional[int] = None,
                  kv_dtype: str = "float32", device=None,
                  mesh: Optional[Mesh] = None) -> Dict[str, Any]:
    """Allocate the generation cache in ``dtype`` (default the compute
    dtype); under ``mesh`` only this rank's ``heads // model`` heads (the
    block of :func:`kv_cache_pspecs` / :func:`paged_kv_cache_pspecs`).
    Two layouts, as in the reference:

    - ``block_size=None``: the contiguous per-slot layout ``{"layers":
      [{"k", "v"}: (slots, max_len, heads, head_dim)], "lengths": (slots,)
      int32}``, every slot reserving ``max_len`` positions;
    - ``block_size=B``: the paged block pool ``{"layers": [{"k", "v"}:
      (num_blocks, B, heads, head_dim)]}``, plus ``{"k_scale",
      "v_scale"}: (num_blocks, B, heads)`` fp32 for ``kv_dtype="int8"``
      (values int8). Block 0 is the reserved scratch block: dead-slot
      writes land there and it is never given to a stream.
      ``num_blocks`` defaults to ``slots * ceil(max_len / B) + 1``."""
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
    heads = _local_heads(cfg, mesh)
    if block_size is None:
        if num_blocks is not None:
            raise ValueError(
                f"num_blocks={num_blocks} requires block_size: the block "
                "pool is a paged-layout concept")
        shape = (slots, max_len, heads, cfg.head_dim)
        return {"layers": [
            {"k": torch.zeros(shape, dtype=dt, device=dev),
             "v": torch.zeros(shape, dtype=dt, device=dev)}
            for _ in range(cfg.layers)],
            "lengths": torch.zeros(slots, dtype=torch.int32, device=dev)}
    block_size = validate_block_size(block_size, max_len)
    if num_blocks is None:
        num_blocks = slots * -(-max_len // block_size) + 1
    if num_blocks < 2:
        raise ValueError(
            f"num_blocks must be >= 2 (block 0 is the reserved scratch "
            f"block), got {num_blocks}")
    shape = (num_blocks, block_size, heads, cfg.head_dim)
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


def kv_cache_pspecs(cfg: TransformerConfig) -> Dict[str, Any]:
    """PartitionSpecs of the contiguous cache, the reference's: heads over
    'model' (the column-parallel qkv's layout), slots and positions whole.
    Slots stay off 'data' on purpose: a prefill writes one slot, which a
    slot-split cache would turn into a gather per admission."""
    kv = P(None, None, MODEL_AXIS, None)
    return {"layers": [{"k": kv, "v": kv} for _ in range(cfg.layers)],
            "lengths": P()}


def paged_kv_cache_pspecs(cfg: TransformerConfig,
                          kv_dtype: str = "float32") -> Dict[str, Any]:
    """PartitionSpecs of the paged block pool, the reference's: heads over
    'model', blocks and in-block positions whole (the host's block table
    indexes a whole block axis, so paging adds no collective); an int8
    pool's per-token-per-head scales split their heads the same way."""
    kv = P(None, None, MODEL_AXIS, None)
    layer = {"k": kv, "v": kv}
    if kv_dtype == "int8":
        layer = dict(layer, k_scale=P(None, None, MODEL_AXIS),
                     v_scale=P(None, None, MODEL_AXIS))
    return {"layers": [dict(layer) for _ in range(cfg.layers)]}


def draft_kv_cache_pspecs(cfg: TransformerConfig) -> Dict[str, Any]:
    """PartitionSpecs of the draft cache: :func:`kv_cache_pspecs` without
    the lengths."""
    kv = P(None, None, MODEL_AXIS, None)
    return {"layers": [{"k": kv, "v": kv} for _ in range(cfg.layers)]}


def _place(tree, shardings):
    """Each leaf's block under its sharding, as a new tensor."""
    if isinstance(tree, dict):
        return {k: _place(tree[k], shardings[k]) for k in tree}
    if isinstance(tree, (list, tuple)):
        return [_place(a, b) for a, b in zip(tree, shardings)]
    return shardings.shard(tree).clone()


def place_kv_cache(cache, cfg: TransformerConfig, mesh: Mesh):
    """This rank's block of a global generation cache of any layout (the
    contiguous one carries ``lengths``, the paged pool does not, an int8
    pool adds scales), as new tensors."""
    if "lengths" in cache:
        spec = kv_cache_pspecs(cfg)
    else:
        kv_dtype = "int8" if "k_scale" in cache["layers"][0] else "float32"
        spec = paged_kv_cache_pspecs(cfg, kv_dtype)
    return _place(cache, tree_shardings(mesh, spec))


def place_draft_kv_cache(cache, cfg: TransformerConfig, mesh: Mesh):
    """This rank's block of a global draft cache, per
    :func:`draft_kv_cache_pspecs`."""
    return _place(cache, tree_shardings(mesh, draft_kv_cache_pspecs(cfg)))


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


def _stepped(body, mesh: Optional[Mesh]):
    """A step function from its per-rank ``body`` (a generator function
    taking the step's arguments): run without autograd through
    :func:`_drive`. The body stays reachable as ``step.body`` for
    :func:`drive_ranks`."""
    @torch.no_grad()
    def step(*args):
        return _drive(body(*args), mesh)

    step.body = body
    return step


def make_paged_prefill(cfg: TransformerConfig, block_size: int,
                       mesh: Optional[Mesh] = None,
                       kv_dtype: str = "float32"):
    """The paged prefill: one padded prompt through the standard forward
    (the same ``_block``), its per-layer K/V written into the physical
    blocks named by ``block_row``, and token 0 sampled.

    ``prefill(params, cache, tokens, block_row, length, key, temperature,
    top_k, step) -> (cache, token0)`` with tokens (1, T_bucket) integer,
    ``block_row`` (ceil(T_bucket/block_size),) physical block ids whose
    entries past the prompt's blocks name scratch block 0, ``length`` the
    real prompt length and ``step`` the sample index the draw folds into
    the key. The pool is updated in place; int8 pools quantize on write.

    Under ``mesh`` every rank runs it on its :func:`place_params` shards
    and its heads of the pool (:func:`init_kv_cache` with ``mesh``) with
    the same host arguments: the packed kernel on the rank's heads, the
    row-parallel products summed over 'model', the logits gathered, so
    every rank samples the same token."""
    _require_causal(cfg)
    validate_kv_dtype(kv_dtype, block_size)
    heads = _local_heads(cfg, mesh)

    def body(params, cache, tokens, block_row, length, key, temperature,
             top_k, step):
        dev = params["tok_emb"].device
        tokens = torch.as_tensor(np.asarray(tokens), device=dev).long()
        block_row = torch.as_tensor(np.asarray(block_row),
                                    device=dev).long()
        _, T = tokens.shape
        nb = block_row.shape[0]
        pad = nb * block_size - T
        x = yield from _embed_steps(
            params, tokens, torch.arange(T, device=dev)[None], cfg, mesh)
        for bp, lc in zip(params["blocks"], cache["layers"]):
            x, k, v = yield from _block_steps(bp, x, cfg, mesh,
                                              return_kv=True)
            kb = F.pad(k[0], (0, 0, 0, 0, 0, pad)).reshape(
                nb, block_size, heads, cfg.head_dim)
            vb = F.pad(v[0], (0, 0, 0, 0, 0, pad)).reshape(
                nb, block_size, heads, cfg.head_dim)
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
        logits = (yield from _logits_steps(last, params, cfg)).float()
        token0 = sample_token(logits, key, temperature, top_k, step)
        return cache, token0

    return _stepped(body, mesh)


def _paged_attention_mesh_spec(cfg: TransformerConfig, mesh: Mesh):
    """PartitionSpecs of the fused paged-attention kernel run per rank
    under ``mesh``, the reference's: heads over 'model' (the column-
    parallel qkv's layout), blocks, tables and positions whole — the
    kernel runs on each rank's heads with no collective. None when the
    heads do not split over the axis."""
    tp = mesh.axis_size(MODEL_AXIS)
    if cfg.heads % tp:
        return None
    m = MODEL_AXIS if MODEL_AXIS in mesh.shape else None
    return {"q": P(None, m, None), "pool": P(None, None, m, None),
            "scale": P(None, None, m), "repl": P()}


def _check_paged_route(cfg: TransformerConfig, mesh: Optional[Mesh],
                       paged_attention: str):
    if paged_attention not in ("gather", "fused"):
        raise ValueError(
            f"paged_attention must be 'gather' or 'fused', "
            f"got {paged_attention!r}")
    if paged_attention == "fused" and mesh is not None \
            and _paged_attention_mesh_spec(cfg, mesh) is None:
        raise ValueError(
            f"paged_attention='fused' cannot shard {cfg.heads} heads over "
            f"the mesh's {mesh.axis_size(MODEL_AXIS)}-way '{MODEL_AXIS}' "
            "axis; use paged_attention='gather' or a dividing mesh")


def _paged_attention(cfg: TransformerConfig, block_size: int,
                     quantized: bool, paged_attention: str):
    """The paged decode step's attention read. ``attend(qs, lc, tables,
    poss)`` takes lists of (S, heads, D) single-token queries and their
    (S,) int32 positions, read against one state of the layer's pool
    ``lc``, and returns the (S, heads, D) outputs: per query one
    :func:`paged_decode_attention` launch on the ``"fused"`` route; on the
    ``"gather"`` route ``pool[tables]`` gathered once as (S, L, heads, D)
    and, per query, the masked einsum attention. ``heads`` is the pool's
    (a rank's under a mesh). Every query runs at the decode step's own
    shapes, so the verify step's k+1 positions each get the bits the
    decode step would give them."""
    scale = 1.0 / math.sqrt(cfg.head_dim)

    def attend(qs, lc, tables, poss):
        S, H, D = qs[0].shape
        L = tables.shape[1] * block_size
        if paged_attention == "fused":
            return [paged_decode_attention(
                q, lc["k"], lc["v"], tables, pos, block_size=block_size,
                scale=scale, k_scale=lc["k_scale"] if quantized else None,
                v_scale=lc["v_scale"] if quantized else None)
                for q, pos in zip(qs, poss)]
        dt = qs[0].dtype
        tl = tables.long()
        gk = lc["k"][tl].reshape(S, L, H, D)
        gv = lc["v"][tl].reshape(S, L, H, D)
        if quantized:
            gk = (gk.float() * lc["k_scale"][tl].reshape(
                S, L, H)[..., None]).to(dt)
            gv = (gv.float() * lc["v_scale"][tl].reshape(
                S, L, H)[..., None]).to(dt)
        return [_masked_attention(q, gk, gv, pos, scale, cfg)
                for q, pos in zip(qs, poss)]

    return attend


def _masked_attention(q, k, v, pos, scale: float, cfg: TransformerConfig):
    """One query per slot, q (S, heads, D), over (S, L, heads, D) K/V:
    positions past ``pos`` (S,) masked, softmax in ``cfg.softmax_dtype``
    — the einsum attention of the reference's decode steps (no kernel:
    the reference has none on this read)."""
    L = k.shape[1]
    s = torch.einsum("shd,slhd->shl", q, k.to(q.dtype)) * scale
    mask = torch.arange(L, device=q.device)[None, :] <= pos[:, None]
    s = s.masked_fill(~mask[:, None, :], torch.finfo(s.dtype).min)
    p = torch.softmax(s.to(cfg.softmax_dtype), dim=-1).to(q.dtype)
    return torch.einsum("shl,slhd->shd", p, v.to(p.dtype))


def _paged_decode_logits_body(cfg: TransformerConfig, block_size: int,
                              kv_dtype: str, paged_attention: str,
                              mesh: Optional[Mesh]):
    quantized = kv_dtype == "int8"
    attend = _paged_attention(cfg, block_size, quantized, paged_attention)
    heads = _local_heads(cfg, mesh)
    width = heads * cfg.head_dim

    def body(params, cache, tables, lengths, tokens, cow_src, cow_dst):
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
        x = yield from _embed_steps(
            params, torch.as_tensor(np.asarray(tokens, np.int64),
                                    device=dev), pos_t.long(), cfg, mesh)
        for bp, lc in zip(params["blocks"], cache["layers"]):
            if cow.size:
                src = torch.as_tensor(cow_src[cow], device=dev)
                dst = torch.as_tensor(cow_dst[cow], device=dev)
                for name in lc:
                    lc[name][dst] = lc[name][src]
            h = _layernorm(x, bp["ln1"])
            q, k, v = _dense(h, bp["qkv"]).split(width, dim=-1)
            q = q.reshape(S, heads, cfg.head_dim).contiguous()
            k = k.reshape(S, heads, cfg.head_dim)
            v = v.reshape(S, heads, cfg.head_dim)
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
            o = attend([q], lc, tables_t, [pos_t])[0].reshape(
                S, width).to(x.dtype)
            x = x + (yield from _row_out(o, bp["attn_out"]))
            h = _layernorm(x, bp["ln2"])
            h = F.gelu(_dense(h, bp["mlp_in"]), approximate="tanh")
            x = x + (yield from _row_out(h, bp["mlp_out"]))
        x = _layernorm(x, params["ln_f"])
        return (yield from _logits_steps(x, params, cfg)).float()

    return body


def make_paged_decode_logits(cfg: TransformerConfig, block_size: int,
                             mesh: Optional[Mesh] = None,
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
      dequantization in the same pass.

    Under ``mesh`` per rank, on its heads of the pool (as
    :func:`make_paged_prefill`); ``"fused"`` raises ``ValueError`` when
    the heads do not split over 'model', as the reference does."""
    _require_causal(cfg)
    validate_kv_dtype(kv_dtype, block_size)
    _check_paged_route(cfg, mesh, paged_attention)
    return _stepped(_paged_decode_logits_body(
        cfg, block_size, kv_dtype, paged_attention, mesh), mesh)


def make_paged_decode_step(cfg: TransformerConfig, block_size: int,
                           mesh: Optional[Mesh] = None,
                           kv_dtype: str = "float32",
                           paged_attention: str = "gather"):
    """THE paged decode step: :func:`make_paged_decode_logits` followed by
    per-slot sampling, as the reference's ``decode_step`` is built.

    ``decode_step(params, cache, tables, lengths, tokens, keys, steps,
    temperatures, top_ks, cow_src, cow_dst) -> (cache, next_tokens)``
    with the pool updated in place and next_tokens (slots,) int64 on the
    params' device (under ``mesh`` every rank samples the same ids from
    the gathered logits)."""
    _require_causal(cfg)
    validate_kv_dtype(kv_dtype, block_size)
    _check_paged_route(cfg, mesh, paged_attention)
    logits_body = _paged_decode_logits_body(cfg, block_size, kv_dtype,
                                            paged_attention, mesh)

    def body(params, cache, tables, lengths, tokens, keys, steps,
             temperatures, top_ks, cow_src, cow_dst):
        logits = yield from logits_body(params, cache, tables, lengths,
                                        tokens, cow_src, cow_dst)
        return cache, sample_tokens(logits, keys, steps, temperatures,
                                    top_ks)

    return _stepped(body, mesh)


# --------------------------------------------------------------------------
# Contiguous generation: per-slot (slots, max_len) rows, lengths on device
# --------------------------------------------------------------------------


def _prefill_rows(params, cache, tokens, slot: int, cfg: TransformerConfig,
                  mesh: Optional[Mesh] = None):
    """Body steps of one padded prompt through the standard forward
    (``_block``, so the packed kernel serves it under ``attention_impl=
    "flash"``), its per-layer K/V written into row ``slot`` of a
    contiguous cache from position 0. Returns the final hidden states
    (1, T, hidden)."""
    dev = params["tok_emb"].device
    _, T = tokens.shape
    x = yield from _embed_steps(params, tokens,
                                torch.arange(T, device=dev)[None], cfg, mesh)
    for bp, lc in zip(params["blocks"], cache["layers"]):
        x, k, v = yield from _block_steps(bp, x, cfg, mesh, return_kv=True)
        lc["k"][slot, :T] = k[0].to(lc["k"].dtype)
        lc["v"][slot, :T] = v[0].to(lc["v"].dtype)
    return x


def make_prefill(cfg: TransformerConfig, mesh: Optional[Mesh] = None):
    """The contiguous prefill: one padded prompt written into cache row
    ``slot``, ``lengths[slot]`` set, and token 0 sampled.

    ``prefill(params, cache, tokens, slot, length, key, temperature, top_k,
    step=0) -> (cache, token0)`` with tokens (1, T_bucket) integer and
    ``length`` the real prompt length; ``step`` is the sample index the
    draw folds into the key (0 for a fresh stream, as the reference's
    draws). The cache is updated in place; under ``mesh`` per rank, on
    its heads."""
    _require_causal(cfg)
    _local_heads(cfg, mesh)

    def body(params, cache, tokens, slot, length, key, temperature, top_k,
             step=0):
        dev = params["tok_emb"].device
        tokens = torch.as_tensor(np.asarray(tokens), device=dev).long()
        x = yield from _prefill_rows(params, cache, tokens, int(slot), cfg,
                                     mesh)
        x = _layernorm(x, params["ln_f"])
        last = x[0, int(length) - 1]
        logits = (yield from _logits_steps(last, params, cfg)).float()
        token0 = sample_token(logits, key, temperature, top_k, step)
        cache["lengths"][int(slot)] = int(length)
        return cache, token0

    return _stepped(body, mesh)


def _contiguous_logits(params, layers, tokens, pos, cfg: TransformerConfig,
                       mesh: Optional[Mesh] = None):
    """Body steps of one token per slot through contiguous (slots, L,
    heads, D) cache layers: per layer the new K/V written at ``pos`` (S,)
    in place, then the masked einsum attention over the slot's own row.
    Returns (S, vocab) fp32 logits."""
    S = tokens.shape[0]
    heads = _local_heads(cfg, mesh)
    width = heads * cfg.head_dim
    rows = torch.arange(S, device=tokens.device)
    scale = 1.0 / math.sqrt(cfg.head_dim)
    pos_l = pos.long()
    x = yield from _embed_steps(params, tokens, pos_l, cfg, mesh)
    for bp, lc in zip(params["blocks"], layers):
        h = _layernorm(x, bp["ln1"])
        q, k, v = _dense(h, bp["qkv"]).split(width, dim=-1)
        q = q.reshape(S, heads, cfg.head_dim)
        lc["k"][rows, pos_l] = k.reshape(S, heads, cfg.head_dim).to(
            lc["k"].dtype)
        lc["v"][rows, pos_l] = v.reshape(S, heads, cfg.head_dim).to(
            lc["v"].dtype)
        o = _masked_attention(q, lc["k"], lc["v"], pos, scale, cfg)
        x = x + (yield from _row_out(o.reshape(S, width), bp["attn_out"]))
        h = _layernorm(x, bp["ln2"])
        h = F.gelu(_dense(h, bp["mlp_in"]), approximate="tanh")
        x = x + (yield from _row_out(h, bp["mlp_out"]))
    x = _layernorm(x, params["ln_f"])
    return (yield from _logits_steps(x, params, cfg)).float()


def make_decode_step(cfg: TransformerConfig, mesh: Optional[Mesh] = None):
    """THE contiguous decode step: one token for every slot, live or dead.

    ``decode_step(params, cache, tokens, live, keys, steps, temperatures,
    top_ks) -> (cache, next_tokens)``, every argument after ``cache`` a
    (slots,)-leading host array (``keys`` (slots, 2) uint32). The write
    goes at ``pos = clip(lengths, 0, max_len - 1)`` on the device, the
    query attends positions 0..pos of its own row, and ``lengths`` grows
    by one where ``live`` (dead slots compute masked garbage and keep
    their lengths). Under ``mesh`` per rank, on its heads."""
    _require_causal(cfg)
    _local_heads(cfg, mesh)

    def body(params, cache, tokens, live, keys, steps, temperatures,
             top_ks):
        dev = params["tok_emb"].device
        lengths = cache["lengths"]
        L = cache["layers"][0]["k"].shape[1]
        pos = lengths.clamp(0, L - 1)
        logits = yield from _contiguous_logits(
            params, cache["layers"],
            torch.as_tensor(np.asarray(tokens, np.int64), device=dev), pos,
            cfg, mesh)
        lengths += torch.as_tensor(np.asarray(live, bool),
                                   device=dev).to(lengths.dtype)
        return cache, sample_tokens(logits, keys, steps, temperatures,
                                    top_ks)

    return _stepped(body, mesh)


# --------------------------------------------------------------------------
# Speculative decoding: the draft's contiguous cache and the paged verify
# --------------------------------------------------------------------------


def init_draft_kv_cache(cfg: TransformerConfig, slots: int, max_len: int,
                        dtype: Optional[torch.dtype] = None,
                        device=None,
                        mesh: Optional[Mesh] = None) -> Dict[str, Any]:
    """The draft model's contiguous cache ``{"layers": [{"k", "v"}:
    (slots, max_len, heads, head_dim)]}`` without device lengths: the
    scheduler passes each call's lengths from the host, so rewinding a
    rejected tail is passing a smaller length. Under ``mesh`` this rank's
    heads only (:func:`draft_kv_cache_pspecs`)."""
    if max_len > cfg.max_seq:
        raise ValueError(
            f"max_len {max_len} exceeds the draft model's positional "
            f"table max_seq={cfg.max_seq}")
    dev = default_device(device)
    dt = cfg.dtype if dtype is None else dtype
    shape = (slots, max_len, _local_heads(cfg, mesh), cfg.head_dim)
    return {"layers": [{"k": torch.zeros(shape, dtype=dt, device=dev),
                        "v": torch.zeros(shape, dtype=dt, device=dev)}
                       for _ in range(cfg.layers)]}


def _require_causal_draft(cfg: TransformerConfig):
    if not cfg.causal:
        raise ValueError("speculative drafting needs a causal LM: set "
                         "TransformerConfig(causal=True)")


def make_draft_prefill(cfg: TransformerConfig, mesh: Optional[Mesh] = None):
    """``draft_prefill(params, cache, tokens, slot) -> cache``: one padded
    prompt through the draft's standard forward, its K/V written into row
    ``slot``. No sampling: the first proposal comes from
    :func:`make_draft_step` fed the target's last token. Under ``mesh``
    per rank, on its heads."""
    _require_causal_draft(cfg)
    _local_heads(cfg, mesh)

    def body(params, cache, tokens, slot):
        dev = params["tok_emb"].device
        tokens = torch.as_tensor(np.asarray(tokens), device=dev).long()
        yield from _prefill_rows(params, cache, tokens, int(slot), cfg, mesh)
        return cache

    return _stepped(body, mesh)


def make_draft_step(cfg: TransformerConfig, mesh: Optional[Mesh] = None):
    """THE draft step: one proposed token per slot.

    ``draft_step(params, cache, tokens, lengths, keys, steps, temperatures,
    top_ks) -> (cache, proposals)`` — the contiguous decode math with
    ``lengths`` from the host (no ``live`` mask: dead or draft-cold slots
    compute garbage the scheduler ignores), ``pos`` clipped to
    ``min(max_len, max_seq) - 1``. ``steps`` carries the TARGET's token
    index of each proposal, so the draw folds the key and step the verify
    folds. Under ``mesh`` per rank, on its heads."""
    _require_causal_draft(cfg)
    _local_heads(cfg, mesh)

    def body(params, cache, tokens, lengths, keys, steps, temperatures,
             top_ks):
        dev = params["tok_emb"].device
        L = cache["layers"][0]["k"].shape[1]
        pos = np.clip(np.asarray(lengths, np.int64), 0,
                      min(L, cfg.max_seq) - 1)
        logits = yield from _contiguous_logits(
            params, cache["layers"],
            torch.as_tensor(np.asarray(tokens, np.int64), device=dev),
            torch.as_tensor(pos.astype(np.int32), device=dev), cfg, mesh)
        return cache, sample_tokens(logits, keys, steps, temperatures,
                                    top_ks)

    return _stepped(body, mesh)


def _rows_dense(x, p):
    """:func:`_dense` of each position's (S, in) rows of position-major x
    (T, S, in) on its own: every matrix product at the decode step's
    shape, so each row comes out with the decode step's bits whatever T
    (a GEMM library picks its kernel, and with it its summation order,
    from the shape)."""
    w = p["kernel"].to(x.dtype)
    return torch.stack([xj @ w for xj in x]) + p["bias"].to(x.dtype)


def _rows_out(x, p):
    """Body steps of :func:`_rows_dense` for a row-parallel layer: each
    position's partial product summed over 'model' on its own, at the
    decode step's shape (a collective's algorithm, and with it its
    summation order, may depend on the size), then the bias."""
    w = p["kernel"].to(x.dtype)
    rows = []
    for xj in x:
        rows.append((yield ("sum", xj @ w)))
    return torch.stack(rows) + p["bias"].to(x.dtype)


def _rows_layernorm(x, p):
    """:func:`_layernorm` of each position's (S, hidden) rows of
    position-major x (T, S, hidden) on its own, so each row comes out
    with the decode step's bits (a row reduction may split a row by the
    row count)."""
    return torch.stack([_layernorm(xj, p) for xj in x])


def make_verify_step(cfg: TransformerConfig, block_size: int, k: int,
                     mesh: Optional[Mesh] = None,
                     kv_dtype: str = "float32",
                     paged_attention: str = "gather"):
    """THE speculative verify step: k+1 positions per slot scored in one
    call, the accepted proposal prefix counted on the device.

    ``verify_step(params, cache, tables, lengths, tokens, keys, steps,
    temperatures, top_ks, cow_src, cow_dst) -> (cache, samples,
    accepted)``: :func:`make_paged_decode_step` from one query per slot to
    k+1. ``tokens`` (slots, k+1): column 0 the slot's last committed
    token, columns 1..k the draft's proposals. Per layer the copy-on-write
    pair goes first, then all k+1 K/V writes at positions length..length+k
    (a write past ``Lcap = min(L, max_seq)`` goes to scratch block 0,
    never clamped: a clamped write would land on a live entry; a write
    past the mapped table entries lands in scratch through the table's
    zeros), then one single-query attention per position, at
    ``min(length + j, Lcap - 1)``: on the fused route one
    :func:`paged_decode_attention` launch each, on the gather route the
    decode step's own gather and einsum. ``samples[:, j]`` is the target's
    sample for token index ``steps + j``; ``accepted`` (slots,) counts the
    leading ``tokens[:, j+1] == samples[:, j]``.

    Each position runs at the decode step's shapes (position-major rows,
    the matrix products, their sums over 'model' and the logits' gather
    one position at a time), so ``samples[:, j]`` is bit for bit what the
    decode step would sample there: a speculative stream equals the plain
    one. Under ``mesh`` per rank, on its heads."""
    _require_causal(cfg)
    if k < 1:
        raise ValueError(
            f"verify needs k >= 1 proposed tokens per turn, got {k} — "
            "k == 0 IS the plain decode_step; the engine falls back to "
            "it rather than minting a degenerate verify executable")
    validate_kv_dtype(kv_dtype, block_size)
    _check_paged_route(cfg, mesh, paged_attention)
    T = k + 1
    quantized = kv_dtype == "int8"
    attend = _paged_attention(cfg, block_size, quantized, paged_attention)
    heads = _local_heads(cfg, mesh)
    width = heads * cfg.head_dim

    def body(params, cache, tables, lengths, tokens, keys, steps,
             temperatures, top_ks, cow_src, cow_dst):
        dev = params["tok_emb"].device
        tables_np = np.asarray(tables, np.int32)
        S, nb = tables_np.shape
        L = nb * block_size
        Lcap = min(L, cfg.max_seq)
        pos = np.clip(np.asarray(lengths, np.int64), 0, Lcap - 1)
        # (T, S) position-major: write positions, their blocks, and the
        # read (attention and embedding) positions
        posm = pos[None, :] + np.arange(T)[:, None]
        blk = tables_np[np.arange(S)[None, :],
                        np.minimum(posm, L - 1) // block_size]
        pb = torch.as_tensor(np.where(posm < Lcap, blk, 0), device=dev)
        off = torch.as_tensor(posm % block_size, device=dev)
        read = torch.as_tensor(np.minimum(posm, Lcap - 1).astype(np.int32),
                               device=dev)
        cow_src = np.asarray(cow_src, np.int64)
        cow_dst = np.asarray(cow_dst, np.int64)
        cow = np.flatnonzero(cow_src != cow_dst)
        tables_t = torch.as_tensor(tables_np, device=dev)
        tok = torch.as_tensor(np.asarray(tokens, np.int64), device=dev)
        x = yield from _embed_steps(params, tok.T, read.long(), cfg,
                                    mesh)                    # (T, S, hidden)
        hd = (heads, cfg.head_dim)
        for bp, lc in zip(params["blocks"], cache["layers"]):
            if cow.size:
                src = torch.as_tensor(cow_src[cow], device=dev)
                dst = torch.as_tensor(cow_dst[cow], device=dev)
                for name in lc:
                    lc[name][dst] = lc[name][src]
            h = _rows_layernorm(x, bp["ln1"])
            q, kx, vx = _rows_dense(h, bp["qkv"]).split(width, dim=-1)
            kx = kx.reshape(T, S, *hd)
            vx = vx.reshape(T, S, *hd)
            if quantized:
                kq, ks = quantize_kv(kx)
                vq, vs = quantize_kv(vx)
                lc["k"][pb, off] = kq
                lc["v"][pb, off] = vq
                lc["k_scale"][pb, off] = ks
                lc["v_scale"][pb, off] = vs
            else:
                lc["k"][pb, off] = kx.to(lc["k"].dtype)
                lc["v"][pb, off] = vx.to(lc["v"].dtype)
            qs = [q[j].reshape(S, *hd).contiguous() for j in range(T)]
            o = torch.stack(attend(qs, lc, tables_t, list(read)))
            x = x + (yield from _rows_out(o.reshape(T, S, width).to(x.dtype),
                                          bp["attn_out"]))
            h = _rows_layernorm(x, bp["ln2"])
            h = F.gelu(_rows_dense(h, bp["mlp_in"]), approximate="tanh")
            x = x + (yield from _rows_out(h, bp["mlp_out"]))
        x = _rows_layernorm(x, params["ln_f"])
        rows = []
        for xj in x:
            rows.append((yield from _logits_steps(xj, params, cfg)))
        logits = torch.stack(rows).float()                   # (T, S, V)
        keys = np.asarray(keys, np.uint32).reshape(S, 2)
        samples = sample_tokens(
            logits.reshape(T * S, -1), np.tile(keys, (T, 1)),
            (np.asarray(steps, np.int64)[None, :]
             + np.arange(T)[:, None]).reshape(-1),
            np.tile(np.asarray(temperatures, np.float32).reshape(S), T),
            np.tile(np.asarray(top_ks, np.int64).reshape(S), T),
        ).reshape(T, S).T                                    # (S, T)
        matches = (tok[:, 1:] == samples[:, :k]).long()
        accepted = torch.cumprod(matches, dim=1).sum(dim=1)
        return cache, samples, accepted

    return _stepped(body, mesh)
