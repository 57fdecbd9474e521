"""Sequence / context parallelism — ring attention and Ulysses-style
all-to-all attention over ``torch.distributed``: the counterpart of
``deeplearning4j_tpu/parallel/sequence_parallel.py``.

The JAX package calls these inside ``shard_map`` with a mesh axis name.
Here each function runs on every rank of the context axis with the
rank's local (B, H, T_local, D) shards and the axis' process group
(``mesh.group(CONTEXT_AXIS)``; None is a ring of one rank, which needs no
communication). K/V blocks rotate with batched point-to-point sends to
rank + 1 and receives from rank - 1 of the group.

- :func:`ring_flash_attention` — the default ring: per (q-shard,
  kv-shard) pair the streamed kernels (``flash_forward``,
  ``flash_bwd_dq``, ``flash_bwd_dkv``) with lse and delta in the global
  softmax frame, and a second ring pass for the backward in which the
  dk/dv partial sums rotate with their blocks; O(T_local) memory both
  ways.
- :func:`ring_attention` — the einsum ring, differentiable to any order.
- :func:`ulysses_attention` — all-to-all from sequence- to head-sharded,
  full-T attention on the local heads, and back.
- :func:`zigzag_ring_flash_attention` — the load-balanced causal ring on
  the zigzag layout (:func:`zigzag_indices`).
- :func:`ring_self_attention`, :func:`zigzag_ring_self_attention` — the
  whole-array conveniences.

One function holds each ring step's body — :func:`_ring_fwd_step`,
:func:`_ring_bwd_step`, :func:`_zz_fwd_step`, :func:`_zz_bwd_step` — given
the held block, its index and this rank's index. The distributed loops
call them between rotations; :func:`ring_flash_loop` and
:func:`zigzag_ring_flash_loop` call the same functions for n virtual ranks
in one process, indexing the blocks instead of receiving them, in the
order the rings add each block's partial sums: the two agree bit for
bit. A causal ring skips the kernels of hidden blocks, never a rotation:
every rank posts the same sends and receives in the same order.
"""
from __future__ import annotations

import math
from typing import List, Optional

import numpy as np
import torch
import torch.distributed as dist

from deeplearning4j_tpu_torch.ops import attention_kernels as _ak
from deeplearning4j_tpu_torch.ops.attention_kernels import (
    flash_attention, flash_bwd_dkv, flash_bwd_dq, flash_envelope_ok,
    flash_forward)
from deeplearning4j_tpu_torch.ops._launch import first_order_only
from deeplearning4j_tpu_torch.parallel.mesh import CONTEXT_AXIS, Mesh

_first_order_only = first_order_only(_ak._FIRST_ORDER_MSG)


# ------------------------------------------------------------ communication


def _ring(group):
    """(n, this rank's index, the group's global ranks) of a ring."""
    if group is None:
        return 1, 0, None
    ranks = dist.get_process_group_ranks(group)
    return len(ranks), dist.get_rank(group), ranks


def _rotate(xs, group, shift: int = 1) -> List[torch.Tensor]:
    """Send each tensor to ring rank ``me + shift`` and receive its
    counterpart from ``me - shift``, all in one batch (tag = position)."""
    n, me, ranks = _ring(group)
    if n == 1:
        return list(xs)
    ops, outs = [], []
    for tag, x in enumerate(xs):
        x = x.contiguous()
        buf = torch.empty_like(x)
        ops.append(dist.P2POp(dist.isend, x, ranks[(me + shift) % n],
                              group, tag))
        ops.append(dist.P2POp(dist.irecv, buf, ranks[(me - shift) % n],
                              group, tag))
        outs.append(buf)
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    return outs


class _Rotate(torch.autograd.Function):
    """:func:`_rotate` as an op: the gradient rotates back."""

    @staticmethod
    def forward(ctx, group, shift, *xs):
        ctx.group, ctx.shift = group, shift
        return tuple(_rotate(xs, group, shift))

    @staticmethod
    def backward(ctx, *gs):
        return (None, None) + tuple(_Rotate.apply(ctx.group, -ctx.shift,
                                                  *gs))


def _all_gather_seq(x, group):
    """The ring's blocks of ``x`` concatenated along dim 2 (no autograd)."""
    n, _, _ = _ring(group)
    if n == 1:
        return x
    parts = [torch.empty_like(x) for _ in range(n)]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, dim=2)


def _own_block(x, group):
    n, me, _ = _ring(group)
    size = x.shape[2] // n
    return x.narrow(2, me * size, size).contiguous()


class _GatherSeq(torch.autograd.Function):
    """Every rank's block concatenated along the sequence (dim 2), where
    each rank goes on with the same whole tensor: the gradient of a block
    is its own slice of the gradient."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_gather_seq(x, group)

    @staticmethod
    def backward(ctx, g):
        return _ScatterSeq.apply(g, ctx.group), None


class _ScatterSeq(torch.autograd.Function):
    """This rank's block of a tensor every rank holds whole: the whole
    gradient is every rank's block gathered."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _own_block(x, group)

    @staticmethod
    def backward(ctx, g):
        return _GatherSeq.apply(g, ctx.group), None


class _GatherSeqSum(torch.autograd.Function):
    """Every rank's block concatenated along the sequence, where each rank
    uses the whole for its own part of a sum (the model's einsum route
    over a context axis): a block's gradient sums every rank's."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_gather_seq(x, group)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return _own_block(g, ctx.group), None


def gather_sequence(x, group):
    """(B, H, T_local, D) blocks -> (B, H, T, D) on every rank of the
    context group, each block's gradient summed over the ranks."""
    if group is None:
        return x
    return _GatherSeqSum.apply(x, group)


def _seq_to_heads(x, group):
    """(B, H, T_local, D) -> (B, H/n, T, D): rank j gets head chunk j of
    every rank's sequence block."""
    n, _, _ = _ring(group)
    B, H, Tl, D = x.shape
    inp = x.reshape(B, n, H // n, Tl, D).permute(1, 0, 2, 3, 4).contiguous()
    out = torch.empty_like(inp)
    dist.all_to_all_single(out, inp, group=group)
    return out.permute(1, 2, 0, 3, 4).reshape(B, H // n, n * Tl, D)


def _heads_to_seq(x, group):
    """(B, H/n, T, D) -> (B, H, T/n, D): the inverse of :func:`_seq_to_heads`."""
    n, _, _ = _ring(group)
    B, Hl, T, D = x.shape
    inp = x.reshape(B, Hl, n, T // n, D).permute(2, 0, 1, 3, 4).contiguous()
    out = torch.empty_like(inp)
    dist.all_to_all_single(out, inp, group=group)
    return out.permute(1, 0, 2, 3, 4).reshape(B, n * Hl, T // n, D)


class _SeqToHeads(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _seq_to_heads(x, group)

    @staticmethod
    def backward(ctx, g):
        return _HeadsToSeq.apply(g, ctx.group), None


class _HeadsToSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _heads_to_seq(x, group)

    @staticmethod
    def backward(ctx, g):
        return _SeqToHeads.apply(g, ctx.group), None


# ------------------------------------------------------------- einsum ring


def _block_attn_update(q, k, v, m, l, o, scale, mask=None):
    """One online-softmax block update (flash-attention accumulation).
    q: (B,H,Tq,D), k/v: (B,H,Tk,D); m/l: (B,H,Tq,1); o: (B,H,Tq,D)."""
    s = torch.einsum("bhqd,bhkd->bhqk", q, k) * scale
    if mask is not None:
        s = torch.where(mask, s, torch.full_like(s, -math.inf))
    m_blk = s.amax(-1, keepdim=True)
    m_new = torch.maximum(m, m_blk)
    # fully-masked block rows have a -inf max: clamp before exp
    m_safe = torch.where(torch.isneginf(m_new), torch.zeros_like(m_new),
                         m_new)
    p = torch.exp(s - m_safe)
    if mask is not None:
        p = torch.where(mask, p, torch.zeros_like(p))
    alpha = torch.where(torch.isneginf(m), torch.zeros_like(m),
                        torch.exp(m - m_safe))
    l_new = alpha * l + p.sum(-1, keepdim=True)
    o_new = alpha * o + torch.einsum("bhqk,bhkd->bhqd", p, v)
    return m_new, l_new, o_new


def ring_attention(q, k, v, group=None, causal: bool = False):
    """Ring attention over a sharded sequence: q, k, v this rank's
    (B, H, T_local, D) blocks; the global sequence is n * T_local. K/V
    blocks rotate around the ring while each rank accumulates its
    queries' attention online — the exact full-attention result, any-
    order differentiable (the backward rotates the gradients back)."""
    n, me, _ = _ring(group)
    B, H, T, D = q.shape
    scale = 1.0 / math.sqrt(D)
    q_pos = me * T + torch.arange(T, device=q.device)
    o = torch.zeros_like(q)
    l = torch.zeros((B, H, T, 1), dtype=q.dtype, device=q.device)
    m = torch.full((B, H, T, 1), -math.inf, dtype=q.dtype, device=q.device)
    k_blk, v_blk = k, v
    for i in range(n):
        kv_idx = (me - i) % n          # block currently held
        mask = None
        if causal:
            k_pos = kv_idx * T + torch.arange(T, device=q.device)
            mask = (q_pos[:, None] >= k_pos[None, :])[None, None]
        m, l, o = _block_attn_update(q, k_blk, v_blk, m, l, o, scale, mask)
        if i < n - 1:
            k_blk, v_blk = _Rotate.apply(group, 1, k_blk, v_blk)
    return o / l.clamp_min(1e-30)


# --------------------------------------------------------- Ulysses (a2a)


def ulysses_attention(q, k, v, group=None, causal: bool = False,
                      use_kernel: Optional[bool] = None):
    """All-to-all ("Ulysses") sequence parallelism: reshard from sequence-
    to head-sharded, run full attention on the whole sequence for the
    local heads, reshard back. Needs heads % n == 0; q, k, v this rank's
    (B, H, T_local, D) blocks.

    ``use_kernel``: None takes the streamed kernel on a CUDA tensor where
    :func:`flash_envelope_ok` holds for the global T, the einsum path
    elsewhere; False pins the einsum path; True takes the kernel (its
    plain version on the CPU) and raises off the envelope."""
    if group is not None:
        q = _SeqToHeads.apply(q, group)
        k = _SeqToHeads.apply(k, group)
        v = _SeqToHeads.apply(v, group)
    D = q.shape[-1]
    T = q.shape[2]
    fits = flash_envelope_ok(T)
    if use_kernel and not fits:
        raise ValueError(
            f"ulysses_attention: use_kernel=True but global T={T} is "
            "outside the streamed kernel's block envelope; pad the "
            "sequence or drop to use_kernel=None/False")
    if use_kernel is None:
        use_kernel = q.is_cuda and fits
    if use_kernel:
        o = flash_attention(q, k, v, causal)
    else:
        s = torch.einsum("bhqd,bhkd->bhqk", q, k) * (1.0 / math.sqrt(D))
        if causal:
            mask = torch.ones(T, T, dtype=torch.bool, device=q.device).tril()
            s = s.masked_fill(~mask, torch.finfo(s.dtype).min)
        p = torch.softmax(s, dim=-1)
        o = torch.einsum("bhqk,bhkd->bhqd", p, v)
    if group is None:
        return o
    return _HeadsToSeq.apply(o, group)


# ------------------------------------------------------ kernel-backed ring


def _merge_partial(o, lse, o_b, lse_b):
    """Combine two normalized attention partials (o, lse) -> (o, lse).
    All fp32; lse shaped (BH, 1, T), o shaped (BH, T, D)."""
    m = torch.maximum(lse, lse_b)
    m_safe = torch.where(torch.isneginf(m), torch.zeros_like(m), m)
    zero = torch.zeros_like(m)
    w = torch.where(torch.isneginf(lse), zero, torch.exp(lse - m_safe))
    w_b = torch.where(torch.isneginf(lse_b), zero, torch.exp(lse_b - m_safe))
    denom = (w + w_b).clamp_min(1e-30)
    wT, wbT, dT = (x.transpose(1, 2) for x in (w, w_b, denom))
    o_new = (o * wT + o_b * wbT) / dT
    lse_new = m_safe + torch.log(denom)
    lse_new = torch.where(torch.isneginf(m), m, lse_new)
    return o_new, lse_new


def _merge(state, part):
    """Merge partial ``part`` into ``state`` (None: nothing yet)."""
    return part if state is None else _merge_partial(*state, *part)


def _add(acc, x):
    return x if acc is None else acc + x


def _add_abs(acc, x):
    """:func:`_add` of |x|: a loop summing it gets each element's sum of
    the pairs' |terms| (``magnitudes=True``)."""
    return _add(acc, x.abs())


def _pair(q3, k3, v3, pair_causal):
    """One (q-shard, kv-shard) pair's forward: o in fp32 (the kernel's
    output, in q's dtype, upcast) and lse (BH, 1, T)."""
    o, lse = flash_forward(q3, k3, v3, pair_causal)
    return o.float(), lse


def _pair_grads3(q3, k3, v3, do3, lse, delta, pair_causal):
    """One pair's (dq, dk, dv) in fp32, lse and delta (BH, 1, T) in the
    GLOBAL softmax frame: the streamed dq and dk/dv passes."""
    dq = flash_bwd_dq(q3, k3, v3, do3, lse, delta, pair_causal)
    dk, dv = flash_bwd_dkv(q3, k3, v3, do3, lse, delta, pair_causal)
    return dq.float(), dk.float(), dv.float()


def _ring_rel(kv_idx: int, my_idx: int, causal: bool):
    """The pair's mask: True (diagonal, causal), False (fully visible) or
    None (a strictly future block of a causal ring: no kernel)."""
    if kv_idx == my_idx:
        return causal
    if causal and kv_idx > my_idx:
        return None
    return False


def _ring_fwd_step(q3, k3, v3, kv_idx: int, my_idx: int, causal: bool,
                   state):
    """Ring forward step: merge the held block ``kv_idx``'s partial into
    ``state`` (o, lse), or leave it as it is for a hidden block."""
    rel = _ring_rel(kv_idx, my_idx, causal)
    if rel is None:
        return state
    return _merge(state, _pair(q3, k3, v3, rel))


def _ring_bwd_step(q3, do3, lse, delta, k3, v3, kv_idx: int, my_idx: int,
                   causal: bool, dq, dk, dv, add=_add):
    """Ring backward step: add the held block's (dq, dk, dv) to this
    rank's dq and to the block's travelling dk/dv partial sums."""
    rel = _ring_rel(kv_idx, my_idx, causal)
    if rel is None:
        return dq, dk, dv
    a, b, c = _pair_grads3(q3, k3, v3, do3, lse, delta, rel)
    return add(dq, a), add(dk, b), add(dv, c)


def _delta(do3, out3):
    """rowsum(dO * O) in fp32, (BH, 1, T), from the output in q's dtype."""
    return (do3.float() * out3.float()).sum(-1)[:, None, :]


def _ring_flash_fwd(q3, k3, v3, group, causal):
    n, me, _ = _ring(group)
    state = None
    for i in range(n):
        if i:
            k3, v3 = _rotate((k3, v3), group)
        state = _ring_fwd_step(q3, k3, v3, (me - i) % n, me, causal, state)
    return state


def _ring_flash_bwd(q3, k3, v3, do3, lse, delta, group, causal):
    n, me, _ = _ring(group)
    dq = dk = dv = None
    for i in range(n):
        if i:
            # dk/dv partial sums ride the ring with their K/V block
            k3, v3, dk, dv = _rotate((k3, v3, dk, dv), group)
        dq, dk, dv = _ring_bwd_step(q3, do3, lse, delta, k3, v3,
                                    (me - i) % n, me, causal, dq, dk, dv)
    if n > 1:
        # one more hop brings each block's partial sums home
        dk, dv = _rotate((dk, dv), group)
    return dq, dk, dv


def _bh(x):
    B, H, T, D = x.shape
    return x.reshape(B * H, T, D).contiguous()


class _RingFlash(torch.autograd.Function):
    """Forward: the ring of streamed forward kernels, o and lse merged in
    fp32 and cast to q's dtype once. Backward: the second ring pass with
    delta from that cast output. First-order only."""

    @staticmethod
    def forward(ctx, q, k, v, group, causal):
        o, lse = _ring_flash_fwd(_bh(q), _bh(k), _bh(v), group, causal)
        out = o.to(q.dtype).reshape(q.shape)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (group, causal)
        return out

    @staticmethod
    @_first_order_only
    def backward(ctx, g):
        q, k, v, out, lse = ctx.saved_tensors
        group, causal = ctx.args
        do3 = _bh(g.to(q.dtype))
        dq, dk, dv = _ring_flash_bwd(_bh(q), _bh(k), _bh(v), do3, lse,
                                     _delta(do3, _bh(out)), group, causal)
        return (dq.to(q.dtype).reshape(q.shape),
                dk.to(k.dtype).reshape(k.shape),
                dv.to(v.dtype).reshape(v.shape), None, None)


def ring_flash_attention(q, k, v, group=None, causal: bool = False):
    """Ring attention whose per-pair block attention is the streamed
    kernels: q, k, v this rank's (B, H, T_local, D) blocks, T_local
    inside :func:`flash_envelope_ok`. Exact full attention; O(T_local)
    memory both ways. Strictly future blocks of a causal ring launch no
    kernel (their rotations still run). First-order autograd only; under
    :func:`~deeplearning4j_tpu_torch.ops.attention_kernels.higher_order_attention`
    it is the einsum :func:`ring_attention`."""
    if _ak._HIGHER_ORDER:
        return ring_attention(q, k, v, group=group, causal=causal)
    return _RingFlash.apply(q, k, v, group, causal)


def ring_flash_loop(q, k, v, n: int, causal: bool = False, do=None,
                    magnitudes: bool = False):
    """The ring of :func:`ring_flash_attention` run for ``n`` virtual
    ranks in one process: q, k, v whole (B, H, T, D), rank r holding
    block r of n; rank r's step i works on block (r - i) % n, indexed
    instead of received. Returns the output, and with ``do`` (the output
    gradient) ``(out, (dq, dk, dv))``. The backward runs the steps in the
    ring's order — step i of every rank before step i + 1 — so each
    block's dk/dv sums take their terms in the order the rotating sums
    do: bit for bit the distributed ring.

    With ``magnitudes`` the backward returns, in fp32 in place of the
    gradients, each element's sum over the pairs of |the pair's term|:
    a pair's gradients leave the kernels in q's dtype before the fp32
    sums, so each adds at most half an ulp of its term to the result
    (what a check of a bf16 ring against a whole-T kernel allows for)."""
    qs, ks, vs = (list(_bh(x).chunk(n, dim=1)) for x in (q, k, v))
    qs, ks, vs = ([c.contiguous() for c in xs] for xs in (qs, ks, vs))
    states = [None] * n
    for r in range(n):
        for i in range(n):
            j = (r - i) % n
            states[r] = _ring_fwd_step(qs[r], ks[j], vs[j], j, r, causal,
                                       states[r])
    outs = [o.to(q.dtype) for o, _ in states]
    out = torch.cat(outs, dim=1).reshape(q.shape)
    if do is None:
        return out
    dos = [c.contiguous() for c in _bh(do.to(q.dtype)).chunk(n, dim=1)]
    deltas = [_delta(d, o) for d, o in zip(dos, outs)]
    add = _add_abs if magnitudes else _add
    dq, dk, dv = [None] * n, [None] * n, [None] * n
    for i in range(n):
        for r in range(n):
            j = (r - i) % n
            dq[r], dk[j], dv[j] = _ring_bwd_step(
                qs[r], dos[r], states[r][1], deltas[r], ks[j], vs[j], j, r,
                causal, dq[r], dk[j], dv[j], add)
    return out, _loop_grads((dq, dk, dv), q, magnitudes)


def _loop_grads(blocks, q, magnitudes):
    """The loops' per-block (dq, dk, dv) as whole tensors: cast to q's
    dtype once, or kept fp32 for ``magnitudes``."""
    dt = torch.float32 if magnitudes else q.dtype
    return tuple(torch.cat([g.to(dt) for g in gs], dim=1).reshape(q.shape)
                 for gs in blocks)


def _ring_self(q, k, v, group, fn):
    """Whole-array wrapper: this rank's block in, every block out."""
    out = fn(_ScatterSeq.apply(q, group), _ScatterSeq.apply(k, group),
             _ScatterSeq.apply(v, group))
    return _GatherSeq.apply(out, group)


def ring_self_attention(mesh: Mesh, q, k, v, causal: bool = False,
                        axis_name: str = CONTEXT_AXIS, impl: str = "ring"):
    """Whole-array convenience: every rank passes the same q, k, v
    (B, H, T, D) with T divisible by the axis size; each runs ``impl`` —
    ``'ring'`` (einsum), ``'ring_flash'`` (kernels) or ``'ulysses'`` — on
    its block and returns the whole output, its gradients whole too."""
    fn = {"ring": ring_attention, "ring_flash": ring_flash_attention,
          "ulysses": ulysses_attention}[impl]
    group = mesh.group(axis_name)
    if group is None:
        return fn(q, k, v, None, causal)
    return _ring_self(q, k, v, group,
                      lambda a, b, c: fn(a, b, c, group, causal))


# --------------------------------------------------- zigzag (balanced) ring
#
# Device d holds the pair (chunk d, chunk 2n-1-d) of the 2n equal chunks:
# its low stripe sees d+1 chunks, its high stripe 2n-d, so every rank does
# 2n+1 half-stripe pairs per ring. Per step, of the four (q-stripe,
# kv-stripe) pairs one of (lo, lo)/(hi, hi) is live for s != d (both
# diagonals at s == d), (hi, lo) is always fully visible and (lo, hi)
# always hidden. Causal only.


def zigzag_indices(T: int, n: int) -> np.ndarray:
    """Gather indices putting a length-T sequence into the zigzag layout
    for an n-rank context axis: rank d's shard is [chunk d ; chunk
    2n-1-d] of the 2n equal chunks. Apply with ``x[..., idx, :]``; invert
    with ``np.argsort(idx)``."""
    if T % (2 * n):
        raise ValueError(
            f"zigzag layout needs T divisible by 2*axis_size; got T={T}, "
            f"n={n}")
    c = T // (2 * n)
    order = []
    for d in range(n):
        order.extend(range(d * c, (d + 1) * c))
        order.extend(range((2 * n - 1 - d) * c, (2 * n - d) * c))
    return np.asarray(order)


def _halves(x3):
    th = x3.shape[1] // 2
    return x3[:, :th].contiguous(), x3[:, th:].contiguous()


def _zz_rel(s: int, d: int):
    """The (lo, lo) and (hi, hi) pairs' masks for held chunk pair ``s`` on
    rank ``d``: True diagonal, False visible, None hidden."""
    if s == d:
        return True, True
    return (False, None) if s < d else (None, False)


def _zz_fwd_step(q_lo, q_hi, k3, v3, s: int, d: int, st_lo, st_hi):
    """Zigzag forward step: the held block ``s`` (both its stripes)
    against this rank's two query stripes."""
    k_lo, k_hi = _halves(k3)
    v_lo, v_hi = _halves(v3)
    lo, hi = _zz_rel(s, d)
    if lo is not None:
        st_lo = _merge(st_lo, _pair(q_lo, k_lo, v_lo, lo))
    if hi is not None:
        st_hi = _merge(st_hi, _pair(q_hi, k_hi, v_hi, hi))
    st_hi = _merge(st_hi, _pair(q_hi, k_lo, v_lo, False))   # always visible
    return st_lo, st_hi


def _zz_bwd_step(q_lo, q_hi, do_lo, do_hi, l_lo, l_hi, d_lo, d_hi, k3, v3,
                 s: int, d: int, dq_lo, dq_hi, dk, dv, add=_add):
    """Zigzag backward step: the held block's gradients into this rank's
    dq stripes and the block's travelling (dk, dv) sums."""
    k_lo, k_hi = _halves(k3)
    v_lo, v_hi = _halves(v3)
    th = k_lo.shape[1]
    dk_lo, dk_hi = (None, None) if dk is None else (dk[:, :th], dk[:, th:])
    dv_lo, dv_hi = (None, None) if dv is None else (dv[:, :th], dv[:, th:])
    lo, hi = _zz_rel(s, d)
    if lo is not None:
        a, b, c = _pair_grads3(q_lo, k_lo, v_lo, do_lo, l_lo, d_lo, lo)
        dq_lo, dk_lo, dv_lo = add(dq_lo, a), add(dk_lo, b), add(dv_lo, c)
    if hi is not None:
        a, b, c = _pair_grads3(q_hi, k_hi, v_hi, do_hi, l_hi, d_hi, hi)
        dq_hi, dk_hi, dv_hi = add(dq_hi, a), add(dk_hi, b), add(dv_hi, c)
    a, b, c = _pair_grads3(q_hi, k_lo, v_lo, do_hi, l_hi, d_hi, False)
    dq_hi, dk_lo, dv_lo = add(dq_hi, a), add(dk_lo, b), add(dv_lo, c)
    # a block's first step is on its owner (s == d), where both stripes
    # are live, so both halves of its sums exist from then on
    return (dq_lo, dq_hi, torch.cat([dk_lo, dk_hi], dim=1),
            torch.cat([dv_lo, dv_hi], dim=1))


def _zz_fwd(q3, k3, v3, group):
    n, d, _ = _ring(group)
    q_lo, q_hi = _halves(q3)
    st_lo = st_hi = None
    for i in range(n):
        if i:
            k3, v3 = _rotate((k3, v3), group)
        st_lo, st_hi = _zz_fwd_step(q_lo, q_hi, k3, v3, (d - i) % n, d,
                                    st_lo, st_hi)
    return st_lo, st_hi


def _zz_bwd(q3, k3, v3, do3, out3, l_lo, l_hi, group):
    n, d, _ = _ring(group)
    q_lo, q_hi = _halves(q3)
    do_lo, do_hi = _halves(do3)
    o_lo, o_hi = _halves(out3)
    d_lo, d_hi = _delta(do_lo, o_lo), _delta(do_hi, o_hi)
    dq_lo = dq_hi = dk = dv = None
    for i in range(n):
        if i:
            k3, v3, dk, dv = _rotate((k3, v3, dk, dv), group)
        dq_lo, dq_hi, dk, dv = _zz_bwd_step(
            q_lo, q_hi, do_lo, do_hi, l_lo, l_hi, d_lo, d_hi, k3, v3,
            (d - i) % n, d, dq_lo, dq_hi, dk, dv)
    if n > 1:
        dk, dv = _rotate((dk, dv), group)
    return torch.cat([dq_lo, dq_hi], dim=1), dk, dv


class _ZigzagRing(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, group):
        (o_lo, l_lo), (o_hi, l_hi) = _zz_fwd(_bh(q), _bh(k), _bh(v), group)
        out = torch.cat([o_lo, o_hi], dim=1).to(q.dtype).reshape(q.shape)
        ctx.save_for_backward(q, k, v, out, l_lo, l_hi)
        ctx.group = group
        return out

    @staticmethod
    @_first_order_only
    def backward(ctx, g):
        q, k, v, out, l_lo, l_hi = ctx.saved_tensors
        dq, dk, dv = _zz_bwd(_bh(q), _bh(k), _bh(v), _bh(g.to(q.dtype)),
                             _bh(out), l_lo, l_hi, ctx.group)
        return (dq.to(q.dtype).reshape(q.shape),
                dk.to(k.dtype).reshape(k.shape),
                dv.to(v.dtype).reshape(v.shape), None)


def zigzag_ring_flash_attention(q, k, v, group=None):
    """Load-balanced CAUSAL ring attention: this rank's (B, H, T_local, D)
    shards in the zigzag layout (:func:`zigzag_indices`; or use
    :func:`zigzag_ring_self_attention`, which permutes). Per-pair compute
    is the streamed kernels with the second-ring-pass backward of
    :func:`ring_flash_attention`; every rank does 2n+1 half-shard pairs a
    pass. First-order autograd only."""
    if _ak._HIGHER_ORDER:
        raise NotImplementedError(
            "zigzag ring is first-order only; under higher_order_attention()"
            " use zigzag_ring_self_attention (which falls back to the exact"
            " reference) or the einsum ring on a contiguous layout")
    return _ZigzagRing.apply(q, k, v, group)


def zigzag_ring_flash_loop(q, k, v, n: int, do=None,
                           magnitudes: bool = False):
    """:func:`zigzag_ring_flash_attention` for ``n`` virtual ranks in one
    process: q, k, v whole (B, H, T, D) in the zigzag layout, rank r
    holding block r of n. As :func:`ring_flash_loop` (``magnitudes``
    too): the same step functions in the ring's order, bit for bit the
    distributed ring."""
    qs, ks, vs = ([c.contiguous() for c in _bh(x).chunk(n, dim=1)]
                  for x in (q, k, v))
    halves = [_halves(x) for x in qs]
    states = [(None, None)] * n
    for r in range(n):
        for i in range(n):
            j = (r - i) % n
            states[r] = _zz_fwd_step(*halves[r], ks[j], vs[j], j, r,
                                     *states[r])
    outs = [torch.cat([lo[0], hi[0]], dim=1).to(q.dtype)
            for lo, hi in states]
    out = torch.cat(outs, dim=1).reshape(q.shape)
    if do is None:
        return out
    dos = [_halves(c.contiguous())
           for c in _bh(do.to(q.dtype)).chunk(n, dim=1)]
    dels = [tuple(_delta(a, b) for a, b in zip(dh, _halves(o)))
            for dh, o in zip(dos, outs)]
    add = _add_abs if magnitudes else _add
    dq = [(None, None)] * n
    dk, dv = [None] * n, [None] * n
    for i in range(n):
        for r in range(n):
            j = (r - i) % n
            lo, hi = states[r]
            a, b, dk[j], dv[j] = _zz_bwd_step(
                *halves[r], *dos[r], lo[1], hi[1], *dels[r], ks[j], vs[j],
                j, r, *dq[r], dk[j], dv[j], add)
            dq[r] = (a, b)
    dq = [torch.cat(p, dim=1) for p in dq]
    return out, _loop_grads((dq, dk, dv), q, magnitudes)


def zigzag_ring_self_attention(mesh: Mesh, q, k, v,
                               axis_name: str = CONTEXT_AXIS):
    """Whole-array convenience for the balanced causal ring: permutes the
    sequence into the zigzag layout, runs each rank's shard, gathers and
    inverse-permutes. q/k/v (B, H, T, D), T divisible by 2 * axis size.
    Under ``higher_order_attention()`` it is the einsum ring on the
    contiguous layout (still sequence-parallel, any order)."""
    if _ak._HIGHER_ORDER:
        return ring_self_attention(mesh, q, k, v, causal=True,
                                   axis_name=axis_name, impl="ring")
    n = mesh.axis_size(axis_name)
    idx_np = zigzag_indices(q.shape[2], n)
    idx = torch.as_tensor(idx_np, device=q.device)
    inv = torch.as_tensor(np.argsort(idx_np), device=q.device)
    group = mesh.group(axis_name)
    qz, kz, vz = (x[:, :, idx] for x in (q, k, v))
    if group is None:
        out = zigzag_ring_flash_attention(qz, kz, vz, None)
    else:
        out = _ring_self(qz, kz, vz, group,
                         lambda a, b, c: zigzag_ring_flash_attention(
                             a, b, c, group))
    return out[:, :, inv]


def reference_attention(q, k, v, causal: bool = False):
    """Single-device full attention — the numerics oracle for SP tests."""
    D = q.shape[-1]
    s = torch.einsum("bhqd,bhkd->bhqk", q, k) / math.sqrt(D)
    if causal:
        T = q.shape[2]
        mask = torch.ones(T, T, dtype=torch.bool, device=q.device).tril()
        s = s.masked_fill(~mask, -math.inf)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, v)
