"""The port's attention kernels, written by hand in CUDA C++ for sm_90a
(``ops/csrc/``), each beside its plain PyTorch version.

- :func:`mha_attention_packed` — packed-layout multi-head attention
  (B, T, H*D), forward :func:`mha_packed_forward` and backward
  :func:`mha_packed_backward` (counterparts: ``mha_attention_packed``,
  ``_mha_packed_forward`` and ``_mha_packed_bwd_rule`` in
  ``deeplearning4j_tpu/ops/pallas_kernels.py``): the prefill attention of
  the causal LM and the training attention at T <= 1024.
  :func:`mha_attention` is its (B, H, T, D) / (BH, T, D) form.
- :func:`flash_attention` — streamed attention on (BH, T, D) or
  (B, H, T, D), forward :func:`flash_forward` and backward passes
  :func:`flash_bwd_dq` and :func:`flash_bwd_dkv` (counterparts:
  ``flash_attention``, ``_flash_forward``, ``_launch_bwd_dq``,
  ``_launch_bwd_dkv``): ``attention_impl="flash"`` at longer T.
- :func:`paged_decode_attention` — fused paged decode attention over the
  shared KV block pool (counterpart: ``paged_decode_attention``), the
  decode attention of the ``"fused"`` route.

The kernels take every head dim from 1 to 128 (:func:`kernel_head_dim_ok`),
forward and backward, fp32 and bf16; bf16 at 64 runs on the tensor cores.

A wrapper takes the plain version only for tensors on the CPU; a CUDA
tensor launches the kernel or raises. Each wrapper counts its kernel
launches in a plain integer attribute so a run can show that its main
path went through the kernels: ``mha_attention_packed.launches`` (the
packed forward), ``mha_packed_backward.launches``,
``flash_forward.launches``, ``flash_bwd_dq.launches``,
``flash_bwd_dkv.launches`` and ``paged_decode_attention.launches``. One
count of ``mha_packed_backward`` is one C call that makes two CUDA
launches (the dq pass, then the dk/dv pass); one of
``paged_decode_attention`` is the split pass and, where the table spans
more than one split, the merge.

Autograd: :func:`mha_attention_packed`, :func:`mha_attention` and
:func:`flash_attention` are ``torch.autograd.Function``\\ s whose
backward is the kernel. Like the JAX package's custom-VJP kernels they
are first-order only; inside :func:`higher_order_attention` they take the
plain differentiable path instead.
"""
from __future__ import annotations

import contextlib
import ctypes
from typing import Optional, Tuple

import torch

from deeplearning4j_tpu_torch.ops._launch import (
    first_order_only, launch as _launch, route as _route,
    stream_ptr as _stream_ptr)

_NEG_INF = -1e30
_Q_CODES = {torch.float32: 0, torch.bfloat16: 1}
_KV_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
# the widest head the kernels take: their FMA templates are built for
# padded widths 16, 32, 64 and 128 and stage a tile of keys at that width in
# shared memory (a shared-memory limit, not a semantic one)
MAX_KERNEL_HEAD_DIM = 128


def kernel_head_dim_ok(d: int) -> bool:
    """True for the head dims the attention kernels run, forward and
    backward, fp32 and bf16: every ``1 <= d <= 128``. The JAX package's
    packed route asserts only that the packed width divides by the heads,
    so this takes every head dim it takes up to the limit."""
    return 1 <= d <= MAX_KERNEL_HEAD_DIM


def _check_kernel_operands(name: str, d: int, *tensors,
                           limit: int = MAX_KERNEL_HEAD_DIM):
    if not 1 <= d <= limit:
        raise ValueError(f"{name} kernel takes head_dim from 1 to {limit}, "
                         f"got {d}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name} needs contiguous operands")


# ------------------------------------------ higher-order autodiff escape


_HIGHER_ORDER = False

_FIRST_ORDER_MSG = (
    "double backward through the attention kernels is unsupported — their "
    "autograd backward is first-order only. Wrap the computation in "
    "deeplearning4j_tpu_torch.ops.attention_kernels.higher_order_attention() "
    "to route attention to the fully differentiable plain PyTorch path.")


@contextlib.contextmanager
def higher_order_attention():
    """Context manager: route :func:`flash_attention`,
    :func:`mha_attention_packed` and :func:`mha_attention` to the fully
    differentiable plain PyTorch attention, so a double backward
    (Hessian-vector products, influence functions) works. Outside it the
    kernels' autograd Functions are used and a double backward raises.
    The flag is read when attention is called (PyTorch runs eagerly)."""
    global _HIGHER_ORDER
    prev = _HIGHER_ORDER
    _HIGHER_ORDER = True
    try:
        yield
    finally:
        _HIGHER_ORDER = prev


_first_order_only = first_order_only(_FIRST_ORDER_MSG)


def _attention_reference(q, k, v, causal: bool, scale: Optional[float]):
    """Plain attention on (..., T, D), differentiable to any order: fp32
    scores and softmax, output in q's dtype (``_attention_reference``)."""
    d = q.shape[-1]
    sc = scale if scale is not None else 1.0 / (d ** 0.5)
    s = torch.einsum("...qd,...kd->...qk", q.float(), k.float()) * sc
    if causal:
        t = q.shape[-2]
        mask = torch.ones(t, t, dtype=torch.bool, device=q.device).tril()
        s = s.masked_fill(~mask, _NEG_INF)
    w = torch.softmax(s, dim=-1)
    return torch.einsum("...qk,...kd->...qd", w, v.float()).to(q.dtype)


def _packed_reference(q, k, v, heads: int, causal: bool,
                      scale: Optional[float]):
    """:func:`_attention_reference` on the packed (B, T, H*D) layout — the
    :func:`higher_order_attention` route of the packed kernel."""
    b, t, hd = q.shape
    d = hd // heads

    def hsplit(x):
        return x.reshape(b, t, heads, d).transpose(1, 2)

    o = _attention_reference(hsplit(q), hsplit(k), hsplit(v), causal, scale)
    return o.transpose(1, 2).reshape(b, t, hd)


# ----------------------------------------------------------- plain versions


def _split_heads(x, heads: int):
    b, t, hd = x.shape
    return x.reshape(b, t, heads, hd // heads).transpose(1, 2).float()


def _merge_heads(x, dtype):
    b, h, t, d = x.shape
    return x.transpose(1, 2).reshape(b, t, h * d).to(dtype)


def _scores(qs, k, heads: int, causal: bool):
    """fp32 scores of the pre-scaled q against k, (B, H, T, T), the causal
    mask at -1e30."""
    s = torch.matmul(_split_heads(qs, heads),
                     _split_heads(k, heads).transpose(-1, -2))
    if causal:
        t = s.shape[-1]
        mask = torch.ones(t, t, dtype=torch.bool, device=s.device).tril()
        s = s.masked_fill(~mask, _NEG_INF)
    return s


def _forward_plain(q, k, v, heads: int, causal: bool, sc: float, p_dtype,
                   floor_l: bool):
    qs = (q.float() * sc).to(q.dtype)
    s = _scores(qs, k, heads, causal)
    m = s.amax(-1, keepdim=True)
    p = torch.exp((s - m).to(p_dtype))
    l = p.float().sum(-1, keepdim=True)
    if floor_l:
        l = l.clamp_min(1e-30)
    o = torch.matmul(p.to(q.dtype).float(), _split_heads(v, heads)) / l
    return _merge_heads(o, q.dtype), (m + torch.log(l))[..., 0]


def _backward_plain(q, k, v, do, lse, delta, heads: int, causal: bool,
                    sc: float, p_dtype, want=("dq", "dk", "dv")):
    """The backward kernels' arithmetic with lse (B, H, T); ``delta`` None
    takes it over the whole row from p in ``p_dtype`` (the packed
    kernel), else it is the caller's (B, H, T) rowsum(dO * O) (the
    streamed passes). Returns the gradients named in ``want``."""
    qs = (q.float() * sc).to(q.dtype)
    s = _scores(qs, k, heads, causal)
    p = torch.exp((s - lse[..., None]).to(p_dtype))
    pb = p.to(q.dtype)
    dos = _split_heads(do, heads)
    dp = torch.matmul(dos, _split_heads(v, heads).transpose(-1, -2))
    if delta is None:
        delta = (p.float() * dp).sum(-1)
    if p_dtype == torch.float32:
        ds = (p * (dp - delta[..., None])).to(q.dtype)
    else:
        ds = pb * (dp - delta[..., None]).to(q.dtype)
    out = {}
    if "dq" in want:
        out["dq"] = _merge_heads(
            torch.matmul(ds.float(), _split_heads(k, heads)) * sc, q.dtype)
    if "dk" in want:
        out["dk"] = _merge_heads(torch.matmul(ds.float().transpose(-1, -2),
                                              _split_heads(qs, heads)),
                                 q.dtype)
    if "dv" in want:
        out["dv"] = _merge_heads(torch.matmul(pb.float().transpose(-1, -2),
                                              dos), q.dtype)
    return tuple(out[n] for n in want)


# ---------------------------------------------- packed attention (rows 1, 2)


def packed_kernel_shape_ok(t: int) -> bool:
    """The routing envelope of the packed kernel, kept identical to the
    JAX package's (T % 8 == 0 and T <= 1024) so both packages route the
    same sequence lengths to it. The CUDA kernels stream K/V and have no
    length limit of their own."""
    return t % 8 == 0 and t <= 1024


def mha_packed_forward_reference(q, k, v, heads: int, causal: bool = False,
                                 scale: Optional[float] = None,
                                 p_dtype: torch.dtype = torch.float32
                                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the packed forward kernel: exactly the arithmetic
    of ``_mha_packed_fwd_kernel`` — scale folded into q and rounded back
    to q's dtype, fp32 scores, causal mask at -1e30, whole-row max,
    ``p = exp((s - m).to(p_dtype))``, fp32 row sum, P.V with p in q's
    dtype. Returns ``(o (B, T, H*D) in q's dtype, lse (B, H, T) fp32)``."""
    d = q.shape[-1] // heads
    sc = scale if scale is not None else 1.0 / (d ** 0.5)
    return _forward_plain(q, k, v, heads, causal, sc, p_dtype, False)


def mha_packed_backward_reference(q, k, v, do, lse, heads: int,
                                  causal: bool = False,
                                  scale: Optional[float] = None,
                                  p_dtype: torch.dtype = torch.float32):
    """Plain version of the packed backward kernel: exactly the arithmetic
    of ``_mha_packed_bwd_kernel`` — ``qs = (q * scale)`` in q's dtype, fp32
    scores, ``p = exp((s - lse).to(p_dtype))``, ``pb = p.to(q.dtype)``,
    ``dv = pb^T dO``, ``dp = dO v^T``, ``delta = sum(p * dp)`` over the
    whole row, ``ds = (p (dp - delta))`` in q's dtype (``pb * (dp -
    delta)`` for bf16 p), ``dq = (ds k) scale``, ``dk = ds^T qs``.
    Returns ``(dq, dk, dv)`` in q's dtype."""
    d = q.shape[-1] // heads
    sc = scale if scale is not None else 1.0 / (d ** 0.5)
    return _backward_plain(q, k, v, do, lse, None, heads, causal, sc,
                           p_dtype)


def _check_packed(q, k, v, heads: int, p_dtype):
    if q.dim() != 3 or q.shape != k.shape or q.shape != v.shape:
        raise ValueError(f"q, k, v must share one (B, T, H*D) shape, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    if q.dtype not in _Q_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k, v must share a float32 or bfloat16 dtype, "
                        f"got {q.dtype}, {k.dtype}, {v.dtype}")
    if heads <= 0 or q.shape[-1] % heads:
        raise ValueError(f"packed width {q.shape[-1]} is not a multiple of "
                         f"heads={heads}")
    if p_dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"p_dtype must be float32 or bfloat16, got {p_dtype}")


def mha_packed_forward(q, k, v, heads: int, causal: bool = False,
                       scale: Optional[float] = None,
                       p_dtype: torch.dtype = torch.float32
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Packed attention forward ``(o, lse)`` — the counterpart of
    ``_mha_packed_forward``: q, k, v (B, T, H*D) in fp32 or bf16, o in
    q's dtype, lse (B, H, T) fp32 (the backward reads it). CPU tensors
    take :func:`mha_packed_forward_reference`."""
    _check_packed(q, k, v, heads, p_dtype)
    b, t, hd = q.shape
    d = hd // heads
    sc = scale if scale is not None else 1.0 / (d ** 0.5)
    if _route(q, k, v) == "cpu":
        return mha_packed_forward_reference(q, k, v, heads, causal, sc,
                                            p_dtype)
    _check_kernel_operands("mha_packed_fwd", d, q, k, v)
    p = ctypes.c_void_p
    i = ctypes.c_int
    o = torch.empty_like(q)
    lse = torch.empty((b, heads, t), dtype=torch.float32, device=q.device)
    _launch("mha_packed_fwd", "mha_packed_fwd",
            [p, p, p, p, p, i, i, i, i, ctypes.c_float, i, i, i, p],
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse.data_ptr(), b, t, heads, d, float(sc), int(bool(causal)),
            int(p_dtype == torch.bfloat16), _Q_CODES[q.dtype],
            _stream_ptr(q.device))
    mha_attention_packed.launches += 1
    return o, lse


def mha_packed_backward(q, k, v, do, lse, heads: int, causal: bool = False,
                        scale: Optional[float] = None,
                        p_dtype: torch.dtype = torch.float32):
    """Packed attention backward ``(dq, dk, dv)`` — the counterpart of
    ``_mha_packed_bwd_rule``: q, k, v, do (B, T, H*D) in one dtype, lse
    (B, H, T) fp32 from the forward; delta is taken inside the kernel.
    CPU tensors take :func:`mha_packed_backward_reference`. On the card
    one call is two launches (dq pass, dk/dv pass) and one count."""
    _check_packed(q, k, v, heads, p_dtype)
    b, t, hd = q.shape
    d = hd // heads
    if do.shape != q.shape or do.dtype != q.dtype:
        raise ValueError(f"do must match q: {tuple(do.shape)} {do.dtype}")
    if lse.shape != (b, heads, t) or lse.dtype != torch.float32:
        raise ValueError(f"lse must be ({b}, {heads}, {t}) float32, got "
                         f"{tuple(lse.shape)} {lse.dtype}")
    sc = scale if scale is not None else 1.0 / (d ** 0.5)
    if _route(q, k, v, do, lse) == "cpu":
        return mha_packed_backward_reference(q, k, v, do, lse, heads, causal,
                                             sc, p_dtype)
    _check_kernel_operands("mha_packed_bwd", d, q, k, v, do, lse)
    p = ctypes.c_void_p
    i = ctypes.c_int
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    delta = torch.empty((b, heads, t), dtype=torch.float32, device=q.device)
    _launch("attention_bwd", "mha_packed_bwd",
            [p] * 9 + [i] * 4 + [ctypes.c_float, i, i, i, p],
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), b, t, heads, d, float(sc), int(bool(causal)),
            int(p_dtype == torch.bfloat16), _Q_CODES[q.dtype],
            _stream_ptr(q.device))
    mha_packed_backward.launches += 1
    return dq, dk, dv


mha_packed_backward.launches = 0


class _MhaPacked(torch.autograd.Function):
    """Forward: the packed forward kernel, saving q, k, v and lse.
    Backward: the packed backward kernel. First-order only."""

    @staticmethod
    def forward(ctx, q, k, v, heads, causal, scale, p_dtype):
        o, lse = mha_packed_forward(q, k, v, heads, causal, scale, p_dtype)
        ctx.save_for_backward(q, k, v, lse)
        ctx.args = (heads, causal, scale, p_dtype)
        return o

    @staticmethod
    @_first_order_only
    def backward(ctx, g):
        q, k, v, lse = ctx.saved_tensors
        do = g.to(q.dtype).contiguous()
        dq, dk, dv = mha_packed_backward(q, k, v, do, lse, *ctx.args)
        return dq, dk, dv, None, None, None, None


def mha_attention_packed(q, k, v, heads: int, causal: bool = False,
                         scale: Optional[float] = None,
                         p_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Attention on the packed projection layout (B, T, heads*head_dim):
    no (B, H, T, D) transpose is made and the (T, T) scores never reach
    device memory, forward or backward. ``p_dtype`` is the softmax
    probability dtype (fp32 exact; bf16 rounds p before the row sum and
    P.V, and the backward rebuilds p as exp_bf16(s - lse): within the JAX
    package's 5e-2 bound of the function the forward ran). First-order
    autograd only — see :func:`higher_order_attention`."""
    if _HIGHER_ORDER:
        return _packed_reference(q, k, v, heads, causal, scale)
    return _MhaPacked.apply(q, k, v, heads, causal, scale, p_dtype)


mha_attention_packed.launches = 0


def mha_attention(q, k, v, causal: bool = False,
                  scale: Optional[float] = None,
                  p_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """:func:`mha_attention_packed` for (B, H, T, D) or (BH, T, D)
    layouts, one head per row of the batch (the packed layout with
    ``heads=1``)."""
    shape = q.shape
    if q.dim() == 4:
        b, h, t, d = shape
        q, k, v = (x.reshape(b * h, t, d) for x in (q, k, v))
    o = mha_attention_packed(q.contiguous(), k.contiguous(), v.contiguous(),
                             1, causal, scale, p_dtype)
    return o.reshape(shape)


# ---------------------------------------- streamed attention (rows 3, 4, 5)


def auto_flash_block(t: int) -> int:
    """Largest divisor of t of the form min(512, t)/2^k, falling back to t
    itself (one whole-T block) for lengths with no power-of-2 structure
    — the JAX package's block rule, copied so both packages route and
    validate the same T. The CUDA kernels tile at their own size; the
    block only decides routing and validation here."""
    blk = min(512, t)
    while blk > 8 and t % blk:
        blk //= 2
    return blk if blk and t % blk == 0 else t


def flash_envelope_ok(t: int) -> bool:
    """True when ``auto_flash_block(t)`` is 8-aligned and at most 1024:
    the streamed route's envelope, as in the JAX package."""
    blk = auto_flash_block(t)
    return blk % 8 == 0 and blk <= 1024


def _resolve_flash_blocks(t: int, block_q, block_k):
    """None -> :func:`auto_flash_block`, raising where that degenerates to
    a whole-T block beyond 1024; explicit blocks are clipped to T. The
    JAX package's rule, so both raise on the same inputs."""
    bq = auto_flash_block(t) if block_q is None else min(block_q, t)
    bk = auto_flash_block(t) if block_k is None else min(block_k, t)
    if (block_q is None and bq > 1024) or (block_k is None and bk > 1024):
        raise ValueError(
            f"flash_attention: T={t} has no power-of-2 block structure, so "
            "the auto block degenerates to a whole-T score tile that "
            "cannot fit VMEM; pass explicit block_q/block_k dividing T, "
            "pad the sequence, or use reference attention")
    return bq, bk


def _check_streamed(name: str, q, *others):
    """q and ``others`` (k, v, and do for the backward) must share one
    (BH, T, D) shape and a float32 or bfloat16 dtype."""
    if q.dim() != 3 or any(x.shape != q.shape for x in others):
        raise ValueError(f"{name}: q, k, v (and do) must share one "
                         f"(BH, T, D) shape, got "
                         f"{[tuple(x.shape) for x in (q, *others)]}")
    if q.dtype not in _Q_CODES or any(x.dtype != q.dtype for x in others):
        raise TypeError(f"{name}: q, k, v (and do) must share a float32 or "
                        f"bfloat16 dtype, got "
                        f"{[x.dtype for x in (q, *others)]}")


def _streamed_setup(q, k, v, block_q, block_k, scale):
    """Validate (BH, T, D) operands and the blocks; returns the scale."""
    _check_streamed("flash_attention", q, k, v)
    t, d = q.shape[1:]
    bq, bk = _resolve_flash_blocks(t, block_q, block_k)
    if t % bq or t % bk:
        raise ValueError(f"flash_attention: T={t} is not a multiple of the "
                         f"blocks ({bq}, {bk})")
    return scale if scale is not None else 1.0 / (d ** 0.5)


def _check_vec(name, x, bh, t):
    if x.shape != (bh, 1, t) or x.dtype != torch.float32:
        raise ValueError(f"{name} must be ({bh}, 1, {t}) float32, got "
                         f"{tuple(x.shape)} {x.dtype}")


def flash_forward_reference(q, k, v, causal: bool = False,
                            scale: Optional[float] = None):
    """Plain version of the streamed forward kernel on (BH, T, D): the
    packed forward's arithmetic with one head and fp32 p, plus the floor
    ``l = max(l, 1e-30)`` of ``_flash_kernel``. Returns ``(o, lse (BH, 1,
    T) fp32)``."""
    sc = scale if scale is not None else 1.0 / (q.shape[-1] ** 0.5)
    return _forward_plain(q, k, v, 1, causal, sc, torch.float32, True)


def flash_forward(q, k, v, causal: bool = False, block_q=None, block_k=None,
                  scale: Optional[float] = None):
    """Streamed attention forward ``(o, lse)`` — the counterpart of
    ``_flash_forward``: q, k, v (BH, T, D) or (B, H, T, D) in fp32 or bf16,
    o in q's layout and dtype, lse (BH, 1, T) fp32. ``block_q``/``block_k``
    are validated as the JAX package validates them (T must divide by the
    resolved blocks); the CUDA kernel tiles at its own size, so its result
    differs from the TPU's 512-block order only by the reassociation of
    the running sums. CPU tensors take :func:`flash_forward_reference`."""
    shape = q.shape
    if q.dim() == 4:
        b, h, t, d = shape
        q, k, v = (x.reshape(b * h, t, d) for x in (q, k, v))
    sc = _streamed_setup(q, k, v, block_q, block_k, scale)
    bh, t, d = q.shape
    if _route(q, k, v) == "cpu":
        o, lse = flash_forward_reference(q, k, v, causal, sc)
        return o.reshape(shape), lse
    _check_kernel_operands("flash_fwd", d, q, k, v)
    p = ctypes.c_void_p
    i = ctypes.c_int
    o = torch.empty_like(q)
    lse = torch.empty((bh, 1, t), dtype=torch.float32, device=q.device)
    _launch("flash_fwd", "flash_fwd",
            [p] * 5 + [i] * 3 + [ctypes.c_float, i, i, p],
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse.data_ptr(), bh, t, d, float(sc), int(bool(causal)),
            _Q_CODES[q.dtype], _stream_ptr(q.device))
    flash_forward.launches += 1
    return o.reshape(shape), lse


flash_forward.launches = 0


def flash_bwd_dq_reference(q, k, v, do, lse, delta, causal: bool = False,
                           scale: Optional[float] = None):
    """Plain version of the streamed dq pass on (BH, T, D), lse and delta
    (BH, 1, T) in the global softmax frame: ``p = exp(s - lse)`` in fp32,
    ``ds = p (dp - delta)`` in q's dtype, ``dq = scale (ds k)``."""
    sc = scale if scale is not None else 1.0 / (q.shape[-1] ** 0.5)
    return _backward_plain(q, k, v, do, lse, delta, 1, causal, sc,
                           torch.float32, ("dq",))[0]


def flash_bwd_dkv_reference(q, k, v, do, lse, delta, causal: bool = False,
                            scale: Optional[float] = None):
    """Plain version of the streamed dk/dv pass: ``dv = p^T dO`` with p in
    dO's dtype, ``dk = ds^T (scale q)``. Returns ``(dk, dv)``."""
    sc = scale if scale is not None else 1.0 / (q.shape[-1] ** 0.5)
    return _backward_plain(q, k, v, do, lse, delta, 1, causal, sc,
                           torch.float32, ("dk", "dv"))


def _check_bwd(name, q, k, v, do, lse, delta):
    _check_streamed(name, q, k, v, do)
    bh, t, _ = q.shape
    _check_vec("lse", lse, bh, t)
    _check_vec("delta", delta, bh, t)


def flash_bwd_dq(q, k, v, do, lse, delta, causal: bool = False,
                 scale: Optional[float] = None):
    """The streamed dq pass — counterpart of ``_launch_bwd_dq``: (BH, T, D)
    operands, lse and delta (BH, 1, T) fp32 in the global softmax frame,
    so a sequence-parallel caller can reuse it per (q-shard, k/v-shard)
    pair. CPU tensors take :func:`flash_bwd_dq_reference`."""
    _check_bwd("flash_bwd_dq", q, k, v, do, lse, delta)
    bh, t, d = q.shape
    sc = scale if scale is not None else 1.0 / (d ** 0.5)
    if _route(q, k, v, do, lse, delta) == "cpu":
        return flash_bwd_dq_reference(q, k, v, do, lse, delta, causal, sc)
    _check_kernel_operands("flash_bwd_dq", d, q, k, v, do, lse, delta)
    p = ctypes.c_void_p
    i = ctypes.c_int
    dq = torch.empty_like(q)
    _launch("attention_bwd", "flash_bwd_dq",
            [p] * 7 + [i] * 3 + [ctypes.c_float, i, i, p],
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), bh, t, d,
            float(sc), int(bool(causal)), _Q_CODES[q.dtype],
            _stream_ptr(q.device))
    flash_bwd_dq.launches += 1
    return dq


flash_bwd_dq.launches = 0


def flash_bwd_dkv(q, k, v, do, lse, delta, causal: bool = False,
                  scale: Optional[float] = None):
    """The streamed dk/dv pass — counterpart of ``_launch_bwd_dkv``; same
    operands as :func:`flash_bwd_dq`. Returns ``(dk, dv)``. CPU tensors
    take :func:`flash_bwd_dkv_reference`."""
    _check_bwd("flash_bwd_dkv", q, k, v, do, lse, delta)
    bh, t, d = q.shape
    sc = scale if scale is not None else 1.0 / (d ** 0.5)
    if _route(q, k, v, do, lse, delta) == "cpu":
        return flash_bwd_dkv_reference(q, k, v, do, lse, delta, causal, sc)
    _check_kernel_operands("flash_bwd_dkv", d, q, k, v, do, lse, delta)
    p = ctypes.c_void_p
    i = ctypes.c_int
    dk, dv = torch.empty_like(q), torch.empty_like(q)
    _launch("attention_bwd", "flash_bwd_dkv",
            [p] * 8 + [i] * 3 + [ctypes.c_float, i, i, p],
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            bh, t, d, float(sc), int(bool(causal)), _Q_CODES[q.dtype],
            _stream_ptr(q.device))
    flash_bwd_dkv.launches += 1
    return dk, dv


flash_bwd_dkv.launches = 0


class _FlashAttention(torch.autograd.Function):
    """Forward: the streamed forward kernel, saving q, k, v, o and lse.
    Backward: delta = rowsum(dO * O) in plain PyTorch (the JAX package
    takes it in XLA, outside Pallas), then the dq and dk/dv kernels.
    First-order only."""

    @staticmethod
    def forward(ctx, q, k, v, causal, block_q, block_k, scale):
        o, lse = flash_forward(q, k, v, causal, block_q, block_k, scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.args = (causal, block_q, block_k, scale)
        return o

    @staticmethod
    @_first_order_only
    def backward(ctx, g):
        q, k, v, o, lse = ctx.saved_tensors
        causal, block_q, block_k, scale = ctx.args
        shape = q.shape
        bh, t = lse.shape[0], lse.shape[2]
        q, k, v, o, g = (x.reshape(bh, t, shape[-1]).contiguous()
                         for x in (q, k, v, o, g))
        sc = _streamed_setup(q, k, v, block_q, block_k, scale)
        do = g.to(q.dtype)
        delta = (do.float() * o.float()).sum(-1).reshape(bh, 1, t)
        dq = flash_bwd_dq(q, k, v, do, lse, delta, causal, sc)
        dk, dv = flash_bwd_dkv(q, k, v, do, lse, delta, causal, sc)
        return (dq.reshape(shape), dk.reshape(shape), dv.reshape(shape),
                None, None, None, None)


def flash_attention(q, k, v, causal: bool = False, block_q=None,
                    block_k=None, scale: Optional[float] = None):
    """(B, H, T, D) or (BH, T, D) attention through the streamed kernels,
    forward and backward: O(T) memory in both directions. T must divide
    by the resolved blocks (:func:`auto_flash_block` for None).
    First-order autograd only — see :func:`higher_order_attention`."""
    if _HIGHER_ORDER:
        return _attention_reference(q, k, v, causal, scale)
    return _FlashAttention.apply(q, k, v, causal, block_q, block_k, scale)


# --------------------------------------------------- paged decode attention


def paged_decode_attention_reference(q, k_pool, v_pool, tables, pos, *,
                                     block_size: int,
                                     scale: Optional[float] = None,
                                     k_scale=None, v_scale=None):
    """Plain version of the paged kernel, mirroring the JAX package's
    gather reference: materialize ``pool[tables]`` as (S, L, H, D),
    dequantize int8 by its scales, mask positions past ``pos`` at -1e30,
    fp32 softmax, output in q's dtype. A table entry outside [0, NB) is
    read as that gather reads it: a negative id counts from the end, then
    the id is clamped into [0, NB)."""
    S, H, D = q.shape
    NB = k_pool.shape[0]
    L = tables.shape[1] * block_size
    sc = scale if scale is not None else 1.0 / (D ** 0.5)
    tl = tables.long()
    tl = torch.where(tl < 0, tl + NB, tl).clamp(0, NB - 1)
    gk = k_pool[tl].reshape(S, L, H, D).float()
    gv = v_pool[tl].reshape(S, L, H, D).float()
    if k_scale is not None:
        gk = gk * k_scale[tl].reshape(S, L, H)[..., None]
        gv = gv * v_scale[tl].reshape(S, L, H)[..., None]
    s = torch.einsum("shd,slhd->shl", q.float(), gk) * sc
    mask = torch.arange(L, device=q.device)[None, :] <= pos.long()[:, None]
    s = torch.where(mask[:, None, :], s, torch.full_like(s, _NEG_INF))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("shl,slhd->shd", p, gv).to(q.dtype)


# positions one CTA of the paged kernel takes (whole blocks, at least one)
PAGED_SPLIT_POSITIONS = 64
# the paged kernel's widest head (its widest instance holds a 1024-dim row
# in registers across a warp)
PAGED_MAX_HEAD_DIM = 1024
# the kernel stages a split's block-table entries in shared memory
_PAGED_MAX_SPLIT_BLOCKS = 64


def paged_decode_plan(nbmax: int, block_size: int) -> Tuple[int, int]:
    """``(blocks_per_split, n_splits)`` of the paged kernel: the table's
    ``nbmax * block_size`` positions cut into splits of whole blocks,
    :data:`PAGED_SPLIT_POSITIONS` positions each (one block where a block
    is longer). It reads only the table's width and the block size, never
    ``pos``, so a call needs no host sync and replays in a CUDA graph; a
    split past a slot's ``pos`` exits on the card. One split skips the
    merge launch."""
    if nbmax < 0 or block_size < 1:
        raise ValueError(f"nbmax {nbmax} and block_size {block_size}")
    per = max(1, min(PAGED_SPLIT_POSITIONS // block_size,
                     _PAGED_MAX_SPLIT_BLOCKS))
    return per, max(1, -(-nbmax // per))


def paged_decode_attention(q, k_pool, v_pool, tables, pos, *,
                           block_size: int, scale: Optional[float] = None,
                           k_scale=None, v_scale=None):
    """Fused paged decode attention: q (S, H, D) single-token queries,
    k_pool/v_pool (NB, B, H, D) shared block pools, tables (S, nbmax)
    int32 physical block ids, pos (S,) int32 per-slot write positions
    (the query attends to positions 0..pos inclusive). With
    ``k_scale``/``v_scale`` ((NB, B, H) fp32) the pools are int8 and
    dequantize in the same pass. Returns (S, H, D) in q's dtype. Dead
    slots' rows name scratch block 0 and give a finite row. CPU tensors
    take :func:`paged_decode_attention_reference`. On the card the
    positions split as :func:`paged_decode_plan` says (D up to 1024, any
    block size); one call is one count of ``launches``, whatever the
    CUDA launches inside (the split pass, then a merge where there is
    more than one split)."""
    S, H, D = q.shape
    NB, B = k_pool.shape[:2]
    if B != block_size:
        raise ValueError(f"pool block dim {B} != block_size {block_size}")
    if k_pool.shape != (NB, B, H, D) or v_pool.shape != k_pool.shape:
        raise ValueError(f"pools must be (NB, {block_size}, {H}, {D}), got "
                         f"{tuple(k_pool.shape)}, {tuple(v_pool.shape)}")
    quantized = k_scale is not None
    if quantized != (v_scale is not None):
        raise ValueError("k_scale and v_scale must be passed together")
    if quantized and (k_pool.dtype != torch.int8
                      or k_scale.shape != (NB, B, H)
                      or v_scale.shape != (NB, B, H)
                      or k_scale.dtype != torch.float32
                      or v_scale.dtype != torch.float32):
        raise ValueError("int8 pools take (NB, B, H) float32 scales")
    if k_pool.dtype == torch.int8 and not quantized:
        raise ValueError("an int8 pool needs k_scale and v_scale")
    if q.dtype not in _Q_CODES or k_pool.dtype not in _KV_CODES \
            or v_pool.dtype != k_pool.dtype:
        raise TypeError(f"unsupported dtypes q={q.dtype} "
                        f"pools={k_pool.dtype}/{v_pool.dtype}")
    if tables.dim() != 2 or tables.shape[0] != S or pos.shape != (S,):
        raise ValueError(f"tables must be ({S}, nbmax) and pos ({S},), got "
                         f"{tuple(tables.shape)}, {tuple(pos.shape)}")
    sc = scale if scale is not None else 1.0 / (D ** 0.5)
    if _route(q, k_pool, v_pool, tables, pos, k_scale, v_scale) == "cpu":
        return paged_decode_attention_reference(
            q, k_pool, v_pool, tables, pos, block_size=block_size, scale=sc,
            k_scale=k_scale, v_scale=v_scale)
    if tables.dtype != torch.int32 or pos.dtype != torch.int32:
        raise TypeError("tables and pos must be int32")
    operands = [q, k_pool, v_pool, tables, pos] + (
        [k_scale, v_scale] if quantized else [])
    _check_kernel_operands("paged_decode", D, *operands,
                           limit=PAGED_MAX_HEAD_DIM)
    o = torch.empty_like(q)
    if o.numel() == 0:
        return o
    nbmax = tables.shape[1]
    per, n_splits = paged_decode_plan(nbmax, B)
    # the splits' (m, l, acc[D]) partials, fp32
    ws = None if n_splits == 1 else torch.empty(
        S * H * n_splits * (D + 2), dtype=torch.float32, device=q.device)
    p = ctypes.c_void_p
    i = ctypes.c_int
    _launch("paged_decode", "paged_decode",
            [p] * 9 + [i] * 8 + [ctypes.c_float, i, i, p],
            q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
            k_scale.data_ptr() if quantized else None,
            v_scale.data_ptr() if quantized else None,
            tables.data_ptr(), pos.data_ptr(), o.data_ptr(),
            None if ws is None else ws.data_ptr(),
            S, H, D, NB, B, nbmax, per, n_splits, float(sc),
            _Q_CODES[q.dtype], _KV_CODES[k_pool.dtype], _stream_ptr(q.device))
    paged_decode_attention.launches += 1
    return o


paged_decode_attention.launches = 0
