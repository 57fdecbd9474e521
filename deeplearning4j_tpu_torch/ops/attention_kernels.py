"""The serving path's two attention kernels, written by hand in CUDA C++ for
sm_90a (``ops/csrc/``), each beside its plain PyTorch version.

- :func:`mha_attention_packed` / :func:`mha_packed_forward` — packed-layout
  multi-head attention forward (counterpart: ``mha_attention_packed`` and
  ``_mha_packed_forward`` in ``deeplearning4j_tpu/ops/pallas_kernels.py``),
  the prefill attention of the causal LM.
- :func:`paged_decode_attention` — fused paged decode attention over the
  shared KV block pool (counterpart: ``paged_decode_attention`` there),
  the decode attention of the ``"fused"`` route.

A wrapper takes the plain version only for tensors on the CPU; a CUDA
tensor launches the kernel or raises. Each wrapper counts its kernel
launches in a plain integer attribute (``mha_attention_packed.launches``,
``paged_decode_attention.launches``) so a run can show that its main path
went through the kernels. The plain versions mirror the JAX functions
they stand beside: the kernel-exact ``(o, lse)`` whole-row softmax of the
packed kernel and the gather reference of the paged kernel.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from deeplearning4j_tpu_torch.ops import _build

_NEG_INF = -1e30
_Q_CODES = {torch.float32: 0, torch.bfloat16: 1}
_KV_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
_PACKED_HEAD_DIMS = (16, 32, 64, 128)
_STATIC_SMEM_BYTES = 48 * 1024

_bound = {}


def _lib(name: str, argtypes) -> ctypes.CDLL:
    """Load kernel library ``name`` and declare its entry point once:
    every pointer and the stream as ``c_void_p`` (64-bit), never the
    ctypes default int."""
    lib = _bound.get(name)
    if lib is None:
        lib = _build.load(name)
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        err = getattr(lib, f"{name}_error_string")
        err.argtypes = [ctypes.c_int]
        err.restype = ctypes.c_char_p
        _bound[name] = lib
    return lib


def _check_rc(lib: ctypes.CDLL, name: str, rc: int):
    if rc != 0:
        msg = getattr(lib, f"{name}_error_string")(rc).decode()
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc} "
                           f"({msg})")


def _stream_ptr(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _route(*tensors: torch.Tensor) -> str:
    """'cpu' (plain version) or 'cuda' (kernel); anything else raises."""
    devs = {t.device for t in tensors if t is not None}
    if len(devs) != 1:
        raise ValueError(f"operands span devices {sorted(map(str, devs))}")
    dev = devs.pop()
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"no attention kernel for device {dev}")
    return dev.type


# ------------------------------------------------- packed attention forward


def packed_kernel_shape_ok(t: int) -> bool:
    """The routing envelope of the packed kernel, kept identical to the
    JAX package's (T % 8 == 0 and T <= 1024) so both packages route the
    same sequence lengths to it. The CUDA kernel streams K/V and has no
    length limit of its own."""
    return t % 8 == 0 and t <= 1024


def mha_packed_forward_reference(q, k, v, heads: int, causal: bool = False,
                                 scale: Optional[float] = None,
                                 p_dtype: torch.dtype = torch.float32
                                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the packed kernel: exactly the arithmetic of
    ``_mha_packed_fwd_kernel`` — scale folded into q and rounded back to
    q's dtype, fp32 scores, causal mask at -1e30, whole-row max,
    ``p = exp((s - m).to(p_dtype))``, fp32 row sum, P.V with p in q's
    dtype. Returns ``(o (B, T, H*D) in q's dtype, lse (B, H, T) fp32)``."""
    b, t, hd = q.shape
    d = hd // heads
    sc = scale if scale is not None else 1.0 / (d ** 0.5)

    def split(x):
        return x.reshape(b, t, heads, d).transpose(1, 2).float()

    qs = (q.float() * sc).to(q.dtype)
    s = torch.matmul(split(qs), split(k).transpose(-1, -2))
    if causal:
        mask = torch.ones(t, t, dtype=torch.bool, device=q.device).tril()
        s = s.masked_fill(~mask, _NEG_INF)
    m = s.amax(-1, keepdim=True)
    p = torch.exp((s - m).to(p_dtype))
    l = p.float().sum(-1, keepdim=True)
    o = torch.matmul(p.to(q.dtype).float(), split(v)) / l
    o = o.to(q.dtype).transpose(1, 2).reshape(b, t, hd)
    return o, (m + torch.log(l))[..., 0]


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
    q's dtype, lse (B, H, T) fp32 (the training slice's backward reads
    it). CPU tensors take :func:`mha_packed_forward_reference`."""
    _check_packed(q, k, v, heads, p_dtype)
    b, t, hd = q.shape
    d = hd // heads
    sc = scale if scale is not None else 1.0 / (d ** 0.5)
    if _route(q, k, v) == "cpu":
        return mha_packed_forward_reference(q, k, v, heads, causal, sc,
                                            p_dtype)
    if d not in _PACKED_HEAD_DIMS:
        raise ValueError(f"mha_packed_fwd kernel is built for head_dim in "
                         f"{_PACKED_HEAD_DIMS}, got {d}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("mha_packed_fwd needs contiguous q, k, v")
    p = ctypes.c_void_p
    i = ctypes.c_int
    lib = _lib("mha_packed_fwd", [p, p, p, p, p, i, i, i, i, ctypes.c_float,
                                  i, i, i, p])
    o = torch.empty_like(q)
    lse = torch.empty((b, heads, t), dtype=torch.float32, device=q.device)
    rc = lib.mha_packed_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                            o.data_ptr(), lse.data_ptr(), b, t, heads, d,
                            float(sc), int(bool(causal)),
                            int(p_dtype == torch.bfloat16),
                            _Q_CODES[q.dtype], _stream_ptr(q.device))
    _check_rc(lib, "mha_packed_fwd", rc)
    mha_attention_packed.launches += 1
    return o, lse


def mha_attention_packed(q, k, v, heads: int, causal: bool = False,
                         scale: Optional[float] = None,
                         p_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Attention on the packed projection layout (B, T, heads*head_dim):
    no (B, H, T, D) transpose is made and the (T, T) scores never reach
    device memory. ``p_dtype`` is the softmax probability dtype (fp32
    exact; bf16 rounds p before the row sum and P.V). Forward only."""
    return mha_packed_forward(q, k, v, heads, causal, scale, p_dtype)[0]


mha_attention_packed.launches = 0


# --------------------------------------------------- paged decode attention


def paged_decode_attention_reference(q, k_pool, v_pool, tables, pos, *,
                                     block_size: int,
                                     scale: Optional[float] = None,
                                     k_scale=None, v_scale=None):
    """Plain version of the paged kernel, mirroring the JAX package's
    gather reference: materialize ``pool[tables]`` as (S, L, H, D),
    dequantize int8 by its scales, mask positions past ``pos`` at -1e30,
    fp32 softmax, output in q's dtype."""
    S, H, D = q.shape
    L = tables.shape[1] * block_size
    sc = scale if scale is not None else 1.0 / (D ** 0.5)
    tl = tables.long()
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


def _paged_smem_bytes(block_size: int, head_dim: int) -> int:
    return 4 * (head_dim + block_size * (head_dim + 1)
                + block_size * head_dim + block_size)


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
    take :func:`paged_decode_attention_reference`."""
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
    if _paged_smem_bytes(B, D) > _STATIC_SMEM_BYTES:
        raise ValueError(f"block_size={B}, head_dim={D} exceed the kernel's "
                         f"48 KB shared-memory stage")
    operands = [q, k_pool, v_pool, tables, pos] + (
        [k_scale, v_scale] if quantized else [])
    if not all(t.is_contiguous() for t in operands):
        raise ValueError("paged_decode needs contiguous operands")
    p = ctypes.c_void_p
    i = ctypes.c_int
    lib = _lib("paged_decode", [p] * 8 + [i] * 6 + [ctypes.c_float, i, i, p])
    o = torch.empty_like(q)
    rc = lib.paged_decode(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
        k_scale.data_ptr() if quantized else None,
        v_scale.data_ptr() if quantized else None,
        tables.data_ptr(), pos.data_ptr(), o.data_ptr(),
        S, H, D, NB, B, tables.shape[1], float(sc),
        _Q_CODES[q.dtype], _KV_CODES[k_pool.dtype], _stream_ptr(q.device))
    _check_rc(lib, "paged_decode", rc)
    paged_decode_attention.launches += 1
    return o


paged_decode_attention.launches = 0
