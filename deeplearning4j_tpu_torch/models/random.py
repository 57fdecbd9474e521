"""Threefry-2x32 counter-based random bits, bit-identical to ``jax.random``
under ``jax.threefry_partitionable(True)`` — the generator the JAX
package's sampler uses (``sample_token``/``_sample_at`` in
``deeplearning4j_tpu/models/bert.py``), so a stream sampled by the port
draws exactly the reference's gumbel noise for the same (seed, step).

Keys are ``(..., 2)`` tensors of 32-bit words held in int64 (torch's
uint32 lacks most arithmetic); every sum is masked back to 32 bits. The
functions run on whatever device their inputs are on.
"""
from __future__ import annotations

import numpy as np
import torch

_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_KS_PARITY = 0x1BD11BDA
_F32_ONE_BITS = 0x3F800000
_F32_TINY = float(np.finfo(np.float32).tiny)


def prng_key(seed: int) -> np.ndarray:
    """``jax.random.PRNGKey(seed)`` for threefry: ``[seed >> 32,
    seed & 0xFFFFFFFF]`` as a (2,) uint32 array."""
    seed = int(seed)
    return np.array([(seed >> 32) & _M32, seed & _M32], np.uint32)


_CHUNK = 1 << 16   # elements a pass on the host: the words stay in cache


def threefry2x32(k1, k2, x0, x1):
    """The Threefry-2x32 block (20 rounds) on broadcastable int64 tensors
    of 32-bit words; returns the two output words. Each round updates the
    words in place; on the host a cache-sized chunk of elements at a time
    (on the card the whole tensor: a launch an operation)."""
    k3 = (k1 ^ k2 ^ _KS_PARITY) & _M32
    x0, x1 = torch.broadcast_tensors(x0 + k1, x1 + k2)
    shape = x0.shape
    x0, x1 = x0.reshape(-1).bitwise_and(_M32), x1.reshape(-1).bitwise_and(_M32)
    ks = [k.reshape(()) if k.numel() == 1 else k.broadcast_to(shape).reshape(-1)
          for k in map(torch.as_tensor, (k1, k2, k3))]
    chunk = max(x0.numel(), 1) if x0.is_cuda else _CHUNK
    tmp = torch.empty(min(x0.numel(), chunk), dtype=x0.dtype, device=x0.device)
    for lo in range(0, x0.numel(), chunk):
        a, b = x0[lo:lo + chunk], x1[lo:lo + chunk]
        t = tmp[:a.numel()]
        k = [kk if kk.dim() == 0 else kk[lo:lo + chunk] for kk in ks]
        for i in range(5):
            for r in _ROTATIONS[i % 2]:
                a.add_(b).bitwise_and_(_M32)
                torch.bitwise_left_shift(b, r, out=t)    # b = rotl(b, r) ^ a
                b.bitwise_right_shift_(32 - r).bitwise_or_(t).bitwise_and_(_M32)
                b.bitwise_xor_(a)
            a.add_(k[(i + 1) % 3]).bitwise_and_(_M32)
            b.add_(k[(i + 2) % 3]).add_(i + 1).bitwise_and_(_M32)
    return x0.reshape(shape), x1.reshape(shape)


def as_key(key, device=None) -> torch.Tensor:
    """A key (or a batch of keys) as an int64 tensor of shape (..., 2)."""
    if isinstance(key, torch.Tensor):
        return key.to(device=device if device is not None else key.device,
                      dtype=torch.int64)
    return torch.as_tensor(np.asarray(key, np.uint32).astype(np.int64),
                           device=device)


def fold_in(key, data) -> torch.Tensor:
    """``jax.random.fold_in``: the key hashed with the 32-bit counter
    ``(0, data)``. ``key`` (..., 2), ``data`` broadcastable to ``key``'s
    leading shape; returns (..., 2) int64."""
    key = as_key(key)
    data = torch.as_tensor(data, device=key.device).to(torch.int64) & _M32
    y0, y1 = threefry2x32(key[..., 0], key[..., 1], torch.zeros_like(data),
                          data)
    return torch.stack([y0, y1], dim=-1)


def random_bits(key, n: int) -> torch.Tensor:
    """``n`` 32-bit words per key (..., 2) -> (..., n), the partitionable
    layout: word i hashes the 64-bit counter i split as (hi, lo) and XORs
    the two output words."""
    key = as_key(key)
    lo = torch.arange(n, dtype=torch.int64, device=key.device)
    y0, y1 = threefry2x32(key[..., 0:1], key[..., 1:2], torch.zeros_like(lo),
                          lo)
    return y0 ^ y1


def uniform(key, n: int, minval: float = 0.0, maxval: float = 1.0
            ) -> torch.Tensor:
    """float32 uniforms in [minval, maxval): the top 23 bits become the
    mantissa of a float in [1, 2), minus 1, scaled — ``jax.random.uniform``."""
    bits = (random_bits(key, n) >> 9) | _F32_ONE_BITS
    floats = bits.to(torch.int32).view(torch.float32) - 1.0
    lo = torch.tensor(minval, dtype=torch.float32)
    span = torch.tensor(maxval, dtype=torch.float32) - lo
    return torch.clamp_min(floats * span.item() + lo.item(), lo.item())


def gumbel(key, n: int) -> torch.Tensor:
    """float32 standard Gumbel noise, ``jax.random.gumbel``'s default
    ("low") mode: ``-log(-log(u))`` with u uniform in [tiny, 1)."""
    u = uniform(key, n, minval=_F32_TINY, maxval=1.0)
    return -torch.log(-torch.log(u))


def split(key, num: int = 2) -> torch.Tensor:
    """``jax.random.split`` for threefry keys under the partitionable
    layout: subkey i is the block of the 64-bit counter i, both output
    words kept (``_threefry_split_foldlike``). ``key`` (2,) -> (num, 2)."""
    key = as_key(key)
    lo = torch.arange(num, dtype=torch.int64, device=key.device)
    y0, y1 = threefry2x32(key[0], key[1], torch.zeros_like(lo), lo)
    return torch.stack([y0, y1], dim=-1)


def bits(key, shape, width: int = 32) -> torch.Tensor:
    """``jax.random.bits`` of ``width`` (8, 16, 32 or 64) bits for a key
    (2,), in the partitionable layout: the row-major index of each
    element is the 64-bit counter. Returned as int64 holding the unsigned
    value; 64-bit words are the two output words ``hi << 32 | lo``,
    wrapped into int64's range (the bits are the same)."""
    key = as_key(key)
    n = 1
    for s in shape:
        n *= int(s)
    lo = torch.arange(n, dtype=torch.int64, device=key.device)
    y0, y1 = threefry2x32(key[0], key[1], lo >> 32, lo & _M32)
    if width == 64:
        out = (y0 << 32) | y1
    else:
        out = (y0 ^ y1) & ((1 << width) - 1)
    return out.reshape(tuple(int(s) for s in shape))
