"""RNG (ref: org.nd4j.linalg.api.rng + libnd4j RandomLauncher/RandomGenerator)
over the port's threefry (counterpart: ``deeplearning4j_tpu/ndarray/random.py``).

The reference keeps the DL4J stateful seed API (``Nd4j.getRandom()
.setSeed(...)``) as a shell over ``jax.random``'s threefry keys. This
module keeps the same shell, and its draws are ``jax.random``'s under the
partitionable threefry layout (``models/random.py``), so the same seed
gives the same numbers in JAX, on the host and on the card:

- :func:`uniform`, :func:`bernoulli`, :func:`permutation` and
  :func:`randint` are equal bit for bit;
- :func:`normal`, :func:`truncated_normal`, :func:`exponential` and
  :func:`gumbel` take the same uniform bits through ``erfinv`` and
  ``log``, whose last bits differ between XLA and torch (a few ulps);
- :func:`gamma` is Marsaglia–Tsang with JAX's key schedule and rejection
  loop; its normal draws inherit ``erfinv``'s ulps.

Keys are anything ``models.random.as_key`` takes (a (2,) uint32 array as
``jax.random.PRNGKey`` makes, or an int64 tensor of two 32-bit words);
draws land on the key's device unless ``device`` is given. A Python float
that sets a draw's dtype (``bernoulli``'s ``p``) is the default float
(``dtypes.float_``: float32, float64 with the 64-bit switch on), as a
numpy value is its canonical dtype; pass a tensor for another.
"""
from __future__ import annotations

import math
import threading

import numpy as np
import torch

from deeplearning4j_tpu_torch.models.random import (
    as_key, bits, prng_key, split, threefry2x32)
from deeplearning4j_tpu_torch.ndarray import dtypes as _dt

# (bits, mantissa bits) of each float dtype
_FLOAT_BITS = {torch.float64: (64, 52), torch.float32: (32, 23),
               torch.float16: (16, 10), torch.bfloat16: (16, 7)}
_ONE_BITS = {torch.float64: 0x3FF0000000000000, torch.float32: 0x3F800000,
             torch.float16: 0x3C00, torch.bfloat16: 0x3F80}
_INT_VIEW = {64: torch.int64, 32: torch.int32, 16: torch.int16}


def _key(key, device):
    return as_key(key, None if device is None else torch.device(device))


def _shape(shape):
    return tuple(int(s) for s in shape)


def _floats(word, dtype):
    """Random bits (int64 holding ``rng_bits`` of them) -> floats in
    [0, 1): the top mantissa bits under exponent 0, minus 1."""
    nbits, nmant = _FLOAT_BITS[dtype]
    rng_bits = 8 if nmant < 8 else nbits
    mant = (word >> (rng_bits - nmant)) & ((1 << nmant) - 1)
    return (mant | _ONE_BITS[dtype]).to(_INT_VIEW[nbits]).view(dtype) - 1


def _rng_bits(dtype) -> int:
    nbits, nmant = _FLOAT_BITS[dtype]
    return 8 if nmant < 8 else nbits


def _bound(v, dtype, device):
    if isinstance(v, torch.Tensor):
        return v.to(device=device, dtype=dtype)
    return torch.as_tensor(np.asarray(v), device=device).to(dtype)


def uniform(key, shape, dtype=torch.float32, minval=0.0, maxval=1.0,
            device=None) -> torch.Tensor:
    """``jax.random.uniform``: floats in [minval, maxval)."""
    key = _key(key, device)
    dtype = _dt.canonical(_dt.resolve(dtype))
    shape = _shape(shape)
    lo = _bound(minval, dtype, key.device)
    hi = _bound(maxval, dtype, key.device)
    floats = _floats(bits(key, shape, _rng_bits(dtype)), dtype)
    return torch.maximum(lo, _fma(floats, hi - lo, lo))


def _fma(a, b, c):
    """a * b + c rounded once, as XLA on the CPU contracts it: exact in
    float64 for float32 and float16 (their product fits), ``addcmul`` for
    float64; bfloat16 rounds twice, as there."""
    if a.dtype == torch.float64:
        return torch.addcmul(c, a, b)
    if a.dtype == torch.bfloat16:     # XLA does not contract bf16
        return a * b + c
    return (a.double() * b.double() + c.double()).to(a.dtype)


def normal(key, shape, dtype=torch.float32, device=None) -> torch.Tensor:
    """``jax.random.normal``: sqrt(2) erfinv(u), u uniform in
    (-1, 1)."""
    dtype = _dt.canonical(_dt.resolve(dtype))
    lo = torch.nextafter(torch.tensor(-1.0, dtype=dtype),
                         torch.tensor(0.0, dtype=dtype))
    u = uniform(key, shape, dtype, lo, 1.0, device)
    return torch.tensor(math.sqrt(2), dtype=dtype, device=u.device) \
        * torch.erfinv(u)


def exponential(key, shape, dtype=torch.float32, device=None):
    """``jax.random.exponential``: -log1p(-u)."""
    return -torch.log1p(-uniform(key, shape, dtype, device=device))


def truncated_normal(key, lower, upper, shape, dtype=torch.float32,
                     device=None):
    """``jax.random.truncated_normal`` on (lower, upper)."""
    dtype = _dt.canonical(_dt.resolve(dtype))
    dev = _key(key, device).device
    sqrt2 = torch.tensor(math.sqrt(2), dtype=dtype, device=dev)
    lower = _bound(lower, dtype, dev)
    upper = _bound(upper, dtype, dev)
    a = torch.erf(lower / sqrt2)
    b = torch.erf(upper / sqrt2)
    u = uniform(key, shape, dtype, a, b, dev)
    out = sqrt2 * torch.erfinv(u)
    inf = torch.tensor(float("inf"), dtype=dtype, device=dev)
    return torch.clamp(out, torch.nextafter(lower, inf),
                       torch.nextafter(upper, -inf))


def _p_dtype(p) -> torch.dtype:
    """The dtype a probability sets: a tensor's own, a numpy value's
    canonical one, the default float for a Python float."""
    if isinstance(p, torch.Tensor):
        return p.dtype
    if isinstance(p, (np.ndarray, np.generic)):
        return _dt.canonical(_dt.resolve(p.dtype))
    return _dt.float_()


def bernoulli(key, p=0.5, shape=None, device=None) -> torch.Tensor:
    """``jax.random.bernoulli``: uniform(p's dtype) < p, as bool."""
    dtype = _p_dtype(p)
    if not dtype.is_floating_point:
        raise TypeError("bernoulli probability `p` must have a floating "
                        f"dtype, got {dtype}")
    dev = _key(key, device).device
    p = _bound(p, dtype, dev)
    shape = tuple(p.shape) if shape is None else _shape(shape)
    return uniform(key, shape, dtype, device=dev) < p


def gumbel(key, shape, dtype=torch.float32, device=None) -> torch.Tensor:
    """``jax.random.gumbel``: -log(-log(u)), u uniform in [tiny, 1)."""
    dtype = _dt.canonical(_dt.resolve(dtype))
    u = uniform(key, shape, dtype, torch.finfo(dtype).tiny, 1.0, device)
    return -torch.log(-torch.log(u))


def _shuffle(key, x: torch.Tensor, axis: int) -> torch.Tensor:
    """JAX's sort-based shuffle: ceil(3 ln(n) / ln(2^32 - 1)) rounds,
    each a stable sort of x along ``axis`` by fresh 32-bit keys."""
    rounds = int(np.ceil(3 * np.log(max(1, x.numel()))
                         / np.log(np.iinfo(np.uint32).max)))
    for _ in range(rounds):
        key, sub = split(key, 2)
        order = bits(sub, x.shape, 32).sort(dim=axis, stable=True).indices
        x = torch.take_along_dim(x, order, dim=axis)
    return x


def permutation(key, x, axis: int = 0, device=None) -> torch.Tensor:
    """``jax.random.permutation``: of ``range(x)`` for an int, else of
    ``x``'s slices along ``axis`` (one shuffle of the indices)."""
    key = _key(key, device)
    if isinstance(x, int):
        return _shuffle(key, torch.arange(x, device=key.device), 0)
    x = torch.as_tensor(x, device=key.device)
    axis = axis % max(x.dim(), 1)
    if x.dim() == 1:
        return _shuffle(key, x, axis)
    ind = _shuffle(key, torch.arange(x.shape[axis], device=key.device), 0)
    return torch.index_select(x, axis, ind)


def _umod(s: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """The unsigned 64-bit value held in the int64 ``s``, modulo ``m``
    (0 < m < 2^31)."""
    wrap = ((1 << 32) % m) ** 2 % m          # 2^64 mod m
    return (torch.remainder(s, m) + torch.where(s < 0, wrap, 0)) % m


def _randint64(key, shape, minval, maxval):
    """``jax.random.randint`` for int64, whose spans must fit in 31
    bits (the offset arithmetic then stays in int64)."""
    mn = torch.as_tensor(minval, device=key.device).to(torch.int64)
    mx = torch.as_tensor(maxval, device=key.device).to(torch.int64)
    span = torch.where(mx <= mn, torch.ones_like(mx), mx - mn)
    if bool((span >= (1 << 31)).any()):
        raise TypeError("randint: int64 spans of 2^31 or more are not "
                        "supported")
    k1, k2 = split(key, 2)
    higher, lower = bits(k1, shape, 64), bits(k2, shape, 64)
    mult = (1 << 32) % span
    mult = (mult * mult) % span
    off = (_umod(higher, span) * mult + _umod(lower, span)) % span
    return mn + off


def randint(key, shape, minval, maxval, dtype=torch.int32, device=None):
    """``jax.random.randint``: two words of random bits reduced modulo the
    span, as JAX does (int64 for spans below 2^31)."""
    key = _key(key, device)
    dtype = _dt.canonical(_dt.resolve(dtype))
    nbits = torch.iinfo(dtype).bits
    if nbits > 32:
        if dtype != torch.int64:
            raise TypeError(f"randint: {dtype} is not supported")
        return _randint64(key, _shape(shape), minval, maxval)
    if nbits < 32:
        # sampled at int32 between the clipped bounds, then cast
        info = torch.iinfo(dtype)
        mn = min(max(int(minval), info.min), info.max)
        mx = min(max(int(maxval), info.min), info.max + 1)
        return randint(key, shape, mn, mx, torch.int32).to(dtype)
    mask = (1 << nbits) - 1
    info = torch.iinfo(dtype)
    shape = _shape(shape)
    mn = torch.as_tensor(minval, device=key.device).to(torch.int64)
    mx = torch.as_tensor(maxval, device=key.device).to(torch.int64)
    out_of_range = mx > info.max
    mn = mn.clamp(info.min, info.max)
    mx = mx.clamp(info.min, info.max)
    k1, k2 = split(key, 2)
    higher, lower = bits(k1, shape, nbits), bits(k2, shape, nbits)
    span = (mx - mn) & mask
    span = torch.where(mx <= mn, torch.ones_like(span), span)
    span = torch.where(out_of_range & (mx > mn), (span + 1) & mask, span)
    # span 0 stands for 2^nbits: x % 2^nbits == x
    safe = torch.where(span == 0, torch.full_like(span, 1 << nbits), span)
    # the unsigned arithmetic of nbits wraps: mask after each step
    mult = (1 << (nbits // 2)) % safe
    mult = ((mult * mult) & mask) % safe
    off = ((((higher % safe) * mult) & mask) + lower % safe) & mask
    off = off % safe
    return (mn + off).to(dtype) if dtype.is_signed else \
        ((mn + off) & mask).to(dtype)


def _scalar_bits(keys: torch.Tensor, width: int) -> torch.Tensor:
    """One draw of ``width`` bits from each key of (m, 2): the bits of
    shape () (counter 0)."""
    zero = torch.zeros_like(keys[:, 0])
    y0, y1 = threefry2x32(keys[:, 0], keys[:, 1], zero, zero)
    if width == 64:
        return (y0 << 32) | y1
    return (y0 ^ y1) & ((1 << width) - 1)


def _scalar_uniform(keys, dtype, lo=None):
    floats = _floats(_scalar_bits(keys, _rng_bits(dtype)), dtype)
    if lo is None:
        return floats
    one = torch.ones((), dtype=dtype, device=keys.device)
    return torch.maximum(lo, _fma(floats, one - lo, lo))


def _split_rows(keys, num):
    """``split`` of every key of (m, 2): (num, m, 2)."""
    lo = torch.arange(num, dtype=torch.int64, device=keys.device)[:, None]
    y0, y1 = threefry2x32(keys[None, :, 0], keys[None, :, 1],
                          torch.zeros_like(lo), lo)
    return torch.stack([y0, y1], dim=-1)


def gamma(key, a, shape=None, dtype=torch.float32, device=None):
    """``jax.random.gamma``: one key a sample (``split(key, n)``), each
    run through Marsaglia–Tsang with JAX's loop and key schedule
    (``_gamma_one``), all samples advanced together under a mask."""
    key = _key(key, device)
    dtype = _dt.canonical(_dt.resolve(dtype))
    dev = key.device
    a = _bound(a, dtype, dev)
    shape = tuple(a.shape) if shape is None else _shape(shape)
    alpha0 = torch.broadcast_to(a, shape).reshape(-1)
    n = alpha0.numel()
    keys = split(key, n)

    def c(v):
        return torch.tensor(v, dtype=dtype, device=dev)

    zero, one = c(0.0), c(1.0)
    boost = alpha0 >= one
    alpha = torch.where(boost, alpha0, alpha0 + one)
    d = alpha - c(1.0 / 3.0)
    cc = c(1.0 / 3.0) / torch.sqrt(d)
    normal_lo = torch.nextafter(c(-1.0), zero)
    sqrt2 = c(math.sqrt(2))
    ks = _split_rows(keys, 2)
    key_loop, subkey = ks[0], ks[1]
    X = torch.zeros(n, dtype=dtype, device=dev)
    V = torch.ones(n, dtype=dtype, device=dev)
    U = torch.full((n,), 2.0, dtype=dtype, device=dev)

    def rejected(X, V, U):
        return (U >= one - c(0.0331) * (X * X)) & (
            torch.log(U) >= X * c(0.5) + d * ((one - V) + torch.log(V)))

    live = rejected(X, V, U)
    while bool(live.any()):
        idx = live.nonzero().squeeze(1)
        k3 = _split_rows(key_loop[idx], 3)
        key_loop[idx] = k3[0]
        xkey, ukey = k3[1], k3[2]
        x = torch.zeros(idx.numel(), dtype=dtype, device=dev)
        v = torch.full_like(x, -1.0)
        inner = v <= zero
        while bool(inner.any()):
            j = inner.nonzero().squeeze(1)
            k2 = _split_rows(xkey[j], 2)
            xkey[j] = k2[0]
            x[j] = sqrt2 * torch.erfinv(_scalar_uniform(k2[1], dtype,
                                                        normal_lo))
            v[j] = one + x[j] * cc[idx[j]]
            inner = v <= zero
        X[idx] = x * x
        V[idx] = (v * v) * v
        U[idx] = _scalar_uniform(ukey, dtype)
        live = rejected(X, V, U)
    samples = one - _scalar_uniform(subkey, dtype)
    boosted = torch.where(boost, one, torch.pow(samples, one / alpha0))
    return ((d * V) * boosted).reshape(shape)


class Random:
    """Stateful key holder; each draw splits a fresh subkey.

    Key creation is lazy (first draw, not construction), as in the
    reference; the key is two 32-bit words on the host, and a draw moves
    it to the device it draws on. Importing the package touches no
    device."""

    def __init__(self, seed: int = 0):
        self._lock = threading.Lock()
        self._key = None
        self._seed = seed

    def setSeed(self, seed: int):
        with self._lock:
            self._key = as_key(prng_key(seed))
            self._seed = seed

    def getSeed(self) -> int:
        return self._seed

    def _ensure(self):
        if self._key is None:
            self._key = as_key(prng_key(self._seed))

    def nextKey(self) -> torch.Tensor:
        with self._lock:
            self._ensure()
            self._key, sub = split(self._key, 2)
            return sub

    def split(self, n: int) -> torch.Tensor:
        with self._lock:
            self._ensure()
            keys = split(self._key, n + 1)
            self._key = keys[0]
            return keys[1:]

    # sampling helpers (shapes as tuples)
    def uniform(self, shape, minval=0.0, maxval=1.0, dtype=torch.float32,
                device=None):
        return uniform(self.nextKey(), shape, dtype, minval, maxval, device)

    def normal(self, shape, mean=0.0, std=1.0, dtype=torch.float32,
               device=None):
        return normal(self.nextKey(), shape, dtype, device) * std + mean

    def bernoulli(self, shape, p=0.5, device=None):
        return bernoulli(self.nextKey(), p, shape, device)

    def randint(self, shape, minval, maxval, dtype=torch.int32, device=None):
        return randint(self.nextKey(), shape, minval, maxval, dtype, device)

    def permutation(self, n_or_array, device=None):
        return permutation(self.nextKey(), n_or_array, device=device)


_global = Random(0)


def getRandom() -> Random:
    return _global
