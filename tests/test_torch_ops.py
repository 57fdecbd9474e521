"""The port's op registry (``deeplearning4j_tpu_torch.ops``) against the
JAX package's (``deeplearning4j_tpu.ops.REGISTRY``) on the CPU: the gate
on the key set, the eager namespaces, the unsigned dtypes, the attention
ops' routes, and the forward and gradient of every key of the ``nn``,
``loss`` and ``image`` namespaces (``tests/torch_op_parity.py``; the other
namespaces: ``test_torch_ops_math.py``, ``test_torch_ops_shape.py``,
``test_torch_ops_cnn.py``, one file each so that no file runs long).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deeplearning4j_tpu.ops as jops
import deeplearning4j_tpu_torch.ops as tops
from deeplearning4j_tpu_torch import NDArray, nd
from torch_op_cases import CASES, flat_outputs, to_torch
from torch_op_parity import (
    check_forward, check_gradient, grad_keys, keys_of, np_of, rng)

KEYS = keys_of("nn", "loss", "image")


@pytest.fixture(autouse=True)
def _host_arrays():
    """Arrays on the host, 64-bit as the reference runs here
    (``tests/conftest.py`` turns ``jax_enable_x64`` on)."""
    nd.setDefaultDevice("cpu")
    with nd.enableX64(True):
        yield
    nd.setDefaultDevice(None)


@pytest.mark.parametrize("key", grad_keys(KEYS))
def test_gradient(key):
    check_gradient(key)


@pytest.mark.parametrize("key", KEYS)
def test_forward(key):
    check_forward(key)


# ------------------------------------------------------------------ gates


def test_registry_is_the_reference_registry():
    """The port registers exactly the reference's 451 keys (its
    ``math_defs.py``, ``nn_defs.py``, ``extra_defs.py``, ``more_defs.py``
    and ``wide_defs.py``), each in the reference's namespace and each with
    a case here."""
    assert len(tops.REGISTRY) == 451
    assert set(tops.REGISTRY) == set(jops.REGISTRY)
    assert set(tops.REGISTRY) == set(CASES)
    for key, spec in tops.REGISTRY.items():
        ns, name = key.split(".", 1)
        assert (spec.namespace, spec.name) == (ns, name)
        assert jops.REGISTRY[key].namespace == ns


def test_eager_namespaces_wrap_and_unwrap():
    """Every key through its eager namespace on NDArray (and numpy)
    arguments gives the torch-level fn's values, wrapped in NDArray."""
    for key in sorted(CASES):
        ns, name = key.split(".", 1)
        args, kwargs = CASES[key].variants[0](rng(key, 0))
        want = flat_outputs(tops.REGISTRY[key].fn(
            *to_torch(args, "cpu"), **to_torch(kwargs, "cpu")))
        wrapped = [NDArray(torch.as_tensor(a)) if isinstance(a, np.ndarray)
                   and i == 0 else a for i, a in enumerate(args)]
        got = getattr(getattr(tops, ns), name)(*wrapped, **kwargs)
        got = flat_outputs(got)
        assert len(got) == len(want), key
        for g, w in zip(got, want):
            if isinstance(w, torch.Tensor):
                assert isinstance(g, NDArray), key
                assert g.device.type == "cpu", key
                if w.dtype.is_floating_point:
                    # the same op run twice: LAPACK's threads may sum in
                    # another order (lstsq)
                    np.testing.assert_allclose(g.toNumpy(), np_of(w),
                                               rtol=1e-5, atol=1e-6,
                                               err_msg=key)
                else:
                    np.testing.assert_array_equal(g.toNumpy(), np_of(w),
                                                  key)
            else:
                assert g == w, key
    assert sorted(dir(tops.linalg)) == sorted(
        k.split(".", 1)[1] for k in CASES if k.startswith("linalg."))
    # the namespace holds the ten updater keys only; the AdamW kernel's
    # module is ops/pallas_updaters.py
    assert sorted(dir(tops.updaters)) == sorted(
        k.split(".", 1)[1] for k in jops.REGISTRY if k.startswith("updaters."))
    assert len(dir(tops.updaters)) == 10
    with pytest.raises(AttributeError):
        tops.updaters.fused_adamw


def test_unsigned_widening_and_uint64_refusal():
    """UINT16/UINT32 compute in int64 and come back in their dtype;
    UINT64 arithmetic raises TypeError naming the dtype (a known
    difference: the reference computes it)."""
    a = torch.tensor([4_000_000_000, 7], dtype=torch.uint32)
    b = torch.tensor([1_000_000_000, 9], dtype=torch.uint32)
    out = tops.REGISTRY["math.add"].fn(a, b)
    assert out.dtype == torch.uint32
    assert out.to(torch.int64).tolist() == [(5_000_000_000) % 2**32, 16]
    ref = jops.REGISTRY["math.add"].fn(jnp.asarray(np.array(
        [4_000_000_000, 7], np.uint32)), jnp.asarray(np.array(
            [1_000_000_000, 9], np.uint32)))
    assert np.asarray(ref).tolist() == out.to(torch.int64).tolist()
    u64 = torch.tensor([3, 5], dtype=torch.uint64)
    for key in ("math.mul", "math.add", "bitwise.xor", "reduce.sum"):
        with pytest.raises(TypeError, match="UINT64"):
            fn = tops.REGISTRY[key].fn
            fn(u64, u64) if key != "reduce.sum" else fn(u64)


# ---------------------------------------------- attention routes (CPU)


def _qkv(seed, shape):
    r = np.random.default_rng(seed)
    return [r.standard_normal(shape).astype(np.float32) for _ in range(3)]


def test_attention_auto_takes_einsum_on_cpu(monkeypatch):
    """Auto (use_kernel=None) on CPU tensors takes the einsum route at
    every T (the kernels' auto route is for CUDA tensors only): no kernel
    wrapper is entered, even at T = 1024, where the card takes row 1."""
    from deeplearning4j_tpu_torch.ops import attention_kernels as ak

    def boom(*a, **k):
        raise AssertionError("kernel route taken on the CPU")

    monkeypatch.setattr(ak, "mha_attention", boom)
    monkeypatch.setattr(ak, "flash_attention", boom)
    monkeypatch.setattr(ak, "mha_attention_packed", boom)
    q, k, v = (torch.as_tensor(x) for x in _qkv(1, (1, 1, 1024, 8)))
    tops.REGISTRY["nn.scaledDotProductAttentionFused"].fn(q, k, v)
    x = torch.as_tensor(_qkv(2, (1, 1024, 8))[0])
    w = torch.eye(8)
    tops.REGISTRY["nn.multiHeadDotProductAttention"].fn(x, x, w, w, w, w, 2)


def test_attention_forced_kernel_takes_plain_versions(monkeypatch):
    """use_kernel=True on CPU tensors goes through the kernel wrappers,
    which take their plain versions (the reference's interpret mode):
    rows 1-2 at T <= 1024."""
    from deeplearning4j_tpu_torch.ops import attention_kernels as ak

    calls = []
    real = ak.mha_attention

    def spy(*a, **k):
        calls.append(a[0].shape)
        return real(*a, **k)

    monkeypatch.setattr(ak, "mha_attention", spy)
    q, k, v = _qkv(3, (1, 2, 32, 8))
    out = tops.nn.scaledDotProductAttentionFused(q, k, v, use_kernel=True)
    ref = jops.nn.scaledDotProductAttentionFused(q, k, v, use_kernel=True)
    assert calls == [(1, 2, 32, 8)]
    np.testing.assert_allclose(out.toNumpy(), np.asarray(ref.toNumpy()),
                               rtol=1e-5, atol=1e-6)


def test_attention_masked_pins_einsum_and_forced_kernel_raises():
    """The reference's cases (tests/test_attention_fusion.py): a masked
    call equals the unmasked one under an all-zero additive mask; forcing
    a kernel with a mask, or off the envelope (T = 10), raises the
    reference's ValueError."""
    r = np.random.default_rng(8)
    q = r.normal(size=(1, 2, 16, 4)).astype(np.float32)
    mask = np.zeros((1, 1, 1, 16), np.float32)
    out = tops.nn.scaledDotProductAttentionFused(q, q, q, mask=mask)
    ref = tops.nn.scaledDotProductAttentionFused(q, q, q)
    np.testing.assert_allclose(out.toNumpy(), ref.toNumpy(), atol=1e-6)
    for kw in ({"mask": mask}, {}):
        qq = q if kw else np.random.default_rng(6).normal(
            size=(1, 2, 10, 4)).astype(np.float32)
        with pytest.raises(ValueError, match="use_kernel=True"):
            tops.nn.scaledDotProductAttentionFused(qq, qq, qq,
                                                   use_kernel=True, **kw)
        with pytest.raises(ValueError, match="use_kernel=True"):
            jops.nn.scaledDotProductAttentionFused(qq, qq, qq,
                                                   use_kernel=True, **kw)


def test_attention_kernel_route_is_first_order_only():
    """A second differentiation through the forced kernel route raises in
    both packages, naming ``higher_order_attention``; the einsum route
    differentiates twice and agrees with the reference's."""
    q, k, v = _qkv(4, (1, 2, 16, 8))

    def ref_f(q, use_kernel):
        return jnp.sum(jops.REGISTRY["nn.scaledDotProductAttentionFused"].fn(
            q, k, v, use_kernel=use_kernel) ** 2)

    with pytest.raises(NotImplementedError, match="higher_order_attention"):
        jax.grad(lambda x: jnp.sum(jax.grad(ref_f)(x, True)))(q)
    t = torch.tensor(q, requires_grad=True)
    kt, vt = torch.as_tensor(k), torch.as_tensor(v)
    fn = tops.REGISTRY["nn.scaledDotProductAttentionFused"].fn
    (g,) = torch.autograd.grad((fn(t, kt, vt, use_kernel=True) ** 2).sum(),
                               t, create_graph=True)
    with pytest.raises(RuntimeError, match="higher_order_attention"):
        g.sum().backward()
    (g,) = torch.autograd.grad((fn(t, kt, vt, use_kernel=False) ** 2).sum(),
                               t, create_graph=True)
    (gg,) = torch.autograd.grad(g.sum(), t)
    ref_gg = jax.grad(lambda x: jnp.sum(jax.grad(ref_f)(x, False)))(q)
    np.testing.assert_allclose(gg.numpy(), np.asarray(ref_gg), rtol=1e-4,
                               atol=1e-4)
