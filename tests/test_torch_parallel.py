"""Parity of the port's device mesh, multi-process runtime and sequence
parallelism (``deeplearning4j_tpu_torch/parallel``) with the JAX package,
on the CPU — the cases of ``tests/test_parallel.py``'s
``TestMesh``/``TestSequenceParallel``.

The port runs in spawned gloo worlds (``tests/torch_dist_worker.py``: a
``file://`` store under ``tmp_path``, one CPU thread a rank, no ``jax``):
a world of 4 ranks runs every case of its ``parallel`` suite and one of 2
its ``multihost`` suite. Both start when the module's first test asks for
them and run while the JAX side computes; each parametrized test reads
its case's result, and every wait is bounded. The JAX package runs here
on the conftest's 8 virtual CPU devices (its Pallas kernels in interpret
mode) on the same numpy inputs; the port's kernel wrappers take their
plain versions on the CPU.
"""
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deeplearning4j_tpu.parallel import sequence_parallel as jsp
from deeplearning4j_tpu.parallel.mesh import make_mesh as jax_make_mesh
from deeplearning4j_tpu_torch.ops.attention_kernels import (
    higher_order_attention)
from deeplearning4j_tpu_torch.parallel import multihost
from deeplearning4j_tpu_torch.parallel import sequence_parallel as sp
from deeplearning4j_tpu_torch.parallel.mesh import make_mesh

import torch_dist_worker as W
from torch_threads import one_torch_thread  # noqa: F401,E402

TIMEOUT = 300.0


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_parallel")
    ws = {"parallel": W.World("parallel", 4, d, TIMEOUT),
          "multihost": W.World("multihost", 2, d, TIMEOUT)}
    yield ws
    for w in ws.values():
        w.close()


def _j(*xs):
    return [jnp.asarray(x) for x in xs]


@functools.lru_cache(maxsize=None)
def _oracle(causal):
    """The JAX package's ``reference_attention`` (the sequence-parallel
    tests' numerics oracle), jitted with its gradient of sum(out^2)."""
    def f(q, k, v):
        return jsp.reference_attention(q, k, v, causal=causal)
    return (jax.jit(f), jax.jit(jax.grad(lambda *a: jnp.sum(f(*a) ** 2),
                                         argnums=(0, 1, 2))))


# ------------------------------------------------------------- forward


@pytest.mark.parametrize("impl,causal,n", W.FWD_CASES)
def test_forward_matches_jax(worlds, impl, causal, n):
    """ring / ring_flash / ulysses at context 2 and 4 (4 ranks; the
    2-rank mesh leaves ranks 2-3 out, as the JAX mesh takes the first
    devices): the port's output against the JAX package's oracle within
    2e-5 (the reference test's bound) and, at context 4, against the JAX
    package's own ``ring_self_attention`` on the same mesh shape."""
    q, k, v = _j(*W.attn_inputs(0, (2, 8, 32, 16)))
    got = worlds["parallel"].case(f"fwd-{impl}-{causal}-{n}")["out"]
    np.testing.assert_allclose(got, np.asarray(_oracle(causal)[0](q, k, v)),
                               atol=2e-5)
    if n == 4:
        want = jsp.ring_self_attention(jax_make_mesh({"context": n}), q, k,
                                       v, causal=causal, impl=impl)
        np.testing.assert_allclose(got, np.asarray(want), atol=2e-5)


# ---------------------------------------------------------- gradients


@pytest.mark.parametrize("impl,causal,n", W.GRAD_CASES)
def test_gradients_match_jax(worlds, impl, causal, n):
    """The kernel ring's second-ring-pass backward (and the zigzag's):
    the output and the gradients of sum(out^2) w.r.t. q, k and v against
    the JAX package's oracle — atol 5e-5, rtol 1e-4, the bound the
    reference's own ring and zigzag tests hold against it."""
    q, k, v = _j(*W.attn_inputs(7, (2, 3, 64, 8), 0.3))
    out = np.asarray(_oracle(causal)[0](q, k, v))
    grads = _oracle(causal)[1](q, k, v)
    got = worlds["parallel"].case(f"grad-{impl}-{causal}-{n}")
    np.testing.assert_allclose(got["out"], out, atol=2e-5)
    for name, want in zip(("dq", "dk", "dv"), grads):
        np.testing.assert_allclose(got[name], np.asarray(want), atol=5e-5,
                                   rtol=1e-4, err_msg=name)


@pytest.mark.parametrize("causal", [False, True])
def test_ulysses_kernel_route_matches_jax(worlds, causal):
    """Ulysses at context 4 with its local attention through the kernel
    route (``use_kernel=True``; the plain version on the CPU) and through
    the einsum path: forward (2e-5) and gradients (5e-5 / 1e-4) against
    the JAX package's oracle."""
    q, k, v = _j(*W.attn_inputs(9, (1, 4, 32, 8), 0.3))
    out = np.asarray(_oracle(causal)[0](q, k, v))
    grads = _oracle(causal)[1](q, k, v)
    got = worlds["parallel"].case(f"ulysses-kernel-{causal}")
    for use_kernel in (True, False):
        o, *g = got[use_kernel]
        np.testing.assert_allclose(o, out, atol=2e-5)
        for a, b in zip(g, grads):
            np.testing.assert_allclose(a, np.asarray(b), atol=5e-5,
                                       rtol=1e-4)


def test_ulysses_forced_kernel_off_envelope_raises(worlds):
    """``use_kernel=True`` at global T=36 (off the envelope) raises the
    reference's ValueError on every rank after the all-to-all."""
    got = worlds["parallel"].case("off-envelope")
    assert got["raised"] is not None and "outside the streamed" \
        in got["raised"], got


# ------------------------------------------------ higher-order escapes


@pytest.mark.parametrize("kind", ["ring_flash", "zigzag"])
def test_higher_order_escape_matches_jax(worlds, kind):
    """Under ``higher_order_attention()`` the kernel ring is the einsum
    ring and the zigzag convenience the contiguous einsum ring, both any-
    order differentiable at context 2: the second derivative of
    sum(attn(q*s, q, q)^2) in s at 1 equals the JAX package's oracle's
    (rtol 1e-4). Outside it the kernel ring's double backward raises."""
    q, = _j(*W.attn_inputs(5 if kind == "ring_flash" else 22,
                           (1, 2, 16, 8), 0.3, n=1))

    def loss(s):
        return jnp.sum(jsp.reference_attention(q * s, q, q, causal=True)
                       ** 2)

    want = float(jax.jit(jax.grad(jax.grad(loss)))(1.0))
    got = worlds["parallel"].case(f"higher-order-{kind}")
    assert np.isfinite(got["h"])
    np.testing.assert_allclose(got["h"], want, rtol=1e-4)
    if kind == "ring_flash":
        assert got["outside"] is not None


def test_zigzag_flash_is_first_order_only():
    q = torch.zeros(1, 2, 16, 8)
    with higher_order_attention():
        with pytest.raises(NotImplementedError, match="first-order"):
            sp.zigzag_ring_flash_attention(q, q, q)


# ------------------------------------------------- zigzag and the loop


@pytest.mark.parametrize("T,n", [(64, 4), (32, 2), (96, 3), (16, 8)])
def test_zigzag_indices_partition(T, n):
    """The port's zigzag permutation is the JAX package's, a permutation
    giving rank d chunks (d, 2n-1-d); T not divisible by 2n raises."""
    idx = sp.zigzag_indices(T, n)
    np.testing.assert_array_equal(idx, jsp.zigzag_indices(T, n))
    assert sorted(idx.tolist()) == list(range(T))
    c = T // (2 * n)
    shard0 = idx[: T // n]
    assert shard0[:c].tolist() == list(range(0, c))
    assert shard0[c:].tolist() == list(range((2 * n - 1) * c, 2 * n * c))
    with pytest.raises(ValueError, match="divisible"):
        sp.zigzag_indices(T + 1, n)


@pytest.mark.parametrize("kind,causal", [("ring", False), ("ring", True),
                                         ("zigzag", True)])
def test_one_process_loop_equals_distributed_ring(worlds, kind, causal):
    """``ring_flash_loop`` / ``zigzag_ring_flash_loop`` over 4 virtual
    ranks (what the card runs at full width) give the 4-rank distributed
    ring's output and dq, dk, dv bit for bit."""
    got = worlds["parallel"].case(f"loop-{kind}-{causal}")
    assert got["equal"] == [True] * 4, got


def test_single_shard_ring_flash_degenerates_to_flash():
    """A context axis of 1 (no process group): no rotation, the local
    streamed kernel (its plain version here), equal to the JAX
    package's."""
    q, = W.attn_inputs(3, (1, 2, 32, 8), n=1)
    got = sp.ring_self_attention(make_mesh({"context": 1}),
                                 *W._t(q, q, q), causal=True,
                                 impl="ring_flash")
    want = jsp.ring_self_attention(jax_make_mesh({"context": 1}),
                                   *_j(q, q, q), causal=True,
                                   impl="ring_flash")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)


# --------------------------------------------------------------- mesh


def test_make_mesh_axes_and_default(worlds):
    """At 4 ranks: the named shape and axis names, the default (every
    rank on 'data'), a too-large shape refused with ValueError as the JAX
    package refuses one, a shape below the world taking the first ranks,
    and each rank's coordinates (row-major, as the JAX mesh's devices)."""
    got = worlds["parallel"].case("mesh")
    jm = jax_make_mesh({"data": 2, "model": 2})
    assert got["shape"] == dict(jm.shape)
    assert got["axis_names"] == tuple(jm.axis_names)
    assert got["default"] == {"data": got["world"]}
    assert dict(jax_make_mesh().shape) == {"data": len(jax.devices())}
    assert got["too_big"] is not None and "needs 8 devices" \
        in got["too_big"]
    with pytest.raises(ValueError):
        jax_make_mesh({"data": 2 * len(jax.devices())})
    assert got["cut_devices"] == [0, 1]
    assert got["cut_contains"] == [True, True, False, False]
    assert got["coords"] == [(0, 0), (0, 1), (1, 0), (1, 1)]
    assert np.asarray(jm.devices).shape == (2, 2)


def test_make_mesh_one_process():
    """Without a process group the mesh is one rank: every axis of size 1
    works, anything larger raises, and there are no groups."""
    m = make_mesh({"data": 1, "model": 1, "context": 1})
    assert m.shape == {"data": 1, "model": 1, "context": 1}
    assert m.group("data") is None and m.axis_index("context") == 0
    assert make_mesh().shape == {"data": 1}
    with pytest.raises(ValueError, match="needs 2 devices"):
        make_mesh({"data": 2})


def test_placement_specs(worlds):
    """``shard_batch`` gives each rank its rows by its 'data' index;
    ``tree_shardings`` degrades an axis the mesh lacks ('context') to a
    whole dim, as the JAX package's ``fix`` does; blocks gather back,
    blocks of an odd length too."""
    got = worlds["parallel"].case("placement")
    x = np.arange(16 * 6, dtype=np.float32).reshape(16, 6)
    assert got["spec"] == ("model", None) and got["whole"] == ()
    for r, (rows, w) in enumerate(got["blocks"]):
        d, m = divmod(r, 2)
        np.testing.assert_array_equal(rows, x[d * 8:(d + 1) * 8])
        np.testing.assert_array_equal(w, x[m * 8:(m + 1) * 8])
    assert got["round_trip"] and got["batch_round_trip"]
    assert got["odd_round_trip"]


# ---------------------------------------------------------- multihost


def test_multihost_two_processes(worlds):
    """Two processes joined through COORDINATOR_ADDRESS / NUM_PROCESSES /
    PROCESS_ID: ``initialize`` returns True, each knows its index, the
    device counts, the coordinator, and ``barrier`` returns the device
    count as a float."""
    res = worlds["multihost"].results()
    assert res["_joined"] is True
    rows = worlds["multihost"].case("info")
    assert [r["process_index"] for r in rows] == [0, 1]
    assert [r["coordinator"] for r in rows] == [True, False]
    assert all(r["global"] == 2 and r["local"] == 1 and r["barrier"] == 2.0
               for r in rows), rows


def test_multihost_single_process_is_a_no_op():
    assert multihost.initialize(num_processes=1) is False
    assert multihost.process_index() == 0 and multihost.is_coordinator()
    assert multihost.global_device_count() == 1
    assert multihost.barrier() == 1.0


@pytest.mark.parametrize("world", ["parallel", "multihost"])
def test_workers_import_no_jax(worlds, world):
    assert worlds[world].results()["_jax_imported"] == []
