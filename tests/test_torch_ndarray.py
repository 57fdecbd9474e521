"""The port's arrays (``deeplearning4j_tpu_torch.ndarray``: NDArray, nd,
dtypes, indexing, Random) against the JAX package's on the CPU.

Each scenario of the reference's ``tests/test_ndarray.py`` runs through
both packages on the same numpy inputs and their results are compared
(values exact, dtypes by DL4J name); then the ``i``-variants' rebinding,
the seeded draws (bit-equal to ``jax.random``'s where the arithmetic is
integer, a few ulps through ``erfinv``/``log``), autograd through the
facade, and the device rule (creation without a card raises unless the
CPU was asked for).
"""
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deeplearning4j_tpu.ndarray as jnd
import deeplearning4j_tpu_torch.ndarray as tnd
from deeplearning4j_tpu_torch.models.random import prng_key
from deeplearning4j_tpu_torch.ndarray import random as trandom

REPO = __file__.rsplit("/tests/", 1)[0]


@pytest.fixture(autouse=True)
def _host_arrays():
    """Arrays on the host, 64-bit as the reference runs here
    (``tests/conftest.py`` turns ``jax_enable_x64`` on)."""
    tnd.nd.setDefaultDevice("cpu")
    with tnd.nd.enableX64(True):
        yield
    tnd.nd.setDefaultDevice(None)


def _out(x):
    """A scenario's result as numpy (NDArray, list, tuple, scalar)."""
    if isinstance(x, (list, tuple)):
        return [_out(e) for e in x]
    if hasattr(x, "toNumpy"):
        return (x.toNumpy(), x.dataType())
    return x


def _same(a, b, label):
    if isinstance(a, list):
        assert isinstance(b, list) and len(a) == len(b), label
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{label}[{i}]")
        return
    if isinstance(a, tuple):
        np.testing.assert_array_equal(a[0], b[0], err_msg=label)
        assert a[1] == b[1], f"{label}: dtype {a[1]} != {b[1]}"
        return
    assert a == b, f"{label}: {a} != {b}"


def _x(*shape):
    return np.arange(int(np.prod(shape)), dtype=np.float32).reshape(shape)


# the reference's tests/test_ndarray.py, as functions of (nd, I) that
# return what the test inspects
SCENARIOS = {
    "zeros_ones": lambda nd, I: [nd.zeros(2, 3), nd.ones((3, 4)),
                                 nd.zeros(2, 3).sumNumber()],
    "create": lambda nd, I: [nd.create([[1.0, 2.0], [3.0, 4.0]]),
                             nd.create([[1.0, 2.0]]).getDouble(0, 1),
                             nd.create([1, 2, 3, 4, 5, 6], shape=(2, 3))],
    "value_scalar_eye": lambda nd, I: [
        nd.valueArrayOf((2, 2), 7.0), nd.scalar(3.5),
        nd.scalar(3.5).isScalar(), nd.eye(3), nd.eye(3).sumNumber()],
    "arange": lambda nd, I: [nd.arange(5), nd.arange(1, 7, 2),
                             nd.arange(5, dtype="FLOAT")],
    "dtypes": lambda nd, I: [
        nd.zeros(2, 2, dtype="DOUBLE").dataType(),
        nd.zeros(2, 2, dtype="DOUBLE").castTo("FLOAT"),
        nd.create([1, 2], dtype="INT"), nd.create([1, 2], dtype="UBYTE"),
        nd.create(np.ones(3, np.int16)).dataType()],
    "arithmetic": lambda nd, I: [
        nd.create(_x(3)).add(nd.create(_x(3) + 4)),
        nd.create(_x(3)).sub(nd.create(_x(3) + 4)),
        nd.create(_x(3)).mul(nd.create(_x(3) + 4)),
        nd.create(_x(3) + 4).div(nd.create(_x(3) + 1)),
        nd.create(_x(3)).rsub(10), nd.create(_x(3) + 1).rdiv(6),
        nd.create(_x(3) + 1) % 2.0, nd.create(_x(3)).pow(2)],
    "dunders": lambda nd, I: [
        nd.create(_x(2)) + 1, 2 * nd.create(_x(2)), nd.create(_x(2)) ** 2,
        -nd.create(_x(2)), 1 - nd.create(_x(2)), 1 / (nd.create(_x(2)) + 1),
        nd.create(_x(2, 2)) @ nd.create(_x(2, 2))],
    "assign_broadcast": lambda nd, I: [
        nd.zeros(2, 2).assign(5.0), nd.ones(2, 3).add(nd.create(_x(3))),
        nd.create(_x(3)).broadcast(2, 3)],
    "linalg_shape": lambda nd, I: [
        nd.create(_x(2, 2)).mmul(nd.create(_x(2, 2) + 1)),
        nd.gemm(nd.create(_x(2, 2)), nd.eye(2), transposeA=True),
        nd.arange(6).reshape(2, 3).transpose(),
        nd.create(_x(2, 3, 4)).transpose(2, 0, 1),
        nd.create(_x(2, 3, 4)).permute(1, 0, 2),
        nd.arange(6).reshape(3, 2), nd.arange(6).reshape(2, 3).ravel(),
        nd.create(_x(2, 3)).repeat(2, axis=1),
        nd.create(_x(2, 1, 3)).squeeze(), nd.create(_x(3)).expandDims(0),
        nd.create(_x(2, 3)).swapAxes(0, 1)],
    "concat_stack": lambda nd, I: [
        nd.concat(0, nd.ones(2, 2), nd.zeros(2, 2)),
        nd.concat(1, nd.ones(2, 2), nd.zeros(2, 2)),
        nd.stack(0, nd.ones(2, 2), nd.zeros(2, 2)),
        nd.vstack(nd.ones(2, 2), nd.zeros(2, 2)),
        nd.hstack(nd.ones(2, 2), nd.zeros(2, 2)),
        nd.split(nd.create(_x(4, 2)), 2), nd.tile(nd.create(_x(2)), 2, 2)],
    "tad": lambda nd, I: [nd.arange(24).reshape(2, 3, 4)
                          .tensorAlongDimension(1, 2),
                          nd.arange(24).reshape(2, 3, 4)
                          .tensorAlongDimension(2, 0, 2)],
    "reductions": lambda nd, I: [
        nd.create(_x(2, 2)).sumNumber(), nd.create(_x(2, 2)).meanNumber(),
        nd.create(_x(2, 2)).maxNumber(), nd.create(_x(2, 2)).minNumber(),
        nd.create(_x(2, 2)).sum(0), nd.create(_x(2, 2)).sum(1),
        nd.create(_x(2, 2)).mean(0), nd.create(_x(2, 3, 4)).max(0, 2),
        nd.create(_x(2, 3, 4)).min(1, keepdims=True),
        nd.create(_x(2, 3) + 1).prod(1), nd.create(_x(2, 3) + 1).prod(),
        nd.create(_x(4)).std(), nd.create(_x(4)).std(biasCorrected=False),
        nd.create(_x(2, 3)).var(1),
        nd.create(np.array([[-3.0, 4.0]], np.float32)).norm1(),
        nd.create(np.array([[-3.0, 4.0]], np.float32)).norm2(),
        nd.create(np.array([[-3.0, 4.0]], np.float32)).normmax(),
        nd.create(np.array([1.0, 9.0, 3.0], np.float32)).argMax(),
        nd.create(_x(2, 3)).argMin(1), nd.create(_x(3) + 1).cumsum(),
        nd.create(_x(2, 3) + 1).cumprod(1),
        nd.create(np.array([0.25, 0.75], np.float32)).entropy(),
        nd.arange(4).sum()],
    "indexing": lambda nd, I: [
        nd.arange(12).reshape(3, 4).getRow(1),
        nd.arange(12).reshape(3, 4).getColumn(2),
        nd.arange(12).reshape(3, 4).getRows(0, 2),
        nd.arange(12).reshape(3, 4).getColumns(3, 1),
        nd.arange(12).reshape(3, 4)[1:, :2],
        nd.arange(12).reshape(3, 4).slice(1, axis=1),
        nd.create(_x(2, 3, 4)).get(I.all(), I.point(1)),
        nd.create(_x(2, 3, 4)).get(I.point(1), I.interval(0, 2)),
        nd.create(np.arange(10, dtype=np.float32)).get(I.interval(1, 2, 9)),
        nd.create(np.arange(10, dtype=np.float32)).get(
            I.interval(1, 2, 9, True)),
        nd.create(_x(2, 3, 4)).get(I.newAxis(), I.all(), I.point(0)),
        nd.create(_x(2, 3, 4)).get(I.point(0), I.indices(2, 0)),
        nd.create(_x(2, 3, 4)).get(I.point(1)),
        nd.create(_x(2, 3, 4)).get(0, slice(1, 3))],
    "put": lambda nd, I: [
        nd.zeros(2, 2).putScalar((0, 1), 5.0),
        nd.zeros(2, 2).putRow(1, nd.create(np.array([7.0, 8.0], np.float32))),
        nd.zeros(2, 3).putColumn(2, nd.create(np.array([1.0, 2.0],
                                                       np.float32))),
        nd.create(_x(2, 3, 4)).put((I.all(), I.interval(1, 3), I.point(0)),
                                   99.0),
        nd.create(np.zeros((3, 4), np.float32)).put(
            (I.interval(0, 2), I.interval(2, 4)),
            nd.create(np.ones((2, 2), np.float32) * 7))],
    "comparison": lambda nd, I: [
        nd.create(np.array([1.0, 5.0, 3.0], np.float32)).gt(2.0),
        nd.create(np.array([1.0, 5.0, 3.0], np.float32)).lte(3.0),
        nd.create(np.array([1.0, 5.0, 3.0], np.float32)) == 5.0,
        nd.create(np.array([1.0, 5.0, 3.0], np.float32)) != 5.0,
        nd.create(_x(2)).equals(nd.create(_x(2))),
        nd.create(_x(2)).equals(nd.create(_x(2) + 0.1)),
        nd.create(_x(2)).equalsWithEps(nd.create(_x(2) + 0.05), eps=0.1),
        nd.create(_x(2)).equals(nd.create(_x(3)))],
    "ordering": lambda nd, I: [
        nd.create(_x(3, 4)).ravel(order="f"),
        nd.create(_x(2, 3, 4)).ravel(order="f"),
        nd.create(_x(3, 4)).reshape(4, 3, order="f"),
        nd.create(_x(3, 4)).reshape(2, 6, order="f"),
        nd.create(_x(2, 3)).dup("f"), nd.create(_x(2, 3)).ordering()],
    "factory_misc": lambda nd, I: [
        nd.linspace(0.0, 1.0, 5), nd.zerosLike(nd.create(_x(2, 2))),
        nd.onesLike(nd.create(_x(2))), nd.where(nd.create(_x(4)) > 1.0),
        nd.where(nd.create(_x(3)) > 0.5, nd.create(_x(3)), nd.zeros(3)),
        nd.matmul(nd.create(_x(2, 3)), nd.create(_x(3, 2))),
        nd.dot(nd.create(_x(2, 3, 4)), nd.create(_x(4, 2))),
        nd.dot(nd.create(_x(3)), nd.create(_x(3))),
        nd.tensorMmul(nd.create(_x(2, 3)), nd.create(_x(3, 2)), 1),
        nd.kron(nd.create(_x(2, 2)), nd.eye(2)), nd.diag(nd.create(_x(3))),
        nd.gather(nd.create(_x(4, 2)), nd.create(np.array([3, 0], np.int32))),
        nd.scatterUpdate(nd.zeros(4, 2), nd.create(np.array([1, 3],
                                                            np.int32)),
                         nd.ones(2, 2)),
        nd.scatterAdd(nd.zeros(4), nd.create(np.array([1, 1, 2], np.int32)),
                      nd.ones(3)),
        nd.oneHot(nd.create(np.array([0, 2, 5], np.int32)), 3),
        nd.sort(nd.create(np.array([3.0, 1.0, 2.0], np.float32))),
        nd.sort(nd.create(np.array([3.0, 1.0, 2.0], np.float32)),
                descending=True),
        nd.argsort(nd.create(np.array([[3.0, 1.0, 1.0]], np.float32))),
        nd.topK(nd.create(np.array([[1.0, 5.0, 5.0, 2.0]], np.float32)), 2),
        nd.topK(nd.create(np.array([[1.0, 5.0], [3.0, 2.0]], np.float32)),
                1, axis=0),
        nd.defaultFloatingPointType() is not None],
    "host_data_dtypes": lambda nd, I: [
        nd.create(np.linspace(0.0, 1.0, 4)), nd.create(np.arange(4)),
        nd.create([1.5, 2.5]), nd.scalar(2), nd.create(np.arange(4)).sum(),
        nd.create(np.arange(4)).mean(), nd.create(np.arange(4)).argMax(),
        nd.create(_x(2)).add(np.linspace(0.0, 1.0, 2)),
        nd.create(np.arange(3)).add(np.arange(3)),
        nd.zeros(2, dtype="DOUBLE"), nd.create(_x(2)).castTo("LONG")],
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_scenario_matches_reference(name):
    fn = SCENARIOS[name]
    want = _out(fn(jnd.nd, jnd.NDArrayIndex))
    got = _out(fn(tnd.nd, tnd.NDArrayIndex))
    _same(got, want, name)


def test_inplace_variants_rebind_the_handle():
    """addi/muli/... rebind the wrapper (the reference's docstring); a
    handle held elsewhere sees the update, and a dup does not."""
    for pkg in (jnd, tnd):
        a = pkg.nd.create(np.array([1.0, 2.0], np.float32))
        ref, copy = a, a.dup()
        a.addi(1.0).muli(2.0).subi(1.0).divi(2.0).rsubi(5.0).rdivi(9.0)
        a.negi()
        t = pkg.nd.create(_x(2, 3)).transposei()
        a[0] = 7.0
        assert ref is a
        np.testing.assert_allclose(ref.toNumpy(), [7.0, -3.6], rtol=1e-6)
        np.testing.assert_array_equal(copy.toNumpy(), [1.0, 2.0])
        assert t.shape == (3, 2)


def test_dtype_names_roundtrip():
    for name in ("DOUBLE", "FLOAT", "HALF", "BFLOAT16", "LONG", "INT",
                 "SHORT", "BYTE", "UBYTE", "UINT16", "UINT32", "UINT64",
                 "BOOL"):
        t = tnd.dtypes.resolve(name)
        assert tnd.dtypes.name_of(t) == name
        assert jnd.dtypes.name_of(jnd.dtypes.resolve(name)) == name
        assert tnd.dtypes.is_floating(t) == jnd.dtypes.is_floating(
            jnd.dtypes.resolve(name))
        assert tnd.dtypes.is_integral(t) == jnd.dtypes.is_integral(
            jnd.dtypes.resolve(name))
    assert tnd.dtypes.resolve(np.float32) == torch.float32
    assert tnd.dtypes.resolve("float16") == torch.float16
    assert tnd.dtypes.resolve(float) == torch.float64
    tnd.nd.setDefaultDataTypes("DOUBLE", "LONG")
    try:
        assert tnd.nd.zeros(2).dataType() == "DOUBLE"
        assert tnd.nd.defaultFloatingPointType() == torch.float64
    finally:
        tnd.nd.setDefaultDataTypes("FLOAT", "INT")


def test_rand_under_set_seed_equals_reference_draw():
    """nd.rand/randomBernoulli and Random's draws are the reference's
    under the same seed, bit for bit; normal within a few ulps."""
    for seed in (0, 42, 2**40 + 3):
        jnd.nd.getRandom().setSeed(seed)
        tnd.nd.getRandom().setSeed(seed)
        for shape in ((3, 3), (17,)):
            a = tnd.nd.rand(*shape).toNumpy()
            b = np.asarray(jnd.nd.rand(*shape).toNumpy())
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(
            tnd.nd.randomBernoulli(0.3, 40).toNumpy(),
            np.asarray(jnd.nd.randomBernoulli(0.3, 40).toNumpy()))
        np.testing.assert_allclose(
            tnd.nd.randn(4, 8).toNumpy(),
            np.asarray(jnd.nd.randn(4, 8).toNumpy()), rtol=4e-6, atol=4e-6)
        jr, tr = jnd.getRandom(), tnd.getRandom()
        np.testing.assert_array_equal(
            tr.randint((30,), -5, 1000).numpy(),
            np.asarray(jr.randint((30,), -5, 1000)))
        np.testing.assert_array_equal(tr.permutation(25).numpy(),
                                      np.asarray(jr.permutation(25)))
        np.testing.assert_array_equal(
            tr.uniform((5,), 0.3, 0.7).numpy(),
            np.asarray(jr.uniform((5,), 0.3, 0.7)))
        np.testing.assert_array_equal(
            tr.bernoulli((12,), 0.6).numpy(),
            np.asarray(jr.bernoulli((12,), 0.6)))
        keys = tr.split(3)
        jkeys = jax.random.key_data(jr.split(3))
        np.testing.assert_array_equal(keys.numpy(), np.asarray(jkeys))
        assert tr.getSeed() == jr.getSeed() == seed


@pytest.mark.parametrize("dtype", ["float32", "float64", "bfloat16",
                                   "float16"])
def test_draws_by_dtype_equal_jax_random(dtype):
    """uniform in every float dtype (bit for bit, XLA's rounding of
    ``u * (max - min) + min`` reproduced), normal and exponential within
    a few ulps, gamma's Marsaglia-Tsang within a few ulps."""
    key = prng_key(11)
    jd, td = jnp.dtype(dtype), getattr(torch, dtype)

    def np64(t):
        return t.to(torch.float64).numpy()

    for lo, hi in ((0.0, 1.0), (-2.0, 2.0), (0.3, 0.7)):
        np.testing.assert_array_equal(
            np64(trandom.uniform(key, (40,), td, lo, hi)),
            np.asarray(jax.random.uniform(key, (40,), jd, lo, hi),
                       np.float64))
    ulps = float(torch.finfo(td).eps) * 8
    for t, j in ((trandom.normal(key, (60,), td),
                  jax.random.normal(key, (60,), jd)),
                 (trandom.exponential(key, (60,), td),
                  jax.random.exponential(key, (60,), jd))):
        np.testing.assert_allclose(np64(t), np.asarray(j, np.float64),
                                   rtol=ulps, atol=ulps)
    if dtype in ("float32", "float64"):
        np.testing.assert_allclose(
            np64(trandom.gamma(key, 3.0, (50,), td)),
            np.asarray(jax.random.gamma(key, 3.0, (50,), jd), np.float64),
            rtol=ulps * 4, atol=ulps * 4)


def test_autograd_through_the_facade():
    """``requires_grad`` passes through the NDArray's ops to the tensor
    (the port's counterpart of the reference's pytree registration), and
    the gradient is jax.grad's."""
    x = np.array([0.5, -1.0, 2.0], np.float32)
    a = tnd.NDArray(torch.tensor(x)).requires_grad_()
    assert a.requires_grad
    y = (a * a).add(a.mul(3.0)).sum()
    y.torch.backward()
    want = jax.grad(lambda v: jnp.sum(
        jnd.NDArray(v).mul(jnd.NDArray(v)).add(
            jnd.NDArray(v).mul(3.0)).sum().jax))(jnp.asarray(x))
    np.testing.assert_allclose(a.grad.toNumpy(), np.asarray(want))
    assert a.torch is a.torch and isinstance(a.torch, torch.Tensor)


def test_creation_without_a_card_raises_unless_cpu_asked():
    """Run in a fresh process (no default device set): without CUDA,
    creating an array or calling an op on numpy data raises naming
    ``device='cpu'``; with ``device="cpu"`` or ``setDefaultDevice("cpu")``
    it works; ``getBackend`` says "cpu" and importing touched no CUDA."""
    code = (
        "import numpy as np, torch\n"
        "import deeplearning4j_tpu_torch as p\n"
        "from deeplearning4j_tpu_torch import ops, nd, NDArray\n"
        "assert not torch.cuda.is_initialized()\n"
        "if torch.cuda.is_available():\n"
        "    print('card'); raise SystemExit\n"
        "for make in (lambda: nd.zeros(2), lambda: nd.create([1.0]),\n"
        "             lambda: NDArray(np.ones(2)), lambda: nd.rand(2),\n"
        "             lambda: ops.math.exp(np.ones(2, np.float32))):\n"
        "    try:\n"
        "        make()\n"
        "    except RuntimeError as e:\n"
        "        assert \"device='cpu'\" in str(e), e\n"
        "    else:\n"
        "        raise AssertionError('created without a card')\n"
        "assert nd.zeros(2, device='cpu').device.type == 'cpu'\n"
        "assert nd.getBackend() == 'cpu'\n"
        "nd.setDefaultDevice('cpu')\n"
        "assert ops.math.exp(np.ones(2, np.float32)).device.type == 'cpu'\n"
        "assert nd.getBackend() == 'cpu'\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() in ("ok", "card")


def test_ops_follow_their_inputs_device():
    """An op on CPU tensors stays on the CPU whatever the default device;
    numpy arguments join the tensors' device."""
    from deeplearning4j_tpu_torch import ops

    tnd.nd.setDefaultDevice(None)
    x = tnd.NDArray(torch.ones(3))
    out = ops.math.add(x, np.ones(3, np.float32))
    assert out.device.type == "cpu"
    assert out.toNumpy().tolist() == [2.0, 2.0, 2.0]
