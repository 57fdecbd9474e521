"""The port's Keras import (``deeplearning4j_tpu_torch/modelimport/keras``)
held against the JAX package's on the CPU, from the same h5 files.

The fixtures are the reference's: each test of ``tests/test_keras_import.py``
is run once a module with its ``KerasModelImport`` wrapped, so every h5
file its body writes with ``tf.keras`` is kept with the network the JAX
package imported from it (its parameters and state as they were right
after the import), each ``output``/``outputSingle`` call made on that
network before any ``fit`` (input and answer), or the exception the
import raised. The port then imports the same file: every converted
weight and every state array equal to the reference's bit for bit (both
run the same numpy layout conversion), each recorded output within 1e-5
of its largest |value| (absolute, fp32), and the same exception type
where the reference raised — and the same warning where it warned.
The port's 64-bit switch is on, as the suite runs the reference.
"""
import inspect
import warnings

import jax
import numpy as np
import pytest

import test_keras_import as R
from deeplearning4j_tpu_torch import nd
from deeplearning4j_tpu_torch.modelimport.keras import KerasModelImport
from deeplearning4j_tpu_torch.train.updaters import tree_leaves
from torch_threads import one_torch_thread  # noqa: F401

TOL = 1e-5



def _reference_tests():
    """(class or None, test name) of every reference test that imports a
    file, in definition order."""
    def imports(fn):
        return "KerasModelImport." in inspect.getsource(fn)

    out = []
    for name, obj in vars(R).items():
        if name.startswith("test_") and callable(obj) and imports(obj):
            out.append((None, name))
        elif name.startswith("Test") and isinstance(obj, type):
            out += [(name, m) for m, fn in vars(obj).items()
                    if m.startswith("test_") and imports(fn)]
    return out


CASES = _reference_tests()


class _Imported:
    """One reference import: the file, the entry point, the network's
    parameters and state at import, its outputs before any fit, the
    warnings the import raised — or the exception."""

    def __init__(self, path, entry):
        self.path, self.entry = path, entry
        self.net = self.error = None
        self.params = self.state = None
        self.calls, self.warned, self.fitted, self.depth = [], [], False, 0

    def watch(self, net):
        self.net = net
        self.params = np.asarray(net.params().toNumpy())
        self.state = [np.asarray(x) for x in jax.tree_util.tree_leaves(net._state)]
        for meth in ("output", "outputSingle"):
            if hasattr(net, meth):
                setattr(net, meth, self._recording(meth, getattr(net, meth)))
        fit = net.fit

        def fitting(*a, **k):
            self.fitted = True
            return fit(*a, **k)

        net.fit = fitting

    def _recording(self, meth, fn):
        def call(x, *a, **k):   # the outermost call only (outputSingle calls output)
            self.depth += 1
            try:
                out = fn(x, *a, **k)
            finally:
                self.depth -= 1
            if not self.fitted and not a and not k and not self.depth:
                self.calls.append((meth, np.array(x), _numpy(out)))
            return out
        return call


def _numpy(out):
    """An output (an NDArray, or a graph's list of them) as numpy."""
    if isinstance(out, (list, tuple)):
        return [np.asarray(o.toNumpy()) for o in out]
    return [np.asarray(out.toNumpy())]


@pytest.fixture(scope="module")
def recorded(tmp_path_factory):
    """{(class, test): [_Imported]} from one run of each reference test's
    body; the module's random generator is restored after."""
    rec, log = {}, []
    ref_import = R.KerasModelImport

    def entry(name):
        def run(path, *a, **k):
            imp = _Imported(path, name)
            log.append(imp)
            try:
                with warnings.catch_warnings(record=True) as w:
                    warnings.simplefilter("always")
                    net = getattr(ref_import, name)(path, *a, **k)
                imp.warned = [str(x.message) for x in w]
                for x in w:   # the reference test may assert on them
                    warnings.warn_explicit(x.message, x.category, x.filename, x.lineno)
            except Exception as e:
                imp.error = e
                raise
            imp.watch(net)
            return net
        return staticmethod(run)

    wrapped = type("KerasModelImport", (), {
        n: entry(n) for n in ("importKerasSequentialModelAndWeights",
                              "importKerasModelAndWeights")})
    state = R.RNG.bit_generator.state
    try:
        R.KerasModelImport = wrapped
        for cls, name in CASES:
            log = []
            fn = getattr(getattr(R, cls)(), name) if cls else getattr(R, name)
            tmp = tmp_path_factory.mktemp(name)
            try:
                with warnings.catch_warnings():
                    warnings.simplefilter("ignore")
                    if "tmp_path" in fn.__code__.co_varnames[:fn.__code__.co_argcount]:
                        fn(tmp)
                    else:
                        fn()
            except Exception:   # the reference's own checks are its tests'
                pass
            rec[cls, name] = log
    finally:
        R.KerasModelImport = ref_import
        R.RNG.bit_generator.state = state
    return rec


@pytest.mark.parametrize("case", CASES, ids=[f"{c}::{n}" if c else n for c, n in CASES])
def test_reference_fixtures(recorded, case):
    imports = recorded[case]
    assert imports, f"{case}: the reference test imported no file"
    for imp in imports:
        with nd.enableX64(True), warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            try:
                net = getattr(KerasModelImport, imp.entry)(imp.path, device="cpu")
                err = None
            except Exception as e:
                net, err = None, e
        if imp.error is not None:
            assert type(err) is type(imp.error), (case, imp.error, err)
            continue
        assert err is None, (case, err)
        assert [str(x.message) for x in w if "Keras" in str(x.message)] == \
            [m for m in imp.warned if "Keras" in m], case
        np.testing.assert_array_equal(net.params().toNumpy(), imp.params, err_msg=str(case))
        got_state = [t.numpy() for t in tree_leaves(net._state)]
        assert len(got_state) == len(imp.state), case
        for a, b in zip(got_state, imp.state):
            np.testing.assert_array_equal(a, b, err_msg=str(case))
        for meth, x, wants in imp.calls:
            with nd.enableX64(True):
                gots = _numpy(getattr(net, meth)(x))
            assert len(gots) == len(wants), case
            for got, want in zip(gots, wants):
                assert got.shape == want.shape, (case, got.shape, want.shape)
                np.testing.assert_allclose(got, want,
                                           atol=TOL * max(np.abs(want).max(), 1.0),
                                           err_msg=str(case))
    assert any(imp.calls or imp.error or imp.warned for imp in imports), case
