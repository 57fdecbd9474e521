"""The scenarios of ``tests/test_torch_ndarray.py`` with both packages in
their default modes (the reference without ``jax_enable_x64``, the port
with its 64-bit switch off, ``nd.enableX64``): Python and numpy data,
sums, means, indices and 64-bit requests come out 32-bit in both, with
the same values."""
import jax
import pytest

import deeplearning4j_tpu.ndarray as jnd
import deeplearning4j_tpu_torch.ndarray as tnd
from test_torch_ndarray import SCENARIOS, _out, _same


@pytest.fixture(autouse=True)
def _host_arrays_default_mode():
    tnd.nd.setDefaultDevice("cpu")
    with jax.enable_x64(False), tnd.nd.enableX64(False):
        yield
    tnd.nd.setDefaultDevice(None)


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_scenario_matches_reference_default_mode(name):
    fn = SCENARIOS[name]
    want = _out(fn(jnd.nd, jnd.NDArrayIndex))
    got = _out(fn(tnd.nd, tnd.NDArrayIndex))
    _same(got, want, f"{name} (default mode)")
