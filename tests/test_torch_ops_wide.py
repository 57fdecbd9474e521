"""The forward, the gradient and both default modes of every key that the
reference's ``ops/wide_defs.py`` defines in its ``updaters``, ``math``,
``shape``, ``loss`` and ``random`` namespaces (the rest:
``test_torch_ops_wide_nn.py``), the port's registry against the JAX
package's on the CPU (``tests/torch_op_parity.py``; recipes and tolerances
in ``tests/torch_op_cases.py``)."""
import pytest

from torch_op_parity import (
    check_forward, check_forward_32, check_gradient, grad_keys, keys_of)
from torch_threads import one_torch_thread  # noqa: F401,E402

KEYS = keys_of("updaters", "math", "shape", "loss", "random",
               modules=("wide_defs",))


@pytest.mark.parametrize("key", grad_keys(KEYS))
def test_gradient(key):
    check_gradient(key)


@pytest.mark.parametrize("key", KEYS)
def test_forward(key):
    check_forward(key)


@pytest.mark.parametrize("key", KEYS)
def test_forward_default_mode(key):
    check_forward_32(key)
