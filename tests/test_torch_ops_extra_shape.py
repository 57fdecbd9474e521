"""The forward, the gradient and both default modes of every key that the
reference's ``ops/extra_defs.py`` defines in its ``shape`` and ``random``
namespaces, the port's registry against the JAX package's on the CPU
(``tests/torch_op_parity.py``; recipes and tolerances in
``tests/torch_op_cases.py``)."""
import pytest

from torch_op_parity import (
    check_forward, check_forward_32, check_gradient, grad_keys, keys_of)

KEYS = keys_of("shape", "random", modules=("extra_defs",))


@pytest.mark.parametrize("key", grad_keys(KEYS))
def test_gradient(key):
    check_gradient(key)


@pytest.mark.parametrize("key", KEYS)
def test_forward(key):
    check_forward(key)


@pytest.mark.parametrize("key", KEYS)
def test_forward_default_mode(key):
    check_forward_32(key)
