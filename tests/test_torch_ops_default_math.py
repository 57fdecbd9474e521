"""The forward of every key of the port's ``math``, ``bitwise``,
``reduce``, ``shape``, ``linalg`` and ``random`` namespaces
with both packages in their default modes (the reference without
``jax_enable_x64``, the port with its 64-bit switch off) on the CPU
(``tests/torch_op_parity.py`` ``check_forward_32``; recipes and
tolerances in ``tests/torch_op_cases.py``): each output has the
reference's dtype, so none is 64-bit, and its value."""
import pytest

from torch_op_parity import check_forward_32, keys_of

KEYS = keys_of('math', 'bitwise', 'reduce', 'shape', 'linalg', 'random')


@pytest.mark.parametrize("key", KEYS)
def test_forward_default_mode(key):
    check_forward_32(key)
