"""The port's weight inits and dropout variants
(``deeplearning4j_tpu_torch/nn/conf/weights.py``, ``dropout.py``) against
the JAX package's on the CPU: every ``WeightInit`` draws the reference's
weights from the same key (uniform draws bit for bit, normal draws within
4e-6 of the largest |value|: the last bits of ``erfinv`` differ between
XLA and torch); every dropout variant draws the reference's mask and
noise from the same key (masks bit for bit), with the port's 64-bit
switch on as the suite runs the reference (a Python float probability
then draws float64 uniforms on both sides).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.nn.conf import dropout as jdrop
from deeplearning4j_tpu.nn.conf import weights as jw
from deeplearning4j_tpu_torch import nd
from deeplearning4j_tpu_torch.models import random as prng
from deeplearning4j_tpu_torch.nn.conf import dropout as pdrop
from deeplearning4j_tpu_torch.nn.conf import weights as pw
from torch_threads import one_torch_thread  # noqa: F401,E402


NORMAL_ABS = 4e-6


@pytest.fixture(autouse=True)
def _x64():
    with nd.enableX64(True):
        yield


UNIFORM_INITS = ("XAVIER_UNIFORM", "RELU_UNIFORM", "HE_UNIFORM", "LECUN_UNIFORM",
                 "UNIFORM", "SIGMOID_UNIFORM")


@pytest.mark.parametrize("name,shape,fan_in,fan_out", [
    (n, s, fi, fo) for n in pw.NAMES for s, fi, fo in (((6, 6), 6, 6), ((4, 3, 2, 2), 12, 16))
    if n != "IDENTITY" or len(s) == 2])  # IDENTITY is square 2-d only, in both packages
def test_weight_init_from_same_key(name, shape, fan_in, fan_out):
    for seed in (0, 5):
        want = np.asarray(jw.init(name, jax.random.key(seed), shape, fan_in, fan_out))
        got = pw.init(name, prng.prng_key(seed), shape, fan_in, fan_out,
                      device="cpu").numpy()
        assert got.dtype == want.dtype == np.float32
        if name in UNIFORM_INITS or name in ("ZERO", "ONES", "IDENTITY"):
            np.testing.assert_array_equal(got, want)
        else:
            np.testing.assert_allclose(got, want, rtol=0,
                                       atol=NORMAL_ABS * max(np.abs(want).max(), 1.0))


def test_unknown_weight_init_refused():
    with pytest.raises(ValueError, match="unknown WeightInit"):
        pw.init("NOPE", prng.prng_key(0), (2, 2), 2, 2, device="cpu")


DROPOUTS = [
    ("Dropout", dict(p=0.7)), ("GaussianDropout", dict(rate=0.3)),
    ("GaussianNoise", dict(stddev=0.2)), ("AlphaDropout", dict(p=0.8)),
    ("SpatialDropout", dict(p=0.6)), ("SpatialDropout", dict(p=0.6, rnnDataFormat="NCW")),
]


@pytest.mark.parametrize("name,kw", DROPOUTS, ids=[f"{n}-{i}" for i, (n, _) in enumerate(DROPOUTS)])
@pytest.mark.parametrize("shape", [(4, 9), (3, 5, 6), (2, 3, 4, 4)])
def test_dropout_variant_equals_reference(name, kw, shape):
    x = np.random.default_rng(2).standard_normal(shape).astype(np.float32)
    j = getattr(jdrop, name)(**kw)
    p = getattr(pdrop, name)(**kw)
    assert p.to_dict() == j.to_dict()
    assert pdrop.IDropout.from_dict(j.to_dict()) == p
    for seed in (0, 9):
        want = np.asarray(j.apply(jax.random.key(seed), jnp.asarray(x)))
        got = p.apply(prng.prng_key(seed), torch.tensor(x)).numpy()
        if name in ("GaussianDropout", "GaussianNoise"):
            np.testing.assert_allclose(got, want, rtol=0, atol=NORMAL_ABS)
        else:
            # the same entries dropped; kept ones equal to the last bit
            np.testing.assert_array_equal(got == 0, want == 0)
            np.testing.assert_allclose(got, want, rtol=1e-7, atol=0)


@pytest.mark.parametrize("keep", [0.5, 0.9, 1.0])
def test_float_dropout_mask_bit_equal(keep):
    x = np.random.default_rng(3).standard_normal((5, 7)).astype(np.float32)
    for seed in (1, 2):
        want = np.asarray(jdrop.apply_dropout(keep, jax.random.key(seed), jnp.asarray(x)))
        got = pdrop.apply_dropout(keep, prng.prng_key(seed), torch.tensor(x)).numpy()
        np.testing.assert_array_equal(got, want)
