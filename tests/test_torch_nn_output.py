"""The port's RepeatVector, LastTimeStep, output and loss layers and
SelfAttentionLayer (``deeplearning4j_tpu_torch/nn/conf/layers.py``)
against the JAX package's on the CPU, as ``tests/test_torch_nn_layers.py``
holds the others: forward in both modes and every gradient, the sequence
cases also with a features mask, through the harness of
``tests/torch_nn_parity.py`` (1e-5 forward, 1e-4 gradients, relative to
the largest |value|). Also: SelfAttentionLayer's kernel route
(``attentionKernel=True``) against the reference's Pallas kernel in
interpret mode, and its refusal without projections.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deeplearning4j_tpu.nn as jnn
import deeplearning4j_tpu_torch.nn as pnn
from deeplearning4j_tpu_torch import nd
from deeplearning4j_tpu_torch.train.updaters import tree_leaves, tree_map

import torch_nn_cases as C
import torch_nn_parity as H
from torch_threads import one_torch_thread  # noqa: F401,E402

IDS = C.CASE_IDS[C.CASE_IDS.index("repeat_vector"):]


@pytest.fixture(autouse=True)
def _x64():
    with nd.enableX64(True):
        yield


@pytest.mark.parametrize("case_id,training,masked", list(H.variants(IDS)))
def test_layer_forward_and_gradients(case_id, training, masked):
    H.check_case(case_id, training, masked)


def test_self_attention_kernel_needs_projection():
    """attentionKernel=True with projectInput=False raises the reference's
    ValueError, in both packages."""
    x = np.zeros((1, 8, 4), np.float32)
    for pkg, arr in ((jnn, jnp.asarray(x)), (pnn, torch.tensor(x))):
        layer = pkg.layers.SelfAttentionLayer(nIn=4, projectInput=False,
                                              attentionKernel=True)
        with pytest.raises(ValueError, match="requires projectInput=True"):
            layer.apply({}, arr)


@pytest.mark.parametrize("case_id", ["self_attention"])
def test_self_attention_kernel_route_matches_interpret_kernel(case_id):
    """attentionKernel=True on both sides: the reference's Pallas packed
    kernel in interpret mode against the port's kernel route (its plain
    versions on the CPU), forward and gradients, same tolerances."""
    jl, _ = C.build(jnn, case_id)
    pl, _ = C.build(pnn, case_id)
    jl.attentionKernel = pl.attentionKernel = True
    params = H.np_tree(jl.init_params(jax.random.key(H.INIT_KEY), jnp.float32))
    x, _ = C.inputs(case_id)

    def f(params, x, ct):
        out, _ = jl.apply(params, x)
        return jnp.sum(out * ct), out

    tp = tree_map(lambda a: torch.tensor(a).requires_grad_(), params)
    xt = torch.tensor(x, requires_grad=True)
    out, _ = pl.apply(tp, xt)
    ct = C.cotangent(tuple(out.shape))
    grads = torch.autograd.grad((out * torch.tensor(ct)).sum(), tree_leaves(tp) + [xt])
    (rg, rx), ref_out = jax.grad(f, argnums=(0, 1), has_aux=True)(params, x, ct)
    H.close(out.detach().numpy(), ref_out, H.FWD_REL, "kernel route forward")
    for a, b in zip(grads, jax.tree_util.tree_leaves(rg) + [rx]):
        H.close(a.numpy(), b, H.GRAD_REL, "kernel route gradient")
