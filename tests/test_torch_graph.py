"""The port's ComputationGraph and its configuration (``deeplearning4j_
tpu_torch/nn/conf/graph.py``, ``nn/computation_graph.py``) against the
JAX package's on the CPU, over the recipes of ``tests/
torch_graph_cases.py``:

- ``ComputationGraphConfiguration.to_json`` gives the reference's string
  byte for byte, and each package's ``from_json`` reads the other's;
- every vertex's forward (1e-5) and gradients (1e-4), relative to the
  largest |value|;
- seeded ``init`` gives the reference's trees (uniform draws bit for bit,
  normal draws within 4e-6 of the largest |value|), one key per node with
  parameters, AttentionVertex included;
- 3 ``fit`` steps of a two-input, two-output graph with a sequence mask,
  conf dropout, a DropoutLayer, BatchNormalization and l2 match the
  reference's losses and parameters within 1e-5 relative (and the
  attention-vertex graph's too);
- ``params()`` flattens in topological order while the updater state
  flattens in sorted-name order, both as the reference's; ``setParams``
  inverts ``params``; a frozen node keeps its parameters bit for bit.
The port's 64-bit switch is on, as the suite runs the reference.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deeplearning4j_tpu.nn as jnn
import deeplearning4j_tpu.train as jtrain
from deeplearning4j_tpu.data import MultiDataSet as JMDS
from deeplearning4j_tpu.nn.conf import graph as jgraph
import deeplearning4j_tpu_torch.nn as pnn
import deeplearning4j_tpu_torch.train as ptrain
from deeplearning4j_tpu_torch import nd
from deeplearning4j_tpu_torch.data import MultiDataSet as PMDS
from deeplearning4j_tpu_torch.nn.conf import graph as pgraph
from deeplearning4j_tpu_torch.train.updaters import tree_leaves, tree_map

import torch_graph_cases as G
import torch_nn_parity as H

REL = 1e-5
NORMAL_ABS = 4e-6


@pytest.fixture(autouse=True)
def _x64(tmp_path):
    from deeplearning4j_tpu_torch.util import crash_reporting
    crash_reporting.crashDumpOutputDirectory(str(tmp_path))
    with nd.enableX64(True):
        yield
    crash_reporting.crashDumpOutputDirectory(None)


def _confs(recipe):
    if recipe == "multi_io":
        return G.multi_io(jnn, jtrain), G.multi_io(pnn, ptrain)
    if recipe == "resnet_cut":
        kw = dict(num_classes=10, hw=32, blocks=(1, 1, 1, 1), width_div=8)
        return G.resnet50(jnn, jtrain, **kw), G.resnet50(pnn, ptrain, **kw)
    if recipe == "attention":
        kw = dict(d=8, heads=2, T=5, classes=3)
        return G.attention_graph(jnn, jtrain, **kw), G.attention_graph(pnn, ptrain, **kw)
    kw = dict(d=8, heads=2, T=5, classes=3,
              dtype="HALF" if recipe == "vertices_half" else "FLOAT")
    return (G.attention_vertex_graph(jnn, jtrain, jgraph, **kw),
            G.attention_vertex_graph(pnn, ptrain, pgraph, **kw))


@pytest.mark.parametrize("recipe", ["multi_io", "resnet_cut", "attention", "vertices",
                                    "vertices_half"])
def test_graph_json_equals_reference(recipe):
    jc, pc = _confs(recipe)
    js, ps = jc.to_json(), pc.to_json()
    assert ps == js
    assert pnn.ComputationGraphConfiguration.from_json(js).to_json() == js
    assert jnn.ComputationGraphConfiguration.from_json(ps).to_json() == ps
    assert [n.name for n in pc.topo_order()] == [n.name for n in jc.topo_order()]


def test_every_vertex_type_has_a_case():
    assert {c[1][0] for c in G.VERTEX_CASES} == set(G.VERTEX_NAMES)
    assert set(pgraph.VERTEX_TYPES) == set(jgraph.VERTEX_TYPES) == set(G.VERTEX_NAMES)


@pytest.mark.parametrize("case_id", [c[0] for c in G.VERTEX_CASES])
def test_vertex_forward_and_gradients(case_id):
    jv = G.make_vertex(jgraph, case_id)
    pv = G.make_vertex(pgraph, case_id)
    xs = G.vertex_inputs(case_id)
    masked = case_id.endswith("mask")
    n_float = len(xs) - (1 if masked else 0)
    has_params = getattr(jv, "has_params", False)
    params = H.np_tree(jv.init_params(jax.random.key(H.INIT_KEY), jnp.float32)) \
        if has_params else {}
    kw = (lambda p: {"params": p}) if has_params else (lambda p: {})

    def f(p, fl, ct):
        out = jv.apply(list(fl) + xs[n_float:], **kw(p))
        return jnp.sum(out * ct), out

    tp = tree_map(lambda a: torch.tensor(a).requires_grad_(), params)
    tx = [torch.tensor(x, requires_grad=i < n_float) for i, x in enumerate(xs)]
    out = pv.apply(tx, **kw(tp))
    ct = H.C.cotangent(tuple(out.shape))
    got = torch.autograd.grad((out * torch.tensor(ct)).sum(),
                              tree_leaves(tp) + tx[:n_float])
    (wp, wx), want = jax.jit(jax.grad(f, argnums=(0, 1), has_aux=True))(
        params, xs[:n_float], ct)
    H.close(out.detach().numpy(), want, H.FWD_REL, f"{case_id} forward")
    for a, b in zip(got, jax.tree_util.tree_leaves(wp) + list(wx)):
        H.close(a.numpy(), b, H.GRAD_REL, f"{case_id} gradient")


@pytest.mark.parametrize("recipe", ["multi_io", "vertices"])
def test_graph_seeded_init_equals_reference(recipe):
    jc, _ = _confs(recipe)
    jg = jnn.ComputationGraph(jc).init()
    pg = pnn.ComputationGraph(pnn.ComputationGraphConfiguration.from_json(jc.to_json()),
                              device="cpu").init()
    assert sorted(pg._params) == sorted(jg._params)
    want = jax.tree_util.tree_leaves(jg._params)
    got = tree_leaves(pg._params)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        w = np.asarray(w, np.float32)
        np.testing.assert_allclose(g.float().numpy(), w, rtol=0,
                                   atol=NORMAL_ABS * max(np.abs(w).max(), 1.0))
    for g, w in zip(tree_leaves(pg._state), jax.tree_util.tree_leaves(jg._state)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert pg.numParams() == jg.numParams()


def _port_of(jg):
    pg = pnn.ComputationGraph(pnn.ComputationGraphConfiguration.from_json(jg.conf.to_json()),
                              device="cpu").init()
    def host(t):  # bfloat16 leaves as float32 (exact); setParamTrees casts back
        return jax.tree_util.tree_map(
            lambda a: np.asarray(a, np.float32) if a.dtype == jnp.bfloat16 else np.asarray(a),
            t)
    return pg.setParamTrees(host(jg._params), host(jg._state))


def _same_params(pg, jg, what):
    H.close(pg.params().toNumpy().astype(np.float64),
            np.asarray(jg.params().jax, np.float64), REL, what)


def test_multi_io_fit_matches_reference():
    """3 steps of the two-input, two-output graph with a sequence mask,
    conf dropout, a DropoutLayer, BatchNormalization and l2: the losses,
    the parameters, BatchNormalization's running statistics."""
    jc, _ = _confs("multi_io")
    jg = jnn.ComputationGraph(jc).init()
    jg.fuseSteps = 0
    pg = _port_of(jg)
    for step in range(3):
        feats, labels, m2 = G.multi_io_data(seed=step)
        jg.fit(JMDS(feats, labels, [None, m2], None))
        pg.fit(PMDS(feats, labels, [None, m2], None))
        H.close(pg.score(), float(jg.score()), REL, f"loss {step}")
    _same_params(pg, jg, "params after 3 steps")
    for a, b in zip(tree_leaves(pg._state), jax.tree_util.tree_leaves(jg._state)):
        H.close(a.numpy(), np.asarray(b), REL, "running statistics")
    feats, labels, m2 = G.multi_io_data(seed=9)
    for a, b in zip(pg.output(*feats, features_masks=[None, m2]),
                    jg.output(*feats, features_masks=[None, m2])):
        H.close(a.toNumpy(), np.asarray(b.jax), REL, "output")
    ds_p, ds_j = PMDS(feats, labels), JMDS(feats, labels)
    H.close(pg.score(ds_p), jg.score(ds_j), REL, "score(dataset)")


def test_attention_vertex_graph_fit_matches_reference():
    """The HALF attention-vertex graph (AttentionVertex's parameters, the
    parameterless DotProductAttentionVertex): 2 steps, losses and params
    within bf16's rounding of the reference's."""
    jc, _ = _confs("vertices_half")
    jg = jnn.ComputationGraph(jc).init()
    jg.fuseSteps = 0
    pg = _port_of(jg)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((3, 5, 8)).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, 3)]
    for _ in range(2):
        jg.fit(JMDS([x], [y]))
        pg.fit(PMDS([x], [y]))
    assert abs(pg.score() - float(jg.score())) <= 2e-2 * abs(float(jg.score()))
    got = pg.params().toNumpy().astype(np.float64)
    want = np.asarray(jg.params().jax, np.float64)
    assert np.abs(got - want).max() <= 2e-2 * np.abs(want).max()


def test_params_order_and_updater_order():
    """On a graph whose node names sort differently from its topological
    order, params() is the reference's flat vector (topological order),
    the updater state's leaves are the reference's (sorted-name order, as
    optax flattens the name dict), and setParams inverts params."""
    jc, _ = _confs("multi_io")
    jg = jnn.ComputationGraph(jc).init()
    jg.fuseSteps = 0
    pg = _port_of(jg)
    order = [n.name for n in pg._order]
    assert order != sorted(order)
    feats, labels, m2 = G.multi_io_data()
    jg.fit(JMDS(feats, labels, [None, m2], None))
    pg.fit(PMDS(feats, labels, [None, m2], None))
    _same_params(pg, jg, "flat params")
    want = jax.tree_util.tree_leaves(jg._opt_state)
    got = tree_leaves(pg._opt_state)
    assert [tuple(a.shape) for a in got] == [tuple(np.shape(b)) for b in want]
    for a, b in zip(got, want):
        H.close(a.numpy(), np.asarray(b), REL, "updater state leaf")
    flat = pg.params().toNumpy()
    pg.setParams(np.arange(flat.size, dtype=np.float32))
    np.testing.assert_array_equal(pg.params().toNumpy(), np.arange(flat.size))
    jg.setParams(np.arange(flat.size, dtype=np.float32))
    for a, b in zip(tree_leaves(pg._params), jax.tree_util.tree_leaves(jg._params)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_frozen_node_keeps_its_parameters():
    """A frozen node's gradients and updates are zeroed: its parameters
    stay bit for bit while the rest train as the reference's do."""
    jc = G.multi_io(jnn, jtrain, frozen="lstm")
    jg = jnn.ComputationGraph(jc).init()
    jg.fuseSteps = 0
    pg = _port_of(jg)
    before = [t.clone() for t in tree_leaves(pg._params["lstm"])]
    for step in range(2):
        feats, labels, m2 = G.multi_io_data(seed=step)
        jg.fit(JMDS(feats, labels, [None, m2], None))
        pg.fit(PMDS(feats, labels, [None, m2], None))
    for a, b in zip(tree_leaves(pg._params["lstm"]), before):
        assert torch.equal(a, b)
    _same_params(pg, jg, "params with a frozen node")


def test_surface_feed_forward_evaluate_clone_summary():
    jc, _ = _confs("multi_io")
    jg = jnn.ComputationGraph(jc).init()
    pg = _port_of(jg)
    feats, labels, _ = G.multi_io_data()
    ff_p, ff_j = pg.feedForward(*feats), jg.feedForward(*feats)
    assert set(ff_p) == set(ff_j)
    for k in ff_j:
        H.close(ff_p[k].toNumpy(), np.asarray(ff_j[k].jax), REL, f"feedForward {k}")
    ev_p = pg.evaluate([PMDS(feats, labels)])
    ev_j = jg.evaluate([JMDS(feats, labels)])
    assert ev_p.accuracy() == ev_j.accuracy()
    other = pg.clone()
    np.testing.assert_array_equal(other.params().toNumpy(), pg.params().toNumpy())
    assert pg.summary() == jg.summary()
    H.close(pg.outputSingle(*feats).toNumpy(), np.asarray(jg.outputSingle(*feats).jax),
            REL, "outputSingle")
    assert pg.warmup(feats[0][0], feats[1][0], batch_sizes=(1, 2)) is pg
