"""The port's SameDiff (``deeplearning4j_tpu_torch/autodiff/samediff.py``)
held against the JAX package's on the CPU: the cases of
``tests/test_samediff.py`` built by the same code in both packages from
the same numpy inputs.

Tolerances: outputs and gradients of one graph within 1e-6 (relative,
fp32, an op at a time against XLA's fused program); fit trajectories
within 1e-5 relative over tens of Adam steps; values drawn through
``weightInit`` within 4e-6 (the normal draws' ``erfinv`` differs in its
last bits, ``ROADMAP.md``); bf16 compute (``computeDtype="HALF"``)
within 2e-2 relative of the reference's bf16 losses. Names, the variable
table and the recorded dtypes are equal. Files cross both ways. The
port's 64-bit switch is on, as the suite runs the reference.
"""
import json
import zipfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deeplearning4j_tpu.autodiff as rad
import deeplearning4j_tpu.data as rdata
import deeplearning4j_tpu.eval as reval
import deeplearning4j_tpu.train as rtrain
import deeplearning4j_tpu_torch.autodiff as pad
import deeplearning4j_tpu_torch.data as pdata
import deeplearning4j_tpu_torch.eval as peval
import deeplearning4j_tpu_torch.train as ptrain
from deeplearning4j_tpu_torch import nd

import test_golden_trajectories as G
from torch_threads import one_torch_thread  # noqa: F401,E402

REL = 1e-5


@pytest.fixture(autouse=True)
def _x64():
    with nd.enableX64(True):
        yield


class _Pkg:
    def __init__(self, ad, data, train, ev, dt, port):
        self.SameDiff = ad.SameDiff
        self.TrainingConfig = ad.TrainingConfig
        self.DataSet, self.ListDataSetIterator = data.DataSet, data.ListDataSetIterator
        self.Adam, self.Sgd, self.L2 = train.Adam, train.Sgd, train.L2
        self.Evaluation = ev.Evaluation
        self.f32, self.i32, self.bool_ = dt
        self.port = port

    def create(self):
        return self.SameDiff.create("cpu") if self.port else self.SameDiff.create()

    def load(self, path):
        return self.SameDiff.load(path, device="cpu") if self.port \
            else self.SameDiff.load(path)


REF = _Pkg(rad, rdata, rtrain, reval, (jnp.float32, jnp.int32, jnp.bool_), False)
PORT = _Pkg(pad, pdata, ptrain, peval, (torch.float32, torch.int32, torch.bool), True)
BOTH = (REF, PORT)


def _np(x):
    return np.asarray(x.toNumpy())


def _close(a, b, rel=1e-6):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape, (a.shape, b.shape)
    np.testing.assert_allclose(a, b, rtol=rel, atol=rel * max(np.abs(b).max(), 1.0))


def _graph_json(sd, tmp_path, tag):
    p = str(tmp_path / f"{tag}.zip")
    sd.save(p)
    with zipfile.ZipFile(p) as zf:
        return json.loads(zf.read("graph.json"))


# ---------------------------------------------------------------- graph


def _chain(P):
    sd = P.create()
    x = sd.placeHolder("x", shape=(None, 3))
    w = sd.var("w", np.ones((3, 2), np.float32))
    b = sd.var("b", np.zeros((2,), np.float32))
    z = x.mmul(w) + b
    sd.math.tanh(z).rename("y")
    s = sd.reduce.mean(sd.math.mul(z, 2.0))       # a literal: lit_N
    sd.constant(np.array([1.0, 2.0]))              # const_N
    sd.math.add(s, 0.5)
    return sd


def test_graph_names_values_and_file_records_match(tmp_path):
    xv = np.array([[1.0, 2.0, 3.0], [0.5, -1.0, 2.0]], np.float32)
    r, p = _chain(REF), _chain(PORT)
    assert list(r._vars) == list(p._vars)
    assert [(o.namespace, o.opname, o.inputs, o.outputs) for o in r._ops] == \
        [(o.namespace, o.opname, o.inputs, o.outputs) for o in p._ops]
    _close(_np(p.output({"x": xv}, "y")["y"]), _np(r.output({"x": xv}, "y")["y"]))
    assert p.summary() == r.summary()
    # graph.json: the same variables, shapes and dtype strings — but for
    # the op of a float32 tensor and a Python literal: with the 64-bit
    # switch on the reference records float64 there (its eval_shape sees
    # the literal strongly typed) while the value it computes is float32,
    # which the port records (a known difference, ROADMAP.md)
    pv, rv = _graph_json(p, tmp_path, "p")["vars"], _graph_json(r, tmp_path, "r")["vars"]
    assert [v["name"] for v in pv] == [v["name"] for v in rv]
    lit_ops = set()
    for o in r._ops:   # the ops downstream of a literal
        if any(i.startswith("lit_") or i in lit_ops for i in o.inputs):
            lit_ops.update(o.outputs)
    last = r._ops[-1].outputs[0]
    assert [v for v in pv if v["name"] not in lit_ops] == \
        [v for v in rv if v["name"] not in lit_ops]
    for a, b in zip(pv, rv):
        if a["name"] in lit_ops:
            assert (a["dtype"], b["dtype"]) == ("float32", "float64")
            assert a["shape"] == b["shape"]
    assert lit_ops and last in lit_ops
    _close(_np(p.output({"x": xv}, last)[last]), _np(r.output({"x": xv}, last)[last]))
    assert p.output({"x": xv}, last)[last].torch.dtype == torch.float32
    assert r.output({"x": xv}, last)[last].dataType() == "FLOAT"


def test_basic_math_variable_types_and_reductions():
    for P in BOTH:
        sd = P.create()
        a = sd.constant("a", np.array([1.0, 2.0]))
        b = sd.constant("b", np.array([3.0, 4.0]))
        np.testing.assert_allclose(_np((a + b).eval()), [4, 6])
        v = sd.var("v", np.zeros((2, 2)))
        c = sd.constant("c", 1.0)
        ph = sd.placeHolder("p", shape=(2, 2))
        assert (v.varType, c.varType, ph.varType) == ("VARIABLE", "CONSTANT", "PLACEHOLDER")
        x = sd.constant("x", np.array([[1.0, 2.0], [3.0, 4.0]]))
        np.testing.assert_allclose(_np(x.sum(1).eval()), [3, 7])
        assert float(_np(sd.reduce.mean(x).eval())) == 2.5


def test_graph_device_is_per_thread():
    """A graph runs its creation ops on its own device in the calling
    thread only: two threads interleaving ``device_scope`` each see their
    own device, and graphs run from threads at once leave the
    process-wide default (``nd.setDefaultDevice``) as the user set it."""
    import threading

    from deeplearning4j_tpu_torch.ndarray import dtypes as _dt

    entered, switched = threading.Event(), threading.Event()
    seen = {}

    def first():
        with _dt.device_scope(torch.device("cpu")):
            entered.set()
            switched.wait(10)
            seen["first"] = _dt.array_device()

    def second():
        entered.wait(10)
        with _dt.device_scope(torch.device("meta")):
            seen["second"] = _dt.array_device()
        switched.set()

    ts = [threading.Thread(target=f) for f in (first, second)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    assert seen == {"first": torch.device("cpu"), "second": torch.device("meta")}

    sd = PORT.create()
    x = sd.placeHolder("x", shape=(3,))
    y = x + sd.shapes.eye(n=3).sum(0)
    errors = []

    def run():
        try:
            for _ in range(100):
                out = sd.output({"x": np.ones(3)}, [y.name])[y.name].torch
                assert out.device.type == "cpu" and out.tolist() == [2.0, 2.0, 2.0]
        except Exception as e:   # surfaced in the main thread below
            errors.append(e)

    prev = _dt.defaults.device
    nd.setDefaultDevice("meta")
    try:
        ts = [threading.Thread(target=run) for _ in range(4)]
        for t in ts:
            t.start()
        for t in ts:
            t.join()
        assert _dt.defaults.device == torch.device("meta")
    finally:
        nd.setDefaultDevice(prev)
    assert errors == []
    assert _dt.array_device() == prev


def test_multi_output_op_names_and_values():
    rng = np.random.default_rng(3)
    B, T, I, H = 2, 3, 4, 5
    w = rng.normal(size=(I, 4 * H)).astype(np.float32) * 0.1
    rw = rng.normal(size=(H, 4 * H)).astype(np.float32) * 0.1
    xv = rng.random((B, T, I)).astype(np.float32)
    outs = []
    for P in BOTH:
        sd = P.create()
        x = sd.placeHolder("x", shape=(B, T, I))
        h0 = sd.constant("h0", np.zeros((B, H), np.float32))
        c0 = sd.constant("c0", np.zeros((B, H), np.float32))
        ys, (hT, cT) = sd.rnn.lstmLayer(x, h0, c0, sd.var("w", w), sd.var("rw", rw),
                                         sd.var("b", np.zeros((4 * H,), np.float32)))
        names = [ys.name, hT.name, cT.name]
        res = sd.output({"x": xv}, names)
        outs.append((names, list(sd._vars), [_np(res[n]) for n in names]))
    assert outs[0][0] == outs[1][0] == ["lstmLayer_1#0", "lstmLayer_1#1.0", "lstmLayer_1#1.1"]
    assert outs[0][1] == outs[1][1]
    for a, b in zip(outs[1][2], outs[0][2]):
        _close(a, b)


def test_calculate_gradients_and_gradient_variables():
    xv = np.array([[0.5, -0.5], [1.0, 2.0]], np.float32)
    got = []
    for P in BOTH:
        sd = P.create()
        w = sd.var("w", np.array([2.0, 3.0], np.float32))
        (w * w).sum().rename("loss")
        sd.setLossVariables("loss")
        g1 = _np(sd.calculateGradients({}, ["w"])["w"])
        assert sd.getVariable("w").gradient() is not None
        sd2 = P.create()
        x = sd2.placeHolder("x", shape=(None, 2))
        w2 = sd2.var("w", np.array([[0.3], [-0.7]], np.float32))
        out = sd2.math.tanh(x.mmul(w2))
        (out * out).sum().rename("loss")
        sd2.setLossVariables("loss")
        got.append((g1, _np(sd2.calculateGradients({"x": xv}, ["w"])["w"])))
    np.testing.assert_allclose(got[1][0], [4.0, 6.0])
    _close(got[1][1], got[0][1])


def test_random_and_updaters_namespaces():
    key = np.asarray(jax.random.PRNGKey(0))
    got = []
    for P in BOTH:
        sd = P.create()
        r = sd.random.normal(sd.constant("key", key), shape=(4,))
        sd2 = P.create()
        u = sd2.updaters.sgdUpdater(sd2.var("g", np.ones(3, np.float32)), lr=0.5)
        got.append((_np(sd.output({}, r.name)[r.name]), _np(sd2.output({}, u.name)[u.name])))
    np.testing.assert_allclose(got[1][0], got[0][0], rtol=0, atol=4e-6)
    np.testing.assert_allclose(got[1][1], 0.5)


def test_weight_init_draws_the_reference_bits():
    vals = []
    for P in BOTH:
        sd = P.create()
        sd.placeHolder("x", shape=(None, 4))
        sd.var("w", (4, 8), weightInit="XAVIER", seed=7)
        sd.var("u", (8, 3), weightInit="XAVIER_UNIFORM", seed=7)
        vals.append([_np(sd.getVariable(n).getArr()) for n in ("w", "u")])
    np.testing.assert_allclose(vals[1][0], vals[0][0], rtol=0, atol=4e-6)
    np.testing.assert_array_equal(vals[1][1], vals[0][1])   # uniform: bit for bit


# ------------------------------------------------------------- training


def _linreg(P):
    rng = np.random.default_rng(0)
    X = rng.normal(size=(256, 3)).astype(np.float32)
    Y = X @ np.array([[1.5], [-2.0], [0.5]], np.float32) + 0.3
    sd = P.create()
    x = sd.placeHolder("x", shape=(None, 3))
    y = sd.placeHolder("y", shape=(None, 1))
    w = sd.var("w", np.zeros((3, 1), np.float32))
    b = sd.var("b", np.zeros((1,), np.float32))
    sd.loss.mse(y, x.mmul(w) + b).rename("loss")
    sd.setLossVariables("loss")
    sd.setTrainingConfig(P.TrainingConfig(updater=P.Adam(0.1),
                                          dataSetFeatureMapping=["x"],
                                          dataSetLabelMapping=["y"]))
    return sd, P.ListDataSetIterator([P.DataSet(X, Y)], batch_size=64)


def _softmax_clf(P, zeros=False):
    rng = np.random.default_rng(1)
    X = rng.normal(size=(200, 4)).astype(np.float32)
    labels = (X[:, 0] + X[:, 1] > 0).astype(int)
    Y = np.eye(2, dtype=np.float32)[labels]
    sd = P.create()
    x = sd.placeHolder("x", shape=(None, 4))
    y = sd.placeHolder("y", shape=(None, 2))
    w = sd.var("w", np.zeros((4, 2), np.float32)) if zeros \
        else sd.var("w", (4, 2), weightInit="XAVIER", seed=7)
    b = sd.var("b", np.zeros((2,), np.float32))
    sd.nn.softmax(x.mmul(w) + b).rename("probs")
    sd.loss.mcxent(y, sd.getVariable("probs")).rename("loss")
    sd.setLossVariables("loss")
    sd.setTrainingConfig(P.TrainingConfig(updater=P.Adam(0.05),
                                          dataSetFeatureMapping=["x"],
                                          dataSetLabelMapping=["y"]))
    return sd, X, Y, labels


def test_linear_regression_trajectory():
    runs = []
    for P in BOTH:
        sd, it = _linreg(P)
        hist = sd.fit(it, epochs=20)
        runs.append((hist, _np(sd.getVariable("w").getArr()), _np(sd.getVariable("b").getArr())))
    (rh, rw, rb), (ph, pw, pb) = runs
    assert len(ph) == len(rh) == 80
    np.testing.assert_allclose(ph, rh, rtol=REL)
    _close(pw, rw, REL)
    _close(pb, rb, REL)


def test_softmax_classifier_trajectory_and_accuracy():
    runs = []
    for P in BOTH:
        sd, X, Y, labels = _softmax_clf(P)
        hist = sd.fit(P.DataSet(X, Y), epochs=40)
        pred = _np(sd.output({"x": X}, "probs")["probs"]).argmax(-1)
        runs.append((hist, (pred == labels).mean()))
    np.testing.assert_allclose(runs[1][0], runs[0][0], rtol=1e-4)
    assert runs[1][1] == runs[0][1] and runs[1][1] > 0.95


def test_regularization_and_evaluate():
    for P in BOTH:
        sd = P.create()
        w = sd.var("w", np.array([10.0], np.float32))
        (w * w).sum().rename("loss")
        sd.setLossVariables("loss")
        sd.setTrainingConfig(P.TrainingConfig(updater=P.Sgd(0.1), regularization=[P.L2(0.1)]))
        sd.fit({}, epochs=1)
        # d/dw (w^2 + 0.1 w^2) = 22 at w = 10: one SGD step to 7.8
        np.testing.assert_allclose(_np(sd.getVariable("w").getArr()), [7.8], rtol=1e-6)
    accs = []
    for P in BOTH:
        sd, X, Y, _ = _softmax_clf(P, zeros=True)
        sd.fit(P.ListDataSetIterator([P.DataSet(X, Y)], batch_size=64), epochs=10)
        ev = sd.evaluate(P.ListDataSetIterator([P.DataSet(X, Y)], batch_size=64),
                         "probs", P.Evaluation())
        accs.append(ev.accuracy())
    assert accs[1] == accs[0] and accs[1] > 0.9


def test_golden_samediff_mse_adam():
    """The reference's golden trajectory (tests/goldens/samediff_mse_adam.json),
    its case built by the port."""
    with open(f"{G.GOLDEN_DIR}/samediff_mse_adam.json") as f:
        golden = json.load(f)
    rng = np.random.RandomState(17)
    P = PORT
    sd = P.create()
    x = sd.placeHolder("x", shape=(None, 4))
    y = sd.placeHolder("y", shape=(None, 1))
    w = sd.var("w", (rng.rand(4, 8).astype(np.float32) - 0.5))
    b = sd.var("b", np.zeros((8,), np.float32))
    w2 = sd.var("w2", (rng.rand(8, 1).astype(np.float32) - 0.5))
    sd.loss.mse(y, sd.math.tanh(x.mmul(w) + b).mmul(w2)).rename("loss")
    sd.setLossVariables("loss")
    sd.setTrainingConfig(P.TrainingConfig(updater=P.Adam(1e-2), dataSetFeatureMapping=["x"],
                                          dataSetLabelMapping=["y"]))
    losses = [sd.fit(P.DataSet(rng.rand(16, 4).astype(np.float32),
                               rng.rand(16, 1).astype(np.float32)))[-1] for _ in range(5)]
    leaves = [_np(sd.getVariable(n).getArr()) for n in ("w", "b", "w2")]
    np.testing.assert_allclose(losses, golden["losses"], rtol=G.RTOL)
    assert sum(float(np.abs(l).sum()) for l in leaves) == \
        pytest.approx(golden["param_abs_sum"], rel=G.RTOL)
    assert sum(float((l.astype(np.float64) ** 2).sum()) for l in leaves) == \
        pytest.approx(golden["param_sq_sum"], rel=G.RTOL)


def _mixed(P, compute_dtype):
    rng = np.random.default_rng(4)
    X = rng.normal(size=(128, 6)).astype(np.float32)
    W = rng.normal(size=(6, 3)).astype(np.float32)
    Y = (X @ W + rng.normal(size=(128, 3)) * 0.05).astype(np.float32)
    sd = P.create()
    x = sd.placeHolder("x", shape=(None, 6))
    y = sd.placeHolder("y", shape=(None, 3))
    w1 = sd.var("w1", (rng.normal(size=(6, 16)) * 0.3).astype(np.float32))
    w2 = sd.var("w2", (rng.normal(size=(16, 3)) * 0.3).astype(np.float32))
    sd.loss.mse(y, sd.math.tanh(x.mmul(w1)).mmul(w2)).rename("loss")
    sd.setLossVariables("loss")
    with pytest.warns(UserWarning, match="bfloat16") if compute_dtype == "HALF" \
            else _nullcontext():
        cfg = P.TrainingConfig(updater=P.Adam(0.05), dataSetFeatureMapping=["x"],
                               dataSetLabelMapping=["y"], computeDtype=compute_dtype)
    sd.setTrainingConfig(cfg)
    return sd, P.DataSet(X, Y)


class _nullcontext:
    def __enter__(self):
        return self

    def __exit__(self, *a):
        return False


def test_half_compute_trains_to_fp32_quality_and_survives_serde(tmp_path):
    sd32, ds = _mixed(PORT, None)
    h32 = sd32.fit(ds, epochs=200)
    runs = []
    for P in BOTH:
        sd16, ds = _mixed(P, "HALF")
        runs.append((sd16, sd16.fit(ds, epochs=200)))
    (_, rh), (p16, ph) = runs
    assert h32[-1] < 0.05
    assert ph[-1] < max(2 * h32[-1], 0.08)
    np.testing.assert_allclose(ph[:10], rh[:10], rtol=2e-2)
    assert p16.getVariable("w1").getArr().torch.dtype == torch.float32
    p = str(tmp_path / "mp.zip")
    p16.save(p, save_updater_state=True)
    for P in BOTH:
        back = P.load(p)
        assert back._training_config.computeDtype == "HALF"
        assert np.isfinite(back.fit(_mixed(P, None)[1], epochs=2)[-1])


# ---------------------------------------------------------- persistence


def _mlp(P):
    rng = np.random.default_rng(5)
    sd = P.create()
    x = sd.placeHolder("x", shape=(None, 3))
    y = sd.placeHolder("y", shape=(None, 2))
    w = sd.var("w", rng.random((3, 2)).astype(np.float32))
    b = sd.var("b", np.zeros((2,), np.float32))
    out = sd.math.tanh(x.mmul(w) + b).rename("out")
    sd.loss.mse(y, out).rename("loss")
    sd.setLossVariables("loss")
    sd.setTrainingConfig(P.TrainingConfig(updater=P.Adam(0.05), dataSetFeatureMapping=["x"],
                                          dataSetLabelMapping=["y"]))
    batches = [{"x": rng.random((4, 3)).astype(np.float32),
                "y": rng.random((4, 2)).astype(np.float32)} for _ in range(3)]
    return sd, batches


@pytest.mark.parametrize("writer,reader", [(REF, PORT), (PORT, REF)],
                         ids=["jax-to-port", "port-to-jax"])
def test_save_load_across_packages_resumes_exactly(tmp_path, writer, reader):
    """A graph fitted two steps and saved with its updater state by one
    package loads in the other: the same output, and one more step from
    the restored Adam state lands where the writer's own next step does."""
    sd, batches = _mlp(writer)
    sd.fit(batches[:2])
    path = str(tmp_path / "m.zip")
    sd.save(path, save_updater_state=True)
    back = reader.load(path)
    xv = batches[2]["x"]
    _close(_np(back.output({"x": xv}, "out")["out"]), _np(sd.output({"x": xv}, "out")["out"]))
    _close(_np(back.batchOutput().input("x", xv).output("out").execSingle()),
           _np(sd.output({"x": xv}, "out")["out"]))
    l_back, l_own = back.fit(batches[2]), sd.fit(batches[2])
    np.testing.assert_allclose(l_back, l_own, rtol=REL)
    for n in ("w", "b"):
        _close(_np(back.getVariable(n).getArr()), _np(sd.getVariable(n).getArr()), REL)


def _while_graph(P, limit=4):
    sd = P.create()
    i0 = sd.constant("i0", np.int32(0))
    acc0 = sd.constant("acc0", np.float32(1.0))
    i_out, acc_out = sd.whileLoop(
        [i0, acc0],
        lambda s, i, acc: s.math.lt(i, limit),
        lambda s, i, acc: [s.math.add(i, 1), s.math.mul(acc, 3.0)],
        name="loop")
    return sd, i_out, acc_out


def test_control_flow_values_and_serde_both_ways(tmp_path):
    xs = np.array([1.0, 2.0, 3.0], np.float32)
    for P in BOTH:
        sd = P.create()
        x = sd.placeHolder("x", shape=(3,), dtype=P.f32)
        pred = sd.placeHolder("p", shape=(), dtype=P.bool_)
        out = sd.ifCond(pred, lambda s, a: s.math.mul(a, 2.0),
                        lambda s, a: s.math.add(a, 10.0), inputs=[x], name="branchy")
        np.testing.assert_allclose(_np(sd.output({"x": xs, "p": np.bool_(True)},
                                                 [out.name])[out.name]), xs * 2)
        np.testing.assert_allclose(_np(sd.output({"x": xs, "p": np.bool_(False)},
                                                 [out.name])[out.name]), xs + 10)
    graphs = {}
    for P in BOTH:
        sd, i_out, acc_out = _while_graph(P)
        res = sd.output({}, [i_out.name, acc_out.name])
        assert (int(_np(res[i_out.name])), float(_np(res[acc_out.name]))) == (4, 81.0)
        graphs[P.port] = sd
    assert list(graphs[True]._vars) == list(graphs[False]._vars)
    for src, dst in ((REF, PORT), (PORT, REF)):
        p = str(tmp_path / f"cf{src.port}.zip")
        graphs[src.port].save(p)
        back = dst.load(p)
        assert float(_np(back.output({}, ["loop#1"])["loop#1"])) == 81.0


def test_gradients_through_if_and_for_and_while_refused():
    grads = []
    for P in BOTH:
        sd = P.create()
        w = sd.var("w", np.array([3.0], np.float32))
        p = sd.placeHolder("p", shape=(), dtype=P.bool_)
        out = sd.ifCond(p, lambda s, a: s.math.mul(a, a),
                        lambda s, a: s.math.mul(a, 5.0), inputs=[w])
        sd.setLossVariables(out.name)
        g_t = _np(sd.calculateGradients({"p": np.bool_(True)}, ["w"])["w"])
        g_f = _np(sd.calculateGradients({"p": np.bool_(False)}, ["w"])["w"])
        sd2 = P.create()
        w2 = sd2.var("w", np.array([[2.0]], np.float32))
        x = sd2.placeHolder("x", shape=(1, 1), dtype=P.f32)
        xN, _ = sd2.forLoop(3, [x, w2], lambda s, i, xx, ww: [s.linalg.matmul(xx, ww), ww],
                            name="powloop")
        one = np.array([[1.0]], np.float32)
        val = _np(sd2.output({"x": one}, [xN.name])[xN.name])
        sd2.setLossVariables(xN.name)
        g_for = _np(sd2.calculateGradients({"x": one}, ["w"])["w"])
        grads.append((g_t, g_f, val, g_for))
        # no reverse mode through a while loop, in either package
        sd3 = P.create()
        w3 = sd3.var("w", np.array([2.0], np.float32))
        _, acc = sd3.whileLoop([sd3.constant("i0", np.int32(0)), w3],
                               lambda s, i, a: s.math.lt(i, 3),
                               lambda s, i, a: [s.math.add(i, 1), s.math.mul(a, a)])
        sd3.setLossVariables(acc.name)
        np.testing.assert_array_equal(_np(sd3.output({}, acc.name)[acc.name]), [256.0])
        with pytest.raises(ValueError, match="while"):
            sd3.calculateGradients({}, ["w"])
    (rt, rf, rv, rg), (pt, pf, pv, pg) = grads
    np.testing.assert_allclose(pt, [6.0])
    np.testing.assert_allclose(pf, [5.0])
    np.testing.assert_array_equal(pv, [[8.0]])
    np.testing.assert_allclose(pg, 12.0, rtol=1e-6)
    for a, b in ((pt, rt), (pf, rf), (pv, rv), (pg, rg)):
        _close(a, b)


def test_fit_listeners_see_every_step_and_fuse_steps_changes_nothing():
    class Rec:
        def __init__(self):
            self.seq = []

        def iterationDone(self, model, it, ep):
            self.seq.append((it, model.score()))

    runs = []
    for fuse in (0, 4):
        sd, batches = _mlp(PORT)
        sd.fuseSteps = fuse
        rec = Rec()
        sd.listeners = [rec]
        hist = sd.fit(batches * 3)
        runs.append((hist, rec.seq, _np(sd.getVariable("w").getArr())))
    assert [i for i, _ in runs[0][1]] == list(range(1, 10))
    np.testing.assert_allclose([s for _, s in runs[0][1]], runs[0][0], rtol=1e-6)
    assert runs[0][0] == runs[1][0]
    np.testing.assert_array_equal(runs[0][2], runs[1][2])
