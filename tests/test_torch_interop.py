"""The port's interop runners (``deeplearning4j_tpu_torch/interop``) held
against the JAX package's on the CPU.

``OnnxRunner`` over the same bytes in both packages — a Gemm MLP, a
convolution stack and config #4's encoder at the ``TINY`` size
(``tests/torch_onnx_cases.py``) — gives the reference runner's input and
output names and its outputs within 1e-5 of their largest |value|, and
the port's ``OnnxFrameworkImporter`` output bit for bit; an unmapped op
raises at construction in both. ``GraphRunner`` runs TensorFlow itself in
both packages: over the reference tests' frozen MLP (bytes and a path)
the same names, the same outputs bit for bit, the same refusal of an
unknown feed.
"""
import numpy as np
import pytest

import test_interop as RI
import test_onnx_import as R1
import torch_onnx_cases as O
import torch_samediff_cases as C
from deeplearning4j_tpu.interop import GraphRunner as RGraphRunner
from deeplearning4j_tpu.interop import OnnxRunner as ROnnxRunner
from deeplearning4j_tpu_torch import nd
from deeplearning4j_tpu_torch.interop import GraphRunner, OnnxRunner
from deeplearning4j_tpu_torch.modelimport.onnx import OnnxFrameworkImporter
from torch_threads import one_torch_thread  # noqa: F401

TOL = 1e-5



def _mlp():
    rng = np.random.default_rng(11)
    w1, b1 = rng.normal(size=(16, 6)).astype(np.float32), rng.normal(size=(16,)).astype(np.float32)
    w2, b2 = rng.normal(size=(3, 16)).astype(np.float32), rng.normal(size=(3,)).astype(np.float32)
    model = R1.make_model(
        [R1.node("Gemm", ["x", "w1", "b1"], ["h"], transB=1), R1.node("Relu", ["h"], ["hr"]),
         R1.node("Gemm", ["hr", "w2", "b2"], ["logits"], transB=1),
         R1.node("Softmax", ["logits"], ["y"], axis=-1)],
        inputs=[("x", (2, 6))], outputs=[("y", (2, 3)), ("logits", (2, 3))],
        initializers={"w1": w1, "b1": b1, "w2": w2, "b2": b2})
    return model.SerializeToString(), {"x": rng.normal(size=(2, 6)).astype(np.float32)}


def _cnn():
    rng = np.random.default_rng(12)
    w = (rng.normal(size=(4, 3, 3, 3)) * 0.1).astype(np.float32)
    model = R1.make_model(
        [R1.node("Conv", ["x", "w"], ["c"], kernel_shape=[3, 3], pads=[1, 1, 1, 1]),
         R1.node("Relu", ["c"], ["r"]),
         R1.node("MaxPool", ["r"], ["p"], kernel_shape=[2, 2], strides=[2, 2]),
         R1.node("GlobalAveragePool", ["p"], ["y"])],
        inputs=[("x", (2, 3, 8, 8))], outputs=[("y", (2, 4, 1, 1))], initializers={"w": w})
    return model.SerializeToString(), {"x": rng.normal(size=(2, 3, 8, 8)).astype(np.float32)}


def _bert():
    rng = np.random.default_rng(13)
    return O.bert_onnx_bytes(**C.TINY), \
        {"ids": rng.integers(0, C.TINY["V"], (2, C.TINY["T"])).astype(np.int64)}


@pytest.mark.parametrize("make", [_mlp, _cnn, _bert], ids=["mlp", "cnn", "bert_tiny"])
def test_onnx_runner_matches_reference(make):
    data, feeds = make()
    ref = ROnnxRunner(data)
    with nd.enableX64(True):
        port = OnnxRunner(data, device="cpu")
        got = port.run(feeds)
        again = port.exec(feeds, outputs=port.output_names[:1])
        sd = OnnxFrameworkImporter.runImport(data, device="cpu")
        direct = {k: v.toNumpy() for k, v in sd.output(feeds, port.output_names).items()}
    want = ref.run(feeds)
    assert port.input_names == ref.input_names
    assert port.output_names == ref.output_names
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=TOL * np.abs(want[k]).max())
        np.testing.assert_array_equal(got[k], direct[k])
    assert list(again) == port.output_names[:1]
    np.testing.assert_array_equal(again[port.output_names[0]], got[port.output_names[0]])


def test_onnx_runner_refuses_unmapped_op():
    model = R1.make_model([R1.node("FancyCustomOp", ["x"], ["y"])],
                          inputs=[("x", (1,))], outputs=[("y", (1,))])
    for runner, kw in ((ROnnxRunner, {}), (OnnxRunner, {"device": "cpu"})):
        with pytest.raises(ValueError, match="FancyCustomOp"):
            runner(model.SerializeToString(), **kw)


@pytest.fixture(scope="module")
def frozen():
    return RI._frozen_mlp_graphdef()


@pytest.mark.parametrize("names", [True, False], ids=["named", "autodetected"])
def test_graph_runner_matches_reference(frozen, names, tmp_path):
    gd, W, b = frozen
    data = gd.SerializeToString()
    path = tmp_path / "frozen.pb"
    path.write_bytes(data)
    kw = dict(inputNames=["x"], outputNames=["Identity"]) if names else {}
    x = np.random.default_rng(14).random((5, 4)).astype(np.float32)
    with RGraphRunner(data, **kw) as ref, GraphRunner(data, **kw) as port, \
            GraphRunner(str(path), **kw) as from_file:
        assert port.inputNames == ref.inputNames == ["x"]
        assert port.outputNames == ref.outputNames
        want = ref.run({"x": x})
        for runner in (port, from_file):
            got = runner.run({"x": x})
            assert list(got) == list(want)
            for k in want:
                np.testing.assert_array_equal(got[k], want[k])
        np.testing.assert_allclose(want[port.outputNames[0]], np.maximum(x @ W + b, 0),
                                   rtol=1e-5)
        with pytest.raises(ValueError, match="unexpected input"):
            port.run({"bogus": np.zeros((1, 4), np.float32)})
