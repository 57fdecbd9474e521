"""The port's ONNX import (``deeplearning4j_tpu_torch/modelimport/onnx``)
held against the JAX package's on the CPU, from the same bytes.

- The reference corpus: every model that ``tests/test_onnx_import.py``
  and ``tests/test_onnx_import2.py`` build with their protoc bindings,
  recorded once a module by running those tests' bodies with their
  ``run_import`` wrapped (each model's bytes, feeds, output name and the
  JAX import's answer), then imported by the port from the same bytes:
  the same dtype and shape, values within 1e-5 (absolute and relative,
  fp32), or the same exception type where the reference raised. The
  importer contract (an unknown op names itself, a path, a fine-tune's
  losses within 1e-5 relative of the reference's).
- Config #4's encoder at the ``TINY`` size written as ONNX bytes by
  ``tests/torch_onnx_cases.py`` (the bytes ``chip_smoke.py``'s
  ``importers`` phase imports at full width): unfused and fused, the
  output within 1e-5 of the JAX import's largest |value| and every
  gradient of an MLM head's loss within 1e-5 of its largest |value|;
  fused against unfused 1e-6; the same as the API-built encoder within
  1e-5 of its largest |value|.
- The wire format: the reference's bytes parse with the port's reader and
  re-serialize to the same bytes, and the port writer's bytes parse with
  the reference's ``onnx_minimal_pb2`` to the same message (the
  reference's bindings need protobuf; the port never imports it).

The port's 64-bit switch is on, as the suite runs the reference.
"""
import inspect

import numpy as np
import pytest

import test_onnx_import as R1
import test_onnx_import2 as R2
import torch_onnx_cases as O
import torch_samediff_cases as C
from deeplearning4j_tpu.autodiff import TrainingConfig as RConfig
from deeplearning4j_tpu.modelimport.onnx import (OnnxFrameworkImporter as RImporter,
                                                 numpy_to_tensor as r_numpy_to_tensor,
                                                 onnx_pb as rpb)
from deeplearning4j_tpu.train import Adam as RAdam
from deeplearning4j_tpu_torch import nd
from deeplearning4j_tpu_torch.autodiff import TrainingConfig as PConfig
from deeplearning4j_tpu_torch.modelimport.onnx import (OnnxFrameworkImporter, numpy_to_tensor,
                                                       onnx_pb, tensor_to_numpy)
from deeplearning4j_tpu_torch.modelimport.onnx.importer import _NP_DT
from deeplearning4j_tpu_torch.train import Adam as PAdam
from torch_threads import one_torch_thread  # noqa: F401

TOL = 1e-5
REF_MODULES = (R1, R2)



def _reference_tests():
    """(module, class, method) of every corpus test, in definition order
    (the importer-contract class calls the importer directly; it has its
    own port tests below)."""
    out = []
    for mod in REF_MODULES:
        for cname, cls in vars(mod).items():
            if not (cname.startswith("Test") and isinstance(cls, type)) \
                    or cname == "TestImporterContract":
                continue
            out += [(mod.__name__, cname, m) for m, fn in vars(cls).items()
                    if m.startswith("test") and callable(fn)]
    return out


CASES = _reference_tests()


@pytest.fixture(scope="module")
def corpus():
    """{(module, class, method): [(bytes, feeds, output, answer)]}: each
    reference test's body run once with ``run_import`` wrapped; the
    modules' random generators are restored after, so the reference's own
    tests draw what they would have drawn."""
    rec, cases = {}, []

    def record(model, feeds, out_name):
        data = model.SerializeToString()
        try:
            got = orig(model, feeds, out_name)
        except Exception as e:
            cases.append((data, dict(feeds), out_name, e))
            raise
        cases.append((data, dict(feeds), out_name, np.array(got)))
        return got

    orig = R1.run_import
    states = [m.RNG.bit_generator.state for m in REF_MODULES]
    try:
        for m in REF_MODULES:
            m.run_import = record
        for key in CASES:
            mod = next(m for m in REF_MODULES if m.__name__ == key[0])
            cases = []
            try:
                getattr(getattr(mod, key[1])(), key[2])()
            except Exception:   # the reference's own oracle is its test's
                pass
            rec[key] = cases
    finally:
        for m, st in zip(REF_MODULES, states):
            m.run_import = orig
            m.RNG.bit_generator.state = st
    return rec


def _port_answer(data, feeds, out_name):
    with nd.enableX64(True):
        try:
            sd = OnnxFrameworkImporter.runImport(data, device="cpu")
            return sd.getVariable(out_name).eval(feeds).toNumpy()
        except Exception as e:
            return e


@pytest.mark.parametrize("key", CASES, ids=["::".join(k) for k in CASES])
def test_reference_corpus(corpus, key):
    cases = corpus[key]
    assert cases, f"{key}: the reference test built no model"
    for data, feeds, out_name, want in cases:
        got = _port_answer(data, feeds, out_name)
        if isinstance(want, Exception):
            assert type(got) is type(want), (key, out_name, want, got)
            continue
        assert not isinstance(got, Exception), (key, out_name, got)
        assert got.shape == want.shape and got.dtype == want.dtype, \
            (key, out_name, got.shape, got.dtype, want.shape, want.dtype)
        np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL, err_msg=str(key))


def test_wire_reads_and_rewrites_reference_bytes(corpus):
    """Every corpus model's protoc bytes through the port's reader and
    writer give the same bytes; the parsed fields read as the reference's."""
    n = 0
    for cases in corpus.values():
        for data, *_ in cases:
            m = onnx_pb.ModelProto.FromString(data)
            assert m.SerializeToString() == data
            r = rpb.ModelProto.FromString(data)
            assert [nd_.op_type for nd_ in m.graph.node] == \
                [nd_.op_type for nd_ in r.graph.node]
            assert [list(nd_.input) for nd_ in m.graph.node] == \
                [list(nd_.input) for nd_ in r.graph.node]
            for a, b in zip(m.graph.initializer, r.graph.initializer):
                np.testing.assert_array_equal(tensor_to_numpy(a), tensor_to_numpy(b))
            n += 1
    assert n >= 60


def test_wire_port_bytes_parse_with_protoc_bindings():
    """The port writer's bytes of the TINY encoder, and of every dtype of
    ``numpy_to_tensor``, parse with the reference's bindings to messages
    that serialize back to the same bytes; building through the
    reference's bindings gives the same bytes."""
    ours = O.bert_onnx_bytes(**C.TINY)
    theirs = rpb.ModelProto.FromString(ours)
    assert theirs.SerializeToString() == ours
    assert O.bert_onnx_model(**C.TINY, pb=rpb).SerializeToString() == ours
    assert len(theirs.graph.node) == len(onnx_pb.ModelProto.FromString(ours).graph.node)
    rng = np.random.default_rng(0)
    for dt in _NP_DT.values():
        arr = (rng.normal(size=(2, 3)) * 10).astype(dt)
        a, b = numpy_to_tensor("t", arr), r_numpy_to_tensor("t", arr)
        assert a.SerializeToString() == b.SerializeToString()
        back = rpb.TensorProto.FromString(a.SerializeToString())
        np.testing.assert_array_equal(tensor_to_numpy(back), arr)


def test_wire_field_encodings():
    """What the reader must take besides the writer's own output: unpacked
    repeated scalars, negative varints, typed data fields, fields the
    schema does not name, and sub-messages set only through a child."""
    t = rpb.TensorProto(name="x", data_type=7)
    t.dims.extend([2, 2])
    t.int64_data.extend([-1, 2 ** 40, 0, -(2 ** 62)])
    data = t.SerializeToString()
    unpacked = b"".join([b"\x08\x02", b"\x08\x02"]) + data[data.index(b"\x10"):]
    unknown = data + b"\xa8\x01\x05" + b"\xb2\x01\x03abc"   # fields 21 and 22
    for raw in (data, unpacked, unknown):
        m = onnx_pb.TensorProto.FromString(raw)
        assert list(m.dims) == [2, 2] and m.name == "x"
        np.testing.assert_array_equal(tensor_to_numpy(m),
                                      np.array([[-1, 2 ** 40], [0, -(2 ** 62)]], np.int64))
    f = onnx_pb.TensorProto(data_type=1, float_data=[0.1, -2.5])
    assert f.SerializeToString() == rpb.TensorProto(data_type=1, float_data=[0.1, -2.5]) \
        .SerializeToString()
    vi = onnx_pb.ValueInfoProto(name="v")
    vi.type.tensor_type.shape.dim.add(dim_value=3)
    r = rpb.ValueInfoProto(name="v")
    r.type.tensor_type.shape.dim.add(dim_value=3)
    assert vi.SerializeToString() == r.SerializeToString()
    untouched = onnx_pb.ValueInfoProto(name="v")
    assert untouched.type.tensor_type.elem_type == 0   # a read sets nothing
    assert untouched.SerializeToString() == rpb.ValueInfoProto(name="v").SerializeToString()
    assert not untouched.HasField("type") and vi.HasField("type")


def _model(nodes, inputs, outputs, initializers=None):
    return R1.make_model(nodes, inputs, outputs, initializers)


def test_unknown_op_raises_with_name():
    model = _model([R1.node("FancyCustomOp", ["x"], ["y"])],
                   inputs=[("x", (1,))], outputs=[("y", (1,))])
    with pytest.raises(ValueError, match="FancyCustomOp"):
        RImporter.runImport(model)
    with pytest.raises(ValueError, match="FancyCustomOp"):
        OnnxFrameworkImporter.runImport(model, device="cpu")


def test_import_needs_cuda_unless_asked_for_cpu():
    """The importer and the runner build on the card by default; without
    one they raise, naming ``device='cpu'``."""
    import torch
    from deeplearning4j_tpu_torch.interop import OnnxRunner

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is usable")
    data = O.bert_onnx_bytes(**C.TINY)
    for build in (OnnxFrameworkImporter.runImport, OnnxRunner):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            build(data)


def test_path_bytes_and_message_import_alike(tmp_path):
    rng = np.random.default_rng(4)
    w = rng.normal(size=(4, 2)).astype(np.float32)
    model = _model([R1.node("Gemm", ["x", "w"], ["y"], transB=1)],
                   inputs=[("x", (1, 2))], outputs=[("y", (1, 4))],
                   initializers={"w": w})
    p = tmp_path / "m.onnx"
    p.write_bytes(model.SerializeToString())
    x = rng.normal(size=(1, 2)).astype(np.float32)
    want = RImporter.runImport(str(p)).getVariable("y").eval({"x": x}).toNumpy()
    for src in (str(p), p.read_bytes(), model, onnx_pb.ModelProto.FromString(p.read_bytes())):
        got = OnnxFrameworkImporter.runImport(src, device="cpu").getVariable("y") \
            .eval({"x": x}).toNumpy()
        np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)


def test_fine_tune_imported_graph_matches_reference():
    """An imported Gemm's initializer made trainable and fitted 20 epochs
    with Adam(0.1): the port's losses within 1e-5 relative of the
    reference's, and falling."""
    rng = np.random.default_rng(6)
    w = (rng.normal(size=(1, 4)) * 0.1).astype(np.float32)
    model = _model([R1.node("Gemm", ["x", "w"], ["y"], transB=1)],
                   inputs=[("x", (8, 4))], outputs=[("y", (8, 1))],
                   initializers={"w": w})
    x = rng.normal(size=(8, 4)).astype(np.float32)
    target = x @ np.array([[1.0], [2.0], [-1.0], [0.5]], np.float32)
    hist = {}
    for pkg, sd, cfg, adam in (
            ("ref", RImporter.runImport(model), RConfig, RAdam),
            ("port", OnnxFrameworkImporter.runImport(model, device="cpu"), PConfig, PAdam)):
        sd.convertToVariable("w")
        label = sd.placeHolder("label", shape=(8, 1))
        sd.reduce.mean(sd.math.square(sd.math.sub(sd.getVariable("y"), label))).rename("loss")
        sd.setLossVariables("loss")
        sd.setTrainingConfig(cfg(updater=adam(0.1)))
        hist[pkg] = np.asarray(sd.fit({"x": x, "label": target}, epochs=20), np.float64)
    np.testing.assert_allclose(hist["port"], hist["ref"], rtol=TOL)
    assert hist["port"][-1] < 0.5 * hist["port"][0]


def _mlm(sd, out, targets_shape, head):
    logits = sd.linalg.matmul(sd.getVariable(out), sd.var("lm_head", head))
    loss = sd.loss.sparseMcxent(sd.placeHolder("targets", shape=targets_shape,
                                               dtype="int32"), logits)
    sd.setLossVariables(loss.name)


@pytest.fixture(scope="module")
def tiny_onnx():
    rng = np.random.default_rng(8)
    T, V, H = C.TINY["T"], C.TINY["V"], C.TINY["H"]
    feeds = {"ids": rng.integers(0, V, (3, T)).astype(np.int64),
             "targets": rng.integers(0, V, (3, T)).astype(np.int32)}
    head = rng.normal(0, 0.05, (H, V)).astype(np.float32)
    return O.bert_onnx_bytes(**C.TINY), feeds, head


@pytest.mark.parametrize("fuse", [False, True], ids=["unfused", "fused"])
def test_tiny_bert_from_onnx_bytes_matches_reference(tiny_onnx, fuse):
    data, feeds, head = tiny_onnx
    out = O.OUTPUT
    wrt = ["tok_emb", "pos_emb", "l0/qkv_w", "l1/fc2_w", "ln4/gamma", "lm_head"]
    res = {}
    for pkg in ("ref", "port"):
        with nd.enableX64(True):
            sd = RImporter.runImport(data) if pkg == "ref" else \
                OnnxFrameworkImporter.runImport(data, device="cpu")
            before = np.asarray(sd.output({"ids": feeds["ids"]}, out)[out].toNumpy())
            assert sd.convertAllConstantsToVariables() == 4 + 12 * C.TINY["L"]
            if fuse:
                assert sd.fuseAttention() == 2
            o = np.asarray(sd.output({"ids": feeds["ids"]}, out)[out].toNumpy())
            _mlm(sd, out, feeds["targets"].shape, head)
            g = sd.calculateGradients(feeds, wrt)
            res[pkg] = (before, o, {k: np.asarray(v.toNumpy()) for k, v in g.items()})
    (rb, ro, rg), (pb_, po, pg) = res["ref"], res["port"]
    np.testing.assert_allclose(po, pb_, atol=1e-6 * np.abs(pb_).max())
    np.testing.assert_allclose(po, ro, atol=TOL * np.abs(ro).max())
    for k in wrt:
        np.testing.assert_allclose(pg[k], rg[k], atol=TOL * np.abs(rg[k]).max(), err_msg=k)
    api, _, api_out = C.build_bert_encoder(**C.TINY, device="cpu")
    want = api.output({"ids": feeds["ids"].astype(np.int32)}, api_out)[api_out].toNumpy()
    np.testing.assert_allclose(po, want, atol=TOL * np.abs(want).max())


def test_onnx_rules_match_reference_table():
    """The port carries the reference's whole rule table."""
    from deeplearning4j_tpu.modelimport.onnx import importer as ri
    from deeplearning4j_tpu_torch.modelimport.onnx import importer as pi
    assert sorted(pi._RULES) == sorted(ri._RULES)
    assert len(pi._RULES) >= 100
    assert inspect.getsource(pi._OnnxGraphImporter._map_node) == \
        inspect.getsource(ri._OnnxGraphImporter._map_node)
