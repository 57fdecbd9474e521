"""``SameDiff.fuseAttention`` (``autodiff/rewrites.py``) of the port held
against the JAX package's on the CPU, and the config #4 encoder of
``tests/torch_samediff_cases.py`` (what ``chip_smoke.py`` runs on the
card) against the port's import of ``tools/tf_bert.py``'s graph.

``fuseAttention`` must fuse the same sites in both packages (2 on the
2-layer encoder, masked or not; the rewrite's unit cases as
``tests/test_attention_fusion.py`` has them), leave outputs unchanged
(1e-6 on the einsum path, 1e-5 masked through the -1e4 adder), keep
training trajectories equal (1e-5 relative), raise its targeted error
for a removed intermediate (also after save and load, either package
writing) and return 0 a second time. The API-built encoder gives the TF
import's outputs bit for bit.
"""
import os
import sys

import numpy as np
import pytest

tf = pytest.importorskip("tensorflow")

import torch  # noqa: E402

from deeplearning4j_tpu.autodiff import SameDiff as RSameDiff  # noqa: E402
from deeplearning4j_tpu.autodiff import TrainingConfig as RConfig  # noqa: E402
from deeplearning4j_tpu.modelimport.tensorflow import (  # noqa: E402
    TensorflowFrameworkImporter as RImporter)
from deeplearning4j_tpu.train import Adam as RAdam  # noqa: E402
from deeplearning4j_tpu_torch import ops as pops  # noqa: E402
from deeplearning4j_tpu_torch.autodiff import SameDiff as PSameDiff  # noqa: E402
from deeplearning4j_tpu_torch.autodiff import TrainingConfig as PConfig  # noqa: E402
from deeplearning4j_tpu_torch.modelimport.tensorflow import (  # noqa: E402
    TensorflowFrameworkImporter as PImporter)
from deeplearning4j_tpu_torch.train import Adam as PAdam  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from tools.tf_bert import build_frozen_bert  # noqa: E402

import torch_samediff_cases as C  # noqa: E402
from torch_threads import one_torch_thread  # noqa: F401,E402

RNG = np.random.default_rng(0)


@pytest.fixture(scope="module")
def tiny_bert():
    """tools/tf_bert.py's 2-layer encoder (H=32, A=4, V=64, T=16), frozen
    unmasked and masked."""
    return {m: build_frozen_bert(**C.TINY, masked=m) for m in (False, True)}


def _nodes(sd):
    return [(o.namespace, o.opname, o.inputs, o.outputs) for o in sd._ops]


def _port_import(gd):
    return PImporter.runImport(gd, device="cpu")


def test_api_built_encoder_is_the_import(tiny_bert):
    """tests/torch_samediff_cases.py's encoder — chip_smoke.py's config #4
    graph — against the port's import of tools/tf_bert.py's graph from the
    same seed: the same ops, the same outputs bit for bit, masked or not,
    before and after fuseAttention (2 sites each)."""
    ids = RNG.integers(0, 64, (2, 16)).astype(np.int32)
    m = np.ones((2, 16), np.float32)
    m[:, 10:] = 0
    for masked, (gd, i, o, _) in tiny_bert.items():
        imp = _port_import(gd)
        api, names, out = C.build_bert_encoder(**C.TINY, masked=masked, device="cpu")
        fi = {i[0]: ids, i[1]: m} if masked else {i: ids}
        fa = {"ids": ids, "mask": m} if masked else {"ids": ids}
        assert sorted(x.opname for x in imp._needed_ops((o,))) == \
            sorted(x.opname for x in api._needed_ops((out,)))
        want = imp.output(fi, o)[o].toNumpy()
        np.testing.assert_array_equal(api.output(fa, out)[out].toNumpy(), want)
        assert imp.fuseAttention() == api.fuseAttention() == 2
        np.testing.assert_array_equal(api.output(fa, out)[out].toNumpy(),
                                      imp.output(fi, o)[o].toNumpy())


# ------------------------------------------------------------ fuseAttention


@pytest.mark.parametrize("masked", [False, True], ids=["unmasked", "masked"])
def test_fuse_imported_bert_both_packages(tiny_bert, masked):
    gd, i, o, _ = tiny_bert[masked]
    x = RNG.integers(0, 64, (2, 16)).astype(np.int32)
    m = np.ones((2, 16), np.float32)
    m[:, 10:] = 0
    feed = {i[0]: x, i[1]: m} if masked else {i: x}
    ref, port = RImporter.runImport(gd), _port_import(gd)
    before = port.output(feed, o)[o].toNumpy()
    n_before = len(port._ops)
    assert ref.fuseAttention() == port.fuseAttention() == 2
    assert len(port._ops) < n_before
    assert _nodes(port) == _nodes(ref)
    after = port.output(feed, o)[o].toNumpy()
    np.testing.assert_allclose(after, before, atol=1e-5 if masked else 1e-6)
    np.testing.assert_allclose(after, np.asarray(ref.output(feed, o)[o].toNumpy()),
                               atol=1e-5)
    assert port.fuseAttention() == 0
    if masked:   # the mask stays live: unmasking the tail moves the output
        other = port.output({i[0]: x, i[1]: np.ones((2, 16), np.float32)}, o)[o].toNumpy()
        assert np.max(np.abs(other - after)) > 1e-4


def test_fused_training_trajectory_matches_unfused_and_reference(tiny_bert):
    gd, i, o, _ = tiny_bert[False]
    rng = np.random.default_rng(1)
    batch = {i: rng.integers(0, 64, (2, 16)).astype(np.int32),
             "t": rng.integers(0, 4, (2, 16)).astype(np.int32)}
    losses = {}
    for pkg, imp, cfg, adam, fuses in (("ref", RImporter.runImport, RConfig, RAdam, (True,)),
                                       ("port", _port_import, PConfig, PAdam, (False, True))):
        for fuse in fuses:
            sd = imp(gd)
            sd.convertAllConstantsToVariables()
            if fuse:
                assert sd.fuseAttention() == 2
            logits = sd.linalg.matmul(sd.getVariable(o),
                                      sd.var("w", np.zeros((32, 4), np.float32)))
            loss = sd.loss.sparseMcxent(sd.placeHolder("t", shape=(2, 16), dtype="int32"),
                                        logits)
            sd.setLossVariables(loss.name)
            sd.setTrainingConfig(cfg(updater=adam(1e-3)))
            losses[pkg, fuse] = sd.fit([batch] * 3)
    np.testing.assert_allclose(losses["port", True], losses["port", False], rtol=1e-5)
    np.testing.assert_allclose(losses["port", True], losses["ref", True], rtol=1e-5)


def _qkv(sd, rng, shape=(1, 2, 8, 4), kv_shape=None, scale=1.0):
    kv_shape = kv_shape or shape
    mk = lambda n, s: sd.var(n, (rng.normal(size=s) * scale).astype(np.float32))  # noqa: E731
    return mk("q", shape), mk("k", kv_shape), mk("v", kv_shape)


def _build(pkg, case):
    """The rewrite's unit cases (tests/test_attention_fusion.py), built in
    either package: (sd, the chain's output, extra)."""
    sd = RSameDiff.create() if pkg == "ref" else PSameDiff.create("cpu")
    if case == "multi_consumer":
        q, k, v = _qkv(sd, np.random.default_rng(2))
        p = sd.nn.softmax(sd.linalg.matmul(q, sd.shapes.permute(k, axes=[0, 1, 3, 2])))
        out = sd.linalg.matmul(p, v)
        return sd, out, p.sum()
    if case == "trainable_scale":
        q, k, v = _qkv(sd, np.random.default_rng(4))
        temp = sd.var("temperature", np.asarray(0.5, np.float32))
        s = sd.linalg.matmul(q, sd.shapes.permute(k, axes=[0, 1, 3, 2])).mul(temp)
        return sd, sd.linalg.matmul(sd.nn.softmax(s), v), None
    if case == "broadcast_kv":
        q, k, v = _qkv(sd, np.random.default_rng(5), (2, 3, 8, 4), (1, 1, 8, 4))
        p = sd.nn.softmax(sd.linalg.matmul(q, sd.shapes.permute(k, axes=[0, 1, 3, 2])))
        return sd, sd.linalg.matmul(p, v), None
    if case == "intermediate":
        q, k, v = _qkv(sd, np.random.default_rng(11), (2, 3, 8, 4))
        p = sd.nn.softmax(sd.linalg.matmul(q, sd.shapes.permute(k, axes=[0, 1, 3, 2])))
        return sd, sd.linalg.matmul(p, v), p
    if case == "mask_first":
        rng = np.random.default_rng(9)
        q, k, v = _qkv(sd, rng, (2, 2, 8, 4), scale=0.3)
        m = sd.var("m", rng.integers(0, 2, (2, 1, 1, 8)).astype(np.float32))
        adder = m.rsub(1.0).mul(sd.constant("neg", np.asarray(-1e9, np.float32)))
        scores = sd.linalg.matmul(q, sd.shapes.permute(k, axes=[0, 1, 3, 2])).mul(
            sd.constant("sc", np.asarray(0.5, np.float32)))
        return sd, sd.linalg.matmul(sd.nn.softmax(adder.add(scores)), v), None
    if case == "dynamic_mask":
        q, k, v = _qkv(sd, np.random.default_rng(7), (2, 2, 8, 4), scale=0.3)
        ph = sd.placeHolder("mask", shape=(2, 1, 1, 8))
        s = sd.linalg.matmul(q, sd.shapes.permute(k, axes=[0, 1, 3, 2])).mul(
            sd.constant("sc", np.asarray(0.5, np.float32))).add(ph)
        return sd, sd.linalg.matmul(sd.nn.softmax(s), v), None
    if case == "unscaled":
        q, k, v = _qkv(sd, np.random.default_rng(3), scale=0.3)
        p = sd.nn.softmax(sd.linalg.matmul(q, sd.shapes.permute(k, axes=[0, 1, 3, 2])))
        return sd, sd.linalg.matmul(p, v), None
    raise ValueError(case)


# case -> sites fused
FUSION_CASES = {"multi_consumer": 0, "trainable_scale": 0, "broadcast_kv": 1,
                "intermediate": 1, "mask_first": 1, "dynamic_mask": 1, "unscaled": 1}
MASK = np.where(np.random.default_rng(7).integers(0, 2, (2, 1, 1, 8)) > 0, 0.0,
                -1e9).astype(np.float32)


@pytest.mark.parametrize("case", list(FUSION_CASES))
def test_fusion_unit_cases_match_the_reference(case, tmp_path):
    feed = {"mask": MASK} if case == "dynamic_mask" else {}
    res = {}
    for pkg in ("ref", "port"):
        sd, out, extra = _build(pkg, case)
        want = np.asarray(sd.output(feed, out.name)[out.name].toNumpy())
        assert sd.fuseAttention() == FUSION_CASES[case]
        got = np.asarray(sd.output(feed, out.name)[out.name].toNumpy())
        np.testing.assert_allclose(got, want, atol=1e-6)
        res[pkg] = (sd, out, extra, got)
    (rsd, _, _, rgot), (psd, out, extra, pgot) = res["ref"], res["port"]
    assert _nodes(psd) == _nodes(rsd)
    np.testing.assert_allclose(pgot, rgot, atol=1e-6)
    if case == "multi_consumer":
        assert np.isfinite(float(extra.eval().toNumpy()))
    if case == "dynamic_mask":
        node = next(o for o in psd._ops if o.opname == "scaledDotProductAttentionFused")
        assert len(node.inputs) == 4
        got2 = psd.output({"mask": np.zeros_like(MASK)}, out.name)[out.name].toNumpy()
        assert np.max(np.abs(got2 - pgot)) > 1e-4
    if case == "unscaled":
        node = next(o for o in psd._ops if o.opname == "scaledDotProductAttentionFused")
        assert node.kwargs["scale"] == 1.0
    if case == "intermediate":
        for sd in (rsd, psd):
            with pytest.raises(ValueError, match="fuseAttention"):
                sd.output({}, extra.name)
        assert psd.output({}, out.name)[out.name].shape == (2, 3, 8, 4)
        # the targeted error survives save and load, either package writing
        for writer, reader in ((psd, RSameDiff.load),
                               (rsd, lambda p: PSameDiff.load(p, device="cpu"))):
            path = str(tmp_path / f"{id(writer)}.zip")
            writer.save(path)
            with pytest.raises(ValueError, match="fuseAttention"):
                reader(path).output({}, extra.name)


def test_fused_masked_graph_serde_both_ways(tiny_bert, tmp_path):
    """A fused masked import saved by either package loads in the other
    with the same outputs (1e-6) and real slices in stridedSlice."""
    gd, (ids_name, mask_name), o, _ = tiny_bert[True]
    rng = np.random.default_rng(12)
    feed = {ids_name: rng.integers(0, 64, (2, 16)).astype(np.int32),
            mask_name: np.ones((2, 16), np.float32)}
    for imp, load in ((RImporter.runImport, lambda p: PSameDiff.load(p, device="cpu")),
                      (_port_import, RSameDiff.load)):
        sd = imp(gd)
        assert sd.fuseAttention() == 2
        want = np.asarray(sd.output(feed, o)[o].toNumpy())
        p = str(tmp_path / "m.zip")
        sd.save(p)
        back = load(p)
        np.testing.assert_allclose(np.asarray(back.output(feed, o)[o].toNumpy()), want,
                                   atol=1e-6)
        assert any(isinstance(s, slice) for op in back._ops if op.opname == "stridedSlice"
                   for s in op.kwargs["slices"])


def test_fused_op_refusals_and_masked_einsum():
    rng = np.random.default_rng(8)
    q = torch.from_numpy(rng.normal(size=(1, 2, 16, 4)).astype(np.float32))
    mask = torch.zeros((1, 1, 1, 16))
    f = pops.nn.scaledDotProductAttentionFused
    np.testing.assert_allclose(f(q, q, q, mask=mask).toNumpy(), f(q, q, q).toNumpy(), atol=1e-6)
    with pytest.raises(ValueError, match="use_kernel=True"):
        f(q, q, q, mask=mask, use_kernel=True)
    q10 = torch.from_numpy(rng.normal(size=(1, 2, 10, 4)).astype(np.float32))
    with pytest.raises(ValueError, match="use_kernel=True"):
        f(q10, q10, q10, use_kernel=True)
