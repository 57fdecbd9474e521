"""The rest of the port's ``profiler`` (``PanicException``,
``ProfilerConfig``, ``check_tree_finite``, ``ProfilingListener``,
``device_trace``, ``peak_flops``) and ``util`` (``resources.py``,
``sharded_checkpoint.py``) on the CPU, beside the JAX package's where
both answer the same question (the same verdicts on the same trees, the
same checksums, the same resource and archive behaviour).

``ShardedCheckpointManager`` resumes exactly over a 2-rank gloo world
(``tests/torch_dist_worker.py``'s ``checkpoint`` suite, one thread a
rank): a run stopped by SIGTERM at step 3 and restored from its latest
checkpoint ends with every rank's params and optimizer state bit-equal
to a run without the break, and the same losses.
"""
import io
import json
import os
import signal
import tarfile
import zipfile

import numpy as np
import pytest
import torch

import deeplearning4j_tpu.profiler as jprof
import deeplearning4j_tpu.util.resources as jres
import deeplearning4j_tpu_torch.nn as pnn
import deeplearning4j_tpu_torch.train as ptrain
from deeplearning4j_tpu_torch import profiler as prof
from deeplearning4j_tpu_torch.data import DataSet
from deeplearning4j_tpu_torch.util import resources as pres
from deeplearning4j_tpu_torch.util.sharded_checkpoint import (
    GracefulShutdown, ShardedCheckpointManager, train_with_checkpointing)

import torch_dist_worker as W
from torch_threads import one_torch_thread  # noqa: F401,E402


def _finite_verdict(check, tree, **kw):
    try:
        check(tree, "t", **kw)
        return None
    except (prof.PanicException, jprof.PanicException) as e:
        return str(e).split(" detected")[0]


@pytest.mark.parametrize("bad,kw", [(None, {}), (np.nan, {}), (np.inf, {}),
                                    (np.nan, {"check_nan": False}),
                                    (np.inf, {"check_inf": False})],
                         ids=["finite", "nan", "inf", "nan-unchecked", "inf-unchecked"])
def test_check_tree_finite_as_the_reference(bad, kw):
    a = np.arange(6, dtype=np.float32).reshape(2, 3)
    b = np.ones(4, np.float32)
    if bad is not None:
        b[2] = bad
    ids = np.arange(3, dtype=np.int32)
    ptree = {"w": [torch.from_numpy(a), {"b": torch.from_numpy(b)}], "ids": torch.from_numpy(ids)}
    jtree = {"w": [a, {"b": b}], "ids": ids}
    assert _finite_verdict(prof.check_tree_finite, ptree, **kw) == \
        _finite_verdict(jprof.profiler.check_tree_finite, jtree, **kw)


def _net():
    L = pnn.layers
    conf = (pnn.NeuralNetConfiguration.Builder().seed(3).updater(ptrain.Sgd(0.1)).list()
            .layer(L.DenseLayer(nIn=4, nOut=5, activation="TANH"))
            .layer(L.OutputLayer(nIn=5, nOut=2, lossFunction="MCXENT")).build())
    return pnn.MultiLayerNetwork(conf, device="cpu").init()


def _ds(seed=0):
    rng = np.random.default_rng(seed)
    return DataSet(rng.normal(size=(8, 4)).astype(np.float32),
                   np.eye(2, dtype=np.float32)[rng.integers(0, 2, 8)])


def test_profiling_listener_panics_on_nan_score_params_and_grads():
    cfg = prof.ProfilerConfig(checkForNAN=True, checkForINF=True)
    listener = prof.ProfilingListener(prof.OpProfiler(), config=cfg)
    assert listener.requiresGradients
    net = _net()
    net.setListeners(listener)
    net.fit(_ds())                       # finite: no panic, grads kept
    assert net._last_grads is not None
    assert [s.name for s in listener.profiler.spans] == []
    net.fit(_ds(1))
    assert [s.name for s in listener.profiler.spans] == ["iteration"]
    net._params[0]["W"][0, 0] = float("nan")
    with pytest.raises(prof.PanicException, match="NaN score"):
        net.fit(_ds(2))

    class Model:   # a finite score over NaN parameters, then NaN gradients
        def __init__(self, params, grads=None):
            self._params, self._last_grads = params, grads

        def score(self):
            return 0.5

    with pytest.raises(prof.PanicException, match="NaN detected in parameters@iter7"):
        listener.iterationDone(Model([torch.tensor([1.0, float("nan")])]), 7, 0)
    with pytest.raises(prof.PanicException, match="Inf detected in gradients@iter8"):
        listener.iterationDone(Model([torch.ones(2)], [torch.tensor([float("inf")])]), 8, 0)
    off = prof.ProfilingListener(prof.OpProfiler(prof.ProfilerConfig(collectSpans=False)))
    off.iterationDone(Model([torch.tensor([float("nan")])]), 1, 0)   # panic modes off
    off.iterationDone(Model([torch.tensor([float("nan")])]), 2, 0)
    assert off.profiler.spans == []


def test_device_trace_writes_a_chrome_trace(tmp_path):
    with prof.device_trace(str(tmp_path)) as p:
        torch.ones(64, 64).matmul(torch.ones(64, 64)).sum()
    with prof.device_trace(str(tmp_path)):
        torch.zeros(3).add(1)
    files = sorted(os.listdir(tmp_path))
    assert files == ["trace_0.json", "trace_1.json"]
    with open(tmp_path / files[0]) as f:
        events = json.load(f)["traceEvents"]
    assert any("mm" in e.get("name", "") for e in events)
    assert any("mm" in e.key for e in p.key_averages())


def test_peak_flops_answers_the_card_or_raises():
    assert prof.peak_flops("NVIDIA H100 80GB HBM3") == 989e12
    for name in ("NVIDIA H100 NVL", "NVIDIA H100 PCIe", "NVIDIA A100-SXM4-80GB",
                 "TPU v5 lite", "NVIDIA GeForce RTX 4090", ""):
        with pytest.raises(ValueError, match="no peak rate known"):
            prof.peak_flops(name)
    assert prof.mfu(1000.0, 1e9, prof.peak_flops("NVIDIA H100 80GB HBM3")) == \
        pytest.approx(1e12 / 989e12)


# ----------------------------------------------------------------- util


@pytest.mark.parametrize("mod", [jres, pres], ids=["jax", "port"])
def test_resources_local_hook_checksum_and_cache(mod, tmp_path, monkeypatch):
    monkeypatch.setenv("DL4JTPU_RESOURCES_CACHE_DIR", str(tmp_path / "cache"))
    R = mod.Resources
    payload = b"weights" * 100
    want = mod.sha256_of(_write(tmp_path / "src.bin", payload))
    assert want == pres.sha256_of(str(tmp_path / "src.bin"))
    R.registerFetchHook(None)
    try:
        with pytest.raises(FileNotFoundError, match="no fetch hook"):
            R.asFile("models/a.bin")
        with pytest.raises(ValueError, match="escapes"):
            R.asFile("../outside.bin")
        calls = []

        def hook(name, dest):
            calls.append(name)
            dest.write_bytes(payload)

        R.registerFetchHook(hook)
        p = R.asFile("models/a.bin", sha256=want)
        assert p.read_bytes() == payload and R.exists("models/a.bin")
        assert R.asFile("models/a.bin", sha256=want) == p and calls == ["models/a.bin"]
        with pytest.raises(IOError, match="checksum mismatch"):
            R.asFile("models/b.bin", sha256="0" * 64)   # fetched, bad: evicted
        assert not R.exists("models/b.bin")
        (tmp_path / "cache" / "seeded.bin").write_bytes(b"user")
        with pytest.raises(IOError, match="checksum mismatch"):
            R.asFile("seeded.bin", sha256="0" * 64, evictOnMismatch=False)
        assert R.exists("seeded.bin")
        assert not [f for f in os.listdir(tmp_path / "cache" / "models") if ".part" in f]
    finally:
        R.registerFetchHook(None)


def _write(path, data: bytes) -> str:
    with open(path, "wb") as f:
        f.write(data)
    return str(path)


@pytest.mark.parametrize("mod", [jres, pres], ids=["jax", "port"])
def test_archive_utils(mod, tmp_path):
    A = mod.ArchiveUtils
    src = tmp_path / "src"
    (src / "d").mkdir(parents=True)
    (src / "a.txt").write_text("a")
    (src / "d" / "b.txt").write_text("b")
    A.zipDirectory(str(src), str(tmp_path / "x.zip"))
    A.unzipFileTo(str(tmp_path / "x.zip"), str(tmp_path / "out"))
    assert (tmp_path / "out" / "d" / "b.txt").read_text() == "b"
    with zipfile.ZipFile(tmp_path / "evil.zip", "w") as zf:
        zf.writestr("../evil.txt", "x")
    with pytest.raises(ValueError, match="escapes"):
        A.unzipFileTo(str(tmp_path / "evil.zip"), str(tmp_path / "out2"))
    with tarfile.open(tmp_path / "t.tar.gz", "w:gz") as tf:
        info = tarfile.TarInfo("inner/c.txt")
        info.size = 3
        tf.addfile(info, io.BytesIO(b"ccc"))
    A.tarGzExtractSingleFile(str(tmp_path / "t.tar.gz"), str(tmp_path / "one" / "c.txt"),
                             "inner/c.txt")
    assert (tmp_path / "one" / "c.txt").read_bytes() == b"ccc"
    with pytest.raises(FileNotFoundError):
        A.tarGzExtractSingleFile(str(tmp_path / "t.tar.gz"), str(tmp_path / "z"), "nope")
    A.untarTo(str(tmp_path / "t.tar.gz"), str(tmp_path / "all"))
    assert (tmp_path / "all" / "inner" / "c.txt").read_bytes() == b"ccc"


def test_graceful_shutdown_flags_and_restores_handlers():
    seen = []
    prev = signal.signal(signal.SIGTERM, lambda s, f: seen.append(s))
    try:
        with GracefulShutdown() as stop:
            assert not stop.should_stop()
            signal.raise_signal(signal.SIGTERM)
            assert stop.should_stop()
            assert seen == [signal.SIGTERM]     # the displaced handler chained
        signal.raise_signal(signal.SIGTERM)      # restored on exit
        assert seen == [signal.SIGTERM] * 2
    finally:
        signal.signal(signal.SIGTERM, prev)


def test_checkpoint_manager_retention_interval_and_exact_restore(tmp_path):
    """One process: save-every-2 with keep-last-2, the idempotent re-save,
    a forced save off the interval, and a restore that lands on the
    like-trees' dtypes exactly."""
    params = {"w": torch.arange(6, dtype=torch.float32).reshape(2, 3),
              "b": torch.zeros(3, dtype=torch.bfloat16)}
    state = {"count": 0, "mu": [torch.ones(2, 3)]}

    def step(p, s, batch):
        p = {"w": p["w"] * 1.5 + batch, "b": p["b"] + 1}
        return p, {"count": s["count"] + 1, "mu": [s["mu"][0] * 0.5 + p["w"]]}, \
            float(p["w"].sum())

    mgr = ShardedCheckpointManager(str(tmp_path), keep_last=2, save_interval_steps=2)
    assert mgr.latest_step() is None
    out_p, out_s, n, losses = train_with_checkpointing(step, params, state,
                                                       lambda s: float(s), 5, mgr)
    assert n == 5 and len(losses) == 5
    assert mgr.all_steps() == [2, 4]
    assert mgr.save(4, out_p, out_s) and mgr.all_steps() == [2, 4]   # idempotent
    assert not mgr.save(5, out_p, out_s)                              # off-interval
    assert mgr.save(5, out_p, out_s, metadata={"k": 1}, force=True)
    assert mgr.all_steps() == [4, 5]
    p, s, at, meta = mgr.restore(params, state)
    assert (at, meta) == (5, {"k": 1})
    assert torch.equal(p["w"], out_p["w"]) and p["b"].dtype == torch.bfloat16
    assert torch.equal(p["b"], out_p["b"]) and s["count"] == 5
    assert torch.equal(s["mu"][0], out_s["mu"][0])
    p4, _, at4, meta4 = mgr.restore(params, state, step=4)
    assert at4 == 4 and meta4 == {"step": 4, "loss": losses[3]}
    with pytest.raises(ValueError, match="shape"):
        mgr.restore({"w": torch.zeros(3, 2), "b": params["b"]}, state)
    with pytest.raises(FileNotFoundError):
        ShardedCheckpointManager(str(tmp_path / "empty")).restore(params, state)


@pytest.fixture(scope="module")
def ckpt_world(tmp_path_factory):
    w = W.World("checkpoint", 2, tmp_path_factory.mktemp("torch_ckpt"), 240.0)
    yield w
    w.close()


def test_sharded_checkpoint_resumes_exactly_over_two_ranks(ckpt_world):
    res = ckpt_world.case("resume")
    assert res["stopped_at"] == W.CKPT_STOP and res["restored"] == W.CKPT_STOP
    assert res["meta"]["preempted"] is True
    assert res["steps"] == [4, 6]             # keep-last-2 at the run's end
    assert res["first"] + res["second"] == res["whole"]
    assert res["bit_equal"] == [True, True]
    assert ckpt_world.results()["_jax_imported"] == []
