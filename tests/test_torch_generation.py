"""The PyTorch port's generation engine (deeplearning4j_tpu_torch/serving)
against the JAX package's, on the CPU.

Both engines serve the same numpy-drawn parameters. The JAX engine runs
its default ``paged_attention="gather"`` route with ``attention_impl=
"full"`` — the same functions as its kernels, without the slow
interpret-mode Pallas calls; the port runs both of its routes (the fused
one with the packed prefill attention, whose CPU path is the kernels'
plain version). Streams must be token-equal, greedy and sampled.
"""
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deeplearning4j_tpu.models import TransformerConfig as JaxConfig
from deeplearning4j_tpu.models import init_params as jax_init_params
from deeplearning4j_tpu.serving import GenerationEngine as JaxEngine
from deeplearning4j_tpu.serving import prefill_buckets as jax_buckets
from deeplearning4j_tpu_torch.models import (
    TransformerConfig, params_from_numpy)
from deeplearning4j_tpu_torch.serving import (
    DeadlineExceededError, GenerationEngine, KVBlocksExhaustedError,
    QueueFullError, RejectedError, prefill_buckets)
from torch_threads import one_torch_thread  # noqa: F401,E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WIDTHS = dict(vocab_size=1024, hidden=128, layers=2, heads=4, mlp_dim=512,
              max_seq=128, causal=True, remat=False)
JCFG = JaxConfig(**WIDTHS, dtype=jnp.float32, attention_impl="full")


def tcfg(impl="full"):
    return TransformerConfig(**WIDTHS, dtype=torch.float32,
                             attention_impl=impl)


def prompt(n, seed=0):
    return np.random.default_rng(seed).integers(0, 1024, n).astype(np.int32)


# prompts reach two prefill buckets (8, 16): few JAX compiles
PROMPTS = [prompt(n, seed=20 + n) for n in (5, 9, 13, 16)]
GREEDY = [dict()] * len(PROMPTS)
SAMPLED = [dict(temperature=0.8, top_k=40, seed=s) for s in (1, 2, 3, 4)]


@pytest.fixture(scope="module")
def np_params():
    p = jax_init_params(jax.random.PRNGKey(0), JCFG)
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), p)


def _serve(engine, kwargs, max_new=12):
    handles = [engine.submit(p, max_new_tokens=max_new, **kw)
               for p, kw in zip(PROMPTS, kwargs)]
    return [h.result(timeout=300) for h in handles]


@pytest.fixture(scope="module")
def jax_streams(np_params):
    params = jax.tree_util.tree_map(jnp.asarray, np_params)
    out = {}
    for kv in ("float32", "int8"):
        with JaxEngine(params, JCFG, slots=4, max_len=64,
                       paged_attention="gather", kv_dtype=kv) as eng:
            out[kv, "greedy"] = _serve(eng, GREEDY)
            out[kv, "sampled"] = _serve(eng, SAMPLED)
    return out


@pytest.fixture(scope="module")
def tparams(np_params):
    return params_from_numpy(np_params, device="cpu")


def _engine(tparams, route="gather", **kw):
    return GenerationEngine(tparams, tcfg("flash" if route == "fused"
                                          else "full"),
                            paged_attention=route, device="cpu",
                            **{**dict(slots=4, max_len=64), **kw})


class TestParityWithJaxEngine:
    @pytest.mark.parametrize("kv_dtype", ["float32", "int8"])
    @pytest.mark.parametrize("route", ["gather", "fused"])
    @pytest.mark.parametrize("mode", ["greedy", "sampled"])
    def test_streams_token_equal(self, tparams, jax_streams, route,
                                 kv_dtype, mode):
        with _engine(tparams, route, kv_dtype=kv_dtype) as eng:
            got = _serve(eng, GREEDY if mode == "greedy" else SAMPLED)
        assert got == jax_streams[kv_dtype, mode]

    def test_prefill_buckets_match(self):
        for n in (1, 7, 8, 10, 64, 512):
            assert prefill_buckets(n) == jax_buckets(n)


class TestScheduling:
    @pytest.mark.parametrize("kw", [
        dict(temperature=0.0, top_k=0, seed=11),
        dict(temperature=0.7, top_k=5, seed=123),
        dict(temperature=1.3, top_k=0, seed=42)])
    def test_alone_vs_coscheduled_identical(self, tparams, kw):
        """A stream's tokens depend only on (params, prompt, key) — never
        on which slot or neighbours served it."""
        p = prompt(6, seed=9)
        with _engine(tparams, "fused") as eng:
            alone = eng.generate(p, max_new_tokens=8, timeout=120, **kw)
            decoys = [eng.submit(prompt(4 + i, seed=50 + i),
                                 max_new_tokens=20, temperature=0.9,
                                 top_k=3, seed=1000 + i) for i in range(3)]
            co = eng.submit(p, max_new_tokens=8, **kw).result(timeout=120)
            for d in decoys:
                d.result(timeout=120)
        assert co == alone

    def test_eos_retires_and_slots_recycle(self, tparams):
        with _engine(tparams, slots=2) as eng:
            ref = eng.generate(PROMPTS[0], max_new_tokens=10, timeout=60)
            eos = ref[3]
            cut = eng.generate(PROMPTS[0], max_new_tokens=10, eos_id=eos,
                               timeout=60)
            assert cut == ref[:ref.index(eos) + 1]
            outs = [eng.submit(prompt(3 + i, i), max_new_tokens=4)
                    for i in range(7)]
            assert all(len(h.result(timeout=60)) == 4 for h in outs)
            assert eng.live_slots == 0
            assert eng._allocator.in_use == 0
            m = eng.metrics
            assert m.prefills_total.value == 9
            assert m.generations_completed.value == 9
            assert m.decode_tokens_per_sec() > 0

    def test_stream_yields_incrementally(self, tparams):
        with _engine(tparams) as eng:
            h = eng.submit(PROMPTS[1], max_new_tokens=6)
            assert list(h.stream(timeout=60)) == h.result(timeout=60)
            assert h.finish_reason == "max_tokens"

    def test_warmup_covers_every_bucket(self, tparams):
        with _engine(tparams, slots=2, max_len=32) as eng:
            eng.warmup()
            assert eng.metrics.prefills_total.value == len(eng.buckets)
            assert eng._allocator.in_use == 0


class TestAdmission:
    def test_kv_blocks_exhausted_shed_typed(self, tparams):
        with _engine(tparams, slots=2, max_len=40, block_size=8,
                     num_blocks=5) as eng:
            with pytest.raises(KVBlocksExhaustedError) as ei:
                eng.submit(prompt(20), max_new_tokens=18)   # 5 > 4 blocks
            assert ei.value.reason == "kv_blocks_exhausted"
            assert ei.value.needed == 5 and ei.value.usable == 4
            assert eng.metrics.rejections_by_reason.get(
                "kv_blocks_exhausted") == 1
            # a request that fits is still served
            assert len(eng.generate(prompt(4), max_new_tokens=4,
                                    timeout=60)) == 4

    def test_requests_wait_for_blocks(self, tparams):
        """4 slots but 4 usable blocks: 2-block streams run two at a time,
        the rest wait at the queue head and all finish."""
        with _engine(tparams, slots=4, max_len=32, block_size=8,
                     num_blocks=5) as eng:
            hs = [eng.submit(prompt(6, i), max_new_tokens=8)
                  for i in range(5)]
            assert all(len(h.result(timeout=120)) == 8 for h in hs)
            assert eng._allocator.in_use == 0

    def test_submit_validation(self, tparams):
        with _engine(tparams, slots=1, max_len=16) as eng:
            with pytest.raises(ValueError, match="at least one"):
                eng.submit([])
            with pytest.raises(ValueError, match="capacity"):
                eng.submit(prompt(10), max_new_tokens=8)
            with pytest.raises(ValueError, match="positive"):
                eng.submit(prompt(2), max_new_tokens=0)
        with pytest.raises(ValueError, match="causal"):
            GenerationEngine(tparams, TransformerConfig(
                **{**WIDTHS, "causal": False}, dtype=torch.float32),
                device="cpu")

    def test_queue_full_deadline_and_shutdown(self, tparams):
        eng = _engine(tparams, slots=1, queue_capacity=2)
        try:
            busy = eng.submit(prompt(4), max_new_tokens=40)
            deadline = time.time() + 60
            while not busy.tokens_so_far():
                assert time.time() < deadline
                time.sleep(0.001)
            late = eng.submit(prompt(4), max_new_tokens=2, timeout_ms=1)
            queued = eng.submit(prompt(5), max_new_tokens=2)
            with pytest.raises(QueueFullError):
                eng.submit(prompt(6), max_new_tokens=2)
            with pytest.raises(DeadlineExceededError):
                late.result(timeout=60)
        finally:
            eng.shutdown()
        with pytest.raises(RejectedError):
            busy.result(timeout=10)
        with pytest.raises(RejectedError):
            queued.result(timeout=10)
        m = eng.metrics
        assert m.rejections_by_reason.get("queue_full") == 1
        assert m.rejections_by_reason.get("deadline") == 1
        with pytest.raises(RejectedError):
            eng.submit(prompt(3))

    def test_engine_needs_cuda_unless_asked_for_cpu(self, tparams):
        if torch.cuda.is_available():
            pytest.skip("a CUDA device is present: the default is usable")
        with pytest.raises(RuntimeError, match="device='cpu'"):
            GenerationEngine(tparams, tcfg())


def test_port_imports_no_jax():
    """Importing every module of the port (found by walking the package,
    so a new module is covered) leaves ``jax``, ``optax``, ``tensorflow``,
    ``h5py``, ``google.protobuf`` and the JAX package out of
    ``sys.modules``."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import deeplearning4j_tpu_torch as pkg\n"
        "names = [m.name for m in pkgutil.walk_packages(pkg.__path__, "
        "pkg.__name__ + '.')]\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "for want in ('ops.pallas_updaters', 'serving.rpc', 'serving.cluster',\n"
        "             'serving.disagg', 'serving.sharded', 'parallel.mesh',\n"
        "             'parallel.multihost', 'parallel.sequence_parallel',\n"
        "             'ndarray.array', 'ops.registry', 'ops.math_defs',\n"
        "             'ops.nn_defs', 'ops.extra_defs', 'ops.more_defs',\n"
        "             'ops.wide_defs', 'parallel.gradient_sharing',\n"
        "             'data.dataset', 'data.normalizers', 'data.fetchers',\n"
        "             'train.activations', 'train.schedules', 'train.updaters',\n"
        "             'train.regularization', 'train.losses', 'nn.conf.inputs',\n"
        "             'nn.conf.weights', 'nn.conf.dropout', 'nn.conf.layers',\n"
        "             'nn.conf.builder', 'eval.evaluation', 'nn.multilayer',\n"
        "             'optimize.listeners', 'util.model_serializer',\n"
        "             'autodiff.samediff', 'autodiff.rewrites',\n"
        "             'modelimport.tensorflow.importer', 'utils.gradientcheck',\n"
        "             'util.resources', 'util.sharded_checkpoint',\n"
        "             'modelimport.onnx.importer', 'modelimport.onnx.wire',\n"
        "             'modelimport.keras.importer', 'interop.onnx_runner',\n"
        "             'interop.tf_runner', 'zoo.models'):\n"
        "    assert 'deeplearning4j_tpu_torch.' + want in names, names\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' "
        "or m.startswith(('jax.', 'jaxlib', 'optax', 'deeplearning4j_tpu.', "
        "'tensorflow', 'h5py', 'google.protobuf')) "
        "or m in ('deeplearning4j_tpu', 'google.protobuf'))\n"
        "assert not bad, bad\n"
        "print(len(names), 'clean')\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith(" clean")
