"""The port's batching ``InferenceEngine`` and ``ModelRegistry``
(deeplearning4j_tpu_torch/serving/engine.py and registry.py) against the
JAX package's, on the CPU.

- The engine over the reference tests' numpy ``MlpAdapter``
  (``tests/test_cluster.py:45``), each scenario of
  ``tests/test_serving.py:74-296`` run through both packages with the
  results compared: coalescing into one batch, the bucket ladder bounding
  the batch shapes, admission sheds (deadline, queue full, shutdown),
  the breaker, a poisoned output, drain, and the ``ServingMetrics``
  counters of a scripted sequence.
- ``CausalLMAdapter.infer`` through both engines against the JAX
  package's ``make_infer_last_logits`` at the reference tests' tiny fp32
  config, and bit for bit against the port's own direct call on the same
  padded bucket batch.
- The registry's deploy / alias / undeploy / previous-version fallback /
  health over one scripted sequence on both packages, equal results; the
  ``registry.warmup`` fault point; ``deploy(draft_model=)`` streams equal
  to the JAX registry's.

Tolerances: counters, refs, health and streams exactly equal; logits
within 1e-5 of the largest |logit| (fp32 on both sides, the same
weights; the JAX package pins exact fp32 matmuls on the CPU and the port
turns TF32 off).
"""
import threading
import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import deeplearning4j_tpu.serving as J
from deeplearning4j_tpu.models import TransformerConfig as JaxConfig
from deeplearning4j_tpu.models import init_params as jax_init_params
from deeplearning4j_tpu.models.bert import (
    make_infer_last_logits as jax_last_logits)
from deeplearning4j_tpu.serving import faults as jax_faults
import deeplearning4j_tpu_torch.serving as T
from deeplearning4j_tpu_torch.models import (
    TransformerConfig, params_from_numpy)
from deeplearning4j_tpu_torch.models.bert import make_infer_last_logits
from deeplearning4j_tpu_torch.serving import faults as t_faults

PKGS = {"jax": J, "torch": T}
WIDTHS = dict(vocab_size=50, hidden=32, layers=2, heads=2, mlp_dim=64,
              max_seq=64, causal=True, remat=False)
DWIDTHS = dict(vocab_size=50, hidden=16, layers=1, heads=2, mlp_dim=32,
               max_seq=64, causal=True, remat=False)
JCFG = JaxConfig(**WIDTHS, dtype=jnp.float32, attention_impl="full")
TCFG = TransformerConfig(**WIDTHS, dtype=torch.float32,
                         attention_impl="full")
JDCFG = JaxConfig(**DWIDTHS, dtype=jnp.float32, attention_impl="full")
TDCFG = TransformerConfig(**DWIDTHS, dtype=torch.float32,
                          attention_impl="full")
# the ServingMetrics counters every engine scenario compares
COUNTERS = ("requests_total", "rows_total", "batches_total",
            "padded_rows_total", "rejected_total", "rejected_queue_full",
            "rejected_deadline", "failed_total", "bucket_hits",
            "bucket_compiles", "rejected_circuit_open",
            "poisoned_results_total")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture
def gloo_world(tmp_path):
    """A process group of one gloo rank in this process, for the mesh
    tests; destroyed after the test."""
    import torch.distributed as dist

    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            world_size=1, rank=0)
    yield
    dist.destroy_process_group()


@pytest.fixture(autouse=True)
def _no_plan_left():
    yield
    for mod in (jax_faults, t_faults):
        if mod.active_plan() is not None:
            mod.active_plan().uninstall()


def host(x) -> np.ndarray:
    return x.toNumpy() if hasattr(x, "toNumpy") else np.asarray(x)


def mlp(pkg, *, w_seed=0, delay_s=0.0, fail=False, nan=False):
    """The reference tests' numpy MLP adapter, as a subclass of ``pkg``'s
    ModelAdapter: ``fail`` raises in infer, ``nan`` returns NaNs."""

    class MlpAdapter(pkg.ModelAdapter):
        kind = "tiny-mlp"

        def __init__(self):
            super().__init__(model=None)
            self.w = (np.linspace(-1.0, 1.0, 6, dtype=np.float32)
                      * (1.0 + w_seed)).reshape(6, 1)
            self.calls = 0

        def infer(self, x):
            self.calls += 1
            if delay_s:
                time.sleep(delay_s)
            if fail:
                raise RuntimeError("kernel exploded")
            y = np.asarray(x, np.float32) @ self.w
            return np.full_like(y, np.nan) if nan else y

    return MlpAdapter()


def counters(eng) -> dict:
    m = eng.metrics
    out = {k: getattr(m, k).value for k in COUNTERS}
    out["rejections_by_reason"] = m.rejections_by_reason.to_dict()
    return out


def both(fn):
    """``fn(pkg)`` on each package; asserts the results are equal and
    returns the port's."""
    got = {side: fn(pkg) for side, pkg in PKGS.items()}
    assert got["torch"] == got["jax"]
    return got["torch"]


def rows(n, seed=0):
    return np.random.default_rng(seed).normal(size=(n, 6)).astype(np.float32)


# --------------------------------------------------------------------------
# The batching engine over the numpy adapter
# --------------------------------------------------------------------------
class TestEngine:
    def test_concurrent_submitters_coalesce_into_one_batch(self):
        def run(pkg):
            ad = mlp(pkg)
            xs = [rows(4, s) for s in range(8)]
            with pkg.InferenceEngine(ad, max_batch_size=32,
                                     max_wait_ms=500) as eng:
                outs = [f.result(timeout=60)
                        for f in [eng.submit(x) for x in xs]]
                # the rows of one call on the whole (unpadded) batch
                full = np.concatenate(xs) @ ad.w
                for i, o in enumerate(outs):
                    assert np.array_equal(host(o), full[4 * i:4 * i + 4])
                return (counters(eng), eng.metrics.mean_requests_per_batch(),
                        ad.calls)

        c, mean, calls = both(run)
        assert c["batches_total"] == 1 and mean == 8.0 and calls == 1
        assert c["rows_total"] == 32 and c["padded_rows_total"] == 0

    def test_single_request_pads_to_bucket(self):
        def run(pkg):
            with pkg.InferenceEngine(mlp(pkg), max_batch_size=16,
                                     max_wait_ms=0) as eng:
                out = host(eng.output(np.zeros((3, 6), np.float32)))
                return out.shape, counters(eng), eng.metrics.fill_ratio.count

        shape, c, fills = both(run)
        assert shape == (3, 1) and c["padded_rows_total"] == 1 and fills == 1

    def test_bucket_ladder_bounds_batch_shapes(self):
        def run(pkg):
            with pkg.InferenceEngine(mlp(pkg), max_batch_size=64,
                                     max_wait_ms=0) as eng:
                for b in range(1, 51):
                    assert host(eng.output(np.ones((b, 6), np.float32))
                                ).shape == (b, 1)
                return (eng.buckets, counters(eng),
                        eng.compiled_signatures(),
                        eng.metrics.snapshot()["per_bucket"])

        ladder, c, sigs, per_bucket = both(run)
        assert ladder == T.bucket_ladder(64) == (1, 2, 4, 8, 16, 32, 64)
        # 50 request sizes, one first sight per rung
        assert c["bucket_compiles"] == sigs == len(ladder)
        assert c["bucket_hits"] == 50 - c["bucket_compiles"]
        assert set(per_bucket) == {str(b) for b in ladder}

    def test_oversize_empty_and_mismatched_rows_refused(self):
        def run(pkg):
            out = []
            with pkg.InferenceEngine(mlp(pkg), max_batch_size=4,
                                     max_wait_ms=0) as eng:
                for x in (np.zeros((5, 6), np.float32),
                          np.zeros((0, 6), np.float32)):
                    with pytest.raises(ValueError) as ei:
                        eng.submit(x)
                    out.append(str(ei.value))
                eng.output(np.zeros((2, 6), np.float32))
                for x in (np.zeros((2, 6), np.float64),
                          np.zeros((2, 7), np.float32)):
                    with pytest.raises(ValueError, match="row signature"):
                        eng.submit(x)
            return out

        both(run)

    def test_deadline_shed_then_serves(self):
        def run(pkg):
            with pkg.InferenceEngine(mlp(pkg), max_batch_size=8,
                                     max_wait_ms=0) as eng:
                fut = eng.submit(np.zeros((2, 6), np.float32),
                                 timeout_ms=1e-4)
                with pytest.raises(pkg.DeadlineExceededError) as ei:
                    fut.result(timeout=30)
                assert isinstance(ei.value, pkg.RejectedError)
                out = host(eng.output(np.zeros((2, 6), np.float32)))
                return ei.value.reason, out.shape, counters(eng)

        reason, shape, c = both(run)
        assert reason == "deadline" and shape == (2, 1)
        assert c["rejected_deadline"] == 1

    def test_queue_full_backpressure(self):
        def run(pkg):
            with pkg.InferenceEngine(mlp(pkg, delay_s=0.25),
                                     max_batch_size=2, max_wait_ms=0,
                                     queue_capacity_rows=4) as eng:
                first = eng.submit(np.ones((2, 6), np.float32))
                time.sleep(0.05)
                held = [eng.submit(np.ones((2, 6), np.float32) * i)
                        for i in (2, 3)]
                with pytest.raises(pkg.QueueFullError) as ei:
                    eng.submit(np.ones((2, 6), np.float32))
                outs = [host(f.result(timeout=30)).tolist()
                        for f in [first] + held]
                return ei.value.reason, outs, counters(eng)

        reason, _outs, c = both(run)
        assert reason == "queue_full" and c["rejected_queue_full"] == 1

    def test_shutdown_rejects_queued_and_new(self):
        def run(pkg):
            eng = pkg.InferenceEngine(mlp(pkg, delay_s=0.5),
                                      max_batch_size=2, max_wait_ms=0,
                                      queue_capacity_rows=64)
            running = eng.submit(np.ones((2, 6), np.float32))
            time.sleep(0.05)
            queued = eng.submit(np.ones((2, 6), np.float32))
            eng.shutdown(wait=False)
            with pytest.raises(pkg.RejectedError) as ei:
                queued.result(timeout=30)
            with pytest.raises(pkg.RejectedError) as ei2:
                eng.submit(np.ones((2, 6), np.float32))
            running.result(timeout=30)
            eng.shutdown()
            return (ei.value.reason, ei2.value.reason,
                    pkg.check_shutdown(eng))

        assert both(run) == ("shutdown", "shutdown", [])

    def test_breaker_opens_and_sheds_typed(self, tmp_path):
        from deeplearning4j_tpu.util import crash_reporting as jc
        from deeplearning4j_tpu_torch.util import crash_reporting as tc

        def run(pkg):
            br = pkg.CircuitBreaker(failure_threshold=2, cooldown_s=60.0)
            with pkg.InferenceEngine(mlp(pkg, fail=True), max_batch_size=4,
                                     max_wait_ms=0, breaker=br) as eng:
                for _ in range(2):
                    with pytest.raises(RuntimeError, match="exploded"):
                        eng.output(np.ones((1, 6), np.float32))
                with pytest.raises(pkg.CircuitOpenError) as ei:
                    eng.submit(np.ones((1, 6), np.float32))
                return ei.value.reason, br.state, counters(eng)

        jc.crashDumpOutputDirectory(str(tmp_path))
        tc.crashDumpOutputDirectory(str(tmp_path))
        try:
            reason, state, c = both(run)
        finally:
            jc.crashDumpOutputDirectory(None)
            tc.crashDumpOutputDirectory(None)
        assert reason == "circuit_open" and state == "OPEN"
        assert c["failed_total"] == 2 and c["rejected_circuit_open"] == 1

    def test_poisoned_output_fails_typed(self):
        def run(pkg):
            with pkg.InferenceEngine(mlp(pkg, nan=True), max_batch_size=4,
                                     max_wait_ms=0) as eng:
                with pytest.raises(pkg.PoisonedResultError) as ei:
                    eng.output(np.ones((2, 6), np.float32))
                return ei.value.reason, counters(eng)

        reason, c = both(run)
        assert reason == "poisoned" and c["poisoned_results_total"] == 1

    def test_dispatch_fault_point_retried(self):
        def run(pkg):
            with pkg.FaultPlan(seed=0).fail("engine.dispatch", at=(0,)) \
                    as plan:
                with pkg.InferenceEngine(
                        mlp(pkg), max_batch_size=4, max_wait_ms=0,
                        retry_policy=pkg.RetryPolicy(max_attempts=2,
                                                     seed=0)) as eng:
                    out = host(eng.output(np.ones((2, 6), np.float32)))
                    return (out.tolist(), eng.metrics.retries_total.value,
                            [(e["point"], e["index"]) for e in plan.fired()])

        out, retries, fired = both(run)
        assert retries == 1 and fired == [("engine.dispatch", 0)]

    def test_drain_finishes_queued_then_sheds_typed(self):
        def run(pkg):
            with pkg.InferenceEngine(mlp(pkg, delay_s=0.1),
                                     max_batch_size=2,
                                     max_wait_ms=0) as eng:
                futs = [eng.submit(np.ones((2, 6), np.float32))
                        for _ in range(3)]
                drained = eng.drain(timeout=30)
                assert all(f.done() for f in futs)
                with pytest.raises(pkg.HostDrainingError) as ei:
                    eng.submit(np.ones((2, 6), np.float32))
                return drained, ei.value.reason, eng.ledger_stats()

        drained, reason, stats = both(run)
        assert drained is True and reason == "host_draining"
        assert stats["queue_depth"] == stats["inflight_rows"] == 0

    def test_scripted_counters_equal(self):
        def run(pkg):
            with pkg.InferenceEngine(mlp(pkg), max_batch_size=8,
                                     max_wait_ms=0) as eng:
                for round_ in range(3):
                    for b in (1, 3, 5):
                        eng.output(np.ones((b, 6), np.float32))
                    with pytest.raises(pkg.RejectedError):
                        eng.submit(np.ones((2, 6), np.float32),
                                   timeout_ms=1e-4).result(timeout=30)
                return counters(eng)

        c = both(run)
        assert c["requests_total"] == 12 and c["rows_total"] == 27

    def test_mesh_of_one_rank_serves_bit_equal(self, gloo_world):
        """``InferenceEngine(mesh=)`` on a mesh of one gloo rank (its
        batches go out on the plan channel to no follower) gives each
        request the rows of the meshless engine's, bit for bit."""
        from deeplearning4j_tpu_torch.parallel.mesh import make_mesh

        xs = [np.random.default_rng(s).normal(size=(n, 6)).astype(
            np.float32) for s, n in ((1, 1), (2, 3), (3, 2))]
        with T.InferenceEngine(mlp(T), max_batch_size=8,
                               max_wait_ms=0) as eng:
            want = [eng.output(x) for x in xs]
        with T.InferenceEngine(mlp(T), mesh=make_mesh({"data": 1}),
                               max_batch_size=8, max_wait_ms=0) as eng:
            got = [eng.output(x) for x in xs]
            assert eng.is_driver and eng._plan.plans == 3
        for a, b in zip(got, want):
            assert a.dtype == b.dtype and np.array_equal(a, b)


# --------------------------------------------------------------------------
# The causal LM behind the batching engine
# --------------------------------------------------------------------------
@pytest.fixture(scope="module")
def np_params():
    p = jax_init_params(jax.random.PRNGKey(0), JCFG)
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), p)


@pytest.fixture(scope="module")
def np_dparams():
    p = jax_init_params(jax.random.PRNGKey(1), JDCFG)
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), p)


def adapters(np_params):
    return {"jax": J.CausalLMAdapter(
                jax.tree_util.tree_map(jnp.asarray, np_params), JCFG),
            "torch": T.CausalLMAdapter(params_from_numpy(
                np_params, device="cpu"), TCFG, device="cpu")}


class TestCausalLM:
    def test_infer_matches_jax_through_both_engines(self, np_params):
        rng = np.random.default_rng(3)
        xs = [rng.integers(1, 50, (n, 12)).astype(np.int32)
              for n in (1, 3, 2, 4)]
        ref = np.asarray(jax_last_logits(JCFG)(
            jax.tree_util.tree_map(jnp.asarray, np_params),
            np.concatenate(xs)))
        outs = {}
        for side, ad in adapters(np_params).items():
            with PKGS[side].InferenceEngine(ad, max_batch_size=16,
                                            max_wait_ms=200) as eng:
                futs = [eng.submit(x) for x in xs]
                outs[side] = np.concatenate(
                    [host(f.result(timeout=120)) for f in futs])
                assert eng.metrics.batches_total.value == 1
        scale = np.abs(ref).max()
        for side in PKGS:
            assert outs[side].shape == (10, 50)
            assert np.abs(outs[side] - ref).max() <= 1e-5 * scale, side

    def test_engine_rows_are_the_padded_batch_rows(self, np_params):
        """Each request's output is bit for bit its rows of a direct call
        on the padded bucket batch the dispatcher formed."""
        ad = adapters(np_params)["torch"]
        x = np.random.default_rng(4).integers(1, 50, (3, 9)).astype(np.int32)
        with T.InferenceEngine(ad, max_batch_size=8, max_wait_ms=0) as eng:
            out = eng.output(x)
        padded = np.concatenate([x, np.zeros((1, 9), np.int32)])
        direct = make_infer_last_logits(TCFG)(
            ad.params, torch.from_numpy(padded)).numpy()
        assert out.dtype == np.float32 and np.array_equal(out, direct[:3])

    def test_adapter_refusals(self, np_params):
        p = params_from_numpy(np_params, device="cpu")
        with pytest.raises(ValueError, match="causal"):
            T.CausalLMAdapter(p, TransformerConfig(
                **{**WIDTHS, "causal": False}), device="cpu")
        with pytest.raises(TypeError, match="MultiLayerNetwork"):
            T.as_adapter(object())
        ad = T.CausalLMAdapter(p, TCFG, device="cpu")
        assert T.as_adapter(ad) is ad and ad.cache_size() is None


    def test_adapter_on_a_mesh_of_one_rank_is_bit_equal(self, np_params,
                                                        gloo_world):
        """``CausalLMAdapter(mesh=)`` on a {data: 1, model: 1} mesh of one
        gloo rank: ``infer`` through the batching engine and the
        adapter's generation engine are bit for bit the meshless
        adapter's (every collective sums or gathers over one rank)."""
        from deeplearning4j_tpu_torch.parallel.mesh import make_mesh

        p = params_from_numpy(np_params, device="cpu")
        x = np.random.default_rng(6).integers(1, 50, (3, 9)).astype(np.int32)
        plain = T.CausalLMAdapter(p, TCFG, device="cpu")
        mesh = make_mesh({"data": 1, "model": 1})
        sharded = T.CausalLMAdapter(p, TCFG, mesh, device="cpu")
        assert sharded.mesh is mesh
        with T.InferenceEngine(sharded, mesh=mesh, max_batch_size=4,
                               max_wait_ms=0) as eng:
            out = eng.output(x)
        assert np.array_equal(out, plain.infer(x)[:3])
        prompt = np.arange(1, 8, dtype=np.int32)
        streams = []
        for ad in (plain, sharded):
            with ad.generation_engine(slots=2, max_len=32,
                                      block_size=8) as g:
                assert g.mesh is ad.mesh
                streams.append(g.generate(prompt, max_new_tokens=6,
                                          temperature=0.8, top_k=5, seed=3,
                                          timeout=120))
        assert streams[0] == streams[1]


# --------------------------------------------------------------------------
# The registry
# --------------------------------------------------------------------------
def registry_script(pkg):
    """One scripted lifecycle; returns what a caller observes."""
    obs = []
    reg = pkg.ModelRegistry(default_buckets=(1, 2, 4),
                            breaker_failure_threshold=2,
                            breaker_cooldown_s=60.0)
    try:
        d1 = reg.deploy("m", mlp(pkg, w_seed=1),
                        warmup_example=np.zeros(6, np.float32))
        d2 = reg.deploy("m", mlp(pkg, w_seed=2, fail=True))
        obs.append((d1.ref, d2.ref, d1.state, d1.warmup_ms is not None,
                    d2.warmup_ms, reg.versions("m"), reg.get("m").ref))
        reg.alias("prod", "m:1")
        reg.alias("canary", "m")
        obs.append((reg.get("prod").ref, reg.get("canary").ref,
                    reg.aliases(), reg.models()))
        with pytest.raises(KeyError):
            reg.alias("x", "nope")
        with pytest.raises(ValueError):
            reg.deploy("a:b", mlp(pkg))
        with pytest.raises(ValueError):
            reg.deploy("m", mlp(pkg), version=2)
        e1 = reg.engine("m:1", max_wait_ms=0)
        obs.append((e1.buckets, e1.name, e1.compiled_signatures(),
                    host(e1.output(np.ones((3, 6), np.float32))).tolist()))
        e2 = reg.engine("m:2", max_wait_ms=0)
        for _ in range(2):
            with pytest.raises(RuntimeError):
                e2.output(np.ones((1, 6), np.float32))
        # v2's breaker is open: lookups fall back to v1, health says so
        obs.append((reg.get("m").ref, reg.get("m", fallback=False).ref,
                    reg.get("canary").ref, reg.metrics.fallback_serves.value,
                    reg.health()))
        with pytest.raises(pkg.CircuitOpenError):
            e2.submit(np.ones((1, 6), np.float32))
        obs.append((reg.undeploy("m", 1), reg.aliases(), reg.versions("m")))
        with pytest.raises(KeyError):
            reg.get("prod")
        obs.append((reg.undeploy("m"), reg.models(), reg.health()))
        with pytest.raises(KeyError):
            reg.get("m")
    finally:
        reg.shutdown()
    with pytest.raises(RuntimeError, match="shut down"):
        reg.deploy("z", mlp(pkg))
        reg.engine("z")
    return obs


class TestRegistry:
    def test_scripted_lifecycle_equal(self):
        obs = both(registry_script)
        health = obs[3][4]["m"]
        assert health["serving"] == "m:1" and health["fallback_from"] == "m:2"
        assert health["versions"][2]["state"] == "CIRCUIT_OPEN"

    def test_warmup_fault_point_rolls_back_the_deploy(self):
        def run(pkg):
            reg = pkg.ModelRegistry(default_buckets=(1, 2, 4))
            with pkg.FaultPlan(seed=0).fail("registry.warmup", at=(1,)):
                with pytest.raises(pkg.FaultInjectedError):
                    reg.deploy("m", mlp(pkg),
                               warmup_example=np.zeros(6, np.float32))
            out = (reg.models(), reg.deploy("m", mlp(pkg)).ref)
            reg.shutdown()
            return out

        assert both(run) == ({}, "m:1")

    def test_concurrent_deploys_get_distinct_versions(self):
        def run(pkg):
            reg = pkg.ModelRegistry(default_buckets=(1, 2))
            deps = [None] * 6
            gate = threading.Barrier(6)

            def worker(i):
                gate.wait(timeout=30)
                deps[i] = reg.deploy("m", mlp(pkg, w_seed=i),
                                     warmup_example=np.zeros(6, np.float32))

            ts = [threading.Thread(target=worker, args=(i,))
                  for i in range(6)]
            for t in ts:
                t.start()
            for t in ts:
                t.join(timeout=60)
            return sorted(d.version for d in deps), reg.versions("m")

        assert both(run) == ([1, 2, 3, 4, 5, 6], [1, 2, 3, 4, 5, 6])

    def test_generation_engine_needs_a_generative_deployment(self):
        def run(pkg):
            reg = pkg.ModelRegistry()
            reg.deploy("m", mlp(pkg))
            with pytest.raises(TypeError, match="not generative"):
                reg.generation_engine("m")
            with pytest.raises(ValueError, match="single-host"):
                reg.front_door()
            return True

        assert both(run)

    def test_draft_deployment_streams_equal_jax(self, np_params,
                                                np_dparams):
        prompts = [np.random.default_rng(s).integers(
            1, 50, n).astype(np.int32) for n, s in ((5, 0), (11, 1), (3, 2))]
        j = (J.CausalLMAdapter(jax.tree_util.tree_map(jnp.asarray,
                                                      np_params), JCFG),
             J.CausalLMAdapter(jax.tree_util.tree_map(jnp.asarray,
                                                      np_dparams), JDCFG))
        t = (T.CausalLMAdapter(params_from_numpy(np_params, device="cpu"),
                               TCFG, device="cpu"),
             T.CausalLMAdapter(params_from_numpy(np_dparams, device="cpu"),
                               TDCFG, device="cpu"))
        streams = {}
        for side, (target, draft) in (("jax", j), ("torch", t)):
            reg = PKGS[side].ModelRegistry()
            dep = reg.deploy("lm", target, draft_model=draft, spec_k=3)
            assert dep.draft is draft and dep.ref == "lm:1"
            eng = reg.generation_engine("lm", slots=2, max_len=32)
            try:
                assert eng._spec is not None and eng._spec.k == 3
                hs = [eng.submit(p, max_new_tokens=10, eos_id=None, seed=s)
                      for s, p in enumerate(prompts)]
                streams[side] = [h.result(timeout=120) for h in hs]
            finally:
                reg.shutdown()
        assert streams["torch"] == streams["jax"]
        assert all(len(s) == 10 for s in streams["torch"])
        reg = T.ModelRegistry()
        with pytest.raises(TypeError, match="CausalLMAdapter"):
            reg.deploy("lm", t[0], draft_model=mlp(T))
        reg.deploy("lm", t[0], draft_model=t[1])
        eng = reg.generation_engine("lm", slots=2, max_len=32,
                                    speculative=None)
        try:
            assert eng._spec is None
        finally:
            reg.shutdown()

    def test_cluster_registry_joins_its_host(self, np_params):
        """``cluster=``: the engines attach to this process's LoopbackHost
        (host id 0 without a process group), which joins the directory."""
        d = T.ClusterDirectory(heartbeat_timeout_s=30.0)
        reg = T.ModelRegistry(cluster=d)
        reg.deploy("lm", adapters(np_params)["torch"])
        try:
            reg.engine("lm", max_wait_ms=0)
            g = reg.generation_engine("lm", slots=2, max_len=32)
            assert d.host_ids() == [0]
            h = d.handle(0)
            assert h.serves("infer") and h.serves("generate")
            assert h.generation is g
            fd = reg.front_door()
            T.HeartbeatPump(h, T.LoopbackTransport(d)).pump_once()
            x = np.array([3, 1, 4, 1, 5], np.int32)
            assert fd.submit_generate(x, max_new_tokens=4).result(
                timeout=120) == g.generate(x, max_new_tokens=4, timeout=120)
        finally:
            reg.shutdown()
