"""The PyTorch port's request tracing (deeplearning4j_tpu_torch/serving/
``tracing.py``, the poisoned-result screen of ``generation.py`` and the
``OpProfiler`` of ``profiler.py``) against the JAX package's, on the CPU.

- ``FlightRecorder``: its bounded ring and sequence numbers;
  ``Tracer``: seeded tail sampling, error retention, the retention ring
  and the disabled fast path give the JAX tracer's decisions.
- A request's ``event_names()`` equal the JAX engine's in deterministic
  scenarios: clean, retried, preempted and watchdog-restarted streams
  (``device="cpu"``, the JAX engine's weights, the reference tests' tiny
  fp32 config).
- The poison screen at prefill and decode (``tests/test_tracing.py``'s
  generation cases): the iteration fails typed ``poisoned`` and the
  engine serves on; ``screen_outputs=False`` turns it off.
- ``Tracer.chrome_events`` has the JAX export's event structure, and
  ``OpProfiler.export_chrome_trace(tracer=...)`` merges the engine's
  ``serving.*`` spans with the request lanes.

The tolerance is exact equality.
"""
import json
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
from deeplearning4j_tpu.serving import faults as jax_faults
from deeplearning4j_tpu.util import crash_reporting as jax_crash
import deeplearning4j_tpu_torch.serving as T
from deeplearning4j_tpu_torch.models import (
    TransformerConfig, params_from_numpy)
from deeplearning4j_tpu_torch.profiler import OpProfiler
from deeplearning4j_tpu_torch.serving import faults as t_faults
from deeplearning4j_tpu_torch.util import crash_reporting as t_crash

WIDTHS = dict(vocab_size=50, hidden=32, layers=2, heads=2, mlp_dim=64,
              max_seq=64, causal=True, remat=False)
JCFG = JaxConfig(**WIDTHS, dtype=jnp.float32, attention_impl="full")
TCFG = TransformerConfig(**WIDTHS, dtype=torch.float32,
                         attention_impl="full")
TIGHT = dict(slots=2, max_len=32, block_size=8, num_blocks=5,
             allocate="on_demand", queue_capacity=8)


def prompt(n, seed=0):
    return np.random.default_rng(seed).integers(
        1, WIDTHS["vocab_size"], n).astype(np.int32)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(autouse=True)
def _isolated(tmp_path):
    jax_crash.crashDumpOutputDirectory(str(tmp_path))
    t_crash.crashDumpOutputDirectory(str(tmp_path))
    yield
    jax_crash.crashDumpOutputDirectory(None)
    t_crash.crashDumpOutputDirectory(None)
    for mod in (jax_faults, t_faults):
        if mod.active_plan() is not None:
            mod.active_plan().uninstall()


@pytest.fixture(scope="module")
def sides():
    p = jax_init_params(jax.random.PRNGKey(0), JCFG)
    np_params = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32),
                                       p)
    tparams = params_from_numpy(np_params, device="cpu")
    return {
        "jax": (J, lambda **kw: J.GenerationEngine(
            p, JCFG, **{"slots": 2, "max_len": 32, **kw})),
        "torch": (T, lambda **kw: T.GenerationEngine(
            tparams, TCFG, **{"slots": 2, "max_len": 32, "device": "cpu",
                              **kw})),
    }


def both(sides, scenario):
    got = {side: scenario(pkg, make) for side, (pkg, make) in sides.items()}
    assert got["torch"] == got["jax"]
    return got["torch"]


# ---------------------------------------------------------------------------
# FlightRecorder and Tracer units
# ---------------------------------------------------------------------------
def test_flight_recorder_ring():
    def run(pkg):
        fr = pkg.FlightRecorder(capacity=4)
        for i in range(7):
            fr.record("retry", attempt=i)
        snap = fr.snapshot()
        return ([(e["kind"], e["attempt"], e["seq"]) for e in snap],
                fr.total_recorded, len(fr))

    assert run(T) == run(J) == ([("retry", i, i + 1) for i in range(3, 7)],
                                7, 4)
    with pytest.raises(ValueError):
        T.FlightRecorder(capacity=0)
    fr = T.FlightRecorder(capacity=2).set_host(3)
    fr.record("x")
    assert fr.snapshot()[0]["host"] == 3
    assert T.flight_recorder() is T.flight_recorder()


@pytest.mark.parametrize("kw", [
    dict(sample_rate=0.5, seed=3, capacity=6),
    dict(sample_rate=0.0, keep_errors=True, capacity=4),
    dict(sample_rate=1.0, keep_errors=False, capacity=3),
])
def test_tail_sampling_and_retention_equal_jax(kw):
    reasons = ("ok", "ok", "deadline", "ok", "model_error", "ok", "ok",
               "watchdog", "ok", "ok", "ok", "circuit_open")

    def run(pkg):
        tr = pkg.Tracer(**kw)
        for i, r in enumerate(reasons):
            t = tr.begin("e", "generate", idx=i)
            if t is pkg.tracing.NULL_TRACE:
                continue
            t.event("decode.step", step=i)
            t.finish(r)
            t.event("late")          # after the terminal: dropped
            t.finish("ok")           # the first terminal wins
        kept = [(t.reason, t.events[0][2]["idx"], t.event_names())
                for t in tr.traces()]
        st = tr.stats()
        return kept, {k: st[k] for k in ("started", "retained",
                                         "retained_total", "sampled_out",
                                         "evicted")}

    assert run(T) == run(J)


def test_disabled_tracer_hands_out_the_null_trace():
    tr = T.Tracer(enabled=False)
    assert tr.begin("e", "generate") is T.tracing.NULL_TRACE
    assert T.default_tracer().begin("e", "g") is T.tracing.NULL_TRACE
    assert T.Tracer(sample_rate=0.0, keep_errors=False).begin(
        "e", "g") is T.tracing.NULL_TRACE
    t = T.Tracer()
    assert t in T.all_tracers()
    assert T.terminal_reason(T.WatchdogTimeoutError("x")) == "watchdog"
    assert T.terminal_reason(RuntimeError("x")) == "model_error"


# ---------------------------------------------------------------------------
# event names against the JAX engine's
# ---------------------------------------------------------------------------
def names(tracer):
    return [(tr.reason, tr.event_names()) for tr in tracer.traces()]


def test_clean_and_retried_event_names_equal_jax(sides):
    def scenario(pkg, make):
        tracer = pkg.Tracer(sample_rate=1.0)
        # a plan counts calls from its installation
        plan = (pkg.FaultPlan(seed=0).fail("generation.prefill", at=(0,))
                .fail("generation.decode_step", at=(1,)))
        with make(tracer=tracer) as eng:
            eng.generate(prompt(5, 0), max_new_tokens=3, timeout=120)
            with plan:
                eng.generate(prompt(5, 1), max_new_tokens=4, timeout=120)
        return names(tracer)

    got = both(sides, scenario)
    assert got[0] == ("ok", ["submit", "queue.admit", "queue.wait",
                             "slot.assign", "prefill", "decode.step",
                             "decode.step", "stream.finish", "retire"])
    assert got[1][1].count("retry.attempt") == 2


def test_preempted_event_names_equal_jax(sides):
    def scenario(pkg, make):
        tracer = pkg.Tracer(sample_rate=1.0)
        gate, entered = threading.Event(), threading.Event()

        def hold(_tok):
            if not entered.is_set():
                entered.set()
                gate.wait(60)

        with make(tracer=tracer, **TIGHT) as eng:
            kw = dict(max_new_tokens=20, eos_id=None)
            hs = [eng.submit(prompt(4, 0), on_token=hold, **kw)]
            assert entered.wait(120)
            hs.append(eng.submit(prompt(4, 1), **kw))
            gate.set()
            [h.result(timeout=120) for h in hs]
        return names(tracer)

    got = both(sides, scenario)
    assert any("preempt" in n for _r, n in got)


def test_watchdog_restart_event_names_equal_jax(sides):
    def scenario(pkg, make):
        tracer = pkg.Tracer(sample_rate=1.0)
        plan = pkg.FaultPlan(seed=0).delay("generation.decode_step",
                                           ms=900, at=(2,))
        with make(tracer=tracer) as eng:
            eng.generate(prompt(5, 0), max_new_tokens=2, timeout=120)
            eng.arm_watchdog(250)
            with plan:
                h = eng.submit(prompt(5, 0), max_new_tokens=8)
                with pytest.raises(pkg.WatchdogTimeoutError):
                    h.result(timeout=60)
            time.sleep(1.0)   # the stale step's late events are dropped
        return names(tracer)

    got = both(sides, scenario)
    assert got[1] == ("watchdog", ["submit", "queue.admit", "queue.wait",
                                   "slot.assign", "prefill", "decode.step",
                                   "decode.step", "watchdog.restart",
                                   "retire"])


# ---------------------------------------------------------------------------
# the poisoned-result screen
# ---------------------------------------------------------------------------
def test_poisoned_decode_fails_typed_and_recovers(sides):
    def scenario(pkg, make):
        plan = pkg.FaultPlan(seed=0).poison(
            "generation.decode_step",
            lambda out: (out[0], np.asarray(out[1]) * 0 - 1), at=(0,))
        fr = pkg.FlightRecorder(capacity=32)
        tracer = pkg.Tracer(sample_rate=0.0, keep_errors=True)
        with make(recorder=fr, tracer=tracer, name="poison-gen") as eng:
            clean = eng.generate(prompt(5, 0), max_new_tokens=4,
                                 timeout=120)
            with plan:
                h = eng.submit(prompt(5, 0), max_new_tokens=4)
                with pytest.raises(pkg.PoisonedResultError) as ei:
                    h.result(timeout=60)
            again = eng.generate(prompt(5, 0), max_new_tokens=4,
                                 timeout=120)
            m = eng.metrics
            return (again == clean, ei.value.reason,
                    m.poisoned_results_total.value,
                    m.rejections_by_reason.to_dict(),
                    [e["kind"] for e in fr.snapshot()
                     if e["kind"] != "engine.shutdown"],
                    names(tracer))

    same, reason, n, reasons, kinds, kept = both(sides, scenario)
    assert same and reason == "poisoned" and n == 1
    assert reasons == {"poisoned": 1}
    assert kinds.count("poisoned_result") == 1
    assert [r for r, _n in kept] == ["poisoned"]


def test_poisoned_prefill_token_screened(sides):
    def scenario(pkg, make):
        plan = pkg.FaultPlan(seed=0).poison(
            "generation.prefill",
            lambda out: (out[0], np.int32(WIDTHS["vocab_size"] + 7)),
            at=(0,))
        with make(name="poison-pf") as eng:
            with plan:
                h = eng.submit(prompt(5, 0), max_new_tokens=4)
                with pytest.raises(pkg.PoisonedResultError):
                    h.result(timeout=60)
            n = len(eng.generate(prompt(5, 0), max_new_tokens=2,
                                 timeout=120))
            return n, eng.metrics.failed_total.value, \
                eng.metrics.poisoned_results_total.value

    assert both(sides, scenario) == (2, 1, 1)


def test_screen_opt_out_delivers_the_raw_ids(sides):
    _pkg, make = sides["torch"]
    plan = T.FaultPlan(seed=0).poison(
        "generation.decode_step",
        lambda out: (out[0], np.full(2, WIDTHS["vocab_size"] + 3)), at=(0,))
    with make(screen_outputs=False) as eng:
        with plan:
            toks = eng.generate(prompt(5, 0), max_new_tokens=2, timeout=120)
        assert toks[1] == WIDTHS["vocab_size"] + 3
        assert eng.metrics.poisoned_results_total.value == 0


# ---------------------------------------------------------------------------
# Chrome export
# ---------------------------------------------------------------------------
def _structure(events):
    """The export's shape without ids and times: (ph, name, args keys)."""
    out = []
    for e in events:
        if e["ph"] == "M":
            out.append(("M", e["name"]))
        else:
            out.append((e["ph"], e["name"], sorted(e.get("args", {}))))
    return out


def test_chrome_events_structure_equals_jax(sides):
    def scenario(pkg, make):
        tracer = pkg.Tracer(sample_rate=1.0)
        with make(tracer=tracer) as eng:
            eng.generate(prompt(5, 0), max_new_tokens=3, timeout=120,
                         tenant="acme")
            eng.generate(prompt(4, 2), max_new_tokens=2, timeout=120)
        events = tracer.chrome_events()
        tracks = sorted(e["args"]["name"].split("/")[0] for e in events
                        if e["name"] == "thread_name")
        return _structure(events), tracks

    structure, tracks = both(sides, scenario)
    assert ("X", "generate[ok]", ["reason", "tenant", "trace_id"]) \
        in structure
    assert tracks[0] == "acme" and tracks[1] == T.DEFAULT_TENANT


def test_op_profiler_export_merges_spans_and_lanes(sides, tmp_path):
    _pkg, make = sides["torch"]
    prof = OpProfiler()
    tracer = T.Tracer(sample_rate=1.0)
    with make(profiler=prof, tracer=tracer) as eng:
        eng.generate(prompt(5, 0), max_new_tokens=3, timeout=120,
                     tenant="acme")
    summary = prof.summary()
    assert summary["serving.prefill"]["count"] == 1
    assert summary["serving.decode_step"]["count"] == 2
    path = prof.export_chrome_trace(str(tmp_path / "merged.json"),
                                    tracer=tracer)
    events = json.load(open(path))["traceEvents"]
    spans = {e["name"] for e in events if e.get("pid") == 1
             and e["ph"] == "X"}
    assert {"serving.prefill", "serving.decode_step"} <= spans
    lanes = {e["args"]["name"] for e in events
             if e["ph"] == "M" and e["name"] == "thread_name"}
    assert any(n.startswith("acme/") for n in lanes)
    plain = json.load(open(prof.export_chrome_trace(
        str(tmp_path / "plain.json"))))["traceEvents"]
    assert all(e["ph"] == "X" for e in plain)
    assert OpProfiler.getInstance() is OpProfiler.getInstance()
