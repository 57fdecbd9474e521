"""The PyTorch port's serving resilience layer (deeplearning4j_tpu_torch/
serving: ``faults.py``, ``resilience.py``, ``ledger.py``,
``util/crash_reporting.py`` and their wiring in ``generation.py``)
against the JAX package's, on the CPU.

- ``FaultPlan``: the same seed, points and rules fire the same ``(point,
  index, kind)`` schedule as the JAX plan over 1000 calls; index rules,
  delay, poison and the single active plan behave as in
  ``tests/test_resilience.py::TestFaultPlan``.
- ``RetryPolicy.backoff_ms`` equals the JAX values for the same seed;
  retries, the classifier, ``RetryBudget`` and the ``CircuitBreaker``
  cycle with its listeners.
- Engine chaos, the scenarios of ``TestGenerationChaos``, each run once
  through the JAX engine and once through the port (``device="cpu"``,
  the JAX engine's weights via ``params_from_numpy``, the reference
  tests' tiny fp32 config): streams token-equal to the clean ones and to
  the JAX engine's, greedy and sampled; terminal exception types, reasons
  and counters equal. The watchdog restart also checks that a stale
  scheduler's late step leaves the replacement's stream untouched.
- The degrade points (``kv.swap_out``, ``kv.swap_in``,
  ``generation.draft_step``) and a retried ``generation.verify_step``.
- Crash dumps (to ``tmp_path``): injected faults never dump, a real
  failure dumps once; ``check_shutdown`` and ``LeakWatch`` of the port,
  called explicitly (``tests/conftest.py`` watches JAX engines only).

The tolerance is token-for-token equality and exact counters.
"""
import os
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
from deeplearning4j_tpu_torch.serving import faults as t_faults
from deeplearning4j_tpu_torch.util import crash_reporting as t_crash

WIDTHS = dict(vocab_size=64, hidden=32, layers=2, heads=2, mlp_dim=64,
              max_seq=32, causal=True, remat=False)
JCFG = JaxConfig(**WIDTHS, dtype=jnp.float32, attention_impl="full")
TCFG = TransformerConfig(**WIDTHS, dtype=torch.float32,
                         attention_impl="full")
SAMPLED = dict(temperature=1.0, top_k=8)
# the counters every chaos scenario compares between the packages
COUNTERS = ("retries_total", "failed_total", "faults_injected_total",
            "breaker_opened_total", "breaker_half_open_total",
            "breaker_closed_total", "rejected_total",
            "rejected_circuit_open", "watchdog_restarts",
            "poisoned_results_total", "prefills_total",
            "generated_tokens_total", "generations_completed")


def prompt(n, seed=0, vocab=64):
    return np.random.default_rng(seed).integers(1, vocab, n).astype(
        np.int32)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(autouse=True)
def _dumps_to_tmp(tmp_path):
    """Crash dumps of both packages land in the test's tmp_path, and a
    plan left installed by a failing test is removed."""
    jax_crash.crashDumpOutputDirectory(str(tmp_path))
    t_crash.crashDumpOutputDirectory(str(tmp_path))
    yield tmp_path
    jax_crash.crashDumpOutputDirectory(None)
    t_crash.crashDumpOutputDirectory(None)
    for mod in (jax_faults, t_faults):
        if mod.active_plan() is not None:
            mod.active_plan().uninstall()


@pytest.fixture(scope="module")
def np_params():
    p = jax_init_params(jax.random.PRNGKey(0), JCFG)
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), p)


@pytest.fixture(scope="module")
def sides(np_params):
    """Each package's serving module and engine factory over the same
    weights."""
    tparams = params_from_numpy(np_params, device="cpu")
    jparams = jax.tree_util.tree_map(jnp.asarray, np_params)
    return {
        "jax": (J, lambda **kw: J.GenerationEngine(
            jparams, JCFG, **{"slots": 2, "max_len": 32, **kw})),
        "torch": (T, lambda **kw: T.GenerationEngine(
            tparams, TCFG, **{"slots": 2, "max_len": 32, "device": "cpu",
                              **kw})),
    }


@pytest.fixture(scope="module")
def clean(sides):
    """Fault-free streams of both packages: greedy and sampled."""
    out = {}
    for side, (_pkg, make) in sides.items():
        with make() as eng:
            out[side] = {
                (seed, kind): eng.generate(
                    prompt(5, seed), max_new_tokens=6, timeout=120,
                    **(SAMPLED if kind == "sampled" else {}), seed=seed)
                for seed in (0, 1) for kind in ("greedy", "sampled")}
    assert out["torch"] == out["jax"]
    return out["torch"]


def counters(eng):
    m = eng.metrics
    return ({k: getattr(m, k).value for k in COUNTERS},
            m.rejections_by_reason.to_dict())


def both(sides, scenario):
    """Run ``scenario(pkg, make)`` on both packages; the port's result
    must equal the JAX engine's."""
    got = {side: scenario(pkg, make) for side, (pkg, make) in sides.items()}
    assert got["torch"] == got["jax"]
    return got["torch"]


# ---------------------------------------------------------------------------
# FaultPlan: the same schedule as the JAX plan, and the three fault kinds
# ---------------------------------------------------------------------------
def _plans(pkg):
    return [
        pkg.FaultPlan(seed=0).fail("generation.decode_step", rate=0.05,
                                   at=(1, 3, 7))
        .fail("generation.prefill", at=(0, 2)),
        pkg.FaultPlan(seed=7).fail("a", rate=0.3).delay("a", ms=0.001,
                                                        rate=0.2)
        .poison("b", lambda y: y, rate=0.5).fail("b", at=(10, 500)),
        pkg.FaultPlan(seed=123).fail("kv.swap_out", rate=0.9)
        .fail("kv.swap_in", rate=0.01),
    ]


@pytest.mark.parametrize("which", [0, 1, 2])
def test_fault_plan_fires_the_jax_schedule(which):
    points = ("generation.decode_step", "generation.prefill", "a", "b",
              "kv.swap_out", "kv.swap_in")

    def run(pkg, mod):
        plan = _plans(pkg)[which]
        with plan:
            for i in range(1000):
                for p in points:
                    try:
                        mod.inject(p, lambda: i)
                    except pkg.FaultInjectedError:
                        pass
        return plan.fired(), [plan.calls(p) for p in points]

    jfired, jcalls = run(J, jax_faults)
    tfired, tcalls = run(T, t_faults)
    assert tfired == jfired and tcalls == jcalls
    assert len(tfired) > 0


def test_inactive_is_passthrough():
    assert t_faults.active_plan() is None
    assert t_faults.inject("generation.decode_step", lambda v: v + 1,
                           41) == 42


def test_index_faults_fire_exactly_at_indices():
    plan = T.FaultPlan(seed=0).fail("p", at=(1, 3))
    with plan:
        for i in range(5):
            if i in (1, 3):
                with pytest.raises(T.FaultInjectedError) as ei:
                    t_faults.inject("p", lambda: i)
                assert ei.value.transient and ei.value.injected
                assert ei.value.index == i
            else:
                assert t_faults.inject("p", lambda: i) == i
    assert [e["index"] for e in plan.fired()] == [1, 3]
    assert plan.calls("p") == 5


def test_delay_and_poison():
    plan = (T.FaultPlan(seed=0)
            .delay("p", ms=30, at=(0,))
            .poison("p", lambda y: y * 0 - 1, at=(1,)))
    with plan:
        t0 = time.perf_counter()
        assert t_faults.inject("p", lambda: np.ones(2)).sum() == 2
        assert (time.perf_counter() - t0) * 1e3 >= 25
        assert t_faults.inject("p", lambda: np.ones(2)).sum() == -2
    assert [e["kind"] for e in plan.fired()] == ["delay", "poison"]


def test_single_active_plan_and_rule_validation():
    with T.FaultPlan():
        with pytest.raises(RuntimeError, match="already installed"):
            T.FaultPlan().install()
    assert t_faults.active_plan() is None
    with pytest.raises(ValueError, match="at= indices or rate="):
        T.FaultPlan().fail("p")
    with pytest.raises(ValueError, match="rate must be"):
        T.FaultPlan().fail("p", rate=1.5)


# ---------------------------------------------------------------------------
# RetryPolicy, RetryBudget, CircuitBreaker
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("seed", [0, 3, 11])
def test_backoff_equals_jax(seed):
    kw = dict(seed=seed, base_delay_ms=2.0, max_delay_ms=8.0, jitter=0.5)
    a = J.RetryPolicy(**kw)
    b = T.RetryPolicy(**kw)
    ja = [a.backoff_ms(k) for k in (1, 2, 3, 4, 5, 1)]
    tb = [b.backoff_ms(k) for k in (1, 2, 3, 4, 5, 1)]
    assert tb == ja
    assert all(d <= 8.0 * 1.5 for d in tb)


def test_retry_policy_classifies_and_bounds():
    calls = {"n": 0}

    def flaky():
        calls["n"] += 1
        if calls["n"] < 3:
            raise T.FaultInjectedError("p", calls["n"])
        return "ok"

    seen = []
    pol = T.RetryPolicy(max_attempts=3, base_delay_ms=0.1, seed=0)
    assert pol.call(flaky, on_retry=lambda a, e: seen.append(a)) == "ok"
    assert calls["n"] == 3 and seen == [1, 2]

    def broken():
        calls["n"] += 1
        raise ValueError("deterministic")

    calls["n"] = 0
    with pytest.raises(ValueError):
        T.RetryPolicy(max_attempts=5, base_delay_ms=0.1).call(broken)
    assert calls["n"] == 1
    with pytest.raises(T.FaultInjectedError):
        T.RetryPolicy(max_attempts=2, base_delay_ms=0.1).call(
            lambda: (_ for _ in ()).throw(T.FaultInjectedError("p", 0)))
    consumed = T.FaultInjectedError("p", 0)
    consumed.donated_state_consumed = True
    assert T.resilience.is_transient(T.FaultInjectedError("p", 0))
    assert not T.resilience.is_transient(consumed)
    assert not T.resilience.is_transient(RuntimeError("CUDA error"))


def test_retry_budget_math_equals_jax():
    def run(pkg):
        b = pkg.RetryBudget(ratio=0.5, burst=2.0)
        out = []
        for op in "ssrsrrsssrs":
            if op == "r":
                b.on_request()
            else:
                out.append(b.try_spend())
        return out, b.stats()

    assert run(T) == run(J)
    with pytest.raises(ValueError):
        T.RetryBudget(ratio=-1)
    with pytest.raises(ValueError):
        T.RetryBudget(burst=0.5)


def test_budget_dry_fails_typed():
    b = T.RetryBudget(ratio=0.0, burst=1.0)
    pol = T.RetryPolicy(max_attempts=5, base_delay_ms=0.1)
    with pytest.raises(T.RetryBudgetExhaustedError) as ei:
        pol.call(lambda: (_ for _ in ()).throw(
            T.FaultInjectedError("p", 0)), budget=b)
    assert ei.value.reason == "retry_budget_exhausted"
    assert isinstance(ei.value.__cause__, T.FaultInjectedError)
    assert b.spent_total == 1 and b.exhausted_total == 1


def test_breaker_full_cycle_with_listeners():
    seen = []
    br = T.CircuitBreaker(failure_threshold=2, cooldown_s=0.05)
    br.add_listener(lambda old, new: seen.append((old, new)))
    assert br.allow() and br.state == "CLOSED"
    br.record_failure()
    assert br.state == "CLOSED"
    br.record_failure()
    assert br.state == "OPEN" and not br.allow()
    time.sleep(0.06)
    assert br.allow() and br.state == "HALF_OPEN"
    assert not br.allow()                       # one probe at a time
    br.record_success()
    assert br.state == "CLOSED" and br.allow()
    assert seen == [("CLOSED", "OPEN"), ("OPEN", "HALF_OPEN"),
                    ("HALF_OPEN", "CLOSED")]
    fn = seen.append
    br.add_listener(fn)
    br.remove_listener(fn)
    br.add_listener(lambda old, new: 1 / 0)     # a broken listener
    br.record_failure()
    br.record_failure()
    assert br.state == "OPEN"


# ---------------------------------------------------------------------------
# Engine chaos: the reference's scenarios on both packages
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kind", ["greedy", "sampled"])
def test_transient_prefill_and_decode_faults_clean_streams(sides, clean,
                                                          kind):
    """Transient faults at both target points, absorbed by retries: the
    streams equal the clean ones and the JAX engine's."""
    kw = SAMPLED if kind == "sampled" else {}

    def scenario(pkg, make):
        plan = (pkg.FaultPlan(seed=5)
                .fail("generation.prefill", at=(0,))
                .fail("generation.decode_step", at=(1, 4)))
        with make() as eng:
            with plan:
                streams = [eng.generate(prompt(5, s), max_new_tokens=6,
                                        timeout=120, seed=s, **kw)
                           for s in (0, 1)]
            return streams, counters(eng), plan.fired()

    streams, (c, reasons), fired = both(sides, scenario)
    assert streams == [clean[(0, kind)], clean[(1, kind)]]
    assert c["retries_total"] == 3 == len(fired)
    assert c["failed_total"] == 0 and c["faults_injected_total"] == 3


def test_exhausted_retries_fail_typed_and_engine_recovers(sides, clean):
    def scenario(pkg, make):
        plan = pkg.FaultPlan(seed=0).fail("generation.decode_step",
                                          rate=1.0)
        with make(retry_policy=pkg.RetryPolicy(max_attempts=2,
                                               base_delay_ms=0.1),
                  breaker=pkg.CircuitBreaker(failure_threshold=50)) as eng:
            with plan:
                h = eng.submit(prompt(5, 0), max_new_tokens=6)
                with pytest.raises(pkg.FaultInjectedError):
                    h.result(timeout=60)
            after = eng.generate(prompt(5, 0), max_new_tokens=6,
                                 timeout=120)
            return after, counters(eng), len(h.tokens_so_far())

    after, (c, reasons), partial = both(sides, scenario)
    assert after == clean[(0, "greedy")]
    assert partial == 1 and c["retries_total"] == 1
    assert c["faults_injected_total"] == 2


def test_breaker_cycle_observable_in_metrics(sides, clean):
    def scenario(pkg, make):
        plan = pkg.FaultPlan(seed=0).fail("generation.prefill", at=(0, 1))
        with make(retry_policy=pkg.RetryPolicy(max_attempts=1),
                  breaker=pkg.CircuitBreaker(failure_threshold=2,
                                             cooldown_s=0.1)) as eng:
            with plan:
                for _ in range(2):
                    with pytest.raises(pkg.FaultInjectedError):
                        eng.generate(prompt(5, 0), max_new_tokens=2,
                                     timeout=60)
                assert eng.breaker.state == "OPEN"
                with pytest.raises(pkg.CircuitOpenError) as ei:
                    eng.submit(prompt(5, 0), max_new_tokens=2)
                assert ei.value.reason == "circuit_open"
                time.sleep(0.12)
                got = eng.generate(prompt(5, 0), max_new_tokens=6,
                                   timeout=120)   # the half-open probe
            return got, eng.breaker.state, counters(eng)

    got, state, (c, reasons) = both(sides, scenario)
    assert got == clean[(0, "greedy")] and state == "CLOSED"
    assert (c["breaker_opened_total"], c["breaker_half_open_total"],
            c["breaker_closed_total"]) == (1, 1, 1)
    assert reasons == {"circuit_open": 1}
    assert c["failed_total"] == 2


def test_watchdog_restart_stale_step_leaves_streams_untouched(sides, clean):
    """A decode step held 1500 ms past a 400 ms watchdog: the live stream
    fails typed ``watchdog``, exactly one restart, and a stream served by
    the replacement — in flight when the stale scheduler's late step runs
    against its abandoned pool — equals the same stream served quietly."""
    def scenario(pkg, make):
        plan = pkg.FaultPlan(seed=0).delay("generation.decode_step",
                                           ms=1500, at=(2,))
        with make() as eng:
            eng.generate(prompt(5, 0), max_new_tokens=2, timeout=120)
            eng.arm_watchdog(400)
            stale = eng._thread
            with plan:
                h = eng.submit(prompt(5, 0), max_new_tokens=8)
                with pytest.raises(pkg.WatchdogTimeoutError) as ei:
                    h.result(timeout=60)
                assert ei.value.reason == "watchdog"
                # a slow consumer keeps this stream live past the moment
                # the stale thread wakes and runs its late step
                h2 = eng.submit(prompt(5, 1), max_new_tokens=20,
                                on_token=lambda _t: time.sleep(0.05))
                late = h2.result(timeout=120)
            stale.join(timeout=10)
            assert not stale.is_alive()
            quiet = eng.generate(prompt(5, 1), max_new_tokens=20,
                                 timeout=120)
            after = eng.generate(prompt(5, 0), max_new_tokens=6,
                                 timeout=120)
            restarts = eng.watchdog_restarts
            c = counters(eng)
        return late, quiet, after, restarts, c[0]["watchdog_restarts"], \
            c[0]["failed_total"], c[1].get("watchdog")

    late, quiet, after, restarts, m_restarts, failed, wd = both(sides,
                                                               scenario)
    assert late == quiet and late[:6] == clean[(1, "greedy")]
    assert after == clean[(0, "greedy")]
    assert restarts == m_restarts == 1 and failed == 1 and wd == 1


def test_watchdog_times_each_prefill_of_a_turn_not_the_turn(sides, clean):
    """Four requests seated in one admission turn, each prefill held
    200 ms under a 400 ms watchdog: the turn takes 800 ms, but every
    prefill beats, so nothing restarts and every stream equals its quiet
    one."""
    _pkg, make = sides["torch"]
    with make(slots=4) as eng:
        eng.generate(prompt(5, 0), max_new_tokens=2, timeout=120)
        eng.arm_watchdog(400)
        plan = T.FaultPlan(seed=0).delay("generation.prefill", ms=200,
                                         at=(0, 1, 2, 3))
        with plan:
            hs = [eng.submit(prompt(5, s), max_new_tokens=6)
                  for s in range(4)]
            outs = [h.result(timeout=120) for h in hs]
        assert len(plan.fired("generation.prefill")) == 4
        assert eng.watchdog_restarts == 0
        quiet = [eng.generate(prompt(5, s), max_new_tokens=6, timeout=120)
                 for s in range(4)]
    assert outs == quiet
    assert outs[0] == clean[(0, "greedy")][:6]


class _HeldGauge:
    """A gauge whose first ``set`` from ``thread`` after ``armed`` sleeps
    ``ms`` first: the decode turn sets the slot occupancy right after
    staging its slots, before it launches."""

    def __init__(self, gauge, thread, armed, ms):
        self._gauge, self._thread, self._armed = gauge, thread, armed
        self._ms, self._fired = ms, threading.Event()

    def set(self, value):
        if threading.current_thread() is self._thread \
                and self._armed.is_set() and not self._fired.is_set():
            self._fired.set()
            time.sleep(self._ms / 1e3)
        self._gauge.set(value)

    def __getattr__(self, name):
        return getattr(self._gauge, name)


@pytest.mark.parametrize("hold", ["turn", "staging", "growth"])
def test_watchdog_restart_while_a_turn_is_held_before_its_launch(sides,
                                                                 clean, hold):
    """The scheduler is held 1500 ms past a 400 ms watchdog before its
    decode step launches: at the top of the turn, between staging its
    slots and the launch, or inside the on-demand block growth. The
    restart swaps in a new pool while the stale thread still holds the
    turn; a stream served by the replacement meanwhile equals the same
    stream served quietly, the stale thread's late launches (if any) go
    to the pool it bound and none to the new one, and the stale thread
    exits."""
    _pkg, make = sides["torch"]
    kw = {"allocate": "on_demand"} if hold == "growth" else {}
    with make(**kw) as eng:
        eng.generate(prompt(5, 0), max_new_tokens=2, timeout=120)
        eng.arm_watchdog(400)
        stale, old_cache = eng._thread, eng._cache
        armed, held = threading.Event(), threading.Event()
        if hold == "staging":
            eng.metrics.slot_occupancy = _HeldGauge(
                eng.metrics.slot_occupancy, stale, armed, 1500)
        else:
            name = "_decode_iteration" if hold == "turn" \
                else "_grow_block_tables"
            real_hold = getattr(eng, name)

            def holding(*a):
                if threading.current_thread() is stale and armed.is_set() \
                        and not held.is_set():
                    held.set()
                    time.sleep(1.5)
                return real_hold(*a)

            setattr(eng, name, holding)
        launches = []   # (thread, cache, time) of every decode step
        real_decode = eng._decode

        def spy(params, cache, *a):
            launches.append((threading.current_thread(), cache,
                             time.perf_counter()))
            return real_decode(params, cache, *a)

        eng._decode = spy
        armed.set()
        h = eng.submit(prompt(5, 0), max_new_tokens=8)
        with pytest.raises(T.WatchdogTimeoutError):
            h.result(timeout=60)
        h2 = eng.submit(prompt(5, 1), max_new_tokens=26,
                        on_token=lambda _t: time.sleep(0.06))
        late = h2.result(timeout=120)
        late_done = time.perf_counter()
        new_cache = eng._cache
        stale.join(timeout=10)
        assert not stale.is_alive()
        quiet = eng.generate(prompt(5, 1), max_new_tokens=26, timeout=120)
        assert eng.watchdog_restarts == 1
    assert new_cache is not old_cache
    assert late == quiet and late[:6] == clean[(1, "greedy")]
    mine = [(c, t) for th, c, t in launches if th is stale]
    assert all(c is not new_cache for c, _t in mine)
    assert all(c is new_cache for th, c, _t in launches if th is not stale)
    if hold != "growth":
        # the stale step launched into its own pool while h2 was live
        assert any(c is old_cache and t < late_done for c, t in mine)


def test_transient_tag_after_the_step_started_is_not_retried(sides, clean):
    class Tagged(RuntimeError):
        transient = True   # raised after the step started: not retried

    def scenario(pkg, make):
        with make(breaker=pkg.CircuitBreaker(failure_threshold=50)) as eng:
            eng.generate(prompt(5, 0), max_new_tokens=2, timeout=120)
            real = eng._decode

            def boom(*a, **kw):
                raise Tagged("device died mid-step")

            eng._decode = boom
            h = eng.submit(prompt(5, 0), max_new_tokens=6)
            with pytest.raises(Tagged):
                h.result(timeout=60)
            eng._decode = real
            after = eng.generate(prompt(5, 0), max_new_tokens=6,
                                 timeout=120)
            return after, counters(eng)

    after, (c, reasons) = both(sides, scenario)
    assert after == clean[(0, "greedy")]
    assert c["retries_total"] == 0


def test_shutdown_detaches_breaker_listeners(sides):
    _pkg, make = sides["torch"]
    br = T.CircuitBreaker(failure_threshold=50)
    engines = []
    for _ in range(3):
        eng = make(breaker=br)
        engines.append(eng)
        eng.shutdown()
    assert br._listeners == []
    with make(breaker=br) as live:
        br.record_failure()
        assert all(e.metrics.breaker_opened_total.value == 0
                   for e in engines)
        assert len(br._listeners) == 2
    assert br._listeners == []


def test_lost_engine_stops_and_rejects_the_queue(sides):
    """When no new pool can be built after a failed step (a CUDA error
    that poisoned the context), the engine stops: the live stream keeps
    the step's error, queued streams are rejected typed."""
    _pkg, make = sides["torch"]
    eng = make(slots=1)
    try:
        eng.generate(prompt(5, 0), max_new_tokens=2, timeout=120)
        gate = threading.Event()

        def boom(*a, **kw):
            gate.wait(30)
            raise RuntimeError("CUDA error: an illegal memory access")

        def no_pool(*_a, **_kw):
            raise RuntimeError("CUDA error: an illegal memory access")

        eng._decode = boom
        eng._reset_cache = no_pool
        live = eng.submit(prompt(5, 0), max_new_tokens=6)
        queued = eng.submit(prompt(5, 1), max_new_tokens=6)
        gate.set()
        with pytest.raises(RuntimeError, match="illegal memory"):
            live.result(timeout=60)
        with pytest.raises(T.RejectedError) as ei:
            queued.result(timeout=60)
        assert ei.value.reason == "shutdown"
        with pytest.raises(T.RejectedError):
            eng.submit(prompt(3))
    finally:
        eng.shutdown()


# ---------------------------------------------------------------------------
# degrade points and the speculative verify
# ---------------------------------------------------------------------------
TIGHT = dict(slots=2, max_len=32, block_size=8, num_blocks=5,
             allocate="on_demand", queue_capacity=8,
             swap_threshold_blocks=0, swap_capacity_blocks=64)


def _serve_parked(eng, specs):
    """Submit every spec while the scheduler is parked in the first
    stream's first token, so both packages seat them in one order."""
    gate = threading.Event()
    fired = []

    def hold(_tok):
        if not fired:
            fired.append(1)
            gate.wait(60)

    hs = []
    try:
        for k, (p, kw) in enumerate(specs):
            hs.append(eng.submit(p, on_token=hold if k == 0 else None, **kw))
    finally:
        gate.set()
    return [h.result(timeout=120) for h in hs]


@pytest.mark.parametrize("point", ["kv.swap_out", "kv.swap_in"])
def test_swap_faults_degrade_to_recompute(sides, point):
    specs = [(prompt(4, s), dict(max_new_tokens=20, eos_id=None, seed=s,
                                 **SAMPLED)) for s in (0, 1)]

    def scenario(pkg, make):
        with make(slots=2, max_len=32, block_size=8) as eng:
            solo = [eng.generate(p, timeout=120, **kw) for p, kw in specs]
        plan = pkg.FaultPlan(seed=0).fail(point, rate=1.0)
        with make(**TIGHT) as eng:
            with plan:
                got = _serve_parked(eng, specs)
            m = eng.metrics
            return (got == solo, m.preemptions_total.value,
                    m.kv_swap_bytes_in.value > 0, len(plan.fired()) > 0,
                    eng.ledger_stats()["swap_entries"])

    equal, preemptions, swapped_in, fired, held = both(sides, scenario)
    assert equal and preemptions >= 1 and fired and not swapped_in
    assert held == 0


def test_draft_and_verify_faults(np_params):
    """Draft-step faults degrade turns to plain decode; a transient
    verify fault is retried: the streams equal the plain engine's."""
    dnp = jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float32),
        jax_init_params(jax.random.PRNGKey(1), JaxConfig(
            **{**WIDTHS, "hidden": 16, "layers": 1, "mlp_dim": 32},
            dtype=jnp.float32, attention_impl="full")))
    tparams = params_from_numpy(np_params, device="cpu")
    dcfg = TransformerConfig(**{**WIDTHS, "hidden": 16, "layers": 1,
                                "mlp_dim": 32}, dtype=torch.float32,
                             attention_impl="full")
    spec = T.SpecConfig(params_from_numpy(dnp, device="cpu"), dcfg, k=3)
    ps = [prompt(5, s) for s in (0, 1)]
    with T.GenerationEngine(tparams, TCFG, slots=2, max_len=32,
                            device="cpu") as eng:
        plain = [eng.generate(p, max_new_tokens=8, timeout=120) for p in ps]
    # stream 0: its first verify is retried, its second turn's draft
    # fails (cold from there); stream 1's draft prefill fails (cold)
    plan = (T.FaultPlan(seed=0)
            .fail("generation.draft_step", at=(3,))
            .fail("generation.draft_prefill", at=(1,))
            .fail("generation.verify_step", at=(0,)))
    with T.GenerationEngine(tparams, TCFG, slots=2, max_len=32,
                            speculative=spec, device="cpu") as eng:
        with plan:
            got = [eng.generate(p, max_new_tokens=8, timeout=120)
                   for p in ps]
        m = eng.metrics
        assert got == plain
        drafts = [e for e in plan.fired()
                  if e["point"].startswith("generation.draft")]
        assert m.spec_fallbacks_total.value >= len(drafts) >= 2
        assert m.retries_total.value == 1 and m.failed_total.value == 0
    assert {e["point"] for e in plan.fired()} == {
        "generation.draft_step", "generation.draft_prefill",
        "generation.verify_step"}


# ---------------------------------------------------------------------------
# crash dumps, the shutdown law, LeakWatch
# ---------------------------------------------------------------------------
def _dumps(d):
    return [f for f in os.listdir(d) if f.startswith("dl4jtpu-crash")]


def test_injected_faults_never_dump(sides, _dumps_to_tmp):
    _pkg, make = sides["torch"]
    plan = T.FaultPlan(seed=0).fail("generation.decode_step", rate=1.0)
    with make(retry_policy=T.RetryPolicy(max_attempts=2,
                                         base_delay_ms=0.1)) as eng:
        with plan:
            with pytest.raises(T.FaultInjectedError):
                eng.generate(prompt(5, 0), max_new_tokens=4, timeout=60)
    assert _dumps(_dumps_to_tmp) == []


def test_real_failure_dumps_once_with_context(sides, _dumps_to_tmp):
    _pkg, make = sides["torch"]
    recorder = T.FlightRecorder(capacity=16)
    with make(recorder=recorder,
              breaker=T.CircuitBreaker(failure_threshold=50)) as eng:
        real = eng._decode

        def boom(*a, **kw):
            raise RuntimeError("device step failed")

        eng._decode = boom
        for s in (0, 1):
            with pytest.raises(RuntimeError, match="device step failed"):
                eng.generate(prompt(5, s), max_new_tokens=4, timeout=60)
        eng._decode = real
        assert len(eng.generate(prompt(5, 0), max_new_tokens=4,
                                timeout=60)) == 4
    files = _dumps(_dumps_to_tmp)
    assert len(files) == 1
    text = open(os.path.join(_dumps_to_tmp, files[0])).read()
    assert "deeplearning4j_tpu_torch crash dump" in text
    assert "RuntimeError: device step failed" in text
    assert "component: serving.GenerationEngine" in text
    assert "point: generation.decode_step" in text
    assert "device: cpu" in text and "numParams:" in text
    kinds = [e["kind"] for e in recorder.snapshot()]
    assert kinds.count("device.failure") == 2 and "crash_dump" in kinds


def test_check_shutdown_and_leak_watch(sides):
    _pkg, make = sides["torch"]
    watch = T.LeakWatch()
    eng = make(prefix_cache_blocks=4, block_size=8)
    eng.register_prefix(prompt(9, 3), prefix_id="p")
    for s in range(3):
        eng.generate(prompt(9, s), max_new_tokens=4, timeout=60)
    eng.submit(prompt(4, 9), prefix_id="p", max_new_tokens=3).result(
        timeout=60)
    eng.shutdown()
    assert T.check_shutdown(eng) == []
    assert watch.finish(settle_s=1.0) == []
    stats = eng.ledger_stats()
    assert stats["kv_pinned_blocks"] > 0 and stats["live_slots"] == 0
    # an orphaned block breaks the law, and the watch names it
    eng._allocator.alloc(1)
    bad = T.check_shutdown(eng)
    assert len(bad) == 1 and "orphaned KV block" in bad[0]
    assert watch.finish(settle_s=0.1) == bad
    assert T.LeakWatch().finish(settle_s=0.1) == []   # already shut down


def test_resource_ledger_returns_to_baseline(sides):
    _pkg, make = sides["torch"]
    with make() as eng:
        eng.generate(prompt(5, 0), max_new_tokens=2, timeout=60)
        tracer = T.Tracer(capacity=8)
        ledger = T.ResourceLedger(engines=[eng], tracers=[tracer])
        ledger.baseline()
        plan = T.FaultPlan(seed=0).fail("generation.decode_step", at=(1,))
        with plan:
            eng.generate(prompt(5, 1), max_new_tokens=6, timeout=60)
        assert ledger.check(timeout_s=5.0) == []
        held = eng._allocator.alloc(1)
        bad = ledger.check()
        assert any("kv_free_blocks" in b for b in bad)
        eng._allocator.free(held)
        assert ledger.assert_clean(timeout_s=5.0).get(
            f"engine[{eng.name}].live_slots") == 0
