"""The PyTorch port's multi-tenant QoS (deeplearning4j_tpu_torch/serving:
``qos.py``, the ``policy=`` path of ``admission.py``, the QoS and SLO
roll-ups of ``metrics.py`` and their wiring in ``generation.py``) against
the JAX package's, on the CPU.

- ``TokenBucket``, ``QosPolicy`` and ``resolve_qos`` (the escalation
  refusal included) give the JAX package's answers over the same inputs.
- ``TenantQueues``: seeded sequences of append, appendleft, pop, expiry
  sweeps and backlog/quota gates pop in the JAX queue's order.
- ``SloBurnGovernor``: the same outcome sequence under one fake clock
  gives the JAX governor's gate decisions, hysteresis included.
- The engine (``device="cpu"``, the JAX engine's weights, the reference
  tests' tiny fp32 config): a weighted share 3:1, an interactive request
  overtaking a batch flood, a quota shed typed ``quota_exceeded``, and a
  ``preemptible=False`` tenant never chosen as a victim — the completion
  orders, preemption counts, streams and QoS roll-ups equal the JAX
  engine's; a policy leaves greedy streams unchanged.

The tolerance is exact equality.
"""
import threading

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import deeplearning4j_tpu.serving as J
from deeplearning4j_tpu.models import TransformerConfig as JaxConfig
from deeplearning4j_tpu.models import init_params as jax_init_params
from deeplearning4j_tpu.serving import admission as jax_admission
from deeplearning4j_tpu.serving import qos as jax_qos
import deeplearning4j_tpu_torch.serving as T
from deeplearning4j_tpu_torch.models import (
    TransformerConfig, params_from_numpy)
from deeplearning4j_tpu_torch.serving import admission as t_admission
from deeplearning4j_tpu_torch.serving import qos as t_qos

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


@pytest.fixture(scope="module")
def sides():
    p = jax_init_params(jax.random.PRNGKey(0), JCFG)
    np_params = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32),
                                       p)
    tparams = params_from_numpy(np_params, device="cpu")
    return {
        "jax": (J, lambda **kw: J.GenerationEngine(p, JCFG, **kw)),
        "torch": (T, lambda **kw: T.GenerationEngine(
            tparams, TCFG, device="cpu", **kw)),
    }


def both(sides, scenario):
    got = {side: scenario(pkg, make) for side, (pkg, make) in sides.items()}
    assert got["torch"] == got["jax"]
    return got["torch"]


def outcome(fn):
    """A call's value, or its exception's type name and message."""
    try:
        return ("ok", fn())
    except Exception as e:
        return (type(e).__name__, str(e))


# ---------------------------------------------------------------------------
# TokenBucket, QosPolicy, resolve_qos
# ---------------------------------------------------------------------------
def test_token_bucket_equals_jax():
    def run(pkg):
        clock = [0.0]
        b = pkg.TokenBucket(rate=2.0, burst=3.0, clock=lambda: clock[0])
        out = []
        for dt, n in ((0.0, 1), (0.0, 2), (0.0, 1), (0.25, 1), (0.25, 1),
                      (10.0, 3), (0.0, 0.5), (0.1, 4), (1.0, 1)):
            clock[0] += dt
            out.append((b.try_take(n), round(b.tokens, 9)))
        return out

    assert run(T) == run(J)
    for bad in (dict(rate=-1, burst=1), dict(rate=1, burst=0)):
        with pytest.raises(ValueError):
            T.TokenBucket(**bad)


POLICIES = {
    "none": None,
    "mixed": dict(tenants={"a": {"priority": "batch", "weight": 2.0},
                           "b": {"priority": "interactive"}}),
    "batch_default": dict(tenants={"c": {"priority": "interactive"}},
                          default_priority="batch"),
}


@pytest.mark.parametrize("which", sorted(POLICIES))
def test_resolve_qos_equals_jax(which):
    def run(pkg):
        kw = POLICIES[which]
        pol = pkg.QosPolicy(**kw) if kw is not None else None
        return [outcome(lambda t=t, p=p: pkg.qos.resolve_qos(pol, t, p))
                for t in (None, "a", "b", "c", "zz")
                for p in (None, "interactive", "batch", "urgent")]

    got = run(T)
    assert got == run(J)
    if which == "mixed":   # the configured batch tenant cannot escalate
        assert got[5] == ("ValueError",
                          "tenant 'a' is configured 'batch' and may not "
                          "escalate to 'interactive' (downgrades are "
                          "allowed)")


@pytest.mark.parametrize("kw", [
    dict(default_weight=0), dict(default_priority="x"),
    dict(slo_shed_error_rate=0.0), dict(slo_shed_p99_ms=-1),
    dict(slo_clear_error_rate=0.1),
    dict(slo_shed_error_rate=0.1, slo_clear_error_rate=0.2),
    dict(slo_clear_p99_ms=5.0),
    dict(slo_min_samples=0), dict(slo_check_interval_s=-1),
    dict(slo_shed_classes=("x",)), dict(tenants={"t": 3}),
    dict(tenants={"t": {"weight": 0}}),
    dict(tenants={"t": {"max_queued": 0}}),
])
def test_policy_validation_equals_jax(kw):
    j, t = outcome(lambda: J.QosPolicy(**kw)), outcome(lambda: T.QosPolicy(
        **kw))
    assert t[0] == j[0] != "ok"


def test_policy_to_dict_and_tenant_lookup():
    kw = dict(tenants={"a": dict(weight=2.0, priority="batch", quota=3.0,
                                 preemptible=False)},
              slo_shed_error_rate=0.5, slo_clear_error_rate=0.25)
    assert T.QosPolicy(**kw).to_dict() == J.QosPolicy(**kw).to_dict()
    pol = T.QosPolicy(**kw)
    assert pol.tenant("zz").weight == 1.0 and pol.quota_bucket("zz") is None
    assert pol.quota_bucket("a") is pol.quota_bucket("a")
    assert pol.quota_bucket("a", unit="requests") is not \
        pol.quota_bucket("a")


# ---------------------------------------------------------------------------
# TenantQueues against the JAX queue, seeded operation sequences
# ---------------------------------------------------------------------------
QUEUE_POLICY = dict(tenants={
    "h": {"weight": 3.0, "priority": "batch"},
    "l": {"weight": 1.0, "priority": "batch"},
    "i": {"weight": 1.0, "priority": "interactive", "max_queued": 3},
    "q": {"weight": 2.0, "quota": 1.0, "quota_burst": 2.0}})


def run_queue_ops(pkg, admission, qos_mod, seed):
    clock = [0.0]
    pol = pkg.QosPolicy(clock=lambda: clock[0], **QUEUE_POLICY)
    q = qos_mod.TenantQueues(pol, unit="requests")
    rng = np.random.default_rng(seed)
    log, popped, n = [], [], 0
    for _ in range(400):
        op = rng.integers(0, 10)
        clock[0] += float(rng.random()) * 0.3
        if op < 5:
            tenant = ("h", "l", "i", "q", "anon")[rng.integers(0, 5)]
            prio = pkg.qos.resolve_qos(pol, tenant, None)[1]
            req = admission.Request(x=n, rows=1, tenant=tenant,
                                    priority=prio)
            if rng.random() < 0.2:
                req.deadline_t = 100.0 + float(rng.random()) * 50
            n += 1
            try:
                q.check_depth(req)
                q.charge_quota(req)
            except pkg.QuotaExceededError as e:
                log.append(("shed", req.x, e.reason))
                continue
            q.append(req)
            log.append(("in", req.x))
        elif op < 8 and len(q):
            head = q[0]
            got = q.popleft()
            assert got is head
            popped.append(got)
            log.append(("out", got.x, got.tenant))
        elif op == 8 and popped:
            back = popped.pop()
            q.appendleft(back)
            log.append(("back", back.x))
        else:
            shed = q.remove_expired(100.0 + float(rng.random()) * 60)
            log.append(("expire", sorted(r.x for r in shed)))
        log.append(("depth", len(q), sorted(q.depth_by_tenant().items())))
    log.append(("drain", [r.x for r in q]))
    return log


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_tenant_queues_pop_order_equals_jax(seed):
    got = run_queue_ops(T, t_admission, t_qos, seed)
    assert got == run_queue_ops(J, jax_admission, jax_qos, seed)
    assert any(e[0] == "shed" for e in got)
    assert any(e[0] == "expire" and e[1] for e in got)


def test_weighted_interleave_and_strict_priority():
    pol = T.QosPolicy({"h": T.TenantPolicy(weight=3.0),
                       "l": T.TenantPolicy(weight=1.0),
                       "b": T.TenantPolicy(priority="batch", weight=100.0)})
    q = T.TenantQueues(pol)
    for t in ["b", "b"] + ["h"] * 12 + ["l"] * 4:
        q.append(T.Request(x=None, rows=1, tenant=t,
                           priority=pol.tenant(t).priority))
    order = [q.popleft().tenant for _ in range(18)]
    assert order[-2:] == ["b", "b"]          # batch only after interactive
    for i in range(0, 16, 4):
        assert order[i:i + 4].count("h") == 3, order


def test_admission_controller_policy_path():
    pol = T.QosPolicy({"q": T.TenantPolicy(quota=1.0, quota_burst=1.0),
                       "m": T.TenantPolicy(max_queued=1)})
    ac = T.AdmissionController(capacity_rows=4, unit="requests",
                               policy=pol)
    assert isinstance(ac._q, T.TenantQueues)
    ac.admit(T.Request(x=0, rows=1, tenant="q"))
    with pytest.raises(T.QuotaExceededError):
        ac.admit(T.Request(x=1, rows=1, tenant="q"))
    ac.admit(T.Request(x=2, rows=1, tenant="m"))
    with pytest.raises(T.QuotaExceededError, match="max_queued"):
        ac.admit(T.Request(x=3, rows=1, tenant="m"))
    assert ac.depth_by_tenant() == {"q": 1, "m": 1}
    assert T.AdmissionController(capacity_rows=4).depth_by_tenant() == {}
    cancelled = []
    ac.on_cancelled = cancelled.append
    r = T.Request(x=4, rows=1, tenant="z")
    ac.admit(r)
    r.future.cancel()
    ac.close()
    assert cancelled == [r]


# ---------------------------------------------------------------------------
# SloBurnGovernor against the JAX governor under one fake clock
# ---------------------------------------------------------------------------
GOVERNORS = {
    "error_rate": dict(slo_shed_error_rate=0.3, slo_window="10s",
                       slo_min_samples=5, slo_check_interval_s=0.0),
    "hysteresis": dict(slo_shed_error_rate=0.4, slo_clear_error_rate=0.1,
                       slo_shed_p99_ms=80.0, slo_clear_p99_ms=40.0,
                       slo_window="10s", slo_min_samples=4,
                       slo_check_interval_s=0.0),
}


@pytest.mark.parametrize("which", sorted(GOVERNORS))
def test_slo_burn_governor_equals_jax(which):
    reasons = ("ok", "ok", "model_error", "watchdog", "slo_shed",
               "quota_exceeded", "deadline", "ok")

    def run(pkg):
        clock = [0.0]
        m = pkg.ServingMetrics()
        for w in m.slo_windows.values():
            w._clock = lambda: clock[0]
        gov = pkg.SloBurnGovernor(pkg.QosPolicy(**GOVERNORS[which]), m)
        rng = np.random.default_rng(7)
        out = []
        for _ in range(300):
            clock[0] += float(rng.random()) * 0.2
            r = reasons[rng.integers(0, len(reasons))]
            m.record_outcome(r, float(rng.random()) * 120 if r == "ok"
                             else None)
            e = gov.gate(("interactive", "batch")[rng.integers(0, 2)])
            out.append(None if e is None else (e.reason, e.detail))
            out.append(m.slo_burn_active.value)
        return out, m.slo_snapshot()

    got = run(T)
    assert got == run(J)
    assert any(x is not None and not isinstance(x, float) for x in got[0])


def test_unknown_slo_window_fails_at_construction(sides):
    _pkg, make = sides["torch"]
    with pytest.raises(ValueError, match="slo_window"):
        make(slots=1, max_len=32,
             qos=T.QosPolicy(slo_shed_error_rate=0.5, slo_window="30s"))


# ---------------------------------------------------------------------------
# The engine under a policy
# ---------------------------------------------------------------------------
def parked(eng, first, rest):
    """Submit ``first``, wait until the scheduler is held in its first
    token, then submit every ``rest`` spec and release it: the queued
    requests are selected by the policy alone. Returns the handles."""
    gate, entered = threading.Event(), threading.Event()

    def hold(_tok):
        if not entered.is_set():
            entered.set()
            gate.wait(60)

    p, kw = first
    hs = [eng.submit(p, on_token=hold, **kw)]
    try:
        assert entered.wait(120), "the first stream never started"
        hs += [eng.submit(p, **kw) for p, kw in rest]
    finally:
        gate.set()
    return hs


def test_weighted_share_3_to_1(sides):
    """Two batch tenants at weights 3:1 drain a preloaded queue through
    one slot: the completion order is the JAX engine's, and the first 20
    completions split 15:5."""
    pol = dict(tenants={"heavy": {"weight": 3.0, "priority": "batch"},
                        "light": {"weight": 1.0, "priority": "batch"}})

    def scenario(pkg, make):
        order = []
        with make(slots=1, max_len=32, queue_capacity=64,
                  qos=pkg.QosPolicy(**pol)) as eng:
            rest = [(prompt(3, k), dict(max_new_tokens=1, tenant=t))
                    for k in range(16) for t in ("heavy", "light")]
            hs = parked(eng, (prompt(3, 99), dict(max_new_tokens=2,
                                                  tenant="light")), rest)
            for h, (_p, kw) in zip(hs[1:], rest):
                h.future.add_done_callback(
                    lambda _f, t=kw["tenant"]: order.append(t))
            toks = [h.result(timeout=120) for h in hs]
            qs = eng.metrics.qos_snapshot()
        return order, toks, {t: d["served"] for t, d in qs["tenants"].items()}

    order, _toks, served = both(sides, scenario)
    head = order[:20]
    assert head.count("heavy") == 15 and head.count("light") == 5
    assert served == {"heavy": 16.0, "light": 17.0}


def test_interactive_overtakes_a_batch_flood(sides):
    pol = dict(tenants={"user": {"priority": "interactive"},
                        "batcher": {"priority": "batch"}})

    def scenario(pkg, make):
        order = []
        with make(slots=1, max_len=32, qos=pkg.QosPolicy(**pol)) as eng:
            rest = [(prompt(5, k), dict(max_new_tokens=2, tenant="batcher"))
                    for k in range(4)]
            rest.append((prompt(5, 9), dict(max_new_tokens=2,
                                            tenant="user")))
            hs = parked(eng, (prompt(5, 8), dict(max_new_tokens=4,
                                                 tenant="batcher")), rest)
            for h, (_p, kw) in zip(hs[1:], rest):
                h.future.add_done_callback(
                    lambda _f, t=kw["tenant"]: order.append(t))
            toks = [h.result(timeout=120) for h in hs]
            qs = eng.metrics.qos_snapshot()
            waits = {p: h["count"]
                     for p, h in qs["queue_wait_by_class"].items()}
        return order, toks, waits

    order, _toks, waits = both(sides, scenario)
    assert order[0] == "user" and order[1:] == ["batcher"] * 4
    assert waits == {"interactive": 1, "batch": 5}


def test_quota_shed_typed(sides):
    def scenario(pkg, make):
        clock = [0.0]
        pol = pkg.QosPolicy({"q": pkg.TenantPolicy(quota=1.0,
                                                   quota_burst=1.0)},
                            clock=lambda: clock[0])
        with make(slots=1, max_len=32, qos=pol) as eng:
            h = eng.submit(prompt(4), max_new_tokens=2, tenant="q")
            with pytest.raises(pkg.QuotaExceededError) as ei:
                eng.submit(prompt(4), max_new_tokens=2, tenant="q")
            clock[0] += 1.0        # the bucket refills one request
            h2 = eng.submit(prompt(4), max_new_tokens=2, tenant="q")
            toks = [h.result(timeout=120), h2.result(timeout=120)]
            m = eng.metrics
            return (ei.value.reason, toks, m.rejections_by_reason.to_dict(),
                    m.quota_rejections_total.value,
                    m.qos_snapshot()["tenants"])

    reason, _toks, reasons, quota, tenants = both(sides, scenario)
    assert reason == "quota_exceeded" and quota == 1
    assert reasons == {"quota_exceeded": 1}
    assert tenants["q"]["rejections_by_reason"] == {"quota_exceeded": 1}


def test_non_preemptible_tenant_never_a_victim(sides):
    """``preemptible=False`` shields the tenant from being another
    stream's victim: any eviction it suffers is its own. Preemption
    counts and streams equal the JAX engine's."""
    def scenario(pkg, make):
        pol = pkg.QosPolicy(tenants={
            "pinned": {"priority": "batch", "preemptible": False}})
        tracer = pkg.Tracer(sample_rate=1.0)
        with make(qos=pol, tracer=tracer, **TIGHT) as eng:
            hs = parked(eng, (prompt(4, 1), dict(max_new_tokens=20,
                                                 eos_id=None,
                                                 tenant="pinned")),
                        [(prompt(4, 0), dict(max_new_tokens=20,
                                             eos_id=None))])
            toks = [h.result(timeout=120) for h in hs]
            evictions = [a for name, _t, a in hs[0]._req.trace.events
                         if name == "preempt"]
            return (toks, eng.metrics.preemptions_total.value,
                    [h._req.x.preemptions for h in hs],
                    [a["self_preempted"] for a in evictions])

    toks, preemptions, per_stream, self_flags = both(sides, scenario)
    assert preemptions >= 1 and all(self_flags)
    _pkg, make = sides["torch"]
    with make(slots=2, max_len=32, block_size=8) as eng:
        assert toks == [eng.generate(prompt(4, s), max_new_tokens=20,
                                     eos_id=None, timeout=120)
                        for s in (1, 0)]


def test_victims_by_class_with_a_policy(sides):
    """Under a policy the batch-class tenant is evicted for the
    interactive one's boundary crossing, never the other way around."""
    def scenario(pkg, make):
        pol = pkg.QosPolicy(tenants={"fast": {"priority": "interactive"},
                                     "slow": {"priority": "batch"}})
        with make(qos=pol, **TIGHT) as eng:
            hs = parked(eng, (prompt(4, 1), dict(max_new_tokens=20,
                                                 eos_id=None,
                                                 tenant="slow")),
                        [(prompt(4, 0), dict(max_new_tokens=20, eos_id=None,
                                             tenant="fast"))])
            toks = [h.result(timeout=120) for h in hs]
            return toks, [h._req.x.preemptions for h in hs]

    _toks, per_stream = both(sides, scenario)
    assert per_stream[1] == 0 and per_stream[0] >= 1


def test_policy_leaves_streams_unchanged(sides):
    _pkg, make = sides["torch"]
    with make(slots=2, max_len=32) as eng:
        ref = [eng.generate(prompt(4 + i, i), max_new_tokens=4, timeout=120)
               for i in range(3)]
        assert type(eng._admission._q).__name__ == "deque"
        assert eng._qos_governor is None
    pol = T.QosPolicy({"a": T.TenantPolicy(weight=3.0, priority="batch")})
    with make(slots=2, max_len=32, qos=pol) as eng:
        assert eng.qos is pol
        got = [eng.generate(prompt(4 + i, i), max_new_tokens=4,
                            timeout=120, tenant="a") for i in range(3)]
    assert got == ref


def test_new_reasons_registered_once():
    for reason in ("quota_exceeded", "slo_shed", "retry_budget_exhausted",
                   "circuit_open", "watchdog", "poisoned"):
        assert T.REJECTION_REASONS.count(reason) == 1
        assert T.tracing.TERMINAL_REASONS.count(reason) == 1
    assert T.QuotaExceededError("x").reason == "quota_exceeded"
    assert T.SloShedError("x", detail="d").detail == "d"
    assert T.DEFAULT_TENANT == J.DEFAULT_TENANT
    assert t_qos.BURN_REASONS == jax_qos.BURN_REASONS
