"""The port's fleet control plane (deeplearning4j_tpu_torch/serving/
cluster.py and timeseries.py) against the JAX package's, on the CPU.

Each scenario runs once through each package's classes and the results
are compared:

- directory membership under a fake clock: joins, leaves, re-joins,
  heartbeats in and out of order, staleness, the probe window, quorum,
  the drain mark and the ``api_snapshot`` fleet roll-up, observed after
  every step of one script;
- front-door routing decisions over a grid of host statuses (least
  loaded, probe, typed ``cluster_capacity`` / ``host_unavailable``), and
  ``routed_by_host`` over real batching engines held in flight;
- generation streams through a two-host loopback fleet, greedy and
  sampled, equal to the JAX fleet's (``tests/test_cluster.py:642``);
- the hedging supervisor over scripted stub hosts: a stalled stream
  raced by a backup, a resume re-dispatch from the delivery watermark,
  a stream lost on every host — each delivers exactly one terminal;
- ``drain_host`` with resident streams (nothing shed, the host leaves);
- the aggregator's stitched cross-host traces;
- ``ElasticityPlanner`` decisions on one snapshot sequence, with cost
  models fitted from one time-series ring, and the heartbeat jitter.

The tolerance is equality: tokens, decisions, counters, trace shapes.
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
import deeplearning4j_tpu_torch.serving as T
from deeplearning4j_tpu_torch.models import (
    TransformerConfig, params_from_numpy)

PKGS = {"jax": J, "torch": T}
WIDTHS = dict(vocab_size=50, hidden=32, layers=2, heads=2, mlp_dim=64,
              max_seq=64, causal=True, remat=False)
JCFG = JaxConfig(**WIDTHS, dtype=jnp.float32, attention_impl="full")
TCFG = TransformerConfig(**WIDTHS, dtype=torch.float32,
                         attention_impl="full")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def both(fn):
    got = {side: fn(pkg) for side, pkg in PKGS.items()}
    assert got["torch"] == got["jax"]
    return got["torch"]


def host(x) -> np.ndarray:
    return x.toNumpy() if hasattr(x, "toNumpy") else np.asarray(x)


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


def mlp(pkg, gate=None):
    class MlpAdapter(pkg.ModelAdapter):
        kind = "tiny-mlp"

        def __init__(self):
            super().__init__(model=None)
            self.w = np.linspace(-1.0, 1.0, 6,
                                 dtype=np.float32).reshape(6, 1)

        def infer(self, x):
            if gate is not None:
                gate.wait(timeout=30.0)
            return np.asarray(x) @ self.w

    return MlpAdapter()


def gen_status(pkg, hid, **kw):
    base = dict(host_id=hid, has_generate=True, slots=8, free_slots=4,
                kv_blocks_total=64, kv_blocks_free=64, kv_blocks_usable=64,
                block_size=16, gen_queue_capacity=8, seq=1)
    base.update(kw)
    return pkg.HostStatus(**base)


class _Static:
    """A host handle with a fixed status and nothing behind it."""

    def __init__(self, pkg, hid, kinds=("infer", "generate")):
        self.host_id = hid
        self.kinds = kinds

    def serves(self, kind):
        return kind in self.kinds


# --------------------------------------------------------------------------
# Directory membership
# --------------------------------------------------------------------------
def directory_script(pkg):
    clock = FakeClock()
    d = pkg.ClusterDirectory(heartbeat_timeout_s=1.0, probe_interval_s=1.0,
                             clock=clock)
    obs = []

    def look(label):
        snap = d.api_snapshot()
        obs.append((label, d.host_ids(), d.alive_ids(), d.stale_ids(),
                    d.quorum(), d.degraded(), snap["fleet"],
                    {h: (v["alive"], v.get("draining"), v["heartbeat_age_s"])
                     for h, v in snap["hosts"].items()}))

    for i in (3, 1, 2):
        d.join(pkg.LoopbackHost(i))
    look("joined")
    d.heartbeat(gen_status(pkg, 1, seq=5, free_slots=2))
    d.heartbeat(gen_status(pkg, 1, seq=3, free_slots=7))   # out of order
    obs.append(("kept newer", d.status(1).free_slots))
    clock.advance(0.9)
    d.heartbeat(gen_status(pkg, 2, seq=1))
    clock.advance(0.2)
    look("1 and 3 stale")
    obs.append(("probe", d.allow_probe(3), d.allow_probe(3),
                d.allow_probe(7)))
    clock.advance(1.1)
    obs.append(("probe window", d.allow_probe(3)))
    d.heartbeat(gen_status(pkg, 1, seq=1))     # restarted: lower seq
    look("1 back")
    obs.append(("drain mark", d.mark_draining(2), d.mark_draining(9),
                d.is_draining(2)))
    d.heartbeat(gen_status(pkg, 3, seq=1, draining=True))
    look("2 marked, 3 says draining")
    d.join(pkg.LoopbackHost(2))                # re-join un-drains
    obs.append(("rejoin", d.is_draining(2), d.status(2)))
    obs.append(("leave", d.leave(2), d.leave(2)))
    d.heartbeat(gen_status(pkg, 8, seq=1))     # heartbeat-only host
    clock.advance(5.0)
    look("all stale")
    return obs


class TestDirectory:
    def test_fake_clock_script_equal(self):
        obs = both(directory_script)
        assert obs[0][1] == [1, 2, 3]
        assert obs[2][2] == [2] and obs[2][3] == [1, 3]
        assert obs[3][1:] == (True, False, False)

    def test_heartbeat_jitter_schedule_equal(self):
        def run(pkg):
            pump = pkg.HeartbeatPump(pkg.LoopbackHost(3),
                                     pkg.LoopbackTransport(
                                         pkg.ClusterDirectory()),
                                     interval_s=0.5, jitter=0.2)
            return [pump.next_interval_s() for _ in range(12)]

        sched = both(run)
        assert all(0.4 <= s < 0.6 for s in sched) and len(set(sched)) > 1

    def test_join_rejects_negative_id_and_bad_args(self):
        def run(pkg):
            out = []
            for bad in (lambda: pkg.ClusterDirectory().join(
                            pkg.LoopbackHost(-1)),
                        lambda: pkg.ClusterDirectory(heartbeat_timeout_s=0),
                        lambda: pkg.ClusterDirectory(quorum=0),
                        lambda: pkg.LoopbackHost(0, host_class="bogus")):
                with pytest.raises(ValueError) as ei:
                    bad()
                out.append(str(ei.value))
            return out

        both(run)


# --------------------------------------------------------------------------
# Routing
# --------------------------------------------------------------------------
ROUTE_GRID = [
    # (statuses by host, kind, route kwargs)
    ({0: dict(free_slots=1), 1: dict(free_slots=5)}, "generate",
     dict(blocks_needed=2)),
    ({0: dict(free_slots=3, kv_blocks_free=10),
      1: dict(free_slots=3, kv_blocks_free=40)}, "generate",
     dict(blocks_needed=2)),
    ({0: dict(free_slots=0, gen_queue_depth=8),
      1: dict(free_slots=0, gen_queue_depth=8)}, "generate",
     dict(blocks_needed=2)),
    ({0: dict(kv_blocks_usable=4), 1: dict(kv_blocks_usable=4)},
     "generate", dict(blocks_needed=5)),
    ({0: dict(free_slots=4, kv_blocks_free=1, allocate="on_demand"),
      1: dict(free_slots=4, kv_blocks_free=1)}, "generate",
     dict(blocks_needed=3, blocks_admit=1)),
    ({0: dict(breaker="OPEN"), 1: dict(free_slots=1)}, "generate",
     dict(blocks_needed=1)),
    ({0: dict(breaker="OPEN"), 1: dict(breaker="OPEN")}, "generate",
     dict(blocks_needed=1)),
    ({0: dict(free_slots=5), 1: dict(free_slots=2)}, "generate",
     dict(blocks_needed=1, pinned=1)),
    ({0: dict(free_slots=5), 1: dict(free_slots=2)}, "generate",
     dict(blocks_needed=1, exclude=(0,))),
    ({0: dict(free_slots=5), 1: dict(free_slots=2)}, "generate",
     dict(blocks_needed=1, exclude=(0, 1), bounced_full=1)),
    ({0: dict(has_infer=True, queue_depth=6, queue_capacity=8,
              buckets=(1, 2, 4, 8)),
      1: dict(has_infer=True, queue_depth=2, queue_capacity=8,
              buckets=(1, 2, 4, 8))}, "infer", dict(rows=3)),
    ({0: dict(has_infer=True, queue_depth=7, queue_capacity=8),
      1: dict(has_infer=True, queue_depth=8, queue_capacity=8)}, "infer",
     dict(rows=2)),
]


def route_grid(pkg):
    out = []
    for statuses, kind, kw in ROUTE_GRID:
        clock = FakeClock()
        d = pkg.ClusterDirectory(heartbeat_timeout_s=1.0, clock=clock)
        for hid, st in statuses.items():
            d.join(_Static(pkg, hid))
            d.heartbeat(gen_status(pkg, hid, **st))
        fd = pkg.ClusterFrontDoor(d)
        try:
            _h, hid, how = fd._route(kind, **kw)
            out.append((hid, how))
        except pkg.RejectedError as e:
            out.append((type(e).__name__, e.reason))
        # every host stale: one probe each, then host_unavailable
        clock.advance(2.0)
        stale = []
        for _ in range(3):
            try:
                stale.append(fd._route(kind, **kw)[1:])
            except pkg.RejectedError as e:
                stale.append((type(e).__name__, e.reason))
        out.append(stale)
    return out


class TestRouting:
    def test_route_decisions_equal(self):
        got = both(route_grid)
        decisions, stale = got[0::2], got[1::2]
        assert decisions[0] == (1, "least_loaded")
        assert decisions[2] == ("ClusterCapacityError", "cluster_capacity")
        assert decisions[10] == (1, "least_loaded")
        assert stale[0] == [(0, "probe"), (1, "probe"),
                            ("HostUnavailableError", "host_unavailable")]

    def test_routed_by_host_and_typed_sheds_over_real_engines(self):
        def run(pkg):
            gates = [threading.Event() for _ in range(3)]
            d = pkg.ClusterDirectory(heartbeat_timeout_s=30.0)
            hosts = []
            for i in range(3):
                eng = pkg.InferenceEngine(
                    mlp(pkg, gates[i]), max_batch_size=8, max_wait_ms=0.0,
                    queue_capacity_rows=8, name=f"e{i}")
                hosts.append(pkg.LoopbackHost(i, engine=eng))
                d.join(hosts[-1])
                pkg.HeartbeatPump(hosts[-1],
                                  pkg.LoopbackTransport(d)).pump_once()
            fd = pkg.ClusterFrontDoor(d)
            try:
                # every dispatcher is held: the front door's outstanding
                # rows decide the spread
                futs = [fd.submit(np.ones((2, 6), np.float32))
                        for _ in range(9)]
                routed = fd.routed_by_host.to_dict()
                for p in (pkg.HeartbeatPump(h, pkg.LoopbackTransport(d))
                          for h in hosts):
                    p.pump_once()
                shed = []
                for _ in range(12):
                    try:
                        futs.append(fd.submit(np.ones((2, 6), np.float32)))
                    except pkg.RejectedError as e:
                        shed.append(e.reason)
                        break
                outstanding = fd.outstanding_total()
                for g in gates:
                    g.set()
                vals = [host(f.result(timeout=30)).tolist() for f in futs]
                deadline = time.time() + 10
                while fd.outstanding_total() and time.time() < deadline:
                    time.sleep(0.01)
                return (routed, shed, outstanding, len(vals),
                        fd.routed_by_host.to_dict(),
                        fd.metrics.rejections_by_reason.to_dict(),
                        fd.outstanding_total())
            finally:
                for g in gates:
                    g.set()
                for h in hosts:
                    h.shutdown()

        routed, shed, out0, n, routed_all, reasons, out1 = both(run)
        assert routed == {"h0": 3, "h1": 3, "h2": 3}
        assert shed == ["cluster_capacity"] and out1 == 0
        assert reasons == {"cluster_capacity": 1}


# --------------------------------------------------------------------------
# Generation through a loopback fleet
# --------------------------------------------------------------------------
@pytest.fixture(scope="module")
def np_params():
    p = jax_init_params(jax.random.PRNGKey(0), JCFG)
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), p)


def gen_fleet(pkg, np_params, n=2, tracer=None, engine_tracers=None,
              **gkw):
    if pkg is J:
        params = jax.tree_util.tree_map(jnp.asarray, np_params)
        make = lambda **kw: J.GenerationEngine(params, JCFG, **kw)  # noqa
    else:
        params = params_from_numpy(np_params, device="cpu")
        make = lambda **kw: T.GenerationEngine(  # noqa: E731
            params, TCFG, device="cpu", **kw)
    d = pkg.ClusterDirectory(heartbeat_timeout_s=30.0)
    hosts = []
    for i in range(n):
        ekw = {} if engine_tracers is None else {"tracer": engine_tracers[i]}
        g = make(slots=2, max_len=32, name=f"gen{i}", **ekw, **gkw)
        hosts.append(pkg.LoopbackHost(i, generation=g, **ekw))
        d.join(hosts[-1])
    for h in hosts:
        pkg.HeartbeatPump(h, pkg.LoopbackTransport(d)).pump_once()
    return d, pkg.ClusterFrontDoor(d, tracer=tracer), hosts


def prompt(n=5, seed=3):
    return np.random.default_rng(seed).integers(1, 50, n).astype(np.int32)


class TestGenerationFleet:
    def test_streams_equal_jax_fleet(self, np_params):
        def run(pkg):
            d, fd, hosts = gen_fleet(pkg, np_params)
            try:
                hs = [fd.submit_generate(prompt(5 + i, i), max_new_tokens=6,
                                         seed=i, **({"temperature": 1.0,
                                                     "top_k": 8}
                                                    if i % 2 else {}))
                      for i in range(4)]
                res = [h.result(timeout=120) for h in hs]
                direct = hosts[1].generation.generate(
                    prompt(5, 0), max_new_tokens=6, seed=0, timeout=120)
                routed = fd.routed_by_host.to_dict()
                return res, direct, sum(routed.values()), \
                    fd.metrics.tenant_served.to_dict()
            finally:
                for h in hosts:
                    h.shutdown()

        res, direct, n, served = both(run)
        assert res[0] == direct and n == 4 and served == {"anon": 4.0}

    def test_drain_host_with_resident_streams_sheds_nothing(self,
                                                            np_params):
        def run(pkg):
            d, fd, hosts = gen_fleet(pkg, np_params)
            try:
                hs = [fd.submit_generate(prompt(4, i), max_new_tokens=12,
                                         seed=i) for i in range(4)]
                ok = pkg.drain_host(d, 1, timeout=120.0)
                res = [h.result(timeout=120) for h in hs]
                after = [fd.submit_generate(prompt(4, 9), max_new_tokens=3,
                                            seed=9).result(timeout=120)]
                with pytest.raises(pkg.HostDrainingError) as ei:
                    hosts[1].submit_generate(prompt(3), max_new_tokens=2)
                return (ok, d.host_ids(), res, after,
                        fd.metrics.rejections_by_reason.to_dict(),
                        hosts[1].generation.drained, ei.value.reason,
                        fd.routed_by_host.to_dict().get("h0"))
            finally:
                for h in hosts:
                    h.shutdown()

        ok, ids, res, after, reasons, drained, reason, h0 = both(run)
        assert ok is True and ids == [0] and reasons == {}
        assert drained is True and reason == "host_draining"
        with pytest.raises(KeyError):
            T.drain_host(T.ClusterDirectory(), 5)

    def test_aggregator_stitches_cross_host_traces(self, np_params):
        def run(pkg):
            tracer = pkg.Tracer(sample_rate=1.0)
            tracers = [pkg.Tracer(sample_rate=1.0) for _ in range(2)]
            d, fd, hosts = gen_fleet(pkg, np_params, tracer=tracer,
                                     engine_tracers=tracers)
            try:
                hs = [fd.submit_generate(prompt(4, i), max_new_tokens=3,
                                         seed=i) for i in range(2)]
                [h.result(timeout=120) for h in hs]
                agg = pkg.ClusterStatsAggregator(d)
                offsets = agg.estimate_clock_offsets()
                deadline = time.time() + 10
                while time.time() < deadline:
                    st = agg.stitched_traces()
                    if len(st) == 2 and all(s["legs"] for s in st):
                        break
                    time.sleep(0.02)
                shape = [(s["span_count"], s["hosts"], s["error"],
                          [leg["parent_span"] for leg in s["legs"]],
                          all(leg["link"] == s["trace_id"]
                              for leg in s["legs"]))
                         for s in st]
                ids = sorted(t["trace_id"].split("/")[0]
                             for t in agg.traces())
                pids = sorted({e["pid"] // 1000 for e in
                               agg.stitched_chrome_events()
                               if e.get("ph") == "X"})
                return shape, ids, sorted(offsets), pids
            finally:
                for h in hosts:
                    h.shutdown()

        shape, ids, offs, pids = both(run)
        assert sorted(shape) == [(2, [0], False, ["route"], True),
                                 (2, [1], False, ["route"], True)]
        assert ids == ["h0", "h1"] and offs == [0, 1] and pids == [0, 1, 2]


# --------------------------------------------------------------------------
# The hedging supervisor over scripted stub hosts
# --------------------------------------------------------------------------
def stub_host(pkg, host_id, tokens=(), stall=False, die_after=None,
              honor_resume=True, free_slots=4):
    """A host with an ``open_stream`` surface whose chunks are scripted:
    ``stall`` never delivers; ``die_after`` delivers that many tokens and
    then raises ``host_unavailable``; otherwise the rest in one chunk."""

    class Stream:
        def __init__(self, host, sid, base):
            self.host, self.stream_id, self.base = host, sid, base
            self.resume_step = base
            self.cancelled = False

        def poll(self, cursor, wait_ms):
            return self.host._poll(self, cursor, wait_ms)

        def cancel(self):
            self.cancelled = True
            self.host.cancels += 1

    class Host:
        def __init__(self):
            self.host_id = host_id
            self.opened = self.cancels = 0
            self.streams, self.resumes = [], []

        def serves(self, kind):
            return kind == "generate"

        def status(self):
            return gen_status(pkg, host_id, free_slots=free_slots,
                              kv_blocks_total=1024, kv_blocks_free=1024,
                              kv_blocks_usable=1024)

        def open_stream(self, prompt, resume_tokens=None, resume_step=0,
                        **kw):
            self.opened += 1
            self.resumes.append(None if resume_tokens is None
                                else list(resume_tokens))
            base = len(resume_tokens) if (honor_resume and resume_tokens
                                          is not None) else 0
            s = Stream(self, f"s{host_id}-{self.opened}", base)
            self.streams.append(s)
            return s

        def _poll(self, s, cursor, wait_ms):
            at = s.base + cursor
            if stall:
                time.sleep(wait_ms / 1e3)
                return pkg.RpcStreamChunk(stream_id=s.stream_id,
                                          cursor=cursor)
            if die_after is not None:
                if at < die_after:
                    return pkg.RpcStreamChunk(
                        stream_id=s.stream_id, cursor=cursor,
                        tokens=list(tokens[at:die_after]))
                raise pkg.HostUnavailableError("host died", host=host_id)
            return pkg.RpcStreamChunk(stream_id=s.stream_id, cursor=cursor,
                                      tokens=list(tokens[at:]), done=True,
                                      finish_reason="max_tokens")

    return Host()


def hedge_run(pkg, hosts, policy, max_new):
    d = pkg.ClusterDirectory(heartbeat_timeout_s=30.0)
    tr = pkg.LoopbackTransport(d)
    for h in hosts:
        d.join(h)
        tr.publish(h.status())
    fd = pkg.ClusterFrontDoor(d, hedge=policy)
    seen = []
    h = fd.submit_generate(np.asarray([1, 2, 3], np.int32),
                           max_new_tokens=max_new, on_token=seen.append)
    try:
        res = h.result(timeout=30)
    except pkg.RejectedError as e:
        res = e.reason
    # the losers' attempt threads wind down (a poll in flight finishes)
    deadline = time.monotonic() + 10
    while fd.outstanding_total() and time.monotonic() < deadline:
        time.sleep(0.01)
    return (res, seen, fd.hedges.to_dict(),
            fd.metrics.rejections_by_reason.to_dict(),
            sum(fd.metrics.tenant_served.to_dict().values())
            + sum(fd.metrics.tenant_shed.to_dict().values()),
            [hst.opened for hst in hosts], [hst.resumes for hst in hosts],
            fd.metrics.stream_resumes_total.value, fd.outstanding_total())


TOKENS = [100 + i for i in range(8)]


class TestHedging:
    def test_stalled_stream_raced_by_a_backup(self):
        def run(pkg):
            hosts = [stub_host(pkg, 0, stall=True, free_slots=8),
                     stub_host(pkg, 1, tokens=[11, 12, 13], free_slots=2)]
            out = hedge_run(pkg, hosts, pkg.HedgePolicy(
                hedge_after_ms=60.0, max_attempts=2, poll_wait_ms=20.0), 3)
            loser = hosts[0].streams[0]
            deadline = time.monotonic() + 10   # the winner cancels it
            while not loser.cancelled and time.monotonic() < deadline:
                time.sleep(0.01)
            return out + (loser.cancelled,)

        res, seen, hedges, reasons, terminals, opened, *_rest, cancelled \
            = both(run)
        assert res == seen == [11, 12, 13] and hedges == {"timeout": 1.0}
        assert terminals == 1 and opened == [1, 1] and cancelled

    def test_lost_stream_resumes_from_the_watermark(self):
        def run(pkg):
            hosts = [stub_host(pkg, 0, tokens=TOKENS, die_after=3,
                               free_slots=8),
                     stub_host(pkg, 1, tokens=TOKENS, free_slots=2)]
            return hedge_run(pkg, hosts, pkg.HedgePolicy(
                hedge_after_ms=None, max_attempts=3, poll_wait_ms=20.0),
                len(TOKENS))

        res, seen, hedges, reasons, terminals, opened, resumes, n_res, \
            out = both(run)
        assert res == seen == TOKENS and hedges == {"redispatch": 1.0}
        assert resumes == [[None], [TOKENS[:3]]] and n_res == 1
        assert terminals == 1 and reasons == {} and out == 0

    def test_unhonored_resume_replays_and_dedups(self):
        def run(pkg):
            hosts = [stub_host(pkg, 0, tokens=TOKENS, die_after=3,
                               free_slots=8),
                     stub_host(pkg, 1, tokens=TOKENS, free_slots=2,
                               honor_resume=False)]
            return hedge_run(pkg, hosts, pkg.HedgePolicy(
                hedge_after_ms=None, max_attempts=3, poll_wait_ms=20.0),
                len(TOKENS))

        res, seen, _h, _r, terminals, _o, _res, n_res, _out = both(run)
        assert res == seen == TOKENS and n_res == 0 and terminals == 1

    def test_lost_everywhere_sheds_once_typed(self):
        def run(pkg):
            hosts = [stub_host(pkg, 0, tokens=TOKENS, die_after=2,
                               free_slots=8),
                     stub_host(pkg, 1, tokens=TOKENS, die_after=5,
                               free_slots=2)]
            return hedge_run(pkg, hosts, pkg.HedgePolicy(
                hedge_after_ms=None, max_attempts=3, poll_wait_ms=20.0),
                len(TOKENS))

        res, seen, hedges, reasons, terminals, opened, *_ = both(run)
        assert res == "host_unavailable" and seen == TOKENS[:5]
        assert reasons == {"host_unavailable": 1.0} and terminals == 1
        assert opened == [1, 1]

    def test_burst_and_spaced_arrivals_route_as_the_reference(self):
        """A stream counts in the front door's outstanding work once its
        dispatch has landed, in both packages: a burst submitted between
        two heartbeats (every dispatch still in flight) goes to the first
        host by id, and arrivals that each come after the previous
        dispatch landed alternate between the hosts."""
        def run(pkg):
            open_gate, poll_gate = threading.Event(), threading.Event()
            hosts = [stub_host(pkg, i, tokens=[7, 8], free_slots=8)
                     for i in range(2)]
            for h in hosts:
                opener, poller = h.open_stream, h._poll

                def held_open(prompt, _open=opener, **kw):
                    open_gate.wait(30)     # the dispatch is in flight
                    return _open(prompt, **kw)

                def held_poll(s, cursor, wait_ms, _poll=poller):
                    if not poll_gate.wait(wait_ms / 1e3):
                        return pkg.RpcStreamChunk(stream_id=s.stream_id,
                                                  cursor=cursor)
                    return _poll(s, cursor, wait_ms)
                h.open_stream, h._poll = held_open, held_poll
            d = pkg.ClusterDirectory(heartbeat_timeout_s=30.0)
            tr = pkg.LoopbackTransport(d)
            for h in hosts:
                d.join(h)
                tr.publish(h.status())
            fd = pkg.ClusterFrontDoor(d, hedge=pkg.HedgePolicy(
                hedge_after_ms=None, poll_wait_ms=20.0))
            prompt_ = np.asarray([1, 2], np.int32)
            poll_gate.set()
            burst = [fd.submit_generate(prompt_, max_new_tokens=2)
                     for _ in range(8)]
            in_flight = fd.outstanding_total()
            open_gate.set()
            res = [h.result(timeout=30) for h in burst]
            opened = [h.opened for h in hosts]
            poll_gate.clear()
            spaced = []
            for k in range(8):
                spaced.append(fd.submit_generate(prompt_, max_new_tokens=2))
                deadline = time.monotonic() + 30
                while fd.outstanding_total() < k + 1 \
                        and time.monotonic() < deadline:
                    time.sleep(0.005)
            landed = fd.outstanding_total()
            poll_gate.set()
            res += [h.result(timeout=30) for h in spaced]
            return (opened, in_flight,
                    [h.opened - o for h, o in zip(hosts, opened)], landed,
                    res, fd.routed_by_host.to_dict())

        opened, in_flight, spaced, landed, res, routed = both(run)
        assert opened == [8, 0] and in_flight == 0
        assert spaced == [4, 4] and landed == 8
        assert res == [[7, 8]] * 16 and routed == {"h0": 12.0, "h1": 4.0}

    def test_policy_validation(self):
        def run(pkg):
            out = []
            for kw in (dict(hedge_after_ms=0.0), dict(max_attempts=0),
                       dict(poll_wait_ms=0.0),
                       dict(infer_hedge_after_ms=0.0)):
                with pytest.raises(ValueError) as ei:
                    pkg.HedgePolicy(**kw)
                out.append(str(ei.value))
            return out

        both(run)


# --------------------------------------------------------------------------
# Elasticity
# --------------------------------------------------------------------------
def snapshot(free, slots=16, sheds=0, preempt=0, draining=(), hosts=2):
    hs = {str(i): {"alive": True, "draining": i in draining,
                   "status": {"free_slots": free // hosts,
                              "kv_blocks_free": 10 * i}}
          for i in range(hosts)}
    return {"hosts": hs,
            "fleet": {"alive": hosts, "draining": len(draining),
                      "slots": slots, "free_slots": free,
                      "preemptions_total": preempt},
            "front_doors": [{"rejections_by_reason":
                             {"cluster_capacity": sheds}}]}


SNAPSHOTS = [snapshot(8), snapshot(1), snapshot(1, sheds=2),
             snapshot(1, sheds=2), snapshot(12), snapshot(12),
             snapshot(12), snapshot(12), snapshot(12, draining=(1,)),
             snapshot(6, preempt=4), snapshot(6, preempt=9),
             snapshot(6, preempt=12), snapshot(14), snapshot(14, hosts=1,
                                                             slots=8)]


def ts_samples(pkg):
    ts = pkg.TimeSeriesStore(capacity=64)
    rng = np.random.default_rng(5)
    for i in range(24):
        occ = float(rng.uniform(0.1, 1.0))
        ts.record(i % 3, {
            "t": float(i), "slot_occupancy": occ,
            "tokens_per_sec": 100.0 + 900.0 * occ + float(rng.normal(0, 5)),
            "host_class": "mixed",
            "config": {"kv_dtype": "int8" if i % 3 == 2 else "float32",
                       "allocate": "reserve", "paged_attention": "fused"}})
    return ts


class TestElasticity:
    def test_planner_decisions_equal(self):
        def run(pkg):
            plain = pkg.ElasticityPlanner(pkg.ElasticityPolicy(
                trend_windows=2, min_hosts=1))
            costed = pkg.ElasticityPlanner(
                pkg.ElasticityPolicy(trend_windows=2),
                timeseries=ts_samples(pkg), host_cost_per_s=2.0)
            return ([plain.observe(s) for s in SNAPSHOTS],
                    [costed.observe(s) for s in SNAPSHOTS[:4]])

        plain, costed = both(run)
        actions = [d["action"] for d in plain]
        assert "join" in actions and "drain" in actions
        assert plain[8]["draining_host"] == 1
        assert "fitted cost/token" in costed[2]["reason"]

    def test_policy_validation(self):
        def run(pkg):
            out = []
            for kw in (dict(low_free_slot_frac=0.7),
                       dict(trend_windows=0), dict(min_hosts=0),
                       dict(preemption_pressure_min=0)):
                with pytest.raises(ValueError) as ei:
                    pkg.ElasticityPolicy(**kw)
                out.append(str(ei.value))
            return out

        both(run)

    def test_loop_drains_the_least_loaded_host(self):
        def run(pkg):
            d = pkg.ClusterDirectory(heartbeat_timeout_s=30.0)
            hosts = []
            for i in range(3):
                eng = pkg.InferenceEngine(mlp(pkg), max_batch_size=4,
                                          max_wait_ms=0.0, name=f"el{i}")
                hosts.append(pkg.LoopbackHost(i, engine=eng))
                d.join(hosts[-1])
            snaps = iter([snapshot(30, slots=32, hosts=3)] * 3)
            loop = pkg.ElasticityLoop(
                d, planner=pkg.ElasticityPlanner(pkg.ElasticityPolicy(
                    trend_windows=2)),
                source=lambda: next(snaps), drain_timeout_s=10.0)
            try:
                acts = [loop.step()["action"] for _ in range(3)]
                return acts, d.host_ids(), loop.steps, \
                    loop in pkg.all_elasticity_loops()
            finally:
                for h in hosts:
                    h.shutdown()

        acts, ids, steps, registered = both(run)
        assert acts == ["hold", "hold", "drain"] and ids == [0, 1]
        assert steps == 3 and registered
