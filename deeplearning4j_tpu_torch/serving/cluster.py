"""Fleet serving control plane (counterpart: ``deeplearning4j_tpu/serving/
cluster.py``): cross-host routing, fleet health, hedged streams and the
elasticity loop.

Every serving tier below this one (micro-batching, continuous-batching
decode, paged KV, QoS, resilience, observability) is per-process: under
heavy traffic one host's slots fill and everything behind them blocks.
ORCA (OSDI '22) and vLLM (SOSP '23) both assume a scheduler whose
capacity view spans the deployment, and Google SRE's load-shedding
doctrine says health must propagate fleet-wide or retries just move the
storm to the next replica. This module is that tier:

- :class:`ClusterDirectory` — membership and fleet health. Hosts
  :meth:`~ClusterDirectory.join` with a :class:`HostHandle` and publish
  :class:`HostStatus` heartbeats carrying their capacity (queue depth,
  free slots, free KV blocks) and health (breaker state, SLO-burn flag).
  A host whose heartbeat goes stale gets probe traffic only (the circuit
  breaker's HALF_OPEN single-probe discipline at fleet scope), and a
  fleet below quorum reports a typed degraded mode.
- :class:`ClusterFrontDoor` — the engines' submit surface
  (``tenant=``, ``priority=``, ``prefix_id=``) over the fleet: each
  request goes to the least-loaded capable host (padding-aware queue
  depth for batch inference, free slots then free KV blocks for
  generation). A full fleet sheds typed ``cluster_capacity``, a dead or
  stale host typed ``host_unavailable``; one host's OPEN breaker drains
  its share of traffic fleet-wide. Streams over the RPC data plane
  (serving/rpc.py) are hedged: a stall races a backup attempt, a lost
  host re-dispatches from the delivery watermark, and exactly one
  terminal reaches the caller. With ``disagg=DisaggPolicy()``
  (serving/disagg.py) a fleet of prefill- and decode-class hosts runs
  each prompt on a prefill host and migrates its KV pages to a decode
  host.
- transports — :class:`LoopbackTransport` delivers heartbeats in
  process (threads as hosts, real engines behind each
  :class:`LoopbackHost`, fake-clock testable); a :class:`~.rpc.
  RemoteHost` pumped by a :class:`HeartbeatPump` reads its status over
  HTTP. The reference's ``HttpTransport`` (heartbeats through the UI
  tier's stats router) waits for the port of that tier.
- :class:`ClusterStatsAggregator` — every host's tail-sampled traces
  with host-prefixed ids, merged Chrome lanes, and the cross-host
  stitching of each logical stream's legs under its front-door root.
- :func:`drain_host` and the :class:`ElasticityPlanner` /
  :class:`ElasticityLoop` join/drain decisions, with cost models fitted
  over serving/timeseries.py's rings.
"""
from __future__ import annotations

import dataclasses
import threading
import time
import weakref
from concurrent.futures import Future
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from deeplearning4j_tpu_torch.serving.admission import (
    DEFAULT_TENANT, ClusterCapacityError, HostDrainingError,
    HostUnavailableError, RejectedError,
)
from deeplearning4j_tpu_torch.serving.metrics import (
    ReasonCounter, ServingMetrics)
from deeplearning4j_tpu_torch.serving.paging import blocks_for_tokens
from deeplearning4j_tpu_torch.serving.qos import PRIORITIES
from deeplearning4j_tpu_torch.serving.tracing import (
    default_tracer, flight_recorder, terminal_reason,
)


# --------------------------------------------------------------------------
# Host status: the heartbeat payload
# --------------------------------------------------------------------------
@dataclasses.dataclass
class HostStatus:
    """One host's capacity + health snapshot — the heartbeat payload the
    directory routes on. JSON-safe by construction (:meth:`to_dict` /
    :meth:`from_dict` are the wire format; the schema and
    ``wire_version`` are the reference's, so either package reads the
    other's heartbeats). Capacity
    fields carry the ADMISSION view: ``queue_depth``/``queue_capacity``
    in the host engine's unit (rows for batch inference, requests for
    generation), ``kv_blocks_usable`` the blocks a stream could EVER get
    (pool capacity minus shared-prefix pins)."""

    host_id: int
    has_infer: bool = False
    has_generate: bool = False
    # admission view (batch engine: rows; generation engine: requests)
    queue_depth: int = 0
    queue_capacity: int = 0
    gen_queue_depth: int = 0
    gen_queue_capacity: int = 0
    # generation capacity
    slots: int = 0
    free_slots: int = 0
    kv_blocks_total: int = 0
    kv_blocks_free: int = 0
    kv_blocks_usable: int = 0
    block_size: int = 0
    # the host engine's block-allocation discipline ("reserve" |
    # "on_demand"): an on-demand host seats a stream on its PROMPT's
    # blocks only, so the router gates its free-block headroom on the
    # admit demand, not the worst case. Defaulted — pre-upgrade
    # heartbeats parse as reserve, the conservative read.
    allocate: str = "reserve"
    # lifetime preemption count (allocate="on_demand" evictions): the
    # elasticity planner reads the fleet-wide DELTA as a capacity-
    # pressure signal — a fleet that preempts steadily needs hosts
    # before it starts shedding
    preemptions_total: int = 0
    # swap-to-host occupancy: blocks a preemption victim parked
    # in host RAM awaiting copy-back, and the store's bound. Defaulted
    # so a pre-swap sender's heartbeat parses (mixed fleet reads 0) and
    # a pre-swap RECEIVER's known-field filter drops them harmlessly.
    kv_swapped_blocks: int = 0
    kv_swap_capacity_blocks: int = 0
    buckets: Tuple[int, ...] = ()
    # disaggregated serving: the host's placement class. A
    # "prefill" host takes prompt processing only, a "decode" host owns
    # decode-phase streams (and receives migrated KV pages), "mixed"
    # does both — the pre-disaggregation behavior, and the DEFAULT, so
    # a pre-upgrade sender's heartbeat parses as mixed and routes
    # exactly as before (bitwise-inert).
    host_class: str = "mixed"
    # fleet-wide cache-aware routing: the host's advertised prefix-cache
    # contents (leading tokens of each cached entry, MRU-first,
    # truncated by the cache's advertisement cap) plus summary counters.
    # Defaulted so pre-upgrade heartbeats parse with an empty
    # advertisement (the router simply never prefers such a host).
    prefix_tokens: Tuple[Tuple[int, ...], ...] = ()
    prefix_cache_entries: int = 0
    prefix_cache_hits: int = 0
    # health
    breaker: str = "CLOSED"
    slo_burn_active: bool = False
    slo_error_rate: float = 0.0
    slo_p99_ms: float = 0.0
    # graceful-leave protocol (serving/rpc.py): a
    # draining host finishes its resident streams but admits nothing
    # new — the router excludes it from candidates (no probe, no shed)
    # until it leaves the directory. Defaulted, so pre-drain senders'
    # heartbeats keep parsing mid-rolling-upgrade.
    draining: bool = False
    seq: int = 0                     # host-side monotone heartbeat counter
    # fleet time-series telemetry: the host's wall clock at
    # status time (the aggregator's NTP-style skew estimate reads it
    # against its own probe round-trip) and one compact
    # timeseries.SAMPLE_FIELDS dict, shipped only when the host has a
    # TimeSeriesStore attached. Defaulted — a wire-v1 sender's heartbeat
    # parses with no sample (the fleet ring simply never sees that
    # host), a wire-v1 receiver's known-field filter drops both.
    wall_t: float = 0.0
    sample: Optional[dict] = None
    # wire-format version for rolling upgrades: receivers branch on this
    # instead of guessing from field shapes, and from_dict's known-field
    # filter + the defaults above mean old<->new mixes keep heartbeating
    wire_version: int = 2

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["buckets"] = list(self.buckets)
        d["prefix_tokens"] = [list(p) for p in self.prefix_tokens]
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "HostStatus":
        known = {f.name for f in dataclasses.fields(cls)}
        kw = {k: v for k, v in d.items() if k in known}
        kw["buckets"] = tuple(kw.get("buckets") or ())
        kw["prefix_tokens"] = tuple(
            tuple(int(t) for t in p)
            for p in kw.get("prefix_tokens") or ())
        return cls(**kw)


# --------------------------------------------------------------------------
# Host handles
# --------------------------------------------------------------------------
class HostHandle:
    """One host as the front door sees it: an id, a status probe, and the
    engine submit surfaces. :class:`LoopbackHost` is the in-process
    implementation (threads as hosts, real engines), :class:`~.rpc.
    RemoteHost` the HTTP one — the directory and front door never assume
    more than this interface."""

    host_id: int = -1

    def serves(self, kind: str) -> bool:
        """Whether this host can take ``'infer'`` or ``'generate'``."""
        raise NotImplementedError

    def status(self) -> HostStatus:
        raise NotImplementedError

    def submit_infer(self, x, *, timeout_ms=None, tenant=None,
                     priority=None, trace_link=None, trace_parent=None):
        raise NotImplementedError

    def submit_generate(self, prompt, **kwargs):
        raise NotImplementedError

    def register_prefix(self, tokens, prefix_id=None, timeout=None) -> str:
        raise NotImplementedError


class LoopbackHost(HostHandle):
    """A host living in THIS process: real engines behind a handle, so
    the whole control-plane tier is testable single-process on CPU with
    threads as hosts. ``engine`` (InferenceEngine) and ``generation``
    (GenerationEngine) are caller-constructed — the host neither owns
    their configuration nor reshapes their behavior; it only computes
    :class:`HostStatus` from their admission/metrics/breaker state and
    forwards submits. ``tracer`` names the Tracer those engines record
    into so the aggregator can host-prefix its traces."""

    def __init__(self, host_id: int, *, engine=None, generation=None,
                 tracer=None, name: Optional[str] = None,
                 host_class: str = "mixed", timeseries=None):
        if host_class not in ("prefill", "decode", "mixed"):
            raise ValueError(
                f"host_class must be 'prefill', 'decode' or 'mixed', "
                f"got {host_class!r}")
        self.host_id = int(host_id)
        self.name = name if name is not None else f"h{host_id}"
        self.host_class = host_class
        self._lock = threading.Lock()
        self._engine = engine
        self._generation = generation
        self._tracer = tracer
        # fleet time-series telemetry: an optional
        # timeseries.TimeSeriesStore — when attached, every status()
        # call (heartbeat cadence by construction: the pump publishes
        # status) builds one compact sample, folds it into this host's
        # own ring, and ships it on the heartbeat for the fleet-side
        # ring. None (default) is bitwise-inert: no sample is built and
        # HostStatus.sample stays None, the wire-v1 shape.
        self._timeseries = timeseries
        self._draining = False
        self._seq = 0
        self._stamp_recorders()

    # ------------------------------------------------------------ wiring
    def _stamp_recorders(self):
        """Make this host's engines' flight-recorder events attributable
        at RECORD time: a merged incident ring (check_shutdown, crash
        dumps) then needs no worker-prefix cross-referencing. One host
        per process in production; a single-process multi-host test that
        inspects stamps gives each engine its own recorder."""
        for eng in (self._engine, self._generation):
            rec = getattr(eng, "_recorder", None)
            if rec is not None:
                rec.set_host(self.host_id)

    def attach_engine(self, engine) -> "LoopbackHost":
        with self._lock:
            self._engine = engine
        self._stamp_recorders()
        return self

    def attach_generation(self, generation) -> "LoopbackHost":
        with self._lock:
            self._generation = generation
        self._stamp_recorders()
        return self

    @property
    def engine(self):
        with self._lock:
            return self._engine

    @property
    def generation(self):
        with self._lock:
            return self._generation

    def serves(self, kind: str) -> bool:
        with self._lock:
            if kind == "infer":
                return self._engine is not None
            if kind == "generate":
                return self._generation is not None
        raise ValueError(f"unknown request kind {kind!r}")

    # ------------------------------------------------------------ status
    def status(self) -> HostStatus:
        eng, gen = self.engine, self.generation
        with self._lock:
            self._seq += 1
            seq = self._seq
        st = HostStatus(host_id=self.host_id, seq=seq,
                        draining=self._draining,
                        host_class=self.host_class)
        breaker = None
        metrics = None
        if eng is not None:
            st.has_infer = True
            st.queue_depth = eng.queue_depth_rows
            st.queue_capacity = eng._admission.capacity_rows
            st.buckets = tuple(eng.buckets)
            breaker, metrics = eng.breaker, eng.metrics
        if gen is not None:
            st.has_generate = True
            st.gen_queue_depth = gen._admission.depth_requests
            st.gen_queue_capacity = gen._admission.capacity_rows
            st.slots = gen.slots
            # heartbeat-grade read: the scheduler mutates the slot table
            # concurrently, and an off-by-one snapshot only skews one
            # routing decision for one heartbeat interval
            st.free_slots = gen.slots - gen.live_slots
            if gen.paged and gen._allocator is not None:
                st.kv_blocks_total = gen._allocator.capacity
                st.kv_blocks_free = gen._allocator.free_count
                st.kv_blocks_usable = gen._usable_blocks()
                st.block_size = gen.block_size
                st.allocate = gen.allocate
                st.preemptions_total = int(
                    gen.metrics.preemptions_total.value)
                if gen._swap_store is not None:
                    st.kv_swapped_blocks = gen._swap_store.blocks_held
                    st.kv_swap_capacity_blocks = \
                        gen._swap_store.capacity_blocks
            cache = getattr(gen, "_prefix_cache", None)
            if cache is not None:
                # cache-aware routing advertisement: entry count, hit
                # count, and the leading tokens of each cached entry
                # (MRU-first, capped) for the fleet prefix index
                st.prefix_cache_entries = len(cache)
                st.prefix_cache_hits = int(cache.hits)
                st.prefix_tokens = cache.advertised_prefixes()
            breaker, metrics = gen.breaker, gen.metrics
        if breaker is not None:
            st.breaker = breaker.state
        if metrics is not None:
            st.slo_burn_active = bool(metrics.slo_burn_active.value)
            windows = sorted(metrics.slo_windows.items(),
                             key=lambda kv: kv[1].window_s)
            if windows:
                s = windows[0][1].stats()
                st.slo_error_rate = s["error_rate"]
                st.slo_p99_ms = s["p99_ms"]
        # the host's wall clock at status time: the aggregator's skew
        # estimate reads it against its own probe round-trip midpoint
        st.wall_t = time.time()
        if self._timeseries is not None and metrics is not None:
            # heartbeat-cadence sampling: status() IS the beat (the
            # pump publishes it), so one sample per beat, decorated
            # with the host identity the cost models cell on
            sample = metrics.timeseries_sample()
            sample["t"] = st.wall_t
            sample["host_class"] = self.host_class
            sample["slots"] = st.slots
            sample["free_slots"] = st.free_slots
            sample["gen_queue_depth"] = st.gen_queue_depth
            if gen is not None:
                sample["config"] = {
                    "kv_dtype": getattr(gen, "kv_dtype", "float32"),
                    "allocate": getattr(gen, "allocate", "reserve"),
                    "paged_attention":
                        (getattr(gen, "paged_attention", "none")
                         if getattr(gen, "paged", False) else "none"),
                }
            st.sample = self._timeseries.record(self.host_id, sample)
        return st

    # ----------------------------------------------------------- submits
    def _drain_gate(self):
        if self._draining:
            raise HostDrainingError(
                f"host {self.host_id} is draining — admission closed "
                "ahead of a graceful leave", host=self.host_id)

    def submit_infer(self, x, *, timeout_ms=None, tenant=None,
                     priority=None, trace_link=None, trace_parent=None):
        self._drain_gate()
        eng = self.engine
        if eng is None:
            raise HostUnavailableError(
                f"host {self.host_id} serves no batch-inference engine",
                host=self.host_id)
        return eng.submit(x, timeout_ms=timeout_ms, tenant=tenant,
                          priority=priority, trace_link=trace_link,
                          trace_parent=trace_parent)

    def submit_generate(self, prompt, **kwargs):
        self._drain_gate()
        gen = self.generation
        if gen is None:
            raise HostUnavailableError(
                f"host {self.host_id} serves no generation engine",
                host=self.host_id)
        return gen.submit(prompt, **kwargs)

    def register_prefix(self, tokens, prefix_id=None, timeout=None) -> str:
        self._drain_gate()
        gen = self.generation
        if gen is None:
            raise HostUnavailableError(
                f"host {self.host_id} serves no generation engine",
                host=self.host_id)
        kw = {} if timeout is None else {"timeout": timeout}
        return gen.register_prefix(tokens, prefix_id=prefix_id, **kw)

    # --------------------------------------------------------------- drain
    @property
    def draining(self) -> bool:
        return self._draining

    def drain(self, timeout: Optional[float] = None) -> bool:
        """Graceful host drain — the host half of the leave protocol:
        flip :attr:`HostStatus.draining` (the next heartbeat tells the
        fleet; this host's own submits shed typed ``host_draining``
        immediately), then drain each engine — admission closed, queued
        and RESIDENT streams finish, shared-prefix pins released.
        Returns True when fully drained within ``timeout``. Leaving the
        directory is the COORDINATOR's half (``drain_host`` pairs the
        two: mark → drain → leave), because the directory lives there."""
        self._draining = True
        eng, gen = self.engine, self.generation
        deadline = None if timeout is None else time.monotonic() + timeout

        def remaining():
            return None if deadline is None \
                else max(0.0, deadline - time.monotonic())

        ok = True
        if eng is not None:
            ok = eng.drain(timeout=remaining()) and ok
        if gen is not None:
            ok = gen.drain(timeout=remaining()) and ok
        return ok

    # ---------------------------------------------------- observability
    def trace_snapshots(self, limit: Optional[int] = None) -> List[dict]:
        if self._tracer is None:
            return []
        return self._tracer.snapshot(limit=limit)

    def chrome_events(self, t0: Optional[float] = None) -> List[dict]:
        if self._tracer is None:
            return []
        return self._tracer.chrome_events(t0=t0)

    def shutdown(self, wait: bool = True):
        eng, gen = self.engine, self.generation
        if eng is not None:
            eng.shutdown(wait=wait)
        if gen is not None:
            gen.shutdown(wait=wait)


# --------------------------------------------------------------------------
# Transports
# --------------------------------------------------------------------------
class ClusterTransport:
    """How a host's heartbeats reach the directory. One method on
    purpose: membership changes ride :meth:`ClusterDirectory.join` /
    ``leave`` (control actions), heartbeats ride the transport (data)."""

    def publish(self, status: HostStatus):
        raise NotImplementedError


class LoopbackTransport(ClusterTransport):
    """In-process transport: a heartbeat is a direct method call into
    the directory. The whole tier runs single-process on CPU — threads
    as hosts, no sockets, fake-clock testable."""

    def __init__(self, directory: "ClusterDirectory"):
        self.directory = directory

    def publish(self, status: HostStatus):
        self.directory.heartbeat(status)


def _validate_jitter(interval_s: float, jitter: float):
    """Shared guard for the jittered daemon loops (HeartbeatPump,
    ElasticityLoop)."""
    if interval_s <= 0:
        raise ValueError("interval_s must be positive")
    if not (0.0 <= jitter < 1.0):
        raise ValueError(f"jitter must be in [0, 1), got {jitter}")


def _jittered_interval_s(interval_s: float, jitter: float, rng) -> float:
    """``interval_s`` scaled by a seeded draw in
    ``[1 - jitter, 1 + jitter)``. Pure-PRNG (no clock), so schedule
    tests assert the whole sequence without sleeping — and a restarted
    fleet's loops decorrelate instead of thundering-herding the
    coordinator forever (fixed intervals never decorrelate)."""
    if jitter == 0.0:
        return interval_s
    u = float(rng.random())
    return interval_s * (1.0 + jitter * (2.0 * u - 1.0))


class HeartbeatPump:
    """Per-host heartbeat driver: periodically publishes
    ``host.status()`` through the transport. ``pump_once()`` is the
    whole beat — tests call it directly (no sleeps in tier-1);
    :meth:`start` runs it on a daemon thread for real deployments.

    ``jitter`` spreads the beat interval by a seeded ±fraction (default
    ±10%): a fleet restarted by one rollout would otherwise beat in
    lockstep and thundering-herd the coordinator every interval forever
    (fixed intervals never decorrelate — the classic synchronized-
    clients failure). The jitter PRNG is seeded per host (``seed``
    defaults to the host id), so the schedule is deterministic for
    tests yet distinct across hosts."""

    def __init__(self, host: HostHandle, transport: ClusterTransport,
                 interval_s: float = 0.5, jitter: float = 0.1,
                 seed: Optional[int] = None):
        _validate_jitter(interval_s, jitter)
        self.host = host
        self.transport = transport
        self.interval_s = interval_s
        self.jitter = float(jitter)
        self._rng = np.random.default_rng(
            seed if seed is not None else int(host.host_id))
        self.beats = 0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def pump_once(self):
        self.transport.publish(self.host.status())
        self.beats += 1

    def next_interval_s(self) -> float:
        """The next beat's wait — see :func:`_jittered_interval_s`."""
        return _jittered_interval_s(self.interval_s, self.jitter,
                                    self._rng)

    def start(self) -> "HeartbeatPump":
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._loop, daemon=True,
                name=f"cluster-heartbeat[h{self.host.host_id}]")
            self._thread.start()
        return self

    def _loop(self):
        while not self._stop.wait(self.next_interval_s()):
            try:
                self.pump_once()
            except Exception:
                pass   # a failed beat is a missed heartbeat, not a crash

    def stop(self):
        self._stop.set()
        if self._thread is not None and self._thread.is_alive():
            self._thread.join(timeout=2.0)


# --------------------------------------------------------------------------
# The directory: membership + fleet health
# --------------------------------------------------------------------------
class ClusterDirectory:
    """Membership and health view of the fleet — the one
    host-identity and membership layer of the serving tier.

    - :meth:`join` / :meth:`leave` — control-plane membership; host ids
      are the caller's (a process's rank in real deployments). Joining an id again REPLACES the handle (a
      restarted host re-joins) and resets its staleness clock.
    - :meth:`heartbeat` — a host's :class:`HostStatus` lands here (via
      a transport); the directory stamps its own clock so staleness is
      judged on the coordinator's timeline (hosts' clocks never
      compared).
    - staleness / probes: a host not heard from within
      ``heartbeat_timeout_s`` is STALE — :meth:`allow_probe` grants at
      most one probe per ``probe_interval_s`` per stale host, mirroring
      the circuit breaker's HALF_OPEN single-probe discipline at fleet
      scope, so a recovering host is rediscovered without a thundering
      herd and a dead one costs one request per interval.
    - quorum: with fewer than ``quorum`` (default: strict majority of
      joined hosts) alive, :meth:`degraded` reports True and the front
      door's forced sheds say so — the typed degraded mode.

    ``clock`` is injectable (``time.monotonic`` default) so staleness
    tests drive a fake clock instead of sleeping. All state lives under
    ``_hb_lock``; nothing blocking ever runs under it.
    """

    def __init__(self, *, heartbeat_timeout_s: float = 2.0,
                 probe_interval_s: Optional[float] = None,
                 quorum: Optional[int] = None,
                 clock: Callable[[], float] = time.monotonic,
                 recorder=None, timeseries=None):
        if heartbeat_timeout_s <= 0:
            raise ValueError("heartbeat_timeout_s must be positive")
        self.heartbeat_timeout_s = float(heartbeat_timeout_s)
        self.probe_interval_s = (float(probe_interval_s)
                                 if probe_interval_s is not None
                                 else self.heartbeat_timeout_s)
        if self.probe_interval_s <= 0:
            raise ValueError("probe_interval_s must be positive")
        if quorum is not None and quorum < 1:
            raise ValueError("quorum must be >= 1")
        self._quorum = quorum
        self._clock = clock
        self._hb_lock = threading.Lock()
        self._handles: Dict[int, HostHandle] = {}
        self._status: Dict[int, HostStatus] = {}
        self._seen_at: Dict[int, float] = {}
        self._probe_at: Dict[int, float] = {}
        # coordinator-side drain marks: set the INSTANT a drain is
        # initiated (before the host's next heartbeat can carry its own
        # draining flag), so the routing window between drain start and
        # the next beat sheds nothing — the drain protocol's zero-shed
        # guarantee
        self._draining_ids: set = set()
        self._ingest_cursor: Dict[str, int] = {}
        self._front_doors: "weakref.WeakSet" = weakref.WeakSet()
        # fleet-side time-series ring: every heartbeat whose
        # HostStatus carries a sample folds it here — None (default) is
        # bitwise-inert, heartbeats are handled exactly as before
        self.timeseries = timeseries
        self._recorder = recorder if recorder is not None \
            else flight_recorder()
        with _DIRECTORIES_LOCK:
            _DIRECTORIES.add(self)

    # --------------------------------------------------------- membership
    def join(self, handle: HostHandle) -> int:
        hid = int(handle.host_id)
        if hid < 0:
            raise ValueError(f"host_id must be >= 0, got {hid}")
        with self._hb_lock:
            replacing = hid in self._handles
            self._handles[hid] = handle
            # a (re)joined host starts with a fresh staleness clock: it
            # is ALIVE until it misses its first heartbeat window — and
            # with NO retained status: a restarted host's heartbeat seq
            # restarts too, and the out-of-order guard must not reject
            # its fresh beats against the pre-restart counter
            self._seen_at[hid] = self._clock()
            self._status.pop(hid, None)
            self._probe_at.pop(hid, None)
            self._draining_ids.discard(hid)   # a re-join un-drains
        self._recorder.record("cluster.join", host=hid,
                              replaced=replacing)
        return hid

    def leave(self, host_id: int) -> bool:
        with self._hb_lock:
            gone = self._handles.pop(host_id, None)
            self._status.pop(host_id, None)
            self._seen_at.pop(host_id, None)
            self._probe_at.pop(host_id, None)
            self._draining_ids.discard(host_id)
            fds = list(self._front_doors)
        if gone is not None:
            # prefix affinity must not outlive the host: a drained
            # host's pins are released, so a stale _prefix_hosts entry
            # would pin every future submit naming that prefix at a
            # host that no longer exists — a permanent typed shed after
            # a zero-shed scale-down. Dropped entries surface as the
            # explicit KeyError ("not registered — call
            # register_prefix()"), telling the caller to re-register.
            for fd in fds:
                fd._forget_host_prefixes(host_id)
            self._recorder.record("cluster.leave", host=host_id)
        return gone is not None

    def host_ids(self) -> List[int]:
        with self._hb_lock:
            return sorted(self._handles)

    def handle(self, host_id: int) -> Optional[HostHandle]:
        with self._hb_lock:
            return self._handles.get(host_id)

    def __len__(self) -> int:
        with self._hb_lock:
            return len(self._handles)

    # --------------------------------------------------------- heartbeats
    def heartbeat(self, status: HostStatus):
        """Fold one host's status into the view. Unknown host ids are
        tracked too (a host may heartbeat before the coordinator binds
        its handle) — they show in :meth:`api_snapshot` but route no
        traffic until a handle joins."""
        hid = int(status.host_id)
        was_stale = False
        with self._hb_lock:
            prev = self._status.get(hid)
            if prev is not None and status.seq < prev.seq \
                    and self._alive_locked(hid):
                # out-of-order delivery: keep the newer view. Only while
                # the host is ALIVE — once its beats have gone stale, a
                # lower seq means the host restarted (fresh counter), and
                # rejecting it would pin the host dead until the new
                # counter outran the pre-restart one
                return
            was_stale = hid in self._seen_at and not self._alive_locked(hid)
            self._status[hid] = status
            self._seen_at[hid] = self._clock()
            self._probe_at.pop(hid, None)
        if self.timeseries is not None and status.sample is not None:
            # fleet-side fold: the heartbeat carried one sample (wire
            # v2, defaulted — v1 senders never reach here)
            self.timeseries.record(hid, status.sample)
        if was_stale:
            self._recorder.record("cluster.heartbeat_recovered", host=hid)

    # ------------------------------------------------------------- health
    def _alive_locked(self, host_id: int) -> bool:
        seen = self._seen_at.get(host_id)
        return seen is not None and \
            self._clock() - seen < self.heartbeat_timeout_s

    def alive(self, host_id: int) -> bool:
        with self._hb_lock:
            return self._alive_locked(host_id)

    def alive_ids(self) -> List[int]:
        with self._hb_lock:
            return sorted(h for h in self._handles
                          if self._alive_locked(h))

    def stale_ids(self) -> List[int]:
        with self._hb_lock:
            return sorted(h for h in self._handles
                          if not self._alive_locked(h))

    def status(self, host_id: int) -> Optional[HostStatus]:
        with self._hb_lock:
            return self._status.get(host_id)

    def quorum(self) -> int:
        """Hosts that must be alive for the fleet to be healthy: the
        configured value, else a strict majority of joined hosts."""
        with self._hb_lock:
            n = len(self._handles)
        return self._quorum if self._quorum is not None else n // 2 + 1

    def degraded(self) -> bool:
        """True when fewer than :meth:`quorum` hosts are alive — the
        typed degraded mode: stale hosts get probe traffic only, and
        front-door sheds name the quorum loss."""
        with self._hb_lock:
            if not self._handles:
                return False
            alive = sum(1 for h in self._handles if self._alive_locked(h))
        return alive < self.quorum()

    def mark_draining(self, host_id: int) -> bool:
        """Coordinator-side drain mark: routing excludes this host from
        the instant the drain is INITIATED (a heartbeat-only flag would
        leave a shed window until the host's next beat). Cleared by
        :meth:`leave` / a re-:meth:`join`. Returns False for unknown
        ids."""
        with self._hb_lock:
            if host_id not in self._handles:
                return False
            self._draining_ids.add(host_id)
        self._recorder.record("cluster.drain", host=host_id)
        return True

    def is_draining(self, host_id: int) -> bool:
        """True when the coordinator marked the host draining OR its own
        heartbeat says so (either side may learn first)."""
        with self._hb_lock:
            if host_id in self._draining_ids:
                return True
            st = self._status.get(host_id)
        return st is not None and st.draining

    def allow_probe(self, host_id: int) -> bool:
        """One probe per ``probe_interval_s`` per non-alive host — the
        fleet-scope HALF_OPEN. Returns True exactly once per window (the
        caller routes that one request); a fresh heartbeat clears the
        window so a recovered host resumes full traffic immediately."""
        with self._hb_lock:
            if host_id not in self._handles:
                return False
            now = self._clock()
            last = self._probe_at.get(host_id)
            if last is not None and now - last < self.probe_interval_s:
                return False
            self._probe_at[host_id] = now
        self._recorder.record("cluster.probe", host=host_id)
        return True

    # ------------------------------------------------------- front doors
    def _register_front_door(self, fd: "ClusterFrontDoor"):
        with self._hb_lock:
            self._front_doors.add(fd)

    # ----------------------------------------------------------- snapshot
    def api_snapshot(self) -> dict:
        """The fleet view as one JSON-safe payload (the reference UI's
        ``GET /api/cluster``; the elasticity planner's input): per-host
        capacity + health
        (slots, blocks, breaker, SLO, heartbeat age) and the fleet
        roll-up (alive/quorum/degraded, summed capacity, and each front
        door's routed/shed mix)."""
        with self._hb_lock:
            now = self._clock()
            hosts = {}
            for hid in sorted(self._handles):
                st = self._status.get(hid)
                seen = self._seen_at.get(hid)
                hosts[hid] = {
                    "alive": self._alive_locked(hid),
                    "draining": hid in self._draining_ids
                                or (st is not None and st.draining),
                    "heartbeat_age_s": (round(now - seen, 3)
                                        if seen is not None else None),
                    "status": st.to_dict() if st is not None else None,
                }
            # heartbeat-only hosts (handle not bound)
            for hid in sorted(set(self._status) - set(self._handles)):
                st = self._status[hid]
                seen = self._seen_at.get(hid)
                hosts[hid] = {
                    "alive": self._alive_locked(hid), "unbound": True,
                    "heartbeat_age_s": (round(now - seen, 3)
                                        if seen is not None else None),
                    "status": st.to_dict(),
                }
            fds = list(self._front_doors)
        alive = [h for h, d in hosts.items() if d["alive"]]
        statuses = [d["status"] for d in hosts.values()
                    if d["status"] is not None and not d.get("unbound")]
        fleet = {
            "hosts": len([h for h in hosts.values()
                          if not h.get("unbound")]),
            "alive": len(alive),
            "draining": len([h for h in hosts.values()
                             if h.get("draining")]),
            "quorum": self.quorum(),
            "state": "degraded" if self.degraded() else "ok",
            "slots": sum(s["slots"] for s in statuses),
            "free_slots": sum(s["free_slots"] for s in statuses),
            "kv_blocks_total": sum(s["kv_blocks_total"] for s in statuses),
            "kv_blocks_free": sum(s["kv_blocks_free"] for s in statuses),
            # pre-upgrade heartbeats carry no preemption counter: .get
            # keeps a mixed-version fleet's snapshot parsing
            "preemptions_total": sum(int(s.get("preemptions_total", 0))
                                     for s in statuses),
            # swap-to-host occupancy roll-up: pre-upgrade heartbeats
            # (and hosts with no swap store) report 0 via the defaults
            "kv_swapped_blocks": sum(int(s.get("kv_swapped_blocks", 0))
                                     for s in statuses),
            "kv_swap_capacity_blocks": sum(
                int(s.get("kv_swap_capacity_blocks", 0))
                for s in statuses),
            "breakers_open": sum(1 for s in statuses
                                 if s["breaker"] == "OPEN"),
            # disaggregated serving: per-class host counts —
            # pre-upgrade heartbeats carry no host_class and read as
            # mixed, the class that routes exactly as before
            "host_classes": {
                c: sum(1 for s in statuses
                       if s.get("host_class", "mixed") == c)
                for c in ("prefill", "decode", "mixed")},
            # fleet prefix-cache roll-up for cache-aware routing
            "prefix_cache_entries": sum(
                int(s.get("prefix_cache_entries", 0)) for s in statuses),
            "prefix_cache_hits": sum(
                int(s.get("prefix_cache_hits", 0)) for s in statuses),
        }
        return {
            "hosts": {str(h): d for h, d in sorted(hosts.items())},
            "fleet": fleet,
            "front_doors": [{
                "name": fd.name,
                "routed_by_host": fd.routed_by_host.to_dict(),
                "rejections_by_reason":
                    fd.metrics.rejections_by_reason.to_dict(),
                # 'timeout' (stall-triggered backup) vs 'redispatch'
                # (attempt lost to a retriable host failure) — the
                # elasticity planner reads the shed mix next to these
                "hedges": fd.hedges.to_dict(),
            } for fd in fds],
        }


# weak registry: a fleet view fans in over live directories without
# pinning dead ones (same pattern as tracing.all_tracers)
_DIRECTORIES: "weakref.WeakSet[ClusterDirectory]" = weakref.WeakSet()
_DIRECTORIES_LOCK = threading.Lock()


def all_directories() -> List[ClusterDirectory]:
    with _DIRECTORIES_LOCK:
        return list(_DIRECTORIES)


# --------------------------------------------------------------------------
# Hedged re-dispatch: terminal-exactly-once streams over the RPC plane
# --------------------------------------------------------------------------
@dataclasses.dataclass
class HedgePolicy:
    """Tail-tolerance policy for generation streams over the RPC data
    plane (Dean & Barroso, "The Tail at Scale"): when a stream makes no
    progress for ``hedge_after_ms``, the front door opens a BACKUP
    attempt on another candidate host — both race, the first terminal
    wins, the loser is cancelled server-side (its slot and KV blocks
    come back instead of decoding for nobody). ``hedge_after_ms=None``
    disables timeout hedging but keeps re-dispatch on host loss.
    ``max_attempts`` bounds TOTAL attempts per logical stream (first
    dispatch + hedges + re-dispatches), so a request that kills every
    host it lands on cannot walk the whole fleet. ``poll_wait_ms`` is
    the long-poll window per chunk fetch (also the cancellation-notice
    latency bound for loser attempts).

    ``infer_hedge_after_ms`` extends the same stall hedge to BATCH
    INFERENCE submits (``ClusterFrontDoor.submit``): an unresolved
    result after this long opens ONE backup POST on another candidate —
    first result wins, the loser is cancelled server-side, and exactly
    one SLO outcome is recorded for the pair. Default None keeps the
    pre-hedge infer path bitwise untouched (streams hedge by default;
    infer results, unlike token streams, have no progress watermark to
    distinguish slow from stuck, so hedging them is opt-in)."""

    hedge_after_ms: Optional[float] = 250.0
    max_attempts: int = 3
    poll_wait_ms: float = 50.0
    infer_hedge_after_ms: Optional[float] = None

    def __post_init__(self):
        if self.hedge_after_ms is not None and self.hedge_after_ms <= 0:
            raise ValueError("hedge_after_ms must be positive (or None)")
        if self.max_attempts < 1:
            raise ValueError("max_attempts must be >= 1")
        if self.poll_wait_ms <= 0:
            raise ValueError("poll_wait_ms must be positive")
        if self.infer_hedge_after_ms is not None \
                and self.infer_hedge_after_ms <= 0:
            raise ValueError(
                "infer_hedge_after_ms must be positive (or None)")


class _Attempt:
    """One live attempt of a hedged stream on one host. ``tokens``
    accumulates the FULL prefix this attempt has received (streams are
    bitwise-deterministic per seed, so every attempt's prefix agrees) —
    the supervisor's leader pushes ``tokens[delivered:]`` to the client
    handle, which is what makes leadership transfer gap-free and
    duplicate-free by construction.

    A resumed attempt (wire v2: the replacement host seated the stream
    at the delivery watermark) is PRE-SEEDED with the delivered prefix:
    ``base`` is the honored resume point, ``tokens``/``cursor`` start
    there, and the wire cursor the remote long-poll sees is ``cursor -
    base`` (the replacement host's handle holds only tokens past the
    watermark — it recomputed, it did not re-decode)."""

    __slots__ = ("stream", "host_id", "idx", "tokens", "cursor", "base")

    def __init__(self, stream, host_id: int, idx: int,
                 prefix: Optional[List[int]] = None):
        self.stream = stream
        self.host_id = host_id
        self.idx = idx
        self.tokens: List[int] = list(prefix) if prefix else []
        self.cursor = len(self.tokens)
        self.base = len(self.tokens)


class _HedgedStream:
    """Supervisor for ONE logical generation stream dispatched over the
    RPC data plane, with hedged re-dispatch and terminal-exactly-once
    semantics. The caller holds a single client
    :class:`~deeplearning4j_tpu_torch.serving.generation.GenerationHandle`;
    underneath it, attempts come and go:

    - each attempt runs in its own thread (route → ``open_stream`` →
      chunk long-poll loop), so a latency spike in one attempt's
      dispatch or stream never blocks another attempt's progress;
    - an attempt lost to the HEDGE_RETRIABLE class (host died, wire
      garbage, remote engine shutdown/watchdog) is folded out
      (``cluster.bounce`` in the trace) and replaced — re-dispatch
      excludes every host already tried, recomputes the REMAINING
      deadline budget, and replays the same seeded request, so the
      stream's tokens are bitwise those the first host would have
      produced;
    - a monitor thread opens a backup attempt when no token progress is
      made for ``hedge_after_ms`` (the classic tail hedge) — first
      terminal wins, losers are cancelled server-side;
    - token delivery is deduplicated by a single ``delivered``
      watermark: the LEADER attempt pushes ``tokens[delivered:]``, and
      leadership transfers only at loss/terminal, so no token is
      delivered twice and none is skipped;
    - exactly ONE terminal reaches the handle (first ``finished`` flip
      wins under the lock), and the front door records exactly one SLO
      outcome for the whole hedged ensemble."""

    HEDGE_RETRIABLE = ("host_unavailable", "rpc_error", "shutdown",
                       "watchdog")

    def __init__(self, fd: "ClusterFrontDoor", toks: np.ndarray, *,
                 gen_kwargs: dict, pinned: Optional[int],
                 blocks_hint_max_new: int, timeout_ms: Optional[float],
                 trace, tenant_label: str, t0: float):
        from deeplearning4j_tpu_torch.serving.generation import (
            client_stream_handle)

        self.fd = fd
        self.toks = toks
        self.gen_kwargs = gen_kwargs       # forwarded to open_stream
        self.pinned = pinned
        self.max_new = blocks_hint_max_new
        self.trace = trace
        self.tenant = tenant_label
        self.t0 = t0
        self.deadline_t = None if timeout_ms is None \
            else t0 + timeout_ms / 1e3
        on_token = gen_kwargs.pop("on_token", None)
        self.handle = client_stream_handle(int(toks.size),
                                           on_token=on_token,
                                           tenant=tenant_label)
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        self.delivered = 0
        self.finished = False
        self.attempts: List[_Attempt] = []
        #: hosts with a dispatch POST currently in flight — an attempt
        #: is invisible to `attempts` until open_stream returns, so
        #: routing and the no-route shed must read this too: a backup
        #: must not re-pick the very host whose dispatch is stalling,
        #: and a failed backup route must not shed a terminal while the
        #: original dispatch may still succeed
        self.inflight: List[int] = []
        self._leader: Optional[_Attempt] = None
        self.tried: List[int] = []
        self.bounced_full = 0
        self.attempt_seq = 0
        self.last_error: Optional[BaseException] = None
        self.last_progress = time.perf_counter()

    # ------------------------------------------------------------ lifecycle
    def start(self, first_route):
        """Launch the first attempt (on the route the front door already
        picked) plus the hedge monitor; returns the client handle."""
        idx = self._claim_attempt()
        t = threading.Thread(
            target=self._run_attempt, args=(idx, first_route),
            daemon=True, name=f"fd-stream[{self.fd.name}]#a{idx}")
        t.start()
        threading.Thread(
            target=self._monitor, daemon=True,
            name=f"fd-stream-monitor[{self.fd.name}]").start()
        return self.handle

    def _claim_attempt(self) -> Optional[int]:
        with self._lock:
            if self.attempt_seq >= self.fd.hedge.max_attempts:
                return None
            self.attempt_seq += 1
            return self.attempt_seq

    def _is_finished(self) -> bool:
        with self._lock:
            return self.finished

    def _remaining_ms(self) -> Optional[float]:
        return None if self.deadline_t is None \
            else (self.deadline_t - time.perf_counter()) * 1e3

    # -------------------------------------------------------------- attempts
    def _run_attempt(self, idx: Optional[int], route=None):
        """One attempt thread: route (unless handed one) → open →
        poll-and-deliver. On a retriable loss, the SAME thread
        re-dispatches when it was the last live attempt (claiming a
        fresh attempt slot); otherwise it exits and the survivors carry
        the stream."""
        while idx is not None and not self._is_finished():
            if route is None:
                with self._lock:
                    exclude = tuple(self.tried) + tuple(
                        a.host_id for a in self.attempts) \
                        + tuple(self.inflight)
                    bounced = self.bounced_full
                try:
                    route = self.fd._route(
                        "generate", rows=1,
                        blocks_needed=self.fd._blocks_needed(
                            int(self.toks.size), self.max_new,
                            self.pinned),
                        blocks_admit=self.fd._blocks_needed(
                            int(self.toks.size), 1, self.pinned),
                        pinned=self.pinned, exclude=exclude,
                        bounced_full=bounced)
                except RejectedError as e:
                    if self.last_error is not None \
                            and e.__cause__ is None:
                        e.__cause__ = self.last_error
                    self._no_route(e)
                    return
            h, hid, how = route
            route = None
            if not hasattr(h, "open_stream"):
                # mixed fleet: a re-dispatch can route to a LOOPBACK
                # host, which has no attempt-scoped stream surface (the
                # supervisor already owns the caller's handle and
                # cannot adopt an engine-owned one) — fold it out like
                # a bounced candidate and try the next; an
                # AttributeError here would kill the attempt thread and
                # hang the caller forever
                with self._lock:
                    self.tried.append(hid)
                self.trace.event("cluster.bounce", host=hid,
                                 reason="host_unavailable", attempt=idx,
                                 detail="no rpc stream surface")
                continue
            self.trace.event("cluster.route", host=hid, decision=how,
                             kind="generate", attempt=idx)
            with self._lock:
                self.inflight.append(hid)
                # resume-from-watermark (wire v2): ship the delivered
                # prefix so the replacement host runs ONE recompute
                # prefill and continues from the exact next token
                # instead of re-decoding the whole stream. The handle
                # holds exactly the delivered tokens (pushed under this
                # lock), so the snapshot IS the watermark. A finished
                # budget (every token delivered, terminal chunk lost)
                # replays instead — resume_step == max_new would be
                # nothing-to-resume.
                resume = list(self.handle.tokens_so_far())
            if not resume or len(resume) >= self.max_new:
                resume = None
            rkw = {} if resume is None else {
                "resume_tokens": resume, "resume_step": len(resume)}
            # wire-v3 trace context: each attempt (first dispatch,
            # hedge, re-dispatch) is a labeled child span of the
            # front-door root — attempt index in the parent-span label
            # so the stitched view tells a resume leg from a hedge leg
            if self.trace.trace_id is not None:
                rkw["trace_link"] = self.trace.trace_id
                rkw["trace_parent"] = (
                    f"attempt{idx}" if resume is None
                    else f"attempt{idx}:resume@{len(resume)}")
            try:
                stream = h.open_stream(
                    self.toks, timeout_ms=self._remaining_ms(),
                    hedge_attempt=idx, **rkw, **self.gen_kwargs)
            except RejectedError as e:
                with self._lock:
                    self.inflight.remove(hid)
                    self.tried.append(hid)
                    if e.reason in ClusterFrontDoor.CAPACITY_BOUNCE_REASONS:
                        self.bounced_full += 1
                    self.last_error = e
                self.trace.event("cluster.bounce", host=hid,
                                 reason=e.reason, attempt=idx)
                continue     # next candidate, same attempt slot
            honored = int(getattr(stream, "resume_step", 0) or 0)
            if resume is not None and honored == len(resume):
                # v2 peer seated the stream at the watermark: pre-seed
                # the attempt so its cursor space starts there and zero
                # already-delivered tokens cross the wire again
                a = _Attempt(stream, hid, idx, prefix=resume)
                self.fd.metrics.stream_resumes_total.inc()
                self.trace.event("stream.resume", host=hid, attempt=idx,
                                 resume_step=honored)
            else:
                # v1 peer (echo 0) or partial honor: full replay from
                # token 0 — the delivered watermark dedups the replayed
                # prefix exactly as before wire v2
                a = _Attempt(stream, hid, idx)
            late = False
            with self._lock:
                self.inflight.remove(hid)
                if self.finished:
                    late = True
                else:
                    self.attempts.append(a)
                    self.last_progress = time.perf_counter()
                    self._cv.notify_all()
            if late:
                stream.cancel()   # raced the terminal: free the slot
                return
            self.fd.routed_by_host.inc(f"h{hid}")
            self.fd._out_add("generate", hid, 1)
            self.trace.event("rpc.dispatch", host=hid,
                             stream_id=stream.stream_id, attempt=idx)
            loss = self._poll_attempt(a)
            self.fd._out_add("generate", hid, -1)
            if loss is None:
                return           # terminal delivered (by someone)
            with self._lock:
                if a in self.attempts:
                    self.attempts.remove(a)
                if self._leader is a:
                    self._leader = None
                self.tried.append(hid)
                self.last_error = loss
                others = bool(self.attempts)
                done = self.finished
            self.trace.event("cluster.bounce", host=hid,
                             reason=getattr(loss, "reason", "model_error"),
                             attempt=idx)
            a.stream.cancel()
            if done or others:
                return           # survivors own the stream (a loss
                #                  racing the winner's terminal is NOT
                #                  a re-dispatch — don't count one)
            idx = self._claim_attempt()
            if idx is not None:
                self.fd.hedges.inc("redispatch")
            if idx is None:
                exc = HostUnavailableError(
                    f"stream lost after "
                    f"{self.fd.hedge.max_attempts} attempt(s); hedge "
                    f"budget exhausted", host=self.pinned)
                exc.__cause__ = loss
                self._shed_once(exc)
                return
        # claim failed before the first dispatch of this thread: the
        # monitor raced the budget away — survivors own the stream

    def _no_route(self, exc: RejectedError):
        """Routing found no candidate for a (re)dispatch: terminal shed
        only when no live attempt remains AND no dispatch is still in
        flight — otherwise the survivors (or the pending dispatch) may
        still finish and this was just a failed hedge."""
        with self._lock:
            live = bool(self.attempts) or bool(self.inflight)
        if not live:
            self._shed_once(exc)

    def _poll_attempt(self, a: _Attempt) -> Optional[BaseException]:
        """Drive one attempt's chunk loop. Returns the loss exception
        when the attempt should be folded out and possibly replaced;
        None when a terminal was delivered (any attempt's) or the
        supervisor finished."""
        while True:
            if self._is_finished():
                return None
            try:
                # wire cursor is attempt-local: a resumed attempt's
                # server never held the pre-watermark tokens
                chunk = a.stream.poll(a.cursor - a.base,
                                      self.fd.hedge.poll_wait_ms)
            except RejectedError as e:
                if getattr(e, "reason", None) in self.HEDGE_RETRIABLE:
                    return e
                self._finish_failed(e)
                return None
            if not self._deliver(a, chunk, promote=chunk.done
                                 and not chunk.error_reason):
                return None      # broken local consumer: terminal done
            if chunk.done:
                if chunk.error_reason in self.HEDGE_RETRIABLE:
                    from deeplearning4j_tpu_torch.serving.rpc import (
                        rejected_from_wire)
                    return rejected_from_wire(
                        chunk.error_reason, chunk.error_message,
                        host=a.host_id)
                if chunk.error_reason is not None:
                    from deeplearning4j_tpu_torch.serving.rpc import (
                        rejected_from_wire)
                    self._finish_failed(rejected_from_wire(
                        chunk.error_reason, chunk.error_message,
                        host=a.host_id))
                else:
                    self._finish_ok(a, chunk.finish_reason or "max_tokens")
                return None

    # ------------------------------------------------- delivery + terminals
    def _deliver(self, a: _Attempt, chunk, promote: bool = False) -> bool:
        """Fold one chunk into the attempt's accumulated prefix and, for
        the LEADER, push the undelivered tail to the client handle.
        ``promote`` forces leadership (a successful terminal's attempt
        must flush its full prefix before finishing). Returns False
        when the client's own on_token consumer broke the stream.

        The pushes happen UNDER the supervisor lock, atomically with
        the watermark advance: claiming ``delivered`` first and pushing
        after would open a window where another attempt's terminal
        (``_take_terminal`` needs this lock) finishes the handle while
        the claimed tokens are still un-pushed — ``result()`` would
        snapshot a truncated stream. A slow ``on_token`` consumer
        therefore stalls only its own stream's supervisor, exactly like
        the local engine path, where the callback runs on the scheduler
        thread."""
        toks = [int(t) for t in chunk.tokens]
        broken: Optional[BaseException] = None
        with self._lock:
            if self.finished or a not in self.attempts:
                return True
            a.tokens.extend(toks)
            a.cursor = len(a.tokens)
            if promote or self._leader is None \
                    or self._leader not in self.attempts \
                    or len(a.tokens) > self.delivered:
                # the last arm is the stalled-leader handoff: attempts
                # share a bitwise-identical prefix, so whichever one is
                # PAST the delivered watermark may lead — a backup that
                # out-runs a stalled-but-alive leader starts streaming
                # to the client immediately instead of withholding its
                # tokens until its terminal flush (the TTFT tail the
                # hedge exists to collapse); ping-ponging is harmless,
                # the watermark dedups
                self._leader = a
            if self._leader is a:
                while self.delivered < len(a.tokens):
                    err = self.handle._push(a.tokens[self.delivered])
                    if err is not None:
                        broken = err
                        break
                    self.delivered += 1
            if toks:
                self.last_progress = time.perf_counter()
                self._cv.notify_all()
        if broken is not None:
            # the handle already delivered its own terminal (_fail
            # inside _push): record the one outcome + stop the fleet
            self.trace.event("on_token.failed",
                             error=type(broken).__name__)
            self._finish_client_error()
            return False
        return True

    def _take_terminal(self) -> Optional[List[_Attempt]]:
        """First caller wins the terminal: returns the loser attempts to
        cancel (None for everyone after the first)."""
        with self._lock:
            if self.finished:
                return None
            self.finished = True
            losers = list(self.attempts)
            self.attempts = []
            self._cv.notify_all()
        return losers

    def _cancel_losers(self, losers: List[_Attempt]):
        for a in losers:
            a.stream.cancel()

    def _finish_ok(self, winner: _Attempt, finish_reason: str):
        losers = self._take_terminal()
        if losers is None:
            return
        delivered = self.handle._finish(finish_reason)
        lat = (time.perf_counter() - self.t0) * 1e3
        if delivered:
            self.fd._finish_request(self.trace, "ok", lat, self.tenant)
        else:   # the caller cancelled first: that terminal stands
            self.fd._finish_request(self.trace, "cancelled", lat, self.tenant)
        self._cancel_losers([a for a in losers if a is not winner])

    def _finish_failed(self, exc: BaseException):
        losers = self._take_terminal()
        if losers is None:
            return
        reason = terminal_reason(exc)
        delivered = self.handle._fail(exc)
        lat = (time.perf_counter() - self.t0) * 1e3
        self.fd._finish_request(self.trace, reason if delivered else "cancelled",
                        lat, self.tenant)
        self._cancel_losers(losers)

    def _finish_client_error(self):
        losers = self._take_terminal()
        if losers is None:
            return
        lat = (time.perf_counter() - self.t0) * 1e3
        self.fd._finish_request(self.trace, "client_error", lat, self.tenant)
        self._cancel_losers(losers)

    def _shed_once(self, exc: RejectedError):
        """Typed fleet shed, exactly once — the hedged analogue of the
        front door's synchronous ``_shed`` (same counters, same trace
        shape), delivered through the client handle because dispatch
        already went asynchronous."""
        losers = self._take_terminal()
        if losers is None:
            return
        self.fd.metrics.rejected_total.inc()
        self.fd.metrics.record_rejection(exc.reason)
        self.fd._recorder.record("cluster.shed", reason=exc.reason,
                                 front_door=self.fd.name)
        self.trace.event("cluster.shed", reason=exc.reason)
        delivered = self.handle._fail(exc)
        self.fd._finish_request(self.trace,
                        exc.reason if delivered else "cancelled",
                        None, self.tenant)
        self._cancel_losers(losers)

    # --------------------------------------------------------------- hedging
    def _monitor(self):
        """Open a backup attempt when the stream stalls (no token
        progress for ``hedge_after_ms``). Decisions are made under the
        cv; the spawn itself (routing + thread start) runs outside it."""
        hed = self.fd.hedge
        if hed.hedge_after_ms is None or self.pinned is not None:
            return    # timeout hedging off (or nowhere else to go)
        wait_s = hed.hedge_after_ms / 1e3
        while True:
            spawn_idx = None
            with self._cv:
                if self.finished:
                    return
                elapsed = time.perf_counter() - self.last_progress
                if elapsed < wait_s:
                    self._cv.wait(wait_s - elapsed)
                    continue
                if len(self.attempts) <= 1 \
                        and self.attempt_seq < hed.max_attempts:
                    # <= 1: a stalled DISPATCH (attempt thread stuck in
                    # routing/open_stream, so nothing is live yet) is
                    # hedged exactly like a stalled stream — the spiked
                    # POST and the backup race, first terminal wins
                    self.attempt_seq += 1
                    spawn_idx = self.attempt_seq
                    self.last_progress = time.perf_counter()
                else:
                    # nothing to hedge right now (two attempts already
                    # racing, or the attempt budget is spent): check
                    # again next window
                    self._cv.wait(wait_s)
                    continue
            self.fd.hedges.inc("timeout")
            self.trace.event("cluster.hedge", attempt=spawn_idx,
                             stalled_ms=round(elapsed * 1e3, 1))
            threading.Thread(
                target=self._run_attempt, args=(spawn_idx, None),
                daemon=True,
                name=f"fd-stream[{self.fd.name}]#a{spawn_idx}").start()


class _HedgedInfer:
    """Supervisor for ONE hedged batch-inference request — the infer
    analogue of :class:`_HedgedStream`, deliberately smaller (a result
    has no token watermark, so there is no leadership or resume: just
    first-result-wins over at most one primary + one backup). The
    caller holds a PROXY Future; underneath it:

    - the primary attempt is the synchronous dispatch ``submit`` already
      made; a monitor opens one backup POST on another candidate when
      the result is still unresolved after ``infer_hedge_after_ms``
      (budget-aware: no backup once the deadline is spent);
    - the first SUCCESS claims the terminal under the supervisor lock
      (the ``_take_terminal`` discipline), resolves the proxy, records
      exactly ONE front-door SLO outcome, and cancels the loser
      server-side (``Future.cancel_remote`` — the RPC ``/cancel``
      endpoint — plus the local ``Future.cancel`` for a still-queued
      loopback op);
    - a FAILURE is adopted only when it is the last outstanding attempt
      and no dispatch is in flight — a failed primary does not mask a
      backup that may still win, and vice versa."""

    def __init__(self, fd: "ClusterFrontDoor", arr, rows: int, *,
                 timeout_ms: Optional[float], tenant, priority,
                 label: str, trace, t0: float, tried: List[int]):
        self.fd = fd
        self.arr = arr
        self.rows = rows
        self.timeout_ms = timeout_ms
        self.tenant = tenant
        self.priority = priority
        self.label = label
        self.trace = trace
        self.t0 = t0
        self.proxy: Future = Future()
        self.proxy.set_running_or_notify_cancel()
        self._lock = threading.Lock()
        self._done_evt = threading.Event()
        self.finished = False
        self.outstanding: Dict[int, Future] = {}
        self.inflight = 0          # backup dispatch POST in progress
        self.tried: List[int] = list(tried)
        self.last_error: Optional[BaseException] = None

    def start(self, hid: int, fut: Future) -> Future:
        """Adopt the already-dispatched primary, arm the stall monitor,
        return the proxy the caller resolves against."""
        self._adopt(hid, fut)
        threading.Thread(
            target=self._monitor, daemon=True,
            name=f"fd-infer-hedge[{self.fd.name}]").start()
        return self.proxy

    def _adopt(self, hid: int, fut: Future):
        with self._lock:
            self.outstanding[hid] = fut
            if hid not in self.tried:
                self.tried.append(hid)
        fut.add_done_callback(lambda f, h=hid: self._attempt_done(h, f))

    def _remaining_ms(self) -> Optional[float]:
        return None if self.timeout_ms is None else \
            self.timeout_ms - (time.perf_counter() - self.t0) * 1e3

    # ------------------------------------------------------------ terminal
    def _claim(self) -> Optional[List[Future]]:
        """First caller wins; returns the loser futures to cancel."""
        with self._lock:
            if self.finished:
                return None
            self.finished = True
            losers = list(self.outstanding.values())
            self.outstanding.clear()
        self._done_evt.set()
        return losers

    def _cancel_losers(self, losers: List[Future]):
        for f in losers:
            f.cancel()
            cancel_remote = getattr(f, "cancel_remote", None)
            if cancel_remote is not None:
                cancel_remote()   # best-effort: the op (queued or
                #                   running) is dropped server-side

    def _attempt_done(self, hid: int, fut: Future):
        self.fd._out_add("infer", hid, -self.rows)
        try:
            exc = fut.exception()
        except BaseException as e:   # cancelled loser: nothing to adopt
            exc = e
        if exc is None:
            losers = self._claim()
            if losers is None:
                return               # late loser: terminal already out
            # the claim above is
            # the hedged ensemble's single winner gate
            self.proxy.set_result(fut.result())
            self.fd._finish_request(
                self.trace, "ok", (time.perf_counter() - self.t0) * 1e3,
                self.label)
            self._cancel_losers([f for f in losers if f is not fut])
            return
        with self._lock:
            self.outstanding.pop(hid, None)
            if not fut.cancelled():
                self.last_error = exc
            survivors = bool(self.outstanding) or self.inflight > 0
            if fut.cancelled():
                # our own loser cleanup resolving: never a terminal
                return
        if survivors:
            self.trace.event("cluster.bounce", host=hid,
                             reason=terminal_reason(exc), kind="infer")
            return
        losers = self._claim()
        if losers is None:
            return
        # single loser-less
        # failure terminal for the whole ensemble
        self.proxy.set_exception(exc)
        self.fd._finish_request(
            self.trace, terminal_reason(exc),
            (time.perf_counter() - self.t0) * 1e3, self.label)

    # ------------------------------------------------------------- hedging
    def _monitor(self):
        hed = self.fd.hedge
        wait_s = hed.infer_hedge_after_ms / 1e3
        self._done_evt.wait(wait_s)
        with self._lock:
            if self.finished or not self.outstanding:
                return      # resolved (or failed) before the stall bar
            if len(self.tried) >= min(2, hed.max_attempts):
                return
            self.inflight += 1
            exclude = tuple(self.tried)
        remaining = self._remaining_ms()
        if remaining is not None and remaining <= 0:
            with self._lock:
                self.inflight -= 1
            return          # no budget left to hedge with
        backup = None
        try:
            h, hid, how = self.fd._route("infer", rows=self.rows,
                                         exclude=exclude)
            self.trace.event("cluster.route", host=hid, decision=how,
                             kind="infer", hedged=True)
            tkw = {} if self.trace.trace_id is None else {
                "trace_link": self.trace.trace_id,
                "trace_parent": "hedge"}
            backup = (hid, h.submit_infer(
                self.arr, timeout_ms=remaining, tenant=self.tenant,
                priority=self.priority, **tkw))
        except RejectedError as e:
            self.trace.event("cluster.hedge", kind="infer",
                             failed=getattr(e, "reason", "rpc_error"))
        finally:
            with self._lock:
                self.inflight -= 1
                dead = not self.outstanding and self.last_error is not None
        if backup is None:
            if dead:
                # the primary failed while this dispatch was deciding:
                # adopt its error now that no backup is coming
                losers = self._claim()
                if losers is not None:
                    exc = self.last_error
                    # same single
                    # failure gate as _attempt_done's loser-less arm
                    self.proxy.set_exception(exc)
                    self.fd._finish_request(
                        self.trace, terminal_reason(exc),
                        (time.perf_counter() - self.t0) * 1e3, self.label)
            return
        hid, fut = backup
        self.fd.hedges.inc("timeout")
        self.fd.routed_by_host.inc(f"h{hid}")
        self.fd._out_add("infer", hid, self.rows)
        self.trace.event("cluster.hedge", kind="infer", host=hid)
        late = False
        with self._lock:
            if self.finished:
                late = True
        if late:
            fut.cancel()
            cancel_remote = getattr(fut, "cancel_remote", None)
            if cancel_remote is not None:
                cancel_remote()
            self.fd._out_add("infer", hid, -self.rows)
            return
        self._adopt(hid, fut)


# --------------------------------------------------------------------------
# The front door: cross-host routing with typed fleet shedding
# --------------------------------------------------------------------------
class ClusterFrontDoor:
    """N hosts, one engine surface. ``submit``/``output`` mirror
    :class:`~deeplearning4j_tpu_torch.serving.engine.InferenceEngine`,
    ``submit_generate``/``register_prefix`` mirror
    :class:`~deeplearning4j_tpu_torch.serving.generation.GenerationEngine` —
    same keywords (``tenant=``, ``priority=``, ``prefix_id=``), plus an
    optional ``host=`` pin.

    Routing (per request, against the latest heartbeat view):

    1. candidates = joined hosts serving the request kind. ALIVE hosts
       with a non-OPEN breaker and admission headroom compete on load —
       batch inference by padding-aware queue depth (the request's rows
       round up to the host's bucket rung before comparing), generation
       by free slots then free KV blocks (a host whose usable blocks
       can never hold the stream is no candidate at all).
    2. hosts that are STALE or breaker-OPEN are the probe set: one
       request per :attr:`ClusterDirectory.probe_interval_s` each
       (fleet-scope HALF_OPEN) — so an OPEN breaker drains the host's
       traffic share fleet-wide while its own HALF_OPEN cycle still
       gets the probe it needs to close again.
    3. nobody routable: alive-but-full fleet sheds typed
       ``cluster_capacity``; no live host at all (or a pinned host
       dead/stale past its probe allowance) sheds typed
       ``host_unavailable`` — quorum-degraded sheds say so.

    The heartbeat view is eventually consistent by design, so a routed
    submit can still bounce off the host's own admission (queue filled
    since the last beat): the front door retries the remaining
    candidates once each before shedding — per-host accounting folded
    into admission, not duplicated above it. Every routed request
    carries a front-door trace (``cluster.route`` event naming the host
    and decision) and lands a front-door SLO outcome at its terminal;
    generation streams are sticky to their admitting host, and
    ``prefix_id`` affinity pins follow-ups to the host holding the
    prefix blocks."""

    def __init__(self, directory: ClusterDirectory, *,
                 metrics: Optional[ServingMetrics] = None,
                 tracer=None, recorder=None, name: str = "cluster",
                 hedge: Optional[HedgePolicy] = None, disagg=None):
        self.directory = directory
        self.name = name
        self.metrics = metrics or ServingMetrics()
        self._tracer = tracer if tracer is not None else default_tracer()
        self._recorder = recorder if recorder is not None \
            else flight_recorder()
        # tail-tolerance policy for streams over the RPC data plane
        # (hosts with an open_stream surface — RemoteHost); loopback
        # streams keep the sticky direct path
        self.hedge = hedge if hedge is not None else HedgePolicy()
        # disaggregated prefill/decode placement (serving/disagg.py's
        # DisaggPolicy). None, the default, leaves every request on the
        # single-host path below; a policy engages only while the fleet
        # has prefill- AND decode-class hosts
        self.disagg = disagg
        self.routed_by_host = ReasonCounter("routed_by_host")
        self.hedges = ReasonCounter("hedges")   # 'timeout' | 'redispatch'
        self._affinity_lock = threading.Lock()
        self._prefix_hosts: Dict[str, int] = {}
        # this front door's own in-flight work per (kind, host), in the
        # kind's cost unit (rows / streams). Heartbeats are eventually
        # consistent — between two beats every submit would otherwise see
        # the same depths and pile onto one host; adding our own
        # outstanding dispatches to the load key keeps routing balanced
        # on the front door's own timeline (least-outstanding, the ORCA
        # scheduler's view lifted to fleet scope).
        self._outstanding: Dict[Tuple[str, int], int] = {}
        directory._register_front_door(self)

    def _out_add(self, kind: str, host_id: int, n: int):
        with self._affinity_lock:
            k = (kind, host_id)
            c = self._outstanding.get(k, 0) + n
            if c > 0:
                self._outstanding[k] = c
            else:
                self._outstanding.pop(k, None)

    def _out(self, kind: str, host_id: int) -> int:
        with self._affinity_lock:
            return self._outstanding.get((kind, host_id), 0)

    def outstanding_total(self) -> int:
        """This front door's own in-flight dispatches across every
        (kind, host) — the zero-leak ledger's stuck-dispatch dimension
        (serving/ledger.py): a chaos episode that strands a hedged
        attempt shows up here as a count that never returns to its
        baseline."""
        with self._affinity_lock:
            return sum(self._outstanding.values())

    # ------------------------------------------------------------ routing
    def _headroom(self, st: HostStatus, kind: str, rows: int,
                  blocks_needed: int,
                  blocks_admit: Optional[int] = None,
                  blocks_migrate: Optional[int] = None) -> bool:
        if kind == "infer":
            return st.queue_depth + rows <= st.queue_capacity
        # a decode host that takes migrated pages seats the stream on its
        # post-migration block count (the prefill host already paid the
        # prompt; the resume token rides inside the generation budget),
        # never on the larger re-prefill count
        bound = blocks_needed if blocks_migrate is None \
            else min(blocks_needed, blocks_migrate)
        if st.kv_blocks_total and bound > st.kv_blocks_usable:
            return False   # this host can NEVER hold the stream (the
            #                 worst case bounds every allocate mode)
        # the demand SEATING pays: an on-demand host takes only the
        # prompt's blocks up front (the generation tail allocates per
        # boundary crossing, preempting when dry), so its free-block
        # headroom is judged on the admit demand
        demand = blocks_admit if (blocks_admit is not None
                                  and st.allocate == "on_demand") \
            else bound
        if st.free_slots > 0 and (not st.kv_blocks_total
                                  or demand <= st.kv_blocks_free):
            return True    # seats immediately
        # no free seat (or blocks currently held by live streams): the
        # request can still queue — retirements free both
        return st.gen_queue_depth + 1 <= st.gen_queue_capacity

    def _load_key(self, st: HostStatus, kind: str, rows: int,
                  blocks_needed: int) -> tuple:
        out = self._out(kind, st.host_id)
        if kind == "infer":
            # padding-aware depth: the request costs its bucket rung on
            # this host, so a near-rung-boundary fleet routes to the
            # host where the padded batch is cheapest; our own
            # outstanding rows ride on top of the heartbeat depth
            rung = rows
            for b in st.buckets:
                if b >= rows:
                    rung = b
                    break
            cap = max(st.queue_capacity, 1)
            return ((st.queue_depth + out + rung) / cap,
                    st.queue_depth + out, st.host_id)
        return (-(st.free_slots - out), st.gen_queue_depth + out,
                -st.kv_blocks_free, st.host_id)

    #: host-side rejection reasons that mean "out of capacity" rather
    #: than "gone": a candidate that bounced one of these counts as a
    #: FULL host when the route exhausts, so the final shed types as
    #: cluster_capacity (add capacity) not host_unavailable (fix hosts)
    CAPACITY_BOUNCE_REASONS = ("queue_full", "kv_blocks_exhausted")

    def _route(self, kind: str, *, rows: int = 1, blocks_needed: int = 0,
               blocks_admit: Optional[int] = None,
               blocks_migrate: Optional[int] = None,
               pinned: Optional[int] = None,
               exclude: Tuple[int, ...] = (), bounced_full: int = 0):
        """Pick (handle, host_id, decision) or raise typed. Pure reader
        of the directory view except for the probe grant. ``exclude``
        names hosts that already bounced this request, ``bounced_full``
        how many of those bounced for capacity (heartbeat lag: the view
        said headroom, the host's own admission said full).
        ``blocks_admit`` is the prompt-only seat demand an on-demand
        host gates on (None: judge every host on ``blocks_needed``).
        ``blocks_migrate`` is the post-migration seat demand of a stream
        that arrives as migrated KV pages: a host is judged on the smaller
        of the two bounds."""
        d = self.directory
        ranked: List[Tuple[tuple, int, HostHandle]] = []
        probe_set: List[Tuple[int, HostHandle]] = []
        full = 0
        for hid in d.host_ids():
            if hid in exclude or (pinned is not None and hid != pinned):
                continue
            h = d.handle(hid)
            if h is None or not h.serves(kind):
                continue
            if d.is_draining(hid):
                # graceful drain: resident streams finish, nothing new
                # routes here — NOT a probe candidate (the host is
                # healthy, it is leaving) and NOT a "full" host (its
                # absence must not convert sheds to cluster_capacity)
                continue
            st = d.status(hid)
            if st is None or not d.alive(hid):
                probe_set.append((hid, h))       # never/stale heartbeat
                continue
            if st.breaker == "OPEN":
                probe_set.append((hid, h))       # drained fleet-wide
                continue
            if not self._headroom(st, kind, rows, blocks_needed,
                                  blocks_admit, blocks_migrate):
                full += 1
                continue
            ranked.append((self._load_key(st, kind, rows, blocks_needed),
                           hid, h))
        if ranked:
            ranked.sort(key=lambda t: t[0])
            _, hid, h = ranked[0]
            return h, hid, "least_loaded"
        for hid, h in probe_set:
            if d.allow_probe(hid):
                return h, hid, "probe"
        degraded = d.degraded()
        full += bounced_full
        if full and pinned is None:
            raise ClusterCapacityError(
                f"cluster has no {kind} capacity: {full} host(s) alive "
                f"but full, {len(probe_set)} probe-only"
                + (" (fleet quorum-degraded)" if degraded else ""),
                hosts=len(d), alive=len(d.alive_ids()))
        if pinned is not None:
            raise HostUnavailableError(
                f"host {pinned} is unavailable for {kind} traffic "
                f"(dead, stale past its probe allowance, full, or never "
                f"joined)" + (" — fleet quorum-degraded" if degraded
                              else ""), host=pinned)
        raise HostUnavailableError(
            f"no host available for {kind} traffic: "
            f"{len(probe_set)} host(s) stale/drained with probe "
            f"allowances spent"
            + (" — fleet quorum-degraded "
               f"({len(d.alive_ids())}/{len(d)} alive, quorum "
               f"{d.quorum()})" if degraded else ""), host=None)

    # ------------------------------------------------------- accounting
    def _shed(self, trace, exc: RejectedError, tenant: str):
        self.metrics.rejected_total.inc()
        self.metrics.record_rejection(exc.reason)
        self._recorder.record("cluster.shed", reason=exc.reason,
                              front_door=self.name)
        trace.event("cluster.shed", reason=exc.reason)
        self._finish_request(trace, exc.reason, None, tenant)

    def _finish_request(self, trace, reason: str, latency_ms: Optional[float],
                tenant: str):
        self.metrics.record_outcome(reason, latency_ms)
        self.metrics.record_tenant_outcome(tenant, reason)
        trace.finish(reason, latency_ms=latency_ms)

    def _watch_future(self, fut, trace, t0: float, tenant: str,
                      kind: str, host_id: int, cost: int):
        def done(f):
            self._out_add(kind, host_id, -cost)
            exc = f.exception()
            reason = "ok" if exc is None else terminal_reason(exc)
            self._finish_request(trace, reason,
                         (time.perf_counter() - t0) * 1e3, tenant)
        fut.add_done_callback(done)

    @staticmethod
    def _label(tenant: Optional[str], priority: Optional[str]) -> str:
        """Front-door accounting label. Tenant/priority pass through to
        the routed host UNRESOLVED — the host's own QosPolicy decides
        defaults and escalation rules; resolving here against no policy
        would stamp ``interactive`` on a tenant the host configures as
        ``batch`` and trip its anti-escalation guard."""
        if priority is not None and priority not in PRIORITIES:
            raise ValueError(
                f"priority must be one of {PRIORITIES}, got {priority!r}")
        return DEFAULT_TENANT if tenant is None else str(tenant)

    # --------------------------------------------------------------- infer
    def submit(self, x, timeout_ms: Optional[float] = None,
               tenant: Optional[str] = None,
               priority: Optional[str] = None,
               host: Optional[int] = None):
        """Route one batch-inference request; returns the host engine's
        Future. Raises typed ``cluster_capacity`` / ``host_unavailable``
        when the fleet cannot take it, and re-raises the host's own
        typed rejection when every candidate bounced."""
        arr = np.asarray(x)
        rows = int(arr.shape[0]) if arr.ndim >= 1 else 1
        label = self._label(tenant, priority)
        self.metrics.requests_total.inc()
        trace = self._tracer.begin(self.name, "cluster.infer", rows=rows,
                                   tenant=label)
        # wire-v3 trace context: the routed host's engine
        # trace becomes a child leg of this front-door root. A disabled
        # tracer's NULL_TRACE has trace_id None → no kwargs → the
        # dispatch is bitwise the pre-v3 call (and a v2 receiver would
        # ignore the fields anyway).
        tkw = {} if trace.trace_id is None else {
            "trace_link": trace.trace_id, "trace_parent": "attempt1"}
        t0 = time.perf_counter()
        tried: List[int] = []
        bounced_full = 0
        last_reject: Optional[RejectedError] = None
        while True:
            try:
                h, hid, how = self._route("infer", rows=rows, pinned=host,
                                          exclude=tuple(tried),
                                          bounced_full=bounced_full)
            except RejectedError as e:
                if last_reject is not None:
                    e.__cause__ = last_reject
                self._shed(trace, e, label)
                raise
            trace.event("cluster.route", host=hid, decision=how,
                        kind="infer")
            try:
                fut = h.submit_infer(arr, timeout_ms=timeout_ms,
                                     tenant=tenant, priority=priority,
                                     **tkw)
            except RejectedError as e:
                # heartbeat lag: the host filled (or shut down) since
                # its last beat — fold it out and try the next candidate
                tried.append(hid)
                if e.reason in self.CAPACITY_BOUNCE_REASONS:
                    bounced_full += 1
                last_reject = e
                trace.event("cluster.bounce", host=hid, reason=e.reason)
                continue
            self.routed_by_host.inc(f"h{hid}")
            self._out_add("infer", hid, rows)
            if (self.hedge.infer_hedge_after_ms is not None
                    and host is None and self.hedge.max_attempts >= 2):
                # stall-hedged: a monitor races ONE backup POST when the
                # result is slow; first success wins, loser cancelled
                # server-side, exactly-once SLO terminal via the proxy
                sup = _HedgedInfer(
                    self, arr, rows, timeout_ms=timeout_ms,
                    tenant=tenant, priority=priority, label=label,
                    trace=trace, t0=t0, tried=tried)
                return sup.start(hid, fut)
            self._watch_future(fut, trace, t0, label, "infer", hid, rows)
            return fut

    def output(self, x, timeout_ms: Optional[float] = None, **kw):
        """Blocking submit (the engines' convenience wrapper)."""
        return self.submit(x, timeout_ms=timeout_ms, **kw).result()

    # ----------------------------------------------------------- generate
    def submit_generate(self, prompt, *, max_new_tokens: int = 16,
                        prefix_id: Optional[str] = None,
                        tenant: Optional[str] = None,
                        priority: Optional[str] = None,
                        host: Optional[int] = None, **kwargs):
        """Route one generation stream; returns a
        :class:`GenerationHandle`. On a LOOPBACK host this is the host
        engine's own handle and the stream is sticky. On an RPC host (``open_stream`` surface) the
        returned handle is front-door-owned and the stream is HEDGED:
        dispatch goes asynchronous (admission sheds surface through the
        handle, exactly once), host loss mid-stream re-dispatches to the
        next candidate with the remaining deadline budget, a stall past
        ``hedge.hedge_after_ms`` races a backup attempt, the first
        terminal wins, and no token is delivered twice (delivery is
        watermarked; streams are seed-deterministic so every attempt's
        prefix agrees). ``prefix_id`` pins routing to the host holding
        the registered prefix — pinned streams never hedge across hosts
        (their KV blocks cannot migrate)."""
        toks = np.asarray(prompt).ravel()
        label = self._label(tenant, priority)
        if (self.disagg is not None and host is None and prefix_id is None
                and self.disagg.enabled(self.directory)):
            # disaggregated placement: a prefill-class host runs the
            # prompt and its KV pages migrate to a decode-class host. The
            # policy does its own request, trace and terminal accounting
            # (it spans two routed submits); pinned and prefix-affine
            # streams stay on the single-host path, since their blocks
            # cannot migrate
            return self.disagg.submit(
                self, toks, max_new_tokens=max_new_tokens, tenant=tenant,
                priority=priority, **kwargs)
        if prefix_id is not None:
            with self._affinity_lock:
                ph = self._prefix_hosts.get(prefix_id)
            if ph is None:
                raise KeyError(
                    f"prefix_id {prefix_id!r} is not registered with this "
                    f"front door — call register_prefix() first")
            if host is not None and host != ph:
                raise ValueError(
                    f"prefix_id {prefix_id!r} lives on host {ph}; "
                    f"host={host} contradicts its affinity")
            host = ph
        self.metrics.requests_total.inc()
        trace = self._tracer.begin(self.name, "cluster.generate",
                                   prompt_len=int(toks.size),
                                   tenant=label)
        t0 = time.perf_counter()
        tried: List[int] = []
        bounced_full = 0
        last_reject: Optional[RejectedError] = None
        while True:
            needed = self._blocks_needed(int(toks.size), max_new_tokens,
                                         host)
            # the prompt-only seat demand (+1, the first write target):
            # what an allocate="on_demand" host actually takes at seating
            needed_admit = self._blocks_needed(int(toks.size), 1, host)
            try:
                h, hid, how = self._route(
                    "generate", rows=1, blocks_needed=needed,
                    blocks_admit=needed_admit,
                    pinned=host, exclude=tuple(tried),
                    bounced_full=bounced_full)
            except RejectedError as e:
                if last_reject is not None:
                    e.__cause__ = last_reject
                self._shed(trace, e, label)
                raise
            if hasattr(h, "open_stream"):
                # RPC host: hand the stream to the hedging supervisor.
                # Dispatch goes asynchronous from here — admission sheds,
                # re-dispatches and the terminal all surface through the
                # returned handle, and the supervisor emits this route's
                # cluster.route/rpc.dispatch trace events itself. Any
                # loopback bounces this loop already collected seed the
                # supervisor's exclude/bounce state so a mixed fleet
                # keeps each-candidate-once semantics.
                gen_kwargs = dict(kwargs)
                timeout_ms = gen_kwargs.pop("timeout_ms", None)
                gen_kwargs.update(max_new_tokens=max_new_tokens,
                                  prefix_id=prefix_id, tenant=tenant,
                                  priority=priority)
                sup = _HedgedStream(
                    self, np.asarray(toks, np.int32),
                    gen_kwargs=gen_kwargs, pinned=host,
                    blocks_hint_max_new=max_new_tokens,
                    timeout_ms=timeout_ms, trace=trace,
                    tenant_label=label, t0=t0)
                sup.tried = list(tried)
                sup.bounced_full = bounced_full
                sup.last_error = last_reject
                return sup.start((h, hid, how))
            trace.event("cluster.route", host=hid, decision=how,
                        kind="generate", blocks_needed=needed)
            tkw = {} if trace.trace_id is None else {
                "trace_link": trace.trace_id, "trace_parent": "route"}
            try:
                handle = h.submit_generate(
                    toks, max_new_tokens=max_new_tokens,
                    prefix_id=prefix_id, tenant=tenant, priority=priority,
                    **tkw, **kwargs)
            except RejectedError as e:
                tried.append(hid)
                if e.reason in self.CAPACITY_BOUNCE_REASONS:
                    bounced_full += 1
                last_reject = e
                trace.event("cluster.bounce", host=hid, reason=e.reason)
                continue
            self.routed_by_host.inc(f"h{hid}")
            self._out_add("generate", hid, 1)
            self._watch_future(handle.future, trace, t0, label,
                               "generate", hid, 1)
            return handle

    def _blocks_needed(self, prompt_len: int, max_new: int,
                       host: Optional[int]) -> int:
        """Worst-case fresh-block demand, in the candidate fleet's block
        size. Heartbeats carry each host's ``block_size``; the fleet
        shares one in practice, so the max across (the pinned host or
        all hosts) is the conservative routing bound."""
        sizes = []
        d = self.directory
        for hid in ([host] if host is not None else d.host_ids()):
            st = d.status(hid) if hid is not None else None
            if st is not None and st.block_size:
                sizes.append(st.block_size)
        if not sizes:
            return 0    # no paged host in view: route on slots alone
        return blocks_for_tokens(prompt_len + max_new, min(sizes))

    def register_prefix(self, tokens, prefix_id: Optional[str] = None,
                        host: Optional[int] = None,
                        timeout: Optional[float] = None) -> str:
        """Register a shared prefix on ONE host (most free KV blocks
        unless pinned) and remember the affinity: streams naming this
        ``prefix_id`` route to that host, where the prefilled blocks
        live."""
        toks = np.asarray(tokens).ravel()
        h, hid, _how = self._route(
            "generate", rows=1,
            blocks_needed=self._blocks_needed(int(toks.size), 0, host),
            pinned=host)
        kw = {} if timeout is None else {"timeout": timeout}
        pid = h.register_prefix(toks, prefix_id=prefix_id, **kw)
        with self._affinity_lock:
            self._prefix_hosts[pid] = hid
        self._recorder.record("cluster.prefix", prefix_id=pid, host=hid)
        return pid

    def prefix_host(self, prefix_id: str) -> Optional[int]:
        with self._affinity_lock:
            return self._prefix_hosts.get(prefix_id)

    def _forget_host_prefixes(self, host_id: int):
        """Directory hook on host leave: drop every prefix affinity
        pointing at the departed host (its pins are gone with it)."""
        with self._affinity_lock:
            stale = [p for p, h in self._prefix_hosts.items()
                     if h == host_id]
            for p in stale:
                del self._prefix_hosts[p]


# --------------------------------------------------------------------------
# One-store observability
# --------------------------------------------------------------------------
class ClusterStatsAggregator:
    """Aggregate every host's observability in one place: tail-sampled
    traces with host-prefixed trace ids, and merged Chrome lanes where
    every track is ``h<id>/tenant/trace-id`` (Perfetto sorts lexically,
    so each host's tenants cluster under that host's lanes). The
    reference also publishes each host's metrics into the UI tier's
    ``StatsStorage``; that half waits for the port of the UI tier.

    With wire-v3 trace context the per-host traces carry
    ``link``/``parent_span`` back to their front-door root, and the
    aggregator STITCHES them: :meth:`stitched_traces` groups every
    host's child legs under the logical stream's root trace, and
    :meth:`stitched_chrome_events` renders root + legs on ONE timeline
    with each host's events shifted by its estimated clock-skew offset
    (:meth:`estimate_clock_offsets` — NTP's classic midpoint estimate
    over a status round-trip: ``offset = host_wall_t - (t_before +
    t_after) / 2``). ``hosts`` optionally names LoopbackHosts whose
    traces should aggregate even though the directory routes to them
    through another handle (an RPC fleet's server-side hosts — the
    observability side-channel in single-process tests)."""

    def __init__(self, directory: ClusterDirectory, hosts=None):
        self.directory = directory
        self._extra_hosts: List[LoopbackHost] = list(hosts or ())
        self._offsets: Dict[int, float] = {}

    def _loopback_hosts(self) -> List[LoopbackHost]:
        out = []
        seen = set()
        for hid in self.directory.host_ids():
            h = self.directory.handle(hid)
            if isinstance(h, LoopbackHost):
                out.append(h)
                seen.add(id(h))
        for h in self._extra_hosts:
            if id(h) not in seen:
                out.append(h)
        return out

    def _front_door_tracers(self) -> list:
        """Each front door's tracer, deduped (front doors may share
        one) — the stitched view's root-trace source."""
        with self.directory._hb_lock:
            fds = list(self.directory._front_doors)
        tracers, seen = [], set()
        for fd in fds:
            tr = fd._tracer
            if tr is not None and id(tr) not in seen:
                seen.add(id(tr))
                tracers.append(tr)
        return tracers

    # ------------------------------------------------------- clock skew
    def estimate_clock_offsets(self) -> Dict[int, float]:
        """Per-host clock-skew offsets (seconds a host's wall clock runs
        AHEAD of the coordinator's), NTP midpoint estimate: probe the
        host's status round-trip and read its ``wall_t`` stamp against
        the probe midpoint. Accuracy is bounded by half the RTT — the
        heartbeat-grade bound the stitched timeline needs (spans are
        hundreds of µs and up), not a time-sync service. Cached for the
        stitched exports; re-estimate whenever drift matters."""
        offsets: Dict[int, float] = {}
        probed = set()
        for hid in self.directory.host_ids():
            h = self.directory.handle(hid)
            if h is None:
                continue
            off = self._probe_offset(h)
            if off is not None:
                offsets[hid] = off
            probed.add(hid)
        for h in self._extra_hosts:
            if h.host_id in probed:
                continue
            off = self._probe_offset(h)
            if off is not None:
                offsets[h.host_id] = off
        self._offsets = offsets
        return offsets

    @staticmethod
    def _probe_offset(h: HostHandle) -> Optional[float]:
        t_before = time.time()
        try:
            st = h.status()
        except Exception:
            return None   # a dead host stitches uncorrected, not at all
        t_after = time.time()
        wall = float(getattr(st, "wall_t", 0.0) or 0.0)
        if not wall:
            return None   # wire-v1 peer: no stamp, assume no skew
        return wall - (t_before + t_after) / 2.0

    @property
    def clock_offsets(self) -> Dict[int, float]:
        return dict(self._offsets)

    def traces(self, limit: Optional[int] = 50) -> List[dict]:
        """Every host's retained traces, trace ids prefixed ``h<id>/``
        so one store never collides two hosts' local sequence numbers."""
        out = []
        for h in self._loopback_hosts():
            for tr in h.trace_snapshots(limit=limit):
                tr = dict(tr)
                tr["host"] = h.host_id
                tr["trace_id"] = f"h{h.host_id}/{tr['trace_id']}"
                out.append(tr)
        out.sort(key=lambda d: d["start"])
        return out[-limit:] if limit is not None else out

    def chrome_events(self, t0: Optional[float] = None) -> List[dict]:
        """Merged Chrome lanes: per-host pid blocks (host id * 1000 +
        local pid keeps lanes disjoint), process names ``h3:serving[...]``
        and thread tracks ``h3/tenant/trace-id``."""
        events: List[dict] = []
        for h in self._loopback_hosts():
            base = (h.host_id + 1) * 1000
            for e in h.chrome_events(t0=t0):
                e = dict(e)
                if "pid" in e:
                    e["pid"] = base + e["pid"]
                if e.get("ph") == "M":
                    args = dict(e.get("args") or {})
                    if "name" in args:
                        sep = ":" if e["name"] == "process_name" else "/"
                        args["name"] = f"h{h.host_id}{sep}{args['name']}"
                    e["args"] = args
                events.append(e)
        return events

    # ------------------------------------------------ cross-host stitching
    def stitched_traces(self, limit: Optional[int] = None) -> List[dict]:
        """ONE trace per logical stream: every front-door root trace
        with its cross-host child legs folded under it (host traces
        whose wire-v3 ``link`` names the root's trace id). Legs carry
        their host id, parent-span label, and the skew-corrected wall
        start (``start_corrected = start - offset``, on the
        coordinator's clock) so the causal chain reads monotonic on one
        timeline; legs sort by corrected start. Roots with no linked
        leg still stitch (span_count 1 — a purely local request)."""
        offsets = self._offsets
        stitched: Dict[str, dict] = {}
        order: List[str] = []
        for tracer in self._front_door_tracers():
            for tr in tracer.snapshot():
                rid = tr["trace_id"]
                if rid in stitched:
                    continue
                stitched[rid] = {
                    "trace_id": rid, "root": tr, "legs": [],
                    "hosts": [], "span_count": 1,
                    "error": tr.get("reason") not in (None, "ok"),
                }
                order.append(rid)
        for h in self._loopback_hosts():
            off = float(offsets.get(h.host_id, 0.0))
            for tr in h.trace_snapshots():
                link = tr.get("link")
                if link is None or link not in stitched:
                    continue
                leg = dict(tr)
                leg["host"] = h.host_id
                leg["skew_offset_s"] = off
                leg["start_corrected"] = tr["start"] - off
                s = stitched[link]
                s["legs"].append(leg)
                if tr.get("reason") not in (None, "ok"):
                    s["error"] = True
        out = []
        for rid in order:
            s = stitched[rid]
            s["legs"].sort(key=lambda d: d["start_corrected"])
            s["hosts"] = sorted({g["host"] for g in s["legs"]})
            s["span_count"] = 1 + len(s["legs"])
            out.append(s)
        out.sort(key=lambda d: d["root"]["start"])
        return out[-limit:] if limit is not None else out

    def stitched_chrome_events(self, t0: Optional[float] = None
                               ) -> List[dict]:
        """The whole fleet's causal chain on ONE Chrome timeline: the
        front doors' root lanes (their native pids — small ints,
        disjoint from the host blocks) plus every host's lanes
        (per-host pid blocks, as :meth:`chrome_events`) with each
        host's event timestamps shifted by its estimated clock-skew
        offset, so a leg's spans land where they truly ran relative to
        the root. ``t0`` is the shared perf_counter origin (defaults to
        the earliest tracer's)."""
        tracers = self._front_door_tracers()
        hosts = self._loopback_hosts()
        if t0 is None:
            bases = [tr._t0 for tr in tracers]
            bases += [h._tracer._t0 for h in hosts
                      if h._tracer is not None]
            t0 = min(bases) if bases else 0.0
        events: List[dict] = []
        for tracer in tracers:
            for e in tracer.chrome_events(t0=t0):
                e = dict(e)
                if e.get("ph") == "M":
                    args = dict(e.get("args") or {})
                    if "name" in args:
                        sep = ":" if e["name"] == "process_name" else "/"
                        args["name"] = f"fd{sep}{args['name']}"
                    e["args"] = args
                events.append(e)
        offsets = self._offsets
        for h in hosts:
            base = (h.host_id + 1) * 1000
            shift_us = float(offsets.get(h.host_id, 0.0)) * 1e6
            for e in h.chrome_events(t0=t0):
                e = dict(e)
                if "pid" in e:
                    e["pid"] = base + e["pid"]
                if e.get("ph") == "M":
                    args = dict(e.get("args") or {})
                    if "name" in args:
                        sep = ":" if e["name"] == "process_name" else "/"
                        args["name"] = f"h{h.host_id}{sep}{args['name']}"
                    e["args"] = args
                elif "ts" in e:
                    e["ts"] = e["ts"] - shift_us
                events.append(e)
        return events

    def export_stitched_chrome(self, path: str) -> str:
        """One-file Chrome/Perfetto export of the stitched fleet view
        (chrome://tracing or ui.perfetto.dev)."""
        import json

        with open(path, "w") as f:
            json.dump({"traceEvents": self.stitched_chrome_events(),
                       "displayTimeUnit": "ms"}, f)
        return path


# --------------------------------------------------------------------------
# Graceful leave + the elasticity decision loop
# --------------------------------------------------------------------------
def drain_host(directory: ClusterDirectory, host_id: int,
               timeout: Optional[float] = None) -> bool:
    """The coordinator half of the graceful-leave protocol, pairing the
    host's :meth:`HostHandle.drain`:

    1. **mark** — :meth:`ClusterDirectory.mark_draining` excludes the
       host from routing the INSTANT the drain is initiated (waiting for
       the host's next heartbeat to carry ``draining`` would leave a
       window where the front door routes into a closing door and sheds
       — the protocol's zero-shed guarantee lives here);
    2. **drain** — the host stops admission, finishes every queued and
       resident stream, and releases its shared-prefix pins;
    3. **leave** — only once fully drained does the host leave the
       directory (its heartbeats stop mattering; a later re-join
       un-drains it).

    Returns True when the host drained within ``timeout``. On timeout
    the host STAYS marked draining with its directory entry intact —
    admission is still closed and resident streams are still finishing,
    so the caller can retry the drain or force ``shutdown()``; it must
    not rejoin routing half-drained."""
    h = directory.handle(host_id)
    if h is None:
        raise KeyError(f"host {host_id} has no bound handle in this "
                       f"directory — cannot drain an unbound "
                       f"(heartbeat-only) member")
    directory.mark_draining(host_id)
    ok = h.drain(timeout=timeout)
    if ok:
        directory.leave(host_id)
    return ok


@dataclasses.dataclass
class ElasticityPolicy:
    """Thresholds for the join/drain decision loop. The loop watches two
    TRENDS from the fleet view (:meth:`ClusterDirectory.api_snapshot`) —
    the fleet's free-slot
    fraction and the front doors' shed mix — and recommends scaling:

    - **join** when capacity pressure persists: ``cluster_capacity``
      sheds appeared since the last look, the free-slot fraction sat
      below ``low_free_slot_frac`` for ``trend_windows`` consecutive
      observations (a single busy tick never scales the fleet), or the
      fleet preempted at least ``preemption_pressure_min`` resident
      streams since the last look — a fleet that preempts steadily is
      serving on borrowed KV blocks and needs hosts BEFORE it starts
      shedding (preemption is the leading indicator, sheds the
      trailing one);
    - **drain** when slack persists: free-slot fraction above
      ``high_free_slot_frac`` with zero capacity sheds for
      ``trend_windows`` consecutive observations, and more than
      ``min_hosts`` routable hosts remain — the least-loaded host drains
      (fewest resident streams leave, so scale-down finishes fastest);
    - **hold** otherwise, and always while any host is mid-drain (one
      elasticity action at a time keeps the trend readable)."""

    low_free_slot_frac: float = 0.15
    high_free_slot_frac: float = 0.60
    trend_windows: int = 3
    min_hosts: int = 1
    # fleet-wide preemptions per observation that count as capacity
    # pressure (allocate="on_demand" hosts evicting residents to serve
    # boundary crossings). 1 = any sustained preemption is pressure;
    # raise it to tolerate occasional churn on small pools
    preemption_pressure_min: int = 1

    def __post_init__(self):
        if not (0.0 <= self.low_free_slot_frac
                < self.high_free_slot_frac <= 1.0):
            raise ValueError(
                f"need 0 <= low_free_slot_frac < high_free_slot_frac <= 1, "
                f"got {self.low_free_slot_frac}/{self.high_free_slot_frac}")
        if self.trend_windows < 1:
            raise ValueError("trend_windows must be >= 1")
        if self.min_hosts < 1:
            raise ValueError("min_hosts must be >= 1")
        if self.preemption_pressure_min < 1:
            raise ValueError("preemption_pressure_min must be >= 1")


class ElasticityPlanner:
    """Pure decision half of the elasticity loop: feed it successive fleet
    views (:meth:`ClusterDirectory.api_snapshot` locally, or fetched over
    HTTP — the shape is the same), get back a
    decision dict. Holds only trend state (previous shed totals,
    consecutive pressure/slack streaks); it never touches the fleet —
    :class:`ElasticityLoop` applies decisions."""

    #: front-door rejection reasons that mean "the fleet was full", the
    #: signal that adding a host would have absorbed the request
    CAPACITY_SHED_REASONS = ("cluster_capacity",)

    def __init__(self, policy: Optional[ElasticityPolicy] = None, *,
                 timeseries=None, host_cost_per_s: float = 1.0,
                 min_fit_samples: int = 4):
        self.policy = policy if policy is not None else ElasticityPolicy()
        # cost-model substrate: a timeseries.TimeSeriesStore (usually the
        # directory's fleet-side ring). When attached,
        # every decision fits tokens/sec cost curves per host class ×
        # config cell and cites the cheapest fitted cost-per-token in
        # its reason; None (default) keeps decisions bitwise identical
        # to the pre-cost-model planner.
        self.timeseries = timeseries
        self.host_cost_per_s = float(host_cost_per_s)
        self.min_fit_samples = int(min_fit_samples)
        self._last_shed_total: Optional[int] = None
        self._last_preempt_total: Optional[int] = None
        self._pressure_streak = 0
        self._slack_streak = 0
        self.last_decision: Optional[dict] = None

    # ------------------------------------------------------------- signals
    def _capacity_sheds(self, snapshot: dict) -> int:
        total = 0
        for fd in snapshot.get("front_doors", ()):
            by_reason = fd.get("rejections_by_reason") or {}
            for r in self.CAPACITY_SHED_REASONS:
                total += int(by_reason.get(r, 0))
        return total

    @staticmethod
    def _free_slot_frac(snapshot: dict) -> Optional[float]:
        fleet = snapshot.get("fleet") or {}
        slots = fleet.get("slots") or 0
        if not slots:
            return None
        return float(fleet.get("free_slots", 0)) / float(slots)

    @staticmethod
    def _drain_candidate(snapshot: dict) -> Optional[int]:
        """Least-loaded alive host: most free slots (ties: most free KV
        blocks, then the highest id — newest joiner leaves first)."""
        best = None
        for hid_s, h in (snapshot.get("hosts") or {}).items():
            st = h.get("status")
            if (st is None or h.get("unbound") or not h.get("alive")
                    or h.get("draining")):
                continue
            key = (st.get("free_slots", 0), st.get("kv_blocks_free", 0),
                   int(hid_s))
            if best is None or key > best[0]:
                best = (key, int(hid_s))
        return None if best is None else best[1]

    # ------------------------------------------------------------ decision
    def observe(self, snapshot: dict) -> dict:
        """Fold one fleet view into the trends and decide.
        The first observation never acts (no delta to read yet)."""
        pol = self.policy
        shed_total = self._capacity_sheds(snapshot)
        shed_delta = (0 if self._last_shed_total is None
                      else max(0, shed_total - self._last_shed_total))
        first = self._last_shed_total is None
        self._last_shed_total = shed_total
        free_frac = self._free_slot_frac(snapshot)
        fleet = snapshot.get("fleet") or {}
        alive = int(fleet.get("alive", 0))
        draining = int(fleet.get("draining", 0))
        # preemption rate — the join signal BESIDE the shed mix: an
        # on-demand fleet evicting residents for KV blocks is out of
        # memory headroom even while nothing sheds yet (missing on
        # pre-upgrade snapshots: delta stays 0)
        preempt_total = int(fleet.get("preemptions_total", 0) or 0)
        preempt_delta = (0 if self._last_preempt_total is None
                         else max(0, preempt_total
                                  - self._last_preempt_total))
        self._last_preempt_total = preempt_total

        pressure = (shed_delta > 0
                    or preempt_delta >= pol.preemption_pressure_min
                    or (free_frac is not None
                        and free_frac < pol.low_free_slot_frac))
        slack = (shed_delta == 0 and preempt_delta == 0
                 and free_frac is not None
                 and free_frac > pol.high_free_slot_frac)
        if first:
            pressure = slack = False
        self._pressure_streak = self._pressure_streak + 1 if pressure else 0
        self._slack_streak = self._slack_streak + 1 if slack else 0

        action, reason, target = "hold", "within watermarks", None
        draining_host = None
        if draining > 0:
            action, reason = "hold", "a drain is already in progress"
            # name the host mid-drain so the loop can keep DRIVING the
            # drain to completion: a resident stream outliving one
            # drain_timeout_s leaves the host marked draining, and a
            # hold-forever here would wedge the whole loop (no retry,
            # no join) on a single stuck drain
            for hid_s, h in (snapshot.get("hosts") or {}).items():
                if h.get("draining") and not h.get("unbound"):
                    draining_host = int(hid_s)
                    break
        elif self._pressure_streak >= pol.trend_windows:
            action = "join"
            ff = "n/a" if free_frac is None else round(free_frac, 3)
            reason = (f"capacity pressure for {self._pressure_streak} "
                      f"window(s): +{shed_delta} capacity shed(s), "
                      f"+{preempt_delta} preemption(s), "
                      f"free-slot fraction {ff}")
            self._pressure_streak = 0
        elif (self._slack_streak >= pol.trend_windows
                and alive - draining > pol.min_hosts):
            target = self._drain_candidate(snapshot)
            if target is not None:
                action = "drain"
                reason = (f"sustained slack for {self._slack_streak} "
                          f"window(s): free-slot fraction "
                          f"{round(free_frac, 3)} > "
                          f"{pol.high_free_slot_frac}, no capacity sheds")
                self._slack_streak = 0
        cost_model = self._fit_cost_model()
        if cost_model is not None and cost_model.get("cheapest"):
            # the decision log cites the fitted figure (the SRE
            # capacity-planning loop's unit economics next to the
            # trend that triggered the action)
            key = cost_model["cheapest"]
            m = cost_model["models"][key]
            reason += (f"; fitted cost/token "
                       f"{m['cost_per_token']:.3e} host-s at full "
                       f"occupancy ({key}, n={m['n']}, "
                       f"r2={m['r2']:.3f})")
        self.last_decision = {
            "action": action, "reason": reason, "host": target,
            "draining_host": draining_host,
            "free_slot_frac": (None if free_frac is None
                               else round(free_frac, 4)),
            "capacity_sheds_delta": shed_delta,
            "preemptions_delta": preempt_delta,
            "pressure_streak": self._pressure_streak,
            "slack_streak": self._slack_streak,
        }
        if cost_model is not None:
            self.last_decision["cost_model"] = cost_model
        return self.last_decision

    def _fit_cost_model(self) -> Optional[dict]:
        """Fit the per-(host class × config) cost curves off the
        attached time-series ring; None without one (bitwise-inert
        default)."""
        if self.timeseries is None:
            return None
        from deeplearning4j_tpu_torch.serving.timeseries import (
            cheapest_cell, fit_cost_models)
        models = fit_cost_models(self.timeseries,
                                 min_samples=self.min_fit_samples,
                                 host_cost_per_s=self.host_cost_per_s)
        return {"models": models, "cheapest": cheapest_cell(models),
                "host_cost_per_s": self.host_cost_per_s}


def http_snapshot_source(url: str, index: int = 0, timeout_s: float = 5.0):
    """A snapshot source reading ``GET /api/cluster`` off a coordinator's
    UI server — the over-the-wire way to feed :class:`ElasticityLoop`
    (the endpoint returns one payload per live directory; ``index`` picks
    which). The endpoint is the reference UI tier's."""
    import json as _json
    import urllib.request as _req

    base = url.rstrip("/")

    def fetch() -> dict:
        with _req.urlopen(f"{base}/api/cluster", timeout=timeout_s) as r:
            payload = _json.loads(r.read().decode())
        return payload[index]
    return fetch


class ElasticityLoop:
    """The acting half of the join/drain loop: each :meth:`step` pulls
    one snapshot from ``source`` (default: the directory's own
    ``api_snapshot``; pass :func:`http_snapshot_source` to drive it off
    a remote coordinator), asks the planner, and
    applies the decision — ``join`` invokes the caller's ``on_join``
    hook (only the deployer can mint hosts; the loop just says when),
    ``drain`` runs :func:`drain_host` on the chosen host. ``start()``
    runs steps on a daemon thread with the same seeded-jitter discipline
    as :class:`HeartbeatPump`; tests call :meth:`step` directly."""

    def __init__(self, directory: ClusterDirectory, *,
                 planner: Optional[ElasticityPlanner] = None,
                 source: Optional[Callable[[], dict]] = None,
                 on_join: Optional[Callable[[dict], None]] = None,
                 drain_timeout_s: Optional[float] = 30.0,
                 interval_s: float = 5.0, jitter: float = 0.1,
                 seed: int = 0):
        _validate_jitter(interval_s, jitter)
        self.directory = directory
        self.planner = planner if planner is not None else ElasticityPlanner()
        self._source = source if source is not None \
            else directory.api_snapshot
        self.on_join = on_join
        self.drain_timeout_s = drain_timeout_s
        self.interval_s = interval_s
        self.jitter = float(jitter)
        self._rng = np.random.default_rng(seed)
        self.steps = 0
        self.decisions: List[dict] = []
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        with _ELASTICITY_LOCK:
            _ELASTICITY_LOOPS.add(self)

    def step(self) -> dict:
        decision = self.planner.observe(self._source())
        self.steps += 1
        self.decisions.append(decision)
        if decision["action"] == "join":
            if self.on_join is not None:
                self.on_join(decision)
        elif decision["action"] == "drain":
            # the snapshot may be seconds stale (http_snapshot_source):
            # the chosen host can have left between observe and apply —
            # skip rather than KeyError out of the caller's step()
            if self.directory.handle(decision["host"]) is not None:
                drain_host(self.directory, decision["host"],
                           timeout=self.drain_timeout_s)
        elif decision.get("draining_host") is not None:
            # a prior drain timed out mid-flight (the host stays marked
            # draining, admission closed, residents still finishing):
            # keep driving it to completion instead of holding forever
            # — drain_host is idempotent and leaves on success
            hid = decision["draining_host"]
            if self.directory.handle(hid) is not None:
                drain_host(self.directory, hid,
                           timeout=self.drain_timeout_s)
        return decision

    def next_interval_s(self) -> float:
        return _jittered_interval_s(self.interval_s, self.jitter,
                                    self._rng)

    def start(self) -> "ElasticityLoop":
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._loop, daemon=True,
                name="elasticity-loop")
            self._thread.start()
        return self

    def _loop(self):
        while not self._stop.wait(self.next_interval_s()):
            try:
                self.step()
            except Exception:
                pass   # a failed fetch/drain must not kill the loop

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None


# weak registry of live loops (same pattern as all_directories)
_ELASTICITY_LOOPS: "weakref.WeakSet[ElasticityLoop]" = weakref.WeakSet()
_ELASTICITY_LOCK = threading.Lock()


def all_elasticity_loops() -> List["ElasticityLoop"]:
    with _ELASTICITY_LOCK:
        return list(_ELASTICITY_LOOPS)


__all__ = ["HostStatus", "HostHandle", "LoopbackHost", "ClusterTransport",
           "LoopbackTransport", "HeartbeatPump",
           "ClusterDirectory", "ClusterFrontDoor", "ClusterStatsAggregator",
           "HedgePolicy", "ElasticityPolicy", "ElasticityPlanner",
           "ElasticityLoop", "all_elasticity_loops", "drain_host",
           "http_snapshot_source", "all_directories"]
