"""Request-scoped tracing, flight recorder and terminal-reason taxonomy
for the serving stack (counterpart: ``deeplearning4j_tpu/serving/
tracing.py``; Dapper-style causal tracing, Sigelman et al. 2010, scoped
to one process).

The engine batches and schedules by iteration, so one request's latency
is smeared across shared queue windows and shared decode steps: only a
request-scoped timeline says where one request's own time went.

- :class:`RequestTrace` — one per sampled request: a trace id plus typed
  events with monotonic timestamps over the request's whole life
  (``submit -> queue.admit -> queue.wait -> slot.assign -> prefill ->
  decode.step* -> stream.finish -> retire``), resilience events
  (``retry.attempt``, ``watchdog.restart``) and recovery events
  (``preempt``, ``kv.swap`` with ``direction="out"|"in"``). Page
  migration (serving/disagg.py) adds ``kv.migrate`` on the engines
  (``direction="export"|"import"``, ``failed=`` on a degraded copy) and
  ``cluster.migrate`` / ``cluster.migrate.fallback`` (with its ``stage``)
  on the front door's trace; the two legs of a migrated stream link to
  that trace as the children ``migrate:prefill`` and ``migrate:decode``.
- :class:`Tracer` — trace collector with **tail sampling**: every
  in-flight request of an enabled tracer records live, and retention is
  decided at ``finish()`` — error traces are always kept, successes at
  ``sample_rate``. A disabled tracer (the default) hands out the shared
  :data:`NULL_TRACE` singleton: no allocation, no lock traffic.
- :class:`FlightRecorder` — an always-on bounded ring of recent
  structured events (breaker transitions, retries, watchdog restarts,
  device failures, poisoned results). Its snapshot is appended to the
  crash dumps of ``util/crash_reporting.py``.
- :func:`terminal_reason` — ONE mapping from exception to terminal-state
  string, shared by traces, the SLO windows and ``rejections_by_reason``.

Export: :meth:`Tracer.chrome_events` renders retained traces in the
Chrome-trace format — one process lane per engine, one thread lane per
request, tenant-prefixed track names — and
``OpProfiler.export_chrome_trace(path, tracer=...)`` merges them with the
profiler's spans on one clock.
"""
from __future__ import annotations

import itertools
import threading
import time
import weakref
from collections import OrderedDict, deque
from typing import Dict, List, Optional, Tuple

import numpy as np

# Canonical terminal states. "ok" is success; every other value matches
# the reason string the same event feeds into
# ``ServingMetrics.rejections_by_reason`` (RejectedError.reason), so
# the SLO error buckets and the rejection counters share one
# vocabulary. "model_error" (server-side dispatch/decode failure),
# "client_error" (the caller's own on_token callback raised) and
# "cancelled" are SLO/trace-only: none is an admission rejection.
TERMINAL_REASONS = (
    "ok", "queue_full", "deadline", "shutdown", "circuit_open", "watchdog",
    "poisoned", "cancelled", "model_error", "client_error",
    "kv_blocks_exhausted",
    # multi-tenant QoS sheds (serving/qos.py + resilience.RetryBudget):
    # per-tenant quota bucket dry, SLO-burn governor shedding batch-class
    # traffic, and the deployment retry budget refusing to amplify a storm
    "quota_exceeded", "slo_shed", "retry_budget_exhausted",
    # the multi-host control plane of the reference package: the whole
    # fleet is out of admission headroom, and no usable host
    "cluster_capacity", "host_unavailable",
    # the RPC data plane of the reference package, and drain: a draining host
    # refusing new admission ahead of leaving the directory, and a peer
    # whose wire payload could not be interpreted (malformed/mid-upgrade
    # schema) — distinct from host_unavailable because the host answered
    "host_draining", "rpc_error",
    # on-demand KV allocation (serving/generation.py allocate="on_demand"):
    # a preempted stream that could not be requeued for recompute-on-resume
    # (admission closed mid-preemption, or the resume demand can never fit
    # the pool again) — distinct from kv_blocks_exhausted because the
    # caller already received tokens and should resubmit the WHOLE request
    "preempted",
    # Deliberately ABSENT: "migrate_failed". Cross-host KV page
    # migration (serving/disagg.py + the kv.migrate endpoint) degrades
    # every failure to recompute on the decode host — the request's
    # terminal is whatever the recomputed stream earns, so a migration
    # failure is a trace event + kv_migrate_fallbacks_total increment,
    # never a terminal reason (the taxonomy lint enforces this stays so).
)


def terminal_reason(exc: BaseException) -> str:
    """The terminal-state string for a request that failed with ``exc``:
    a typed serving error's own ``reason`` (RejectedError and subclasses —
    queue_full/deadline/shutdown/circuit_open/watchdog/poisoned), else
    ``model_error``. The single exception->taxonomy mapping."""
    r = getattr(exc, "reason", None)
    return r if isinstance(r, str) and r else "model_error"


# --------------------------------------------------------------------------
# Flight recorder: always-on bounded ring of noteworthy events
# --------------------------------------------------------------------------
class FlightRecorder:
    """Bounded ring of recent structured events — the black box.

    Always on and O(capacity) memory forever: ``record`` appends one dict
    and the deque's maxlen evicts the oldest. Recording sites are
    *noteworthy* events only (failures, retries, breaker/watchdog
    activity, lifecycle), not per-request traffic, so the happy path pays
    nothing and the ring's horizon stays minutes-wide under load.
    ``snapshot()`` is what ``util/crash_reporting`` appends to every
    serving crash dump."""

    def __init__(self, capacity: int = 512, host: Optional[int] = None):
        if capacity <= 0:
            raise ValueError("capacity must be positive")
        self.capacity = capacity
        self._ring: deque = deque(maxlen=capacity)
        self._lock = threading.Lock()
        self._seq = 0
        self._host = host

    def set_host(self, host: Optional[int]) -> "FlightRecorder":
        """Stamp every FUTURE event with this host id (``"host"`` field).
        Events are attributable at record time, so a merged incident ring
        from several hosts' crash dumps needs no worker-prefix
        cross-referencing; already-recorded events keep whatever stamp
        they got. ``None`` stops stamping (the single-process default —
        the event shape is unchanged until a host id exists)."""
        with self._lock:
            self._host = host
        return self

    def record(self, kind: str, **fields):
        e = {"kind": kind, "t": time.time(),
             "mono_ms": time.perf_counter() * 1e3, **fields}
        with self._lock:
            if self._host is not None and "host" not in e:
                e["host"] = self._host
            self._seq += 1
            e["seq"] = self._seq
            self._ring.append(e)

    def snapshot(self) -> List[dict]:
        """Oldest-first copy of the ring (JSON-safe dicts)."""
        with self._lock:
            return [dict(e) for e in self._ring]

    def clear(self):
        with self._lock:
            self._ring.clear()

    @property
    def total_recorded(self) -> int:
        with self._lock:
            return self._seq

    def __len__(self) -> int:
        with self._lock:
            return len(self._ring)


_FLIGHT = FlightRecorder()


def flight_recorder() -> FlightRecorder:
    """The process-global flight recorder. Engines and the registry record
    into it by default, and crash dumps snapshot it — pass an explicit
    ``recorder=`` to an engine only when a test needs isolation."""
    return _FLIGHT


# --------------------------------------------------------------------------
# Request traces
# --------------------------------------------------------------------------
class _NullTrace:
    """Shared no-op trace: what a disabled tracer hands out. Every
    instrumentation point calls methods on the request's trace
    unconditionally; with sampling off they all land here — no per-request
    allocation, no locks, no branches at the call sites."""

    __slots__ = ()
    trace_id = None
    sampled = False

    def event(self, name, **attrs):
        pass

    def finish(self, reason="ok", latency_ms=None, **attrs):
        pass

    def __repr__(self):
        return "<NULL_TRACE>"


NULL_TRACE = _NullTrace()

_TRACE_SEQ = itertools.count(1)


class _LinkRegistry:
    """Process-wide tail-sampling coordination for LINKED traces (one
    logical stream whose legs finish in different Tracers — the front
    door's root plus each host engine's child).

    The per-tracer retention coin is leg-local, so without coordination a
    success-sampled front-door trace can survive while its FAILED remote
    leg is dropped (or vice versa) and the stitched view lies. The fix
    keeps tail-sampling semantics per *logical* stream: an error on any
    leg marks the logical id errored (bounded FIFO of recent ids), which
    (a) force-retains every LATER leg of that stream and (b) resurrects
    every EARLIER leg that the coin had sampled out — sampled-out legs
    park here (bounded, oldest streams evicted for real) instead of
    vanishing immediately, precisely so a late error can still claim
    them. Unlinked traces pass through with identical observable
    behavior: nothing else ever shares their logical id, so a parked
    unlinked trace is just a deferred drop.

    Lock order: this registry's lock never nests with a Tracer's —
    callers do registry lookups and tracer mutations in separate
    critical sections (a cycle between two tracers bridged through here
    could otherwise deadlock)."""

    MAX_ERROR_IDS = 1024     # recent errored logical ids remembered
    MAX_PARKED = 512         # sampled-out traces held for resurrection

    def __init__(self):
        self._lock = threading.Lock()
        self._errors: "OrderedDict[str, bool]" = OrderedDict()
        self._parked: "OrderedDict[str, list]" = OrderedDict()
        self._n_parked = 0

    def errored(self, logical_id: str) -> bool:
        with self._lock:
            return logical_id in self._errors

    def mark_error(self, logical_id: str) -> list:
        """Record one leg's error terminal; returns the (trace, tracer
        weakref) pairs previously parked under this logical id so the
        caller can re-admit them into their own tracers' rings."""
        with self._lock:
            if logical_id not in self._errors:
                self._errors[logical_id] = True
                while len(self._errors) > self.MAX_ERROR_IDS:
                    self._errors.popitem(last=False)
            entries = self._parked.pop(logical_id, [])
            self._n_parked -= len(entries)
            return entries

    def park(self, logical_id: str, trace, tracer):
        """Hold a sampled-out finished trace for possible resurrection.
        The trace's strong tracer edge is cut (a weakref rides along
        instead) so parking never pins a tracer past its engine."""
        trace._tracer = None
        with self._lock:
            self._parked.setdefault(logical_id, []).append(
                (trace, weakref.ref(tracer)))
            self._n_parked += 1
            while self._n_parked > self.MAX_PARKED and self._parked:
                _, evicted = self._parked.popitem(last=False)
                self._n_parked -= len(evicted)

    def clear(self):
        with self._lock:
            self._errors.clear()
            self._parked.clear()
            self._n_parked = 0


_LINKS = _LinkRegistry()


def link_registry() -> _LinkRegistry:
    """The process-global linked-trace retention registry (tests reset it
    via ``clear()`` for isolation)."""
    return _LINKS


class RequestTrace:
    """One request's causal timeline: typed events with monotonic
    timestamps. Created by :meth:`Tracer.begin`, carried on
    ``admission.Request.trace``, finished exactly once (first ``finish``
    wins; later events/finishes are dropped — a watchdog and a zombie
    dispatcher may both reach the terminal)."""

    __slots__ = ("trace_id", "engine", "kind", "tenant", "start_t",
                 "start_wall", "end_t", "reason", "latency_ms", "events",
                 "dropped_events", "pid", "tid", "_tracer", "_lock",
                 "_done", "link", "parent_span")

    MAX_EVENTS = 1024   # fixed memory even for a runaway stream

    def __init__(self, tracer: "Tracer", engine: str, kind: str,
                 link: Optional[str] = None,
                 parent_span: Optional[str] = None, **attrs):
        self.trace_id = f"{engine}-{next(_TRACE_SEQ):06d}"
        self.engine = engine
        self.kind = kind
        # cross-host trace context (Dapper):
        # ``link`` is the LOGICAL stream's root trace id (the front-door
        # trace this one is a child leg of), ``parent_span`` the label of
        # the parent span that dispatched it ("attempt1", "migrate:prefill",
        # ...). Both default None — a local root.
        self.link = link
        self.parent_span = parent_span
        # tenant identity (QoS attribution, serving/qos.py) lifted out of
        # the submit attrs so the Chrome export can tag its track name —
        # Perfetto sorts thread lanes lexically, so tenant-prefixed names
        # group one tenant's request timelines together
        t = (attrs or {}).get("tenant")
        self.tenant = str(t) if t is not None else None
        self.start_t = time.perf_counter()
        self.start_wall = time.time()
        self.end_t: Optional[float] = None
        self.reason: Optional[str] = None
        self.latency_ms: Optional[float] = None
        # (name, perf_counter_t, attrs-or-None)
        self.events: List[Tuple[str, float, Optional[dict]]] = []
        self.dropped_events = 0
        self.pid = 0        # chrome lanes, assigned at retention
        self.tid = 0
        self._tracer = tracer
        self._lock = threading.Lock()
        self._done = False
        self.events.append(("submit", self.start_t, attrs or None))

    sampled = True

    def event(self, name: str, **attrs):
        """Record one typed event at now (monotonic). Events carrying a
        ``dur_ms`` attr export as Chrome duration slices ending at now;
        the rest export as instants."""
        t = time.perf_counter()
        with self._lock:
            if self._done:
                return   # zombie effects after the terminal are dropped
            if len(self.events) >= self.MAX_EVENTS:
                self.dropped_events += 1
                return
            self.events.append((name, t, attrs or None))

    def finish(self, reason: str = "ok", latency_ms: Optional[float] = None,
               **attrs):
        """Terminal: stamps the ``retire`` event + reason and hands the
        trace to its tracer's retention policy. Idempotent — the first
        terminal wins, which is what makes the watchdog/zombie delivery
        races safe to instrument."""
        t = time.perf_counter()
        with self._lock:
            if self._done:
                return
            self._done = True
            self.end_t = t
            self.reason = reason
            self.latency_ms = latency_ms
            a = {"reason": reason}
            if latency_ms is not None:
                a["latency_ms"] = round(latency_ms, 3)
            a.update(attrs)
            self.events.append(("retire", t, a))
        self._tracer._retain(self)

    # ------------------------------------------------------------- reading
    @property
    def done(self) -> bool:
        with self._lock:
            return self._done

    def duration_ms(self) -> float:
        end = self.end_t if self.end_t is not None else time.perf_counter()
        return (end - self.start_t) * 1e3

    def event_names(self) -> List[str]:
        with self._lock:
            return [name for name, _, _ in self.events]

    def to_dict(self) -> dict:
        """JSON-safe form: event times are
        ms relative to the trace's own submit."""
        with self._lock:
            events = [{"name": name, "t_ms": round((t - self.start_t) * 1e3, 3),
                       **({"attrs": attrs} if attrs else {})}
                      for name, t, attrs in self.events]
            out = {
                "trace_id": self.trace_id, "engine": self.engine,
                "kind": self.kind, "reason": self.reason,
                "start": self.start_wall,
                "duration_ms": round(self.duration_ms(), 3),
                "dropped_events": self.dropped_events,
                "events": events,
            }
            if self.link is not None:
                out["link"] = self.link
            if self.parent_span is not None:
                out["parent_span"] = self.parent_span
            return out


class Tracer:
    """Trace collector with tail-sampling retention.

    - ``enabled=False`` (what :func:`default_tracer` starts as): ``begin``
      returns :data:`NULL_TRACE` — the zero-allocation fast path.
    - enabled: every request records live; at ``finish`` the trace is
      retained when its terminal reason is an error/shed (``keep_errors``,
      on by default — deadline-violating and failed requests always
      explain themselves) or by a seeded coin at ``sample_rate`` for
      successes. Retention is a bounded deque: ``capacity`` most-recent
      retained traces, older ones evicted.

    Chrome lanes are assigned at retention: one pid per engine name, one
    tid per retained trace, so :meth:`chrome_events` renders one process
    lane per engine and one thread lane per request."""

    def __init__(self, sample_rate: float = 1.0, keep_errors: bool = True,
                 capacity: int = 256, seed: int = 0, enabled: bool = True):
        if not (0.0 <= sample_rate <= 1.0):
            raise ValueError(f"sample_rate must be in [0, 1], got {sample_rate}")
        if capacity <= 0:
            raise ValueError("capacity must be positive")
        self.sample_rate = float(sample_rate)
        self.keep_errors = bool(keep_errors)
        self.capacity = capacity
        self.enabled = bool(enabled)
        self._rng = np.random.default_rng(seed)
        self._retained: deque = deque(maxlen=capacity)
        self._pids: Dict[str, int] = {}
        self._tids: Dict[str, int] = {}
        self._lock = threading.Lock()
        self.started = 0
        self.retained_total = 0
        self.sampled_out = 0
        self.link_retained = 0
        self._t0 = time.perf_counter()
        with _TRACERS_LOCK:
            _TRACERS.add(self)

    # ------------------------------------------------------------ recording
    def begin(self, engine: str, kind: str, link: Optional[str] = None,
              parent_span: Optional[str] = None, **attrs):
        """A new RequestTrace — or NULL_TRACE when this tracer cannot
        possibly retain it (disabled, or sample_rate=0 with errors not
        kept), which keeps the off path allocation-free. ``link`` /
        ``parent_span`` attach the trace to a cross-host parent (the
        trace context of a parent on another host):
        the new trace stays a full local RequestTrace but records whose
        child leg it is, and tail sampling treats the whole linked
        stream as one retention unit."""
        if not self.enabled or (self.sample_rate <= 0.0
                                and not self.keep_errors):
            return NULL_TRACE
        with self._lock:
            self.started += 1
        return RequestTrace(self, engine, kind, link=link,
                            parent_span=parent_span, **attrs)

    def _admit(self, trace: RequestTrace):
        """Append one finished trace to the retention ring (caller has
        already decided retention): assign its Chrome lanes and count it."""
        with self._lock:
            pid = self._pids.get(trace.engine)
            if pid is None:
                pid = self._pids[trace.engine] = 2 + len(self._pids)
            trace.pid = pid
            self._tids[trace.engine] = tid = \
                self._tids.get(trace.engine, 0) + 1
            trace.tid = tid
            self.retained_total += 1
            self._retained.append(trace)

    def _retain(self, trace: RequestTrace):
        """Tail-sampling decision at finish time: errors always kept when
        keep_errors, successes kept at sample_rate (seeded draw) — and
        the decision is coordinated per LOGICAL stream through the link
        registry, so an error on any linked leg force-retains every other
        leg of the same stream, whichever tracer holds it (registry and
        tracer locks never nest — see :class:`_LinkRegistry`)."""
        logical = trace.link if trace.link is not None else trace.trace_id
        if trace.reason != "ok" and self.keep_errors:
            # the error leg itself is always kept; claim back any legs
            # of the same stream the coin already sampled out elsewhere
            resurrect = _LINKS.mark_error(logical)
            self._admit(trace)
            for parked, tracer_ref in resurrect:
                owner = tracer_ref()
                if owner is None:
                    continue
                with owner._lock:
                    owner.sampled_out -= 1
                    owner.link_retained += 1
                owner._admit(parked)
            return
        with self._lock:
            # the seeded coin draw is unchanged (same draw order as
            # before link-aware retention: no draw for kept errors or
            # at sample_rate=1.0), so seeded tests stay reproducible
            drop = self.sample_rate < 1.0 \
                and float(self._rng.random()) >= self.sample_rate
        if drop and _LINKS.errored(logical):
            with self._lock:
                self.link_retained += 1
            drop = False
        if not drop:
            self._admit(trace)
            return
        with self._lock:
            self.sampled_out += 1
        # park instead of dropping: a LATER error on a linked leg can
        # still resurrect this one (unlinked ids are never claimed, so
        # parking is just a deferred drop for them)
        _LINKS.park(logical, trace, self)

    # -------------------------------------------------------------- reading
    def traces(self, engine: Optional[str] = None) -> List[RequestTrace]:
        with self._lock:
            return [t for t in self._retained
                    if engine is None or t.engine == engine]

    def snapshot(self, engine: Optional[str] = None,
                 limit: Optional[int] = None) -> List[dict]:
        out = [t.to_dict() for t in self.traces(engine)]
        return out[-limit:] if limit is not None else out

    def find(self, trace_id: str) -> Optional[RequestTrace]:
        with self._lock:
            for t in self._retained:
                if t.trace_id == trace_id:
                    return t
        return None

    def stats(self) -> dict:
        with self._lock:
            return {"enabled": self.enabled, "sample_rate": self.sample_rate,
                    "keep_errors": self.keep_errors,
                    "capacity": self.capacity, "started": self.started,
                    "retained": len(self._retained),
                    "retained_total": self.retained_total,
                    "sampled_out": self.sampled_out,
                    "link_retained": self.link_retained,
                    "evicted": self.retained_total - len(self._retained)}

    def clear(self):
        with self._lock:
            self._retained.clear()

    # -------------------------------------------------------------- export
    def chrome_events(self, t0: Optional[float] = None) -> List[dict]:
        """Chrome-trace events for the retained traces: one process lane
        per engine (``pid``, with a process_name metadata record), one
        thread lane per request (``tid``, named by trace id). ``t0`` is
        the perf_counter origin — pass the OpProfiler's so serving and
        training share one clock; defaults to this tracer's construction
        time."""
        base = self._t0 if t0 is None else t0
        with self._lock:
            traces = list(self._retained)
            pids = dict(self._pids)
        events: List[dict] = []
        for engine, pid in sorted(pids.items(), key=lambda kv: kv[1]):
            events.append({"ph": "M", "name": "process_name", "pid": pid,
                           "args": {"name": f"serving[{engine}]"}})
        for tr in traces:
            end_t = tr.end_t if tr.end_t is not None else time.perf_counter()
            # tenant-tagged track names: Perfetto sorts
            # thread lanes lexically within the engine's process lane, so
            # the "tenant/" prefix clusters each tenant's request
            # timelines into one contiguous per-tenant view
            track = f"{tr.tenant}/{tr.trace_id}" if tr.tenant is not None \
                else tr.trace_id
            events.append({"ph": "M", "name": "thread_name", "pid": tr.pid,
                           "tid": tr.tid, "args": {"name": track}})
            args = {"trace_id": tr.trace_id, "reason": tr.reason}
            if tr.tenant is not None:
                args["tenant"] = tr.tenant
            events.append({
                "name": f"{tr.kind}[{tr.reason or 'live'}]", "ph": "X",
                "ts": (tr.start_t - base) * 1e6,
                "dur": max((end_t - tr.start_t) * 1e6, 1.0),
                "pid": tr.pid, "tid": tr.tid, "args": args})
            with tr._lock:
                evs = list(tr.events)
            for name, t, attrs in evs:
                dur_ms = (attrs or {}).get("dur_ms")
                if dur_ms:
                    events.append({
                        "name": name, "ph": "X",
                        "ts": (t - base) * 1e6 - dur_ms * 1e3,
                        "dur": dur_ms * 1e3, "pid": tr.pid, "tid": tr.tid,
                        **({"args": attrs} if attrs else {})})
                else:
                    events.append({
                        "name": name, "ph": "i", "s": "t",
                        "ts": (t - base) * 1e6, "pid": tr.pid, "tid": tr.tid,
                        **({"args": attrs} if attrs else {})})
        return events

    def export_chrome_trace(self, path: str) -> str:
        """Standalone export (serving lanes only). For the merged
        serving+training view use
        ``OpProfiler.export_chrome_trace(path, tracer=...)``."""
        import json

        with open(path, "w") as f:
            json.dump({"traceEvents": self.chrome_events(),
                       "displayTimeUnit": "ms"}, f)
        return path


# weak registry: a fan-in over live tracers that does not pin
# dead ones (their engines hold the strong refs)
_TRACERS: "weakref.WeakSet[Tracer]" = weakref.WeakSet()
_TRACERS_LOCK = threading.Lock()
_DEFAULT: Optional[Tracer] = None
_DEFAULT_LOCK = threading.Lock()


def default_tracer() -> Tracer:
    """The process-global tracer engines fall back to when constructed
    without an explicit ``tracer=``. Starts DISABLED (the zero-cost path);
    flip it on for the whole process with :func:`configure`."""
    global _DEFAULT
    with _DEFAULT_LOCK:
        if _DEFAULT is None:
            _DEFAULT = Tracer(sample_rate=0.0, keep_errors=False,
                              enabled=False)
    return _DEFAULT


def configure(sample_rate: float = 1.0, keep_errors: bool = True,
              capacity: Optional[int] = None, seed: int = 0) -> Tracer:
    """Enable (or retune) the process-global tracer in place — engines
    already constructed against it pick the new policy up on their next
    ``begin``. ``capacity=None`` (the default) keeps the current retention
    capacity: a retune that only dials sampling must never silently
    shrink the ring and drop the incident traces it holds."""
    t = default_tracer()
    if not (0.0 <= sample_rate <= 1.0):
        raise ValueError(f"sample_rate must be in [0, 1], got {sample_rate}")
    t.sample_rate = float(sample_rate)
    t.keep_errors = bool(keep_errors)
    t.enabled = sample_rate > 0.0 or keep_errors
    t._rng = np.random.default_rng(seed)
    if capacity is not None and capacity != t.capacity:
        if capacity <= 0:
            raise ValueError("capacity must be positive")
        with t._lock:
            t.capacity = capacity
            t._retained = deque(t._retained, maxlen=capacity)
    return t


def all_tracers() -> List[Tracer]:
    """Every Tracer constructed in this process.
    Tracers are few (one global + maybe one per test/bench) and tiny when
    empty, so a plain list is fine."""
    with _TRACERS_LOCK:
        return list(_TRACERS)


__all__ = ["RequestTrace", "Tracer", "FlightRecorder", "NULL_TRACE",
           "flight_recorder", "link_registry", "default_tracer",
           "configure", "all_tracers", "terminal_reason",
           "TERMINAL_REASONS"]
