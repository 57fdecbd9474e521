"""Zero-leak resource ledgers (counterpart: ``deeplearning4j_tpu/serving/
ledger.py``).

An episode of chaos is survived only if, once it settles, every resource
it touched is back where it started: block-allocator free lists full
(modulo intentional pins), swap-store residency zero, no resident stream
stuck in a slot, RPC op registries resolved, tracer retention still
bounded, no thread or RSS creep.
The accounting lives in one place:

- :class:`ResourceLedger` — snapshot/diff accounting over a set of
  engines, front doors, RPC servers and tracers plus the process itself
  (threads, RSS). ``baseline()`` stamps the reference state; ``check()``
  re-snapshots (with a settle window — streams and HTTP connection
  threads wind down asynchronously) and returns
  the dimensions that did NOT return to baseline. ``assert_clean()`` is
  the raising form.
- :func:`check_shutdown` — the ABSOLUTE invariants that must hold for one
  engine or RPC server after shutdown, independent of any baseline: no
  resident slot, no queued request, swap store empty, every allocator
  block attributable (free + prefix pins + prefix cache == capacity),
  every RPC op resolved.
- :class:`LeakWatch` — a test fixture's hook: at teardown it sweeps every
  engine and server still in the weak registries and runs
  :func:`check_shutdown` over the ones that were shut down, returning the
  violations.

The ledger only READS engine state, through each engine's
``ledger_stats()`` and the public op accounting of
:class:`~.rpc.HostRpcServer`; it takes no engine locks of its own and
never blocks,
so it is safe to call from another thread while the engine is under load.
Leaks are reported as strings naming the dimension, never as typed sheds.
"""
from __future__ import annotations

import dataclasses
import threading
import time
import weakref
from typing import Dict, Iterable, List, Mapping, Optional, Tuple

__all__ = [
    "LedgerSnapshot", "LeakWatch", "ResourceLedger", "check_shutdown",
    "track_engine", "track_rpc_server", "tracked_engines",
    "tracked_rpc_servers",
]

# weak registries (the tracing.all_tracers pattern): engines and RPC
# servers register themselves at construction so a ledger can enumerate
# what a test or an episode created without threading every object
# through every helper. Weak: the ledger must never keep a dead engine
# alive.
_ENGINES: "weakref.WeakSet" = weakref.WeakSet()
_RPC_SERVERS: "weakref.WeakSet" = weakref.WeakSet()
_REG_LOCK = threading.Lock()


def track_engine(engine) -> None:
    """Called by ``GenerationEngine.__init__`` and
    ``InferenceEngine.__init__``."""
    with _REG_LOCK:
        _ENGINES.add(engine)


def track_rpc_server(server) -> None:
    """Called by ``HostRpcServer.__init__``."""
    with _REG_LOCK:
        _RPC_SERVERS.add(server)


def tracked_engines() -> list:
    with _REG_LOCK:
        return list(_ENGINES)


def tracked_rpc_servers() -> list:
    with _REG_LOCK:
        return list(_RPC_SERVERS)


def process_thread_counts() -> Tuple[int, int]:
    """(live threads, live NON-daemon threads) for this process."""
    threads = threading.enumerate()
    return len(threads), sum(1 for t in threads if not t.daemon)


def process_rss_bytes() -> Optional[int]:
    """Current resident set size, or None where unreadable (non-Linux):
    /proc/self/statm field 1 (resident pages) times the page size."""
    try:
        import resource

        with open("/proc/self/statm") as fh:
            pages = int(fh.read().split()[1])
        return pages * resource.getpagesize()
    except (OSError, ValueError, IndexError, ImportError):
        return None


@dataclasses.dataclass(frozen=True)
class LedgerSnapshot:
    """One point-in-time accounting: flat ``{dimension: value}``, with
    stable dimension names (``"engine[g0].live_slots"``,
    ``"process.rss_bytes"``) that :meth:`diff` pairs across snapshots."""

    taken_t: float
    dims: Mapping[str, float]

    def diff(self, other: "LedgerSnapshot") -> Dict[str, Tuple[float, float]]:
        """``{dim: (self_value, other_value)}`` for every dimension that
        differs (dimensions absent on one side count as 0)."""
        out: Dict[str, Tuple[float, float]] = {}
        for k in sorted(set(self.dims) | set(other.dims)):
            a, b = self.dims.get(k, 0), other.dims.get(k, 0)
            if a != b:
                out[k] = (a, b)
        return out

    def get(self, dim: str, default: float = 0) -> float:
        return self.dims.get(dim, default)


def _engine_dims(engine, out: Dict[str, float]) -> None:
    stats = engine.ledger_stats()
    name = stats.pop("name", getattr(engine, "name", "engine"))
    for k, v in stats.items():
        out[f"engine[{name}].{k}"] = v


def _rpc_dims(server, out: Dict[str, float]) -> None:
    hid = getattr(getattr(server, "host", None), "host_id", "?")
    out[f"rpc[h{hid}].open_ops"] = server.open_ops()


def _tracer_dims(tracer, idx: int, out: Dict[str, float]) -> None:
    st = tracer.stats()
    out[f"tracer[{idx}].retained"] = st.get("retained", 0)
    # capacity rides along so the bounded-retention check is absolute,
    # not baseline-relative
    out[f"tracer[{idx}].capacity"] = st.get("capacity", 0) or 0


class ResourceLedger:
    """Snapshot/diff accounting over a fleet plus this process.
    ``engines`` / ``rpc_servers`` / ``front_doors`` / ``tracers`` name the
    objects to account; pass no ``engines`` (or ``rpc_servers``) to
    account every one constructed in this process (the weak
    registries)::

        ledger = ResourceLedger(engines=engines, rpc_servers=servers)
        ledger.baseline()            # after warmup, before chaos
        ... episode ...
        ledger.assert_clean(timeout_s=10.0)   # settle, then gate

    Exact dimensions (slots, blocks, swap entries, open ops, non-daemon
    threads, front-door outstanding) must return EXACTLY to baseline; total threads may settle below
    baseline but not above ``baseline + thread_slack``; RSS may grow up
    to ``rss_slack_bytes`` (allocator caches, code pages) but no
    further."""

    #: dimensions allowed to DROP below baseline
    _MONOTONE_DOWN = ("process.threads",)

    def __init__(self, *, engines: Optional[Iterable] = None,
                 rpc_servers: Optional[Iterable] = None,
                 front_doors: Iterable = (),
                 tracers: Iterable = (),
                 rss_slack_bytes: int = 192 * 1024 * 1024,
                 thread_slack: int = 2):
        self._engines = None if engines is None else list(engines)
        self._servers = None if rpc_servers is None else list(rpc_servers)
        self._front_doors = list(front_doors)
        self._tracers = list(tracers)
        self.rss_slack_bytes = rss_slack_bytes
        self.thread_slack = thread_slack
        self._baseline: Optional[LedgerSnapshot] = None

    def snapshot(self) -> LedgerSnapshot:
        dims: Dict[str, float] = {}
        engines = self._engines if self._engines is not None \
            else tracked_engines()
        servers = self._servers if self._servers is not None \
            else tracked_rpc_servers()
        for e in engines:
            _engine_dims(e, dims)
        for srv in servers:
            _rpc_dims(srv, dims)
        for i, fd in enumerate(self._front_doors):
            dims[f"front_door[{i}].outstanding"] = fd.outstanding_total()
        for i, tr in enumerate(self._tracers):
            _tracer_dims(tr, i, dims)
        threads, non_daemon = process_thread_counts()
        dims["process.threads"] = threads
        dims["process.non_daemon_threads"] = non_daemon
        rss = process_rss_bytes()
        if rss is not None:
            dims["process.rss_bytes"] = rss
        return LedgerSnapshot(taken_t=time.monotonic(), dims=dims)

    def baseline(self) -> LedgerSnapshot:
        """Stamp (and return) the reference snapshot ``check`` diffs
        against. Call it at steady state — after warmup, before chaos."""
        self._baseline = self.snapshot()
        return self._baseline

    def _violations(self, base: LedgerSnapshot,
                    now: LedgerSnapshot) -> List[str]:
        out: List[str] = []
        for dim, (b, a) in base.diff(now).items():
            if dim == "process.rss_bytes":
                if a > b + self.rss_slack_bytes:
                    out.append(
                        f"{dim}: grew {a - b:+.0f} bytes over baseline "
                        f"(> {self.rss_slack_bytes} slack)")
            elif dim == "process.threads":
                if a > b + self.thread_slack:
                    out.append(f"{dim}: {b:.0f} -> {a:.0f} "
                               f"(> +{self.thread_slack} slack)")
            elif dim in self._MONOTONE_DOWN:
                if a > b:
                    out.append(f"{dim}: {b:.0f} -> {a:.0f}")
            else:
                out.append(f"{dim}: {b:.0f} -> {a:.0f}")
        # absolute bound, baseline-independent: tracer retention must
        # stay inside its ring capacity
        for dim, v in now.dims.items():
            if dim.endswith(".retained"):
                cap = now.get(dim[:-len("retained")] + "capacity", 0)
                if cap and v > cap:
                    out.append(f"{dim}: {v:.0f} exceeds ring capacity "
                               f"{cap:.0f}")
        return out

    def check(self, *, timeout_s: float = 0.0,
              poll_s: float = 0.1) -> List[str]:
        """Violations vs baseline, retrying for up to ``timeout_s``:
        "clean" is an eventually-reached state (retiring streams free
        their blocks on the scheduler thread, HTTP connection threads exit
        after their socket closes, op registries resolve on delivery)."""
        if self._baseline is None:
            raise RuntimeError("ResourceLedger.check() before baseline()")
        deadline = time.monotonic() + timeout_s
        while True:
            bad = self._violations(self._baseline, self.snapshot())
            if not bad or time.monotonic() >= deadline:
                return bad
            time.sleep(poll_s)

    def assert_clean(self, *, timeout_s: float = 10.0,
                     context: str = "") -> LedgerSnapshot:
        """Raise AssertionError naming every leaked dimension; returns
        the clean snapshot otherwise."""
        bad = self.check(timeout_s=timeout_s)
        if bad:
            where = f" after {context}" if context else ""
            raise AssertionError(
                "resource ledger did not return to baseline"
                + where + ":\n  " + "\n  ".join(bad))
        return self.snapshot()


def check_shutdown(obj) -> List[str]:
    """The invariants that must hold for ONE shut-down engine or stopped
    RPC server, no baseline needed. Returns violation strings.

    GenerationEngine: every slot vacated, queue empty, swap store empty,
    and every allocator block attributable — free + explicit prefix pins
    + automatic prefix cache == capacity (pins survive shutdown by
    design; orphaned blocks do not). InferenceEngine: queue empty,
    nothing in flight. HostRpcServer: every registered op resolved (TTL
    retention of resolved ops is fine; an op that can never resolve is a
    stuck client)."""
    out: List[str] = []
    label = getattr(obj, "name", None) or type(obj).__name__
    if hasattr(obj, "open_ops"):                     # HostRpcServer
        n = obj.open_ops()
        if n:
            out.append(f"rpc[{label}]: {n} unresolved op(s) at stop")
        return out
    stats = obj.ledger_stats()
    name = stats.get("name", label)
    for dim in ("live_slots", "queue_depth", "swap_entries",
                "swap_blocks_held", "inflight_rows"):
        v = stats.get(dim, 0)
        if v:
            out.append(f"engine[{name}].{dim}: {v:.0f} at shutdown")
    cap = stats.get("kv_capacity_blocks")
    if cap:
        attributed = (stats.get("kv_free_blocks", 0)
                      + stats.get("kv_pinned_blocks", 0)
                      + stats.get("kv_prefix_cache_blocks", 0))
        if attributed != cap:
            out.append(
                f"engine[{name}]: {cap - attributed:.0f} orphaned KV "
                f"block(s) at shutdown (free {stats.get('kv_free_blocks', 0):.0f}"
                f" + pinned {stats.get('kv_pinned_blocks', 0):.0f}"
                f" + cached {stats.get('kv_prefix_cache_blocks', 0):.0f}"
                f" != capacity {cap:.0f})")
    return out


def _shut_down(obj) -> bool:
    """Did this engine or server already stop? Only stopped objects are
    held to the shutdown law — live ones legitimately hold resources."""
    if hasattr(obj, "open_ops"):
        thread = getattr(obj, "_thread", None)
        return thread is not None and not thread.is_alive()
    stop = getattr(obj, "_stop", None)
    return stop is not None and stop.is_set()


class LeakWatch:
    """A test fixture's handle::

        watch = LeakWatch()          # construct at test SETUP
        ... test body ...
        violations = watch.finish()

    ``finish()`` settles briefly and returns shutdown-law violations for
    every engine or server in the registries that has been shut down
    since the watch
    was constructed: engines ALREADY shut down then (an earlier test's,
    lingering un-collected in the weak registry) are excluded."""

    def __init__(self):
        self._preexisting: "weakref.WeakSet" = weakref.WeakSet(
            obj for obj in tracked_engines() + tracked_rpc_servers()
            if _shut_down(obj))

    def finish(self, *, settle_s: float = 5.0,
               poll_s: float = 0.05) -> List[str]:
        deadline = time.monotonic() + settle_s
        while True:
            bad: List[str] = []
            for obj in tracked_engines() + tracked_rpc_servers():
                if obj in self._preexisting:
                    continue
                if _shut_down(obj):
                    bad.extend(check_shutdown(obj))
            if not bad or time.monotonic() >= deadline:
                return bad
            time.sleep(poll_s)
