"""Deterministic fault injection for the serving stack (counterpart:
``deeplearning4j_tpu/serving/faults.py``; the same seeds fire the same
schedule in both packages, bit for bit).

Design constraints, in priority order:

- **zero overhead when inactive.** Every instrumented call site goes
  through :func:`inject`, which is one module-global read and a branch
  when no plan is installed.
- **bit-for-bit reproducible.** A :class:`FaultPlan` is seeded; rate-based
  faults draw from a per-point numpy PRNG keyed on (seed, crc32(point)),
  and index-based faults fire on exact per-point call counters — so a
  chaos test replays the identical fault schedule on every run, and a
  failure found under ``FaultPlan(seed=k)`` is reported as just ``k``.
- **typed transience.** Injected failures raise
  :class:`FaultInjectedError` (``transient=True, injected=True``): the
  resilience layer's RetryPolicy retries them, and the crash-dump wiring
  skips them.

Injection points are plain strings named after the call they wrap. The
generation engine's:

- ``generation.prefill``, ``generation.decode_step`` and
  ``generation.verify_step`` — the target model's steps. A fail rule
  raises BEFORE the step launches anything, so the retry re-runs the
  same kernels against an untouched pool; a delay rule sleeps first (at
  watchdog scale, a hung scheduler); a poison rule rewrites the step's
  result (a device returning garbage).
- ``generation.draft_prefill`` and ``generation.draft_step`` — the
  speculative draft. DEGRADE contract: a fired fault turns the stream's
  turns into plain decode turns (``spec_fallbacks_total``, the draft
  breaker), never sheds or stalls it.
- ``kv.swap_out`` and ``kv.swap_in`` — the preemption victim's block
  copies to and from host memory. DEGRADE contract: a fired fault falls
  back to recompute-on-resume; the resumed stream is the uninterrupted
  one either way.

Cross-host KV page migration (serving/disagg.py and the ``kv.migrate``
RPC endpoint) carries the same DEGRADE contract across hosts: a fired
fault falls back to recompute on the DECODE host, it never sheds.

- ``kv.migrate`` — the migrate round trip itself (the RPC, or the
  loopback hand-off of the captured pages): no pages and, over the wire,
  no first token arrive; the decode host runs the whole stream;
- ``kv.migrate.export`` — the prefill host's device-to-host page copy:
  no pages ship, the decode host recomputes from the first token;
- ``kv.migrate.import`` — parking shipped pages in the decode host's
  swap store: the pages are dropped and the decode host recomputes from
  the first token.

Usage::

    plan = (FaultPlan(seed=7)
            .fail("generation.prefill", at=(0, 2))         # exact indices
            .fail("generation.decode_step", rate=0.05)     # seeded Bernoulli
            .delay("generation.decode_step", ms=50, at=(5,)))
    with plan:
        ... drive traffic ...
    plan.fired()   # the exact (point, index, kind) schedule that fired
"""
from __future__ import annotations

import threading
import time
import zlib
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np


class FaultInjectedError(RuntimeError):
    """A deliberately injected transient failure. ``transient`` makes the
    RetryPolicy retry it; ``injected`` keeps crash forensics quiet."""

    transient = True
    injected = True

    def __init__(self, point: str, index: int):
        super().__init__(
            f"injected transient fault at {point!r} (call #{index})")
        self.point = point
        self.index = index


class _Rule:
    """One fault rule: fires at exact call indices and/or at a seeded
    Bernoulli rate. kind: 'fail' | 'delay' | 'poison'."""

    __slots__ = ("kind", "at", "rate", "exc", "ms", "mutate")

    def __init__(self, kind: str, at: Optional[Sequence[int]], rate: float,
                 exc: Optional[Callable[[], BaseException]] = None,
                 ms: float = 0.0, mutate: Optional[Callable] = None):
        if at is None and rate <= 0.0:
            raise ValueError("a fault rule needs at= indices or rate= > 0")
        if not (0.0 <= rate <= 1.0):
            raise ValueError(f"rate must be in [0, 1], got {rate}")
        self.kind = kind
        self.at = frozenset(int(i) for i in at) if at is not None else None
        self.rate = float(rate)
        self.exc = exc
        self.ms = float(ms)
        self.mutate = mutate

    def triggered(self, index: int, rng) -> bool:
        # NB: the rate draw is consumed on EVERY call (not only when at=
        # misses) so the schedule depends solely on (seed, call index) —
        # adding an at= rule never shifts another rule's random stream.
        hit_rate = self.rate > 0.0 and float(rng.random()) < self.rate
        hit_at = self.at is not None and index in self.at
        return hit_at or hit_rate


class FaultPlan:
    """A seeded, installable schedule of faults over named injection
    points. Install with ``with plan:`` (or :meth:`install` /
    :meth:`uninstall`); only one plan may be active per process."""

    def __init__(self, seed: int = 0):
        self.seed = int(seed)
        self._rules: Dict[str, List[_Rule]] = {}
        self._calls: Dict[str, int] = {}
        self._rngs: Dict[str, np.random.Generator] = {}
        self._log: List[dict] = []
        self._lock = threading.Lock()

    # ------------------------------------------------------------- authoring
    def fail(self, point: str, *, at: Optional[Sequence[int]] = None,
             rate: float = 0.0,
             exc: Optional[Callable[[], BaseException]] = None) -> "FaultPlan":
        """Raise a transient :class:`FaultInjectedError` (or ``exc()``)
        BEFORE the wrapped call runs — the call's own state is untouched,
        which is what makes retrying it safe even for donated buffers."""
        self._rules.setdefault(point, []).append(
            _Rule("fail", at, rate, exc=exc))
        return self

    def delay(self, point: str, ms: float, *,
              at: Optional[Sequence[int]] = None,
              rate: float = 0.0) -> "FaultPlan":
        """Sleep ``ms`` before the wrapped call — trips deadlines and, at
        watchdog scale, simulates a hung dispatcher."""
        self._rules.setdefault(point, []).append(
            _Rule("delay", at, rate, ms=ms))
        return self

    def poison(self, point: str, mutate: Callable, *,
               at: Optional[Sequence[int]] = None,
               rate: float = 0.0) -> "FaultPlan":
        """Replace the wrapped call's result with ``mutate(result)`` —
        models a device returning garbage rather than failing loudly."""
        self._rules.setdefault(point, []).append(
            _Rule("poison", at, rate, mutate=mutate))
        return self

    # ------------------------------------------------------------ inspection
    def calls(self, point: str) -> int:
        """How many instrumented calls this plan has observed at point."""
        with self._lock:
            return self._calls.get(point, 0)

    def fired(self, point: Optional[str] = None) -> List[dict]:
        """The injection events that actually fired, in order — the
        reproducibility contract: two runs of the same seeded plan over
        the same traffic produce identical ``fired()`` lists."""
        with self._lock:
            return [dict(e) for e in self._log
                    if point is None or e["point"] == point]

    # ------------------------------------------------------------- lifecycle
    def install(self) -> "FaultPlan":
        global _ACTIVE
        with _INSTALL_LOCK:
            if _ACTIVE is not None:
                raise RuntimeError("another FaultPlan is already installed")
            _ACTIVE = self
        return self

    def uninstall(self):
        global _ACTIVE
        with _INSTALL_LOCK:
            if _ACTIVE is self:
                _ACTIVE = None

    def __enter__(self) -> "FaultPlan":
        return self.install()

    def __exit__(self, *exc):
        self.uninstall()
        return False

    # -------------------------------------------------------------- runtime
    def _rng_for(self, point: str):
        rng = self._rngs.get(point)
        if rng is None:
            rng = self._rngs[point] = np.random.default_rng(
                [self.seed, zlib.crc32(point.encode())])
        return rng

    def _decide(self, point: str):
        """Under the plan lock: advance the point's call counter, evaluate
        every rule, and return (pre_delay_ms, exception, poison_fns)."""
        with self._lock:
            index = self._calls.get(point, 0)
            self._calls[point] = index + 1
            rules = self._rules.get(point)
            if not rules:
                return 0.0, None, ()
            rng = self._rng_for(point)
            delay_ms, exc, poisons = 0.0, None, []
            for r in rules:
                if not r.triggered(index, rng):
                    continue
                self._log.append({"point": point, "index": index,
                                  "kind": r.kind})
                if r.kind == "delay":
                    delay_ms += r.ms
                elif r.kind == "fail" and exc is None:
                    exc = (r.exc() if r.exc is not None
                           else FaultInjectedError(point, index))
                elif r.kind == "poison":
                    poisons.append(r.mutate)
            return delay_ms, exc, tuple(poisons)

    def _invoke(self, point: str, call, args, kwargs):
        delay_ms, exc, poisons = self._decide(point)
        if delay_ms > 0.0:
            time.sleep(delay_ms / 1e3)
        if exc is not None:
            raise exc
        out = call(*args, **kwargs)
        for mutate in poisons:
            out = mutate(out)
        return out


_ACTIVE: Optional[FaultPlan] = None
_INSTALL_LOCK = threading.Lock()


def active_plan() -> Optional[FaultPlan]:
    return _ACTIVE


def inject(point: str, call, *args, **kwargs):
    """Run ``call(*args, **kwargs)`` under the active plan's faults for
    ``point``. When no plan is installed this is exactly the direct call —
    one global read and one branch, the whole inactive cost."""
    plan = _ACTIVE
    if plan is None:
        return call(*args, **kwargs)
    return plan._invoke(point, call, args, kwargs)


__all__ = ["FaultPlan", "FaultInjectedError", "inject", "active_plan"]
