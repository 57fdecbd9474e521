"""Failure isolation for the serving engine (counterpart:
``deeplearning4j_tpu/serving/resilience.py``). Only the circuit breaker is
ported: the generation engine's speculative draft leg runs behind one, so
a failing draft degrades its turns to plain decode instead of failing
again on every turn. Retry policies, the watchdog and the engine mixin are
not ported yet."""
from __future__ import annotations

import threading
import time
from typing import Callable


class CircuitBreaker:
    """CLOSED -> OPEN after ``failure_threshold`` CONSECUTIVE failures;
    while OPEN, :meth:`allow` returns False until ``cooldown_s`` elapses,
    then exactly ONE caller gets a HALF_OPEN probe, whose outcome closes
    the breaker or re-opens it for another cooldown. Thread-safe."""

    CLOSED = "CLOSED"
    OPEN = "OPEN"
    HALF_OPEN = "HALF_OPEN"

    def __init__(self, failure_threshold: int = 5, cooldown_s: float = 5.0,
                 name: str = "", clock: Callable[[], float] = time.monotonic):
        if failure_threshold < 1:
            raise ValueError("failure_threshold must be >= 1")
        self.failure_threshold = failure_threshold
        self.cooldown_s = cooldown_s
        self.name = name
        self._clock = clock
        self._state = self.CLOSED
        self._consecutive = 0
        self._opened_at = 0.0
        self._probe_inflight = False
        self._probe_started = 0.0
        self._lock = threading.Lock()

    @property
    def state(self) -> str:
        with self._lock:
            return self._state

    @property
    def consecutive_failures(self) -> int:
        with self._lock:
            return self._consecutive

    def allow(self) -> bool:
        """CLOSED: always. OPEN: False until the cooldown expires, then the
        first caller flips to HALF_OPEN and is the probe. HALF_OPEN: only
        while no probe is outstanding; a probe older than another full
        cooldown counts as lost and its permit is granted again, so the
        breaker cannot wedge in HALF_OPEN."""
        with self._lock:
            if self._state == self.CLOSED:
                return True
            now = self._clock()
            if self._state == self.OPEN:
                if now - self._opened_at < self.cooldown_s:
                    return False
                self._state = self.HALF_OPEN
                self._probe_inflight = True
                self._probe_started = now
                return True
            if self._probe_inflight and \
                    now - self._probe_started >= self.cooldown_s:
                self._probe_inflight = False   # lost probe: grant again
            ok = not self._probe_inflight
            if ok:
                self._probe_inflight = True
                self._probe_started = now
            return ok

    def record_success(self):
        with self._lock:
            self._consecutive = 0
            self._probe_inflight = False
            self._state = self.CLOSED

    def record_failure(self):
        with self._lock:
            self._consecutive += 1
            self._probe_inflight = False
            if self._state == self.HALF_OPEN or (
                    self._state == self.CLOSED
                    and self._consecutive >= self.failure_threshold):
                self._opened_at = self._clock()
                self._state = self.OPEN
            elif self._state == self.OPEN:
                # a straggler failure while OPEN re-arms the cooldown
                self._opened_at = self._clock()
