"""Admission control for the generation engine: a bounded FIFO request
queue with backpressure, per-request deadlines and typed shedding
(counterpart: ``deeplearning4j_tpu/serving/admission.py``, its plain FIFO
path — the QoS queues and request traces are not ported yet).

An overloaded server turns unbounded queueing into an immediate typed
rejection the caller can act on: a full queue rejects at submit, and
requests whose deadline passed are shed at dequeue time without ever
occupying a slot.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from concurrent.futures import Future, InvalidStateError
from dataclasses import dataclass, field
from typing import Callable, Optional


class RejectedError(RuntimeError):
    """Request refused. ``reason`` is machine-readable: 'queue_full' |
    'deadline' | 'shutdown' | 'kv_blocks_exhausted'."""

    def __init__(self, msg: str, reason: str):
        super().__init__(msg)
        self.reason = reason


class QueueFullError(RejectedError):
    """Backpressure rejection, with the observed ``depth`` and the
    configured ``capacity`` (in the controller's unit)."""

    def __init__(self, msg: str, depth: Optional[int] = None,
                 capacity: Optional[int] = None):
        super().__init__(msg, "queue_full")
        self.depth = depth
        self.capacity = capacity


class DeadlineExceededError(RejectedError):
    def __init__(self, msg: str):
        super().__init__(msg, "deadline")


class KVBlocksExhaustedError(RejectedError):
    """The paged KV block pool can never serve this request: its
    worst-case block reservation exceeds the pool's capacity. Transient
    pressure (blocks held by live streams) is not this error — such
    requests wait in the queue. Carries ``needed`` / ``usable`` /
    ``capacity`` in blocks."""

    def __init__(self, msg: str, needed: Optional[int] = None,
                 usable: Optional[int] = None,
                 capacity: Optional[int] = None):
        super().__init__(msg, "kv_blocks_exhausted")
        self.needed = needed
        self.usable = usable
        self.capacity = capacity


@dataclass
class Request:
    """One submitted request (``rows`` units of queue budget)."""

    x: object
    rows: int
    future: Future = field(default_factory=Future)
    submit_t: float = field(default_factory=time.perf_counter)
    deadline_t: Optional[float] = None   # perf_counter timestamp, or None

    def expired(self, now: Optional[float] = None) -> bool:
        if self.deadline_t is None:
            return False
        return (now if now is not None else time.perf_counter()) \
            >= self.deadline_t


class AdmissionController:
    """Bounded FIFO of :class:`Request` measured in ``rows``.

    - ``admit()`` raises :class:`QueueFullError` when the capacity would be
      exceeded.
    - ``take(max_rows, timeout)`` pops the head if it fits; expired heads
      are shed (future failed with :class:`DeadlineExceededError`).
    - ``close()`` wakes the consumer and rejects everything still queued.

    Futures are always failed outside the lock: ``set_exception`` runs
    done-callbacks synchronously, and one that re-enters the controller
    would deadlock on it."""

    def __init__(self, capacity_rows: int = 1024,
                 default_timeout_ms: Optional[float] = None,
                 unit: str = "rows"):
        if capacity_rows <= 0:
            raise ValueError("capacity_rows must be positive")
        self.capacity_rows = capacity_rows
        self.default_timeout_ms = default_timeout_ms
        self.unit = unit
        self._q: deque = deque()
        self._rows = 0
        self._cv = threading.Condition()
        self._closed = False
        # observer hooks, called with each shed / close-rejected request
        # after its future is failed (not for one someone else resolved)
        self.on_shed: Optional[Callable[[Request], None]] = None
        self.on_close_reject: Optional[Callable[[Request], None]] = None

    @property
    def depth_requests(self) -> int:
        with self._cv:
            return len(self._q)

    def admit(self, req: Request, timeout_ms: Optional[float] = None
              ) -> Request:
        """Enqueue or raise. ``timeout_ms`` (or the controller default)
        stamps the request's deadline relative to its submit time."""
        tmo = timeout_ms if timeout_ms is not None \
            else self.default_timeout_ms
        if tmo is not None:
            req.deadline_t = req.submit_t + tmo / 1000.0
        with self._cv:
            if self._closed:
                raise RejectedError("engine is shut down", "shutdown")
            if self._rows + req.rows > self.capacity_rows:
                raise QueueFullError(
                    f"queue full: {self._rows} {self.unit} queued + "
                    f"{req.rows} submitted > capacity {self.capacity_rows} "
                    f"{self.unit}", depth=self._rows,
                    capacity=self.capacity_rows)
            self._q.append(req)
            self._rows += req.rows
            self._cv.notify()
        return req

    def _shed(self, req: Request):
        waited_ms = (time.perf_counter() - req.submit_t) * 1e3
        try:
            req.future.set_exception(DeadlineExceededError(
                f"deadline exceeded after {waited_ms:.1f} ms in queue"))
        except InvalidStateError:
            return   # the caller cancelled it while queued
        if self.on_shed is not None:
            self.on_shed(req)

    def take(self, max_rows: int, timeout: float) -> Optional[Request]:
        """Pop the head request if it fits in ``max_rows``; wait up to
        ``timeout`` seconds for one. Returns None on timeout, on close,
        or when the head does not fit."""
        end = time.perf_counter() + timeout
        while True:
            shed, out, decided = [], None, False
            with self._cv:
                while True:
                    if self._q:
                        head = self._q[0]
                        if head.expired():
                            self._q.popleft()
                            self._rows -= head.rows
                            shed.append(head)
                            continue
                        decided = True
                        if head.rows <= max_rows:
                            self._q.popleft()
                            self._rows -= head.rows
                            out = head
                        break
                    remaining = end - time.perf_counter()
                    if self._closed or remaining <= 0:
                        decided = True
                        break
                    if shed:
                        break   # drop the lock to fail shed futures first
                    self._cv.wait(remaining)
            for req in shed:
                self._shed(req)
            if decided:
                return out

    def requeue_head(self, req: Request):
        """Return a just-dequeued request to the queue head (the paged
        scheduler does this when the pool cannot serve it yet); after
        ``close()`` it is rejected like the rest of the queue."""
        with self._cv:
            if not self._closed:
                self._q.appendleft(req)
                self._rows += req.rows
                self._cv.notify()
                return
        self._reject_closed(req)

    def expire_queued(self) -> int:
        """Shed every expired request still queued; returns how many. A
        slot-bound scheduler only calls ``take()`` when a slot is free, so
        without this sweep a dead prompt would hold queue budget under
        full occupancy."""
        now = time.perf_counter()
        with self._cv:
            shed = [r for r in self._q if r.expired(now)]
            if shed:
                self._q = deque(r for r in self._q if not r.expired(now))
                self._rows = sum(r.rows for r in self._q)
        for req in shed:
            self._shed(req)
        return len(shed)

    def close(self):
        with self._cv:
            self._closed = True
            pending = list(self._q)
            self._q.clear()
            self._rows = 0
            self._cv.notify_all()
        for req in pending:
            self._reject_closed(req)

    def _reject_closed(self, req: Request):
        try:
            req.future.set_exception(
                RejectedError("engine shut down with request queued",
                              "shutdown"))
        except InvalidStateError:
            return   # the caller cancelled it while queued
        if self.on_close_reject is not None:
            self.on_close_reject(req)
