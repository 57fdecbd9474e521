"""Trace-driven workload generation (counterpart: ``deeplearning4j_tpu/
serving/loadgen.py``): sustained, realistic load in Dean & Barroso's
"Tail at Scale" sense, not one-shot scenario prompts.

Three pieces, each usable alone:

- :class:`TraceSpec` → ``generate()``: a seeded, fully deterministic
  synthetic trace. Three request families model the production mix —
  **chat** (short prompt behind a shared system prefix, long decode),
  **rag** (huge prompt, short decode) and **batch** (medium shapes,
  arriving in bursty clumps under the ``batch`` QoS class). Arrival
  times come from an :class:`ArrivalProcess` (Poisson, on/off bursts,
  or a linear ramp). Same seed → identical trace, the JAX package's
  included, so an incident replays from its seed alone.
- :class:`LoadGenerator` → ``run()``: replays a trace against any
  submit surface — a :class:`~.generation.GenerationEngine`, a
  :class:`~.cluster.ClusterFrontDoor`, or the HTTP RPC plane via
  :func:`main` — pacing submissions on the trace's arrival clock and
  recording one :class:`RequestRecord` per stream (TTFT, latency,
  terminal reason, and the watermark check: the tokens streamed via
  ``on_token`` must be EXACTLY the final result, no dup, no skip).
- :class:`LoadReport`: the aggregate — sustained tokens/sec, windowed
  latency percentiles (p99 inside chaos windows apart from p99 outside
  them), terminal-reason mix, stuck-stream count.

Standalone driver::

    python -m deeplearning4j_tpu_torch.serving.loadgen \
        --url http://127.0.0.1:8471 --url http://127.0.0.1:8472 \
        --seed 7 --duration-s 30 --rate-rps 4

builds RemoteHost handles over the given RPC endpoints, fronts them
with a ClusterFrontDoor, replays the seeded trace and prints the
report as one JSON line. The hosts run their engines wherever they were
started (``device="cuda"`` by default); this command touches no device.
"""
from __future__ import annotations

import dataclasses
import threading
import time
import zlib
from typing import Callable, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np

from deeplearning4j_tpu_torch.serving.tracing import terminal_reason

__all__ = [
    "ArrivalProcess", "LoadGenerator", "LoadReport", "RequestRecord",
    "TraceRequest", "TraceSpec", "WORKLOAD_KINDS",
    "engine_submitter", "front_door_submitter",
]

WORKLOAD_KINDS = ("chat", "rag", "batch")


def _rng(seed: int, label: str) -> np.random.Generator:
    """Stream-split PRNG, the faults.py idiom: one seed, independent
    streams per label, reproducible regardless of call order."""
    return np.random.default_rng([int(seed), zlib.crc32(label.encode())])


# ------------------------------------------------------------------ arrivals
@dataclasses.dataclass(frozen=True)
class ArrivalProcess:
    """Seeded arrival-time generator over a fixed horizon.

    ``kind`` selects the process:

    - ``"poisson"`` — homogeneous, exponential gaps at ``rate_rps``.
    - ``"onoff"`` — bursty: alternate ``on_s`` seconds at ``rate_rps``
      with ``off_s`` seconds at ``off_rate_rps`` (the classic on/off
      source; stresses admission backpressure at the on-edge).
    - ``"ramp"`` — inhomogeneous Poisson thinned from ``rate_rps``,
      intensity ramping linearly ``start_rate_rps`` → ``rate_rps``
      over the horizon (capacity-planning shape: does the fleet keep
      its SLO as load grows?).
    """

    kind: str = "poisson"
    rate_rps: float = 8.0
    on_s: float = 2.0
    off_s: float = 1.0
    off_rate_rps: float = 0.5
    start_rate_rps: float = 1.0

    def __post_init__(self):
        if self.kind not in ("poisson", "onoff", "ramp"):
            raise ValueError(f"unknown arrival kind {self.kind!r}")
        if self.rate_rps <= 0:
            raise ValueError("rate_rps must be positive")

    def arrivals(self, duration_s: float,
                 rng: np.random.Generator) -> List[float]:
        """Sorted arrival offsets in ``[0, duration_s)``."""
        out: List[float] = []
        t = 0.0
        if self.kind == "poisson":
            while True:
                t += rng.exponential(1.0 / self.rate_rps)
                if t >= duration_s:
                    return out
                out.append(t)
        if self.kind == "onoff":
            # piecewise-constant-rate process: a gap that would cross
            # the current window's edge is clamped there and redrawn at
            # the next window's rate — exact, because the exponential
            # is memoryless (no thinning, no off-window bleed)
            period = self.on_s + self.off_s
            while True:
                phase = t % period
                on = phase < self.on_s
                rate = self.rate_rps if on else self.off_rate_rps
                edge = t + ((self.on_s - phase) if on
                            else (period - phase))
                if rate <= 0:       # silent window: jump to its end
                    t = edge
                    if t >= duration_s:
                        return out
                    continue
                step = rng.exponential(1.0 / rate)
                if t + step >= edge:
                    t = edge
                    if t >= duration_s:
                        return out
                    continue
                t += step
                if t >= duration_s:
                    return out
                out.append(t)
        # ramp: thinning (Lewis & Shedler) against the peak rate keeps
        # the draw count — hence the replayed schedule — seed-stable
        peak = max(self.rate_rps, self.start_rate_rps)
        while True:
            t += rng.exponential(1.0 / peak)
            if t >= duration_s:
                return out
            frac = t / duration_s
            rate = self.start_rate_rps \
                + (self.rate_rps - self.start_rate_rps) * frac
            if rng.uniform() * peak < rate:
                out.append(t)


# --------------------------------------------------------------------- trace
@dataclasses.dataclass(frozen=True)
class TraceRequest:
    """One scheduled request. ``prompt`` is a token tuple (frozen and
    hashable — the replay contract wants value identity); ``seed`` is
    the request's own sampling seed so a re-dispatched or replayed
    stream regenerates bit-identically."""

    index: int
    arrival_s: float
    kind: str
    prompt: Tuple[int, ...]
    max_new_tokens: int
    tenant: str
    priority: Optional[str]
    seed: int

    def prompt_array(self) -> np.ndarray:
        return np.asarray(self.prompt, np.int32)


@dataclasses.dataclass(frozen=True)
class TraceSpec:
    """Seeded synthetic-trace recipe. ``generate()`` is a pure function
    of the spec — the seed IS the trace.

    ``max_len`` bounds prompt + decode to the serving engine's per-slot
    capacity; family shapes scale inside it. ``mix`` weights the three
    families (normalized; a family can be zeroed out).
    """

    seed: int = 0
    duration_s: float = 10.0
    vocab_size: int = 50
    max_len: int = 48
    mix: Mapping[str, float] = dataclasses.field(
        default_factory=lambda: {"chat": 0.5, "rag": 0.25, "batch": 0.25})
    arrival: ArrivalProcess = dataclasses.field(
        default_factory=ArrivalProcess)
    system_prefix_len: int = 6
    n_chat_tenants: int = 3
    burst_size: int = 3

    def system_prefix(self) -> Tuple[int, ...]:
        """The shared chat system prefix — deterministic from the seed,
        identical across every chat request (register it once via
        ``GenerationEngine.register_prefix`` / the front door to
        exercise copy-on-write sharing under chaos)."""
        rng = _rng(self.seed, "loadgen.system_prefix")
        return tuple(int(x) for x in
                     rng.integers(1, self.vocab_size,
                                  self.system_prefix_len))

    def generate(self) -> List[TraceRequest]:
        weights = {k: float(self.mix.get(k, 0.0)) for k in WORKLOAD_KINDS}
        total = sum(weights.values())
        if total <= 0:
            raise ValueError("TraceSpec.mix sums to zero")
        probs = np.asarray([weights[k] / total for k in WORKLOAD_KINDS])
        rng = _rng(self.seed, "loadgen.trace")
        sys_prefix = self.system_prefix()
        out: List[TraceRequest] = []
        for t in self.arrival.arrivals(self.duration_s, rng):
            kind = WORKLOAD_KINDS[int(rng.choice(len(WORKLOAD_KINDS),
                                                 p=probs))]
            if kind == "batch":
                # bursty batch: one arrival fans into a clump landing
                # within ~50 ms (the queue-pressure shape)
                n = int(rng.integers(1, self.burst_size + 1))
                for _ in range(n):
                    out.append(self._request(
                        len(out), t + float(rng.uniform(0.0, 0.05)),
                        kind, rng, sys_prefix))
            else:
                out.append(self._request(len(out), t, kind, rng,
                                         sys_prefix))
        out.sort(key=lambda r: (r.arrival_s, r.index))
        return [dataclasses.replace(r, index=i)
                for i, r in enumerate(out)]

    def _request(self, index: int, at: float, kind: str,
                 rng: np.random.Generator,
                 sys_prefix: Tuple[int, ...]) -> TraceRequest:
        cap = self.max_len
        if kind == "chat":
            decode = int(rng.integers(8, max(10, cap // 2)))
            decode = min(decode, cap - len(sys_prefix) - 4)
            plen = int(rng.integers(2, max(3, cap // 6)))
            plen = min(plen, cap - decode - len(sys_prefix))
            body = tuple(int(x) for x in
                         rng.integers(1, self.vocab_size, plen))
            prompt = sys_prefix + body
            tenant = f"chat{int(rng.integers(self.n_chat_tenants))}"
            priority: Optional[str] = "interactive"
        elif kind == "rag":
            decode = int(rng.integers(2, 7))
            plen = int(rng.integers(max(2, cap - decode - 8),
                                    cap - decode))
            prompt = tuple(int(x) for x in
                           rng.integers(1, self.vocab_size, plen))
            tenant, priority = "rag", "interactive"
        else:   # batch
            decode = int(rng.integers(4, max(6, cap // 3)))
            plen = int(rng.integers(4, max(6, cap // 3)))
            plen = min(plen, cap - decode)
            prompt = tuple(int(x) for x in
                           rng.integers(1, self.vocab_size, plen))
            tenant, priority = "batch", "batch"
        return TraceRequest(index=index, arrival_s=float(at), kind=kind,
                            prompt=prompt, max_new_tokens=max(1, decode),
                            tenant=tenant, priority=priority,
                            seed=int(rng.integers(2 ** 31)))


# ------------------------------------------------------------------- records
@dataclasses.dataclass
class RequestRecord:
    """Outcome of one replayed stream (wall times are perf_counter)."""

    index: int
    kind: str
    tenant: str
    submit_t: float
    done_t: Optional[float] = None
    first_token_t: Optional[float] = None
    tokens: int = 0
    reason: str = "pending"
    ok: bool = False
    watermark_clean: bool = True

    @property
    def stuck(self) -> bool:
        return self.done_t is None

    @property
    def latency_ms(self) -> Optional[float]:
        if self.done_t is None:
            return None
        return (self.done_t - self.submit_t) * 1e3

    @property
    def ttft_ms(self) -> Optional[float]:
        if self.first_token_t is None:
            return None
        return (self.first_token_t - self.submit_t) * 1e3


def _percentile(values: Sequence[float], q: float) -> Optional[float]:
    if not values:
        return None
    return float(np.percentile(np.asarray(values, np.float64), q))


class LoadReport:
    """Aggregate over a replay's records.

    ``windows`` (optional ``[(start_t, end_t), ...]`` in the same
    perf_counter timebase) classifies completions as *inside* or
    *outside* those spans — pass chaos-episode windows and "p99 during
    vs between episodes" falls out of one record set.
    """

    def __init__(self, records: Sequence[RequestRecord],
                 started_t: float, finished_t: float):
        self.records = list(records)
        self.started_t = started_t
        self.finished_t = finished_t

    # ------------------------------------------------------------ aggregates
    @property
    def duration_s(self) -> float:
        return max(self.finished_t - self.started_t, 1e-9)

    @property
    def completed(self) -> List[RequestRecord]:
        return [r for r in self.records if not r.stuck]

    @property
    def stuck_streams(self) -> int:
        return sum(1 for r in self.records if r.stuck)

    @property
    def total_tokens(self) -> int:
        return sum(r.tokens for r in self.records)

    @property
    def tokens_per_sec(self) -> float:
        return self.total_tokens / self.duration_s

    @property
    def watermark_clean(self) -> bool:
        """True iff every OK stream delivered exactly its final token
        list through ``on_token`` — no duplicate, no skip."""
        return all(r.watermark_clean for r in self.records if r.ok)

    def reasons(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for r in self.records:
            out[r.reason] = out.get(r.reason, 0) + 1
        return out

    def latency_percentile(self, q: float,
                           windows: Optional[Sequence[Tuple[float, float]]]
                           = None,
                           inside: bool = True) -> Optional[float]:
        vals = []
        for r in self.completed:
            if windows is not None:
                hit = any(a <= r.done_t <= b for a, b in windows)
                if hit != inside:
                    continue
            vals.append(r.latency_ms)
        return _percentile(vals, q)

    def ttft_percentile(self, q: float) -> Optional[float]:
        return _percentile([r.ttft_ms for r in self.completed
                            if r.ttft_ms is not None], q)

    def to_dict(self, windows: Optional[Sequence[Tuple[float, float]]]
                = None) -> dict:
        ok = [r for r in self.records if r.ok]
        return {
            "requests": len(self.records),
            "ok": len(ok),
            "stuck_streams": self.stuck_streams,
            "duration_s": round(self.duration_s, 3),
            "tokens_per_sec": round(self.tokens_per_sec, 2),
            "total_tokens": self.total_tokens,
            "watermark_clean": self.watermark_clean,
            "reasons": self.reasons(),
            "ttft_p50_ms": self.ttft_percentile(50),
            "ttft_p99_ms": self.ttft_percentile(99),
            "latency_p50_ms": self.latency_percentile(50),
            "latency_p99_ms": self.latency_percentile(99),
            "latency_p99_during_episodes_ms":
                self.latency_percentile(99, windows, inside=True)
                if windows else None,
            "latency_p99_between_episodes_ms":
                self.latency_percentile(99, windows, inside=False)
                if windows else None,
        }


# ----------------------------------------------------------------- submitters
def engine_submitter(engine) -> Callable:
    """Adapter: replay straight into one GenerationEngine."""

    def submit(tr: TraceRequest, on_token):
        return engine.submit(tr.prompt_array(),
                             max_new_tokens=tr.max_new_tokens,
                             seed=tr.seed, tenant=tr.tenant,
                             priority=tr.priority, on_token=on_token)
    return submit


def front_door_submitter(front_door) -> Callable:
    """Adapter: replay through a ClusterFrontDoor (loopback hosts or the
    HTTP RPC plane — routing, hedging and re-dispatch included)."""

    def submit(tr: TraceRequest, on_token):
        return front_door.submit_generate(
            tr.prompt_array(), max_new_tokens=tr.max_new_tokens,
            seed=tr.seed, tenant=tr.tenant, priority=tr.priority,
            on_token=on_token)
    return submit


# -------------------------------------------------------------------- driver
class LoadGenerator:
    """Replays a trace against a submit adapter on its arrival clock.

    ``speed`` scales the clock (2.0 = twice as fast); ``drain_timeout_s``
    bounds the wait for stragglers after the last submit — anything
    unresolved past it is recorded as STUCK (``reason="stuck"`` is a
    report label, not a serving terminal: no taxonomy entry).
    """

    def __init__(self, trace: Sequence[TraceRequest], submit: Callable,
                 *, speed: float = 1.0, drain_timeout_s: float = 60.0):
        if speed <= 0:
            raise ValueError("speed must be positive")
        self.trace = list(trace)
        self.submit = submit
        self.speed = speed
        self.drain_timeout_s = drain_timeout_s
        self._lock = threading.Lock()

    def run(self) -> LoadReport:
        records: List[RequestRecord] = []
        handles: List[Tuple[RequestRecord, object, list]] = []
        done = threading.Event()
        pending = [0]
        t0 = time.perf_counter()
        for tr in self.trace:
            due = t0 + tr.arrival_s / self.speed
            delay = due - time.perf_counter()
            if delay > 0:
                time.sleep(delay)
            rec = RequestRecord(index=tr.index, kind=tr.kind,
                                tenant=tr.tenant,
                                submit_t=time.perf_counter())
            records.append(rec)
            streamed: List[int] = []

            def on_token(tok, rec=rec, streamed=streamed):
                if rec.first_token_t is None:
                    rec.first_token_t = time.perf_counter()
                streamed.append(int(tok))

            try:
                handle = self.submit(tr, on_token)
            except Exception as e:   # typed submit-time shed: a record,
                rec.done_t = time.perf_counter()   # never a replay abort
                rec.reason = self._reason(e)
                continue
            with self._lock:
                pending[0] += 1
            handles.append((rec, handle, streamed))
            handle.future.add_done_callback(
                lambda fut, rec=rec, streamed=streamed:
                    self._on_done(rec, fut, streamed, pending, done))
        deadline = time.monotonic() + self.drain_timeout_s
        while time.monotonic() < deadline:
            with self._lock:
                if pending[0] == 0:
                    break
            done.wait(timeout=0.05)
            done.clear()
        for rec, handle, streamed in handles:
            if rec.done_t is None:     # still unresolved: stuck stream
                rec.reason = "stuck"
                rec.tokens = len(streamed)
        return LoadReport(records, t0, time.perf_counter())

    @staticmethod
    def _reason(exc: BaseException) -> str:
        reason = getattr(exc, "reason", None)
        return reason if isinstance(reason, str) else terminal_reason(exc)

    def _on_done(self, rec: RequestRecord, fut, streamed: List[int],
                 pending: List[int], done: threading.Event):
        rec.done_t = time.perf_counter()
        exc = fut.exception()
        if exc is None:
            result = list(fut.result())
            rec.ok = True
            rec.reason = "ok"
            rec.tokens = len(result)
            # THE watermark check: the streamed sequence must be the
            # final result exactly — a duplicated chunk (re-dispatch
            # replaying delivered tokens) or a skipped one (cursor
            # raced past a loss) both fail it
            rec.watermark_clean = streamed == result
        else:
            rec.reason = self._reason(exc)
            rec.tokens = len(streamed)
        with self._lock:
            pending[0] -= 1
        done.set()


# ----------------------------------------------------------------- CLI (RPC)
def run_over_rpc(urls: Sequence[str], spec: TraceSpec, *,
                 speed: float = 1.0, drain_timeout_s: float = 60.0,
                 hedge=None) -> LoadReport:
    """Drive a live HTTP RPC fleet with the seeded trace:
    RemoteHost handles over ``urls``, a directory kept warm by real
    heartbeat pumps, a hedging front door doing the routing."""
    from deeplearning4j_tpu_torch.serving.cluster import (
        ClusterDirectory, ClusterFrontDoor, HeartbeatPump,
        LoopbackTransport,
    )
    from deeplearning4j_tpu_torch.serving.rpc import RemoteHost

    directory = ClusterDirectory(heartbeat_timeout_s=10.0)
    pumps = []
    for i, url in enumerate(urls):
        rem = RemoteHost(i, url)
        directory.join(rem)
        pump = HeartbeatPump(rem, LoopbackTransport(directory))
        pump.pump_once()
        pump.start()
        pumps.append(pump)
    fd = ClusterFrontDoor(directory, hedge=hedge)
    try:
        gen = LoadGenerator(spec.generate(), front_door_submitter(fd),
                            speed=speed, drain_timeout_s=drain_timeout_s)
        return gen.run()
    finally:
        for pump in pumps:
            pump.stop()


def main(argv: Optional[Sequence[str]] = None) -> int:
    import argparse
    import json

    ap = argparse.ArgumentParser(
        description="Seeded trace-driven load over the HTTP RPC plane")
    ap.add_argument("--url", action="append", required=True,
                    help="host RPC endpoint (repeatable)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--duration-s", type=float, default=10.0)
    ap.add_argument("--rate-rps", type=float, default=4.0)
    ap.add_argument("--arrival", default="poisson",
                    choices=("poisson", "onoff", "ramp"))
    ap.add_argument("--vocab-size", type=int, default=50)
    ap.add_argument("--max-len", type=int, default=48)
    ap.add_argument("--speed", type=float, default=1.0)
    args = ap.parse_args(argv)
    spec = TraceSpec(seed=args.seed, duration_s=args.duration_s,
                     vocab_size=args.vocab_size, max_len=args.max_len,
                     arrival=ArrivalProcess(kind=args.arrival,
                                            rate_rps=args.rate_rps))
    report = run_over_rpc(args.url, spec, speed=args.speed)
    print(json.dumps(report.to_dict()))
    return 0 if report.stuck_streams == 0 else 1


if __name__ == "__main__":
    raise SystemExit(main())
