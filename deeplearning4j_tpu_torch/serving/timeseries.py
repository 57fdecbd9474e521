"""Fleet time-series telemetry (counterpart: ``deeplearning4j_tpu/serving/
timeseries.py``): bounded rings of per-host samples and the least-squares
cost models the elasticity planner fits over them.

A point-in-time ``ServingMetrics.snapshot()`` has no history, traces
sample requests rather than hosts, and the flight recorder keeps
incidents; none answers the capacity-planning question "what does a
token per second cost on this host class, under this config?". This
module is the data half of that loop:

- a **sample** is a plain JSON-safe dict built at heartbeat cadence by
  ``ServingMetrics.timeseries_sample()`` and decorated by the host with
  its identity (``host_class``, the ``{kv_dtype, allocate,
  paged_attention}`` engine config, slot totals). Samples ride inside
  ``HostStatus`` (the versioned wire dataclass) as one defaulted field.
- :class:`TimeSeriesStore` is the bounded ring: per-host deques of the
  most recent ``capacity`` samples, folded host-side (the host's own
  ring) and fleet-side (``ClusterDirectory(timeseries=...)`` folds every
  heartbeat's sample).
- :func:`fit_cost_models` fits tokens/sec ~ a + b·occupancy per
  (host class × config) cell by ordinary least squares and converts the
  full-occupancy rate into **cost per token** (host-seconds per token by
  default; dollars when the caller prices ``host_cost_per_s``).
"""
from __future__ import annotations

import threading
import time
from collections import deque
from typing import Dict, List, Optional

import numpy as np

#: the per-heartbeat sample schema (all optional but ``t``): wall-clock
#: stamp, throughput, occupancy, pressure and self-observation gauges.
#: Producers may ship a subset; consumers must .get() with defaults.
SAMPLE_FIELDS = (
    "t",                    # wall-clock seconds (time.time) at sampling
    "tokens_per_sec",       # steady-state decode throughput
    "generated_tokens_total",
    "slot_occupancy",       # live/total decode slots, 0..1
    "kv_block_occupancy",   # in-use/total KV blocks, 0..1
    "preemptions_total",    # cumulative on_demand evictions
    "spec_acceptance_rate",  # speculative-decoding acceptance, 0..1
    "queue_depth",          # batch-inference rows waiting
    "gen_queue_depth",      # generation requests waiting
    "queue_by_class",       # {priority: cumulative admissions}
    "rss_bytes",            # process RSS at sampling
    "host_class",           # "prefill" | "decode" | "mixed"
    "config",               # {kv_dtype, allocate, paged_attention}
    "slots", "free_slots",
)


def config_key(host_class: str, config: Optional[dict]) -> str:
    """One cost-model cell's identity: host class × the engine config
    axes that move tokens/sec (kv dtype, block allocation discipline,
    paged-attention kernel). Stable string form so cells key dicts and
    survive JSON round-trips."""
    cfg = config or {}
    return (f"{host_class or 'mixed'}"
            f"|kv={cfg.get('kv_dtype', 'float32')}"
            f"|alloc={cfg.get('allocate', 'reserve')}"
            f"|paged={cfg.get('paged_attention', 'none')}")


class TimeSeriesStore:
    """Bounded per-host sample rings. Thread-safe; every reader returns
    copies (samples are shared dicts — treat them as frozen). Memory is
    fixed by construction: ``capacity`` samples per host, hosts bounded
    by fleet size (a runaway host id set is the caller's bug, not a
    leak mode this store can create)."""

    def __init__(self, capacity: int = 512):
        if capacity <= 0:
            raise ValueError("capacity must be positive")
        self.capacity = int(capacity)
        self._series: Dict[int, deque] = {}
        self._lock = threading.Lock()
        self.recorded_total = 0

    # ------------------------------------------------------------ writing
    def record(self, host_id: int, sample: dict) -> dict:
        """Fold one sample into ``host_id``'s ring. Stamps ``t`` with
        wall-clock now when the producer didn't; returns the sample."""
        if "t" not in sample:
            sample = dict(sample)
            sample["t"] = time.time()
        with self._lock:
            ring = self._series.get(int(host_id))
            if ring is None:
                ring = self._series[int(host_id)] = deque(
                    maxlen=self.capacity)
            ring.append(sample)
            self.recorded_total += 1
        return sample

    # ------------------------------------------------------------ reading
    def host_ids(self) -> List[int]:
        with self._lock:
            return sorted(self._series)

    def series(self, host_id: int) -> List[dict]:
        with self._lock:
            ring = self._series.get(int(host_id))
            return [dict(s) for s in ring] if ring is not None else []

    def latest(self, host_id: int) -> Optional[dict]:
        with self._lock:
            ring = self._series.get(int(host_id))
            return dict(ring[-1]) if ring else None

    def all_samples(self) -> List[dict]:
        """Every host's samples, flattened (fitting input)."""
        with self._lock:
            return [dict(s) for ring in self._series.values()
                    for s in ring]

    def __len__(self) -> int:
        with self._lock:
            return sum(len(r) for r in self._series.values())

    def clear(self):
        with self._lock:
            self._series.clear()

    def api_snapshot(self, limit: Optional[int] = None) -> dict:
        """The ring as one JSON-safe payload (the reference UI's
        ``GET /api/timeseries``): per-host series (most recent ``limit``
        samples each) plus the ring's own accounting."""
        with self._lock:
            hosts = {
                str(hid): {
                    "n": len(ring),
                    "latest": dict(ring[-1]) if ring else None,
                    "series": [dict(s) for s in
                               (list(ring)[-limit:] if limit is not None
                                else ring)],
                }
                for hid, ring in sorted(self._series.items())}
            recorded = self.recorded_total
        return {"capacity": self.capacity, "recorded_total": recorded,
                "hosts": hosts}


def fit_cost_models(samples, *, min_samples: int = 4,
                    host_cost_per_s: float = 1.0) -> Dict[str, dict]:
    """Least-squares cost models per (host class × config) cell.

    ``samples`` is a :class:`TimeSeriesStore` or a flat sample list.
    Each cell fits ``tokens_per_sec ~ intercept + slope · occupancy``
    (occupancy = ``slot_occupancy``, the utilization axis join/drain
    actually moves) by ``np.linalg.lstsq`` over samples that carry both
    fields, then prices the FULL-occupancy rate:

        ``cost_per_token = host_cost_per_s / tokens_per_sec@occ=1``

    host-seconds per token with the default unit cost — multiply by a
    $/host-second rate for dollars. Cells with fewer than
    ``min_samples`` usable samples, or a non-positive predicted rate,
    are reported with ``cost_per_token=None`` (the planner must never
    act on a curve fit through noise). Returns ``{config_key: model}``
    where model carries intercept/slope/n/r2/tokens_per_sec_at_full/
    cost_per_token."""
    if isinstance(samples, TimeSeriesStore):
        samples = samples.all_samples()
    if host_cost_per_s <= 0:
        raise ValueError("host_cost_per_s must be positive")
    cells: Dict[str, List[dict]] = {}
    for s in samples:
        rate = s.get("tokens_per_sec")
        occ = s.get("slot_occupancy")
        if rate is None or occ is None:
            continue
        key = config_key(s.get("host_class", "mixed"), s.get("config"))
        cells.setdefault(key, []).append(s)
    models: Dict[str, dict] = {}
    for key, rows in sorted(cells.items()):
        n = len(rows)
        occ = np.asarray([float(s["slot_occupancy"]) for s in rows])
        rate = np.asarray([float(s["tokens_per_sec"]) for s in rows])
        model = {"n": n, "intercept": None, "slope": None, "r2": None,
                 "tokens_per_sec_at_full": None, "cost_per_token": None,
                 "mean_tokens_per_sec": float(rate.mean()) if n else 0.0}
        if n >= min_samples:
            design = np.stack([np.ones_like(occ), occ], axis=1)
            coef, *_ = np.linalg.lstsq(design, rate, rcond=None)
            a, b = float(coef[0]), float(coef[1])
            pred = design @ coef
            ss_res = float(((rate - pred) ** 2).sum())
            ss_tot = float(((rate - rate.mean()) ** 2).sum())
            at_full = a + b * 1.0
            model.update(
                intercept=a, slope=b,
                r2=(1.0 - ss_res / ss_tot) if ss_tot > 0 else 1.0,
                tokens_per_sec_at_full=at_full,
                cost_per_token=(host_cost_per_s / at_full
                                if at_full > 0 else None))
        models[key] = model
    return models


def cheapest_cell(models: Dict[str, dict]) -> Optional[str]:
    """The config cell with the lowest fitted cost-per-token (ties:
    lexical key, for determinism); None when no cell has a usable
    fit."""
    best = None
    for key, m in sorted(models.items()):
        cpt = m.get("cost_per_token")
        if cpt is None:
            continue
        if best is None or cpt < best[0]:
            best = (cpt, key)
    return None if best is None else best[1]


__all__ = ["TimeSeriesStore", "fit_cost_models", "cheapest_cell",
           "config_key", "SAMPLE_FIELDS"]
