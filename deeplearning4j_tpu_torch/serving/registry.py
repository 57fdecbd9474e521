"""Versioned model registry for the serving runtime (counterpart:
``deeplearning4j_tpu/serving/registry.py``). The lifecycle is TF-Serving's
and Clipper's servable lifecycle: deploy -> warmup -> ready -> undeploy,
with monotone integer versions per name and mutable aliases for routing.

A model adapter normalizes a model to ONE row-in/row-out contract the
batching engine can serve: ``infer(batch) -> np.ndarray`` on the host.
The port serves :class:`CausalLMAdapter` (the causal LM of
``models/bert.py``: last-position logits for the batching engine, and the
continuous-batching generation engine) and any caller-written
:class:`ModelAdapter`; the reference's adapters for ``MultiLayerNetwork``,
``ComputationGraph`` and ``SameDiff`` come with the port of those model
kinds.

Warmup on deploy: ``deploy(warmup_example=...)`` tiles one example row to
every bucket and runs the model once per rung before the deployment
becomes visible (the reference compiles each rung's executable there; the
port's first call at each shape sets up cuBLAS's plans and the caching
allocator's blocks).

Under a mesh of ranks (``CausalLMAdapter(mesh=)``) every rank of the mesh
deploys the same model and builds its engines with the same arguments:
a deploy-time warmup runs the adapter, and with it the mesh's
collectives, on every rank; :meth:`ModelRegistry.engine` with ``mesh=``
re-ladders to multiples of the mesh's 'data' size.
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from deeplearning4j_tpu_torch import default_device
from deeplearning4j_tpu_torch.parallel.mesh import DATA_AXIS
from deeplearning4j_tpu_torch.serving.faults import inject
from deeplearning4j_tpu_torch.serving.metrics import ServingMetrics
from deeplearning4j_tpu_torch.serving.resilience import (
    CircuitBreaker, RetryBudget)
from deeplearning4j_tpu_torch.serving.tracing import flight_recorder


def tile_rows(example_row, batch: int) -> np.ndarray:
    """Tile ONE example row (feature shape, no batch dim) into a
    ``batch``-row array — the shared warmup idiom (registry deploy and
    engine warmup)."""
    ex = np.asarray(example_row)
    return np.broadcast_to(ex, (batch,) + ex.shape).copy()


class ModelAdapter:
    """Uniform inference surface: ``infer(batch) -> np.ndarray`` (host),
    row i of the output belonging to row i of the input."""

    kind: str = "unknown"

    def __init__(self, model):
        self.model = model

    def infer(self, x) -> np.ndarray:
        raise NotImplementedError

    def cache_size(self) -> Optional[int]:
        """Live compiled-signature count of the model's executable cache,
        or None when there is none (every port adapter: it runs
        eagerly)."""
        return None


class CausalLMAdapter(ModelAdapter):
    """Generative surface for the causal LM (models/bert.py): ``params``
    is the parameter tree, plus the TransformerConfig. Serves both engine
    kinds — :meth:`infer` gives last-position logits for the batching
    :class:`~.engine.InferenceEngine`, :meth:`generation_engine` builds
    the continuous-batching :class:`~.generation.GenerationEngine`.
    ``device`` defaults to ``"cuda"``. Under ``mesh`` every rank of the
    mesh builds the adapter with the same global ``params``: :meth:`infer`
    runs ``make_infer_last_logits(cfg, mesh)`` on the rank's
    ``place_params`` shards (every rank passes the same batch and gets the
    whole logits), and :meth:`generation_engine` serves on the mesh."""

    kind = "CausalLM"

    def __init__(self, params, cfg, mesh=None, *, device=None):
        super().__init__(model=params)
        if not cfg.causal:
            raise ValueError("CausalLMAdapter needs TransformerConfig("
                             "causal=True)")
        self.params = params
        self.cfg = cfg
        self.mesh = mesh
        self.device = default_device(device)
        self._fwd = None
        self._compute = None
        self._init_lock = threading.Lock()

    def infer(self, x) -> np.ndarray:
        """Token ids (B, T) -> last-position logits (B, vocab) fp32. The
        ids go to the adapter's device, the logits come back to the host
        as a numpy copy."""
        with self._init_lock:
            if self._fwd is None:
                from deeplearning4j_tpu_torch.models.bert import (
                    compute_params, make_infer_last_logits, place_params)

                # one compute-dtype copy of the weights (of this rank's
                # shards under a mesh) for every call (bitwise the master
                # weights' results)
                params = self.params if self.mesh is None \
                    else place_params(self.params, self.cfg, self.mesh)
                self._compute = compute_params(params, self.cfg, self.device)
                self._fwd = make_infer_last_logits(self.cfg, self.mesh)
        tokens = torch.from_numpy(
            np.array(x, dtype=np.int32, copy=True)).to(self.device)
        return self._fwd(self._compute, tokens).cpu().numpy()

    def generation_engine(self, **engine_kwargs):
        from deeplearning4j_tpu_torch.serving.generation import (
            GenerationEngine)

        engine_kwargs.setdefault("device", self.device)
        engine_kwargs.setdefault("mesh", self.mesh)
        return GenerationEngine(self.params, self.cfg, **engine_kwargs)


def as_adapter(model, input_name: Optional[str] = None,
               output_name: Optional[str] = None,
               output_index: int = 0) -> ModelAdapter:
    """Passthrough for ready adapters. The reference also wraps
    ``MultiLayerNetwork``, ``ComputationGraph`` and ``SameDiff`` models
    (``input_name``/``output_name``/``output_index`` pick their surface);
    those model kinds are not ported, so anything else raises."""
    if isinstance(model, ModelAdapter):
        return model
    raise TypeError(
        f"cannot serve {type(model).__name__}: the port serves a "
        "ModelAdapter (CausalLMAdapter, or your own); the MultiLayerNetwork, "
        "ComputationGraph and SameDiff adapters come with the port of the "
        "nn/ and autodiff/ model kinds")


@dataclass
class Deployment:
    """One (name, version) servable."""

    name: str
    version: int
    adapter: ModelAdapter
    buckets: Tuple[int, ...]
    deployed_at: float = field(default_factory=time.time)
    warmup_ms: Optional[float] = None
    warmup_example: Optional[object] = None  # one row; engines re-warm
    state: str = "ready"
    # one breaker per (name, version): every engine over this deployment
    # shares it, so failures anywhere trip it everywhere and the registry
    # can route around it (health() / previous-version fallback)
    breaker: Optional[CircuitBreaker] = None
    # deploy-time multi-tenant QoS policy (serving/qos.py QosPolicy):
    # every engine spun up over this deployment enforces it by default
    qos: Optional[object] = None
    # one retry budget per (name, version), shared by its engines like
    # the breaker (created lazily when the registry has a ratio)
    retry_budget: Optional[RetryBudget] = None
    # speculative decoding: the draft model rides the target's
    # deployment (one name:version, one breaker, one retry budget). When
    # set, every generation engine over this deployment defaults to
    # speculative=SpecConfig(draft..., k=spec_k, ...)
    draft: Optional[ModelAdapter] = None
    spec_k: int = 4
    spec_min_acceptance: float = 0.0
    spec_min_proposed: int = 256

    @property
    def ref(self) -> str:
        return f"{self.name}:{self.version}"


class ModelRegistry:
    """deploy/undeploy/alias with per-name monotone versions.

    Refs accepted everywhere a model is looked up: ``"name"`` (latest
    version), ``"name:3"`` (pinned), or an alias bound with :meth:`alias`
    (e.g. ``"prod" -> "bert:2"`` for canary flips)."""

    def __init__(self, default_buckets: Sequence[int] = (1, 2, 4, 8, 16, 32),
                 breaker_failure_threshold: int = 5,
                 breaker_cooldown_s: float = 5.0,
                 retry_budget_ratio: Optional[float] = None,
                 retry_budget_burst: float = 10.0,
                 metrics: Optional[ServingMetrics] = None,
                 tracer=None, recorder=None, cluster=None):
        self.default_buckets = tuple(default_buckets)
        self.breaker_failure_threshold = breaker_failure_threshold
        self.breaker_cooldown_s = breaker_cooldown_s
        # retry budgets (resilience.RetryBudget): with a ratio, every
        # deployment gets ONE budget shared by all its engines; None keeps
        # retries unmetered
        self.retry_budget_ratio = retry_budget_ratio
        self.retry_budget_burst = retry_budget_burst
        self.metrics = metrics or ServingMetrics()
        # request tracing for every engine this registry spins up (None:
        # the process default, off until configured) and the always-on
        # flight recorder for deploy/fallback lifecycle events
        self._tracer = tracer
        self._recorder = recorder if recorder is not None \
            else flight_recorder()
        self._models: Dict[str, Dict[int, Deployment]] = {}
        self._aliases: Dict[str, str] = {}
        self._lock = threading.RLock()
        self._engines: List[object] = []   # engines spun up via engine()
        self._closed = False
        # cluster tier (serving/cluster.py ClusterDirectory): with a
        # directory, every engine this registry spins up attaches to this
        # process's LoopbackHost, which joins the directory, and
        # front_door() serves the whole fleet; None is the single-host
        # stack
        self.cluster = cluster
        self._local_host = None

    # --------------------------------------------------------------- teardown
    def __enter__(self) -> "ModelRegistry":
        return self

    def __exit__(self, *exc):
        self.shutdown()

    def shutdown(self, wait: bool = True):
        """Idempotent teardown: stop every engine this registry spun up
        and refuse new engine construction. Deployments stay readable."""
        with self._lock:
            self._closed = True
            engines, self._engines = self._engines, []
        for eng in engines:
            eng.shutdown(wait=wait)

    def _track(self, eng):
        with self._lock:
            if self._closed:
                eng.shutdown(wait=False)
                raise RuntimeError("registry is shut down")
            self._engines.append(eng)
        return eng

    # ----------------------------------------------------------- cluster tier
    def _cluster_host(self):
        """This process's LoopbackHost in the cluster directory, minted
        and joined on the first engine when ``cluster=`` was given; its id
        is the process's index in the job (``multihost.process_index``:
        its ``torch.distributed`` rank, else 0), as in the reference."""
        from deeplearning4j_tpu_torch.parallel import multihost
        from deeplearning4j_tpu_torch.serving.cluster import LoopbackHost

        created = False
        with self._lock:
            if self._local_host is None:
                self._local_host = LoopbackHost(
                    multihost.process_index(), tracer=self._tracer)
                created = True
            host = self._local_host
        if created:
            # join outside the registry lock: the directory takes its own
            # heartbeat lock, and the two must not nest
            self.cluster.join(host)
        return host

    def front_door(self, **kwargs):
        """A :class:`~deeplearning4j_tpu_torch.serving.cluster.
        ClusterFrontDoor` over this registry's directory — the fleet-wide
        submit surface. Requires ``cluster=`` at construction."""
        from deeplearning4j_tpu_torch.serving.cluster import ClusterFrontDoor

        if self.cluster is None:
            raise ValueError(
                "this registry is single-host (cluster=None); pass a "
                "ClusterDirectory at construction to serve a fleet")
        if self._tracer is not None:
            kwargs.setdefault("tracer", self._tracer)
        kwargs.setdefault("recorder", self._recorder)
        return ClusterFrontDoor(self.cluster, **kwargs)

    # ------------------------------------------------------------- lifecycle
    def deploy(self, name: str, model, *, version: Optional[int] = None,
               buckets: Optional[Sequence[int]] = None,
               warmup_example=None, input_name: Optional[str] = None,
               output_name: Optional[str] = None,
               output_index: int = 0, qos=None,
               draft_model=None, spec_k: int = 4,
               spec_min_acceptance: float = 0.0,
               spec_min_proposed: int = 256) -> Deployment:
        """Register ``model`` under ``name``; returns the Deployment. With
        ``warmup_example`` (ONE row, no batch dim) every bucket size runs
        once (the ``registry.warmup`` fault point) before the deployment
        becomes visible. ``qos`` attaches a deploy-time
        :class:`~deeplearning4j_tpu_torch.serving.qos.QosPolicy` every
        engine over this deployment enforces unless overridden.

        ``draft_model`` (a :class:`CausalLMAdapter` over a smaller LM)
        deploys draft and target as ONE deployment for speculative
        decoding: engines from :meth:`generation_engine` then default to
        ``speculative=SpecConfig(draft..., k=spec_k,
        min_acceptance=spec_min_acceptance)``."""
        if ":" in name:
            raise ValueError(f"model name {name!r} may not contain ':'")
        adapter = as_adapter(model, input_name=input_name,
                             output_name=output_name,
                             output_index=output_index)
        if draft_model is not None:
            draft_model = as_adapter(draft_model)
            if not (hasattr(draft_model, "params")
                    and hasattr(draft_model, "cfg")):
                raise TypeError(
                    f"draft_model must be a CausalLMAdapter (got "
                    f"{draft_model.kind}) — the draft proposes token ids "
                    "for the target's verify step")
        bks = tuple(sorted(set(buckets))) if buckets else self.default_buckets
        ex = np.asarray(warmup_example) if warmup_example is not None else None
        dep = Deployment(name=name, version=0, adapter=adapter, buckets=bks,
                         warmup_example=ex, qos=qos, draft=draft_model,
                         spec_k=spec_k,
                         spec_min_acceptance=spec_min_acceptance,
                         spec_min_proposed=spec_min_proposed,
                         state="warming" if ex is not None else "ready")
        with self._lock:
            # reserve the slot under the lock: concurrent deploys of one
            # name must not pick the same version and clobber each other
            # after the (lock-free) warmup below
            versions = self._models.setdefault(name, {})
            if version is None:
                version = max(versions) + 1 if versions else 1
            elif version in versions:
                raise ValueError(f"{name}:{version} is already deployed")
            dep.version = version
            versions[version] = dep
        if ex is not None:
            try:
                t0 = time.perf_counter()
                for b in bks:
                    inject("registry.warmup", adapter.infer, tile_rows(ex, b))
                dep.warmup_ms = (time.perf_counter() - t0) * 1e3
            except BaseException:
                with self._lock:
                    versions.pop(version, None)
                    if not versions:
                        self._models.pop(name, None)
                self._recorder.record("registry.deploy_failed", ref=dep.ref)
                raise
            dep.state = "ready"
        self._recorder.record("registry.deploy", ref=dep.ref,
                              adapter_kind=adapter.kind,
                              warmed=dep.warmup_ms is not None)
        return dep

    def undeploy(self, name: str, version: Optional[int] = None) -> int:
        """Remove one version (or all). Aliases that pointed at removed
        deployments are dropped too. Returns how many were removed."""
        with self._lock:
            versions = self._models.get(name, {})
            victims = ([version] if version is not None
                       else sorted(versions))
            removed = 0
            for v in victims:
                if v in versions:
                    versions.pop(v).state = "retired"
                    removed += 1
            if not versions:
                self._models.pop(name, None)
            dangling = [a for a, tgt in self._aliases.items()
                        if self._resolve_unlocked(tgt) is None]
            for a in dangling:
                del self._aliases[a]
        if removed:
            self._recorder.record("registry.undeploy", name=name,
                                  version=version, removed=removed)
        return removed

    def alias(self, alias: str, target: str):
        """Bind ``alias`` -> ``target`` ("name" or "name:version"),
        validated now but resolved per lookup, so re-deploying a floating
        target moves the alias with it."""
        with self._lock:
            if self._resolve_unlocked(target) is None:
                raise KeyError(f"alias target {target!r} is not deployed")
            self._aliases[alias] = target

    # -------------------------------------------------------------- lookup
    def _resolve_unlocked(self, ref: str) -> Optional[Deployment]:
        seen = set()
        while ref in self._aliases and ref not in seen:
            seen.add(ref)
            ref = self._aliases[ref]
        if ":" in ref:
            name, _, v = ref.partition(":")
            try:
                dep = self._models.get(name, {}).get(int(v))
            except ValueError:
                return None
            return dep if dep is not None and dep.state == "ready" else None
        ready = [v for v, d in (self._models.get(ref) or {}).items()
                 if d.state == "ready"]
        return self._models[ref][max(ready)] if ready else None

    def _fallback_unlocked(self, dep: Deployment) -> Optional[Deployment]:
        """Degraded-mode routing: when ``dep``'s breaker is OPEN, the
        previous healthy version of the same name (the highest version
        below it that is ready with a non-OPEN breaker) serves instead."""
        br = dep.breaker
        if br is None or br.state != CircuitBreaker.OPEN:
            return None
        versions = self._models.get(dep.name, {})
        for v in sorted(versions, reverse=True):
            if v >= dep.version:
                continue
            cand = versions[v]
            if cand.state != "ready":
                continue
            if cand.breaker is not None \
                    and cand.breaker.state == CircuitBreaker.OPEN:
                continue
            return cand
        return None

    def get(self, ref: str, fallback: bool = True) -> Deployment:
        """Resolve ``ref``; with ``fallback`` (the default) a deployment
        whose breaker is OPEN is replaced by the previous healthy version
        of the same name when one exists. ``fallback=False`` gives the
        literal resolution."""
        fell_back, primary_ref = False, None
        with self._lock:
            dep = self._resolve_unlocked(ref)
            if dep is not None and fallback:
                fb = self._fallback_unlocked(dep)
                if fb is not None:
                    primary_ref = dep.ref
                    dep, fell_back = fb, True
        if dep is None:
            raise KeyError(f"no deployment for {ref!r}")
        if fell_back:
            self.metrics.fallback_serves.inc()
            self._recorder.record("registry.fallback", requested=primary_ref,
                                  served=dep.ref)
        return dep

    # --------------------------------------------------------------- health
    def _breaker_for(self, dep: Deployment) -> CircuitBreaker:
        with self._lock:
            if dep.breaker is None:
                dep.breaker = CircuitBreaker(
                    failure_threshold=self.breaker_failure_threshold,
                    cooldown_s=self.breaker_cooldown_s, name=dep.ref)
                dep.breaker.add_listener(
                    self.metrics.record_breaker_transition)
            return dep.breaker

    def _retry_budget_for(self, dep: Deployment) -> Optional[RetryBudget]:
        if self.retry_budget_ratio is None:
            return None
        with self._lock:
            if dep.retry_budget is None:
                dep.retry_budget = RetryBudget(
                    ratio=self.retry_budget_ratio,
                    burst=self.retry_budget_burst)
            return dep.retry_budget

    def health(self) -> Dict[str, dict]:
        """Per-deployment health: ``SERVING`` (ready, breaker CLOSED or
        never exercised), ``DEGRADED`` (HALF_OPEN), ``CIRCUIT_OPEN``
        (shedding; served by the fallback version when one exists), or
        the lifecycle state upper-cased (``WARMING``). ``serving`` names
        the ref traffic routes to after fallback."""
        with self._lock:
            out: Dict[str, dict] = {}
            for name, versions in self._models.items():
                vs = {}
                for v, d in sorted(versions.items()):
                    br = d.breaker
                    if d.state != "ready":
                        state = d.state.upper()
                    elif br is None or br.state == CircuitBreaker.CLOSED:
                        state = "SERVING"
                    elif br.state == CircuitBreaker.OPEN:
                        state = "CIRCUIT_OPEN"
                    else:
                        state = "DEGRADED"
                    vs[v] = {
                        "state": state,
                        "breaker": br.state if br is not None else None,
                        "consecutive_failures":
                            br.consecutive_failures if br is not None else 0,
                    }
                primary = self._resolve_unlocked(name)
                serving = fallback_from = None
                if primary is not None:
                    fb = self._fallback_unlocked(primary)
                    serving = (fb or primary).ref
                    if fb is not None:
                        fallback_from = primary.ref
                out[name] = {"versions": vs, "serving": serving,
                             "fallback_from": fallback_from}
            return out

    def versions(self, name: str) -> List[int]:
        with self._lock:
            return sorted(self._models.get(name, {}))

    def models(self) -> Dict[str, List[int]]:
        with self._lock:
            return {n: sorted(vs) for n, vs in self._models.items()}

    def aliases(self) -> Dict[str, str]:
        with self._lock:
            return dict(self._aliases)

    # -------------------------------------------------------------- serving
    def engine(self, ref: str, **engine_kwargs):
        """Spin up an :class:`~.engine.InferenceEngine` over a deployment:
        the deployment's bucket ladder is the padding ladder, its breaker,
        QoS policy and retry budget are the engine's, and a deployment
        with a warmup example re-warms through the engine's own dispatch
        path. With ``mesh=`` a ladder whose rungs are not all multiples
        of the mesh's 'data' size gives way to the engine's own
        (``bucket_ladder(max_batch_size, multiple_of=data)``)."""
        from deeplearning4j_tpu_torch.serving.engine import InferenceEngine

        dep = self.get(ref)
        mesh = engine_kwargs.get("mesh")
        n = mesh.axis_size(DATA_AXIS) if mesh is not None else 1
        if all(b % n == 0 for b in dep.buckets):
            engine_kwargs.setdefault("buckets", dep.buckets)
        engine_kwargs.setdefault("max_batch_size", dep.buckets[-1])
        engine_kwargs.setdefault("name", dep.ref)
        # share the deployment's breaker: trips seen by any engine make
        # the registry route new lookups to the previous healthy version
        engine_kwargs.setdefault("breaker", self._breaker_for(dep))
        if dep.qos is not None:
            engine_kwargs.setdefault("qos", dep.qos)
        rb = self._retry_budget_for(dep)
        if rb is not None:
            engine_kwargs.setdefault("retry_budget", rb)
        if self._tracer is not None:
            engine_kwargs.setdefault("tracer", self._tracer)
        engine_kwargs.setdefault("recorder", self._recorder)
        eng = InferenceEngine(dep.adapter, **engine_kwargs)
        try:
            if dep.warmup_example is not None:
                eng.warmup(dep.warmup_example)
            self._track(eng)
            if self.cluster is not None:
                self._cluster_host().attach_engine(eng)
            return eng
        except BaseException:
            eng.shutdown(wait=False)
            raise

    def generation_engine(self, ref: str, shared_prefixes=None,
                          **engine_kwargs):
        """Spin up a continuous-batching :class:`~.generation.
        GenerationEngine` over a generative deployment (a
        :class:`CausalLMAdapter`), tracked for :meth:`shutdown`.
        ``shared_prefixes`` maps prefix id -> tokens: each is registered
        (prefilled once, blocks pinned) before the engine is returned.
        A deployment with a draft defaults the engine to speculative
        decoding over it (pass ``speculative=None`` to opt out)."""
        dep = self.get(ref)
        if not hasattr(dep.adapter, "generation_engine"):
            raise TypeError(
                f"{dep.ref} ({dep.adapter.kind}) is not generative: deploy a "
                "CausalLMAdapter to serve autoregressive decode")
        engine_kwargs.setdefault("name", dep.ref)
        engine_kwargs.setdefault("breaker", self._breaker_for(dep))
        if dep.qos is not None:
            engine_kwargs.setdefault("qos", dep.qos)
        if dep.draft is not None:
            from deeplearning4j_tpu_torch.serving.generation import SpecConfig
            engine_kwargs.setdefault("speculative", SpecConfig(
                dep.draft.params, dep.draft.cfg, k=dep.spec_k,
                min_acceptance=dep.spec_min_acceptance,
                min_proposed=dep.spec_min_proposed))
        rb = self._retry_budget_for(dep)
        if rb is not None:
            engine_kwargs.setdefault("retry_budget", rb)
        if self._tracer is not None:
            engine_kwargs.setdefault("tracer", self._tracer)
        engine_kwargs.setdefault("recorder", self._recorder)
        eng = dep.adapter.generation_engine(**engine_kwargs)
        try:
            for pid, toks in (shared_prefixes or {}).items():
                eng.register_prefix(toks, prefix_id=pid)
            self._track(eng)
            if self.cluster is not None:
                self._cluster_host().attach_generation(eng)
            return eng
        except BaseException:
            eng.shutdown(wait=False)
            raise


__all__ = ["ModelAdapter", "CausalLMAdapter", "Deployment", "ModelRegistry",
           "as_adapter", "tile_rows"]
