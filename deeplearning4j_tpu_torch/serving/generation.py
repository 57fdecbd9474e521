"""Continuous-batching generation engine: ORCA-style iteration-level
scheduling over the paged or contiguous KV cache of ``models/bert.py``
(counterpart: ``deeplearning4j_tpu/serving/generation.py``).

Every turn of the scheduler thread (1) prefills any shared prefix waiting
for its one prefill, (2) admits queued prompts into free slots, (3) runs
ONE decode step for all slots, (4) streams each new token to its caller
and (5) retires streams on EOS or their token budget so the slot serves
the next prompt. Admission is gated on free KV blocks as well as free
slots: a request the pool can never hold sheds typed
``kv_blocks_exhausted``, one that merely has to wait stays at the queue
head.

The block lifecycle:

- a prompt is seated by a prefill into fresh blocks, or without one (the
  decode-feed seat): a stream naming a :meth:`GenerationEngine.
  register_prefix` prefix references its pinned blocks and copies a
  partially filled shared tail block on its first write (copy-on-write);
  a prompt whose leading blocks the automatic prefix cache holds
  references them; either way the rest of the prompt rides the decode
  step one token per iteration;
- ``allocate="reserve"`` takes a stream's worst-case footprint at seating,
  ``"on_demand"`` only its prompt's blocks and one more per block
  boundary the decode crosses, preempting a resident stream when the pool
  is dry; the victim requeues and resumes by recomputing its tokens
  through the prefill, or, above ``swap_threshold_blocks``, by copying its
  blocks back from host memory;
- retired streams' full blocks stay in the automatic prefix cache
  (``prefix_cache_blocks``) until a seat needs the blocks.

Sampling is gumbel-max under a per-request key folded with the token
index, computed row by row, so a stream's tokens are the same whether it
decodes alone or beside any neighbours, and whether or not it was
preempted — and, with the same weights, the same as the JAX engine's.

Speculative decoding (``speculative=SpecConfig(...)``) turns a scheduler
turn into k draft steps on the draft model's contiguous cache and ONE
verify step that scores k+1 positions per slot through the paged cache;
each stream commits the prefix of the draft's proposals that matches the
target's own samples, plus the target's next sample. The tokens are the
plain engine's at any k; only the steps per token change.

Resilience, as the reference's: the target model's steps run through
seeded fault points (``generation.prefill``, ``generation.decode_step``,
``generation.verify_step``; :mod:`.faults`) and a :class:`~.resilience.
RetryPolicy` that retries only failures tagged transient that raised
before the step launched anything; an engine-wide
:class:`~.resilience.CircuitBreaker` sheds submits typed
``circuit_open`` while open; a :class:`~.resilience.Watchdog`
(``watchdog_timeout_ms`` / :meth:`arm_watchdog`) replaces a scheduler
that stops heartbeating. The steps write K/V into the pool in place, so
every replacement builds a NEW pool (the KV cache and its slots; paged,
the allocator, block tables and prefix cache with them) and swaps it in
with the epoch bump in one locked step. Each scheduler turn binds the
current pool at its top and reaches no other: a stale thread's late
writes land in the pool it bound and its results are dropped. The
watchdog covers host stalls: a thread blocked inside a CUDA call on a
hung kernel cannot be replaced, since the new thread's launches queue
behind it on the same stream. Sampled ids are screened (out of vocab,
non-finite) on the host copy the step already makes; a poisoned
iteration fails typed ``poisoned``. The draft points and the swap copies
(``kv.swap_out``, ``kv.swap_in``) degrade instead of failing a stream.

Multi-tenant QoS (``qos=QosPolicy``; :mod:`.qos`): weighted-fair queues
with strict priority classes, quotas, an SLO-burn governor and the
``preemptible=False`` exemption. Tracing (``tracer=Tracer``; :mod:`.tracing`)
records each request's events (``submit``, ``queue.admit``,
``queue.wait``, ``slot.assign``, ``prefill``, ``decode.step``,
``retry.attempt``, ``preempt``, ``kv.swap``, ``watchdog.restart``,
``stream.finish``, ``retire``); the engine opens ``serving.*`` spans on
its :class:`~deeplearning4j_tpu_torch.profiler.OpProfiler` and registers
with the resource ledger (:mod:`.ledger`, :meth:`ledger_stats`). With no
policy, no fault plan and the default (disabled) tracer, streams are the
plain engine's.

:func:`client_stream_handle` is the handle of a stream decoded on another
host (serving/rpc.py, serving/cluster.py). Page migration for
disaggregated prefill/decode (serving/disagg.py): ``submit(capture_pages=
True)`` exports a retiring stream's blocks (:meth:`GenerationEngine.
take_captured_pages`), and :meth:`GenerationEngine.import_pages` parks
another host's pages for a ``submit(swap_key=...)`` that re-seats them
through the swap-in path. The reference's ``compiled_signatures`` and
``draft_compiled_signatures`` count XLA executables; the port runs
eagerly and has none to count.

Sharded serving (``mesh=``, a mesh of ranks from
:func:`~deeplearning4j_tpu_torch.parallel.mesh.make_mesh`): every rank
of the mesh builds the engine with the same arguments. Heads and the MLP
ride 'model' (``place_params``; each rank's pool holds its ``heads //
model`` heads) and 'data' replicates, as in the reference. The mesh's
first rank is the driver: it runs the scheduler above and sends each
device operation's plan to the other ranks, which launch the same step on
their shards (:mod:`.sharded`); ``submit`` works only on the driver. A
swap-out parks each rank's own heads under one ticket; an export gathers
each block's heads to every rank, so another engine imports one-device
pages.
"""
from __future__ import annotations

import dataclasses
import itertools
import queue
import threading
import time
from collections import deque
from concurrent.futures import Future, InvalidStateError
from typing import (Any, Callable, Deque, Dict, List, Optional, Sequence,
                    Tuple)

import numpy as np
import torch

from deeplearning4j_tpu_torch import default_device
from deeplearning4j_tpu_torch.models.bert import (
    compute_params, grow_block_table, init_draft_kv_cache, init_kv_cache,
    make_decode_step, make_draft_prefill, make_draft_step,
    make_paged_decode_step, make_paged_prefill, make_prefill,
    make_verify_step, paged_kv_cache_pspecs, place_params,
    validate_block_size, validate_kv_dtype)
from deeplearning4j_tpu_torch.models.random import prng_key
from deeplearning4j_tpu_torch.parallel.mesh import (
    CONTEXT_AXIS, DATA_AXIS, MODEL_AXIS)
from deeplearning4j_tpu_torch.profiler import OpProfiler
from deeplearning4j_tpu_torch.serving.admission import (
    DEFAULT_TENANT, AdmissionController, HostDrainingError,
    KVBlocksExhaustedError, PreemptedError, RejectedError, Request)
from deeplearning4j_tpu_torch.serving.engine import bucket_ladder
from deeplearning4j_tpu_torch.serving.faults import inject
from deeplearning4j_tpu_torch.serving.ledger import track_engine
from deeplearning4j_tpu_torch.serving.metrics import ServingMetrics
from deeplearning4j_tpu_torch.serving.paging import (
    BlockAllocator, BlockSwapStore, PrefixCache, SharedPrefix, SwapEntry,
    blocks_for_tokens, kv_bytes_per_token)
from deeplearning4j_tpu_torch.serving.qos import (
    PRIORITIES, SloBurnGovernor, SpecAcceptanceGovernor, resolve_qos)
from deeplearning4j_tpu_torch.serving.resilience import (
    CircuitBreaker, ResilientEngineMixin, RetryPolicy, WatchdogTimeoutError)
from deeplearning4j_tpu_torch.serving.sharded import (
    PlanChannel, bind_card, card_of, driver_only)
from deeplearning4j_tpu_torch.serving.tracing import terminal_reason

_DONE = object()
_UNSET = object()   # submit()'s "use the engine default" eos sentinel


# a step's point -> (step function, its params, the pool's cache it runs
# on), read off the engine and the pool: the driver and the followers of
# a mesh engine launch through the same table
_STEPS = {
    "generation.prefill": ("_prefill", "params", "cache"),
    "generation.decode_step": ("_decode", "params", "cache"),
    "generation.verify_step": ("_verify", "params", "cache"),
    "generation.draft_prefill": ("_draft_prefill", "_draft_params",
                                 "draft_cache"),
    "generation.draft_step": ("_draft_step", "_draft_params",
                              "draft_cache"),
}


class _Parked(list):
    """A mesh engine's swapped-out blocks: this rank's per-layer host
    buffers, and the ticket under which every other rank parked its own
    heads of the same blocks."""

    ticket: int = -1


def _host(x) -> np.ndarray:
    """A step result's host copy: the one device-to-host copy a step
    makes (a poison rule may already have replaced it by a host array)."""
    if isinstance(x, torch.Tensor):
        return x.cpu().numpy()
    return np.asarray(x)


def prefill_buckets(max_len: int, min_bucket: int = 8) -> Tuple[int, ...]:
    """Prompt-length bucket ladder: geometric, clamped to ``max_len``."""
    return tuple(sorted({min(b, max_len)
                         for b in bucket_ladder(max_len,
                                                min_bucket=min(min_bucket,
                                                               max_len))}))


@dataclasses.dataclass
class GenerationRequest:
    """One queued generation (rides ``Request.x`` through admission)."""

    prompt: np.ndarray              # (n,) int32
    max_new_tokens: int
    temperature: float
    top_k: int
    eos_id: Optional[int]
    key: np.ndarray                 # (2,) uint32 base PRNG key
    prefix_id: Optional[str] = None  # a register_prefix() prefix
    handle: "GenerationHandle" = None
    # ---- preemption and resume ------------------------------------------
    # set when the stream was evicted to reclaim KV blocks: the tokens it
    # had generated (appended to the prompt by the recompute prefill) and
    # the index its next sample resumes at — the key folds the token
    # index, so the resumed stream is token-equal to the unpreempted one
    resume_tokens: Optional[np.ndarray] = None
    resume_step: int = 0
    preemptions: int = 0
    # the key of this stream's parked KV blocks when its preemption
    # swapped them to host memory: a live key re-seats them with no
    # prefill; a miss falls back to the recompute above
    swap_key: Optional[int] = None
    swap_ins: int = 0               # resumes by swap-in
    # ---- cross-host KV page migration (serving/disagg.py) ---------------
    # capture_pages asks the retire tail to copy this stream's written KV
    # blocks (values and int8 scales) to host memory as a SwapEntry on
    # captured_entry BEFORE the terminal is delivered; the disaggregation
    # orchestrator ships it to a decode-class host, which re-seats it
    # through the swap-in path. A failed export leaves captured_entry
    # None: the decode host recomputes, the stream is never shed.
    capture_pages: bool = False
    captured_entry: Optional[SwapEntry] = None


class GenerationHandle:
    """Per-request streaming surface. ``result()`` blocks for the full
    token list; ``stream()`` yields tokens as the scheduler emits them
    (single consumer); ``future`` is the underlying admission future, so
    shedding and shutdown surface as :class:`RejectedError` here too."""

    def __init__(self, request: Request, prompt_len: int,
                 on_token: Optional[Callable[[int], None]] = None):
        self._req = request
        self.prompt_len = prompt_len
        self.finish_reason: Optional[str] = None   # 'eos' | 'max_tokens'
        self._tokens: List[int] = []
        self._lock = threading.Lock()
        self._q: "queue.SimpleQueue" = queue.SimpleQueue()
        self._on_token = on_token
        # tokens are pushed before the future resolves, so _DONE always
        # trails the last token (and any exception) in the stream queue
        request.future.add_done_callback(lambda _f: self._q.put(_DONE))

    @property
    def future(self) -> Future:
        return self._req.future

    def tokens_so_far(self) -> List[int]:
        with self._lock:
            return list(self._tokens)

    def result(self, timeout: Optional[float] = None) -> List[int]:
        """Generated token ids (prompt excluded; EOS included when hit)."""
        return self._req.future.result(timeout)

    def stream(self, timeout: Optional[float] = None):
        """Yield tokens as they are generated; raises the request's error
        at the point it occurred."""
        while True:
            item = self._q.get(timeout=timeout)
            if item is _DONE:
                exc = self._req.future.exception()
                if exc is not None:
                    raise exc
                return
            yield item

    def _push(self, token: int) -> Optional[BaseException]:
        """Deliver one token; returns the ``on_token`` callback's exception
        when a broken consumer failed its own stream (the scheduler then
        retires the slot — the error must not reach the scheduler loop)."""
        with self._lock:
            self._tokens.append(token)
        self._q.put(token)
        if self._on_token is not None:
            try:
                self._on_token(token)
            except Exception as e:
                if self._fail(e):
                    return e
        return None

    def _finish(self, reason: str) -> bool:
        self.finish_reason = reason
        try:
            self._req.future.set_result(self.tokens_so_far())
            return True
        except InvalidStateError:
            return False   # caller cancelled while queued/running

    def _fail(self, exc: BaseException) -> bool:
        """True iff this call delivered the terminal."""
        try:
            self._req.future.set_exception(exc)
            return True
        except InvalidStateError:
            return False


@dataclasses.dataclass(frozen=True)
class SpecConfig:
    """Speculative decoding (Leviathan et al., ICML'23): a small DRAFT
    model proposes ``k`` tokens per scheduler turn and the target verifies
    them in ONE k+1-position verify step, committing the longest proposal
    prefix that matches its own samples.

    Every token of a stream is a function of (request key, token index),
    so the verify step computes the target's samples at the k+1 positions
    and acceptance only decides how MANY commit per turn: a speculative
    stream is the plain one at any k, temperature and ``kv_dtype``.

    ``draft_params``/``draft_cfg`` are the draft model (it must share the
    target's vocab and cover the engine's ``max_len`` positions); ``k`` is
    the proposals per turn. ``min_acceptance`` > 0 arms the per-tenant
    :class:`~deeplearning4j_tpu_torch.serving.qos.SpecAcceptanceGovernor`:
    a tenant whose acceptance stays below it after ``min_proposed``
    proposals is demoted to k=0 (plain turns)."""

    draft_params: Any
    draft_cfg: Any
    k: int = 4
    min_acceptance: float = 0.0
    min_proposed: int = 256

    def __post_init__(self):
        if self.k < 1:
            raise ValueError(
                f"SpecConfig.k must be >= 1 (k == 0 IS plain decode — "
                f"pass speculative=None), got {self.k}")


@dataclasses.dataclass
class _Slot:
    """Scheduler-side state of one occupied cache slot."""

    greq: GenerationRequest
    request: Request
    n_generated: int = 0
    last_token: int = 0
    length: int = 0                  # tokens whose K/V are in the cache
    blocks: Optional[List[int]] = None   # every block this stream refs
    prefix_len: int = 0              # tokens of shared blocks (prefix or
    #                                  cache hit) the stream started from
    # prompt tokens still to feed through decode steps (the decode-feed
    # seat: no prefill, the suffix rides the decode step one token per
    # iteration and mid-feed samples are discarded)
    pending: Optional[Deque[int]] = None
    # one-shot copy-on-write of a partially filled shared tail block
    # before the stream's first write into it: (src block, dst block)
    cow: Optional[Tuple[int, int]] = None
    # table-row entries mapped so far (shared + fresh): the worst case at
    # seating under allocate="reserve", one more per boundary under
    # "on_demand"
    n_entries: int = 0
    resumed: bool = False            # seated from a preemption's resume
    # speculative decoding: positions of this stream the DRAFT cache holds.
    # The slot speculates (is draft-warm) iff draft_len == length at turn
    # start; -1 is draft-cold (never draft-prefilled, the draft failed, or
    # the stream advanced through a plain turn)
    draft_len: int = -1


@dataclasses.dataclass(eq=False)
class _Pool:
    """Everything a scheduler turn writes, built new and replaced whole:
    the KV cache (the steps write K/V into its tensors in place), the
    slots seated in it, and for a paged engine the block tables, the
    allocator their ids come from, the automatic prefix cache (it holds
    that allocator's references) and the block waiter; a speculative
    engine's draft cache. A scheduler thread binds the engine's current
    pool at the top of each turn and reaches no other, so a thread staled
    by a watchdog restart can only write into the pool it bound. The
    engine swaps ``_pool`` under ``_wd_lock``; ``engine._pool is pool``,
    read under that lock, decides whether a thread's work still counts."""

    epoch: int
    cache: Dict[str, Any]
    slots: List[Optional[_Slot]]
    allocator: Optional[BlockAllocator] = None
    tables: Optional[np.ndarray] = None
    prefix_cache: Optional[PrefixCache] = None
    draft_cache: Optional[Dict[str, Any]] = None
    # the dequeued request waiting for KV blocks: (request, demand,
    # priority); freed blocks accumulate toward it instead of being taken
    # by same-or-lower-class requests behind it
    block_waiter: Optional[Tuple[Request, int, str]] = None
    # the request in prefill: a restart fails it with the live slots
    inflight_prefill: Optional[Request] = None
    # a mesh engine's plans name the pool they bind by this key
    key: int = 0

    def live_count(self) -> int:
        return sum(s is not None for s in self.slots)


class GenerationEngine(ResilientEngineMixin):
    """Iteration-level scheduler over one causal LM and one KV cache on one
    device.

    ``submit(prompt)`` returns a :class:`GenerationHandle`; a background
    thread runs the admit → decode → stream → retire loop. ``slots``
    bounds concurrent generations and ``max_len`` is a stream's capacity
    (prefix + prompt + generated tokens). K/V live in a pool of
    ``num_blocks`` blocks of ``block_size`` tokens (default: the
    contiguous footprint, 16-token blocks) addressed through per-slot
    block tables.

    ``kv_dtype`` selects the pool's storage: ``"float32"`` (full precision
    in the cache dtype, by default the model's compute dtype) or
    ``"int8"`` (quantize on write, dequantize on read, per-token scales).
    ``paged_attention`` selects the decode attention read: ``"gather"``
    (the reference's default: materialize the block gather) or
    ``"fused"`` (the hand-written paged-attention kernel).

    ``allocate`` is the allocator's discipline: ``"reserve"`` (default)
    takes a stream's whole worst-case ``ceil((len + max_new) /
    block_size)`` footprint at seating; ``"on_demand"`` (vLLM SOSP'23
    §4.5) takes only the prompt's blocks and one more per block boundary,
    and when the pool is dry preempts one resident stream — never of a
    higher class than the needy one; the lowest class, then the largest
    footprint, then the latest arrival — and requeues it to resume
    token-equal: by recomputing its tokens through the prefill, or, when
    its footprint exceeds ``swap_threshold_blocks``, by copying its blocks
    to host memory (a :class:`~.paging.BlockSwapStore` of
    ``swap_capacity_blocks``, default the pool's size) and back. A victim
    that can never fit again sheds typed ``'preempted'``.

    ``paged=False`` keeps the contiguous layout instead: every slot
    reserves ``max_len`` positions of a (slots, max_len) cache whose
    lengths live on the device, with no block tables, sharing, on-demand
    allocation, swap, int8 storage or fused route.

    ``speculative`` (a :class:`SpecConfig`; paged only) turns each turn
    into k draft steps and ONE k+1-position verify step; streams are the
    plain engine's token for token. A failing draft degrades turns to
    plain decode behind its own :class:`~deeplearning4j_tpu_torch.serving.
    resilience.CircuitBreaker` and never sheds a stream.

    :meth:`register_prefix` prefills a shared prefix once and pins its
    blocks; ``submit(prefix_id=...)`` streams reference them.
    ``prefix_cache_blocks`` > 0 keeps up to that many of retired streams'
    full blocks in an LRU that later prompts sharing a block-aligned
    token prefix reference with no opt-in (SGLang's RadixAttention
    policy); cached blocks are reclaimed on demand and never gate
    admission.

    ``qos`` (a :class:`~deeplearning4j_tpu_torch.serving.qos.QosPolicy`)
    orders the queue by priority class and weighted fair share, meters
    tenant quotas and queue bounds, sheds batch traffic while the SLO
    burns, and exempts ``preemptible=False`` tenants from being another
    stream's preemption victim. ``retry_policy`` (default: 3 attempts,
    transient-tagged failures only), ``breaker`` (default: opens after 5
    consecutive failures) and ``retry_budget`` (default: unmetered) shape
    the resilience layer; ``watchdog_timeout_ms`` arms the scheduler
    watchdog (arm it after warm-up: a first use reads like a stall).
    ``tracer`` (default: the process tracer, disabled) records request
    traces, ``recorder`` (default: the process flight recorder) the
    noteworthy events, ``profiler`` (default: ``OpProfiler.getInstance()``)
    the ``serving.*`` spans; ``screen_outputs`` fails an iteration whose
    sampled ids are out of vocab or non-finite.

    ``mesh`` shards the model over a mesh of ranks (every rank of it
    builds the engine with the same arguments and global params; the
    first rank takes the submits, the others follow its plans,
    :mod:`.sharded`).

    The engine keeps one compute-dtype copy of the weights (under a mesh,
    of this rank's shards) on ``device``, made once here
    (:func:`~deeplearning4j_tpu_torch.models.bert.compute_params`);
    ``device`` defaults to ``"cuda"``."""

    _COMPONENT = "serving.GenerationEngine"
    _FAILURE_NOUN = "prefill/decode"

    def __init__(self, params, cfg, *, mesh=None, slots: int = 8,
                 max_len: Optional[int] = None,
                 buckets: Optional[Sequence[int]] = None,
                 cache_dtype: Optional[torch.dtype] = None,
                 paged: bool = True,
                 block_size: Optional[int] = None,
                 num_blocks: Optional[int] = None,
                 kv_dtype: str = "float32",
                 paged_attention: str = "gather",
                 allocate: str = "reserve",
                 prefix_cache_blocks: int = 0,
                 swap_threshold_blocks: Optional[int] = None,
                 swap_capacity_blocks: Optional[int] = None,
                 queue_capacity: int = 64,
                 default_timeout_ms: Optional[float] = None,
                 eos_id: Optional[int] = None,
                 metrics: Optional[ServingMetrics] = None,
                 profiler: Optional[OpProfiler] = None,
                 retry_policy: Optional[RetryPolicy] = None,
                 breaker: Optional[CircuitBreaker] = None,
                 retry_budget=None, qos=None,
                 speculative: Optional[SpecConfig] = None,
                 watchdog_timeout_ms: Optional[float] = None,
                 tracer=None, recorder=None, screen_outputs: bool = True,
                 device=None, name: str = "generation"):
        if not cfg.causal:
            raise ValueError(
                "GenerationEngine needs a causal LM: TransformerConfig("
                "causal=True) — a bidirectional encoder has no decode order")
        if slots <= 0:
            raise ValueError("slots must be positive")
        if mesh is not None and mesh.axis_size(CONTEXT_AXIS) > 1:
            raise ValueError(
                f"GenerationEngine shards heads over '{MODEL_AXIS}' and "
                f"replicates '{DATA_AXIS}'; a '{CONTEXT_AXIS}' axis of "
                f"{mesh.axis_size(CONTEXT_AXIS)} is not served (a prompt "
                "prefills whole on every rank)")
        self.device = card_of(default_device(device))
        self.cfg = cfg
        self.mesh = mesh
        self.slots = slots
        self.max_len = max_len if max_len is not None else cfg.max_seq
        self.buckets = (tuple(sorted(set(int(b) for b in buckets)))
                        if buckets else prefill_buckets(self.max_len))
        if self.buckets[-1] > self.max_len:
            raise ValueError(f"prefill buckets {self.buckets} exceed "
                             f"max_len {self.max_len}")
        self.eos_id = eos_id
        self.name = name
        self.metrics = metrics or ServingMetrics()
        self.profiler = profiler or OpProfiler.getInstance()
        self.paged = paged
        if paged:
            if allocate not in ("reserve", "on_demand"):
                raise ValueError(
                    f"allocate must be 'reserve' or 'on_demand', got "
                    f"{allocate!r}")
            if prefix_cache_blocks < 0:
                raise ValueError(
                    f"prefix_cache_blocks must be >= 0, got "
                    f"{prefix_cache_blocks}")
            if swap_threshold_blocks is not None \
                    and swap_threshold_blocks < 0:
                raise ValueError(
                    f"swap_threshold_blocks must be >= 0 (a victim whose "
                    f"footprint EXCEEDS it swaps to host RAM), got "
                    f"{swap_threshold_blocks}")
            if swap_capacity_blocks is not None \
                    and swap_threshold_blocks is None:
                raise ValueError(
                    "swap_capacity_blocks requires swap_threshold_blocks "
                    "— the store only fills from preemption swap-outs")
            if block_size is None:
                # 16-token blocks, degrading to the largest power of two
                # that fits a tiny max_len
                block_size = 16
                while block_size > self.max_len:
                    block_size //= 2
            self.block_size = validate_block_size(block_size, self.max_len)
            self.kv_dtype = validate_kv_dtype(kv_dtype, self.block_size)
            self.paged_attention = paged_attention
            self.allocate = allocate
            self.prefix_cache_blocks = int(prefix_cache_blocks)
            self.max_blocks_per_slot = blocks_for_tokens(self.max_len,
                                                         self.block_size)
            self.num_blocks = (slots * self.max_blocks_per_slot + 1
                               if num_blocks is None else int(num_blocks))
            self.swap_threshold_blocks = swap_threshold_blocks
            self._swap_store = BlockSwapStore(
                int(swap_capacity_blocks) if swap_capacity_blocks
                is not None else self.num_blocks) \
                if swap_threshold_blocks is not None else None
            self._prefill = make_paged_prefill(cfg, self.block_size, mesh,
                                               kv_dtype=self.kv_dtype)
            self._decode = make_paged_decode_step(
                cfg, self.block_size, mesh, kv_dtype=self.kv_dtype,
                paged_attention=paged_attention)
        else:
            # int8 storage is a block-pool concept: validated against the
            # contiguous layout's absent block size, so the error names it
            validate_kv_dtype(kv_dtype, None)
            if allocate != "reserve":
                raise ValueError(
                    f"allocate={allocate!r} requires the paged KV cache "
                    "(GenerationEngine(paged=True)) — the contiguous "
                    "layout reserves whole rows, there is nothing to "
                    "allocate on demand")
            if prefix_cache_blocks:
                raise ValueError(
                    "prefix_cache_blocks requires the paged KV cache "
                    "(GenerationEngine(paged=True)) — the automatic "
                    "prefix cache holds retired streams' blocks")
            if swap_threshold_blocks is not None \
                    or swap_capacity_blocks is not None:
                raise ValueError(
                    "swap_threshold_blocks requires the paged KV cache "
                    "(GenerationEngine(paged=True)) — swap-to-host parks "
                    "block K/V, and the contiguous layout has no blocks")
            if paged_attention != "gather":
                raise ValueError(
                    f"paged_attention={paged_attention!r} requires the "
                    "paged KV cache (GenerationEngine(paged=True)) — the "
                    "contiguous layout has no block table to fuse over")
            self.kv_dtype = kv_dtype
            self.paged_attention = "gather"
            self.allocate = "reserve"
            self.prefix_cache_blocks = 0
            self.swap_threshold_blocks = None
            self._swap_store = None
            self.block_size = None
            self.num_blocks = None
            self.max_blocks_per_slot = None
            self._prefill = make_prefill(cfg, mesh)
            self._decode = make_decode_step(cfg, mesh)
        self._cache_dtype = cache_dtype
        if mesh is not None:
            params = place_params(params, cfg, mesh)
        self.params = compute_params(params, cfg, self.device)
        # shared-prefix registry, and the queue of prefixes waiting for
        # their prefill (run by the scheduler thread, which owns the pool)
        self._prefixes: Dict[str, SharedPrefix] = {}
        self._prefix_lock = threading.Lock()
        self._pending_prefix: Deque[Tuple[str, Optional[Future]]] = deque()
        self._prefix_ids = itertools.count()
        self._prefix_busy = False
        # warmup sets _cache_bypass so every rung's probe really prefills
        self._cache_bypass = False
        # speculative decoding: the draft's steps and THE verify step, the
        # draft's own breaker (a failing draft degrades turns to plain
        # decode, never sheds) and the per-tenant acceptance governor
        self._spec = speculative
        self._spec_force_plain = False   # warmup: run the plain fallback
        if speculative is not None:
            if not self.paged:
                raise ValueError(
                    "speculative decoding requires the paged KV cache "
                    "(GenerationEngine(paged=True)) — the verify step is "
                    "a paged executable")
            dcfg = speculative.draft_cfg
            if not dcfg.causal:
                raise ValueError(
                    "the draft model must be causal: TransformerConfig("
                    "causal=True)")
            if dcfg.vocab_size != cfg.vocab_size:
                raise ValueError(
                    f"draft vocab {dcfg.vocab_size} != target vocab "
                    f"{cfg.vocab_size} — proposals are fed to the target "
                    "as token ids, the vocabularies must be shared")
            if dcfg.max_seq < self.max_len:
                raise ValueError(
                    f"draft max_seq {dcfg.max_seq} < engine max_len "
                    f"{self.max_len} — the draft must cover every prompt "
                    "bucket position")
            self._draft_cfg = dcfg
            dparams = speculative.draft_params
            if mesh is not None:
                dparams = place_params(dparams, dcfg, mesh)
            self._draft_params = compute_params(dparams, dcfg, self.device)
            # the draft writes K/V up to position length + k - 1, within
            # its positional table (proposals near the end degrade to
            # garbage the verify rejects, never to wrong tokens)
            self._draft_max_len = min(self.max_len + speculative.k,
                                      dcfg.max_seq)
            self._draft_prefill = make_draft_prefill(dcfg, mesh)
            self._draft_step = make_draft_step(dcfg, mesh)
            self._verify = make_verify_step(
                cfg, self.block_size, speculative.k, mesh,
                kv_dtype=self.kv_dtype, paged_attention=paged_attention)
            self._draft_breaker = CircuitBreaker(name=f"{name}.draft")
            self._spec_governor = SpecAcceptanceGovernor(
                speculative.min_acceptance, speculative.min_proposed)
        # multi-tenant QoS: weighted-fair queues, quotas and the SLO-burn
        # governor; None keeps the plain FIFO path
        self.qos = qos
        self._qos_governor = SloBurnGovernor(qos, self.metrics) \
            if qos is not None else None
        self._admission = AdmissionController(
            capacity_rows=queue_capacity,
            default_timeout_ms=default_timeout_ms, unit="requests",
            policy=qos)
        self._admission.on_shed = self._count_shed
        self._admission.on_close_reject = self._count_close_reject
        self._admission.on_cancelled = self._count_cancelled
        # requests admitted and not yet terminal (drain's exit condition)
        self._outstanding = 0
        self._outstanding_lock = threading.Lock()
        self._draining = False
        self._stop = threading.Event()
        self.screen_outputs = screen_outputs
        self._init_resilience(retry_policy=retry_policy, breaker=breaker,
                              retry_budget=retry_budget,
                              tracer=tracer, recorder=recorder)
        # a mesh engine's plan channel (serving/sharded.py): the driver
        # sends every device operation's plan, a follower runs them
        self._plan = PlanChannel(mesh) if mesh is not None else None
        self._pool_keys = itertools.count()
        if self._plan is not None and not self._plan.is_driver:
            # a follower: its pools and parked blocks come plan by plan
            self._pool = _Pool(epoch=0, cache={}, slots=[None] * slots)
            self._fpools: Dict[int, _Pool] = {}
            self._fparked: Dict[int, List[Dict[str, Any]]] = {}
            self._thread = None
            self._plan.follow(self._follow)
            track_engine(self)
            return
        self._tickets = itertools.count()
        self._pool = self._new_pool()
        self._pool_gauges()
        self._thread = threading.Thread(
            target=self._loop, args=(0,),
            name=f"generation-scheduler[{self.name}]", daemon=True)
        self._thread.start()
        if watchdog_timeout_ms is not None:
            self.arm_watchdog(watchdog_timeout_ms)
        track_engine(self)   # weak: the resource ledger's registry

    # ------------------------------------------------------------ lifecycle
    def __enter__(self) -> "GenerationEngine":
        return self

    def __exit__(self, *exc):
        self.shutdown()

    def shutdown(self, wait: bool = True):
        """Idempotent: stop the scheduler; queued and in-flight requests
        are rejected ('shutdown') — partial streams keep what they have in
        :meth:`GenerationHandle.tokens_so_far`; waiting
        :meth:`register_prefix` callers are rejected too. The watchdog
        stops and the engine's listeners leave its breaker first."""
        self._shutdown_resilience()
        self._stop.set()
        self._admission.close()
        with self._prefix_lock:
            pending, self._pending_prefix = list(self._pending_prefix), deque()
        for _pid, fut in pending:
            if fut is None:
                continue
            try:
                fut.set_exception(RejectedError(
                    "engine shut down before the prefix was prefilled",
                    "shutdown"))
            except InvalidStateError:
                pass
        self._recorder.record("engine.shutdown", engine=self.name)
        if self._thread is not None and wait and self._thread.is_alive():
            self._thread.join(timeout=30.0)
        if self._plan is not None and (wait or self._plan.is_driver):
            # the driver's shutdown plan, after its last launch; a
            # follower waits for it
            self._plan.close()

    @property
    def is_driver(self) -> bool:
        """False on a mesh engine's followers: they run the driver's
        plans, and submit, generate and register_prefix raise there."""
        return self._plan is None or self._plan.is_driver

    def plan_stats(self) -> Optional[dict]:
        """A mesh engine's plans sent so far and the milliseconds their
        broadcasts took (the driver's); None without a mesh."""
        return None if self._plan is None else self._plan.stats()

    @property
    def drained(self) -> bool:
        """Nothing queued, resident or waiting for a prefix prefill."""
        with self._outstanding_lock:
            if self._outstanding:
                return False
        with self._prefix_lock:
            return not self._pending_prefix and not self._prefix_busy

    def drain(self, timeout: Optional[float] = None,
              release_prefixes: bool = True) -> bool:
        """Graceful drain: stop admitting (new submits and registrations
        shed typed ``host_draining``), let every queued and resident
        stream finish, then release every shared-prefix pin so the pool's
        blocks return to the free list. True when fully drained within
        ``timeout`` (None waits forever). On a timeout the engine stays
        draining and keeps its explicit pins (the caller decides whether
        to force ``shutdown()``). The automatic prefix cache is released
        on both exits: admission is closed, so nothing can match it
        again."""
        ok = self._drain_wait(timeout)
        if release_prefixes and self._prefix_cache is not None:
            before = len(self._prefix_cache)
            self._prefix_cache.release_all()
            if before:
                self.metrics.prefix_cache_evictions_total.inc(before)
                self._update_block_gauges()
        if not ok:
            return False
        if release_prefixes:
            with self._prefix_lock:
                pids = list(self._prefixes)
            for pid in pids:
                self.release_prefix(pid)
        return True

    # --------------------------------------------------------------- submit
    def submit(self, prompt, *, max_new_tokens: int = 16,
               temperature: float = 0.0, top_k: int = 0,
               eos_id: Any = _UNSET, seed: int = 0,
               timeout_ms: Optional[float] = None,
               prefix_id: Optional[str] = None,
               tenant: Optional[str] = None,
               priority: Optional[str] = None,
               on_token: Optional[Callable[[int], None]] = None,
               resume_tokens=None, resume_step: int = 0,
               capture_pages: bool = False,
               swap_key: Optional[int] = None,
               trace_link: Optional[str] = None,
               trace_parent: Optional[str] = None) -> GenerationHandle:
        """Queue one prompt. Greedy by default; ``temperature`` > 0
        samples, ``top_k`` > 0 restricts sampling to the k most likely
        tokens, ``seed`` fixes the stream's PRNG key (a fixed seed gives a
        reproducible stream whatever its neighbours). ``eos_id`` defaults
        to the engine's; ``eos_id=None`` disables EOS retirement.
        ``timeout_ms`` bounds queue time.

        ``prefix_id`` names a :meth:`register_prefix` prefix: the stream's
        sequence is ``prefix + prompt``, the prefix's pinned blocks are
        referenced (its prefill happened once) and only the prompt rides
        the decode step. ``tenant`` and ``priority`` (``"interactive"``
        or ``"batch"``; by default the tenant's configured class, else
        ``"interactive"``) attribute the request: under the engine's
        ``qos`` policy they order the queue (a configured tenant may not
        escalate above its class), without one the queue stays FIFO; and
        preemption never evicts a stream of a higher class than the one
        that needs the blocks.

        ``resume_tokens``/``resume_step`` seat the stream at a resume
        point: the delivered tokens ride the prompt through one recompute
        prefill and the next sample is drawn at index ``resume_step``
        (which must equal ``len(resume_tokens)``). ``swap_key`` names
        parked blocks to re-seat from instead (it needs
        ``resume_tokens``, the fallback on a miss): a preemption's
        swap-out, or pages another host exported (:meth:`import_pages`).

        ``capture_pages`` (paged only) exports the stream's written K/V
        blocks when it retires, for :meth:`take_captured_pages`: the
        prefill half of disaggregated serving (serving/disagg.py runs such
        a stream with ``max_new_tokens=1``).

        ``trace_link``/``trace_parent`` attach the stream's trace to a
        cross-host parent (the trace context serving/rpc.py forwards):
        the engine's ``RequestTrace`` stays a full local timeline that
        names the front-door trace it is a leg of, so the cluster
        aggregator can stitch the legs. By default it is a local root.
        On a mesh engine only the driver takes submits."""
        if not self.is_driver:
            raise driver_only(self, "submit")
        tenant, priority = resolve_qos(self.qos, tenant, priority)
        toks = np.ascontiguousarray(np.asarray(prompt, np.int32).ravel())
        if toks.size == 0:
            raise ValueError("prompt must contain at least one token")
        if max_new_tokens <= 0:
            raise ValueError("max_new_tokens must be positive")
        if resume_tokens is not None:
            resume_tokens = np.ascontiguousarray(
                np.asarray(resume_tokens, np.int32).ravel())
            if int(resume_step) != int(resume_tokens.size):
                raise ValueError(
                    f"resume_step ({resume_step}) must equal "
                    f"len(resume_tokens) ({resume_tokens.size}) — the "
                    "resume point is the delivery watermark")
            if resume_step >= max_new_tokens:
                raise ValueError(
                    f"resume_step ({resume_step}) must be < "
                    f"max_new_tokens ({max_new_tokens}) — a finished "
                    "stream has nothing to resume")
        elif resume_step:
            raise ValueError(
                f"resume_step ({resume_step}) requires resume_tokens — "
                "the delivered prefix the recompute prefill replays")
        if capture_pages and not self.paged:
            raise ValueError(
                "capture_pages requires the paged KV cache "
                "(GenerationEngine(paged=True)) — page export gathers "
                "block rows, and the contiguous layout has no blocks")
        if swap_key is not None and resume_tokens is None:
            raise ValueError(
                "swap_key requires resume_tokens — a swap-in miss degrades "
                "to the recompute path, which needs the delivered tokens")
        prefix_len = 0
        if prefix_id is not None:
            if not self.paged:
                raise ValueError(
                    "prefix_id requires the paged KV cache "
                    "(GenerationEngine(paged=True))")
            with self._prefix_lock:
                prefix = self._prefixes.get(prefix_id)
            if prefix is None:
                raise KeyError(
                    f"prefix_id {prefix_id!r} is not registered — call "
                    "register_prefix() first")
            prefix_len = prefix.length
        total = prefix_len + toks.size + max_new_tokens
        if total > self.max_len:
            raise ValueError(
                f"prefix ({prefix_len}) + prompt ({toks.size}) + "
                f"max_new_tokens ({max_new_tokens}) exceeds the cache "
                f"capacity max_len={self.max_len}")
        if prefix_id is None and toks.size > self.buckets[-1]:
            # prefix streams skip the prefill (the prompt rides the decode
            # step), so the bucket ladder does not bound them
            raise ValueError(
                f"prompt ({toks.size}) exceeds the top prefill bucket "
                f"{self.buckets[-1]} — extend `buckets` up to max_len")
        greq = GenerationRequest(
            prompt=toks, max_new_tokens=max_new_tokens,
            temperature=float(temperature), top_k=int(top_k),
            eos_id=self.eos_id if eos_id is _UNSET else eos_id,
            key=prng_key(seed), prefix_id=prefix_id,
            resume_tokens=resume_tokens, resume_step=int(resume_step),
            capture_pages=bool(capture_pages), swap_key=swap_key)
        trace = self._tracer.begin(self.name, "generate",
                                   link=trace_link,
                                   parent_span=trace_parent,
                                   prompt_len=int(toks.size),
                                   max_new_tokens=max_new_tokens,
                                   tenant=tenant)
        if resume_tokens is not None:
            self.metrics.stream_resumes_total.inc()
            trace.event("stream.resume", resume_step=int(resume_step))
        if swap_key is not None:
            # pages another host exported (import_pages); the seat's
            # kv.swap event says whether they were used
            trace.event("kv.migrate", direction="import", key=int(swap_key))
        req = Request(x=greq, rows=1, trace=trace, tenant=tenant,
                      priority=priority)
        greq.handle = GenerationHandle(req, toks.size, on_token=on_token)
        self._count_request()
        if self._draining:
            # drain outranks every other gate: the host is leaving
            e = HostDrainingError(
                f"engine[{self.name}] is draining — admission is closed")
            self._reject_submit(trace, e, tenant=tenant)
            raise e
        self._breaker_gate(trace, tenant=tenant)
        if self._qos_governor is not None:
            e = self._qos_governor.gate(priority)
            if e is not None:
                self._reject_submit(trace, e, tenant=tenant)
                raise e
        # structural shed: a footprint the pool can never hold (capacity
        # minus prefix pins) fails typed now, not after a queue wait that
        # cannot end another way
        needed = usable = 0
        if self.paged:
            needed = self._fresh_blocks_needed(prefix_len, int(toks.size),
                                               max_new_tokens)
            usable = self._usable_blocks()
        if needed > usable:
            e = KVBlocksExhaustedError(
                f"request needs {needed} KV blocks but the pool can free "
                f"at most {usable} of {self._allocator.capacity} "
                f"(block_size={self.block_size}; shared-prefix pins "
                "excluded) — shrink the request or grow num_blocks",
                needed=needed, usable=usable,
                capacity=self._allocator.capacity)
            self._reject_submit(trace, e, tenant=tenant)
            raise e
        with self._outstanding_lock:
            self._outstanding += 1
        try:
            self._admission.admit(req, timeout_ms=timeout_ms)
        except RejectedError as e:
            with self._outstanding_lock:
                self._outstanding -= 1
            self._reject_submit(trace, e, tenant=tenant)
            raise
        req.future.add_done_callback(self._terminal)
        self.metrics.queue_depth.set(self._admission.depth_requests)
        return greq.handle

    def _terminal(self, _future: Future):
        with self._outstanding_lock:
            self._outstanding -= 1

    def generate(self, prompt, timeout: Optional[float] = None,
                 **kwargs) -> List[int]:
        """Blocking submit: the full generated-token list."""
        return self.submit(prompt, **kwargs).result(timeout=timeout)

    # ------------------------------------------------------ shared prefixes
    def register_prefix(self, tokens, prefix_id: Optional[str] = None,
                        timeout: Optional[float] = 300.0) -> str:
        """Prefill a shared prefix once and pin its blocks; returns the id
        to pass as ``submit(prefix_id=...)``. The prefill runs on the
        scheduler thread, which owns the pool: this call blocks until the
        prefix is resident. After a cache rebuild the registration
        survives and the next stream naming it re-prefills it."""
        if not self.is_driver:
            raise driver_only(self, "register_prefix")
        if not self.paged:
            raise ValueError("register_prefix requires the paged KV cache "
                             "(GenerationEngine(paged=True))")
        if self._draining:
            raise HostDrainingError(
                f"engine[{self.name}] is draining — it takes no new prefix "
                "pins")
        toks = np.ascontiguousarray(np.asarray(tokens, np.int32).ravel())
        if toks.size == 0:
            raise ValueError("prefix must contain at least one token")
        if toks.size > self.buckets[-1]:
            raise ValueError(
                f"prefix ({toks.size}) exceeds the top prefill bucket "
                f"{self.buckets[-1]} — extend `buckets` up to max_len")
        if toks.size >= self.max_len:
            raise ValueError(
                f"prefix ({toks.size}) leaves no room to generate within "
                f"max_len={self.max_len}")
        nb = blocks_for_tokens(int(toks.size), self.block_size)
        fut: Future = Future()
        with self._prefix_lock:
            if self._stop.is_set():
                raise RejectedError("engine is shut down", "shutdown")
            # pins and not-yet-prefilled registrations together: two
            # concurrent registrations must not both pass and over-commit
            reserved = sum(
                len(p.blocks) if p.blocks
                else blocks_for_tokens(p.length, self.block_size)
                for p in self._prefixes.values())
            usable = self._allocator.capacity - reserved
            if nb > usable:
                raise KVBlocksExhaustedError(
                    f"prefix needs {nb} KV blocks but only {usable} of "
                    f"{self._allocator.capacity} can ever be pinned "
                    "(other prefixes hold the rest)",
                    needed=nb, usable=usable,
                    capacity=self._allocator.capacity)
            if prefix_id is None:
                prefix_id = f"prefix-{next(self._prefix_ids)}"
            if prefix_id in self._prefixes:
                raise ValueError(
                    f"prefix_id {prefix_id!r} is already registered")
            self._prefixes[prefix_id] = SharedPrefix(prefix_id, toks)
            self._pending_prefix.append((prefix_id, fut))
        try:
            fut.result(timeout)
        except BaseException:
            # withdraw the registration so its reservation does not shrink
            # the pool forever; a prefill already running frees its blocks
            # when it finds the id gone
            with self._prefix_lock:
                p = self._prefixes.get(prefix_id)
                if p is not None and not p.ready:
                    del self._prefixes[prefix_id]
                    self._pending_prefix = deque(
                        (pid, f) for pid, f in self._pending_prefix
                        if pid != prefix_id)
            raise
        return prefix_id

    def release_prefix(self, prefix_id: str) -> bool:
        """Drop a shared prefix's pin. Its blocks return to the free list
        once the last stream referencing them retires; queued streams
        naming the id fail at admission. False for an unknown id."""
        with self._prefix_lock:
            prefix = self._prefixes.pop(prefix_id, None)
            if prefix is None:
                return False
            blocks, prefix.blocks = prefix.blocks, None
            if blocks:
                self._allocator.free(blocks)
        self._recorder.record("prefix.release", engine=self.name,
                              prefix_id=prefix_id)
        return True

    def _usable_blocks(self, excluding: Optional[str] = None) -> int:
        """Blocks a request could ever get: the pool's capacity minus the
        prefix pins (a registered prefix not prefilled yet reserves its
        worst case). ``excluding`` leaves one prefix out of the sum."""
        with self._prefix_lock:
            pinned = sum(
                len(p.blocks) if p.blocks
                else blocks_for_tokens(p.length, self.block_size)
                for pid, p in self._prefixes.items() if pid != excluding)
        return self._allocator.capacity - pinned

    # ------------------------------------------------------------ scheduler
    def _live_count(self) -> int:
        return self._pool.live_count()

    # the current pool's parts, for readers outside the scheduler thread;
    # the scheduler's own code reaches only the pool it bound
    @property
    def _cache(self) -> Dict[str, Any]:
        return self._pool.cache

    @property
    def _allocator(self) -> Optional[BlockAllocator]:
        return self._pool.allocator

    @property
    def _prefix_cache(self) -> Optional[PrefixCache]:
        return self._pool.prefix_cache

    def _launch(self, plan: dict, fn):
        """``fn()``, the driver's half of a device operation: on a mesh
        engine its plan goes to the followers first."""
        return fn() if self._plan is None else self._plan.run(plan, fn)

    def _alloc_caches(self) -> _Pool:
        """A pool's device state, which every rank of a mesh allocates:
        the KV cache (this rank's heads) and a speculative engine's draft
        cache."""
        return _Pool(epoch=self._epoch, slots=[None] * self.slots,
                     cache=init_kv_cache(
                         self.cfg, self.slots, self.max_len,
                         dtype=self._cache_dtype, block_size=self.block_size,
                         num_blocks=self.num_blocks, kv_dtype=self.kv_dtype,
                         device=self.device, mesh=self.mesh),
                     draft_cache=self._new_draft_cache()
                     if self._spec is not None else None)

    def _new_pool(self) -> _Pool:
        """Allocate a pool that shares nothing with any earlier one: the
        KV cache, empty slots and, paged, a fresh allocator, zeroed block
        tables and an empty prefix cache; a speculative engine's draft
        cache. A mesh engine's followers allocate theirs under the same
        key, and drop it once the driver's pool is collected."""
        key = next(self._pool_keys)
        pool = self._launch({"op": "pool", "pool": key}, self._alloc_caches)
        pool.key = key
        if self._plan is not None:
            self._plan.drop_later(pool, "pool", key)
        if self.paged:
            pool.allocator = BlockAllocator(self.num_blocks, reserved=1)
            pool.tables = np.zeros((self.slots, self.max_blocks_per_slot),
                                   np.int32)
            if self.prefix_cache_blocks:
                pool.prefix_cache = PrefixCache(
                    pool.allocator, self.block_size, self.prefix_cache_blocks)
        return pool

    def _swap_pool(self, pool: _Pool, restart: bool = False) -> _Pool:
        """Make ``pool`` current and return the one it replaces; the
        caller holds ``_wd_lock``. ``restart`` bumps the epoch in the same
        step. Every registered prefix loses its blocks at once (under
        ``_prefix_lock``, so a prefix's blocks are always the current
        allocator's; it re-prefills on its next use) and the swap store's
        entries go (parked from the replaced pool)."""
        with self._prefix_lock:
            old = self._pool
            if restart:
                self._epoch += 1
            pool.epoch = self._epoch
            self._pool = pool
            for p in self._prefixes.values():
                p.blocks = None
        if self._swap_store is not None:
            self._swap_store.invalidate()
        return old

    def _reset_cache(self, stale: Optional[_Pool] = None) -> bool:
        """Replace the pool by a NEW one in one consistent empty state,
        after a failed step whose partial writes may have left the old one
        inconsistent. ``stale`` is the failing thread's pool: when a
        watchdog restart replaced it first, nothing is replaced (False).
        Cached and swapped blocks go with the old pool, unfreed: their
        references are the old allocator's."""
        pool = self._new_pool()
        with self._wd_lock:
            if stale is not None and self._pool is not stale:
                return False
            self._swap_pool(pool)
        self._pool_gauges()
        return True

    def _pool_gauges(self):
        if not self.paged:
            return
        self.metrics.kv_blocks_total.set(self._allocator.capacity)
        self.metrics.kv_block_bytes.set(self.kv_block_bytes)
        self.metrics.kv_pool_hbm_bytes.set(
            self.num_blocks * self.kv_block_bytes)
        self._update_block_gauges()

    def _new_draft_cache(self) -> Dict[str, Any]:
        """A new draft-model contiguous cache: with every pool, and after
        a failed draft call. Live slots become draft-cold; the caller
        marks them."""
        return init_draft_kv_cache(self._draft_cfg, self.slots,
                                   self._draft_max_len, device=self.device,
                                   mesh=self.mesh)

    @property
    def kv_block_bytes(self) -> int:
        """Device bytes of one KV block across all layers (int8 pools count
        their 1-byte values plus fp32 scales). Paged engines only."""
        if not self.paged:
            raise ValueError(
                "kv_block_bytes is a paged-layout property (this engine "
                "runs the contiguous cache: paged=False); a contiguous "
                "stream's footprint is max_len * "
                "paging.kv_bytes_per_token(...)")
        dt = self._cache_dtype if self._cache_dtype is not None \
            else self.cfg.dtype
        return self.block_size * kv_bytes_per_token(
            self.cfg.layers, self.cfg.heads, self.cfg.head_dim,
            self.kv_dtype, torch.empty((), dtype=dt).element_size())

    def _update_block_gauges(self):
        """Pool occupancy (blocks held, over capacity), prefix pins, the
        fragmentation (the share of touched block capacity holding no
        token), the reservation slack (blocks mapped into a stream's table
        but not yet written: the worst-case tail ``reserve`` holds idle),
        and the prefix-cache and swap-store occupancy. Paged engines
        only."""
        pool = self._pool
        alloc = pool.allocator
        if alloc is None:
            return
        B = self.block_size
        in_use = alloc.in_use
        with self._prefix_lock:
            ready = [p for p in self._prefixes.values() if p.blocks]
            pinned = sum(len(p.blocks) for p in ready)
            tokens = sum(p.length for p in ready)
            touched = sum(blocks_for_tokens(p.length, B) for p in ready)
        slack = 0
        for st in list(pool.slots):
            if st is not None:
                local = max(0, st.length - (st.prefix_len // B) * B)
                tokens += local
                touched += blocks_for_tokens(local, B)
                slack += max(0, (st.n_entries - st.prefix_len // B)
                             - blocks_for_tokens(local, B))
        cap = alloc.capacity
        self.metrics.kv_blocks_in_use.set(in_use)
        self.metrics.kv_blocks_pinned.set(pinned)
        self.metrics.kv_hbm_bytes_in_use.set(in_use * self.kv_block_bytes)
        self.metrics.kv_block_occupancy.set(in_use / cap if cap else 0.0)
        self.metrics.kv_fragmentation.set(
            max(0.0, 1.0 - tokens / (touched * B)) if touched else 0.0)
        self.metrics.kv_reservation_slack.set(slack)
        self.metrics.prefix_cache_blocks.set(
            pool.prefix_cache.total_blocks
            if pool.prefix_cache is not None else 0)
        self.metrics.kv_swapped_blocks_held.set(
            self._swap_store.blocks_held
            if self._swap_store is not None else 0)

    def _loop(self, epoch: int):
        """Scheduler loop for one epoch. Each turn binds the current pool
        and works on it alone. A watchdog restart bumps the epoch and
        swaps in a new pool: this (possibly wedged) thread exits at its
        next bind, and whatever it computes meanwhile lands in its own
        pool and is dropped at its next ``self._pool is pool`` check."""
        bind_card(self.device)
        # the step's staging arrays, allocated once for THIS thread and
        # refilled in place every iteration: a replacement scheduler runs
        # its own _loop and so its own buffers
        buf = self._make_step_buffers()
        try:
            while not self._stop.is_set():
                pool = self._pool
                if pool.epoch != epoch:
                    break
                if self._watchdog is not None:
                    self._watchdog.beat()
                if self.paged:
                    self._drain_prefix_queue(pool)
                self._admit(pool)
                if pool.live_count() and self._pool is pool:
                    try:
                        self._decode_iteration(pool, buf)
                    except Exception as e:   # fail tenants, keep the thread
                        # a verify failure stamps its own fault point
                        self._on_device_failure(
                            e, pool,
                            point=getattr(e, "fault_point",
                                          "generation.decode_step"))
        finally:
            # queued requests are failed by _admission.close() itself; a
            # stale thread must not fail its replacement's tenants
            pool = self._pool
            if self._stop.is_set() and pool.epoch == epoch:
                self._fail_live(RejectedError(
                    "engine shut down mid-generation", "shutdown"), pool)

    def _on_device_failure(self, exc: BaseException, pool: _Pool,
                           point: str):
        """The failure tail of a prefill, decode or verify step: it may
        have written part of its K/V, so every live tenant fails and the
        pool is rebuilt. The breaker counts the failure; the first real
        (not injected, not typed) failure writes a crash dump. A stale
        thread's failure (``pool`` no longer current) touches nothing of
        its replacement's. When no new pool can be built (a CUDA error
        that poisoned the context), the engine stops: the live streams
        hold the step's error, queued requests are rejected ``shutdown``
        and the flight recorder notes ``engine.lost``."""
        self._breaker.record_failure()
        if not getattr(exc, "injected", False) \
                and not isinstance(exc, RejectedError):
            # recorded before the dump, so the dump's snapshot has it
            self._recorder.record("device.failure", engine=self.name,
                                  point=point, error=type(exc).__name__)
        self._maybe_crash_dump(exc, point=point)
        with self._wd_lock:
            current = self._pool is pool
        if not current:
            return
        self._fail_live(exc, pool)
        try:
            self._reset_cache(stale=pool)
        except Exception as lost:
            self._recorder.record("engine.lost", engine=self.name,
                                  error=f"{type(lost).__name__}: {lost}")
            self._stop.set()
            self._admission.close()

    def _admit(self, pool: _Pool):
        """Fill free slots from the queue. Waits briefly only when the
        engine is idle; with live tenants admission is opportunistic so
        decode cadence never stalls on an empty queue. Each head is
        planned (:meth:`_plan_blocks`): shed typed, requeued at the head
        to wait for blocks (FIFO preserved), or seated — by a swap-in, the
        decode-feed seat or a prefill."""
        self._admission.expire_queued()
        for i in range(self.slots):
            if self._stop.is_set() or self._pool is not pool:
                return
            if pool.slots[i] is not None:
                continue
            idle = pool.live_count() == 0
            req = self._admission.take(1, timeout=0.05 if idle else 0.0)
            self.metrics.queue_depth.set(self._admission.depth_requests)
            if req is None:
                if idle:
                    return
                continue
            if self._pool is not pool:
                # the pool was replaced while this turn waited: the turn
                # that binds the new one takes the request
                self._admission.requeue_head(req)
                return
            prefix = cached = None
            if self.paged:
                verdict, prefix, cached = self._plan_blocks(pool, req)
                if verdict == "shed":
                    continue
                if verdict == "wait":
                    self._admission.requeue_head(req)
                    return
            greq: GenerationRequest = req.x
            resumed = greq.resume_tokens is not None
            if not req.future.running():
                if not req.future.set_running_or_notify_cancel():
                    if cached is not None:
                        # the plan's match references must not outlive it
                        pool.allocator.free(cached[2])
                    self._discard_swap(greq)
                    self._finish_request(req.trace, "cancelled",
                                         tenant=req.tenant)
                    continue     # caller cancelled while queued
            if not resumed:
                qw = (time.perf_counter() - req.submit_t) * 1e3
                self.metrics.queue_wait_ms.observe(qw)
                self.metrics.observe_queue_wait_class(req.priority, qw)
                req.trace.event("queue.wait", queue_wait_ms=round(qw, 3))
            if greq.swap_key is not None and self.paged \
                    and self._swap_in_seat(pool, i, req):
                continue
            if prefix is not None or cached is not None:
                self._seat_stream(pool, i, req, prefix, cached)
                continue
            if self.paged and resumed and int(greq.prompt.size) \
                    + int(greq.resume_tokens.size) > self.buckets[-1]:
                # the recompute prompt outgrew the prefill ladder: rebuild
                # the K/V through the decode-feed seat instead
                self._seat_stream(pool, i, req, None, None)
                continue
            with self._wd_lock:   # the watchdog sees the in-flight prefill
                pool.inflight_prefill = req
            try:
                self._prefill_into(pool, i, req)
            except Exception as e:
                self.metrics.failed_total.inc()
                req.trace.event("prefill.failed", error=type(e).__name__)
                # the outcome is recorded by the terminal's winner only:
                # a watchdog that failed this request first keeps its own
                if greq.handle._fail(e):
                    self._finish_request(
                        req.trace, terminal_reason(e),
                        latency_ms=(time.perf_counter() - req.submit_t)
                        * 1e3, tenant=req.tenant)
                self._on_device_failure(e, pool,
                                        point="generation.prefill")
            finally:
                with self._wd_lock:
                    pool.inflight_prefill = None

    # ------------------------------------------------- paged block planning
    def _fresh_blocks_needed(self, prefix_len: int, n_prompt: int,
                             max_new: int, admit: bool = False) -> int:
        """THE block-demand formula: fresh blocks a stream allocates, its
        footprint minus the prefix's full shared blocks (a partially
        filled shared tail is copied into a fresh block). ``admit=False``
        is the worst case (every token the stream may generate): the
        structural bound, and what ``reserve`` takes at seating.
        ``admit=True`` is what seating takes: the same under ``reserve``;
        under ``on_demand`` the prompt's positions plus one (the first
        generated token's write target)."""
        total = prefix_len + n_prompt + max_new
        if admit and self.allocate == "on_demand":
            total = prefix_len + n_prompt + 1
        return blocks_for_tokens(total, self.block_size) \
            - prefix_len // self.block_size

    def _blocks_needed(self, greq: GenerationRequest,
                       prefix: Optional[SharedPrefix],
                       admit: bool = False) -> int:
        """A request's fresh-block demand. A resumed request recomputes its
        generated tokens through the prompt and its remaining budget
        shrinks by as many: its worst case is unchanged."""
        n = int(greq.prompt.size)
        if greq.resume_tokens is not None:
            n += int(greq.resume_tokens.size)
        return self._fresh_blocks_needed(
            prefix.length if prefix is not None else 0,
            n, greq.max_new_tokens - greq.resume_step, admit=admit)

    def _plan_blocks(self, pool: _Pool, req: Request):
        """Dispose of the dequeued head: ``("ok", prefix, cached)`` when its
        seat demand fits the free pool (``cached`` the prefix cache's hit
        ``(entry, m, blocks)``, its block references this planner's),
        ``("wait", None, None)`` when it must wait for retirements or for
        a prefix's prefill, ``("shed", None, None)`` when it was failed
        typed here. The worst case gates structurally; the seat demand
        (the prompt's blocks only under ``on_demand``) gates against the
        free pool."""
        greq: GenerationRequest = req.x
        prefix = None
        if greq.prefix_id is not None:
            with self._prefix_lock:
                prefix = self._prefixes.get(greq.prefix_id)
            if prefix is None:
                e = RuntimeError(
                    f"shared prefix {greq.prefix_id!r} was released while "
                    "this request was queued")
                if greq.handle._fail(e):
                    self._finish_request(req.trace, "client_error",
                                         tenant=req.tenant)
                return "shed", None, None
            if not prefix.ready:
                # K/V lost to a cache rebuild: re-prefill, wait our turn
                self._queue_prefix_prefill(greq.prefix_id)
                return "wait", None, None
        needed_worst = self._blocks_needed(greq, prefix)
        usable = self._usable_blocks()
        waiter = pool.block_waiter
        if waiter is not None and (waiter[0] is req
                                   or waiter[0].future.done()):
            pool.block_waiter = waiter = None
        if needed_worst > usable:
            if greq.resume_tokens is not None:
                # a preemption victim whose footprint can never fit again
                # (prefix pins grew after its blocks were freed)
                self._discard_swap(greq)
                self._shed_typed(req, PreemptedError(
                    f"stream was preempted after {greq.resume_step} "
                    f"token(s) and its resume needs {needed_worst} KV "
                    f"blocks but the pool can free at most {usable} of "
                    f"{pool.allocator.capacity} — resubmit",
                    tokens_generated=greq.resume_step))
                return "shed", None, None
            self._shed_typed(req, KVBlocksExhaustedError(
                f"request needs {needed_worst} KV blocks but the pool "
                f"can free at most {usable} of "
                f"{pool.allocator.capacity} (shared-prefix pins "
                "excluded)",
                needed=needed_worst, usable=usable,
                capacity=pool.allocator.capacity))
            return "shed", None, None
        # the automatic prefix cache's longest block-aligned match (its
        # references taken with the match); resumed streams skip it, their
        # recompute rebuilds the state through the same prefill route
        cached = None
        if (pool.prefix_cache is not None and prefix is None
                and greq.resume_tokens is None and not self._cache_bypass):
            cached = pool.prefix_cache.match_and_ref(greq.prompt)
        if cached is not None:
            m = cached[1]
            needed = self._fresh_blocks_needed(
                m * self.block_size,
                int(greq.prompt.size) - m * self.block_size,
                greq.max_new_tokens, admit=True)
        else:
            needed = self._blocks_needed(greq, prefix, admit=True)
        # off limits: the blocks a queued prefix prefill still needs, and
        # the block waiter's demand when this request's class is the
        # waiter's or lower
        rank = PRIORITIES.index(req.priority)
        reserved = 0
        if waiter is not None and rank >= PRIORITIES.index(waiter[2]):
            reserved = waiter[1]
        avail = pool.allocator.free_count \
            - self._pending_prefix_demand() - reserved
        if needed > avail and pool.prefix_cache is not None \
                and len(pool.prefix_cache):
            # cached blocks are reclaimable: evict LRU entries (never the
            # one just matched) before making anyone wait
            self._cache_evict(pool, needed - avail,
                              protect=cached[0] if cached else None)
            avail = pool.allocator.free_count \
                - self._pending_prefix_demand() - reserved
        if needed > avail:
            if cached is not None:
                pool.allocator.free(cached[2])
            pool.block_waiter = (req, needed, req.priority)
            return "wait", None, None
        return "ok", prefix, cached

    def _pending_prefix_demand(self) -> int:
        """Worst-case blocks the queued, not yet prefilled prefixes need:
        held back from stream admission so retirements accumulate toward
        the prefix prefill."""
        with self._prefix_lock:
            pending = {pid for pid, _ in self._pending_prefix}
            return sum(blocks_for_tokens(p.length, self.block_size)
                       for pid, p in self._prefixes.items()
                       if pid in pending and not p.ready)

    def _queue_prefix_prefill(self, prefix_id: str):
        with self._prefix_lock:
            if any(pid == prefix_id for pid, _ in self._pending_prefix):
                return
            self._pending_prefix.append((prefix_id, None))

    def _drain_prefix_queue(self, pool: _Pool):
        """Prefill the pending shared prefixes (scheduler thread). A prefix
        whose blocks are not free yet stays at the head until retirements
        free them; one that can never fit is unregistered and failed
        typed."""
        while not self._stop.is_set() and self._pool is pool:
            with self._prefix_lock:
                if not self._pending_prefix:
                    return
                pid, fut = self._pending_prefix[0]
                prefix = self._prefixes.get(pid)
                self._prefix_busy = True
            try:
                if prefix is not None and not prefix.ready:
                    nb = blocks_for_tokens(prefix.length, self.block_size)
                    if nb > self._usable_blocks(excluding=pid):
                        with self._prefix_lock:
                            self._prefixes.pop(pid, None)
                        self._pop_prefix_head(pid)
                        if fut is not None:
                            try:
                                fut.set_exception(KVBlocksExhaustedError(
                                    f"prefix {pid!r} needs {nb} KV blocks "
                                    "the pool can never free (pinned by "
                                    "other prefixes)", needed=nb,
                                    usable=self._usable_blocks(),
                                    capacity=pool.allocator.capacity))
                            except InvalidStateError:
                                pass
                        continue
                    if nb > pool.allocator.free_count:
                        return   # wait for retirements to free blocks
                    try:
                        if not self._prefill_prefix(pool, prefix):
                            return   # stale: the new epoch owns the queue
                    except Exception as e:
                        self._pop_prefix_head(pid)
                        if fut is not None:
                            try:
                                fut.set_exception(e)
                            except InvalidStateError:
                                pass
                        self._on_device_failure(e, pool,
                                                point="generation.prefill")
                        return
                self._pop_prefix_head(pid)
                if fut is None:
                    continue
                try:
                    if prefix is None:
                        fut.set_exception(RuntimeError(
                            f"prefix {pid!r} was released before its "
                            "prefill"))
                    else:
                        fut.set_result(pid)
                except InvalidStateError:
                    pass
            finally:
                with self._prefix_lock:
                    self._prefix_busy = False

    def _pop_prefix_head(self, pid: str):
        with self._prefix_lock:
            if self._pending_prefix and self._pending_prefix[0][0] == pid:
                self._pending_prefix.popleft()

    def _prefill_prefix(self, pool: _Pool, prefix: SharedPrefix) -> bool:
        """The one prefill a shared prefix gets per pool: allocate its
        blocks, write its K/V through the bucketed prefill (its sampled
        token discarded), publish ``prefix.blocks``. False when a watchdog
        restart replaced the pool meanwhile: the write went to the old
        pool and the replacement's drain prefills again."""
        alloc = pool.allocator
        n = prefix.length
        nb = blocks_for_tokens(n, self.block_size)
        blocks = alloc.alloc(nb)
        bucket = self._bucket_for(n)
        row = np.zeros(blocks_for_tokens(bucket, self.block_size), np.int32)
        row[:nb] = blocks
        padded = np.zeros((1, bucket), np.int32)
        padded[0, :n] = prefix.tokens
        t0 = time.perf_counter()
        try:
            with self.profiler.span("serving.prefix_prefill",
                                    engine=self.name,
                                    prefix=prefix.prefix_id, tokens=n):
                self._retry_call(lambda: self._donated_call(
                    "generation.prefill", pool, padded, row, n, prng_key(0),
                    0.0, 0, 0))
        except Exception:
            alloc.free(blocks)   # the bound allocator: a stale one is inert
            raise
        with self._prefix_lock:   # held by the pool swap too
            current = self._pool is pool
            registered = current and \
                self._prefixes.get(prefix.prefix_id) is prefix
            if registered:
                prefix.blocks = blocks
        if not current:
            return False
        self._breaker.record_success()
        if not registered:      # released while it was prefilling
            alloc.free(blocks)
            return True
        self.metrics.prefix_prefills_total.inc()
        self.metrics.prefill_ms.observe((time.perf_counter() - t0) * 1e3)
        self._recorder.record("prefix.prefill", engine=self.name,
                              prefix_id=prefix.prefix_id, tokens=n,
                              blocks=nb)
        self._update_block_gauges()
        return True

    def _seat_stream(self, pool: _Pool, i: int, req: Request,
                     prefix: Optional[SharedPrefix], cached):
        """Seat a stream without a prefill — the decode-feed seat, in three
        flavours:

        - an explicit shared prefix: the table references the prefix's
          pinned blocks; a partially filled shared tail block is held
          read-only and copied by the slot's first decode step
          (``_Slot.cow``) into its first fresh block;
        - a prefix-cache hit ``(entry, m, blocks)``: the table references
          the entry's first ``m`` (full) blocks;
        - a bare feed: a resumed stream whose recompute prompt outgrew the
          prefill ladder rebuilds its K/V from position 0.

        Fresh blocks cover the rest of the seat demand; the unprefilled
        tokens (prompt suffix, and a resumed stream's generated tokens)
        ride the decode step one per iteration with mid-feed samples
        discarded. The last feed's sample is token ``resume_step`` (0 for
        a fresh stream), the index the request key folds."""
        greq: GenerationRequest = req.x
        B = self.block_size
        alloc = pool.allocator
        resumed = greq.resume_tokens is not None
        feed = [int(t) for t in greq.prompt]
        if resumed:
            feed += [int(t) for t in greq.resume_tokens]
        cow = cow_src = None
        owned: List[int] = []   # references the planner already holds
        try:
            if prefix is not None:
                P = prefix.length
                with self._prefix_lock:   # the pool swap holds it too
                    pblocks = prefix.blocks if self._pool is pool else None
                if pblocks is None:
                    raise RuntimeError(
                        f"shared prefix {greq.prefix_id!r} was "
                        "invalidated while this request was being "
                        "seated; resubmit")
                shared = list(pblocks[:P // B])
                # the partial tail block is referenced (the copy reads it)
                # but never enters the table: its entry is the copy's dst
                part = [pblocks[P // B]] if P % B else []
                cow_src = pblocks[P // B] if P % B else None
                nfresh = self._blocks_needed(greq, prefix, admit=True)
            elif cached is not None:
                _entry, m, owned = cached
                P = m * B
                shared = list(owned)
                part = []
                nfresh = self._fresh_blocks_needed(
                    P, len(feed) - P, greq.max_new_tokens
                    - greq.resume_step, admit=True)
                feed = feed[m * B:]
            else:
                P = 0
                shared, part = [], []
                nfresh = self._fresh_blocks_needed(
                    0, len(feed), greq.max_new_tokens - greq.resume_step,
                    admit=True)
            fresh = alloc.alloc(nfresh)
            refs = part if owned else shared + part
            try:
                alloc.incref(refs)   # all-or-nothing
            except ValueError as e:
                alloc.free(fresh)
                raise RuntimeError(
                    f"shared prefix {greq.prefix_id!r} was released while "
                    "this request was being seated; resubmit") from e
            held = shared + part + fresh
            if cow_src is not None:
                cow = (cow_src, fresh[0])
        except Exception as e:
            if owned:
                alloc.free(owned)   # the match references must not leak
            if self._pool is not pool:
                self._seat_restarted(req)
            # release_prefix racing the seat: a client lifecycle mistake
            elif greq.handle._fail(e):
                self._finish_request(req.trace, "client_error",
                                     tenant=req.tenant)
            return
        n_shared = len(shared)
        n_entries = n_shared + len(fresh)
        row = np.zeros(self.max_blocks_per_slot, np.int32)
        row[:n_shared] = shared
        row[n_shared:n_entries] = fresh
        st = _Slot(greq=greq, request=req, n_generated=greq.resume_step,
                   last_token=0, length=P, blocks=held, prefix_len=P,
                   pending=deque(feed), cow=cow, n_entries=n_entries,
                   resumed=resumed)
        with self._wd_lock:
            seated = self._pool is pool and not self._stop.is_set()
            if seated:
                pool.tables[i] = row
                pool.slots[i] = st
        if not seated:
            alloc.free(held)     # the bound allocator: a stale one is inert
            self._seat_restarted(req)
            return
        if prefix is not None and not resumed:
            prefix.hits += 1
            self.metrics.prefix_hits_total.inc()
        if cached is not None:
            self.metrics.prefix_cache_hits_total.inc()
        if cow is not None:
            self.metrics.kv_cow_copies_total.inc()
        req.trace.event("slot.assign", slot=i, prefix_id=greq.prefix_id,
                        shared_blocks=n_shared + (1 if cow else 0),
                        fresh_blocks=len(fresh),
                        cached_tokens=P if cached is not None else 0,
                        resumed=resumed)
        self._update_block_gauges()

    def _seat_restarted(self, req: Request):
        """A restart (or shutdown) replaced the pool while ``req`` was
        being seated without a prefill: fail it typed ``watchdog``."""
        if req.x.handle._fail(WatchdogTimeoutError(
                f"engine[{self.name}] restarted while this prompt was "
                "being seated; resubmit")):
            self._finish_request(req.trace, "watchdog", tenant=req.tenant)

    def _swap_in_seat(self, pool: _Pool, i: int, req: Request) -> bool:
        """Re-seat a swapped-out preemption victim by copying its parked
        blocks into freshly allocated ones and rebuilding its table row:
        no prefill, no feed — the slot resumes where the eviction froze it
        and the next decode step continues the stream. The copy is queued
        on the decode step's stream, so that step sees the blocks. False on
        any miss (entry evicted from the store or dropped with a replaced
        pool, pool refusal, a ``kv.swap_in`` fault): the caller falls
        through to the recompute path; a swap failure never sheds."""
        greq: GenerationRequest = req.x
        key, greq.swap_key = greq.swap_key, None   # one shot either way
        store = self._swap_store
        entry = store.take(key) if store is not None else None
        if entry is None:
            return False
        self.metrics.kv_swapped_blocks_held.set(store.blocks_held)
        alloc = pool.allocator
        # the demand _plan_blocks just verified (swapped victims hold no
        # prefix); it covers the parked blocks
        nfresh = self._blocks_needed(greq, None, admit=True)
        try:
            blocks = alloc.alloc(nfresh)
        except KVBlocksExhaustedError:
            return False
        used = entry.used_blocks
        try:
            inject("kv.swap_in", self._blocks_from_host, blocks[:used],
                   entry.payload, pool)
        except Exception as e:
            alloc.free(blocks)
            req.trace.event("kv.swap", direction="in", slot=i,
                            failed=type(e).__name__)
            return False
        row = np.zeros(self.max_blocks_per_slot, np.int32)
        row[:nfresh] = blocks
        st = _Slot(greq=greq, request=req, n_generated=entry.n_generated,
                   last_token=entry.last_token, length=entry.length,
                   blocks=blocks, prefix_len=0, n_entries=nfresh,
                   resumed=True)
        with self._wd_lock:
            seated = self._pool is pool and not self._stop.is_set()
            if seated:
                pool.tables[i] = row
                pool.slots[i] = st
        if not seated:
            alloc.free(blocks)   # the bound allocator: a stale one is inert
            return False         # the recompute path owns the terminal
        greq.swap_ins += 1
        self.metrics.kv_swap_bytes_in.inc(entry.nbytes)
        req.trace.event("kv.swap", direction="in", slot=i, blocks=used,
                        bytes=entry.nbytes)
        req.trace.event("slot.assign", slot=i, swapped_in=True,
                        resumed=True)
        self._update_block_gauges()
        return True

    # ---------------------------------------- on-demand growth + preemption
    def _grow_block_tables(self, pool: _Pool) -> bool:
        """Map a fresh block into every live slot whose next write (at
        position ``st.length``) falls past its mapped entries — the
        on-demand allocator's per-iteration work. Host-side only: the
        fixed-width table row gains an entry, so the decode step's shapes
        (and the paged kernel's split plan) never change. False when a
        watchdog restart replaced the pool (the caller abandons the
        iteration)."""
        B = self.block_size
        while True:
            needy = None
            with self._wd_lock:
                if self._pool is not pool or self._stop.is_set():
                    return False
                for i, st in enumerate(pool.slots):
                    if st is not None and \
                            blocks_for_tokens(st.length + 1, B) > st.n_entries:
                        needy = (i, st)
                        break
            if needy is None:
                return True
            if not self._grow_slot(pool, needy[0], needy[1]):
                return False

    def _grow_slot(self, pool: _Pool, i: int, st: _Slot) -> bool:
        """Allocate one block for slot ``i``'s boundary crossing; when the
        pool is dry, evict prefix-cache entries first, then preempt.
        False only when the pool was replaced; a self-preempted slot
        returns True and the caller's re-scan finds it gone."""
        alloc = pool.allocator
        while True:
            try:
                block = alloc.alloc(1)[0]
            except KVBlocksExhaustedError:
                block = None
            if block is not None:
                with self._wd_lock:
                    current = self._pool is pool
                    seated = current and pool.slots[i] is st
                    if seated:
                        st.n_entries = grow_block_table(
                            pool.tables, i, st.n_entries, block)
                        st.blocks.append(block)
                if not seated:
                    alloc.free([block])   # the stream is gone
                return current
            if pool.prefix_cache is not None and len(pool.prefix_cache):
                if self._cache_evict(pool, 1):
                    continue
            outcome = self._preempt_for(pool, i, st)
            if outcome == "stale":
                return False
            if outcome == "self":
                return True

    def _try_swap_out(self, pool: _Pool, j: int, vst: _Slot):
        """Copy victim slot ``j``'s written blocks (values and int8 scales)
        to host memory. The caller holds ``_wd_lock`` with ``pool``
        current and has not freed the victim's blocks yet: the copy
        completes before this returns, and once ``free_batch`` runs the
        pool may hand the blocks to another stream. Returns ``(key,
        blocks, bytes)``, or ``(None, 0, 0)`` when the victim is at or
        below the threshold, holds shared blocks, has a pending
        copy-on-write or feed (its K/V is not complete), the store cannot
        take it, or the copy fails (a ``kv.swap_out`` fault) — every miss
        resumes by recompute."""
        store = self._swap_store
        if store is None or vst.blocks is None \
                or self.swap_threshold_blocks is None:
            # no threshold: the store exists only for migrated pages
            # (import_pages), and preemption recomputes
            return None, 0, 0
        if len(vst.blocks) <= self.swap_threshold_blocks:
            return None, 0, 0
        if vst.cow is not None or vst.pending:
            return None, 0, 0
        if vst.prefix_len != 0 or vst.greq.prefix_id is not None:
            # shared blocks outlive the eviction; the re-seat's demand
            # would need the plan's shared-block discount
            return None, 0, 0
        used = blocks_for_tokens(vst.length, self.block_size)
        if used <= 0 or used > vst.n_entries:
            return None, 0, 0
        try:
            payload, nbytes = inject("kv.swap_out", self._blocks_to_host,
                                     pool.tables[j][:used], pool)
        except Exception:
            return None, 0, 0
        key = store.put(SwapEntry(
            payload=payload, used_blocks=used, length=vst.length,
            n_generated=vst.n_generated, last_token=int(vst.last_token),
            prefix_len=vst.prefix_len, nbytes=nbytes))
        if key is None:
            return None, 0, 0
        return key, used, nbytes

    def _copy_out(self, cache, blocks, gather: bool = False,
                  to_host: bool = True) -> Tuple[List[Dict[str, Any]], int]:
        """Copy ``blocks`` of every leaf of ``cache`` — K and V values,
        and an int8 pool's scales — into host buffers, pinned on the card;
        returns the per-layer buffers and their bytes. The copies are
        complete when this returns, so the blocks may be freed right
        after. ``gather`` first gathers each block's heads over 'model'
        (a collective: every rank of the mesh calls it); a follower that
        only takes part in it passes ``to_host=False``."""
        rows = torch.as_tensor(np.asarray(blocks, np.int64),
                               device=self.device)
        pin = self.device.type == "cuda"
        specs = self._kv_shardings() if gather else None
        payload, nbytes = [], 0
        for li, lc in enumerate(cache["layers"]):
            parked = {}
            for name, leaf in lc.items():
                src = leaf.index_select(0, rows)
                if gather:
                    src = specs[li][name].gather(src)
                if not to_host:
                    continue
                dst = torch.empty(src.shape, dtype=src.dtype,
                                  pin_memory=pin)
                dst.copy_(src, non_blocking=True)
                parked[name] = dst
                nbytes += dst.numel() * dst.element_size()
            payload.append(parked)
        if pin:
            torch.cuda.current_stream(self.device).synchronize()
        return payload, nbytes

    def _copy_in(self, cache, blocks, payload: List[Dict[str, Any]]):
        """Write :meth:`_copy_out` buffers into ``blocks`` of ``cache``.
        The copies are queued on the current stream, the one the decode
        step runs on, so the next step reads the restored blocks."""
        rows = torch.as_tensor(np.asarray(blocks, np.int64),
                               device=self.device)
        for lc, parked in zip(cache["layers"], payload):
            for name, leaf in lc.items():
                leaf[rows] = parked[name].to(self.device, non_blocking=True)

    def _kv_shardings(self):
        """Per layer, each pool leaf's placement over the mesh."""
        from deeplearning4j_tpu_torch.parallel.mesh import tree_shardings

        return tree_shardings(self.mesh, paged_kv_cache_pspecs(
            self.cfg, self.kv_dtype))["layers"]

    def _own_heads(self, payload: List[Dict[str, Any]]
                   ) -> List[Dict[str, Any]]:
        """This rank's heads of pages that hold every head."""
        specs = self._kv_shardings()
        return [{name: specs[li][name].shard(t) for name, t in layer.items()}
                for li, layer in enumerate(payload)]

    def _blocks_to_host(self, blocks, pool: Optional[_Pool] = None
                        ) -> Tuple[List[Dict[str, Any]], int]:
        """Park ``blocks`` of ``pool`` (the pool the caller bound; by
        default the current one) in host memory (:meth:`_copy_out`): the
        swap-out copy. On a mesh engine every rank parks its own heads of
        the blocks: the driver's buffers come back as a :class:`_Parked`
        whose ticket names the followers' (dropped when it is), and the
        bytes are the driver's."""
        pool = self._pool if pool is None else pool
        if self._plan is None:
            return self._copy_out(pool.cache, blocks)
        ticket = next(self._tickets)
        payload, nbytes = self._launch(
            {"op": "to_host", "pool": pool.key, "ticket": ticket,
             "blocks": np.asarray(blocks)},
            lambda: self._copy_out(pool.cache, blocks))
        parked = _Parked(payload)
        parked.ticket = ticket
        self._plan.drop_later(parked, "parked", ticket)
        return parked, nbytes

    def _blocks_from_host(self, blocks, payload: List[Dict[str, Any]],
                          pool: Optional[_Pool] = None):
        """Write parked blocks into ``blocks`` of ``pool`` (by default the
        current one; :meth:`_copy_in`). On a mesh engine each rank writes
        its own heads: its own parked buffers (a :class:`_Parked`), or its
        heads of pages that hold every head (another engine's export)."""
        pool = self._pool if pool is None else pool
        if self._plan is None:
            return self._copy_in(pool.cache, blocks, payload)
        plan = {"op": "from_host", "pool": pool.key,
                "blocks": np.asarray(blocks)}
        if isinstance(payload, _Parked):
            plan["ticket"] = payload.ticket
            mine = payload
        else:
            plan["whole"] = payload
            mine = self._own_heads(payload)
        return self._launch(plan,
                            lambda: self._copy_in(pool.cache, blocks, mine))

    def _export_blocks(self, blocks, pool: Optional[_Pool] = None
                       ) -> Tuple[List[Dict[str, Any]], int]:
        """Pages of ``blocks`` for another engine (:meth:`_capture_pages`):
        on a mesh engine every rank gathers each block's heads over
        'model', so the driver's pages hold every head — the layout and
        wire format of a one-device engine's."""
        pool = self._pool if pool is None else pool
        if self._plan is None:
            return self._copy_out(pool.cache, blocks)
        return self._launch(
            {"op": "export", "pool": pool.key, "blocks": np.asarray(blocks)},
            lambda: self._copy_out(pool.cache, blocks, gather=True))

    def _follow(self, plan: dict):
        """A follower's half of one of the driver's plans
        (serving/sharded.py): the same launch on this rank's shards."""
        bind_card(self.device)
        for kind, key in plan.get("drops", ()):
            (self._fpools if kind == "pool" else self._fparked).pop(key,
                                                                    None)
        op = plan["op"]
        if op == "pool":
            self._fpools[plan["pool"]] = self._alloc_caches()
            return
        pool = self._fpools[plan["pool"]]
        if op == "step":
            self._step(plan["point"], pool, plan["args"])
        elif op == "draft":
            pool.draft_cache = self._new_draft_cache()
        elif op == "to_host":
            self._fparked[plan["ticket"]] = self._copy_out(
                pool.cache, plan["blocks"])[0]
        elif op == "from_host":
            payload = self._fparked.pop(plan["ticket"]) \
                if "ticket" in plan else self._own_heads(plan["whole"])
            self._copy_in(pool.cache, plan["blocks"], payload)
        elif op == "export":
            self._copy_out(pool.cache, plan["blocks"], gather=True,
                           to_host=False)
        else:
            raise ValueError(f"unknown plan {op!r}")

    def _discard_swap(self, greq: GenerationRequest):
        """Drop a requeued stream's parked blocks (it was shed or
        cancelled: they will never be swapped back in)."""
        if greq.swap_key is not None:
            if self._swap_store is not None:
                self._swap_store.discard(greq.swap_key)
                self.metrics.kv_swapped_blocks_held.set(
                    self._swap_store.blocks_held)
            greq.swap_key = None

    # ------------------------------------ cross-host KV page migration
    def _capture_pages(self, pool: _Pool, req: Request, blocks, length: int,
                       n_generated: int, last_token: int):
        """Export a retiring ``capture_pages`` stream's written blocks
        (values and int8 scales, every layer) as a :class:`SwapEntry` on
        its ``captured_entry``: the prefill half of a migration. The
        caller holds ``_wd_lock`` with ``pool`` current and has not freed
        the blocks: the copy is the swap-out's (:meth:`_blocks_to_host`),
        complete when it returns, so the blocks may go back to the free
        list right after. Any failure (the seeded ``kv.migrate.export``
        point among them) leaves ``captured_entry`` None: the decode host
        recomputes, the stream is never shed."""
        greq: GenerationRequest = req.x
        try:
            payload, nbytes = inject("kv.migrate.export",
                                     self._export_blocks, blocks, pool)
        except Exception as e:
            req.trace.event("kv.migrate", direction="export",
                            failed=type(e).__name__)
            return
        greq.captured_entry = SwapEntry(
            payload=payload, used_blocks=len(blocks), length=int(length),
            n_generated=int(n_generated), last_token=int(last_token),
            prefix_len=0, nbytes=nbytes)
        self.metrics.kv_migrate_bytes_out.inc(nbytes)
        req.trace.event("kv.migrate", direction="export",
                        blocks=len(blocks), bytes=nbytes)

    def take_captured_pages(self, handle: GenerationHandle
                            ) -> Optional[SwapEntry]:
        """One-shot retrieval of a ``capture_pages`` stream's exported
        pages; None when the export failed or never ran (the caller
        recomputes on the decode host). Call once the handle's future has
        resolved: the capture happens before the terminal is delivered."""
        greq = handle._req.x
        if greq is None:
            return None
        entry, greq.captured_entry = greq.captured_entry, None
        return entry

    def import_pages(self, entry: SwapEntry) -> Optional[int]:
        """Park migrated pages in this engine's swap store and return the
        key to pass as ``submit(swap_key=...)``: the decode half of a
        migration re-seats through the swap-in path. The entry is put
        under ``_wd_lock``, so a watchdog restart before its stream is
        admitted drops it with the store's other entries (they name the
        replaced pool's contents) and the stream recomputes. An engine
        without ``swap_threshold_blocks`` gets its store here; preemption
        still gates on the threshold, so it does not change. None when the
        store refuses the entry or the seeded ``kv.migrate.import`` point
        fires: the caller submits without ``swap_key`` and recomputes."""
        if not self.is_driver:
            raise driver_only(self, "import_pages")
        if not self.paged:
            raise ValueError(
                "import_pages requires the paged KV cache "
                "(GenerationEngine(paged=True)) — migrated pages re-seat "
                "through the block pool")
        try:
            with self._wd_lock:
                if self._swap_store is None:
                    self._swap_store = BlockSwapStore(self.num_blocks)
                store = self._swap_store
                key = inject("kv.migrate.import", store.put, entry)
        except Exception:
            return None
        if key is not None:
            self.metrics.kv_migrate_bytes_in.inc(entry.nbytes)
            self.metrics.kv_swapped_blocks_held.set(store.blocks_held)
        return key

    def discard_imported(self, key: int):
        """Drop an :meth:`import_pages` entry whose stream never reached
        admission (its submit was rejected): nothing will take the key,
        so the parked bytes come back now."""
        with self._wd_lock:
            store = self._swap_store
        if store is not None:
            store.discard(key)
            self.metrics.kv_swapped_blocks_held.set(store.blocks_held)

    def _preempt_for(self, pool: _Pool, needy_i: int,
                     needy_st: _Slot) -> str:
        """The pool cannot serve slot ``needy_i``'s next block: evict ONE
        resident stream and requeue it at the queue head — its written
        blocks swapped to host memory when its footprint exceeds
        ``swap_threshold_blocks``, else for recompute-on-resume. Victims
        are of the needy stream's class or lower, never of a tenant the
        QoS policy marks ``preemptible=False``; among them the lowest
        class, then the largest footprint, then the latest arrival goes
        first. With no eligible victim the needy stream preempts itself.
        Returns ``"freed"``, ``"self"`` or ``"stale"`` (a watchdog
        restart replaced the pool)."""
        needy_rank = PRIORITIES.index(needy_st.request.priority)
        with self._wd_lock:
            if self._pool is not pool:
                return "stale"
            best = None
            for j, st in enumerate(pool.slots):
                if st is None or st is needy_st:
                    continue
                if st.request.future.done():
                    continue   # terminal delivered; its retire owns it
                rank = PRIORITIES.index(st.request.priority)
                if rank < needy_rank:
                    continue   # never evict a higher class
                if self.qos is not None and not self.qos.tenant(
                        st.request.tenant).preemptible:
                    continue
                key = (rank, len(st.blocks or ()), st.request.submit_t)
                if best is None or key > best[0]:
                    best = (key, j, st)
            j, vst = (best[1], best[2]) if best is not None \
                else (needy_i, needy_st)
            # the copy to host must finish before free_batch hands these
            # blocks to another stream; under the lock, so a restart's
            # swap-store reset comes before or after it, never mid-way
            swap_key, swap_blocks, swap_bytes = self._try_swap_out(
                pool, j, vst)
            pool.slots[j] = None
            pool.tables[j] = 0
            blocks, vst.blocks = vst.blocks, None
            if blocks:
                pool.allocator.free_batch([blocks])
        greq = vst.greq
        req = vst.request
        greq.resume_tokens = np.asarray(greq.handle.tokens_so_far(),
                                        np.int32)
        greq.resume_step = vst.n_generated
        greq.swap_key = swap_key
        greq.preemptions += 1
        self.metrics.preemptions_total.inc()
        if swap_key is not None:
            self.metrics.kv_swapped_blocks.inc(swap_blocks)
            self.metrics.kv_swap_bytes_out.inc(swap_bytes)
            self.metrics.kv_swapped_blocks_held.set(
                self._swap_store.blocks_held)
            req.trace.event("kv.swap", direction="out", slot=j,
                            blocks=swap_blocks, bytes=swap_bytes)
        req.trace.event("preempt", slot=j,
                        tokens_generated=vst.n_generated,
                        blocks_freed=len(blocks or ()),
                        swapped=swap_key is not None,
                        self_preempted=vst is needy_st)
        self._recorder.record("stream.preempt", engine=self.name,
                              slot=j, tenant=req.tenant,
                              tokens_generated=vst.n_generated,
                              blocks=len(blocks or ()))
        # the deadline bounded queue time, which this stream already
        # served: its requeue must not turn into a 'deadline' shed
        req.deadline_t = None
        if self._stop.is_set():
            self._discard_swap(greq)
            self._shed_typed(req, PreemptedError(
                f"stream preempted after {vst.n_generated} token(s) "
                "while the engine was shutting down — resubmit",
                tokens_generated=vst.n_generated))
        else:
            self._admission.requeue_head(req)
            self.metrics.queue_depth.set(self._admission.depth_requests)
        return "self" if vst is needy_st else "freed"

    def _maybe_cache_retired(self, pool: _Pool, i: int, st: _Slot):
        """Offer a normally retired stream's full blocks to the automatic
        prefix cache instead of freeing them: the block-aligned span of
        the ``st.length`` written positions (the retiring token's own K/V
        was never written), covered by its prompt and generated tokens.
        Explicit-prefix streams are skipped (their pin owns the shared
        span)."""
        cache = pool.prefix_cache
        if cache is None or st.greq.prefix_id is not None \
                or st.blocks is None:
            return
        B = self.block_size
        m = st.length // B
        if m <= 0 or st.n_entries < m:
            return
        seq = np.concatenate([
            np.asarray(st.greq.prompt, np.int32),
            np.asarray(st.greq.handle.tokens_so_far(), np.int32)])
        if seq.size < m * B:
            return
        row = [int(b) for b in pool.tables[i][:m]]
        pool.allocator.incref(row)   # the cache's own reference
        before = len(cache)
        kept = cache.insert(seq[:m * B], row)
        if kept:
            self.metrics.prefix_cache_inserts_total.inc()
        evicted = before + (1 if kept else 0) - len(cache)
        if evicted > 0:
            self.metrics.prefix_cache_evictions_total.inc(evicted)
        # set before the stream's terminal is delivered, so a caller that
        # reads the gauge after result() sees its blocks
        self.metrics.prefix_cache_blocks.set(cache.total_blocks)

    def _cache_evict(self, pool: _Pool, need_blocks: int,
                     protect=None) -> int:
        """Evict LRU prefix-cache entries, counted into the metrics;
        returns the references released."""
        cache = pool.prefix_cache
        before = len(cache)
        released = cache.evict(need_blocks, protect=protect)
        evicted = before - len(cache)
        if evicted > 0:
            self.metrics.prefix_cache_evictions_total.inc(evicted)
        return released

    def _bucket_for(self, n: int) -> int:
        for b in self.buckets:
            if b >= n:
                return b
        return self.buckets[-1]

    def _step(self, point: str, pool: _Pool, host):
        """Launch the step ``point`` names on ``pool`` with its host
        arguments: the one call the driver and a follower both make."""
        fn, params, cache = _STEPS[point]
        return getattr(self, fn)(getattr(self, params), getattr(pool, cache),
                                 *host)

    def _donated_call(self, point: str, pool: _Pool, *host):
        """Run the step ``point`` names on ``pool`` (:data:`_STEPS`) under
        the ``point`` fault hook, and stamp an exception that escapes
        after the step started with ``donated_state_consumed=True``: an
        injected fault raises before the step launches anything (the pool
        is untouched, a retry is safe), but a real failure from the step
        itself may have written part of the pool, so the retry classifier
        refuses it and the fail-tenants-and-rebuild path takes over. On a
        mesh engine the plan goes out inside the hook, so an injected
        fault fires before any rank launches."""
        started = False

        def run(*a):
            nonlocal started
            started = True
            return self._launch(
                {"op": "step", "point": point, "pool": pool.key, "args": a},
                lambda: self._step(point, pool, a))

        try:
            return inject(point, run, *host)
        except BaseException as e:
            if started:
                try:
                    e.donated_state_consumed = True
                except Exception:
                    pass   # an exception with __slots__: stays refused
            raise

    def _screen_token_ids(self, toks: np.ndarray, point: str, live=None):
        """The poisoned-result screen on a step's host copy of its sampled
        ids (no extra device sync): non-finite values (a poison rule may
        rewrite the copy to float) or ids outside [0, vocab) fail the
        iteration typed. Dead slots sample masked garbage by design, so
        only ``live`` entries are screened."""
        a = np.asarray(toks)
        if live is not None:
            a = a[np.asarray(live)]
        if a.size == 0:
            return
        if np.issubdtype(a.dtype, np.inexact) \
                and not bool(np.all(np.isfinite(a))):
            self._poisoned(point, "non-finite sampled token values")
        bad = (a < 0) | (a >= self.cfg.vocab_size)
        if bool(np.any(bad)):
            self._poisoned(
                point, f"{int(np.count_nonzero(bad))} sampled token id(s) "
                       f"outside [0, {self.cfg.vocab_size})")

    def _prefill_into(self, pool: _Pool, slot: int, req: Request):
        """Seat ``req`` in ``slot`` by a prefill. A resumed request's
        generated tokens ride the prompt (recompute-on-resume) and its
        sample is drawn at ``resume_step``; TTFT is observed only for a
        stream's first token (``resume_step == 0``). The prefill writes
        the bound ``pool``; when a watchdog restart replaced it
        meanwhile, the write went to the old pool and the request fails
        typed ``watchdog``. A speculative
        engine then draft-prefills the same prompt (:meth:`_draft_seat`)."""
        greq: GenerationRequest = req.x
        resumed = greq.resume_tokens is not None
        toks = greq.prompt
        if resumed:
            toks = np.concatenate(
                [greq.prompt, np.asarray(greq.resume_tokens, np.int32)])
        n = int(toks.size)
        bucket = self._bucket_for(n)
        padded = np.zeros((1, bucket), np.int32)
        padded[0, :n] = toks
        req.trace.event("slot.assign", slot=slot, bucket=bucket,
                        resumed=resumed)
        alloc = blocks = row = None
        nb_total = 0
        if self.paged:
            alloc = pool.allocator
            nb_total = self._blocks_needed(greq, None, admit=True)
            blocks = alloc.alloc(nb_total)
            row = np.zeros(self.max_blocks_per_slot, np.int32)
            row[:nb_total] = blocks
        t0 = time.perf_counter()
        try:
            with self.profiler.span("serving.prefill", engine=self.name,
                                    slot=slot, bucket=bucket, prompt=n):
                def call():
                    if self.paged:
                        return self._donated_call(
                            "generation.prefill", pool, padded,
                            row[:blocks_for_tokens(bucket, self.block_size)],
                            n, greq.key, greq.temperature, greq.top_k,
                            greq.resume_step)
                    return self._donated_call(
                        "generation.prefill", pool, padded, slot, n,
                        greq.key, greq.temperature, greq.top_k,
                        greq.resume_step)

                tok_host = _host(self._retry_call(call)[1]).reshape(-1)
                if self.screen_outputs:
                    self._screen_token_ids(tok_host, "generation.prefill")
                tok = int(tok_host[0])
        except Exception:
            if blocks is not None:
                alloc.free(blocks)   # the bound allocator: stale is inert
            raise
        with self._wd_lock:
            current = self._pool is pool
        if not current:
            # a restart replaced the pool while this (stale) prefill ran:
            # fail the request typed rather than leave its future hanging
            if blocks is not None:
                alloc.free(blocks)
            req.trace.event("watchdog.restart", stale=True)
            if greq.handle._fail(WatchdogTimeoutError(
                    f"engine[{self.name}] restarted while this prompt was "
                    "in prefill; resubmit")):
                self._finish_request(req.trace, "watchdog",
                                     tenant=req.tenant)
            return
        self._breaker.record_success()
        now = time.perf_counter()
        req.trace.event("prefill", dur_ms=round((now - t0) * 1e3, 3),
                        slot=slot, bucket=bucket, prompt=n)
        self.metrics.prefill_ms.observe((now - t0) * 1e3)
        if greq.resume_step == 0:
            self.metrics.ttft_ms.observe((now - req.submit_t) * 1e3)
        self.metrics.prefills_total.inc()
        self.metrics.generated_tokens_total.inc()
        state = _Slot(greq=greq, request=req,
                      n_generated=greq.resume_step + 1, last_token=tok,
                      length=n, blocks=blocks, n_entries=nb_total,
                      resumed=resumed)
        if greq.capture_pages and blocks is not None \
                and self._retire_reason(state, tok) is not None:
            # a stream retiring at its first token (the disaggregated
            # prefill stage runs max_new_tokens=1): export its pages before
            # _push resolves the future, since the orchestrator reads the
            # entry the moment result() returns
            used = blocks_for_tokens(n, self.block_size)
            if 0 < used <= nb_total:
                with self._wd_lock:
                    if self._pool is pool:
                        self._capture_pages(pool, req, blocks[:used], n,
                                            state.n_generated, tok)
        err = greq.handle._push(tok)
        if err is not None:
            # a broken on_token consumer failed its own stream
            req.trace.event("on_token.failed", error=type(err).__name__)
            self._finish_request(req.trace, "client_error",
                                 tenant=req.tenant)
            self._release_blocks(pool, state)
        elif self._maybe_retire(state, tok):
            self._release_blocks(pool, state)   # retired at its first token
        else:
            with self._wd_lock:
                # a restart after the check above swapped in a pool
                # without this stream's K/V: do not seat it
                registered = self._pool is pool
                if registered:
                    if self.paged:
                        pool.tables[slot] = row
                    pool.slots[slot] = state
            if not registered:
                self._release_blocks(pool, state)
            elif self._spec is not None:
                self._draft_seat(pool, slot, state, padded)
        if self.paged:
            self._update_block_gauges()

    def _draft_seat(self, pool: _Pool, slot: int, state: _Slot,
                    padded: np.ndarray):
        """Draft-prefill a just-seated stream's prompt into the draft cache
        (speculative engines). Any failure, a ``generation.draft_prefill``
        fault included, takes the degrade path: the draft cache is
        rebuilt, every live slot goes draft-cold, and the stream itself
        goes on at plain speed — a failing draft never sheds. A prompt
        bucket wider than the draft's positional table leaves the slot
        cold."""
        if padded.shape[1] > self._draft_cfg.max_seq:
            return
        try:
            self._donated_call("generation.draft_prefill", pool, padded,
                               slot)
        except Exception as e:
            self._draft_failed(pool, "generation.draft_prefill", e)
            return
        state.draft_len = state.length

    def _draft_failed(self, pool: _Pool, point: str, exc: BaseException):
        """The degrade path of a failed draft call: count it, feed the
        draft breaker, rebuild the pool's draft cache (the call may have
        written part of it) and make its live slots draft-cold."""
        self._draft_breaker.record_failure()
        self.metrics.spec_fallbacks_total.inc()
        self._recorder.record("spec.draft_failure", engine=self.name,
                              point=point, error=type(exc).__name__)
        if self._pool is pool:   # a replaced pool is dropped whole
            pool.draft_cache = self._launch(
                {"op": "draft", "pool": pool.key}, self._new_draft_cache)
            for st in pool.slots:
                if st is not None:
                    st.draft_len = -1

    def _make_step_buffers(self) -> Dict[str, np.ndarray]:
        """One scheduler thread's step staging arrays: every per-slot
        argument of the decode (and verify) step but the block tables
        (the pool's own), shaped by the engine's configuration only,
        refilled in place each iteration."""
        S = self.slots
        buf = {"tokens": np.zeros(S, np.int64),
               "live": np.zeros(S, bool),
               "keys": np.zeros((S, 2), np.uint32),
               "steps": np.zeros(S, np.int64),
               "temps": np.zeros(S, np.float32),
               "top_ks": np.zeros(S, np.int64),
               "lengths": np.zeros(S, np.int64),
               "cow_src": np.zeros(S, np.int64),
               "cow_dst": np.zeros(S, np.int64)}
        if self._spec is not None:
            buf["spec_tokens"] = np.zeros((S, self._spec.k + 1), np.int64)
            buf["draft_feed"] = np.zeros(S, np.int64)
        return buf

    def _decode_iteration(self, pool: _Pool, buf: Dict[str, np.ndarray]):
        """One scheduler turn: a single decode step over ALL slots (dead
        slots ride along: on the scratch block, or on their own row of the
        contiguous cache), then stream/retire per live slot. Under
        ``on_demand`` the slots crossing a block boundary get their block
        first (preempting when the pool is dry). A feeding slot's token is
        its next pending prompt token and its sample is discarded until
        the feed ends; a pending copy-on-write goes out once as
        ``cow_src``/``cow_dst``. A speculative engine takes the turn
        through :meth:`_spec_turn` when any slot can speculate.

        Everything the step reads and writes is the bound ``pool``'s:
        after a watchdog restart a stale step writes into the abandoned
        pool and its tokens are dropped."""
        S = self.slots
        if self.paged and self.allocate == "on_demand":
            if not self._grow_block_tables(pool):
                return   # the pool was replaced mid-growth
        tokens, live, keys = buf["tokens"], buf["live"], buf["keys"]
        steps, temps, top_ks = buf["steps"], buf["temps"], buf["top_ks"]
        lengths = buf["lengths"]
        cow_src, cow_dst = buf["cow_src"], buf["cow_dst"]
        for a in (tokens, live, keys, steps, temps, top_ks, lengths,
                  cow_src, cow_dst):
            a.fill(0)
        states = list(pool.slots)
        n_live = 0
        for i, st in enumerate(states):
            if st is None:
                continue
            n_live += 1
            tokens[i] = st.pending[0] if st.pending else st.last_token
            live[i] = True
            keys[i] = st.greq.key
            steps[i] = st.n_generated
            temps[i] = st.greq.temperature
            top_ks[i] = st.greq.top_k
            lengths[i] = st.length
            if st.cow is not None:
                cow_src[i], cow_dst[i] = st.cow
        self.metrics.slot_occupancy.set(n_live / S)
        if not n_live:
            return   # growth preempted every stream: nothing to decode
        if self._spec is not None and not self._spec_force_plain \
                and self._spec_turn(pool, buf, states, n_live):
            return
        t0 = time.perf_counter()
        tables = pool.tables
        with self.profiler.span("serving.decode_step", engine=self.name,
                                live=n_live, slots=S):
            def call():
                if self.paged:
                    return self._donated_call(
                        "generation.decode_step", pool, tables, lengths,
                        tokens, keys, steps, temps, top_ks, cow_src, cow_dst)
                return self._donated_call(
                    "generation.decode_step", pool, tokens, live, keys,
                    steps, temps, top_ks)

            toks = _host(self._retry_call(call)[1])
            if self.screen_outputs:
                # before any commit: a poisoned iteration takes the
                # fail-tenants and rebuild path
                self._screen_token_ids(toks, "generation.decode_step",
                                       live=live)
        with self._wd_lock:
            current = self._pool is pool
        if not current:
            return   # stale: the restart failed these tenants typed
        self._breaker.record_success()
        dt_ms = (time.perf_counter() - t0) * 1e3
        now = time.perf_counter()
        self.metrics.decode_step_ms.observe(dt_ms)
        self.metrics.decode_wall_ms.inc(dt_ms)
        self.metrics.decode_steps_total.inc()
        emitted = 0
        for i, st in enumerate(states):
            if st is None:
                continue
            res = self._commit_sampled(pool, i, st, int(toks[i]), dt_ms,
                                       now)
            if res == "stale":
                return
            if res != "fed":
                emitted += 1
        self.metrics.generated_tokens_total.inc(emitted)
        self.metrics.slot_occupancy.set(pool.live_count() / S)
        if self.paged:
            self._update_block_gauges()

    def _spec_turn(self, pool: _Pool, buf: Dict[str, np.ndarray],
                   states: List[Optional[_Slot]], n_live: int) -> bool:
        """One speculative turn: k draft steps, then ONE verify step over
        all slots, committing each slot's accepted prefix. False hands the
        turn back to the plain decode step: no slot can speculate, the
        draft breaker is open, or a draft step failed (the degrade path;
        the draft is not retried).

        A slot speculates when it is draft-warm (``draft_len == length``),
        feeds no prompt and its tenant is not demoted. The others ride the
        verify all the same and commit exactly one token, as in a plain
        turn. Each slot commits ``c = min(accepted + 1, k, cap)`` samples
        through :meth:`_commit_sampled`, ``cap`` the positions its mapped
        blocks and ``max_seq`` still hold (writes past them went to
        scratch); the verify counts as one decode step. The verify is
        retried like the decode step; a real verify failure propagates to
        the scheduler loop stamped ``fault_point='generation.verify_step'``
        (fail the tenants, rebuild)."""
        spec = self._spec
        k = spec.k
        elig = [st is not None and not st.pending
                and st.draft_len == st.length
                and not self._spec_governor.demoted(st.request.tenant)
                for st in states]
        if not any(elig):
            return False
        if not self._draft_breaker.allow():
            self.metrics.spec_fallbacks_total.inc()
            return False
        dtoks = buf["spec_tokens"]
        dtoks[:, 0] = buf["tokens"]
        feed = buf["draft_feed"]
        np.copyto(feed, buf["tokens"])
        try:
            with self.profiler.span("serving.draft_step", engine=self.name,
                                    live=n_live, k=k):
                for j in range(k):
                    props = _host(self._donated_call(
                        "generation.draft_step", pool, feed,
                        buf["lengths"] + j, buf["keys"], buf["steps"] + j,
                        buf["temps"], buf["top_ks"])[1])
                    if self.screen_outputs:
                        self._screen_token_ids(
                            props, "generation.draft_step",
                            live=np.asarray(elig))
                    dtoks[:, j + 1] = props
                    np.copyto(feed, props)
        except Exception as e:
            self._draft_failed(pool, "generation.draft_step", e)
            return False
        with self._wd_lock:
            if self._pool is not pool:
                return True   # stale: the restart failed these tenants
        self._draft_breaker.record_success()
        t0 = time.perf_counter()
        tables = pool.tables
        try:
            with self.profiler.span("serving.verify_step", engine=self.name,
                                    live=n_live, slots=self.slots, k=k):
                def call():
                    return self._donated_call(
                        "generation.verify_step", pool, tables,
                        buf["lengths"], dtoks, buf["keys"], buf["steps"],
                        buf["temps"], buf["top_ks"], buf["cow_src"],
                        buf["cow_dst"])

                _, samples, accepted = self._retry_call(call)
                samples = _host(samples)
                accepted = _host(accepted)
                if self.screen_outputs:
                    self._screen_token_ids(samples, "generation.verify_step",
                                           live=buf["live"])
        except Exception as e:
            try:
                e.fault_point = "generation.verify_step"
            except Exception:
                pass   # an exception with __slots__: the generic label
            raise
        with self._wd_lock:
            current = self._pool is pool
        if not current:
            return True   # stale: the restart failed these tenants
        self._breaker.record_success()
        dt_ms = (time.perf_counter() - t0) * 1e3
        now = time.perf_counter()
        self.metrics.decode_step_ms.observe(dt_ms)
        self.metrics.decode_wall_ms.inc(dt_ms)
        self.metrics.decode_steps_total.inc()
        B = self.block_size
        emitted = 0
        for i, st in enumerate(states):
            if st is None:
                continue
            if elig[i]:
                cap = max(1, min(st.n_entries * B, self.cfg.max_seq)
                          - st.length)
                c = min(int(accepted[i]) + 1, k, cap)
                self.metrics.record_spec_outcome(
                    st.request.tenant, k, int(accepted[i]))
                self._spec_governor.record(
                    st.request.tenant, k, int(accepted[i]))
            else:
                c = 1   # cold, feeding or demoted: a plain turn
            res = "ok"
            for j in range(c):
                res = self._commit_sampled(pool, i, st, int(samples[i, j]),
                                           dt_ms, now)
                if res == "stale":
                    return True
                if res != "fed":
                    emitted += 1
                if res in ("retired", "client_error"):
                    break
            if elig[i] and res == "ok":
                # the draft wrote positions length..length+k-1 and c <= k
                # of them were committed: its cache is as long as the
                # stream again
                if pool.slots[i] is st:
                    st.draft_len = st.length
        self.metrics.generated_tokens_total.inc(emitted)
        self.metrics.slot_occupancy.set(pool.live_count() / self.slots)
        self._update_block_gauges()
        return True

    def _commit_sampled(self, pool: _Pool, i: int, st: _Slot, tok: int,
                        dt_ms: float, now: float) -> str:
        """Commit one sampled token to slot ``i``: advance the stream (a
        mid-feed sample is discarded: ``"fed"``), retire it on EOS/budget
        (its full blocks offered to the prefix cache, its slot freed for
        the next admission), deliver the token. Returns ``"stale"`` (the
        pool was replaced: the caller abandons the iteration), ``"fed"``,
        ``"ok"``, ``"retired"`` or ``"client_error"``. The stream is
        touched under ``_wd_lock`` with ``pool`` current, so a stale
        step's token never reaches a caller."""
        reason = None
        fed_only = first_token = False
        with self._wd_lock:
            if self._pool is not pool:
                return "stale"
            st.length += 1
            st.cow = None          # the copy landed with this step
            if st.pending:
                st.pending.popleft()
                if st.pending:
                    fed_only = True
                else:
                    first_token = True
            if not fed_only:
                st.n_generated += 1
                st.last_token = tok
                reason = self._retire_reason(st, tok)
                if reason is not None:
                    if st.greq.capture_pages and st.blocks is not None:
                        # a decode-feed seat retiring (a prefix or cache
                        # hit, EOS at its first token): export the written
                        # pages while the blocks are still referenced
                        # (st.length counts written positions; the
                        # retiring token's K/V never is)
                        used = blocks_for_tokens(st.length, self.block_size)
                        if 0 < used <= st.n_entries:
                            self._capture_pages(
                                pool, st.request, pool.tables[i][:used],
                                st.length, st.n_generated, tok)
                    self._maybe_cache_retired(pool, i, st)
                    self._clear_slot(pool, i, st)
        if fed_only:
            st.request.trace.event("prompt.feed", slot=i,
                                   remaining=len(st.pending))
            return "fed"
        if first_token and st.greq.resume_step == 0:
            # a feed stream's first token lands here, never again on resume
            self.metrics.ttft_ms.observe((now - st.request.submit_t) * 1e3)
        st.request.trace.event("decode.step", step=st.n_generated - 1,
                               dur_ms=round(dt_ms, 3), slot=i, token=tok)
        err = st.greq.handle._push(tok)
        if err is not None:
            # a broken on_token consumer: its handle holds the terminal
            st.request.trace.event("on_token.failed",
                                   error=type(err).__name__)
            if reason is None:
                with self._wd_lock:
                    if self._pool is pool and pool.slots[i] is st:
                        self._clear_slot(pool, i, st)
            self._finish_request(st.request.trace, "client_error",
                                 tenant=st.request.tenant)
            return "client_error"
        if reason is not None:
            self._finish_stream(st, reason)
            return "retired"
        return "ok"

    def _retire_reason(self, st: _Slot, tok: int) -> Optional[str]:
        if st.greq.eos_id is not None and tok == st.greq.eos_id:
            return "eos"
        if st.n_generated >= st.greq.max_new_tokens:
            return "max_tokens"
        return None

    def _finish_stream(self, st: _Slot, reason: str):
        delivered = st.greq.handle._finish(reason)
        self.metrics.generations_completed.inc()
        lat = (time.perf_counter() - st.request.submit_t) * 1e3
        self.metrics.latency_ms.observe(lat)
        st.request.trace.event("stream.finish", finish_reason=reason,
                               tokens=st.n_generated)
        if delivered:
            self._finish_request(st.request.trace, "ok", latency_ms=lat,
                                 tenant=st.request.tenant)
        else:
            # the terminal was delivered elsewhere (a watchdog, a broken
            # on_token) and counted there: close the trace with it
            try:
                exc = st.request.future.exception(timeout=0)
            except BaseException:
                exc = None   # a cancelled future: exception() raises
            st.request.trace.finish(
                "cancelled" if exc is None else terminal_reason(exc),
                latency_ms=lat)

    def _maybe_retire(self, st: _Slot, tok: int) -> bool:
        reason = self._retire_reason(st, tok)
        if reason is None:
            return False
        self._finish_stream(st, reason)
        return True

    def _release_blocks(self, pool: _Pool, st: _Slot):
        """Drop a stream's block references into the allocator of the
        pool it was seated in (idempotent)."""
        if st.blocks is None:
            return
        blocks, st.blocks = st.blocks, None
        pool.allocator.free(blocks)

    def _clear_slot(self, pool: _Pool, i: int, st: _Slot):
        """Vacate slot ``i`` and point its block-table row back at the
        scratch block: a dead slot still takes part in every decode step
        and writes where its row says, so a stale row would aim that write
        at blocks the next admission may hand to a new stream."""
        pool.slots[i] = None
        if self.paged:
            pool.tables[i] = 0
        self._release_blocks(pool, st)

    def _fail_live(self, exc: BaseException, pool: _Pool):
        """Fail every live tenant of ``pool`` and vacate its slot, each
        under ``_wd_lock`` while ``pool`` is current: a restart that
        replaced it failed them itself. Futures resolve outside the
        lock."""
        reason = terminal_reason(exc)
        victims: List[_Slot] = []
        for i in range(self.slots):
            with self._wd_lock:
                if self._pool is not pool:
                    break
                st = pool.slots[i]
                if st is None:
                    continue
                self._clear_slot(pool, i, st)
            victims.append(st)
        for st in victims:
            if st.greq.handle._fail(exc):
                self._finish_request(st.request.trace, reason,
                                     tenant=st.request.tenant)

    # a preempted stream requeued with parked blocks can die in the queue
    # (deadline, shutdown, a caller's cancel): its host memory comes back
    # with it
    def _count_shed(self, req: Request):
        self._discard_swap(req.x)
        super()._count_shed(req)

    def _count_close_reject(self, req: Request):
        self._discard_swap(req.x)
        super()._count_close_reject(req)

    def _count_cancelled(self, req: Request):
        self._discard_swap(req.x)
        super()._count_cancelled(req)

    # ---------------------------------------------- resilience mixin hooks
    def _retry_traces(self):
        pool = self._pool
        with self._wd_lock:
            if pool.inflight_prefill is not None:
                return (pool.inflight_prefill.trace,)
        return tuple(s.request.trace for s in list(pool.slots)
                     if s is not None)

    def _crash_dump_model(self):
        return self.params

    def _crash_dump_context(self) -> dict:
        pool = self._pool
        ctx = {"slots": self.slots, "live_slots": pool.live_count()}
        if self.paged:
            ctx.update(kv_blocks=pool.allocator.num_blocks,
                       kv_blocks_free=pool.allocator.free_count,
                       block_size=self.block_size)
        return ctx

    def _watchdog_busy(self) -> bool:
        pool = self._pool
        with self._wd_lock:
            if pool.inflight_prefill is not None or self._prefix_busy:
                return True
        with self._prefix_lock:
            if self._pending_prefix:
                return True
        return pool.live_count() > 0 or self._admission.depth_requests > 0

    def _watchdog_stall(self):
        """The watchdog's recovery hook: the scheduler stopped
        heartbeating with work outstanding. Swap in a NEW pool and bump
        the epoch in one locked step (the stale thread keeps the pool it
        bound and writes only there if it wakes), fail the old pool's
        in-prefill request and live streams typed ``watchdog``, and start
        a fresh scheduler over the kept queue."""
        pool = self._new_pool()
        with self._wd_lock:
            old = self._swap_pool(pool, restart=True)
            epoch = pool.epoch
            pre = old.inflight_prefill
        exc = WatchdogTimeoutError(
            f"engine[{self.name}] scheduler missed its heartbeat for "
            f">{self._watchdog.timeout_s * 1e3:.0f} ms; live generations "
            f"failed, scheduler restarted")
        failed = 0
        if pre is not None:
            pre.trace.event("watchdog.restart", epoch=epoch, in_prefill=True)
            if pre.x.handle._fail(exc):
                self._finish_request(pre.trace, "watchdog",
                                     tenant=pre.tenant)
            failed += 1
        # the old pool's slots stay as they are: the stale thread owns them
        for i, st in enumerate(list(old.slots)):
            if st is not None:
                st.request.trace.event("watchdog.restart", epoch=epoch,
                                       slot=i)
                if st.greq.handle._fail(exc):
                    self._finish_request(st.request.trace, "watchdog",
                                         tenant=st.request.tenant)
                failed += 1
        if failed:
            self.metrics.failed_total.inc(failed)
        self.metrics.watchdog_restarts.inc()
        self.metrics.record_rejection("watchdog")
        self._recorder.record("watchdog.restart", engine=self.name,
                              epoch=epoch, victims=failed)
        self.metrics.slot_occupancy.set(0.0)
        self._breaker.record_failure()
        self._pool_gauges()
        self._thread = threading.Thread(
            target=self._loop, args=(epoch,),
            name=f"generation-scheduler[{self.name}]#{epoch}", daemon=True)
        self._thread.start()

    # -------------------------------------------------------------- insight
    @property
    def live_slots(self) -> int:
        return self._live_count()

    @property
    def queue_depth(self) -> int:
        return self._admission.depth_requests

    def ledger_stats(self) -> dict:
        """Point-in-time resource accounting for the resource ledger
        (:mod:`.ledger`): resident slots, queued requests, KV blocks by
        attribution (free / explicit pins / automatic cache) and swap-store
        residency. Reads only; each lock is taken briefly on its own."""
        stats = {"name": self.name,
                 "live_slots": self._live_count(),
                 "queue_depth": self._admission.depth_requests}
        pool = self._pool
        alloc, store, cache = (pool.allocator, self._swap_store,
                               pool.prefix_cache)
        if alloc is not None:
            stats["kv_capacity_blocks"] = alloc.capacity
            stats["kv_free_blocks"] = alloc.free_count
            stats["kv_blocks_in_use"] = alloc.in_use
        if store is not None:
            stats["swap_entries"] = len(store)
            stats["swap_blocks_held"] = store.blocks_held
        if cache is not None:
            stats["kv_prefix_cache_blocks"] = cache.total_blocks
        with self._prefix_lock:
            stats["pinned_prefixes"] = len(self._prefixes)
            stats["kv_pinned_blocks"] = sum(
                len(p.blocks) for p in self._prefixes.values() if p.blocks)
        return stats

    def warmup(self) -> "GenerationEngine":
        """Run one short throwaway stream per prefill bucket (token-0
        prompts, the shortest length that maps to each rung) so the first
        live request does not pay one-time set-up: the kernels' build and
        load, the allocator's and libraries' first use. The prefix cache
        is bypassed meanwhile (a rung's probe must prefill) and its probe
        entries are dropped after. A speculative engine also runs one
        probe through the plain decode fallback. A mesh engine's
        followers return at once: they run the driver's probes."""
        if not self.is_driver:
            return self
        prev = 0
        self._cache_bypass = True
        try:
            for b in self.buckets:
                n, prev = prev + 1, b
                new = min(2, self.max_len - n)
                if new < 1:
                    continue   # rung admits no prompt at all (n == max_len)
                # eos_id=None: an engine eos_id matching the continuation
                # would retire every probe at prefill and skip the decode
                self.generate(np.zeros(n, np.int32), max_new_tokens=new,
                              eos_id=None, timeout=300.0)
        finally:
            self._cache_bypass = False
            if self._prefix_cache is not None:
                self._prefix_cache.release_all()
        if self._spec is not None and self.max_len >= 2:
            # the rungs ran the draft and verify steps; one forced-plain
            # probe runs the plain decode fallback too
            self._spec_force_plain = True
            try:
                self.generate(np.zeros(1, np.int32),
                              max_new_tokens=min(2, self.max_len - 1),
                              eos_id=None, timeout=300.0)
            finally:
                self._spec_force_plain = False
        return self


def client_stream_handle(prompt_len: int,
                         on_token: Optional[Callable[[int], None]] = None,
                         tenant: Optional[str] = None) -> GenerationHandle:
    """A :class:`GenerationHandle` backed by no local scheduler — the
    client half of a cross-host stream (serving/rpc.py's bridge and the
    front door's hedging supervisor in serving/cluster.py). The bridge
    delivers through the hooks the scheduler uses — ``_push`` per token,
    ``_finish``/``_fail`` exactly once at the terminal — so ``result()``,
    ``stream()``, ``tokens_so_far()`` and ``on_token`` behave the same
    whether the tokens were decoded in this process or long-polled off a
    remote host. The admission ``Request`` only carries the future and
    the tenant label; it never enters a queue."""
    req = Request(x=None, rows=1,
                  tenant=tenant if tenant is not None else DEFAULT_TENANT)
    return GenerationHandle(req, prompt_len, on_token=on_token)
