"""Continuous-batching generation engine: ORCA-style iteration-level
scheduling over the paged KV cache of ``models/bert.py`` (counterpart:
``deeplearning4j_tpu/serving/generation.py``).

Every turn of the scheduler thread (1) admits queued prompts into free
slots — a prompt prefills alone, padded to a length bucket, into KV blocks
reserved for its whole worst-case footprint — (2) runs ONE decode step for
all slots, (3) streams each new token to its caller and (4) retires
streams on EOS or their token budget so the slot serves the next prompt.
Admission is gated on free KV blocks as well as free slots: a request the
pool can never hold sheds typed ``kv_blocks_exhausted``, one that merely
has to wait for retirements stays at the queue head.

Sampling is gumbel-max under a per-request key folded with the token
index, computed row by row, so a stream's tokens are the same whether it
decodes alone or beside any neighbours — and, with the same weights, the
same as the JAX engine's.

Ported: the paged cache under the ``reserve`` allocation, ``kv_dtype``
``float32``/``int8``, the ``gather``/``fused`` decode attention routes,
greedy/temperature/top-k sampling, EOS and max-token retirement, bounded
FIFO admission with deadlines, one device. Shared prefixes, on-demand
allocation and preemption, the prefix cache and swap, speculation, QoS,
resilience, tracing and meshes are not ported yet.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
import time
from concurrent.futures import Future, InvalidStateError
from typing import Any, Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from deeplearning4j_tpu_torch import default_device
from deeplearning4j_tpu_torch.models.bert import (
    compute_params, init_kv_cache, make_paged_decode_step,
    make_paged_prefill, validate_block_size, validate_kv_dtype)
from deeplearning4j_tpu_torch.models.random import prng_key
from deeplearning4j_tpu_torch.serving.admission import (
    AdmissionController, KVBlocksExhaustedError, RejectedError, Request)
from deeplearning4j_tpu_torch.serving.engine import bucket_ladder
from deeplearning4j_tpu_torch.serving.metrics import ServingMetrics
from deeplearning4j_tpu_torch.serving.paging import (
    BlockAllocator, blocks_for_tokens, kv_bytes_per_token)

_DONE = object()
_UNSET = object()   # submit()'s "use the engine default" eos sentinel


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
    handle: "GenerationHandle" = None


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


@dataclasses.dataclass
class _Slot:
    """Scheduler-side state of one occupied cache slot."""

    greq: GenerationRequest
    request: Request
    n_generated: int = 0
    last_token: int = 0
    length: int = 0                  # tokens whose K/V are in the cache
    blocks: Optional[List[int]] = None   # the blocks this stream holds


class GenerationEngine:
    """Iteration-level scheduler over one causal LM and one paged KV cache
    on one device.

    ``submit(prompt)`` returns a :class:`GenerationHandle`; a background
    thread runs the admit → decode → stream → retire loop. ``slots``
    bounds concurrent generations and ``max_len`` is a stream's capacity
    (prompt + generated tokens). K/V live in a pool of ``num_blocks``
    blocks of ``block_size`` tokens (default: the contiguous footprint,
    16-token blocks); a stream reserves ``ceil((len + max_new) /
    block_size)`` blocks when it is seated.

    ``kv_dtype`` selects the pool's storage: ``"float32"`` (full precision
    in the cache dtype, by default the model's compute dtype) or
    ``"int8"`` (quantize on write, dequantize on read, per-token scales).
    ``paged_attention`` selects the decode attention read: ``"gather"``
    (the reference's default: materialize the block gather) or
    ``"fused"`` (the hand-written paged-attention kernel).

    The engine keeps one compute-dtype copy of the weights on ``device``,
    made once here (:func:`~deeplearning4j_tpu_torch.models.bert.
    compute_params`); ``device`` defaults to ``"cuda"``."""

    def __init__(self, params, cfg, *, slots: int = 8,
                 max_len: Optional[int] = None,
                 buckets: Optional[Sequence[int]] = None,
                 cache_dtype: Optional[torch.dtype] = None,
                 block_size: Optional[int] = None,
                 num_blocks: Optional[int] = None,
                 kv_dtype: str = "float32",
                 paged_attention: str = "gather",
                 queue_capacity: int = 64,
                 default_timeout_ms: Optional[float] = None,
                 eos_id: Optional[int] = None,
                 metrics: Optional[ServingMetrics] = None,
                 device=None, name: str = "generation"):
        if not cfg.causal:
            raise ValueError(
                "GenerationEngine needs a causal LM: TransformerConfig("
                "causal=True) — a bidirectional encoder has no decode order")
        if slots <= 0:
            raise ValueError("slots must be positive")
        self.device = default_device(device)
        self.cfg = cfg
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
        if block_size is None:
            # 16-token blocks, degrading to the largest power of two that
            # fits a tiny max_len
            block_size = 16
            while block_size > self.max_len:
                block_size //= 2
        self.block_size = validate_block_size(block_size, self.max_len)
        self.kv_dtype = validate_kv_dtype(kv_dtype, self.block_size)
        self.paged_attention = paged_attention
        self.max_blocks_per_slot = blocks_for_tokens(self.max_len,
                                                     self.block_size)
        self.num_blocks = (slots * self.max_blocks_per_slot + 1
                           if num_blocks is None else int(num_blocks))
        self._cache_dtype = cache_dtype
        self.params = compute_params(params, cfg, self.device)
        self._prefill = make_paged_prefill(cfg, self.block_size,
                                           kv_dtype=self.kv_dtype)
        self._decode = make_paged_decode_step(
            cfg, self.block_size, kv_dtype=self.kv_dtype,
            paged_attention=paged_attention)
        self._slots: List[Optional[_Slot]] = [None] * slots
        self._reset_cache()
        self._admission = AdmissionController(
            capacity_rows=queue_capacity,
            default_timeout_ms=default_timeout_ms, unit="requests")
        self._admission.on_shed = self._count_shed
        self._admission.on_close_reject = self._count_close_reject
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._loop, name=f"generation-scheduler[{self.name}]",
            daemon=True)
        self._thread.start()

    # ------------------------------------------------------------ lifecycle
    def __enter__(self) -> "GenerationEngine":
        return self

    def __exit__(self, *exc):
        self.shutdown()

    def shutdown(self, wait: bool = True):
        """Idempotent: stop the scheduler; queued and in-flight requests
        are rejected ('shutdown') — partial streams keep what they have in
        :meth:`GenerationHandle.tokens_so_far`."""
        self._stop.set()
        self._admission.close()
        if wait and self._thread.is_alive():
            self._thread.join(timeout=30.0)

    # --------------------------------------------------------------- submit
    def submit(self, prompt, *, max_new_tokens: int = 16,
               temperature: float = 0.0, top_k: int = 0,
               eos_id: Any = _UNSET, seed: int = 0,
               timeout_ms: Optional[float] = None,
               on_token: Optional[Callable[[int], None]] = None
               ) -> GenerationHandle:
        """Queue one prompt. Greedy by default; ``temperature`` > 0
        samples, ``top_k`` > 0 restricts sampling to the k most likely
        tokens, ``seed`` fixes the stream's PRNG key (a fixed seed gives a
        reproducible stream whatever its neighbours). ``eos_id`` defaults
        to the engine's; ``eos_id=None`` disables EOS retirement.
        ``timeout_ms`` bounds queue time."""
        toks = np.ascontiguousarray(np.asarray(prompt, np.int32).ravel())
        if toks.size == 0:
            raise ValueError("prompt must contain at least one token")
        if max_new_tokens <= 0:
            raise ValueError("max_new_tokens must be positive")
        total = toks.size + max_new_tokens
        if total > self.max_len:
            raise ValueError(
                f"prompt ({toks.size}) + max_new_tokens ({max_new_tokens}) "
                f"exceeds the cache capacity max_len={self.max_len}")
        if toks.size > self.buckets[-1]:
            raise ValueError(
                f"prompt ({toks.size}) exceeds the top prefill bucket "
                f"{self.buckets[-1]} — extend `buckets` up to max_len")
        greq = GenerationRequest(
            prompt=toks, max_new_tokens=max_new_tokens,
            temperature=float(temperature), top_k=int(top_k),
            eos_id=self.eos_id if eos_id is _UNSET else eos_id,
            key=prng_key(seed))
        req = Request(x=greq, rows=1)
        greq.handle = GenerationHandle(req, toks.size, on_token=on_token)
        self.metrics.requests_total.inc()
        # structural shed: a reservation the pool can never satisfy fails
        # typed now, not after a queue wait that cannot end another way
        needed = self._blocks_needed(int(toks.size), max_new_tokens)
        capacity = self._allocator.capacity
        if needed > capacity:
            e = KVBlocksExhaustedError(
                f"request needs {needed} KV blocks but the pool can free "
                f"at most {capacity} (block_size={self.block_size}) — "
                "shrink the request or grow num_blocks",
                needed=needed, usable=capacity, capacity=capacity)
            self.metrics.record_rejection(e.reason)
            raise e
        try:
            self._admission.admit(req, timeout_ms=timeout_ms)
        except RejectedError as e:
            self.metrics.record_rejection(e.reason)
            raise
        self.metrics.queue_depth.set(self._admission.depth_requests)
        return greq.handle

    def generate(self, prompt, timeout: Optional[float] = None,
                 **kwargs) -> List[int]:
        """Blocking submit: the full generated-token list."""
        return self.submit(prompt, **kwargs).result(timeout=timeout)

    # ------------------------------------------------------------ scheduler
    def _live_count(self) -> int:
        return sum(s is not None for s in self._slots)

    def _reset_cache(self):
        """(Re)allocate the block pool, allocator and block tables as one
        consistent empty state — at construction and after a failed
        prefill or decode step, whose partial writes may have left the
        pool inconsistent."""
        self._cache = init_kv_cache(
            self.cfg, self.slots, self.max_len, dtype=self._cache_dtype,
            block_size=self.block_size, num_blocks=self.num_blocks,
            kv_dtype=self.kv_dtype, device=self.device)
        self._allocator = BlockAllocator(self.num_blocks, reserved=1)
        self._tables = np.zeros((self.slots, self.max_blocks_per_slot),
                                np.int32)
        self.metrics.kv_blocks_total.set(self._allocator.capacity)
        self.metrics.kv_blocks_in_use.set(0)

    @property
    def kv_block_bytes(self) -> int:
        """Device bytes of one KV block across all layers (int8 pools count
        their 1-byte values plus fp32 scales)."""
        dt = self._cache_dtype if self._cache_dtype is not None \
            else self.cfg.dtype
        return self.block_size * kv_bytes_per_token(
            self.cfg.layers, self.cfg.heads, self.cfg.head_dim,
            self.kv_dtype, torch.empty((), dtype=dt).element_size())

    def _loop(self):
        try:
            while not self._stop.is_set():
                self._admit()
                if self._live_count() and not self._stop.is_set():
                    try:
                        self._decode_iteration()
                    except Exception as e:   # fail tenants, keep the thread
                        self._on_device_failure(e)
        finally:
            if self._stop.is_set():
                self._fail_live(RejectedError(
                    "engine shut down mid-generation", "shutdown"))

    def _on_device_failure(self, exc: BaseException):
        """A failed prefill/decode may have written part of its K/V: fail
        every live tenant and rebuild the pool."""
        self.metrics.failed_total.inc()
        self._fail_live(exc)
        self._reset_cache()

    def _admit(self):
        """Fill free slots from the queue. Waits briefly only when the
        engine is idle; with live tenants admission is opportunistic so
        decode cadence never stalls on an empty queue. A head whose blocks
        are not free yet goes back to the queue head (FIFO preserved)."""
        self._admission.expire_queued()
        for i in range(self.slots):
            if self._stop.is_set():
                return
            if self._slots[i] is not None:
                continue
            idle = self._live_count() == 0
            req = self._admission.take(1, timeout=0.05 if idle else 0.0)
            self.metrics.queue_depth.set(self._admission.depth_requests)
            if req is None:
                if idle:
                    return
                continue
            greq: GenerationRequest = req.x
            if self._blocks_needed(int(greq.prompt.size),
                                   greq.max_new_tokens) \
                    > self._allocator.free_count:
                self._admission.requeue_head(req)
                return
            if not req.future.set_running_or_notify_cancel():
                continue     # caller cancelled while queued
            self.metrics.queue_wait_ms.observe(
                (time.perf_counter() - req.submit_t) * 1e3)
            try:
                self._prefill_into(i, req)
            except Exception as e:
                if greq.handle._fail(e):
                    self.metrics.record_rejection("model_error")
                self._on_device_failure(e)

    def _blocks_needed(self, n_prompt: int, max_new: int) -> int:
        """THE block-demand formula: a stream's whole worst-case footprint,
        taken at seating — shared by the submit-time gate and the seat."""
        return blocks_for_tokens(n_prompt + max_new, self.block_size)

    def _bucket_for(self, n: int) -> int:
        for b in self.buckets:
            if b >= n:
                return b
        return self.buckets[-1]

    def _prefill_into(self, slot: int, req: Request):
        greq: GenerationRequest = req.x
        n = int(greq.prompt.size)
        bucket = self._bucket_for(n)
        padded = np.zeros((1, bucket), np.int32)
        padded[0, :n] = greq.prompt
        nb_total = self._blocks_needed(n, greq.max_new_tokens)
        alloc = self._allocator
        blocks = alloc.alloc(nb_total)
        row = np.zeros(self.max_blocks_per_slot, np.int32)
        row[:nb_total] = blocks
        t0 = time.perf_counter()
        try:
            _, tok = self._prefill(
                self.params, self._cache, padded,
                row[:blocks_for_tokens(bucket, self.block_size)], n,
                greq.key, greq.temperature, greq.top_k, 0)
            tok = int(tok)
        except Exception:
            alloc.free(blocks)
            raise
        now = time.perf_counter()
        self.metrics.prefill_ms.observe((now - t0) * 1e3)
        self.metrics.ttft_ms.observe((now - req.submit_t) * 1e3)
        self.metrics.prefills_total.inc()
        self.metrics.generated_tokens_total.inc()
        state = _Slot(greq=greq, request=req, n_generated=1, last_token=tok,
                      length=n, blocks=blocks)
        if greq.handle._push(tok) is not None:
            # a broken on_token consumer failed its own stream at token 0
            self.metrics.record_rejection("client_error")
            self._release_blocks(state)
        elif self._maybe_retire(state, tok):
            self._release_blocks(state)   # retired at token 0
        else:
            self._tables[slot] = row
            self._slots[slot] = state
        self.metrics.kv_blocks_in_use.set(self._allocator.in_use)

    def _decode_iteration(self):
        """One scheduler turn: a single decode step over ALL slots (dead
        slots ride along on the scratch block), then stream/retire per
        live slot."""
        S = self.slots
        tokens = np.zeros(S, np.int64)
        keys = np.zeros((S, 2), np.uint32)
        steps = np.zeros(S, np.int64)
        temps = np.zeros(S, np.float32)
        top_ks = np.zeros(S, np.int64)
        lengths = np.zeros(S, np.int64)
        no_cow = np.zeros(S, np.int64)
        states = list(self._slots)
        n_live = 0
        for i, st in enumerate(states):
            if st is None:
                continue
            n_live += 1
            tokens[i] = st.last_token
            keys[i] = st.greq.key
            steps[i] = st.n_generated
            temps[i] = st.greq.temperature
            top_ks[i] = st.greq.top_k
            lengths[i] = st.length
        self.metrics.slot_occupancy.set(n_live / S)
        t0 = time.perf_counter()
        _, toks = self._decode(self.params, self._cache, self._tables,
                               lengths, tokens, keys, steps, temps, top_ks,
                               no_cow, no_cow)
        toks = toks.cpu().numpy()
        dt_ms = (time.perf_counter() - t0) * 1e3
        self.metrics.decode_step_ms.observe(dt_ms)
        self.metrics.decode_wall_ms.inc(dt_ms)
        self.metrics.decode_steps_total.inc()
        for i, st in enumerate(states):
            if st is not None:
                self._commit_sampled(i, st, int(toks[i]))
        self.metrics.generated_tokens_total.inc(n_live)
        self.metrics.slot_occupancy.set(self._live_count() / S)
        self.metrics.kv_blocks_in_use.set(self._allocator.in_use)

    def _commit_sampled(self, i: int, st: _Slot, tok: int):
        """Commit one sampled token to slot ``i``: advance the stream,
        retire it on EOS/budget (freeing its slot for the next
        admission), deliver the token."""
        st.length += 1
        st.n_generated += 1
        st.last_token = tok
        reason = self._retire_reason(st, tok)
        if reason is not None:
            self._clear_slot(i, st)
        if st.greq.handle._push(tok) is not None:
            # a broken on_token consumer: its handle holds the terminal
            if reason is None:
                self._clear_slot(i, st)
            self.metrics.record_rejection("client_error")
            return
        if reason is not None:
            self._finish_stream(st, reason)

    def _retire_reason(self, st: _Slot, tok: int) -> Optional[str]:
        if st.greq.eos_id is not None and tok == st.greq.eos_id:
            return "eos"
        if st.n_generated >= st.greq.max_new_tokens:
            return "max_tokens"
        return None

    def _finish_stream(self, st: _Slot, reason: str):
        st.greq.handle._finish(reason)
        self.metrics.generations_completed.inc()
        self.metrics.latency_ms.observe(
            (time.perf_counter() - st.request.submit_t) * 1e3)

    def _maybe_retire(self, st: _Slot, tok: int) -> bool:
        reason = self._retire_reason(st, tok)
        if reason is None:
            return False
        self._finish_stream(st, reason)
        return True

    def _release_blocks(self, st: _Slot):
        """Return a stream's blocks to the free list (idempotent)."""
        if st.blocks is None:
            return
        blocks, st.blocks = st.blocks, None
        self._allocator.free(blocks)

    def _clear_slot(self, i: int, st: _Slot):
        """Vacate slot ``i`` and point its block-table row back at the
        scratch block: a dead slot still takes part in every decode step
        and writes where its row says, so a stale row would aim that write
        at blocks the next admission may hand to a new stream."""
        self._slots[i] = None
        self._tables[i] = 0
        self._release_blocks(st)

    def _fail_live(self, exc: BaseException):
        """Fail every live tenant and vacate its slot."""
        victims = []
        for i, st in enumerate(self._slots):
            if st is not None:
                self._clear_slot(i, st)
                victims.append(st)
        for st in victims:
            if st.greq.handle._fail(exc):
                self.metrics.record_rejection(
                    getattr(exc, "reason", "model_error"))

    def _count_shed(self, req: Request):
        self.metrics.record_rejection("deadline")

    def _count_close_reject(self, req: Request):
        self.metrics.record_rejection("shutdown")

    # -------------------------------------------------------------- insight
    @property
    def live_slots(self) -> int:
        return self._live_count()

    def warmup(self) -> "GenerationEngine":
        """Run one short throwaway stream per prefill bucket (token-0
        prompts, the shortest length that maps to each rung) so the first
        live request does not pay one-time set-up: the kernels' build and
        load, the allocator's and libraries' first use."""
        prev = 0
        for b in self.buckets:
            n, prev = prev + 1, b
            new = min(2, self.max_len - n)
            if new < 1:
                continue   # rung admits no prompt at all (n == max_len)
            # eos_id=None: an engine eos_id matching the continuation would
            # retire every probe at prefill and skip the decode step
            self.generate(np.zeros(n, np.int32), max_new_tokens=new,
                          eos_id=None, timeout=300.0)
        return self
