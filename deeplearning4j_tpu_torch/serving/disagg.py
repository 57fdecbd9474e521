"""Disaggregated prefill/decode serving with cross-host KV page migration
(counterpart: ``deeplearning4j_tpu/serving/disagg.py``; DistServe OSDI'24
and Splitwise ISCA'24 placement, SGLang RadixAttention's fleet-wide
prefix routing).

Prefill is compute-bound (one batched pass over the prompt), decode is
memory-bound (one token a step against a growing KV cache), so on one
host each phase is the other's noisy neighbour: a long prompt's prefill
stalls every resident stream's inter-token latency. Disaggregation gives
each phase its own hosts:

1. the front door routes the PROMPT to a prefill-class host, which runs
   the prefill (and the first sampled token) with ``capture_pages=True``:
   the engine's retire tail copies the stream's written KV blocks (values
   and int8 scales, lengths, stream state) to host memory as a
   :class:`~deeplearning4j_tpu_torch.serving.paging.SwapEntry`;
2. the pages MIGRATE to a decode-class host: an in-process hand-off
   between loopback hosts, the ``kv.migrate`` RPC endpoint
   (``/rpc/v1/migrate``, serving/rpc.py) between real hosts;
3. the decode host parks them (:meth:`GenerationEngine.import_pages`),
   seats them through the swap-in path (``submit(swap_key=...)``) and
   resumes from the first token's watermark with NO re-prefill. The
   pages move byte for byte and sampled draws are keyed by position, so
   the stream is the single-host stream token for token.

Every failure along the way DEGRADES, never sheds: a fired ``kv.migrate``
/ ``kv.migrate.export`` / ``kv.migrate.import`` fault falls back to a
recompute on the decode host (the same seed; in fp32 the same tokens,
while a bf16 recompute prefill may round K/V unlike the decode steps),
and ``migrate_failed`` is not a terminal reason: the request ends with
whatever the recomputed stream earns. Capacity sheds stay legitimate: a
fleet with no decode headroom sheds typed ``cluster_capacity``.

The same machinery routes by cache: each host's heartbeat advertises its
prefix cache's leading tokens (``HostStatus.prefix_tokens``),
:class:`FleetPrefixIndex` folds them into one radix tree, and the
decode-stage route prefers the host already holding the prompt's longest
prefix.

``ClusterFrontDoor(disagg=None)`` (the default) never touches this
module, and a configured policy engages only while the fleet advertises
prefill- AND decode-class hosts (``LoopbackHost(host_class=...)``; every
host defaults to ``"mixed"``).
"""
from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional, Sequence, Set, Tuple

import numpy as np

from deeplearning4j_tpu_torch.serving.admission import RejectedError
from deeplearning4j_tpu_torch.serving.faults import inject
from deeplearning4j_tpu_torch.serving.generation import client_stream_handle
from deeplearning4j_tpu_torch.serving.paging import RadixPrefixIndex, SwapEntry
from deeplearning4j_tpu_torch.serving.rpc import (
    KvMigrateResponse, _decode_pages, _encode_pages,
)


class FleetPrefixIndex:
    """Fleet-wide longest-prefix index over every host's advertised
    prefix-cache contents — one :class:`RadixPrefixIndex` whose values
    are host ids. :meth:`refresh` folds in each host's latest heartbeat
    (re-indexing only hosts whose ``seq`` moved, so a steady fleet costs
    one dict probe per host), :meth:`best_hosts` answers "who already
    holds this prompt's longest prefix" in one tree walk."""

    def __init__(self):
        self._index = RadixPrefixIndex()
        # hid -> (heartbeat seq at last index, the paths indexed then)
        self._hosts: Dict[int, Tuple[int, Tuple[Tuple[int, ...], ...]]] = {}
        self._lock = threading.Lock()

    def refresh(self, directory) -> None:
        """Fold the directory's current heartbeat view into the index.
        Hosts whose heartbeat ``seq`` is unchanged are skipped; hosts
        that left the directory are dropped."""
        with self._lock:
            live = set()
            for hid in directory.host_ids():
                live.add(hid)
                st = directory.status(hid)
                if st is None:
                    continue
                cur = self._hosts.get(hid)
                if cur is not None and cur[0] == st.seq:
                    continue
                if cur is not None:
                    for p in cur[1]:
                        self._index.remove(p, hid)
                paths = tuple(tuple(int(t) for t in p)
                              for p in st.prefix_tokens if len(p))
                for p in paths:
                    self._index.insert(p, hid)
                self._hosts[hid] = (st.seq, paths)
            for hid in set(self._hosts) - live:
                for p in self._hosts[hid][1]:
                    self._index.remove(p, hid)
                del self._hosts[hid]

    def best_hosts(self, tokens: Sequence[int]) -> Tuple[int, Set[int]]:
        """``(depth, host_ids)``: the longest advertised prefix of
        ``tokens`` anywhere in the fleet and every host achieving it,
        or ``(0, set())``."""
        with self._lock:
            return self._index.match(tuple(int(t) for t in tokens))

    def node_count(self) -> int:
        with self._lock:
            return self._index.node_count()


class DisaggPolicy:
    """Two-stage prefill→migrate→decode placement for the cluster front
    door. Plug in via ``ClusterFrontDoor(disagg=DisaggPolicy())``; the
    policy engages per request only when :meth:`enabled` sees both a
    prefill-class and a decode-class host alive and non-draining —
    otherwise (and for pinned / prefix-affine streams, whose blocks
    cannot migrate) the front door's single-host path runs untouched.

    The class contract the routing tests assert: a prefill-class host
    NEVER holds a decode-phase stream. Stage A routes among non-decode
    hosts; stage B — including every degrade-to-recompute fallback —
    routes among non-prefill hosts.
    """

    #: stage-A wait slack past the request deadline, mirroring the RPC
    #: server's result-wait slack (the host's own deadline machinery is
    #: authoritative; this only bounds a hung local future)
    WAIT_SLACK_S = 30.0
    DEFAULT_WAIT_S = 600.0

    def __init__(self, prefix_index: Optional[FleetPrefixIndex] = None):
        self.prefix_index = prefix_index if prefix_index is not None \
            else FleetPrefixIndex()

    # ------------------------------------------------------------ gating
    def enabled(self, directory) -> bool:
        """True iff the fleet has ≥1 alive, non-draining prefill-class
        host AND ≥1 decode-class host — a mixed-only fleet (every
        pre-upgrade fleet) keeps the policy fully inert."""
        have_p = have_d = False
        for hid in directory.host_ids():
            st = directory.status(hid)
            if (st is None or st.draining or directory.is_draining(hid)
                    or not directory.alive(hid)):
                continue
            if st.host_class == "prefill":
                have_p = True
            elif st.host_class == "decode":
                have_d = True
            if have_p and have_d:
                return True
        return False

    def _class_ids(self, directory) -> Tuple[Tuple[int, ...],
                                             Tuple[int, ...]]:
        """(prefill-class ids, decode-class ids) in the current view —
        the exclusion sets the two route stages hand to ``_route``."""
        prefill: List[int] = []
        decode: List[int] = []
        for hid in directory.host_ids():
            st = directory.status(hid)
            if st is None:
                continue
            if st.host_class == "prefill":
                prefill.append(hid)
            elif st.host_class == "decode":
                decode.append(hid)
        return tuple(prefill), tuple(decode)

    @staticmethod
    def _sampling_kwargs(kwargs: dict) -> dict:
        """The subset of submit kwargs the wire migrate surface carries
        (the loopback path forwards ``kwargs`` whole)."""
        kw = {k: kwargs[k] for k in ("temperature", "top_k", "seed")
              if k in kwargs}
        if "eos_id" in kwargs:
            kw["eos_id"] = kwargs["eos_id"]
        return kw

    # ------------------------------------------------------------ submit
    def submit(self, fd, prompt, *, max_new_tokens: int = 16,
               tenant: Optional[str] = None,
               priority: Optional[str] = None, **kwargs):
        """Place one generation stream across the disaggregated fleet;
        returns a client-side GenerationHandle streaming the SAME tokens
        a single-host run would produce. Called by
        ``ClusterFrontDoor.submit_generate`` — does its own request/
        trace/terminal accounting because the request spans two routed
        submits."""
        toks = np.asarray(prompt, np.int32).ravel()
        n = int(toks.size)
        label = fd._label(tenant, priority)
        on_token = kwargs.pop("on_token", None)
        timeout_ms = kwargs.pop("timeout_ms", None)
        deadline_t = (time.monotonic() + timeout_ms / 1e3
                      if timeout_ms is not None else None)

        def budget() -> Optional[float]:
            if deadline_t is None:
                return None
            return max(0.0, (deadline_t - time.monotonic()) * 1e3)

        fd.metrics.requests_total.inc()
        trace = fd._tracer.begin(fd.name, "cluster.generate",
                                 prompt_len=n, tenant=label)
        t0 = time.perf_counter()
        client = client_stream_handle(n, on_token=on_token, tenant=label)
        prefill_ids, decode_ids = self._class_ids(fd.directory)

        # ---------------- stage A: prefill on a non-decode host --------
        first, finish_a, entry, block_size_a = self._stage_prefill(
            fd, trace, toks, max_new_tokens, budget, tenant, priority,
            decode_ids, kwargs)

        if first is not None and (max_new_tokens <= 1
                                  or finish_a == "eos"):
            # the whole stream fit in the prefill step (one-token budget
            # or the prompt's first sample hit EOS): no decode phase
            # exists, nothing migrates
            client._push(int(first))
            client._finish(finish_a or "max_tokens")
            fd._finish_request(trace, "ok",
                               (time.perf_counter() - t0) * 1e3, label)
            return client

        if first is not None and entry is None:
            # prefill ran but no pages shipped (export fault, or a
            # non-paged prefill engine): the decode host resumes from
            # the watermark by recompute — degraded, never shed
            trace.event("cluster.migrate.fallback", stage="export")
            fd.metrics.kv_migrate_fallbacks_total.inc()

        # ---------------- stage B: decode on a non-prefill host --------
        hid_b = self._stage_decode(fd, trace, client, toks, first, entry,
                                   block_size_a, max_new_tokens, budget,
                                   tenant, priority, label, prefill_ids,
                                   kwargs)
        fd._watch_future(client.future, trace, t0, label, "generate",
                         hid_b, 1)
        return client

    # ------------------------------------------------------------ stage A
    def _stage_prefill(self, fd, trace, toks, max_new_tokens,
                       deadline_budget, tenant, priority, decode_ids,
                       kwargs):
        """Run prefill + page capture on a non-decode host. Returns
        ``(first_token, finish_reason, entry, block_size)`` — any of
        them degraded to None means stage B recomputes; this stage
        NEVER sheds (its typed rejections all fold into the fallback)."""
        n = int(toks.size)
        try:
            ha, hid_a, how_a = fd._route(
                "generate", rows=1,
                blocks_needed=fd._blocks_needed(n, 1, None),
                blocks_admit=fd._blocks_needed(n, 1, None),
                exclude=tuple(decode_ids))
        except RejectedError as e:
            trace.event("cluster.migrate.fallback", stage="route",
                        reason=e.reason)
            fd.metrics.kv_migrate_fallbacks_total.inc()
            return None, None, None, 0
        trace.event("cluster.route", host=hid_a, decision=how_a,
                    kind="generate", stage="prefill")
        fd.routed_by_host.inc(f"h{hid_a}")
        # wire-v3 trace context: the prefill leg is a labeled child of
        # the front-door root (NULL_TRACE → no kwargs, bitwise-inert)
        tkw = {} if trace.trace_id is None else {
            "trace_link": trace.trace_id,
            "trace_parent": "migrate:prefill"}
        try:
            if hasattr(ha, "migrate_prefill"):
                # RPC host: one round-trip runs prefill + capture and
                # ships the pages back (the kv.migrate fault point
                # wraps the hop client-side)
                pf = ha.migrate_prefill(
                    toks, max_new_tokens=max_new_tokens,
                    timeout_ms=deadline_budget(), tenant=tenant,
                    priority=priority, **tkw,
                    **self._sampling_kwargs(kwargs))
                entry = None
                if pf.mode == "captured" and pf.pages is not None:
                    entry = SwapEntry(
                        payload=_decode_pages(pf.pages),
                        used_blocks=int(pf.used_blocks),
                        length=int(pf.length),
                        n_generated=int(pf.n_generated),
                        last_token=int(pf.last_token),
                        prefix_len=0, nbytes=int(pf.nbytes))
                return (int(pf.first_token), pf.finish_reason, entry,
                        int(pf.block_size))
            # loopback host: capture in-process; the kv.migrate fault
            # point wraps the hand-off so a seeded wire fault fires on
            # single-process fleets too
            h1 = ha.submit_generate(
                toks, max_new_tokens=1, capture_pages=True,
                timeout_ms=deadline_budget(), tenant=tenant,
                priority=priority, **tkw, **kwargs)
            b = deadline_budget()
            wait_s = self.DEFAULT_WAIT_S if b is None \
                else b / 1e3 + self.WAIT_SLACK_S
            out = h1.result(timeout=wait_s)
            if not len(out):
                raise RuntimeError("prefill produced no token")
            gen = getattr(ha, "generation", None)
            entry = None
            if gen is not None:
                entry = inject("kv.migrate", gen.take_captured_pages, h1)
            return (int(out[0]), h1.finish_reason, entry,
                    int(getattr(gen, "block_size", 0) or 0))
        except Exception as e:
            # DEGRADE, never shed: any stage-A failure — typed
            # rejection, injected kv.migrate fault, wire loss — means
            # the decode host runs the stream from scratch (same seed,
            # same tokens)
            trace.event("cluster.migrate.fallback", stage="prefill",
                        host=hid_a,
                        reason=getattr(e, "reason", type(e).__name__))
            fd.metrics.kv_migrate_fallbacks_total.inc()
            return None, None, None, 0

    # ------------------------------------------------------------ stage B
    def _stage_decode(self, fd, trace, client, toks, first, entry,
                      block_size_a, max_new_tokens, deadline_budget,
                      tenant, priority, label, prefill_ids, kwargs):
        """Seat the stream on a non-prefill host — migrated pages when
        stage A shipped them, resume-recompute when only the first
        token survived, full recompute when nothing did. Bounces retry
        the remaining candidates; an exhausted route sheds typed (the
        only legitimate shed: capacity, not migration failure)."""
        n = int(toks.size)
        have_first = first is not None
        # the conservative re-prefill bound counts the resume token as
        # prompt; the post-migration bound is what a seated stream
        # actually grows to (the first token rides inside max_new) —
        # _route judges a migration-capable host on the smaller
        needed = fd._blocks_needed(n + (1 if have_first else 0),
                                   max_new_tokens, None)
        migrate = fd._blocks_needed(n, max_new_tokens, None) \
            if entry is not None else None
        admit = fd._blocks_needed(n + (1 if have_first else 0), 1, None)

        # cache-aware preference: the decode-capable host already
        # holding the prompt's longest advertised prefix goes first
        self.prefix_index.refresh(fd.directory)
        depth, cache_hosts = self.prefix_index.best_hosts(toks)
        preferred: Optional[int] = None
        if depth > 0:
            eligible = sorted(h for h in cache_hosts
                              if h not in prefill_ids)
            if eligible:
                preferred = eligible[0]

        if first is not None:
            # deliver the watermark before the decode host can race its
            # own pushes into the client handle
            client._push(int(first))

        tried: List[int] = []
        bounced_full = 0
        last_reject: Optional[RejectedError] = None
        while True:
            hb = hid_b = how_b = None
            if preferred is not None and preferred not in tried:
                try:
                    hb, hid_b, how_b = fd._route(
                        "generate", rows=1, blocks_needed=needed,
                        blocks_admit=admit, blocks_migrate=migrate,
                        pinned=preferred, bounced_full=bounced_full)
                    how_b = "prefix"
                    fd.metrics.prefix_route_hits_total.inc()
                    trace.event("cluster.prefix_route", host=hid_b,
                                depth=int(depth))
                except RejectedError:
                    preferred = None   # fall through to the open route
            if hb is None:
                try:
                    hb, hid_b, how_b = fd._route(
                        "generate", rows=1, blocks_needed=needed,
                        blocks_admit=admit, blocks_migrate=migrate,
                        exclude=tuple(tried) + tuple(prefill_ids),
                        bounced_full=bounced_full)
                except RejectedError as e:
                    if last_reject is not None:
                        e.__cause__ = last_reject
                    fd._shed(trace, e, label)
                    client._fail(e)
                    raise
            trace.event("cluster.route", host=hid_b, decision=how_b,
                        kind="generate", stage="decode",
                        migrated=entry is not None)
            try:
                self._dispatch_decode(fd, trace, client, hb, hid_b, toks,
                                      first, entry, block_size_a,
                                      max_new_tokens, deadline_budget,
                                      tenant, priority, kwargs)
            except RejectedError as e:
                tried.append(hid_b)
                preferred = None
                if e.reason in fd.CAPACITY_BOUNCE_REASONS:
                    bounced_full += 1
                last_reject = e
                trace.event("cluster.bounce", host=hid_b, reason=e.reason)
                continue
            fd.routed_by_host.inc(f"h{hid_b}")
            fd._out_add("generate", hid_b, 1)
            return hid_b

    def _dispatch_decode(self, fd, trace, client, hb, hid_b, toks, first,
                         entry, block_size_a, max_new_tokens,
                         deadline_budget, tenant, priority, kwargs):
        """One decode-host admission attempt. Raises the host's typed
        RejectedError (the caller bounce-retries); any OTHER migration
        trouble degrades to recompute on this same host."""

        def relay(tok):
            err = client._push(int(tok))
            if err is not None:
                # a broken consumer callback fails the stream on the
                # serving host too (client_error), same as single-host
                raise err

        kw = dict(kwargs)
        kw.pop("capture_pages", None)
        gen_b = getattr(hb, "generation", None)
        # wire-v3 trace context: the context crosses BOTH migration
        # stages — the decode leg links to the same front-door root as
        # the prefill leg, never dropped between the two hops
        tkw = {} if trace.trace_id is None else {
            "trace_link": trace.trace_id,
            "trace_parent": "migrate:decode"}

        if hasattr(hb, "submit_migrated") and first is not None:
            # RPC decode host: ship pages (when captured) or just the
            # watermark; the server seats via import_pages and resumes.
            # handle=client → the bridge delivers post-watermark tokens
            # and the terminal straight into the client handle.
            pf = KvMigrateResponse(
                ok=True,
                mode="captured" if entry is not None else "recompute",
                first_token=int(first),
                pages=(_encode_pages(entry.payload)
                       if entry is not None else None),
                used_blocks=entry.used_blocks if entry else 0,
                length=entry.length if entry else 0,
                n_generated=entry.n_generated if entry else 0,
                last_token=entry.last_token if entry else 0,
                nbytes=entry.nbytes if entry else 0,
                block_size=int(block_size_a))
            _, mode = hb.submit_migrated(
                toks, pf, max_new_tokens=max_new_tokens,
                timeout_ms=deadline_budget(), tenant=tenant,
                priority=priority, handle=client, **tkw,
                **self._sampling_kwargs(kwargs))
            if mode == "migrated":
                fd.metrics.kv_migrations_total.inc()
                trace.event("cluster.migrate", host=hid_b,
                            nbytes=entry.nbytes if entry else 0)
            elif entry is not None:
                fd.metrics.kv_migrate_fallbacks_total.inc()
                trace.event("cluster.migrate.fallback", stage="import",
                            host=hid_b)
            return

        key = None
        if (entry is not None and gen_b is not None
                and getattr(gen_b, "paged", False)
                and block_size_a
                and block_size_a == getattr(gen_b, "block_size", 0)):
            try:
                key = gen_b.import_pages(entry)
            except Exception:
                key = None   # import fault (seeded or real) → recompute
        if entry is not None and key is None:
            fd.metrics.kv_migrate_fallbacks_total.inc()
            trace.event("cluster.migrate.fallback", stage="import",
                        host=hid_b)
        if key is not None:
            kw["swap_key"] = key
        if first is not None:
            kw["resume_tokens"] = np.asarray([int(first)], np.int32)
            kw["resume_step"] = 1
        try:
            h2 = hb.submit_generate(
                toks, max_new_tokens=max_new_tokens,
                timeout_ms=deadline_budget(), tenant=tenant,
                priority=priority, on_token=relay, **tkw, **kw)
        except RejectedError:
            if key is not None and gen_b is not None:
                # the one-shot key will never be taken — reclaim the
                # parked bytes before bouncing to the next candidate
                gen_b.discard_imported(key)
            raise
        if key is not None:
            fd.metrics.kv_migrations_total.inc()
            trace.event("cluster.migrate", host=hid_b,
                        nbytes=entry.nbytes)

        def done(f):
            try:
                exc = f.exception()
            except BaseException as e:   # cancelled
                exc = e
            if exc is not None:
                client._fail(exc)
            else:
                client._finish(h2.finish_reason or "max_tokens")
        h2.future.add_done_callback(done)


__all__ = ["DisaggPolicy", "FleetPrefixIndex"]
