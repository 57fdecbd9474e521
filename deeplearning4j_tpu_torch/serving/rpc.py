"""Fault-tolerant RPC data plane (counterpart: ``deeplearning4j_tpu/
serving/rpc.py``): the cross-host request path behind
:class:`~deeplearning4j_tpu_torch.serving.cluster.HostHandle`, over the
standard library's HTTP server and client. The tail-tolerance recipe is
Dean & Barroso's "The Tail at Scale" with Google SRE's load shedding:

- **wire schema** — :class:`RpcRequest` / :class:`RpcResponse` /
  :class:`RpcStreamChunk` are versioned dataclasses beside
  ``HostStatus``'s heartbeat schema: a ``wire_version`` field, full-field
  ``to_dict`` (``dataclasses.asdict``), known-field-filtered
  ``from_dict``, so peers of different versions keep talking during a
  rolling upgrade. The fields and versions are the reference's: either
  package's client talks to the other's server.
- **deadline propagation** — every hop carries the REMAINING budget: the
  client recomputes ``deadline_t - now`` at each send (so hedged
  re-dispatches ship a smaller budget than the first attempt), and the
  server sheds typed ``deadline`` on arrival when the budget is already
  spent, before a slot or queue entry is consumed.
- **streamed token delivery** — a generation stream admitted on a
  remote host long-polls home in :class:`RpcStreamChunk` batches
  (``/rpc/v1/stream`` blocks up to ``wait_ms`` for new tokens) and is
  bridged into a local :class:`~deeplearning4j_tpu_torch.serving.
  generation.GenerationHandle` (``generation.client_stream_handle``), so
  ``result()``/``stream()``/``on_token`` behave the same either side of
  the wire. The front door's hedging supervisor
  (``cluster.ClusterFrontDoor``) drives the same chunk protocol across
  attempts for terminal-exactly-once re-dispatch.
- **typed fleet sheds** — a host's own rejection crosses the wire as its
  taxonomy reason and is re-raised typed on the client
  (:func:`rejected_from_wire`); network loss raises ``host_unavailable``
  and malformed payloads ``rpc_error``, both chained to the cause.
- **deterministic chaos** — the client wraps its network calls in the
  fault points ``rpc.dispatch`` (submit POST), ``rpc.stream`` (chunk
  long-poll) and ``rpc.response`` (payload decode), so a seeded
  ``FaultPlan`` drops, delays or malforms RPC traffic reproducibly.
- **graceful drain** — ``POST /rpc/v1/drain`` runs the host-leave
  protocol (stop admission, finish resident streams, release prefix
  pins) so a fleet scales down without shedding a request.

- **KV page migration** — ``POST /rpc/v1/migrate`` (:class:`KvMigrateRequest`
  / :class:`KvMigrateResponse`) runs a prompt's prefill with page capture
  on a prefill-class host and seats the shipped pages on a decode-class
  host (serving/disagg.py drives both stages; the ``kv.migrate`` fault
  point wraps the round trip). Pages cross as base64 of each leaf's raw
  bytes, encoded from torch (no ``ml_dtypes``): a bf16 pool's pages are
  ``"bfloat16"`` on the wire, as the reference writes them, and arrive
  bit for bit.
"""
from __future__ import annotations

import base64
import dataclasses
import functools
import http.client
import itertools
import json
import threading
import time
import urllib.error
import urllib.request
from concurrent.futures import Future
from concurrent.futures import wait as _futures_wait
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, List, Optional

import numpy as np
import torch

from deeplearning4j_tpu_torch.serving.admission import (
    DeadlineExceededError, HostDrainingError, HostUnavailableError,
    RejectedError, RpcError,
)
from deeplearning4j_tpu_torch.serving.cluster import HostHandle, HostStatus
from deeplearning4j_tpu_torch.serving.faults import FaultInjectedError, inject
from deeplearning4j_tpu_torch.serving.generation import client_stream_handle
from deeplearning4j_tpu_torch.serving.ledger import track_rpc_server
from deeplearning4j_tpu_torch.serving.paging import SwapEntry
from deeplearning4j_tpu_torch.serving.tracing import (
    TERMINAL_REASONS, terminal_reason,
)

#: One prefix for every data-plane endpoint — versioned in the PATH as
#: well as the payload so a load balancer can route major revisions.
RPC_PREFIX = "/rpc/v1"

_UNSET = object()   # open_stream's "use the engine default" eos sentinel


# --------------------------------------------------------------------------
# Wire schema (versioned dataclasses, like the heartbeat's HostStatus)
# --------------------------------------------------------------------------
@dataclasses.dataclass
class RpcRequest:
    """One submit crossing the wire. ``timeout_ms`` is the REMAINING
    deadline budget at send time (never an absolute clock — hosts'
    clocks are not comparable; the receiver re-anchors the budget on its
    own clock, so network transit only ever SHRINKS the deadline).
    ``hedge_attempt`` numbers re-dispatches of the same logical request
    so server logs can correlate a hedge's loser and winner.

    ``resume_tokens``/``resume_step`` (wire v2, the engine's recompute-
    on-resume crossing the RPC boundary) re-dispatch a lost stream from its
    delivery watermark: the already-delivered tokens ride along, the
    replacement host runs ONE recompute prefill, and decoding continues
    at index ``resume_step`` — zero re-decoded tokens; in fp32 the
    uninterrupted stream bit for bit, while a bf16 model's recompute
    prefill may round K/V unlike the decode steps and so continue on
    another greedy path. Both fields are DEFAULTED so a v1 receiver's
    known-field filter silently drops them and replays from token 0
    (the client's watermark dedup absorbs the duplicates — see the
    ``RpcResponse.resume_step`` echo).

    ``trace_id``/``parent_span`` (wire v3, Dapper-style cross-host trace
    context) name the front-door trace this dispatch is a child leg of
    and the labeled span that sent it ("attempt0", "hedge:timeout", ...).
    The receiving engine begins its own RequestTrace LINKED to that id,
    so the aggregator can stitch the legs into one logical stream.
    Rolling-upgrade tolerant both directions: a v2 receiver's
    known-field filter drops the fields (its trace stays a local root,
    exactly today's behavior), and a v2 SENDER's request leaves the
    defaults None so a v3 receiver mints a local root as today."""

    request_id: str = ""
    kind: str = "infer"                  # 'infer' | 'generate'
    # ---- infer payload ---------------------------------------------------
    x: Optional[list] = None             # batch-major rows, nested lists
    x_dtype: str = "float32"
    # ---- generate payload ------------------------------------------------
    prompt: Optional[list] = None        # token ids
    max_new_tokens: int = 16
    temperature: float = 0.0
    top_k: int = 0
    eos_id: Optional[int] = None
    eos_default: bool = True             # True: use the host engine's eos
    seed: int = 0
    prefix_id: Optional[str] = None
    # ---- resume-from-watermark (wire v2) ---------------------------------
    resume_tokens: Optional[list] = None  # delivered-so-far token ids
    resume_step: int = 0                  # == len(resume_tokens)
    # ---- cross-host trace context (wire v3) ------------------------------
    trace_id: Optional[str] = None       # the logical stream's root trace
    parent_span: Optional[str] = None    # label of the dispatching span
    # ---- identity + budget ----------------------------------------------
    tenant: Optional[str] = None
    priority: Optional[str] = None
    timeout_ms: Optional[float] = None   # remaining budget at send time
    hedge_attempt: int = 0
    wire_version: int = 3

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "RpcRequest":
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in known})


@dataclasses.dataclass
class RpcResponse:
    """Submit/result envelope. ``ok=False`` carries the host's own typed
    rejection (``error_reason`` from the one taxonomy) so the client
    re-raises it as if admission had run locally; ``done=False`` is the
    long-poll "nothing yet" answer for infer results.

    ``resume_step`` (wire v2) ECHOES the honored resume point of a
    generate admit: a v2 server that seated the stream at the request's
    watermark answers with it, a v1 server (whose ``from_dict`` dropped
    the resume fields) leaves the default 0 — so the client knows
    whether the attempt resumes or replays, and only pre-seeds its
    delivered prefix in the former case."""

    request_id: str = ""
    ok: bool = False
    done: bool = True
    stream_id: Optional[str] = None
    result: Optional[list] = None
    result_dtype: Optional[str] = None
    error_reason: Optional[str] = None
    error_message: Optional[str] = None
    resume_step: int = 0
    wire_version: int = 2

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "RpcResponse":
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in known})


@dataclasses.dataclass
class RpcStreamChunk:
    """One long-poll's worth of a generation stream: ``tokens`` are the
    ids past the client's ``cursor`` (cursor-addressed, so a hedged
    re-poll or a duplicate delivery is idempotent — the client only
    advances by what it has not seen). ``done`` carries the terminal:
    ``finish_reason`` on success, ``error_reason``/``error_message``
    (taxonomy-typed) on failure."""

    stream_id: str = ""
    cursor: int = 0
    tokens: List[int] = dataclasses.field(default_factory=list)
    done: bool = False
    finish_reason: Optional[str] = None
    error_reason: Optional[str] = None
    error_message: Optional[str] = None
    wire_version: int = 1

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "RpcStreamChunk":
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in known})


@dataclasses.dataclass
class KvMigrateRequest:
    """One ``kv.migrate`` call crossing the wire — the cross-host KV
    page-migration endpoint serving/disagg.py's two-stage placement
    drives. ``kind="prefill"`` asks the receiving (prefill-class) host
    to run the prompt's prefill with page capture; ``kind="import"``
    ships stage A's captured block pages (base64 arrays — cache values
    AND int8 scales per layer) to the decode host, which seats them
    through its swap store's swap-in path and continues the stream
    from the delivery watermark (``first_token``/``resume_step``).
    ``timeout_ms`` is the REMAINING deadline budget at send time, wire
    discipline identical to :class:`RpcRequest` — the budget shrinks
    across the two stages, never resets."""

    request_id: str = ""
    kind: str = "prefill"                # 'prefill' | 'import'
    prompt: Optional[list] = None        # token ids
    max_new_tokens: int = 16             # ORIGINAL total budget (the
    #                                      prefill stage runs 1 itself)
    temperature: float = 0.0
    top_k: int = 0
    eos_id: Optional[int] = None
    eos_default: bool = True
    seed: int = 0
    tenant: Optional[str] = None
    priority: Optional[str] = None
    timeout_ms: Optional[float] = None   # remaining budget at send time
    # ---- cross-host trace context (wire v2, same contract as
    # RpcRequest's v3 fields: defaulted None both directions, so the
    # context survives BOTH migration legs or degrades to local roots) --
    trace_id: Optional[str] = None
    parent_span: Optional[str] = None
    # ---- import payload (stage B) ----------------------------------------
    first_token: int = 0                 # the delivery watermark token
    resume_step: int = 1
    pages: Optional[list] = None         # per-layer {leaf: b64 array}
    used_blocks: int = 0
    length: int = 0
    n_generated: int = 0
    last_token: int = 0
    nbytes: int = 0
    block_size: int = 0                  # sender's block size (a
    #                                      mismatch degrades to recompute)
    wire_version: int = 2

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "KvMigrateRequest":
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in known})


@dataclasses.dataclass
class KvMigrateResponse:
    """``kv.migrate`` answer. ``mode`` is the honored outcome:
    ``captured`` (stage A — the pages ride back beside the first
    token), ``migrated`` (stage B — the pages seated, the stream
    resumes from them), ``recompute`` (the degrade path — the stream
    still runs, it just re-prefills on the decode host: the same tokens
    in fp32, while a bf16 recompute may round K/V unlike the decode
    steps and continue on another greedy path). Failure answers carry
    the host's typed reason exactly like :class:`RpcResponse`; a
    migration that cannot move its pages is NOT
    a failure — it is ``recompute`` (tracing.py: ``migrate_failed`` is
    deliberately not a terminal reason)."""

    request_id: str = ""
    ok: bool = False
    mode: str = "recompute"              # 'captured'|'migrated'|'recompute'
    stream_id: Optional[str] = None      # import: the /stream op id
    first_token: int = 0
    finish_reason: Optional[str] = None  # prefill: 'eos' short-circuits
    #                                      stage B entirely
    pages: Optional[list] = None
    used_blocks: int = 0
    length: int = 0
    n_generated: int = 0
    last_token: int = 0
    nbytes: int = 0
    block_size: int = 0
    error_reason: Optional[str] = None
    error_message: Optional[str] = None
    wire_version: int = 1

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "KvMigrateResponse":
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in known})


#: The leaf dtypes a page crosses the wire in, by their wire names (the
#: names numpy and ``ml_dtypes`` give them, which the reference writes).
_WIRE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
                "float16": torch.float16, "int8": torch.int8}
_WIRE_NAMES = {v: k for k, v in _WIRE_DTYPES.items()}


def _encode_pages(payload) -> list:
    """KV block pages → JSON-safe wire form: per layer, per cache leaf
    (values AND int8 scales — the quantized path's scales ride the same
    dict), a base64 blob of the leaf's raw bytes + dtype + shape, read
    from torch through a byte view, so a bf16 leaf needs no ``ml_dtypes``.
    Binary-exact by construction, and the same dict the reference encodes
    from numpy arrays of the same values. A leaf dtype outside
    ``_WIRE_DTYPES`` raises (the caller ships no pages)."""
    out = []
    for layer in payload:
        enc = {}
        for k, a in layer.items():
            t = torch.as_tensor(a).detach().to("cpu").contiguous()
            raw = t.reshape(-1).view(torch.uint8).numpy().tobytes()
            enc[k] = {"b64": base64.b64encode(raw).decode("ascii"),
                      "dtype": _WIRE_NAMES[t.dtype], "shape": list(t.shape)}
        out.append(enc)
    return out


def _decode_pages(pages: list) -> list:
    """The inverse of :func:`_encode_pages`: per layer, ``{leaf: CPU
    tensor}`` holding the shipped bytes. An unknown dtype name or a blob
    that does not fill its shape raises (the caller recomputes)."""
    out = []
    for layer in pages:
        dec = {}
        for k, d in layer.items():
            raw = bytearray(base64.b64decode(d["b64"]))
            flat = torch.frombuffer(raw, dtype=torch.uint8) if raw \
                else torch.empty(0, dtype=torch.uint8)
            dec[k] = flat.view(_WIRE_DTYPES[d["dtype"]]).reshape(
                [int(n) for n in d["shape"]])
        out.append(dec)
    return out


def rejected_from_wire(reason: Optional[str], message: Optional[str],
                       host: Optional[int] = None) -> RejectedError:
    """Rebuild a peer's typed rejection client-side, in the ONE
    taxonomy: a known reason re-raises as a ``RejectedError`` carrying
    it (so the front door's bounce/capacity classification and the SLO
    windows see exactly what the host shed); an unknown/absent reason is
    a wire-schema problem and types ``rpc_error``."""
    msg = message or f"host {host} rejected the request ({reason})"
    if reason == "host_unavailable":
        return HostUnavailableError(msg, host=host)
    if reason == "host_draining":
        return HostDrainingError(msg, host=host)
    if isinstance(reason, str) and reason in TERMINAL_REASONS \
            and reason != "ok":
        return RejectedError(msg, reason)
    return RpcError(
        f"host {host} answered with unknown terminal reason {reason!r}: "
        f"{message}", host=host)


# --------------------------------------------------------------------------
# Server side: one host's data-plane endpoint
# --------------------------------------------------------------------------
class _OpState:
    """Server-side record of one in-flight remote op."""

    __slots__ = ("op_id", "kind", "handle", "future", "cv", "cancelled",
                 "created_t", "resolved_t")

    def __init__(self, op_id: str, kind: str, handle=None, future=None):
        self.op_id = op_id
        self.kind = kind
        self.handle = handle          # GenerationHandle (generate ops)
        self.future = future          # Future (infer ops)
        self.cv = threading.Condition()
        self.cancelled = False
        self.created_t = time.monotonic()
        #: stamped by the first TTL sweep that sees the op done — the
        #: retention clock starts at the TERMINAL, never at creation
        self.resolved_t: Optional[float] = None


class _RpcHandler(BaseHTTPRequestHandler):
    server_version = "dl4jtpu-rpc/1.0"

    def log_message(self, *a):   # silence per-request stderr spam
        pass

    def _json(self, obj, code=200):
        body = json.dumps(obj).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):
        rpc: "HostRpcServer" = self.server.rpc  # type: ignore[attr-defined]
        if self.path == f"{RPC_PREFIX}/status":
            self._json(rpc.host.status().to_dict())
            return
        self._json({"error": "not found"}, 404)

    def do_POST(self):
        rpc: "HostRpcServer" = self.server.rpc  # type: ignore[attr-defined]
        n = int(self.headers.get("Content-Length", "0"))
        try:
            payload = json.loads(self.rfile.read(n).decode())
        except (ValueError, UnicodeDecodeError):
            self._json({"error": "malformed JSON body"}, 400)
            return
        route = {
            f"{RPC_PREFIX}/submit": rpc._handle_submit,
            f"{RPC_PREFIX}/result": rpc._handle_result,
            f"{RPC_PREFIX}/stream": rpc._handle_stream,
            f"{RPC_PREFIX}/cancel": rpc._handle_cancel,
            f"{RPC_PREFIX}/register_prefix": rpc._handle_register_prefix,
            f"{RPC_PREFIX}/drain": rpc._handle_drain,
            f"{RPC_PREFIX}/migrate": rpc._handle_migrate,
        }.get(self.path)
        if route is None:
            self._json({"error": "not found"}, 404)
            return
        try:
            self._json(route(payload))
        except Exception as e:   # a broken payload must not kill the thread
            self._json({"error": f"{type(e).__name__}: {e}"}, 500)


class _HttpServer(ThreadingHTTPServer):
    #: the listen backlog. The front door holds a long-poll connection per
    #: stream, and a host's engine threads keep the accept loop waiting
    #: for the interpreter lock: past the standard library's 5 queued
    #: connections the kernel drops SYNs, which clients retry after 1, 3
    #: and 7 s, so a stream stalls long enough to be hedged
    request_queue_size = 1024


class HostRpcServer:
    """One host's RPC data-plane endpoint: a stdlib
    ``ThreadingHTTPServer`` bound to 127.0.0.1, in front of a
    :class:`~deeplearning4j_tpu_torch.serving.cluster.HostHandle` —
    typically the process's ``LoopbackHost`` over its real
    engines. Endpoints (all JSON):

    - ``GET  /rpc/v1/status`` — the live :class:`HostStatus` (the same
      payload heartbeats carry; a :class:`RemoteHost` pump reads it).
    - ``POST /rpc/v1/submit`` — one :class:`RpcRequest`. Admission runs
      synchronously: a typed rejection returns ``ok=False`` with the
      host's reason; an admitted op returns ``stream_id`` for the
      result/stream long-polls. An exhausted deadline budget sheds
      typed ``deadline`` HERE, before touching the engine.
    - ``POST /rpc/v1/result`` — long-poll an infer op's Future.
    - ``POST /rpc/v1/stream`` — long-poll a generation stream's next
      :class:`RpcStreamChunk` past ``cursor``.
    - ``POST /rpc/v1/cancel`` — cancel an op server-side: a queued op's
      future cancels; a RESIDENT stream is retired on its next token
      (the hedging supervisor's loser releases its slot and KV blocks
      instead of decoding to completion for nobody).
    - ``POST /rpc/v1/register_prefix`` / ``POST /rpc/v1/drain`` — the
      prefix and host-leave control actions.

    ``clock`` is injectable for deadline tests. Resolved ops are kept
    until the TTL sweep (run from every submit/result/stream handler):
    a terminal must survive a lost HTTP response, so re-polls of a done
    op are idempotent rather than 'unknown op' errors."""

    #: abandoned ops (client died / hedged away without cancel) are
    #: dropped this many seconds after their terminal resolved
    OP_TTL_S = 120.0

    def __init__(self, host, port: int = 0,
                 clock=time.perf_counter):
        self.host = host
        self._clock = clock
        self._lock = threading.Lock()
        self._ops: Dict[str, _OpState] = {}
        self._op_ids = itertools.count(1)
        #: last submit's arrival budget (ms), for deadline-propagation
        #: tests: what the remote host actually saw
        self.last_arrival_budget_ms: Optional[float] = None
        self.submits = 0
        self.cancels = 0
        self._httpd = _HttpServer(("127.0.0.1", port), _RpcHandler)
        self._httpd.rpc = self  # type: ignore[attr-defined]
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, kwargs={"poll_interval": 0.05},
            daemon=True, name=f"rpc-server[h{getattr(host, 'host_id', '?')}]")
        self._thread.start()
        track_rpc_server(self)   # weak: the zero-leak ledger's registry

    @property
    def port(self) -> int:
        return self._httpd.server_address[1]

    @property
    def url(self) -> str:
        return f"http://127.0.0.1:{self.port}"

    def stop(self):
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout=5.0)

    # ----------------------------------------------------------- op registry
    def _register(self, state: _OpState):
        with self._lock:
            self._ops[state.op_id] = state

    def _op(self, op_id: str) -> Optional[_OpState]:
        with self._lock:
            return self._ops.get(op_id)

    def _gc(self):
        """TTL sweep over RESOLVED ops. The clock starts when a sweep
        first sees the terminal (resolved_t), never at creation — an op
        whose total runtime exceeds the TTL (a long decode) must still
        get its full post-terminal retention window, or the client's
        final poll would find 'unknown op' and fail/redo a stream that
        succeeded."""
        now = time.monotonic()
        with self._lock:
            items = list(self._ops.items())
        # done-ness reads the future/handle internals — evaluate OUTSIDE
        # the registry lock (leaf-lock hygiene: this mutex must stay a
        # pure dict guard)
        resolved = [k for k, s in items if self._op_done(s)]
        with self._lock:
            for k in resolved:
                s = self._ops.get(k)
                if s is None:
                    continue
                if s.resolved_t is None:
                    s.resolved_t = now
                elif now - s.resolved_t > self.OP_TTL_S:
                    self._ops.pop(k, None)
        self._publish_open_ops(len(items) - len(resolved))

    def open_ops(self) -> int:
        """Registered ops whose terminal has NOT resolved — the zero-
        leak ledger's stuck-client dimension. TTL-retained RESOLVED ops
        don't count: retention is the watermark-replay contract, not a
        leak. (serving/ledger.py check_shutdown holds this to zero once
        the host's engines are down.)"""
        with self._lock:
            items = list(self._ops.values())
        # future/handle internals read outside the registry lock, same
        # leaf-lock hygiene as _gc
        return sum(1 for s in items if not self._op_done(s))

    def _publish_open_ops(self, n: int):
        """Mirror the op registry's unresolved count onto the host
        engines' ``open_ops`` gauge so the metrics snapshot shows the
        number the ledger asserts on."""
        for eng in (getattr(self.host, "engine", None),
                    getattr(self.host, "generation", None)):
            m = getattr(eng, "metrics", None)
            if m is not None:
                m.open_ops.set(n)

    @staticmethod
    def _op_done(state: _OpState) -> bool:
        fut = state.future if state.future is not None \
            else state.handle.future
        return fut.done()

    # -------------------------------------------------------------- handlers
    def _handle_submit(self, payload: dict) -> dict:
        self._gc()
        try:
            req = RpcRequest.from_dict(payload)
        except (TypeError, KeyError, ValueError) as e:
            return RpcResponse(ok=False, error_reason="rpc_error",
                               error_message=f"malformed RpcRequest: {e}"
                               ).to_dict()
        self.submits += 1
        self.last_arrival_budget_ms = req.timeout_ms
        return self._submit(req, req.timeout_ms)

    def _submit(self, req: RpcRequest, timeout_ms: Optional[float]) -> dict:
        """Admit one wire request against the local host. ``timeout_ms``
        is the remaining budget that arrived on the wire: the server
        sheds typed ``deadline`` itself when it is already spent, and
        otherwise threads it through the engine submit so queue-time
        shedding enforces the ORIGINAL caller's deadline, not an
        unbounded local default."""
        if timeout_ms is not None and timeout_ms <= 0.0:
            return RpcResponse(
                request_id=req.request_id, ok=False, error_reason="deadline",
                error_message=(f"deadline budget exhausted in transit "
                               f"({timeout_ms:.1f} ms remaining on "
                               f"arrival)")).to_dict()
        op_id = f"op-{next(self._op_ids)}"
        # wire v3 trace context: honor it by threading the sender's
        # logical trace id into the local engine submit, so the engine's
        # own RequestTrace becomes a LINKED child leg of the front-door
        # trace (a v2 sender leaves both None — local root, as today)
        trace_kw = {} if req.trace_id is None else {
            "trace_link": req.trace_id, "trace_parent": req.parent_span}
        try:
            if req.kind == "infer":
                arr = np.asarray(req.x, dtype=np.dtype(req.x_dtype))
                fut = self.host.submit_infer(
                    arr, timeout_ms=timeout_ms, tenant=req.tenant,
                    priority=req.priority, **trace_kw)
                state = _OpState(op_id, "infer", future=fut)
            elif req.kind == "generate":
                state = _OpState(op_id, "generate")
                kw = {} if req.eos_default else {"eos_id": req.eos_id}
                kw.update(trace_kw)
                if req.resume_tokens is not None:
                    # wire v2 resume: seat through the engine's
                    # recompute-on-resume path (one recompute prefill,
                    # next sample at index resume_step)
                    kw["resume_tokens"] = np.asarray(req.resume_tokens,
                                                     np.int32)
                    kw["resume_step"] = int(req.resume_step)
                handle = self.host.submit_generate(
                    np.asarray(req.prompt, np.int32),
                    max_new_tokens=req.max_new_tokens,
                    temperature=req.temperature, top_k=req.top_k,
                    seed=req.seed, timeout_ms=timeout_ms,
                    prefix_id=req.prefix_id, tenant=req.tenant,
                    priority=req.priority,
                    on_token=self._make_on_token(state), **kw)
                state.handle = handle
                handle.future.add_done_callback(
                    lambda _f, s=state: self._notify(s))
            else:
                return RpcResponse(
                    request_id=req.request_id, ok=False,
                    error_reason="rpc_error",
                    error_message=f"unknown kind {req.kind!r}").to_dict()
        except RejectedError as e:
            return RpcResponse(request_id=req.request_id, ok=False,
                               error_reason=e.reason,
                               error_message=str(e)).to_dict()
        except (ValueError, KeyError, TypeError) as e:
            # caller-shaped errors (bad prompt/dtype — np.asarray and
            # np.dtype raise TypeError too — unknown prefix): typed
            # 'client_error' so the peer fails the request, not the
            # host; an escape here would go out as HTTP 500, which the
            # client types hedge-retriable rpc_error and replays the
            # same malformed request across the whole fleet
            return RpcResponse(request_id=req.request_id, ok=False,
                               error_reason="client_error",
                               error_message=str(e)).to_dict()
        self._register(state)
        return RpcResponse(request_id=req.request_id, ok=True,
                           stream_id=op_id,
                           resume_step=int(req.resume_step)
                           if req.resume_tokens is not None else 0
                           ).to_dict()

    def _make_on_token(self, state: _OpState):
        def on_token(_tok: int):
            # raising here is the engine's sanctioned immediate-retire
            # path (broken-consumer handling): a cancelled
            # stream frees its slot and KV blocks on the next token
            # instead of decoding its whole budget for nobody
            if state.cancelled:
                raise RuntimeError(
                    "stream cancelled by the peer (hedged away)")
            self._notify(state)
        return on_token

    def _notify(self, state: _OpState):
        with state.cv:
            state.cv.notify_all()

    def _handle_result(self, payload: dict) -> dict:
        self._gc()
        op_id = payload.get("stream_id")
        wait_ms = float(payload.get("wait_ms") or 0.0)
        state = self._op(op_id) if isinstance(op_id, str) else None
        if state is None or state.kind != "infer":
            return RpcResponse(ok=False, error_reason="rpc_error",
                               error_message=f"unknown op {op_id!r}"
                               ).to_dict()
        _futures_wait([state.future], timeout=wait_ms / 1e3)
        if not state.future.done():
            return RpcResponse(ok=True, done=False,
                               stream_id=op_id).to_dict()
        # the op stays registered until the TTL sweep: popping on fetch
        # would make the terminal unrecoverable when THIS response is
        # lost in transit (the client's retry must be able to re-poll
        # an already-resolved result — idempotence over a lossy wire)
        exc = state.future.exception()
        if exc is not None:
            return RpcResponse(ok=False, done=True, stream_id=op_id,
                               error_reason=terminal_reason(exc),
                               error_message=str(exc)).to_dict()
        res = state.future.result()
        arr = np.asarray(res)
        wire_dtype = str(arr.dtype)
        try:
            np.dtype(wire_dtype)
        except TypeError:
            # non-wire-safe dtype (a bfloat16 result from a peer's own
            # engine; numpy cannot reconstruct the name) — ship the
            # nearest JSON-exact representation instead
            arr = arr.astype(np.float32)
            wire_dtype = "float32"
        return RpcResponse(ok=True, done=True, stream_id=op_id,
                           result=arr.tolist(),
                           result_dtype=wire_dtype).to_dict()

    def _handle_stream(self, payload: dict) -> dict:
        self._gc()
        op_id = payload.get("stream_id")
        cursor = int(payload.get("cursor") or 0)
        wait_ms = float(payload.get("wait_ms") or 0.0)
        state = self._op(op_id) if isinstance(op_id, str) else None
        if state is None or state.kind != "generate":
            return RpcStreamChunk(
                stream_id=str(op_id), cursor=cursor, done=True,
                error_reason="rpc_error",
                error_message=f"unknown stream {op_id!r}").to_dict()
        handle = state.handle
        deadline = time.monotonic() + wait_ms / 1e3
        with state.cv:
            while True:
                # order matters: read done BEFORE snapshotting tokens.
                # The engine pushes every token before it resolves the
                # future, so done-then-tokens guarantees a done=True
                # chunk carries the COMPLETE stream — the reverse order
                # could observe a stale snapshot, then a just-resolved
                # future, and silently drop the trailing tokens
                done = handle.future.done()
                toks = handle.tokens_so_far()
                if len(toks) > cursor or done:
                    break
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                state.cv.wait(remaining)
        err_reason = err_msg = finish = None
        if done:
            finish = handle.finish_reason
            try:
                exc = handle.future.exception(timeout=0)
            except BaseException:       # future.cancel() won the terminal
                exc, err_reason = None, "cancelled"
            if exc is not None:
                err_reason = terminal_reason(exc)
                err_msg = str(exc)
            # no pop here: the terminal chunk must survive a lost HTTP
            # response — a re-poll of a done stream returns the same
            # (cursor-addressed, idempotent) terminal until the TTL
            # sweep forgets the op
        return RpcStreamChunk(stream_id=op_id, cursor=cursor,
                              tokens=[int(t) for t in toks[cursor:]],
                              done=bool(done), finish_reason=finish,
                              error_reason=err_reason,
                              error_message=err_msg).to_dict()

    def _handle_cancel(self, payload: dict) -> dict:
        op_id = payload.get("stream_id")
        state = self._op(op_id) if isinstance(op_id, str) else None
        if state is None:
            return {"ok": True, "found": False}
        self.cancels += 1
        state.cancelled = True
        fut = state.future if state.future is not None \
            else state.handle.future
        fut.cancel()   # queued op: immediate; resident stream: the
        #                on_token hook retires it on the next token
        self._notify(state)
        with self._lock:
            self._ops.pop(op_id, None)
        return {"ok": True, "found": True}

    def _handle_register_prefix(self, payload: dict) -> dict:
        try:
            timeout_s = payload.get("timeout_s")
            pid = self.host.register_prefix(
                np.asarray(payload["tokens"], np.int32),
                prefix_id=payload.get("prefix_id"),
                timeout=timeout_s)
            return {"ok": True, "prefix_id": pid}
        except RejectedError as e:
            return {"ok": False, "error_reason": e.reason,
                    "error_message": str(e)}
        except (ValueError, KeyError, TypeError) as e:
            return {"ok": False, "error_reason": "client_error",
                    "error_message": str(e)}

    def _handle_drain(self, payload: dict) -> dict:
        timeout_s = payload.get("timeout_s")
        drained = self.host.drain(
            timeout=float(timeout_s) if timeout_s is not None else None)
        return {"ok": True, "drained": bool(drained)}

    # --------------------------------------------- kv.migrate endpoint
    def _handle_migrate(self, payload: dict) -> dict:
        """``POST /rpc/v1/migrate`` — cross-host KV page migration, the
        endpoint beside ``/rpc/v1/*`` that serving/disagg.py's two-stage
        placement drives. ``kind="prefill"`` runs a ONE-token prefill
        with page capture and answers with the first sampled token plus
        the base64-encoded block pages (values + int8 scales + lengths +
        stream watermark — everything a SwapEntry carries);
        ``kind="import"`` seats shipped pages through the engine's
        swap store's swap-in path and continues decoding from the
        watermark, answering with the ``stream_id`` the normal
        ``/stream`` long-poll serves. EVERY page-movement degradation
        (capture failed, pages undecodable, import fault, block-size
        mismatch) answers ``mode="recompute"`` — the stream still runs,
        it just re-prefills; only the host's own
        typed admission rejections answer ``ok=False``."""
        self._gc()
        try:
            req = KvMigrateRequest.from_dict(payload)
        except (TypeError, KeyError, ValueError) as e:
            return KvMigrateResponse(
                ok=False, error_reason="rpc_error",
                error_message=f"malformed KvMigrateRequest: {e}").to_dict()
        timeout_ms = req.timeout_ms
        self.last_arrival_budget_ms = timeout_ms
        if timeout_ms is not None and timeout_ms <= 0.0:
            return KvMigrateResponse(
                request_id=req.request_id, ok=False,
                error_reason="deadline",
                error_message=(f"deadline budget exhausted in transit "
                               f"({timeout_ms:.1f} ms remaining on "
                               f"arrival)")).to_dict()
        if req.kind == "prefill":
            return self._migrate_prefill(req, timeout_ms)
        if req.kind == "import":
            return self._migrate_import(req, timeout_ms)
        return KvMigrateResponse(
            request_id=req.request_id, ok=False, error_reason="rpc_error",
            error_message=f"unknown migrate kind {req.kind!r}").to_dict()

    def _migrate_prefill(self, req: KvMigrateRequest,
                         timeout_ms: Optional[float]) -> dict:
        kw = {} if req.eos_default else {"eos_id": req.eos_id}
        if req.trace_id is not None:
            # wire v2 migrate trace context: the prefill leg links to
            # the front-door trace exactly like a /submit dispatch does
            kw["trace_link"] = req.trace_id
            kw["trace_parent"] = req.parent_span
        try:
            handle = self.host.submit_generate(
                np.asarray(req.prompt, np.int32), max_new_tokens=1,
                temperature=req.temperature, top_k=req.top_k,
                seed=req.seed, timeout_ms=timeout_ms, tenant=req.tenant,
                priority=req.priority, capture_pages=True, **kw)
        except RejectedError as e:
            return KvMigrateResponse(request_id=req.request_id, ok=False,
                                     error_reason=e.reason,
                                     error_message=str(e)).to_dict()
        except (ValueError, KeyError, TypeError) as e:
            return KvMigrateResponse(request_id=req.request_id, ok=False,
                                     error_reason="client_error",
                                     error_message=str(e)).to_dict()
        # block the handler thread for the one-token prefill: the server
        # is a ThreadingHTTPServer, and the caller's budget (plus grace
        # for a cold first call) bounds the wait
        wait_s = 600.0 if timeout_ms is None else timeout_ms / 1e3 + 30.0
        try:
            toks = handle.result(timeout=wait_s)
        except RejectedError as e:
            return KvMigrateResponse(request_id=req.request_id, ok=False,
                                     error_reason=e.reason,
                                     error_message=str(e)).to_dict()
        except Exception as e:
            return KvMigrateResponse(request_id=req.request_id, ok=False,
                                     error_reason=terminal_reason(e),
                                     error_message=str(e)).to_dict()
        if not len(toks):
            return KvMigrateResponse(
                request_id=req.request_id, ok=False,
                error_reason="rpc_error",
                error_message="prefill produced no token").to_dict()
        first = int(toks[0])
        finish = handle.finish_reason
        gen = getattr(self.host, "generation", None)
        entry = None if gen is None else gen.take_captured_pages(handle)
        if entry is None:
            return KvMigrateResponse(
                request_id=req.request_id, ok=True, mode="recompute",
                first_token=first, finish_reason=finish).to_dict()
        try:
            pages = _encode_pages(entry.payload)
        except Exception:
            # a leaf dtype the wire cannot carry: ship no pages — the
            # decode host recomputes, the stream still runs
            return KvMigrateResponse(
                request_id=req.request_id, ok=True, mode="recompute",
                first_token=first, finish_reason=finish).to_dict()
        return KvMigrateResponse(
            request_id=req.request_id, ok=True, mode="captured",
            first_token=first, finish_reason=finish, pages=pages,
            used_blocks=int(entry.used_blocks), length=int(entry.length),
            n_generated=int(entry.n_generated),
            last_token=int(entry.last_token), nbytes=int(entry.nbytes),
            block_size=int(getattr(gen, "block_size", 0) or 0)).to_dict()

    def _migrate_import(self, req: KvMigrateRequest,
                        timeout_ms: Optional[float]) -> dict:
        gen = getattr(self.host, "generation", None)
        key = None
        if gen is not None and req.pages is not None \
                and getattr(gen, "paged", False) \
                and (not req.block_size
                     or req.block_size == gen.block_size):
            try:
                entry = SwapEntry(
                    payload=_decode_pages(req.pages),
                    used_blocks=int(req.used_blocks),
                    length=int(req.length),
                    n_generated=int(req.n_generated),
                    last_token=int(req.last_token), prefix_len=0,
                    nbytes=int(req.nbytes))
                key = gen.import_pages(entry)
            except Exception:
                key = None   # undecodable pages: recompute, never shed
        op_id = f"op-{next(self._op_ids)}"
        state = _OpState(op_id, "generate")
        kw = {} if req.eos_default else {"eos_id": req.eos_id}
        if req.trace_id is not None:
            # the import/decode leg carries the SAME logical trace the
            # prefill leg did — the context is never dropped between the
            # two migration stages (deadline-propagation-style contract)
            kw["trace_link"] = req.trace_id
            kw["trace_parent"] = req.parent_span
        if key is not None:
            kw["swap_key"] = key
        try:
            handle = self.host.submit_generate(
                np.asarray(req.prompt, np.int32),
                max_new_tokens=req.max_new_tokens,
                temperature=req.temperature, top_k=req.top_k,
                seed=req.seed, timeout_ms=timeout_ms,
                tenant=req.tenant, priority=req.priority,
                resume_tokens=np.asarray([req.first_token], np.int32),
                resume_step=int(req.resume_step),
                on_token=self._make_on_token(state), **kw)
        except RejectedError as e:
            if key is not None:
                gen.discard_imported(key)
            return KvMigrateResponse(request_id=req.request_id, ok=False,
                                     error_reason=e.reason,
                                     error_message=str(e)).to_dict()
        except (ValueError, KeyError, TypeError) as e:
            if key is not None:
                gen.discard_imported(key)
            return KvMigrateResponse(request_id=req.request_id, ok=False,
                                     error_reason="client_error",
                                     error_message=str(e)).to_dict()
        state.handle = handle
        handle.future.add_done_callback(
            lambda _f, s=state: self._notify(s))
        self._register(state)
        return KvMigrateResponse(
            request_id=req.request_id, ok=True,
            mode="migrated" if key is not None else "recompute",
            stream_id=op_id, first_token=int(req.first_token)).to_dict()


# --------------------------------------------------------------------------
# Client side: RemoteHost + the stream attempt protocol
# --------------------------------------------------------------------------
class RemoteStream:
    """One ATTEMPT of a generation stream on one remote host: the
    cursor-addressed chunk protocol the bridge and the front door's
    hedging supervisor drive. Deliberately not a GenerationHandle — the
    handle the caller holds outlives attempts (hedged re-dispatch swaps
    the attempt underneath it).

    ``resume_step`` is the HONORED resume point echoed by the server's
    admit (0 when the attempt replays from the first token — a fresh
    dispatch, or a v1 peer that dropped the resume fields): the hedging
    supervisor pre-seeds its delivered prefix only when it is > 0, and
    this attempt's cursor space starts there."""

    def __init__(self, host: "RemoteHost", stream_id: str,
                 resume_step: int = 0):
        self.host = host
        self.host_id = host.host_id
        self.stream_id = stream_id
        self.resume_step = int(resume_step)

    def poll(self, cursor: int, wait_ms: float) -> RpcStreamChunk:
        """The next chunk past ``cursor`` (long-polls up to ``wait_ms``
        server-side). Raises typed ``host_unavailable``/``rpc_error``
        on network loss / malformed payload — the hedging supervisor's
        re-dispatch triggers."""
        raw = self.host._rpc(
            f"{RPC_PREFIX}/stream",
            {"stream_id": self.stream_id, "cursor": int(cursor),
             "wait_ms": float(wait_ms), "wire_version": 1},
            point="rpc.stream")
        try:
            chunk = RpcStreamChunk.from_dict(raw)
            # validate at the wire boundary so every consumer (bridge,
            # hedging supervisor) can iterate chunk.tokens without its
            # own guards — a null/garbage tokens field from a poisoned
            # or mid-upgrade payload must type rpc_error here, not
            # TypeError a background thread to death
            chunk.tokens = [int(t) for t in chunk.tokens]
            chunk.done = bool(chunk.done)
            return chunk
        except (TypeError, KeyError, ValueError) as e:
            raise RpcError(
                f"malformed RpcStreamChunk from host {self.host_id}",
                host=self.host_id) from e

    def cancel(self):
        """Best-effort server-side cancel (the hedge loser's cleanup:
        the remote slot and its KV blocks come back on the next decode
        turn instead of finishing the stream for nobody)."""
        try:
            self.host._rpc(f"{RPC_PREFIX}/cancel",
                           {"stream_id": self.stream_id, "wire_version": 1},
                           point=None)
        except Exception:
            pass   # the host may already be gone — that IS the cancel


class _ConnectTimeout(TimeoutError):
    """A TCP handshake that timed out: the host never saw the request."""


class _HandshakeTimedConnection(http.client.HTTPConnection):
    """An HTTP connection whose handshake has a timeout of its own,
    ``connect_timeout``; the socket then takes the call's timeout for
    the request and the reply."""

    def __init__(self, host, *, connect_timeout: float, **kw):
        super().__init__(host, **kw)
        self.connect_timeout = connect_timeout

    def connect(self):
        timeout = self.timeout
        self.timeout = min(timeout, self.connect_timeout)
        try:
            super().connect()
        except TimeoutError as e:
            raise _ConnectTimeout(f"connect timed out after "
                                  f"{self.timeout:.1f} s") from e
        finally:
            self.timeout = timeout
        self.sock.settimeout(timeout)


class _HandshakeTimedHandler(urllib.request.HTTPHandler):
    def __init__(self, connect_timeout: float):
        super().__init__()
        self.connect_timeout = connect_timeout

    def http_open(self, req):
        return self.do_open(functools.partial(
            _HandshakeTimedConnection,
            connect_timeout=self.connect_timeout), req)


class RemoteHost(HostHandle):
    """A host reached over the RPC data plane — the HTTP implementation
    of the :class:`HostHandle` seam. The directory and
    front door drive it exactly like a :class:`LoopbackHost`:
    ``status()`` feeds heartbeats (``HeartbeatPump(remote, transport)``
    works unchanged), ``submit_infer`` returns a Future resolved by a
    background result poller, ``submit_generate`` bridges the remote
    stream into a local ``GenerationHandle``, and ``open_stream`` is
    the attempt-scoped surface the front door's hedging supervisor
    drives directly.

    Failure taxonomy at this boundary: a TYPED rejection from the host
    re-raises with the host's own reason (``rejected_from_wire``);
    network loss raises ``host_unavailable``; a payload this client
    cannot interpret raises ``rpc_error`` — all three chain the
    underlying cause. ``clock`` is injectable so deadline-budget tests
    drive a fake clock.

    A call's TCP handshake times out after ``connect_timeout_s`` and is
    tried again on a fresh socket (a new source port) until the call's
    ``timeout_s`` is spent: the host never saw a request whose handshake
    failed, so any call may be retried. Without this, one handshake that
    goes unanswered (seen on a loopback host, under a fleet's stream
    long-polls) holds its call for the whole ``timeout_s`` and then fails
    a stream that may have no other host to go to. ``connect_retries``
    counts the retries."""

    def __init__(self, host_id: int, url: str, *, timeout_s: float = 30.0,
                 connect_timeout_s: float = 2.0,
                 poll_wait_ms: float = 200.0, clock=time.perf_counter,
                 name: Optional[str] = None):
        self.host_id = int(host_id)
        self.url = url.rstrip("/")
        self.timeout_s = float(timeout_s)
        self.connect_timeout_s = float(connect_timeout_s)
        self.connect_retries = 0
        self._retries_lock = threading.Lock()
        self._opener = urllib.request.build_opener(
            _HandshakeTimedHandler(self.connect_timeout_s))
        self.poll_wait_ms = float(poll_wait_ms)
        self._clock = clock
        self.name = name if name is not None else f"h{host_id}"
        self._req_ids = itertools.count(1)
        self._status_lock = threading.Lock()
        self._last_status: Optional[HostStatus] = None

    # ----------------------------------------------------------- transport
    def _http_json(self, path: str, payload: Optional[dict],
                   timeout_s: Optional[float] = None):
        data = None if payload is None else json.dumps(payload).encode()
        timeout = timeout_s if timeout_s is not None else self.timeout_s
        give_up = time.monotonic() + timeout
        while True:
            left = give_up - time.monotonic()
            req = urllib.request.Request(
                self.url + path, data=data,
                headers={"Content-Type": "application/json"})
            try:
                with self._opener.open(req, timeout=max(left, 1e-3)) as resp:
                    return json.loads(resp.read().decode())
            except urllib.error.URLError as e:
                # a handshake cut short by the call's own budget is final
                if not isinstance(e.reason, _ConnectTimeout) \
                        or left <= self.connect_timeout_s:
                    raise
                with self._retries_lock:
                    self.connect_retries += 1

    def _rpc(self, path: str, payload: Optional[dict], *,
             point: Optional[str], timeout_s: Optional[float] = None):
        """One wire round-trip under the chaos hooks: ``point`` names
        the request-side fault point (``rpc.dispatch``/``rpc.stream``);
        the decoded payload additionally rides ``rpc.response`` so a
        poison rule can malform it deterministically."""
        def call():
            return self._http_json(path, payload, timeout_s=timeout_s)

        try:
            raw = inject(point, call) if point is not None else call()
            raw = inject("rpc.response", _identity, raw)
        except FaultInjectedError as e:
            raise HostUnavailableError(
                f"host {self.host_id} rpc {path} dropped (injected "
                f"network fault)", host=self.host_id) from e
        except urllib.error.HTTPError as e:
            # the host ANSWERED — with a refusal this client cannot use
            raise RpcError(
                f"host {self.host_id} answered {path} with HTTP {e.code}",
                host=self.host_id) from e
        except (urllib.error.URLError, OSError, TimeoutError) as e:
            raise HostUnavailableError(
                f"host {self.host_id} unreachable for {path}: {e}",
                host=self.host_id) from e
        except (ValueError, UnicodeDecodeError) as e:
            raise RpcError(
                f"host {self.host_id} sent undecodable payload for {path}",
                host=self.host_id) from e
        return raw

    # -------------------------------------------------------------- status
    def status(self) -> HostStatus:
        try:
            raw = self._rpc(f"{RPC_PREFIX}/status", None, point=None)
            st = HostStatus.from_dict(raw)
        except RejectedError:
            raise
        except (TypeError, KeyError, ValueError) as e:
            raise RpcError(
                f"host {self.host_id} sent a malformed HostStatus",
                host=self.host_id) from e
        with self._status_lock:
            self._last_status = st
        return st

    def serves(self, kind: str) -> bool:
        """Answer from the CACHED status only — the front door calls
        this for every candidate on every route, so it must never block
        on the network (a blackholed host would stall routing for the
        whole socket timeout). Before any status has been seen the
        answer is optimistically True: the directory's stale/probe
        discipline owns unknown hosts, and a mis-kinded probe dispatch
        just bounces typed, each candidate at most once."""
        if kind not in ("infer", "generate"):
            raise ValueError(f"unknown request kind {kind!r}")
        with self._status_lock:
            st = self._last_status
        if st is None:
            return True
        return st.has_infer if kind == "infer" else st.has_generate

    # -------------------------------------------------------------- deadline
    def _deadline_t(self, timeout_ms: Optional[float]) -> Optional[float]:
        return None if timeout_ms is None \
            else self._clock() + timeout_ms / 1e3

    def _budget_ms(self, deadline_t: Optional[float]) -> Optional[float]:
        """REMAINING budget right now — recomputed at every send so each
        hop (and each hedged re-dispatch) ships what is actually left."""
        return None if deadline_t is None \
            else (deadline_t - self._clock()) * 1e3

    # --------------------------------------------------------------- submits
    def _submit_wire(self, req: RpcRequest) -> RpcResponse:
        raw = self._rpc(f"{RPC_PREFIX}/submit", req.to_dict(),
                        point="rpc.dispatch")
        try:
            resp = RpcResponse.from_dict(raw)
        except (TypeError, KeyError, ValueError) as e:
            raise RpcError(
                f"malformed RpcResponse from host {self.host_id}",
                host=self.host_id) from e
        if not resp.ok:
            raise rejected_from_wire(resp.error_reason, resp.error_message,
                                     host=self.host_id)
        if not resp.stream_id:
            raise RpcError(
                f"host {self.host_id} accepted the submit but returned "
                f"no op id", host=self.host_id)
        return resp

    def submit_infer(self, x, *, timeout_ms=None, tenant=None,
                     priority=None, trace_link=None,
                     trace_parent=None) -> Future:
        """Dispatch one batch-inference request; admission outcome is
        synchronous (a typed rejection raises HERE, so the front door's
        bounce loop works unchanged), the result rides a background
        long-poll into the returned Future. ``trace_link`` /
        ``trace_parent`` stamp the wire-v3 trace context (default None:
        the v2-sender shape — the remote trace stays a local root)."""
        arr = np.asarray(x)
        deadline_t = self._deadline_t(timeout_ms)
        req = RpcRequest(
            request_id=f"h{self.host_id}-r{next(self._req_ids)}",
            kind="infer", x=arr.tolist(), x_dtype=str(arr.dtype),
            trace_id=trace_link, parent_span=trace_parent,
            tenant=tenant, priority=priority,
            timeout_ms=self._budget_ms(deadline_t))
        resp = self._submit_wire(req)
        fut: Future = Future()
        fut.set_running_or_notify_cancel()

        def cancel_remote(op_id=resp.stream_id):
            # best-effort server-side drop (the hedge loser's cleanup);
            # the host may already be gone — that IS the cancel
            try:
                self._rpc(f"{RPC_PREFIX}/cancel",
                          {"stream_id": op_id, "wire_version": 1},
                          point=None)
            except Exception:
                pass

        fut.cancel_remote = cancel_remote  # type: ignore[attr-defined]
        t = threading.Thread(
            target=self._poll_result, args=(resp.stream_id, fut, deadline_t),
            daemon=True, name=f"rpc-result[h{self.host_id}]")
        t.start()
        return fut

    #: client-side backstop slack past the deadline before the result
    #: poller gives up — the SERVER owns deadline shedding (it has the
    #: re-anchored budget); this only stops the poller thread + socket
    #: from leaking forever when the remote engine wedges with the op
    #: never resolving
    DEADLINE_GRACE_S = 1.0

    def _poll_result(self, op_id: str, fut: Future,
                     deadline_t: Optional[float]):
        try:
            self._poll_result_loop(op_id, fut, deadline_t)
        except Exception as e:
            # the poller thread must NEVER die silently: any unexpected
            # error (post-parse decoding, a dtype this client cannot
            # build, a bug) resolves the caller's Future typed instead
            # of hanging it forever with the thread gone
            exc = RpcError(
                f"result poller for {op_id} on host {self.host_id} "
                f"failed: {type(e).__name__}: {e}", host=self.host_id)
            exc.__cause__ = e
            self._resolve(fut, exc=exc)

    def _poll_result_loop(self, op_id: str, fut: Future,
                          deadline_t: Optional[float]):
        while True:
            if deadline_t is not None and \
                    self._clock() >= deadline_t + self.DEADLINE_GRACE_S:
                self._resolve(fut, exc=DeadlineExceededError(
                    f"no result from host {self.host_id} for {op_id} "
                    f"within its deadline budget (+{self.DEADLINE_GRACE_S}"
                    f"s grace) — client-side backstop"))
                return
            try:
                raw = self._rpc(
                    f"{RPC_PREFIX}/result",
                    {"stream_id": op_id, "wait_ms": self.poll_wait_ms,
                     "wire_version": 1}, point="rpc.stream")
                resp = RpcResponse.from_dict(raw)
            except RejectedError as e:
                self._resolve(fut, exc=e)
                return
            except (TypeError, KeyError, ValueError) as e:
                exc = RpcError(
                    f"malformed RpcResponse from host {self.host_id}",
                    host=self.host_id)
                exc.__cause__ = e
                self._resolve(fut, exc=exc)
                return
            if not resp.done:
                continue
            if resp.error_reason is not None or not resp.ok:
                self._resolve(fut, exc=rejected_from_wire(
                    resp.error_reason, resp.error_message,
                    host=self.host_id))
                return
            dtype = np.dtype(resp.result_dtype or "float32")
            self._resolve(fut, result=np.asarray(resp.result, dtype=dtype))
            return

    @staticmethod
    def _resolve(fut: Future, result=None, exc=None):
        from concurrent.futures import InvalidStateError

        try:
            if exc is not None:
                # client-side
                # mirror of a terminal the REMOTE engine already
                # recorded (its _finish_request/SLO window); under the
                # front door, _watch_future records the fleet outcome.
                # Recording here too would double-count every request.
                fut.set_exception(exc)
            else:
                # same as above:
                # the remote engine owns this terminal's accounting
                fut.set_result(result)
        except InvalidStateError:
            pass   # caller cancelled: that terminal stands

    def open_stream(self, prompt, *, max_new_tokens: int = 16,
                    temperature: float = 0.0, top_k: int = 0,
                    eos_id=_UNSET, seed: int = 0,
                    timeout_ms: Optional[float] = None,
                    prefix_id: Optional[str] = None,
                    tenant: Optional[str] = None,
                    priority: Optional[str] = None,
                    hedge_attempt: int = 0,
                    deadline_t: Optional[float] = None,
                    resume_tokens=None,
                    resume_step: int = 0,
                    trace_link: Optional[str] = None,
                    trace_parent: Optional[str] = None) -> RemoteStream:
        """Admit one generation attempt remotely and return the
        attempt-scoped :class:`RemoteStream`. ``deadline_t`` (this
        client's clock) takes precedence over ``timeout_ms`` so hedged
        re-dispatches of one logical request share ONE deadline — each
        attempt ships only the budget that remains.

        ``resume_tokens``/``resume_step`` ask the host to seat this
        attempt at the delivery watermark instead of replaying (wire v2;
        ``max_new_tokens`` stays the ORIGINAL total budget). The
        returned stream's ``resume_step`` is what the server actually
        honored — 0 from a v1 peer, whose replay-from-0 the caller's
        watermark dedup must absorb."""
        toks = np.asarray(prompt, np.int32).ravel()
        if deadline_t is None:
            deadline_t = self._deadline_t(timeout_ms)
        eos_default = eos_id is _UNSET
        req = RpcRequest(
            request_id=f"h{self.host_id}-r{next(self._req_ids)}",
            kind="generate", prompt=[int(t) for t in toks],
            max_new_tokens=int(max_new_tokens),
            temperature=float(temperature), top_k=int(top_k),
            eos_id=None if eos_default else eos_id,
            eos_default=eos_default, seed=int(seed), prefix_id=prefix_id,
            resume_tokens=None if resume_tokens is None
            else [int(t) for t in resume_tokens],
            resume_step=int(resume_step),
            trace_id=trace_link, parent_span=trace_parent,
            tenant=tenant, priority=priority,
            timeout_ms=self._budget_ms(deadline_t),
            hedge_attempt=int(hedge_attempt))
        resp = self._submit_wire(req)
        return RemoteStream(self, resp.stream_id,
                            resume_step=int(resp.resume_step or 0))

    def submit_generate(self, prompt, **kwargs):
        """HostHandle surface: admit remotely and bridge the stream into
        a local :class:`GenerationHandle` (one poller thread pulls
        chunks through ``RemoteStream.poll`` and replays them through
        the handle's scheduler-side hooks). Direct single-host use; the
        front door's hedging supervisor uses :meth:`open_stream`
        instead and owns the handle across attempts."""
        on_token = kwargs.pop("on_token", None)
        toks = np.asarray(prompt, np.int32).ravel()
        stream = self.open_stream(toks, **kwargs)
        handle = client_stream_handle(int(toks.size), on_token=on_token,
                                      tenant=kwargs.get("tenant"))
        t = threading.Thread(
            target=self._bridge_stream, args=(stream, handle),
            daemon=True, name=f"rpc-stream[h{self.host_id}]")
        t.start()
        return handle

    def _bridge_stream(self, stream: RemoteStream, handle):
        try:
            self._bridge_stream_loop(stream, handle)
        except Exception as e:
            # same never-die-silently contract as the result poller:
            # the caller's handle must observe a typed terminal
            exc = RpcError(
                f"stream bridge for {stream.stream_id} on host "
                f"{self.host_id} failed: {type(e).__name__}: {e}",
                host=self.host_id)
            exc.__cause__ = e
            # client-side bridge
            # failure terminal; the remote engine owns its own
            # accounting (see the typed-loss path below)
            handle._fail(exc)
            stream.cancel()

    def _bridge_stream_loop(self, stream: RemoteStream, handle):
        cursor = 0
        while True:
            try:
                chunk = stream.poll(cursor, self.poll_wait_ms)
            except RejectedError as e:
                # client-side
                # bridge: the remote engine (or, on network loss, no
                # one) owns this stream's accounting; the front door's
                # hedging supervisor records fleet outcomes itself and
                # never uses this bridge
                if handle._fail(e):
                    pass   # terminal delivered (exactly once)
                stream.cancel()
                return
            for tok in chunk.tokens:
                err = handle._push(int(tok))
                if err is not None:
                    stream.cancel()   # broken local consumer: stop the host
                    return
            cursor += len(chunk.tokens)
            if chunk.done:
                if chunk.error_reason is not None:
                    # mirror of the
                    # remote engine's already-recorded failure terminal
                    handle._fail(rejected_from_wire(
                        chunk.error_reason, chunk.error_message,
                        host=self.host_id))
                else:
                    # mirror of the
                    # remote engine's already-recorded success terminal
                    handle._finish(chunk.finish_reason or "max_tokens")
                return

    # --------------------------------------------- kv.migrate (disagg)
    def migrate_prefill(self, prompt, *, max_new_tokens: int = 16,
                        temperature: float = 0.0, top_k: int = 0,
                        eos_id=_UNSET, seed: int = 0,
                        timeout_ms: Optional[float] = None,
                        deadline_t: Optional[float] = None,
                        tenant: Optional[str] = None,
                        priority: Optional[str] = None,
                        trace_link: Optional[str] = None,
                        trace_parent: Optional[str] = None
                        ) -> KvMigrateResponse:
        """Stage A of disaggregated serving (serving/disagg.py): run
        the prompt's prefill HERE with page capture, returning the
        first sampled token plus the captured block pages. Raises the
        host's typed rejection, or ``host_unavailable`` on network loss
        (the ``kv.migrate`` fault point covers this hop) — the caller
        degrades to recompute on the decode host, never sheds."""
        toks = np.asarray(prompt, np.int32).ravel()
        if deadline_t is None:
            deadline_t = self._deadline_t(timeout_ms)
        eos_default = eos_id is _UNSET
        req = KvMigrateRequest(
            request_id=f"h{self.host_id}-m{next(self._req_ids)}",
            kind="prefill", prompt=[int(t) for t in toks],
            max_new_tokens=int(max_new_tokens),
            temperature=float(temperature), top_k=int(top_k),
            eos_id=None if eos_default else eos_id,
            eos_default=eos_default, seed=int(seed), tenant=tenant,
            priority=priority, timeout_ms=self._budget_ms(deadline_t),
            trace_id=trace_link, parent_span=trace_parent)
        return self._migrate_rpc(req)

    def submit_migrated(self, prompt, prefill: KvMigrateResponse, *,
                        max_new_tokens: int = 16,
                        temperature: float = 0.0, top_k: int = 0,
                        eos_id=_UNSET, seed: int = 0,
                        timeout_ms: Optional[float] = None,
                        deadline_t: Optional[float] = None,
                        tenant: Optional[str] = None,
                        priority: Optional[str] = None,
                        trace_link: Optional[str] = None,
                        trace_parent: Optional[str] = None,
                        handle=None):
        """Stage B: seat stage A's pages on THIS host and continue the
        stream from its watermark. Returns ``(handle, mode)`` — the
        bridged local handle (``handle=`` lets the caller pass the
        client handle it already delivered the first token through; the
        server's handle holds only post-watermark tokens, so the bridge
        starts clean at cursor 0) and the server's honored mode
        (``"migrated"`` | ``"recompute"``)."""
        toks = np.asarray(prompt, np.int32).ravel()
        if deadline_t is None:
            deadline_t = self._deadline_t(timeout_ms)
        eos_default = eos_id is _UNSET
        req = KvMigrateRequest(
            request_id=f"h{self.host_id}-m{next(self._req_ids)}",
            kind="import", prompt=[int(t) for t in toks],
            max_new_tokens=int(max_new_tokens),
            temperature=float(temperature), top_k=int(top_k),
            eos_id=None if eos_default else eos_id,
            eos_default=eos_default, seed=int(seed), tenant=tenant,
            priority=priority, timeout_ms=self._budget_ms(deadline_t),
            trace_id=trace_link, parent_span=trace_parent,
            first_token=int(prefill.first_token), resume_step=1,
            pages=prefill.pages, used_blocks=int(prefill.used_blocks),
            length=int(prefill.length),
            n_generated=int(prefill.n_generated),
            last_token=int(prefill.last_token),
            nbytes=int(prefill.nbytes),
            block_size=int(prefill.block_size))
        resp = self._migrate_rpc(req)
        if not resp.stream_id:
            raise RpcError(
                f"host {self.host_id} accepted the migrated stream but "
                f"returned no op id", host=self.host_id)
        stream = RemoteStream(self, resp.stream_id)
        if handle is None:
            handle = client_stream_handle(int(toks.size), tenant=tenant)
        t = threading.Thread(
            target=self._bridge_stream, args=(stream, handle),
            daemon=True, name=f"rpc-migrated[h{self.host_id}]")
        t.start()
        return handle, resp.mode

    def _migrate_rpc(self, req: KvMigrateRequest) -> KvMigrateResponse:
        raw = self._rpc(f"{RPC_PREFIX}/migrate", req.to_dict(),
                        point="kv.migrate")
        try:
            resp = KvMigrateResponse.from_dict(raw)
        except (TypeError, KeyError, ValueError) as e:
            raise RpcError(
                f"malformed KvMigrateResponse from host {self.host_id}",
                host=self.host_id) from e
        if not resp.ok:
            raise rejected_from_wire(resp.error_reason,
                                     resp.error_message,
                                     host=self.host_id)
        return resp

    # ------------------------------------------------------- control actions
    def register_prefix(self, tokens, prefix_id=None, timeout=None) -> str:
        toks = np.asarray(tokens, np.int32).ravel()
        raw = self._rpc(
            f"{RPC_PREFIX}/register_prefix",
            {"tokens": [int(t) for t in toks], "prefix_id": prefix_id,
             "timeout_s": timeout, "wire_version": 1},
            point="rpc.dispatch",
            timeout_s=max(self.timeout_s, timeout or 0.0) + 5.0)
        if not raw.get("ok"):
            raise rejected_from_wire(raw.get("error_reason"),
                                     raw.get("error_message"),
                                     host=self.host_id)
        return raw["prefix_id"]

    def drain(self, timeout: Optional[float] = None) -> bool:
        """Run the remote host's graceful drain (blocks until drained or
        ``timeout``); the caller (the elasticity loop) marks/leaves the
        directory around this call — see ``cluster.drain_host``."""
        raw = self._rpc(
            f"{RPC_PREFIX}/drain",
            {"timeout_s": timeout, "wire_version": 1}, point=None,
            timeout_s=(timeout + 10.0) if timeout is not None else 600.0)
        return bool(raw.get("drained"))


def _identity(x):
    return x


__all__ = ["RpcRequest", "RpcResponse", "RpcStreamChunk",
           "KvMigrateRequest", "KvMigrateResponse", "HostRpcServer",
           "RemoteHost", "RemoteStream", "rejected_from_wire", "RPC_PREFIX"]
