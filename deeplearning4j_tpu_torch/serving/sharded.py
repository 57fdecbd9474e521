"""Sharded serving over a mesh of ranks: one rank decides, every rank
launches.

This module has no counterpart in the JAX package. There one controller
drives every device of the mesh and the compiler inserts the collectives.
Under ``torch.distributed`` every rank is a process of its own, and an
engine's decisions — admission, QoS, block allocation, copy-on-write,
preemption, the prefix cache, swap, speculation, retries, the breaker and
the watchdog — hang on when requests reach one process, which the other
ranks never see. So the ranks do not each schedule:

- every rank of the mesh builds the engine with the same arguments;
- the mesh's first rank is the **driver**: it runs the whole scheduler,
  and ``submit`` works only there;
- before every device operation the driver broadcasts the operation's
  **plan** (its name, the pool it binds, its host arguments) and then
  launches it; the other ranks, the **followers**, run each plan on their
  own shards in the order the plans come. Every collective inside the
  steps (the model axis' sums and gathers) therefore meets its peers.

The plans travel on a gloo group of their own over the mesh's ranks
(:class:`_Link`, one a process and mesh, made once), so host arrays never
pass through the card; activations stay on the mesh's groups. The group
is made on the default group's store under a prefix of its own, outside
``torch.distributed``'s registry of groups: that registry names a group
made by only its own ranks after the ranks alone, so a mesh's own groups
over the same ranks would share its name. The driver
holds the link's lock across a plan's broadcast and its own launch, so
the driver's launches (from any thread, of any engine on the mesh) come in
the order its plans went out. While idle it sends a heartbeat, so a
follower's wait outlives no timeout.

Failure. A follower whose handler raises aborts its process groups and
stops following: the driver's next collective or broadcast raises. A
driver step that fails after its plan went out leaves the followers out
of step (they may sit in a collective the driver never reaches), so on a
mesh with followers that failure breaks the link and surfaces as
:class:`MeshBrokenError`; the engine fails its tenants typed through its
usual fail-and-rebuild path, and the rebuild's own plan then fails, which
stops the engine. A lost rank costs the engine: nothing recovers the
mesh but building it anew. How soon the driver sees the loss: at once
when the rank's process died (its sockets close); otherwise when a
timeout expires — the plan group's :data:`TIMEOUT_S`, or a mesh group's
(``init_process_group``'s defaults: 30 minutes for gloo, 10 for NCCL).
"""
from __future__ import annotations

import collections
import datetime
import pickle
import threading
import time
import weakref
from typing import Any, Callable, Dict, Optional, Tuple

import torch
import torch.distributed as dist

from deeplearning4j_tpu_torch.parallel.mesh import Mesh

# seconds a plan broadcast may wait for its peers before it raises (an
# idle driver's heartbeat comes every TIMEOUT_S / 8)
TIMEOUT_S = 600.0


class MeshBrokenError(RuntimeError):
    """The ranks of a sharded engine's mesh are no longer in step: a rank
    is gone, a follower failed a plan, or a launched step failed on the
    driver. Nothing on this mesh serves again until it is built anew."""


_links: Dict[Tuple[int, ...], "_Link"] = {}
_links_lock = threading.Lock()


def _abort_groups(groups):
    """Best-effort abort of process groups, so peers blocked in a
    collective with this rank raise instead of waiting out the timeout."""
    abort = getattr(dist.distributed_c10d, "_abort_process_group", None)
    for g in groups:
        if g is None or g is dist.GroupMember.WORLD:
            continue   # the default group outlives a mesh
        try:
            if isinstance(g, dist.ProcessGroupGloo):
                g.abort()
            elif abort is not None:
                abort(g)
        except Exception:
            pass


def _broadcast(pg, obj=None):
    """``obj`` from the group's rank 0 to every rank of the raw gloo group
    ``pg`` (its pickle's length, then its bytes); returns it."""
    opts = dist.BroadcastOptions()
    opts.rootRank = 0
    if obj is not None:
        data = torch.frombuffer(bytearray(
            pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)),
            dtype=torch.uint8)
        n = torch.tensor([data.numel()], dtype=torch.int64)
    else:
        n = torch.zeros(1, dtype=torch.int64)
    pg.broadcast([n], opts).wait()
    if obj is None:
        data = torch.empty(int(n[0]), dtype=torch.uint8)
    pg.broadcast([data], opts).wait()
    return obj if obj is not None else pickle.loads(data.numpy().tobytes())


class _Link:
    """The plan channel of one mesh (by its ranks) in this process: the
    gloo group, the driver's send lock and heartbeat, a follower's
    dispatcher thread, and the per-engine endpoints (by tag). Engines on
    one mesh open endpoints in the same order on every rank, so a tag
    names the same engine everywhere."""

    def __init__(self, ranks: Tuple[int, ...], timeout_s: float):
        self.ranks = ranks
        self.driver = ranks[0]
        self.timeout_s = float(timeout_s)
        self.is_driver = not dist.is_initialized() \
            or dist.get_rank() == self.driver
        self.group = None
        # the default group the link was made in: a later one (the
        # process group destroyed and made again) needs a new link
        self.world = dist.GroupMember.WORLD if dist.is_initialized() \
            else None
        if dist.is_initialized():
            store = dist.PrefixStore(
                "serving.sharded/" + "-".join(map(str, ranks)) + "/",
                dist.distributed_c10d._get_default_store())
            self.group = dist.ProcessGroupGloo(
                store, ranks.index(dist.get_rank()), len(ranks),
                datetime.timedelta(seconds=self.timeout_s))
        self.lock = threading.RLock()
        self.error: Optional[BaseException] = None
        self.extra_groups: list = []
        self._tags = 0
        self._open = 0
        self._endpoints: Dict[int, "PlanChannel"] = {}
        self._pending: Dict[int, list] = collections.defaultdict(list)
        self._state = threading.Condition()
        self._last_send = time.monotonic()
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()

    # ------------------------------------------------------------ endpoints
    def attach(self, channel: "PlanChannel") -> int:
        with self._state:
            if self._open == 0:
                self._start()
            self._open += 1
            tag = self._tags
            self._tags += 1
            self._endpoints[tag] = channel
            # plans that came before the endpoint, under the lock the
            # dispatcher delivers under: none overtakes them
            for plan in self._pending.pop(tag, []):
                channel._deliver(plan)
        return tag

    def detach(self, tag: int):
        with self._state:
            self._endpoints.pop(tag, None)
            self._open -= 1
            last = self._open == 0
        if last and self.is_driver:
            # under the lock a beat takes before it sends: none follows
            # the close
            with self.lock:
                self._stop.set()
                if self.error is None:
                    try:
                        self.send(None, {"op": "close"})
                    except MeshBrokenError:
                        pass
            if self._thread is not None:
                self._thread.join(timeout=self.timeout_s)

    def _start(self):
        if self._thread is not None and self._thread.is_alive():
            # the last session's dispatcher ends at the close the driver
            # sent before this rank opened the link again
            self._thread.join(timeout=self.timeout_s)
        self._stop = threading.Event()
        if self.group is None or len(self.ranks) == 1 and self.is_driver:
            self._thread = None
            return
        target = self._beat if self.is_driver else self._dispatch
        self._thread = threading.Thread(
            target=target, name=f"mesh-plans{list(self.ranks)}", daemon=True)
        self._thread.start()

    # --------------------------------------------------------------- driver
    def send(self, tag: Optional[int], plan: dict) -> float:
        """Broadcast ``(tag, plan)`` to the followers; returns its seconds.
        The caller holds :attr:`lock` when a launch must follow in
        order."""
        with self.lock:
            if self.error is not None:
                raise MeshBrokenError(
                    f"the mesh {list(self.ranks)} is broken: "
                    f"{self.error}") from self.error
            t0 = time.perf_counter()
            if self.group is not None:
                try:
                    _broadcast(self.group, (tag, plan))
                except Exception as e:
                    self.fail(e)
                    raise MeshBrokenError(
                        f"plan {plan.get('op')!r} could not reach the mesh "
                        f"{list(self.ranks)}: {e}") from e
            self._last_send = time.monotonic()
            return time.perf_counter() - t0

    def _beat(self):
        period = max(0.05, min(10.0, self.timeout_s / 8))
        stop = self._stop
        while not stop.wait(period):
            # the stop is read again under the lock ``detach`` sends the
            # close under: a beat after the close would wait on followers
            # that no longer receive
            with self.lock:
                if stop.is_set():
                    return
                if time.monotonic() - self._last_send < period:
                    continue
                try:
                    self.send(None, {"op": "beat"})
                except MeshBrokenError:
                    return

    def fail(self, exc: BaseException, abort: bool = True):
        """Mark the link broken (every later send raises) and abort its
        groups, so peers waiting on this rank raise."""
        if self.error is None:
            self.error = exc
        if abort:
            _abort_groups([self.group] + self.extra_groups)
        with self._state:
            endpoints = list(self._endpoints.values())
        for ch in endpoints:
            ch._broken(exc)

    # ------------------------------------------------------------- follower
    def _dispatch(self):
        while True:
            try:
                tag, plan = _broadcast(self.group)
            except Exception as e:
                self.fail(e)
                return
            op = plan.get("op")
            if op == "beat":
                continue
            if op == "close":
                return
            with self._state:
                ch = self._endpoints.get(tag)
                if ch is None:
                    self._pending[tag].append(plan)
                    continue
                if not ch._deliver(plan):
                    return


def _link(mesh: Mesh) -> _Link:
    ranks = tuple(int(r) for r in mesh.devices.ravel())
    world = dist.GroupMember.WORLD if dist.is_initialized() else None
    with _links_lock:
        link = _links.get(ranks)
        if link is not None and link.world is not world:
            link = None
        if link is None or link.error is not None and link._open == 0:
            if link is not None and link.group is not None:
                # its ranks parted in the middle of a plan: nothing on
                # them is in step again in this process
                raise MeshBrokenError(
                    f"the mesh {list(ranks)} broke earlier in this process: "
                    f"{link.error}")
            link = _Link(ranks, TIMEOUT_S)
            _links[ranks] = link
    return link


class PlanChannel:
    """One sharded engine's end of its mesh's plan link.

    On the driver, :meth:`run` broadcasts a plan and then launches; on a
    follower, :meth:`follow` hands each plan for this engine to a handler
    (in arrival order, on the link's dispatcher thread) until the
    driver's ``shutdown`` plan. ``stats()`` reports the driver's plans and
    the seconds their broadcasts took."""

    def __init__(self, mesh: Mesh):
        if not mesh.contains_rank():
            raise ValueError(
                f"rank {dist.get_rank()} is not a device of the mesh "
                f"{mesh.shape}: only the mesh's ranks build its engine")
        self.mesh = mesh
        self.link = _link(mesh)
        self.link.extra_groups = [mesh.group(a) for a in mesh.axis_names]
        self.driver_rank = self.link.driver
        self.is_driver = self.link.is_driver
        self.followers = len(self.link.ranks) - 1
        self._handler: Optional[Callable[[dict], None]] = None
        self._done = threading.Event()
        self.error: Optional[BaseException] = None
        self._drops: collections.deque = collections.deque()
        self.plans = 0
        self.plan_s = 0.0
        self._closed = False
        self.tag = self.link.attach(self) if self.is_driver else None

    # --------------------------------------------------------------- driver
    def run(self, plan: dict, fn: Callable[[], Any]):
        """Broadcast ``plan`` (with the keys of objects dropped since the
        last one), then ``fn()``, both under the link's lock. With
        followers, an exception from ``fn`` breaks the link (the followers
        may be out of step) and raises :class:`MeshBrokenError`."""
        with self.link.lock:
            drops = []
            while self._drops:
                drops.append(self._drops.popleft())
            if drops:
                plan = dict(plan, drops=drops)
            self.plan_s += self.link.send(self.tag, plan)
            self.plans += 1
            if not self.followers:
                return fn()
            try:
                return fn()
            except Exception as e:
                self.link.fail(e)
                raise MeshBrokenError(
                    f"{plan.get('op')!r} failed on the driver after its "
                    f"plan went out; the mesh {list(self.link.ranks)} left "
                    f"lockstep: {type(e).__name__}: {e}") from e

    def drop_later(self, obj, kind: str, key):
        """When ``obj`` is collected, tell the followers to drop their
        ``(kind, key)`` counterpart with the next plan."""
        weakref.finalize(obj, self._drops.append, (kind, key))

    def stats(self) -> dict:
        return {"plans": self.plans, "plan_ms": self.plan_s * 1e3}

    def close(self):
        """Driver: send the engine's ``shutdown`` plan (idempotent).
        Follower: wait for it."""
        if self._closed:
            return
        self._closed = True
        if self.is_driver:
            if self.link.error is None:
                try:
                    self.link.send(self.tag, {"op": "shutdown"})
                except MeshBrokenError:
                    pass
        elif self.tag is not None:
            self._done.wait()
        if self.tag is not None:
            self.link.detach(self.tag)

    # ------------------------------------------------------------- follower
    def follow(self, handler: Callable[[dict], None]):
        """Hand each of this engine's plans to ``handler``; returns at
        once (the link's dispatcher thread does the work)."""
        self._handler = handler
        self.tag = self.link.attach(self)

    def _deliver(self, plan: dict) -> bool:
        """Run one plan; False stops the dispatcher (the link broke)."""
        if plan.get("op") == "shutdown":
            self._done.set()
            return True
        try:
            self._handler(plan)
        except BaseException as e:
            self.error = e
            self.link.fail(e)
            return False
        return True

    def _broken(self, exc: BaseException):
        if self.error is None:
            self.error = exc
        self._done.set()

    @property
    def done(self) -> bool:
        return self._done.is_set()


def card_of(device) -> torch.device:
    """``device`` with the index of the card it means now: a thread
    started later begins on card 0, whatever this one chose."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def bind_card(device: Optional[torch.device]):
    """Make ``device`` the calling thread's card: an engine's scheduler
    and a follower's plans run on threads of their own, and the
    hand-written kernels launch on the thread's current card (a rank of
    a mesh drives a card that need not be card 0)."""
    if device is not None and device.type == "cuda":
        torch.cuda.set_device(device)


def driver_only(engine, what: str):
    """The ``ValueError`` a follower raises for a driver-only call."""
    return ValueError(
        f"{what} runs on the mesh's driver, rank {engine._plan.driver_rank}: "
        f"this rank ({dist.get_rank()}) follows its plans")
