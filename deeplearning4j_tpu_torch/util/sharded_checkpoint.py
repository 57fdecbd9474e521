"""Sharded checkpointing + preemption grace (counterpart:
``deeplearning4j_tpu/util/sharded_checkpoint.py``, which runs over orbax;
ref: the reference's ModelSerializer zip handles host-memory models, and
sharded device state needs per-shard persistence).

Over the port's explicit mesh (``parallel/mesh.py``) every rank holds its
own shards (``models.bert.place_params`` and the optimizer state built
from them), so every rank writes its own: a checkpoint of step ``s`` is a
directory ``<dir>/<s>`` holding ``shard_<rank>.pt`` per rank (the rank's
params and optimizer state on the host, ``torch.save``) and the JSON
sidecar ``checkpoint.json`` (step, world size, mesh shape), plus
``meta.json`` when the caller gives metadata. A step's directory takes its
final name only once every rank has written (a ``<s>.tmp`` directory
renamed after a barrier), so a preempted save never poses as a
checkpoint. Restore reads this rank's file and re-places every leaf where
the matching leaf of the ``*_like`` trees lives (device, dtype, shape),
so the state lands back on the mesh's placements. The format is the
port's own: orbax's cannot be written without orbax.

Every rank of the default process group calls ``save`` and ``restore``
(they meet at barriers); without a process group there is one rank.

Components:
- ``ShardedCheckpointManager`` — the CheckpointListener-style retention
  contract (keep-last-k, save-every-N) over those directories.
- ``GracefulShutdown`` — SIGTERM/SIGINT grace (preemption -> final
  checkpoint -> clean exit).
- ``train_with_checkpointing`` — the fit-with-CheckpointListener loop for
  ``make_train_step``-style steps: resume-exact (params, optimizer state
  and step) from the latest checkpoint.
"""
from __future__ import annotations

import json
import os
import shutil
import signal
from typing import Any, Callable, Dict, Optional

import torch
import torch.distributed as dist

from deeplearning4j_tpu_torch.train.updaters import tree_leaves, tree_map


class GracefulShutdown:
    """SIGTERM/SIGINT -> flag; training loops poll should_stop() and write a
    final checkpoint before exiting. Restores prior handlers on __exit__."""

    def __init__(self, signals=(signal.SIGTERM, signal.SIGINT)):
        self.signals = signals
        self._stop = False
        self._prev: Dict[int, Any] = {}

    def __enter__(self):
        for s in self.signals:
            self._prev[s] = signal.signal(s, self._handler)
        return self

    def _handler(self, signum, frame):
        self._stop = True
        # chain-call the handler we displaced so wrapping an outer
        # GracefulShutdown (or any app-level handler) doesn't silently
        # disable it. SIG_DFL/SIG_IGN aren't callable; the stock
        # default_int_handler is excluded because chaining it would turn a
        # graceful SIGINT into a KeyboardInterrupt mid-checkpoint —
        # exactly what this class exists to prevent.
        prev = self._prev.get(signum)
        if callable(prev) and prev is not signal.default_int_handler:
            prev(signum, frame)

    def should_stop(self) -> bool:
        return self._stop

    def __exit__(self, *exc):
        for s, h in self._prev.items():
            signal.signal(s, h)
        return False


def _rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def _world() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def _barrier():
    if dist.is_initialized():
        dist.barrier()


def _host(tree):
    return tree_map(lambda t: t.detach().cpu().clone()
                    if isinstance(t, torch.Tensor) else t, tree)


def _place(saved, like):
    """``saved``'s leaves placed as the matching leaves of ``like``."""
    def one(s, l):
        if isinstance(l, torch.Tensor):
            if tuple(s.shape) != tuple(l.shape):
                raise ValueError(f"checkpoint leaf of shape {tuple(s.shape)} "
                                 f"for a leaf of shape {tuple(l.shape)}")
            return s.to(device=l.device, dtype=l.dtype)
        return s
    return tree_map(one, saved, like)


class ShardedCheckpointManager:
    """keep-last-k / save-every-N sharded checkpoints (ref:
    CheckpointListener retention + ModelSerializer, for sharded trees).
    ``mesh`` (optional) is recorded in the sidecar and checked on
    restore."""

    SIDECAR = "checkpoint.json"

    def __init__(self, directory: str, keep_last: int = 3,
                 save_interval_steps: int = 1, mesh=None):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.keep_last = keep_last
        self.save_interval_steps = save_interval_steps
        self.mesh = mesh

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, str(step))

    def all_steps(self):
        return sorted(int(d) for d in os.listdir(self.directory)
                      if d.isdigit() and os.path.exists(
                          os.path.join(self._path(int(d)), self.SIDECAR)))

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def save(self, step: int, params, opt_state, metadata: Optional[dict] = None,
             force: bool = False) -> bool:
        """Write step ``step`` (every rank its shards) when ``force`` or
        when ``step`` is a multiple of ``save_interval_steps``; True when
        the step is durable (already saved counts: idempotent)."""
        if step in self.all_steps():
            return True
        if not force and self.save_interval_steps \
                and step % self.save_interval_steps:
            return False
        tmp = self._path(step) + ".tmp"
        if _rank() == 0:
            shutil.rmtree(tmp, ignore_errors=True)
            os.makedirs(tmp)
        _barrier()
        torch.save({"params": _host(params), "opt_state": _host(opt_state)},
                   os.path.join(tmp, f"shard_{_rank()}.pt"))
        _barrier()
        if _rank() == 0:
            if metadata:
                with open(os.path.join(tmp, "meta.json"), "w") as f:
                    json.dump(metadata, f)
            with open(os.path.join(tmp, self.SIDECAR), "w") as f:
                json.dump({"step": step, "world_size": _world(),
                           "mesh": dict(self.mesh.shape) if self.mesh is not None
                           else None}, f)
            os.replace(tmp, self._path(step))
            if self.keep_last:
                for old in self.all_steps()[:-self.keep_last]:
                    shutil.rmtree(self._path(old), ignore_errors=True)
        _barrier()
        return True

    def restore(self, params_like, opt_state_like, step: Optional[int] = None):
        """Restore (params, opt_state, step, metadata): this rank's shards
        of step ``step`` (default the latest), each leaf placed as the
        matching leaf of ``params_like``/``opt_state_like``."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.directory}")
        path = self._path(step)
        with open(os.path.join(path, self.SIDECAR)) as f:
            side = json.load(f)
        if side["world_size"] != _world():
            raise ValueError(f"checkpoint {path} was written by "
                             f"{side['world_size']} ranks; this world has "
                             f"{_world()}")
        if self.mesh is not None and side["mesh"] is not None \
                and side["mesh"] != dict(self.mesh.shape):
            raise ValueError(f"checkpoint {path} was written on the mesh "
                             f"{side['mesh']}, not {dict(self.mesh.shape)}")
        saved = torch.load(os.path.join(path, f"shard_{_rank()}.pt"),
                           weights_only=True)
        metadata = None
        meta_path = os.path.join(path, "meta.json")
        if os.path.exists(meta_path):
            with open(meta_path) as f:
                metadata = json.load(f)
        return (_place(saved["params"], params_like),
                _place(saved["opt_state"], opt_state_like), step, metadata)

    def wait(self):
        """Saves are synchronous; kept for the reference's API."""

    def close(self):
        """Nothing to release; kept for the reference's API."""


def train_with_checkpointing(
        step_fn: Callable, params, opt_state, batch_fn: Callable[[int], Any],
        num_steps: int, manager: ShardedCheckpointManager,
        start_step: int = 0, shutdown: Optional[GracefulShutdown] = None,
        listeners=()) -> tuple:
    """Run ``step_fn(params, opt_state, batch) -> (params, opt_state, loss)``
    from ``start_step`` to ``num_steps`` with periodic checkpoints (manager's
    save_interval_steps) and preemption grace: on SIGTERM a final checkpoint
    is forced before returning. ``batch_fn(step)`` supplies the batch — keyed
    by step so a resumed run replays the identical schedule (resume-exact).
    Returns (params, opt_state, last_step_completed, losses)."""
    losses = []
    step = start_step

    class _LoopModel:
        """Minimal model facade for TrainingListener consumers (score() +
        _params are what StatsListener/ProfilingListener read)."""
        def score(self):
            return losses[-1] if losses else float("nan")

        @property
        def _params(self):
            return params

        def numParams(self):
            return int(sum(l.numel() for l in tree_leaves(params)
                           if isinstance(l, torch.Tensor)))

    proxy = _LoopModel()
    for step in range(start_step, num_steps):
        batch = batch_fn(step)
        params, opt_state, loss = step_fn(params, opt_state, batch)
        losses.append(float(loss))
        for lst in listeners:
            lst.iterationDone(proxy, step, 0)
        completed = step + 1
        manager.save(completed, params, opt_state,
                     metadata={"step": completed, "loss": float(loss)})
        if shutdown is not None and shutdown.should_stop():
            manager.save(completed, params, opt_state, force=True,
                         metadata={"step": completed, "loss": float(loss),
                                   "preempted": True})
            manager.wait()
            return params, opt_state, completed, losses
    manager.wait()
    return params, opt_state, num_steps, losses
