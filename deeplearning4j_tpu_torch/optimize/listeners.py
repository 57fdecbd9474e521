"""Training listeners (counterpart: ``deeplearning4j_tpu/optimize/
listeners.py``; ref: org.deeplearning4j.optimize.listeners.* —
ScoreIterationListener, PerformanceListener, CollectScoresListener,
TimeIterationListener, EvaluativeListener; CheckpointListener lives in
o.d.optimize.listeners.CheckpointListener).

The listener SPI matches the reference's: iterationDone(model, iteration,
epoch) fired per optimizer step, onEpochEnd(model) per epoch. Models fire
these from their fit loops, after every step."""
from __future__ import annotations

import logging
import os
import time
from typing import List, Optional

log = logging.getLogger("deeplearning4j_tpu_torch")


class TrainingListener:
    """SPI (ref: org.deeplearning4j.optimize.api.TrainingListener)."""

    def iterationDone(self, model, iteration: int, epoch: int):
        pass

    def onEpochStart(self, model):
        pass

    def onEpochEnd(self, model):
        pass

    def requiresModelAtIteration(self, iteration: int) -> bool:
        """Whether iterationDone at ``iteration`` reads anything beyond
        ``model.score()`` / wall-clock (parameters, activations, saving the
        model, ...). Kept for the reference's SPI: its fused fit path
        flushes at these iterations; this port calls every listener after
        every step with the model current, so nothing here reads it."""
        return True


class ScoreIterationListener(TrainingListener):
    """Log score every N iterations (ref: ScoreIterationListener)."""

    def __init__(self, printIterations: int = 10):
        self.n = max(printIterations, 1)

    def iterationDone(self, model, iteration, epoch):
        if iteration % self.n == 0:
            log.info("Score at iteration %d is %s", iteration, model.score())
            print(f"Score at iteration {iteration} is {model.score()}")

    def requiresModelAtIteration(self, iteration: int) -> bool:
        return False  # reads only score()


class PerformanceListener(TrainingListener):
    """Throughput reporting (ref: PerformanceListener — samples/sec, iter ms)."""

    def __init__(self, frequency: int = 10, reportScore: bool = False):
        self.frequency = max(frequency, 1)
        self.reportScore = reportScore
        self._last_t: Optional[float] = None
        self._last_iter = 0

    def iterationDone(self, model, iteration, epoch):
        now = time.perf_counter()
        if self._last_t is not None and iteration % self.frequency == 0:
            dt = now - self._last_t
            iters = iteration - self._last_iter
            ms = 1000.0 * dt / max(iters, 1)
            msg = f"iteration {iteration}: {ms:.2f} ms/iter"
            if self.reportScore:
                msg += f", score {model.score()}"
            print(msg)
            self._last_t, self._last_iter = now, iteration
        elif self._last_t is None:
            self._last_t, self._last_iter = now, iteration

    def requiresModelAtIteration(self, iteration: int) -> bool:
        # the reference's fused fit flushes at measurement iterations
        return iteration % self.frequency == 0


class CollectScoresListener(TrainingListener):
    """Accumulate (iteration, score) pairs (ref: CollectScoresListener)."""

    def __init__(self, frequency: int = 1):
        self.frequency = max(frequency, 1)
        self.iterations: List[int] = []
        self.scores: List[float] = []

    def iterationDone(self, model, iteration, epoch):
        if iteration % self.frequency == 0:
            self.iterations.append(iteration)
            self.scores.append(model.score())

    def requiresModelAtIteration(self, iteration: int) -> bool:
        return False  # reads only score()


class TimeIterationListener(TrainingListener):
    """ETA logging (ref: TimeIterationListener)."""

    def __init__(self, iterationCount: int):
        self.total = iterationCount
        self._start = time.perf_counter()

    def iterationDone(self, model, iteration, epoch):
        elapsed = time.perf_counter() - self._start
        if iteration > 0:
            remaining = elapsed / iteration * (self.total - iteration)
            log.info("Remaining time estimate: %.1fs (%d/%d)", remaining,
                     iteration, self.total)

    def requiresModelAtIteration(self, iteration: int) -> bool:
        # cumulative ETA only (elapsed/iteration extrapolation)
        return False


class EvaluativeListener(TrainingListener):
    """Periodic holdout evaluation (ref: EvaluativeListener)."""

    def __init__(self, iterator, frequency: int = 1, unit: str = "epoch"):
        self.iterator = iterator
        self.frequency = max(frequency, 1)
        self.unit = unit
        self.evaluations: List = []

    def _evaluate(self, model):
        if hasattr(self.iterator, "reset"):
            self.iterator.reset()
        ev = model.evaluate(self.iterator)
        self.evaluations.append(ev)
        print(ev.stats())

    def iterationDone(self, model, iteration, epoch):
        if self.unit == "iteration" and iteration % self.frequency == 0:
            self._evaluate(model)

    def requiresModelAtIteration(self, iteration: int) -> bool:
        # needs live params exactly at its evaluation iterations
        return self.unit == "iteration" and iteration % self.frequency == 0

    def onEpochEnd(self, model, *_):
        if self.unit == "epoch" and model.getEpochCount() % self.frequency == 0:
            self._evaluate(model)


class CheckpointListener(TrainingListener):
    """Periodic checkpoints with retention (ref: o.d.optimize.listeners.
    CheckpointListener: every N iters/epochs, keepLast(k), checkpoint_<n>_
    <Model>.zip + index file; static load helpers)."""

    def __init__(self, dirPath: str, keepLast: int = 0, saveEveryNEpochs: int = 0,
                 saveEveryNIterations: int = 0, logSaving: bool = False):
        self.dir = dirPath
        os.makedirs(dirPath, exist_ok=True)
        self.keepLast = keepLast
        self.everyNEpochs = saveEveryNEpochs
        self.everyNIterations = saveEveryNIterations
        self.logSaving = logSaving
        self._count = 0

    def _save(self, model):
        from deeplearning4j_tpu_torch.util.model_serializer import ModelSerializer
        name = f"checkpoint_{self._count}_{type(model).__name__}.zip"
        path = os.path.join(self.dir, name)
        ModelSerializer.writeModel(model, path, saveUpdater=True)
        with open(os.path.join(self.dir, "checkpointInfo.txt"), "a") as f:
            f.write(f"{self._count},{name},{time.time()}\n")
        if self.logSaving:
            print(f"Saved checkpoint {path}")
        self._count += 1
        if self.keepLast > 0:
            self._prune()

    def _prune(self):
        cps = self.availableCheckpoints(self.dir)
        for n, name in cps[:-self.keepLast]:
            p = os.path.join(self.dir, name)
            if os.path.exists(p):
                os.remove(p)

    @staticmethod
    def availableCheckpoints(dirPath: str):
        out = []
        for f in os.listdir(dirPath):
            if f.startswith("checkpoint_") and f.endswith(".zip"):
                out.append((int(f.split("_")[1]), f))
        return sorted(out)

    @staticmethod
    def lastCheckpoint(dirPath: str) -> Optional[str]:
        cps = CheckpointListener.availableCheckpoints(dirPath)
        return os.path.join(dirPath, cps[-1][1]) if cps else None

    @staticmethod
    def loadCheckpointMLN(dirPath: str, number: Optional[int] = None, device=None):
        """The checkpoint ``number`` (default the last) onto ``device``
        (default ``"cuda"``)."""
        from deeplearning4j_tpu_torch.util.model_serializer import ModelSerializer
        cps = dict(CheckpointListener.availableCheckpoints(dirPath))
        name = cps[number] if number is not None else cps[max(cps)]
        return ModelSerializer.restoreMultiLayerNetwork(os.path.join(dirPath, name),
                                                        device=device)

    def iterationDone(self, model, iteration, epoch):
        if self.everyNIterations and iteration % self.everyNIterations == 0:
            self._save(model)

    def requiresModelAtIteration(self, iteration: int) -> bool:
        # needs live params exactly at its save iterations
        return bool(self.everyNIterations) \
            and iteration % self.everyNIterations == 0

    def onEpochEnd(self, model, *_):
        if self.everyNEpochs and model.getEpochCount() % self.everyNEpochs == 0:
            self._save(model)
