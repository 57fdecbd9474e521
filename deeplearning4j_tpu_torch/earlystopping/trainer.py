"""Early stopping trainer (counterpart: ``deeplearning4j_tpu/earlystopping/
trainer.py``; ref: org.deeplearning4j.earlystopping —
EarlyStoppingConfiguration.Builder, EarlyStoppingTrainer, termination
conditions (MaxEpochs, ScoreImprovementEpochs, MaxTime, MaxScore), model
savers (InMemoryModelSaver, LocalFileModelSaver through the port's
ModelSerializer), EarlyStoppingResult). Works for MultiLayerNetwork and
ComputationGraph alike: it reads only fit/score/clone/listeners."""
from __future__ import annotations

import os
import time
from dataclasses import dataclass, field
from typing import Any, List, Optional


# ---------------------------------------------------------------- conditions
class MaxEpochsTerminationCondition:
    """(ref: termination.MaxEpochsTerminationCondition)."""

    def __init__(self, maxEpochs: int):
        self.maxEpochs = maxEpochs

    def terminate_epoch(self, epoch: int, score: float, best: float) -> bool:
        return epoch + 1 >= self.maxEpochs


class ScoreImprovementEpochTerminationCondition:
    """Stop after N epochs without improvement (ref: same name).

    Stateful: EarlyStoppingTrainer.fit() calls reset() at the start of every
    run so a configuration can be reused. Only invoked on epochs where a score
    was actually computed (requires_score flag)."""

    requires_score = True

    def __init__(self, maxEpochsWithNoImprovement: int, minImprovement: float = 0.0):
        self.patience = maxEpochsWithNoImprovement
        self.minImprovement = minImprovement
        self.reset()

    def reset(self):
        self._best = float("inf")
        self._since = 0

    def terminate_epoch(self, epoch: int, score: float, best: float) -> bool:
        if score < self._best - self.minImprovement:
            self._best = score
            self._since = 0
            return False
        self._since += 1
        return self._since > self.patience


class MaxTimeIterationTerminationCondition:
    """Wall-clock bound (ref: MaxTimeIterationTerminationCondition)."""

    def __init__(self, maxTimeSeconds: float):
        self.maxTime = maxTimeSeconds
        self.reset()

    def reset(self):
        self._start = time.perf_counter()

    def terminate_iteration(self, score: float) -> bool:
        return (time.perf_counter() - self._start) > self.maxTime


class MaxScoreIterationTerminationCondition:
    """Abort on diverging score (ref: MaxScoreIterationTerminationCondition)."""

    def __init__(self, maxScore: float):
        self.maxScore = maxScore

    def terminate_iteration(self, score: float) -> bool:
        return score > self.maxScore or score != score  # NaN counts


# -------------------------------------------------------------------- savers
class InMemoryModelSaver:
    """(ref: saver.InMemoryModelSaver)."""

    def __init__(self):
        self._best = None
        self._latest = None

    def saveBestModel(self, model, score: float):
        self._best = model.clone()

    def saveLatestModel(self, model, score: float):
        self._latest = model.clone()

    def getBestModel(self):
        return self._best

    def getLatestModel(self):
        return self._latest


class LocalFileModelSaver:
    """(ref: saver.LocalFileModelSaver) — bestModel.zip / latestModel.zip."""

    def __init__(self, directory: str):
        self.dir = directory
        # getBestModel/getLatestModel restore onto the saved model's device
        self.device = None
        os.makedirs(directory, exist_ok=True)

    def _path(self, name):
        return os.path.join(self.dir, name)

    def saveBestModel(self, model, score: float):
        from deeplearning4j_tpu_torch.util.model_serializer import ModelSerializer
        ModelSerializer.writeModel(model, self._path("bestModel.zip"), True)
        self.device = model.device

    def saveLatestModel(self, model, score: float):
        from deeplearning4j_tpu_torch.util.model_serializer import ModelSerializer
        ModelSerializer.writeModel(model, self._path("latestModel.zip"), True)
        self.device = model.device

    def getBestModel(self):
        from deeplearning4j_tpu_torch.util.model_serializer import ModelSerializer
        p = self._path("bestModel.zip")
        return ModelSerializer.restoreModel(p, device=self.device) \
            if os.path.exists(p) else None

    def getLatestModel(self):
        from deeplearning4j_tpu_torch.util.model_serializer import ModelSerializer
        p = self._path("latestModel.zip")
        return ModelSerializer.restoreModel(p, device=self.device) \
            if os.path.exists(p) else None


# ---------------------------------------------------------- score calculator
class DataSetLossCalculator:
    """Holdout loss as the early-stopping score (ref: scorecalc.
    DataSetLossCalculator)."""

    def __init__(self, iterator, average: bool = True):
        self.iterator = iterator
        self.average = average

    def calculateScore(self, model) -> float:
        if hasattr(self.iterator, "reset"):
            self.iterator.reset()
        total, n = 0.0, 0
        for ds in self.iterator:
            total += model.score(ds)
            n += 1
        return total / max(n, 1) if self.average else total


# ---------------------------------------------------------------- config
@dataclass
class EarlyStoppingConfiguration:
    """(ref: EarlyStoppingConfiguration.Builder)."""
    epochTerminationConditions: List[Any] = field(default_factory=list)
    iterationTerminationConditions: List[Any] = field(default_factory=list)
    scoreCalculator: Optional[Any] = None
    modelSaver: Any = field(default_factory=InMemoryModelSaver)
    evaluateEveryNEpochs: int = 1
    saveLastModel: bool = False

    class Builder:
        def __init__(self):
            self._c = EarlyStoppingConfiguration()

        def epochTerminationConditions(self, *conds):
            self._c.epochTerminationConditions = list(conds)
            return self

        def iterationTerminationConditions(self, *conds):
            self._c.iterationTerminationConditions = list(conds)
            return self

        def scoreCalculator(self, sc):
            self._c.scoreCalculator = sc
            return self

        def modelSaver(self, saver):
            self._c.modelSaver = saver
            return self

        def evaluateEveryNEpochs(self, n: int):
            self._c.evaluateEveryNEpochs = n
            return self

        def saveLastModel(self, b: bool):
            self._c.saveLastModel = b
            return self

        def build(self) -> "EarlyStoppingConfiguration":
            return self._c


@dataclass
class EarlyStoppingResult:
    """(ref: EarlyStoppingResult)."""
    terminationReason: str
    terminationDetails: str
    scoreVsEpoch: dict
    bestModelEpoch: int
    bestModelScore: float
    totalEpochs: int
    bestModel: Any


class _IterationGuard:
    """Listener bridging iteration termination conditions into fit."""

    def __init__(self, conds):
        self.conds = conds
        self.tripped: Optional[str] = None

    def iterationDone(self, model, iteration, epoch):
        for c in self.conds:
            if c.terminate_iteration(model.score()):
                self.tripped = type(c).__name__
                raise _StopTraining


class _StopTraining(Exception):
    _control_flow = True  # not a crash: fit()'s dump-and-reraise skips it

    pass


class EarlyStoppingTrainer:
    """(ref: EarlyStoppingTrainer / BaseEarlyStoppingTrainer.fit loop)."""

    def __init__(self, config: EarlyStoppingConfiguration, model, trainData):
        self.config = config
        self.model = model
        self.trainData = trainData

    def _fit_epoch(self):
        """One epoch of training; subclasses swap the executor (the parallel
        trainer routes through ParallelWrapper)."""
        self.model.fit(self.trainData)

    def fit(self) -> EarlyStoppingResult:
        cfg = self.config
        score_vs_epoch = {}
        best_score, best_epoch = float("inf"), -1
        reason, details = "EpochTerminationCondition", ""
        for c in list(cfg.epochTerminationConditions) + list(
                cfg.iterationTerminationConditions):
            if hasattr(c, "reset"):
                c.reset()
        guard = _IterationGuard(cfg.iterationTerminationConditions)
        saved_listeners = list(self.model.listeners)
        if cfg.iterationTerminationConditions:
            self.model.addListeners(guard)
        epoch = 0
        try:
            while True:
                if hasattr(self.trainData, "reset"):
                    self.trainData.reset()
                try:
                    self._fit_epoch()
                except _StopTraining:
                    reason = "IterationTerminationCondition"
                    details = guard.tripped or ""
                    break
                if epoch % cfg.evaluateEveryNEpochs == 0:
                    score = (cfg.scoreCalculator.calculateScore(self.model)
                             if cfg.scoreCalculator else self.model.score())
                    score_vs_epoch[epoch] = score
                    if score < best_score:
                        best_score, best_epoch = score, epoch
                        cfg.modelSaver.saveBestModel(self.model, score)
                    if cfg.saveLastModel:
                        cfg.modelSaver.saveLatestModel(self.model, score)
                stop = False
                for c in cfg.epochTerminationConditions:
                    if getattr(c, "requires_score", False) and epoch not in score_vs_epoch:
                        continue  # non-evaluation epoch: no score to judge
                    if c.terminate_epoch(epoch, score_vs_epoch.get(epoch, best_score),
                                         best_score):
                        details = type(c).__name__
                        stop = True
                        break
                if stop:
                    break
                epoch += 1
        finally:
            self.model.listeners = saved_listeners
        # only consult the saver if THIS run saved a best model — a reused
        # saver may hold a previous run's (stale) best
        best = (cfg.modelSaver.getBestModel() if best_epoch >= 0 else None) \
            or self.model
        return EarlyStoppingResult(
            terminationReason=reason, terminationDetails=details,
            scoreVsEpoch=score_vs_epoch, bestModelEpoch=best_epoch,
            bestModelScore=best_score, totalEpochs=epoch + 1, bestModel=best)


class EarlyStoppingParallelTrainer(EarlyStoppingTrainer):
    """Early stopping over sharded data-parallel training (ref:
    org.deeplearning4j.parallelism.EarlyStoppingParallelTrainer): each
    epoch runs through ParallelWrapper, one rank a process, and scoring and
    saving read the model the wrapper trains in place (the same on every
    rank)."""

    def __init__(self, config, model, trainData, mesh=None, workers=None):
        super().__init__(config, model, trainData)
        from deeplearning4j_tpu_torch.parallel.data_parallel import ParallelWrapper
        self.wrapper = ParallelWrapper(model, mesh=mesh, workers=workers)

    def _fit_epoch(self):
        self.wrapper.fit(self.trainData)
