"""Optimization runner (counterpart: ``deeplearning4j_tpu/arbiter/runner.py``, copied;
ref: org.deeplearning4j.arbiter.optimize.runner.
LocalOptimizationRunner + OptimizationConfiguration: candidate generator +
score function + termination conditions -> best candidate; results carry
per-candidate scores/exceptions as the reference's OptimizationResult does)."""
from __future__ import annotations

import time
import traceback
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional


@dataclass
class Candidate:
    index: int
    hyperparameters: Dict[str, Any]


@dataclass
class CandidateResult:
    candidate: Candidate
    score: Optional[float]
    duration_sec: float
    exception: Optional[str] = None
    model: Any = None


class MaxCandidatesCondition:
    """(ref: MaxCandidatesCondition)."""

    def __init__(self, n: int):
        self.n = n

    def terminate(self, runner) -> bool:
        return len(runner.results) >= self.n


class MaxTimeCondition:
    """(ref: MaxTimeCondition)."""

    def __init__(self, seconds: float):
        self.seconds = seconds

    def terminate(self, runner) -> bool:
        return (time.monotonic() - runner._start) >= self.seconds


class ScoreImprovementCondition:
    """Stop after N candidates without best-score improvement."""

    def __init__(self, patience: int):
        self.patience = patience

    def terminate(self, runner) -> bool:
        best = runner.bestResult()
        if best is None:
            return False
        since = len(runner.results) - 1 - best.candidate.index
        return since >= self.patience


@dataclass
class OptimizationConfiguration:
    """(ref: OptimizationConfiguration.Builder). ``model_builder(hp) -> model``
    and ``score_function(model, hp) -> float`` replace the reference's
    TaskCreator/ScoreFunction SPI pair; minimize_score as in the reference's
    ScoreFunction.minimize()."""
    candidate_generator: Any = None
    model_builder: Callable[[dict], Any] = None
    score_function: Callable[[Any, dict], float] = None
    termination_conditions: List[Any] = field(default_factory=list)
    minimize_score: bool = True


class OptimizationRunner:
    """(ref: LocalOptimizationRunner.execute). Sequential candidate loop —
    see package docstring for why the reference's worker pool is dropped."""

    def __init__(self, config: OptimizationConfiguration, listeners=()):
        self.config = config
        self.results: List[CandidateResult] = []
        self.listeners = list(listeners)
        self._start = None

    def execute(self) -> CandidateResult:
        cfg = self.config
        assert cfg.candidate_generator is not None
        assert cfg.termination_conditions, "at least one termination condition"
        self._start = time.monotonic()
        for i, hp in enumerate(cfg.candidate_generator):
            cand = Candidate(i, hp)
            t0 = time.monotonic()
            try:
                model = cfg.model_builder(hp)
                score = float(cfg.score_function(model, hp))
                res = CandidateResult(cand, score, time.monotonic() - t0,
                                      model=model)
            except Exception:
                res = CandidateResult(cand, None, time.monotonic() - t0,
                                      exception=traceback.format_exc())
            self.results.append(res)
            for lst in self.listeners:
                lst(res)
            if any(tc.terminate(self) for tc in cfg.termination_conditions):
                break
        best = self.bestResult()
        if best is None:
            raise RuntimeError("no candidate produced a score; last error:\n"
                               + (self.results[-1].exception or "<none>"))
        return best

    def bestResult(self) -> Optional[CandidateResult]:
        scored = [r for r in self.results if r.score is not None]
        if not scored:
            return None
        key = (min if self.config.minimize_score else max)
        return key(scored, key=lambda r: r.score)

    def numCandidatesCompleted(self) -> int:
        return len(self.results)

    def numCandidatesFailed(self) -> int:
        return sum(1 for r in self.results if r.exception is not None)
