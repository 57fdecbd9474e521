"""Learning-rate schedules (counterpart: ``deeplearning4j_tpu/train/
schedules.py``; ref: org.nd4j.linalg.schedule.* — ISchedule impls).

Each schedule is a dataclass serializable to JSON whose ``to_fn`` gives a
function of the step count, evaluated as optax evaluates a schedule: at
the updater's count *before* that step's increment (0 on the first step).
Counts live on the host, so each value is computed there, in the type the
reference computes it in with its 64-bit mode on (the suite's): Python
doubles, except Step, Poly and WarmupLinearDecay, whose int32 count
promotes to float32 there and here (numpy float32) — then it joins a
gradient in the gradient's dtype. ScheduleType ITERATION/EPOCH parity: the ``t``
passed in is the iteration counter; epoch-typed schedules divide by
iterations_per_epoch.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np

_f32 = np.float32


@dataclass
class Schedule:
    scheduleType: str = "ITERATION"  # or EPOCH

    def value_at(self, t):
        raise NotImplementedError

    def to_fn(self, iterations_per_epoch: int = 1):
        div = iterations_per_epoch if self.scheduleType == "EPOCH" else 1

        def fn(step):
            return self.value_at(step // div if div > 1 else step)

        return fn

    def to_dict(self):
        d = {"@type": type(self).__name__}
        d.update(self.__dict__)
        return d


@dataclass
class FixedSchedule(Schedule):
    value: float = 0.001

    def value_at(self, t):
        return self.value


@dataclass
class StepSchedule(Schedule):
    initialValue: float = 0.1
    decayRate: float = 0.5
    step: float = 10

    def value_at(self, t):
        return _f32(self.initialValue) * _f32(self.decayRate) ** np.floor(_f32(t) / _f32(self.step))


@dataclass
class ExponentialSchedule(Schedule):
    initialValue: float = 0.1
    gamma: float = 0.99

    def value_at(self, t):
        return self.initialValue * self.gamma ** float(t)


@dataclass
class InverseSchedule(Schedule):
    initialValue: float = 0.1
    gamma: float = 0.99
    power: float = 1.0

    def value_at(self, t):
        return self.initialValue / (1.0 + self.gamma * t) ** self.power


@dataclass
class PolySchedule(Schedule):
    initialValue: float = 0.1
    power: float = 2.0
    maxIter: int = 1000

    def value_at(self, t):
        frac = _f32(min(t, self.maxIter)) / _f32(self.maxIter)
        return _f32(self.initialValue) * (_f32(1.0) - frac) ** _f32(self.power)


@dataclass
class SigmoidSchedule(Schedule):
    initialValue: float = 0.1
    gamma: float = 0.99
    stepSize: int = 10

    def value_at(self, t):
        return self.initialValue / (1.0 + math.exp(-self.gamma * (t - self.stepSize)))


@dataclass
class MapSchedule(Schedule):
    values: dict = field(default_factory=dict)  # {iteration: lr}; holds until next key

    def value_at(self, t):
        keys = sorted(int(k) for k in self.values)

        def val(k):
            return self.values.get(k, self.values.get(str(k)))

        result = val(keys[0])
        for k in keys:
            if t >= k:
                result = val(k)
        return result


@dataclass
class WarmupLinearDecaySchedule(Schedule):
    """Linear warmup then linear decay (the BERT fine-tune schedule; no
    reference equivalent — the reference predates it)."""
    peakValue: float = 1e-4
    warmupSteps: int = 100
    totalSteps: int = 1000
    endValue: float = 0.0

    def value_at(self, t):
        if t < self.warmupSteps:
            return _f32(self.peakValue) * _f32(t) / _f32(max(self.warmupSteps, 1))
        frac = _f32(t - self.warmupSteps) / _f32(max(self.totalSteps - self.warmupSteps, 1))
        return _f32(self.peakValue) + _f32(self.endValue - self.peakValue) * np.clip(
            frac, _f32(0.0), _f32(1.0))


_ALL = {c.__name__: c for c in [
    FixedSchedule, StepSchedule, ExponentialSchedule, InverseSchedule, PolySchedule,
    SigmoidSchedule, MapSchedule, WarmupLinearDecaySchedule]}


def from_dict(d: dict) -> Schedule:
    d = dict(d)
    cls = _ALL[d.pop("@type")]
    return cls(**d)
