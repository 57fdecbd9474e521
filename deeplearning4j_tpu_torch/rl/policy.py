"""Action-selection policies (counterpart: ``deeplearning4j_tpu/rl/policy.py``, copied;
ref: org.deeplearning4j.rl4j.policy —
EpsGreedy, Policy/ACPolicy, BoltzmannQ)."""
from __future__ import annotations

import numpy as np


class GreedyPolicy:
    """argmax-Q (ref: DQNPolicy)."""

    def select(self, q_values: np.ndarray, rng=None) -> int:
        return int(np.argmax(q_values))


class EpsGreedy:
    """Annealed epsilon-greedy (ref: rl4j EpsGreedy: epsilon decays linearly
    from 1.0 to minEpsilon over epsilonNbStep steps)."""

    def __init__(self, min_epsilon: float = 0.05, anneal_steps: int = 1000,
                 seed: int = 0):
        self.min_epsilon = min_epsilon
        self.anneal_steps = max(anneal_steps, 1)
        self.rng = np.random.RandomState(seed)
        self._step = 0

    @property
    def epsilon(self) -> float:
        frac = min(self._step / self.anneal_steps, 1.0)
        return 1.0 + (self.min_epsilon - 1.0) * frac

    def select(self, q_values: np.ndarray, rng=None) -> int:
        eps = self.epsilon
        self._step += 1
        if self.rng.rand() < eps:
            return int(self.rng.randint(len(q_values)))
        return int(np.argmax(q_values))


class BoltzmannPolicy:
    """Softmax-over-Q sampling (ref: BoltzmannQ)."""

    def __init__(self, temperature: float = 1.0, seed: int = 0):
        self.temperature = temperature
        self.rng = np.random.RandomState(seed)

    def select(self, q_values: np.ndarray, rng=None) -> int:
        z = q_values / max(self.temperature, 1e-8)
        z = z - z.max()
        p = np.exp(z)
        p /= p.sum()
        return int(self.rng.choice(len(q_values), p=p))
