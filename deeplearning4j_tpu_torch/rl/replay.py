"""Experience replay (counterpart: ``deeplearning4j_tpu/rl/replay.py``, copied;
ref: org.deeplearning4j.rl4j.learning.sync.ExpReplay —
circular buffer + uniform minibatch sampling). Storage is preallocated numpy
rings (no per-transition objects); sampling returns contiguous arrays ready
to become one device batch."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np


@dataclass
class Transition:
    """(ref: rl4j Transition)."""
    observation: np.ndarray
    action: int
    reward: float
    next_observation: np.ndarray
    done: bool


class ExpReplay:
    def __init__(self, max_size: int, obs_size: int, seed: int = 0):
        self.max_size = max_size
        self.obs = np.zeros((max_size, obs_size), np.float32)
        self.next_obs = np.zeros((max_size, obs_size), np.float32)
        self.actions = np.zeros(max_size, np.int32)
        self.rewards = np.zeros(max_size, np.float32)
        self.dones = np.zeros(max_size, np.float32)
        self._idx = 0
        self._size = 0
        self.rng = np.random.RandomState(seed)

    def store(self, t: Transition):
        i = self._idx
        self.obs[i] = t.observation
        self.next_obs[i] = t.next_observation
        self.actions[i] = t.action
        self.rewards[i] = t.reward
        self.dones[i] = float(t.done)
        self._idx = (i + 1) % self.max_size
        self._size = min(self._size + 1, self.max_size)

    def __len__(self) -> int:
        return self._size

    def sample(self, batch_size: int) -> Tuple[np.ndarray, ...]:
        idx = self.rng.randint(0, self._size, batch_size)
        return (self.obs[idx], self.actions[idx], self.rewards[idx],
                self.next_obs[idx], self.dones[idx])
