"""n-step return computation (counterpart: ``deeplearning4j_tpu/rl/
returns.py``, copied) over vectorized rollouts — shared by the
n-step Q and A2C/A3C learners, factored pure so the terminal/truncation
semantics are unit-testable in isolation.

Semantics per stream i, step t (backwards recursion):
- terminal (``dones[t,i]``): value beyond t is 0 — the episode really ended.
- truncated (``truncs[t,i]``): the env hit a time limit and was auto-reset;
  the value beyond t is ``trunc_boot[t,i]`` = V/maxQ of the episode's FINAL
  observation. Chaining the running return here would leak the next
  episode's rewards across the reset boundary.
- otherwise: chain the running return.
The recursion seeds from ``tail_boot`` = V/maxQ of the rollout's last
next-observation per stream.
"""
from __future__ import annotations

import numpy as np


def nstep_returns(rewards: np.ndarray, dones: np.ndarray, truncs: np.ndarray,
                  tail_boot: np.ndarray, trunc_boot: np.ndarray,
                  gamma: float) -> np.ndarray:
    """All args (S, N) except tail_boot (N,); returns (S, N) float32."""
    S, N = rewards.shape
    returns = np.empty((S, N), np.float32)
    R = np.asarray(tail_boot, np.float32)
    for t in reversed(range(S)):
        vnext = np.where(dones[t], 0.0,
                         np.where(truncs[t], trunc_boot[t], R))
        R = rewards[t] + gamma * vnext
        returns[t] = R
    return returns
