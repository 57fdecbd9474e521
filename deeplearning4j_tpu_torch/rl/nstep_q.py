"""n-step Q-learning over vectorized environments (counterpart:
``deeplearning4j_tpu/rl/nstep_q.py``; ref: org.deeplearning4j.rl4j.
learning.async.nstep.discrete.AsyncNStepQLearningDiscreteDense +
AsyncNStepQLConfiguration).

The reference's async design: ``numThreads`` workers each roll ``nStep``
transitions on a private MDP, compute gradients against a shared global
network, and apply them asynchronously. Here, as in the JAX package, the
same data flow runs synchronously: a ``VectorizedMDP`` steps N envs in
lockstep, action selection is ONE batched Q evaluation on the device, and
each rollout produces ONE update over the (N*nStep) batch, which crosses
to the device in one copy.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, List, Optional, Union

import numpy as np
import torch

from deeplearning4j_tpu_torch.rl.env import MDP
from deeplearning4j_tpu_torch.rl.qlearning import (
    clone_tree, learner_net, net_out, taken, td_loss, to_device, update_step)
from deeplearning4j_tpu_torch.rl.returns import nstep_returns
from deeplearning4j_tpu_torch.rl.vector_env import VectorizedMDP, collect_rollout


@dataclass
class AsyncQLearningConfiguration:
    """(ref: AsyncNStepQLConfiguration builder; numThreads -> numEnvs)."""
    seed: int = 0
    gamma: float = 0.99
    nStep: int = 5                  # rollout length per update
    numEnvs: int = 4                # experience-stream parallelism (ref: numThreads)
    targetDqnUpdateFreq: int = 100  # env steps between target-net syncs
    minEpsilon: float = 0.05
    epsilonNbStep: int = 1000
    maxStep: int = 5000             # total env steps across all envs
    maxEpochStep: int = 500         # per-episode cap (truncation, bootstrapped)
    errorClamp: Optional[float] = 1.0


class AsyncNStepQLearningDiscreteDense:
    """(ref: AsyncNStepQLearningDiscreteDense — class name kept for parity;
    see module docstring for the sync-vectorized redesign), on ``device``
    (default ``"cuda"``, or the given network's; without CUDA it raises
    unless ``device="cpu"``)."""

    def __init__(self, mdp_fn: Union[Callable[[], MDP], VectorizedMDP],
                 net_conf, config: AsyncQLearningConfiguration, device=None):
        self.config = config
        if isinstance(mdp_fn, VectorizedMDP):
            self.venv = mdp_fn
        elif callable(mdp_fn) and not isinstance(mdp_fn, MDP):
            self.venv = VectorizedMDP([mdp_fn for _ in range(config.numEnvs)])
        else:
            raise ValueError("pass an env factory (lambda: MyMDP()) or a "
                             "VectorizedMDP, not a single MDP instance")
        self.net = learner_net(net_conf, device)
        self.device = self.net.device
        self._params = self.net._params
        self._target = clone_tree(self._params)
        self._net_state = self.net._state
        self._tx = self.net.conf.updater.to_transform()
        self._opt_state = self._tx.init(self._params)
        self.rng = np.random.RandomState(config.seed)
        self.episode_rewards: List[float] = []
        self._steps = 0      # total env steps (all envs)
        self._eps_steps = 0  # epsilon-annealing counter (advances per selection)

    # ---------------------------------------------------------------- step
    def _q_fn(self, params, obs):
        return net_out(self.net, params, obs)

    def _q_host(self, params, obs: np.ndarray) -> np.ndarray:
        with torch.no_grad():
            q = self._q_fn(params, torch.from_numpy(
                np.ascontiguousarray(obs, np.float32)).to(self.device))
        return q.cpu().numpy()

    def _update_fn(self, params, opt_state, obs, actions, returns):
        cfg = self.config

        def loss_fn(p):
            return td_loss(taken(self._q_fn(p, obs), actions), returns,
                           cfg.errorClamp)

        return update_step(self._tx, loss_fn, params, opt_state)

    # ------------------------------------------------------------ training
    def _epsilon(self) -> float:
        # annealed on its own per-selection counter so the schedule advances
        # every vector step, not once per rollout (self._steps updates only
        # after collect_rollout returns)
        frac = min(self._eps_steps / max(self.config.epsilonNbStep, 1), 1.0)
        return 1.0 + (self.config.minEpsilon - 1.0) * frac

    def _select_actions(self, obs: np.ndarray) -> np.ndarray:
        """Batched eps-greedy: ONE device call scores all envs."""
        q = self._q_host(self._params, obs)
        greedy = q.argmax(-1)
        explore = self.rng.rand(len(obs)) < self._epsilon()
        self._eps_steps += len(obs)
        randoms = self.rng.randint(self.venv.n_actions, size=len(obs))
        return np.where(explore, randoms, greedy).astype(np.int64)

    def train(self) -> List[float]:
        cfg = self.config
        N, S = self.venv.num_envs, cfg.nStep
        obs = self.venv.reset()
        last_sync = 0
        while self._steps < cfg.maxStep:
            obs, ro, ra, rr, rd, rtrunc, tobs = collect_rollout(
                self.venv, obs, self._select_actions, S, cfg.maxEpochStep,
                self.episode_rewards)
            self._steps += S * N
            # ---- n-step bootstrapped returns per env (one batched target
            # eval for the rollout tail + every truncation point)
            boot = self._q_host(self._target, obs).max(-1)
            if rtrunc.any():
                qtrunc = self._q_host(self._target, tobs.reshape(S * N, -1)
                                      ).max(-1).reshape(S, N)
            else:  # no truncation this rollout — skip the masked-out eval
                qtrunc = np.zeros((S, N), np.float32)
            returns = nstep_returns(rr, rd, rtrunc, boot, qtrunc, cfg.gamma)
            # ---- one update over the (S*N) batch
            self._params, self._opt_state, _ = self._update_fn(
                self._params, self._opt_state,
                *to_device(self.device, ro.reshape(S * N, -1),
                           ra.reshape(S * N).astype(np.int32),
                           returns.reshape(S * N)))
            if self._steps - last_sync >= cfg.targetDqnUpdateFreq:
                self._target = clone_tree(self._params)
                last_sync = self._steps
        self.net._params = self._params
        return self.episode_rewards

    def q_values(self, obs: np.ndarray) -> np.ndarray:
        return self._q_host(self._params, np.asarray(obs)[None])[0]

    def play(self, max_steps: Optional[int] = None) -> float:
        """One greedy episode on a fresh single env."""
        env = self.venv.envs[0]
        obs = env.reset()
        total, steps = 0.0, 0
        cap = max_steps or self.config.maxEpochStep
        while steps < cap:
            obs, reward, done, _ = env.step(int(np.argmax(self.q_values(obs))))
            total += reward
            steps += 1
            if done:
                break
        return total
