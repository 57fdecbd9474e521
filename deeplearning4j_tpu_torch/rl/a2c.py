"""Advantage actor-critic (counterpart: ``deeplearning4j_tpu/rl/a2c.py``;
ref: org.deeplearning4j.rl4j.learning.async.a3c.discrete.A3CDiscreteDense —
the synchronous-batch equivalent: rl4j's async workers exist to
parallelize CPU gradient computation, which one batched update on the
device makes unnecessary).

One update: n-step returns on the host, then on the learner's device the
advantage (without gradient), the policy-gradient loss with entropy bonus
and the value MSE — both heads updated together by the policy network's
updater over ``{"pi", "v"}``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List

import numpy as np
import torch

from deeplearning4j_tpu_torch.rl.env import MDP
from deeplearning4j_tpu_torch.rl.qlearning import (
    learner_net, net_out, taken, to_device, update_step)
from deeplearning4j_tpu_torch.rl.returns import nstep_returns
from deeplearning4j_tpu_torch.rl.vector_env import VectorizedMDP, collect_rollout


@dataclass
class A2CConfiguration:
    """(ref: A3CConfiguration builder; numThreads -> numEnvs)."""
    seed: int = 0
    gamma: float = 0.99
    nStep: int = 32                # rollout length per update
    entropyCoef: float = 0.01
    valueCoef: float = 0.5
    maxStep: int = 5000
    maxEpochStep: int = 500
    numEnvs: int = 1               # >1: lockstep vectorized rollouts (the
                                   # sync stand-in for A3C's worker threads)


class A2CDiscreteDense:
    """Policy net (softmax over actions) + value net (scalar), both dense
    layer stacks from the nn config DSL, on ``device`` (default
    ``"cuda"``, or the given networks'; without CUDA it raises unless
    ``device="cpu"``)."""

    def __init__(self, mdp, policy_conf, value_conf, config: A2CConfiguration,
                 device=None):
        """``mdp``: an MDP instance (numEnvs=1), or an env factory callable /
        VectorizedMDP when config.numEnvs > 1."""
        self.config = config
        self.venv = None
        if config.numEnvs > 1:
            if isinstance(mdp, VectorizedMDP):
                self.venv = mdp
            elif callable(mdp) and not isinstance(mdp, MDP):
                self.venv = VectorizedMDP([mdp for _ in range(config.numEnvs)])
            else:
                raise ValueError("numEnvs > 1 needs an env factory or "
                                 "VectorizedMDP, not a single MDP instance")
            self.mdp = self.venv.envs[0]
        else:
            self.mdp = mdp() if (callable(mdp) and not isinstance(mdp, MDP)) else mdp
        self.pi_net = learner_net(policy_conf, device)
        self.v_net = learner_net(value_conf, device)
        if self.v_net.device != self.pi_net.device:
            raise ValueError(f"the policy network is on {self.pi_net.device}, "
                             f"the value network on {self.v_net.device}")
        self.device = self.pi_net.device
        self._pi = self.pi_net._params
        self._v = self.v_net._params
        self._tx = self.pi_net.conf.updater.to_transform()
        self._opt = self._tx.init({"pi": self._pi, "v": self._v})
        self.rng = np.random.RandomState(config.seed)
        self.episode_rewards: List[float] = []
        self._steps = 0

    def _probs_fn(self, pi_params, obs):
        return net_out(self.pi_net, pi_params, obs)

    def _value_fn(self, v_params, obs):
        return net_out(self.v_net, v_params, obs)[:, 0]

    def _host(self, fn, params, obs: np.ndarray) -> np.ndarray:
        with torch.no_grad():
            out = fn(params, torch.from_numpy(
                np.ascontiguousarray(obs, np.float32)).to(self.device))
        return out.cpu().numpy()

    def _update_fn(self, params, opt_state, obs, actions, returns):
        cfg = self.config

        def loss_fn(p):
            probs = self._probs_fn(p["pi"], obs)
            logp = torch.log(torch.clamp(probs, min=1e-8))
            values = self._value_fn(p["v"], obs)
            adv = (returns - values).detach()
            sel_logp = taken(logp, actions)
            policy_loss = -torch.mean(sel_logp * adv)
            entropy = -torch.mean(torch.sum(probs * logp, -1))
            value_loss = torch.mean((returns - values) ** 2)
            return (policy_loss + cfg.valueCoef * value_loss
                    - cfg.entropyCoef * entropy)

        return update_step(self._tx, loss_fn, params, opt_state)

    def _update(self, obs, actions, returns):
        params, self._opt, loss = self._update_fn(
            {"pi": self._pi, "v": self._v}, self._opt,
            *to_device(self.device, obs, actions, returns))
        self._pi, self._v = params["pi"], params["v"]
        return loss

    def action_probs(self, obs: np.ndarray) -> np.ndarray:
        return self._host(self._probs_fn, self._pi, np.asarray(obs)[None])[0]

    def train(self) -> List[float]:
        if self.venv is not None:
            return self._train_vectorized()
        cfg = self.config
        obs = self.mdp.reset()
        ep_reward, ep_steps = 0.0, 0
        buf_obs, buf_act, buf_rew, buf_done = [], [], [], []
        while self._steps < cfg.maxStep:
            p = self.action_probs(obs)
            action = int(self.rng.choice(len(p), p=p / p.sum()))
            next_obs, reward, done, _ = self.mdp.step(action)
            buf_obs.append(obs); buf_act.append(action)
            buf_rew.append(reward); buf_done.append(done)
            obs = next_obs
            ep_reward += reward
            ep_steps += 1
            self._steps += 1
            episode_over = done or ep_steps >= cfg.maxEpochStep
            if len(buf_obs) >= cfg.nStep or episode_over:
                # n-step discounted returns, bootstrapped from V(s_T).
                # Time-limit truncation is NOT a terminal: bootstrap there
                # too, else the value head trains toward 0 exactly where the
                # agent survives longest
                if done:
                    boot = 0.0
                else:
                    boot = float(self._host(self._value_fn, self._v,
                                            np.asarray(obs)[None])[0])
                R = boot
                returns = np.zeros(len(buf_rew), np.float32)
                for i in reversed(range(len(buf_rew))):
                    R = buf_rew[i] + cfg.gamma * R * (1.0 - float(buf_done[i]))
                    returns[i] = R
                self._update(np.stack(buf_obs), np.array(buf_act, np.int32),
                             returns)
                buf_obs, buf_act, buf_rew, buf_done = [], [], [], []
            if episode_over:
                self.episode_rewards.append(ep_reward)
                obs = self.mdp.reset()
                ep_reward, ep_steps = 0.0, 0
        self.pi_net._params = self._pi
        self.v_net._params = self._v
        return self.episode_rewards

    def _train_vectorized(self) -> List[float]:
        """Lockstep N-env rollouts (ref: A3C's numThreads workers — same
        experience parallelism, one batched policy eval + one update per
        rollout instead of N async racing gradients)."""
        cfg = self.config
        N, S = self.venv.num_envs, cfg.nStep
        obs = self.venv.reset()

        def select_actions(o):
            probs = self._host(self._probs_fn, self._pi, o)
            probs = probs / probs.sum(-1, keepdims=True)
            # per-env categorical sample via inverse-CDF (one rand per env)
            cdf = probs.cumsum(-1)
            u = self.rng.rand(N, 1)
            return (u > cdf[:, :-1]).sum(-1)

        while self._steps < cfg.maxStep:
            obs, ro, ra, rr, rd, rtrunc, tobs = collect_rollout(
                self.venv, obs, select_actions, S, cfg.maxEpochStep,
                self.episode_rewards)
            self._steps += S * N
            # bootstrap: V(s_T) at the rollout tail, 0 at terminals,
            # V(final_obs) at truncation points
            boot = self._host(self._value_fn, self._v, obs)
            if rtrunc.any():
                vtrunc = self._host(self._value_fn, self._v,
                                    tobs.reshape(S * N, -1)).reshape(S, N)
            else:  # no truncation this rollout — skip the masked-out eval
                vtrunc = np.zeros((S, N), np.float32)
            returns = nstep_returns(rr, rd, rtrunc, boot, vtrunc, cfg.gamma)
            self._update(ro.reshape(S * N, -1),
                         ra.reshape(S * N).astype(np.int32),
                         returns.reshape(S * N))
        self.pi_net._params = self._pi
        self.v_net._params = self._v
        return self.episode_rewards

    def play(self, max_steps=None) -> float:
        obs = self.mdp.reset()
        total, steps = 0.0, 0
        cap = max_steps or self.config.maxEpochStep
        while steps < cap:
            action = int(np.argmax(self.action_probs(obs)))
            obs, reward, done, _ = self.mdp.step(action)
            total += reward
            steps += 1
            if done:
                break
        return total
