"""Deep Q-learning (counterpart: ``deeplearning4j_tpu/rl/qlearning.py``;
ref: org.deeplearning4j.rl4j.learning.sync.qlearning.discrete.
QLearningDiscreteDense + QLearning.QLConfiguration).

The Q-network is the port's ``MultiLayerNetwork`` layer stack applied to
a parameter tree (params in, Q out); the target network is a cloned
tree. One update computes the TD targets without gradient (double-DQN or
vanilla), gathers the taken-action Q, takes autograd's gradient of the
clamped loss and applies the network's updater (``to_transform``:
optax's arithmetic), all on the learner's device. A replay batch crosses
to the device in one copy; one forward of one row chooses each action.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import numpy as np
import torch

from deeplearning4j_tpu_torch import default_device
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.rl.env import MDP
from deeplearning4j_tpu_torch.rl.policy import EpsGreedy, GreedyPolicy
from deeplearning4j_tpu_torch.rl.replay import ExpReplay, Transition
from deeplearning4j_tpu_torch.text.word2vec import _to_device
from deeplearning4j_tpu_torch.train.updaters import (
    apply_updates, tree_leaves, tree_map, tree_unflatten)


# ----------------------------------------------------- shared by learners


def learner_net(conf, device) -> MultiLayerNetwork:
    """The network a learner trains: ``conf`` itself when it is a network
    (``device``, if given, must be its device), else a new one built and
    initialized on ``device``."""
    if isinstance(conf, MultiLayerNetwork):
        if device is not None and default_device(device) != conf.device:
            raise ValueError(f"the network is on {conf.device}, not {device}")
        return conf
    return MultiLayerNetwork(conf, device=device).init()


def net_out(net: MultiLayerNetwork, params, obs: torch.Tensor) -> torch.Tensor:
    """The network's inference output for ``params``."""
    out, _, _ = net._forward(params, net._state, obs, training=False, rng=None)
    return out


def clone_tree(tree):
    return tree_map(lambda t: t.detach().clone(), tree)


def to_device(device, *cols: np.ndarray) -> List[torch.Tensor]:
    """Host columns (each (B,) or (B, F)) to ``device`` in one float32
    copy, split there; integer columns (actions) come back as int64."""
    flat = [np.asarray(c).reshape(len(c), -1) for c in cols]
    packed = _to_device(np.concatenate([f.astype(np.float32) for f in flat], axis=1),
                        device, dtype=np.float32)
    out, lo = [], 0
    for c, f in zip(cols, flat):
        part = packed[:, lo:lo + f.shape[1]]
        lo += f.shape[1]
        part = part if np.asarray(c).ndim > 1 else part[:, 0]
        out.append(part.long() if np.issubdtype(np.asarray(c).dtype, np.integer)
                   else part)
    return out


def update_step(tx, loss_fn, params, opt_state):
    """(params, opt_state, loss) after one step of ``tx`` on autograd's
    gradient of ``loss_fn(params)``."""
    live = tree_map(lambda p: p.detach().requires_grad_(), params)
    leaves = tree_leaves(live)
    loss = loss_fn(live)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = tree_unflatten(params, [torch.zeros_like(l) if g is None else g
                                    for l, g in zip(leaves, grads)])
    with torch.no_grad():
        updates, opt_state = tx.update(grads, opt_state, params)
        params = apply_updates(params, updates)
    return params, opt_state, loss.detach()


def td_loss(q_sel, target, clamp: Optional[float]):
    """Mean squared TD error, or huber: quadratic within the clamp, linear
    outside (ref: errorClamp)."""
    err = q_sel - target
    if clamp is None:
        return torch.mean(err ** 2)
    ae = torch.abs(err)
    return torch.mean(torch.where(ae <= clamp, 0.5 * err ** 2,
                                  clamp * (ae - 0.5 * clamp)))


def taken(q, actions):
    """q[i, actions[i]] (``take_along_axis``)."""
    return torch.take_along_dim(q, actions[:, None], dim=-1)[:, 0]


# ------------------------------------------------------------------- DQN


@dataclass
class QLearningConfiguration:
    """(ref: QLearning.QLConfiguration builder)."""
    seed: int = 0
    gamma: float = 0.99
    batchSize: int = 32
    expRepMaxSize: int = 10000
    targetDqnUpdateFreq: int = 100
    updateStart: int = 64          # env steps before learning begins
    trainFreq: int = 1             # learn every N env steps
    doubleDQN: bool = True
    minEpsilon: float = 0.05
    epsilonNbStep: int = 1000
    maxStep: int = 5000            # total env steps
    maxEpochStep: int = 500        # per-episode cap
    errorClamp: Optional[float] = 1.0  # huber-style TD clamp (ref: errorClamp)


class QLearningDiscreteDense:
    """(ref: QLearningDiscreteDense — dense-observation discrete-action
    DQN), on ``device`` (default ``"cuda"``, or the given network's;
    without CUDA it raises unless ``device="cpu"``)."""

    def __init__(self, mdp: MDP, net_conf, config: QLearningConfiguration,
                 device=None):
        self.mdp = mdp
        self.config = config
        self.net = learner_net(net_conf, device)
        self.device = self.net.device
        self._params = self.net._params
        self._target = clone_tree(self._params)
        self._state = self.net._state
        self._tx = self.net.conf.updater.to_transform()
        self._opt_state = self._tx.init(self._params)
        self.replay = ExpReplay(config.expRepMaxSize, mdp.obs_size,
                                seed=config.seed)
        self.policy = EpsGreedy(config.minEpsilon, config.epsilonNbStep,
                                seed=config.seed)
        self.episode_rewards: List[float] = []
        self._steps = 0

    # ---------------------------------------------------------------- step
    def _q_fn(self, params, obs):
        return net_out(self.net, params, obs)

    def _update_fn(self, params, target, opt_state, obs, actions, rewards,
                   next_obs, dones):
        """One DQN update from device tensors; (params, opt_state, loss)."""
        cfg = self.config
        with torch.no_grad():
            q_next_target = self._q_fn(target, next_obs)
            if cfg.doubleDQN:
                # online net picks the argmax (first of ties), target net
                # evaluates it
                sel = torch.argmax(self._q_fn(params, next_obs), dim=-1)
                q_next = taken(q_next_target, sel)
            else:
                q_next = q_next_target.max(-1).values
            td_target = rewards + cfg.gamma * q_next * (1.0 - dones)

        def loss_fn(p):
            return td_loss(taken(self._q_fn(p, obs), actions), td_target,
                           cfg.errorClamp)

        return update_step(self._tx, loss_fn, params, opt_state)

    def _update(self, batch):
        """One update from a replay sample (host arrays)."""
        self._params, self._opt_state, loss = self._update_fn(
            self._params, self._target, self._opt_state,
            *to_device(self.device, *batch))
        return loss

    # ------------------------------------------------------------ training
    def q_values(self, obs: np.ndarray) -> np.ndarray:
        with torch.no_grad():
            q = self._q_fn(self._params,
                           torch.from_numpy(np.asarray(obs)[None]).to(self.device))
        return q.cpu().numpy()[0]

    def train(self) -> List[float]:
        """Run until maxStep env steps; returns per-episode rewards
        (ref: ILearning.train + TrainingListener loop)."""
        cfg = self.config
        while self._steps < cfg.maxStep:
            obs = self.mdp.reset()
            ep_reward, ep_steps = 0.0, 0
            while True:
                action = self.policy.select(self.q_values(obs))
                next_obs, reward, done, _ = self.mdp.step(action)
                self.replay.store(Transition(obs, action, reward, next_obs, done))
                obs = next_obs
                ep_reward += reward
                ep_steps += 1
                self._steps += 1
                if (len(self.replay) >= max(cfg.updateStart, cfg.batchSize)
                        and self._steps % cfg.trainFreq == 0):
                    self._update(self.replay.sample(cfg.batchSize))
                if self._steps % cfg.targetDqnUpdateFreq == 0:
                    self._target = clone_tree(self._params)
                if done or ep_steps >= cfg.maxEpochStep or self._steps >= cfg.maxStep:
                    break
            self.episode_rewards.append(ep_reward)
        self.net._params = self._params  # expose learned weights on the net
        return self.episode_rewards

    def getPolicy(self) -> GreedyPolicy:
        return GreedyPolicy()

    def play(self, max_steps: Optional[int] = None) -> float:
        """One greedy episode (ref: Policy.play)."""
        obs = self.mdp.reset()
        total, steps = 0.0, 0
        cap = max_steps or self.config.maxEpochStep
        while steps < cap:
            action = int(np.argmax(self.q_values(obs)))
            obs, reward, done, _ = self.mdp.step(action)
            total += reward
            steps += 1
            if done:
                break
        return total
