"""Environment SPI + builtin test environments (counterpart: ``deeplearning4j_tpu/rl/env.py``, copied;
ref: rl4j-api MDP interface
and rl4j-gym's Box/Discrete spaces; gym need not be installed,
so the classic-control CartPole dynamics are implemented directly from the
public equations of motion — the same ones rl4j's gym-java-client drives)."""
from __future__ import annotations

from typing import Any, Optional, Tuple

import numpy as np


class MDP:
    """(ref: org.deeplearning4j.rl4j.mdp.MDP). step returns
    (observation, reward, done, info)."""

    obs_size: int
    n_actions: int

    def reset(self) -> np.ndarray:
        raise NotImplementedError

    def step(self, action: int) -> Tuple[np.ndarray, float, bool, dict]:
        raise NotImplementedError

    def close(self):
        pass


class ChainMDP(MDP):
    """Deterministic n-state chain: actions {0: left, 1: right}; reward 1 at
    the right end, 0.01 at the left end (the classic exploration testbed —
    optimal policy always goes right). Episode ends after ``horizon`` steps.
    Observations are one-hot state encodings."""

    def __init__(self, n_states: int = 6, horizon: int = 20):
        self.n = n_states
        self.horizon = horizon
        self.obs_size = n_states
        self.n_actions = 2
        self._s = 0
        self._t = 0

    def _obs(self):
        o = np.zeros(self.n, np.float32)
        o[self._s] = 1.0
        return o

    def reset(self):
        self._s = 1
        self._t = 0
        return self._obs()

    def step(self, action):
        self._t += 1
        if action == 1:
            self._s = min(self._s + 1, self.n - 1)
        else:
            self._s = max(self._s - 1, 0)
        reward = 1.0 if self._s == self.n - 1 else (0.01 if self._s == 0 else 0.0)
        done = self._t >= self.horizon
        return self._obs(), reward, done, {}


class CartPole(MDP):
    """Classic-control cart-pole balance (public dynamics: Barto, Sutton &
    Anderson 1983 as used by gym CartPole-v1). Reward 1 per step until the
    pole falls or 500 steps elapse."""

    def __init__(self, seed: int = 0, max_steps: int = 500):
        self.rng = np.random.RandomState(seed)
        self.obs_size = 4
        self.n_actions = 2
        self.max_steps = max_steps
        self.gravity = 9.8
        self.masscart = 1.0
        self.masspole = 0.1
        self.length = 0.5  # half pole length
        self.force_mag = 10.0
        self.tau = 0.02
        self.theta_limit = 12 * 2 * np.pi / 360
        self.x_limit = 2.4
        self._state: Optional[np.ndarray] = None
        self._t = 0

    def reset(self):
        self._state = self.rng.uniform(-0.05, 0.05, 4).astype(np.float32)
        self._t = 0
        return self._state.copy()

    def step(self, action):
        x, x_dot, theta, theta_dot = self._state
        force = self.force_mag if action == 1 else -self.force_mag
        costheta, sintheta = np.cos(theta), np.sin(theta)
        total_mass = self.masscart + self.masspole
        polemass_length = self.masspole * self.length
        temp = (force + polemass_length * theta_dot ** 2 * sintheta) / total_mass
        thetaacc = (self.gravity * sintheta - costheta * temp) / (
            self.length * (4.0 / 3.0 - self.masspole * costheta ** 2 / total_mass))
        xacc = temp - polemass_length * thetaacc * costheta / total_mass
        x = x + self.tau * x_dot
        x_dot = x_dot + self.tau * xacc
        theta = theta + self.tau * theta_dot
        theta_dot = theta_dot + self.tau * thetaacc
        self._state = np.array([x, x_dot, theta, theta_dot], np.float32)
        self._t += 1
        done = bool(abs(x) > self.x_limit or abs(theta) > self.theta_limit
                    or self._t >= self.max_steps)
        return self._state.copy(), 1.0, done, {}


class MountainCar(MDP):
    """Classic-control mountain car (ref: rl4j-gym MountainCar-v0 binding;
    dynamics from the public equations — Moore 1990): position in
    [-1.2, 0.6], velocity in [-0.07, 0.07], actions {0: left, 1: idle,
    2: right}, reward -1 per step until the goal at x >= 0.5."""

    def __init__(self, horizon: int = 200, seed: int = 0):
        self.obs_size = 2
        self.n_actions = 3
        self.horizon = horizon
        self._rng = np.random.default_rng(seed)
        self._s = np.zeros(2, np.float32)
        self._t = 0

    def reset(self):
        self._s = np.array([self._rng.uniform(-0.6, -0.4), 0.0], np.float32)
        self._t = 0
        return self._s.copy()

    def step(self, action: int):
        pos, vel = float(self._s[0]), float(self._s[1])
        vel += (action - 1) * 0.001 + np.cos(3 * pos) * (-0.0025)
        vel = float(np.clip(vel, -0.07, 0.07))
        pos = float(np.clip(pos + vel, -1.2, 0.6))
        if pos <= -1.2:
            vel = 0.0
        self._s = np.array([pos, vel], np.float32)
        self._t += 1
        done = pos >= 0.5 or self._t >= self.horizon
        return self._s.copy(), -1.0, done, {}


class GymEnvAdapter(MDP):
    """Adapter over a gymnasium/gym environment (ref: rl4j-gym's GymEnv via
    gym-java-client). Gated: neither package ships in this image, so
    construction raises with instructions unless one is importable; the
    adapter itself handles both the 5-tuple (gymnasium) and 4-tuple (legacy
    gym) step signatures."""

    def __init__(self, env_id: str, **make_kwargs):
        gym = None
        for mod in ("gymnasium", "gym"):
            try:
                gym = __import__(mod)
                break
            except ImportError:
                continue
        if gym is None:
            raise ImportError(
                "GymEnvAdapter needs gymnasium or gym (neither is installed "
                "in this environment); use the built-in CartPole/MountainCar/"
                "ChainMDP envs instead")
        self._env = gym.make(env_id, **make_kwargs)
        self.obs_size = int(np.prod(self._env.observation_space.shape))
        self.n_actions = int(self._env.action_space.n)

    def reset(self):
        out = self._env.reset()
        obs = out[0] if isinstance(out, tuple) else out
        return np.asarray(obs, np.float32).ravel()

    def step(self, action: int):
        out = self._env.step(int(action))
        if len(out) == 5:  # gymnasium: obs, reward, terminated, truncated, info
            obs, r, term, trunc, info = out
            done = bool(term or trunc)
        else:              # legacy gym: obs, reward, done, info
            obs, r, done, info = out
        return np.asarray(obs, np.float32).ravel(), float(r), done, info

    def close(self):
        self._env.close()
