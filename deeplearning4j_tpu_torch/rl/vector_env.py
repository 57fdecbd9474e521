"""Vectorized environment execution (counterpart: ``deeplearning4j_tpu/rl/
vector_env.py``, copied; the stand-in for rl4j's async worker threads —
ref: org.deeplearning4j.rl4j.learning.async.AsyncLearning + AsyncThread,
where N threads each own an MDP instance and race gradients into a shared
global network).

The redesign inverts control: N MDP instances step in lockstep on the
host while ONE network evaluates/updates over the whole (N, obs) batch on
the device — same experience parallelism, no gradient staleness, and each
network call is one batched call instead of N racing ones.
"""
from __future__ import annotations

from typing import Callable, List, Sequence, Tuple

import numpy as np

from deeplearning4j_tpu_torch.rl.env import MDP


class VectorizedMDP:
    """Steps N independent MDP instances as one batched environment.

    Auto-reset semantics (the standard vector-env contract): when instance i
    finishes an episode, ``step`` returns ``done[i]=True`` with the FRESH
    reset observation in ``obs[i]``, and the finished episode's total reward
    in ``infos[i]["episode_reward"]``.
    """

    def __init__(self, env_fns: Sequence[Callable[[], MDP]]):
        if not env_fns:
            raise ValueError("need at least one env factory")
        self.envs: List[MDP] = [fn() for fn in env_fns]
        self.num_envs = len(self.envs)
        self.obs_size = self.envs[0].obs_size
        self.n_actions = self.envs[0].n_actions
        self._ep_reward = np.zeros(self.num_envs, np.float64)
        self._ep_steps = np.zeros(self.num_envs, np.int64)

    def reset(self) -> np.ndarray:
        self._ep_reward[:] = 0.0
        self._ep_steps[:] = 0
        return np.stack([e.reset() for e in self.envs]).astype(np.float32)

    def step(self, actions: Sequence[int], max_episode_steps: int = 0
             ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, List[dict]]:
        """actions: one int per env. ``max_episode_steps`` > 0 additionally
        truncates episodes (reported via info["truncated"], done stays the
        env's own signal so learners can bootstrap through time limits)."""
        obs = np.empty((self.num_envs, self.obs_size), np.float32)
        rewards = np.zeros(self.num_envs, np.float32)
        dones = np.zeros(self.num_envs, bool)
        infos: List[dict] = [{} for _ in range(self.num_envs)]
        for i, (env, a) in enumerate(zip(self.envs, actions)):
            o, r, d, info = env.step(int(a))
            rewards[i] = r
            self._ep_reward[i] += r
            self._ep_steps[i] += 1
            truncated = bool(max_episode_steps
                             and self._ep_steps[i] >= max_episode_steps)
            if d or truncated:
                # final_obs: the episode's true last observation — learners
                # must bootstrap from THIS on truncation, never from the
                # fresh reset obs returned in obs[i]
                infos[i] = dict(info, episode_reward=float(self._ep_reward[i]),
                                episode_steps=int(self._ep_steps[i]),
                                truncated=truncated and not d,
                                final_obs=np.asarray(o, np.float32))
                self._ep_reward[i] = 0.0
                self._ep_steps[i] = 0
                o = env.reset()
            dones[i] = d
            obs[i] = o
        return obs, rewards, dones, infos

    def close(self):
        for e in self.envs:
            e.close()


def collect_rollout(venv: VectorizedMDP, obs: np.ndarray, select_actions,
                    n_steps: int, max_episode_steps: int,
                    episode_rewards: list):
    """Run ``n_steps`` lockstep vector steps (shared by the n-step Q and
    A2C/A3C learners so their terminal/truncation bookkeeping cannot drift).

    ``select_actions(obs) -> (N,) actions``. Completed-episode rewards are
    appended to ``episode_rewards``. Returns
    ``(obs, ro, ra, rr, rd, rtrunc, tobs)`` where ``rtrunc``/``tobs`` mark
    truncated streams and their pre-reset final observations (see
    returns.nstep_returns for why the chain must break there).
    """
    S, N = n_steps, venv.num_envs
    ro = np.empty((S, N, venv.obs_size), np.float32)
    ra = np.empty((S, N), np.int64)
    rr = np.empty((S, N), np.float32)
    rd = np.empty((S, N), bool)
    rtrunc = np.zeros((S, N), bool)
    tobs = np.zeros((S, N, venv.obs_size), np.float32)
    for t in range(S):
        actions = select_actions(obs)
        ro[t], ra[t] = obs, actions
        obs, rr[t], rd[t], infos = venv.step(
            actions, max_episode_steps=max_episode_steps)
        for i, info in enumerate(infos):
            if "episode_reward" in info:
                episode_rewards.append(info["episode_reward"])
            if info.get("truncated"):
                rtrunc[t, i] = True
                tobs[t, i] = info["final_obs"]
    return obs, ro, ra, rr, rd, rtrunc, tobs
