"""Reinforcement learning (counterpart: ``deeplearning4j_tpu/rl``; ref:
rl4j — rl4j-core's QLearningDiscreteDense / A3CDiscreteDense, ExpReplay,
EpsGreedy policies, MDP SPI).

The environment SPI stays host-side Python (gym-shaped), while every
learning update — TD targets, double-DQN argmax/gather, advantage
actor-critic — is one forward, autograd backward and updater step over the
port's ``MultiLayerNetwork`` layers on the learner's device (``device``:
``"cuda"`` unless the caller passes ``"cpu"``). Replay sampling is
vectorized numpy; a batch crosses to the device in one copy.
"""
from deeplearning4j_tpu_torch.rl.env import MDP, CartPole, ChainMDP, MountainCar, GymEnvAdapter
from deeplearning4j_tpu_torch.rl.replay import ExpReplay, Transition
from deeplearning4j_tpu_torch.rl.policy import BoltzmannPolicy, EpsGreedy, GreedyPolicy
from deeplearning4j_tpu_torch.rl.qlearning import QLearningConfiguration, QLearningDiscreteDense
from deeplearning4j_tpu_torch.rl.a2c import A2CConfiguration, A2CDiscreteDense
from deeplearning4j_tpu_torch.rl.vector_env import VectorizedMDP
from deeplearning4j_tpu_torch.rl.nstep_q import (
    AsyncNStepQLearningDiscreteDense, AsyncQLearningConfiguration)

# A3C parity name (ref: A3CDiscreteDense): the vectorized-sync A2C with
# numEnvs > 1 carries the same N experience streams minus gradient staleness.
A3CDiscreteDense = A2CDiscreteDense
A3CConfiguration = A2CConfiguration

__all__ = [
    "MDP", "CartPole", "ChainMDP", "MountainCar", "GymEnvAdapter",
    "ExpReplay", "Transition",
    "EpsGreedy", "GreedyPolicy", "BoltzmannPolicy",
    "QLearningConfiguration", "QLearningDiscreteDense",
    "A2CConfiguration", "A2CDiscreteDense",
    "A3CConfiguration", "A3CDiscreteDense",
    "VectorizedMDP",
    "AsyncQLearningConfiguration", "AsyncNStepQLearningDiscreteDense",
]
