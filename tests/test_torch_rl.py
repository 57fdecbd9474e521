"""The port's reinforcement learning (``deeplearning4j_tpu_torch/rl``) held
against the JAX package's on the CPU, with ``tests/test_rl.py``'s networks.

- Environments, replay, policies, returns and the vector env are copies:
  equal step for step (observations, rewards, flags, samples, choices).
- One update from parameters carried over from the reference learner
  (its own seeded init differs from the port's in the last bit of a few
  weights): DQN vanilla and double, n-step Q and A2C over the same
  batches, five updates each, give the reference's loss and parameters
  within ``UPDATE_TOL`` of each leaf's largest |value| (float32 matmuls
  summed in another order, then Adam's division: a few ulps a step).
- Short runs on ``ChainMDP`` from carried-over parameters give the
  reference's episode returns exactly: every action is an argmax of Q or
  a draw against probabilities that agree to a few ulps, and none of
  these runs meets a near-tie (a flipped action would show here as a
  different return).
- ``GymEnvAdapter`` keeps gym out of ``sys.modules`` until constructed.
- Every learner's ``device`` default raises without CUDA.
"""
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

import deeplearning4j_tpu.rl as R
import deeplearning4j_tpu_torch.rl as P
import test_rl as RT
from deeplearning4j_tpu.rl.returns import nstep_returns as r_returns
from deeplearning4j_tpu.rl.vector_env import collect_rollout as r_rollout
from deeplearning4j_tpu_torch.nn.conf.builder import MultiLayerConfiguration
from deeplearning4j_tpu_torch.rl.qlearning import to_device
from deeplearning4j_tpu_torch.rl.returns import nstep_returns as p_returns
from deeplearning4j_tpu_torch.rl.vector_env import collect_rollout as p_rollout
from deeplearning4j_tpu_torch.train.updaters import tree_leaves
from torch_threads import one_torch_thread  # noqa: F401

UPDATE_TOL = 1e-5


def _conf(ref_conf):
    """The port's configuration of a reference network's."""
    return MultiLayerConfiguration.from_json(ref_conf.to_json())


def _carry(net, ref_params):
    """Put the reference's parameters on the port network; return its tree."""
    net.setParamTrees(jax.tree_util.tree_map(np.asarray, ref_params))
    return net._params


def _close(got, want, what):
    """A port tree against a reference tree (dict keys sorted in both),
    each leaf within UPDATE_TOL of its largest |value|."""
    got = [l.detach().numpy() for l in tree_leaves(got)]
    want = [np.asarray(l) for l in jax.tree_util.tree_leaves(want)]
    assert len(got) == len(want), what
    for i, (a, b) in enumerate(zip(got, want)):
        err = np.abs(a.astype(np.float64) - b).max()
        assert err <= UPDATE_TOL * max(np.abs(b).max(), 1e-30), (what, i, err)


# ------------------------------------------------------- copies, step by step


@pytest.mark.parametrize("env", ["chain", "cartpole", "mountain_car"])
def test_envs_equal_step_for_step(env):
    make = {"chain": lambda m: m.ChainMDP(n_states=5, horizon=12),
            "cartpole": lambda m: m.CartPole(seed=3, max_steps=60),
            "mountain_car": lambda m: m.MountainCar(horizon=40, seed=2)}[env]
    r, p = make(R), make(P)
    assert (p.obs_size, p.n_actions) == (r.obs_size, r.n_actions)
    acts = np.random.RandomState(0).randint(r.n_actions, size=300)
    ro, po = r.reset(), p.reset()
    for a in acts:
        assert np.array_equal(ro, po)
        ro, rr, rd, _ = r.step(int(a))
        po, pr, pd, _ = p.step(int(a))
        assert (pr, pd) == (rr, rd)
        if rd:
            ro, po = r.reset(), p.reset()


def test_replay_and_policies_equal():
    rr, pr = R.ExpReplay(6, 3, seed=4), P.ExpReplay(6, 3, seed=4)
    for i in range(9):
        t = (np.full(3, i, np.float32), i % 2, float(i), np.full(3, i + 1, np.float32),
             i % 4 == 0)
        rr.store(R.Transition(*t))
        pr.store(P.Transition(*t))
    assert len(pr) == len(rr) == 6
    for _ in range(3):
        for a, b in zip(pr.sample(16), rr.sample(16)):
            assert a.dtype == b.dtype and np.array_equal(a, b)
    q = np.array([0.1, 0.5, 0.2], np.float32)
    for rp, pp in ((R.EpsGreedy(0.1, 20, seed=1), P.EpsGreedy(0.1, 20, seed=1)),
                   (R.BoltzmannPolicy(0.5, seed=2), P.BoltzmannPolicy(0.5, seed=2))):
        assert [pp.select(q) for _ in range(60)] == [rp.select(q) for _ in range(60)]
    assert P.GreedyPolicy().select(q) == R.GreedyPolicy().select(q) == 1
    assert P.EpsGreedy(0.1, 20).epsilon == R.EpsGreedy(0.1, 20).epsilon


def test_vector_env_rollouts_and_returns_equal():
    venv = {m: m.VectorizedMDP([lambda m=m, i=i: m.ChainMDP(4, horizon=3 + i)
                                for i in range(3)]) for m in (R, P)}
    obs = {m: venv[m].reset() for m in (R, P)}
    rng = {m: np.random.RandomState(7) for m in (R, P)}
    eps = {R: [], P: []}
    outs = {}
    for m, roll in ((R, r_rollout), (P, p_rollout)):
        outs[m] = roll(venv[m], obs[m], lambda o, m=m: rng[m].randint(2, size=len(o)),
                       6, 4, eps[m])
    for a, b in zip(outs[P], outs[R]):
        assert np.array_equal(a, b)
    assert eps[P] == eps[R]
    _, _, _, rr, rd, rtrunc, _ = outs[R]
    boot = np.array([0.5, -1.0, 2.0], np.float32)
    tb = np.random.RandomState(1).randn(6, 3).astype(np.float32)
    assert np.array_equal(p_returns(rr, rd, rtrunc, boot, tb, 0.9),
                          r_returns(rr, rd, rtrunc, boot, tb, 0.9))


def test_gym_adapter_stays_lazy():
    code = ("import sys\n"
            "import deeplearning4j_tpu_torch.rl as rl\n"
            "assert not {'gym', 'gymnasium'} & set(sys.modules)\n"
            "try:\n"
            "    rl.GymEnvAdapter('CartPole-v1')\n"
            "except ImportError as e:\n"
            "    print('refused', e)\n"
            "else:\n"
            "    print('built')\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith(("refused GymEnvAdapter needs gymnasium or gym",
                                  "built"))


# -------------------------------------------------------------- updates


def _dqn_pair(double, seed=0, **over):
    cfg = dict(dict(seed=seed, doubleDQN=double, batchSize=16, expRepMaxSize=200), **over)
    conf = RT.q_net_conf(5, 2, seed=seed)
    r = R.QLearningDiscreteDense(R.ChainMDP(5, 10), conf, R.QLearningConfiguration(**cfg))
    p = P.QLearningDiscreteDense(P.ChainMDP(5, 10), _conf(conf),
                                 P.QLearningConfiguration(**cfg), device="cpu")
    p._params = _carry(p.net, r._params)
    p._target = _carry(p.net.clone(), r._target)
    p._opt_state = p._tx.init(p._params)
    return r, p


def _random_play(env, replay, steps, seed):
    rng = np.random.RandomState(seed)
    obs = env.reset()
    for _ in range(steps):
        a = int(rng.randint(env.n_actions))
        nxt, rew, done, _ = env.step(a)
        replay.store(R.Transition(obs, a, rew, nxt, done))
        obs = env.reset() if done else nxt


@pytest.mark.parametrize("double", [False, True], ids=["vanilla", "double"])
def test_dqn_updates(double):
    r, p = _dqn_pair(double)
    _random_play(R.ChainMDP(5, 10), r.replay, 120, seed=1)
    # the target lags the online network by two updates
    for k in range(5):
        b = r.replay.sample(16)
        r._params, r._opt_state, r_loss = r._jit_update(
            r._params, r._target, r._opt_state, *(jax.numpy.asarray(x) for x in b))
        p._params, p._opt_state, p_loss = p._update_fn(
            p._params, p._target, p._opt_state, *to_device("cpu", *b))
        assert float(p_loss) == pytest.approx(float(r_loss), rel=UPDATE_TOL, abs=1e-7)
        _close(p._params, r._params, f"update {k}")
        if k == 1:
            r._target = jax.tree.map(jax.numpy.array, r._params)
            p._target = _carry(p.net.clone(), r._target)
    obs = np.eye(5, dtype=np.float32)[2]
    np.testing.assert_allclose(p.q_values(obs), r.q_values(obs), rtol=UPDATE_TOL, atol=1e-7)


def test_nstep_q_update():
    cfg = dict(seed=3, nStep=5, numEnvs=4)
    conf = RT.q_net_conf(5, 2, seed=3)
    r = R.AsyncNStepQLearningDiscreteDense(lambda: R.ChainMDP(5, 20), conf,
                                           R.AsyncQLearningConfiguration(**cfg))
    p = P.AsyncNStepQLearningDiscreteDense(lambda: P.ChainMDP(5, 20), _conf(conf),
                                           P.AsyncQLearningConfiguration(**cfg),
                                           device="cpu")
    p._params = _carry(p.net, r._params)
    p._opt_state = p._tx.init(p._params)
    rng = np.random.RandomState(2)
    for k in range(5):
        obs = np.eye(5, dtype=np.float32)[rng.randint(5, size=20)]
        act = rng.randint(2, size=20).astype(np.int32)
        ret = rng.randn(20).astype(np.float32) * 2       # past the clamp too
        r._params, r._opt_state, r_loss = r._jit_update(
            r._params, r._opt_state, *(jax.numpy.asarray(x) for x in (obs, act, ret)))
        p._params, p._opt_state, p_loss = p._update_fn(
            p._params, p._opt_state, *to_device("cpu", obs, act, ret))
        assert float(p_loss) == pytest.approx(float(r_loss), rel=UPDATE_TOL, abs=1e-7)
        _close(p._params, r._params, f"update {k}")
    np.testing.assert_allclose(p._select_actions(obs[:4]), r._select_actions(obs[:4]))


def _a2c_pair(n_envs, seed=0, **over):
    cfg = dict(dict(seed=seed, nStep=8, numEnvs=n_envs, gamma=0.9), **over)
    pi, v = RT.pi_net_conf(5, 2, seed=seed), RT.v_net_conf(5, seed=seed + 1)
    make = (lambda m: (lambda: m.ChainMDP(5, 20))) if n_envs > 1 else \
        (lambda m: m.ChainMDP(5, 10))
    r = R.A2CDiscreteDense(make(R), pi, v, R.A2CConfiguration(**cfg))
    p = P.A2CDiscreteDense(make(P), _conf(pi), _conf(v), P.A2CConfiguration(**cfg),
                           device="cpu")
    p._pi = _carry(p.pi_net, r._pi)
    p._v = _carry(p.v_net, r._v)
    p._opt = p._tx.init({"pi": p._pi, "v": p._v})
    return r, p


def test_a2c_update():
    r, p = _a2c_pair(1)
    rng = np.random.RandomState(4)
    for k in range(5):
        obs = np.eye(5, dtype=np.float32)[rng.randint(5, size=16)]
        act = rng.randint(2, size=16).astype(np.int32)
        ret = rng.randn(16).astype(np.float32)
        params, r._opt, r_loss = r._jit_update({"pi": r._pi, "v": r._v}, r._opt,
                                               *(jax.numpy.asarray(x) for x in (obs, act, ret)))
        r._pi, r._v = params["pi"], params["v"]
        p_loss = p._update(obs, act, ret)
        assert float(p_loss) == pytest.approx(float(r_loss), rel=UPDATE_TOL, abs=1e-7)
        _close({"pi": p._pi, "v": p._v}, {"pi": r._pi, "v": r._v}, f"update {k}")
    np.testing.assert_allclose(p.action_probs(obs[0]), r.action_probs(obs[0]),
                               rtol=UPDATE_TOL, atol=1e-7)


# ------------------------------------------------------------- short runs


def test_dqn_run_gives_the_reference_returns():
    r, p = _dqn_pair(True, gamma=0.95, batchSize=32, expRepMaxSize=2000,
                     targetDqnUpdateFreq=50, updateStart=50, minEpsilon=0.05,
                     epsilonNbStep=400, maxStep=600, maxEpochStep=10)
    want, got = r.train(), p.train()
    assert len(got) == len(want) == 60 and got == want
    _close(p._params, r._params, "after the run")
    assert p.play() == r.play()


@pytest.mark.parametrize("n_envs", [1, 4])
def test_a2c_run_gives_the_reference_returns(n_envs):
    r, p = _a2c_pair(n_envs, seed=5, maxStep=640, maxEpochStep=20)
    want, got = r.train(), p.train()
    assert len(want) > 10 and got == want
    assert p.play() == r.play()


def test_nstep_q_run_gives_the_reference_returns():
    cfg = dict(seed=3, gamma=0.9, nStep=5, numEnvs=4, targetDqnUpdateFreq=80,
               minEpsilon=0.05, epsilonNbStep=1500, maxStep=800, maxEpochStep=20)
    conf = RT.q_net_conf(5, 2, seed=3)
    r = R.AsyncNStepQLearningDiscreteDense(lambda: R.ChainMDP(5, 20), conf,
                                           R.AsyncQLearningConfiguration(**cfg))
    p = P.AsyncNStepQLearningDiscreteDense(lambda: P.ChainMDP(5, 20), _conf(conf),
                                           P.AsyncQLearningConfiguration(**cfg),
                                           device="cpu")
    p._params = _carry(p.net, r._params)
    p._target = _carry(p.net.clone(), r._target)
    p._opt_state = p._tx.init(p._params)
    want, got = r.train(), p.train()
    assert len(want) > 20 and got == want
    assert p.play() == r.play()
    _close(p.net._params, r.net._params, "the net's params after the run")


# ---------------------------------------------------------------- device


@pytest.mark.parametrize("make", [
    lambda: P.QLearningDiscreteDense(P.ChainMDP(), _conf(RT.q_net_conf(6, 2)),
                                     P.QLearningConfiguration()),
    lambda: P.AsyncNStepQLearningDiscreteDense(
        lambda: P.ChainMDP(), _conf(RT.q_net_conf(6, 2)), P.AsyncQLearningConfiguration()),
    lambda: P.A2CDiscreteDense(P.ChainMDP(), _conf(RT.pi_net_conf(6, 2)),
                               _conf(RT.v_net_conf(6)), P.A2CConfiguration())])
def test_device_default_needs_cuda(monkeypatch, make):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make()


def test_learner_takes_a_network_on_its_device():
    from deeplearning4j_tpu_torch.nn import MultiLayerNetwork

    net = MultiLayerNetwork(_conf(RT.q_net_conf(6, 2)), device="cpu").init()
    dqn = P.QLearningDiscreteDense(P.ChainMDP(), net, P.QLearningConfiguration())
    assert dqn.net is net and dqn.device == torch.device("cpu")
    assert P.A3CDiscreteDense is P.A2CDiscreteDense
    with pytest.raises(ValueError, match="factory"):
        P.A2CDiscreteDense(P.ChainMDP(), _conf(RT.pi_net_conf(6, 2)),
                           _conf(RT.v_net_conf(6)), P.A2CConfiguration(numEnvs=4),
                           device="cpu")
