"""The port's hyperparameter search (``deeplearning4j_tpu_torch/arbiter``,
a copy of the JAX package's pure-Python module) held against the
reference on the CPU.

- Every space samples the reference's values from the same generator,
  and discretizes to the same grid; the generators' streams are equal.
- The runner over the reference tests' analytic score gives the same
  results (candidates, scores, best, failures, termination).
- A search over real training — ``tests/test_arbiter.py``'s end-to-end
  case, each candidate a port ``MultiLayerNetwork`` on the CPU against a
  reference network from the same parameters — gives every candidate's
  score within ``SCORE_TOL`` relative and the same best candidate.
"""
import itertools

import jax
import numpy as np
import pytest

import deeplearning4j_tpu.arbiter as R
import deeplearning4j_tpu_torch.arbiter as P
from torch_threads import one_torch_thread  # noqa: F401

SCORE_TOL = 1e-5


def _spaces(m):
    return {"lr": m.ContinuousParameterSpace(1e-4, 1e-1, log_uniform=True),
            "mom": m.ContinuousParameterSpace(0.1, 0.9),
            "units": m.IntegerParameterSpace(2, 9),
            "act": m.DiscreteParameterSpace(["relu", "tanh", "sigmoid"]),
            "bias": m.BooleanSpace(), "fixed": m.FixedValue(3)}


def test_spaces_and_generators_equal():
    rs, ps = _spaces(R), _spaces(P)
    r_rng, p_rng = np.random.RandomState(5), np.random.RandomState(5)
    for k in rs:
        assert [ps[k].sample(p_rng) for _ in range(50)] == \
            [rs[k].sample(r_rng) for _ in range(50)], k
        for points in (1, 3, 7):
            assert ps[k].grid_values(points) == rs[k].grid_values(points), k
    for seed in (0, 1):
        r_it, p_it = iter(R.RandomSearchGenerator(rs, seed=seed)), \
            iter(P.RandomSearchGenerator(ps, seed=seed))
        assert [next(p_it) for _ in range(30)] == [next(r_it) for _ in range(30)]
    small = lambda m: {"x": m.DiscreteParameterSpace(list(range(6))),
                       "y": m.ContinuousParameterSpace(0.0, 1.0)}
    for order in ("Sequential", "RandomOrder"):
        rg = R.GridSearchCandidateGenerator(small(R), 4, order=order, seed=2)
        pg = P.GridSearchCandidateGenerator(small(P), 4, order=order, seed=2)
        assert pg.total() == rg.total() == 24 and list(pg) == list(rg)


def _analytic(m, gen, conditions):
    return m.OptimizationRunner(m.OptimizationConfiguration(
        candidate_generator=gen, model_builder=lambda hp: hp,
        score_function=lambda model, hp:
            (hp["lr"] - 0.3) ** 2 + (0.1 if hp["units"] != 16 else 0.0),
        termination_conditions=conditions))


@pytest.mark.parametrize("case", ["grid", "patience", "failures", "maximize"])
def test_runner_results_equal(case):
    def run(m):
        spaces = {"lr": m.ContinuousParameterSpace(0.0, 0.6),
                  "units": m.DiscreteParameterSpace([8, 16])}
        if case == "grid":
            runner = _analytic(m, m.GridSearchCandidateGenerator(spaces, 5),
                               [m.MaxCandidatesCondition(100)])
        elif case == "patience":
            runner = _analytic(m, m.RandomSearchGenerator(spaces, seed=3),
                               [m.ScoreImprovementCondition(patience=15),
                                m.MaxCandidatesCondition(200)])
        elif case == "failures":
            def build(hp):
                if hp["x"] == "boom":
                    raise RuntimeError("bad candidate")
                return hp
            runner = m.OptimizationRunner(m.OptimizationConfiguration(
                candidate_generator=m.GridSearchCandidateGenerator(
                    {"x": m.DiscreteParameterSpace(["boom", "ok", "boom"])}),
                model_builder=build, score_function=lambda mdl, hp: 1.0,
                termination_conditions=[m.MaxCandidatesCondition(3)]))
        else:
            runner = m.OptimizationRunner(m.OptimizationConfiguration(
                candidate_generator=({"i": i} for i in itertools.count()),
                model_builder=lambda hp: hp, score_function=lambda mdl, hp: -abs(hp["i"] - 4),
                termination_conditions=[m.MaxCandidatesCondition(9)],
                minimize_score=False))
        seen = []
        runner.listeners.append(lambda res: seen.append(res.candidate.index))
        best = runner.execute()
        rows = [(r.candidate.index, r.candidate.hyperparameters, r.score,
                 r.exception is None) for r in runner.results]
        return (best.candidate.index, best.score, rows, runner.numCandidatesCompleted(),
                runner.numCandidatesFailed(), seen)

    assert run(P) == run(R)


def test_runner_refusals_equal():
    for m in (R, P):
        runner = m.OptimizationRunner(m.OptimizationConfiguration(
            candidate_generator=iter([{"a": 1}]),
            model_builder=lambda hp: 1 / 0, score_function=lambda mdl, hp: 0.0,
            termination_conditions=[m.MaxCandidatesCondition(1)]))
        with pytest.raises(RuntimeError, match="no candidate produced a score"):
            runner.execute()
        assert "ZeroDivisionError" in runner.results[0].exception


def test_search_over_real_training_picks_the_same_best():
    """``test_arbiter.TestEndToEndNetworkSearch``'s search: the reference
    trains its networks, the port trains its own on the CPU from the same
    parameters (carried over: the two seeded inits differ in the last bit
    of a few weights); four random candidates over lr and width."""
    from deeplearning4j_tpu.data import DataSet as RData
    from deeplearning4j_tpu.nn import InputType, MultiLayerNetwork, NeuralNetConfiguration
    from deeplearning4j_tpu.nn.conf.layers import DenseLayer, OutputLayer
    from deeplearning4j_tpu.train import Adam
    from deeplearning4j_tpu_torch.data import DataSet as PData
    from deeplearning4j_tpu_torch.nn import MultiLayerNetwork as PNet
    from deeplearning4j_tpu_torch.nn.conf.builder import MultiLayerConfiguration

    rng = np.random.RandomState(0)
    x = rng.randn(128, 4).astype(np.float32)
    y = np.eye(2, dtype=np.float32)[(x.sum(-1) > 0).astype(int)]
    ref_nets = {}

    def conf(hp):
        return (NeuralNetConfiguration.Builder().seed(0).updater(Adam(hp["lr"])).list()
                .layer(DenseLayer(nOut=hp["units"], activation="RELU"))
                .layer(OutputLayer(nOut=2, lossFunction="MCXENT"))
                .setInputType(InputType.feedForward(4)).build())

    def build_ref(hp):
        net = MultiLayerNetwork(conf(hp)).init()
        # a host copy: fit donates the network's arrays
        ref_nets[len(ref_nets)] = jax.tree_util.tree_map(np.array, net._params)
        return net

    def build_port(hp):
        net = PNet(MultiLayerConfiguration.from_json(conf(hp).to_json()), device="cpu").init()
        net.setParamTrees(ref_nets[len(port_idx)])
        port_idx.append(hp)
        return net

    def score(data):
        def fn(model, hp):
            model.fit(data, epochs=15)
            return model.score()
        return fn

    port_idx = []
    results = {}
    for m, build, data in ((R, build_ref, RData(x, y)), (P, build_port, PData(x, y))):
        runner = m.OptimizationRunner(m.OptimizationConfiguration(
            candidate_generator=m.RandomSearchGenerator(
                {"lr": m.ContinuousParameterSpace(1e-5, 3e-2, log_uniform=True),
                 "units": m.IntegerParameterSpace(4, 24)}, seed=7),
            model_builder=build, score_function=score(data),
            termination_conditions=[m.MaxCandidatesCondition(4)]))
        best = runner.execute()
        results[m] = (best.candidate.index, [(r.candidate.hyperparameters, r.score)
                                             for r in runner.results])
    assert results[P][0] == results[R][0]
    for (php, ps), (rhp, rs) in zip(results[P][1], results[R][1]):
        assert php == rhp and ps == pytest.approx(rs, rel=SCORE_TOL)
    scores = sorted(s for _, s in results[P][1])
    assert scores[0] < scores[-1] * 0.9     # the search separates its candidates
