"""Transfer learning (``deeplearning4j_tpu_torch/nn/transferlearning.py``)
and early stopping (``deeplearning4j_tpu_torch/earlystopping``) against
the JAX package's on the CPU:

- ``TransferLearning.Builder`` — ``setFeatureExtractor`` plus
  ``nOutReplace`` with a ``FineTuneConfiguration``, and
  ``removeOutputLayer`` plus ``addLayer``: the new configuration's string,
  3 fine-tune steps (losses and parameters within 1e-5 relative of the
  reference's), the frozen layers bit for bit unchanged, and
  ``TransferLearningHelper.featurize``;
- ``EarlyStoppingTrainer`` over a MultiLayerNetwork and a ComputationGraph
  with ``ScoreImprovementEpochTerminationCondition``,
  ``MaxEpochsTerminationCondition``, a holdout ``DataSetLossCalculator``
  and both savers: the score of every epoch (1e-5 relative), the best
  epoch, the epochs run and the termination reason equal the
  reference's, and the best model the saver restores gives that epoch's
  score; the iteration conditions stop a run as the reference's do; the
  parallel trainer at one process is the plain trainer.
The port's 64-bit switch is on, as the suite runs the reference.
"""
import jax
import numpy as np
import pytest
import torch

import deeplearning4j_tpu.nn as jnn
import deeplearning4j_tpu.train as jtrain
import deeplearning4j_tpu.earlystopping as jes
from deeplearning4j_tpu.data import DataSet as JDataSet, ListDataSetIterator as JIt
from deeplearning4j_tpu.nn import transferlearning as jtl
import deeplearning4j_tpu_torch.nn as pnn
import deeplearning4j_tpu_torch.train as ptrain
import deeplearning4j_tpu_torch.earlystopping as pes
from deeplearning4j_tpu_torch import nd
from deeplearning4j_tpu_torch.data import DataSet, ListDataSetIterator as PIt
from deeplearning4j_tpu_torch.nn import transferlearning as ptl
from deeplearning4j_tpu_torch.train.updaters import tree_leaves
from deeplearning4j_tpu_torch.util import crash_reporting

import torch_graph_cases as G
import torch_nn_parity as H
from torch_threads import one_torch_thread  # noqa: F401,E402

REL = 1e-5


@pytest.fixture(autouse=True)
def _x64(tmp_path):
    crash_reporting.crashDumpOutputDirectory(str(tmp_path))
    with nd.enableX64(True):
        yield
    crash_reporting.crashDumpOutputDirectory(None)


def _lenet(pkg, train, seed=1):
    """A narrow LeNet (the networks phase's net at small widths)."""
    L = pkg.layers
    return (pkg.NeuralNetConfiguration.Builder().seed(seed).updater(train.Adam(1e-2)).list()
            .layer(L.ConvolutionLayer(nOut=4, kernelSize=(3, 3), activation="RELU"))
            .layer(L.SubsamplingLayer(kernelSize=(2, 2), stride=(2, 2)))
            .layer(L.ConvolutionLayer(nOut=6, kernelSize=(3, 3), activation="RELU"))
            .layer(L.SubsamplingLayer(kernelSize=(2, 2), stride=(2, 2)))
            .layer(L.DenseLayer(nOut=12, activation="RELU"))
            .layer(L.OutputLayer(nOut=10, lossFunction="MCXENT"))
            .setInputType(pkg.InputType.convolutionalFlat(14, 14, 1)).build())


def _digits(seed, n=12, classes=10):
    rng = np.random.default_rng(seed)
    return (rng.random((n, 196), np.float32),
            np.eye(classes, dtype=np.float32)[rng.integers(0, classes, n)])


def _pair():
    jnet = jnn.MultiLayerNetwork(_lenet(jnn, jtrain)).init()
    jnet.fuseSteps = 0
    pnet = pnn.MultiLayerNetwork(pnn.MultiLayerConfiguration.from_json(jnet.conf.to_json()),
                                 device="cpu").init()
    pnet.setParamTrees(H.np_tree(jnet._params), H.np_tree(jnet._state))
    for s in range(2):  # "pretrained" on 10 classes
        x, y = _digits(s)
        jnet.fit(JDataSet(x, y))
        pnet.fit(DataSet(x, y))
    return jnet, pnet


def _same(pnet, jnet, what):
    H.close(pnet.params().toNumpy(), np.asarray(jnet.params().jax), REL, what)


@pytest.mark.parametrize("surgery", ["feature_extractor_nout", "replace_output"])
def test_transfer_learning_matches_reference(surgery):
    jnet, pnet = _pair()

    def build(tl, train, L, net):
        ftc = tl.FineTuneConfiguration.Builder().updater(train.Nesterovs(0.05, 0.9)).seed(
            77).build()
        b = tl.TransferLearning.Builder(net).fineTuneConfiguration(ftc).setFeatureExtractor(3)
        if surgery == "feature_extractor_nout":
            return b.nOutReplace(4, 7, "XAVIER").nOutReplace(5, 5).build()
        return b.removeOutputLayer().addLayer(L.OutputLayer(nOut=5, lossFunction="MCXENT",
                                                            activation="SOFTMAX")).build()

    jnew = build(jtl, jtrain, jnn.layers, jnet)
    jnew.fuseSteps = 0
    pnew = build(ptl, ptrain, pnn.layers, pnet)
    assert pnew.conf.to_json() == jnew.conf.to_json()
    # the re-initialized layers come from the fine-tune seed: carry the
    # reference's (normal draws differ in their last bits)
    pnew.setParamTrees(H.np_tree(jnew._params), H.np_tree(jnew._state))
    frozen = [t.clone() for i in range(4) for t in tree_leaves(pnew._params[i])]
    for s in range(3):
        x, y = _digits(10 + s, classes=5)
        jnew.fit(JDataSet(x, y))
        pnew.fit(DataSet(x, y))
        H.close(pnew.score(), float(jnew.score()), REL, f"fine-tune loss {s}")
    _same(pnew, jnew, "fine-tuned params")
    after = [t for i in range(4) for t in tree_leaves(pnew._params[i])]
    assert all(torch.equal(a, b) for a, b in zip(after, frozen))
    x, _ = _digits(20)
    H.close(ptl.TransferLearningHelper(pnew, 3).featurize(x),
            jtl.TransferLearningHelper(jnew, 3).featurize(x), REL, "featurize")


def _es(pkg, es, saver, max_epochs=6, patience=1, iter_conds=()):
    hold = [(_digits(100 + i)) for i in range(2)]
    calc = es.DataSetLossCalculator(
        (JIt if pkg is jnn else PIt)([(JDataSet if pkg is jnn else DataSet)(x, y)
                                      for x, y in hold]))
    b = (es.EarlyStoppingConfiguration.Builder()
         .epochTerminationConditions(es.ScoreImprovementEpochTerminationCondition(patience),
                                     es.MaxEpochsTerminationCondition(max_epochs))
         .scoreCalculator(calc).modelSaver(saver).saveLastModel(True))
    if iter_conds:
        b = b.iterationTerminationConditions(*iter_conds)
    return b.build()


def _train_data(pkg, n=3):
    cls = JDataSet if pkg is jnn else DataSet
    it = JIt if pkg is jnn else PIt
    return it([cls(*_digits(200 + i)) for i in range(n)])


@pytest.mark.parametrize("saver", ["memory", "file"])
def test_early_stopping_matches_reference(saver, tmp_path):
    jnet, pnet = _pair()
    jsaver = jes.InMemoryModelSaver() if saver == "memory" else \
        jes.LocalFileModelSaver(str(tmp_path / "ref"))
    psaver = pes.InMemoryModelSaver() if saver == "memory" else \
        pes.LocalFileModelSaver(str(tmp_path / "port"))
    jres = jes.EarlyStoppingTrainer(_es(jnn, jes, jsaver), jnet, _train_data(jnn)).fit()
    pres = pes.EarlyStoppingTrainer(_es(pnn, pes, psaver), pnet, _train_data(pnn)).fit()
    assert sorted(pres.scoreVsEpoch) == sorted(jres.scoreVsEpoch)
    H.close([pres.scoreVsEpoch[e] for e in sorted(pres.scoreVsEpoch)],
            [jres.scoreVsEpoch[e] for e in sorted(jres.scoreVsEpoch)], REL, "scores")
    assert (pres.bestModelEpoch, pres.totalEpochs, pres.terminationReason,
            pres.terminationDetails) == (jres.bestModelEpoch, jres.totalEpochs,
                                         jres.terminationReason, jres.terminationDetails)
    hold = [DataSet(*_digits(100 + i)) for i in range(2)]
    best_score = np.mean([pres.bestModel.score(ds) for ds in hold])
    H.close(best_score, pres.bestModelScore, REL, "best model's score")
    assert pres.bestModel is not pnet
    if saver == "file":
        assert type(psaver.getLatestModel()).__name__ == "MultiLayerNetwork"


def test_early_stopping_graph_and_iteration_conditions(tmp_path):
    """A ComputationGraph under early stopping (file saver), then the
    iteration conditions (a score bound, a zero time bound) stopping a run
    with the reference's reason."""
    def graph(pkg, train):
        return G.multi_io(pkg, train, seed=4)

    jg = jnn.ComputationGraph(graph(jnn, jtrain)).init()
    jg.fuseSteps = 0
    pg = pnn.ComputationGraph(pnn.ComputationGraphConfiguration.from_json(jg.conf.to_json()),
                              device="cpu").init()
    pg.setParamTrees(H.np_tree(jg._params), H.np_tree(jg._state))
    from deeplearning4j_tpu.data import MultiDataSet as JM
    from deeplearning4j_tpu_torch.data import MultiDataSet as PM
    data = [G.multi_io_data(seed=s, batch=6) for s in range(3)]
    hold = G.multi_io_data(seed=50, batch=6)

    def conf(es, M, saver):
        calc = es.DataSetLossCalculator([M(hold[0], hold[1])])
        return (es.EarlyStoppingConfiguration.Builder()
                .epochTerminationConditions(es.ScoreImprovementEpochTerminationCondition(1),
                                            es.MaxEpochsTerminationCondition(4))
                .scoreCalculator(calc).modelSaver(saver).build())

    jres = jes.EarlyStoppingTrainer(conf(jes, JM, jes.LocalFileModelSaver(str(tmp_path / "j"))),
                                    jg, [JM(f, l) for f, l, _ in data]).fit()
    pres = pes.EarlyStoppingTrainer(conf(pes, PM, pes.LocalFileModelSaver(str(tmp_path / "p"))),
                                    pg, [PM(f, l) for f, l, _ in data]).fit()
    H.close([pres.scoreVsEpoch[e] for e in sorted(pres.scoreVsEpoch)],
            [jres.scoreVsEpoch[e] for e in sorted(jres.scoreVsEpoch)], REL, "graph scores")
    assert (pres.bestModelEpoch, pres.totalEpochs) == (jres.bestModelEpoch, jres.totalEpochs)
    assert type(pres.bestModel).__name__ == "ComputationGraph"
    H.close(pres.bestModel.score(PM(hold[0], hold[1])), pres.bestModelScore, REL,
            "restored graph's score")

    for cond in ("score", "time"):
        _, pnet = _pair()
        jnet, _ = _pair()
        jc = (jes.MaxScoreIterationTerminationCondition(0.0) if cond == "score"
              else jes.MaxTimeIterationTerminationCondition(0.0))
        pc = (pes.MaxScoreIterationTerminationCondition(0.0) if cond == "score"
              else pes.MaxTimeIterationTerminationCondition(0.0))
        jr = jes.EarlyStoppingTrainer(_es(jnn, jes, jes.InMemoryModelSaver(), iter_conds=(jc,)),
                                      jnet, _train_data(jnn)).fit()
        pr = pes.EarlyStoppingTrainer(_es(pnn, pes, pes.InMemoryModelSaver(), iter_conds=(pc,)),
                                      pnet, _train_data(pnn)).fit()
        assert (pr.terminationReason, pr.terminationDetails, pr.totalEpochs) == \
            (jr.terminationReason, jr.terminationDetails, jr.totalEpochs)
        assert pnet.getIterationCount() == jnet.getIterationCount()
        assert pnet.listeners == []


def test_parallel_trainer_at_one_process_is_the_plain_trainer():
    _, a = _pair()
    _, b = _pair()
    ra = pes.EarlyStoppingTrainer(_es(pnn, pes, pes.InMemoryModelSaver(), max_epochs=3), a,
                                  _train_data(pnn)).fit()
    rb = pes.EarlyStoppingParallelTrainer(_es(pnn, pes, pes.InMemoryModelSaver(),
                                              max_epochs=3), b, _train_data(pnn)).fit()
    assert ra.scoreVsEpoch == rb.scoreVsEpoch
    assert torch.equal(a.params().torch, b.params().torch)
