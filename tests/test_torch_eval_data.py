"""The port's evaluation and data modules (``deeplearning4j_tpu_torch/
eval``, ``deeplearning4j_tpu_torch/data``) against the JAX package's on
the CPU, both pure numpy:

- ``Evaluation``, ``RegressionEvaluation``, ``ROC``, ``ROCMultiClass``,
  ``EvaluationBinary``, ``ROCBinary`` and ``EvaluationCalibration`` fed
  the same labels and predictions (numpy, and the port's tensors and
  NDArrays), with and without a mask: every statistic equal (1e-12
  relative) and the same ``stats()`` text;
- ``DataSet``/``MultiDataSet`` and the iterators: the same batches in
  the same order (shuffling seeded), splits and merges;
- the normalizers: fitted statistics and transformed / reverted features
  equal;
- the fetchers: the synthetic surrogates equal element for element, and
  the IDX reader over a cache directory (``DL4J_TPU_CACHE``) equal to the
  reference's.
"""
import gzip
import os
import struct
import subprocess
import sys

import numpy as np
import pytest
import torch

from deeplearning4j_tpu import data as jdata
from deeplearning4j_tpu.data import fetchers as jfetch
from deeplearning4j_tpu.data import normalizers as jnorm
from deeplearning4j_tpu import eval as jeval
from deeplearning4j_tpu_torch import NDArray
from deeplearning4j_tpu_torch import data as pdata
from deeplearning4j_tpu_torch.data import fetchers as pfetch
from deeplearning4j_tpu_torch.data import normalizers as pnorm
from deeplearning4j_tpu_torch import eval as peval

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _same(a, b):
    if isinstance(b, float) and np.isnan(b):
        assert np.isnan(a)
    elif isinstance(b, (float, np.floating)):
        assert a == pytest.approx(b, rel=1e-12, abs=1e-15)
    elif isinstance(b, np.ndarray):
        np.testing.assert_allclose(a, b, rtol=1e-12, atol=1e-15)
    elif isinstance(b, (tuple, list)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    else:
        assert a == b


def _classification(rng, shape, k):
    labels = np.eye(k, dtype=np.float32)[rng.integers(0, k, shape)]
    logits = rng.standard_normal(shape + (k,))
    preds = (np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)).astype(np.float32)
    return labels, preds


def _wrap(kind, a):
    if kind == "tensor":
        return torch.tensor(a)
    if kind == "ndarray":
        return NDArray(torch.tensor(a))
    return a


@pytest.mark.parametrize("kind", ["numpy", "tensor", "ndarray"])
@pytest.mark.parametrize("masked", [False, True], ids=["nomask", "mask"])
def test_evaluation(kind, masked):
    rng = np.random.default_rng(0)
    y, p = _classification(rng, (4, 6), 3)
    mask = (rng.random((4, 6)) > 0.3).astype(np.float32) if masked else None
    j, q = jeval.Evaluation(3), peval.Evaluation(3)
    for _ in range(2):
        j.eval(y, p, mask=mask)
        q.eval(_wrap(kind, y), _wrap(kind, p), mask=mask)
    for name in ("accuracy", "precision", "recall", "f1", "confusionMatrix", "stats"):
        _same(getattr(q, name)(), getattr(j, name)())
    for c in range(3):
        for name in ("precision", "recall", "f1", "falsePositiveRate", "matthewsCorrelation"):
            _same(getattr(q, name)(c), getattr(j, name)(c))


def test_regression_evaluation():
    rng = np.random.default_rng(1)
    y = rng.standard_normal((20, 3)).astype(np.float32)
    p = (y + 0.3 * rng.standard_normal((20, 3))).astype(np.float32)
    j, q = jeval.RegressionEvaluation(), peval.RegressionEvaluation()
    j.eval(y, p)
    q.eval(torch.tensor(y), p)
    for name in ("meanSquaredError", "meanAbsoluteError", "rootMeanSquaredError",
                 "rSquared", "pearsonCorrelation"):
        _same(getattr(q, name)(), getattr(j, name)())
        for c in range(3):
            _same(getattr(q, name)(c), getattr(j, name)(c))
    assert q.stats() == j.stats()


@pytest.mark.parametrize("one_hot", [False, True])
def test_roc(one_hot):
    rng = np.random.default_rng(2)
    y = (rng.random(40) > 0.5).astype(np.float32)
    p = np.clip(y * 0.3 + rng.random(40) * 0.7, 0, 1).astype(np.float32)
    if one_hot:
        y = np.stack([1 - y, y], -1)
        p = np.stack([1 - p, p], -1)
    j, q = jeval.ROC(), peval.ROC()
    j.eval(y, p)
    q.eval(y, p)
    _same(q.calculateAUC(), j.calculateAUC())
    _same(q.calculateAUCPR(), j.calculateAUCPR())


def test_roc_multiclass_and_binary():
    rng = np.random.default_rng(3)
    y, p = _classification(rng, (30,), 4)
    j, q = jeval.ROCMultiClass(), peval.ROCMultiClass()
    j.eval(y, p)
    q.eval(y, p)
    _same(q.calculateAverageAUC(), j.calculateAverageAUC())
    for c in range(4):
        _same(q.calculateAUC(c), j.calculateAUC(c))
    yb = (rng.random((30, 3)) > 0.5).astype(np.float32)
    pb = rng.random((30, 3)).astype(np.float32)
    mask = (rng.random((30, 3)) > 0.2).astype(np.float32)
    for J, Q in ((jeval.EvaluationBinary, peval.EvaluationBinary),
                 (jeval.ROCBinary, peval.ROCBinary)):
        j, q = J(), Q()
        j.eval(yb, pb, mask=mask)
        q.eval(yb, pb, mask=mask)
        names = ("truePositives", "falsePositives", "trueNegatives", "falseNegatives",
                 "accuracy", "precision", "recall", "f1") if J is jeval.EvaluationBinary \
            else ("calculateAUC", "calculateAUCPR")
        for c in range(3):
            for name in names:
                _same(getattr(q, name)(c), getattr(j, name)(c))
        if J is jeval.EvaluationBinary:
            _same(q.averageAccuracy(), j.averageAccuracy())
            _same(q.averageF1(), j.averageF1())
            assert q.stats() == j.stats()
        else:
            _same(q.calculateAverageAUC(), j.calculateAverageAUC())


def test_evaluation_calibration():
    rng = np.random.default_rng(4)
    y, p = _classification(rng, (50,), 3)
    j, q = jeval.EvaluationCalibration(), peval.EvaluationCalibration()
    j.eval(y, p)
    q.eval(y, p)
    for name in ("reliabilityDiagram", "expectedCalibrationError", "probabilityHistogram",
                 "residualPlot", "stats"):
        _same(getattr(q, name)(), getattr(j, name)())


def _batches(it):
    return [(ds.features.copy(), ds.labels.copy()) for ds in it]


def _same_batches(a, b):
    assert len(a) == len(b)
    for (fa, la), (fb, lb) in zip(a, b):
        np.testing.assert_array_equal(fa, fb)
        np.testing.assert_array_equal(la, lb)


def test_datasets_and_iterators():
    rng = np.random.default_rng(5)
    x = rng.standard_normal((23, 4)).astype(np.float32)
    y = rng.standard_normal((23, 2)).astype(np.float32)
    fm = (rng.random((23, 3)) > 0.5).astype(np.float32)
    jd, pd = jdata.DataSet(x, y, fm, fm), pdata.DataSet(torch.tensor(x), NDArray(torch.tensor(y)),
                                                       fm, fm)
    assert pd.numExamples() == jd.numExamples()
    for a, b in zip(pd.splitTestAndTrain(0.6), jd.splitTestAndTrain(0.6)):
        np.testing.assert_array_equal(a.features, b.features)
        np.testing.assert_array_equal(a.labels_mask, b.labels_mask)
    jd.shuffle(3)
    pd.shuffle(3)
    np.testing.assert_array_equal(pd.features, jd.features)
    _same_batches(_batches(pdata.ListDataSetIterator([pd], batch_size=5)),
                  _batches(jdata.ListDataSetIterator([jd], batch_size=5)))
    ja = jdata.ArrayDataSetIterator(x, y, 4, shuffle=True, seed=2)
    pa = pdata.ArrayDataSetIterator(x, y, 4, shuffle=True, seed=2)
    for _ in range(3):  # the epochs reshuffle the same way
        _same_batches(_batches(pa), _batches(ja))
    assert pa.batch() == ja.batch() == 4
    m = pdata.DataSet.merge([pd, pd])
    assert m.numExamples() == 46
    md = pd.toMultiDataSet()
    assert isinstance(md, pdata.MultiDataSet) and md.numExamples() == 23


@pytest.mark.parametrize("name,kw", [("NormalizerStandardize", {}),
                                     ("NormalizerMinMaxScaler", dict(minRange=-1.0)),
                                     ("ImagePreProcessingScaler", dict(a=-0.5, b=0.5)),
                                     ("VGG16ImagePreProcessor", {})])
@pytest.mark.parametrize("shape", [(10, 3), (6, 5, 3), (4, 3, 2, 2)])
def test_normalizers(name, kw, shape):
    rng = np.random.default_rng(6)
    if name == "VGG16ImagePreProcessor" and len(shape) != 4:
        shape = (4, 3, 2, 2)
    x = (rng.random(shape) * 255).astype(np.float32)
    fm = (rng.random(shape[:2]) > 0.3).astype(np.float32) if len(shape) == 3 else None
    j, q = getattr(jnorm, name)(**kw), getattr(pnorm, name)(**kw)
    j.fit(jdata.ListDataSetIterator([jdata.DataSet(x, x, fm)]))
    q.fit(pdata.ListDataSetIterator([pdata.DataSet(x, x, fm)]))
    for attr in ("mean", "std", "dataMin", "dataMax"):
        if hasattr(j, attr):
            np.testing.assert_array_equal(getattr(q, attr), getattr(j, attr))
    jd, pd = jdata.DataSet(x.copy(), x), pdata.DataSet(x.copy(), x)
    j.transform(jd)
    q.preProcess(pd)
    np.testing.assert_array_equal(pd.features, jd.features)
    j.revert(jd)
    q.revert(pd)
    np.testing.assert_array_equal(pd.features, jd.features)


def test_normalizer_save_load(tmp_path):
    x = np.random.default_rng(7).standard_normal((9, 4)).astype(np.float32)
    q = pnorm.NormalizerStandardize().fit(pdata.DataSet(x, x))
    q.save(str(tmp_path / "n.npz"))
    j = jnorm.NormalizerStandardize.load(str(tmp_path / "n.npz"))
    np.testing.assert_array_equal(j.mean, q.mean)
    back = pnorm.NormalizerStandardize.load(str(tmp_path / "n.npz"))
    np.testing.assert_array_equal(back.std, q.std)


@pytest.mark.parametrize("name,kw", [
    ("MnistDataSetIterator", dict(batch_size=32, num_examples=96)),
    ("MnistDataSetIterator", dict(batch_size=16, train=False, num_examples=48, binarize=True)),
    ("EmnistDataSetIterator", dict(batch_size=16, num_examples=32)),
    ("IrisDataSetIterator", dict(batch_size=50)),
    ("Cifar10DataSetIterator", dict(batch_size=8, num_examples=16)),
    ("TinyImageNetDataSetIterator", dict(batch_size=4, num_examples=8, num_classes=5)),
    ("LFWDataSetIterator", dict(batch_size=4, num_examples=8)),
    ("SvhnDataSetIterator", dict(batch_size=8, num_examples=16)),
])
def test_fetcher_surrogates_equal(name, kw, monkeypatch, tmp_path):
    monkeypatch.setattr(jfetch, "CACHE_DIR", tmp_path)
    monkeypatch.setattr(pfetch, "CACHE_DIR", tmp_path)
    j, q = getattr(jfetch, name)(**kw), getattr(pfetch, name)(**kw)
    assert q.synthetic and j.synthetic
    _same_batches(_batches(q), _batches(j))


def _write_idx(d, split, imgs, labels):
    d.mkdir(parents=True, exist_ok=True)
    with gzip.open(d / f"{split}-images-idx3-ubyte.gz", "wb") as f:
        f.write(struct.pack(">IIII", 2051, imgs.shape[0], 28, 28) + imgs.tobytes())
    with gzip.open(d / f"{split}-labels-idx1-ubyte.gz", "wb") as f:
        f.write(struct.pack(">II", 2049, labels.shape[0]) + labels.tobytes())


def test_idx_reader_from_cache(tmp_path):
    rng = np.random.default_rng(8)
    imgs = rng.integers(0, 256, (12, 28, 28), dtype=np.uint8)
    labels = rng.integers(0, 10, 12, dtype=np.uint8)
    _write_idx(tmp_path / "mnist", "train", imgs, labels)
    code = ("import sys, numpy as np\n"
            "from deeplearning4j_tpu_torch.data.fetchers import MnistDataSetIterator as M\n"
            "it = M(4, shuffle=False)\n"
            "b = [ds.features for ds in it]\n"
            "np.save(sys.argv[1], np.concatenate(b))\n"
            "print(it.synthetic)\n")
    out = tmp_path / "f.npy"
    env = dict(os.environ, DL4J_TPU_CACHE=str(tmp_path))
    r = subprocess.run([sys.executable, "-c", code, str(out)], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "False"
    np.testing.assert_array_equal(np.load(out), imgs.reshape(12, 784).astype(np.float32) / 255.0)
    np.testing.assert_array_equal(pfetch._idx_labels(tmp_path / "mnist" / "train-labels-idx1-ubyte.gz"),
                                  jfetch._idx_labels(tmp_path / "mnist" / "train-labels-idx1-ubyte.gz"))
