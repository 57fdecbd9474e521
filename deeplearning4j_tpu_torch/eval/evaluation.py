"""Classification / regression / ROC evaluation (ref: org.nd4j.evaluation —
Evaluation, RegressionEvaluation, ROC, ROCMultiClass, EvaluationCalibration;
counterpart: ``deeplearning4j_tpu/eval/evaluation.py``).

Streaming accumulators: ``eval(labels, predictions)`` per batch, metrics on
demand — same usage contract as the reference. Accumulation happens on host
in numpy (tiny data); the forward pass runs on the network's device.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch


def _np(x):
    """Host numpy of an array, a tensor (on any device) or NDArray."""
    from deeplearning4j_tpu_torch.ndarray.array import NDArray
    if isinstance(x, NDArray):
        return x.toNumpy()
    if isinstance(x, torch.Tensor):
        t = x.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    return np.asarray(x)


class Evaluation:
    """Multi-class classification metrics (ref: org.nd4j.evaluation.classification.Evaluation):
    accuracy, precision/recall/F1 (macro + per-class), confusion matrix."""

    def __init__(self, num_classes: Optional[int] = None, labels: Optional[list] = None):
        self.num_classes = num_classes
        self.label_names = labels
        self.confusion: Optional[np.ndarray] = None

    def eval(self, labels, predictions, mask=None):
        y = _np(labels)
        p = _np(predictions)
        if y.ndim == 3:  # (B,T,C) time series: flatten time
            y = y.reshape(-1, y.shape[-1])
            p = p.reshape(-1, p.shape[-1])
            if mask is not None:
                m = _np(mask).reshape(-1).astype(bool)
                y, p = y[m], p[m]
        true = y.argmax(-1) if y.ndim > 1 else y.astype(int)
        pred = p.argmax(-1) if p.ndim > 1 else p.astype(int)
        n = self.num_classes or int(max(true.max(initial=0), pred.max(initial=0))) + 1
        if self.confusion is None:
            self.num_classes = n
            self.confusion = np.zeros((n, n), dtype=np.int64)
        elif n > self.confusion.shape[0]:
            grown = np.zeros((n, n), dtype=np.int64)
            grown[:self.confusion.shape[0], :self.confusion.shape[1]] = self.confusion
            self.confusion = grown
            self.num_classes = n
        np.add.at(self.confusion, (true, pred), 1)

    # ---- metrics
    def accuracy(self) -> float:
        c = self.confusion
        return float(np.trace(c) / max(c.sum(), 1))

    def _tp_fp_fn(self, cls):
        c = self.confusion
        tp = c[cls, cls]
        fp = c[:, cls].sum() - tp
        fn = c[cls, :].sum() - tp
        return tp, fp, fn

    def precision(self, cls: Optional[int] = None) -> float:
        if cls is not None:
            tp, fp, _ = self._tp_fp_fn(cls)
            return float(tp / max(tp + fp, 1))
        return float(np.mean([self.precision(i) for i in range(self.num_classes)]))

    def recall(self, cls: Optional[int] = None) -> float:
        if cls is not None:
            tp, _, fn = self._tp_fp_fn(cls)
            return float(tp / max(tp + fn, 1))
        return float(np.mean([self.recall(i) for i in range(self.num_classes)]))

    def f1(self, cls: Optional[int] = None) -> float:
        if cls is not None:
            p, r = self.precision(cls), self.recall(cls)
            return 2 * p * r / max(p + r, 1e-12)
        return float(np.mean([self.f1(i) for i in range(self.num_classes)]))

    def falsePositiveRate(self, cls: int) -> float:
        c = self.confusion
        tp, fp, fn = self._tp_fp_fn(cls)
        tn = c.sum() - tp - fp - fn
        return float(fp / max(fp + tn, 1))

    def matthewsCorrelation(self, cls: int) -> float:
        c = self.confusion
        tp, fp, fn = self._tp_fp_fn(cls)
        tn = c.sum() - tp - fp - fn
        denom = np.sqrt(float((tp + fp) * (tp + fn) * (tn + fp) * (tn + fn)))
        return float((tp * tn - fp * fn) / max(denom, 1e-12))

    def confusionMatrix(self) -> np.ndarray:
        return self.confusion

    def stats(self) -> str:
        lines = [
            f"# of classes: {self.num_classes}",
            f"Accuracy:  {self.accuracy():.4f}",
            f"Precision: {self.precision():.4f}",
            f"Recall:    {self.recall():.4f}",
            f"F1 Score:  {self.f1():.4f}",
            "Confusion matrix:",
            str(self.confusion),
        ]
        return "\n".join(lines)


class RegressionEvaluation:
    """(ref: org.nd4j.evaluation.regression.RegressionEvaluation): MSE, MAE,
    RMSE, R^2, pearson correlation — per-column streaming."""

    def __init__(self, n_columns: Optional[int] = None):
        self.n = 0
        self.sum_err2 = None
        self.sum_abs = None
        self.sum_y = None
        self.sum_y2 = None
        self.sum_p = None
        self.sum_p2 = None
        self.sum_yp = None

    def eval(self, labels, predictions, mask=None):
        y = _np(labels).astype(np.float64)
        p = _np(predictions).astype(np.float64)
        y = y.reshape(-1, y.shape[-1])
        p = p.reshape(-1, p.shape[-1])
        if mask is None:
            m = np.ones((y.shape[0], 1))
        else:
            m = _np(mask).astype(np.float64)
            m = m.reshape(-1, y.shape[-1]) if m.size == y.size \
                else m.reshape(-1, 1)  # per-timestep mask broadcast over cols
        if self.sum_err2 is None:
            cols = y.shape[-1]
            self.sum_err2 = np.zeros(cols)
            self.sum_abs = np.zeros(cols)
            self.sum_y = np.zeros(cols)
            self.sum_y2 = np.zeros(cols)
            self.sum_p = np.zeros(cols)
            self.sum_p2 = np.zeros(cols)
            self.sum_yp = np.zeros(cols)
        self.n = self.n + m.sum(0)  # per-col counts ((1,) broadcasts)
        self.sum_err2 += ((p - y) ** 2 * m).sum(0)
        self.sum_abs += (np.abs(p - y) * m).sum(0)
        self.sum_y += (y * m).sum(0)
        self.sum_y2 += (y ** 2 * m).sum(0)
        self.sum_p += (p * m).sum(0)
        self.sum_p2 += (p ** 2 * m).sum(0)
        self.sum_yp += (y * p * m).sum(0)

    def meanSquaredError(self, col=None):
        mse = self.sum_err2 / self.n
        return float(mse.mean() if col is None else mse[col])

    def meanAbsoluteError(self, col=None):
        mae = self.sum_abs / self.n
        return float(mae.mean() if col is None else mae[col])

    def rootMeanSquaredError(self, col=None):
        return float(np.sqrt(self.meanSquaredError(col)))

    def rSquared(self, col=None):
        ss_res = self.sum_err2
        ss_tot = self.sum_y2 - self.sum_y ** 2 / self.n
        r2 = 1.0 - ss_res / np.maximum(ss_tot, 1e-12)
        return float(r2.mean() if col is None else r2[col])

    def pearsonCorrelation(self, col=None):
        cov = self.sum_yp - self.sum_y * self.sum_p / self.n
        vy = self.sum_y2 - self.sum_y ** 2 / self.n
        vp = self.sum_p2 - self.sum_p ** 2 / self.n
        r = cov / np.maximum(np.sqrt(vy * vp), 1e-12)
        return float(r.mean() if col is None else r[col])

    def stats(self) -> str:
        return (f"MSE: {self.meanSquaredError():.6f}  MAE: {self.meanAbsoluteError():.6f}  "
                f"RMSE: {self.rootMeanSquaredError():.6f}  R^2: {self.rSquared():.4f}")


class ROC:
    """Binary ROC/AUC with exact computation (ref: org.nd4j.evaluation.classification.ROC
    with thresholdSteps=0 'exact' mode)."""

    def __init__(self):
        self.scores = []
        self.labels = []

    def eval(self, labels, predictions, mask=None):
        y = _np(labels)
        p = _np(predictions)
        if y.ndim > 1 and y.shape[-1] == 2:  # one-hot binary: positive = col 1
            y = y[..., 1]
            p = p[..., 1]
        self.labels.append(y.reshape(-1))
        self.scores.append(p.reshape(-1))

    def calculateAUC(self) -> float:
        y = np.concatenate(self.labels)
        s = np.concatenate(self.scores)
        order = np.argsort(-s, kind="stable")
        y = y[order]
        tp = np.cumsum(y)
        fp = np.cumsum(1 - y)
        n_pos, n_neg = max(tp[-1], 1e-12), max(fp[-1], 1e-12)
        tpr = np.concatenate([[0.0], tp / n_pos])
        fpr = np.concatenate([[0.0], fp / n_neg])
        return float(np.trapezoid(tpr, fpr))

    def calculateAUCPR(self) -> float:
        y = np.concatenate(self.labels)
        s = np.concatenate(self.scores)
        order = np.argsort(-s, kind="stable")
        y = y[order]
        tp = np.cumsum(y)
        precision = tp / np.arange(1, len(y) + 1)
        recall = tp / max(tp[-1], 1e-12)
        return float(np.trapezoid(precision, recall))


class ROCMultiClass:
    """One-vs-all ROC per class (ref: org.nd4j.evaluation.classification.ROCMultiClass)."""

    def __init__(self):
        self.per_class: dict[int, ROC] = {}

    def eval(self, labels, predictions, mask=None):
        y = _np(labels)
        p = _np(predictions)
        for c in range(y.shape[-1]):
            self.per_class.setdefault(c, ROC()).eval(y[..., c], p[..., c])

    def calculateAUC(self, cls: int) -> float:
        return self.per_class[cls].calculateAUC()

    def calculateAverageAUC(self) -> float:
        return float(np.mean([r.calculateAUC() for r in self.per_class.values()]))


class EvaluationBinary:
    """Per-output independent binary metrics for multi-label sigmoid outputs
    (ref: org.nd4j.evaluation.classification.EvaluationBinary — counts
    TP/FP/TN/FN per output column at a 0.5 decision threshold, mask-aware)."""

    def __init__(self, n_columns: Optional[int] = None, decision_threshold: float = 0.5):
        self.n = n_columns
        self.threshold = decision_threshold
        self._tp = self._fp = self._tn = self._fn = None

    def _ensure(self, n):
        if self._tp is None:
            self.n = n
            self._tp = np.zeros(n); self._fp = np.zeros(n)
            self._tn = np.zeros(n); self._fn = np.zeros(n)

    def eval(self, labels, predictions, mask=None):
        y = _np(labels)
        p = _np(predictions)
        y2 = y.reshape(-1, y.shape[-1])
        p2 = p.reshape(-1, p.shape[-1])
        self._ensure(y2.shape[-1])
        m = np.ones(y2.shape) if mask is None else _np(mask).reshape(-1, y2.shape[-1])
        pred = (p2 >= self.threshold).astype(np.float64)
        self._tp += ((pred == 1) & (y2 == 1) & (m > 0)).sum(0)
        self._fp += ((pred == 1) & (y2 == 0) & (m > 0)).sum(0)
        self._tn += ((pred == 0) & (y2 == 0) & (m > 0)).sum(0)
        self._fn += ((pred == 0) & (y2 == 1) & (m > 0)).sum(0)

    def truePositives(self, col):  return int(self._tp[col])
    def falsePositives(self, col): return int(self._fp[col])
    def trueNegatives(self, col):  return int(self._tn[col])
    def falseNegatives(self, col): return int(self._fn[col])

    def accuracy(self, col) -> float:
        tot = self._tp[col] + self._fp[col] + self._tn[col] + self._fn[col]
        return float((self._tp[col] + self._tn[col]) / max(tot, 1e-12))

    def precision(self, col) -> float:
        return float(self._tp[col] / max(self._tp[col] + self._fp[col], 1e-12))

    def recall(self, col) -> float:
        return float(self._tp[col] / max(self._tp[col] + self._fn[col], 1e-12))

    def f1(self, col) -> float:
        pr, rc = self.precision(col), self.recall(col)
        return 2 * pr * rc / max(pr + rc, 1e-12)

    def averageAccuracy(self) -> float:
        return float(np.mean([self.accuracy(i) for i in range(self.n)]))

    def averageF1(self) -> float:
        return float(np.mean([self.f1(i) for i in range(self.n)]))

    def stats(self) -> str:
        lines = ["EvaluationBinary (threshold %.2f)" % self.threshold]
        for i in range(self.n or 0):
            lines.append(
                f"  out {i}: acc {self.accuracy(i):.4f} precision "
                f"{self.precision(i):.4f} recall {self.recall(i):.4f} "
                f"f1 {self.f1(i):.4f}")
        return "\n".join(lines)


class ROCBinary:
    """Per-output-column ROC for multi-label binary outputs
    (ref: org.nd4j.evaluation.classification.ROCBinary)."""

    def __init__(self):
        self.per_output: dict[int, ROC] = {}

    def eval(self, labels, predictions, mask=None):
        y = _np(labels)
        p = _np(predictions)
        y2 = y.reshape(-1, y.shape[-1])
        p2 = p.reshape(-1, p.shape[-1])
        m = None if mask is None else _np(mask).reshape(-1, y2.shape[-1])
        for c in range(y2.shape[-1]):
            yc, pc = y2[:, c], p2[:, c]
            if m is not None:
                keep = m[:, c] > 0
                yc, pc = yc[keep], pc[keep]
            self.per_output.setdefault(c, ROC()).eval(yc, pc)

    def calculateAUC(self, col: int) -> float:
        return self.per_output[col].calculateAUC()

    def calculateAUCPR(self, col: int) -> float:
        return self.per_output[col].calculateAUCPR()

    def calculateAverageAUC(self) -> float:
        return float(np.mean([r.calculateAUC() for r in self.per_output.values()]))


class EvaluationCalibration:
    """Probability-calibration diagnostics (ref: org.nd4j.evaluation.
    classification.EvaluationCalibration): reliability diagram (accuracy vs
    confidence per bin), expected calibration error, residual-probability and
    predicted-probability histograms."""

    def __init__(self, reliability_bins: int = 10, histogram_bins: int = 50):
        self.rbins = reliability_bins
        self.hbins = histogram_bins
        self._conf = []   # predicted prob of the true class's argmax decision
        self._hit = []    # argmax correct?
        self._probs = []  # every predicted probability (flattened)
        self._residuals = []  # |label - p| per class entry

    def eval(self, labels, predictions, mask=None):
        y = _np(labels).reshape(-1, _np(labels).shape[-1])
        p = _np(predictions).reshape(-1, y.shape[-1])
        if mask is not None:
            keep = _np(mask).reshape(-1) > 0
            y, p = y[keep], p[keep]
        pred_cls = p.argmax(-1)
        true_cls = y.argmax(-1)
        self._conf.append(p[np.arange(len(p)), pred_cls])
        self._hit.append((pred_cls == true_cls).astype(np.float64))
        self._probs.append(p.reshape(-1))
        self._residuals.append(np.abs(y - p).reshape(-1))

    def reliabilityDiagram(self):
        """(bin_centers, mean_confidence, accuracy, counts) per bin."""
        conf = np.concatenate(self._conf)
        hit = np.concatenate(self._hit)
        edges = np.linspace(0.0, 1.0, self.rbins + 1)
        idx = np.clip(np.digitize(conf, edges) - 1, 0, self.rbins - 1)
        centers = (edges[:-1] + edges[1:]) / 2
        mean_conf = np.zeros(self.rbins)
        acc = np.zeros(self.rbins)
        counts = np.zeros(self.rbins)
        for b in range(self.rbins):
            sel = idx == b
            counts[b] = sel.sum()
            if counts[b]:
                mean_conf[b] = conf[sel].mean()
                acc[b] = hit[sel].mean()
        return centers, mean_conf, acc, counts

    def expectedCalibrationError(self) -> float:
        _, mean_conf, acc, counts = self.reliabilityDiagram()
        total = max(counts.sum(), 1e-12)
        return float(np.sum(counts / total * np.abs(acc - mean_conf)))

    def probabilityHistogram(self):
        probs = np.concatenate(self._probs)
        counts, edges = np.histogram(probs, bins=self.hbins, range=(0.0, 1.0))
        return edges, counts

    def residualPlot(self):
        res = np.concatenate(self._residuals)
        counts, edges = np.histogram(res, bins=self.hbins, range=(0.0, 1.0))
        return edges, counts

    def stats(self) -> str:
        return (f"EvaluationCalibration: ECE "
                f"{self.expectedCalibrationError():.4f} over {self.rbins} bins")
