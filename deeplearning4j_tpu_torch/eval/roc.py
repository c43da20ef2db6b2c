"""ROC and AUC with thresholded accumulation.

Counterpart of ``deeplearning4j_tpu/eval/roc.py``, numpy only: fixed
threshold steps, so accumulation streams in O(steps) memory.
"""
from __future__ import annotations

import numpy as np

#: numpy 2 names the trapezoidal rule ``trapezoid``, numpy 1 ``trapz``
_trapezoid = getattr(np, "trapezoid", None) or np.trapz


class ROC:
    """Binary ROC. Labels: [B,1] {0,1} or [B,2] one-hot; predictions same shape
    (probability of class 1 in column -1)."""

    def __init__(self, threshold_steps: int = 30):
        self.threshold_steps = threshold_steps
        self.thresholds = np.linspace(0.0, 1.0, threshold_steps + 1)
        self.tp = np.zeros(threshold_steps + 1, np.int64)
        self.fp = np.zeros(threshold_steps + 1, np.int64)
        self.tn = np.zeros(threshold_steps + 1, np.int64)
        self.fn = np.zeros(threshold_steps + 1, np.int64)

    def eval(self, labels: np.ndarray, predictions: np.ndarray) -> None:
        labels = np.asarray(labels)
        predictions = np.asarray(predictions)
        if labels.ndim == 2 and labels.shape[1] == 2:
            pos = labels[:, 1] > 0.5
            prob = predictions[:, 1]
        else:
            pos = labels.reshape(-1) > 0.5
            prob = predictions.reshape(-1)
        for i, t in enumerate(self.thresholds):
            pred_pos = prob >= t
            self.tp[i] += int(np.sum(pred_pos & pos))
            self.fp[i] += int(np.sum(pred_pos & ~pos))
            self.fn[i] += int(np.sum(~pred_pos & pos))
            self.tn[i] += int(np.sum(~pred_pos & ~pos))

    def get_roc_curve(self):
        """[(threshold, fpr, tpr)] points."""
        pts = []
        for i, t in enumerate(self.thresholds):
            tpr = self.tp[i] / max(self.tp[i] + self.fn[i], 1)
            fpr = self.fp[i] / max(self.fp[i] + self.tn[i], 1)
            pts.append((float(t), float(fpr), float(tpr)))
        return pts

    def calculate_auc(self) -> float:
        """Trapezoidal AUC over the thresholded curve (reference ROC.calculateAUC)."""
        pts = sorted((fpr, tpr) for _, fpr, tpr in self.get_roc_curve())
        xs = [p[0] for p in pts]
        ys = [p[1] for p in pts]
        return float(_trapezoid(ys, xs))


class ROCMultiClass:
    """One-vs-all ROC per class (reference ROCMultiClass.java)."""

    def __init__(self, threshold_steps: int = 30):
        self.threshold_steps = threshold_steps
        self.per_class: dict[int, ROC] = {}

    def eval(self, labels: np.ndarray, predictions: np.ndarray) -> None:
        labels = np.asarray(labels)
        predictions = np.asarray(predictions)
        n_classes = labels.shape[-1]
        for c in range(n_classes):
            roc = self.per_class.setdefault(c, ROC(self.threshold_steps))
            roc.eval(labels[:, c:c + 1], predictions[:, c:c + 1])

    def calculate_auc(self, cls: int) -> float:
        return self.per_class[cls].calculate_auc()

    def calculate_average_auc(self) -> float:
        return float(np.mean([r.calculate_auc() for r in self.per_class.values()]))
