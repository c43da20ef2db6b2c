"""Classification evaluation: accuracy, precision, recall, F1 and the
confusion matrix.

Counterpart of ``deeplearning4j_tpu/eval/evaluation.py``, numpy only, with
the same counts and metrics. Time-series input ``[B, T, C]`` is flattened
with the label mask applied. Accumulation is host bookkeeping; the forward
that produces the guesses runs on the network's device.
"""
from __future__ import annotations

from typing import Optional

import numpy as np


class ConfusionMatrix:
    def __init__(self, n_classes: int):
        self.n_classes = n_classes
        self.matrix = np.zeros((n_classes, n_classes), dtype=np.int64)

    def add(self, actual: int, predicted: int, count: int = 1) -> None:
        self.matrix[actual, predicted] += count

    def get_count(self, actual: int, predicted: int) -> int:
        return int(self.matrix[actual, predicted])

    def actual_total(self, cls: int) -> int:
        return int(self.matrix[cls].sum())

    def predicted_total(self, cls: int) -> int:
        return int(self.matrix[:, cls].sum())

    def __str__(self) -> str:
        return str(self.matrix)


class Prediction:
    """Per-example prediction with attached metadata for error attribution
    (reference eval/meta/Prediction.java)."""

    __slots__ = ("actual", "predicted", "record_meta_data")

    def __init__(self, actual: int, predicted: int, record_meta_data=None):
        self.actual = actual
        self.predicted = predicted
        self.record_meta_data = record_meta_data

    def __repr__(self) -> str:
        return (f"Prediction(actual={self.actual}, "
                f"predicted={self.predicted}, meta={self.record_meta_data!r})")


class Evaluation:
    """Classification accumulator.

    ``labels`` attaches class-label names used in ``stats()`` and the rendered
    confusion matrix (reference eval/Evaluation.java labeled constructors);
    ``top_n > 1`` additionally tracks top-N accuracy — a guess counts if the
    true class is among the N highest-probability outputs (reference
    Evaluation(List<String> labels, int topN) and stats() top-N block).
    """

    def __init__(self, n_classes: Optional[int] = None, labels: Optional[list] = None,
                 top_n: int = 1):
        self.labels = list(labels) if labels else None
        self.n_classes = n_classes or (len(labels) if labels else None)
        self.top_n = max(1, int(top_n))
        self.top_n_correct = 0
        self.confusion: Optional[ConfusionMatrix] = None
        self.num_examples = 0
        self._predictions: list = []

    def label_name(self, cls: int) -> str:
        if self.labels and 0 <= cls < len(self.labels):
            return str(self.labels[cls])
        return str(cls)

    def _ensure(self, n: int):
        if self.confusion is None:
            self.n_classes = self.n_classes or n
            self.confusion = ConfusionMatrix(self.n_classes)

    def eval(self, labels: np.ndarray, predictions: np.ndarray,
             mask: Optional[np.ndarray] = None,
             record_meta_data: Optional[list] = None) -> None:
        """labels/predictions: one-hot/probabilities [B,C] or time series [B,T,C]."""
        labels = np.asarray(labels)
        predictions = np.asarray(predictions)
        if labels.ndim == 3:  # [B,T,C] -> flatten with mask
            B, T, C = labels.shape
            labels = labels.reshape(-1, C)
            predictions = predictions.reshape(-1, C)
            if record_meta_data is not None:
                # metadata is per example; replicate across that example's
                # timesteps so flattened rows keep the right attribution
                record_meta_data = [
                    record_meta_data[b] if b < len(record_meta_data) else None
                    for b in range(B) for _ in range(T)]
            if mask is not None:
                keep = np.asarray(mask).reshape(-1) > 0
                labels, predictions = labels[keep], predictions[keep]
                if record_meta_data is not None:
                    record_meta_data = [m for m, k in
                                        zip(record_meta_data, keep) if k]
        elif mask is not None:  # [B, C] with a per-example mask
            keep = np.asarray(mask).reshape(-1) > 0
            labels, predictions = labels[keep], predictions[keep]
            if record_meta_data is not None:
                record_meta_data = [m for m, k in
                                    zip(record_meta_data, keep) if k]
        self._ensure(labels.shape[-1])
        actual = labels.argmax(-1)
        guess = predictions.argmax(-1)
        if self.top_n > 1 and len(actual):
            n = min(self.top_n, predictions.shape[-1])
            topk = np.argpartition(predictions, -n, axis=-1)[:, -n:]
            self.top_n_correct += int((topk == actual[:, None]).any(-1).sum())
        else:
            self.top_n_correct += int((actual == guess).sum())
        for i, (a, g) in enumerate(zip(actual, guess)):
            self.confusion.add(int(a), int(g))
            if record_meta_data is not None:
                meta = record_meta_data[i] if i < len(record_meta_data) else None
                self._predictions.append(Prediction(int(a), int(g), meta))
        self.num_examples += len(actual)

    # ---------------------------------------------------- metadata attribution
    def get_prediction_errors(self) -> list:
        """Mispredicted examples with metadata (reference
        Evaluation.getPredictionErrors)."""
        return [p for p in self._predictions if p.actual != p.predicted]

    def get_predictions_by_actual_class(self, cls: int) -> list:
        return [p for p in self._predictions if p.actual == cls]

    def get_predictions_by_predicted_class(self, cls: int) -> list:
        return [p for p in self._predictions if p.predicted == cls]

    def get_predictions(self, actual: int, predicted: int) -> list:
        return [p for p in self._predictions
                if p.actual == actual and p.predicted == predicted]

    # ------------------------------------------------------------------ metrics
    def true_positives(self, cls: int) -> int:
        return self.confusion.get_count(cls, cls)

    def false_positives(self, cls: int) -> int:
        return self.confusion.predicted_total(cls) - self.true_positives(cls)

    def false_negatives(self, cls: int) -> int:
        return self.confusion.actual_total(cls) - self.true_positives(cls)

    def accuracy(self) -> float:
        if self.num_examples == 0:
            return 0.0
        return float(np.trace(self.confusion.matrix)) / self.num_examples

    def precision(self, cls: Optional[int] = None) -> float:
        if cls is not None:
            pt = self.confusion.predicted_total(cls)
            return self.true_positives(cls) / pt if pt else 0.0
        vals = [self.precision(c) for c in range(self.n_classes)
                if self.confusion.actual_total(c) > 0]
        return float(np.mean(vals)) if vals else 0.0

    def recall(self, cls: Optional[int] = None) -> float:
        if cls is not None:
            at = self.confusion.actual_total(cls)
            return self.true_positives(cls) / at if at else 0.0
        vals = [self.recall(c) for c in range(self.n_classes)
                if self.confusion.actual_total(c) > 0]
        return float(np.mean(vals)) if vals else 0.0

    def f1(self, cls: Optional[int] = None) -> float:
        p, r = self.precision(cls), self.recall(cls)
        return 2 * p * r / (p + r) if (p + r) else 0.0

    def top_n_accuracy(self) -> float:
        """Fraction of examples whose true class was in the top-N guesses
        (reference Evaluation.topNAccuracy())."""
        if self.num_examples == 0:
            return 0.0
        return self.top_n_correct / self.num_examples

    def stats(self) -> str:
        """Human-readable summary with class-label names when provided
        (reference Evaluation.stats():352)."""
        lines = ["==========================Scores========================================",
                 f" Examples:  {self.num_examples}",
                 f" Accuracy:  {self.accuracy():.4f}"]
        if self.top_n > 1:
            lines.append(f" Top-{self.top_n} Accuracy: {self.top_n_accuracy():.4f}")
        lines += [f" Precision: {self.precision():.4f}",
                  f" Recall:    {self.recall():.4f}",
                  f" F1 Score:  {self.f1():.4f}",
                  "========================================================================"]
        if self.confusion is not None and self.n_classes <= 20:
            names = [self.label_name(c) for c in range(self.n_classes)]
            w = max(len(n) for n in names)
            lines.append("Confusion matrix (rows = actual, cols = predicted):")
            cols = " ".join(f"{n:>{max(w, 5)}}" for n in names)
            lines.append(f"{'':>{w}} {cols}")
            for a in range(self.n_classes):
                row = " ".join(f"{self.confusion.get_count(a, p):>{max(w, 5)}}"
                               for p in range(self.n_classes))
                lines.append(f"{names[a]:>{w}} {row}")
        return "\n".join(lines)

    def merge(self, other: "Evaluation") -> "Evaluation":
        """Combine accumulated stats (used by distributed evaluation, reference
        spark impl/multilayer/evaluation/)."""
        if other.confusion is None:
            return self
        if self.confusion is None:
            self.n_classes = other.n_classes
            self.confusion = ConfusionMatrix(other.n_classes)
        if self.labels is None:
            self.labels = other.labels
        self.confusion.matrix += other.confusion.matrix
        self.num_examples += other.num_examples
        self.top_n_correct += other.top_n_correct
        self._predictions.extend(other._predictions)
        return self
