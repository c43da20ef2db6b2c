"""Regression evaluation: per-column MSE, MAE, RMSE, RSE and correlation.

Counterpart of ``deeplearning4j_tpu/eval/regression.py``, numpy only.
"""
from __future__ import annotations

from typing import Optional

import numpy as np


class RegressionEvaluation:
    def __init__(self, column_names: Optional[list] = None):
        self.column_names = column_names
        self._sum_sq_err = None
        self._sum_abs_err = None
        self._sum_label = None
        self._sum_label_sq = None
        self._sum_pred = None
        self._sum_pred_sq = None
        self._sum_label_pred = None
        self.n = 0

    def _ensure(self, c):
        if self._sum_sq_err is None:
            z = lambda: np.zeros(c, np.float64)
            self._sum_sq_err, self._sum_abs_err = z(), z()
            self._sum_label, self._sum_label_sq = z(), z()
            self._sum_pred, self._sum_pred_sq, self._sum_label_pred = z(), z(), z()

    def eval(self, labels: np.ndarray, predictions: np.ndarray,
             mask: Optional[np.ndarray] = None) -> None:
        labels = np.asarray(labels, np.float64)
        predictions = np.asarray(predictions, np.float64)
        if labels.ndim == 3:
            C = labels.shape[-1]
            labels = labels.reshape(-1, C)
            predictions = predictions.reshape(-1, C)
            if mask is not None:
                keep = np.asarray(mask).reshape(-1) > 0
                labels, predictions = labels[keep], predictions[keep]
        self._ensure(labels.shape[-1])
        err = labels - predictions
        self._sum_sq_err += (err ** 2).sum(0)
        self._sum_abs_err += np.abs(err).sum(0)
        self._sum_label += labels.sum(0)
        self._sum_label_sq += (labels ** 2).sum(0)
        self._sum_pred += predictions.sum(0)
        self._sum_pred_sq += (predictions ** 2).sum(0)
        self._sum_label_pred += (labels * predictions).sum(0)
        self.n += labels.shape[0]

    def mean_squared_error(self, col: int = 0) -> float:
        return float(self._sum_sq_err[col] / self.n)

    def mean_absolute_error(self, col: int = 0) -> float:
        return float(self._sum_abs_err[col] / self.n)

    def root_mean_squared_error(self, col: int = 0) -> float:
        return float(np.sqrt(self._sum_sq_err[col] / self.n))

    def relative_squared_error(self, col: int = 0) -> float:
        mean_label = self._sum_label[col] / self.n
        denom = self._sum_label_sq[col] - self.n * mean_label ** 2
        return float(self._sum_sq_err[col] / denom) if denom else 0.0

    def correlation_r2(self, col: int = 0) -> float:
        n = self.n
        num = n * self._sum_label_pred[col] - self._sum_label[col] * self._sum_pred[col]
        den = (np.sqrt(n * self._sum_label_sq[col] - self._sum_label[col] ** 2)
               * np.sqrt(n * self._sum_pred_sq[col] - self._sum_pred[col] ** 2))
        return float(num / den) if den else 0.0

    def num_columns(self) -> int:
        return len(self._sum_sq_err) if self._sum_sq_err is not None else 0

    def stats(self) -> str:
        cols = self.num_columns()
        lines = ["Column    MSE            MAE            RMSE           RSE            R"]
        for c in range(cols):
            name = (self.column_names[c] if self.column_names and c < len(self.column_names)
                    else f"col_{c}")
            lines.append(f"{name:<9} {self.mean_squared_error(c):<14.6g} "
                         f"{self.mean_absolute_error(c):<14.6g} "
                         f"{self.root_mean_squared_error(c):<14.6g} "
                         f"{self.relative_squared_error(c):<14.6g} "
                         f"{self.correlation_r2(c):<.6g}")
        return "\n".join(lines)
