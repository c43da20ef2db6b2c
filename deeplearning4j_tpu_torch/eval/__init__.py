"""Evaluation: classification, regression and ROC, numpy only."""
from .evaluation import ConfusionMatrix, Evaluation
from .regression import RegressionEvaluation
from .roc import ROC, ROCMultiClass

__all__ = ["ConfusionMatrix", "Evaluation", "ROC", "ROCMultiClass",
           "RegressionEvaluation"]
