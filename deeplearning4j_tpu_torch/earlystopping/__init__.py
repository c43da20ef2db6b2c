"""Early stopping: train epoch by epoch, score each on held-out data, keep
the best model, and stop when a termination condition fires."""
from .config import (
    EarlyStoppingConfiguration, EarlyStoppingConfigurationBuilder,
    EarlyStoppingResult, TerminationReason)
from .savers import (
    EarlyStoppingModelSaver, InMemoryModelSaver, LocalFileModelSaver)
from .scorecalc import DataSetLossCalculator, ScoreCalculator
from .termination import (
    BestScoreEpochTerminationCondition, EpochTerminationCondition,
    InvalidScoreIterationTerminationCondition, IterationTerminationCondition,
    MaxEpochsTerminationCondition, MaxScoreIterationTerminationCondition,
    MaxTimeIterationTerminationCondition,
    ScoreImprovementEpochTerminationCondition, is_invalid_score)
from .trainer import (
    EarlyStoppingGraphTrainer, EarlyStoppingListener,
    EarlyStoppingParallelTrainer, EarlyStoppingTrainer)

__all__ = [
    "BestScoreEpochTerminationCondition", "DataSetLossCalculator",
    "EarlyStoppingConfiguration", "EarlyStoppingConfigurationBuilder",
    "EarlyStoppingGraphTrainer", "EarlyStoppingListener",
    "EarlyStoppingModelSaver", "EarlyStoppingParallelTrainer",
    "EarlyStoppingResult", "EarlyStoppingTrainer",
    "EpochTerminationCondition", "InMemoryModelSaver",
    "InvalidScoreIterationTerminationCondition",
    "IterationTerminationCondition", "LocalFileModelSaver",
    "MaxEpochsTerminationCondition", "MaxScoreIterationTerminationCondition",
    "MaxTimeIterationTerminationCondition", "ScoreCalculator",
    "ScoreImprovementEpochTerminationCondition", "TerminationReason",
    "is_invalid_score"]
