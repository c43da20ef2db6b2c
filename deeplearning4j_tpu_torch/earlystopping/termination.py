"""Termination conditions: epoch conditions see ``(epoch, score)``,
iteration conditions the last minibatch's score.

Counterpart of ``deeplearning4j_tpu/earlystopping/termination.py``. The
invalid-score condition uses ``observability.health.is_invalid_score``, the
predicate the training-health alarm uses, so the two never disagree.
"""
from __future__ import annotations

import time

from ..observability.health import is_invalid_score


class EpochTerminationCondition:
    def initialize(self) -> None:
        pass

    def terminate(self, epoch: int, score: float) -> bool:
        raise NotImplementedError


class IterationTerminationCondition:
    def initialize(self) -> None:
        pass

    def terminate(self, score: float) -> bool:
        raise NotImplementedError


class MaxEpochsTerminationCondition(EpochTerminationCondition):
    """Stop after ``max_epochs`` epochs."""

    def __init__(self, max_epochs: int):
        if max_epochs <= 0:
            raise ValueError("max_epochs must be > 0")
        self.max_epochs = max_epochs

    def terminate(self, epoch: int, score: float) -> bool:
        return epoch + 1 >= self.max_epochs

    def __repr__(self):
        return f"MaxEpochsTerminationCondition({self.max_epochs})"


class ScoreImprovementEpochTerminationCondition(EpochTerminationCondition):
    """Stop when the score has not improved on the best by more than
    ``min_improvement`` for more than ``max_epochs_without_improvement``
    epochs."""

    def __init__(self, max_epochs_without_improvement: int,
                 min_improvement: float = 0.0):
        self.max_epochs_without_improvement = max_epochs_without_improvement
        self.min_improvement = min_improvement
        self.best_score = None
        self.epochs_without = 0

    def initialize(self) -> None:
        self.best_score = None
        self.epochs_without = 0

    def terminate(self, epoch: int, score: float) -> bool:
        if self.best_score is None or \
                self.best_score - score > self.min_improvement:
            self.best_score = score if self.best_score is None else min(
                self.best_score, score)
            self.epochs_without = 0
            return False
        self.epochs_without += 1
        return self.epochs_without > self.max_epochs_without_improvement

    def __repr__(self):
        return (f"ScoreImprovementEpochTerminationCondition("
                f"{self.max_epochs_without_improvement}, "
                f"{self.min_improvement})")


class BestScoreEpochTerminationCondition(EpochTerminationCondition):
    """Stop once the score passes a target (below it when
    ``lesser_better``)."""

    def __init__(self, best_expected_score: float, lesser_better: bool = True):
        self.best_expected_score = best_expected_score
        self.lesser_better = lesser_better

    def terminate(self, epoch: int, score: float) -> bool:
        if self.lesser_better:
            return score < self.best_expected_score
        return score > self.best_expected_score

    def __repr__(self):
        return f"BestScoreEpochTerminationCondition({self.best_expected_score})"


class MaxTimeIterationTerminationCondition(IterationTerminationCondition):
    """Stop once ``max_seconds`` of wall time have passed since the start."""

    def __init__(self, max_seconds: float):
        self.max_seconds = max_seconds
        self._end = None

    def initialize(self) -> None:
        self._end = time.monotonic() + self.max_seconds

    def terminate(self, score: float) -> bool:
        return self._end is not None and time.monotonic() >= self._end

    def __repr__(self):
        return f"MaxTimeIterationTerminationCondition({self.max_seconds}s)"


class MaxScoreIterationTerminationCondition(IterationTerminationCondition):
    """Stop when a minibatch's score exceeds ``max_score``."""

    def __init__(self, max_score: float):
        self.max_score = max_score

    def terminate(self, score: float) -> bool:
        return score > self.max_score

    def __repr__(self):
        return f"MaxScoreIterationTerminationCondition({self.max_score})"


class InvalidScoreIterationTerminationCondition(IterationTerminationCondition):
    """Stop on a NaN or infinite minibatch score."""

    def terminate(self, score: float) -> bool:
        return is_invalid_score(score)

    def __repr__(self):
        return "InvalidScoreIterationTerminationCondition()"
