"""``EarlyStoppingConfiguration``, its builder, and the result types.

Counterpart of ``deeplearning4j_tpu/earlystopping/config.py``.
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Dict, List, Optional

from .savers import EarlyStoppingModelSaver, InMemoryModelSaver
from .scorecalc import ScoreCalculator
from .termination import EpochTerminationCondition, IterationTerminationCondition


class TerminationReason(enum.Enum):
    ERROR = "Error"
    ITERATION_TERMINATION_CONDITION = "IterationTerminationCondition"
    EPOCH_TERMINATION_CONDITION = "EpochTerminationCondition"


@dataclasses.dataclass
class EarlyStoppingResult:
    termination_reason: TerminationReason
    termination_details: str
    score_vs_epoch: Dict[int, float]
    best_model_epoch: int
    best_model_score: float
    total_epochs: int
    best_model: object

    def __repr__(self):
        return (f"EarlyStoppingResult(terminationReason={self.termination_reason},"
                f" details={self.termination_details},"
                f" bestModelEpoch={self.best_model_epoch},"
                f" bestModelScore={self.best_model_score},"
                f" totalEpochs={self.total_epochs})")


class EarlyStoppingConfiguration:
    """The termination conditions, the score calculator (None: no epoch is
    scored), the model saver (default: in memory), whether to save the last
    model too, and how often (in epochs) to score."""

    def __init__(self, epoch_termination_conditions=None,
                 iteration_termination_conditions=None,
                 score_calculator: Optional[ScoreCalculator] = None,
                 model_saver: Optional[EarlyStoppingModelSaver] = None,
                 save_last_model: bool = False,
                 evaluate_every_n_epochs: int = 1):
        self.epoch_termination_conditions: List[EpochTerminationCondition] = (
            list(epoch_termination_conditions or []))
        self.iteration_termination_conditions: List[
            IterationTerminationCondition] = list(
                iteration_termination_conditions or [])
        self.score_calculator = score_calculator
        self.model_saver = model_saver or InMemoryModelSaver()
        self.save_last_model = save_last_model
        self.evaluate_every_n_epochs = evaluate_every_n_epochs

    @staticmethod
    def builder() -> "EarlyStoppingConfigurationBuilder":
        return EarlyStoppingConfigurationBuilder()


class EarlyStoppingConfigurationBuilder:
    """The fluent builder of :class:`EarlyStoppingConfiguration`."""

    def __init__(self):
        self._epoch: list = []
        self._iteration: list = []
        self._score_calculator = None
        self._saver = None
        self._save_last = False
        self._every_n = 1

    def epoch_termination_conditions(self, *conds):
        self._epoch.extend(conds)
        return self

    def iteration_termination_conditions(self, *conds):
        self._iteration.extend(conds)
        return self

    def score_calculator(self, calc):
        self._score_calculator = calc
        return self

    def model_saver(self, saver):
        self._saver = saver
        return self

    def save_last_model(self, flag: bool = True):
        self._save_last = flag
        return self

    def evaluate_every_n_epochs(self, n: int):
        self._every_n = n
        return self

    def build(self) -> EarlyStoppingConfiguration:
        return EarlyStoppingConfiguration(
            epoch_termination_conditions=self._epoch,
            iteration_termination_conditions=self._iteration,
            score_calculator=self._score_calculator,
            model_saver=self._saver,
            save_last_model=self._save_last,
            evaluate_every_n_epochs=self._every_n)
