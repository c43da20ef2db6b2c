"""The early-stopping loop, for either network type.

Counterpart of ``deeplearning4j_tpu/earlystopping/trainer.py``: one ``fit``
call a minibatch, the iteration conditions after each, the score
calculator every ``evaluate_every_n_epochs`` epochs, the best model saved
whenever the score improves, the epoch conditions after each scored epoch.
An exception in an epoch ends the run with a ``TerminationReason.ERROR``
result, as in the JAX package, so a caller checks ``termination_reason``.

The minibatch score is a device scalar read lazily: it is read (one host
sync a step) only when there is an iteration condition to give it to.
"""
from __future__ import annotations

import logging
from typing import Optional

from .config import (EarlyStoppingConfiguration, EarlyStoppingResult,
                     TerminationReason)

log = logging.getLogger(__name__)


class EarlyStoppingListener:
    def on_start(self, config, model) -> None:
        pass

    def on_epoch(self, epoch: int, score: float, config, model) -> None:
        pass

    def on_completion(self, result: EarlyStoppingResult) -> None:
        pass


class EarlyStoppingTrainer:
    def __init__(self, config: EarlyStoppingConfiguration, model, iterator,
                 listener: Optional[EarlyStoppingListener] = None):
        self.config = config
        self.model = model
        self.iterator = iterator
        self.listener = listener

    def _fit_one(self, ds) -> None:
        from ..nn.graph_network import ComputationGraph, MultiDataSet

        if isinstance(self.model, ComputationGraph):
            self.model.fit(ds if isinstance(ds, MultiDataSet)
                           else MultiDataSet([ds.features], [ds.labels]))
        else:
            self.model.fit(ds.features, ds.labels)

    def _check_iteration_termination(self, cfg):
        if not cfg.iteration_termination_conditions:
            return None
        score = self.model.score_value
        for c in cfg.iteration_termination_conditions:
            if c.terminate(score):
                return c
        return None

    def _run_epoch(self, cfg):
        """One epoch of training; the iteration condition that fired, or
        None."""
        for ds in self.iterator:
            self._fit_one(ds)
            fired = self._check_iteration_termination(cfg)
            if fired is not None:
                return fired
        return None

    def _finish(self, reason, details, scores, best_epoch, best_score,
                epochs) -> EarlyStoppingResult:
        result = EarlyStoppingResult(
            reason, details, scores, best_epoch, best_score, epochs,
            self.config.model_saver.get_best_model())
        if self.listener:
            self.listener.on_completion(result)
        return result

    def fit(self) -> EarlyStoppingResult:
        cfg = self.config
        for c in cfg.iteration_termination_conditions:
            c.initialize()
        for c in cfg.epoch_termination_conditions:
            c.initialize()
        if self.listener:
            self.listener.on_start(cfg, self.model)

        score_vs_epoch: dict = {}
        best_score = float("inf")
        best_epoch = -1
        epoch = 0
        while True:
            if hasattr(self.iterator, "reset"):
                self.iterator.reset()
            try:
                fired = self._run_epoch(cfg)
            except Exception as e:  # an Error result, as in the JAX package
                log.warning("early stopping terminated by exception at "
                            "epoch %d: %s", epoch, e)
                return self._finish(TerminationReason.ERROR, str(e),
                                    score_vs_epoch, best_epoch, best_score,
                                    epoch)
            if fired is not None:
                if cfg.save_last_model:
                    cfg.model_saver.save_latest_model(self.model, 0.0)
                return self._finish(
                    TerminationReason.ITERATION_TERMINATION_CONDITION,
                    repr(fired), score_vs_epoch, best_epoch, best_score, epoch)

            epoch += 1
            if (epoch - 1) % cfg.evaluate_every_n_epochs != 0:
                continue
            sc = cfg.score_calculator
            score = sc.calculate_score(self.model) if sc else 0.0
            score_vs_epoch[epoch - 1] = score
            if sc is not None and score < best_score:
                best_score = score
                best_epoch = epoch - 1
                cfg.model_saver.save_best_model(self.model, score)
            if cfg.save_last_model:
                cfg.model_saver.save_latest_model(self.model, score)
            if self.listener:
                self.listener.on_epoch(epoch - 1, score, cfg, self.model)
            for c in cfg.epoch_termination_conditions:
                if c.terminate(epoch - 1, score):
                    return self._finish(
                        TerminationReason.EPOCH_TERMINATION_CONDITION,
                        repr(c), score_vs_epoch, best_epoch, best_score, epoch)


class EarlyStoppingParallelTrainer(EarlyStoppingTrainer):
    """Early stopping over data-parallel epochs: waits for the parallel
    modes (``parallel/wrapper.py``)."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(
            "EarlyStoppingParallelTrainer needs ParallelWrapper, which is not "
            "ported yet (ROADMAP.md A7); use EarlyStoppingTrainer")


#: the JAX package's alias of the one trainer for graphs
EarlyStoppingGraphTrainer = EarlyStoppingTrainer
