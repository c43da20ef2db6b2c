"""Score calculators: the loss over held-out data, for either network type.

Counterpart of ``deeplearning4j_tpu/earlystopping/scorecalc.py``.
"""
from __future__ import annotations


class ScoreCalculator:
    def calculate_score(self, model) -> float:
        raise NotImplementedError


class DataSetLossCalculator(ScoreCalculator):
    """The loss over an iterator of ``DataSet``\\ s (or ``MultiDataSet``\\ s
    for a graph): each batch's ``score`` weighted by its example count and
    averaged (``average=False``: summed)."""

    def __init__(self, iterator, average: bool = True):
        self.iterator = iterator
        self.average = average

    def calculate_score(self, model) -> float:
        from ..nn.graph_network import ComputationGraph, MultiDataSet

        if hasattr(self.iterator, "reset"):
            self.iterator.reset()
        total, n = 0.0, 0
        for ds in self.iterator:
            if isinstance(model, ComputationGraph):
                mds = (ds if isinstance(ds, MultiDataSet)
                       else MultiDataSet([ds.features], [ds.labels]))
                score = model.score(mds)
                examples = mds.num_examples()
            else:
                score = model.score(ds.features, ds.labels)
                examples = int(ds.features.shape[0])
            total += score * examples
            n += examples
        if n == 0:
            return 0.0
        return total / n if self.average else total
