"""``DataSet``: features and labels with their optional masks.

Counterpart of the container in ``deeplearning4j_tpu/datasets/dataset.py``:
numpy arrays (or tensors), ``features_mask`` and ``labels_mask`` ``[B, T]``
{0,1}, with ``num_examples``, ``split_test_and_train``, ``shuffle`` and
``batch_by``. The normalizers wait for the serializer's zip format
(ROADMAP.md).
"""
from __future__ import annotations

import dataclasses
from typing import Any, List, Optional, Tuple

import numpy as np


def _cut(a, sl):
    return None if a is None else a[sl]


@dataclasses.dataclass
class DataSet:
    features: Any
    labels: Any
    features_mask: Optional[Any] = None
    labels_mask: Optional[Any] = None

    def num_examples(self) -> int:
        return int(self.features.shape[0])

    def _take(self, sl) -> "DataSet":
        return DataSet(self.features[sl], self.labels[sl],
                       _cut(self.features_mask, sl), _cut(self.labels_mask, sl))

    def split_test_and_train(self, n_train: int) -> Tuple["DataSet", "DataSet"]:
        """The first ``n_train`` examples, and the rest."""
        return (self._take(slice(0, n_train)),
                self._take(slice(n_train, None)))

    def shuffle(self, seed: Optional[int] = None) -> None:
        """Permute the examples in place (``np.random.default_rng(seed)``,
        the JAX package's permutation for the same seed)."""
        idx = np.random.default_rng(seed).permutation(self.num_examples())
        shuffled = self._take(idx)
        self.features, self.labels = shuffled.features, shuffled.labels
        self.features_mask = shuffled.features_mask
        self.labels_mask = shuffled.labels_mask

    def batch_by(self, batch_size: int) -> List["DataSet"]:
        return [self._take(slice(i, i + batch_size))
                for i in range(0, self.num_examples(), batch_size)]
