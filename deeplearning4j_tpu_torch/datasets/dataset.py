"""``DataSet``: features and labels with their optional masks.

Counterpart of the container in ``deeplearning4j_tpu/datasets/dataset.py``:
numpy arrays (or tensors), ``features_mask`` and ``labels_mask`` ``[B, T]``
{0,1}, with ``num_examples``, ``split_test_and_train``, ``shuffle`` and
``batch_by``; and the normalizers, ``NormalizerStandardize`` (which the
model zip carries as ``normalizer.npz``) and ``NormalizerMinMaxScaler``,
numpy on the host as in the JAX package.
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


def _flat(features) -> np.ndarray:
    return features.reshape(features.shape[0], -1)


class NormalizerStandardize:
    """Feature-wise zero mean and unit variance (``std`` carries 1e-8, as
    in the JAX package); ``to_arrays``/``from_arrays`` are the model zip's
    ``normalizer.npz``."""

    def __init__(self):
        self.mean: Optional[np.ndarray] = None
        self.std: Optional[np.ndarray] = None

    def fit(self, ds: DataSet) -> None:
        flat = _flat(ds.features)
        self.mean = flat.mean(axis=0)
        self.std = flat.std(axis=0) + 1e-8

    def transform(self, ds: DataSet) -> None:
        shape = ds.features.shape
        ds.features = ((_flat(ds.features) - self.mean) / self.std
                       ).reshape(shape)

    def revert(self, ds: DataSet) -> None:
        shape = ds.features.shape
        ds.features = (_flat(ds.features) * self.std + self.mean
                       ).reshape(shape)

    def to_arrays(self) -> dict:
        return {"mean": self.mean, "std": self.std}

    @staticmethod
    def from_arrays(d: dict) -> "NormalizerStandardize":
        n = NormalizerStandardize()
        n.mean, n.std = d["mean"], d["std"]
        return n


class NormalizerMinMaxScaler:
    """Feature-wise scaling of ``[min, max]`` to ``[min_range,
    max_range]``; a constant feature scales by 1."""

    def __init__(self, min_range: float = 0.0, max_range: float = 1.0):
        self.min_range = min_range
        self.max_range = max_range
        self.data_min: Optional[np.ndarray] = None
        self.data_max: Optional[np.ndarray] = None

    def fit(self, ds: DataSet) -> None:
        flat = _flat(ds.features)
        self.data_min = flat.min(axis=0)
        self.data_max = flat.max(axis=0)

    def _range(self) -> np.ndarray:
        return np.where(self.data_max > self.data_min,
                        self.data_max - self.data_min, 1.0)

    def transform(self, ds: DataSet) -> None:
        shape = ds.features.shape
        scaled = (_flat(ds.features) - self.data_min) / self._range()
        ds.features = (scaled * (self.max_range - self.min_range)
                       + self.min_range).reshape(shape)

    def revert(self, ds: DataSet) -> None:
        shape = ds.features.shape
        scaled = ((_flat(ds.features) - self.min_range)
                  / (self.max_range - self.min_range))
        ds.features = (scaled * self._range() + self.data_min).reshape(shape)

    def to_arrays(self) -> dict:
        return {"data_min": self.data_min, "data_max": self.data_max,
                "range": np.asarray([self.min_range, self.max_range])}

    @staticmethod
    def from_arrays(d: dict) -> "NormalizerMinMaxScaler":
        lo, hi = (float(v) for v in d["range"])
        n = NormalizerMinMaxScaler(lo, hi)
        n.data_min, n.data_max = d["data_min"], d["data_max"]
        return n
