"""The ``DataSetIterator`` family.

Counterpart of ``deeplearning4j_tpu/datasets/iterators.py``, with the same
batch orders: a list, arrays in minibatches (shuffled per epoch from
``seed + epoch``), a background-thread prefetch wrapper, repeated epochs,
sampling with replacement, and pre-built datasets. Each yields
``DataSet``\\ s of host arrays; ``fit`` moves a batch to the device.
"""
from __future__ import annotations

from typing import Iterator, Optional

import numpy as np

from .dataset import DataSet
from .prefetch import DevicePrefetcher


class DataSetIterator:
    """``for ds in it: ...``; ``reset()`` rewinds."""

    def __iter__(self) -> Iterator[DataSet]:
        raise NotImplementedError

    def reset(self) -> None:
        pass

    def batch_size(self) -> int:
        raise NotImplementedError

    def total_examples(self) -> int:
        raise NotImplementedError


class ListDataSetIterator(DataSetIterator):
    """A pre-built list of ``DataSet``\\ s."""

    def __init__(self, datasets: list, batch: Optional[int] = None):
        self._list = datasets
        self._batch = batch or (datasets[0].num_examples() if datasets else 0)

    def __iter__(self):
        return iter(self._list)

    def batch_size(self) -> int:
        return self._batch

    def total_examples(self) -> int:
        return sum(d.num_examples() for d in self._list)


def _rows(a, idx):
    return None if a is None else a[idx]


class ArrayDataSetIterator(DataSetIterator):
    """Minibatches of arrays; with ``shuffle`` the order of an epoch is a
    permutation from ``np.random.default_rng(seed + epoch)``. With
    ``drop_last`` a last partial batch is left out."""

    def __init__(self, features: np.ndarray, labels: np.ndarray, batch: int,
                 shuffle: bool = False, seed: int = 0,
                 features_mask: Optional[np.ndarray] = None,
                 labels_mask: Optional[np.ndarray] = None,
                 drop_last: bool = True):
        self.features = np.asarray(features)
        self.labels = np.asarray(labels)
        self.features_mask = features_mask
        self.labels_mask = labels_mask
        self._batch = batch
        self._shuffle = shuffle
        self._seed = seed
        self._epoch = 0
        self._drop_last = drop_last

    def __iter__(self):
        n = self.features.shape[0]
        idx = np.arange(n)
        if self._shuffle:
            np.random.default_rng(self._seed + self._epoch).shuffle(idx)
        self._epoch += 1
        end = n - n % self._batch if self._drop_last else n
        for i in range(0, end, self._batch):
            sl = idx[i:i + self._batch]
            yield DataSet(self.features[sl], self.labels[sl],
                          _rows(self.features_mask, sl),
                          _rows(self.labels_mask, sl))

    def batch_size(self) -> int:
        return self._batch

    def total_examples(self) -> int:
        return int(self.features.shape[0])


class AsyncDataSetIterator(DataSetIterator):
    """Prefetches ``base``'s batches on a background thread, up to
    ``queue_size`` ahead, in ``base``'s order."""

    def __init__(self, base: DataSetIterator, queue_size: int = 4):
        self.base = base
        self.queue_size = queue_size
        self._pf: Optional[DevicePrefetcher] = None  # the latest producer

    def __iter__(self):
        self.close()  # a new pass abandons the previous producer
        self._pf = DevicePrefetcher(self.base, depth=max(1, self.queue_size),
                                    path=None)
        return iter(self._pf)

    def close(self) -> None:
        if self._pf is not None:
            self._pf.close()

    def reset(self) -> None:
        self.close()
        if hasattr(self.base, "reset"):
            self.base.reset()

    def batch_size(self) -> int:
        return self.base.batch_size()

    def total_examples(self) -> int:
        return self.base.total_examples()


class MultipleEpochsIterator(DataSetIterator):
    """``base`` repeated ``epochs`` times, reset before each."""

    def __init__(self, epochs: int, base: DataSetIterator):
        self.epochs = epochs
        self.base = base

    def __iter__(self):
        for _ in range(self.epochs):
            self.base.reset()
            yield from self.base

    def reset(self) -> None:
        self.base.reset()

    def batch_size(self) -> int:
        return self.base.batch_size()

    def total_examples(self) -> int:
        return self.epochs * self.base.total_examples()


class SamplingDataSetIterator(DataSetIterator):
    """``total_batches`` minibatches drawn with replacement, from
    ``np.random.default_rng(seed + epoch)``."""

    def __init__(self, dataset: DataSet, batch: int, total_batches: int,
                 seed: int = 0):
        self.dataset = dataset
        self._batch = batch
        self.total_batches = total_batches
        self._seed = seed
        self._epoch = 0

    def __iter__(self):
        rng = np.random.default_rng(self._seed + self._epoch)
        self._epoch += 1
        n = self.dataset.num_examples()
        for _ in range(self.total_batches):
            idx = rng.integers(0, n, self._batch)
            yield DataSet(self.dataset.features[idx], self.dataset.labels[idx])

    def batch_size(self) -> int:
        return self._batch

    def total_examples(self) -> int:
        return self._batch * self.total_batches


class ExistingDataSetIterator(ListDataSetIterator):
    """Pre-built ``DataSet``\\ s from any iterable, a generator included."""

    def __init__(self, datasets, batch=None):
        super().__init__(list(datasets), batch)
