"""Records -> ``DataSet`` batches (the DataVec bridge).

Counterpart of ``deeplearning4j_tpu/datavec/iterators.py`` (the reference's
``RecordReaderDataSetIterator``, ``SequenceRecordReaderDataSetIterator``
and ``RecordReaderMultiDataSetIterator``): reader records into (features,
one-hot labels) minibatches, padded and masked sequence pairs, and named
multi-input, multi-output sets, as numpy arrays on the host.
"""
from __future__ import annotations

from typing import Dict, Iterator, List, Optional

import numpy as np

from ..datasets.dataset import DataSet
from ..datasets.iterators import DataSetIterator
from .records import RecordReader


def _one_hot(idx: np.ndarray, n: int) -> np.ndarray:
    out = np.zeros((len(idx), n), np.float32)
    out[np.arange(len(idx)), idx.astype(int)] = 1.0
    return out


class RecordReaderDataSetIterator(DataSetIterator):
    """records -> DataSet batches. ``label_index`` column becomes the label
    (one-hot when ``num_classes`` given, else regression); remaining columns
    are features. ``label_index=None`` => all columns are features."""

    def __init__(self, reader: RecordReader, batch: int,
                 label_index: Optional[int] = None,
                 num_classes: Optional[int] = None,
                 regression: bool = False,
                 label_index_to: Optional[int] = None):
        self.reader = reader
        self.batch = batch
        self.label_index = label_index
        self.num_classes = num_classes
        self.regression = regression or num_classes is None
        self.label_index_to = label_index_to

    def __iter__(self) -> Iterator[DataSet]:
        feats: List[List[float]] = []
        labels: List = []
        for rec in self.reader:
            if self.label_index is None:
                feats.append([float(v) for v in rec])
                labels.append(0.0)
            elif self.label_index_to is not None:
                lo, hi = self.label_index, self.label_index_to
                labels.append([float(v) for v in rec[lo:hi + 1]])
                feats.append([float(v) for v in rec[:lo] + rec[hi + 1:]])
            else:
                li = (self.label_index if self.label_index >= 0
                      else len(rec) - 1)
                labels.append(float(rec[li]))
                feats.append([float(v) for v in rec[:li] + rec[li + 1:]])
            if len(feats) == self.batch:
                yield self._make(feats, labels)
                feats, labels = [], []
        if feats:
            yield self._make(feats, labels)

    def _make(self, feats, labels) -> DataSet:
        x = np.asarray(feats, np.float32)
        if self.label_index is None:
            y = np.zeros((len(x), 0), np.float32)
        elif not self.regression and self.num_classes:
            y = _one_hot(np.asarray(labels), self.num_classes)
        else:
            y = np.asarray(labels, np.float32)
            if y.ndim == 1:
                y = y[:, None]
        return DataSet(x, y)


class SequenceRecordReaderDataSetIterator(DataSetIterator):
    """Paired feature/label sequence readers -> padded+masked sequence
    DataSets [B, T, F] (reference SequenceRecordReaderDataSetIterator with
    ALIGN_END-style padding via mask arrays). A single reader whose rows
    carry the label in ``label_index`` also works."""

    def __init__(self, features: RecordReader, batch: int,
                 labels: Optional[RecordReader] = None,
                 num_classes: Optional[int] = None,
                 regression: bool = False,
                 label_index: Optional[int] = None):
        self.features = features
        self.labels = labels
        self.batch = batch
        self.num_classes = num_classes
        self.regression = regression or num_classes is None
        self.label_index = label_index

    def _pairs(self):
        fseqs = list(self.features.sequences()
                     if hasattr(self.features, "sequences")
                     else self.features)
        if self.labels is not None:
            lseqs = list(self.labels.sequences()
                         if hasattr(self.labels, "sequences") else self.labels)
        else:
            li = self.label_index if self.label_index is not None else -1
            lseqs = [[[r[li]] for r in seq] for seq in fseqs]
            fseqs = [[(r[:li] + r[li + 1:]) if li >= 0 else r[:-1]
                      for r in seq] for seq in fseqs]
        return fseqs, lseqs

    def __iter__(self) -> Iterator[DataSet]:
        fseqs, lseqs = self._pairs()
        for b0 in range(0, len(fseqs), self.batch):
            fb = fseqs[b0:b0 + self.batch]
            lb = lseqs[b0:b0 + self.batch]
            t_max = max(len(s) for s in fb)
            nf = len(fb[0][0])
            x = np.zeros((len(fb), t_max, nf), np.float32)
            mask = np.zeros((len(fb), t_max), np.float32)
            if self.regression:
                nl = len(lb[0][0])
                y = np.zeros((len(fb), t_max, nl), np.float32)
            else:
                y = np.zeros((len(fb), t_max, self.num_classes), np.float32)
            for i, (fs, ls) in enumerate(zip(fb, lb)):
                for t, row in enumerate(fs):
                    x[i, t] = np.asarray(row, np.float32)
                    mask[i, t] = 1.0
                for t, row in enumerate(ls):
                    if self.regression:
                        y[i, t] = np.asarray(row, np.float32)
                    else:
                        y[i, t, int(row[0])] = 1.0
            yield DataSet(x, y, features_mask=mask, labels_mask=mask.copy())


class RecordReaderMultiDataSetIterator:
    """Named multi-input/multi-output sets (reference
    RecordReaderMultiDataSetIterator builder): register readers by name, then
    declare inputs/outputs as column ranges over them."""

    def __init__(self, batch: int):
        self.batch = batch
        self._readers: Dict[str, RecordReader] = {}
        self._inputs: List = []
        self._outputs: List = []

    def add_reader(self, name: str, reader: RecordReader
                   ) -> "RecordReaderMultiDataSetIterator":
        self._readers[name] = reader
        return self

    def add_input(self, name: str, col_from: int = 0,
                  col_to: Optional[int] = None
                  ) -> "RecordReaderMultiDataSetIterator":
        self._inputs.append((name, col_from, col_to, None))
        return self

    def add_output(self, name: str, col_from: int = 0,
                   col_to: Optional[int] = None
                   ) -> "RecordReaderMultiDataSetIterator":
        self._outputs.append((name, col_from, col_to, None))
        return self

    def add_output_one_hot(self, name: str, column: int, num_classes: int
                           ) -> "RecordReaderMultiDataSetIterator":
        self._outputs.append((name, column, column, num_classes))
        return self

    def __iter__(self):
        streams = {n: list(r) for n, r in self._readers.items()}
        n = min(len(v) for v in streams.values())
        for b0 in range(0, n, self.batch):
            ins = [self._slice(streams, spec, b0) for spec in self._inputs]
            outs = [self._slice(streams, spec, b0) for spec in self._outputs]
            yield ins, outs

    def _slice(self, streams, spec, b0) -> np.ndarray:
        name, lo, hi, one_hot = spec
        rows = streams[name][b0:b0 + self.batch]
        if one_hot is not None:
            idx = np.asarray([float(r[lo]) for r in rows])
            return _one_hot(idx, one_hot)
        sel = [[float(v) for v in (r[lo:hi + 1] if hi is not None else r[lo:])]
               for r in rows]
        return np.asarray(sel, np.float32)
