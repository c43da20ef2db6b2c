"""Datasets: the ``DataSet`` container, the iterators ``fit_iterator`` and
``evaluate`` take, and MNIST."""
from .dataset import DataSet, NormalizerMinMaxScaler, NormalizerStandardize
from .iterators import (
    ArrayDataSetIterator, AsyncDataSetIterator, DataSetIterator,
    ExistingDataSetIterator, ListDataSetIterator, MultipleEpochsIterator,
    SamplingDataSetIterator)
from .mnist import MnistDataSetIterator
from .prefetch import DevicePrefetcher

__all__ = ["ArrayDataSetIterator", "AsyncDataSetIterator", "DataSet",
           "DataSetIterator", "DevicePrefetcher", "ExistingDataSetIterator",
           "ListDataSetIterator",
           "MnistDataSetIterator", "MultipleEpochsIterator",
           "NormalizerMinMaxScaler", "NormalizerStandardize",
           "SamplingDataSetIterator"]
