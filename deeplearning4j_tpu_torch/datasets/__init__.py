"""Datasets: the ``DataSet`` container, the iterators ``fit_iterator`` and
``evaluate`` take, MNIST and the CIFAR-10, LFW, Curves and Iris
fetchers."""
from .dataset import DataSet, NormalizerMinMaxScaler, NormalizerStandardize
from .fetchers import (
    CifarDataSetIterator, CurvesDataSetIterator, IrisDataSetIterator,
    LFWDataSetIterator)
from .iterators import (
    ArrayDataSetIterator, AsyncDataSetIterator, DataSetIterator,
    ExistingDataSetIterator, ListDataSetIterator, MultipleEpochsIterator,
    SamplingDataSetIterator)
from .mnist import MnistDataSetIterator
from .prefetch import DevicePrefetcher

__all__ = ["ArrayDataSetIterator", "AsyncDataSetIterator",
           "CifarDataSetIterator", "CurvesDataSetIterator", "DataSet",
           "DataSetIterator", "DevicePrefetcher", "ExistingDataSetIterator",
           "IrisDataSetIterator", "LFWDataSetIterator", "ListDataSetIterator",
           "MnistDataSetIterator", "MultipleEpochsIterator",
           "NormalizerMinMaxScaler", "NormalizerStandardize",
           "SamplingDataSetIterator"]
