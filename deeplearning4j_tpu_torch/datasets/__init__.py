"""Datasets: the ``DataSet`` container that ``fit`` takes."""
from .dataset import DataSet

__all__ = ["DataSet"]
