"""``DataSet``: features and labels with their optional masks.

Counterpart of the container in ``deeplearning4j_tpu/datasets/dataset.py``,
limited to what ``MultiLayerNetwork.fit`` and ``fit_iterator`` read: numpy
arrays or tensors, ``features_mask`` and ``labels_mask`` ``[B, T]`` {0,1}.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional


@dataclasses.dataclass
class DataSet:
    features: Any
    labels: Any
    features_mask: Optional[Any] = None
    labels_mask: Optional[Any] = None
