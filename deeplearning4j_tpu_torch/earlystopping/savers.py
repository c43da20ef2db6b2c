"""Where early stopping keeps its best and latest models.

Counterpart of ``deeplearning4j_tpu/earlystopping/savers.py``. The port's
updater writes the params in place, so a model kept in memory must own its
tensors: :class:`InMemoryModelSaver` keeps a ``clone()`` of the network (a
copy of every param, layer state and updater state tensor). A copy that
shared the tensors, as the JAX package's may (its arrays are immutable),
would follow training.
"""
from __future__ import annotations

import os


class EarlyStoppingModelSaver:
    def save_best_model(self, model, score: float) -> None:
        raise NotImplementedError

    def save_latest_model(self, model, score: float) -> None:
        raise NotImplementedError

    def get_best_model(self):
        raise NotImplementedError

    def get_latest_model(self):
        raise NotImplementedError


class InMemoryModelSaver(EarlyStoppingModelSaver):
    """Clones of the best and the latest model, on the model's device."""

    def __init__(self):
        self._best = None
        self._latest = None

    def save_best_model(self, model, score: float) -> None:
        self._best = model.clone()

    def save_latest_model(self, model, score: float) -> None:
        self._latest = model.clone()

    def get_best_model(self):
        return self._best

    def get_latest_model(self):
        return self._latest


class LocalFileModelSaver(EarlyStoppingModelSaver):
    """``bestModel.dl4jtpu.zip`` and ``latestModel.dl4jtpu.zip`` in
    ``directory``; either network type (the zip records which). A model is
    read back on ``device`` (``None`` means CUDA)."""

    BEST = "bestModel.dl4jtpu.zip"
    LATEST = "latestModel.dl4jtpu.zip"

    def __init__(self, directory: str, device=None):
        self.directory = directory
        self.device = device
        os.makedirs(directory, exist_ok=True)

    def _write(self, model, name: str) -> None:
        from ..utils.model_serializer import write_model

        write_model(model, os.path.join(self.directory, name))

    def _read(self, name: str):
        from ..utils.model_serializer import guess_model

        path = os.path.join(self.directory, name)
        return guess_model(path, device=self.device) if os.path.exists(path) \
            else None

    def save_best_model(self, model, score: float) -> None:
        self._write(model, self.BEST)

    def save_latest_model(self, model, score: float) -> None:
        self._write(model, self.LATEST)

    def get_best_model(self):
        return self._read(self.BEST)

    def get_latest_model(self):
        return self._read(self.LATEST)
