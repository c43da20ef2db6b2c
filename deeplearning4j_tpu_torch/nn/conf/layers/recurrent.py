"""Recurrent-family layers of the slice: ``RnnOutputLayer``.

Counterpart of ``deeplearning4j_tpu/nn/conf/layers/recurrent.py``. LSTM
layers are not ported yet (ROADMAP.md).
"""
from __future__ import annotations

import torch

from ....ops.losses import get_loss
from ..serde import register_layer
from .base import Layer
from .feedforward import dense


@register_layer("RnnOutput")
class RnnOutputLayer(Layer):
    """Time-distributed output layer: ``act(x @ W + b)`` at every timestep of
    ``[B, T, F]``, with its loss masked by the time-series label mask."""

    def __init__(self, conf, device):
        super().__init__(conf, device)
        self.loss = conf.get("loss", "mcxent")

    def param_shapes(self):
        return {"W": (self.n_in, self.n_out), "b": (self.n_out,)}

    def has_loss(self) -> bool:
        return True

    def preout(self, params, x):
        return dense(params, x)

    def apply(self, params, x, mask=None, train=False, gen=None):
        x = self.apply_dropout(x, gen, train)
        return self.act_fn()(dense(params, x))

    def compute_loss(self, params, x, labels, mask=None) -> torch.Tensor:
        """The configured loss of ``labels`` against ``act(x @ W + b)``."""
        return get_loss(self.loss)(labels, self.preout(params, x),
                                   self.act_fn(), mask)
