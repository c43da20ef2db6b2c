"""Recurrent-family layers of the slice: ``RnnOutputLayer``.

Counterpart of ``deeplearning4j_tpu/nn/conf/layers/recurrent.py``. LSTM
layers are not ported yet (ROADMAP.md).
"""
from __future__ import annotations

from ..serde import register_layer
from .base import Layer
from .feedforward import dense


@register_layer("RnnOutput")
class RnnOutputLayer(Layer):
    """Time-distributed output layer: ``act(x @ W + b)`` at every timestep of
    ``[B, T, F]``. The loss is training-side and not part of this port yet."""

    def __init__(self, conf, device):
        super().__init__(conf, device)
        self.loss = conf.get("loss", "mcxent")

    def param_shapes(self):
        return {"W": (self.n_in, self.n_out), "b": (self.n_out,)}

    def apply(self, params, x, mask=None):
        return self.act_fn()(dense(params, x))
