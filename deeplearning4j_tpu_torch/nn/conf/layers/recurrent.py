"""Recurrent layers: ``LSTM``, ``GravesLSTM`` (peepholes),
``GravesBidirectionalLSTM`` and ``RnnOutputLayer``.

Counterpart of ``deeplearning4j_tpu/nn/conf/layers/recurrent.py``. The time
recursion runs through ``ops/lstm.py`` (:func:`lstm_sequence`), whose
standard cell is the CUDA kernel pair on the card; backprop through time is
that engine's ``torch.autograd.Function``.

Layout ``[batch, time, features]``. Param names and shapes as in the JAX
package: ``W [n_in, 4H]`` input weights, ``RW [H, 4H]`` recurrent, ``b [4H]``
(the forget-gate quarter starts at ``forget_gate_bias_init``), peepholes
``pI``/``pF``/``pO [H]``; the bidirectional layer holds two such sets under
the prefixes ``F`` and ``B``. ``apply`` starts every batch from zero state;
``apply_streaming`` carries ``{"h", "c"}`` across calls (``rnn_time_step``).
"""
from __future__ import annotations

from typing import Optional

import torch

from ....ops.activations import get_activation
from ....ops.losses import get_loss
from ....ops.lstm import lstm_sequence
from ..serde import register_layer
from .base import Layer, init_weight
from .feedforward import dense


@register_layer("LSTM")
class LSTM(Layer):
    """Standard LSTM cell (no peepholes unless the config sets them)."""

    PEEPHOLE_DEFAULT = False

    def __init__(self, conf, device):
        self.forget_gate_bias_init = float(conf.get("forget_gate_bias_init",
                                                    1.0))
        self.gate_activation = conf.get("gate_activation", "sigmoid")
        self.peephole = bool(conf.get("peephole", self.PEEPHOLE_DEFAULT))
        super().__init__(conf, device)

    def _cell_shapes(self, prefix: str = "") -> dict:
        h = self.n_out
        shapes = {f"{prefix}W": (self.n_in, 4 * h), f"{prefix}RW": (h, 4 * h),
                  f"{prefix}b": (4 * h,)}
        if self.peephole:
            for k in ("pI", "pF", "pO"):
                shapes[f"{prefix}{k}"] = (h,)
        return shapes

    def param_shapes(self):
        return self._cell_shapes()

    def regularizable_params(self):
        return ("W", "RW")

    def init_param(self, name, shape, gen):
        """``W`` and ``RW`` by the weight-init scheme; ``b`` zeros with the
        forget quarter at ``forget_gate_bias_init``; peepholes zeros."""
        if name in ("W", "RW"):
            return init_weight(gen, shape, self.weight_init, self.dist)
        out = torch.zeros(shape)
        if name == "b":
            h = self.n_out
            out[h:2 * h] = self.forget_gate_bias_init
        return out

    def _acts(self):
        return (get_activation(self.activation or "tanh"),
                get_activation(self.gate_activation))

    def _run(self, params, x, h0, c0, mask):
        act, gate = self._acts()
        return lstm_sequence(params, x, act, gate, h0, c0, self.peephole, mask,
                             act_name=self.activation or "tanh",
                             gate_name=self.gate_activation)

    def _zeros(self, x):
        return torch.zeros(x.shape[0], self.n_out, dtype=torch.float32,
                           device=x.device)

    def apply(self, params, x, mask=None, train=False, gen=None):
        # a full sequence starts from zero state every batch; streaming
        # state is apply_streaming
        x = self.apply_dropout(x, gen, train)
        zeros = self._zeros(x)
        ys, _ = self._run(params, x, zeros, zeros, mask)
        return ys

    def apply_streaming(self, params, state: dict, x,
                        mask: Optional[torch.Tensor] = None):
        """One call of ``rnn_time_step``: run ``x [B, T, F]`` from the carried
        ``{"h", "c"}`` (zeros when absent) and return ``(ys, {"h", "c"})``."""
        h0 = state.get("h")
        c0 = state.get("c")
        h0 = self._zeros(x) if h0 is None else h0
        c0 = self._zeros(x) if c0 is None else c0
        ys, (h, c) = self._run(params, x, h0, c0, mask)
        return ys, {"h": h, "c": c}


@register_layer("GravesLSTM")
class GravesLSTM(LSTM):
    """LSTM with peephole connections (Graves 2013)."""

    PEEPHOLE_DEFAULT = True


@register_layer("GravesBidirectionalLSTM")
class GravesBidirectionalLSTM(LSTM):
    """A forward and a backward Graves LSTM over the sequence; the output is
    their sum (the reference's ADD mode). The backward pass runs over the
    time-flipped input with the mask flipped too. It cannot stream: the
    backward pass needs the whole sequence."""

    PEEPHOLE_DEFAULT = True

    def param_shapes(self):
        return {**self._cell_shapes("F"), **self._cell_shapes("B")}

    def regularizable_params(self):
        return ("FW", "FRW", "BW", "BRW")

    def init_param(self, name, shape, gen):
        return super().init_param(name[1:], shape, gen)

    def apply(self, params, x, mask=None, train=False, gen=None):
        x = self.apply_dropout(x, gen, train)
        zeros = self._zeros(x)
        fwd = {k[1:]: v for k, v in params.items() if k.startswith("F")}
        bwd = {k[1:]: v for k, v in params.items() if k.startswith("B")}
        ys_f, _ = self._run(fwd, x, zeros, zeros, mask)
        mask_rev = None if mask is None else torch.flip(mask, dims=(1,))
        ys_b, _ = self._run(bwd, torch.flip(x, dims=(1,)), zeros, zeros,
                            mask_rev)
        return ys_f + torch.flip(ys_b, dims=(1,))


def streaming_lstm(layer) -> bool:
    """True for a layer whose state ``rnn_time_step`` carries."""
    return isinstance(layer, LSTM) and not isinstance(
        layer, GravesBidirectionalLSTM)


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
