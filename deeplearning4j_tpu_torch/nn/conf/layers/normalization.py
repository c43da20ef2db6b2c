"""Normalization layers: ``BatchNormalization`` and
``LocalResponseNormalization``.

Counterpart of ``deeplearning4j_tpu/nn/conf/layers/normalization.py``. Batch
norm runs over the channel axis, the last one (NHWC images, ``[B, F]``
features). Its running mean and var are layer state (buffers ``mean`` and
``var``, 0 and 1 at init): a training forward normalizes with the batch's
statistics (``ops/batch_norm.py``, the JAX formulas, in the policy's
``stat_dtype``) and returns the new state ``decay * state + (1 - decay) *
batch`` from the biased variance, kept float32 under every policy,
which the network writes after the step; inference folds the running
statistics into one scale and one shift a channel. With
``lock_gamma_beta`` the layer has no params and scales by the fixed
``gamma`` and ``beta``.
"""
from __future__ import annotations

import torch

from ....common import at_least_f32, get_policy
from ....ops.batch_norm import batch_norm_infer, batch_norm_train
from ..serde import register_layer
from .base import Layer


@register_layer("BatchNormalization")
class BatchNormalization(Layer):
    """Batch norm over the last axis, with a running mean and var."""

    FIELDS = {"decay": 0.9, "eps": 1e-5, "gamma": 1.0, "beta": 0.0,
              "lock_gamma_beta": False, "n_in": 0}

    @classmethod
    def set_n_in(cls, fields, itype):
        if not fields.get("n_in"):
            fields["n_in"] = (itype.channels if itype.kind == "convolutional"
                              else itype.flat_size())

    def __init__(self, conf, device):
        self.n_in = int(conf["n_in"])
        self.decay = float(conf["decay"])
        self.eps = float(conf["eps"])
        # the init (and, locked, the fixed) values; "gamma" and "beta" name
        # the params
        self.gamma_value = float(conf["gamma"])
        self.beta_value = float(conf["beta"])
        self.lock_gamma_beta = bool(conf["lock_gamma_beta"])
        super().__init__(conf, device)

    def param_shapes(self):
        if self.lock_gamma_beta:
            return {}
        return {"gamma": (self.n_in,), "beta": (self.n_in,)}

    def init_param(self, name, shape, gen):
        return torch.full(shape, self.gamma_value if name == "gamma"
                          else self.beta_value)

    def init_state(self):
        return {"mean": torch.zeros(self.n_in), "var": torch.ones(self.n_in)}

    def regularizable_params(self):
        return ()

    def _gamma_beta(self, params, device):
        if self.lock_gamma_beta:
            return (torch.full((self.n_in,), self.gamma_value, device=device),
                    torch.full((self.n_in,), self.beta_value, device=device))
        return params["gamma"], params["beta"]

    def apply_with_state(self, params, state, x, mask=None, train=False,
                         gen=None):
        gamma, beta = self._gamma_beta(params, x.device)
        if train:
            out, mean, var = batch_norm_train(
                x, gamma, beta, self.eps, get_policy().stat_dtype(x.dtype))
            d = self.decay
            new_state = {
                "mean": d * state["mean"] + (1 - d) * mean.to(state["mean"].dtype),
                "var": d * state["var"] + (1 - d) * var.to(state["var"].dtype)}
        else:
            out = batch_norm_infer(x, gamma, beta, state["mean"],
                                   state["var"], self.eps)
            new_state = state
        return self.act_fn()(out), new_state


@register_layer("LocalResponseNormalization")
class LocalResponseNormalization(Layer):
    """Across channels: ``x / (k + alpha * sum of x^2 over n adjacent
    channels)^beta``, NHWC, statistics in at least float32."""

    FIELDS = {"k": 2.0, "n": 5, "alpha": 1e-4, "beta": 0.75}

    def __init__(self, conf, device):
        self.k = float(conf["k"])
        self.n = int(conf["n"])
        self.alpha = float(conf["alpha"])
        self.beta = float(conf["beta"])
        super().__init__(conf, device)

    def regularizable_params(self):
        return ()

    def apply(self, params, x, mask=None, train=False, gen=None):
        half = self.n // 2
        xf = x.to(at_least_f32(x.dtype))
        sq = xf * xf
        padded = torch.nn.functional.pad(sq, (half, half))
        c = x.shape[-1]
        windowed = padded[..., 0:c]
        for i in range(1, self.n):
            windowed = windowed + padded[..., i:i + c]
        denom = (self.k + self.alpha * windowed) ** self.beta
        return (xf / denom).to(x.dtype)
