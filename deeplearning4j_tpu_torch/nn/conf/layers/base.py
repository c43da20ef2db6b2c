"""Layer base class: an ``nn.Module`` built from a layer config.

Counterpart of ``deeplearning4j_tpu/nn/conf/layers/base.py``. Parameters
keep the JAX names (``W``, ``b``, ``ln1_g``, ``Wqkv``, ...) and the JAX
``[in, out]`` layout, so per-output-channel int8 scales stay on the last
axis; they are trainable. ``apply(params, x, mask, train, gen)`` is the pure
forward over an explicit param dict (the module's own parameters when
training, a pinned snapshot when serving); ``forward(x)`` runs it over the
module's own parameters.

Dropout follows DL4J: ``dropout`` is the *retain* probability, and kept
values are divided by it (inverted dropout). It applies only in training
and only when a ``torch.Generator`` is given.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch
from torch import nn

from ....ops.activations import get_activation
from ...weights import init_weights


def init_weight(gen: torch.Generator, shape: Tuple[int, ...],
                scheme: str, dist: Optional[dict] = None) -> torch.Tensor:
    """A weight drawn on the CPU from ``gen`` per DL4J WeightInit name
    (``nn/weights.py``)."""
    return init_weights(gen, shape, scheme, dist)


class Layer(nn.Module):
    """Hyperparameters from one ``LayerConf`` plus named parameters."""

    TYPE = ""

    def __init__(self, conf, device: torch.device):
        super().__init__()
        self.n_in = int(conf["n_in"])
        self.n_out = int(conf["n_out"])
        # the global defaults are baked into every LayerConf
        # (``MultiLayerConfiguration``), so the layer reads them as they are
        self.activation = conf["activation"]
        self.weight_init = conf["weight_init"]
        self.dist = conf["dist"]
        self.bias_init = float(conf["bias_init"])
        self.l1 = float(conf["l1"])
        self.l2 = float(conf["l2"])
        self.dropout = float(conf["dropout"])
        self.learning_rate = float(conf["learning_rate"])
        self.bias_learning_rate = float(conf["bias_learning_rate"])
        self.updater = conf["updater"]
        self.momentum = float(conf["momentum"])
        self.momentum_schedule = conf.get("momentum_schedule")
        self.rho = float(conf["rho"])
        self.rms_decay = float(conf["rms_decay"])
        self.adam_mean_decay = float(conf["adam_mean_decay"])
        self.adam_var_decay = float(conf["adam_var_decay"])
        self.epsilon = float(conf["epsilon"])
        self.gradient_normalization = conf["gradient_normalization"]
        self.gradient_normalization_threshold = float(
            conf["gradient_normalization_threshold"])
        self.device = device
        for name, shape in self.param_shapes().items():
            self.register_parameter(name, nn.Parameter(
                torch.zeros(shape, device=device)))

    def param_shapes(self) -> Dict[str, Tuple[int, ...]]:
        raise NotImplementedError

    def regularizable_params(self) -> Sequence[str]:
        """Param names subject to l1/l2 (weights, not biases)."""
        return ("W",)

    def has_loss(self) -> bool:
        """True for output layers that end backprop with a loss function."""
        return False

    def init_param(self, name: str, shape, gen: torch.Generator) -> torch.Tensor:
        """Weights (``W*``) by the weight-init scheme, biases by bias_init."""
        if name.startswith("W"):
            return init_weight(gen, shape, self.weight_init, self.dist)
        return torch.full(shape, self.bias_init)

    @torch.no_grad()
    def init_params(self, gen: torch.Generator) -> None:
        for name, shape in self.param_shapes().items():
            getattr(self, name).copy_(self.init_param(name, shape, gen))

    def params(self) -> Dict[str, torch.Tensor]:
        """The layer's parameters by JAX name (trainable tensors)."""
        return dict(self.named_parameters())

    def act_fn(self):
        return get_activation(self.activation or "identity")

    def apply_dropout(self, x: torch.Tensor, gen: Optional[torch.Generator],
                      train: bool) -> torch.Tensor:
        """Inverted dropout with retain probability ``self.dropout``: keep
        each value with that probability and divide kept values by it."""
        p = self.dropout
        if not train or not self.uses_dropout() or gen is None:
            return x
        keep = torch.rand(x.shape, generator=gen, device=x.device) < p
        return torch.where(keep, x / p, torch.zeros((), dtype=x.dtype,
                                                    device=x.device))

    def uses_dropout(self) -> bool:
        return 0.0 < self.dropout < 1.0

    def apply(self, params: dict, x: torch.Tensor,
              mask: Optional[torch.Tensor] = None, train: bool = False,
              gen: Optional[torch.Generator] = None) -> torch.Tensor:
        raise NotImplementedError

    def forward(self, x: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        return self.apply(self.params(), x, mask)
