"""Layer base class: a forward-only ``nn.Module`` built from a layer config.

Counterpart of ``deeplearning4j_tpu/nn/conf/layers/base.py``. Parameters
keep the JAX names (``W``, ``b``, ``ln1_g``, ``Wqkv``, ...) and the JAX
``[in, out]`` layout, so per-output-channel int8 scales stay on the last
axis. ``apply(params, x)`` is the pure forward over an explicit param dict
(the serving snapshot, possibly dequantized); ``forward(x)`` runs it over
the module's own parameters.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
from torch import nn

from ....ops.activations import get_activation


def init_weight(gen: torch.Generator, shape: Tuple[int, ...],
                scheme: str) -> torch.Tensor:
    """A weight drawn on the CPU from ``gen`` per DL4J WeightInit name (the
    dense ``[in, out]`` fan convention of ``nn/weights.py``)."""
    fan_in, fan_out = float(shape[0]), float(shape[-1])
    scheme = str(scheme).lower()
    if scheme == "zero":
        return torch.zeros(shape)
    normal = torch.randn(shape, generator=gen, dtype=torch.float32)
    if scheme == "xavier":
        return normal * math.sqrt(2.0 / (fan_in + fan_out))
    if scheme == "relu":
        return normal * math.sqrt(2.0 / fan_in)
    if scheme == "normal":
        return normal / math.sqrt(fan_in)
    raise ValueError(f"weight_init {scheme!r} is not supported by this port yet")


class Layer(nn.Module):
    """Hyperparameters from one ``LayerConf`` plus named parameters."""

    TYPE = ""

    def __init__(self, conf, device: torch.device):
        super().__init__()
        self.n_in = int(conf["n_in"])
        self.n_out = int(conf["n_out"])
        self.activation = conf.get("activation", "identity")
        self.weight_init = conf.get("weight_init", "xavier")
        self.bias_init = float(conf.get("bias_init", 0.0))
        self.device = device
        for name, shape in self.param_shapes().items():
            self.register_parameter(name, nn.Parameter(
                torch.zeros(shape, device=device), requires_grad=False))

    def param_shapes(self) -> Dict[str, Tuple[int, ...]]:
        raise NotImplementedError

    def init_param(self, name: str, shape, gen: torch.Generator) -> torch.Tensor:
        """Weights (``W*``) by the weight-init scheme, biases by bias_init."""
        if name.startswith("W"):
            return init_weight(gen, shape, self.weight_init)
        return torch.full(shape, self.bias_init)

    @torch.no_grad()
    def init_params(self, gen: torch.Generator) -> None:
        for name, shape in self.param_shapes().items():
            getattr(self, name).copy_(self.init_param(name, shape, gen))

    def params(self) -> Dict[str, torch.Tensor]:
        return {name: p.data for name, p in self.named_parameters()}

    def act_fn(self):
        return get_activation(self.activation or "identity")

    def apply(self, params: dict, x: torch.Tensor,
              mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        raise NotImplementedError

    def forward(self, x: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        return self.apply(self.params(), x, mask)
