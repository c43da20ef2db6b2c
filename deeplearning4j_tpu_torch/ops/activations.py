"""Activation functions.

Counterpart of ``deeplearning4j_tpu/ops/activations.py``: the same names
(matched case-insensitively) and the same formulas. The functions keep the
JAX names as their ``__name__``, which ``ops/losses.py`` reads to take the
fused softmax cross-entropy for ``softmax`` and ``logsoftmax``.
"""
from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F


def identity(x: torch.Tensor) -> torch.Tensor:
    return x


def relu(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp_min(x, 0)


def relu6(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp(x, 0, 6)


def leakyrelu(x: torch.Tensor, alpha: float = 0.01) -> torch.Tensor:
    return torch.where(x >= 0, x, alpha * x)


def elu(x: torch.Tensor, alpha: float = 1.0) -> torch.Tensor:
    # exp of the negative side only, so the unused branch cannot overflow
    safe = torch.where(x > 0, torch.zeros_like(x), x)
    return torch.where(x > 0, x, alpha * (torch.exp(safe) - 1.0))


def selu(x: torch.Tensor) -> torch.Tensor:
    return F.selu(x)


def sigmoid(x: torch.Tensor) -> torch.Tensor:
    return torch.sigmoid(x)


def hardsigmoid(x: torch.Tensor) -> torch.Tensor:
    # DL4J's 0.2 x + 0.5, not PyTorch's x / 6 + 0.5
    return torch.clamp(0.2 * x + 0.5, 0.0, 1.0)


def tanh(x: torch.Tensor) -> torch.Tensor:
    return torch.tanh(x)


def hardtanh(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp(x, -1.0, 1.0)


def rationaltanh(x: torch.Tensor) -> torch.Tensor:
    return 1.7159 * torch.tanh(2.0 * x / 3.0)


def rectifiedtanh(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp_min(torch.tanh(x), 0.0)


def softmax(x: torch.Tensor) -> torch.Tensor:
    return torch.softmax(x, dim=-1)


def logsoftmax(x: torch.Tensor) -> torch.Tensor:
    return torch.log_softmax(x, dim=-1)


def softplus(x: torch.Tensor) -> torch.Tensor:
    # jax.nn.softplus is logaddexp(x, 0), with no linear cut-over
    return torch.logaddexp(x, torch.zeros_like(x))


def softsign(x: torch.Tensor) -> torch.Tensor:
    return x / (1.0 + x.abs())


def cube(x: torch.Tensor) -> torch.Tensor:
    return x ** 3


def swish(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)


def gelu(x: torch.Tensor) -> torch.Tensor:
    # jax.nn.gelu defaults to the tanh approximation
    return F.gelu(x, approximate="tanh")


ACTIVATIONS: dict[str, Callable[[torch.Tensor], torch.Tensor]] = {
    "identity": identity,
    "linear": identity,
    "relu": relu,
    "relu6": relu6,
    "leakyrelu": leakyrelu,
    "elu": elu,
    "selu": selu,
    "sigmoid": sigmoid,
    "hardsigmoid": hardsigmoid,
    "tanh": tanh,
    "hardtanh": hardtanh,
    "rationaltanh": rationaltanh,
    "rectifiedtanh": rectifiedtanh,
    "softmax": softmax,
    "logsoftmax": logsoftmax,
    "softplus": softplus,
    "softsign": softsign,
    "cube": cube,
    "swish": swish,
    "gelu": gelu,
}


def get_activation(name) -> Callable[[torch.Tensor], torch.Tensor]:
    """Resolve an activation by DL4J-style name or pass a callable through."""
    if callable(name):
        return name
    key = str(name).lower()
    if key not in ACTIVATIONS:
        raise ValueError(f"Unknown activation '{name}'. Known: {sorted(ACTIVATIONS)}")
    return ACTIVATIONS[key]
