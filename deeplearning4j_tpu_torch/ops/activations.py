"""Activation functions resolved by the serving slice.

Counterpart of ``deeplearning4j_tpu/ops/activations.py``, limited to the
names this slice's configs use. Names match case-insensitively.
"""
from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F


def identity(x: torch.Tensor) -> torch.Tensor:
    return x


def relu(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp_min(x, 0)


def sigmoid(x: torch.Tensor) -> torch.Tensor:
    return torch.sigmoid(x)


def tanh(x: torch.Tensor) -> torch.Tensor:
    return torch.tanh(x)


def softmax(x: torch.Tensor) -> torch.Tensor:
    return torch.softmax(x, dim=-1)


def gelu(x: torch.Tensor) -> torch.Tensor:
    # jax.nn.gelu defaults to the tanh approximation
    return F.gelu(x, approximate="tanh")


ACTIVATIONS: dict[str, Callable[[torch.Tensor], torch.Tensor]] = {
    "identity": identity,
    "linear": identity,
    "relu": relu,
    "sigmoid": sigmoid,
    "tanh": tanh,
    "softmax": softmax,
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
