"""Weight initialization schemes.

Counterpart of ``deeplearning4j_tpu/nn/weights.py``: the DL4J ``WeightInit``
names with the same fan-in/fan-out convention and the same distributions.
Every initializer draws on the CPU from an explicit ``torch.Generator``, so a
seed gives the same weights on every device. The JAX package's RNG differs:
weights cross between the two packages through ``convert.from_jax`` only.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch


def fan_in_out(shape: Sequence[int]) -> Tuple[float, float]:
    """(fan_in, fan_out) for dense [in, out] or conv [kh, kw, in, out] shapes."""
    if len(shape) == 2:
        return float(shape[0]), float(shape[1])
    if len(shape) == 4:
        receptive = shape[0] * shape[1]
        return float(shape[2] * receptive), float(shape[3] * receptive)
    if len(shape) == 1:
        return float(shape[0]), float(shape[0])
    receptive = 1
    for s in shape[:-2]:
        receptive *= s
    return float(shape[-2] * receptive), float(shape[-1] * receptive)


def _normal(gen, shape, dtype):
    return torch.randn(shape, generator=gen, dtype=dtype)


def _uniform(gen, shape, dtype, lo, hi):
    return torch.rand(shape, generator=gen, dtype=dtype) * (hi - lo) + lo


def init_weights(gen: torch.Generator, shape: Sequence[int], scheme: str,
                 distribution: Optional[dict] = None,
                 dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """A CPU tensor initialized per DL4J WeightInit scheme name."""
    scheme = str(scheme).lower()
    fan_in, fan_out = fan_in_out(shape)
    shape = tuple(shape)

    if scheme == "zero":
        return torch.zeros(shape, dtype=dtype)
    if scheme == "one":
        return torch.ones(shape, dtype=dtype)
    if scheme == "normal":
        # DL4J NORMAL: N(0, 1/sqrt(fanIn))
        return _normal(gen, shape, dtype) / math.sqrt(fan_in)
    if scheme == "uniform":
        a = 1.0 / math.sqrt(fan_in)
        return _uniform(gen, shape, dtype, -a, a)
    if scheme == "xavier":
        # DL4J XAVIER: N(0, 2/(fanIn+fanOut))
        return _normal(gen, shape, dtype) * math.sqrt(2.0 / (fan_in + fan_out))
    if scheme == "xavier_uniform":
        a = math.sqrt(6.0 / (fan_in + fan_out))
        return _uniform(gen, shape, dtype, -a, a)
    if scheme == "xavier_fan_in":
        return _normal(gen, shape, dtype) * math.sqrt(1.0 / fan_in)
    if scheme == "xavier_legacy":
        return _normal(gen, shape, dtype) * math.sqrt(1.0 / (fan_in + fan_out))
    if scheme == "relu":
        # He init: N(0, 2/fanIn)
        return _normal(gen, shape, dtype) * math.sqrt(2.0 / fan_in)
    if scheme == "relu_uniform":
        a = math.sqrt(6.0 / fan_in)
        return _uniform(gen, shape, dtype, -a, a)
    if scheme == "sigmoid_uniform":
        a = 4.0 * math.sqrt(6.0 / (fan_in + fan_out))
        return _uniform(gen, shape, dtype, -a, a)
    if scheme == "lecun_normal":
        return _normal(gen, shape, dtype) * math.sqrt(1.0 / fan_in)
    if scheme == "lecun_uniform":
        a = math.sqrt(3.0 / fan_in)
        return _uniform(gen, shape, dtype, -a, a)
    if scheme == "distribution":
        return _from_distribution(gen, shape, distribution or {}, dtype)
    raise ValueError(f"Unknown weight init scheme '{scheme}'")


def _from_distribution(gen, shape, dist: dict, dtype) -> torch.Tensor:
    """DL4J Distribution configs: ``{"type": "normal"|"uniform"|"binomial",
    ...}``."""
    kind = str(dist.get("type", "normal")).lower()
    if kind in ("normal", "gaussian"):
        mean = float(dist.get("mean", 0.0))
        std = float(dist.get("std", 1.0))
        return mean + std * _normal(gen, shape, dtype)
    if kind == "uniform":
        lower = float(dist.get("lower", -1.0))
        upper = float(dist.get("upper", 1.0))
        return _uniform(gen, shape, dtype, lower, upper)
    if kind == "binomial":
        n = int(dist.get("n", dist.get("numberOfTrials", 1)))
        p = float(dist.get("p", dist.get("probabilityOfSuccess", 0.5)))
        count = torch.full(shape, float(n))
        return torch.binomial(count, torch.full(shape, p),
                              generator=gen).to(dtype)
    raise ValueError(f"Unknown distribution type '{kind}'")
