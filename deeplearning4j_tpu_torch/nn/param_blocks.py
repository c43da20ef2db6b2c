"""The hooks a layer calls on its params container around a product.

A parallel step may hand a layer its params as a container some of whose
leaves are this rank's blocks of a split leaf (``ShardedParams`` of
``parallel/tensor_parallel.py``, the ``dp_tp`` placement). Such a
container supplies ``enter``, ``leave``, ``whole_sum`` and ``is_block``,
and the layer calls them through the helpers here, so it needs to know
nothing of the placement. For a plain dict every helper is the identity
(``whole_sum`` is ``t.sum()``, ``is_block`` False).
"""
from __future__ import annotations

import torch


def enter(params, name: str, x: torch.Tensor) -> torch.Tensor:
    """``x`` as the input of the product with the ``name`` leaf."""
    f = getattr(params, "enter", None)
    return x if f is None else f(name, x)


def leave(params, name: str, y: torch.Tensor) -> torch.Tensor:
    """``y``, the product with the ``name`` leaf, as the whole product."""
    f = getattr(params, "leave", None)
    return y if f is None else f(name, y)


def whole_sum(params, name: str, t: torch.Tensor) -> torch.Tensor:
    """``t.sum()`` of the ``name`` leaf's elementwise term (a regularizer)
    over the whole leaf."""
    f = getattr(params, "whole_sum", None)
    return t.sum() if f is None else f(name, t)


def is_block(params, name: str) -> bool:
    """Whether the ``name`` leaf is this rank's block of a split leaf."""
    f = getattr(params, "is_block", None)
    return False if f is None else f(name)
