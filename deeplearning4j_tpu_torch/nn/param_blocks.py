"""The hooks a layer calls on its params container around a product.

A parallel step may hand a layer its params as a container some of whose
leaves are this rank's blocks of a split leaf (``ShardedParams`` of
``parallel/tensor_parallel.py``, the ``dp_tp`` placement). Such a
container supplies ``enter``, ``leave``, ``whole_sum`` and ``is_block``,
and the layer calls them through the helpers here, so it needs to know
nothing of the placement. For a plain dict every helper is the identity
(``whole_sum`` is ``t.sum()``, ``is_block`` False).

A network may also hold blocks of its own leaves between calls: a sharded
fit's placement between its steps, or the placement a restore onto a
sharding installs (``utils/sharded_checkpoint.restore_sharded``), named in
``net._held_sharding``. :func:`held_view` is the whole view a read takes
of them (``output``), and :func:`settle` makes a restored network whole
for good before any other entry point uses it. Both are collectives: every
rank of the mesh makes the same call.
"""
from __future__ import annotations

import contextlib

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


def held_view(net, parts=("params",)):
    """A context in which ``net``'s ``parts`` (of "params", "updater") are
    whole, where it holds them as blocks; a no-op otherwise."""
    held = getattr(net, "_held_sharding", None)
    return (held.whole_view(parts) if held is not None
            else contextlib.nullcontext())


def settle(net) -> None:
    """A network a restore onto a sharding left holding blocks made whole,
    its placement dropped; a fit's placement is left to its fit."""
    held = getattr(net, "_held_sharding", None)
    if getattr(held, "restored", False):
        held.settle()
