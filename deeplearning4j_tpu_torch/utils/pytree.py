"""The flat view of a network's parameters, over lists and dicts of tensors.

Counterpart of ``deeplearning4j_tpu/utils/pytree.py``. A tree is a nested
list, tuple or dict whose leaves are tensors (or numpy arrays); ``None`` is
an empty subtree. The flat order is the JAX pytree order: lists in order,
dict keys sorted. It is the order of a network's ``params()``, of the
solvers' vector and of ``flatten_params(updater_state)``, so a flat vector
of either package reads the same in the other.
"""
from __future__ import annotations

from typing import Any, Iterator, List, Tuple

import numpy as np
import torch


def _children(tree) -> Iterator[Tuple[Any, Any]]:
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield k, tree[k]
    else:
        yield from enumerate(tree)


def _is_node(tree) -> bool:
    return isinstance(tree, (dict, list, tuple))


def leaves_with_paths(tree, prefix: tuple = ()) -> Iterator[Tuple[tuple, Any]]:
    """``(path, leaf)`` in the flat order; a path holds each dict key and
    each list index on the way to the leaf."""
    if tree is None:
        return
    if not _is_node(tree):
        yield prefix, tree
        return
    for k, child in _children(tree):
        yield from leaves_with_paths(child, prefix + (k,))


def tree_leaves(tree) -> list:
    return [leaf for _, leaf in leaves_with_paths(tree)]


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` (and the matching leaves of
    ``rest``), keeping the structure and the containers' types."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        out = [tree_map(fn, v, *(r[i] for r in rest))
               for i, v in enumerate(tree)]
        return out if isinstance(tree, list) else tuple(out)
    return fn(tree, *rest)


def tree_map_with_path(fn, tree, prefix: tuple = ()):
    """:func:`tree_map` of ``fn(path, leaf)``, the path as
    :func:`leaves_with_paths` gives it."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, prefix + (k,))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        out = [tree_map_with_path(fn, v, prefix + (i,))
               for i, v in enumerate(tree)]
        return out if isinstance(tree, list) else tuple(out)
    return fn(prefix, tree)


def _numel(leaf) -> int:
    return int(np.prod(tuple(leaf.shape))) if len(leaf.shape) else 1


def flatten_params(tree, dtype=None) -> torch.Tensor:
    """All leaves in one 1-D tensor, in the flat order. ``dtype=None``
    keeps the leaves' promoted dtype; pass ``torch.float32`` for the
    standard flat view. An empty tree gives an empty float32 vector."""
    leaves = [l if isinstance(l, torch.Tensor) else torch.as_tensor(l)
              for l in tree_leaves(tree)]
    if not leaves:
        return torch.zeros(0, dtype=dtype or torch.float32)
    if dtype is None:
        dtype = leaves[0].dtype
        for l in leaves[1:]:
            dtype = torch.promote_types(dtype, l.dtype)
    return torch.cat([l.reshape(-1).to(dtype) for l in leaves])


def unflatten_params(template, flat: torch.Tensor):
    """The inverse of :func:`flatten_params` for ``template``'s structure,
    shapes and dtypes. The leaves are views of ``flat`` where the dtypes
    agree, so a loss of the result differentiates back into ``flat``."""
    offsets, at = {}, 0
    for path, leaf in leaves_with_paths(template):
        offsets[path] = at
        at += _numel(leaf)
    if at != flat.shape[0]:
        raise ValueError(f"Flat vector length {flat.shape[0]} != param count "
                         f"{at}")

    def take(path, leaf):
        o = offsets[path]
        return flat[o:o + _numel(leaf)].reshape(tuple(leaf.shape)).to(
            leaf.dtype)

    return tree_map_with_path(take, template)


def num_params(tree) -> int:
    return sum(_numel(l) for l in tree_leaves(tree))


def tree_average(trees: List[Any]):
    """The elementwise mean of trees of one structure (parameter
    averaging)."""
    return tree_map(lambda *xs: sum(xs) / len(xs), *trees)
