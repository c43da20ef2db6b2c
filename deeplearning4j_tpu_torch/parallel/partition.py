"""The partition-rule engine: named param trees -> regex rules -> specs.

Counterpart of ``deeplearning4j_tpu/parallel/partition.py``, the one place
layouts come from:

1. :func:`named_tree_map` walks a tree of lists and dicts (a network's
   ``params_list``, a graph's params dict, the updater state that mirrors
   them) with ``/``-joined paths; a model tree's top component carries the
   layer class (``0.DenseLayer/W``, ``ff.TransformerBlock/Wqkv``), and an
   updater-state leaf extends its param's path (``.../W/m``), so one rule
   shards a param and its moments alike.
2. :func:`match_partition_rules` maps ``(regex, value)`` rules, first match
   wins, onto a tree of :class:`PartitionSpec`. Scalars and tiny vectors
   replicate; a non-scalar leaf no rule matches raises
   :class:`PartitionRuleError`; a dim the mesh axis does not divide demotes
   the leaf to replicated.
3. The rule sets ``dp`` (replicate), ``dp_tp`` (Megatron column and row
   splits; the specs are data here, the placement waits for A7.9) and
   ``zero3`` (every leaf split over ``data`` on its first divisible dim).

A spec is the JAX ``PartitionSpec`` as a plain tuple of axis names (None for
a whole dim). Placement is SPMD: :func:`device_put` gives this rank its
local shard of each leaf. The JAX package's telemetry (the spec counter and
the per-device bytes gauge) is plain counters here (:func:`stats`).
"""
from __future__ import annotations

import re
import threading
from collections import Counter
from typing import Any, Callable, Iterable, Optional, Sequence, Tuple

import numpy as np
import torch

#: 1-D leaves below this many elements replicate whatever the rules say
TINY_VECTOR = 8


class PartitionSpec(tuple):
    """Axis names by dim (None: the dim is whole); ``PartitionSpec()`` is
    replicated. Trailing dims not named are whole."""

    def __new__(cls, *axes):
        return super().__new__(cls, axes)

    def __repr__(self) -> str:
        return "PartitionSpec(" + ", ".join(repr(a) for a in self) + ")"


pspec = PartitionSpec


class PartitionRuleError(ValueError):
    """A non-scalar leaf matched no rule. Raised, not defaulted: a leaf
    replicated by accident is a run that stops scaling unseen."""


# ------------------------------------------------------------- rule values
class FirstDivisible:
    """Shard the first dim the mesh axis divides; replicate if none (the
    ZeRO scan)."""

    def __init__(self, axis: str = "data"):
        self.axis = axis

    def __repr__(self):
        return f"FirstDivisible({self.axis!r})"


class Col:
    """Megatron column split: the LAST (output) dim; a 1-D bias splits
    too."""

    def __init__(self, axis: str = "model"):
        self.axis = axis

    def __repr__(self):
        return f"Col({self.axis!r})"


class Row:
    """Megatron row split: the SECOND-TO-LAST (input) dim; 1-D leaves
    replicate."""

    def __init__(self, axis: str = "model"):
        self.axis = axis

    def __repr__(self):
        return f"Row({self.axis!r})"


# ---------------------------------------------------------------- tree walk
def _is_container(x) -> bool:
    return isinstance(x, (dict, list, tuple)) and not isinstance(
        x, PartitionSpec)


def named_tree_map(f: Callable[..., Any], tree, *rest, sep: str = "/",
                   top_names: Optional[dict] = None):
    """A tree map whose function gets the ``sep``-joined path first:
    ``f(path, leaf, *rest_leaves)``. ``rest`` trees have ``tree``'s
    structure, or hold a leaf (a spec) where ``tree`` holds a subtree, which
    then applies to the whole subtree. ``top_names`` rewrites the first path
    component."""

    def walk(node, others, parts):
        if isinstance(node, dict):
            return {k: walk(v, [_child(o, k) for o in others], parts + [str(k)])
                    for k, v in node.items()}
        if _is_container(node):
            out = [walk(v, [_child(o, i) for o in others], parts + [str(i)])
                   for i, v in enumerate(node)]
            return type(node)(out) if isinstance(node, tuple) else out
        if node is None:
            return None
        if top_names and parts:
            parts = [top_names.get(parts[0], parts[0])] + parts[1:]
        return f(sep.join(parts), node, *others)

    return walk(tree, list(rest), [])


def _child(node, key):
    return node[key] if _is_container(node) else node


def tree_leaves(tree) -> list:
    """The leaves of a tree of lists and dicts, in walk order."""
    out: list = []
    named_tree_map(lambda _p, leaf: out.append(leaf), tree)
    return out


def _type_name(lc) -> str:
    from ..nn.conf.serde import layer_class
    return layer_class(lc.type).__name__


def model_top_names(tree, conf) -> dict:
    """A model tree's top components named with their layer class: list
    index ``0`` -> ``0.DenseLayer``, vertex ``ff`` -> ``ff.TransformerBlock``.
    Params, gradients and updater state share the structure."""
    if conf is None:
        return {}
    layers = getattr(conf, "layers", None)
    if isinstance(tree, (list, tuple)) and layers:
        return {str(i): f"{i}.{_type_name(l)}" for i, l in enumerate(layers)}
    vertices = getattr(conf, "vertices", None)
    if isinstance(tree, dict) and vertices:
        out = {}
        for name in tree:
            layer = getattr(vertices.get(name), "layer", None)
            out[name] = (f"{name}.{_type_name(layer)}" if layer is not None
                         else name)
        return out
    return {}


# ------------------------------------------------------------- rule matching
def _axis_factor(mesh, axis) -> Optional[int]:
    """Product of the mesh sizes of a spec entry (a name or a tuple of
    names); None if a name is not a mesh axis."""
    f = 1
    for a in (axis if isinstance(axis, tuple) else (axis,)):
        if mesh is None or a not in mesh.shape:
            return None
        f *= mesh.shape[a]
    return f


def _resolve(value, shape: Sequence[int], mesh) -> PartitionSpec:
    """A rule value as a concrete spec for ``shape``, demoted to replicated
    when the axis is absent or does not divide the dim."""
    if isinstance(value, FirstDivisible):
        f = _axis_factor(mesh, value.axis)
        if f is not None:
            for d, n in enumerate(shape):
                if n % f == 0:
                    return PartitionSpec(*([None] * d), value.axis)
        return PartitionSpec()
    if isinstance(value, Col):
        f = _axis_factor(mesh, value.axis)
        if f is not None and shape and shape[-1] % f == 0:
            return PartitionSpec(*([None] * (len(shape) - 1)), value.axis)
        return PartitionSpec()
    if isinstance(value, Row):
        f = _axis_factor(mesh, value.axis)
        if f is not None and len(shape) >= 2 and shape[-2] % f == 0:
            return PartitionSpec(*([None] * (len(shape) - 2)), value.axis,
                                 None)
        return PartitionSpec()
    if isinstance(value, PartitionSpec):
        if len(value) > len(shape):
            return PartitionSpec()
        for d, ax in enumerate(value):
            if ax is None:
                continue
            f = _axis_factor(mesh, ax)
            if f is None or shape[d] % f:
                return PartitionSpec()
        return value
    raise TypeError(f"rule value {value!r} is not a PartitionSpec/"
                    f"Col/Row/FirstDivisible")


def _shape(leaf) -> Tuple[int, ...]:
    return tuple(getattr(leaf, "shape", ()) or ())


def match_partition_rules(rules: Iterable[Tuple[str, Any]], tree, *,
                          mesh=None, conf=None, sep: str = "/") -> Any:
    """``(regex, value)`` rules onto ``tree``: a tree of specs. First match
    wins (``re.search``, unanchored: ``/W(/|$)`` hits a param and its
    moments ``/W/m``). Scalars, size-1 and tiny 1-D leaves replicate
    without a rule; an unmatched non-scalar leaf raises
    :class:`PartitionRuleError`."""
    rules = [(re.compile(pat), val) for pat, val in rules]

    def spec_for(path, leaf):
        shape = _shape(leaf)
        size = int(np.prod(shape)) if shape else 1
        if not shape or size <= 1 or (len(shape) == 1 and size < TINY_VECTOR):
            return PartitionSpec()
        for pat, val in rules:
            if pat.search(path):
                return _resolve(val, shape, mesh)
        raise PartitionRuleError(
            f"no partition rule matches leaf {path!r} with shape {shape}; "
            f"add a rule (or an explicit '.*' -> P() catch-all): silent "
            f"replication is not a default")

    return named_tree_map(spec_for, tree, sep=sep,
                          top_names=model_top_names(tree, conf))


# -------------------------------------------------------------- rule sets
def dp_rules() -> list:
    """Data parallelism: every parameter replicated."""
    return [(r".*", PartitionSpec())]


def dp_tp_rules(model_axis: str = "model") -> list:
    """Megatron dp x tp: column-split the up-projections (fused QKV, MLP and
    expert W1, dense/conv/LSTM output dims) and their biases, row-split the
    down-projections (Wo, W2); norms, gates and the rest replicate."""
    return [
        (r"/Wqkv(/|$)", Col(model_axis)),
        (r"/Wo(/|$)", Row(model_axis)),
        (r"/W1(/|$)", Col(model_axis)),
        (r"/W2(/|$)", Row(model_axis)),
        (r"/b1(/|$)", Col(model_axis)),
        (r"/(W|RW|FW|FRW|BW|BRW)(/|$)", Col(model_axis)),
        (r"/(b|Fb|Bb)(/|$)", Col(model_axis)),
        (r".*", PartitionSpec()),
    ]


def zero3_rules(data_axis: str = "data") -> list:
    """ZeRO-3: every parameter and updater-state leaf split over the data
    axis on its first divisible dim."""
    return [(r".*", FirstDivisible(data_axis))]


RULE_SETS = {"dp": dp_rules, "dp_tp": dp_tp_rules, "zero3": zero3_rules}


def rules_for(name: str, **kwargs) -> list:
    try:
        return RULE_SETS[name](**kwargs)
    except KeyError:
        raise ValueError(f"unknown rule set {name!r}; have {sorted(RULE_SETS)}")


# ----------------------------------------------------------- placement
def sharded_dim(spec: PartitionSpec) -> Optional[Tuple[int, Any]]:
    """``(dim, axis)`` of the one dim a spec splits, None if replicated.
    A spec that splits two dims (tensor parallelism) raises."""
    named = [(d, a) for d, a in enumerate(spec) if a is not None]
    if not named:
        return None
    if len(named) > 1:
        raise NotImplementedError(
            f"spec {spec!r} splits more than one dim: placement across two "
            "axes is tensor parallelism (ROADMAP.md A7.9)")
    return named[0]


def local_shard(leaf: torch.Tensor, spec: PartitionSpec, mesh) -> torch.Tensor:
    """This rank's block of ``leaf`` under ``spec`` (a copy; the leaf
    itself when replicated)."""
    at = sharded_dim(spec)
    if at is None:
        return leaf
    d, axis = at
    axes = axis if isinstance(axis, tuple) else (axis,)
    n = mesh.axis_size(*axes)
    return leaf.chunk(n, dim=d)[mesh.index(*axes)].clone()


def device_put(tree, mesh, spec_tree):
    """``tree`` placed per ``spec_tree`` (a spec tree, or one spec for the
    whole tree): each rank keeps its local shard of each leaf."""
    return named_tree_map(lambda _p, leaf, spec: local_shard(leaf, spec, mesh),
                          tree, spec_tree)


def batch_spec(mesh, n: int, axis: str = "data") -> PartitionSpec:
    """The leading-axis spec of a batch of ``n`` rows: split on ``axis``
    when the mesh divides ``n``, replicated otherwise."""
    f = _axis_factor(mesh, axis)
    if f and f > 1 and n % f == 0:
        return PartitionSpec(axis)
    return PartitionSpec()


def shard_factor(mesh, spec: PartitionSpec) -> int:
    """How many ways ``spec`` splits one array across the mesh."""
    f = 1
    for ax in spec:
        if ax is None:
            continue
        f *= _axis_factor(mesh, ax) or 1
    return f


def _nbytes(leaf) -> int:
    if isinstance(leaf, torch.Tensor):
        return leaf.numel() * leaf.element_size()
    return int(np.asarray(leaf).nbytes)


def tree_nbytes(tree) -> int:
    return sum(_nbytes(leaf) for leaf in tree_leaves(tree))


def per_device_bytes(tree, spec_tree, mesh) -> int:
    """Bytes of ``tree`` each rank holds under ``spec_tree`` (a spec tree,
    or one spec for the whole tree)."""
    total = 0.0
    for b in tree_leaves(named_tree_map(
            lambda _p, leaf, spec: _nbytes(leaf) / shard_factor(mesh, spec),
            tree, spec_tree)):
        total += b
    return int(total)


# --------------------------------------------------------------- counters
_lock = threading.Lock()
_spec_counts: Counter = Counter()
_param_bytes: dict = {}


def _spec_label(spec: PartitionSpec) -> str:
    return "P(" + ",".join(str(a) for a in spec) + ")"


def record_specs(rule_set: str, *spec_trees) -> None:
    """Count each resolved spec of the trees, by rule set (the JAX
    package's ``dl4j_sharding_spec_total``)."""
    with _lock:
        for tree in spec_trees:
            if isinstance(tree, PartitionSpec):
                _spec_counts[(rule_set, _spec_label(tree))] += 1
                continue
            if tree is None:
                continue
            for s in tree_leaves(tree):
                if isinstance(s, PartitionSpec):
                    _spec_counts[(rule_set, _spec_label(s))] += 1


def record_param_bytes(rule_set: str, tree, spec_tree, mesh) -> int:
    """Record the per-rank bytes of ``tree`` under ``spec_tree`` for the
    rule set (the JAX package's per-device bytes gauge); returns them."""
    b = per_device_bytes(tree, spec_tree, mesh)
    with _lock:
        _param_bytes[rule_set] = b
    return b


def stats() -> dict:
    """``{"sharding_spec_total": {(rule set, spec): n},
    "sharded_param_bytes_per_device": {rule set: bytes}}``."""
    with _lock:
        return {"sharding_spec_total": dict(_spec_counts),
                "sharded_param_bytes_per_device": dict(_param_bytes)}
