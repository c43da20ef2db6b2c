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
   splits, placed by ``tensor_parallel.py``) and
   ``zero3`` (every leaf split over ``data`` on its first divisible dim).

A spec is the JAX ``PartitionSpec`` as a plain tuple of axis names (None for
a whole dim). On a process-group ``Mesh`` placement is SPMD:
:func:`device_put` gives this rank its local shard of each leaf. On a
``DeviceMesh`` (one process driving a device list) it gives each leaf as a
:class:`MeshLeaf`, the tensor every slot holds on its device. An int8
``QuantizedLeaf`` is a node of the tree, its ``q`` and ``scale`` leaves
named as the JAX package's pytree paths name them (``.../W/q``). The JAX
package's telemetry is recorded as its series: ``dl4j_sharding_spec_total``
(one count a resolved spec) and ``dl4j_sharded_param_bytes_per_device``
(the bytes a rank holds under a rule set), which :func:`stats` reads back.
"""
from __future__ import annotations

import re
from typing import Any, Callable, Iterable, Optional, Sequence, Tuple

import numpy as np
import torch

from ..observability.metrics import LabeledSeries, global_registry
from ..observability.names import (
    SHARDED_PARAM_BYTES_PER_DEVICE, SHARDING_SPEC_TOTAL)

#: 1-D leaves below this many elements replicate whatever the rules say
TINY_VECTOR = 8


class PartitionSpec(tuple):
    """Axis names by dim (None: the dim is whole); ``PartitionSpec()`` is
    replicated. Trailing dims not named are whole."""

    def __new__(cls, *axes):
        return super().__new__(cls, axes)

    def __getnewargs__(self):
        # a pickled spec unpickles through __new__(cls, *axes)
        return tuple(self)

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


def _is_record(x) -> bool:
    """A named tuple (``QuantizedLeaf``): its fields are named in paths."""
    return isinstance(x, tuple) and hasattr(x, "_fields")


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
        if _is_record(node):
            return type(node)(*[
                walk(v, [_child(o, i) for o in others], parts + [f])
                for i, (f, v) in enumerate(zip(node._fields, node))])
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
def split_dims(spec: PartitionSpec) -> list:
    """``[(dim, axes), ...]`` of every dim ``spec`` splits, in dim order,
    ``axes`` a tuple of mesh axis names; empty if replicated."""
    return [(d, a if isinstance(a, tuple) else (a,))
            for d, a in enumerate(spec) if a is not None]


def sharded_dim(spec: PartitionSpec) -> Optional[Tuple[int, Any]]:
    """``(dim, axis)`` of the first dim a spec splits, None if replicated
    (:func:`split_dims` lists them all)."""
    named = [(d, a) for d, a in enumerate(spec) if a is not None]
    return named[0] if named else None


def one_split(spec: PartitionSpec, what: str) -> Optional[Tuple[int, tuple]]:
    """``(dim, axes)`` of the one dim ``spec`` splits, None if replicated,
    for the placements that hold a leaf split on one dim (``what`` names
    the placement): a spec that splits two raises ``ValueError``."""
    splits = split_dims(spec)
    if len(splits) > 1:
        raise ValueError(f"{what} holds a leaf split on one dim; spec "
                         f"{spec!r} splits {len(splits)} (device_put places "
                         "it)")
    return splits[0] if splits else None


def block_of(leaf: torch.Tensor, splits, mesh) -> torch.Tensor:
    """This rank's block of ``leaf`` (a contiguous copy) under ``splits``
    (``[(dim, axes), ...]``): along each split dim, the block at this
    rank's row-major position on that dim's axes, as JAX lays out a
    ``NamedSharding``."""
    for d, axes in splits:
        leaf = leaf.chunk(mesh.axis_size(*axes), dim=d)[mesh.index(*axes)]
    return leaf.clone(memory_format=torch.contiguous_format)


def local_shard(leaf: torch.Tensor, spec: PartitionSpec, mesh) -> torch.Tensor:
    """This rank's block of ``leaf`` under ``spec`` (:func:`block_of`; the
    leaf itself when replicated)."""
    splits = split_dims(spec)
    return block_of(leaf, splits, mesh) if splits else leaf


class MeshLeaf:
    """A leaf placed on a ``DeviceMesh``: ``shards[s]`` is the tensor slot
    ``s`` holds on its device, its block along every dim ``spec`` splits
    (the spec's contiguous block, as JAX lays a sharded array out), or the
    whole leaf where ``spec`` replicates it. ``shape``, ``dtype`` and
    :attr:`nbytes` are the whole leaf's."""

    __slots__ = ("shards", "spec", "shape", "dtype", "mesh")

    def __init__(self, leaf: torch.Tensor, spec: PartitionSpec, mesh):
        self.spec, self.mesh = spec, mesh
        self.shape, self.dtype = tuple(leaf.shape), leaf.dtype
        splits = split_dims(spec)
        self.shards = []
        for s in range(mesh.size):
            part = leaf
            for d, axes in splits:
                part = part.chunk(mesh.axis_size(*axes), dim=d)[
                    mesh.index(s, *axes)]
            self.shards.append(part.detach().to(mesh.device_of(s),
                                                copy=True).contiguous())

    def numel(self) -> int:
        return int(np.prod(self.shape)) if self.shape else 1

    def element_size(self) -> int:
        return self.shards[0].element_size()

    @property
    def nbytes(self) -> int:
        return self.numel() * self.element_size()

    def whole(self, slot: int) -> torch.Tensor:
        """The whole leaf for ``slot``, on its device: its own copy where
        replicated, else its peers' blocks along the split axes copied
        there and concatenated in order, the last split dim first (an
        exact layout change, no arithmetic)."""
        splits = split_dims(self.spec)
        if not splits:
            return self.shards[slot]
        dev = self.mesh.device_of(slot)
        axes = [a for _d, ax in splits for a in ax]
        # the peers in row-major order over the split dims' axes
        blocks = [self.shards[p].to(dev) for p in self.mesh.peers(slot, *axes)]
        for d, ax in reversed(splits):
            n = self.mesh.axis_size(*ax)
            blocks = [torch.cat(blocks[i:i + n], d)
                      for i in range(0, len(blocks), n)]
        return blocks[0]

    def __repr__(self) -> str:
        return f"MeshLeaf({self.shape}, {self.dtype}, {self.spec!r})"


def is_device_mesh(mesh) -> bool:
    """Whether ``mesh`` is a ``DeviceMesh`` (a device list one process
    drives), not a process group's ``Mesh``."""
    return hasattr(mesh, "slots")


def device_put(tree, mesh, spec_tree):
    """``tree`` placed per ``spec_tree`` (a spec tree, or one spec for the
    whole tree): on a process-group ``Mesh`` each rank keeps its local
    shard of each leaf; on a ``DeviceMesh`` each leaf becomes a
    :class:`MeshLeaf` holding one tensor for every slot, on that slot's
    device."""
    if is_device_mesh(mesh):
        return named_tree_map(lambda _p, leaf, spec: MeshLeaf(leaf, spec,
                                                              mesh),
                              tree, spec_tree)
    return named_tree_map(lambda _p, leaf, spec: local_shard(leaf, spec, mesh),
                          tree, spec_tree)


def gather_whole(tree, slot: int):
    """A tree placed by :func:`device_put` on a ``DeviceMesh`` as whole
    tensors on ``slot``'s device (see :meth:`MeshLeaf.whole`)."""
    return named_tree_map(
        lambda _p, leaf: leaf.whole(slot) if isinstance(leaf, MeshLeaf)
        else leaf, tree)


def slot_bytes(tree, slot: int) -> int:
    """The bytes the tensors ``slot`` holds of a tree placed on a
    ``DeviceMesh`` take."""
    return sum(leaf.shards[slot].numel() * leaf.shards[slot].element_size()
               for leaf in tree_leaves(tree) if isinstance(leaf, MeshLeaf))


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
    if isinstance(leaf, (torch.Tensor, MeshLeaf)):
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


# --------------------------------------------------------------- telemetry
_spec_counts = LabeledSeries(global_registry().counter(
    SHARDING_SPEC_TOTAL,
    "partition-rule engine spec decisions, one count per leaf per "
    "compiled step, by rule set and resolved spec"), "rule_set", "spec")
_param_bytes = LabeledSeries(global_registry().gauge(
    SHARDED_PARAM_BYTES_PER_DEVICE,
    "per-device bytes of the parameter tree under the resolved specs — "
    "zero3 should read ~1/N of the replicated figure"), "rule_set")


def _spec_label(spec: PartitionSpec) -> str:
    return "P(" + ",".join(str(a) for a in spec) + ")"


def record_specs(rule_set: str, *spec_trees) -> None:
    """Count each resolved spec of the trees, by rule set
    (``dl4j_sharding_spec_total``)."""
    for tree in spec_trees:
        if tree is None:
            continue
        specs = [tree] if isinstance(tree, PartitionSpec) \
            else tree_leaves(tree)
        for s in specs:
            if isinstance(s, PartitionSpec):
                _spec_counts(rule_set, _spec_label(s)).inc()


def record_param_bytes(rule_set: str, tree, spec_tree, mesh) -> int:
    """Set the per-rank bytes of ``tree`` under ``spec_tree`` for the rule
    set (``dl4j_sharded_param_bytes_per_device``); returns them."""
    b = per_device_bytes(tree, spec_tree, mesh)
    _param_bytes(rule_set).set(b)
    return b


def stats() -> dict:
    """The series read back: ``{"sharding_spec_total": {(rule set, spec):
    n}, "sharded_param_bytes_per_device": {rule set: bytes}}``."""
    return {"sharding_spec_total": _spec_counts.read(),
            "sharded_param_bytes_per_device": _param_bytes.read()}
