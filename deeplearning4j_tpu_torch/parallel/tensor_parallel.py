"""Tensor parallelism: the ``dp_tp`` placement over the ``model`` axis.

The JAX package states ``dp_tp`` as specs only (``partition.dp_tp_rules``:
Megatron column splits of ``Wqkv``, ``W1``, ``b1`` and the dense, conv and
LSTM weights and biases, row splits of ``Wo`` and ``W2``) and GSPMD
inserts the collectives those layouts imply. Here the collectives are
written out. A step on a ``{data, model}`` mesh splits the batch's rows
over ``data`` only: the ranks of one model group see the same rows and
compute the same loss. Each leaf the rules split is held at rest as this
rank's block, and used in one of two ways:

* **Megatron pairs**, where a layer can compute on its block:
  - the attention of ``TransformerBlock`` and ``MoETransformerBlock``
    (``attention_residual``) when the model axis divides the heads: a rank
    computes with the q, k and v columns of its ``H/n`` heads and with the
    rows of ``Wo`` that read them;
  - ``TransformerBlock``'s FFN (``W1``, ``b1`` by columns, ``W2`` by rows)
    and the experts of ``MoELayer``/``MoETransformerBlock`` (``W1 [E, F,
    H]``, ``b1 [E, H]`` and ``W2 [E, H, F]`` by the hidden units), when all
    three are split.

  The replicated input enters through :func:`copy_to_model` (the identity
  forward, an ``all_reduce`` of its gradient over ``model``) and the row
  half's partial products leave through :func:`reduce_from_model` (an
  ``all_reduce`` forward, the identity backward); ``bo``/``b2`` are added
  once, after that sum.
* **Gather at use**, every other split leaf (the embedding, dense, conv,
  LSTM and output layers, and a pair that does not engage): the step
  all-gathers the whole leaf from the blocks before the forward, an exact
  layout change (zero3's gather over ``data``, here over ``model``), so
  the loss and the LSTM kernels see whole rows. The ranks of the group run
  the same forward on it, so a rank keeps its own block of the leaf's
  gradient.

What a rank holds at rest: its block of every split leaf in the layout it
computes with, and every other leaf whole. For a gathered leaf that is the
spec's contiguous block; for ``Wqkv`` in a Megatron attention it is the
concatenation of its heads' q, k and v columns (``j·F + r·F/n ..
j·F + (r+1)·F/n`` for ``j = 0, 1, 2``), the same ``3F/n`` columns as the
spec's block but not the same ones, because the port splits ``qkv`` into
q, k and v by ``F`` columns and the spec's contiguous block is not a head
group. The updater state's slots follow their param. The network's whole
tensors of split leaves give their storage back between steps, and
``fit`` ends with them whole again in JAX's order.

Data-axis gradient averaging is the synchronous step's: one ``all_reduce``
over ``data`` of the blocks' and the replicated leaves' gradients. Squared
sums of split leaves (gradient normalization, LARS/LAMB) are summed over
``model``.
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.distributed as dist

from . import compile_seam
from .compile_seam import (
    WholeViews, _spec_at, count_collective, free_storage)
from .partition import sharded_dim


class ShardedParams(dict):
    """One layer's params as a ``dp_tp`` step hands them to its forward:
    the names in ``shards`` are this rank's blocks (a Megatron pair), the
    rest whole. ``group``, ``size`` and ``index`` describe the model
    group. The layers reach the collectives through the hooks of
    ``nn/param_blocks.py``: ``enter`` (the replicated input of a column
    block), ``leave`` (a row block's partial product summed), ``whole_sum``
    and ``is_block``."""

    def __init__(self, items, group, size: int, index: int, shards):
        super().__init__(items)
        self.group, self.size, self.index = group, size, index
        self.shards = frozenset(shards)

    def is_block(self, name: str) -> bool:
        return name in self.shards

    def enter(self, name: str, x: torch.Tensor) -> torch.Tensor:
        return copy_to_model(x, self) if name in self.shards else x

    def leave(self, name: str, y: torch.Tensor) -> torch.Tensor:
        return reduce_from_model(y, self) if name in self.shards else y

    def whole_sum(self, name: str, t: torch.Tensor) -> torch.Tensor:
        s = t.sum()
        return reduce_from_model(s, self) if name in self.shards else s


class _CopyToModel(torch.autograd.Function):
    """Identity forward; the gradient summed over the model group."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        if ctx.group is not None:
            dist.all_reduce(g, group=ctx.group)
            count_collective("all_reduce", "tp_input_grad",
                             g.numel() * g.element_size())
        return g, None


class _ReduceFromModel(torch.autograd.Function):
    """The partial products summed over the model group; identity
    backward."""

    @staticmethod
    def forward(ctx, x, group):
        x = x.contiguous().clone()
        if group is not None:
            dist.all_reduce(x, group=group)
            count_collective("all_reduce", "tp_output",
                             x.numel() * x.element_size())
        return x

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_to_model(x: torch.Tensor, tp: ShardedParams) -> torch.Tensor:
    return _CopyToModel.apply(x, tp.group)


def reduce_from_model(x: torch.Tensor, tp: ShardedParams) -> torch.Tensor:
    return _ReduceFromModel.apply(x, tp.group)


# ------------------------------------------------------------------ layouts
class _Layout:
    """How a leaf is split: along ``dim`` into ``n`` blocks, within each of
    ``groups`` equal parts of that dim (``groups`` 3 is ``Wqkv``'s q, k, v
    head layout; 1 is the spec's contiguous block)."""

    __slots__ = ("dim", "groups")

    def __init__(self, dim: int, groups: int = 1):
        self.dim, self.groups = dim, groups

    def split(self, full: torch.Tensor, n: int, index: int) -> torch.Tensor:
        parts = [g.chunk(n, self.dim)[index]
                 for g in full.chunk(self.groups, self.dim)]
        return torch.cat(parts, self.dim).contiguous()

    def join(self, blocks: list) -> torch.Tensor:
        parts = [torch.cat([b.chunk(self.groups, self.dim)[j]
                            for b in blocks], self.dim)
                 for j in range(self.groups)]
        return torch.cat(parts, self.dim)


def _megatron_names(layer, split: dict, n: int) -> tuple:
    """``(names computed on their blocks, their layouts)`` of a layer: the
    pairs that engage, given the leaves the rules split (name -> dim)."""
    from ..nn.conf.layers.attention import TransformerBlock
    from ..nn.conf.layers.moe import MoELayer, MoETransformerBlock

    names, layouts = set(), {}
    if isinstance(layer, (TransformerBlock, MoETransformerBlock)) and \
            layer.n_heads % n == 0 and split.get("Wqkv") == 1 and \
            split.get("Wo") == 0:
        names |= {"Wqkv", "Wo"}
        layouts["Wqkv"] = _Layout(1, 3)
    if isinstance(layer, MoELayer):
        pair = {"W1": 2, "b1": 1, "W2": 1}
    elif isinstance(layer, TransformerBlock):
        pair = {"W1": 1, "b1": 0, "W2": 0}
    else:
        pair = {}
    if pair and all(split.get(k) == d for k, d in pair.items()):
        names |= set(pair)
    return names, layouts


class TPPlacement(WholeViews):
    """The ``dp_tp`` placement of one network on the mesh's ``axis``: each
    split leaf's block on this rank (``shards``), the layers' Megatron
    pairs, and the collectives between the blocks and the whole leaves.
    It has the interface of ``compile_seam.Sharding`` that the wrapper's
    fit reads (``begin``, ``end``, ``gather_all``, the updater state's
    scatter and gather)."""

    def __init__(self, view, mesh, axis: str, param_specs):
        self.view, self.mesh, self.axis = view, mesh, axis
        self.group = mesh.group(axis)
        self.n = mesh.shape[axis]
        self.idx = mesh.coords[axis]
        params = view.params()
        #: (key, name) -> the layout of a split leaf
        self.layouts: Dict[tuple, _Layout] = {}
        #: key -> the names its forward computes on as blocks
        self.megatron: Dict[object, frozenset] = {}
        for key in view.keys:
            split = {}
            for name in params[key]:
                at = sharded_dim(_spec_at(param_specs, key, name))
                if at is not None:
                    split[name] = at[0]
            names, special = _megatron_names(view.layers[key], split, self.n)
            self.megatron[key] = frozenset(names)
            for name, d in split.items():
                self.layouts[(key, name)] = special.get(name, _Layout(d))
        #: this rank's block of each split leaf (a leaf tensor)
        self.shards: Dict[tuple, torch.Tensor] = {}

    def _full(self, key, name) -> torch.Tensor:
        return self.view.params()[key][name]

    def _gather(self, block: torch.Tensor, layout: _Layout,
                site: str) -> torch.Tensor:
        if self.group is None:
            return layout.join([block])
        buf = block.new_empty((self.n * block.shape[0],)
                              + tuple(block.shape[1:]))
        dist.all_gather_into_tensor(buf, block.contiguous(), group=self.group)
        count_collective("all_gather", site, buf.numel() * buf.element_size())
        return layout.join(list(buf.view((self.n,) + tuple(block.shape))
                                .unbind(0)))

    # -- the network's state in and out of the placement
    @torch.no_grad()
    def begin(self) -> None:
        """Blocks taken anew from the network's whole params (a load may
        have replaced them), the whole tensors' storage given back."""
        self.shards.clear()
        for (key, name), layout in self.layouts.items():
            p = self._full(key, name)
            block = layout.split(p.detach(), self.n, self.idx)
            self.shards[(key, name)] = block.requires_grad_(True)
            free_storage(p)

    @torch.no_grad()
    def gather_all(self) -> None:
        """Every split leaf whole again from the blocks, in JAX's order."""
        for (key, name), layout in self.layouts.items():
            p = self._full(key, name)
            if p.untyped_storage().size() == 0:
                p.untyped_storage().resize_(p.numel() * p.element_size())
            if (key, name) in self.shards:
                p.copy_(self._gather(self.shards[(key, name)], layout,
                                     "tp_gather"))

    def end(self) -> None:
        self.gather_all()
        self.shards.clear()

    def _slots(self, upd, fn):
        view = self.view
        by_key = {}
        for key in view.keys:
            own = view.upd_of(upd, key)
            layer = {}
            for name, slots in own.items():
                layout = self.layouts.get((key, name))
                layer[name] = (slots if layout is None else
                               {s: fn(t, layout, key, name)
                                for s, t in slots.items()})
            by_key[key] = layer
        return view.new_upd(by_key, upd)

    @torch.no_grad()
    def scatter_updater_state(self, upd):
        """The updater state's slots of split leaves as this rank's blocks,
        in their param's layout."""
        def cut(t, layout, key, name):
            if tuple(t.shape) != tuple(self._full(key, name).shape):
                return t
            return layout.split(t, self.n, self.idx)
        return self._slots(upd, cut)

    @torch.no_grad()
    def gather_updater_state(self, upd):
        """The blocks of the updater state whole again on every rank."""
        def whole(t, layout, key, name):
            if tuple(t.shape) == tuple(self._full(key, name).shape):
                return t
            return self._gather(t, layout, "tp_state")
        return self._slots(upd, whole)

    # -- a step's view of the params
    def step_params(self):
        """The params container a step's forward reads: per layer a
        :class:`ShardedParams` of the replicated leaves, this rank's blocks
        of its Megatron pairs, and the gathered leaves as fresh whole
        tensors (leaves of this step's graph)."""
        view = self.view
        params = view.params()
        out = {}
        for key in view.keys:
            items = {}
            for name, p in params[key].items():
                layout = self.layouts.get((key, name))
                if layout is None:
                    items[name] = p
                elif name in self.megatron[key]:
                    items[name] = self.shards[(key, name)]
                else:
                    with torch.no_grad():
                        whole = self._gather(self.shards[(key, name)],
                                             layout, "tp_at_use")
                    items[name] = whole.requires_grad_(True)
            out[key] = ShardedParams(items, self.group, self.n, self.idx,
                                     self.megatron[key])
        if view.graph:
            return out
        return [out[k] for k in view.keys]

    def block_grad(self, key, name, g: torch.Tensor) -> torch.Tensor:
        """A leaf's gradient as the update sees it: this rank's block (of a
        gathered leaf's whole gradient), or as it is."""
        layout = self.layouts.get((key, name))
        if layout is None or name in self.megatron[key]:
            return g
        return layout.split(g, self.n, self.idx)

    def update_view(self, key) -> dict:
        """A layer's params as its update writes them: the blocks of the
        split leaves, the rest whole."""
        params = self.view.params()[key]
        return {name: self.shards.get((key, name), p)
                for name, p in params.items()}

    def sqsum(self, key):
        """The squared-sum rule of a layer's update: a split leaf's summed
        over the model group."""
        split = {name for (k, name) in self.layouts if k == key}
        if not split or self.group is None:
            return None

        def f(name, t):
            s = torch.sum(t * t)
            if name in split:
                dist.all_reduce(s, group=self.group)
            return s
        return f

    def checkpoint_entry(self, key, name, t: torch.Tensor, slot):
        """What a sharded checkpoint saves of a leaf (``slot`` None) or of
        an updater slot between steps: ``(key suffix, tensor)``, this
        rank's block of a split leaf in its layout, the dim moved first
        (``Wqkv``'s as its share of the q, k and v thirds)."""
        from ..utils.sharded_checkpoint import shard_suffix
        layout = self.layouts.get((key, name))
        block = self.shards.get((key, name))
        if layout is None or block is None:
            return "", t
        if slot is not None:
            if tuple(t.shape) != tuple(block.shape):
                return "", t  # a slot the scatter kept whole
            block = t
        return (shard_suffix(self.idx, self.n, layout.dim, layout.groups),
                block.movedim(layout.dim, 0))

    def held_bytes(self) -> int:
        """Bytes of params this rank holds between steps."""
        total = 0
        params = self.view.params()
        for key in self.view.keys:
            for name, p in params[key].items():
                t = self.shards.get((key, name))
                total += (t if t is not None else p).numel() * \
                    p.element_size()
        return total

    # -- the whole view between steps (Wqkv joined from its q, k, v parts)
    def held_parts(self) -> frozenset:
        return frozenset(("params", "updater") if self.shards else ())

    def _view_in(self, parts) -> int:
        net = self.view.net
        nbytes = 0
        if "params" in parts:
            self.gather_all()
            nbytes += sum(self._full(k, n).numel() * self._full(k, n)
                          .element_size() for (k, n) in self.shards)
        if "updater" in parts:
            self._held_upd = net.updater_state
            net.updater_state = self.gather_updater_state(self._held_upd)
            nbytes += sum(t.numel() * t.element_size()
                          for (k, n) in self.shards
                          for t in self.view.upd_of(net.updater_state, k)
                          .get(n, {}).values())
        return nbytes

    @torch.no_grad()
    def _view_out(self, parts) -> None:
        if "updater" in parts:
            self.view.net.updater_state = self._held_upd
            self._held_upd = None
        if "params" in parts:
            for (key, name) in self.shards:
                free_storage(self._full(key, name))


class TPStep:
    """The synchronous ``dp_tp`` step: the forward on the placement's
    params, the gradients averaged over the batch's ranks, the update on
    the blocks."""

    def __init__(self, view, mesh, reduce_axes, placement: TPPlacement):
        self.view, self.mesh = view, mesh
        self.group = mesh.group(*reduce_axes)
        self.n = mesh.axis_size(*reduce_axes)
        #: the ranks of a model group draw the same dropout masks: the seed
        #: is folded with the batch's index, not the global rank
        self.fold = mesh.index(*reduce_axes)
        self.sharding = placement

    def __call__(self, xs, ys, rng, iteration, upd, fmasks=None,
                 lmasks=None):
        from ..nn.multilayer import UPDATER_LABEL, update_layer
        view, pl = self.view, self.sharding
        params = pl.step_params()
        loss, new_states = view.objective(
            params, xs, ys, compile_seam._fold_rank(rng, self.fold), fmasks,
            lmasks)
        grads = view.grads(loss, params)
        g = view.net.conf.global_conf
        with torch.no_grad(), torch.profiler.record_function(UPDATER_LABEL):
            grads = {key: {name: pl.block_grad(key, name, gr)
                           for name, gr in grads.get(key, {}).items()}
                     for key in view.keys}
            self._average(grads)
            new_upd = {}
            for key in view.keys:
                if not grads[key]:
                    continue
                new_upd[key] = update_layer(
                    g, view.layers[key], pl.update_view(key), grads[key],
                    view.upd_of(upd, key), iteration, sqsum=pl.sqsum(key))
        loss = compile_seam._mean_over(loss.detach().clone(), self.group,
                                       self.n)
        return view.new_upd(new_upd, upd), new_states, loss

    def _average(self, grads: dict) -> None:
        if self.group is None:
            return
        flat = [gr for key in self.view.keys for gr in grads[key].values()]
        if not flat:
            return
        buf = torch.cat([gr.reshape(-1).to(torch.float32) for gr in flat])
        dist.all_reduce(buf, group=self.group)
        count_collective("all_reduce", "grad", buf.numel() * buf.element_size())
        buf.div_(self.n)
        at = 0
        for gr in flat:
            gr.copy_(buf[at:at + gr.numel()].view(gr.shape))
            at += gr.numel()
