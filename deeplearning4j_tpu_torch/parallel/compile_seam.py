"""The one seam every parallel fit path builds its step through.

Counterpart of ``deeplearning4j_tpu/parallel/compile_seam.py``. There,
``compile_step`` compiles a step function for a mesh under spec trees:
``"jit"`` (GSPMD, where XLA inserts the collectives the layouts imply) or
``"shard_map"`` (a per-device body). Here each rank runs the step eagerly
on its own part of the batch, and the seam puts in the collectives by hand.
The step is a network's training objective (``loss_fn`` or ``graph_loss``:
``(params, xs, ys, rng, fmasks, lmasks) -> (loss, new_states)``), its
gradients (``torch.autograd.grad``) and the port's own updaters
(``update_layer``); the result is a :class:`CompiledStep` with the
``KStepFit._train_call`` contract, ``(xs, ys, rng, iteration, upd, fmasks,
lmasks) -> (upd', states', loss)``, so the network's single steps and its
K-step CUDA graph both run it.

- ``"jit"``, the synchronous step: every rank's objective is its own
  shard's loss (a mean over its rows, or its tokens under sequence
  parallelism), and the gradients are averaged over the batch's ranks,
  which with even shards is the gradient of the global batch's loss. Dense
  leaves (``dp``) are averaged with one ``all_reduce`` of the flattened
  gradients. A leaf whose updater state is sharded (ZeRO-1,
  ``shard_optimizer_state``) gets its gradient by ``reduce_scatter_tensor``
  and is updated on this rank's shard, the updater state living only there;
  its param is then ``all_gather``\\ ed back, unless the params are sharded
  too (FSDP, ``shard_parameters``, and ``zero3``): those keep only their
  shard between steps (the network's full tensors hold no storage), and the
  step gathers each layer's leaves when the forward first reads that layer
  (a params container handed to ``loss_fn``/``graph_loss``).
- ``"shard_map"``, the local step of local SGD and parameter averaging: the
  network's own update from this rank's batch, no gradient collective; the
  reported loss is the mean over the ranks.

What the global batch computes that a shard does not is reduced where it
is formed: batch norm's moments and their backward (``ops/batch_norm.py``
over the context's group), the MoE load-balance share ``f_e``
(``nn/conf/layers/moe.py``), gradient norms over sharded leaves (the
``sqsum`` of the updaters' normalizations), and the score. Regularization
needs nothing: every rank adds the whole term and the average of the N
equal gradients is that term's gradient once.

The spec counts and the collective bytes are the JAX package's series
(``dl4j_sharding_spec_total``, ``dl4j_collective_bytes_total``), read back
by ``partition.stats()`` and :func:`stats`; the JAX seam's compile tracker
waits for the profiler plane (A9.4).
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Callable, Dict, Optional

import torch
import torch.distributed as dist

from ..observability.metrics import LabeledSeries, global_registry
from ..observability.names import COLLECTIVE_BYTES_TOTAL
from . import partition
from .partition import PartitionSpec, sharded_dim

STRATEGIES = ("jit", "shard_map")

_collective_bytes = LabeledSeries(global_registry().counter(
    COLLECTIVE_BYTES_TOTAL,
    "bytes moved by host-dispatched collectives, by op and site"),
    "op", "site")


def count_collective(op: str, site: str, nbytes: int) -> None:
    """Add to the bytes a collective moved (``dl4j_collective_bytes_total``,
    by op and site), counted from its tensors' shapes on the host."""
    _collective_bytes(op, site).inc(int(nbytes))


def stats() -> dict:
    """``{"collective_bytes_total": {(op, site): bytes}}`` read back from
    the series, plus the partition engine's."""
    out = {"collective_bytes_total": _collective_bytes.read()}
    out.update(partition.stats())
    return out


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


@torch.no_grad()
def free_storage(t: torch.Tensor) -> None:
    """Give ``t``'s storage back, keeping its shape (a placement restores
    it with ``untyped_storage().resize_``). A numpy view of a CPU tensor
    (``.numpy()``, as a listener's host copy makes one) pins its storage
    for good; such a tensor moves to a fresh storage first."""
    st = t.untyped_storage()
    try:
        st.resize_(0)
    except RuntimeError:
        fresh = torch.UntypedStorage(st.nbytes(), device=t.device)
        t.set_(fresh, t.storage_offset(), t.shape, t.stride())
        fresh.resize_(0)


# ------------------------------------------------------------ network views
class NetView:
    """What the seam needs of a network: its layers by key in update order,
    its objective and its gradients."""

    def __init__(self, net):
        from ..nn.graph_network import ComputationGraph
        self.net = net
        self.graph = isinstance(net, ComputationGraph)
        if self.graph:
            self.keys = [n for n in net.order if n in net.vertex_layers]
            self.layers = dict(net.vertex_layers)
        else:
            self.keys = list(range(len(net.layers)))
            self.layers = dict(enumerate(net.layers))

    def params(self):
        return self.net.params_list

    def objective(self, params, xs, ys, rng, fmasks=None, lmasks=None):
        """``(loss, new_states)`` of a training forward on this rank's
        tensors."""
        net = self.net
        if self.graph:
            from ..nn.graph_network import graph_loss
            return graph_loss(net, params, net.state_list, xs, ys, rng,
                              fmasks, lmasks)
        from ..nn.multilayer import loss_fn
        return loss_fn(net, params, xs[0], ys[0], rng, fmasks, lmasks)

    def grads(self, loss, params) -> dict:
        """Gradients in each param's dtype, by layer key and param name."""
        if self.graph:
            from ..nn.graph_network import _graph_grads
            return _graph_grads(loss, params)
        from ..nn.multilayer import _grads
        from ..nn.updaters import grads_to_param_dtype
        return dict(enumerate(grads_to_param_dtype(_grads(loss, params),
                                                   params)))

    def upd_of(self, upd, key):
        return upd.get(key, {}) if self.graph else upd[key]

    def new_upd(self, by_key: dict, upd):
        if self.graph:
            return {n: by_key.get(n, upd.get(n, {})) for n in self.net.order}
        return [by_key.get(k, upd[k]) for k in self.keys]


# ----------------------------------------------------------- whole views
class WholeViews:
    """What a placement that holds blocks between steps gives the
    listeners that read whole state (``reads_whole``): :meth:`whole_view`
    makes the params and/or the updater state whole on every rank (each
    rank takes part in the collectives) while they run, then gives the
    blocks back, so the next step finds the placement and the held bytes
    as they were. A subclass says what it holds (:meth:`held_parts`) and
    assembles it (``_view_in``, returning the bytes of the whole tensors
    it assembled) and gives it back (``_view_out``). ``views`` and
    ``view_bytes`` count the views taken and those bytes. A view inside a
    view is the outer one."""

    views = 0
    view_bytes = 0
    _viewing = 0

    def held_parts(self) -> frozenset:
        """Of ``"params"`` and ``"updater"``, what this rank holds as
        blocks between steps."""
        raise NotImplementedError

    def _view_in(self, parts: frozenset) -> int:
        raise NotImplementedError

    def _view_out(self, parts: frozenset) -> None:
        raise NotImplementedError

    @contextlib.contextmanager
    def whole_view(self, parts):
        parts = frozenset(parts) & frozenset(self.held_parts())
        if not parts or self._viewing:
            yield
            return
        self._viewing += 1
        try:
            nbytes = self._view_in(parts)
            self.views += 1
            self.view_bytes += nbytes
            yield
        finally:
            try:
                self._view_out(parts)
            finally:
                self._viewing -= 1

    def view_stats(self) -> dict:
        return {"whole_views": self.views,
                "whole_view_bytes": self.view_bytes}


# --------------------------------------------------------------- ZeRO layout
class _Leaf:
    """One param's placement: the splits its updater state is cut by
    (``usplit``) and those the param itself is cut by between steps
    (``psplit``), each a tuple of ``(dim, axes)`` in dim order (a spec may
    split one dim or several), None where whole."""

    __slots__ = ("key", "name", "usplit", "psplit")

    def __init__(self, key, name, usplit, psplit):
        self.key, self.name = key, name
        self.usplit, self.psplit = usplit, psplit


def _spec_at(specs, key, name):
    """The spec of a param's leaf in a spec tree (or a single prefix
    spec)."""
    node = specs
    for k in (key, name):
        if isinstance(node, PartitionSpec):
            break
        node = node[k]
    if not isinstance(node, PartitionSpec):
        # a dict of slot specs: they share the param's shape and spec
        specs_ = [s for s in partition.tree_leaves(node)
                  if isinstance(s, PartitionSpec)]
        node = specs_[0] if specs_ else PartitionSpec()
    return node


def _splits(spec) -> Optional[tuple]:
    """``((dim, axes), ...)`` of every dim ``spec`` splits, None if none."""
    return tuple(partition.split_dims(spec)) or None


def gather_blocks(block: torch.Tensor, splits, mesh,
                  site: str) -> torch.Tensor:
    """The whole tensor from every rank's ``block`` under ``splits``: one
    all-gather over each split dim's axes, the last dim first."""
    t = block
    for d, axes in reversed(splits):
        group = mesh.group(*axes)
        if group is None:
            continue
        n = mesh.axis_size(*axes)
        parts = torch.empty((n * t.shape[0],) + tuple(t.shape[1:]),
                            dtype=t.dtype, device=t.device)
        dist.all_gather_into_tensor(parts, t.contiguous(), group=group)
        count_collective("all_gather", site, _nbytes(parts))
        t = torch.cat(parts.view((n,) + tuple(t.shape)).unbind(0), dim=d)
    return t


class Sharding(WholeViews):
    """The ZeRO placement of one network on the mesh: which leaves are
    split on which dims (a spec may split one or several, each over its
    own axes), this rank's shards (each the spec's contiguous block, in its
    leaf's layout), and the collectives that move between them and the
    whole."""

    def __init__(self, view: NetView, mesh, param_specs, upd_specs,
                 reduce_axes):
        self.view, self.mesh = view, mesh
        #: the axes that split the batch: a gradient is averaged over them
        self.reduce_axes = tuple(reduce_axes)
        self.reduce_n = mesh.axis_size(*reduce_axes)
        net_upd = view.net.updater_state
        self.leaves: Dict[tuple, _Leaf] = {}
        params = view.params()
        for key in view.keys:
            for name in params[key]:
                slots = view.upd_of(net_upd, key).get(name, {})
                usplit = (_splits(_spec_at(upd_specs, key, name)) if slots
                          else None)
                psplit = _splits(_spec_at(param_specs, key, name))
                if None not in (usplit, psplit) and usplit != psplit:
                    raise ValueError(
                        f"{key}/{name}: updater state split as {usplit}, "
                        f"the param as {psplit}; they must agree")
                for d, axes in usplit or ():
                    red = set(axes) & set(self.reduce_axes)
                    if red and red != set(axes):
                        raise ValueError(
                            f"{key}/{name}: dim {d} is split over {axes}, "
                            f"batch axes and others at once")
                self.leaves[(key, name)] = _Leaf(key, name, usplit, psplit)
        #: this rank's param shards of the params split at rest
        self.param_shards: Dict[tuple, torch.Tensor] = {}
        #: layers whose params are whole in this step
        self.gathered: set = set()

    # -- shards
    def shard(self, t: torch.Tensor, splits) -> torch.Tensor:
        """This rank's block of ``t`` under ``splits``."""
        return partition.block_of(t, splits, self.mesh)

    def gather_into(self, full: torch.Tensor, shard: torch.Tensor,
                    splits, site: str) -> None:
        """All-gather ``shard`` over ``splits``' axes into ``full``."""
        full.copy_(gather_blocks(shard, splits, self.mesh, site))

    def split_group(self, splits):
        """The process group of every axis ``splits`` cut over (a block's
        peers)."""
        return self.mesh.group(*(a for _d, axes in splits for a in axes))

    def reduce_scatter(self, g: torch.Tensor, splits) -> torch.Tensor:
        """The average of ``g`` over the batch's ranks, this rank's block
        under ``splits``: summed by ``reduce_scatter_tensor`` along each
        dim split over batch axes, cut along a dim split over other axes
        (its ranks computed the same gradient), all-reduced first over the
        batch axes no split covers."""
        mesh = self.mesh
        cut = {a for _d, axes in splits for a in axes}
        pre = tuple(a for a in self.reduce_axes if a not in cut)
        pre_group = mesh.group(*pre) if pre else None
        if pre_group is not None:
            g = g.clone()
            dist.all_reduce(g, group=pre_group)
        for d, axes in splits:
            group = mesh.group(*axes)
            n = mesh.axis_size(*axes)
            if set(axes) <= set(self.reduce_axes) and group is not None:
                gd = g.movedim(d, 0).contiguous()
                out = torch.empty((gd.shape[0] // n,) + tuple(gd.shape[1:]),
                                  dtype=gd.dtype, device=gd.device)
                dist.reduce_scatter_tensor(out, gd, group=group)
                count_collective("reduce_scatter", "zero", _nbytes(gd))
                g = out.movedim(0, d)
            else:
                g = g.chunk(n, dim=d)[mesh.index(*axes)]
        return (g / self.reduce_n).contiguous()

    # -- the network's state in and out of the placement
    @torch.no_grad()
    def scatter_updater_state(self, upd):
        """The network's whole updater state as this rank's shards (leaves
        with a ``usplit``); the rest stays as it is."""
        view = self.view
        by_key = {}
        for key in view.keys:
            own = view.upd_of(upd, key)
            by_key[key] = {
                name: ({s: self.shard(t, self.leaves[(key, name)].usplit)
                        for s, t in slots.items()}
                       if self.leaves[(key, name)].usplit is not None
                       else slots)
                for name, slots in own.items()}
        return view.new_upd(by_key, upd)

    @torch.no_grad()
    def gather_updater_state(self, upd):
        """Sharded updater state back to whole tensors on every rank."""
        view = self.view
        params = view.params()
        by_key = {}
        for key in view.keys:
            own = view.upd_of(upd, key)
            layer = {}
            for name, slots in own.items():
                leaf = self.leaves[(key, name)]
                if leaf.usplit is None:
                    layer[name] = slots
                    continue
                whole = {}
                for s, t in slots.items():
                    full = torch.empty(params[key][name].shape, dtype=t.dtype,
                                       device=t.device)
                    self.gather_into(full, t, leaf.usplit, "zero_state")
                    whole[s] = full
                layer[name] = whole
            by_key[key] = layer
        return view.new_upd(by_key, upd)

    def begin(self) -> None:
        """Before a fit: shards taken anew from the network's whole
        params (a load may have replaced them since the last fit), then
        released."""
        self.param_shards.clear()
        self.release_params()

    def end(self) -> None:
        """After a fit: every leaf whole again on every rank."""
        self.gather_all()
        self.gathered.clear()

    @torch.no_grad()
    def release_params(self) -> None:
        """Keep only this rank's shard of each leaf split at rest; the
        network's full tensor gives its storage back."""
        params = self.view.params()
        for (key, name), leaf in self.leaves.items():
            if leaf.psplit is None:
                continue
            p = params[key][name]
            if (key, name) not in self.param_shards:
                self.param_shards[(key, name)] = self.shard(p, leaf.psplit)
            free_storage(p)
        self.gathered.clear()

    @torch.no_grad()
    def gather_layer(self, key) -> None:
        """Make layer ``key``'s leaves whole from the shards (once a
        step)."""
        if key in self.gathered:
            return
        self.gathered.add(key)
        params = self.view.params()
        for name, p in params[key].items():
            leaf = self.leaves[(key, name)]
            if leaf.psplit is None:
                continue
            p.untyped_storage().resize_(p.numel() * p.element_size())
            self.gather_into(p, self.param_shards[(key, name)], leaf.psplit,
                             "fsdp")

    def gather_all(self) -> None:
        for key in self.view.keys:
            self.gather_layer(key)

    def at_use(self, params):
        """``params`` as a container that gathers a layer's leaves when the
        forward first reads it."""
        if not any(l.psplit is not None for l in self.leaves.values()):
            return params
        if isinstance(params, dict):
            return _GatherDict(params, self.gather_layer)
        return _GatherList(params, self.gather_layer)

    def checkpoint_entry(self, key, name, t: torch.Tensor, slot):
        """What a sharded checkpoint saves of a leaf (``slot`` None) or of
        an updater slot between steps: ``(key suffix, tensor)``, this
        rank's block (its dim first) of one split at rest."""
        from ..utils.sharded_checkpoint import stored_block
        leaf = self.leaves.get((key, name))
        splits = None if leaf is None else (leaf.psplit if slot is None
                                            else leaf.usplit)
        if splits is None:
            return "", t
        block = self.param_shards[(key, name)] if slot is None else t
        return stored_block(block, splits, self.mesh)

    def held_bytes(self) -> int:
        """Bytes of params this rank holds between steps."""
        params = self.view.params()
        total = 0
        for (key, name), leaf in self.leaves.items():
            p = params[key][name]
            total += (_nbytes(self.param_shards[(key, name)])
                      if leaf.psplit is not None and (key, name)
                      in self.param_shards else _nbytes(p))
        return total

    # -- the whole view between steps
    def held_parts(self) -> frozenset:
        leaves = self.leaves.values()
        return frozenset(
            (["params"] if any(l.psplit is not None for l in leaves) else [])
            + (["updater"] if any(l.usplit is not None for l in leaves)
               else []))

    def _view_in(self, parts) -> int:
        net, params = self.view.net, self.view.params()
        nbytes = 0
        if "params" in parts:
            self.gather_all()
            nbytes += sum(_nbytes(params[k][n]) for (k, n), l
                          in self.leaves.items() if l.psplit is not None)
        if "updater" in parts:
            self._held_upd = net.updater_state
            net.updater_state = self.gather_updater_state(self._held_upd)
            nbytes += sum(_nbytes(t) for k in self.view.keys
                          for n, slots in self.view.upd_of(
                              net.updater_state, k).items()
                          if self.leaves[(k, n)].usplit is not None
                          for t in slots.values())
        return nbytes

    def _view_out(self, parts) -> None:
        if "updater" in parts:
            self.view.net.updater_state = self._held_upd
            self._held_upd = None
        if "params" in parts:
            self.release_params()


class RestoredSharding(WholeViews):
    """The placement a restore onto a sharding installs
    (``utils/sharded_checkpoint.restore_sharded``): each leaf its spec
    splits (on one dim or several) is held on this rank as the spec's
    block, for the param and for each updater slot of the param's shape;
    the network's
    whole tensors of those leaves give their storage back. It answers
    :meth:`checkpoint_entry` as the fits' placements do, gives whole views
    (``output`` reads through one), and :meth:`settle` makes the network
    whole for good, which every other entry point (a fit resuming from the
    restore) does first. ``blocks`` maps ``(layer, name, slot)`` (slot None
    for the param) to ``(block, dim, axes)``."""

    restored = True

    def __init__(self, net, mesh, blocks: dict):
        self.net, self.mesh, self.blocks = net, mesh, blocks
        self._release()

    def _whole(self, layer, name, slot) -> torch.Tensor:
        net = self.net
        if slot is None:
            return net.params_list[layer][name]
        return net.updater_state[layer][name][slot]

    @torch.no_grad()
    def _release(self, slots: bool = True) -> None:
        for (layer, name, slot) in self.blocks:
            if slot is None or slots:
                free_storage(self._whole(layer, name, slot))

    @torch.no_grad()
    def _assemble(self, parts) -> int:
        """The whole tensors of ``parts`` from every rank's blocks."""
        nbytes = 0
        for (layer, name, slot), (block, splits) in self.blocks.items():
            if ("params" if slot is None else "updater") not in parts:
                continue
            full = self._whole(layer, name, slot)
            full.untyped_storage().resize_(_nbytes(full))
            full.copy_(gather_blocks(block, splits, self.mesh, "restored"))
            nbytes += _nbytes(full)
        return nbytes

    def held_parts(self) -> frozenset:
        return frozenset("params" if slot is None else "updater"
                         for (_l, _n, slot) in self.blocks)

    def _view_in(self, parts) -> int:
        return self._assemble(parts)

    @torch.no_grad()
    def _view_out(self, parts) -> None:
        for (layer, name, slot) in self.blocks:
            if ("params" if slot is None else "updater") in parts:
                free_storage(self._whole(layer, name, slot))

    def settle(self) -> None:
        """Every leaf whole on every rank, for good; the network holds no
        placement after."""
        if self._viewing:
            return
        self._assemble(self.held_parts())
        self.blocks = {}
        if getattr(self.net, "_held_sharding", None) is self:
            self.net._held_sharding = None

    def checkpoint_entry(self, key, name, t: torch.Tensor, slot):
        """``(key suffix, tensor)`` a sharded checkpoint saves of a leaf:
        this rank's block under a shard key, or the whole leaf."""
        from ..utils.sharded_checkpoint import stored_block
        held = self.blocks.get((key, name, slot))
        if held is None:
            return "", t
        return stored_block(*held, self.mesh)

    def held_bytes(self) -> int:
        """Bytes of params this rank holds."""
        total = 0
        for layer, params in (self.net.params_list.items()
                              if isinstance(self.net.params_list, dict)
                              else enumerate(self.net.params_list)):
            for name, p in params.items():
                held = self.blocks.get((layer, name, None))
                total += _nbytes(held[0] if held is not None else p)
        return total


class _GatherList(list):
    """A params list that gathers layer ``i`` on its first read."""

    def __init__(self, items, gather):
        super().__init__(items)
        self._gather = gather

    def __getitem__(self, i):
        if isinstance(i, slice):
            return [self[j] for j in range(len(self))[i]]
        self._gather(i % len(self))
        return list.__getitem__(self, i)

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]


class _GatherDict(dict):
    """A graph's params dict that gathers a vertex's leaves on first
    read."""

    def __init__(self, items, gather):
        super().__init__(items)
        self._gather = gather

    def __getitem__(self, k):
        self._gather(k)
        return dict.__getitem__(self, k)

    def get(self, k, default=None):
        return self[k] if k in self else default

    def items(self):
        return [(k, self[k]) for k in self.keys()]

    def values(self):
        return [self[k] for k in self.keys()]


# --------------------------------------------------------------- the steps
def _fold_rank(rng: Optional[int], rank: int) -> Optional[int]:
    """A step's seed made distinct for each rank (the JAX ``fold_in`` of
    the replica index), so ranks draw different dropout masks."""
    if rng is None or rank == 0:
        return rng
    return (int(rng) * 1_000_003 + rank) % (2 ** 62)


def _mean_over(t: torch.Tensor, group, n: int) -> torch.Tensor:
    if group is None:
        return t
    dist.all_reduce(t, group=group)
    return t.div_(n)


class _SyncStep:
    """The synchronous data-parallel step (``"jit"``)."""

    def __init__(self, view: NetView, mesh, reduce_axes,
                 sharding: Optional[Sharding]):
        self.view, self.mesh = view, mesh
        self.group = mesh.group(*reduce_axes)
        self.n = mesh.axis_size(*reduce_axes)
        self.sharding = sharding

    def __call__(self, xs, ys, rng, iteration, upd, fmasks=None,
                 lmasks=None):
        from ..nn.multilayer import UPDATER_LABEL, update_layer
        view, sh = self.view, self.sharding
        params = view.params()
        if sh is not None:
            params = sh.at_use(params)
        loss, new_states = view.objective(
            params, xs, ys, _fold_rank(rng, self.mesh.rank), fmasks, lmasks)
        # (the gradients' walk over the params reads every layer, so a
        # layer the loss does not reach is gathered too)
        grads = view.grads(loss, params)
        params = view.params()
        g = view.net.conf.global_conf
        with torch.no_grad(), torch.profiler.record_function(UPDATER_LABEL):
            shards = self._reduce(grads)
            new_upd = {}
            for key in view.keys:
                if not grads.get(key):
                    continue
                layer = view.layers[key]
                own = view.upd_of(upd, key)
                if sh is None:
                    new_upd[key] = update_layer(g, layer, params[key],
                                                grads[key], own, iteration)
                    continue
                pview, gview, sq = self._layer_shards(key, params[key],
                                                      grads[key], shards)
                new_upd[key] = update_layer(g, layer, pview, gview, own,
                                            iteration, sqsum=sq)
                self._finish_layer(key, params[key], pview)
        if sh is not None:
            sh.release_params()
        loss = _mean_over(loss.detach().clone(), self.group, self.n)
        return view.new_upd(new_upd, upd), new_states, loss

    def _reduce(self, grads) -> dict:
        """Average the gradients over the batch's ranks in place: the whole
        leaves by one ``all_reduce`` of their concatenation, the leaves
        with a sharded updater state by ``reduce_scatter_tensor`` (returned
        by ``(key, name)``)."""
        sh = self.sharding
        whole, shards = [], {}
        for key in self.view.keys:
            for name, gr in grads.get(key, {}).items():
                if sh is not None and sh.leaves[(key, name)].usplit is not None:
                    shards[(key, name)] = sh.reduce_scatter(
                        gr, sh.leaves[(key, name)].usplit)
                else:
                    whole.append(gr)
        if whole and self.group is not None:
            flat = torch.cat([gr.reshape(-1).to(torch.float32)
                              for gr in whole])
            dist.all_reduce(flat, group=self.group)
            flat.div_(self.n)
            at = 0
            for gr in whole:
                gr.copy_(flat[at:at + gr.numel()].view(gr.shape))
                at += gr.numel()
        return shards

    def _layer_shards(self, key, params: dict, grads: dict, shards: dict):
        """The layer's params, gradients and squared-sum rule as the update
        sees them: a sharded leaf as this rank's block (a copy, written
        back in :meth:`_finish_layer`), its squared sums reduced over the
        axis."""
        sh = self.sharding
        pview, gview, split = {}, {}, set()
        for name, p in params.items():
            leaf = sh.leaves[(key, name)]
            if leaf.usplit is None:
                pview[name], gview[name] = p, grads[name]
                continue
            pview[name] = sh.shard(p, leaf.usplit)
            gview[name] = shards[(key, name)]
            split.add(name)

        def sqsum(name, t):
            s = torch.sum(t * t)
            group = (sh.split_group(sh.leaves[(key, name)].usplit)
                     if name in split else None)
            if group is not None:
                dist.all_reduce(s, group=group)
            return s

        return pview, gview, (sqsum if split else None)

    def _finish_layer(self, key, params: dict, pview: dict) -> None:
        """Updated blocks back into the layer: gathered into the whole
        param (ZeRO-1), or kept as the shard between steps (FSDP)."""
        sh = self.sharding
        for name, p in params.items():
            leaf = sh.leaves[(key, name)]
            if leaf.usplit is not None:
                if leaf.psplit is not None:
                    sh.param_shards[(key, name)] = pview[name]
                else:
                    sh.gather_into(p, pview[name], leaf.usplit, "zero1")
            elif leaf.psplit is not None:
                sh.param_shards[(key, name)] = sh.shard(p, leaf.psplit)


class _LocalStep:
    """The local step (``"shard_map"``): this rank's own update, the loss
    averaged over the ranks."""

    def __init__(self, view: NetView, mesh, reduce_axes):
        self.view, self.mesh = view, mesh
        self.group = mesh.group(*reduce_axes)
        self.n = mesh.axis_size(*reduce_axes)

    def __call__(self, xs, ys, rng, iteration, upd, fmasks=None,
                 lmasks=None):
        from ..nn.multilayer import UPDATER_LABEL, update_layer
        view = self.view
        params = view.params()
        loss, new_states = view.objective(
            params, xs, ys, _fold_rank(rng, self.mesh.rank), fmasks, lmasks)
        grads = view.grads(loss, params)
        g = view.net.conf.global_conf
        new_upd = {}
        with torch.no_grad(), torch.profiler.record_function(UPDATER_LABEL):
            for key in view.keys:
                if grads.get(key):
                    new_upd[key] = update_layer(
                        g, view.layers[key], params[key], grads[key],
                        view.upd_of(upd, key), iteration)
        loss = _mean_over(loss.detach().clone(), self.group, self.n)
        return view.new_upd(new_upd, upd), new_states, loss


@dataclasses.dataclass
class CompiledStep:
    """A parallel train step and the layout that made it: call it as
    ``KStepFit._train_call``."""
    fn: Callable
    name: str
    rule_set: str
    strategy: str
    mesh: Any
    in_specs: Any
    out_specs: Any
    sharding: Optional[Sharding] = None

    def __call__(self, *args, **kwargs):
        return self.fn(*args, **kwargs)


def compile_step(name: str, step_fn, *, mesh, rule_set: str,
                 in_specs=None, out_specs=None, strategy: str = "jit",
                 reduce_axes=("data",), param_specs=None, upd_specs=None,
                 params=None, conf=None,
                 tp_axis: Optional[str] = None) -> CompiledStep:
    """The step of ``step_fn`` (a network: its objective, gradients and
    updaters) on ``mesh`` under the spec trees.

    ``strategy`` ``"jit"`` averages the gradients over ``reduce_axes`` (the
    axes that split the batch), ZeRO-style where ``upd_specs`` or
    ``param_specs`` shard a leaf over ``data``, and with ``tp_axis`` as the
    ``dp_tp`` placement (``tensor_parallel.py``) of the leaves
    ``param_specs`` split over that axis; ``"shard_map"`` updates each
    rank on its own and averages only the reported loss. ``params`` with
    ``param_specs`` record the per-rank param bytes for the rule set, and
    every spec tree is counted (``partition.stats()``)."""
    if strategy not in STRATEGIES:
        raise ValueError(f"unknown compile strategy {strategy!r}; "
                         f"expected 'jit' or 'shard_map'")
    view = step_fn if isinstance(step_fn, NetView) else NetView(step_fn)
    sharding = None
    if strategy == "jit" and tp_axis is not None:
        from .tensor_parallel import TPPlacement, TPStep
        fn = TPStep(view, mesh, tuple(reduce_axes),
                    TPPlacement(view, mesh, tp_axis, param_specs))
        sharding = fn.sharding
    elif strategy == "jit":
        if _any_split(param_specs) or _any_split(upd_specs):
            sharding = Sharding(view, mesh, param_specs
                                if param_specs is not None
                                else PartitionSpec(), upd_specs
                                if upd_specs is not None
                                else PartitionSpec(), tuple(reduce_axes))
        fn = _SyncStep(view, mesh, tuple(reduce_axes), sharding)
    else:
        fn = _LocalStep(view, mesh, tuple(reduce_axes))
    partition.record_specs(rule_set, in_specs, out_specs, param_specs,
                           upd_specs)
    if params is not None and param_specs is not None:
        partition.record_param_bytes(rule_set, params, param_specs, mesh)
    return CompiledStep(fn=fn, name=name, rule_set=rule_set,
                        strategy=strategy, mesh=mesh, in_specs=in_specs,
                        out_specs=out_specs, sharding=sharding)


def _any_split(specs) -> bool:
    if specs is None:
        return False
    if isinstance(specs, PartitionSpec):
        return sharded_dim(specs) is not None
    return any(isinstance(s, PartitionSpec) and sharded_dim(s) is not None
               for s in partition.tree_leaves(specs))


def average_tree(tree, group, n: int, site: str) -> None:
    """Every floating leaf of ``tree`` replaced in place by its mean over
    the group, with one ``all_reduce`` of their concatenation in float32
    (a bf16 leaf averages in float32, as the JAX averager widens it)."""
    if group is None:
        return
    leaves = [t for t in partition.tree_leaves(tree)
              if isinstance(t, torch.Tensor) and t.is_floating_point()]
    if not leaves:
        return
    with torch.no_grad():
        flat = torch.cat([t.reshape(-1).to(torch.float32) for t in leaves])
        dist.all_reduce(flat, group=group)
        count_collective("all_reduce", site, _nbytes(flat))
        flat.div_(n)
        at = 0
        for t in leaves:
            t.copy_(flat[at:at + t.numel()].view(t.shape))
            at += t.numel()


def broadcast_tree(tree, group, src: int) -> None:
    """Every tensor leaf of ``tree`` replaced in place by global rank
    ``src``'s."""
    if group is None:
        return
    with torch.no_grad():
        for t in partition.tree_leaves(tree):
            if isinstance(t, torch.Tensor):
                dist.broadcast(t, src, group=group)
