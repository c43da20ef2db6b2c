"""``ComputationGraph``: a DAG of vertices, run forward and trained.

Counterpart of ``deeplearning4j_tpu/nn/graph_network.py``: ``MultiDataSet``,
the pure functions (``graph_forward``, ``graph_forward_streaming``,
``graph_loss``, ``_aux_losses``, ``_apply_graph_updates``,
``make_graph_train_step``, ``make_graph_tbptt_step``,
``eval_forward_to_vertex``, ``make_graph_pretrain_step``) and the stateful
shell (``init``, ``output`` as
a list, ``score``, ``fit`` on a ``DataSet``, a ``MultiDataSet``, input and
label lists or an iterable, ``fit_iterator`` with the K-step dispatch of
``nn/ksteps.py``, truncated BPTT, ``evaluate``, the flat
``params``/``set_params``/``num_params`` view, ``score_examples``,
``gradient_and_score``, layerwise pretraining (``pretrain``,
``pretrain_layer``, and ``fit_iterator`` of a config with ``pretrain``
set), the recurrent API ``rnn_time_step`` and the previous-state
accessors, ``clone``).

The forward walks the vertices in the configuration's topological order.
Masks are routed per input stream: a vertex takes the first mask among its
inputs'. A layer vertex runs its layer module's ``apply_with_state``; a
training forward returns the new layer states and the step writes them
after the update. The train loss is the sum of the output layers' losses
on their inputs (the output layers' own forward is not needed for it), plus
the vertices' auxiliary losses (a MoE vertex's load-balance term, in the
standard and the TBPTT step alike) and regularization. As in ``MultiLayerNetwork``, the step is eager:
``torch.autograd.grad`` gives the gradients and the updater subtracts each
step from its parameter in place, vertex by vertex in topological order,
inside a ``torch.profiler.record_function`` range (``UPDATER_LABEL``) that
names its kernels in a profile.

The params, states and updater state are dicts by vertex name (``{}`` for
a vertex without params), as in the JAX package; the flat view follows the
JAX pytree order: vertex names sorted, then param names sorted.

Truncated BPTT cuts every input, label and mask along the time axis (1)
into ``tbptt_fwd_length`` chunks, one update a chunk; each streaming LSTM
vertex carries its ``h``/``c`` across the chunks of a batch, detached at
each boundary (the truncation), from zeros for every batch.

The config's ``dtype`` names the policy the train step, TBPTT, streaming
and ``output``/``score``/``evaluate`` run under, as for
``MultiLayerNetwork``.

A non-SGD ``optimization_algo`` trains through the ``Solver``
(``optimize/solvers.py``).

Diagnostics as in ``MultiLayerNetwork``: the health variant of the step at
the monitor's due iterations (``make_graph_train_step(net, health=True)``),
a flight-recorder ``step`` event and a watchdog beat every step and chunk,
one bundle on an exception escaping ``fit`` or ``fit_iterator``, and the
fit phases' seconds.
"""
from __future__ import annotations

import copy
import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..common import resolve_device, under_conf_policy, wrap_with_policy
from ..observability.flight_recorder import dump_on_unhandled
from ..observability.health import health_terms
from . import param_blocks
from .conf.graphconf import ComputationGraphConfiguration
from .conf.layers.recurrent import streaming_lstm
from .conf.serde import layer_class
from .conf.vertices import LayerVertex
from .ksteps import KStepFit, t_staging
from .multilayer import (
    _SEED_RANGE, UPDATER_LABEL, _dropout_gen, _layer_seeds, _numpy, _rewound,
    _updater_spec, load_states, pretrain_update, update_layer, write_states)
from .updaters import updater_init


@dataclasses.dataclass
class MultiDataSet:
    """Several inputs and several outputs: lists of arrays, one per network
    input and per network output, with optional mask lists."""

    features: list
    labels: list
    features_masks: Optional[list] = None
    labels_masks: Optional[list] = None

    def num_examples(self) -> int:
        return int(self.features[0].shape[0])


def _coerce_graph_batch(ds):
    """A ``DataSet`` or ``MultiDataSet`` as ``(xs, ys, fmasks, lmasks)``
    lists."""
    if isinstance(ds, MultiDataSet):
        return ds.features, ds.labels, ds.features_masks, ds.labels_masks
    fm = [ds.features_mask] if ds.features_mask is not None else None
    lm = [ds.labels_mask] if ds.labels_mask is not None else None
    return [ds.features], [ds.labels], fm, lm


def _graph_regularization(net, params) -> torch.Tensor:
    """``l1 * |W|_1 + 0.5 * l2 * ||W||^2`` over the layer vertices'
    regularizable params, only when the config sets
    ``use_regularization``."""
    total = torch.zeros((), dtype=torch.float32, device=net.device)
    if not net.conf.global_conf.use_regularization:
        return total
    for name, layer in net.vertex_layers.items():
        for pname in layer.regularizable_params():
            if pname not in params.get(name, {}):
                continue
            own = params[name]
            w = own[pname]
            # a dp_tp block's terms are summed over its model group
            if layer.l1:
                total = total + layer.l1 * param_blocks.whole_sum(own, pname, w.abs())
            if layer.l2:
                total = total + 0.5 * layer.l2 * param_blocks.whole_sum(own, pname, w * w)
    return total


def graph_forward(net, params: dict, states: dict, inputs: list, *,
                  train: bool, rng: Optional[int] = None,
                  masks: Optional[list] = None,
                  collect_loss_inputs: bool = False):
    """Walk the DAG in topological order. Returns ``(acts, new_states,
    loss_inputs)``: every vertex's activation by name, every vertex's new
    state, and, with ``collect_loss_inputs``, each loss-bearing output
    layer's input (its loss is computed on it; such a layer's own forward
    runs only when another vertex reads its output).

    With ``gradient_checkpointing`` set, a training forward runs each layer
    vertex under ``torch.utils.checkpoint``; the state comes out of the
    first forward only."""
    return _walk(net, params, states, inputs, train, rng, masks,
                 collect_loss_inputs)[:3]


def graph_forward_streaming(net, params: dict, states: dict,
                            rnn_states: dict, inputs: list, *, train: bool,
                            rng: Optional[int] = None,
                            masks: Optional[list] = None,
                            collect_loss_inputs: bool = False,
                            truncate: bool = False):
    """:func:`graph_forward` threading the streaming LSTM vertices' state:
    each runs ``apply_streaming`` from its ``rnn_states`` entry (with the
    vertex's mask) and hands on its final ``{"h", "c"}``, detached with
    ``truncate`` (the TBPTT boundary). Returns ``(acts, new_states,
    loss_inputs, new_rnn_states)``."""
    return _walk(net, params, states, inputs, train, rng, masks,
                 collect_loss_inputs, rnn_states, truncate)


def _walk(net, params, states, inputs, train, rng, masks,
          collect_loss_inputs, rnn_states=None, truncate=False):
    conf = net.conf
    acts: Dict[str, torch.Tensor] = dict(zip(conf.network_inputs, inputs))
    mask_of: Dict[str, Optional[torch.Tensor]] = dict.fromkeys(
        conf.network_inputs)
    for i, name in enumerate(conf.network_inputs[:len(masks or [])]):
        mask_of[name] = masks[i]
    new_states: Dict[str, dict] = {}
    new_rnn: Dict[str, dict] = {}
    loss_inputs: Dict[str, torch.Tensor] = {}
    order = net.order
    seeds = _layer_seeds(len(order), rng)
    remat = train and conf.global_conf.gradient_checkpointing
    for i, name in enumerate(order):
        vertex = conf.vertices[name]
        srcs = conf.vertex_inputs[name]
        vins = [acts[src] for src in srcs]
        mask = next((mask_of[s] for s in srcs if mask_of.get(s) is not None),
                    None)
        mask_of[name] = mask
        state = states.get(name, {})
        layer = net.vertex_layers.get(name)
        if collect_loss_inputs and name in net.loss_outputs:
            loss_inputs[name] = vins[0]
            new_states[name] = state
            if name not in net.consumed:
                continue
        if layer is None:
            acts[name], new_states[name] = vertex.apply(vins, mask), state
            continue
        if rnn_states is not None and streaming_lstm(layer):
            acts[name], rs = layer.apply_streaming(
                params.get(name, {}), rnn_states.get(name, {}), vins[0],
                mask=mask)
            new_rnn[name] = ({k: v.detach() for k, v in rs.items()}
                             if truncate else rs)
            new_states[name] = state
            continue
        if remat:
            def f(p, s, h, _layer=layer, _mask=mask, _gen_seed=seeds[i]):
                return _layer.apply_with_state(
                    p, s, h, _mask, True,
                    _dropout_gen(_layer, _gen_seed, h.device))
            y, ns = checkpoint(f, params.get(name, {}), state, vins[0],
                               use_reentrant=False, preserve_rng_state=False)
        else:
            y, ns = layer.apply_with_state(
                params.get(name, {}), state, vins[0], mask, train,
                _dropout_gen(layer, seeds[i], vins[0].device))
        acts[name] = y
        new_states[name] = ns
    if rnn_states is not None:
        new_rnn = {n: new_rnn.get(n, rnn_states.get(n, {})) for n in order}
    return acts, new_states, loss_inputs, new_rnn


def _output_losses(net, params, loss_inputs, labels, lmasks=None):
    """The sum of the output layers' losses."""
    total = torch.zeros((), dtype=torch.float32, device=net.device)
    for i, out_name in enumerate(net.conf.network_outputs):
        if out_name not in net.loss_outputs:
            raise ValueError(f"Output vertex '{out_name}' has no loss function")
        lmask = lmasks[i] if lmasks and i < len(lmasks) else None
        total = total + net.vertex_layers[out_name].compute_loss(
            params[out_name], loss_inputs[out_name], labels[i], lmask)
    return total


def _aux_losses(net, new_states):
    """The vertices' auxiliary objectives: a layer vertex publishes one as
    an ``"aux_loss"`` scalar in its state (the MoE load-balance term),
    weighted by its layer's ``aux_loss_weight``."""
    total = 0.0
    for name, ns in new_states.items():
        if isinstance(ns, dict) and "aux_loss" in ns:
            layer = net.vertex_layers.get(name)
            total = total + getattr(layer, "aux_loss_weight", 1.0) * \
                ns["aux_loss"]
    return total


def graph_loss(net, params, states, inputs, labels, rng=None, fmasks=None,
               lmasks=None):
    """Training loss: the output layers' losses of a train-mode forward,
    plus the auxiliary losses and regularization. Returns ``(loss,
    new_states)``."""
    _, new_states, loss_inputs = graph_forward(
        net, params, states, inputs, train=True, rng=rng, masks=fmasks,
        collect_loss_inputs=True)
    total = _output_losses(net, params, loss_inputs, labels, lmasks)
    total = total + _aux_losses(net, new_states)
    return total + _graph_regularization(net, params), new_states


def _graph_grads(loss, params) -> Dict[str, dict]:
    """``d loss / d param`` by vertex and param name (zeros for a param the
    loss does not reach), in each param's dtype."""
    keys = [(n, k) for n, p in params.items() for k in p]
    flat = [params[n][k] for n, k in keys]
    got = torch.autograd.grad(loss, flat, allow_unused=True)
    grads: Dict[str, dict] = {n: {} for n in params}
    for (n, k), p, g in zip(keys, flat, got):
        grads[n][k] = torch.zeros_like(p) if g is None else g.to(p.dtype)
    return grads


def _apply_graph_updates(net, params, loss, upd_state, iteration,
                         health: bool = False):
    """Gradients of ``loss``, then each layer vertex's update (gradient
    normalization, learning-rate policy, bias rate, updater) in topological
    order, in place. Returns the new updater state; with ``health``, also
    the packed health summary."""
    g = net.conf.global_conf
    grads = _graph_grads(loss, params)
    new_upd = {}
    # the label names the updater's kernels in a profile
    with torch.no_grad(), torch.profiler.record_function(UPDATER_LABEL):
        before = net._snapshot_params(params) if health else None
        for name in net.order:
            layer = net.vertex_layers.get(name)
            if layer is None or not grads.get(name):
                new_upd[name] = upd_state.get(name, {})
                continue
            new_upd[name] = update_layer(g, layer, params[name], grads[name],
                                         upd_state[name], iteration)
        if health:
            return new_upd, health_terms(grads, before, params, loss)
    return new_upd


def _init_graph_rnn_states(net, batch: int) -> dict:
    """Zero ``{"h", "c"}`` for each streaming LSTM vertex, ``{}`` for the
    others."""
    states = {}
    for name in net.order:
        layer = net.vertex_layers.get(name)
        if layer is not None and streaming_lstm(layer):
            z = torch.zeros(batch, layer.n_out, dtype=torch.float32,
                            device=net.device)
            states[name] = {"h": z, "c": z.clone()}
        else:
            states[name] = {}
    return states


def make_graph_tbptt_step(net):
    """The truncated-BPTT step over one chunk as a plain function:
    ``(params, states, upd_state, rnn_states, inputs, labels, rng,
    iteration, fmasks, lmasks) -> (states', upd_state', rnn_states',
    loss)``: the streaming forward from the carried LSTM state (detached at
    the chunk's end), the output layers' losses plus the auxiliary losses
    and regularization, and
    the update of every layer vertex, biases at their own rate, as the
    graph's ordinary step."""

    def tbptt_step(params, states, upd_state, rnn_states, inputs, labels,
                   rng, iteration, fmasks=None, lmasks=None):
        _, new_states, loss_inputs, new_rnn = graph_forward_streaming(
            net, params, states, rnn_states, inputs, train=True, rng=rng,
            masks=fmasks, collect_loss_inputs=True, truncate=True)
        loss = _output_losses(net, params, loss_inputs, labels, lmasks)
        loss = loss + _aux_losses(net, new_states)
        loss = loss + _graph_regularization(net, params)
        new_upd = _apply_graph_updates(net, params, loss, upd_state, iteration)
        return new_states, new_upd, new_rnn, loss.detach()

    return tbptt_step


def make_graph_train_step(net, health: bool = False):
    """The train step as a plain function: ``(params, states, upd_state,
    inputs, labels, rng, iteration, fmasks, lmasks) -> (states', upd_state',
    loss)``, and with ``health`` the packed health summary after the loss;
    the params are updated in place, the new states returned."""

    def train_step(params, states, upd_state, inputs, labels, rng, iteration,
                   fmasks=None, lmasks=None):
        loss, new_states = graph_loss(net, params, states, inputs, labels, rng,
                                      fmasks, lmasks)
        if health:
            new_upd, packed = _apply_graph_updates(
                net, params, loss, upd_state, iteration, health=True)
            return new_states, new_upd, loss.detach(), packed
        new_upd = _apply_graph_updates(net, params, loss, upd_state, iteration)
        return new_states, new_upd, loss.detach()

    return train_step


def _ancestors(conf, name: str) -> set:
    """``name``'s ancestor vertices and network inputs."""
    anc, stack = set(), list(conf.vertex_inputs.get(name, []))
    while stack:
        n = stack.pop()
        if n not in anc:
            anc.add(n)
            stack.extend(conf.vertex_inputs.get(n, []))
    return anc


def eval_forward_to_vertex(net, params, states, inputs, name: str):
    """The eval-mode forward of ``name``'s ancestors only: returns the
    vertex's (first) input. The one walk of the graph pretraining step and
    the graph pretraining gradient check."""
    conf = net.conf
    anc = _ancestors(conf, name)
    acts = dict(zip(conf.network_inputs, inputs))
    for n in net.order:
        if n not in anc or n in acts:
            continue
        vins = [acts[s] for s in conf.vertex_inputs[n]]
        layer = net.vertex_layers.get(n)
        if layer is None:
            acts[n] = conf.vertices[n].apply(vins, None)
        else:
            acts[n] = layer.apply_with_state(params.get(n, {}),
                                             states.get(n, {}), vins[0])[0]
    return acts[conf.vertex_inputs[name][0]]


def make_graph_pretrain_step(net, name: str):
    """The unsupervised pretraining step of vertex ``name`` as a plain
    function: ``(params, states, vertex_upd, inputs, rng, iteration,
    noise=None) -> (vertex_upd', loss)``. The vertex's ancestors run their
    eval forward without gradient; only the vertex's params move, in place,
    through its own updater state."""
    layer = net.vertex_layers[name]
    g = net.conf.global_conf

    def pretrain_step(params, states, vertex_upd, inputs, rng, iteration,
                      noise=None):
        with torch.no_grad():
            h = eval_forward_to_vertex(net, params, states, inputs, name)
        return pretrain_update(g, layer, params[name], vertex_upd, h, rng,
                               iteration, noise)

    return wrap_with_policy(pretrain_step, g.dtype)


class ComputationGraph(KStepFit, nn.Module):
    """The vertices of ``conf`` on ``device`` (``None`` means CUDA)."""

    _prefetch_path = "graph"

    def __init__(self, conf: ComputationGraphConfiguration, device=None):
        super().__init__()
        self.conf = conf
        self.device = resolve_device(device)
        if not conf.topological_order:
            conf.topological_order = conf.topo_sort()
        self.order: List[str] = list(conf.topological_order)
        #: the layer module of each layer vertex, by vertex name
        self.vertex_layers: Dict[str, nn.Module] = {
            name: layer_class(v.layer.type)(v.layer, self.device)
            for name in self.order
            for v in [conf.vertices[name]] if isinstance(v, LayerVertex)}
        self._modules_in_order = nn.ModuleList(self.vertex_layers.values())
        #: output vertices whose loss the training forward computes, and the
        #: vertices another vertex reads
        self.loss_outputs = {n for n in conf.network_outputs
                             if n in self.vertex_layers
                             and self.vertex_layers[n].has_loss()}
        self.consumed = {s for ins in conf.vertex_inputs.values() for s in ins}
        self._initialized = False
        self.updater_state: Optional[dict] = None
        self.iteration = 0
        self.epoch = 0
        self.listeners: list = []
        self.last_batch_size = 0
        self._score = float("nan")
        self._rng = torch.Generator(device="cpu")
        #: the train step, by the health flag (made at first use)
        self._train_steps: dict = {}
        self._tbptt_step = None
        #: the pretraining steps by vertex name (made at first use)
        self._pretrain_steps: dict = {}
        #: the Solver of a non-SGD ``optimization_algo`` (made at first use)
        self._solver = None
        #: the captured train steps of the K-step dispatch, by batch shapes
        self._step_graphs: dict = {}
        #: streaming state of ``rnn_time_step`` by vertex (None until it runs)
        self._rnn_state: Optional[dict] = None

    # ------------------------------------------------------------------ lifecycle
    def init(self, seed: Optional[int] = None) -> "ComputationGraph":
        """Draw every parameter, vertex by vertex in topological order, from
        one CPU ``torch.Generator`` seeded with ``seed`` (default: the
        config's), reset the layer states and zero the updater state. The
        JAX package's RNG differs: weights cross through
        ``convert.from_jax`` only."""
        seed = self.conf.global_conf.seed if seed is None else seed
        gen = torch.Generator(device="cpu").manual_seed(seed)
        for layer in self.vertex_layers.values():
            layer.init_params(gen)
            layer.reset_state()
        self._rng.manual_seed((int(seed) * 0x9E3779B1 + 0xC6) % _SEED_RANGE)
        self._init_updater_state()
        self._drop_step_graphs()
        self._initialized = True
        return self

    def _init_updater_state(self) -> None:
        self.updater_state = {
            name: ({pname: updater_init(_updater_spec(layer), p)
                    for pname, p in layer.params().items()}
                   if layer is not None else {})
            for name in self.order
            for layer in [self.vertex_layers.get(name)]}

    def _check_names(self, given: dict, what: str) -> None:
        if set(given) - set(self.order):
            raise ValueError(f"{what} for unknown vertices "
                             f"{sorted(set(given) - set(self.order))}")

    @torch.no_grad()
    def load_params(self, params: dict,
                    states: Optional[dict] = None) -> "ComputationGraph":
        """Copy params given by vertex name and JAX param name (numpy arrays
        or tensors), and with ``states`` the layers' running states the same
        way; names and shapes must match exactly. The updater state is
        zeroed unless one was loaded already."""
        self._check_names(params, "params")
        self._drop_step_graphs()
        for name in self.order:
            layer = self.vertex_layers.get(name)
            own = {} if layer is None else layer.params()
            given = params.get(name, {})
            if set(given) != set(own):
                raise ValueError(f"vertex {name!r} params {sorted(given)} != "
                                 f"expected {sorted(own)}")
            for k, value in given.items():
                t = torch.as_tensor(np.array(value, dtype=np.float32))
                if tuple(t.shape) != tuple(own[k].shape):
                    raise ValueError(f"vertex {name!r} param {k}: shape "
                                     f"{tuple(t.shape)} != "
                                     f"{tuple(own[k].shape)}")
                own[k].copy_(t)
        if states is not None:
            self.load_state(states)
        if self.updater_state is None:
            self._init_updater_state()
        self._initialized = True
        return self

    def load_state(self, states: dict) -> "ComputationGraph":
        """Copy the layer vertices' running states (as the JAX
        ``net.state_list`` holds them, by vertex name)."""
        self._check_names(states, "states")
        names = list(self.vertex_layers)
        load_states(list(self.vertex_layers.values()),
                    [states.get(n, {}) for n in names], names)
        self._drop_step_graphs()
        return self

    @torch.no_grad()
    def load_updater_state(self, state: dict,
                           iteration: int = 0) -> "ComputationGraph":
        """Set the updater state (by vertex, param and state name, as the
        JAX ``net.updater_state``) and the iteration."""
        if self.updater_state is None:
            self._init_updater_state()
        self._check_names(state, "updater state")
        new = {}
        for name, own in self.updater_state.items():
            given = state.get(name, {})
            if set(own) != set(given):
                raise ValueError(f"vertex {name!r} updater state params "
                                 f"{sorted(given)} != {sorted(own)}")
            new[name] = {}
            for pname, slots in own.items():
                if set(slots) != set(given[pname]):
                    raise ValueError(
                        f"vertex {name!r} param {pname}: updater state "
                        f"{sorted(given[pname])} != {sorted(slots)}")
                new[name][pname] = {
                    k: torch.as_tensor(np.array(given[pname][k],
                                                dtype=np.float32)
                                       ).to(self.device) for k in slots}
        self.updater_state = new
        self.iteration = int(iteration)
        self._drop_step_graphs()
        return self

    def _require_init(self) -> None:
        if not self._initialized:
            raise RuntimeError("network is not initialized: call init() or "
                               "load_params() first")
        param_blocks.settle(self)

    def set_listeners(self, *listeners) -> None:
        self.listeners = list(listeners)

    def add_listener(self, listener) -> None:
        self.listeners.append(listener)

    # ------------------------------------------------------------------ params API
    @property
    def params_list(self) -> Dict[str, dict]:
        """Each vertex's params by JAX name (``{}`` for a vertex without
        params), in topological order."""
        return {n: (self.vertex_layers[n].params() if n in self.vertex_layers
                    else {}) for n in self.order}

    @property
    def state_list(self) -> Dict[str, dict]:
        """Each vertex's running state by JAX name (its layer's buffers)."""
        return {n: (self.vertex_layers[n].state() if n in self.vertex_layers
                    else {}) for n in self.order}

    def _flat_order(self) -> list:
        """The params in the JAX pytree order: vertex names sorted, then
        param names sorted."""
        pl = self.params_list
        return [pl[n][k] for n in sorted(pl) for k in sorted(pl[n])]

    def params(self) -> torch.Tensor:
        """All parameters as one flat vector, the JAX ``params()`` order."""
        leaves = self._flat_order()
        if not leaves:
            return torch.zeros(0, device=self.device)
        return torch.cat([t.detach().reshape(-1) for t in leaves])

    @torch.no_grad()
    def set_params(self, flat) -> None:
        """Copy a flat vector (as :meth:`params` gives it) into the params."""
        flat = self._to_device(flat).reshape(-1)
        if flat.numel() != self.num_params():
            raise ValueError(f"{flat.numel()} values for {self.num_params()} "
                             "params")
        self._drop_step_graphs()
        at = 0
        for t in self._flat_order():
            t.copy_(flat[at:at + t.numel()].reshape(t.shape))
            at += t.numel()

    def num_params(self) -> int:
        return sum(t.numel() for t in self._flat_order())

    # ------------------------------------------------------------------ inference
    def _to_device(self, a) -> Optional[torch.Tensor]:
        """A tensor on this network's device; float64 host data becomes
        float32, as JAX makes it by default."""
        if a is None:
            return None
        if not isinstance(a, torch.Tensor):
            a = torch.from_numpy(np.array(a))
            if a.dtype == torch.float64:
                a = a.to(torch.float32)
        return a.to(self.device)

    def _to_devices(self, arrays) -> Optional[list]:
        if arrays is None:
            return None
        return [self._to_device(a) for a in arrays]

    def _output_pure(self, params, states, xs: list,
                     masks: Optional[list] = None) -> list:
        """The eval-mode forward: the network outputs, in order."""
        acts, _, _ = graph_forward(self, params, states, xs, train=False,
                                   masks=masks)
        return [acts[o] for o in self.conf.network_outputs]

    @under_conf_policy
    @torch.no_grad()
    def output(self, *inputs) -> List[torch.Tensor]:
        """The network outputs (a list, one per output vertex) for one array
        per network input, on this network's device. A network holding
        blocks of its params gathers them whole for the call, on every
        rank."""
        with param_blocks.held_view(self):
            self._require_init()
            return self._output_pure(self.params_list, self.state_list,
                                     self._to_devices(inputs))

    @under_conf_policy
    @torch.no_grad()
    def score(self, data) -> float:
        """Loss (with regularization) on a ``MultiDataSet`` or
        ``DataSet``: the eval-mode forward (running batch-norm statistics,
        no dropout), masks not applied, as in the JAX package."""
        self._require_init()
        xs, ys, _, _ = _coerce_graph_batch(data)
        params = self.params_list
        _, _, loss_inputs = graph_forward(
            self, params, self.state_list, self._to_devices(xs), train=False,
            collect_loss_inputs=True)
        total = _output_losses(self, params, loss_inputs, self._to_devices(ys))
        return float(total + _graph_regularization(self, params))

    @under_conf_policy
    @torch.no_grad()
    def score_examples(self, data, add_regularization: bool = False
                       ) -> np.ndarray:
        """Each example's loss, summed over the outputs, unreduced (``[B]``
        numpy): the loss of the one-example batch. Feature masks route
        through the forward, label masks weight each example's own loss."""
        self._require_init()
        xs, ys, fms, lms = _coerce_graph_batch(data)
        params = self.params_list
        _, _, loss_inputs = graph_forward(
            self, params, self.state_list, self._to_devices(xs), train=False,
            masks=self._to_devices(fms), collect_loss_inputs=True)
        ys, lms = self._to_devices(ys), self._to_devices(lms)
        total = None
        for i, out_name in enumerate(self.conf.network_outputs):
            if out_name not in self.loss_outputs:
                raise ValueError(
                    f"Output vertex '{out_name}' has no loss function")
            layer, h = self.vertex_layers[out_name], loss_inputs[out_name]
            lm = lms[i] if lms and i < len(lms) else None
            per = torch.stack([
                layer.compute_loss(params[out_name], h[j:j + 1], ys[i][j:j + 1],
                                   None if lm is None else lm[j:j + 1])
                for j in range(h.shape[0])])
            total = per if total is None else total + per
        if add_regularization:
            total = total + _graph_regularization(self, params)
        return total.cpu().numpy()

    @under_conf_policy
    def gradient_and_score(self, xs, ys):
        """``(grads, score)`` without an update: the training loss's
        gradients by vertex and param name, without dropout (batch norm
        normalizes with the batch's statistics; its state is not
        written)."""
        self._require_init()
        params = self.params_list
        loss, _ = graph_loss(self, params, self.state_list,
                             self._to_devices(list(xs)),
                             self._to_devices(list(ys)))
        return _graph_grads(loss, params), float(loss.detach())

    # ------------------------------------------------------------------ evaluation
    @under_conf_policy
    def evaluate(self, iterator, labels_list=None, top_n: int = 1):
        """Classification scores of the outputs over an iterable of
        ``DataSet``\\ s or ``MultiDataSet``\\ s, label masks per output
        stream; outputs whose class count differs from the first label
        array's are left out, as in the JAX package."""
        from ..eval.evaluation import Evaluation

        ev = Evaluation(labels=labels_list, top_n=top_n)
        for ds in _rewound(iterator):
            feats, labels, fmasks, lmasks = _coerce_graph_batch(ds)
            with torch.no_grad():
                outs = self._output_pure(self.params_list, self.state_list,
                                         self._to_devices(feats),
                                         self._to_devices(fmasks))
            n_cls = np.asarray(_numpy(labels[0])).shape[-1]
            for i, out in enumerate(outs[:len(labels)]):
                lab = _numpy(labels[i])
                if lab.shape[-1] != n_cls:
                    continue
                lm = (_numpy(lmasks[i]) if lmasks and i < len(lmasks)
                      and lmasks[i] is not None else None)
                ev.eval(lab, _numpy(out), mask=lm)
        return ev

    # ------------------------------------------------------------------ training
    @property
    def score_value(self) -> float:
        """The last step's loss; read from the device only when asked for."""
        if isinstance(self._score, torch.Tensor):
            self._score = float(self._score)
        return self._score

    @score_value.setter
    def score_value(self, value) -> None:
        self._score = value

    def _next_rng(self) -> int:
        return int(torch.randint(0, _SEED_RANGE, (1,), generator=self._rng))

    def _uses_tbptt(self) -> bool:
        """Truncated BPTT applies to graphs with a streaming LSTM vertex;
        any other graph flagged ``TruncatedBPTT`` trains with the standard
        step, as in the JAX package."""
        return (self.conf.backprop_type == "TruncatedBPTT"
                and any(streaming_lstm(l) for l in self.vertex_layers.values()))

    @dump_on_unhandled("ComputationGraph.fit")
    def fit(self, data, labels=None, *, epochs: int = 1) -> None:
        """Fit on a ``MultiDataSet`` or ``DataSet``, on lists of inputs and
        labels (or one array each), or on an iterable of batches. ``epochs``
        repeats of one unmasked batch run in groups of ``dispatch_ksteps``
        steps (``_fit_repeated``) on an eligible graph, as single steps
        otherwise."""
        from ..datasets.dataset import DataSet

        if isinstance(data, (MultiDataSet, DataSet)):
            xs, ys, fm, lm = _coerce_graph_batch(data)
        elif labels is not None:
            xs = list(data) if isinstance(data, (list, tuple)) else [data]
            ys = list(labels) if isinstance(labels, (list, tuple)) else [labels]
            fm = lm = None
        else:
            self.fit_iterator(data, epochs=epochs)
            return
        if (epochs > 1 and fm is None and lm is None
                and self._multistep_ok(self.dispatch_ksteps)):
            self._fit_repeated(xs, ys, epochs)
            return
        for _ in range(epochs):
            self._fit_batch(xs, ys, fm, lm)

    @dump_on_unhandled("ComputationGraph.fit_iterator")
    def fit_iterator(self, iterator, epochs: int = 1,
                     ksteps: Optional[int] = None) -> None:
        KStepFit.fit_iterator(self, iterator, epochs, ksteps)

    fit_iterator.__doc__ = KStepFit.fit_iterator.__doc__

    # the hooks of the K-step shell (KStepFit)
    def _layer_modules(self) -> list:
        return list(self.vertex_layers.values())

    def _group_arrays(self, ds):
        xs, ys, fm, lm = _coerce_graph_batch(ds)
        if fm is not None or lm is not None:
            return None
        return [_numpy(x) for x in xs], [_numpy(y) for y in ys]

    def _fit_dataset(self, ds) -> None:
        self._fit_batch(*_coerce_graph_batch(ds))

    def _fit_arrays(self, xs: list, ys: list) -> None:
        self._fit_batch(xs, ys)

    @under_conf_policy
    def _train_call(self, xs: list, ys: list, rng, iteration, upd,
                    fmasks=None, lmasks=None, health: bool = False):
        """The train step on device tensors: ``(upd', states', loss)``, and
        the packed health summary after them with ``health``."""
        step = self._train_steps.get(health)
        if step is None:
            step = self._train_steps[health] = make_graph_train_step(
                self, health)
        out = step(self.params_list, self.state_list, upd, xs, ys, rng,
                   iteration, fmasks, lmasks)
        return (out[1], out[0]) + tuple(out[2:])

    def _write_states(self, new_states: dict) -> None:
        write_states(self.vertex_layers.values(),
                     [new_states[n] for n in self.vertex_layers])

    def _uses_sgd(self) -> bool:
        return self.conf.global_conf.optimization_algo in (
            None, "stochastic_gradient_descent")

    def _fit_batch(self, xs, ys, fmasks=None, lmasks=None) -> None:
        self._require_init()
        if not self._uses_sgd():
            # the Solver algorithms, as in MultiLayerNetwork._fit_batch
            from ..optimize.solvers import Solver

            if self._solver is None:
                self._solver = Solver(self)
            self._solver.optimize(list(xs), list(ys))
            return
        if self._uses_tbptt():
            self._fit_tbptt(xs, ys, fmasks, lmasks)
            return
        with t_staging.time():
            xs, ys = self._to_devices(xs), self._to_devices(ys)
            fmasks = self._to_devices(fmasks)
            lmasks = self._to_devices(lmasks)
        self.last_batch_size = int(xs[0].shape[0]) if xs and xs[0].ndim else 0
        self._single_steps(xs, ys, fmasks, lmasks)

    @under_conf_policy
    def _fit_tbptt(self, xs, ys, fmasks=None, lmasks=None) -> None:
        """Truncated BPTT: every input, label and mask cut along the time
        axis (1) into ``tbptt_fwd_length`` chunks, one update a chunk; the
        LSTM vertices' state carries across chunks without gradient and
        starts from zero for every batch."""
        xs, ys = self._to_devices(xs), self._to_devices(ys)
        fmasks, lmasks = self._to_devices(fmasks), self._to_devices(lmasks)
        self.last_batch_size = int(xs[0].shape[0]) if xs[0].ndim else 0
        T = xs[0].shape[1]
        L = self.conf.tbptt_fwd_length
        if self._tbptt_step is None:
            self._tbptt_step = make_graph_tbptt_step(self)
        rnn_state = _init_graph_rnn_states(self, xs[0].shape[0])
        for c in range(max(1, -(-T // L))):
            sl = slice(c * L, min((c + 1) * L, T))
            fm = [m[:, sl] for m in fmasks] if fmasks else None
            lm = [m[:, sl] for m in lmasks] if lmasks else None
            new_states, self.updater_state, rnn_state, loss = \
                self._tbptt_step(self.params_list, self.state_list,
                                 self.updater_state, rnn_state,
                                 [x[:, sl] for x in xs],
                                 [y[:, sl] for y in ys], self._next_rng(),
                                 self.iteration, fm, lm)
            self._write_states(new_states)
            self._chunk_done(loss)

    # ------------------------------------------------------------------ pretrain
    def pretrain(self, iterator) -> None:
        """Greedy layerwise unsupervised pretraining of every pretraining
        vertex in topological order (:meth:`pretrain_layer`): earlier
        vertices are frozen features for later ones."""
        for name in self.order:
            layer = self.vertex_layers.get(name)
            if layer is not None and layer.is_pretrain_layer():
                self.pretrain_layer(name, iterator)

    def pretrain_layer(self, name: str, iterator) -> None:
        """Pretrain vertex ``name`` on the features of every batch of
        ``iterator`` (reset first when it can be); its ancestors give its
        input in eval mode and only its params move. ``score_value`` is the
        last batch's pretraining loss; ``iteration`` does not move."""
        self._require_init()
        if name not in self.conf.vertices:
            raise ValueError(f"Unknown vertex '{name}'; graph vertices: "
                             f"{sorted(self.conf.vertices)}")
        layer = self.vertex_layers.get(name)
        if layer is None or not layer.is_pretrain_layer():
            raise ValueError(
                f"Vertex '{name}' is not pretrainable: layerwise pretraining "
                "needs an unsupervised layer (VAE, RBM, AutoEncoder)")
        step = self._pretrain_steps.get(name)
        if step is None:
            step = self._pretrain_steps[name] = make_graph_pretrain_step(
                self, name)
        for ds in _rewound(iterator):
            xs = self._to_devices(_coerce_graph_batch(ds)[0])
            self.updater_state[name], loss = step(
                self.params_list, self.state_list, self.updater_state[name],
                xs, self._next_rng(), self.iteration)
            self.score_value = loss  # a device scalar, read lazily

    # ------------------------------------------------------------------ rnn API
    @torch.no_grad()
    @under_conf_policy
    def rnn_time_step(self, *inputs) -> list:
        """Streaming inference carrying the LSTM vertices' state across
        calls: one ``[B, T, F]`` array per network input (T may be 1) ->
        the network outputs of those steps (a list)."""
        self._require_init()
        xs = self._to_devices(inputs)
        if self._rnn_state is None:
            self._rnn_state = _init_graph_rnn_states(self, xs[0].shape[0])
        acts, _, _, self._rnn_state = graph_forward_streaming(
            self, self.params_list, self.state_list, self._rnn_state, xs,
            train=False)
        return [acts[o] for o in self.conf.network_outputs]

    def rnn_get_previous_state(self) -> Optional[dict]:
        """The streaming state by vertex (``{"h", "c"}`` for the LSTM
        vertices, ``{}`` for the others); None until ``rnn_time_step`` has
        run."""
        return self._rnn_state

    def rnn_set_previous_state(self, state) -> None:
        """Install a state taken by ``rnn_get_previous_state`` (moved to this
        network's device)."""
        self._rnn_state = (None if state is None else
                           {n: {k: self._to_device(v) for k, v in s.items()}
                            for n, s in state.items()})

    def rnn_clear_previous_state(self) -> None:
        self._rnn_state = None

    # ------------------------------------------------------------------ copies
    def clone(self, device=None) -> "ComputationGraph":
        """A network on ``device`` (default: this network's) with copies
        (never aliases) of the params, the layer states, the updater state,
        the counters, the RNG state and the streaming state."""
        dev = self.device if device is None else device
        net = ComputationGraph(copy.deepcopy(self.conf), device=dev)
        with torch.no_grad():
            for name, layer in self.vertex_layers.items():
                theirs = net.vertex_layers[name]
                for own, other in ((layer.params(), theirs.params()),
                                   (layer.state(), theirs.state())):
                    for k, v in own.items():
                        other[k].copy_(v)
        net._initialized = self._initialized
        if self.updater_state is not None:
            net.updater_state = {
                n: {p: {k: v.to(net.device, copy=True)
                        for k, v in slots.items()}
                    for p, slots in vs.items()}
                for n, vs in self.updater_state.items()}
        net.iteration = self.iteration
        net.epoch = self.epoch
        net._rng.set_state(self._rng.get_state())
        if self._rnn_state is not None:
            net._rnn_state = {n: {k: v.to(net.device, copy=True)
                                  for k, v in s.items()}
                              for n, s in self._rnn_state.items()}
        return net
