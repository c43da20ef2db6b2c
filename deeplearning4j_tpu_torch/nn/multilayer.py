"""``MultiLayerNetwork``: a stack of layers, run forward and trained.

Counterpart of ``deeplearning4j_tpu/nn/multilayer.py``: ``init``,
``output``, ``_output_pure``, ``feed_forward``, ``predict``, ``params_list``,
``state_list``, the flat ``params``/``set_params``/``num_params`` view,
``score_examples``, ``gradient_and_score``, ``evaluate`` and its regression
and ROC forms, the pure
training functions (``_regularization``, ``_aux_losses``, ``loss_fn``,
``make_train_step``, ``make_tbptt_step``, ``make_pretrain_step``) and
the stateful shell over them
(``fit`` on arrays, a ``DataSet`` or an iterable of ``DataSet``\\ s,
``_fit_batch`` with ``iterations > 1`` or, for a non-SGD
``optimization_algo``, through the ``Solver``, truncated BPTT (``_fit_tbptt``) for
stacks with an LSTM, ``fit_iterator`` (with layerwise pretraining first
when the config sets ``pretrain``), ``pretrain``, ``pretrain_layer``,
``score``, ``score_value``, listeners, the K-step dispatch of
``nn/ksteps.py``), and the recurrent
API (``rnn_time_step``, the previous-state accessors, ``clone``). Every forward applies the configuration's input
preprocessors before their layers, as the JAX ``forward_fn`` does.

Layer state (batch norm's running mean and var) lives in each layer's
buffers; ``state_list`` reads them. Every forward runs
``Layer.apply_with_state`` over an explicit state list; a training forward
returns the new states, and the network writes them into the buffers once
the step's update is done (:func:`write_states`), so a checkpointed layer's
second forward in the backward writes nothing.

The JAX package fuses the whole step into one compiled program; here the
step is eager: ``torch.autograd.grad`` gives the gradients, and the updater
runs under ``no_grad`` and updates the parameters *in place* (the JAX step
returns new arrays; in place saves a copy of every parameter). The JAX
package's K-step fused dispatch (``fit_iterator(ksteps=)``,
``fit(epochs=k)``) is :class:`~.ksteps.KStepFit`: on the card a CUDA graph
of the step; its health-monitor variant waits for the observability plane
(ROADMAP.md).

The config's ``dtype`` names the policy (``common.py``) every step, TBPTT
chunk, streaming call and ``output``/``score``/``evaluate`` runs under,
whatever the ambient policy (``under_conf_policy``), as the JAX package
traces each program under it. Parameters, updater state and batch norm's
running state stay float32 under every named policy.

Iteration numbering follows the JAX package: a step runs with the
network's ``iteration`` (the Adam bias correction and the learning-rate
policies read it), then ``iteration`` is incremented and listeners see the
new value. A pretraining step reads the iteration and leaves it as it is,
as the JAX package does.
"""
from __future__ import annotations

import copy
from typing import List, Optional

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..common import (
    host_numpy, resolve_device, under_conf_policy, wrap_with_policy)
from .conf.multilayer import MultiLayerConfiguration
from .conf.layers.recurrent import LSTM, streaming_lstm
from .conf.serde import layer_class
from .ksteps import KStepFit
from .updaters import (
    UpdaterSpec, effective_lr, grads_to_param_dtype, normalize_gradients,
    updater_init, updater_step_with_param,
)

#: the profiler range around the updater's kernels in a train step
UPDATER_LABEL = "dl4j::updater"
#: parameter names that train at the bias learning rate
_BIAS_NAMES = ("b", "vb", "beta")
_SEED_RANGE = 2 ** 62


def _updater_spec(layer) -> UpdaterSpec:
    return UpdaterSpec(
        name=layer.updater or "sgd", momentum=layer.momentum,
        momentum_schedule=layer.momentum_schedule, rho=layer.rho,
        rms_decay=layer.rms_decay, adam_mean_decay=layer.adam_mean_decay,
        adam_var_decay=layer.adam_var_decay, epsilon=layer.epsilon)


def _regularization(net, params_list) -> torch.Tensor:
    """``l1 * |W|_1 + 0.5 * l2 * ||W||^2`` over the regularizable params,
    only when the config sets ``use_regularization``."""
    total = torch.zeros((), dtype=torch.float32, device=net.device)
    if not net.conf.global_conf.use_regularization:
        return total
    for layer, params in zip(net.layers, params_list):
        for name in layer.regularizable_params():
            if name not in params:
                continue
            w = params[name]
            if layer.l1:
                total = total + layer.l1 * w.abs().sum()
            if layer.l2:
                total = total + 0.5 * layer.l2 * (w * w).sum()
    return total


def _aux_losses(layers, new_states):
    """Sum of layer-declared auxiliary objectives: a layer publishes one as
    an ``"aux_loss"`` scalar in its state (the MoE layers' load-balance
    term), weighted by its ``aux_loss_weight``."""
    total = 0.0
    for layer, ns in zip(layers, new_states):
        if isinstance(ns, dict) and "aux_loss" in ns:
            total = total + getattr(layer, "aux_loss_weight", 1.0) * ns["aux_loss"]
    return total


def _layer_seeds(n: int, rng: Optional[int]) -> List[Optional[int]]:
    """One seed per layer from a step's seed (the counterpart of splitting a
    JAX key per layer), or None when the step has no randomness."""
    if rng is None:
        return [None] * n
    g = torch.Generator(device="cpu").manual_seed(int(rng))
    return torch.randint(0, _SEED_RANGE, (n,), generator=g).tolist()


def _dropout_gen(layer, seed: Optional[int], device) -> Optional[torch.Generator]:
    """A generator on ``device`` for the layer's dropout mask, or None when
    the layer draws none."""
    if seed is None or not layer.uses_dropout():
        return None
    return torch.Generator(device=device).manual_seed(seed)


def _pre(net, i: int, h: torch.Tensor, mask=None) -> torch.Tensor:
    """``h`` through the preprocessor before layer ``i``, if it has one."""
    pp = net.conf.preprocessor(i)
    return h if pp is None else pp.pre_process(h, mask)


def write_states(layers, new_states) -> None:
    """Copy each layer's new state into its buffers (a state handed back
    unchanged is skipped)."""
    with torch.no_grad():
        for layer, ns in zip(layers, new_states):
            own = layer.state()
            for k, v in ns.items():
                if k in own and v is not own[k]:
                    own[k].copy_(v)


def loss_fn(net, params_list, x, y, rng: Optional[int] = None, fmask=None,
            lmask=None, state_list=None):
    """Training loss: the forward in train mode to the last (loss) layer,
    plus auxiliary losses and regularization, from ``state_list`` (default:
    the network's). Returns ``(loss, new_state_list)``.

    With ``gradient_checkpointing`` set, each layer application runs under
    ``torch.utils.checkpoint``: the backward recomputes the layer's forward
    instead of holding its activations. A layer's dropout generator is made
    from its seed inside the checkpointed function, so the recompute draws
    the same mask."""
    layers = net.layers
    last = layers[-1]
    if not last.has_loss():
        raise ValueError("Last layer has no loss function; cannot compute "
                         "supervised loss")
    remat = net.conf.global_conf.gradient_checkpointing
    states = net.state_list if state_list is None else state_list
    seeds = _layer_seeds(len(layers), rng)
    dev = x.device
    h = x
    new_states = []
    for i, layer in enumerate(layers[:-1]):
        h = _pre(net, i, h, fmask)
        if remat:
            def f(p, s, hh, _layer=layer, _seed=seeds[i]):
                return _layer.apply_with_state(
                    p, s, hh, fmask, True, _dropout_gen(_layer, _seed, dev))
            h, ns = checkpoint(f, params_list[i], states[i], h,
                               use_reentrant=False, preserve_rng_state=False)
        else:
            h, ns = layer.apply_with_state(params_list[i], states[i], h, fmask,
                                           True,
                                           _dropout_gen(layer, seeds[i], dev))
        new_states.append(ns)
    h = _pre(net, len(layers) - 1, h, fmask)
    h = last.apply_dropout(h, _dropout_gen(last, seeds[-1], dev), True)
    loss = last.compute_loss(params_list[-1], h, y, lmask)
    new_states.append(states[-1])
    loss = loss + _aux_losses(layers, new_states)
    return loss + _regularization(net, params_list), new_states


def _grads(loss_val, params_list) -> List[dict]:
    """``d loss_val / d param`` per layer by param name (zeros for a param
    the loss does not reach)."""
    keys = [(i, name) for i, p in enumerate(params_list) for name in p]
    flat = [params_list[i][name] for i, name in keys]
    got = torch.autograd.grad(loss_val, flat, allow_unused=True)
    grads = [{} for _ in params_list]
    for (i, name), p, gr in zip(keys, flat, got):
        grads[i][name] = torch.zeros_like(p) if gr is None else gr
    return grads


def update_layer(g, layer, params, grads, upd, iteration,
                 bias_rate: bool = True, sqsum=None) -> dict:
    """One layer's update under ``no_grad``: the gradient normalization,
    the learning-rate policy of global conf ``g`` and the updater, each step
    subtracted from its parameter in place. With ``bias_rate`` the bias
    params train at the layer's ``bias_learning_rate``; without it every
    param trains at the layer's rate. ``sqsum(name, t)`` forms the squared
    sums of the gradient normalization and the LARS/LAMB norms (a ZeRO step
    passes one that reduces a sharded leaf's over its ranks). Returns the
    layer's new updater state."""
    grads = normalize_gradients(grads, layer.gradient_normalization,
                                layer.gradient_normalization_threshold or 1.0,
                                sqsum)
    spec = _updater_spec(layer)
    lr = effective_lr(layer.learning_rate, g.lr_policy, iteration,
                      g.lr_policy_decay_rate, g.lr_policy_power,
                      g.lr_policy_steps, g.lr_schedule, g.max_num_iterations)
    lr_bias = lr
    if bias_rate and layer.bias_learning_rate is not None:
        lr_bias = torch.tensor(layer.bias_learning_rate, dtype=torch.float32)
    u_new = {}
    for name, grad in grads.items():
        this_lr = lr_bias if name in _BIAS_NAMES else lr
        step, ustate = updater_step_with_param(
            spec, grad, params[name], upd[name], this_lr, iteration, sqsum,
            name)
        params[name].sub_(step)
        u_new[name] = ustate
    return u_new


def _apply_updates(net, params_list, upd_state, loss_val, iteration,
                   bias_rate: bool = True) -> list:
    """Gradients of ``loss_val`` by ``torch.autograd.grad``, then
    :func:`update_layer` for each layer, inside the ``UPDATER_LABEL``
    profiler range. Returns the new updater state."""
    g = net.conf.global_conf
    grads = grads_to_param_dtype(_grads(loss_val, params_list), params_list)
    new_upd = []
    # the label names the updater's kernels in a profile
    with torch.no_grad(), torch.profiler.record_function(UPDATER_LABEL):
        for i, layer in enumerate(net.layers):
            if not grads[i]:
                new_upd.append(upd_state[i])
                continue
            new_upd.append(update_layer(g, layer, params_list[i], grads[i],
                                        upd_state[i], iteration, bias_rate))
    return new_upd


def make_train_step(net):
    """The train step as a plain function:
    ``(params_list, upd_state, x, y, rng, iteration, fmask, lmask) ->
    (upd_state', state_list', loss)``.

    Gradients come from ``torch.autograd.grad``; per-layer gradient
    normalization, the learning-rate policy, the separate bias learning rate
    and the updater then run under ``no_grad`` and subtract each step from
    its parameter in place. The new layer states are returned, not
    written."""

    def train_step(params_list, upd_state, x, y, rng, iteration, fmask=None,
                   lmask=None):
        loss_val, new_states = loss_fn(net, params_list, x, y, rng, fmask,
                                       lmask)
        new_upd = _apply_updates(net, params_list, upd_state, loss_val,
                                 iteration)
        return new_upd, new_states, loss_val.detach()

    return train_step


def pretrain_update(g, layer, params: dict, upd: dict, h: torch.Tensor,
                    rng: Optional[int], iteration, noise=None):
    """One pretraining update of ``layer`` on its input ``h`` (already
    detached): the gradient of its ``pretrain_loss`` with respect to its
    own params only, then :func:`update_layer` with every param at the
    layer's learning rate (no bias rate), without l1/l2, as the JAX
    pretrain step. The layer's random draws come from a generator on
    ``h``'s device seeded with ``rng`` unless ``noise`` gives them. Returns
    ``(upd', loss)``."""
    gen = None if rng is None else torch.Generator(
        device=h.device).manual_seed(int(rng))
    loss = layer.pretrain_loss(params, h, gen=gen, noise=noise)
    grads = grads_to_param_dtype(_grads(loss, [params]), [params])[0]
    with torch.no_grad():
        new_upd = update_layer(g, layer, params, grads, upd, iteration,
                               bias_rate=False)
    return new_upd, loss.detach()


def eval_forward_to_layer(net, params_list, state_list, x,
                          layer_idx: int) -> torch.Tensor:
    """The eval-mode forward of the layers before ``layer_idx``: returns
    that layer's input, after its preprocessor. The one walk of the
    pretraining step and the pretraining gradient check."""
    h = x
    for i in range(layer_idx):
        h = net.layers[i].apply_with_state(params_list[i], state_list[i],
                                           _pre(net, i, h))[0]
    return _pre(net, layer_idx, h)


def make_pretrain_step(net, layer_idx: int):
    """The unsupervised pretraining step of layer ``layer_idx`` as a plain
    function: ``(params_list, state_list, layer_upd, x, rng, iteration,
    noise=None) -> (layer_upd', loss)``. The layers before it run their
    eval forward (no dropout) without gradient; only the layer's own params
    move, in place, through its own updater state."""
    layer = net.layers[layer_idx]
    g = net.conf.global_conf

    def pretrain_step(params_list, state_list, layer_upd, x, rng, iteration,
                      noise=None):
        with torch.no_grad():
            h = eval_forward_to_layer(net, params_list, state_list, x,
                                      layer_idx)
        return pretrain_update(g, layer, params_list[layer_idx], layer_upd,
                               h, rng, iteration, noise)

    return wrap_with_policy(pretrain_step, g.dtype)


def _init_rnn_states(net, batch: int) -> List[dict]:
    """Zero ``{"h", "c"}`` per LSTM layer (``{}`` for the others)."""
    states = []
    for layer in net.layers:
        if isinstance(layer, LSTM):
            z = torch.zeros(batch, layer.n_out, dtype=torch.float32,
                            device=net.device)
            states.append({"h": z, "c": z.clone()})
        else:
            states.append({})
    return states


def _rnn_forward(net, params_list, rnn_states, x):
    """Forward pass threading the streaming LSTM state: ``(out,
    new_states)``. Layers that do not stream run their full-sequence
    forward in eval mode."""
    h = x
    new_rnn = []
    for i, (layer, params, state, rs) in enumerate(zip(
            net.layers, params_list, net.state_list, rnn_states)):
        h = _pre(net, i, h)
        if streaming_lstm(layer):
            h, rs = layer.apply_streaming(params, rs, h)
        else:
            h = layer.apply_with_state(params, state, h)[0]
        new_rnn.append(rs)
    return h, new_rnn


def make_tbptt_step(net):
    """The truncated-BPTT step over one chunk as a plain function:
    ``(params_list, upd_state, rnn_states, x, y, rng, iteration, fmask,
    lmask) -> (upd_state', rnn_states', state_list', loss)``.

    Streaming LSTM layers run ``apply_streaming`` from the carried state with
    ``mask=fmask`` and hand on their final state detached (the truncation);
    the other layers run their training forward. As in the JAX package's
    TBPTT step, every param, biases included, trains at the layer's
    learning rate: ``bias_learning_rate`` is not read here."""

    def tbptt_step(params_list, upd_state, rnn_states, x, y, rng, iteration,
                   fmask=None, lmask=None):
        layers = net.layers
        states = net.state_list
        seeds = _layer_seeds(len(layers), rng)
        h = x
        new_rnn = []
        new_states = []
        for i, layer in enumerate(layers[:-1]):
            h = _pre(net, i, h, fmask)
            if streaming_lstm(layer):
                h, rs = layer.apply_streaming(params_list[i], rnn_states[i], h,
                                              mask=fmask)
                new_rnn.append({k: v.detach() for k, v in rs.items()})
                new_states.append(states[i])
            else:
                h, ns = layer.apply_with_state(
                    params_list[i], states[i], h, fmask, True,
                    _dropout_gen(layer, seeds[i], x.device))
                new_rnn.append(rnn_states[i])
                new_states.append(ns)
        last = layers[-1]
        h = last.apply_dropout(h, _dropout_gen(last, seeds[-1], x.device), True)
        loss = last.compute_loss(params_list[-1], h, y, lmask)
        new_rnn.append(rnn_states[-1])
        new_states.append(states[-1])
        loss = loss + _aux_losses(layers, new_states)
        loss = loss + _regularization(net, params_list)
        new_upd = _apply_updates(net, params_list, upd_state, loss, iteration,
                                 bias_rate=False)
        return new_upd, new_rnn, new_states, loss.detach()

    return tbptt_step


def load_states(layers, given_states, where) -> None:
    """Copy running states (numpy arrays or tensors, by JAX name) into the
    layers' buffers; ``where`` names each layer in errors. Names and shapes
    must match exactly."""
    given_states = list(given_states)
    if len(given_states) != len(layers):
        raise ValueError(f"{len(given_states)} state dicts for {len(layers)} "
                         "layers")
    with torch.no_grad():
        for i, layer, given in zip(where, layers, given_states):
            own = layer.state()
            if set(given) != set(own):
                raise ValueError(f"layer {i} ({layer.TYPE}) state "
                                 f"{sorted(given)} != expected {sorted(own)}")
            for name, value in given.items():
                t = torch.as_tensor(np.array(value, dtype=np.float32))
                if tuple(t.shape) != tuple(own[name].shape):
                    raise ValueError(f"layer {i} state {name}: shape "
                                     f"{tuple(t.shape)} != "
                                     f"{tuple(own[name].shape)}")
                own[name].copy_(t)


def _numpy(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return host_numpy(a)
    return np.asarray(a)


def _rewound(iterator):
    """``iterator`` reset first when it can be."""
    if hasattr(iterator, "reset"):
        iterator.reset()
    return iterator


class MultiLayerNetwork(KStepFit, nn.Module):
    """Layers built from ``conf`` on ``device`` (``None`` means CUDA)."""

    def __init__(self, conf: MultiLayerConfiguration, device=None):
        super().__init__()
        self.conf = conf
        self.device = resolve_device(device)
        self.layers = nn.ModuleList(
            layer_class(lc.type)(lc, self.device) for lc in conf.layers)
        self._initialized = False
        self.updater_state: Optional[list] = None
        self.iteration = 0
        self.epoch = 0
        self.listeners: list = []
        self.last_batch_size = 0
        self._score = float("nan")
        self._rng = torch.Generator(device="cpu")
        self._train_step = None
        self._tbptt_step = None
        #: the pretraining steps by layer index (made at first use)
        self._pretrain_steps: dict = {}
        #: the Solver of a non-SGD ``optimization_algo`` (made at first use)
        self._solver = None
        #: the captured train steps of the K-step dispatch, by batch shapes
        self._step_graphs: dict = {}
        #: streaming state of ``rnn_time_step`` (None until it runs)
        self._rnn_state: Optional[List[dict]] = None

    # ------------------------------------------------------------------ lifecycle
    def init(self, seed: Optional[int] = None) -> "MultiLayerNetwork":
        """Draw every parameter from one CPU ``torch.Generator`` seeded with
        ``seed`` (default: the config's seed), so one seed gives the same
        weights on every device, and zero the updater state. The JAX
        package's RNG differs: weights cross between the two packages
        through ``convert.from_jax`` only."""
        seed = self.conf.global_conf.seed if seed is None else seed
        gen = torch.Generator(device="cpu")
        gen.manual_seed(seed)
        for layer in self.layers:
            layer.init_params(gen)
            layer.reset_state()
        self._rng.manual_seed((int(seed) * 0x9E3779B1 + 0xD14) % _SEED_RANGE)
        self._init_updater_state()
        self._drop_step_graphs()
        self._initialized = True
        return self

    def _init_updater_state(self) -> None:
        self.updater_state = [
            {name: updater_init(_updater_spec(layer), p)
             for name, p in layer.params().items()}
            for layer in self.layers]

    @torch.no_grad()
    def load_params(self, params_list: List[dict],
                    state_list: Optional[List[dict]] = None
                    ) -> "MultiLayerNetwork":
        """Copy params given per layer by JAX name (numpy arrays or tensors),
        and with ``state_list`` the layers' running states the same way;
        names and shapes must match exactly. The updater state is zeroed
        unless one was loaded already."""
        if len(params_list) != len(self.layers):
            raise ValueError(f"{len(params_list)} param dicts for "
                             f"{len(self.layers)} layers")
        self._drop_step_graphs()
        for i, (layer, given) in enumerate(zip(self.layers, params_list)):
            own = layer.params()
            if set(given) != set(own):
                raise ValueError(f"layer {i} ({layer.TYPE}) params "
                                 f"{sorted(given)} != expected {sorted(own)}")
            for name, value in given.items():
                t = torch.as_tensor(np.array(value, dtype=np.float32))
                if tuple(t.shape) != tuple(own[name].shape):
                    raise ValueError(f"layer {i} param {name}: shape "
                                     f"{tuple(t.shape)} != "
                                     f"{tuple(own[name].shape)}")
                own[name].copy_(t)
        if state_list is not None:
            self.load_state(state_list)
        if self.updater_state is None:
            self._init_updater_state()
        self._initialized = True
        return self

    @torch.no_grad()
    def load_state(self, state_list: List[dict]) -> "MultiLayerNetwork":
        """Copy the layers' running state (batch norm's mean and var), given
        per layer by JAX name as the JAX ``net.state_list`` holds it (numpy
        arrays or tensors); names and shapes must match exactly."""
        load_states(self.layers, state_list, range(len(self.layers)))
        self._drop_step_graphs()
        return self

    @torch.no_grad()
    def load_updater_state(self, state: List[dict],
                           iteration: int = 0) -> "MultiLayerNetwork":
        """Set the updater state (per layer, per param name, per state name,
        numpy arrays or tensors, as the JAX ``net.updater_state``) and the
        iteration, so a trajectory continues where another left off."""
        if self.updater_state is None:
            self._init_updater_state()
        if len(state) != len(self.updater_state):
            raise ValueError(f"{len(state)} updater-state dicts for "
                             f"{len(self.updater_state)} layers")
        new = []
        for i, (own, given) in enumerate(zip(self.updater_state, state)):
            if set(own) != set(given):
                raise ValueError(f"layer {i} updater state params "
                                 f"{sorted(given)} != {sorted(own)}")
            layer_state = {}
            for name, slots in own.items():
                if set(slots) != set(given[name]):
                    raise ValueError(f"layer {i} param {name}: updater state "
                                     f"{sorted(given[name])} != {sorted(slots)}")
                layer_state[name] = {
                    k: torch.as_tensor(np.array(given[name][k], dtype=np.float32)
                                       ).to(self.device)
                    for k in slots}
            new.append(layer_state)
        self.updater_state = new
        self.iteration = int(iteration)
        self._drop_step_graphs()
        return self

    def _require_init(self) -> None:
        if not self._initialized:
            raise RuntimeError("network is not initialized: call init() or "
                               "load_params() first")

    def set_listeners(self, *listeners) -> None:
        self.listeners = list(listeners)

    def add_listener(self, listener) -> None:
        self.listeners.append(listener)

    # ------------------------------------------------------------------ params API
    def _flat_order(self) -> list:
        """The params in the JAX ``flatten_params`` order: layer by layer,
        each layer's names sorted (a JAX pytree's dict order)."""
        return [p[k] for p in self.params_list for k in sorted(p)]

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

    @property
    def params_list(self) -> List[dict]:
        return [layer.params() for layer in self.layers]

    @property
    def state_list(self) -> List[dict]:
        """Each layer's running state by JAX name (its buffers; ``{}`` for
        a layer without state)."""
        return [layer.state() for layer in self.layers]

    # ------------------------------------------------------------------ inference
    def _output_pure(self, params_list, state_list, x: torch.Tensor,
                     mask: Optional[torch.Tensor] = None,
                     collect: Optional[list] = None) -> torch.Tensor:
        """The forward in eval mode; with ``collect`` each layer's output is
        appended to it."""
        h = x
        for i, (layer, params, state) in enumerate(zip(self.layers, params_list,
                                                       state_list)):
            h = layer.apply_with_state(params, state, _pre(self, i, h, mask),
                                       mask)[0]
            if collect is not None:
                collect.append(h)
        return h

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

    @under_conf_policy
    @torch.no_grad()
    def output(self, x) -> torch.Tensor:
        """Forward pass returning the final activations on this network's
        device."""
        self._require_init()
        return self._output_pure(self.params_list, self.state_list,
                                 self._to_device(x))

    @under_conf_policy
    @torch.no_grad()
    def feed_forward(self, x) -> List[torch.Tensor]:
        """Every layer's output, in order."""
        self._require_init()
        acts: list = []
        self._output_pure(self.params_list, self.state_list,
                          self._to_device(x), collect=acts)
        return acts

    def predict(self, x) -> np.ndarray:
        """The class of each row: the argmax of the output."""
        return self.output(x).argmax(dim=-1).cpu().numpy()

    # ------------------------------------------------------------------ evaluation
    def evaluate(self, iterator_or_x, y=None, labels_list=None,
                 top_n: int = 1):
        """Classification scores over an iterator of ``DataSet``\\ s or one
        ``(x, y)`` pair; ``labels_list`` names the classes in ``stats()``,
        ``top_n`` counts top-N accuracy beside top-1."""
        from ..eval.evaluation import Evaluation

        ev = Evaluation(labels=labels_list, top_n=top_n)
        if y is not None:
            ev.eval(_numpy(y), _numpy(self.output(iterator_or_x)))
            return ev
        for ds in _rewound(iterator_or_x):
            ev.eval(_numpy(ds.labels), _numpy(self.output(ds.features)),
                    mask=None if ds.labels_mask is None
                    else _numpy(ds.labels_mask))
        return ev

    def f1_score(self, x, y=None) -> float:
        """F1 on a ``DataSet`` or an ``(x, y)`` pair."""
        from ..datasets.dataset import DataSet

        if y is None and isinstance(x, DataSet):
            x, y = x.features, x.labels
        return self.evaluate(x, y).f1()

    def _evaluate_with(self, ev, iterator):
        for ds in _rewound(iterator):
            ev.eval(_numpy(ds.labels), _numpy(self.output(ds.features)))
        return ev

    def evaluate_regression(self, iterator):
        from ..eval.regression import RegressionEvaluation

        return self._evaluate_with(RegressionEvaluation(), iterator)

    def evaluate_roc(self, iterator, threshold_steps: int = 30):
        from ..eval.roc import ROC

        return self._evaluate_with(ROC(threshold_steps), iterator)

    def evaluate_roc_multiclass(self, iterator, threshold_steps: int = 30):
        """One-vs-all ROC per class."""
        from ..eval.roc import ROCMultiClass

        return self._evaluate_with(ROCMultiClass(threshold_steps), iterator)

    @under_conf_policy
    @torch.no_grad()
    def score(self, x=None, y=None, dataset=None) -> float:
        """Loss (with regularization) on a dataset, without dropout; a
        ``DataSet``'s feature and label masks are honored as in ``fit``."""
        self._require_init()
        fmask = lmask = None
        if dataset is not None:
            x, y = dataset.features, dataset.labels
            fmask, lmask = dataset.features_mask, dataset.labels_mask
        x, y = self._to_device(x), self._to_device(y)
        fmask, lmask = self._to_device(fmask), self._to_device(lmask)
        params = self.params_list
        h = self._eval_trunk(params, self.state_list, x, fmask)
        loss = self.layers[-1].compute_loss(params[-1], h, y, lmask)
        return float(loss + _regularization(self, params))

    def _eval_trunk(self, params_list, state_list, x,
                    fmask=None) -> torch.Tensor:
        """The eval-mode forward to the last layer's input (its preprocessor
        applied): the one trunk of ``score`` and ``score_examples``."""
        h = x
        for i, (layer, p, st) in enumerate(zip(self.layers[:-1], params_list,
                                               state_list)):
            h = layer.apply_with_state(p, st, _pre(self, i, h, fmask),
                                       fmask)[0]
        return _pre(self, len(self.layers) - 1, h, fmask)

    @under_conf_policy
    @torch.no_grad()
    def score_examples(self, x, y=None,
                       add_regularization: bool = False) -> np.ndarray:
        """Each example's loss, unreduced (``[B]`` numpy): the loss of the
        one-example batch, so every loss keeps its own reduction rules. ``x``
        may be a ``DataSet``, whose label mask weights each example's own
        loss. With ``add_regularization`` the l1/l2 term is added to each."""
        from ..datasets.dataset import DataSet

        self._require_init()
        fmask = lmask = None
        if y is None and isinstance(x, DataSet):
            fmask, lmask = x.features_mask, x.labels_mask
            x, y = x.features, x.labels
        x, y = self._to_device(x), self._to_device(y)
        fmask, lmask = self._to_device(fmask), self._to_device(lmask)
        params = self.params_list
        h = self._eval_trunk(params, self.state_list, x, fmask)
        last = self.layers[-1]
        per = torch.stack([
            last.compute_loss(params[-1], h[i:i + 1], y[i:i + 1],
                              None if lmask is None else lmask[i:i + 1])
            for i in range(h.shape[0])])
        if add_regularization:
            per = per + _regularization(self, params)
        return per.cpu().numpy()

    @under_conf_policy
    def gradient_and_score(self, x, y, fmask=None, lmask=None):
        """``(grads, score)`` without an update: the training loss's
        gradients per layer by param name, without dropout (batch norm
        normalizes with the batch's statistics, and its state is not
        written)."""
        self._require_init()
        x, y = self._to_device(x), self._to_device(y)
        fmask, lmask = self._to_device(fmask), self._to_device(lmask)
        params = self.params_list
        loss, _ = loss_fn(self, params, x, y, None, fmask, lmask)
        return _grads(loss, params), float(loss.detach())

    @property
    def score_value(self) -> float:
        """The last step's loss; read from the device only when asked for."""
        if isinstance(self._score, torch.Tensor):
            self._score = float(self._score)
        return self._score

    @score_value.setter
    def score_value(self, value) -> None:
        self._score = value

    # ------------------------------------------------------------------ training
    def _next_rng(self) -> int:
        return int(torch.randint(0, _SEED_RANGE, (1,), generator=self._rng))

    def fit(self, x, y=None, *, epochs: int = 1, fmask=None,
            lmask=None) -> None:
        """Fit on arrays, a ``DataSet``, or an iterable of ``DataSet``\\ s.
        ``epochs`` repeats of one unmasked batch run in groups of
        ``dispatch_ksteps`` steps (``_fit_repeated``) on an eligible
        network, as single steps otherwise."""
        from ..datasets.dataset import DataSet

        if y is None and isinstance(x, DataSet):
            self.fit(x.features, x.labels, epochs=epochs,
                     fmask=x.features_mask, lmask=x.labels_mask)
            return
        if y is None and hasattr(x, "__iter__") \
                and not isinstance(x, (np.ndarray, torch.Tensor)):
            self.fit_iterator(x, epochs=epochs)
            return
        if (epochs > 1 and fmask is None and lmask is None
                and self._multistep_ok(self.dispatch_ksteps)):
            self._fit_repeated([x], [y], epochs)
            return
        for _ in range(epochs):
            self._fit_batch(x, y, fmask, lmask)

    # the hooks of the K-step shell (KStepFit)
    def _layer_modules(self) -> list:
        return list(self.layers)

    def _group_arrays(self, ds):
        if ds.features_mask is not None or ds.labels_mask is not None:
            return None
        return [_numpy(ds.features)], [_numpy(ds.labels)]

    def _fit_dataset(self, ds) -> None:
        self._fit_batch(ds.features, ds.labels, ds.features_mask,
                        ds.labels_mask)

    def _fit_arrays(self, xs: list, ys: list) -> None:
        self._fit_batch(xs[0], ys[0])

    @under_conf_policy
    def _train_call(self, xs: list, ys: list, rng, iteration, upd,
                    fmask=None, lmask=None):
        """The train step on device tensors: ``(upd', states', loss)``."""
        if self._train_step is None:
            self._train_step = make_train_step(self)
        return self._train_step(self.params_list, upd, xs[0], ys[0], rng,
                                iteration, fmask, lmask)

    def _write_states(self, new_states: list) -> None:
        write_states(self.layers, new_states)

    def _uses_tbptt(self) -> bool:
        """Truncated BPTT applies to stacks with an LSTM layer only; any other
        stack flagged ``TruncatedBPTT`` trains with the standard step, as in
        the JAX package."""
        return (self.conf.backprop_type == "TruncatedBPTT"
                and any(isinstance(l, LSTM) for l in self.layers))

    def _uses_sgd(self) -> bool:
        return self.conf.global_conf.optimization_algo in (
            None, "stochastic_gradient_descent")

    def _fit_batch(self, x, y, fmask=None, lmask=None) -> None:
        self._require_init()
        if not self._uses_sgd():
            # LBFGS, conjugate gradient and line-search GD minimize the batch
            # loss through the Solver, as the JAX package routes them
            from ..optimize.solvers import Solver

            if self._solver is None:
                self._solver = Solver(self)
            self._solver.optimize(x, y)
            return
        if self._uses_tbptt():
            self._fit_tbptt(x, y, fmask, lmask)
            return
        x, y = self._to_device(x), self._to_device(y)
        fmask, lmask = self._to_device(fmask), self._to_device(lmask)
        self.last_batch_size = int(x.shape[0]) if x.ndim else 0
        for _ in range(max(1, self.conf.global_conf.iterations)):
            loss = self._eager_step([x], [y], self.iteration, fmask, lmask)
            self.score_value = loss  # a device scalar, read lazily
            self.iteration += 1
            for listener in self.listeners:
                listener.iteration_done(self, self.iteration)

    @under_conf_policy
    def _fit_tbptt(self, x, y, fmask=None, lmask=None) -> None:
        """Truncated BPTT: the time axis (1) cut into ``tbptt_fwd_length``
        chunks, one update per chunk; the LSTM state carries across chunks
        without gradient and starts from zero for every batch."""
        x, y = self._to_device(x), self._to_device(y)
        fmask, lmask = self._to_device(fmask), self._to_device(lmask)
        self.last_batch_size = int(x.shape[0]) if x.ndim else 0
        T = x.shape[1]
        L = self.conf.tbptt_fwd_length
        if self._tbptt_step is None:
            self._tbptt_step = make_tbptt_step(self)
        rnn_state = _init_rnn_states(self, x.shape[0])
        for c in range(max(1, -(-T // L))):
            sl = slice(c * L, min((c + 1) * L, T))
            fm = fmask[:, sl] if fmask is not None else None
            lm = lmask[:, sl] if lmask is not None else None
            self.updater_state, rnn_state, new_states, loss = self._tbptt_step(
                self.params_list, self.updater_state, rnn_state, x[:, sl],
                y[:, sl], self._next_rng(), self.iteration, fm, lm)
            write_states(self.layers, new_states)
            self.score_value = loss  # a device scalar, read lazily
            self.iteration += 1
            for listener in self.listeners:
                listener.iteration_done(self, self.iteration)

    # ------------------------------------------------------------------ pretrain
    def pretrain(self, iterator) -> None:
        """Greedy layerwise unsupervised pretraining: each pretraining layer
        in order (:meth:`pretrain_layer`), an epoch of ``iterator`` each."""
        for idx, layer in enumerate(self.layers):
            if layer.is_pretrain_layer():
                self.pretrain_layer(idx, iterator)

    def pretrain_layer(self, layer_idx: int, iterator) -> None:
        """Pretrain layer ``layer_idx`` on the features of every batch of
        ``iterator`` (reset first when it can be); the earlier layers give
        its input in eval mode. ``score_value`` is the last batch's
        pretraining loss; ``iteration`` does not move."""
        self._require_init()
        if not 0 <= layer_idx < len(self.layers):
            raise ValueError(f"layer_idx {layer_idx} out of range for "
                             f"{len(self.layers)} layers")
        if not self.layers[layer_idx].is_pretrain_layer():
            raise ValueError(
                f"Layer {layer_idx} ({type(self.layers[layer_idx]).__name__})"
                " is not pretrainable: layerwise pretraining needs an "
                "unsupervised layer (VAE, RBM, AutoEncoder)")
        step = self._pretrain_steps.get(layer_idx)
        if step is None:
            step = self._pretrain_steps[layer_idx] = make_pretrain_step(
                self, layer_idx)
        for ds in _rewound(iterator):
            self.updater_state[layer_idx], loss = step(
                self.params_list, self.state_list,
                self.updater_state[layer_idx], self._to_device(ds.features),
                self._next_rng(), self.iteration)
            self.score_value = loss  # a device scalar, read lazily

    # ------------------------------------------------------------------ rnn API
    @under_conf_policy
    @torch.no_grad()
    def rnn_time_step(self, x) -> torch.Tensor:
        """Streaming inference carrying the LSTM state across calls:
        ``x [B, T, F]`` (T may be 1) -> the outputs of those steps."""
        self._require_init()
        x = self._to_device(x)
        if self._rnn_state is None:
            self._rnn_state = _init_rnn_states(self, x.shape[0])
        out, self._rnn_state = _rnn_forward(self, self.params_list,
                                            self._rnn_state, x)
        return out

    def rnn_get_previous_state(self) -> Optional[List[dict]]:
        """Per-layer streaming state (``{"h", "c"}`` for LSTM layers); None
        until ``rnn_time_step`` has run."""
        return self._rnn_state

    def rnn_set_previous_state(self, state) -> None:
        """Install a state taken by ``rnn_get_previous_state`` (moved to this
        network's device)."""
        self._rnn_state = (None if state is None else
                           [{k: self._to_device(v) for k, v in s.items()}
                            for s in state])

    def rnn_clear_previous_state(self) -> None:
        self._rnn_state = None

    def clone(self, device=None) -> "MultiLayerNetwork":
        """A network on ``device`` (default: this network's) with copies
        (never aliases) of the params, the layer states, the updater state,
        the counters, the RNG state and the streaming state."""
        dev = self.device if device is None else device
        net = MultiLayerNetwork(copy.deepcopy(self.conf), device=dev)
        with torch.no_grad():
            for own, theirs in zip(self.params_list + self.state_list,
                                   net.params_list + net.state_list):
                for k, v in own.items():
                    theirs[k].copy_(v)
        net._initialized = self._initialized
        if self.updater_state is not None:
            net.updater_state = [
                {n: {k: v.to(net.device, copy=True) for k, v in slots.items()}
                 for n, slots in layer.items()} for layer in self.updater_state]
        net.iteration = self.iteration
        net.epoch = self.epoch
        net._rng.set_state(self._rng.get_state())
        if self._rnn_state is not None:
            net._rnn_state = [{k: v.to(net.device, copy=True)
                               for k, v in s.items()} for s in self._rnn_state]
        return net
