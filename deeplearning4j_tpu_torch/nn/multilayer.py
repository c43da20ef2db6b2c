"""``MultiLayerNetwork``: a stack of layers, run forward and trained.

Counterpart of ``deeplearning4j_tpu/nn/multilayer.py``: ``init``,
``output``, ``_output_pure``, ``params_list``, ``state_list``, the pure
training functions (``_regularization``, ``_aux_losses``, ``loss_fn``,
``make_train_step``, ``make_tbptt_step``) and the stateful shell over them
(``fit`` on arrays, a ``DataSet`` or an iterable of ``DataSet``\\ s,
``_fit_batch`` with ``iterations > 1``, truncated BPTT (``_fit_tbptt``) for
stacks with an LSTM, ``fit_iterator``, ``score``, ``score_value``,
listeners), and the recurrent API (``rnn_time_step``, the previous-state
accessors, ``clone``).

The JAX package fuses the whole step into one compiled program; here the
step is eager: ``torch.autograd.grad`` gives the gradients, and the updater
runs under ``no_grad`` and updates the parameters *in place* (the JAX step
returns new arrays; in place saves a copy of every parameter). The JAX
package's K-step fused dispatch, its device prefetcher and its health
monitor are TPU dispatch and observability machinery and are not ported:
``fit(epochs=k)`` loops over single steps (ROADMAP.md).

Iteration numbering follows the JAX package: a step runs with the
network's ``iteration`` (the Adam bias correction and the learning-rate
policies read it), then ``iteration`` is incremented and listeners see the
new value.
"""
from __future__ import annotations

import copy
from typing import Iterable, List, Optional

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..common import resolve_device
from .conf.multilayer import MultiLayerConfiguration
from .conf.layers.recurrent import LSTM, streaming_lstm
from .conf.serde import layer_class
from .updaters import (
    UpdaterSpec, effective_lr, grads_to_param_dtype, normalize_gradients,
    updater_init, updater_step_with_param,
)

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
    """Sum of layer-declared auxiliary objectives (a layer publishes one as
    an ``"aux_loss"`` scalar in its state, weighted by its
    ``aux_loss_weight``). No layer of this port publishes one yet."""
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


def loss_fn(net, params_list, x, y, rng: Optional[int] = None, fmask=None,
            lmask=None):
    """Training loss: the forward in train mode to the last (loss) layer,
    plus auxiliary losses and regularization. Returns
    ``(loss, new_state_list)``.

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
    seeds = _layer_seeds(len(layers), rng)
    dev = x.device
    h = x
    for i, layer in enumerate(layers[:-1]):
        if remat:
            def f(p, hh, _layer=layer, _seed=seeds[i]):
                return _layer.apply(p, hh, fmask, True,
                                    _dropout_gen(_layer, _seed, dev))
            h = checkpoint(f, params_list[i], h, use_reentrant=False,
                           preserve_rng_state=False)
        else:
            h = layer.apply(params_list[i], h, fmask, True,
                            _dropout_gen(layer, seeds[i], dev))
    h = last.apply_dropout(h, _dropout_gen(last, seeds[-1], dev), True)
    loss = last.compute_loss(params_list[-1], h, y, lmask)
    new_states = net.state_list
    loss = loss + _aux_losses(layers, new_states)
    return loss + _regularization(net, params_list), new_states


def _apply_updates(net, params_list, upd_state, loss_val, iteration,
                   bias_rate: bool = True) -> list:
    """Gradients of ``loss_val`` by ``torch.autograd.grad``, then per layer
    the gradient normalization, the learning-rate policy and the updater,
    run under ``no_grad``; each step is subtracted from its parameter in
    place. With ``bias_rate`` the bias params train at the layer's
    ``bias_learning_rate``; without it every param trains at the layer's
    rate. Returns the new updater state."""
    g = net.conf.global_conf
    keys = [(i, name) for i, p in enumerate(params_list) for name in p]
    flat = [params_list[i][name] for i, name in keys]
    got = torch.autograd.grad(loss_val, flat, allow_unused=True)
    grads = [{} for _ in params_list]
    for (i, name), p, gr in zip(keys, flat, got):
        grads[i][name] = torch.zeros_like(p) if gr is None else gr
    grads = grads_to_param_dtype(grads, params_list)
    new_upd = []
    with torch.no_grad():
        for i, layer in enumerate(net.layers):
            g_i = grads[i]
            if not g_i:
                new_upd.append(upd_state[i])
                continue
            g_i = normalize_gradients(
                g_i, layer.gradient_normalization,
                layer.gradient_normalization_threshold or 1.0)
            spec = _updater_spec(layer)
            lr = effective_lr(layer.learning_rate, g.lr_policy, iteration,
                              g.lr_policy_decay_rate, g.lr_policy_power,
                              g.lr_policy_steps, g.lr_schedule,
                              g.max_num_iterations)
            lr_bias = lr
            if bias_rate and layer.bias_learning_rate is not None:
                lr_bias = torch.tensor(layer.bias_learning_rate,
                                       dtype=torch.float32)
            u_new = {}
            for name, grad in g_i.items():
                this_lr = lr_bias if name in _BIAS_NAMES else lr
                step, ustate = updater_step_with_param(
                    spec, grad, params_list[i][name], upd_state[i][name],
                    this_lr, iteration)
                params_list[i][name].sub_(step)
                u_new[name] = ustate
            new_upd.append(u_new)
    return new_upd


def make_train_step(net):
    """The train step as a plain function:
    ``(params_list, upd_state, x, y, rng, iteration, fmask, lmask) ->
    (upd_state', loss)``.

    Gradients come from ``torch.autograd.grad``; per-layer gradient
    normalization, the learning-rate policy, the separate bias learning rate
    and the updater then run under ``no_grad`` and subtract each step from
    its parameter in place."""

    def train_step(params_list, upd_state, x, y, rng, iteration, fmask=None,
                   lmask=None):
        loss_val, _ = loss_fn(net, params_list, x, y, rng, fmask, lmask)
        new_upd = _apply_updates(net, params_list, upd_state, loss_val,
                                 iteration)
        return new_upd, loss_val.detach()

    return train_step


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
    forward."""
    h = x
    new_rnn = []
    for layer, params, rs in zip(net.layers, params_list, rnn_states):
        if streaming_lstm(layer):
            h, rs = layer.apply_streaming(params, rs, h)
        else:
            h = layer.apply(params, h)
        new_rnn.append(rs)
    return h, new_rnn


def make_tbptt_step(net):
    """The truncated-BPTT step over one chunk as a plain function:
    ``(params_list, upd_state, rnn_states, x, y, rng, iteration, fmask,
    lmask) -> (upd_state', rnn_states', loss)``.

    Streaming LSTM layers run ``apply_streaming`` from the carried state with
    ``mask=fmask`` and hand on their final state detached (the truncation);
    the other layers run their training forward. As in the JAX package's
    TBPTT step, every param, biases included, trains at the layer's
    learning rate: ``bias_learning_rate`` is not read here."""

    def tbptt_step(params_list, upd_state, rnn_states, x, y, rng, iteration,
                   fmask=None, lmask=None):
        layers = net.layers
        seeds = _layer_seeds(len(layers), rng)
        h = x
        new_rnn = []
        for i, layer in enumerate(layers[:-1]):
            if streaming_lstm(layer):
                h, rs = layer.apply_streaming(params_list[i], rnn_states[i], h,
                                              mask=fmask)
                new_rnn.append({k: v.detach() for k, v in rs.items()})
            else:
                h = layer.apply(params_list[i], h, fmask, True,
                                _dropout_gen(layer, seeds[i], x.device))
                new_rnn.append(rnn_states[i])
        last = layers[-1]
        h = last.apply_dropout(h, _dropout_gen(last, seeds[-1], x.device), True)
        loss = last.compute_loss(params_list[-1], h, y, lmask)
        new_rnn.append(rnn_states[-1])
        loss = loss + _aux_losses(layers, net.state_list)
        loss = loss + _regularization(net, params_list)
        new_upd = _apply_updates(net, params_list, upd_state, loss, iteration,
                                 bias_rate=False)
        return new_upd, new_rnn, loss.detach()

    return tbptt_step


class MultiLayerNetwork(nn.Module):
    """Layers built from ``conf`` on ``device`` (``None`` means CUDA)."""

    def __init__(self, conf: MultiLayerConfiguration, device=None):
        super().__init__()
        if conf.global_conf.dtype not in (None, "float32"):
            raise ValueError(f"config dtype {conf.global_conf.dtype!r} is not "
                             "supported by this port yet (ROADMAP.md)")
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
        self._rng.manual_seed((int(seed) * 0x9E3779B1 + 0xD14) % _SEED_RANGE)
        self._init_updater_state()
        self._initialized = True
        return self

    def _init_updater_state(self) -> None:
        self.updater_state = [
            {name: updater_init(_updater_spec(layer), p)
             for name, p in layer.params().items()}
            for layer in self.layers]

    @torch.no_grad()
    def load_params(self, params_list: List[dict]) -> "MultiLayerNetwork":
        """Copy params given per layer by JAX name (numpy arrays or tensors);
        names and shapes must match exactly. The updater state is zeroed
        unless one was loaded already."""
        if len(params_list) != len(self.layers):
            raise ValueError(f"{len(params_list)} param dicts for "
                             f"{len(self.layers)} layers")
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
        if self.updater_state is None:
            self._init_updater_state()
        self._initialized = True
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
        return self

    def _require_init(self) -> None:
        if not self._initialized:
            raise RuntimeError("network is not initialized: call init() or "
                               "load_params() first")

    def set_listeners(self, *listeners) -> None:
        self.listeners = list(listeners)

    def add_listener(self, listener) -> None:
        self.listeners.append(listener)

    @property
    def params_list(self) -> List[dict]:
        return [layer.params() for layer in self.layers]

    @property
    def state_list(self) -> List[dict]:
        return [{} for _ in self.layers]

    # ------------------------------------------------------------------ inference
    def _output_pure(self, params_list, state_list, x: torch.Tensor,
                     mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        h = x
        for layer, params in zip(self.layers, params_list):
            h = layer.apply(params, h, mask)
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

    @torch.no_grad()
    def output(self, x) -> torch.Tensor:
        """Forward pass returning the final activations on this network's
        device."""
        self._require_init()
        return self._output_pure(self.params_list, self.state_list,
                                 self._to_device(x))

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
        h = x
        for layer, p in zip(self.layers[:-1], params[:-1]):
            h = layer.apply(p, h, fmask)
        loss = self.layers[-1].compute_loss(params[-1], h, y, lmask)
        return float(loss + _regularization(self, params))

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

    def _check_trainable(self) -> None:
        """Raise for the training settings this port cannot run yet, naming
        the field, instead of training another model than the config's."""
        g = self.conf.global_conf
        if g.optimization_algo not in (None, "stochastic_gradient_descent"):
            raise NotImplementedError(
                f"optimization_algo={g.optimization_algo!r}: the Solver "
                "algorithms (LBFGS, conjugate gradient, line-search GD) are "
                "not ported yet (ROADMAP.md); use stochastic_gradient_descent")
        if self.conf.pretrain:
            raise NotImplementedError(
                "pretrain=True: layerwise pretraining is not ported yet "
                "(ROADMAP.md)")

    def fit(self, x, y=None, *, epochs: int = 1, fmask=None,
            lmask=None) -> None:
        """Fit on arrays, a ``DataSet``, or an iterable of ``DataSet``\\ s;
        ``epochs`` repeats of one batch run as single steps."""
        from ..datasets.dataset import DataSet

        if y is None and isinstance(x, DataSet):
            self.fit(x.features, x.labels, epochs=epochs,
                     fmask=x.features_mask, lmask=x.labels_mask)
            return
        if y is None and hasattr(x, "__iter__") \
                and not isinstance(x, (np.ndarray, torch.Tensor)):
            self.fit_iterator(x, epochs=epochs)
            return
        for _ in range(epochs):
            self._fit_batch(x, y, fmask, lmask)

    def fit_iterator(self, iterator: Iterable, epochs: int = 1) -> None:
        """Fit from an iterable of ``DataSet``\\ s, batch by batch, for
        ``epochs`` passes (an iterator with ``reset()`` is reset first)."""
        self._check_trainable()
        for _ in range(epochs):
            for listener in self.listeners:
                if hasattr(listener, "on_epoch_start"):
                    listener.on_epoch_start(self)
            if hasattr(iterator, "reset"):
                iterator.reset()
            for ds in iterator:
                self._fit_batch(ds.features, ds.labels, ds.features_mask,
                                ds.labels_mask)
            for listener in self.listeners:
                if hasattr(listener, "on_epoch_end"):
                    listener.on_epoch_end(self)
            self.epoch += 1

    def _uses_tbptt(self) -> bool:
        """Truncated BPTT applies to stacks with an LSTM layer only; any other
        stack flagged ``TruncatedBPTT`` trains with the standard step, as in
        the JAX package."""
        return (self.conf.backprop_type == "TruncatedBPTT"
                and any(isinstance(l, LSTM) for l in self.layers))

    def _fit_batch(self, x, y, fmask=None, lmask=None) -> None:
        self._require_init()
        self._check_trainable()
        if self._uses_tbptt():
            self._fit_tbptt(x, y, fmask, lmask)
            return
        x, y = self._to_device(x), self._to_device(y)
        fmask, lmask = self._to_device(fmask), self._to_device(lmask)
        self.last_batch_size = int(x.shape[0]) if x.ndim else 0
        if self._train_step is None:
            self._train_step = make_train_step(self)
        for _ in range(max(1, self.conf.global_conf.iterations)):
            self.updater_state, loss = self._train_step(
                self.params_list, self.updater_state, x, y, self._next_rng(),
                self.iteration, fmask, lmask)
            self.score_value = loss  # a device scalar, read lazily
            self.iteration += 1
            for listener in self.listeners:
                listener.iteration_done(self, self.iteration)

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
            self.updater_state, rnn_state, loss = self._tbptt_step(
                self.params_list, self.updater_state, rnn_state, x[:, sl],
                y[:, sl], self._next_rng(), self.iteration, fm, lm)
            self.score_value = loss  # a device scalar, read lazily
            self.iteration += 1
            for listener in self.listeners:
                listener.iteration_done(self, self.iteration)

    # ------------------------------------------------------------------ rnn API
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
        (never aliases) of the params, the updater state, the counters, the
        RNG state and the streaming state."""
        dev = self.device if device is None else device
        net = MultiLayerNetwork(copy.deepcopy(self.conf), device=dev)
        with torch.no_grad():
            for own, theirs in zip(self.params_list, net.params_list):
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
