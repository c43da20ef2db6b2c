"""``PipelineTrainer``: train a network config through the GPipe executor.

Counterpart of ``deeplearning4j_tpu/parallel/pipeline_trainer.py``. Hand a
``MultiLayerNetwork`` (``models.transformer_lm``, say) to
``PipelineTrainer`` and ``fit()`` runs the homogeneous middle of the stack,
the longest run of equal layer configs (:func:`find_block_run`), as
pipeline stages over the mesh's ``stage`` axis (``pipeline.py``), while the
layers around it run as in single-device training. The updaters,
schedules, clipping, regularization and the other layers' aux losses are
the network's own, so a pipelined step equals a single-device step on the
same batch.

The port is SPMD, one stage a rank. How a step splits over the ranks:

* The layers before the run (the embedding) run on every rank, as JAX runs
  them replicated; stage 0 feeds their output to the pipeline, so only
  stage 0's backward reaches them.
* The layers after the run and the loss run on the last stage alone, on the
  pipeline's output, which only that stage holds; their new states (none
  in the LMs) are then broadcast from it.
* Each rank's objective is its share of the loss: the last stage's holds
  the loss, the aux losses and the regularization of every layer outside
  the run; each stage's holds the regularization of its own blocks. The
  gradients of the layers outside the run are summed over the stage group
  (one ``all_reduce``), which gives each the gradient single-device
  training gives it, once; a block's gradient is whole on its stage.
  The reported score is the shares' sum.

Between steps each stage keeps only its own blocks' params and updater
state: the other blocks' tensors give their storage back (``fit`` starts
so), and ``fit`` ends with every leaf whole on every rank, broadcast from
the stage that owns it. A sharded checkpoint taken by a listener between
steps saves each block from its owner (:meth:`PipelineTrainer.
checkpoint_entry`). A listener that reads whole params or updater state
(a zip checkpoint, the param log) fires inside a whole view: each block
broadcast from its owner to every stage, the storage given back after.
Each step records a ``step`` event in the flight recorder, is timed into
``dl4j_fit_phase_seconds`` and beats the watchdog; the handoffs and the
gradients' all-reduce add their bytes to ``dl4j_collective_bytes_total``
(``compile_seam.stats()`` reads them back); ``fit`` dumps the recorder once on an
unhandled exception. The JAX module's compile tracker waits for A9.4.
"""
from __future__ import annotations

import time
from collections import Counter
from typing import Optional

import torch
import torch.distributed as dist

from ..common import wrap_with_policy
from ..datasets.prefetch import DevicePrefetcher
from ..nn.ksteps import t_dispatch, t_listeners, t_staging
from ..observability.flight_recorder import dump_on_unhandled, global_recorder
from ..observability.watchdog import beat
from ..optimize.listeners import fire_iteration_done
from .compile_seam import WholeViews, count_collective, free_storage
from .mesh import Mesh, build_mesh, world
from .pipeline import PipelineParallel


def find_block_run(layers) -> tuple:
    """``(i0, i1)``: the longest run of consecutive equal layer configs,
    the pipeline-able stack. The final (loss) layer never joins it."""
    best = (0, 0)
    i = 0
    n = len(layers) - 1  # the loss layer stays out
    while i < n:
        j = i + 1
        while j < n and layers[j] == layers[i]:
            j += 1
        if j - i > best[1] - best[0]:
            best = (i, j)
        i = j
    return best


def _storage_restore(t: torch.Tensor) -> None:
    t.untyped_storage().resize_(t.numel() * t.element_size())


class PipelineTrainer(WholeViews):
    """GPipe training for configs with a homogeneous block stack.

    ``n_microbatches`` trades the bubble share ``(S-1)/(S+M-1)`` for the
    size of a tick's activation. Blocks must be stateless and free of
    dropout (the pipeline threads no per-block state or draws); everything
    else of the config behaves as in single-device ``fit``."""

    #: batches staged ahead of the step loop (0 stages inline)
    prefetch_depth: int = 2

    def __init__(self, net, mesh: Optional[Mesh] = None,
                 n_stages: Optional[int] = None, axis_name: str = "stage",
                 n_microbatches: int = 4):
        self.net = net
        conf = net.conf
        if not hasattr(conf, "layers"):
            raise ValueError("PipelineTrainer trains a MultiLayerNetwork "
                             "(a list of layers)")
        self.mesh = mesh or build_mesh({axis_name: n_stages or world()[1]})
        self.axis_name = axis_name
        self.n_stages = self.mesh.shape[axis_name]
        i0, i1 = find_block_run(conf.layers)
        if i1 - i0 < 2:
            raise ValueError("config has no homogeneous block stack to "
                             "pipeline (need >= 2 identical consecutive "
                             "layer configs)")
        if (i1 - i0) % self.n_stages:
            raise ValueError(f"{i1 - i0} pipeline blocks not divisible by "
                             f"{self.n_stages} stages")
        if conf.layers[i0].get("dropout"):
            raise ValueError("pipelined blocks must be dropout-free")
        block = net.layers[i0]
        if block.init_state():
            # MoETransformerBlock: its aux_loss state would be dropped by
            # the stateless pipeline body, and training would lose the
            # Switch load-balance term with no error
            raise ValueError("pipelined blocks must be stateless "
                             f"({type(block).__name__} publishes state)")
        for i in range(i0, i1):
            if conf.preprocessor(i) is not None:
                raise ValueError("preprocessors inside the pipelined block "
                                 "run are not supported")
        self.block_range = (i0, i1)
        self._block = block

        def block_fn(p, x):
            return block.apply(p, x, None, True, None)

        if conf.global_conf.gradient_checkpointing:
            # the contract of multilayer.loss_fn: the backward recomputes
            # each block's forward instead of holding its activations
            from torch.utils.checkpoint import checkpoint
            plain = block_fn

            def block_fn(p, x):
                return checkpoint(plain, p, x, use_reentrant=False,
                                  preserve_rng_state=False)

        self.pipe = PipelineParallel(self.mesh, block_fn, n_blocks=i1 - i0,
                                     axis_name=axis_name,
                                     n_microbatches=n_microbatches)
        #: layer indices of this stage's blocks
        self.own = [i0 + b for b in self.pipe.own_blocks()]
        self.counts: Counter = Counter()

    # ---------------------------------------------------------------- layout
    def _others(self) -> list:
        """Indices of the blocks other stages own."""
        i0, i1 = self.block_range
        return [i for i in range(i0, i1) if i not in self.own]

    def _owner(self, i: int) -> int:
        """The global rank of the stage that owns block ``i``."""
        stage = (i - self.block_range[0]) // self.pipe.blocks_per_stage
        return self.pipe.ranks[stage]

    def _block_tensors(self, i: int,
                       parts=("params", "updater")) -> list:
        """Block ``i``'s params and/or updater-state slots, in one order on
        every rank."""
        net = self.net
        out = []
        if "params" in parts:
            params = net.params_list[i]
            out += [params[k] for k in sorted(params)]
        if "updater" in parts:
            upd = net.updater_state[i]
            for k in sorted(upd):
                out += [upd[k][s] for s in sorted(upd[k])]
        return out

    @torch.no_grad()
    def _release(self) -> None:
        """Keep only this stage's blocks: the others give their storage
        back."""
        for i in self._others():
            for t in self._block_tensors(i):
                free_storage(t)

    @torch.no_grad()
    def _gather(self, parts=("params", "updater"),
                site: str = "pipeline_gather") -> int:
        """Every block (its ``parts``) whole again on every rank, from its
        owner; returns the bytes this rank received."""
        group = self.pipe.group
        got = 0
        for i in range(*self.block_range):
            src = self._owner(i)
            for t in self._block_tensors(i, parts):
                if i not in self.own:
                    _storage_restore(t)
                    got += t.numel() * t.element_size()
                if group is not None:
                    dist.broadcast(t, src, group=group)
                    count_collective("broadcast", site,
                                     t.numel() * t.element_size())
        return got

    # -- the whole view between steps
    def held_parts(self) -> frozenset:
        return frozenset(("params", "updater") if self._others() else ())

    def _view_in(self, parts) -> int:
        return self._gather(tuple(sorted(parts)), "pipeline_view")

    @torch.no_grad()
    def _view_out(self, parts) -> None:
        for i in self._others():
            for t in self._block_tensors(i, tuple(sorted(parts))):
                free_storage(t)

    def checkpoint_entry(self, key, name, t: torch.Tensor, slot):
        """What a sharded checkpoint saves of a leaf or an updater slot
        between steps: a block of the stack only on the stage that owns
        it (None elsewhere), every other leaf whole."""
        i0, i1 = self.block_range
        if i0 <= key < i1 and key not in self.own:
            return None
        return "", t

    def held_bytes(self) -> int:
        """Bytes of block params this rank holds now."""
        i0, i1 = self.block_range
        return sum(p.untyped_storage().nbytes()
                   for i in range(i0, i1)
                   for p in self.net.params_list[i].values())

    def stats(self) -> dict:
        """Steps, the whole views given to listeners and their bytes, the
        handoff route and the pipeline's counters (the bytes the handoffs
        and the all-reduce moved are ``compile_seam.stats()``'s series)."""
        return {**dict(self.counts), **self.view_stats(),
                **self.pipe.stats()}

    # ------------------------------------------------------------------ loss
    def _pipeline_loss(self, params_list, state_list, x, y, rng):
        """``multilayer.loss_fn`` with the block run executed as a
        pipeline: ``(this rank's share of the loss, new states, the
        pipeline's output)``."""
        from ..nn.multilayer import (
            _aux_losses, _dropout_gen, _layer_seeds, _pre, _regularization)

        net = self.net
        layers = net.layers
        n = len(layers)
        i0, i1 = self.block_range
        last = layers[-1]
        remat = net.conf.global_conf.gradient_checkpointing
        seeds = _layer_seeds(n, rng)
        dev = x.device

        def apply_one(i, h):
            h = _pre(net, i, h)
            layer = layers[i]
            if remat:
                from torch.utils.checkpoint import checkpoint

                def f(p, s, hh, _layer=layer, _seed=seeds[i]):
                    return _layer.apply_with_state(
                        p, s, hh, None, True,
                        _dropout_gen(_layer, _seed, dev))
                return checkpoint(f, params_list[i], state_list[i], h,
                                  use_reentrant=False,
                                  preserve_rng_state=False)
            return layer.apply_with_state(params_list[i], state_list[i], h,
                                          None, True,
                                          _dropout_gen(layer, seeds[i], dev))

        h = x
        new_states = []
        for i in range(i0):
            h, ns = apply_one(i, h)
            new_states.append(ns)
        out = self.pipe.run([params_list[i] for i in self.own], h)
        new_states.extend(state_list[i0:i1])
        own_reg = [params_list[i] if i in self.own else {}
                   for i in range(n)]
        if not self.pipe.is_last:
            new_states.extend(state_list[i1:])
            return _regularization(net, own_reg), new_states, out
        h = out
        for i in range(i1, n - 1):
            h, ns = apply_one(i, h)
            new_states.append(ns)
        h = _pre(net, n - 1, h)
        h = last.apply_dropout(h, _dropout_gen(last, seeds[-1], dev), True)
        loss = last.compute_loss(params_list[-1], h, y, None)
        new_states.append(state_list[-1])
        loss = loss + _aux_losses(layers, new_states)
        outside = [{} if i0 <= i < i1 else params_list[i] for i in range(n)]
        loss = loss + _regularization(net, outside)
        return loss + _regularization(net, own_reg), new_states, out

    # ------------------------------------------------------------------ step
    def _step(self, x, y, rng, iteration) -> torch.Tensor:
        """One pipelined train step: the update done in place, the states
        written; returns the loss."""
        from ..nn.multilayer import UPDATER_LABEL, update_layer, write_states
        from ..nn.updaters import grads_to_param_dtype

        net = self.net
        i0, i1 = self.block_range
        params = net.params_list
        states = net.state_list
        loss, new_states, out = self._pipeline_loss(params, states, x, y, rng)
        live = [i for i in range(len(params))
                if not (i0 <= i < i1) or i in self.own]
        keys = [(i, k) for i in live for k in params[i]]
        flat = [params[i][k] for i, k in keys]
        roots, seeds = [], []
        if loss.requires_grad:
            roots, seeds = [loss], [torch.ones_like(loss)]
        if not self.pipe.is_last:
            # the pipeline's backward is a collective on every stage: its
            # output joins the graph with a zero gradient where the loss
            # does not read it
            roots.append(out)
            seeds.append(torch.zeros_like(out))
        got = torch.autograd.grad(roots, flat, seeds, allow_unused=True)
        grads = [{} for _ in params]
        for (i, k), p, g in zip(keys, flat, got):
            grads[i][k] = torch.zeros_like(p) if g is None else g
        grads = grads_to_param_dtype(grads, params)
        group = self.pipe.group
        outside = [i for i in live if not (i0 <= i < i1)]
        with torch.no_grad():
            if group is not None:
                # the layers outside the run: each stage's share summed
                whole = [grads[i][k] for i in outside for k in grads[i]]
                if whole:
                    buf = torch.cat([g.reshape(-1).to(torch.float32)
                                     for g in whole])
                    dist.all_reduce(buf, group=group)
                    count_collective("all_reduce", "pipeline_grad",
                                     buf.numel() * buf.element_size())
                    at = 0
                    for g in whole:
                        g.copy_(buf[at:at + g.numel()].view(g.shape))
                        at += g.numel()
                loss = loss.detach().clone()
                dist.all_reduce(loss, group=group)
                for i in range(i1, len(params)):
                    for k in sorted(new_states[i]):
                        t = new_states[i][k]
                        if isinstance(t, torch.Tensor):
                            dist.broadcast(t, self.pipe.ranks[-1],
                                           group=group)
            g = net.conf.global_conf
            with torch.profiler.record_function(UPDATER_LABEL):
                for i in live:
                    if grads[i]:
                        net.updater_state[i] = update_layer(
                            g, net.layers[i], params[i], grads[i],
                            net.updater_state[i], iteration)
        write_states(net.layers, new_states)
        self.counts["steps"] += 1
        return loss.detach()

    # ------------------------------------------------------------------- fit
    @dump_on_unhandled("PipelineTrainer.fit")
    def fit(self, iterator, epochs: int = 1) -> None:
        """Every batch runs one pipelined train step; listeners fire once an
        iteration. The next batch is staged on the producer thread of a
        :class:`DevicePrefetcher` while the current step runs. A masked
        batch raises (the pipeline threads no masks), after every earlier
        batch has trained."""
        net = self.net
        net._require_init()

        def stage(ds):
            if (getattr(ds, "features_mask", None) is not None
                    or getattr(ds, "labels_mask", None) is not None):
                raise ValueError("PipelineTrainer does not support "
                                 "masked batches; use net.fit()")
            return net._to_device(ds.features), net._to_device(ds.labels)

        step = wrap_with_policy(self._step, net.conf.global_conf.dtype)
        net._drop_step_graphs()
        self._release()
        # what a sharded checkpoint saves from between steps
        # (utils/sharded_checkpoint.py): this stage's blocks
        net._held_sharding = self
        try:
            for _ in range(epochs):
                if hasattr(iterator, "reset"):
                    iterator.reset()
                with DevicePrefetcher(iterator, stage,
                                      depth=self.prefetch_depth,
                                      path="pipeline",
                                      wait_series=t_staging) as pf:
                    for x, y in pf:
                        net.last_batch_size = (int(x.shape[0]) if x.ndim
                                               else 0)
                        t0 = time.perf_counter()
                        loss = step(x, y, net._next_rng(), net.iteration)
                        dt = time.perf_counter() - t0
                        t_dispatch.observe(dt)
                        global_recorder().record(
                            "step", path="PipelineTrainer.train_step",
                            it=net.iteration, batch=net.last_batch_size,
                            dispatch_s=dt)
                        net.score_value = loss
                        net.iteration += 1
                        with t_listeners.time():
                            fire_iteration_done(net, net.iteration)
                        beat(net.iteration)
        finally:
            net._held_sharding = None
            self._gather()
