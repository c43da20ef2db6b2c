"""The K-step fused dispatch of both network types.

Counterpart of the JAX package's K-step path: ``make_multistep_train_step``
and ``make_graph_multistep_train_step``, ``fit_iterator(ksteps=)``,
``_fit_epoch_multistep``, ``_dispatch_multistep``, ``_dispatch_staged``,
``_fit_repeated`` and ``_run_multistep``. :class:`KStepFit` is the shell
both networks share, the train step's eager and captured forms included;
each network supplies how its step's arguments are laid out.

The JAX package fuses K train steps into one program (``lax.scan`` over a
``[K, B, ...]`` stack) so that the host pays one dispatch for K steps. On
the card the port's counterpart is a CUDA graph of one train step
(:class:`StepGraph`), replayed once a step with no Python in between but
the copy of the step's batch into the graph's input buffers and the
replay. One capture serves every group of the same batch shapes and
dtypes and the same dtype policy (:func:`~..common.effective_policy_key`
of the config's ``dtype``, as the JAX program cache is keyed), whatever
its length (the ragged tail of an epoch too): the step is captured under
the config's policy, and a policy flip under a config that names none
captures anew, never replaying a graph of another policy. The graphs
of a network share one memory pool, which holds one step's intermediates:
they replay one after another on one stream, each replay's loss is
copied out before the next, and a tensor a step keeps past its end (a
cached constant) is made in the eager warm-up before a capture, outside
the pool. They are captured on one side stream too: the caching allocator
hands a freed block only to the stream that freed it, so a later capture
takes the blocks an earlier one freed instead of growing the pool. On the
CPU a group runs as a plain loop of the network's single step: no graph,
and the params are bitwise those of single steps.

A captured step reads everything from addresses fixed at capture:
- its batch from static input buffers, written before each replay;
- the iteration from a device tensor (the learning-rate policies, the
  momentum schedules and Adam's bias correction read it), which the step
  increments itself; the network writes it before each group;
- the parameters, which the updater changes in place, and the layers'
  running states (batch norm's mean and variance), which the step copies
  into the layers' buffers;
- the updater state, which the step copies into the tensors it was
  captured with (:func:`copy_into`); before a group the network's current
  state is copied there if an eager step or a load replaced it
  (:meth:`StepGraph.adopt`).
With a :class:`~..observability.health.HealthMonitor` attached, the group's
first due step (``due_index``; one check a group, as JAX checks one row of
its stacked group output) replays a second captured step, the health
variant, keyed beside the plain one by the health flag and sharing its
pool, its updater state and (rewritten at each switch) the iteration; the
other steps replay the plain graph, bitwise unmonitored training. Each
group records one ``step`` event in the flight recorder (its first
iteration, ``k``, the batch and the host seconds of its dispatch), times
its dispatch and its listeners into ``dl4j_fit_phase_seconds`` and beats
the watchdog once.

A step draws no random numbers: a network whose layers use dropout, like
one that trains with TBPTT, ``iterations > 1`` or another algorithm than
SGD, takes single steps. A call that replaces the parameters' values or
the updater state from outside (``set_params``, ``load_params``,
``load_state``, ``load_updater_state``) drops the captured graphs.

The first step with new shapes runs eagerly on a side stream (the warm-up
PyTorch asks for before a capture; it is a real step and counts as one),
then the step is captured. A capture that fails raises, naming the
operation that broke it; nothing falls back to single steps. The kernel
wrappers count their launches in Python, which a replay does not run: the
launches the capture recorded are added once a replay.
"""
from __future__ import annotations

import time
import weakref
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from ..common import effective_policy_key
from ..datasets.prefetch import (
    DevicePrefetcher, StagedGroup, consume_staged, stage_to_device)
from ..observability.flight_recorder import global_recorder
from ..observability.health import ParamSnapshot
from ..observability.metrics import global_registry
from ..observability.names import FIT_PHASE_SECONDS
from ..observability.watchdog import beat
from ..ops import _cuda
from ..utils.batching import k_step_groups

# the fit loops' step-time attribution, resolved once: a step pays two
# perf_counter reads and one locked add a phase
_phase_hist = global_registry().histogram(
    FIT_PHASE_SECONDS,
    "host wall seconds per fit-loop phase (staging: host cast+transfer "
    "submit, or with device prefetch the visible wait for the staged batch; "
    "dispatch: the step's or the group's launches; listeners: callback "
    "overhead)")
t_staging = _phase_hist.labels(phase="staging")
t_dispatch = _phase_hist.labels(phase="dispatch")
t_listeners = _phase_hist.labels(phase="listeners")

#: every live captured step, for the flight recorder's bundle
_LIVE_GRAPHS: "weakref.WeakSet[StepGraph]" = weakref.WeakSet()


def live_graphs() -> list:
    """The captured train steps alive in the process."""
    return list(_LIVE_GRAPHS)


def _tensors(out) -> list:
    return list(out) if isinstance(out, tuple) else [out]


def copy_into(dst, src) -> None:
    """Copy ``src``'s tensors into ``dst``'s in place; both have the same
    nesting of lists and dicts (a tensor that is already ``dst``'s is
    skipped)."""
    if isinstance(dst, dict):
        for k, v in dst.items():
            copy_into(v, src[k])
    elif isinstance(dst, (list, tuple)):
        for d, s in zip(dst, src):
            copy_into(d, s)
    elif dst is not src:
        dst.copy_(src)


def _stage_host(a, dtype):
    """Features cast to ``dtype`` before the copy to the device: on the host
    for host data (half the bytes on the wire for bfloat16), on the device
    for a tensor already there."""
    if dtype is None:
        return a
    if not isinstance(a, torch.Tensor):
        a = torch.from_numpy(np.array(a))
    return a.to(dtype)


def _widened(a: torch.Tensor) -> torch.Tensor:
    """Features staged in a narrower float dtype back in float32, the dtype
    the port computes in, on the device. The staging's rounding stays, as in
    JAX, where the first float32 operation promotes them."""
    if a.is_floating_point() and a.dtype != torch.float32:
        return a.float()
    return a


class StepGraph:
    """One train step, captured once and replayed once a step.

    ``make_body(xs, ys, iteration, state)`` returns the step as a function
    of no arguments: it reads its batch from ``xs`` and ``ys`` (the static
    buffers, one per network input and label array) and the iteration from
    ``iteration`` (a device int64 scalar it increments), updates ``state``
    (the updater state) in place and returns the loss (with ``health``,
    the loss and the packed health summary). The graph is captured on
    ``stream`` into ``pool``, the side stream and the memory pool the
    network's graphs share."""

    def __init__(self, make_body: Callable, xs: List[torch.Tensor],
                 ys: List[torch.Tensor], state, pool, stream,
                 health: bool = False):
        self.health = health
        self.inputs = [torch.empty_like(t) for t in xs + ys]
        self.iteration = torch.zeros((), dtype=torch.int64,
                                     device=xs[0].device)
        self.state = state
        self.pool = pool
        self.stream = stream
        self.body = make_body(self.inputs[:len(xs)], self.inputs[len(xs):],
                              self.iteration, state)
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        #: the replay's output buffers: the loss, or (loss, packed summary)
        self.out = None
        #: launches of each kernel wrapper in one replay
        self.per_replay: Dict[object, int] = {}
        #: replays run so far
        self.replays = 0
        #: device memory the shared pool grew by at this capture (the step's
        #: intermediates, which the allocator's statistics of allocated
        #: bytes do not count between replays)
        self.pool_bytes = 0
        _LIVE_GRAPHS.add(self)

    def describe(self) -> dict:
        """Host facts of the capture (no device read): shapes, variant,
        launches a replay by kernel, replays, pool bytes."""
        return {"shapes": [list(t.shape) for t in self.inputs],
                "health": self.health, "captured": self.graph is not None,
                "per_replay": {fn.__name__: n
                               for fn, n in self.per_replay.items()},
                "replays": self.replays, "pool_bytes": self.pool_bytes}

    def adopt(self, current_state, iteration: int):
        """Before a group: copy the updater state the network holds into the
        captured tensors (when an eager step or a load replaced them) and
        write the iteration. Returns the state the network holds from now
        on."""
        if current_state is not self.state:
            with torch.no_grad():
                copy_into(self.state, current_state)
        self.iteration.fill_(iteration)
        return self.state

    def step(self, batch: List[torch.Tensor]):
        """One train step on ``batch`` (device tensors of the captured
        shapes); the returned loss (and summary) is overwritten by the next
        replay."""
        for dst, src in zip(self.inputs, batch):
            dst.copy_(src)
        if self.graph is None:
            return self._warm_up_and_capture()
        self.graph.replay()
        self.replays += 1
        for fn, n in self.per_replay.items():
            _cuda.count(fn, n)
        return self.out

    def _warm_up_and_capture(self):
        main = torch.cuda.current_stream()
        side = torch.cuda.Stream()
        side.wait_stream(main)
        with torch.cuda.stream(side):
            warm = self.body()
        main.wait_stream(side)
        for t in _tensors(warm):
            t.record_stream(main)
        # the warm-up's cached blocks go back to the card before the graph
        # takes memory for the shared pool
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved()
        graph = torch.cuda.CUDAGraph()
        stream = self.stream
        try:
            # thread-local: the prefetcher's thread keeps staging meanwhile;
            # the launches on the capture's stream go to its record, not to
            # the counts
            with _cuda.capturing(stream) as recorded, \
                    torch.cuda.graph(graph, pool=self.pool, stream=stream,
                                     capture_error_mode="thread_local"):
                out = self.body()
        except RuntimeError as e:
            raise RuntimeError(
                "capturing the train step as a CUDA graph failed (an "
                "operation of the step cannot be captured; a host sync such "
                f"as .item(), .tolist() or .cpu() is the usual cause): {e}"
            ) from e
        self.per_replay = {fn: n for fn, n in recorded.items() if n}
        self.graph, self.out = graph, out
        self.pool_bytes = torch.cuda.memory_reserved() - reserved
        return warm


class KStepFit:
    """The K-step shell of ``MultiLayerNetwork`` and ``ComputationGraph``.

    A network supplies ``_group_arrays(ds)`` (its inputs and labels as lists
    of host arrays, or None for a dataset that takes a single step),
    ``_fit_dataset(ds)`` and ``_fit_arrays(xs, ys)`` (its single-step
    path), ``_train_call(xs, ys, rng, iteration, upd, fmasks, lmasks)`` (its
    train step on device tensors, returning ``(upd', states', loss)``),
    ``_write_states(states)``, ``_next_rng()``, ``_uses_tbptt()`` and
    ``_layer_modules()``.
    """

    #: train steps a group in ``fit_iterator`` and ``fit(epochs=k)``; 1
    #: turns the K-step path off
    dispatch_ksteps: int = 8
    #: torch dtype features are cast to on the host before the copy to the
    #: device (labels stay as they are); None keeps them as given
    stage_dtype = None
    #: groups staged ahead of the steps by the prefetcher's thread; <= 0
    #: stages inline
    prefetch_depth: int = 2
    #: the last K-step epoch's :class:`DevicePrefetcher` (its counters)
    prefetcher: Optional[DevicePrefetcher] = None
    #: the ``path`` label of the prefetcher's series
    _prefetch_path = "multilayer"
    #: host seconds of the last K-step group's dispatch
    last_dispatch_s = 0.0
    #: the memory pool and the capture stream the network's captured steps
    #: share
    _graph_pool = None
    _capture_stream = None
    #: the attached ``observability.health.HealthMonitor`` (or None): the
    #: fit loops run the health variant of the step when it is due
    health_monitor = None
    #: the health variant's copy of the parameters before the update
    _param_snapshot: Optional[ParamSnapshot] = None

    def _multistep_ok(self, k: int) -> bool:
        """The JAX eligibility rule (SGD, ``iterations <= 1``, no TBPTT)
        plus no dropout: a captured step would draw the same mask every
        replay."""
        g = self.conf.global_conf
        return (k > 1
                and g.optimization_algo in (None,
                                            "stochastic_gradient_descent")
                and g.iterations <= 1 and not self._uses_tbptt()
                and not any(l.uses_dropout() for l in self._layer_modules()))

    def _drop_step_graphs(self) -> None:
        self._step_graphs = {}
        self._graph_pool = self._capture_stream = None

    def _own_step(self) -> bool:
        """False while a parallel mode's step is installed as
        ``_train_call``: that fit records its own step events and is not
        monitored, as the JAX package's parallel steps are not."""
        return "_train_call" not in vars(self)

    def _monitor(self):
        """The attached health monitor, where the step is the network's."""
        return self.health_monitor if self._own_step() else None

    def _snapshot_params(self, params) -> torch.Tensor:
        """The parameters before a monitored step's update, in the flat
        buffer the health variant owns (:class:`ParamSnapshot`)."""
        if self._param_snapshot is None:
            self._param_snapshot = ParamSnapshot()
        return self._param_snapshot.take(params)

    # ---------------------------------------------------------- the step
    def _eager_step(self, xs: list, ys: list, iteration, fmasks=None,
                    lmasks=None, health: bool = False):
        """One train step on device tensors, the layer states written;
        returns the loss, and with ``health`` the packed health summary
        too."""
        kw = {"health": True} if health else {}
        out = self._train_call(xs, ys, self._next_rng(), iteration,
                               self.updater_state, fmasks, lmasks, **kw)
        self.updater_state, new_states, loss = out[:3]
        self._write_states(new_states)
        return (loss, out[3]) if health else loss

    def _step_body(self, xs: list, ys: list, iteration: torch.Tensor, state,
                   health: bool = False):
        """The train step as :class:`StepGraph` captures it: no seed, the
        updater state copied into ``state``, the iteration incremented on
        the device; with ``health`` it also returns the packed summary."""
        kw = {"health": True} if health else {}

        def body():
            out = self._train_call(xs, ys, None, iteration, state, **kw)
            new_upd, new_states, loss = out[:3]
            with torch.no_grad():
                copy_into(state, new_upd)
                self._write_states(new_states)
                iteration.add_(1)
            return (loss, out[3]) if health else loss

        return body

    def _single_steps(self, xs: list, ys: list, fmasks=None,
                      lmasks=None) -> None:
        """``iterations`` eager steps on one batch of device tensors, each
        the health variant when the monitor is due, with its step event,
        phase times and heartbeat, as the JAX ``_fit_batch``."""
        cls = type(self).__name__
        for _ in range(max(1, self.conf.global_conf.iterations)):
            hm = self._monitor()
            use_health = hm is not None and hm.due(self.iteration)
            name = "train_step_health" if use_health else "train_step"
            t0 = time.perf_counter()
            loss = self._eager_step(xs, ys, self.iteration, fmasks, lmasks,
                                    health=use_health)
            dt = time.perf_counter() - t0
            t_dispatch.observe(dt)
            if use_health:
                loss, packed = loss
                hm.offer(packed, self.iteration)
            global_recorder().record(
                "step", path=f"{cls}.{name}", it=self.iteration,
                batch=self.last_batch_size, dispatch_s=dt)
            self.score_value = loss  # a device scalar, read lazily
            self.iteration += 1
            with t_listeners.time():
                for listener in self.listeners:
                    listener.iteration_done(self, self.iteration)
            beat(self.iteration)

    def _chunk_done(self, loss) -> None:
        """After a TBPTT chunk's step: its event, the listeners, a beat."""
        global_recorder().record(
            "step", path=f"{type(self).__name__}.tbptt_step",
            it=self.iteration, batch=self.last_batch_size)
        self.score_value = loss  # a device scalar, read lazily
        self.iteration += 1
        for listener in self.listeners:
            listener.iteration_done(self, self.iteration)
        beat(self.iteration)

    # ------------------------------------------------------------ fit loops
    def fit_iterator(self, iterator, epochs: int = 1,
                     ksteps: Optional[int] = None) -> None:
        """Fit from an iterable of datasets for ``epochs`` passes (an
        iterator with ``reset()`` is reset first). With ``ksteps`` (default
        ``dispatch_ksteps``) above 1 on an eligible network, same-shape
        unmasked batches run in groups of up to ``ksteps`` steps, staged
        ahead by a :class:`DevicePrefetcher`; masked batches, a group of
        one and an ineligible network take single steps. Listeners see
        every iteration. A config with ``pretrain`` set runs the layerwise
        pretraining (``pretrain``) over the iterator first, each epoch, as
        the JAX package does."""
        k = self.dispatch_ksteps if ksteps is None else max(1, ksteps)
        multistep = self._multistep_ok(k)
        for _ in range(epochs):
            for listener in self.listeners:
                if hasattr(listener, "on_epoch_start"):
                    listener.on_epoch_start(self)
            if hasattr(iterator, "reset"):
                iterator.reset()
            if self.conf.pretrain:
                self.pretrain(iterator)
                if hasattr(iterator, "reset"):
                    iterator.reset()
            if multistep:
                self._fit_epoch_multistep(iterator, k)
            else:
                for ds in iterator:
                    self._fit_dataset(ds)
            for listener in self.listeners:
                if hasattr(listener, "on_epoch_end"):
                    listener.on_epoch_end(self)
            self.epoch += 1

    def _fit_epoch_multistep(self, iterator, k: int) -> None:
        self._require_init()
        stream = (torch.cuda.Stream(self.device)
                  if self.device.type == "cuda" else None)

        def stage(kind_item):
            # producer thread: stack, cast and start the copy of a group
            kind, item = kind_item
            if kind != "group" or len(item) < 2:
                return kind_item
            return "staged", stage_to_device(item, self.device,
                                             self.stage_dtype, stream)

        groups = k_step_groups(iterator, k, self._group_arrays)
        with DevicePrefetcher(groups, stage, depth=self.prefetch_depth,
                              path=self._prefetch_path,
                              wait_series=t_staging) as pf:
            self.prefetcher = pf
            for kind, item in pf:
                if kind == "single":
                    self._fit_dataset(item)
                elif kind == "group":
                    self._fit_arrays(*item[0])
                else:
                    self._dispatch_staged(item)

    def _dispatch_multistep(self, batches: list) -> None:
        """A pre-built group of ``(inputs, labels)`` host arrays, staged
        inline (the prefetcher's depth-0 behaviour)."""
        if not batches:
            return
        if len(batches) == 1:
            self._fit_arrays(*batches[0])
            return
        with t_staging.time():
            group = stage_to_device(batches, self.device, self.stage_dtype)
        self._dispatch_staged(group)

    def _dispatch_staged(self, group: StagedGroup) -> None:
        """Run a group whose ``[K, B, ...]`` stacks are on the device (or on
        their way there: the steps wait on the copy's event)."""
        consume_staged(group)
        self.last_batch_size = int(group.xs[0].shape[1])
        xs = [_widened(x) for x in group.xs]
        steps = [([x[j] for x in xs], [y[j] for y in group.ys])
                 for j in range(group.n)]
        self._after_group(self._run_group(steps))

    def _fit_repeated(self, xs: list, ys: list, epochs: int) -> None:
        """``epochs`` steps on one batch, ``dispatch_ksteps`` a group, the
        batch moved to the device once."""
        with t_staging.time():
            xd = [_widened(self._to_device(_stage_host(a, self.stage_dtype)))
                  for a in xs]
            yd = [self._to_device(a) for a in ys]
        self.last_batch_size = int(xd[0].shape[0]) if xd[0].ndim else 0
        remaining = epochs
        while remaining > 0:
            k = min(self.dispatch_ksteps, remaining)
            self._after_group(self._run_group([(xd, yd)] * k))
            remaining -= k

    def _run_group(self, steps: list) -> torch.Tensor:
        """The steps of a group, each ``(inputs, labels)`` device tensors;
        returns their losses ``[n]``. The group's first due step (if a
        monitor is attached) is the health variant, whose summary is
        offered to the monitor; the group records one step event. The
        iteration advances after the group (:meth:`_after_group`)."""
        self._require_init()
        n = len(steps)
        hm = self._monitor()
        due = hm.due_index(self.iteration, n) if hm is not None else None
        losses = torch.empty(n, dtype=torch.float32, device=self.device)
        t0 = time.perf_counter()
        if self.device.type != "cuda":
            for j, (xs, ys) in enumerate(steps):
                out = self._eager_step(xs, ys, self.iteration + j,
                                       health=j == due)
                if j == due:
                    out, packed = out
                    hm.offer(packed, self.iteration + j)
                losses[j] = out
        else:
            xs0, ys0 = steps[0]
            key = (tuple((tuple(t.shape), t.dtype) for t in xs0 + ys0),
                   effective_policy_key(self.conf.global_conf.dtype))
            current = None
            for j, (xs, ys) in enumerate(steps):
                sg = self._step_graph(key, j == due, xs0, ys0)
                if sg is not current:
                    # the graphs share the updater state; each keeps its own
                    # device iteration, written at each switch
                    self.updater_state = sg.adopt(self.updater_state,
                                                  self.iteration + j)
                    current = sg
                self._next_rng()  # the seed stream advances as in single steps
                out = sg.step(xs + ys)
                if j == due:
                    # the summary is copied out now: the next health replay
                    # overwrites its buffer
                    out, packed = out
                    hm.offer(packed, self.iteration + j)
                losses[j].copy_(out)
        dt = self.last_dispatch_s = time.perf_counter() - t0
        t_dispatch.observe(dt)
        if self._own_step():
            name = "multistep" if due is None else "multistep_health"
            global_recorder().record(
                "step", path=f"{type(self).__name__}.{name}",
                it=self.iteration, k=n, batch=self.last_batch_size,
                dispatch_s=dt)
        return losses

    def _step_graph(self, key, health: bool, xs0, ys0) -> StepGraph:
        """The captured step (plain or health variant) for ``key``, made at
        first use in the network's shared pool."""
        sg = self._step_graphs.get((key, health))
        if sg is None:
            if self._graph_pool is None:
                self._graph_pool = torch.cuda.graph_pool_handle()
                self._capture_stream = torch.cuda.Stream(self.device)
            sg = self._step_graphs[(key, health)] = StepGraph(
                lambda *a: self._step_body(*a, health=health), xs0, ys0,
                self.updater_state, self._graph_pool, self._capture_stream,
                health=health)
        return sg

    def _after_group(self, losses: torch.Tensor) -> None:
        """The iteration advanced once a step, each step's loss kept (read
        from the device only when asked for), the listeners called once an
        iteration and the watchdog beaten once a group."""
        from ..optimize.listeners import fire_iteration_done
        with t_listeners.time():
            for j in range(losses.shape[0]):
                self.iteration += 1
                self.score_value = losses[j]
                fire_iteration_done(self, self.iteration)
        beat(self.iteration)
