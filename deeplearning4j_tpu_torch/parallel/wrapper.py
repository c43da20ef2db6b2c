"""``ParallelWrapper``: data-parallel training over a mesh of ranks.

Counterpart of ``deeplearning4j_tpu/parallel/wrapper.py`` (DL4J's
``ParallelWrapper``). The port is SPMD: every rank runs the same
``ParallelWrapper(...).fit(iterator)`` over an iterator that yields the same
global batches on every rank (the JAX package's multi-process contract,
its ``_stage``), and takes its own rows of each; under sequence parallelism
it takes its block of the time axis too. Without a process group it is a
group of one.

* ``averaging_frequency == 1``, synchronous DP: each step is the seam's
  ``"jit"`` step (``compile_seam.py``): the rank's loss, its gradients
  averaged over the batch's ranks, the update. Same-shape unmasked batches
  run in groups of ``dispatch_ksteps`` (the JAX ``sync_multistep``), on the
  card through the network's K-step CUDA graph with the NCCL collectives
  inside the capture (the eager warm-up step before the capture creates the
  communicators). On the CPU a group is a loop of eager steps; under ZeRO
  (a param's storage is resized between steps) and over gloo on the card
  (its collectives run on the host) it takes single steps. ``shard_optimizer_state`` (ZeRO-1), ``shard_parameters`` (FSDP)
  and ``sharding("zero3")`` split leaves over ``data`` by the ``zero3``
  rules: a sharded leaf is updated on this rank's block, and a sharded
  param keeps only its block between steps (``compile_seam.Sharding``;
  ``fit`` ends with every leaf whole on every rank).
* The batches the sharded step does not cover run whole on every rank
  with the network's own step and no collective, which keeps the ranks
  equal: masked batches, ``iterations > 1``, TBPTT, a Solver algorithm,
  and a global batch the data axis does not divide (JAX replicates it,
  ``partition.batch_spec``).
* ``averaging_frequency == N > 1``, local SGD: each rank updates on its
  rows (the seam's ``"shard_map"`` step), and every N steps the params,
  the layers' states and (``average_updaters``) the updater state are
  averaged over the ranks; ``fit`` ends with an average.

* ``expert_parallel(axis="data", capacity_factor)``: the MoE layers run
  the all_to_all dispatch of ``moe.py`` over the data axis (the tokens'
  axis doubles as the experts' axis), in the synchronous step.
* ``sharding("dp_tp")`` on a ``{data, model}`` mesh: the rows split over
  ``data`` only, each leaf the ``dp_tp`` rules split held as this rank's
  block over ``model`` and used by the layers' Megatron pairs or gathered
  at use (``tensor_parallel.py``); gradients averaged over ``data``.

Both take single steps (no K-step capture), as ZeRO does.

Telemetry as in the JAX wrapper: each single step, K-step group and local
step records a ``step`` event (its path, iteration, batch, host seconds of
the dispatch and the gradients' all-reduce bytes), is timed into
``dl4j_fit_phase_seconds`` and beats the watchdog; the collectives add
their bytes to ``dl4j_collective_bytes_total`` (``compile_seam``); ``fit``
dumps the flight recorder once on an unhandled exception.
:meth:`ParallelWrapper.stats` keeps the wrapper's own step counts beside
the series read back.
"""
from __future__ import annotations

import contextlib
import time
from collections import Counter
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from ..common import wrap_with_policy
from ..datasets.prefetch import DevicePrefetcher, stage_to_device
from ..nn.ksteps import t_dispatch, t_listeners, t_staging
from ..observability.flight_recorder import dump_on_unhandled, global_recorder
from ..observability.watchdog import beat
from ..optimize.listeners import fire_iteration_done
from ..utils.batching import k_step_groups
from . import compile_seam, context as pctx
from .compile_seam import (
    NetView, average_tree, broadcast_tree, compile_step)
from .mesh import Mesh, data_parallel_mesh
from .partition import (
    PartitionSpec as P, match_partition_rules, rules_for, tree_nbytes)


class ParallelWrapperBuilder:
    """The JAX package's builder (DL4J ``ParallelWrapper.Builder``)."""

    def __init__(self, model):
        self._model = model
        self._workers: Optional[int] = None
        self._prefetch = 2
        self._avg_freq = 1
        self._average_updaters = True
        self._report_score = False
        self._mesh: Optional[Mesh] = None
        self._seq_axis: Optional[str] = None
        self._seq_mode = "ulysses"
        self._expert_axis: Optional[str] = None
        self._capacity_factor = 2.0
        self._zero1 = False
        self._fsdp = False
        self._sharding: Optional[str] = None

    def workers(self, n: int) -> "ParallelWrapperBuilder":
        self._workers = n
        return self

    def prefetch_buffer(self, n: int) -> "ParallelWrapperBuilder":
        self._prefetch = n
        return self

    def averaging_frequency(self, n: int) -> "ParallelWrapperBuilder":
        self._avg_freq = max(1, n)
        return self

    def average_updaters(self, flag: bool) -> "ParallelWrapperBuilder":
        self._average_updaters = flag
        return self

    def report_score_after_averaging(self, flag: bool
                                     ) -> "ParallelWrapperBuilder":
        self._report_score = flag
        return self

    def mesh(self, mesh: Mesh) -> "ParallelWrapperBuilder":
        self._mesh = mesh
        return self

    def sequence_parallel(self, axis: str = "sp",
                          mode: str = "ulysses") -> "ParallelWrapperBuilder":
        """Run the attention layers sequence-parallel over mesh axis
        ``axis`` (``"ulysses"`` or ``"ring"``), each rank holding a block
        of the time axis."""
        self._seq_axis = axis
        self._seq_mode = mode
        return self

    def expert_parallel(self, axis: str = "data",
                        capacity_factor: float = 2.0
                        ) -> "ParallelWrapperBuilder":
        """Run the MoE layers expert-parallel over mesh axis ``axis`` (the
        batch's ``"data"`` axis), each expert's buffer holding
        ``capacity_factor`` times its even share of a rank's tokens."""
        self._expert_axis = axis
        self._capacity_factor = capacity_factor
        return self

    def shard_parameters(self, flag: bool = True) -> "ParallelWrapperBuilder":
        """FSDP: each rank keeps 1/N of each shardable param between
        steps; each layer is gathered when the forward reads it."""
        self._fsdp = flag
        return self

    def shard_optimizer_state(self, flag: bool = True
                              ) -> "ParallelWrapperBuilder":
        """ZeRO-1: each rank keeps 1/N of the updater state and updates its
        block of each param; the math is unchanged."""
        self._zero1 = flag
        return self

    def sharding(self, rule_set: str) -> "ParallelWrapperBuilder":
        """A rule set by name (``partition.py``): ``"dp"`` (the default),
        ``"zero3"`` (params and updater state split over ``data``) or
        ``"dp_tp"`` (tensor parallelism over a ``model`` axis)."""
        self._sharding = rule_set
        return self

    def build(self) -> "ParallelWrapper":
        return ParallelWrapper(self._model, workers=self._workers,
                               prefetch=self._prefetch,
                               averaging_frequency=self._avg_freq,
                               average_updaters=self._average_updaters,
                               report_score=self._report_score,
                               mesh=self._mesh,
                               sequence_parallel_axis=self._seq_axis,
                               sequence_parallel_mode=self._seq_mode,
                               expert_parallel_axis=self._expert_axis,
                               capacity_factor=self._capacity_factor,
                               shard_optimizer_state=self._zero1,
                               shard_parameters=self._fsdp,
                               sharding=self._sharding)


def _layers(model) -> list:
    """A network's layer modules, either type."""
    vertex_layers = getattr(model, "vertex_layers", None)
    if vertex_layers is not None:
        return list(vertex_layers.values())
    return list(model.layers)


class ParallelWrapper:
    def __init__(self, model, workers: Optional[int] = None,
                 prefetch: int = 2, averaging_frequency: int = 1,
                 average_updaters: bool = True, report_score: bool = False,
                 mesh: Optional[Mesh] = None,
                 sequence_parallel_axis: Optional[str] = None,
                 sequence_parallel_mode: str = "ulysses",
                 expert_parallel_axis: Optional[str] = None,
                 capacity_factor: float = 2.0,
                 shard_optimizer_state: bool = False,
                 shard_parameters: bool = False,
                 sharding: Optional[str] = None):
        from ..nn.conf.layers.recurrent import LSTM

        self.model = model
        self.mesh = mesh or data_parallel_mesh(workers)
        if "data" not in self.mesh.shape:
            raise ValueError(f"the mesh needs a 'data' axis: "
                             f"{self.mesh.shape}")
        self.n_workers = self.mesh.shape["data"]
        if workers is not None and workers != self.n_workers:
            raise ValueError(f"workers={workers} but the mesh's 'data' axis "
                             f"has {self.n_workers} ranks")
        self.seq_axis = sequence_parallel_axis
        self.seq_mode = sequence_parallel_mode
        self.capacity_factor = capacity_factor
        self.zero1 = shard_optimizer_state
        self.fsdp = shard_parameters
        if sharding not in (None, "dp", "dp_tp", "zero3"):
            raise ValueError(f"unknown sharding rule set {sharding!r}; "
                             "expected 'dp', 'dp_tp', or 'zero3'")
        self.expert_axis = expert_parallel_axis
        self.rule_set = sharding
        if sharding == "zero3":
            self.zero1 = self.fsdp = True
        if sharding == "dp_tp":
            if "model" not in self.mesh.shape:
                raise ValueError("sharding('dp_tp') needs a mesh with a "
                                 "'model' axis, e.g. build_mesh({'data': 4, "
                                 "'model': 2})")
            if averaging_frequency != 1:
                raise ValueError("sharding('dp_tp') requires "
                                 "averaging_frequency == 1 (synchronous DP)")
            if self.seq_axis or self.expert_axis or self.zero1 or self.fsdp:
                raise ValueError(
                    "sharding('dp_tp') runs alone: sequence or expert "
                    "parallelism and ZeRO/FSDP do not compose with it here")
        if (self.zero1 or self.fsdp) and averaging_frequency != 1:
            raise ValueError("shard_optimizer_state/shard_parameters "
                             "(ZeRO/FSDP) require averaging_frequency == 1 "
                             "(synchronous DP)")
        if (self.seq_axis or self.expert_axis) and averaging_frequency != 1:
            raise ValueError("sequence/expert parallelism requires "
                             "averaging_frequency == 1 (synchronous DP)")
        if self.seq_axis:
            if self.seq_axis not in self.mesh.shape:
                raise ValueError(f"sequence axis {self.seq_axis!r} not in "
                                 f"mesh axes {tuple(self.mesh.shape)}")
            if self.seq_mode not in ("ulysses", "ring"):
                raise ValueError(f"unknown seq_mode {self.seq_mode!r}")
            layers = _layers(model)
            attn = [l for l in layers
                    if hasattr(l, "n_heads") and hasattr(l, "causal")]
            if not attn:
                raise ValueError("sequence_parallel() requested but the "
                                 "model has no attention layers")
            if any(isinstance(l, LSTM) for l in layers):
                # the time axis is split: a recurrence would see its block
                raise ValueError("sequence_parallel() splits the time axis; "
                                 "a recurrent layer cannot run on a block")
            n = self.mesh.shape[self.seq_axis]
            if self.seq_mode == "ulysses":
                bad = [l.n_heads for l in attn if l.n_heads % n]
                if bad:
                    raise ValueError(
                        f"sequence_parallel('{self.seq_axis}', ulysses) with "
                        f"axis size {n}: head counts {bad} are not divisible "
                        "by it (use mode='ring' or adjust heads)")
        if self.expert_axis:
            self._check_expert_parallel(model)
        self.prefetch = prefetch
        self.averaging_frequency = averaging_frequency
        self.average_updaters = average_updaters
        self.report_score = report_score
        self._sync_step = None
        self._local_step = None
        self._counts: Counter = Counter()

    def _check_expert_parallel(self, model) -> None:
        """An explicit ``expert_parallel()`` engages or fails: a MoE layer
        whose expert count the axis does not divide would run the dense
        path in silence (JAX ``wrapper.py``'s check)."""
        axis = self.expert_axis
        if axis not in self.mesh.shape:
            raise ValueError(f"expert axis {axis!r} not in mesh axes "
                             f"{tuple(self.mesh.shape)}")
        if axis != "data":
            raise ValueError(
                f"expert_parallel('{axis}'): the tokens are split over "
                "'data', which the experts' axis doubles as; use 'data'")
        n = self.mesh.shape[axis]
        moe_layers = [l for l in _layers(model) if hasattr(l, "n_experts")]
        bad = [l.n_experts for l in moe_layers if l.n_experts % n]
        if bad:
            raise ValueError(
                f"expert_parallel('{axis}') with axis size {n}: expert "
                f"counts {bad} are not divisible by it")
        if not moe_layers:
            raise ValueError("expert_parallel() requested but the model "
                             "has no MoE layers")

    @staticmethod
    def builder(model) -> ParallelWrapperBuilder:
        return ParallelWrapperBuilder(model)

    # ------------------------------------------------------------- layout
    def _batch_axes(self) -> tuple:
        return ("data",) + ((self.seq_axis,) if self.seq_axis else ())

    def _context(self):
        return pctx.parallel_context(self.mesh, seq_axis=self.seq_axis,
                                     seq_mode=self.seq_mode,
                                     expert_axis=self.expert_axis,
                                     capacity_factor=self.capacity_factor,
                                     data_axis="data")

    def _batch_spec(self, arr) -> P:
        """The spec this rank's block of a batch array is cut by: rows over
        ``data``, and under sequence parallelism the time axis of a
        ``[B, T, F]`` array over the sequence axis (a length the axis does
        not divide raises here, naming both)."""
        if self.seq_axis and getattr(arr, "ndim", 0) == 3:
            n = self.mesh.shape[self.seq_axis]
            t = arr.shape[1]
            if t % n:
                raise ValueError(
                    f"sequence_parallel('{self.seq_axis}'): sequence length "
                    f"{t} (axis 1 of a batch shaped {tuple(arr.shape)}) is "
                    f"not divisible by the '{self.seq_axis}' mesh axis size "
                    f"{n}; pad or re-bucket the batch")
            return P("data", self.seq_axis)
        return P("data")

    def _local(self, arr) -> np.ndarray:
        """This rank's block of a host batch array under :meth:`_batch_spec`."""
        a = arr.detach().cpu().numpy() if isinstance(arr, torch.Tensor) \
            else np.asarray(arr)
        spec = self._batch_spec(a)
        if self.seq_axis and len(spec) < 2:
            raise ValueError("sequence_parallel() needs [B, T, F] inputs and "
                             f"labels; got an array shaped {a.shape}")
        for d, axis in enumerate(spec):
            n = self.mesh.shape[axis]
            a = np.split(a, n, axis=d)[self.mesh.coords[axis]]
        return np.ascontiguousarray(a)

    def _rule_label(self) -> str:
        if self.rule_set:
            return self.rule_set
        return "zero3" if (self.fsdp or self.zero1) else "dp"

    def _matched_specs(self, rules, tree, what: str):
        """The engine's specs for a param-shaped tree; an explicit sharding
        request that would split nothing raises."""
        from .partition import tree_leaves
        specs = match_partition_rules(rules, tree, mesh=self.mesh,
                                      conf=self.model.conf)
        if tree_leaves(tree) and all(s == P() for s in tree_leaves(specs)):
            raise ValueError(f"{what}: no dimension is divisible by the mesh "
                             "axis; nothing would shard")
        return specs

    def _spec_trees(self):
        """``(param_specs, upd_specs)``: a ``P()`` prefix (replicated), the
        ``dp_tp`` rules' specs (params and their updater state alike) or
        the ``zero3`` rules' specs."""
        net = self.model
        if self.rule_set == "dp_tp":
            rules = rules_for("dp_tp")
            par = self._matched_specs(rules, net.params_list,
                                      "sharding('dp_tp')")
            upd = match_partition_rules(rules, net.updater_state,
                                        mesh=self.mesh, conf=net.conf)
            return par, upd
        par, upd = P(), P()
        if self.fsdp:
            par = self._matched_specs(rules_for("zero3"), net.params_list,
                                      "shard_parameters()")
        if self.zero1:
            upd = self._matched_specs(rules_for("zero3"), net.updater_state,
                                      "shard_optimizer_state()")
        return par, upd

    # ------------------------------------------------------------ public API
    @dump_on_unhandled("ParallelWrapper.fit")
    def fit(self, iterator, epochs: int = 1) -> None:
        """DL4J ``fit(DataSetIterator)``: every rank iterates the same
        global batches and trains on its block of each."""
        net = self.model
        net._require_init()
        if self.averaging_frequency == 1:
            self._fit_sync(iterator, epochs)
        else:
            self._fit_local_sgd(iterator, epochs)

    def stats(self) -> dict:
        """The wrapper's counters (steps by path, fallbacks, averages, the
        whole views given to listeners and their bytes) and the seam's and
        the rule engine's."""
        sh = getattr(self._sync_step, "sharding", None)
        views = (sh.view_stats() if sh is not None
                 else {"whole_views": 0, "whole_view_bytes": 0})
        return {**dict(self._counts), **views, **compile_seam.stats()}

    @contextlib.contextmanager
    def _stepping(self, step):
        """The network's train step replaced by ``step`` (its single steps
        and its captured K-step graph both call ``_train_call``), the
        captured graphs dropped on the way in and out."""
        net = self.model
        net._drop_step_graphs()
        net._train_call = wrap_with_policy(step, net.conf.global_conf.dtype)
        try:
            yield
        finally:
            del net._train_call
            net._drop_step_graphs()

    def _to_device(self, arrays: list) -> list:
        return [self.model._to_device(a) for a in arrays]

    def _host_arrays(self, ds):
        """``(xs, ys, fmasks, lmasks)`` of a dataset as lists."""
        from ..nn.graph_network import _coerce_graph_batch
        return _coerce_graph_batch(ds)

    def _note_step(self, path: str, n: int = 1) -> None:
        self._counts[f"steps_{path}"] += n

    def _after_step(self, loss, batch_size: int, path: str, dispatch_s: float,
                    **fields) -> None:
        """After a step of the wrapper's: its event, the iteration, the
        listeners (timed), a beat."""
        net = self.model
        net.last_batch_size = batch_size
        global_recorder().record("step", path=path, it=net.iteration,
                                 batch=batch_size, dispatch_s=dispatch_s,
                                 **fields)
        net.score_value = loss
        net.iteration += 1
        with t_listeners.time():
            fire_iteration_done(net, net.iteration)
        beat(net.iteration)

    # -------------------------------------------------------- synchronous DP
    def _make_sync_step(self):
        net = self.model
        par_sp, upd_sp = self._spec_trees()
        return compile_step(
            "ParallelWrapper.sync_step", NetView(net), mesh=self.mesh,
            rule_set=self._rule_label(), strategy="jit",
            in_specs=(par_sp, P(), upd_sp, None, None, P(), P()),
            out_specs=(par_sp, P(), upd_sp, P()),
            reduce_axes=self._batch_axes(), param_specs=par_sp,
            upd_specs=upd_sp, params=net.params_list, conf=net.conf,
            tp_axis="model" if self.rule_set == "dp_tp" else None)

    def _capturable(self) -> bool:
        """K-step groups replay a CUDA graph only where the step's
        collectives can be captured: NCCL (or no group), and no ZeRO."""
        if (self.model.device.type != "cuda" or self.zero1 or self.fsdp
                or self.expert_axis or self.rule_set == "dp_tp"):
            return False
        group = self.mesh.group(*self._batch_axes())
        return group is None or dist.get_backend(group) == "nccl"

    def _fit_sync(self, iterator, epochs: int) -> None:
        net = self.model
        if self._sync_step is None:
            self._sync_step = self._make_sync_step()
        step = self._sync_step
        sh = step.sharding
        k = max(1, getattr(net, "dispatch_ksteps", 8))
        if net.device.type == "cuda" and not self._capturable():
            k = 1
        if not net._multistep_ok(k):
            k = 1
        unsharded = (net._uses_tbptt() or not net._uses_sgd()
                     or max(1, net.conf.global_conf.iterations) > 1)
        n_data = self.mesh.shape["data"]
        # the gradients' all-reduce moves their float32 concatenation
        grad_bytes = tree_nbytes(net.params_list)

        def to_batch(ds):
            # the batches the sharded step does not cover go whole
            if unsharded:
                return None
            xs, ys, fm, lm = self._host_arrays(ds)
            if fm is not None or lm is not None:
                return None
            if int(np.shape(xs[0])[0]) % n_data:
                return None
            return [self._local(a) for a in xs], [self._local(a) for a in ys]

        def fallback(ds):
            # whole on every rank, the network's own step, no collective:
            # the ranks stay equal
            self._counts["fallback_steps"] += 1
            with pctx.no_context(), self._unstepped():
                if sh is not None:
                    sh.gather_all()
                    net.updater_state = sh.gather_updater_state(
                        net.updater_state)
                    net._held_sharding = None  # whole for this step
                try:
                    net._fit_dataset(ds)
                finally:
                    if sh is not None:
                        net.updater_state = sh.scatter_updater_state(
                            net.updater_state)
                        sh.begin()
                        net._held_sharding = sh

        stream = (torch.cuda.Stream(net.device)
                  if net.device.type == "cuda" else None)

        def stage(kind_item):
            kind, item = kind_item
            if kind != "group" or len(item) < 2:
                return kind_item
            return "staged", stage_to_device(item, net.device,
                                             net.stage_dtype, stream)

        with self._context(), self._stepping(step):
            if sh is not None:
                net.updater_state = sh.scatter_updater_state(net.updater_state)
                sh.begin()
                # what a sharded checkpoint saves from between steps
                # (utils/sharded_checkpoint.py): this rank's blocks
                net._held_sharding = sh
            try:
                for _ in range(epochs):
                    if hasattr(iterator, "reset"):
                        iterator.reset()
                    groups = k_step_groups(iterator, k, to_batch)
                    with DevicePrefetcher(groups, stage,
                                          depth=self.prefetch,
                                          path="wrapper_sync",
                                          wait_series=t_staging) as pf:
                        for kind, item in pf:
                            if kind == "single":
                                fallback(item)
                            elif kind == "group":
                                xs, ys = item[0]
                                t0 = time.perf_counter()
                                loss = net._eager_step(
                                    self._to_device(xs), self._to_device(ys),
                                    net.iteration)
                                dt = time.perf_counter() - t0
                                t_dispatch.observe(dt)
                                self._note_step("sync")
                                moved = 0 if sh is not None else grad_bytes
                                if moved:
                                    compile_seam.count_collective(
                                        "all_reduce", "grad", moved)
                                self._after_step(
                                    loss, int(xs[0].shape[0]) * n_data,
                                    "ParallelWrapper.sync_step", dt,
                                    collective_bytes=moved)
                            else:
                                it0 = net.iteration
                                net._dispatch_staged(item)
                                net.last_batch_size = (
                                    int(item.xs[0].shape[1]) * n_data)
                                self._note_step("sync_ksteps", item.n)
                                moved = (0 if sh is not None
                                         else grad_bytes * item.n)
                                if moved:
                                    compile_seam.count_collective(
                                        "all_reduce", "grad", moved)
                                global_recorder().record(
                                    "step",
                                    path="ParallelWrapper.sync_multistep",
                                    it=it0, k=item.n,
                                    batch=net.last_batch_size,
                                    dispatch_s=net.last_dispatch_s,
                                    collective_bytes=moved)
            finally:
                if sh is not None:
                    net._held_sharding = None
                    sh.end()
                    net.updater_state = sh.gather_updater_state(
                        net.updater_state)

    @contextlib.contextmanager
    def _unstepped(self):
        """The network's own step back for a block inside a parallel fit."""
        net = self.model
        step = net.__dict__.pop("_train_call", None)
        net._drop_step_graphs()
        try:
            yield
        finally:
            if step is not None:
                net._train_call = step
            net._drop_step_graphs()

    # ------------------------------------------------------------ local SGD
    def _average(self, site: str) -> None:
        """Params, layer states and (``average_updaters``) updater state
        replaced by their mean over the data ranks."""
        net = self.model
        group, n = self.mesh.group("data"), self.mesh.shape["data"]
        average_tree(net.params_list, group, n, site)
        average_tree(net.state_list, group, n, site)
        if self.average_updaters:
            average_tree(net.updater_state, group, n, site)
        self._counts["averages"] += 1

    def _fit_local_sgd(self, iterator, epochs: int) -> None:
        net = self.model
        if self._local_step is None:
            self._local_step = compile_step(
                "ParallelWrapper.local_sgd_step", NetView(net),
                mesh=self.mesh, rule_set=self._rule_label(),
                strategy="shard_map", reduce_axes=("data",),
                in_specs=(P("data"),) * 5 + (P(), P()),
                out_specs=(P("data"),) * 3 + (P(),))
        n_data = self.mesh.shape["data"]
        since_avg = 0
        # no context: each replica's batch norm and MoE shares are its own,
        # as in the JAX shard_map body
        with self._stepping(self._local_step):
            for _ in range(epochs):
                if hasattr(iterator, "reset"):
                    iterator.reset()
                for ds in iterator:
                    xs, ys, _, _ = self._host_arrays(ds)
                    bs = int(np.shape(xs[0])[0])
                    if bs % n_data:
                        raise ValueError(
                            f"local SGD splits each batch over {n_data} "
                            f"ranks; a batch of {bs} rows does not divide")
                    t0 = time.perf_counter()
                    loss = net._eager_step(
                        self._to_device([self._local(a) for a in xs]),
                        self._to_device([self._local(a) for a in ys]),
                        net.iteration)
                    dt = time.perf_counter() - t0
                    t_dispatch.observe(dt)
                    self._note_step("local_sgd")
                    net.last_batch_size = bs
                    global_recorder().record(
                        "step", path="ParallelWrapper.local_step",
                        it=net.iteration, batch=bs, dispatch_s=dt)
                    net.score_value = loss
                    net.iteration += 1
                    since_avg += 1
                    if since_avg >= self.averaging_frequency:
                        self._average("wrapper_local_sgd")
                        since_avg = 0
                    with t_listeners.time():
                        for listener in net.listeners:
                            listener.iteration_done(net, net.iteration)
                    beat(net.iteration)
            # the final sync
            self._average("wrapper_local_sgd")
            if not self.average_updaters:
                # the JAX wrapper keeps replica 0's updater state
                broadcast_tree(net.updater_state, self.mesh.group("data"),
                               self.mesh.global_rank("data", 0))
