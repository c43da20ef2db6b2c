"""Cluster-style training: the ``TrainingMaster`` SPI and parameter averaging.

Counterpart of ``deeplearning4j_tpu/parallel/training_master.py`` (DL4J's
dl4j-spark ``TrainingMaster``/``TrainingWorker``,
``ParameterAveragingTrainingMaster``, ``SparkDl4jMultiLayer`` and the
per-phase timing stats with their HTML timeline), without the parameter
server (A7.3).

Spark's executors are the data axis's ranks here, SPMD: every rank
iterates the same minibatches and groups them into splits of ``workers x
averaging_frequency``, worker ``d`` taking minibatches ``d, d + workers,
...`` of a split, as the JAX package deals them out. Each rank runs its
minibatches as local steps (the seam's ``"shard_map"`` step: no gradient
collective), then the params, the layers' states and, with
``average_updaters``, the updater state are averaged over the ranks (the
tree aggregate). :class:`DistributedMultiLayer` fronts it and evaluates
each rank's block of each batch, merging the ranks' counts.
"""
from __future__ import annotations

import json
import time
from typing import List, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..common import wrap_with_policy
from .compile_seam import NetView, average_tree, broadcast_tree, compile_step
from .mesh import Mesh, data_parallel_mesh
from .partition import PartitionSpec as P


class TrainingMaster:
    """SPI (DL4J ``api/TrainingMaster``)."""

    def execute_training(self, model, data_iterator) -> None:
        raise NotImplementedError

    def get_training_stats(self):
        return None


class TrainingWorker:
    """SPI (DL4J ``api/TrainingWorker``): processes minibatches locally and
    emits a result for aggregation."""

    def get_initial_model(self):
        raise NotImplementedError

    def process_minibatch(self, dataset, model):
        raise NotImplementedError

    def get_final_result(self, model):
        raise NotImplementedError


class SparkTrainingStats:
    """Per-phase timings (DL4J ``CommonSparkTrainingStats``): events
    ``(phase, start_ms, duration_ms, meta)``."""

    def __init__(self):
        self.events: List[dict] = []

    def add(self, phase: str, start: float, duration: float, **meta) -> None:
        self.events.append({"phase": phase, "start_ms": int(start * 1000),
                            "duration_ms": duration * 1000, **meta})

    def phases(self) -> List[str]:
        return sorted({e["phase"] for e in self.events})

    def total_time_ms(self, phase: str) -> float:
        return sum(e["duration_ms"] for e in self.events if e["phase"] == phase)

    def export_html(self, path: str) -> None:
        """A self-contained SVG timeline (DL4J
        ``StatsUtils.exportStatsAsHTML``)."""
        if not self.events:
            with open(path, "w") as f:
                f.write("<html><body>No events</body></html>")
            return
        t0 = min(e["start_ms"] for e in self.events)
        t1 = max(e["start_ms"] + e["duration_ms"] for e in self.events)
        span = max(t1 - t0, 1.0)
        phases = self.phases()
        colors = ["#4C78A8", "#F58518", "#54A24B", "#E45756", "#72B7B2",
                  "#B279A2"]
        width, row_h = 960, 28
        rows = []
        for e in self.events:
            row = phases.index(e["phase"])
            x = 80 + (e["start_ms"] - t0) / span * (width - 100)
            w = max(e["duration_ms"] / span * (width - 100), 1.0)
            c = colors[row % len(colors)]
            rows.append(f'<rect x="{x:.1f}" y="{row*row_h+6}" width="{w:.1f}" '
                        f'height="{row_h-10}" fill="{c}"><title>{e["phase"]}: '
                        f'{e["duration_ms"]:.1f} ms</title></rect>')
        labels = [f'<text x="4" y="{i*row_h+row_h//2+4}" font-size="11">{p}'
                  f'</text>' for i, p in enumerate(phases)]
        html = (f'<html><body><h3>Training timeline</h3>'
                f'<svg width="{width}" height="{len(phases)*row_h+20}" '
                f'font-family="sans-serif">{"".join(labels)}{"".join(rows)}'
                f'</svg><pre>{json.dumps(self.summary(), indent=2)}</pre>'
                f'</body></html>')
        with open(path, "w") as f:
            f.write(html)

    def summary(self) -> dict:
        return {p: {"count": sum(1 for e in self.events if e["phase"] == p),
                    "total_ms": round(self.total_time_ms(p), 2)}
                for p in self.phases()}


class ParameterAveragingTrainingMaster(TrainingMaster):
    """Synchronous parameter averaging over the data axis's ranks (DL4J
    ``ParameterAveragingTrainingMaster``)."""

    def __init__(self, num_workers: Optional[int] = None,
                 batch_size_per_worker: int = 32,
                 averaging_frequency: int = 1,
                 average_updaters: bool = True,
                 collect_training_stats: bool = False,
                 mesh: Optional[Mesh] = None,
                 prefetch: int = 2):
        self.mesh = mesh or data_parallel_mesh(num_workers)
        self.num_workers = self.mesh.shape["data"]
        if num_workers is not None and num_workers != self.num_workers:
            raise ValueError(f"num_workers={num_workers} but the mesh's "
                             f"'data' axis has {self.num_workers} ranks")
        self.batch_size_per_worker = batch_size_per_worker
        self.averaging_frequency = max(1, averaging_frequency)
        self.average_updaters = average_updaters
        self.collect_training_stats = collect_training_stats
        self.stats = SparkTrainingStats() if collect_training_stats else None
        #: kept for the JAX signature: a rank stages its minibatches inline
        self.prefetch = prefetch
        self._steps = {}

    class Builder:
        def __init__(self, num_workers: Optional[int] = None):
            self._kw = {"num_workers": num_workers}

        def batch_size_per_worker(self, n: int):
            self._kw["batch_size_per_worker"] = n
            return self

        def averaging_frequency(self, n: int):
            self._kw["averaging_frequency"] = n
            return self

        def average_updaters(self, flag: bool):
            self._kw["average_updaters"] = flag
            return self

        def collect_training_stats(self, flag: bool):
            self._kw["collect_training_stats"] = flag
            return self

        def mesh(self, mesh: Mesh):
            self._kw["mesh"] = mesh
            return self

        def prefetch(self, n: int):
            self._kw["prefetch"] = n
            return self

        def build(self) -> "ParameterAveragingTrainingMaster":
            return ParameterAveragingTrainingMaster(**self._kw)

    def _step_for(self, model):
        step = self._steps.get(id(model))
        if step is None:
            step = self._steps[id(model)] = compile_step(
                "TrainingMaster.local_steps", NetView(model), mesh=self.mesh,
                rule_set="dp", strategy="shard_map", reduce_axes=("data",),
                in_specs=(P("data"),) * 5 + (P(), P()),
                out_specs=(P("data"),) * 3 + (P(),))
        return step

    def execute_training(self, model, data_iterator) -> None:
        """One pass over the iterator (DL4J ``executeTraining``): splits of
        ``workers x averaging_frequency`` minibatches, each rank's share run
        as local steps, then the average. A last split with a multiple of
        ``workers`` minibatches runs with fewer steps; a ragged rest is
        dropped, as the JAX package drops it."""
        from ..nn.graph_network import _coerce_graph_batch

        D, F = self.num_workers, self.averaging_frequency
        me = self.mesh.coords["data"]
        group = self.mesh.group("data")
        step = self._step_for(model)
        model._require_init()
        t_setup = time.time()
        # every rank starts from the first rank's model, as the master
        # broadcasts it to Spark's executors
        src = self.mesh.global_rank("data", 0)
        for tree in (model.params_list, model.state_list,
                     model.updater_state):
            broadcast_tree(tree, group, src)
        if self.stats:
            self.stats.add("BroadcastParameters", t_setup,
                           time.time() - t_setup)
        if hasattr(data_iterator, "reset"):
            data_iterator.reset()

        def splits():
            rows: List[List] = [[] for _ in range(D)]
            filled = 0
            for ds in data_iterator:
                rows[filled % D].append(ds)
                filled += 1
                if filled == D * F:
                    yield rows
                    rows = [[] for _ in range(D)]
                    filled = 0
            if filled and filled % D == 0:
                yield rows

        def dev(arrays):
            return [model._to_device(a) for a in arrays]

        # the network's train step is the seam's local step for the pass
        model._drop_step_graphs()
        model._train_call = wrap_with_policy(step,
                                             model.conf.global_conf.dtype)
        try:
            for rows in splits():
                t0 = time.time()
                mine = [_coerce_graph_batch(ds)[:2] for ds in rows[me]]
                if self.stats:
                    self.stats.add("SplitData", t0, time.time() - t0)
                t1 = time.time()
                losses = []
                for j, (xs, ys) in enumerate(mine):
                    losses.append(model._eager_step(dev(xs), dev(ys),
                                                    model.iteration + j))
                model.iteration += len(mine)
                # the step averaged each loss over the ranks already
                loss = torch.stack(losses).mean()
                if self.stats:
                    self.stats.add("WorkerFit", t1, time.time() - t1,
                                   loss=float(loss))
                t2 = time.time()
                average_tree(model.params_list, group, D, "training_master")
                average_tree(model.state_list, group, D, "training_master")
                if self.average_updaters:
                    average_tree(model.updater_state, group, D,
                                 "training_master")
                if self.stats:
                    self.stats.add("AverageParameters", t2, time.time() - t2)
                model.score_value = loss
                for listener in model.listeners:
                    listener.iteration_done(model, model.iteration)
        finally:
            del model._train_call
            model._drop_step_graphs()
        t3 = time.time()
        if self.stats:
            self.stats.add("SetParametersOnMaster", t3, time.time() - t3)

    def get_training_stats(self) -> Optional[SparkTrainingStats]:
        return self.stats


class DistributedMultiLayer:
    """The front end (DL4J ``SparkDl4jMultiLayer``)."""

    def __init__(self, model, training_master: TrainingMaster):
        self.model = model
        self.master = training_master

    def fit(self, data, epochs: int = 1):
        for _ in range(epochs):
            self.master.execute_training(self.model, iter(data)
                                         if isinstance(data, list) else data)
        return self.model

    def evaluate(self, iterator):
        """Distributed evaluation: each rank takes its block of each batch
        (a batch the data axis does not divide is padded with its last row,
        and the padding is dropped), and the ranks' counts are merged, so
        every rank returns the whole evaluation."""
        from ..eval.evaluation import Evaluation

        mesh = getattr(self.master, "mesh", None)
        if mesh is None or "data" not in mesh.shape:
            return self.model.evaluate(iterator)
        n, me = mesh.shape["data"], mesh.coords["data"]
        net = self.model
        e = Evaluation()
        if hasattr(iterator, "reset"):
            iterator.reset()
        for ds in iterator:
            x, y = _host(ds.features), _host(ds.labels)
            mask = None if ds.labels_mask is None else _host(ds.labels_mask)
            b = len(x)
            per = -(-b // n)
            lo = me * per
            real = max(0, min(per, b - lo))
            pad = (-b) % n
            if pad:
                x = np.concatenate([x, np.repeat(x[-1:], pad, 0)])
            out = net.output(x[lo:lo + per])
            out = _host(out[:real] if isinstance(out, torch.Tensor)
                        else out[0][:real])
            if real:
                e.eval(y[lo:lo + real], out,
                       mask=None if mask is None else mask[lo:lo + real])
        group = mesh.group("data")
        if group is None:
            return e
        every = [None] * n
        dist.all_gather_object(every, e, group=group)
        merged = Evaluation()
        for other in every:
            merged.merge(other)
        return merged

    def get_score(self) -> float:
        return self.model.score_value


def _host(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


#: DL4J's graph front end shares the implementation
DistributedComputationGraph = DistributedMultiLayer
