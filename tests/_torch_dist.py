"""Ranks of the PyTorch port on a gloo CPU group, for the tests.

``run(world, jobs)`` starts ``world`` Python processes (this file as a
script), each joining a gloo group through ``file://`` rendezvous in a
temporary directory (no port, so parallel test workers never collide), with
one CPU thread. Each rank runs every job of ``jobs`` in order, a job being
``(name, kwargs)`` naming a function of :data:`JOBS`, and the parent gets
back each rank's ``{name: result}`` (numpy arrays and plain values). A test
module starts its ranks once and runs all its scenarios in them.

The ranks import the port and numpy only, never JAX: the JAX reference
runs in the parent. Every rank builds the same network from the same
config JSON and initial params and iterates the same global batches.
"""
import os
import pickle
import subprocess
import sys
import tempfile
import time
import traceback

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run(world, jobs, timeout=240):
    """Run ``jobs`` on ``world`` gloo ranks; a list of each rank's
    ``{job name: result}``. A rank that fails raises here with its
    traceback."""
    with tempfile.TemporaryDirectory(prefix="dl4j-ranks-") as d:
        with open(os.path.join(d, "jobs.pkl"), "wb") as f:
            pickle.dump(jobs, f)
        env = dict(os.environ, OMP_NUM_THREADS="1",
                   PYTHONPATH=ROOT + os.pathsep + os.environ.get(
                       "PYTHONPATH", ""))
        logs = [open(os.path.join(d, f"rank{r}.log"), "w")
                for r in range(world)]
        procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), d, str(world), str(r)],
            cwd=ROOT, env=env, stdout=logs[r], stderr=subprocess.STDOUT)
            for r in range(world)]
        deadline = time.monotonic() + timeout
        try:
            while any(p.poll() is None for p in procs):
                if any(p.poll() not in (None, 0) for p in procs):
                    break
                if time.monotonic() > deadline:
                    break
                time.sleep(0.05)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                p.wait()
            for f in logs:
                f.close()
        if any(p.returncode != 0 for p in procs):
            text = []
            for r in range(world):
                with open(os.path.join(d, f"rank{r}.log")) as f:
                    text.append(f"--- rank {r} (exit {procs[r].returncode})"
                                f"\n{f.read()[-4000:]}")
            raise RuntimeError("rank processes failed:\n" + "\n".join(text))
        out = []
        for r in range(world):
            with open(os.path.join(d, f"rank{r}.pkl"), "rb") as f:
                out.append(pickle.load(f))
        return out


# ------------------------------------------------------------ rank side
def _np(tree):
    import numpy as np
    import torch
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_np(v) for v in tree]
    return np.asarray(tree) if tree is not None else None


def _net(conf_json, params, states=None):
    from deeplearning4j_tpu_torch.convert import from_jax
    return from_jax(conf_json, params, device="cpu", state_list=states)


def _datasets(batches):
    from deeplearning4j_tpu_torch.datasets import DataSet
    from deeplearning4j_tpu_torch.nn.graph_network import MultiDataSet
    out = []
    for b in batches:
        if isinstance(b[0], list):
            out.append(MultiDataSet(b[0], b[1]))
        else:
            out.append(DataSet(b[0], b[1]))
    return out


def _checksum(batches) -> float:
    import numpy as np
    b = batches[0]
    xs = b[0] if isinstance(b[0], list) else [b[0]]
    return float(sum(np.asarray(x, np.float64).sum() for x in xs))


def _mesh(axes):
    from deeplearning4j_tpu_torch.parallel.mesh import build_mesh
    return build_mesh(axes) if axes else None


def job_wrapper(conf_json, params, batches, axes=None, states=None,
                epochs=1, knobs=(), ksteps=None, prefetch=0, local_freq=None,
                single=False, hold_check=False, zero_specs=None):
    """Train through ``ParallelWrapper`` (``knobs``: builder calls as
    ``(method, args)``); with ``single`` through the network's own ``fit``
    instead. ``zero_specs`` (a spec tree over the params) stands for the
    ZeRO placement's param and updater specs, as ``compile_step`` takes
    any spec (a custom rule). Returns the final params, states and updater
    state, the scores, the first batch's checksum, the wrapper's counters
    and, under ZeRO, this rank's param shards by ``layer/name``."""
    from deeplearning4j_tpu_torch.datasets import ListDataSetIterator
    from deeplearning4j_tpu_torch.parallel import ParallelWrapper

    if zero_specs is not None:
        from deeplearning4j_tpu_torch.parallel.partition import (
            PartitionSpec)
        specs = [{k: PartitionSpec(*v) for k, v in layer.items()}
                 for layer in zero_specs]
        ParallelWrapper._spec_trees = lambda self: (specs, specs)

    from deeplearning4j_tpu_torch.parallel import compile_seam

    before = dict(compile_seam.stats()["collective_bytes_total"])
    net = _net(conf_json, params, states)
    if ksteps is not None:
        net.dispatch_ksteps = ksteps
    scores, holds = [], []

    class Listen:
        def iteration_done(self, model, iteration):
            scores.append(float(model.score_value))
            if hold_check:
                holds.append(_held(model, pw))

    net.set_listeners(Listen())
    data = _datasets(batches)
    pw = None
    if single:
        for _ in range(epochs):
            for ds in data:
                net.fit(ds)
    else:
        b = ParallelWrapper.builder(net).prefetch_buffer(prefetch)
        mesh = _mesh(axes)
        b = b.mesh(mesh) if mesh is not None else b
        for method, args in knobs:
            b = getattr(b, method)(*args)
        pw = b.build()
        if local_freq is not None:
            # the local-SGD machinery at a frequency the builder routes to
            # the synchronous path (the JAX suite's freq-1 check)
            pw.averaging_frequency = local_freq
            pw._fit_local_sgd(ListDataSetIterator(data), epochs)
        else:
            pw.fit(ListDataSetIterator(data), epochs=epochs)
    return {"params": _np(net.params_list), "states": _np(net.state_list),
            "updater": _np(net.updater_state), "scores": scores,
            "iteration": net.iteration, "checksum": _checksum(batches),
            "holds": holds,
            "shards": {} if not hasattr(
                getattr(getattr(pw, "_sync_step", None), "sharding", None),
                "param_shards") else {
                f"{k}/{n}": _np(t) for (k, n), t in
                pw._sync_step.sharding.param_shards.items()},
            "stats": {} if pw is None else {
                k: v for k, v in pw.stats().items() if isinstance(k, str)
                and not isinstance(v, dict)},
            "collectives": {
                f"{op}/{site}": n - before.get((op, site), 0)
                for (op, site), n in
                compile_seam.stats()["collective_bytes_total"].items()
                if n != before.get((op, site), 0)}}


def _held(net, pw):
    """What a rank holds between ZeRO steps: the bytes of its param shards
    and updater-state shards, and the storage of the network's sharded
    params."""
    from deeplearning4j_tpu_torch.parallel.partition import tree_nbytes
    sh = pw._sync_step.sharding
    storage = sorted({p.untyped_storage().size() for d in net.params_list
                      for p in d.values()})
    out = {"param_bytes": sh.held_bytes(),
           "updater_bytes": tree_nbytes(net.updater_state),
           "min_storage": storage[0]}
    if hasattr(sh, "layouts"):
        # dp_tp: each split leaf's block against its whole leaf, in bytes
        params = sh.view.params()
        out["blocks"] = {
            f"{key}/{name}": (t.numel() * t.element_size(),
                              params[key][name].numel()
                              * params[key][name].element_size())
            for (key, name), t in sh.shards.items()}
        out["megatron"] = {str(k): sorted(v) for k, v in sh.megatron.items()
                           if v}
    return out


def job_master(conf_json, params, batches, workers, freq=1, epochs=1,
               stats=False, html=None, eval_batches=None):
    """``ParameterAveragingTrainingMaster`` through ``DistributedMultiLayer``:
    the params after ``fit``, the stats' phases, the HTML page written on
    rank 0 (its text), and a distributed evaluation's confusion matrix."""
    import torch.distributed as dist

    from deeplearning4j_tpu_torch.parallel.training_master import (
        DistributedMultiLayer, ParameterAveragingTrainingMaster)
    net = _net(conf_json, params)
    master = (ParameterAveragingTrainingMaster.Builder(workers)
              .averaging_frequency(freq).collect_training_stats(stats)
              .build())
    front = DistributedMultiLayer(net, master)
    out = {}
    if batches:
        front.fit(_datasets(batches), epochs=epochs)
        out["params"] = _np(net.params_list)
        out["score"] = float(front.get_score())
        out["iteration"] = net.iteration
    if stats:
        out["phases"] = master.get_training_stats().phases()
        if html and dist.get_rank() == 0:
            master.get_training_stats().export_html(html)
            with open(html) as f:
                out["html"] = f.read()
    if eval_batches:
        e = front.evaluate(_datasets(eval_batches))
        out["confusion"] = e.confusion.matrix.copy()
        out["accuracy"] = e.accuracy()
    return out


def job_early_stopping(conf_json, params, batches, holdout, max_epochs,
                       patience, workers):
    """``EarlyStoppingParallelTrainer`` against the data-set loss on the
    held-out batch: the best epoch, the epochs run and the reason."""
    from deeplearning4j_tpu_torch.datasets import ListDataSetIterator
    from deeplearning4j_tpu_torch.earlystopping import (
        DataSetLossCalculator, EarlyStoppingConfiguration,
        EarlyStoppingParallelTrainer, InMemoryModelSaver,
        MaxEpochsTerminationCondition,
        ScoreImprovementEpochTerminationCondition)
    net = _net(conf_json, params)
    cfg = EarlyStoppingConfiguration(
        epoch_termination_conditions=[
            MaxEpochsTerminationCondition(max_epochs),
            ScoreImprovementEpochTerminationCondition(patience)],
        score_calculator=DataSetLossCalculator(
            ListDataSetIterator(_datasets(holdout))),
        model_saver=InMemoryModelSaver())
    result = EarlyStoppingParallelTrainer(
        cfg, net, ListDataSetIterator(_datasets(batches)),
        workers=workers).fit()
    return {"best_epoch": result.best_model_epoch,
            "epochs": result.total_epochs,
            "reason": str(result.termination_reason),
            "scores": dict(result.score_vs_epoch),
            "params": _np(net.params_list)}


def job_attention(shapes, mode, causal, axes, axis="sp", seed=0):
    """Ring or Ulysses attention of the whole arrays (the same on every
    rank): the output, and the gradients of ``sum(out ** 2)`` through the
    differentiable whole-array entry point."""
    import numpy as np
    import torch

    from deeplearning4j_tpu_torch.parallel import ring_attention as ra
    mesh = _mesh(axes)
    rng = np.random.default_rng(seed)
    q, k, v = (torch.tensor(rng.normal(size=shapes).astype(np.float32),
                            requires_grad=True) for _ in range(3))
    fn = ra.ring_attention if mode == "ring" else ra.ulysses_attention
    out = fn(q, k, v, mesh, axis, causal=causal)
    (out ** 2).sum().backward()
    return {"out": _np(out), "grads": [_np(t.grad) for t in (q, k, v)]}


def job_raises(what):
    """The refusals that need a group: returns each one's exception type and
    message."""
    out = {}
    try:
        what_fn = _REFUSALS[what]
        what_fn()
    except Exception as e:  # the test reads the type and the message
        out = {"type": type(e).__name__, "msg": str(e)}
    return out


def _refuse_indivisible_heads():
    import numpy as np
    import torch

    from deeplearning4j_tpu_torch.parallel import ring_attention as ra
    q = torch.tensor(np.zeros((1, 8, 6, 4), np.float32))
    ra.ulysses_attention(q, q, q, _mesh({"sp": 4}), "sp")


def _sp_net(max_len=16):
    from deeplearning4j_tpu_torch.models import transformer_lm
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    return MultiLayerNetwork(transformer_lm(8, width=32, n_layers=1,
                                            n_heads=4, max_len=max_len),
                             device="cpu").init()


def _refuse_local_sgd_sp():
    from deeplearning4j_tpu_torch.parallel import ParallelWrapper
    (ParallelWrapper.builder(_sp_net()).mesh(_mesh({"data": 2, "sp": 2}))
     .averaging_frequency(4).sequence_parallel("sp").build())


def _refuse_sp_length():
    import numpy as np

    from deeplearning4j_tpu_torch.parallel import ParallelWrapper
    pw = (ParallelWrapper.builder(_sp_net(32))
          .mesh(_mesh({"data": 1, "sp": 4})).sequence_parallel("sp")
          .build())
    assert pw._batch_spec(np.zeros((8, 16, 8), np.float32)) == ("data", "sp")
    assert pw._batch_spec(np.zeros((8, 5), np.float32)) == ("data",)
    pw._batch_spec(np.zeros((8, 18, 8), np.float32))


def _refuse_sp_heads():
    from deeplearning4j_tpu_torch.models import transformer_lm
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.parallel import ParallelWrapper
    net = MultiLayerNetwork(transformer_lm(8, width=24, n_layers=1,
                                           n_heads=6, max_len=16),
                            device="cpu").init()
    (ParallelWrapper.builder(net).mesh(_mesh({"data": 1, "sp": 4}))
     .sequence_parallel("sp", "ulysses").build())


def _refuse_pipeline_indivisible():
    from deeplearning4j_tpu_torch.models import transformer_lm
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.parallel.pipeline_trainer import (
        PipelineTrainer)
    net = MultiLayerNetwork(transformer_lm(8, width=32, n_layers=3,
                                           n_heads=4, max_len=16,
                                           learning_rate=0.01),
                            device="cpu").init()
    PipelineTrainer(net, mesh=_mesh({"stage": 2}))


def _refuse_indivisible_experts():
    from deeplearning4j_tpu_torch.models import moe_transformer_lm
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.parallel import ParallelWrapper
    net = MultiLayerNetwork(moe_transformer_lm(8, width=32, n_layers=1,
                                               n_heads=4, n_experts=6,
                                               max_len=16),
                            device="cpu").init()
    ParallelWrapper.builder(net).workers(4).expert_parallel("data").build()


def _refuse_experts_without_moe():
    from deeplearning4j_tpu_torch.parallel import ParallelWrapper
    net = _sp_net()
    ParallelWrapper.builder(net).workers(4).expert_parallel("data").build()


def _refuse_expert_axis():
    from deeplearning4j_tpu_torch.models import moe_transformer_lm
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.parallel import ParallelWrapper
    net = MultiLayerNetwork(moe_transformer_lm(8, width=32, n_layers=1,
                                               n_heads=4, n_experts=4,
                                               max_len=16),
                            device="cpu").init()
    (ParallelWrapper.builder(net).mesh(_mesh({"data": 2, "sp": 2}))
     .expert_parallel("sp").build())


def _refuse_dp_tp_nothing_shards():
    import numpy as np

    from deeplearning4j_tpu_torch.datasets import DataSet, ListDataSetIterator
    from deeplearning4j_tpu_torch.nn.conf import NeuralNetConfiguration
    from deeplearning4j_tpu_torch.nn.conf.layers import DenseLayer, OutputLayer
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.parallel import ParallelWrapper
    conf = (NeuralNetConfiguration.builder().seed(1).list()
            .layer(DenseLayer.conf(n_in=5, n_out=7, activation="tanh"))
            .layer(OutputLayer.conf(n_in=7, n_out=3, loss="mcxent",
                                    activation="softmax")).build())
    net = MultiLayerNetwork(conf, device="cpu").init()
    pw = (ParallelWrapper.builder(net).mesh(_mesh({"data": 2, "model": 2}))
          .prefetch_buffer(0).sharding("dp_tp").build())
    x = np.zeros((8, 5), np.float32)
    y = np.eye(3, dtype=np.float32)[np.zeros(8, int)]
    pw.fit(ListDataSetIterator([DataSet(x, y)]))


_REFUSALS = {"pipeline_indivisible": _refuse_pipeline_indivisible,
             "dp_tp_nothing_shards": _refuse_dp_tp_nothing_shards,
             "indivisible_experts": _refuse_indivisible_experts,
             "experts_without_moe": _refuse_experts_without_moe,
             "expert_axis": _refuse_expert_axis,
             "ulysses_heads": _refuse_indivisible_heads,
             "local_sgd_sp": _refuse_local_sgd_sp,
             "sp_length": _refuse_sp_length,
             "sp_heads": _refuse_sp_heads}


def job_mesh(axes):
    """The mesh's coordinates and, for each single axis, the global ranks of
    this rank's group."""
    import torch
    import torch.distributed as dist
    mesh = _mesh(axes)
    out = {"coords": dict(mesh.coords), "groups": {}}
    for a in mesh.axis_names:
        g = mesh.group(a)
        t = torch.tensor([dist.get_rank()])
        got = [torch.zeros(1, dtype=t.dtype) for _ in range(mesh.shape[a])]
        dist.all_gather(got, t, group=g)
        out["groups"][a] = [int(x) for x in got]
    return out


def job_checkpoint(conf_json, params, batches, directory, knobs=(),
                   every=1, axes=None, n_micro=None):
    """``ParallelWrapper.fit`` (``knobs``, over the mesh ``axes``), or with
    ``n_micro`` ``PipelineTrainer.fit`` over ``axes``' stages, with a
    ``CheckpointListener(sharded=True)`` saving every ``every`` iterations
    into ``directory`` (every rank writes its own blocks). Returns the
    final params, updater state and iteration, and the smallest param
    storage the listener saw (0 when the rank held only its blocks)."""
    from deeplearning4j_tpu_torch.datasets import ListDataSetIterator
    from deeplearning4j_tpu_torch.optimize.listeners import (
        CheckpointListener)
    from deeplearning4j_tpu_torch.parallel import ParallelWrapper
    from deeplearning4j_tpu_torch.parallel.pipeline_trainer import (
        PipelineTrainer)

    net = _net(conf_json, params)
    seen = []

    class Storage:
        def iteration_done(self, model, iteration):
            seen.append(min(p.untyped_storage().size()
                            for d in model.params_list for p in d.values()))

    net.set_listeners(Storage(), CheckpointListener(
        directory, every_n_iterations=every, every_n_epochs=None,
        keep_last=2, sharded=True))
    data = ListDataSetIterator(_datasets(batches))
    if n_micro is not None:
        PipelineTrainer(net, mesh=_mesh(axes),
                        n_microbatches=n_micro).fit(data)
    else:
        b = ParallelWrapper.builder(net).prefetch_buffer(0)
        if axes:
            b = b.mesh(_mesh(axes))
        for method, args in knobs:
            b = getattr(b, method)(*args)
        b.build().fit(data)
    return {"params": _np(net.params_list), "updater": _np(net.updater_state),
            "iteration": net.iteration, "min_storage": min(seen)}


def _split_storage(net):
    """The smallest storage of the network's params and updater slots (0
    while a placement holds blocks of them)."""
    tensors = [p for d in _items(net.params_list) for p in d.values()]
    tensors += [t for d in _items(net.updater_state or [])
                for slots in d.values() for t in slots.values()]
    return min(t.untyped_storage().size() for t in tensors)


def _items(tree):
    return list(tree.values()) if isinstance(tree, dict) else list(tree)


def job_whole_view(conf_json, params, batches, directory, axes, knobs=(),
                   n_micro=None, every=None):
    """A fit (``ParallelWrapper`` with ``knobs`` over the mesh ``axes``,
    or with ``n_micro`` ``PipelineTrainer`` over its stages) with a zip
    ``CheckpointListener`` every ``every`` iterations (default: the last
    batch's) into ``directory`` and a ``ParamAndGradientIterationListener``,
    which read the whole state; single steps. Returns the final params and
    updater state, the param log's rows, the fit's stats, and at the start
    of each step what the rank held (the placement's param bytes, the
    updater state's bytes, the smallest storage)."""
    from deeplearning4j_tpu_torch.datasets import ListDataSetIterator
    from deeplearning4j_tpu_torch.optimize.listeners import (
        CheckpointListener, ParamAndGradientIterationListener)
    from deeplearning4j_tpu_torch.parallel import ParallelWrapper
    from deeplearning4j_tpu_torch.parallel.partition import tree_nbytes
    from deeplearning4j_tpu_torch.parallel.pipeline_trainer import (
        PipelineTrainer)

    net = _net(conf_json, params)
    net.dispatch_ksteps = 1
    log = ParamAndGradientIterationListener(print_mean_magnitudes=False)
    net.set_listeners(CheckpointListener(
        directory, every_n_iterations=every or len(batches),
        every_n_epochs=None, keep_last=len(batches)), log)
    holds = []

    def spy(fn):
        def step(*a, **k):
            held = net._held_sharding
            holds.append({"param_bytes": held.held_bytes(),
                          "updater_bytes": tree_nbytes(net.updater_state),
                          "min_storage": _split_storage(net)})
            return fn(*a, **k)
        return step

    data = ListDataSetIterator(_datasets(batches))
    if n_micro is not None:
        fit = PipelineTrainer(net, mesh=_mesh(axes), n_microbatches=n_micro)
        fit._step = spy(fit._step)
    else:
        b = ParallelWrapper.builder(net).prefetch_buffer(0).mesh(_mesh(axes))
        for method, args in knobs:
            b = getattr(b, method)(*args)
        fit = b.build()
        net._eager_step = spy(net._eager_step)
    fit.fit(data)
    st = fit.stats()
    return {"params": _np(net.params_list), "updater": _np(net.updater_state),
            "iteration": net.iteration, "rows": log.rows, "holds": holds,
            "views": st["whole_views"], "view_bytes": st["whole_view_bytes"]}


def job_restore_onto(conf_json, params, directory, axes, x, specs=None,
                     rules=None, batches=None, knobs=()):
    """``restore_sharded`` onto ``specs`` (or the rule set ``rules``'
    specs) on the mesh ``axes``: this rank's blocks by ``layer/name[/slot]``
    (a leaf split on one dim: its dim first; on several: in the leaf's
    layout, under ``grid_blocks``), what it read, the storage of its whole tensors, the
    ``output`` of ``x`` (gathered at use) and a second call's; then, with
    ``batches``, a ``ParallelWrapper`` fit (``knobs``) resuming from it and
    the same fit from a whole restore (params, updater state, scores)."""
    from deeplearning4j_tpu_torch.datasets import ListDataSetIterator
    from deeplearning4j_tpu_torch.parallel import ParallelWrapper, partition
    from deeplearning4j_tpu_torch.utils.sharded_checkpoint import (
        restore_sharded)

    mesh = _mesh(axes)
    net = _net(conf_json, params)
    if specs is None:
        specs = partition.match_partition_rules(
            partition.rules_for(rules), net.params_list, mesh=mesh,
            conf=net.conf)
    restore_sharded(directory, net, shardings=specs, mesh=mesh)
    held = net._held_sharding
    blocks = {"/".join(str(p) for p in k if p is not None):
              (_np(b.movedim(s[0][0], 0)), s[0][0])
              for k, (b, s) in held.blocks.items() if len(s) == 1}
    grid_blocks = {"/".join(str(p) for p in k if p is not None): _np(b)
                   for k, (b, s) in held.blocks.items() if len(s) > 1}
    storage = {f"{layer}/{name}": p.untyped_storage().size()
               for layer, d in enumerate(net.params_list)
               for name, p in d.items()}
    out = {"blocks": blocks, "grid_blocks": grid_blocks,
           "reads": dict(held.reads),
           "storage": storage, "held_bytes": held.held_bytes(),
           "iteration": net.iteration, "output": _np(net.output(x)),
           "storage_after_output": _split_storage(net),
           "output_again": _np(net.output(x)), "views": held.views}
    if batches is None:
        return out
    runs = {}
    for how in ("sharded", "whole"):
        if how == "whole":
            net = _net(conf_json, params)
            restore_sharded(directory, net)
        scores = []

        class Listen:
            def iteration_done(self, model, iteration):
                scores.append(float(model.score_value))

        net.set_listeners(Listen())
        b = ParallelWrapper.builder(net).prefetch_buffer(0).mesh(mesh)
        for method, args in knobs:
            b = getattr(b, method)(*args)
        b.build().fit(ListDataSetIterator(_datasets(batches)))
        runs[how] = {"params": _np(net.params_list), "scores": scores,
                     "updater": _np(net.updater_state),
                     "held": getattr(net, "_held_sharding", None) is None}
    out["fit"] = runs
    return out


def _layer(conf):
    """A CPU layer from ``{"@type": ..., fields}`` with the global
    defaults baked in, as a network builds it."""
    import torch

    from deeplearning4j_tpu_torch.nn.conf.multilayer import (
        GlobalConf, LayerConf, bake_layer_defaults)
    from deeplearning4j_tpu_torch.nn.conf.serde import layer_class
    cls = layer_class(conf["@type"])
    lc = cls.conf(**{k: v for k, v in conf.items() if k != "@type"})
    lc = LayerConf(lc.type, bake_layer_defaults(lc.fields, GlobalConf()))
    return cls(lc, torch.device("cpu"))


def job_pipeline(conf_json, params, batches, axes, n_micro=4,
                 epochs=1, hold_check=False, checkpointing=False,
                 hold_updater=False):
    """``PipelineTrainer.fit`` over the ``stage`` axis of ``axes``: the
    final params (whole on every rank), the scores, the trainer's stats,
    and with ``hold_check`` what the rank held between steps (its blocks'
    param bytes and the storage of every block's params)."""
    import json

    from deeplearning4j_tpu_torch.datasets import ListDataSetIterator
    from deeplearning4j_tpu_torch.parallel.pipeline_trainer import (
        PipelineTrainer)

    if checkpointing:
        d = json.loads(conf_json)
        d["global_conf"]["gradient_checkpointing"] = True
        conf_json = json.dumps(d)
    net = _net(conf_json, params)
    trainer = PipelineTrainer(net, mesh=_mesh(axes), n_microbatches=n_micro)
    scores, holds = [], []

    class Listen:
        def iteration_done(self, model, iteration):
            scores.append(float(model.score_value))
            if hold_check:
                i0, i1 = trainer.block_range
                tensors = [list(model.params_list[i].values())
                           + ([t for slots in model.updater_state[i].values()
                               for t in slots.values()] if hold_updater
                              else [])
                           for i in range(i0, i1)]
                holds.append({
                    "held": trainer.held_bytes(),
                    "storage": [min(t.untyped_storage().size() for t in ts)
                                for ts in tensors]})

    net.set_listeners(Listen())
    trainer.fit(ListDataSetIterator(_datasets(batches)), epochs=epochs)
    return {"params": _np(net.params_list), "scores": scores,
            "iteration": net.iteration, "holds": holds,
            "updater": _np(net.updater_state), "stats": trainer.stats(),
            "own": trainer.own, "last_batch_size": net.last_batch_size}


def job_pipeline_parallel(block_conf, stacked, x, axes, n_micro=4):
    """``PipelineParallel`` of one block type over stacked params: the
    output and ``reference_forward`` on the last stage, and the gradients
    of ``sum(out ** 2)`` (there) with respect to the stacked params and
    the input, summed over the stages."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from deeplearning4j_tpu_torch.parallel.pipeline import PipelineParallel

    block = _layer(block_conf)
    mesh = _mesh(axes)
    n_blocks = next(iter(stacked.values())).shape[0]
    pipe = PipelineParallel(
        mesh, lambda p, h: block.apply(p, h, None, True, None),
        n_blocks=n_blocks, n_microbatches=n_micro)
    st = {k: torch.tensor(v, requires_grad=True) for k, v in stacked.items()}
    xt = torch.tensor(x, requires_grad=True)
    out = pipe(st, xt)
    # the sequential oracle and its autograd gradients
    rst = {k: torch.tensor(v, requires_grad=True) for k, v in stacked.items()}
    rx = torch.tensor(x, requires_grad=True)
    ref = pipe.reference_forward(rst, rx)
    (ref ** 2).sum().backward()
    loss = (out ** 2).sum() if pipe.is_last else (out * 0).sum()
    loss.backward()
    grads = {k: v.grad.clone() for k, v in st.items()}
    gx = (xt.grad.clone() if xt.grad is not None
          else torch.zeros_like(xt))
    group = pipe.group
    for t in list(grads.values()) + [gx]:
        if group is not None:
            dist.all_reduce(t, group=group)
    return {"out": _np(out) if pipe.is_last else None,
            "ref": _np(ref), "grads": _np(grads), "gx": _np(gx),
            "ref_grads": _np({k: v.grad for k, v in rst.items()}),
            "ref_gx": _np(rx.grad),
            "stats": pipe.stats(), "is_last": pipe.is_last,
            "zeros": bool(np.all(_np(out) == 0)) if not pipe.is_last
            else None}


def job_moe_ffn(layer_conf, params, x, axes, axis, capacity_factor,
                whole=False):
    """``expert_parallel_ffn`` on this rank's rows of ``x`` (or, with
    ``whole``, ``ExpertParallelMoE`` on all of it): the rows' output, the
    aux share, and the gradients of ``sum(y ** 2) + aux`` summed over the
    axis."""
    import torch
    import torch.distributed as dist

    from deeplearning4j_tpu_torch.parallel import moe

    layer = _layer(layer_conf)
    mesh = _mesh(axes)
    pt = {k: torch.tensor(v, requires_grad=True) for k, v in params.items()}
    xt = torch.tensor(x)
    if whole:
        y = moe.ExpertParallelMoE(layer, mesh, axis, capacity_factor)(pt, xt)
        return {"y": _np(y)}
    n, i = mesh.shape[axis], mesh.coords[axis]
    mine = xt.chunk(n)[i]
    moe.reset_stats()
    y, aux = moe.expert_parallel_ffn(layer, pt, mine, mesh, axis,
                                     capacity_factor, train=True)
    # summed over the ranks: sum(y ** 2) over the batch plus the mean of
    # the aux shares (JAX's global term)
    ((y ** 2).sum() + aux / n).backward()
    grads = {k: v.grad.clone() for k, v in pt.items()}
    for t in grads.values():
        dist.all_reduce(t, group=mesh.group(axis))
    return {"y": _np(y), "aux": float(aux), "grads": _np(grads),
            "tokens": moe.stats()}


def job_shard_tp(conf_json, params, axes):
    """``mesh.shard_params_for_tp``: this rank's blocks."""
    from deeplearning4j_tpu_torch.parallel.mesh import shard_params_for_tp
    net = _net(conf_json, params)
    return {"blocks": _np(shard_params_for_tp(net.params_list, net.conf,
                                              _mesh(axes)))}


JOBS = {"pipeline": job_pipeline, "pipeline_parallel": job_pipeline_parallel,
        "moe_ffn": job_moe_ffn, "shard_tp": job_shard_tp,
        "wrapper": job_wrapper, "master": job_master, "checkpoint":
        job_checkpoint,
        "early_stopping": job_early_stopping, "attention": job_attention,
        "raises": job_raises, "mesh": job_mesh,
        "whole_view": job_whole_view, "restore_onto": job_restore_onto}


def _child(d, world, rank):
    import datetime

    import torch
    torch.set_num_threads(1)
    from deeplearning4j_tpu_torch.parallel.mesh import init_distributed
    init_distributed(f"file://{d}/rendezvous", int(world), int(rank),
                     device="cpu", timeout=datetime.timedelta(seconds=120))
    with open(os.path.join(d, "jobs.pkl"), "rb") as f:
        jobs = pickle.load(f)
    out = {}
    for name, kw in jobs:
        kw = dict(kw)
        fn = JOBS[kw.pop("job")]
        try:
            out[name] = fn(**kw)
        except Exception:
            print(f"job {name} failed on rank {rank}:\n"
                  f"{traceback.format_exc()}", flush=True)
            os._exit(1)
    with open(os.path.join(d, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)
    import torch.distributed as dist
    dist.destroy_process_group()


if __name__ == "__main__":
    _child(*sys.argv[1:])
