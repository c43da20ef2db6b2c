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
                single=False, hold_check=False):
    """Train through ``ParallelWrapper`` (``knobs``: builder calls as
    ``(method, args)``); with ``single`` through the network's own ``fit``
    instead. Returns the final params, states and updater state, the
    scores, the first batch's checksum and the wrapper's counters."""
    from deeplearning4j_tpu_torch.datasets import ListDataSetIterator
    from deeplearning4j_tpu_torch.parallel import ParallelWrapper

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
            "stats": {} if pw is None else {
                k: v for k, v in pw.stats().items() if isinstance(k, str)
                and not isinstance(v, dict)}}


def _held(net, pw):
    """What a rank holds between ZeRO steps: the bytes of its param shards
    and updater-state shards, and the storage of the network's sharded
    params."""
    from deeplearning4j_tpu_torch.parallel.partition import tree_nbytes
    sh = pw._sync_step.sharding
    storage = sorted({p.untyped_storage().size() for d in net.params_list
                      for p in d.values()})
    return {"param_bytes": sh.held_bytes(),
            "updater_bytes": tree_nbytes(net.updater_state),
            "min_storage": storage[0]}


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


_REFUSALS = {"ulysses_heads": _refuse_indivisible_heads,
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
                   every=1):
    """``ParallelWrapper.fit`` with a ``CheckpointListener(sharded=True)``
    saving every ``every`` iterations into ``directory`` (every rank
    writes its own blocks). Returns the final params, updater state and
    iteration, and the smallest param storage the listener saw (0 when
    the rank held only its shards)."""
    from deeplearning4j_tpu_torch.datasets import ListDataSetIterator
    from deeplearning4j_tpu_torch.optimize.listeners import (
        CheckpointListener)
    from deeplearning4j_tpu_torch.parallel import ParallelWrapper

    net = _net(conf_json, params)
    seen = []

    class Storage:
        def iteration_done(self, model, iteration):
            seen.append(min(p.untyped_storage().size()
                            for d in model.params_list for p in d.values()))

    net.set_listeners(Storage(), CheckpointListener(
        directory, every_n_iterations=every, every_n_epochs=None,
        keep_last=2, sharded=True))
    b = ParallelWrapper.builder(net).prefetch_buffer(0)
    for method, args in knobs:
        b = getattr(b, method)(*args)
    b.build().fit(ListDataSetIterator(_datasets(batches)))
    return {"params": _np(net.params_list), "updater": _np(net.updater_state),
            "iteration": net.iteration, "min_storage": min(seen)}


JOBS = {"wrapper": job_wrapper, "master": job_master, "checkpoint":
        job_checkpoint,
        "early_stopping": job_early_stopping, "attention": job_attention,
        "raises": job_raises, "mesh": job_mesh}


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
