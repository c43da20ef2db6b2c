"""The port's training listeners (``optimize/listeners.py``) and early
stopping (``earlystopping/``) held against the JAX package on the CPU.

Both packages train the same network from the same weights (converted by
``convert.from_jax``) on the same batches (SGD, plain float32 dense and
convolution layers):

- each listener fires at the iterations where the JAX one fires, and the
  scores ``CollectScoresIterationListener`` and
  ``ParamAndGradientIterationListener`` record are the JAX ones within
  1e-5 relative (float32 sums in another order over a few steps);
- ``CheckpointListener`` keeps the files the JAX one keeps, each restores
  with the network's leaves at that save, and ``last_checkpoint`` picks
  the JAX choice;
- ``EarlyStoppingTrainer`` on a ``MultiLayerNetwork`` and on a
  ``ComputationGraph`` stops at the JAX epoch for the JAX reason with the
  JAX best epoch; the epoch scores within 1e-5 relative;
- the in-memory saver's best model keeps its weights while the network
  trains on: the port's updater writes params in place, so the saver
  clones them.
"""
import glob
import logging
import math
import os

import numpy as np
import pytest
import torch

from _torch_port import _np_tree as _np
from _torch_port import compile_cache_at
from deeplearning4j_tpu import earlystopping as jes
from deeplearning4j_tpu.datasets.dataset import DataSet as JDataSet
from deeplearning4j_tpu.datasets.iterators import (
    ListDataSetIterator as JListIt)
from deeplearning4j_tpu.nn.conf.builders import NeuralNetConfiguration as JNNC
from deeplearning4j_tpu.nn.conf.inputs import InputType as JInputType
from deeplearning4j_tpu.nn.conf.layers import (
    ConvolutionLayer, DenseLayer, OutputLayer)
from deeplearning4j_tpu.nn.conf.vertices import MergeVertex
from deeplearning4j_tpu.nn.graph_network import ComputationGraph as JGraph
from deeplearning4j_tpu.nn.graph_network import MultiDataSet as JMDS
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JNet
from deeplearning4j_tpu.observability.health import is_invalid_score as jinvalid
from deeplearning4j_tpu.optimize import listeners as jl
from deeplearning4j_tpu_torch import earlystopping as tes
from deeplearning4j_tpu_torch.convert import from_jax, to_numpy
from deeplearning4j_tpu_torch.datasets.dataset import DataSet
from deeplearning4j_tpu_torch.datasets.iterators import ListDataSetIterator
from deeplearning4j_tpu_torch.nn.graph_network import MultiDataSet
from deeplearning4j_tpu_torch.optimize import listeners as tl
from deeplearning4j_tpu_torch.utils.model_serializer import guess_model

REL = 1e-5


def _mln_conf(lr=0.1):
    return (JNNC.builder().seed(21).learning_rate(lr).weight_init("xavier")
            .list()
            .layer(ConvolutionLayer(n_out=3, kernel_size=(3, 3),
                                    stride=(1, 1), activation="tanh"))
            .layer(DenseLayer(n_out=10, activation="tanh"))
            .layer(OutputLayer(n_out=3, loss="mcxent", activation="softmax"))
            .set_input_type(JInputType.convolutional_flat(6, 6, 1))
            .build())


def _graph_conf(lr=0.1):
    return (JNNC.builder().seed(22).learning_rate(lr).weight_init("xavier")
            .graph_builder().add_inputs("a", "b")
            .add_layer("da", DenseLayer(n_in=4, n_out=6, activation="tanh"),
                       "a")
            .add_layer("db", DenseLayer(n_in=3, n_out=5, activation="tanh"),
                       "b")
            .add_vertex("m", MergeVertex(), "da", "db")
            .add_layer("out", OutputLayer(n_in=11, n_out=3, loss="mcxent",
                                          activation="softmax"), "m")
            .set_outputs("out").build())


def _mln_data(n_batches, seed, batch=8):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n_batches):
        x = rng.random((batch, 36)).astype(np.float32)
        lab = (x[:, :12].sum(1) > x[:, 12:24].sum(1)).astype(int) \
            + (x[:, 24:].sum(1) > 6.5).astype(int)
        out.append((x, np.eye(3, dtype=np.float32)[lab]))
    return out


def _graph_data(n_batches, seed, batch=8):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n_batches):
        a = rng.standard_normal((batch, 4)).astype(np.float32)
        b = rng.standard_normal((batch, 3)).astype(np.float32)
        lab = (a[:, 0] + b[:, 0] > 0).astype(int) + (a[:, 1] > 1).astype(int)
        out.append(([a, b], [np.eye(3, dtype=np.float32)[lab]]))
    return out


def _pair(conf, tmp_path, graph=False):
    """A JAX network and its port from the same weights."""
    with compile_cache_at(tmp_path / "x0"):
        jnet = (JGraph if graph else JNet)(conf).init()
    tnet = from_jax(conf.to_json(), _np(jnet.params_list), device="cpu")
    return jnet, tnet


def _listeners(pkg, tmp):
    m = jl if pkg == "jax" else tl
    return {
        "score": m.ScoreIterationListener(3),
        "collect": m.CollectScoresIterationListener(2),
        "perf": m.PerformanceListener(frequency=2, report=False),
        "time": m.TimeIterationListener(total_iterations=8, frequency=4),
        "params": m.ParamAndGradientIterationListener(
            iterations=3, print_mean_magnitudes=False,
            output_file=str(tmp / f"{pkg}_rows.jsonl")),
        "nan": m.NanScoreWatcher(),
        "fired": _Fired(m.IterationListener),
    }


def _Fired(base):
    class Fired(base):
        def __init__(self):
            self.iterations, self.epochs = [], 0

        def iteration_done(self, model, iteration):
            self.iterations.append(iteration)

        def on_epoch_end(self, model):
            self.epochs += 1
    return Fired()


def test_listeners_fire_at_the_jax_iterations(tmp_path, caplog):
    batches = _mln_data(4, seed=1)
    jnet, tnet = _pair(_mln_conf(), tmp_path)
    jls, tls = _listeners("jax", tmp_path), _listeners("port", tmp_path)
    jnet.set_listeners(*jls.values())
    tnet.set_listeners(*tls.values())
    logs = {}
    for pkg, net, ds_cls, it_cls in (("jax", jnet, JDataSet, JListIt),
                                     ("port", tnet, DataSet,
                                      ListDataSetIterator)):
        caplog.clear()
        with caplog.at_level(logging.INFO), \
                compile_cache_at(tmp_path / "x1"):
            net.fit_iterator(it_cls([ds_cls(x, y) for x, y in batches]),
                             epochs=2)
        logs[pkg] = [r.getMessage() for r in caplog.records
                     if "Score at iteration" in r.getMessage()]
    assert tnet.iteration == jnet.iteration == 8
    # ScoreIterationListener(3) logs at 3 and 6, the scores within REL
    assert [m.split(" is ")[0] for m in logs["port"]] == \
        [m.split(" is ")[0] for m in logs["jax"]] == \
        ["Score at iteration 3", "Score at iteration 6"]
    for a, b in zip(logs["port"], logs["jax"]):
        assert abs(float(a.split(" is ")[1]) - float(b.split(" is ")[1])) \
            <= REL * abs(float(b.split(" is ")[1]))
    j, t = jls["collect"].scores, tls["collect"].scores
    assert [i for i, _ in t] == [i for i, _ in j] == [2, 4, 6, 8]
    np.testing.assert_allclose([s for _, s in t], [float(s) for _, s in j],
                               rtol=REL)
    assert tls["perf"].last_iter == jls["perf"].last_iter == 8
    assert tls["perf"].samples_per_sec > 0
    rows_t, rows_j = tls["params"].rows, jls["params"].rows
    assert [r["iteration"] for r in rows_t] == [r["iteration"] for r in rows_j]
    for rt, rj in zip(rows_t, rows_j):
        assert set(rt) == set(rj)
        for k in rj:
            assert abs(rt[k] - rj[k]) <= REL * abs(rj[k]) + 1e-7, k
    assert len(open(tmp_path / "port_rows.jsonl").read().splitlines()) == \
        len(rows_j) == 2
    assert tls["fired"].iterations == jls["fired"].iterations == \
        list(range(1, 9))
    assert tls["fired"].epochs == jls["fired"].epochs == 2
    assert not tls["nan"].triggered


class _LazyScore:
    """A network stand-in whose score counts its reads."""

    def __init__(self, score):
        self._score, self.reads, self.params_list = score, 0, []
        self.last_batch_size = 4

    @property
    def score_value(self):
        self.reads += 1
        return self._score


def test_listeners_read_the_score_only_when_they_fire():
    model = _LazyScore(1.5)
    score = tl.ScoreIterationListener(5)
    for i in range(1, 11):
        score.iteration_done(model, i)
    assert model.reads == 2  # iterations 5 and 10
    nan = tl.NanScoreWatcher()
    with pytest.raises(FloatingPointError):
        nan.iteration_done(_LazyScore(float("nan")), 3)
    seen = []
    tl.NanScoreWatcher(lambda m, i, s: seen.append(i)).iteration_done(
        _LazyScore(float("inf")), 4)
    assert seen == [4]


def test_profiler_listener_traces_its_window(tmp_path):
    _, tnet = _pair(_mln_conf(), tmp_path)
    prof = tl.ProfilerListener(str(tmp_path / "trace"), start_iteration=2,
                               num_iterations=2)
    again = tl.ProfilerListener(str(tmp_path / "rep"), start_iteration=1,
                                num_iterations=1, repeat_every=3)
    tnet.set_listeners(prof)
    for x, y in _mln_data(6, seed=2):
        tnet.fit(x, y)
    assert prof.windows == [str(tmp_path / "trace")]
    s = prof.summaries[0]
    assert s["iterations"] == 2 and s["events"] > 0
    assert os.path.getsize(s["trace"]) > 0
    tnet.set_listeners(again)
    for x, y in _mln_data(7, seed=3):
        tnet.fit(x, y)
    # a window opens at the first iteration at or past start_iteration;
    # each stop moves start_iteration on by repeat_every (the JAX rule), so
    # here the next one opens right after: 7-8, 9-10, 11-12, 13-
    assert [os.path.basename(w) for w in again.windows] == \
        ["iter_7", "iter_9", "iter_11"]
    assert again._active_since == 13


def test_checkpoint_listener_keeps_the_jax_files(tmp_path):
    batches = _mln_data(3, seed=4)
    jnet, tnet = _pair(_mln_conf(), tmp_path)
    jdir, tdir = tmp_path / "jax", tmp_path / "port"
    jck = jl.CheckpointListener(str(jdir), every_n_iterations=2,
                                every_n_epochs=1, keep_last=3)
    tck = tl.CheckpointListener(str(tdir), every_n_iterations=2,
                                every_n_epochs=1, keep_last=3)
    saved = {}

    class Keep(tl.IterationListener):
        def iteration_done(self, model, iteration):
            if iteration % 2 == 0:
                saved[f"iter_{iteration}"] = to_numpy(model.params_list)

    jnet.set_listeners(jck)
    tnet.set_listeners(tck, Keep())
    with compile_cache_at(tmp_path / "x1"):
        jnet.fit_iterator(JListIt([JDataSet(x, y) for x, y in batches]),
                          epochs=2)
    tnet.fit_iterator(ListDataSetIterator([DataSet(x, y) for x, y in batches]),
                      epochs=2)

    def names(d):
        return sorted(os.path.basename(p) for p in glob.glob(str(d / "*")))

    assert names(tdir) == names(jdir)
    assert "latest.zip" in names(tdir)
    assert os.path.basename(tl.CheckpointListener.last_checkpoint(
        str(tdir))) == os.path.basename(
            jl.CheckpointListener.last_checkpoint(str(jdir)))
    for name in names(tdir):
        if name.startswith("checkpoint_iter_"):
            back = guess_model(str(tdir / name), device="cpu")
            tag = name[len("checkpoint_"):-len(".zip")]
            for own, ref in zip(to_numpy(back.params_list), saved[tag]):
                for k in ref:
                    np.testing.assert_array_equal(own[k], ref[k])
    # a new listener over the same directory rotates the files on disk
    again = tl.CheckpointListener(str(tdir), every_n_iterations=1,
                                  keep_last=3)
    assert len(again._written) == 3
    # no pointer and no zip: nothing to resume
    assert tl.CheckpointListener.last_checkpoint(str(tmp_path)) is None
    with pytest.raises(NotImplementedError, match="A7"):
        tl.CheckpointListener(str(tmp_path / "s"), sharded=True)


# ---------------------------------------------------------- early stopping
def _es_config(m, calc, saver, min_improvement=0.0):
    return (m.EarlyStoppingConfiguration.builder()
            .epoch_termination_conditions(
                m.MaxEpochsTerminationCondition(8),
                m.ScoreImprovementEpochTerminationCondition(1,
                                                            min_improvement))
            .iteration_termination_conditions(
                m.InvalidScoreIterationTerminationCondition())
            .score_calculator(calc).model_saver(saver)
            .save_last_model(True).build())


def _iters(pkg, batches, graph):
    if pkg == "jax":
        items = [JMDS(x, y) if graph else JDataSet(x, y) for x, y in batches]
        return JListIt(items)
    items = [MultiDataSet(x, y) if graph else DataSet(x, y)
             for x, y in batches]
    return ListDataSetIterator(items)


@pytest.mark.parametrize("graph", [False, True], ids=["mln", "graph"])
def test_early_stopping_stops_as_jax(graph, tmp_path):
    # rate 0.3: the stack's held-out loss turns up after epoch 2; the graph's
    # keeps falling, by less than 0.05 an epoch from epoch 2
    conf = _graph_conf(lr=0.3) if graph else _mln_conf(lr=0.3)
    min_improvement = 0.05 if graph else 0.0
    data = _graph_data if graph else _mln_data
    train, held = data(4, seed=5), data(3, seed=6)
    jnet, tnet = _pair(conf, tmp_path, graph)
    with compile_cache_at(tmp_path / "x1"):
        jres = jes.EarlyStoppingTrainer(
            _es_config(jes, jes.DataSetLossCalculator(_iters("jax", held,
                                                             graph)),
                       jes.InMemoryModelSaver(), min_improvement),
            jnet, _iters("jax", train, graph)).fit()
    saver = tes.LocalFileModelSaver(str(tmp_path / "best"), device="cpu")
    tres = tes.EarlyStoppingTrainer(
        _es_config(tes, tes.DataSetLossCalculator(_iters("port", held, graph)),
                   saver, min_improvement),
        tnet, _iters("port", train, graph)).fit()
    assert tres.termination_reason.value == jres.termination_reason.value
    assert tres.termination_details == jres.termination_details
    assert tres.total_epochs == jres.total_epochs
    assert tres.best_model_epoch == jres.best_model_epoch
    assert sorted(tres.score_vs_epoch) == sorted(jres.score_vs_epoch)
    np.testing.assert_allclose(
        [tres.score_vs_epoch[e] for e in sorted(tres.score_vs_epoch)],
        [jres.score_vs_epoch[e] for e in sorted(jres.score_vs_epoch)],
        rtol=REL)
    # the configuration stops by score improvement before the epoch cap
    assert tres.termination_reason is tes.TerminationReason.\
        EPOCH_TERMINATION_CONDITION
    assert "ScoreImprovement" in tres.termination_details
    assert tres.total_epochs < 8
    if not graph:
        assert tres.best_model_epoch < tres.total_epochs - 1
    # the best model is read back from its zip, at the best epoch's score
    best = tres.best_model
    assert type(best) is type(tnet)
    calc = tes.DataSetLossCalculator(_iters("port", held, graph))
    assert abs(calc.calculate_score(best) - tres.best_model_score) <= \
        1e-6 * abs(tres.best_model_score)
    assert saver.get_latest_model().iteration == tnet.iteration


def test_in_memory_best_model_does_not_follow_training(tmp_path):
    batches = _mln_data(4, seed=7)
    _, tnet = _pair(_mln_conf(), tmp_path)
    saver = tes.InMemoryModelSaver()
    res = tes.EarlyStoppingTrainer(
        _es_config(tes, tes.DataSetLossCalculator(
            _iters("port", _mln_data(2, seed=8), False)), saver),
        tnet, _iters("port", batches, False)).fit()
    best = saver.get_best_model()
    frozen = best.params().clone()
    frozen_upd = to_numpy(best.updater_state)
    assert not torch.equal(frozen, tnet.params()) or \
        res.best_model_epoch == res.total_epochs - 1
    for x, y in batches:
        tnet.fit(x, y)
    assert torch.equal(best.params(), frozen)
    for own, ref in zip(to_numpy(best.updater_state), frozen_upd):
        for k in ref:
            for s in ref[k]:
                np.testing.assert_array_equal(own[k][s], ref[k][s])
    assert best is not tnet and best.params().data_ptr() != \
        tnet.params().data_ptr()


def test_iteration_conditions_and_errors_end_as_in_jax(tmp_path):
    batches = _mln_data(3, seed=9)
    jnet, tnet = _pair(_mln_conf(), tmp_path)
    results = {}
    for pkg, m, net in (("jax", jes, jnet), ("port", tes, tnet)):
        cfg = (m.EarlyStoppingConfiguration.builder()
               .epoch_termination_conditions(
                   m.MaxEpochsTerminationCondition(5))
               .iteration_termination_conditions(
                   m.MaxScoreIterationTerminationCondition(0.5))
               .build())
        with compile_cache_at(tmp_path / f"x{pkg}"):
            results[pkg] = m.EarlyStoppingTrainer(
                cfg, net, _iters(pkg, batches, False)).fit()
    j, t = results["jax"], results["port"]
    assert t.termination_reason.value == j.termination_reason.value == \
        "IterationTerminationCondition"
    assert t.termination_details == j.termination_details
    assert t.total_epochs == j.total_epochs == 0
    assert tnet.iteration == jnet.iteration == 1

    class Boom(tes.ScoreCalculator):
        def calculate_score(self, model):
            raise RuntimeError("held-out data unreadable")

    cfg = tes.EarlyStoppingConfiguration(
        epoch_termination_conditions=[tes.MaxEpochsTerminationCondition(2)],
        score_calculator=Boom())
    with pytest.raises(RuntimeError, match="unreadable"):
        # an epoch's scoring is outside the training try, as in JAX
        tes.EarlyStoppingTrainer(cfg, tnet, _iters("port", batches, False)
                                 ).fit()

    class BadIter:
        def __iter__(self):
            raise OSError("disk gone")

    res = tes.EarlyStoppingTrainer(cfg, tnet, BadIter()).fit()
    assert res.termination_reason is tes.TerminationReason.ERROR
    assert res.termination_details == "disk gone"
    # the data-parallel trainer (a group of one here) ends the same way
    res = tes.EarlyStoppingParallelTrainer(cfg, tnet, BadIter()).fit()
    assert res.termination_reason is tes.TerminationReason.ERROR
    assert res.termination_details == "disk gone"


@pytest.mark.parametrize("score", [None, "x", float("nan"), float("inf"),
                                   -float("inf"), 0.0, 3, np.float32(2.5),
                                   torch.tensor(1.0), torch.tensor(math.nan)])
def test_is_invalid_score_is_the_jax_predicate(score):
    ref = jinvalid(score.item() if isinstance(score, torch.Tensor) else score)
    assert tes.is_invalid_score(score) is ref


def test_termination_conditions_match_jax():
    scores = [3.0, 2.0, 2.5, 1.9, 1.95, 1.96, 1.97]
    for jc, tc in ((jes.ScoreImprovementEpochTerminationCondition(1, 0.05),
                    tes.ScoreImprovementEpochTerminationCondition(1, 0.05)),
                   (jes.BestScoreEpochTerminationCondition(1.95),
                    tes.BestScoreEpochTerminationCondition(1.95)),
                   (jes.MaxEpochsTerminationCondition(4),
                    tes.MaxEpochsTerminationCondition(4))):
        jc.initialize()
        tc.initialize()
        assert [tc.terminate(e, s) for e, s in enumerate(scores)] == \
            [jc.terminate(e, s) for e, s in enumerate(scores)]
        assert repr(tc) == repr(jc)
    with pytest.raises(ValueError):
        tes.MaxEpochsTerminationCondition(0)
    t = tes.MaxTimeIterationTerminationCondition(0.0)
    assert not t.terminate(1.0)  # not initialized yet
    t.initialize()
    assert t.terminate(1.0)
