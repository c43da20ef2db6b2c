"""The port's diagnostics plane (A9.3): the flight recorder, the step
watchdog and the training-health monitor, held against the JAX package.

- ``tests/test_flight_recorder.py``'s contracts run on the port's objects
  (``_torch_port.run_on_port``): the ring, the kill switch, the bundle's
  file set, the exception and signal egress, the cadence rule, fits with a
  monitor (healthy and NaN), the shared invalid-score predicate, the
  watchdog and the fit loop's step events;
- ``health_terms`` on the same numpy arrays as JAX's within 1e-6 relative;
- a small dense net and a two-layer ``transformer_lm``, from the JAX
  weights (``convert.from_jax``), fit with ``HealthMonitor(cadence=4)``
  eagerly and through ``fit_iterator(ksteps=8)`` in both packages: every
  summary within 1e-5 relative of JAX's, the same checks and alarm
  iterations, and the parameters bitwise those of an unmonitored port fit
  (the plain steps are the unmonitored ones; the monitored step's update is
  the same arithmetic);
- a NaN batch alarms at the same iteration in both packages;
- a monitored fit on the default device raises without CUDA;
- nothing is left behind: no signal handler, watchdog thread or dump
  directory.
"""
import os
import signal
import threading

import numpy as np
import pytest
import torch

from _torch_port import compile_cache_at, jax_lm, run_on_port
from deeplearning4j_tpu.datasets.dataset import DataSet as JDataSet
from deeplearning4j_tpu.nn.conf.builders import (
    NeuralNetConfiguration as JConf)
from deeplearning4j_tpu.nn.conf.layers import (
    DenseLayer as JDense, OutputLayer as JOutput)
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JNet
from deeplearning4j_tpu.observability import health as jhealth
from deeplearning4j_tpu_torch.convert import from_jax
from deeplearning4j_tpu_torch.datasets import DataSet, ListDataSetIterator
from deeplearning4j_tpu_torch.nn.conf import NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.conf.layers import DenseLayer, OutputLayer
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.observability import (
    FlightRecorder, HealthMonitor, MetricsRegistry, NanAlertListener,
    flight_recorder, global_recorder, global_watchdog, health_terms)
from deeplearning4j_tpu_torch.observability import health as phealth
import deeplearning4j_tpu_torch.observability as pobs

CADENCE, KSTEPS = 4, 8
SUMMARY_RTOL = 1e-5


@pytest.fixture(autouse=True)
def nothing_left_behind():
    """Every test leaves the process as it found it: the signal handlers,
    no watchdog or its thread, the global recorder's dump directory."""
    sigs = (signal.SIGTERM, signal.SIGUSR1)
    handlers = {s: signal.getsignal(s) for s in sigs}
    rec = global_recorder()
    dump_dir = rec.dump_dir
    yield
    assert {s: signal.getsignal(s) for s in sigs} == handlers
    assert global_watchdog() is None
    assert not any(t.name == "dl4j-step-watchdog" and t.is_alive()
                   for t in threading.enumerate())
    assert rec.dump_dir == dump_dir


# --------------------------------------------------- the JAX contracts
def _port_small_net():
    conf = (NeuralNetConfiguration.builder().seed(0).learning_rate(0.1)
            .list()
            .layer(DenseLayer.conf(n_in=4, n_out=8, activation="tanh"))
            .layer(OutputLayer.conf(n_in=8, n_out=3, loss="mcxent",
                                    activation="softmax"))
            .build())
    return MultiLayerNetwork(conf, device="cpu").init()


FLIGHT_CONTRACTS = [
    "test_ring_buffer_bounds_and_eviction", "test_ring_buffer_thread_safety",
    "test_kill_switch", "test_dump_bundle_completeness",
    "test_list_bundles_newest_first", "test_exception_escape_dumps_once",
    "test_signal_handler_dumps", "test_health_cadence_logic",
    "test_healthy_fit_checks_without_alarm",
    "test_nan_injection_alarms_and_dumps",
    "test_nan_alert_listener_score_fallback",
    "test_invalid_score_predicate_shared",
    "test_watchdog_fires_once_on_stall", "test_watchdog_silent_on_healthy_run",
    "test_watchdog_unarmed_until_first_beat",
    "test_global_watchdog_beat_hook", "test_fit_records_step_events"]
PORTED_MODULES = [
    "deeplearning4j_tpu.observability.flight_recorder",
    "deeplearning4j_tpu.observability.health",
    "deeplearning4j_tpu.observability.watchdog",
    "deeplearning4j_tpu.observability.metrics",
    "deeplearning4j_tpu.earlystopping.termination",
    "deeplearning4j_tpu.datasets.dataset",
    "deeplearning4j_tpu.datasets.iterators"]


@pytest.mark.parametrize("name", FLIGHT_CONTRACTS)
def test_jax_flight_recorder_contract_holds_on_port(name, monkeypatch,
                                                    tmp_path, caplog):
    import sys

    import test_flight_recorder as contracts

    # the contracts' net, the recorder module they patch and the package
    # they import inside a body are the port's
    monkeypatch.setattr(contracts, "_small_net", _port_small_net)
    monkeypatch.setattr(contracts, "fr_mod", flight_recorder)
    monkeypatch.setitem(sys.modules, "deeplearning4j_tpu.observability",
                        pobs)
    kw = {}
    if "tmp_path" in contracts.__dict__[name].__code__.co_varnames:
        kw["tmp_path"] = tmp_path
    if "monkeypatch" in contracts.__dict__[name].__code__.co_varnames:
        kw["monkeypatch"] = monkeypatch
    if "caplog" in contracts.__dict__[name].__code__.co_varnames:
        kw["caplog"] = caplog
    run_on_port("test_flight_recorder", name, monkeypatch, PORTED_MODULES,
                **kw)


# --------------------------------------------------------- health_terms
def _term_trees(seed: int, nan: bool):
    rng = np.random.default_rng(seed)
    shapes = {"W": (5, 3), "b": (3,), "gamma": (7,)}
    grads = [{k: rng.normal(size=s).astype(np.float32)
              for k, s in shapes.items()} for _ in range(2)]
    params = [{k: rng.normal(size=s).astype(np.float32)
               for k, s in shapes.items()} for _ in range(2)]
    new = [{k: (v - 0.1 * grads[i][k]).astype(np.float32)
            for k, v in p.items()} for i, p in enumerate(params)]
    if nan:
        grads[1]["W"][2, 1] = np.nan
        grads[0]["b"][0] = np.inf
    return grads, params, new, np.float32(1.7)


@pytest.mark.parametrize("nan", [False, True])
def test_health_terms_match_jax(nan):
    import jax
    import jax.numpy as jnp

    grads, params, new, loss = _term_trees(3, nan)
    want = np.asarray(jax.jit(jhealth.health_terms)(
        jax.tree_util.tree_map(jnp.asarray, grads),
        jax.tree_util.tree_map(jnp.asarray, params),
        jax.tree_util.tree_map(jnp.asarray, new), jnp.float32(loss)))
    t = lambda tree: [{k: torch.from_numpy(v) for k, v in d.items()}
                      for d in tree]
    got = health_terms(t(grads), t(params), t(new), torch.tensor(loss))
    assert got.dtype == torch.float32 and got.shape == (4,)
    got = got.numpy()
    if nan:
        assert np.isnan(got[0]) and np.isnan(want[0])
        assert got[2] == want[2] == 2.0
        np.testing.assert_allclose(got[[1, 3]], want[[1, 3]], rtol=1e-6)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-6)
    # the snapshot route: the old params as the flat buffer the step owns
    flat = phealth.ParamSnapshot().take(t(params))
    np.testing.assert_array_equal(
        health_terms(t(grads), flat, t(new), torch.tensor(loss)).numpy(),
        got)


def test_health_terms_values():
    grads = [torch.ones((2, 2)), torch.zeros(3)]
    params = [torch.zeros((2, 2)), torch.zeros(3)]
    new_params = [torch.full((2, 2), 0.5), torch.zeros(3)]
    g, u, nf, loss = health_terms(grads, params, new_params,
                                  torch.tensor(1.25)).tolist()
    assert (g, u, nf, loss) == (2.0, 1.0, 0.0, 1.25)
    grads[0][0, 0] = float("nan")
    assert health_terms(grads, params, new_params, 1.25)[2] == 1.0


def test_invalid_score_is_one_object():
    from deeplearning4j_tpu_torch.earlystopping import termination
    assert termination.is_invalid_score is phealth.is_invalid_score \
        is pobs.is_invalid_score


# ------------------------------------------- monitored fits against JAX
class _Summaries:
    """A monitor's every resolved summary (works on either package's
    ``HealthMonitor``: wraps its ``_resolve``)."""

    def __init__(self, hm):
        self.hm, self.seen = hm, []
        inner = hm._resolve

        def resolve(*a):
            alarm = inner(*a)
            self.seen.append(dict(hm.last))
            return alarm
        hm._resolve = resolve


def _dense_jconf():
    return (JConf.builder().seed(0).learning_rate(0.1).updater("adam").list()
            .layer(JDense(n_in=6, n_out=10, activation="tanh"))
            .layer(JOutput(n_in=10, n_out=3, loss="mcxent",
                           activation="softmax"))
            .build())


def _dense_batches(n: int, nan_at=None):
    rng = np.random.default_rng(7)
    out = []
    for i in range(n):
        x = rng.normal(size=(12, 6)).astype(np.float32)
        y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, 12)]
        if i == nan_at:
            x[3, 2] = np.nan
        out.append((x, y))
    return out


def _lm_batches(n: int, vocab: int, T: int, nan_at=None):
    rng = np.random.default_rng(11)
    out = []
    for i in range(n):
        ids = rng.integers(0, vocab, size=(4, T))
        x = np.eye(vocab, dtype=np.float32)[ids]
        if i == nan_at:
            x[1, 2, 0] = np.nan
        out.append((x, x))
    return out


LM = {"vocab": 16, "width": 16, "n_layers": 2, "n_heads": 2, "max_len": 8}


def _model(kind, cache):
    """``(JAX net, its config's JSON, params as numpy)``."""
    with compile_cache_at(cache):
        if kind == "dense":
            jnet = JNet(_dense_jconf()).init()
            params = [{k: np.asarray(v) for k, v in p.items()}
                      for p in jnet.params_list]
        else:
            jnet, params = jax_lm(seed=5, **LM)
    return jnet, jnet.conf.to_json(), params


def _batches(kind, n, nan_at=None):
    if kind == "dense":
        return _dense_batches(n, nan_at)
    return _lm_batches(n, LM["vocab"], LM["max_len"], nan_at)


STEPS = 12


def _jax_monitored(kind, route, cache, nan_at=None):
    jnet, conf_json, params = _model(kind, cache)
    with compile_cache_at(cache):
        hm = jhealth.HealthMonitor(cadence=CADENCE, registry=_jax_registry(),
                                   dump_on_alarm=False).attach(jnet)
        log = _Summaries(hm)
        jnet.set_listeners(jhealth.NanAlertListener())
        batches = _batches(kind, STEPS, nan_at)
        if route == "eager":
            for x, y in batches:
                jnet.fit(x, y)
        else:
            jnet.fit_iterator([JDataSet(x, y) for x, y in batches],
                              ksteps=KSTEPS)
        hm.poll()
    return conf_json, params, hm, log.seen


def _jax_registry():
    from deeplearning4j_tpu.observability.metrics import MetricsRegistry as R
    return R()


def _port_fit(conf_json, params, kind, route, monitored, nan_at=None):
    net = from_jax(conf_json, params, device="cpu")
    hm = log = None
    if monitored:
        hm = HealthMonitor(cadence=CADENCE, registry=MetricsRegistry(),
                           dump_on_alarm=False).attach(net)
        log = _Summaries(hm)
        net.set_listeners(NanAlertListener())
    batches = _batches(kind, STEPS, nan_at)
    if route == "eager":
        for x, y in batches:
            net.fit(x, y)
    else:
        net.fit_iterator(ListDataSetIterator(
            [DataSet(x, y) for x, y in batches]), ksteps=KSTEPS)
    if hm is not None:
        hm.poll()
    return net, hm, log


def _rel(a: float, b: float) -> float:
    return abs(a - b) / max(abs(b), 1e-12)


@pytest.mark.parametrize("route", ["eager", "ksteps"])
@pytest.mark.parametrize("kind", ["dense", "lm"])
def test_monitored_fit_matches_jax(kind, route, tmp_path):
    conf_json, params, jhm, jseen = _jax_monitored(kind, route, tmp_path)
    net, hm, log = _port_fit(conf_json, params, kind, route, True)
    plain, _, _ = _port_fit(conf_json, params, kind, route, False)
    # eager: every 4th step; K-step groups of 8: one check a group
    want_its = ([0, 4, 8] if route == "eager" else [0, 8])
    assert [s["iteration"] for s in log.seen] == \
        [s["iteration"] for s in jseen] == want_its
    assert hm.checks == jhm.checks == len(want_its)
    assert hm.alarms == jhm.alarms == 0
    for got, want in zip(log.seen, jseen):
        for k in ("grad_norm", "update_norm", "loss"):
            assert _rel(got[k], want[k]) <= SUMMARY_RTOL, (k, got, want)
        assert got["nonfinite_grads"] == want["nonfinite_grads"] == 0.0
    # the monitored fit trains exactly as the unmonitored one
    for a, b in zip(net.params_list, plain.params_list):
        for k in a:
            assert torch.equal(a[k], b[k]), k
    assert net.iteration == plain.iteration == STEPS


@pytest.mark.parametrize("kind", ["dense", "lm"])
def test_nan_batch_alarms_at_jax_iteration(kind, tmp_path):
    """A NaN feature at iteration 5 poisons the parameters; the next due
    check (iteration 8) sees non-finite gradients in both packages."""
    conf_json, params, jhm, _ = _jax_monitored(kind, "ksteps", tmp_path,
                                               nan_at=5)
    _, hm, _ = _port_fit(conf_json, params, kind, "ksteps", True, nan_at=5)
    assert hm.alarm["why"] == jhm.alarm["why"] == "nonfinite-grads"
    assert hm.alarm["iteration"] == jhm.alarm["iteration"] == 8
    assert hm.alarms == jhm.alarms == 1 and hm.checks == jhm.checks == 2


def test_monitored_fit_records_group_events_and_beats():
    rec = global_recorder()
    before = len(rec.snapshot())
    net = _port_small_net()
    HealthMonitor(cadence=CADENCE, registry=MetricsRegistry()).attach(net)
    beats = []
    wd = pobs.watchdog.StepWatchdog(60.0, registry=MetricsRegistry())
    wd.heartbeat = lambda step=None: beats.append(step)
    pobs.watchdog._GLOBAL = wd
    try:
        x, y = _dense_batches(1)[0]
        net.fit(x[:, :4], y, epochs=10)
    finally:
        pobs.watchdog._GLOBAL = None
    events = [e for e in rec.snapshot()[before:] if e["kind"] == "step"]
    assert [(e["path"], e["it"], e["k"]) for e in events] == [
        ("MultiLayerNetwork.multistep_health", 0, 8),
        ("MultiLayerNetwork.multistep_health", 8, 2)]
    assert all(isinstance(e["dispatch_s"], float) for e in events)
    assert beats == [8, 10]


def test_default_device_monitored_fit_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    conf = _port_small_net().conf
    x, y = _dense_batches(1)[0]
    with pytest.raises(RuntimeError, match="CUDA"):
        net = MultiLayerNetwork(conf)
        HealthMonitor().attach(net.init())
        net.fit(x[:, :4], y, epochs=8)


def test_dump_reads_no_device_and_names_the_graphs(tmp_path):
    """The bundle's environment and cost sections come from host state: the
    process's CUDA state is left alone where it is not initialized."""
    rec = FlightRecorder(capacity=8, dump_dir=str(tmp_path),
                         registry=MetricsRegistry())
    rec.record("step", it=0, k=2)
    path = rec.dump(reason="probe")
    import json
    with open(os.path.join(path, "environment.json")) as f:
        env = json.load(f)
    with open(os.path.join(path, "cost_analysis.json")) as f:
        cost = json.load(f)
    assert env["torch_version"] == torch.__version__
    assert "devices" not in env or torch.cuda.is_initialized()
    assert isinstance(cost["step_graphs"], list)
    assert "flash_fwd" in cost["launches"]
    assert sorted(os.listdir(path)) == sorted(flight_recorder.BUNDLE_FILES)
