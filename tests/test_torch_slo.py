"""The port's SLO engine (A9.2), held against the JAX package.

- ``tests/test_tracing.py``'s SLO contracts run on the port's objects: the
  burn-rate math on synthetic histogram windows (the multi-window guard,
  the gauge flip, one flight-recorder bundle at the alert edge, the
  exemplar naming a stored trace) and the availability objective;
- both engines, fed the same synthetic registry snapshots (made from a
  seed with numpy) on the same injected clock, return the same
  ``evaluate()`` payload, export the same ``dl4j_slo_*`` series and dump
  the same bundles;
- ``default_serve_objectives`` reads the same ``DL4J_SLO_*`` variables;
  bad objectives raise the JAX errors;
- the ticker starts and stops; the server evaluates ``GET /serve/slo``
  and hands its engine to the autoscaler.

Burn rates and fractions are compared exactly: both engines round the same
float64 arithmetic at the same places.
"""
import http.client
import json
import time

import numpy as np
import pytest

from _torch_port import run_on_port
from deeplearning4j_tpu.observability import flight_recorder as jfr
from deeplearning4j_tpu.observability import metrics as jmetrics
from deeplearning4j_tpu.observability import slo as jslo
from deeplearning4j_tpu.observability import tracing as jtracing
from deeplearning4j_tpu_torch.keras_server import InferenceServer
from deeplearning4j_tpu_torch.observability import flight_recorder as fr
from deeplearning4j_tpu_torch.observability import metrics
from deeplearning4j_tpu_torch.observability import names as _n
from deeplearning4j_tpu_torch.observability import slo
from deeplearning4j_tpu_torch.observability import tracing

SLO_MODULES = ["deeplearning4j_tpu.observability.slo",
               "deeplearning4j_tpu.observability.tracing",
               "deeplearning4j_tpu.observability.metrics",
               "deeplearning4j_tpu.observability.flight_recorder"]
PACKAGES = {"ours": (slo, metrics, tracing, fr),
            "ref": (jslo, jmetrics, jtracing, jfr)}


@pytest.mark.parametrize("name", [
    "test_slo_burn_rate_math_on_synthetic_windows",
    "test_slo_availability_objective_counts_errors"])
def test_jax_slo_contract_holds_on_port(name, monkeypatch, tmp_path):
    kw = {"tmp_path": tmp_path} if "synthetic" in name else {}
    run_on_port("test_tracing", name, monkeypatch, SLO_MODULES, **kw)


def _snapshots(seed: int, steps: int, bad_rate: float) -> list:
    """Cumulative registry snapshots of the three serve series a default
    objective reads: the request and TTFT histograms (two routes, the
    registry's default buckets) and the request and error counters."""
    rng = np.random.default_rng(seed)
    buckets = list(metrics.DEFAULT_BUCKETS)
    hist = {name: {route: np.zeros(len(buckets) + 1, np.int64)
                   for route in ("/v1/predict", "/v1/generate")}
            for name in (_n.SERVE_REQUEST_SECONDS, _n.SERVE_TTFT_SECONDS)}
    total = bad = 0
    out = []
    for step in range(steps):
        burst = step in (steps // 2, steps // 2 + 1)
        for name in hist:
            for route, counts in hist[name].items():
                n = int(rng.integers(50, 200))
                p_bad = min(0.9, bad_rate * (20 if burst else 1))
                slow = rng.random(n) < p_bad
                vals = np.where(slow, rng.uniform(0.6, 5.0, n),
                                rng.uniform(1e-4, 0.2, n))
                idx = np.searchsorted(buckets, vals, side="left")
                np.add.at(counts, idx, 1)
        n = int(rng.integers(100, 400))
        total += n
        bad += int(rng.binomial(n, min(0.9, bad_rate * (40 if burst else 1))))
        snap = {name: {"type": "histogram", "help": "", "series": [
            {"labels": {"route": route}, "buckets": buckets,
             "bucket_counts": counts.tolist(), "count": int(counts.sum()),
             "sum": 0.0} for route, counts in sorted(per.items())]}
            for name, per in hist.items()}
        snap[_n.SERVE_REQUESTS_TOTAL] = {"type": "counter", "help": "",
                                         "series": [{"labels": {"model": "m"},
                                                     "value": float(total)}]}
        snap[_n.SERVE_ERRORS_TOTAL] = {"type": "counter", "help": "",
                                       "series": [{"labels": {},
                                                   "value": float(bad)}]}
        out.append(snap)
    return out


def _engine(pkg: str, feed: list, clock, dump_dir: str):
    slo_mod, met, tr, rec_mod = PACKAGES[pkg]

    class Fed(met.MetricsRegistry):
        """The engine's own series are real; what it reads is the feed."""

        def snapshot(self):
            return feed[0]

    reg = Fed()
    store = tr.TraceStore(enabled=True, sample=1.0, registry=met.
                          MetricsRegistry())
    store.put_exemplar(_n.SERVE_TTFT_SECONDS, 4.5, "e" * 32)
    rec = rec_mod.FlightRecorder(capacity=8, dump_dir=dump_dir,
                                 registry=met.MetricsRegistry())
    eng = slo_mod.SLOEngine(registry=reg, store=store, recorder=rec,
                            clock=clock, cooldown_s=120.0,
                            windows=((120.0, 14.4), (600.0, 6.0)))
    return eng, reg


def _slo_series(reg) -> dict:
    snap = type(reg).__mro__[1].snapshot(reg)
    return {k: v for k, v in snap.items() if k.startswith("dl4j_slo_")}


@pytest.mark.parametrize("seed,bad_rate", [(0, 0.001), (1, 0.004),
                                           (2, 0.02), (3, 0.0)])
def test_evaluate_equals_jax_on_the_same_snapshots(seed, bad_rate, tmp_path,
                                                   monkeypatch):
    for var in ("DL4J_SLO_P99_MS", "DL4J_SLO_TTFT_MS",
                "DL4J_SLO_AVAILABILITY"):
        monkeypatch.delenv(var, raising=False)
    snaps = _snapshots(seed, steps=14, bad_rate=bad_rate)
    now = [1000.0]
    feeds = {"ours": [snaps[0]], "ref": [snaps[0]]}
    engines = {pkg: _engine(pkg, feeds[pkg], lambda: now[0],
                            str(tmp_path / pkg)) for pkg in PACKAGES}
    alerts = 0
    for snap in snaps[1:]:
        now[0] += 60.0
        out = {}
        for pkg, (eng, reg) in engines.items():
            feeds[pkg][0] = snap
            out[pkg] = eng.evaluate()
            for entry in out[pkg]:
                if entry["exemplar"] is not None:
                    entry["exemplar"].pop("ts")  # when it was put
        assert out["ours"] == out["ref"]
        alerts += sum(e["alerting"] for e in out["ours"])
        assert _slo_series(engines["ours"][1]) == \
            _slo_series(engines["ref"][1])
    bundles = {pkg: sorted(p.name.split("-", 4)[-1] for p in
                           (tmp_path / pkg).iterdir())
               if (tmp_path / pkg).exists() else []
               for pkg in PACKAGES}
    assert bundles["ours"] == bundles["ref"]
    if bad_rate >= 0.004:
        assert alerts and bundles["ours"]   # the burst burns
    if bad_rate == 0.0:
        assert not alerts and not bundles["ours"]


@pytest.mark.parametrize("env", [{}, {"DL4J_SLO_P99_MS": "80",
                                      "DL4J_SLO_TTFT_MS": "1200",
                                      "DL4J_SLO_AVAILABILITY": "0.99"},
                                 {"DL4J_SLO_P99_MS": "junk"}])
def test_default_objectives_read_the_jax_variables(env, monkeypatch):
    for var in ("DL4J_SLO_P99_MS", "DL4J_SLO_TTFT_MS",
                "DL4J_SLO_AVAILABILITY"):
        monkeypatch.delenv(var, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    ours = [o.describe() for o in slo.default_serve_objectives()]
    assert ours == [o.describe() for o in jslo.default_serve_objectives()]
    assert [o["name"] for o in ours] == ["request_p99", "ttft_p99",
                                         "availability"]


@pytest.mark.parametrize("kw", [
    {"kind": "quantile"}, {"kind": "latency"},
    {"kind": "latency", "metric": "m"},
    {"kind": "availability", "total_metric": "t"},
    {"kind": "latency", "metric": "m", "threshold_s": 0.1, "target": 1.0}])
def test_bad_objectives_raise_as_jax(kw):
    with pytest.raises(ValueError) as ours:
        slo.SLO("x", **kw)
    with pytest.raises(ValueError) as ref:
        jslo.SLO("x", **kw)
    assert str(ours.value) == str(ref.value)


def test_ticker_starts_and_stops():
    reg = metrics.MetricsRegistry()
    eng = slo.SLOEngine(registry=reg, store=None,
                        recorder=fr.FlightRecorder(capacity=4, registry=reg))
    assert eng.start(interval_s=0.01) is eng
    deadline = time.time() + 10
    while len(eng._snaps) < 4 and time.time() < deadline:
        time.sleep(0.01)
    ticker = eng._ticker
    eng.stop()
    assert len(eng._snaps) >= 4 and not ticker.is_alive()
    assert eng._ticker is None
    eng.stop()  # idempotent


def test_serve_slo_route_and_autoscaler_input():
    srv = InferenceServer(device="cpu", autoscale=True, min_replicas=1,
                          max_replicas=2, autoscale_cooldown_s=300.0)
    assert srv.autoscaler.slo_engine is srv.slo
    srv.start()
    try:
        assert srv.slo._ticker is not None
        conn = http.client.HTTPConnection("127.0.0.1", srv.port, timeout=30)
        conn.request("GET", "/serve/slo")
        resp = conn.getresponse()
        body = json.loads(resp.read())
        conn.close()
    finally:
        srv.stop()
    assert resp.status == 200 and srv.slo._ticker is None
    objectives = body["slo"]
    assert [o["name"] for o in objectives] == ["request_p99", "ttft_p99",
                                               "availability"]
    for o in objectives:
        assert [w["window_s"] for w in o["windows"]] == [300.0, 3600.0]
        assert {"alerting", "budget_remaining", "exemplar"} <= set(o)
