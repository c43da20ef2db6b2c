"""The port's metrics registry and the serving path's series (A9.1).

- ``tests/test_observability.py``'s registry contracts (counters through
  ``tree_nbytes``) run on the port's ``MetricsRegistry``;
- every metric name equals the JAX package's string;
- ``tests/test_serving.py``'s backpressure scenario: the queue-depth gauge
  agrees with what the 429 claimed;
- ``GET /metrics`` over HTTP, plain and in replica mode: the counters equal
  what was sent and what ``/serve/status`` says;
- decode's token, TTFT, eviction, page and spec series equal ``stats()``;
- the kill switch stops every series of a running server.
"""
import http.client
import json
import re
import threading
import time

import numpy as np
import pytest
import torch

from _torch_port import run_on_port
from deeplearning4j_tpu.observability import names as jax_names
from deeplearning4j_tpu_torch.keras_server import (
    AdmissionController, InferenceServer, MicroBatcher, ModelRegistry,
    RejectedError,
)
from deeplearning4j_tpu_torch.keras_server.decode import DecodeEngine
from deeplearning4j_tpu_torch.models.transformer import transformer_lm
from deeplearning4j_tpu_torch.nn.conf import NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.conf.layers import DenseLayer, OutputLayer
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.observability import (
    MetricsRegistry, global_registry, names as _n, tree_nbytes,
)

N_IN, N_OUT = 16, 4


def _mlp(seed=5):
    conf = (NeuralNetConfiguration.builder().seed(seed).list()
            .layer(DenseLayer.conf(n_in=N_IN, n_out=32, activation="relu"))
            .layer(OutputLayer.conf(n_in=32, n_out=N_OUT, loss="mcxent",
                                    activation="softmax"))
            .build())
    return MultiLayerNetwork(conf, device="cpu").init()


@pytest.fixture(scope="module")
def lm():
    return MultiLayerNetwork(transformer_lm(32, width=32, n_layers=1,
                                            n_heads=2, max_len=32, seed=4),
                             device="cpu").init()


# ------------------------------------------------------ registry contracts
REGISTRY_CONTRACTS = [
    "test_counter_semantics", "test_gauge_and_histogram_semantics",
    "test_labels_memoized_and_type_conflict",
    "test_kill_switch_disables_mutation",
    "test_concurrent_increments_are_exact", "test_prometheus_text_parses",
    "test_write_jsonl_appends_snapshot", "test_tree_nbytes"]


@pytest.mark.parametrize("name", REGISTRY_CONTRACTS)
def test_jax_registry_contract_holds_on_port(name, monkeypatch, tmp_path):
    kw = {"tmp_path": tmp_path} if "jsonl" in name else {}
    run_on_port("test_observability", name, monkeypatch,
                ["deeplearning4j_tpu.observability.metrics"], **kw)


def test_tree_nbytes_reads_tensors_without_their_data():
    net = _mlp()
    want = sum(p.numel() * 4 for layer in net.params_list
               for p in layer.values())
    assert tree_nbytes(net.params_list) == want
    meta = torch.empty((3, 5), dtype=torch.bfloat16, device="meta")
    assert tree_nbytes({"a": (meta, [np.zeros(4, np.int8)])}) == 34
    assert tree_nbytes([None, "x", 3]) == 0


def test_metric_names_equal_jax():
    def constants(mod):
        return {k: v for k, v in vars(mod).items()
                if k.isupper() and isinstance(v, str)}
    assert constants(_n) == constants(jax_names)
    assert _n.ALL_METRIC_NAMES == jax_names.ALL_METRIC_NAMES
    assert all(v.startswith("dl4j_") for v in _n.ALL_METRIC_NAMES)


def test_labelset_cap_collapses_into_overflow(monkeypatch):
    monkeypatch.setenv("DL4J_METRICS_MAX_LABELSETS", "2")
    reg = MetricsRegistry()
    c = reg.counter("c_total")
    for sid in "abcd":
        c.labels(session=sid).inc()
    snap = reg.snapshot()
    assert len(snap["c_total"]["series"]) == 2
    dropped = snap[_n.METRICS_DROPPED_LABELSETS_TOTAL]["series"]
    assert dropped == [{"labels": {"family": "c_total"}, "value": 2.0}]
    assert 'session="c"' not in reg.prometheus_text()


# ---------------------------------------------------------- backpressure
def _series(metrics, name):
    return {tuple(sorted(r["labels"].items())): r
            for r in metrics.snapshot().get(name, {}).get("series", [])}


def _value(metrics, name, **labels):
    row = _series(metrics, name).get(tuple(sorted(labels.items())))
    if row is None:
        return 0.0
    return row["count"] if "count" in row else row["value"]


def test_backpressure_rejects_and_queue_depth_gauge_agrees():
    registry = ModelRegistry()
    mv = registry.register("m", _mlp(), version="v1", device="cpu")
    release = threading.Event()
    real_pf = mv.predict_fn

    def blocking(x):
        release.wait(timeout=30)
        return real_pf(x)

    mv.predict_fn = blocking
    metrics = MetricsRegistry()
    admission = AdmissionController(max_pending=4, metrics=metrics)
    batcher = MicroBatcher(registry, max_batch=1, max_latency_s=0.0,
                           admission=admission, metrics=metrics)
    try:
        x = np.zeros((1, N_IN), np.float32)
        futs = [batcher.submit("m", x) for _ in range(4)]
        with pytest.raises(RejectedError) as exc:
            batcher.submit("m", x)
        assert exc.value.pending == 4 and exc.value.limit == 4
        assert exc.value.retry_after_s > 0
        # the gauge agrees with what the 429 claimed
        assert _value(metrics, _n.SERVE_QUEUE_DEPTH) == 4
        assert admission.pending == 4
        release.set()
        for f in futs:
            f.result(timeout=30)
        deadline = time.time() + 10
        while admission.pending and time.time() < deadline:
            time.sleep(0.01)
        assert _value(metrics, _n.SERVE_QUEUE_DEPTH) == 0
        assert _value(metrics, _n.SERVE_REJECTED_TOTAL) == 1
        assert _value(metrics, _n.SERVE_REQUESTS_TOTAL, model="m") == 4
        assert _value(metrics, _n.SERVE_BATCHES_TOTAL, model="m") == 4
        assert _value(metrics, _n.SERVE_BATCH_DISPATCH_SECONDS) == 4
        assert _value(metrics, _n.SERVE_BATCH_OCCUPANCY) == 1.0
        # a priority shed is counted by tenant and priority
        low = AdmissionController(max_pending=2, metrics=metrics)
        low.admit(priority="low", tenant="t1")
        with pytest.raises(RejectedError):
            low.admit(priority="low", tenant="t1")
        assert _value(metrics, _n.SERVE_SHED_TOTAL, tenant="t1",
                      priority="low") == 1
    finally:
        release.set()
        batcher.close()


def test_registry_models_and_hot_swaps():
    metrics = MetricsRegistry()
    reg = ModelRegistry(metrics=metrics)
    net = _mlp()
    reg.register("a", net, device="cpu")
    reg.register("a", net, device="cpu")
    reg.register("b", net, device="cpu")
    assert _value(metrics, _n.SERVE_MODELS_LOADED) == 3
    assert _value(metrics, _n.SERVE_HOT_SWAPS_TOTAL, model="a") == 1
    reg.set_active("a", "v1")
    reg.set_active("a", "v1")   # no move, no swap
    assert _value(metrics, _n.SERVE_HOT_SWAPS_TOTAL, model="a") == 2
    assert _value(metrics, _n.SERVE_HOT_SWAPS_TOTAL, model="b") == 0


# ------------------------------------------------------------- /metrics
def _http(port, method, path, body=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    try:
        conn.request(method, path, None if body is None else json.dumps(body),
                     {"Content-Type": "application/json"})
        resp = conn.getresponse()
        return resp.status, resp.getheader("Content-Type"), resp.read()
    finally:
        conn.close()


_SAMPLE = re.compile(r'^([a-zA-Z_:][a-zA-Z0-9_:]*)(\{[^{}]*\})? (\S+)$')


def parse_prometheus(text: str) -> dict:
    """``{(name, ((label, value), ...)): float}`` of every sample line."""
    out = {}
    for line in text.splitlines():
        if not line or line.startswith("#"):
            continue
        m = _SAMPLE.match(line)
        assert m, f"invalid Prometheus line: {line!r}"
        labels = tuple(sorted(re.findall(r'(\w+)="([^"]*)"', m.group(2) or "")))
        out[(m.group(1), labels)] = float(m.group(3))
    return out


def _scrape(port) -> dict:
    code, ctype, body = _http(port, "GET", "/metrics")
    assert code == 200 and ctype == "text/plain; version=0.0.4"
    return parse_prometheus(body.decode())


def _moved(after, before, name, **labels):
    """How far the series ``name{labels}`` moved between two scrapes (the
    server writes the process-global registry, which other tests share)."""
    key = (name, tuple(sorted(labels.items())))
    return after.get(key, 0.0) - before.get(key, 0.0)


def _request_count(port, before, route, want, timeout=5.0):
    """The request histogram's count for ``route`` since ``before``, once
    it reaches ``want`` (the handler observes after its response)."""
    deadline = time.time() + timeout
    while True:
        got = _moved(_scrape(port), before, _n.SERVE_REQUEST_SECONDS + "_count",
                     route=route)
        if got >= want or time.time() > deadline:
            return got


@pytest.mark.parametrize("replicas", [1, 2])
def test_http_metrics_route(replicas, lm):
    srv = InferenceServer(device="cpu", replicas=replicas, max_batch=8,
                          max_latency_s=0.002, decode_max_context=32,
                          decode_max_slots=4).start()
    model, gen = f"mlp_http{replicas}", f"lm_http{replicas}"
    try:
        srv.register(model, _mlp(), version="v1")
        srv.register(gen, lm, version="v1")
        before = _scrape(srv.port)
        sent = 6
        for i in range(sent):
            code, _, _ = _http(srv.port, "POST", "/v1/predict", {
                "model": model,
                "inputs": np.full((2, N_IN), i, np.float32).tolist()})
            assert code == 200
        code, _, _ = _http(srv.port, "POST", "/v1/generate",
                           {"model": gen, "prompt": [1, 2, 3],
                            "max_new_tokens": 5})
        assert code == 200
        after = _scrape(srv.port)
        _, _, st = _http(srv.port, "GET", "/serve/status")
        st = json.loads(st)
        assert _moved(after, before, _n.SERVE_REQUESTS_TOTAL,
                      model=model) == sent
        batches = _moved(after, before, _n.SERVE_BATCHES_TOTAL, model=model)
        assert batches == st["queue"]["dispatches"] >= 1
        assert _moved(after, before,
                      _n.SERVE_BATCH_DISPATCH_SECONDS + "_count") == batches
        dec = st["decode"][f"{gen}@v1"]
        assert _moved(after, before, _n.SERVE_TOKENS_TOTAL) \
            == dec["tokens"] == 5
        assert _moved(after, before, _n.SERVE_TTFT_SECONDS + "_count") == 1
        assert _moved(after, before, _n.SERVE_EVICTIONS_TOTAL,
                      reason="max_tokens") == 1
        assert after[(_n.SERVE_MODELS_LOADED, ())] == 2
        assert _request_count(srv.port, before, "/v1/predict", sent) == sent
        assert _request_count(srv.port, before, "/v1/generate", 1) == 1
        if replicas > 1:
            routed = {r["replica"]: _moved(
                after, before, _n.SERVE_REPLICA_ROUTED_TOTAL,
                replica=str(r["replica"]))
                for r in st["replicas"]["replicas"]}
            assert sum(routed.values()) == sent
            assert routed == {r["replica"]: r["routed"]
                              for r in st["replicas"]["replicas"]}
            assert after[(_n.SERVE_FLEET_SIZE, ())] == 2
            for r in range(2):
                assert after[(_n.SERVE_REPLICA_ACTIVE_VERSION, (
                    ("model", model), ("replica", str(r)),
                    ("version", "v1")))] == 1
                assert after[(_n.SERVE_REPLICA_QUEUE_DEPTH,
                              (("replica", str(r)),))] == 0
        # the kill switch: nothing moves while it is off
        global_registry().set_enabled(False)
        try:
            _http(srv.port, "POST", "/v1/predict",
                  {"model": model, "inputs": np.zeros((1, N_IN)).tolist()})
            off = _scrape(srv.port)
        finally:
            global_registry().set_enabled(True)
        assert _moved(off, before, _n.SERVE_REQUESTS_TOTAL,
                      model=model) == sent
    finally:
        srv.stop()


def test_replica_scale_events_and_active_versions():
    from deeplearning4j_tpu_torch.keras_server import ReplicaSet
    metrics = MetricsRegistry()
    rs = ReplicaSet(2, device="cpu", max_batch=4, metrics=metrics)
    try:
        net = _mlp()
        rs.register("m", net)
        rs.register("m", net)
        for r in ("0", "1"):
            assert _value(metrics, _n.SERVE_REPLICA_ACTIVE_VERSION,
                          replica=r, model="m", version="v1") == 0
            assert _value(metrics, _n.SERVE_REPLICA_ACTIVE_VERSION,
                          replica=r, model="m", version="v2") == 1
        new = rs.add_replica(reason="test")
        assert _value(metrics, _n.SERVE_FLEET_SIZE) == 3
        assert rs.remove_replica(new.index, reason="test")
        assert _value(metrics, _n.SERVE_FLEET_SIZE) == 2
        for direction in ("out", "in"):
            assert _value(metrics, _n.SERVE_SCALE_EVENTS_TOTAL,
                          direction=direction, reason="test") == 1
        assert _value(metrics, _n.SERVE_REPLICA_ACTIVE_VERSION,
                      replica=str(new.index), model="m", version="v2") == 0
    finally:
        rs.close()


# ------------------------------------------------------------ decode series
@pytest.mark.parametrize("kv", ["dense", "paged"])
def test_decode_series_equal_stats(lm, kv):
    metrics = MetricsRegistry()
    eng = DecodeEngine(lm, device="cpu", max_context=32, min_slots=1,
                       max_slots=4, kv=kv, page_size=8, metrics=metrics,
                       **({"draft_net": lm, "spec_tokens": 2}
                          if kv == "paged" else {}))
    try:
        prompt = [3, 1, 4, 1, 5, 9, 2, 6, 5]
        sessions = [eng.submit(prompt, 4), eng.submit(prompt[:7] + [8], 3),
                    eng.submit([7], 2)]
        for s in sessions:
            s.result(timeout=120)
        st = eng.stats()
    finally:
        eng.close()
    assert _value(metrics, _n.SERVE_TOKENS_TOTAL) == st["tokens"] == 9
    assert _value(metrics, _n.SERVE_TTFT_SECONDS) == len(sessions)
    assert _value(metrics, _n.SERVE_EVICTIONS_TOTAL,
                  reason="max_tokens") == st["evictions"] == 3
    assert 0 < _value(metrics, _n.SERVE_SLOT_OCCUPANCY) <= 1
    stalls = _series(metrics, _n.SERVE_BUCKET_GROWTH_STALL_SECONDS)
    assert {dict(k)["bucket"] for k in stalls} == {
        str(b) for b in st["buckets"]}
    assert _value(metrics, _n.DECODE_STATE_COPY_BYTES_TOTAL) \
        == st["state_copy_bytes"] > 0
    if kv == "paged":
        assert _value(metrics, _n.DECODE_PREFIX_SHARE_RATIO) \
            == st["prefix_share_ratio"]
        assert _value(metrics, _n.DECODE_PAGES_IN_USE) >= 0
        assert _value(metrics, _n.DECODE_SPEC_TOKENS_TOTAL,
                      outcome="proposed") == st["spec_proposed"] > 0
        assert _value(metrics, _n.DECODE_SPEC_TOKENS_TOTAL,
                      outcome="accepted") == st["spec_accepted"]
        assert _value(metrics, _n.DECODE_SPEC_ACCEPTANCE) \
            == st["spec_acceptance"] == 1.0


def test_stream_series(lm):
    from deeplearning4j_tpu_torch.keras_server.streaming import StreamSessions
    from deeplearning4j_tpu_torch.models.char_rnn import char_rnn_lstm
    metrics = MetricsRegistry()
    reg = ModelRegistry(metrics=metrics)
    net = MultiLayerNetwork(char_rnn_lstm(8, hidden=8), device="cpu").init()
    reg.register("rnn", net, device="cpu")
    ss = StreamSessions(reg, ttl_s=0.0, device="cpu", metrics=metrics)
    x = np.zeros((1, 3, 8), np.float32)
    ss.step("rnn", "s1", x)
    assert _value(metrics, _n.SERVE_STREAM_STEPS_TOTAL, model="rnn") == 3
    assert _value(metrics, _n.SERVE_STREAM_SESSIONS) == 1
    time.sleep(0.01)
    ss.step("rnn", "s2", x[:, :1])   # s1 is past its ttl: evicted
    assert _value(metrics, _n.SERVE_EVICTIONS_TOTAL, reason="ttl") == 1
    assert ss.reset("rnn", "s2")
    assert _value(metrics, _n.SERVE_EVICTIONS_TOTAL, reason="reset") == 1
    assert _value(metrics, _n.SERVE_STREAM_SESSIONS) == 0
    assert _value(metrics, _n.SERVE_STREAM_STEPS_TOTAL, model="rnn") == 4


def test_default_registry_is_process_global():
    assert global_registry() is global_registry()
    adm = AdmissionController(max_pending=1)
    adm.admit()
    assert _value(global_registry(), _n.SERVE_QUEUE_DEPTH) == 1
    adm.release()
    assert _value(global_registry(), _n.SERVE_QUEUE_DEPTH) == 0
