"""Request tracing in the port (A9.2), held against the JAX package.

- ``traceparent`` parsing and formatting give the JAX answers on the same
  headers, malformed ones included;
- ``tests/test_tracing.py``'s store contracts run on the port's objects
  (``_torch_port.run_on_port``): span parents and monotone timestamps, the
  tail sampler under concurrent finalize,
  a decode session's queue/prefill/decode spans, park and preempt under
  pool starvation; the off store returns the no-op singleton;
- the same requests through the port's server and the JAX server
  (``DL4J_COMPILE_CACHE=0``: XLA:CPU's reload of a serialized executable
  fails on a host whose CPU features differ from the compiling one's) give
  the same trees: span names, parents, statuses, link
  counts and attribute names, for ``/v1/predict`` (and the batch dispatch
  that links it), ``/v1/generate``, a 429 kept at ``sample=0``, the
  batcher's fan-in of four requests, and the replica router;
- the PS stitch (a bound consume span, ``ps.push_window``, the RPC span,
  the server's ``ps.apply``) over the inproc and TCP transports, and the
  broker's publish/consume stitch, equal JAX's, and a trace crosses between
  the packages on the wire;
- ``trace_index.db`` written by either package's store reads in the other;
- ``span()``'s histogram, recorder events and trace span.

Every comparison is exact (structure, names and integer attributes); no
wall-clock budget is asserted.
"""
import http.client
import json
import threading
import time
import types

import numpy as np
import pytest
import torch

import deeplearning4j_tpu.observability.tracing as jtracing
from _torch_port import cpu_default, run_on_port
from deeplearning4j_tpu.keras_server import InferenceServer as JServer
from deeplearning4j_tpu.keras_server import ModelRegistry as JRegistry
from deeplearning4j_tpu.keras_server.batcher import MicroBatcher as JBatcher
from deeplearning4j_tpu.keras_server.replica import ReplicaSet as JReplicaSet
from deeplearning4j_tpu.models.transformer import transformer_lm as jlm
from deeplearning4j_tpu.nn.conf.builders import NeuralNetConfiguration as JNNC
from deeplearning4j_tpu.nn.conf.layers import DenseLayer, OutputLayer
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JNet
from deeplearning4j_tpu.observability.metrics import (
    MetricsRegistry as JMetricsRegistry)
from deeplearning4j_tpu.parallel import param_server as jps
from deeplearning4j_tpu.parallel import ps_transport as jpst
from deeplearning4j_tpu.streaming import broker as jbroker
from deeplearning4j_tpu.ui.storage import FileStatsStorage as JFileStorage
from deeplearning4j_tpu_torch.convert import from_jax
from deeplearning4j_tpu_torch.keras_server import (
    InferenceServer, MicroBatcher, ModelRegistry, ReplicaSet)
from deeplearning4j_tpu_torch.keras_server import decode as decode_mod
from deeplearning4j_tpu_torch.nn import multilayer as multilayer_mod
from deeplearning4j_tpu_torch.observability import (
    FlightRecorder, MetricsRegistry, span)
from deeplearning4j_tpu_torch.observability import tracing
from deeplearning4j_tpu_torch.parallel import param_server as ps
from deeplearning4j_tpu_torch.parallel import ps_transport as pst
from deeplearning4j_tpu_torch.streaming import broker
from deeplearning4j_tpu_torch.ui.storage import FileStatsStorage

N_IN, N_OUT = 12, 3
#: the client's trace context on every compared request
CALLER = "00-" + "c" * 32 + "-" + "d" * 16 + "-01"
#: JAX modules whose objects the contracts of tests/test_tracing.py take
TRACING_MODULES = ["deeplearning4j_tpu.observability.tracing",
                   "deeplearning4j_tpu.observability.metrics",
                   "deeplearning4j_tpu.keras_server.decode",
                   "deeplearning4j_tpu.models.transformer",
                   "deeplearning4j_tpu.nn.multilayer"]


def _np(tree):
    return [{k: np.asarray(v) for k, v in layer.items()} for layer in tree]


def _jax_mlp(seed=7):
    conf = (JNNC.builder().seed(seed).learning_rate(0.1).updater("adam")
            .weight_init("xavier").list()
            .layer(DenseLayer(n_in=N_IN, n_out=24, activation="relu"))
            .layer(OutputLayer(n_in=24, n_out=N_OUT, loss="mcxent",
                               activation="softmax"))
            .build())
    return JNet(conf).init()


def _port(jnet):
    return from_jax(jnet.conf.to_json(), _np(jnet.params_list), device="cpu")


@pytest.fixture()
def stores(monkeypatch):
    """A fresh, fully sampled store in each package, installed as the
    process global for the test; the previous ones come back after."""
    monkeypatch.setenv("DL4J_COMPILE_CACHE", "0")
    ours = tracing.TraceStore(enabled=True, sample=1.0, capacity=256,
                              registry=MetricsRegistry())
    ref = jtracing.TraceStore(enabled=True, sample=1.0, capacity=256,
                              registry=JMetricsRegistry())
    prev = tracing.global_trace_store(), jtracing.global_trace_store()
    tracing.set_global_trace_store(ours)
    jtracing.set_global_trace_store(ref)
    yield ours, ref
    tracing.set_global_trace_store(prev[0])
    jtracing.set_global_trace_store(prev[1])


def shape(rec) -> list:
    """A trace's tree without ids or times: each span's name, its parent's
    name (``<remote>`` for a parent in another trace or process), status,
    link count and attribute names, sorted."""
    by_id = {s["span_id"]: s for s in rec["spans"]}
    out = []
    for s in rec["spans"]:
        pid = s["parent_id"]
        parent = None if pid is None else (
            by_id[pid]["name"] if pid in by_id else "<remote>")
        out.append((s["name"], parent, s["status"], len(s["links"]),
                    tuple(sorted(s["attrs"]))))
    return sorted(out)


def _wait(store, trace_id, names=(), timeout=10.0):
    """The trace's record once it holds every span named in ``names``."""
    deadline = time.time() + timeout
    while True:
        rec = store.get(trace_id)
        if rec is not None and set(names) <= {s["name"]
                                              for s in rec["spans"]}:
            return rec
        if time.time() > deadline:
            raise AssertionError(f"trace {trace_id} incomplete: {rec}")
        time.sleep(0.01)


def _post(port, path, obj, headers=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    try:
        conn.request("POST", path, body=json.dumps(obj),
                     headers={"Content-Type": "application/json",
                              **(headers or {})})
        resp = conn.getresponse()
        return resp.status, resp.getheader("traceparent"), resp.read()
    finally:
        conn.close()


def _get(port, path):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
    try:
        conn.request("GET", path)
        resp = conn.getresponse()
        return resp.status, json.loads(resp.read())
    finally:
        conn.close()


def _dispatch_of(store, queue_span_id):
    """The batch.dispatch span whose links name ``queue_span_id``, and its
    record."""
    for summary in store.list(256):
        rec = store.get(summary["trace_id"])
        for s in rec["spans"]:
            if s["name"] == "batch.dispatch" and any(
                    l.split("-")[2] == queue_span_id for l in s["links"]):
                return s, rec
    raise AssertionError("no dispatch span links the request")


# ------------------------------------------------------------- traceparent
HEADERS = [
    "00-" + "a" * 32 + "-" + "b" * 16 + "-01",
    "00-4bf92f3577b34da6a3ce929d0e0e4736-00f067aa0ba902b7-00",
    "  00-" + "a" * 32 + "-" + "b" * 16 + "-01  ",
    None, "", "junk", "00-short-b-01",
    "00-" + "0" * 32 + "-" + "b" * 16 + "-01",
    "00-" + "a" * 32 + "-" + "0" * 16 + "-01",
    "zz-" + "a" * 32 + "-" + "b" * 16 + "-01",
    "ff-" + "a" * 32 + "-" + "b" * 16 + "-01",
    "00-" + "g" * 32 + "-" + "b" * 16 + "-01",
    "00-" + "a" * 32 + "-" + "b" * 16,
    "00-" + "a" * 31 + "-" + "b" * 16 + "-01",
]


@pytest.mark.parametrize("header", HEADERS)
def test_traceparent_parses_as_jax(header):
    def read(ref):
        return None if ref is None else (ref.trace_id, ref.span_id,
                                         ref.traceparent())
    ours = read(tracing.parse_traceparent(header))
    assert ours == read(jtracing.parse_traceparent(header))
    if ours is not None:
        assert tracing.format_traceparent(*ours[:2]) == \
            jtracing.format_traceparent(*ours[:2]) == ours[2]


# ------------------------------------------------------- the JAX contracts
STORE_CONTRACTS = ["test_span_tree_parents_and_monotonic_timestamps",
                   "test_tail_sampler_survives_concurrent_finalize",
                   "test_decode_session_trace_spans_queue_prefill_decode",
                   "test_decode_pool_starvation_leaves_park_or_preempt_spans"]


@pytest.mark.parametrize("name", ["test_traceparent_roundtrip_and_malformed"]
                         + STORE_CONTRACTS)
def test_jax_tracing_contract_holds_on_port(name, monkeypatch):
    cpu_default(monkeypatch, decode_mod, multilayer_mod)
    kw = {}
    if name in STORE_CONTRACTS:
        store = tracing.TraceStore(enabled=True, sample=1.0, capacity=256,
                                   registry=MetricsRegistry())
        prev = tracing.global_trace_store()
        tracing.set_global_trace_store(store)
        kw["store"] = store
    try:
        run_on_port("test_tracing", name, monkeypatch, TRACING_MODULES, **kw)
    finally:
        if kw:
            tracing.set_global_trace_store(prev)


def test_noop_span_when_off_allocates_no_span(monkeypatch):
    """JAX ``test_disabled_store_returns_the_noop_singleton`` on the port
    (its ``NOOP_SPAN`` is a module instance, which the contract runner does
    not swap): both span functions return the one singleton and the store
    sees nothing."""
    store = tracing.TraceStore(enabled=False, registry=MetricsRegistry())
    monkeypatch.setattr(tracing, "_STORE", store)
    assert tracing.trace_span("a", parent=None, x=1) is tracing.NOOP_SPAN
    assert tracing.start_span("b") is tracing.NOOP_SPAN
    with tracing.trace_span("c") as sp:
        assert tracing.current_span() is None and sp.ref() is None
    assert tracing.trace_span("d").traceparent() == ""
    assert not store._live and len(store) == 0


# ---------------------------------------------------- servers side by side
def _servers(jnet, **kw):
    jreg = JRegistry()
    jreg.register("m", jnet, version="v1")
    reg = ModelRegistry()
    reg.register("m", _port(jnet), version="v1", device="cpu")
    return (InferenceServer(reg, device="cpu", **kw).start(),
            JServer(jreg, **kw).start())


def test_http_predict_tree_equals_jax(stores):
    ours_st, ref_st = stores
    jnet = _jax_mlp()
    srv, jsrv = _servers(jnet, max_batch=8, max_latency_s=0.002,
                         max_queue=64)
    try:
        got = {}
        for side, s, st in (("ours", srv, ours_st), ("ref", jsrv, ref_st)):
            status, tp, body = _post(s.port, "/v1/predict",
                                     {"model": "m",
                                      "inputs": [[0.5] * N_IN]},
                                     {"traceparent": CALLER})
            assert status == 200
            echo = tracing.parse_traceparent(tp)
            assert echo.trace_id == "c" * 32 and echo.span_id != "d" * 16
            rec = _wait(st, echo.trace_id, ("http /v1/predict", "admission",
                                            "batch.queue"))
            queue = next(x for x in rec["spans"]
                         if x["name"] == "batch.queue")
            root = next(x for x in rec["spans"] if x["parent_id"] == "d" * 16)
            assert root["span_id"] == echo.span_id
            assert root["mono"] <= queue["mono"]
            dspan, drec = _dispatch_of(st, queue["span_id"])
            got[side] = (shape(rec), shape(drec), json.loads(body),
                         {k: dspan["attrs"][k] for k in
                          ("model", "rows", "bucket", "requests", "version")},
                         queue["attrs"]["bucket"])
            code, listed = _get(s.port, "/serve/traces")
            assert echo.trace_id in {t["trace_id"] for t in listed["traces"]}
            code, fetched = _get(s.port, f"/serve/traces/{echo.trace_id}")
            assert code == 200 and shape(fetched) == shape(rec)
            assert _get(s.port, "/serve/traces/" + "e" * 32)[0] == 404
        ours, ref = got["ours"], got["ref"]
        assert ours[:2] == ref[:2] and ours[3:] == ref[3:]
        np.testing.assert_allclose(ours[2]["predictions"],
                                   ref[2]["predictions"], rtol=0, atol=2e-6)
        # the dispatch's cache stamp: None without a compile cache (JAX's
        # value with its cache off)
        assert ours[1] == [("batch.dispatch", None, "ok", 1, tuple(sorted(
            ("bucket", "compile_cache_hit", "dispatch_s", "model",
             "occupancy", "requests", "rows", "version"))))]
        dspan, _ = _dispatch_of(ours_st, next(
            x["span_id"] for x in ours_st.get("c" * 32)["spans"]
            if x["name"] == "batch.queue"))
        assert dspan["attrs"]["compile_cache_hit"] is None
    finally:
        srv.stop()
        jsrv.stop()


def test_http_generate_tree_equals_jax(stores):
    ours_st, ref_st = stores
    jnet = JNet(jlm(vocab_size=24, width=32, n_layers=1, n_heads=2,
                    max_len=32, seed=5)).init()
    srv, jsrv = _servers(jnet, decode_max_slots=2, decode_max_context=32)
    try:
        got = {}
        for side, s, st in (("ours", srv, ours_st), ("ref", jsrv, ref_st)):
            status, tp, body = _post(s.port, "/v1/generate",
                                     {"model": "m", "prompt": [1, 2, 3],
                                      "max_new_tokens": 4},
                                     {"traceparent": CALLER})
            assert status == 200
            lines = [json.loads(l) for l in body.decode().splitlines()
                     if l.strip()]
            rec = _wait(st, tracing.parse_traceparent(tp).trace_id,
                        ("http /v1/generate", "decode.decode"))
            by = {x["name"]: x for x in rec["spans"]}
            got[side] = (shape(rec), lines[-1]["tokens"],
                         by["decode.decode"]["attrs"]["reason"],
                         by["decode.decode"]["attrs"]["tokens"],
                         by["decode.queue"]["attrs"]["prompt_len"])
            assert by["decode.prefill"]["attrs"]["ttft_s"] > 0
            assert st.exemplar("dl4j_serve_ttft_seconds") is not None
        assert got["ours"] == got["ref"]
        assert got["ours"][2:] == ("max_tokens", 4, 3)
    finally:
        srv.stop()
        jsrv.stop()


def test_429_is_kept_at_sample_zero_as_jax(monkeypatch):
    monkeypatch.setenv("DL4J_COMPILE_CACHE", "0")
    ours_st = tracing.TraceStore(enabled=True, sample=0.0, capacity=64,
                                 registry=MetricsRegistry())
    ref_st = jtracing.TraceStore(enabled=True, sample=0.0, capacity=64,
                                 registry=JMetricsRegistry())
    monkeypatch.setattr(tracing, "_STORE", ours_st)
    monkeypatch.setattr(jtracing, "_STORE", ref_st)
    srv, jsrv = _servers(_jax_mlp(seed=9), max_batch=1, max_latency_s=0.0,
                         max_queue=1)
    try:
        got = {}
        for side, s, st in (("ours", srv, ours_st), ("ref", jsrv, ref_st)):
            s.batcher.admission.admit(1)   # the queue is full
            try:
                status, tp, _ = _post(s.port, "/v1/predict",
                                      {"model": "m", "inputs": [[0.0] * N_IN]},
                                      {"traceparent": CALLER})
            finally:
                s.batcher.admission.release(1)
            assert status == 429
            rec = _wait(st, tracing.parse_traceparent(tp).trace_id)
            root = next(x for x in rec["spans"] if x["parent_id"] == "d" * 16)
            got[side] = (shape(rec), rec["status"], rec["keep_reason"],
                         root["attrs"]["http_status"])
            # an admitted request's trace is sampled away at sample=0
            status, tp, _ = _post(s.port, "/v1/predict",
                                  {"model": "m", "inputs": [[0.0] * N_IN]})
            assert status == 200
            time.sleep(0.05)
            assert st.get(tracing.parse_traceparent(tp).trace_id) is None
        assert got["ours"] == got["ref"]
        assert got["ours"][1:] == ("error", "error", 429)
    finally:
        srv.stop()
        jsrv.stop()


def test_batched_dispatch_links_every_request_as_jax(stores):
    ours_st, ref_st = stores
    jnet = _jax_mlp()
    jreg = JRegistry()
    jreg.register("m", jnet, version="v1")
    reg = ModelRegistry()
    reg.register("m", _port(jnet), version="v1", device="cpu")
    got = {}
    for side, b, st, span_fn in (
            ("ours", MicroBatcher(reg, max_batch=8, max_latency_s=0.25),
             ours_st, tracing.trace_span),
            ("ref", JBatcher(jreg, max_batch=8, max_latency_s=0.25), ref_st,
             jtracing.trace_span)):
        try:
            roots, futs = [], []
            for _ in range(4):
                with span_fn("test.request") as sp:
                    futs.append(b.submit("m", np.zeros((1, N_IN),
                                                       np.float32)))
                    roots.append(sp.trace_id)
            for f in futs:
                f.result(timeout=60)
            assert b.stats()["dispatches"] == 1
        finally:
            b.close()
        recs = [_wait(st, t, ("batch.queue",)) for t in roots]
        queue_ids = [next(x["span_id"] for x in r["spans"]
                          if x["name"] == "batch.queue") for r in recs]
        dspan, drec = _dispatch_of(st, queue_ids[0])
        assert {l.split("-")[1] for l in dspan["links"]} == set(roots)
        assert {l.split("-")[2] for l in dspan["links"]} == set(queue_ids)
        got[side] = ([shape(r) for r in recs], shape(drec),
                     {k: dspan["attrs"][k] for k in ("rows", "bucket",
                                                     "requests")})
    assert got["ours"] == got["ref"]
    assert got["ours"][2] == {"rows": 4, "bucket": 4, "requests": 4}


def test_replica_router_tree_equals_jax(stores):
    ours_st, ref_st = stores
    jnet = _jax_mlp()
    got = {}
    for side, rs, st, span_fn, net in (
            ("ours", ReplicaSet(2, device="cpu", max_latency_s=0.001),
             ours_st, tracing.trace_span, _port(jnet)),
            ("ref", JReplicaSet(2, max_latency_s=0.001), ref_st,
             jtracing.trace_span, jnet)):
        try:
            rs.register("m", net, version="v1")
            with span_fn("test.request") as root:
                fut = rs.submit("m", np.zeros((1, N_IN), np.float32))
            res = fut.result(timeout=60)
        finally:
            rs.close()
        rec = _wait(st, root.trace_id, ("batch.queue",))
        route = next(x for x in rec["spans"] if x["name"] == "replica.route")
        assert route["attrs"]["replica"] == res["replica"]
        got[side] = (shape(rec), route["attrs"]["tried"])
    assert got["ours"] == got["ref"]
    names = {(n, p) for n, p, *_ in got["ours"][0]}
    assert names == {("test.request", None),
                     ("replica.route", "test.request"),
                     ("admission", "replica.route"),
                     ("batch.queue", "replica.route")}


# ------------------------------------------------------------ the PS stitch
def _replica(torch_leaves: bool):
    w = torch.zeros(4) if torch_leaves else np.zeros(4, np.float32)
    return types.SimpleNamespace(params_list=[{"w": w}], iteration=0,
                                 fit=lambda x, y: None)


def _ps_tree(mod, tmod, tr, transport_kind):
    """One worker window of one step through ``transport_kind``, with the
    transport bound to an open consume span, as the elastic worker binds
    its batch's; returns the consume trace's shape."""
    server = mod.ParameterServer([np.zeros(4, np.float32)])
    frontend = None
    if transport_kind == "tcp":
        frontend = tmod.ParameterServerTcpFrontend(server).start()
        transport = tmod.TcpTransport(("127.0.0.1", frontend.port))
    else:
        transport = tmod.InprocTransport(server)
    consume = tr.start_span("broker.consume", topic="t")
    batches = iter([types.SimpleNamespace(features=np.zeros((1, 4)),
                                          labels=np.zeros((1, 4)))])
    try:
        transport.bind_trace_parent(consume.ref())
        mod.run_worker_loop(transport=transport,
                            replica=_replica(mod is ps), step_fn=None,
                            next_batch=lambda: next(batches, None),
                            push_frequency=1, background_pull=False)
    finally:
        consume.finish()
        transport.close()
        if frontend is not None:
            frontend.stop()
    store = tr.global_trace_store()
    want = {"ps.push_window", "ps.push"} | (
        {"ps.apply"} if transport_kind == "tcp" else set())
    rec = _wait(store, consume.trace_id, want)
    return shape(rec)


@pytest.mark.parametrize("transport_kind", ["inproc", "tcp"])
def test_ps_push_stitches_one_trace_as_jax(stores, transport_kind):
    ours = _ps_tree(ps, pst, tracing, transport_kind)
    ref = _ps_tree(jps, jpst, jtracing, transport_kind)
    assert ours == ref
    parents = {(n, p) for n, p, *_ in ours}
    assert ("ps.push_window", "broker.consume") in parents
    assert ("ps.push", "ps.push_window") in parents
    if transport_kind == "tcp":
        # the worker's first pull is traced on the wire too
        assert ("ps.pull", "broker.consume") in parents
        assert ("ps.apply", "ps.push") in parents


def test_ps_apply_parents_on_a_jax_worker_header(stores):
    """The trace crosses packages on the wire: a JAX TCP worker's push
    lands as ``ps.apply`` in the port server's store, under the worker's
    trace id and RPC span."""
    ours_st, ref_st = stores
    server = ps.ParameterServer([np.zeros(4, np.float32)])
    frontend = pst.ParameterServerTcpFrontend(server).start()
    transport = jpst.TcpTransport(("127.0.0.1", frontend.port))
    try:
        with jtracing.trace_span("worker.window") as root:
            transport.push(np.ones(4, np.float32), 0)
    finally:
        transport.close()
        frontend.stop()
    worker = ref_st.get(root.trace_id)
    rpc = next(s for s in worker["spans"] if s["name"] == "ps.push")
    rec = _wait(ours_st, root.trace_id, ("ps.apply",))
    (apply,) = rec["spans"]
    assert apply["name"] == "ps.apply" and apply["parent_id"] == rpc["span_id"]
    assert apply["attrs"]["accepted"] is True


# --------------------------------------------------------- the broker stitch
def _broker_tree(bmod, tr):
    b = bmod.LoopbackBroker().start()
    producer = bmod.BrokerProducer(b.address)
    consumer = bmod.ReconnectingConsumer(b.address, "t", group="g")
    try:
        with tr.trace_span("shard.publish", topic="t", shard=0) as root:
            producer.publish("t", {"x": np.arange(4, dtype=np.float32)})
        producer.publish("t", {"x": np.zeros(1, np.float32)})
        meta, arrays = consumer.get(timeout=10)
        ref = consumer.last_trace_ref
        assert "traceparent" in meta and ref.trace_id == root.trace_id
        np.testing.assert_array_equal(arrays["x"], np.arange(4))
        meta, _ = consumer.get(timeout=10)
        assert "traceparent" not in meta and consumer.last_trace_ref is None
    finally:
        consumer.close()
        producer.close()
        b.stop()
    return shape(_wait(tr.global_trace_store(), root.trace_id,
                       ("broker.consume",)))


def test_broker_publish_consume_stitch_as_jax(stores):
    ours = _broker_tree(broker, tracing)
    assert ours == _broker_tree(jbroker, jtracing)
    assert [(n, p) for n, p, *_ in ours] == [
        ("broker.consume", "shard.publish"), ("shard.publish", None)]


def test_broker_trace_crosses_from_a_jax_producer(stores):
    """A JAX producer's message meta parents the port consumer's
    ``broker.consume`` (the reserved ``traceparent`` key of wire.py)."""
    ours_st, ref_st = stores
    b = broker.LoopbackBroker().start()
    producer = jbroker.BrokerProducer(b.address)
    consumer = broker.ReconnectingConsumer(b.address, "t", group="g")
    try:
        with jtracing.trace_span("shard.publish") as root:
            producer.publish("t", {"x": np.ones(2, np.float32)})
        consumer.get(timeout=10)
    finally:
        consumer.close()
        producer.close()
        b.stop()
    rec = _wait(ours_st, root.trace_id, ("broker.consume",))
    assert rec["spans"][0]["parent_id"] == root.span_id


# --------------------------------------------------------------- persistence
@pytest.mark.parametrize("writer", ["port", "jax"])
def test_trace_index_reads_across_packages(writer, tmp_path):
    wmod, rmod = (tracing, jtracing) if writer == "port" else \
        (jtracing, tracing)
    regs = {tracing: MetricsRegistry, jtracing: JMetricsRegistry}
    st = wmod.TraceStore(enabled=True, sample=1.0, base_dir=str(tmp_path),
                         registry=regs[wmod]())
    prev = wmod.global_trace_store()
    wmod.set_global_trace_store(st)
    try:
        ids = []
        for name in ("a", "b"):
            with wmod.trace_span(f"http /{name}") as sp:
                with wmod.trace_span("child"):
                    pass
            ids.append(sp.trace_id)
    finally:
        wmod.set_global_trace_store(prev)
    assert not st._index_failed
    reader = rmod.TraceStore(enabled=True, base_dir=str(tmp_path),
                             registry=regs[rmod]())
    assert reader.index_entries() == st.index_entries()
    assert {e["trace_id"] for e in reader.index_entries()} == set(ids)
    storage = (JFileStorage if writer == "port" else FileStatsStorage)(
        str(tmp_path / "trace_index.db"))
    try:
        assert storage.list_session_ids() == ["traces"]
        assert storage.list_type_ids_for_session("traces") == ["TraceRecord"]
        assert sorted(storage.list_worker_ids_for_session("traces")) == \
            sorted(ids)
    finally:
        storage.close()
    lines = (tmp_path / "traces.jsonl").read_text().splitlines()
    assert [json.loads(l)["n_spans"] for l in lines] == [2, 2]


def test_persistence_failure_never_fails_a_trace(tmp_path):
    blocker = tmp_path / "file"
    blocker.write_text("x")
    st = tracing.TraceStore(enabled=True, sample=1.0,
                            base_dir=str(blocker / "sub"),
                            registry=MetricsRegistry())
    prev = tracing.global_trace_store()
    tracing.set_global_trace_store(st)
    try:
        with tracing.trace_span("http /x") as sp:
            pass
    finally:
        tracing.set_global_trace_store(prev)
    assert st._index_failed and st.get(sp.trace_id) is not None


# ------------------------------------------------------------------ span()
def test_span_histogram_recorder_and_trace(stores):
    ours_st, _ = stores
    reg = MetricsRegistry()
    rec = FlightRecorder(capacity=16, registry=reg)
    with span("epoch/0/stage", metric_name="stage", registry=reg,
              recorder=rec):
        pass
    with tracing.trace_span("http /v1/predict") as root:
        with span("epoch/1/stage", metric_name="stage", registry=reg,
                  recorder=rec):
            pass
    (s,) = reg.snapshot()["dl4j_span_seconds"]["series"]
    assert s["labels"] == {"name": "stage"} and s["count"] == 2
    kinds = [(e["kind"], e["name"]) for e in rec.snapshot()]
    assert kinds == [("span_enter", "epoch/0/stage"),
                     ("span_exit", "epoch/0/stage"),
                     ("span_enter", "epoch/1/stage"),
                     ("span_exit", "epoch/1/stage")]
    # only the span under an ambient trace opened a trace span
    assert len(ours_st) == 1
    assert [(n, p) for n, p, *_ in shape(ours_st.get(root.trace_id))] == [
        ("http /v1/predict", None), ("stage", "http /v1/predict")]


def test_jax_span_histogram_contract_holds_on_port(monkeypatch):
    run_on_port("test_observability", "test_span_records_histogram",
                monkeypatch, ["deeplearning4j_tpu.observability.metrics",
                              "deeplearning4j_tpu.observability.spans"])


def test_live_table_empties_after_rejected_and_closed_sessions(stores):
    """Every span a rejected or drained session opened is finished: no
    trace stays live (``dl4j_trace_live_traces`` back to 0)."""
    ours_st, _ = stores
    from deeplearning4j_tpu_torch.keras_server.admission import RejectedError
    from deeplearning4j_tpu_torch.models.transformer import transformer_lm
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    net = MultiLayerNetwork(transformer_lm(24, width=32, n_layers=1,
                                           n_heads=2, max_len=32, seed=5),
                            device="cpu").init()
    eng = decode_mod.DecodeEngine(net, device="cpu", max_context=32,
                                  min_slots=1, max_slots=1, kv="paged",
                                  page_size=8, n_pages=2)
    try:
        with tracing.trace_span("http /v1/generate") as root:
            with pytest.raises(RejectedError):
                eng.submit([1] * 20, max_new_tokens=10)   # never fits
            with pytest.raises(ValueError):
                eng.submit([99], max_new_tokens=2)        # outside vocab
            sessions = [eng.submit([1, 2], max_new_tokens=3)
                        for _ in range(3)]
    finally:
        eng.close()
    assert all(s.done.is_set() for s in sessions)
    rec = _wait(ours_st, root.trace_id)
    statuses = sorted(s["status"] for s in rec["spans"]
                      if s["name"] == "decode.queue")
    assert statuses == ["error", "ok", "ok", "ok", "rejected"]
    assert rec["keep_reason"] == "error" and not ours_st._live
