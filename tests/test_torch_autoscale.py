"""The autoscaler, fleet mutation, tenants and the load generator of the
port, held against the JAX package.

Mirrors ``tests/test_autoscale.py`` on the CPU (``device="cpu"``):
``add_replica``/``remove_replica`` are atomic and never reuse an index;
scale-in drains without loss; one scale event per cooldown window on a
fake clock, one step at a time, within the bounds, scale-in only after
``headroom_ticks`` quiet ticks; the bounds are validated; under saturation
``low`` is shed before ``high``, and the port's per-tenant shed counts
equal the JAX package's ``dl4j_serve_shed_total`` for the same sequence;
the ``X-DL4J-Priority``/``X-DL4J-Tenant`` headers reach admission. The
load generator's records carry the JAX harnesses' keys (each run at a tiny
size in both packages), its percentile is JAX's, and its subprocess client
answers. Answers are held against the JAX network's ``output`` within 1e-6.
"""
import http.client
import json

import numpy as np
import pytest

from deeplearning4j_tpu.keras_server import admission as jax_admission
from deeplearning4j_tpu.keras_server import loadgen as jax_loadgen
from deeplearning4j_tpu.models.transformer import transformer_lm as jax_lm
from deeplearning4j_tpu.nn.conf.builders import NeuralNetConfiguration as JNNC
from deeplearning4j_tpu.nn.conf.layers import DenseLayer, OutputLayer
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JaxNet
from deeplearning4j_tpu.observability import names as _n
from deeplearning4j_tpu.observability.metrics import global_registry
from deeplearning4j_tpu_torch.convert import from_jax
from deeplearning4j_tpu_torch.keras_server import (
    Autoscaler, InferenceServer, ReplicaSet, loadgen,
)
from deeplearning4j_tpu_torch.keras_server.admission import (
    PRIORITY_FLOORS, PRIORITY_LEVELS, AdmissionController, RejectedError,
    normalize_priority,
)
from deeplearning4j_tpu_torch.keras_server.serving import (
    PRIORITY_HEADER, TENANT_HEADER,
)

N_IN, N_OUT = 12, 3
TOL = 1e-6


def _jax_mlp(seed=7):
    conf = (JNNC.builder().seed(seed).learning_rate(0.1).updater("adam")
            .weight_init("xavier").list()
            .layer(DenseLayer(n_in=N_IN, n_out=16, activation="relu"))
            .layer(OutputLayer(n_in=16, n_out=N_OUT, loss="mcxent",
                               activation="softmax"))
            .build())
    return JaxNet(conf).init()


def _port(jnet):
    params = [{k: np.asarray(v) for k, v in p.items()}
              for p in jnet.params_list]
    return from_jax(jnet.conf.to_json(), params, device="cpu")


@pytest.fixture(scope="module")
def mlp():
    jnet = _jax_mlp()
    return jnet, _port(jnet)


def _x(n=2, seed=0):
    return np.random.default_rng(seed).standard_normal((n, N_IN)) \
        .astype(np.float32)


class _Clock:
    def __init__(self, t=1000.0):
        self.t = t

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


class _FakeSLO:
    """Duck-typed SLO engine: the autoscaler only reads evaluate()."""

    def __init__(self, burn=0.0, alerting=False):
        self.burn = burn
        self.alerting = alerting

    def evaluate(self):
        return [{"name": "latency", "alerting": self.alerting,
                 "windows": [{"burn_rate": self.burn}]}]


# ------------------------------------------------------- fleet mutation API
def test_add_remove_replica_atomic(mlp):
    jnet, net = mlp
    rs = ReplicaSet(2, device="cpu", max_batch=8, max_latency_s=0.001,
                    max_queue=32)
    try:
        rs.register("mlp", net, version="v1")
        r2 = rs.add_replica(reason="t-atomic")
        assert r2.index == 2 and rs.n_replicas == 3
        # the catalog was registered before the replica became routable
        assert r2.registry.active("mlp").version == "v1"
        out = r2.batcher.submit("mlp", _x()).result(timeout=30)
        np.testing.assert_allclose(np.asarray(out["predictions"]),
                                   np.asarray(jnet.output(_x())), rtol=0,
                                   atol=TOL)
        assert out["version"] == "v1" and out["replica"] == 2
        assert rs.scale_events[("out", "t-atomic")] == 1
        # a later register() rolls onto the added replica too
        rs.register("mlp", _port(_jax_mlp(seed=9)), version="v2")
        for r in rs.replicas:
            assert r.registry.active("mlp").version == "v2"
        assert rs.remove_replica(reason="t-atomic") is True
        assert sorted(r.index for r in rs.replicas) == [0, 1]
        assert rs.scale_events[("in", "t-atomic")] == 1
        assert rs.remove_replica(index=99) is False
        with pytest.raises(ValueError):
            rs.remove_replica(index=0)
        assert rs.remove_replica(index=1) is True
        with pytest.raises(ValueError):
            rs.remove_replica()
        assert rs.add_replica(reason="t-atomic").index == 3
        assert rs.n_replicas == 2
        assert {"direction": "out", "reason": "t-atomic", "count": 2} in \
            rs.stats()["scale_events"]
    finally:
        rs.close()


def test_scale_in_drains_without_loss(mlp):
    jnet, net = mlp
    rs = ReplicaSet(2, device="cpu", max_batch=8, max_latency_s=0.05,
                    max_queue=64)
    try:
        rs.register("mlp", net, version="v1")
        victim = [r for r in rs.replicas if r.index == 1][0]
        futures = [victim.batcher.submit("mlp", _x(1, seed=i))
                   for i in range(12)]
        assert rs.remove_replica(index=1, reason="t-drain") is True
        for i, f in enumerate(futures):
            out = f.result(timeout=30)
            np.testing.assert_allclose(
                np.asarray(out["predictions"]),
                np.asarray(jnet.output(_x(1, seed=i))), rtol=0, atol=TOL)
            assert out["replica"] == 1
        assert victim.batcher.admission.rejected == 0
        assert rs.n_replicas == 1
    finally:
        rs.close()


# --------------------------------------------------------------- hysteresis
def test_hysteresis_one_event_per_cooldown_window():
    clock = _Clock()
    slo = _FakeSLO(burn=5.0)
    rs = ReplicaSet(1, device="cpu", max_batch=4, max_latency_s=0.001,
                    max_queue=16)
    try:
        asc = Autoscaler(rs, slo_engine=slo, min_replicas=1, max_replicas=3,
                         cooldown_s=10.0, headroom_ticks=3, clock=clock)
        assert asc.tick() == "out" and rs.n_replicas == 2
        for _ in range(9):
            clock.advance(1.0)
            assert asc.tick() == "none"
        assert rs.n_replicas == 2
        clock.advance(1.0)
        assert asc.tick() == "out" and rs.n_replicas == 3
        clock.advance(11.0)
        assert asc.tick() == "none" and rs.n_replicas == 3
        slo.burn = 0.0
        clock.advance(11.0)
        assert asc.tick() == "none"      # low tick 1
        clock.advance(1.0)
        assert asc.tick() == "none"      # low tick 2
        slo.burn = 5.0                   # a blip resets the streak
        clock.advance(1.0)
        assert asc.tick() == "none"
        slo.burn = 0.0
        for _ in range(2):
            clock.advance(1.0)
            assert asc.tick() == "none"
        clock.advance(1.0)
        assert asc.tick() == "in" and rs.n_replicas == 2
        st = asc.status()
        assert st["n_replicas"] == 2
        assert st["last_decision"] == "in"
        assert st["last_reason"] == "headroom"
        assert st["min_replicas"] == 1 and st["max_replicas"] == 3
        assert st["last_scale_out_latency_s"] is not None
        assert [e["direction"] for e in st["events"]] == ["out", "out", "in"]
    finally:
        rs.close()


def test_queue_pressure_scales_out_and_drained_scale_in(mlp):
    """Queue pressure alone (no SLO input) scales out; the quiet fleet
    scales back in, drained, with every admitted request answered."""
    jnet, net = mlp
    clock = _Clock()
    rs = ReplicaSet(1, device="cpu", max_batch=4, max_latency_s=0.5,
                    max_queue=8)
    try:
        rs.register("mlp", net, version="v1")
        asc = Autoscaler(rs, min_replicas=1, max_replicas=2, cooldown_s=5.0,
                         headroom_ticks=2, clock=clock)
        futs = [rs.submit("mlp", _x(1, seed=i)) for i in range(6)]
        assert asc.tick() == "out" and rs.n_replicas == 2
        assert asc.status()["last_reason"] == "queue-depth"
        for i, f in enumerate(futs):
            np.testing.assert_allclose(
                np.asarray(f.result(timeout=30)["predictions"]),
                np.asarray(jnet.output(_x(1, seed=i))), rtol=0, atol=TOL)
        clock.advance(6.0)
        assert asc.tick() == "none"
        clock.advance(1.0)
        assert asc.tick() == "in" and rs.n_replicas == 1
    finally:
        rs.close()


def test_autoscaler_bounds_validation():
    rs = ReplicaSet(1, device="cpu", max_batch=4, max_queue=16)
    try:
        with pytest.raises(ValueError):
            Autoscaler(rs, min_replicas=0)
        with pytest.raises(ValueError):
            Autoscaler(rs, min_replicas=4, max_replicas=2)
        # a fleet below its floor is filled at the next tick
        asc = Autoscaler(rs, min_replicas=2, max_replicas=3,
                         cooldown_s=300.0)
        asc.tick()
        assert rs.n_replicas == 2
    finally:
        rs.close()


# --------------------------------------------------------- priority shedding
def _jax_shed(tenant, priority):
    series = global_registry().snapshot().get(
        _n.SERVE_SHED_TOTAL, {}).get("series", [])
    for s in series:
        if s["labels"].get("tenant") == tenant \
                and s["labels"].get("priority") == priority:
            return s["value"]
    return 0


def _shed_sequence(ac):
    """The JAX suite's saturation sequence; returns the refusals' flags."""
    out = []
    ac.admit(5, priority="high", tenant="acme-t16")
    for call in (dict(priority="low", tenant="free-t16"),
                 "admit2",
                 dict(priority="normal", tenant="acme-t16"),
                 "admit3",
                 dict(priority="high", tenant="acme-t16")):
        if call == "admit2":
            ac.admit(2, priority="normal", tenant="acme-t16")
            continue
        if call == "admit3":
            ac.admit(3, priority="high", tenant="acme-t16")
            continue
        with pytest.raises((RejectedError,
                            jax_admission.RejectedError)) as ei:
            ac.admit(**call)
        out.append((ei.value.priority, ei.value.shed))
    return out


def test_priority_shed_order_and_tenant_counts_equal_jax():
    assert PRIORITY_LEVELS == jax_admission.PRIORITY_LEVELS
    assert PRIORITY_FLOORS == jax_admission.PRIORITY_FLOORS
    for tag in (None, "LOW", "gibberish", " normal "):
        assert normalize_priority(tag) == jax_admission.normalize_priority(tag)
    ac = AdmissionController(max_pending=10, expected_latency_s=0.01)
    jac = jax_admission.AdmissionController(max_pending=10,
                                            expected_latency_s=0.01)
    for p in PRIORITY_LEVELS:
        assert ac.limit_for(p) == jac.limit_for(p)
    got, want = _shed_sequence(ac), _shed_sequence(jac)
    assert got == want == [("low", True), ("normal", True), ("high", False)]
    assert (ac.shed, ac.rejected) == (jac.shed, jac.rejected) == (2, 3)
    st = ac.stats()
    for tenant in ("free-t16", "acme-t16"):
        for p in PRIORITY_LEVELS:
            assert ac.shed_by[(tenant, p)] == _jax_shed(tenant, p)
    assert st["shed_by_tenant"] == {"acme-t16": 1, "free-t16": 1}
    assert st["shed_by_priority"] == {"low": 1, "normal": 1}
    assert st["pending"] == 10 and st["rejected"] == 3


def test_priority_flows_through_router(mlp):
    jnet, net = mlp
    rs = ReplicaSet(2, device="cpu", max_batch=8, max_latency_s=0.001,
                    max_queue=32)
    try:
        rs.register("mlp", net, version="v1")
        out = rs.submit("mlp", _x(), priority="low",
                        tenant="acme-t16").result(timeout=30)
        np.testing.assert_allclose(np.asarray(out["predictions"]),
                                   np.asarray(jnet.output(_x())), rtol=0,
                                   atol=TOL)
    finally:
        rs.close()


def _post(port, body, headers):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
    try:
        conn.request("POST", "/v1/predict", body=json.dumps(body),
                     headers={"Content-Type": "application/json", **headers})
        resp = conn.getresponse()
        return resp.status, json.loads(resp.read())
    finally:
        conn.close()


def test_http_autoscaler_status_and_tenant_header(mlp):
    jnet, net = mlp
    srv = InferenceServer(device="cpu", autoscale=True, min_replicas=1,
                          max_replicas=2, autoscale_cooldown_s=300.0,
                          max_batch=8, max_latency_s=0.002, max_queue=4)
    srv.register("mlp", net, version="v1")
    srv.start()
    try:
        x = np.zeros((2, N_IN), np.float32)
        code, body = _post(srv.port, {"model": "mlp", "inputs": x.tolist()},
                           {PRIORITY_HEADER: "low", TENANT_HEADER: "acme-t16"})
        assert code == 200
        np.testing.assert_allclose(np.asarray(body["predictions"]),
                                   np.asarray(jnet.output(x)), rtol=0,
                                   atol=TOL)
        # fill the one replica's low budget (2 of 4): the tenant's next low
        # request is shed with a 429 and counted against it
        adm = srv.replica_set.replicas[0].batcher.admission
        adm.admit(2, priority="high")
        try:
            code, _ = _post(srv.port, {"model": "mlp", "inputs": x.tolist()},
                            {PRIORITY_HEADER: "low",
                             TENANT_HEADER: "acme-t16"})
        finally:
            adm.release(2)
        assert code == 429
        assert adm.stats()["shed_by_tenant"] == {"acme-t16": 1}
        conn = http.client.HTTPConnection("127.0.0.1", srv.port, timeout=30)
        conn.request("GET", "/serve/status")
        st = json.loads(conn.getresponse().read())
        conn.close()
        asc = st["autoscaler"]
        assert asc["running"] is True
        assert asc["min_replicas"] == 1 and asc["max_replicas"] == 2
        assert asc["n_replicas"] >= 1 and "cooldown_s" in asc
        assert "last_scale_out_latency_s" in asc
        assert st["replicas"]["replicas"][0]["rejected"] == 1
    finally:
        srv.stop()


# ------------------------------------------------------------ the loadgen
def _keys(rec, prefix=""):
    """Every key path of a record, nested dicts included."""
    out = set()
    for k, v in rec.items():
        out.add(prefix + k)
        if isinstance(v, dict):
            out |= _keys(v, prefix + k + ".")
    return out


def _missing(jax_rec, port_rec):
    return sorted(_keys(jax_rec) - _keys(port_rec))


def test_percentile_equals_jax():
    vals = sorted(np.random.default_rng(0).normal(size=37).tolist())
    for q in (0.0, 0.5, 0.9, 0.99, 1.0):
        assert loadgen.percentile(vals, q) == jax_loadgen.percentile(vals, q)
    assert loadgen.percentile([], 0.5) == 0.0


def test_ramp_ab_record_keys_equal_jax(mlp, tmp_path):
    jnet, net = mlp
    kw = dict(model="mlp", qps_low=15.0, segment_s=0.6, slo_ms=1000.0,
              min_replicas=1, max_replicas=2, cooldown_s=0.5,
              interval_s=0.1, max_batch=8, max_latency_s=0.002,
              max_queue=64, example=np.zeros((1, N_IN), np.float32),
              workers=4)
    rec_path = tmp_path / "ramp.jsonl"
    rec = loadgen.run_ramp_ab(net, device="cpu", record_path=str(rec_path),
                              **kw)
    jrec = jax_loadgen.run_ramp_ab(jnet, **kw)
    assert _missing(jrec, rec) == []
    assert rec["harness"] == "keras_server.loadgen.run_ramp_ab"
    assert rec["qps_high"] == pytest.approx(150.0)
    for phase in ("auto", "static"):
        assert rec[phase]["requests"] > 0 and rec[phase]["ok"] > 0
        assert rec[phase]["p99_ms"] >= rec[phase]["p50_ms"] >= 0.0
    assert rec["lost_requests"] == 0 and rec["auto"]["lost"] == 0
    lines = rec_path.read_text().strip().splitlines()
    assert len(lines) == 1 and json.loads(lines[0])["model"] == "mlp"


@pytest.mark.parametrize("harness", ["run_ab", "run_replica_ab"])
def test_predict_harness_record_keys_equal_jax(mlp, harness):
    jnet, net = mlp
    kw = dict(model="mlp", qps=40.0, duration_s=0.4, max_batch=8,
              example=np.zeros((1, N_IN), np.float32), workers=4,
              warmup_requests=2, isolate_client=False)
    rec = getattr(loadgen, harness)(net, device="cpu", **kw)
    jrec = getattr(jax_loadgen, harness)(jnet, **kw)
    assert _missing(jrec, rec) == []
    phases = (("unbatched", "batched") if harness == "run_ab"
              else ("replicas_1", "replicas_n"))
    for p in phases:
        assert rec[p]["ok"] > 0 and rec[p]["errors"] == 0
        assert rec[p]["recompiles"] == rec[p]["bucket_count"]
        assert rec[p]["kernel_launches"] == {}  # the CPU launches none


@pytest.fixture(scope="module")
def lm():
    jnet = JaxNet(jax_lm(vocab_size=24, width=32, n_layers=2, n_heads=2,
                         max_len=64, seed=5)).init()
    jdraft = JaxNet(jax_lm(vocab_size=24, width=16, n_layers=2, n_heads=2,
                           max_len=64, seed=9)).init()
    return (jnet, _port(jnet)), (jdraft, _port(jdraft))


@pytest.mark.parametrize("harness", ["run_spec_ab", "run_paged_ab",
                                     "run_decode_ab"])
def test_decode_harness_record_keys_equal_jax(lm, harness):
    (jnet, net), (jdraft, draft) = lm
    kw = dict(n_sessions=6, prompt_len=3, max_new_tokens=6, max_context=64)
    if harness == "run_decode_ab":
        kw.update(slots=4, offered_sps=1000.0)
    extra = (draft,) if harness == "run_spec_ab" else ()
    jextra = (jdraft,) if harness == "run_spec_ab" else ()
    rec = getattr(loadgen, harness)(net, *extra, device="cpu", **kw)
    jrec = getattr(jax_loadgen, harness)(jnet, *jextra, **kw)
    assert _missing(jrec, rec) == []
    if harness != "run_decode_ab":
        assert rec["bitwise_equal"] is True
    if harness == "run_spec_ab":
        assert rec["acceptance"] == pytest.approx(jrec["acceptance"])
        assert rec["spec"]["tokens"] == rec["greedy"]["tokens"]


def test_subprocess_client_answers(mlp):
    _, net = mlp
    srv = InferenceServer(device="cpu", max_batch=8).start()
    try:
        srv.register("mlp", net)
        res = loadgen.run_closed_loop_proc(srv.port, "mlp", (1, N_IN),
                                           workers=2, requests_per_worker=3)
    finally:
        srv.stop()
    assert res["mode"] == "closed" and res["ok"] == 6
    assert res["errors"] == 0 and res["rejected"] == 0
