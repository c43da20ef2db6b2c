"""Replicas behind the least-queue router, multi-input ``PredictFn`` and
batcher, held against the JAX package.

Mirrors ``tests/test_serving_replica.py`` on the CPU (``device="cpu"``):
a two-input graph (and a two-input, two-output one) through ``PredictFn``
and the ``MicroBatcher`` against the JAX network's ``output`` within 1e-6; a
rolling hot swap over 3 replicas that loses no request, each answer within
1e-6 of the JAX ``output`` of the version that answered it; the router's
preference for the shorter queue; replica mode's refusal of an external
registry; the sharded placements that wait for ROADMAP.md A7; HTTP status
in replica mode. Also the empty ``MultiLayerConfiguration()`` against the
JAX one, and the launch counter under threads. Weights cross only through
``convert.from_jax``.
"""
import http.client
import json
import threading
import time

import numpy as np
import pytest

from deeplearning4j_tpu.keras_server.batcher import MicroBatcher as JaxBatcher
from deeplearning4j_tpu.keras_server.registry import (
    ModelRegistry as JaxRegistry,
)
from deeplearning4j_tpu.nn.conf.builders import NeuralNetConfiguration as JNNC
from deeplearning4j_tpu.nn.conf.layers import DenseLayer, OutputLayer
from deeplearning4j_tpu.nn.conf.vertices import MergeVertex
from deeplearning4j_tpu.nn.graph_network import ComputationGraph as JaxGraph
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JaxNet
from deeplearning4j_tpu_torch.convert import from_jax
from deeplearning4j_tpu_torch.keras_server import (
    InferenceServer, MicroBatcher, ModelRegistry, ReplicaSet,
)
from deeplearning4j_tpu_torch.nn.inference import PredictFn, make_predict_fn
from deeplearning4j_tpu_torch.ops import _cuda

N_IN, N_OUT = 16, 4
TOL = 1e-6


def _np(tree):
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_np(v) for v in tree]
    return np.asarray(tree)


def _port(jnet):
    return from_jax(jnet.conf.to_json(), _np(jnet.params_list), device="cpu")


def _jax_mlp(seed=7):
    conf = (JNNC.builder().seed(seed).learning_rate(0.1).updater("adam")
            .weight_init("xavier").list()
            .layer(DenseLayer(n_in=N_IN, n_out=32, activation="relu"))
            .layer(OutputLayer(n_in=32, n_out=N_OUT, loss="mcxent",
                               activation="softmax"))
            .build())
    return JaxNet(conf).init()


def _jax_two_input_graph(seed=5, two_outputs=False):
    b = (JNNC.builder().seed(seed).learning_rate(0.1).updater("adam")
         .weight_init("xavier").graph_builder()
         .add_inputs("a", "b")
         .add_layer("da", DenseLayer(n_in=4, n_out=6, activation="tanh"), "a")
         .add_layer("db", DenseLayer(n_in=3, n_out=6, activation="tanh"), "b")
         .add_vertex("merged", MergeVertex(), "da", "db")
         .add_layer("out", OutputLayer(n_in=12, n_out=2, loss="mse",
                                       activation="identity"), "merged"))
    if two_outputs:
        b = b.add_layer("out2", OutputLayer(n_in=12, n_out=3, loss="mcxent",
                                            activation="softmax"), "merged")
        b = b.set_outputs("out", "out2")
    else:
        b = b.set_outputs("out")
    return JaxGraph(b.build()).init()


def _ab(n=3, seed=3):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, 4)).astype(np.float32),
            rng.normal(size=(n, 3)).astype(np.float32))


# ----------------------------------------------------- multi-input serving
@pytest.mark.parametrize("two_outputs", [False, True])
def test_multi_input_graph_through_predictfn_and_batcher(two_outputs):
    jnet = _jax_two_input_graph(two_outputs=two_outputs)
    net = _port(jnet)
    a, b = _ab()
    want = [np.asarray(o) for o in jnet.output(a, b)]
    pf = make_predict_fn(net, device="cpu")
    assert pf.n_inputs == 2
    got = pf(a, b)
    got = [g.numpy() for g in (got if two_outputs else [got])]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=0, atol=TOL)
    with pytest.raises(ValueError, match="2 input"):
        pf(a)

    registry = ModelRegistry()
    registry.register("g", net, version="v1", device="cpu")
    batcher = MicroBatcher(registry, max_batch=8, max_latency_s=0.002)
    try:
        futs = [batcher.submit("g", [a[i:i + 1], b[i:i + 1]])
                for i in range(3)]
        for i, f in enumerate(futs):
            pred = f.result(timeout=30)["predictions"]
            pred = pred if two_outputs else [pred]
            for p, w in zip(pred, want):
                np.testing.assert_allclose(np.asarray(p), w[i:i + 1],
                                           rtol=0, atol=TOL)
        # mismatched leading dims are an input error at submit, as in JAX
        with pytest.raises(ValueError, match="leading batch axis"):
            batcher.submit("g", [a, b[:2]])
        assert batcher.stats()["errors"] == 0
    finally:
        batcher.close()
    # the JAX batcher refuses the same request the same way
    jreg = JaxRegistry()
    jreg.register("g", jnet, version="v1")
    jb = JaxBatcher(jreg, max_batch=8, max_latency_s=0.002)
    try:
        with pytest.raises(ValueError, match="leading batch axis"):
            jb.submit("g", [a, b[:2]])
    finally:
        jb.close()


# ----------------------------------------------------- replica set + router
def test_rolling_hot_swap_three_replicas_zero_loss():
    j1, j2 = _jax_mlp(seed=1), _jax_mlp(seed=2)
    x = np.random.default_rng(0).normal(size=(1, N_IN)).astype(np.float32)
    want = {"v1": np.asarray(j1.output(x)), "v2": np.asarray(j2.output(x))}
    rs = ReplicaSet(3, device="cpu", max_latency_s=0.001,
                    drain_timeout_s=30.0)
    try:
        rs.register("m", _port(j1), version="v1")
        results, errors = [], []
        done = threading.Event()

        def client():
            got = []
            while not (done.is_set() and len(got) >= 100):
                try:
                    got.append(rs.submit("m", x).result(timeout=60))
                except Exception as e:  # any loss fails the test
                    errors.append(e)
                    break
                time.sleep(0.0005)
            results.extend(got)

        threads = [threading.Thread(target=client) for _ in range(3)]
        for t in threads:
            t.start()
        time.sleep(0.05)  # let v1 traffic establish
        rs.register("m", _port(j2), version="v2")
        done.set()
        for t in threads:
            t.join(timeout=120)
        assert not errors, f"requests lost during the roll: {errors[:3]}"
        assert len(results) >= 300
        versions = {r["version"] for r in results}
        assert versions == {"v1", "v2"}
        for r in results:
            np.testing.assert_allclose(np.asarray(r["predictions"]),
                                       want[r["version"]], rtol=0, atol=TOL)
        assert {r["replica"] for r in results} == {0, 1, 2}
        for r in rs.replicas:
            assert r.registry.active("m").version == "v2"
            assert r.registry.active("m").predict_fn.name == \
                f"serve_predict@v2~r{r.index}"
            assert not r.draining
        with pytest.raises(ValueError, match="immutable"):
            rs.register("m", _port(j1), version="v2")
    finally:
        rs.close()


def test_router_prefers_shorter_queue_under_slow_replica():
    rs = ReplicaSet(2, device="cpu", max_batch=1, max_latency_s=0.0)
    try:
        rs.register("m", _port(_jax_mlp()), version="v1")
        x = np.zeros((1, N_IN), np.float32)
        for r in rs.replicas:
            r.batcher.submit("m", x).result(timeout=60)
        # wedge replica 0: every dispatch sleeps, so its queue stays deep
        mv0 = rs.replicas[0].registry.active("m")
        real = mv0.predict_fn

        def slow(*xs):
            time.sleep(0.05)
            return real(*xs)

        mv0.predict_fn = slow
        futs = []
        for _ in range(40):
            futs.append(rs.submit("m", x))
            time.sleep(0.002)
        by_replica = {0: 0, 1: 0}
        for f in futs:
            by_replica[f.result(timeout=60)["replica"]] += 1
        assert by_replica[1] > by_replica[0], by_replica
        routed = {r["replica"]: r["routed"] for r in rs.stats()["replicas"]}
        assert routed[1] > routed[0]
    finally:
        rs.close()


def test_replica_mode_refuses_external_registry():
    with pytest.raises(ValueError, match="replica mode"):
        InferenceServer(ModelRegistry(), replicas=2, device="cpu")


def test_sharded_placements_wait_for_a7():
    net = _port(_jax_mlp())
    with pytest.raises(NotImplementedError, match="A7.1"):
        ReplicaSet(2, device="cpu", sharding="dp_tp")
    with pytest.raises(NotImplementedError, match="A7.4"):
        ReplicaSet(2, device="cpu", membership=object())
    with pytest.raises(NotImplementedError, match="A7"):
        InferenceServer(replicas=2, device="cpu", sharding="dp_tp")
    with pytest.raises(NotImplementedError, match="A7"):
        InferenceServer(replicas=2, device="cpu",
                        replica_mesh_axes={"data": 2})
    with pytest.raises(NotImplementedError, match="A7"):
        ReplicaSet(2, device="cpu", devices=["cpu", "cpu"])
    with pytest.raises(NotImplementedError, match="A7"):
        InferenceServer(replicas=2, device="cpu", replica_devices=["cpu"])
    with pytest.raises(NotImplementedError, match="A7.8"):
        make_predict_fn(net, device="cpu", sharding="dp_tp", mesh=object())
    with pytest.raises(NotImplementedError, match="A7.8"):
        PredictFn(net, device="cpu", mesh=object())


def test_http_replica_mode_status():
    jnet = _jax_mlp()
    srv = InferenceServer(replicas=2, device="cpu", max_batch=8,
                          max_latency_s=0.002, max_queue=64)
    srv.register("mlp", _port(jnet), version="v1")
    srv.start()
    try:
        conn = http.client.HTTPConnection("127.0.0.1", srv.port, timeout=30)
        x = np.random.default_rng(5).normal(size=(2, N_IN)).astype(np.float32)
        conn.request("POST", "/v1/predict",
                     body=json.dumps({"model": "mlp", "inputs": x.tolist()}),
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        body = json.loads(resp.read())
        assert resp.status == 200
        assert body["version"] == "v1" and body["replica"] in (0, 1)
        np.testing.assert_allclose(np.asarray(body["predictions"]),
                                   np.asarray(jnet.output(x)), rtol=0,
                                   atol=TOL)
        conn.request("GET", "/serve/status")
        st = json.loads(conn.getresponse().read())
        conn.close()
        assert st["replicas"]["n_replicas"] == 2
        assert len(st["replicas"]["replicas"]) == 2
        assert st["queue"]["replicas"] == 2 and "queue_depth" in st["queue"]
        for rep in st["replicas"]["replicas"]:
            assert rep["active"] == {"mlp": "v1"}
            assert rep["devices"] == ["cpu"]
        assert sum(rep["routed"] for rep in st["replicas"]["replicas"]) == 1
        assert "autoscaler" not in st
    finally:
        srv.stop()


def test_fleet_reads_race_free_under_churn():
    rs = ReplicaSet(2, device="cpu", max_batch=4, max_latency_s=0.001,
                    max_queue=8)
    stop = threading.Event()
    errors = []

    def reader():
        try:
            while not stop.is_set():
                assert rs.n_replicas >= 1
                assert rs.primary_registry is rs.replicas[0].registry
        except Exception as e:  # pragma: no cover - the regression itself
            errors.append(e)

    readers = [threading.Thread(target=reader) for _ in range(4)]
    try:
        for t in readers:
            t.start()
        for _ in range(5):
            rs.add_replica(reason="t-churn")
            rs.add_replica(reason="t-churn")
            assert rs.remove_replica(reason="t-churn") is True
            assert rs.remove_replica(reason="t-churn") is True
    finally:
        stop.set()
        for t in readers:
            t.join()
        rs.close()
    assert not errors
    assert rs.scale_events[("out", "t-churn")] == 10
    assert rs.scale_events[("in", "t-churn")] == 10


# -------------------------------------------------------------- C2, counts
def test_empty_multilayer_configuration_equals_jax():
    from deeplearning4j_tpu.nn.conf.multilayer import (
        MultiLayerConfiguration as JaxConf,
    )
    from deeplearning4j_tpu_torch.nn.conf import MultiLayerConfiguration
    conf = MultiLayerConfiguration()
    assert conf.layers == [] and conf.global_conf.seed == 12345
    assert conf.to_dict() == json.loads(JaxConf().to_json())
    # two empty configs own their lists
    assert MultiLayerConfiguration().layers is not conf.layers


def test_launch_counter_exact_under_threads():
    def fake_kernel():
        pass

    fake_kernel.launches = 0
    barrier = threading.Barrier(8)

    def work():
        barrier.wait()
        for _ in range(1000):
            _cuda.count(fake_kernel)

    threads = [threading.Thread(target=work) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert fake_kernel.launches == 8000
    _cuda.count(fake_kernel, 5)
    assert fake_kernel.launches == 8005


def test_capture_records_only_its_streams_launches(monkeypatch):
    """A graph capture records the launches made on its stream, from any
    thread (autograd runs the backward on its own); another stream's
    launches meanwhile count as usual."""
    def fake_kernel():
        pass

    class Stream:
        cuda_stream = 7

    fake_kernel.launches = 0
    on = threading.local()
    monkeypatch.setattr(_cuda, "_current_stream",
                        lambda: getattr(on, "stream", 0))

    def launch(stream, n):
        on.stream = stream
        for _ in range(n):
            _cuda.count(fake_kernel)

    with _cuda.capturing(Stream()) as rec:
        threads = [threading.Thread(target=launch, args=(7, 5)),
                   threading.Thread(target=launch, args=(0, 100))]
        for t in threads:
            t.start()
        launch(7, 2)
        for t in threads:
            t.join()
        with pytest.raises(RuntimeError, match="already records"):
            with _cuda.capturing(Stream()):
                pass
    assert rec == {fake_kernel: 7}
    assert fake_kernel.launches == 100
    launch(7, 1)
    assert fake_kernel.launches == 101
