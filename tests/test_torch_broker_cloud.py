"""The port's broker, routes and cloud module held against the JAX
package's on the CPU: ``deeplearning4j_tpu_torch/streaming/broker.py``,
``streaming/__init__.py`` and ``cloud/__init__.py``.

The counterparts of ``tests/test_streaming_broker.py`` and
``tests/test_cloud_streaming.py``: offset-addressed delivery, committed-
offset resume across forced connection drops (nothing lost), redelivery of
an uncommitted message, independent consumer groups, a training route fed
through the broker surviving a drop, handler errors kept and counted, the
ingest source; the storage providers (local, HTTP with auth and the
path-escape guard, bad uploads refused), the gated S3 provider, the
provisioner's request dict equal to JAX's, and the training and serving
routes against the JAX routes on the same messages (params within 1e-6,
outputs within 1e-6). Frames cross packages: a JAX producer feeds the
port's consumer through the JAX broker, and the other way round. Every
server started here is stopped.
"""
import queue
import threading
import time

import numpy as np
import pytest

from deeplearning4j_tpu import cloud as jcloud
from deeplearning4j_tpu import streaming as jstreaming
from deeplearning4j_tpu.nn.conf.builders import NeuralNetConfiguration as JNNC
from deeplearning4j_tpu.nn.conf.layers import DenseLayer, OutputLayer
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JaxNet
from deeplearning4j_tpu.streaming import broker as jbroker
from deeplearning4j_tpu_torch import cloud
from deeplearning4j_tpu_torch.convert import from_jax, to_numpy
from deeplearning4j_tpu_torch.streaming import (
    Route, ServingRoute, TrainingRoute,
)
from deeplearning4j_tpu_torch.streaming.broker import (
    BrokerIngestSource, BrokerProducer, BrokerTrainingRoute, LoopbackBroker,
    ReconnectingConsumer,
)

TOL = 1e-6


@pytest.fixture()
def broker():
    b = LoopbackBroker().start()
    yield b
    b.stop()


def _msg(i, n=4):
    return {"x": np.full((2, n), float(i), np.float32),
            "y": np.eye(3, dtype=np.float32)[[i % 3, (i + 1) % 3]]}


def _np(tree):
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_np(v) for v in tree]
    return np.asarray(tree)


def _jax_net(n_out=3, seed=12345):
    conf = (JNNC.builder().seed(seed).learning_rate(0.1).updater("sgd")
            .list()
            .layer(DenseLayer(n_in=4, n_out=8, activation="tanh"))
            .layer(OutputLayer(n_in=8, n_out=n_out, loss="mcxent",
                               activation="softmax"))
            .build())
    return JaxNet(conf).init()


def _port(jnet):
    return from_jax(jnet.conf.to_json(), _np(jnet.params_list), device="cpu")


def _wait(pred, timeout=10.0):
    deadline = time.time() + timeout
    while not pred() and time.time() < deadline:
        time.sleep(0.02)
    return pred()


# ------------------------------------------------------------------ broker
def test_publish_fetch_roundtrip(broker):
    prod = BrokerProducer(broker.address)
    cons = ReconnectingConsumer(broker.address, "t", group="g")
    try:
        assert prod.publish("t", _msg(0), meta={"tag": "a"}) == 0
        assert prod.publish("t", _msg(1)) == 1
        meta, arrays = cons.get(timeout=2.0)
        assert meta["tag"] == "a"
        np.testing.assert_array_equal(arrays["x"], _msg(0)["x"])
        cons.task_done()
        _, arrays = cons.get(timeout=2.0)
        np.testing.assert_array_equal(arrays["y"], _msg(1)["y"])
        cons.task_done()
        with pytest.raises(queue.Empty):
            cons.get(timeout=0.05)  # the log is exhausted
        assert broker.depth("t") == 2
        assert broker.committed("t", "g") == 1
        st = broker.stats()
        assert st["publish"] == 2 and st["deliver"] == 2
        assert st["topics"] == {"t": 2}
    finally:
        prod.close()
        cons.close()


def test_forced_drop_loses_no_messages(broker):
    prod = BrokerProducer(broker.address)
    cons = ReconnectingConsumer(broker.address, "t", group="g")
    try:
        for i in range(10):
            prod.publish("t", _msg(i), meta={"i": i})
        seen = []
        for _ in range(5):
            meta, _ = cons.get(timeout=2.0)
            seen.append(meta["i"])
            cons.task_done()
        assert broker.drop_connections() >= 1
        for _ in range(5):
            meta, _ = cons.get(timeout=5.0)
            seen.append(meta["i"])
            cons.task_done()
        assert seen == list(range(10))  # nothing lost, nothing repeated
        assert cons.reconnects == 1
        # the producer's connection died too: it reconnects and retries
        assert prod.publish("t", _msg(10)) == 10
    finally:
        prod.close()
        cons.close()


def test_uncommitted_message_redelivers_after_drop(broker):
    prod = BrokerProducer(broker.address)
    cons = ReconnectingConsumer(broker.address, "t", group="g")
    try:
        prod.publish("t", _msg(0), meta={"i": 0})
        meta, _ = cons.get(timeout=2.0)
        assert meta["i"] == 0
        broker.drop_connections()  # dies before task_done commits
        cons.task_done()           # the commit is lost with it
        meta, _ = cons.get(timeout=5.0)
        assert meta["i"] == 0      # delivered again
        cons.task_done()
    finally:
        prod.close()
        cons.close()


def test_consumer_groups_track_independent_offsets(broker):
    prod = BrokerProducer(broker.address)
    a = ReconnectingConsumer(broker.address, "t", group="a")
    b = ReconnectingConsumer(broker.address, "t", group="b")
    try:
        for i in range(3):
            prod.publish("t", _msg(i), meta={"i": i})
        a.get(timeout=2.0)
        a.task_done()
        assert b.get(timeout=2.0)[0]["i"] == 0
        assert broker.committed("t", "a") == 0
        assert broker.committed("t", "b") == -1
    finally:
        prod.close()
        a.close()
        b.close()


@pytest.mark.parametrize("direction", ["jax_producer", "port_producer"])
def test_broker_frames_cross_packages(direction):
    """A JAX producer publishes to the JAX broker and the port's consumer
    reads it, bf16 codes included; then the port's producer feeds the
    port's broker and the JAX consumer reads it."""
    if direction == "jax_producer":
        b = jbroker.LoopbackBroker().start()
        prod = jbroker.BrokerProducer(b.address)
        cons = ReconnectingConsumer(b.address, "t", group="g")
    else:
        b = LoopbackBroker().start()
        prod = BrokerProducer(b.address)
        cons = jbroker.ReconnectingConsumer(b.address, "t", group="g")
    rng = np.random.default_rng(4)
    x = rng.normal(size=(3, 5)).astype(np.float32)
    try:
        prod.publish("t", {"x": x, "i": np.arange(3)}, meta={"k": 1})
        prod.publish("t", {"x": x}, codec="bf16")
        meta, arrays = cons.get(timeout=2.0)
        cons.task_done()
        assert meta["k"] == 1
        np.testing.assert_array_equal(arrays["x"], x)
        np.testing.assert_array_equal(arrays["i"], np.arange(3))
        _, arrays = cons.get(timeout=2.0)
        cons.task_done()
        from deeplearning4j_tpu.streaming import wire as jwire
        np.testing.assert_array_equal(
            arrays["x"], jwire.decode_array(*jwire.encode_array(x, "bf16")))
        assert b.committed("t", "g") == 1
    finally:
        prod.close()
        cons.close()
        b.stop()


def test_ingest_source_ends_at_fin(broker):
    prod = BrokerProducer(broker.address)
    try:
        for i in range(3):
            prod.publish("s", _msg(i))
        prod.publish("s", {}, meta={"fin": True})
        prod.publish("s", _msg(9))  # after the fin: not read
        cons = ReconnectingConsumer(broker.address, "s", group="g")
        got = [a["x"][0, 0] for a in BrokerIngestSource(cons, 2.0)]
        assert got == [0.0, 1.0, 2.0]
        assert broker.committed("s", "g") == 3  # the fin is committed
        cons.close()
    finally:
        prod.close()


# ------------------------------------------------------------------ routes
def _route_batches(n=6, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        x = rng.normal(size=(8, 4)).astype(np.float32)
        lab = (x[:, 0] + x[:, 1] > 0).astype(int)
        out.append((x, np.eye(3, dtype=np.float32)[lab]))
    return out


def test_training_route_matches_jax_route():
    jnet = _jax_net()
    net = _port(jnet)
    batches = _route_batches(5)
    ours, ref = TrainingRoute(net).start(), jstreaming.TrainingRoute(
        jnet).start()
    try:
        for x, y in batches:
            ours.send(x, y)
            ref.send(x, y)
        ours.drain()
        ref.drain()
    finally:
        ours.stop()
        ref.stop()
    assert ours.processed == ref.processed == 5 and not ours.errors
    assert ours.stats() == {"route": "TrainingRoute", "processed": 5,
                            "errors": 0}
    for a, b in zip(to_numpy(net.params_list), _np(jnet.params_list)):
        for k in b:
            np.testing.assert_allclose(a[k], b[k], rtol=TOL, atol=TOL)


def test_serving_route_matches_jax_output():
    jnet = _jax_net(n_out=2, seed=0)
    net = _port(jnet)
    x = np.random.default_rng(1).normal(size=(3, 4)).astype(np.float32)
    route = ServingRoute(net).start()
    try:
        route.send("req-1", x)
        rid, out = route.receive()
    finally:
        route.stop()
    assert rid == "req-1" and out.shape == (3, 2)
    np.testing.assert_allclose(out, np.asarray(jnet.output(x)), rtol=TOL,
                               atol=TOL)


def test_route_handler_errors_are_kept_and_counted():
    def handler(msg):
        if msg == "poison":
            raise ValueError("bad message")

    src = queue.Queue()
    route = Route(src, handler).start()
    try:
        for m in ("ok", "poison", "ok"):
            src.put(m)
        route.drain(timeout=10)
        assert route.processed == 2
        assert route.errors == ["ValueError: bad message"]
        assert route.stats()["errors"] == 1
    finally:
        route.stop()


def test_training_route_through_broker_survives_drop(broker):
    jnet = _jax_net()
    net = _port(jnet)
    batches = _route_batches(6)
    prod = BrokerProducer(broker.address)
    route = BrokerTrainingRoute(net, broker.address, "train").start()
    try:
        for x, y in batches[:3]:
            prod.publish("train", {"x": x, "y": y})
        assert _wait(lambda: route.processed >= 3)
        broker.drop_connections()
        for x, y in batches[3:]:
            prod.publish("train", {"x": x, "y": y})
        assert _wait(lambda: route.processed >= 6)
        assert route.processed == 6 and route.errors == []
        assert route.source.reconnects >= 1
    finally:
        route.stop()
        prod.close()
    # every batch reached fit, in order, once: the JAX fits on them agree
    for x, y in batches:
        jnet.fit(x, y)
    for a, b in zip(to_numpy(net.params_list), _np(jnet.params_list)):
        for k in b:
            np.testing.assert_allclose(a[k], b[k], rtol=TOL, atol=TOL)


def test_broker_training_route_error_isolated_per_message(broker):
    net = _port(_jax_net())
    prod = BrokerProducer(broker.address)
    route = BrokerTrainingRoute(net, broker.address, "train").start()
    try:
        prod.publish("train", {"x": np.zeros((2, 4), np.float32)})  # no y
        prod.publish("train", {"x": np.zeros((2, 4), np.float32),
                               "y": np.eye(3, dtype=np.float32)[[0, 1]]})
        assert _wait(lambda: route.processed >= 1 and route.errors)
        assert route.processed == 1 and len(route.errors) == 1
    finally:
        route.stop()
        prod.close()


# ------------------------------------------------------------------- cloud
def test_local_storage_roundtrip(tmp_path):
    store = cloud.LocalFileSystemProvider(str(tmp_path / "store"))
    src = tmp_path / "artifact.bin"
    src.write_bytes(b"\x01\x02\x03")
    store.upload(str(src), "models/run1/artifact.bin")
    assert store.list("models") == ["models/run1/artifact.bin"]
    assert store.list("nothing") == []
    dst = tmp_path / "restored.bin"
    store.download("models/run1/artifact.bin", str(dst))
    assert dst.read_bytes() == b"\x01\x02\x03"
    with pytest.raises(ValueError):
        store.upload(str(src), "../escape.bin")


def test_http_storage_roundtrip_over_socket(tmp_path):
    import urllib.error

    server, base_url = cloud.serve_storage(str(tmp_path / "remote"),
                                           token="tok")
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    try:
        store = cloud.HttpStorageProvider(base_url, token="tok")
        src = tmp_path / "model.zip"
        src.write_bytes(b"weights" * 100)
        assert store.upload(str(src), "runs/exp1/model.zip").endswith(
            "runs/exp1/model.zip")
        store.upload(str(src), "runs/exp2/model.zip")
        assert store.list("runs") == ["runs/exp1/model.zip",
                                      "runs/exp2/model.zip"]
        dst = tmp_path / "back.zip"
        store.download("runs/exp1/model.zip", str(dst))
        assert dst.read_bytes() == src.read_bytes()
        # the JAX client reads the port's server the same way
        jstore = jcloud.HttpStorageProvider(base_url, token="tok")
        assert jstore.list("runs") == store.list("runs")
        bad = cloud.HttpStorageProvider(base_url, token="wrong")
        with pytest.raises(urllib.error.HTTPError):
            bad.list("")
        with pytest.raises(urllib.error.HTTPError):
            store.download("../../etc/passwd", str(tmp_path / "x"))
        with pytest.raises(urllib.error.HTTPError):
            store.download("runs/nope.zip", str(tmp_path / "x"))
    finally:
        server.shutdown()
        server.server_close()


def test_http_storage_server_rejects_bad_uploads(tmp_path):
    import http.client

    server, base_url = cloud.serve_storage(str(tmp_path / "remote"))
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    try:
        host = base_url.split("//")[1]
        c = http.client.HTTPConnection(host, timeout=10)
        c.putrequest("PUT", "/a.bin", skip_accept_encoding=True)
        c.endheaders()
        assert c.getresponse().status == 411
        assert not (tmp_path / "remote" / "a.bin").exists()
        c2 = http.client.HTTPConnection(host, timeout=10)
        c2.putrequest("PUT", "/b.bin")
        c2.putheader("Content-Length", "1000000")
        c2.endheaders()
        c2.send(b"short")
        c2.close()  # disconnect mid-body
        assert _wait(lambda: not (tmp_path / "remote" / "b.bin").exists(),
                     timeout=5.0)
    finally:
        server.shutdown()
        server.server_close()


def test_s3_provider_gated_and_provisioner_equals_jax():
    with pytest.raises(RuntimeError, match="egress"):
        cloud.S3Provider("bucket")
    for kw in ({}, {"accelerator_type": "v5litepod-16", "num_slices": 2,
                    "preemptible": True, "zone": "europe-west4-b"}):
        assert cloud.TpuProvisioner(**kw).render("trainer") == \
            jcloud.TpuProvisioner(**kw).render("trainer")
    oracle = cloud.MembershipOracle()
    assert isinstance(oracle, cloud.TpuProvisioner)
    assert oracle.render("x") == jcloud.MembershipOracle().render("x")
    assert (oracle.lease_timeout_s, oracle.role) == (15.0, "worker")
