"""The metric series of the training, parallel and data paths (A9.1 part 2)
and their flight-recorder events, on the CPU.

Each run takes the series' values before and after and holds the
difference against what the run did and against the module's own
``stats()``: the async parameter server in process (pushes, pulls,
staleness and weights, version, worker steps), the tcp and shm transports
(wire and ring bytes, segments, a reaped orphan), the broker and the wire
(messages, a reconnect, copied bytes), a one-worker ``ElasticTrainer`` fit
(joins, live workers, no handoff), the partition engine (specs and
per-device bytes), the ring and Ulysses gauges, the prefetcher, the host
runtime's decode bytes, and the fit loop's phase histogram. The JAX
package's own assertions of ``tests/test_elastic.py`` and
``tests/test_streaming_broker.py`` on these series run on the port.
"""
import queue

import numpy as np
import pytest
import torch

from _torch_port import run_on_port
from deeplearning4j_tpu_torch.datasets import DataSet, ListDataSetIterator
from deeplearning4j_tpu_torch.datasets.prefetch import DevicePrefetcher
from deeplearning4j_tpu_torch.nn.conf import NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.conf.layers import DenseLayer, OutputLayer
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.observability import (
    global_recorder, global_registry, names as _n)
from deeplearning4j_tpu_torch.parallel import partition
from deeplearning4j_tpu_torch.parallel import ps_transport as pst
from deeplearning4j_tpu_torch.parallel.param_server import (
    ParameterServer, ParameterServerParallelWrapper)


def _value(name: str, **labels) -> float:
    """The sum of a family's series whose labels include ``labels``
    (a histogram's count)."""
    fam = global_registry().snapshot().get(name, {"series": []})
    total = 0.0
    for s in fam["series"]:
        if all(s["labels"].get(k) == v for k, v in labels.items()):
            total += s.get("value", s.get("count", 0))
    return total


def _values(*keys) -> dict:
    return {k: _value(k[0], **dict(k[1:])) for k in keys}


def _delta(before: dict) -> dict:
    after = _values(*before)
    return {k[0] + "".join(f"{{{a}={b}}}" for a, b in k[1:]): after[k] - v
            for k, v in before.items()}


def _events_since(n: int, kind: str) -> list:
    return [e for e in global_recorder().snapshot()[n:] if e["kind"] == kind]


def _net(seed=3):
    conf = (NeuralNetConfiguration.builder().seed(seed).learning_rate(0.1)
            .list()
            .layer(DenseLayer.conf(n_in=4, n_out=8, activation="tanh"))
            .layer(OutputLayer.conf(n_in=8, n_out=3, loss="mcxent",
                                    activation="softmax"))
            .build())
    return MultiLayerNetwork(conf, device="cpu").init()


def _batches(n: int, seed=0) -> list:
    rng = np.random.default_rng(seed)
    return [DataSet(rng.normal(size=(8, 4)).astype(np.float32),
                    np.eye(3, dtype=np.float32)[rng.integers(0, 3, 8)])
            for _ in range(n)]


# --------------------------------------------------------- the JAX contracts
JAX_CONTRACTS = [
    ("test_elastic", "test_zombie_push_is_fenced_and_counted"),
    ("test_elastic", "test_elastic_metric_names_registered"),
    ("test_streaming_broker",
     "test_route_handler_errors_are_counted_and_recorded")]


@pytest.mark.parametrize("module,name", JAX_CONTRACTS)
def test_jax_series_contract_holds_on_port(module, name, monkeypatch):
    run_on_port(module, name, monkeypatch, [
        "deeplearning4j_tpu.cloud", "deeplearning4j_tpu.parallel.param_server",
        "deeplearning4j_tpu.streaming",
        "deeplearning4j_tpu.observability.metrics",
        "deeplearning4j_tpu.observability.flight_recorder"])


# ----------------------------------------------------------- parameter server
PS = (_n.PS_PUSHES_TOTAL, ("outcome", "applied"))
PS_REJ = (_n.PS_PUSHES_TOTAL, ("outcome", "rejected"))


def test_inproc_ps_series_equal_the_run_and_stats():
    n, workers, freq = 12, 2, 2
    before = _values(PS, PS_REJ, (_n.PS_PULLS_TOTAL,), (_n.PS_STALENESS,),
                     (_n.PS_PUSH_WEIGHT,), (_n.PS_WORKER_STEPS_TOTAL,))
    wrapper = (ParameterServerParallelWrapper.builder(_net())
               .workers(workers).push_frequency(freq).build())
    wrapper.fit(ListDataSetIterator(_batches(n)))
    d = _delta(before)
    srv = wrapper.server.stats()
    steps = sum(w["steps"] for w in wrapper.worker_stats)
    assert steps == n
    assert d["dl4j_ps_worker_steps_total"] == steps
    assert d["dl4j_ps_pushes_total{outcome=applied}"] == srv["pushes"] \
        == srv["version"]
    assert d["dl4j_ps_pushes_total{outcome=rejected}"] == srv["rejected"]
    assert d["dl4j_ps_pulls_total"] == srv["pulls"]
    # every push observes its staleness; applied ones their weight
    assert d["dl4j_ps_staleness"] == sum(srv["staleness"].values())
    assert d["dl4j_ps_push_weight"] == srv["pushes"]
    assert _value(_n.PS_VERSION) == srv["version"]
    for w, stats in enumerate(wrapper.worker_stats):
        assert _value(_n.PS_WORKER_STEPS_TOTAL, worker=str(w)) >= \
            stats["steps"]


def test_rejected_push_records_event():
    srv = ParameterServer([np.zeros(4, np.float32)], staleness_cap=0)
    mark = len(global_recorder().snapshot())
    before = _values(PS_REJ)
    srv.push_delta(np.ones(4, np.float32), 0)
    res = srv.push_delta(np.ones(4, np.float32), 0)  # one behind, cap 0
    assert not res.accepted
    assert _delta(before)["dl4j_ps_pushes_total{outcome=rejected}"] == 1
    ev = _events_since(mark, "ps_push_rejected")
    assert ev and ev[-1]["staleness"] == 1 and ev[-1]["cap"] == 0


def test_tcp_transport_wire_bytes_equal_its_counts():
    srv = ParameterServer([np.zeros(16, np.float32)])
    mark = len(global_recorder().snapshot())
    frontend = pst.ParameterServerTcpFrontend(srv).start()
    pusher = pst.TcpTransport(("127.0.0.1", frontend.port), codec="bf16")
    puller = pst.TcpTransport(("127.0.0.1", frontend.port))
    push_k = (_n.PS_WIRE_BYTES_TOTAL, ("op", "push"), ("codec", "bf16"))
    pull_k = (_n.PS_WIRE_BYTES_TOTAL, ("op", "pull"))
    before = _values(push_k, pull_k)
    try:
        for v in range(3):
            pusher.push(np.full(16, 0.5, np.float32), v)
        for _ in range(2):
            puller.pull()
        d = _delta(before)
        assert d["dl4j_ps_wire_bytes_total{op=push}{codec=bf16}"] == \
            pusher.stats()["push_bytes"] == pusher.stats()["bytes_sent"] \
            > 3 * 16 * 2
        assert d["dl4j_ps_wire_bytes_total{op=pull}"] == \
            puller.stats()["bytes_received"] == 2 * 16 * 4
    finally:
        pusher.close()
        puller.close()
        frontend.stop()
    assert _events_since(mark, "ps_server_start")[-1]["port"] == \
        frontend.port
    assert _events_since(mark, "ps_server_stop")[-1]["pushes"] == 3


def test_shm_series_equal_the_rings_and_segments(tmp_path):
    srv = ParameterServer([np.zeros(32, np.float32)])
    frontend = pst.ParameterServerTcpFrontend(srv).start()
    shm = pst.ShmTransport(("127.0.0.1", frontend.port))
    keys = [(_n.SHM_BYTES_TOTAL, ("direction", d))
            for d in ("push", "pull", "shard")]
    before = _values(*keys, (_n.SHM_REAPED_TOTAL,))
    mark = len(global_recorder().snapshot())
    try:
        for _ in range(3):
            shm.push(np.ones(32, np.float32), shm.pull()[0])
        assert shm.stats()["shm_active"]
        # the frontend's pair and the gauge agree with this process's count
        assert _value(_n.SHM_SEGMENTS) == pst.segment_stats()["owned"] >= 2
        name = pst.write_shard_segment({"x": np.ones(10, np.float32)})
        pst.release_segment_by_name(name)
        # an orphan of a dead creator, reaped from a directory of its own
        dead = 2 ** 22 + 12345
        while pst._pid_alive(dead):
            dead += 1
        (tmp_path / f"dl4j_pt_shm_{dead}_0_push").write_bytes(b"x")
        assert pst.reap_orphans(str(tmp_path)) == 1
        d = _delta(before)
        assert d["dl4j_shm_bytes_total{direction=push}"] == \
            shm.stats()["shm_push_bytes"] == 3 * 32 * 4
        # the server writes the pull ring at each pull and each push reply
        assert d["dl4j_shm_bytes_total{direction=pull}"] == 6 * 32 * 4
        assert d["dl4j_shm_bytes_total{direction=shard}"] > 40
        assert d["dl4j_shm_reaped_total"] == 1
        assert pst.segment_stats()["reaped"] == _value(_n.SHM_REAPED_TOTAL)
        assert _events_since(mark, "shm_reaped")[-1]["count"] == 1
        assert _events_since(mark, "ps_shm_open")
    finally:
        shm.close()
        frontend.stop()
    assert _value(_n.SHM_SEGMENTS) == pst.segment_stats()["owned"]


# ---------------------------------------------------------- broker and wire
def test_broker_and_wire_series_equal_the_run():
    from deeplearning4j_tpu_torch.streaming import wire
    from deeplearning4j_tpu_torch.streaming.broker import (
        BrokerProducer, LoopbackBroker, ReconnectingConsumer)

    keys = [(_n.BROKER_MESSAGES_TOTAL, ("op", "publish")),
            (_n.BROKER_MESSAGES_TOTAL, ("op", "deliver")),
            (_n.BROKER_RECONNECTS_TOTAL,),
            (_n.WIRE_COPY_BYTES_TOTAL, ("site", "decode"))]
    before = _values(*keys)
    copy_before = wire.stats()["copy_bytes"].get("decode", 0)
    mark = len(global_recorder().snapshot())
    broker = LoopbackBroker().start()
    prod = BrokerProducer(broker.address)
    cons = ReconnectingConsumer(broker.address, "t", "g")
    try:
        for i in range(4):
            prod.publish("t", {"x": np.full(3, i, np.float32)})
        got = [cons.get(timeout=5.0)]
        cons.task_done()
        broker.drop_connections()
        for _ in range(3):
            got.append(cons.get(timeout=5.0))
            cons.task_done()
        meta, buf = wire.encode_array(np.arange(6, dtype=np.float32))
        wire.decode_array(meta, buf, copy=True)
        d = _delta(before)
        st = broker.stats()
        assert d["dl4j_broker_messages_total{op=publish}"] == \
            st["publish"] == 4
        assert d["dl4j_broker_messages_total{op=deliver}"] == st["deliver"]
        assert d["dl4j_broker_reconnects_total"] == cons.reconnects == 1
        assert d["dl4j_wire_copy_bytes_total{site=decode}"] == 24 == \
            wire.stats()["copy_bytes"]["decode"] - copy_before
        assert _events_since(mark, "broker_drop_connections")
        assert _events_since(mark, "broker_reconnect")[-1]["n"] == 1
    finally:
        cons.close()
        prod.close()
        broker.stop()


# ---------------------------------------------------------------- elastic
def test_elastic_fit_series_equal_its_stats():
    from deeplearning4j_tpu_torch.parallel.elastic import ElasticTrainer

    keys = [(_n.ELASTIC_JOINS_TOTAL,), (_n.ELASTIC_HANDOFFS_TOTAL,),
            (_n.ELASTIC_FENCED_PUSHES_TOTAL,),
            (_n.ELASTIC_LEASE_EXPIRIES_TOTAL,)]
    before = _values(*keys)
    mark = len(global_recorder().snapshot())
    trainer = (ElasticTrainer.builder(_net()).workers(1).push_frequency(2)
               .lease_timeout(30.0).fit_timeout(50.0).build())
    trainer.fit(ListDataSetIterator(_batches(4)))
    d = _delta(before)
    st = trainer.stats
    assert d["dl4j_elastic_joins_total"] == st["joins"] == 1
    assert d["dl4j_elastic_handoffs_total"] == st["handoffs"] == 0
    assert d["dl4j_elastic_fenced_pushes_total"] == st["fenced"] == 0
    assert d["dl4j_elastic_lease_expiries_total"] == st["lease_expiries"]
    assert _value(_n.ELASTIC_LIVE_WORKERS) == \
        trainer.oracle.stats()["live"] == 0
    joins = _events_since(mark, "worker_join")
    assert [e["worker"] for e in joins] == ["shard0-gen0"]
    assert _events_since(mark, "worker_leave")


# ---------------------------------------------------- partition, attention
def test_partition_series_are_its_stats():
    from deeplearning4j_tpu_torch.parallel.mesh import build_mesh

    mesh = build_mesh({"data": 1})
    tree = {"W": torch.zeros(8, 4), "b": torch.zeros(4)}
    specs = {"W": partition.PartitionSpec("data"),
             "b": partition.PartitionSpec()}
    spec_k = (_n.SHARDING_SPEC_TOTAL, ("rule_set", "series_probe"))
    before = _values(spec_k)
    partition.record_specs("series_probe", specs)
    b = partition.record_param_bytes("series_probe", tree, specs, mesh)
    assert b == 8 * 4 * 4 + 4 * 4
    assert _delta(before)[
        "dl4j_sharding_spec_total{rule_set=series_probe}"] == 2
    st = partition.stats()
    assert st["sharded_param_bytes_per_device"]["series_probe"] == b == \
        _value(_n.SHARDED_PARAM_BYTES_PER_DEVICE, rule_set="series_probe")
    assert st["sharding_spec_total"][("series_probe", "P(data)")] == \
        _value(_n.SHARDING_SPEC_TOTAL, rule_set="series_probe",
               spec="P(data)")


@pytest.mark.parametrize("mode", ["ring", "ulysses"])
def test_attention_sets_its_per_step_gauge(mode):
    from deeplearning4j_tpu_torch.parallel import ring_attention as ra
    from deeplearning4j_tpu_torch.parallel.mesh import build_mesh

    mesh = build_mesh({"sp": 1})
    q, k, v = (torch.randn(2, 8, 2, 4) for _ in range(3))
    if mode == "ring":
        ra.ring_attention_sharded(q, k, v, mesh, "sp")
        want, op = 2 * q.numel() * 4, ("ppermute_kv", "ring_attention")
    else:
        ra.ulysses_attention_sharded(q, k, v, mesh, "sp")
        want, op = 4 * q.numel() * 4, ("all_to_all", "ulysses_attention")
    assert _value(_n.COLLECTIVE_BYTES_PER_STEP, op=op[0], site=op[1]) == want


# ------------------------------------------------------- the data paths
def test_prefetcher_series_equal_its_counters():
    path = "series_probe"
    items = [np.ones((4, 5), np.float32) for _ in range(6)]
    pf = DevicePrefetcher(iter(items), lambda a: torch.from_numpy(a),
                          depth=2, path=path)
    assert len(list(pf)) == 6
    assert _value(_n.PREFETCH_BYTES_TOTAL, path=path) == pf.bytes == 6 * 80
    assert _value(_n.PREFETCH_STAGING_SECONDS_TOTAL, path=path) == \
        pytest.approx(pf.staging_s, rel=1e-9)
    assert _value(_n.PREFETCH_WAIT_SECONDS_TOTAL, path=path) == \
        pytest.approx(pf.wait_s, rel=1e-9)
    ratio = _value(_n.PREFETCH_OVERLAP_RATIO, path=path)
    assert 0.0 <= ratio <= 1.0
    assert _value(_n.PREFETCH_DEPTH, path=path) <= 2


def test_ingest_decode_bytes_by_path():
    from deeplearning4j_tpu_torch import nativert

    key = (_n.INGEST_DECODE_BYTES_TOTAL, ("path", "python"))
    before = _values(key)
    nativert.decode_records_py(np.arange(5, dtype=np.float32).tobytes())
    nativert.decode_records_py(bytes(6), codec="u8")
    assert _delta(before)[
        "dl4j_ingest_decode_bytes_total{path=python}"] == 20 + 6


def test_fit_phases_and_route_errors():
    from deeplearning4j_tpu_torch.streaming import Route

    keys = [(_n.FIT_PHASE_SECONDS, ("phase", p))
            for p in ("staging", "dispatch", "listeners")]
    before = _values(*keys)
    net = _net()
    net.fit_iterator(ListDataSetIterator(_batches(5)), ksteps=2)
    d = _delta(before)
    # groups of 2, 2 and a single step: 3 dispatches, 3 listener blocks,
    # the prefetcher's 3 waits
    assert d["dl4j_fit_phase_seconds{phase=dispatch}"] == 3
    assert d["dl4j_fit_phase_seconds{phase=listeners}"] == 3
    assert d["dl4j_fit_phase_seconds{phase=staging}"] >= 2

    class Poisoned(Route):
        pass

    src = queue.Queue()
    route = Poisoned(src, lambda m: 1 / 0).start()
    try:
        src.put("m")
        route.drain(timeout=10)
    finally:
        route.stop()
    assert route.stats()["errors"] == 1 == \
        _value(_n.ROUTE_ERRORS_TOTAL, route="Poisoned")


def test_no_series_or_event_holds_a_tensor():
    """Every value the registry and the recorder hold is a host number or
    string (a CUDA tensor there would make a scrape or a dump wait on the
    card)."""
    net = _net()
    from deeplearning4j_tpu_torch.observability import HealthMonitor
    HealthMonitor(cadence=2).attach(net)
    net.fit_iterator(ListDataSetIterator(_batches(4)), ksteps=2)
    for e in global_recorder().snapshot():
        assert not any(isinstance(v, torch.Tensor) for v in e.values())
    snap = global_registry().snapshot()
    for fam in snap.values():
        for s in fam["series"]:
            for v in s.values():
                assert not isinstance(v, torch.Tensor)
