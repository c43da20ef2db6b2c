"""Elastic training and lease fencing of the port
(``deeplearning4j_tpu_torch/cloud``, ``parallel/elastic.py``,
``parallel/ps_worker.py``, ``keras_server/replica.py``,
``keras_server/autoscaler.py``) held against the JAX package's on the CPU.

The counterparts of ``tests/test_elastic.py``: the membership oracle on a
fake clock (each scenario run on the JAX oracle too, with the same
outcomes), epoch fencing of zombie pushes in process and over the wire,
the membership verbs over the frontend, the bounded half-open socket, the
refused connection, an error reply not retried, group resume at committed
+ 1, ``ps_worker`` main in the static and the elastic mode, restore only
from a committed sidecar, builder validation, and one small chaos run (a
worker SIGKILLed mid-fit on the shm transport: the shard handed off, every
group committed through its fin marker, no orphan segment, the loss near a
single-process fit's), under a limit of 60 s. Serving under membership,
the counterpart of ``tests/test_autoscale.py``'s zombie test: a fenced
replica is never dispatched to, swept, and replaced.
"""
import json
import queue
import socket
import threading
import time

import numpy as np
import pytest

from deeplearning4j_tpu import cloud as jcloud
from deeplearning4j_tpu.nn.conf.builders import NeuralNetConfiguration as JNNC
from deeplearning4j_tpu.nn.conf.layers import DenseLayer, OutputLayer
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JaxNet
from deeplearning4j_tpu_torch import cloud
from deeplearning4j_tpu_torch.convert import from_jax
from deeplearning4j_tpu_torch.datasets import DataSet, ListDataSetIterator
from deeplearning4j_tpu_torch.keras_server import (
    Autoscaler, InferenceServer, ReplicaSet,
)
from deeplearning4j_tpu_torch.parallel import ps_transport as pst
from deeplearning4j_tpu_torch.parallel import ps_worker
from deeplearning4j_tpu_torch.parallel.elastic import ElasticTrainer
from deeplearning4j_tpu_torch.observability import global_recorder
from deeplearning4j_tpu_torch.parallel.param_server import ParameterServer
from deeplearning4j_tpu_torch.streaming.broker import (
    BrokerProducer, LoopbackBroker, ReconnectingConsumer,
)


class FakeClock:
    def __init__(self, t: float = 0.0):
        self.t = t

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> None:
        self.t += dt


def _np(tree):
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_np(v) for v in tree]
    return np.asarray(tree)


def _jax_dense(seed=12345, n_in=4, n_out=3, updater="sgd"):
    conf = (JNNC.builder().seed(seed).learning_rate(0.1).updater(updater)
            .list()
            .layer(DenseLayer(n_in=n_in, n_out=8, activation="tanh"))
            .layer(OutputLayer(n_in=8, n_out=n_out, loss="mcxent",
                               activation="softmax"))
            .build())
    return JaxNet(conf).init()


def _port(jnet):
    return from_jax(jnet.conf.to_json(), _np(jnet.params_list), device="cpu")


# --------------------------------------------------------- membership oracle
def _scenario_epochs(Oracle):
    clock = FakeClock()
    oracle = Oracle(lease_timeout_s=15.0, clock=clock)
    a = oracle.register(0, worker="a")
    b = oracle.register(1, worker="b")
    return [(a.member, a.epoch), (b.member, b.epoch), oracle.joins,
            sorted(l.name for l in oracle.live_members())]


def _scenario_heartbeat(Oracle):
    clock = FakeClock()
    oracle = Oracle(lease_timeout_s=15.0, clock=clock)
    lease = oracle.register(0)
    out = []
    for dt in (10.0, 10.0, 16.0, -20.0):
        clock.advance(dt)
        out.append(oracle.heartbeat(lease.member, lease.epoch))
    return out + [oracle.lease_expiries, oracle.lease(lease.member).reason]


def _scenario_validate(Oracle):
    clock = FakeClock()
    oracle = Oracle(lease_timeout_s=10.0, clock=clock)
    lease = oracle.register(0)
    clock.advance(9.0)
    out = [oracle.validate(lease.member, lease.epoch)]
    clock.advance(2.0)  # validate at t=9 did not renew
    out += [oracle.validate(lease.member, lease.epoch), oracle.lease_expiries,
            oracle.validate(99, 99)]
    live = oracle.register(0)
    return out + [oracle.validate(live.member, live.epoch + 1)]


def _scenario_expire(Oracle):
    clock = FakeClock()
    oracle = Oracle(lease_timeout_s=5.0, clock=clock)
    a = oracle.register(0, worker="a")
    b = oracle.register(1, worker="b")
    clock.advance(4.0)
    oracle.heartbeat(b.member, b.epoch)
    clock.advance(2.0)
    return [[l.member for l in oracle.expire()], oracle.expire(),
            [l.member for l in oracle.live_members()], a.member]


def _scenario_leave(Oracle):
    oracle = Oracle(clock=FakeClock())
    lease = oracle.register(0)
    out = [oracle.deregister(lease.member, lease.epoch, reason="done"),
           oracle.lease_expiries, oracle.validate(lease.member, lease.epoch),
           oracle.deregister(lease.member, lease.epoch)]
    w = oracle.register(3, worker="w")
    out += [oracle.evict(w.member, reason="exit-rc137"),
            oracle.lease_expiries, oracle.lease(w.member).reason,
            oracle.validate(w.member, w.epoch), oracle.evict(w.member)]
    old = oracle.register(0, worker="shard0-gen0")
    oracle.evict(old.member)
    new = oracle.register(0, worker="shard0-gen1")
    return out + [new.epoch > old.epoch,
                  oracle.live_member_for_shard(0).member == new.member,
                  oracle.member_by_name("shard0-gen1").member == new.member,
                  oracle.member_by_name("nobody")]


@pytest.mark.parametrize("scenario", [_scenario_epochs, _scenario_heartbeat,
                                      _scenario_validate, _scenario_expire,
                                      _scenario_leave],
                         ids=lambda f: f.__name__[10:])
def test_oracle_matches_jax_on_a_fake_clock(scenario):
    ours = scenario(cloud.MembershipOracle)
    assert ours == scenario(jcloud.MembershipOracle)
    assert ours  # and says something


def test_oracle_expected_outcomes():
    assert _scenario_epochs(cloud.MembershipOracle) == [
        (1, 1), (2, 2), 2, ["a", "b"]]
    assert _scenario_heartbeat(cloud.MembershipOracle) == [
        True, True, False, False, 1, "lease-lapsed"]
    assert _scenario_validate(cloud.MembershipOracle) == [
        True, False, 1, False, False]
    oracle = cloud.MembershipOracle(clock=FakeClock())
    oracle.register(0)
    assert oracle.stats() == {"live": 1, "joins": 1, "lease_expiries": 0,
                              "evictions": 0, "leaves": 0}


# -------------------------------------------------------------- epoch fencing
def test_zombie_push_is_fenced_and_identityless_push_is_not():
    clock = FakeClock()
    oracle = cloud.MembershipOracle(lease_timeout_s=5.0, clock=clock)
    srv = ParameterServer([np.zeros(8, np.float32)], membership=oracle)
    lease = oracle.register(0)
    delta = np.ones(8, np.float32)
    res = srv.push_delta(delta, 0, member=lease.member, epoch=lease.epoch)
    assert res.accepted and not res.fenced and srv.version == 1
    clock.advance(6.0)  # the lease lapses: a zombie
    res = srv.push_delta(delta, 1, member=lease.member, epoch=lease.epoch)
    assert res.fenced and not res.accepted and srv.version == 1
    assert srv.fenced == 1 and srv.rejected == 1
    assert res.params.shape == (8,)
    repl = oracle.register(0)
    assert srv.push_delta(delta, 1, member=repl.member,
                          epoch=repl.epoch).accepted
    assert srv.push_delta(delta, 2).accepted  # no identity: static worker
    assert srv.version == 3


def test_membership_verbs_over_tcp_frontend():
    clock = FakeClock()
    oracle = cloud.MembershipOracle(lease_timeout_s=5.0, clock=clock)
    srv = ParameterServer([np.zeros(6, np.float32)], membership=oracle)
    frontend = pst.ParameterServerTcpFrontend(srv).start()
    t = pst.TcpTransport(("127.0.0.1", frontend.port))
    try:
        reg = t.register(2, worker="w0")
        assert reg["member"] == reg["epoch"] == 1 and reg["lease_s"] == 5.0
        assert not t.heartbeat()  # no identity bound yet
        t.bind_member(reg["member"], reg["epoch"])
        assert t.clone().member_identity == (1, 1)
        assert t.heartbeat()
        res = t.push(np.ones(6, np.float32), 0)
        assert res.accepted and not res.fenced
        assert t.deregister("done")
        res = t.push(np.ones(6, np.float32), 1)
        assert res.fenced and not res.accepted  # the fence crosses the wire
        assert not t.heartbeat()
        assert oracle.lease(1).reason == "done"
    finally:
        t.close()
        frontend.stop()


def test_jax_worker_registers_with_the_port_frontend():
    """The membership verbs are the JAX package's frames: a JAX transport
    registers, heartbeats and is fenced by the port's server."""
    from deeplearning4j_tpu.parallel.ps_transport import TcpTransport as JTcp
    oracle = cloud.MembershipOracle(lease_timeout_s=5.0, clock=FakeClock())
    srv = ParameterServer([np.zeros(4, np.float32)], membership=oracle)
    frontend = pst.ParameterServerTcpFrontend(srv).start()
    t = JTcp(("127.0.0.1", frontend.port))
    try:
        reg = t.register(0, worker="jax")
        t.bind_member(reg["member"], reg["epoch"])
        assert t.heartbeat()
        assert t.push(np.ones(4, np.float32), 0).accepted
        oracle.evict(reg["member"])
        assert t.push(np.ones(4, np.float32), 1).fenced
    finally:
        t.close()
        frontend.stop()


def test_membership_and_federation_verbs_need_their_planes():
    srv = ParameterServer([np.zeros(4, np.float32)])  # no membership
    frontend = pst.ParameterServerTcpFrontend(srv).start()
    t = pst.TcpTransport(("127.0.0.1", frontend.port))
    try:
        with pytest.raises(RuntimeError, match="membership"):
            t.register(0)
        for op in ("metrics_push", "trace_push", "dump_fleet"):
            with pytest.raises(RuntimeError, match="A9.4"):
                with t._lock:
                    t._rpc({"op": op})
    finally:
        t.close()
        frontend.stop()
    with pytest.raises(NotImplementedError, match="A9.4"):
        pst.ParameterServerTcpFrontend(srv, federation=object())


# ------------------------------------------------------- transport robustness
def test_half_open_socket_raises_transport_error_in_bounded_time():
    lsock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    lsock.bind(("127.0.0.1", 0))
    lsock.listen(4)
    accepted = []

    def _accept_and_hold():
        try:
            while True:
                conn, _ = lsock.accept()
                accepted.append(conn)  # held open, never answered
        except OSError:
            pass

    threading.Thread(target=_accept_and_hold, daemon=True).start()
    t = pst.TcpTransport(lsock.getsockname(), timeout=0.2,
                         connect_timeout=0.5, retries=2, backoff_s=0.05,
                         backoff_cap_s=0.1)
    t0 = time.monotonic()
    try:
        with pytest.raises(pst.TransportError):
            t.pull()
    finally:
        elapsed = time.monotonic() - t0
        t.close()
        lsock.close()
        for c in accepted:
            c.close()
    assert elapsed < 5.0
    assert t.stats()["retries"] == 2


def test_connection_refused_raises_transport_error():
    probe = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    probe.bind(("127.0.0.1", 0))
    addr = probe.getsockname()
    probe.close()
    t = pst.TcpTransport(addr, timeout=0.2, connect_timeout=0.3, retries=1,
                         backoff_s=0.01)
    with pytest.raises(pst.TransportError):
        t.pull()
    t.close()


def test_server_error_reply_is_not_retried():
    srv = ParameterServer([np.zeros(4, np.float32)])
    frontend = pst.ParameterServerTcpFrontend(srv).start()
    t = pst.TcpTransport(("127.0.0.1", frontend.port), retries=3,
                         backoff_s=5.0)  # a retry would cost 5 s
    t0 = time.monotonic()
    try:
        with pytest.raises(RuntimeError, match="unknown PS op"):
            with t._lock:
                t._rpc({"op": "definitely-not-an-op"})
    finally:
        elapsed = time.monotonic() - t0
        t.close()
        frontend.stop()
    assert elapsed < 2.0


# ------------------------------------------------------ broker shard handoff
def _publish(broker, topic, n):
    producer = BrokerProducer(broker.address)
    try:
        for i in range(n):
            producer.publish(topic, {"x": np.full((2,), i, np.float32)},
                             meta={"idx": i})
    finally:
        producer.close()


def test_group_resume_at_committed_plus_one():
    broker = LoopbackBroker().start()
    try:
        _publish(broker, "shard-0", 8)
        assert broker.committed("shard-0", "g") == -1
        a = ReconnectingConsumer(broker.address, "shard-0", group="g")
        assert a.commit_delivered() is None  # nothing delivered yet
        seen_a = []
        for _ in range(6):
            meta, _ = a.get(timeout=1.0)
            seen_a.append(meta["idx"])
            if meta["idx"] == 3:
                assert a.commit_delivered() == 3
        a.close()  # "crashes" without committing 4 and 5
        assert broker.committed("shard-0", "g") == 3
        b = ReconnectingConsumer(broker.address, "shard-0", group="g")
        seen_b = []
        while True:
            try:
                meta, _ = b.get(timeout=0.3)
            except queue.Empty:
                break
            seen_b.append(meta["idx"])
        assert seen_b == [4, 5, 6, 7]
        assert b.commit_delivered() == 7
        b.close()
        assert set(seen_a) & set(seen_b) == {4, 5}
        assert set(seen_a) | set(seen_b) == set(range(8))
    finally:
        broker.stop()


# ----------------------------------------------------------- worker process
def test_ps_worker_main_static_mode_cleans_npz(tmp_path, capsys):
    net = _port(_jax_dense())
    srv = ParameterServer(net.params_list)
    frontend = pst.ParameterServerTcpFrontend(srv).start()
    conf_path = tmp_path / "conf.json"
    conf_path.write_text(net.conf.to_json())
    rng = np.random.default_rng(0)
    x = rng.normal(size=(4, 8, 4)).astype(np.float32)
    y = np.tile(np.eye(3, dtype=np.float32)[[0, 1, 2, 0, 1, 2, 0, 1]],
                (4, 1, 1))
    data_path = tmp_path / "worker0.npz"
    np.savez(data_path, x=x, y=y)
    try:
        rc = ps_worker.main([
            "--addr", f"127.0.0.1:{frontend.port}",
            "--conf", str(conf_path), "--data", str(data_path),
            "--worker-id", "7", "--push-frequency", "2", "--device", "cpu"])
    finally:
        frontend.stop()
    assert rc == 0
    assert not data_path.exists()
    assert srv.pushes == 2
    stats = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert stats["steps"] == 4 and stats["exit_reason"] == "done"
    assert stats["worker_id"] == 7 and stats["device"] == "cpu"
    assert stats["transport"]["transport"] == "tcp"
    assert "sm_xent" not in stats["launches"]  # wrapper names
    assert "softmax_cross_entropy" in stats["launches"]


def test_ps_worker_main_elastic_mode(tmp_path, capsys):
    """Register, consume the shard topic to its fin marker, commit it,
    deregister: the shard is complete and the lease ended as done."""
    net = _port(_jax_dense())
    oracle = cloud.MembershipOracle(lease_timeout_s=10.0)
    srv = ParameterServer(net.params_list, membership=oracle)
    frontend = pst.ParameterServerTcpFrontend(srv).start()
    broker = LoopbackBroker().start()
    conf_path = tmp_path / "conf.json"
    conf_path.write_text(net.conf.to_json())
    prod = BrokerProducer(broker.address)
    rng = np.random.default_rng(1)
    for _ in range(5):
        prod.publish("shard-0", {
            "x": rng.normal(size=(8, 4)).astype(np.float32),
            "y": np.eye(3, dtype=np.float32)[rng.integers(0, 3, 8)]})
    fin = prod.publish("shard-0", {}, meta={"fin": True})
    prod.close()
    try:
        rc = ps_worker.main([
            "--addr", f"127.0.0.1:{frontend.port}", "--conf", str(conf_path),
            "--broker", f"127.0.0.1:{broker.port}", "--topic", "shard-0",
            "--group", "shard-0", "--shard", "0", "--worker-name", "w0",
            "--push-frequency", "2", "--device", "cpu"])
    finally:
        frontend.stop()
        broker.stop()
    assert rc == 0
    stats = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert stats["steps"] == 5 and stats["fin"] is True
    assert (stats["member"], stats["shard"]) == (1, 0)
    assert srv.pushes == 3  # windows of 2, 2 and the flush of 1
    assert broker.committed("shard-0", "shard-0") == fin
    assert oracle.lease(1).reason == "done"


def test_ps_worker_main_rejects_ambiguous_modes():
    with pytest.raises(SystemExit):
        ps_worker.main(["--addr", "127.0.0.1:1", "--conf", "c.json"])
    with pytest.raises(SystemExit):
        ps_worker.main(["--addr", "127.0.0.1:1", "--conf", "c.json",
                        "--data", "d.npz", "--broker", "127.0.0.1:2",
                        "--topic", "t", "--group", "g"])
    with pytest.raises(SystemExit):
        ps_worker.main(["--addr", "127.0.0.1:1", "--conf", "c.json",
                        "--broker", "127.0.0.1:2"])


# ------------------------------------------------------------ restore-on-join
def test_maybe_restore_only_from_committed_sidecar(tmp_path):
    import os

    from deeplearning4j_tpu_torch.utils.sharded_checkpoint import (
        save_sharded)
    src = _port(_jax_dense(seed=7))
    for _ in range(3):
        src.fit(np.ones((4, 4), np.float32),
                np.eye(3, dtype=np.float32)[[0, 1, 2, 0]])
    ckpt = tmp_path / "ckpt"
    save_sharded(str(ckpt), src)
    fresh = _port(_jax_dense(seed=99))
    trainer = ElasticTrainer(fresh, checkpoint_dir=str(ckpt))
    trainer._maybe_restore()
    assert trainer.restored_from_checkpoint
    np.testing.assert_array_equal(fresh.params_list[0]["W"].detach().numpy(),
                                  src.params_list[0]["W"].detach().numpy())
    assert fresh.iteration == 3
    os.unlink(ckpt / "meta.json")  # a torn save: ignored
    t2 = ElasticTrainer(_port(_jax_dense(seed=99)),
                        checkpoint_dir=str(ckpt))
    t2._maybe_restore()
    assert not t2.restored_from_checkpoint


def test_builder_validates_and_builds():
    net = _port(_jax_dense())
    with pytest.raises(ValueError, match="compression"):
        ElasticTrainer(net, compression="zstd")
    with pytest.raises(ValueError, match="transport"):
        ElasticTrainer(net, transport="inproc")
    t = (ElasticTrainer.builder(net).workers(3).push_frequency(2)
         .staleness(4).compression("bf16").transport("shm")
         .server_optimizer("momentum", 0.5).lease_timeout(7.5)
         .respawn(False, 2).checkpoint("/x", 3.0).worker_delays(0.1)
         .fit_timeout(30.0).build())
    assert (t.workers, t.push_frequency, t.staleness, t.compression,
            t.transport, t.server_optimizer, t.server_lr, t.lease_timeout_s,
            t.respawn, t.max_handoffs_per_shard, t.checkpoint_dir,
            t.checkpoint_interval_s, t.worker_delays, t.fit_timeout_s) == \
        (3, 2, 4, "bf16", "shm", "momentum", 0.5, 7.5, False, 2, "/x", 3.0,
         [0.1], 30.0)
    assert not t.chaos_kill(0)  # nothing running


# ------------------------------------------------------------------- chaos
def test_chaos_sigkill_hands_the_shard_off(tmp_path, monkeypatch):
    """SIGKILL one of two worker processes mid-fit (shm transport, CPU):
    the shard hands off, the replacement resumes at the committed offset,
    every shard's group ends committed through its fin marker, no orphan
    segment is left, and the loss lands near a single-process fit's on
    the same batches. The kill waits for the oracle's ``worker_join`` event
    of shard 0's first worker: under load the other worker can push twice
    before shard 0's process has even registered, and a kill then would
    hand off a worker that never joined."""
    rng = np.random.default_rng(0)
    means = rng.normal(0.0, 1.0, (3, 4)).astype(np.float32)
    data = []
    for _ in range(24):
        lab = rng.integers(0, 3, 16)
        x = (means[lab] + rng.normal(0, 0.5, (16, 4))).astype(np.float32)
        noisy = np.where(rng.random(16) < 0.25, rng.integers(0, 3, 16), lab)
        data.append((x, np.eye(3, dtype=np.float32)[noisy]))
    gx = np.concatenate([x for x, _ in data])
    gy = np.concatenate([y for _, y in data])
    jnet = _jax_dense()
    single = _port(jnet)
    for x, y in data:
        single.fit(x, y)
    sync_loss = float(single.score(gx, gy))

    pst.reap_orphans()  # what an earlier killed run left
    net = _port(jnet)
    trainer = (ElasticTrainer.builder(net).workers(2).push_frequency(2)
               .transport("shm").lease_timeout(10.0).respawn(True)
               .worker_delays(0.1, 0.1).checkpoint(str(tmp_path / "ck"), 1.0)
               .fit_timeout(50.0).build())
    killed = threading.Event()
    joined = threading.Event()
    rec = global_recorder()
    record = rec.record

    def _record(kind, **fields):
        record(kind, **fields)
        if kind == "worker_join" and fields.get("worker") == "shard0-gen0":
            joined.set()

    monkeypatch.setattr(rec, "record", _record)

    def _assassin():
        deadline = time.monotonic() + 45.0
        if not joined.wait(timeout=45.0):
            return
        while time.monotonic() < deadline:
            if (trainer.server is not None and trainer._shards
                    and trainer._shards[0].proc is not None
                    and trainer.server.version >= 2):
                if trainer.chaos_kill(0):
                    killed.set()
                return
            time.sleep(0.02)

    t = threading.Thread(target=_assassin, daemon=True)
    t0 = time.monotonic()
    t.start()
    trainer.fit(ListDataSetIterator([DataSet(x, y) for x, y in data]))
    t.join(timeout=5.0)
    assert time.monotonic() - t0 < 60.0
    assert killed.is_set(), "the chaos kill never fired"
    assert trainer.handoffs >= 1 and trainer.published == 24
    for sc in trainer.shard_commits:
        assert sc["committed"] >= sc["fin"] >= 0, sc
    st = trainer.stats
    assert st["joins"] == 2 + trainer.handoffs
    assert st["fenced"] == 0 and st["checkpoints"] >= 1
    assert pst.orphan_segments() == []
    assert all(s["transport"]["shm_active"] for s in trainer.worker_stats)
    loss = float(net.score(gx, gy))
    assert abs(loss / sync_loss - 1.0) < 0.15, (loss, sync_loss)
    assert loss < 1.0986
    # the final checkpoint is committed and holds the trained params
    from deeplearning4j_tpu_torch.utils.sharded_checkpoint import (
        restore_sharded)
    back = restore_sharded(str(tmp_path / "ck"), device="cpu")
    np.testing.assert_array_equal(back.params_list[0]["W"].detach().numpy(),
                                  net.params_list[0]["W"].detach().numpy())


# ----------------------------------------------------- serving under leases
N_IN, N_OUT = 12, 3


def _x(n=2, seed=0):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((n, N_IN)).astype(np.float32)


def test_zombie_lease_fencing_and_backfill():
    jnet = _jax_dense(seed=7, n_in=N_IN, n_out=N_OUT, updater="adam")
    oracle = cloud.MembershipOracle(role="replica", lease_timeout_s=60.0)
    rs = ReplicaSet(2, device="cpu", max_batch=8, max_latency_s=0.001,
                    max_queue=32, membership=oracle)
    try:
        rs.register("mlp", _port(jnet), version="v1")
        assert [r.lease.name for r in rs.replicas] == ["replica-0",
                                                       "replica-1"]
        zombie = [r for r in rs.replicas if r.index == 1][0]
        assert oracle.evict(zombie.lease.member, reason="chaos") is True
        assert [r.index for r in rs.fenced_replicas()] == [1]
        # the router never dispatches to a fenced replica
        for i in range(6):
            out = rs.submit("mlp", _x(1, seed=i)).result(timeout=30)
            np.testing.assert_allclose(
                np.asarray(out["predictions"]),
                np.asarray(jnet.output(_x(1, seed=i))), rtol=1e-6,
                atol=1e-6)
        routed = {s["replica"]: s["routed"] for s in rs.stats()["replicas"]}
        assert routed[0] == 6 and routed[1] == 0
        assert [s["replica"] for s in rs.stats()["replicas"]
                if s["fenced"]] == [1]
        # the sweep removes the zombie and fills the fleet back outside the
        # cooldown window
        asc = Autoscaler(rs, min_replicas=2, max_replicas=4,
                         cooldown_s=300.0)
        asc.tick()
        assert rs.n_replicas == 2 and rs.fenced_replicas() == []
        assert sorted(r.index for r in rs.replicas) == [0, 2]
        fresh = [r for r in rs.replicas if r.index == 2][0]
        assert fresh.registry.active("mlp").version == "v1"
        assert oracle.validate(fresh.lease.member, fresh.lease.epoch)
        assert rs.scale_events[("in", "lease-fenced")] == 1
        assert rs.scale_events[("out", "replace-fenced")] == 1
        rs.heartbeat()  # a heartbeat cannot revive the evicted lease
        assert not oracle.validate(zombie.lease.member, zombie.lease.epoch)
        # removal deregisters
        rs.remove_replica(2, reason="t")
        assert oracle.lease(fresh.lease.member).reason == "t"
    finally:
        rs.close()


def test_autoscaling_server_fences_its_replicas():
    srv = InferenceServer(device="cpu", replicas=2, autoscale=True,
                          min_replicas=1, max_replicas=3)
    try:
        assert srv.membership is not None
        assert srv.membership.role == "replica"
        leases = [r.lease for r in srv.replica_set.replicas]
        assert all(srv.membership.validate(l.member, l.epoch)
                   for l in leases)
        assert InferenceServer(device="cpu", replicas=2).membership is None
    finally:
        srv.stop()
