"""The async parameter server of the port
(``deeplearning4j_tpu_torch/parallel/param_server.py``, ``ps_transport.py``,
``ps_worker.py``) held against the JAX package's on the CPU.

- The server: the same deltas pushed at the same base versions give the
  same vector as the JAX ``ParameterServer`` (SGD and momentum, atol
  1e-7), with the same staleness weights, rejections and fences.
- ``flatten_tree`` of params carried across by ``convert.from_jax`` equals
  the JAX vector bitwise (a dense net, a 2-layer transformer LM, a graph).
- The counterparts of ``tests/test_param_server.py``: one worker against
  the port's ``fit`` and against the JAX one-worker wrapper (rtol 2e-4,
  atol 2e-5; the dense net and the transformer LM), the partial-window
  flush, multi-worker step counts, staleness 0 with its retries, builder
  validation, tcp against inproc, ``shm`` (the rings used, and the
  fallback that says so), the older push/pull facade, thread safety, and
  two worker processes over tcp and over shm on the CPU (the straggler
  wall-time test is left out: it is timing-bound).

Every test that starts a server or a process stops it; every process has a
timeout. Weights cross only through ``convert.from_jax``.
"""
import threading

import numpy as np
import pytest
import torch

from deeplearning4j_tpu.datasets.dataset import DataSet as JDataSet
from deeplearning4j_tpu.datasets.iterators import (
    ListDataSetIterator as JListIterator,
)
from deeplearning4j_tpu.nn.conf.builders import NeuralNetConfiguration as JNNC
from deeplearning4j_tpu.nn.conf.layers import DenseLayer, OutputLayer
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JaxNet
from deeplearning4j_tpu.parallel import param_server as jps
from deeplearning4j_tpu_torch.convert import from_jax, to_numpy
from deeplearning4j_tpu_torch.datasets import DataSet, ListDataSetIterator
from deeplearning4j_tpu_torch.parallel import ps_transport as pst
from deeplearning4j_tpu_torch.parallel.param_server import (
    DEFAULT_STALENESS_CAP, ParameterServer, ParameterServerParallelWrapper,
    ParameterServerTrainingHook, flatten_tree, tree_leaves, unflatten_into,
    unflatten_tree,
)

from _torch_port import compile_cache_at

RTOL, ATOL = 2e-4, 2e-5


def _np(tree):
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_np(v) for v in tree]
    return np.asarray(tree)


def _jax_dense(seed=12345, lr=0.1):
    conf = (JNNC.builder().seed(seed).learning_rate(lr).updater("sgd")
            .list()
            .layer(DenseLayer(n_in=4, n_out=8, activation="tanh"))
            .layer(OutputLayer(n_in=8, n_out=3, loss="mcxent",
                               activation="softmax"))
            .build())
    return JaxNet(conf).init()


def _jax_lm(seed=3):
    from deeplearning4j_tpu.models.transformer import transformer_lm
    # the config's own Adam rate (3e-4)
    return JaxNet(transformer_lm(16, width=32, n_layers=2, n_heads=2,
                                 max_len=16, seed=seed)).init()


def _port(jnet):
    return from_jax(jnet.conf.to_json(), _np(jnet.params_list), device="cpu")


def _batches(n_batches=16, batch=8, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n_batches):
        x = rng.normal(size=(batch, 4)).astype(np.float32)
        labels = (x[:, 0] + x[:, 1] > 0).astype(int)
        y = np.zeros((batch, 3), np.float32)
        y[np.arange(batch), labels] = 1
        out.append((x, y))
    return out


def _lm_batches(n=8, batch=4, T=16, V=16, seed=1):
    rng = np.random.default_rng(seed)
    eye = np.eye(V, dtype=np.float32)
    out = []
    for _ in range(n):
        ids = rng.integers(0, V, (batch, T))
        out.append((eye[ids], eye[np.roll(ids, -1, axis=1)]))
    return out


def _port_it(batches):
    return ListDataSetIterator([DataSet(x, y) for x, y in batches])


def _jax_it(batches):
    return JListIterator([JDataSet(x, y) for x, y in batches])


def _leaves(tree):
    return [np.asarray(a) for a in tree_leaves(to_numpy(tree))]


def _server(n=8, **kw):
    return ParameterServer([np.zeros(n, np.float32)], **kw)


def _jserver(n=8, **kw):
    return jps.ParameterServer([np.zeros(n, np.float32)], **kw)


# ---------------------------------------------------------------- the server
@pytest.mark.parametrize("optimizer", ["sgd", "momentum"])
def test_server_vector_matches_jax(optimizer):
    """The same deltas at the same base versions, some stale, some past
    the cap: the same weights, outcomes and vector as the JAX server."""
    rng = np.random.default_rng(11)
    init = rng.normal(size=37).astype(np.float32)
    kw = dict(staleness_cap=2, optimizer=optimizer, server_lr=0.7,
              momentum=0.6)
    ours = ParameterServer([init], **kw)
    ref = jps.ParameterServer([init], **kw)
    for i in range(20):
        delta = rng.normal(size=37).astype(np.float32)
        base = max(0, ours.version - int(rng.integers(0, 5)))
        a = ours.push_delta(delta, base)
        b = ref.push_delta(delta, base)
        assert (a.accepted, a.version, a.staleness, a.weight) == \
               (b.accepted, b.version, b.staleness, b.weight)
        np.testing.assert_allclose(a.params, b.params, rtol=0, atol=1e-7)
    assert (ours.pushes, ours.rejected) == (ref.pushes, ref.rejected)
    assert ours.rejected > 0 and ours.pushes > 0
    np.testing.assert_allclose(ours.pull_flat()[1], ref.pull_flat()[1],
                               rtol=0, atol=1e-7)


def test_staleness_weights_and_cap_match_jax():
    delta = np.ones(8, np.float32)
    for srv in (_server(), _jserver()):
        weights = [srv.push_delta(delta, base_version=0).weight
                   for _ in range(3)]
        assert weights == [1.0, 0.5, pytest.approx(1 / 3)]
        np.testing.assert_allclose(srv.pull_flat()[1],
                                   (1 + 0.5 + 1 / 3) * delta, rtol=1e-6)
    ours, ref = _server(staleness_cap=2), _jserver(staleness_cap=2)
    for srv in (ours, ref):
        for _ in range(3):
            srv.push_delta(delta, base_version=srv.version)
    a, b = ours.push_delta(delta, 0), ref.push_delta(delta, 0)
    assert (a.accepted, a.weight, a.staleness) == \
           (b.accepted, b.weight, b.staleness) == (False, 0.0, 3)
    np.testing.assert_array_equal(a.params, b.params)
    retry = ours.push_delta(delta, base_version=a.version)
    assert retry.accepted and retry.weight == 1.0 and ours.version == 4
    assert ours.stats()["staleness"] == {0: 4, 3: 1}


def test_fences_match_jax():
    from deeplearning4j_tpu.cloud import MembershipOracle as JOracle
    from deeplearning4j_tpu_torch.cloud import MembershipOracle

    class Clock:
        t = 0.0

        def __call__(self):
            return self.t

    out = []
    for Oracle, Server in ((MembershipOracle, ParameterServer),
                           (JOracle, jps.ParameterServer)):
        clock = Clock()
        oracle = Oracle(lease_timeout_s=5.0, clock=clock)
        srv = Server([np.zeros(4, np.float32)], membership=oracle)
        lease = oracle.register(0)
        d = np.ones(4, np.float32)
        r1 = srv.push_delta(d, 0, member=lease.member, epoch=lease.epoch)
        clock.t = 6.0
        r2 = srv.push_delta(d, 1, member=lease.member, epoch=lease.epoch)
        r3 = srv.push_delta(d, 1)  # no identity: not fenced
        repl = oracle.register(0)
        r4 = srv.push_delta(d, 2, member=repl.member, epoch=repl.epoch)
        out.append([(r.accepted, r.fenced, r.version, r.weight)
                    for r in (r1, r2, r3, r4)]
                   + [(srv.fenced, srv.rejected, oracle.lease_expiries)])
    assert out[0] == out[1]
    assert out[0][1][:2] == (False, True)


def test_flatten_tree_equals_jax_vector():
    from deeplearning4j_tpu.nn.conf.vertices import MergeVertex
    from deeplearning4j_tpu.nn.graph_network import ComputationGraph as JG
    graph = JG(JNNC.builder().seed(5).graph_builder()
               .add_inputs("a", "b")
               .add_layer("db", DenseLayer(n_in=3, n_out=6), "b")
               .add_layer("da", DenseLayer(n_in=4, n_out=6), "a")
               .add_vertex("m", MergeVertex(), "da", "db")
               .add_layer("out", OutputLayer(n_in=12, n_out=2, loss="mse",
                                             activation="identity"), "m")
               .set_outputs("out").build()).init()
    for jnet in (_jax_dense(), _jax_lm(), graph):
        jvec, _ = jps.flatten_tree(jnet.params_list)
        net = _port(jnet)
        vec, spec = flatten_tree(net.params_list)
        assert vec.dtype == np.float32
        np.testing.assert_array_equal(vec, jvec)
        # the rebuilt tree and the in-place write both give it back
        back = unflatten_tree(vec, spec)
        for a, b in zip(_leaves(back), _leaves(net.params_list)):
            np.testing.assert_array_equal(a, b)
        other = _port(jnet)
        with torch.no_grad():
            for p in tree_leaves(other.params_list):
                p.zero_()
        unflatten_into(jvec, other.params_list)
        np.testing.assert_array_equal(flatten_tree(other.params_list)[0],
                                      jvec)


def test_tree_flatten_roundtrip_and_legacy_facade():
    tree = [np.arange(6, dtype=np.float32).reshape(2, 3),
            np.ones((4,), np.float32)]
    vec, spec = flatten_tree(tree)
    assert vec.shape == (10,) and vec.dtype == np.float32
    for a, b in zip(tree, unflatten_tree(vec, spec)):
        np.testing.assert_array_equal(a, b)
    net = _port(_jax_dense())
    srv = ParameterServer(net.params_list)
    pulled = srv.pull()
    assert isinstance(pulled, list) and set(pulled[0]) == {"W", "b"}
    res = srv.push(pulled)  # a full-param push against the head
    assert res.accepted and srv.version == 1
    np.testing.assert_array_equal(res.params, flatten_tree(pulled)[0])


def test_server_is_thread_safe_under_contention():
    srv = _server(n=4)
    delta = np.ones(4, np.float32)
    n_threads, pushes_each = 8, 50

    def worker():
        for _ in range(pushes_each):
            srv.push_delta(delta, srv.pull_flat()[0])

    threads = [threading.Thread(target=worker) for _ in range(n_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert srv.version == srv.pushes == n_threads * pushes_each
    assert 0 < srv.pull_flat()[1][0] <= n_threads * pushes_each


# ------------------------------------------------------------- one worker
@pytest.mark.parametrize("model", ["dense", "lm"])
def test_single_worker_matches_fit_and_jax_wrapper(model, tmp_path):
    """One worker at push frequency 4 over 8 batches: each window's delta
    lands at staleness 0, weight 1, so the result is the port's own fit and
    the JAX one-worker wrapper's, within rtol 2e-4 atol 2e-5; exactly 2
    pushes (no shutdown re-push)."""
    jnet = _jax_dense() if model == "dense" else _jax_lm()
    data = _batches(8) if model == "dense" else _lm_batches(8)
    ps_net = _port(jnet)
    wrapper = (ParameterServerParallelWrapper.builder(ps_net)
               .workers(1).push_frequency(4).build())
    wrapper.fit(_port_it(data))
    single = _port(jnet)
    for x, y in data:
        single.fit(x, y)
    with compile_cache_at(tmp_path):
        jwrap = (jps.ParameterServerParallelWrapper.builder(jnet)
                 .workers(1).push_frequency(4).build())
        jwrap.fit(_jax_it(data))
    ref = [np.asarray(a) for a in __import__("jax").tree_util.tree_leaves(
        jnet.params_list)]
    for a, b, c in zip(_leaves(ps_net.params_list),
                       _leaves(single.params_list), ref):
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(a, c, rtol=RTOL, atol=ATOL)
    assert wrapper.server.pushes == jwrap.server.pushes == 2
    assert wrapper.worker_stats[0]["steps"] == 8
    assert wrapper.worker_stats[0]["pushes"] == 2
    assert wrapper.stats()["server"]["version"] == 2


def test_partial_final_window_flushes_exactly_once():
    for n, pushes in ((6, 2), (8, 2)):
        wrapper = (ParameterServerParallelWrapper
                   .builder(_port(_jax_dense())).workers(1)
                   .push_frequency(4).build())
        wrapper.fit(_port_it(_batches(n_batches=n)))
        assert wrapper.server.pushes == pushes
        assert wrapper.worker_stats[0]["steps"] == n


def test_training_hooks_see_every_step():
    seen = []

    class Hook(ParameterServerTrainingHook):
        def pre_update(self, dataset, model):
            seen.append(("pre", model.iteration))

        def post_update(self, dataset, model):
            seen.append(("post", model.iteration))

    wrapper = (ParameterServerParallelWrapper.builder(_port(_jax_dense()))
               .workers(1).push_frequency(2).training_hooks(Hook()).build())
    wrapper.fit(_port_it(_batches(4)))
    assert seen == [("pre", 0), ("post", 1), ("pre", 1), ("post", 2),
                    ("pre", 2), ("post", 3), ("pre", 3), ("post", 4)]


# ------------------------------------------------------------- many workers
def test_async_multiworker_trains_and_counts_every_step():
    data = _batches(n_batches=16)
    net = _port(_jax_dense())
    gx = np.concatenate([x for x, _ in data])
    gy = np.concatenate([y for _, y in data])
    s0 = float(net.score(gx, gy))
    wrapper = (ParameterServerParallelWrapper.builder(net)
               .workers(4).push_frequency(2).staleness(4).build())
    wrapper.fit(_port_it(data))
    assert sum(s["steps"] for s in wrapper.worker_stats) == 16
    assert wrapper.server.version == wrapper.server.pushes > 0
    assert float(net.score(gx, gy)) < s0 * 0.9


def test_staleness_cap_zero_forces_rebase_retry_but_loses_no_steps():
    wrapper = (ParameterServerParallelWrapper.builder(_port(_jax_dense()))
               .workers(4).push_frequency(1).staleness(0).build())
    wrapper.fit(_port_it(_batches(n_batches=16)))
    assert sum(s["steps"] for s in wrapper.worker_stats) == 16
    assert wrapper.server.pushes + wrapper.server.rejected >= 16
    assert sum(s["rejected"] for s in wrapper.worker_stats) \
        == wrapper.server.rejected


def test_builder_validation():
    net = _port(_jax_dense())
    with pytest.raises(ValueError, match="transport"):
        ParameterServerParallelWrapper(net, transport="carrier-pigeon")
    with pytest.raises(ValueError, match="compression"):
        ParameterServerParallelWrapper(net, compression="zip")
    with pytest.raises(ValueError, match="hooks"):
        (ParameterServerParallelWrapper.builder(net)
         .transport("tcp").training_hooks(object()).build())
    w = (ParameterServerParallelWrapper.builder(net).workers(3)
         .push_frequency(0).staleness(2).compression("bf16")
         .transport("shm").server_optimizer("momentum", 0.5)
         .worker_delays(0.1, 0.2).build())
    assert (w.workers, w.push_frequency, w.staleness, w.compression,
            w.transport, w.server_optimizer, w.server_lr,
            w.worker_delays) == (3, 1, 2, "bf16", "shm", "momentum", 0.5,
                                 [0.1, 0.2])
    assert DEFAULT_STALENESS_CAP == jps.DEFAULT_STALENESS_CAP


# --------------------------------------------------------------- transports
def test_tcp_transport_parity_with_inproc():
    srv_a, srv_b = _server(), _server()
    frontend = pst.ParameterServerTcpFrontend(srv_b).start()
    inproc = pst.InprocTransport(srv_a)
    tcp = pst.TcpTransport(("127.0.0.1", frontend.port))
    try:
        rng = np.random.default_rng(11)
        for _ in range(5):
            delta = rng.normal(size=8).astype(np.float32)
            ra = inproc.push(delta, base_version=srv_a.version)
            rb = tcp.push(delta, base_version=tcp.pull()[0])
            assert (ra.accepted, ra.version, ra.staleness, ra.weight) == \
                   (rb.accepted, rb.version, rb.staleness, rb.weight)
            np.testing.assert_array_equal(ra.params, rb.params)
        va, veca = inproc.pull()
        vb, vecb = tcp.pull()
        assert va == vb
        np.testing.assert_array_equal(veca, vecb)
        st = tcp.stats()
        assert st["push"] == 5 and st["pull"] == 6 and st["bytes_sent"] > 0
        assert frontend.stats()["push"] == 5
    finally:
        tcp.close()
        frontend.stop()


def test_jax_worker_transport_talks_to_the_port_frontend():
    """The frames are the JAX package's: a JAX TcpTransport pushes bf16
    deltas to the port's frontend and pulls the port server's vector."""
    from deeplearning4j_tpu.parallel.ps_transport import (
        TcpTransport as JTcp)
    srv = _server()
    frontend = pst.ParameterServerTcpFrontend(srv).start()
    t = JTcp(("127.0.0.1", frontend.port), codec="bf16")
    try:
        delta = np.linspace(-2, 2, 8).astype(np.float32)
        res = t.push(delta, 0)
        assert res.accepted and res.version == 1
        from deeplearning4j_tpu.streaming import wire as jwire
        expect = jwire.decode_array(*jwire.encode_array(delta, "bf16"))
        np.testing.assert_array_equal(srv.pull_flat()[1], expect)
        assert t.pull()[0] == 1
    finally:
        t.close()
        frontend.stop()


def test_shm_transport_uses_the_rings_and_matches_inproc():
    srv_a, srv_b = _server(n=64), _server(n=64)
    frontend = pst.ParameterServerTcpFrontend(srv_b).start()
    inproc = pst.InprocTransport(srv_a)
    shm = pst.ShmTransport(("127.0.0.1", frontend.port))
    try:
        rng = np.random.default_rng(2)
        for _ in range(4):
            delta = rng.normal(size=64).astype(np.float32)
            ra = inproc.push(delta, srv_a.version)
            rb = shm.push(delta, shm.pull()[0])
            np.testing.assert_array_equal(ra.params, rb.params)
            assert (ra.version, ra.weight) == (rb.version, rb.weight)
        st = shm.stats()
        assert st["shm_active"] is True and shm.shm_active
        assert st["shm_pushes"] == 4 and st["shm_pulls"] == 4
        assert st["shm_push_bytes"] == 4 * 64 * 4
        assert "push" not in st and "pull" not in st  # nothing on tcp frames
        assert frontend.stats()["shm_sessions"] == 1
    finally:
        shm.close()
        frontend.stop()
    assert frontend.stats()["shm_sessions"] == 0


def test_shm_transport_falls_back_and_says_so(monkeypatch):
    srv = _server()
    frontend = pst.ParameterServerTcpFrontend(srv).start()

    def refuse(nbytes, kind):
        raise OSError("no room")

    monkeypatch.setattr(pst, "create_segment", refuse)
    shm = pst.ShmTransport(("127.0.0.1", frontend.port))
    try:
        res = shm.push(np.ones(8, np.float32), 0)
        assert res.accepted and shm.pull()[0] == 1
        st = shm.stats()
        assert st["shm_active"] is False and st["shm_pushes"] == 0
        assert st["push"] == 1 and "no room" in st["fallback_reason"]
    finally:
        shm.close()
        frontend.stop()


def test_shm_ring_seqlock_and_shard_segments():
    seg = pst.create_segment(pst.ShmRing.segment_size(16), "ringtest")
    try:
        ring = pst.ShmRing(seg, 16)
        slot, seq = ring.write(memoryview(b"abcd"), 7)
        version, view = ring.read(slot, seq)
        assert version == 7 and bytes(view) == b"abcd"
        del view
        with pytest.raises(ConnectionError, match="seqlock"):
            ring.read(slot, seq + 2)
        with pytest.raises(ValueError, match="overflow"):
            ring.write(memoryview(bytes(17)), 1)
    finally:
        pst.release_segment(seg, unlink=True)
    x = np.arange(24, dtype=np.float32).reshape(2, 3, 4)
    name = pst.write_shard_segment({"x": x, "y": x[:, :1]}, kind="t")
    try:
        back = pst.read_shard_segment(name)
        np.testing.assert_array_equal(back["x"], x)
        np.testing.assert_array_equal(back["y"], x[:, :1])
    finally:
        assert pst.release_segment_by_name(name)
    assert not pst.release_segment_by_name(name)


def test_bf16_pushes_over_tcp_round_like_jax():
    srv = _server()
    frontend = pst.ParameterServerTcpFrontend(srv).start()
    tcp = pst.TcpTransport(("127.0.0.1", frontend.port), codec="bf16")
    try:
        delta = np.linspace(-2, 2, 8).astype(np.float32)
        assert tcp.push(delta, base_version=0).accepted
        np.testing.assert_allclose(srv.pull_flat()[1], delta, rtol=1e-2,
                                   atol=1e-2)
    finally:
        tcp.close()
        frontend.stop()


# ----------------------------------------------------------- worker processes
def _separable(n=24, seed=0):
    rng = np.random.default_rng(seed)
    means = rng.normal(0.0, 1.0, (3, 4)).astype(np.float32)
    data = []
    for _ in range(n):
        lab = rng.integers(0, 3, 16)
        x = (means[lab] + rng.normal(0, 0.5, (16, 4))).astype(np.float32)
        noisy = np.where(rng.random(16) < 0.25, rng.integers(0, 3, 16), lab)
        data.append((x, np.eye(3, dtype=np.float32)[noisy]))
    return data


@pytest.mark.parametrize("transport,codec", [("tcp", "bf16"),
                                             ("shm", "none")])
def test_two_worker_processes_train(transport, codec):
    """Two worker processes (``python -m ...ps_worker --device cpu``) over
    tcp with bf16 deltas, and over shm: every step counted, each worker's
    stats from its own process, the loss falls; on shm the shards went
    through segments and the rings were used."""
    pst.reap_orphans()  # what an earlier killed run left
    data = _separable()
    gx = np.concatenate([x for x, _ in data])
    gy = np.concatenate([y for _, y in data])
    net = _port(_jax_dense())
    s0 = float(net.score(gx, gy))
    wrapper = (ParameterServerParallelWrapper.builder(net)
               .workers(2).push_frequency(2).transport(transport)
               .compression(codec).build())
    wrapper.fit(_port_it(data))
    stats = wrapper.worker_stats
    assert len(stats) == 2
    assert sum(s["steps"] for s in stats) == 24
    assert wrapper.server.pushes == sum(s["pushes"] for s in stats)
    assert {s["device"] for s in stats} == {"cpu"}
    assert all(s["exit_reason"] == "done" for s in stats)
    # the dense net launches no kernel; the counts come from each worker
    assert all(set(s["launches"]) >= {"softmax_cross_entropy", "flash_fwd"}
               for s in stats)
    if transport == "shm":
        assert wrapper.shard_routes == ["shm", "shm"]
        assert all(s["transport"]["shm_active"] for s in stats)
        assert all(s["transport"]["shm_pushes"] == s["pushes"]
                   for s in stats)
    else:
        assert wrapper.shard_routes == ["npz", "npz"]
        assert all(s["transport"]["codec"] == "bf16" for s in stats)
    assert float(net.score(gx, gy)) < min(s0, 1.0986)
    assert pst.orphan_segments() == []
