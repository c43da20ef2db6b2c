"""Sharded serving pins and sharded replicas of the port on the CPU: the
counterparts of the sharded cases of ``tests/test_serving_replica.py``.

A sharded ``PredictFn`` lives on a device mesh that one process drives
(``build_mesh({"data": 4, "model": 2}, devices=["cpu"] * 8)``: eight slots
on the one CPU, told apart by position). Stated tolerances:

- bitwise against the port's unsharded pin at batch sizes 1, 2, 3, 4, 8
  and 32, float32 and int8 (the JAX package's serving contract);
- ``per_device_param_bytes`` equal to the partition math, to the bytes the
  tensors of every slot hold and to the recorded gauge;
- within 1e-6 of the JAX package's sharded pin on the same weights
  (``convert.from_jax``; the tolerance ``test_torch_replica.py`` holds the
  port's predict to against JAX), with the same specs leaf for leaf;
- ``ReplicaSet(sharding=, devices=)``, ``InferenceServer(sharding=,
  replica_devices=, replica_mesh_axes=)``: JAX's placements and errors,
  disjoint slices, requests served through a rolling swap with none lost.
"""
import http.client
import json
import threading

import numpy as np
import pytest
import torch

from _torch_port import compile_cache_at, no_executable_cache
from deeplearning4j_tpu.nn.conf.builders import NeuralNetConfiguration as JNNC
from deeplearning4j_tpu.nn.conf.layers import (
    BatchNormalization, DenseLayer, OutputLayer,
)
from deeplearning4j_tpu.nn.inference import make_predict_fn as jmake_predict
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JaxNet
from deeplearning4j_tpu.parallel import partition as jpartition
from deeplearning4j_tpu.parallel.mesh import build_mesh as jbuild_mesh
from deeplearning4j_tpu_torch.convert import from_jax
from deeplearning4j_tpu_torch.keras_server import InferenceServer, ReplicaSet
from deeplearning4j_tpu_torch.models import transformer_lm
from deeplearning4j_tpu_torch.nn.inference import PredictFn, make_predict_fn
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.parallel import partition
from deeplearning4j_tpu_torch.parallel.mesh import (
    DeviceMesh, Mesh, build_mesh,
)

N_IN, N_OUT = 16, 4
TOL = 1e-6
SIZES = (1, 2, 3, 4, 8, 32)
AXES = {"data": 4, "model": 2}


def _np(tree):
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_np(v) for v in tree]
    return np.asarray(tree)


def _jax_mlp(seed=7, wide=False):
    """JAX ``test_serving_replica.py``'s nets: a dense layer, batch norm
    and the output (``wide``: two 64-unit dense layers, so the kernels
    clear the int8 size floor)."""
    b = (JNNC.builder().seed(seed).learning_rate(0.1).updater("adam")
         .weight_init("xavier").list())
    if wide:
        b = (b.layer(DenseLayer(n_in=N_IN, n_out=64, activation="relu"))
             .layer(DenseLayer(n_in=64, n_out=64, activation="relu"))
             .layer(OutputLayer(n_in=64, n_out=N_OUT, loss="mcxent",
                                activation="softmax")))
    else:
        b = (b.layer(DenseLayer(n_in=N_IN, n_out=32, activation="relu"))
             .layer(BatchNormalization(n_in=32))
             .layer(OutputLayer(n_in=32, n_out=N_OUT, loss="mcxent",
                                activation="softmax")))
    return JaxNet(b.build()).init()


def _port(jnet):
    return from_jax(jnet.conf.to_json(), _np(jnet.params_list),
                    device="cpu", state_list=_np(jnet.state_list))


def _mesh():
    return build_mesh(AXES, devices=["cpu"] * 8)


def _rows(n, seed=0):
    return np.random.default_rng(seed + n).normal(
        size=(n, N_IN)).astype(np.float32)


def test_device_mesh_layout():
    mesh = _mesh()
    assert isinstance(mesh, DeviceMesh) and partition.is_device_mesh(mesh)
    assert mesh.shape == AXES and mesh.size == 8
    assert mesh.devices.shape == (4, 2)
    assert mesh.coords(5) == {"data": 2, "model": 1}
    assert mesh.peers(5, "model") == [4, 5]
    assert mesh.peers(5, "data") == [1, 3, 5, 7]
    assert mesh.lead_slots("data") == [0, 2, 4, 6]
    assert mesh.index(5, "data", "model") == 5
    # JAX's error for too few devices; a device that is not there
    with pytest.raises(ValueError, match="needs 8 devices, have 4"):
        build_mesh(AXES, devices=["cpu"] * 4)
    if not torch.cuda.is_available():
        with pytest.raises(ValueError, match="not there"):
            build_mesh({"data": 2}, devices=["cuda:0", "cuda:1"])
    # with no devices the mesh is the process group's
    assert isinstance(build_mesh({"data": 1}), Mesh)


@pytest.mark.parametrize("quant", [None, "int8"])
def test_sharded_predict_bitwise_and_per_device_bytes(quant):
    net = _port(_jax_mlp(wide=quant == "int8"))
    mesh = _mesh()
    ref = make_predict_fn(net, device="cpu", quant=quant)
    pf = make_predict_fn(net, sharding="dp_tp", mesh=mesh, quant=quant)
    # batch sizes the data axis divides and ones it does not (3, 1): the
    # odd tails run whole on the first device
    for n in SIZES:
        x = _rows(n)
        a, b = ref(x), pf(x)
        assert a.shape == (n, N_OUT)
        assert torch.equal(a, b), f"sharded output drifted at batch {n}"
    # the params really live split: a split leaf holds half its bytes a
    # slot on the model=2 axis
    split = [leaf for leaf in partition.tree_leaves(pf.params_snapshot())
             if isinstance(leaf, partition.MeshLeaf)
             and partition.sharded_dim(leaf.spec) is not None]
    assert split
    for leaf in split:
        assert len(leaf.shards) == 8
        assert all(s.nbytes * 2 == leaf.nbytes for s in leaf.shards)
    # per-device accounting: the property == the partition math == the
    # tensors each slot holds == the recorded gauge
    per_dev = pf.per_device_param_bytes
    assert per_dev is not None and per_dev < pf.param_bytes
    assert per_dev == partition.per_device_bytes(
        pf.params_snapshot(), pf.param_specs, mesh)
    assert pf.slot_param_bytes() == [per_dev] * 8
    assert partition.stats()["sharded_param_bytes_per_device"]["dp_tp"] \
        == per_dev
    assert pf.param_bytes == ref.param_bytes
    assert ref.per_device_param_bytes is None
    if quant == "int8":
        assert pf.name.endswith("+int8")
        # the int8 codes shard too: below the float32 sharded pin
        f32 = make_predict_fn(net, sharding="dp_tp", mesh=mesh)
        assert pf.param_bytes < f32.param_bytes
        assert per_dev < f32.per_device_param_bytes


def test_batch_spec_odd_tail_replicates():
    mesh = _mesh()
    assert partition.batch_spec(mesh, 8) == partition.pspec("data")
    assert partition.batch_spec(mesh, 4) == partition.pspec("data")
    assert partition.batch_spec(mesh, 3) == partition.pspec()
    assert partition.batch_spec(mesh, 1) == partition.pspec()


def test_sharded_transformer_pin_bitwise_and_multi_device_rows():
    """A transformer LM (3-D id batches, the flash forward's plain
    version) on a {data: 2, model: 2} mesh: bitwise at every size, each
    data slot running its own rows."""
    conf = transformer_lm(16, width=32, n_layers=2, n_heads=4, max_len=8)
    net = MultiLayerNetwork(conf, device="cpu").init(seed=3)
    mesh = build_mesh({"data": 2, "model": 2}, devices=["cpu"] * 4)
    ref = make_predict_fn(net, device="cpu")
    pf = make_predict_fn(net, sharding="dp_tp", mesh=mesh)
    rng = np.random.default_rng(9)
    for n in (1, 2, 3, 4):
        x = np.eye(16, dtype=np.float32)[rng.integers(0, 16, (n, 8))]
        assert torch.equal(ref(x), pf(x)), n
    specs = {p: s for p, s in _paths(pf.param_specs)}
    assert specs["1/Wqkv"] == partition.pspec(None, "model")
    assert specs["1/Wo"] == partition.pspec("model", None)
    assert pf.per_device_param_bytes == pf.slot_param_bytes()[3]


def _paths(tree):
    out = []
    partition.named_tree_map(lambda p, s: out.append((p, s)), tree)
    return out


def test_sharded_pin_equals_jax_sharded_pin(tmp_path):
    """The port's sharded pin against the JAX package's on the same
    weights: the same specs by path (int8's codes and scales too), the
    same per-device bytes, outputs within TOL."""
    for wide, quant in ((False, None), (True, "int8")):
        jnet = _jax_mlp(wide=wide)
        with compile_cache_at(tmp_path / f"x{wide}"), no_executable_cache():
            jpf = jmake_predict(jnet, sharding="dp_tp",
                                mesh=jbuild_mesh(AXES), quant=quant)
            want = {n: np.asarray(jpf(_rows(n))) for n in SIZES}
        pf = make_predict_fn(_port(jnet), sharding="dp_tp", mesh=_mesh(),
                             quant=quant)
        got_specs, jax_specs = [], []
        partition.named_tree_map(
            lambda p, s: got_specs.append((p, tuple(s))), pf.param_specs)
        jpartition.named_tree_map(
            lambda p, s: jax_specs.append((p, tuple(s))), jpf.param_specs,
            is_leaf=lambda s: isinstance(s, jpartition.PartitionSpec))
        assert sorted(got_specs) == sorted(jax_specs)
        assert pf.per_device_param_bytes == jpf.per_device_param_bytes
        for n in SIZES:
            np.testing.assert_allclose(pf(_rows(n)).numpy(), want[n],
                                       rtol=TOL, atol=TOL)


def test_predictfn_placement_validation():
    net = _port(_jax_mlp())
    mesh = _mesh()
    with pytest.raises(ValueError, match="mesh"):
        make_predict_fn(net, sharding="dp_tp")
    with pytest.raises(ValueError, match="not both"):
        make_predict_fn(net, sharding="dp_tp", mesh=mesh, device="cpu")
    with pytest.raises(ValueError, match="not both"):
        PredictFn(net, sharding="dp_tp", mesh=mesh, device="cpu")
    with pytest.raises(ValueError, match="sharding="):
        PredictFn(net, mesh=mesh)
    # a process-group mesh would need every batch broadcast to its ranks
    with pytest.raises(ValueError, match=r"build_mesh\(axes, devices="):
        make_predict_fn(net, sharding="dp_tp", mesh=build_mesh({"data": 1}))
    with pytest.raises(ValueError, match="unknown rule set"):
        make_predict_fn(net, sharding="nope", mesh=mesh)


def test_registry_describes_a_sharded_version():
    from deeplearning4j_tpu_torch.keras_server import ModelRegistry
    reg = ModelRegistry()
    mv = reg.register("m", _port(_jax_mlp()), sharding="dp_tp",
                      mesh=build_mesh({"data": 2, "model": 2},
                                      devices=["cpu"] * 4))
    d = mv.describe()
    assert d["sharding"] == "dp_tp" and d["devices"] == ["cpu"] * 4
    assert mv.predict_fn.per_device_param_bytes < d["param_bytes"]


def test_replica_set_sharded_placement_disjoint():
    rs = ReplicaSet(4, sharding="dp_tp", devices=["cpu"] * 8,
                    max_latency_s=0.001)
    try:
        assert rs.n_replicas == 4
        seen = []
        for r in rs.replicas:
            assert len(r.devices()) == 2  # 8 slots / 4 replicas
            assert r.mesh.shape == {"data": 1, "model": 2}
            seen.extend(r.slots)
        assert sorted(seen) == list(range(8))
        net = _port(_jax_mlp())
        rs.register("m", net, version="v1")
        x = _rows(2)
        res = rs.submit("m", x).result(timeout=60)
        assert res["version"] == "v1" and res["replica"] in range(4)
        np.testing.assert_array_equal(
            res["predictions"], make_predict_fn(net, device="cpu")(x).numpy())
        st = rs.stats()
        assert st["sharding"] == "dp_tp"
        assert [r["slots"] for r in st["replicas"]] == [
            [0, 1], [2, 3], [4, 5], [6, 7]]
        assert all(r["mesh"] == {"data": 1, "model": 2}
                   for r in st["replicas"])
        # every slice is claimed: a sharded scale-out has none left
        with pytest.raises(ValueError, match="no free device slice"):
            rs.add_replica()
    finally:
        rs.close()


def test_replica_set_placement_errors_and_round_robin():
    with pytest.raises(ValueError, match="need >= 4 devices, have 2"):
        ReplicaSet(4, sharding="dp_tp", devices=["cpu"] * 2)
    with pytest.raises(ValueError, match="needs 4 devices per replica"):
        ReplicaSet(2, sharding="dp_tp", devices=["cpu"] * 4,
                   mesh_axes={"data": 2, "model": 2})
    with pytest.raises(ValueError, match="device list"):
        ReplicaSet(2, device="cpu", sharding="dp_tp")
    # an odd slice gives the model axis 1 (JAX's default slice shape)
    rs = ReplicaSet(2, sharding="dp_tp", devices=["cpu"] * 6)
    try:
        assert [r.mesh.shape for r in rs.replicas] == [
            {"data": 3, "model": 1}] * 2
    finally:
        rs.close()
    # unsharded: round-robin over the device list; a scale-out continues it
    rs = ReplicaSet(3, devices=["cpu", "cpu"])
    try:
        assert [r.devices() for r in rs.replicas] == [["cpu"]] * 3
        assert all(r.mesh is None and r.sharding is None
                   for r in rs.replicas)
        assert rs.add_replica().devices() == ["cpu"]
    finally:
        rs.close()


def _post(port, path, body):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    conn.request("POST", path, body=json.dumps(body),
                 headers={"Content-Type": "application/json"})
    r = conn.getresponse()
    return r.status, json.loads(r.read())


def test_http_sharded_replicas_roll_without_loss():
    """``InferenceServer(replicas=2, sharding="dp_tp",
    replica_devices=["cpu"] * 8)``: 24 predicts from 4 threads with a
    rolling swap to v2 in flight; every answer 200 and within TOL of the
    unsharded pin of the version that answered; status lists each
    replica's 4 slots and mesh."""
    v1, v2 = _port(_jax_mlp(seed=7)), _port(_jax_mlp(seed=8))
    refs = {"v1": make_predict_fn(v1, device="cpu"),
            "v2": make_predict_fn(v2, device="cpu")}
    srv = InferenceServer(replicas=2, sharding="dp_tp",
                          replica_devices=["cpu"] * 8, device="cpu",
                          max_batch=8, max_latency_s=0.002)
    srv.register("mlp", v1, version="v1")
    srv.start()
    answers, lock = [], threading.Lock()
    try:
        def client(k):
            for i in range(6):
                x = _rows(1, seed=100 * k + i)
                code, body = _post(srv.port, "/v1/predict",
                                   {"model": "mlp", "inputs": x.tolist()})
                with lock:
                    answers.append((code, body, x))

        threads = [threading.Thread(target=client, args=(k,))
                   for k in range(4)]
        for t in threads:
            t.start()
        srv.register("mlp", v2, version="v2")
        for t in threads:
            t.join(60)
        assert len(answers) == 24
        for code, body, x in answers:
            assert code == 200
            # the batcher groups rows of several requests: held as
            # test_torch_replica.py holds a batched answer
            np.testing.assert_allclose(
                np.asarray(body["predictions"], np.float32),
                refs[body["version"]](x).numpy(), rtol=TOL, atol=TOL)
        conn = http.client.HTTPConnection("127.0.0.1", srv.port, timeout=30)
        conn.request("GET", "/serve/status")
        st = json.loads(conn.getresponse().read())
        reps = st["replicas"]["replicas"]
        assert [r["slots"] for r in reps] == [[0, 1, 2, 3], [4, 5, 6, 7]]
        assert all(r["mesh"] == {"data": 2, "model": 2}
                   and r["sharding"] == "dp_tp" and len(r["devices"]) == 4
                   and r["active"] == {"mlp": "v2"} for r in reps)
    finally:
        srv.stop()
    # replica_mesh_axes shapes each slice
    srv = InferenceServer(replicas=2, sharding="dp_tp", device="cpu",
                          replica_devices=["cpu"] * 8,
                          replica_mesh_axes={"data": 1, "model": 4})
    try:
        assert [r.mesh.shape for r in srv.replica_set.replicas] == [
            {"data": 1, "model": 4}] * 2
    finally:
        srv.replica_set.close()
