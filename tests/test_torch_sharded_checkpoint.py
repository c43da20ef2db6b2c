"""Sharded checkpoints of the port (``utils/sharded_checkpoint.py``, on
``torch.distributed.checkpoint``) on the CPU.

- A round trip of a ``MultiLayerNetwork`` (Adam, batch norm) and a
  ``ComputationGraph``: params, layer states and updater state bitwise,
  iteration and epoch from the sidecar, the restored network continuing
  bitwise as the original does; rebuilt from the stored config or into a
  given network.
- A ``zero3`` fit on two gloo ranks (``tests/_torch_dist.py``) with
  ``CheckpointListener(sharded=True)``: each rank writes its own blocks
  (shard keys of both ranks in the index, the listener seeing released
  param storage), and the checkpoint restored in one process equals the
  ranks' whole state bitwise.
- The sidecar: ``config.json`` and ``meta.json`` with the keys and values
  the JAX package's ``_snapshot_sidecar`` gives for the same network.
- Commit ordering (the counterparts of ``tests/test_sharded_checkpoint.py``):
  the async sidecar appears only after ``wait``, rolling saves commit the
  previous directory with its own iteration, restore refuses an
  uncommitted directory, saves to one directory replace each other.
- ``CheckpointListener(sharded=True)``: rotation, the ``LATEST`` pointer
  and a restore from it.
"""
import json
import os

import numpy as np
import pytest

from deeplearning4j_tpu.nn.conf.builders import NeuralNetConfiguration as JNNC
from deeplearning4j_tpu.nn.conf.layers import (
    BatchNormalization, DenseLayer, OutputLayer,
)
from deeplearning4j_tpu.nn.conf.vertices import MergeVertex
from deeplearning4j_tpu.nn.graph_network import ComputationGraph as JGraph
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JaxNet
from deeplearning4j_tpu_torch.convert import from_jax, to_numpy
from deeplearning4j_tpu_torch.optimize.listeners import CheckpointListener
from deeplearning4j_tpu_torch.utils.sharded_checkpoint import (
    AsyncShardedSaver, restore_sharded, save_sharded,
)

import _torch_dist


def _np(tree):
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_np(v) for v in tree]
    return np.asarray(tree)


def _jax_mlp(seed=5):
    conf = (JNNC.builder().seed(seed).learning_rate(0.05).updater("adam")
            .list()
            .layer(DenseLayer(n_in=4, n_out=16, activation="tanh"))
            .layer(BatchNormalization(n_in=16))
            .layer(OutputLayer(n_in=16, n_out=3, loss="mcxent",
                               activation="softmax"))
            .build())
    return JaxNet(conf).init()


def _jax_graph(seed=6):
    return JGraph(
        JNNC.builder().seed(seed).learning_rate(0.05).updater("adam")
        .graph_builder().add_inputs("a", "b")
        .add_layer("da", DenseLayer(n_in=4, n_out=6, activation="tanh"), "a")
        .add_layer("db", DenseLayer(n_in=3, n_out=6, activation="tanh"), "b")
        .add_vertex("m", MergeVertex(), "da", "db")
        .add_layer("out", OutputLayer(n_in=12, n_out=2, loss="mse",
                                      activation="identity"), "m")
        .set_outputs("out").build()).init()


def _data(seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(16, 4)).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, 16)]
    return x, y


def _trained(jnet=None, steps=2):
    jnet = jnet or _jax_mlp()
    net = from_jax(jnet.conf.to_json(), _np(jnet.params_list), device="cpu")
    x, y = _data()
    for _ in range(steps):
        net.fit(x, y)
    return net, x, y


def _graph_trained():
    net = from_jax(_jax_graph().conf.to_json(),
                   _np(_jax_graph().params_list), device="cpu")
    rng = np.random.default_rng(2)
    xs = [rng.normal(size=(8, 4)).astype(np.float32),
          rng.normal(size=(8, 3)).astype(np.float32)]
    ys = [rng.normal(size=(8, 2)).astype(np.float32)]
    for _ in range(2):
        net.fit(xs, ys)
    return net, xs, ys


def _assert_same_state(a, b):
    for ta, tb in ((a.params_list, b.params_list),
                   (a.state_list, b.state_list),
                   (a.updater_state, b.updater_state)):
        ta, tb = to_numpy(ta), to_numpy(tb)
        items = ta.items() if isinstance(ta, dict) else enumerate(ta)
        for k, leaves in items:
            assert set(leaves) == set(tb[k])
            for name, v in leaves.items():
                if isinstance(v, dict):
                    assert set(v) == set(tb[k][name])
                    for slot, arr in v.items():
                        np.testing.assert_array_equal(arr, tb[k][name][slot])
                else:
                    np.testing.assert_array_equal(v, tb[k][name])
    assert (a.iteration, a.epoch) == (b.iteration, b.epoch)


@pytest.mark.parametrize("kind", ["multilayer", "graph"])
def test_round_trip_bitwise_and_resume(kind, tmp_path):
    net, x, y = _trained() if kind == "multilayer" else _graph_trained()
    net.epoch = 3
    d = save_sharded(str(tmp_path / "ck"), net, step=7)
    assert sorted(os.listdir(d)) == ["config.json", "meta.json", "state"]
    back = restore_sharded(d, device="cpu")  # rebuilt from the config
    assert type(back) is type(net)
    _assert_same_state(back, net)
    into = restore_sharded(d, (_trained(_jax_mlp(seed=99))[0]
                               if kind == "multilayer"
                               else _graph_trained()[0]))
    _assert_same_state(into, net)
    # the restored network continues as the original does
    for n in (net, back):
        n.fit(x, y)
    _assert_same_state(back, net)


def test_sidecar_equals_jax_snapshot(tmp_path):
    from deeplearning4j_tpu.utils.sharded_checkpoint import (
        _snapshot_sidecar as jax_sidecar)
    jnet = _jax_mlp()
    net, _, _ = _trained(jnet, steps=0)
    for n in (jnet, net):
        n.iteration, n.epoch = 4, 1
    d = save_sharded(str(tmp_path / "ck"), net, step=12)
    ref = jax_sidecar(jnet, 12)
    with open(os.path.join(d, "meta.json")) as f:
        meta = json.load(f)
    with open(os.path.join(d, "config.json")) as f:
        config = f.read()
    assert meta == ref["meta"]
    assert set(meta) == {"iteration", "epoch", "step", "network_type"}
    assert json.loads(config) == json.loads(ref["config"])
    graph = from_jax(_jax_graph().conf.to_json(),
                     _np(_jax_graph().params_list), device="cpu")
    d2 = save_sharded(str(tmp_path / "g"), graph)
    with open(os.path.join(d2, "meta.json")) as f:
        assert json.load(f) == jax_sidecar(_jax_graph(), None)["meta"]


def test_async_sidecar_commits_only_after_wait(tmp_path):
    net, x, y = _trained()
    d = str(tmp_path / "commit_ck")
    with AsyncShardedSaver() as saver:
        saver.save(d, net)
        assert not os.path.exists(os.path.join(d, "meta.json"))
        assert not os.path.exists(os.path.join(d, "config.json"))
        snap = [{k: v.copy() for k, v in layer.items()}
                for layer in to_numpy(net.params_list)]
        net.fit(x, y)  # train on while the write is in flight
        saver.wait()
        assert os.path.exists(os.path.join(d, "meta.json"))
        assert os.path.exists(os.path.join(d, "config.json"))
    back = restore_sharded(d, device="cpu")
    # the state of save() time, not of wait() time
    assert back.iteration == net.iteration - 1
    for a, b in zip(to_numpy(back.params_list), snap):
        for k in b:
            np.testing.assert_array_equal(a[k], b[k])


def test_async_rolling_save_commits_previous_directory(tmp_path):
    net, x, y = _trained()
    d1, d2 = str(tmp_path / "ck1"), str(tmp_path / "ck2")
    with AsyncShardedSaver() as saver:
        saver.save(d1, net)
        it1 = int(net.iteration)
        net.fit(x, y)
        saver.save(d2, net)
        assert os.path.exists(os.path.join(d1, "meta.json"))
        with open(os.path.join(d1, "meta.json")) as f:
            assert json.load(f)["iteration"] == it1
        assert not os.path.exists(os.path.join(d2, "meta.json"))
    assert os.path.exists(os.path.join(d2, "meta.json"))
    assert saver.committed == 2


def test_restore_refuses_uncommitted_and_rolls_one_directory(tmp_path):
    net, x, y = _trained()
    d = str(tmp_path / "roll")
    save_sharded(d, net)
    net.fit(x, y)
    save_sharded(d, net)  # a second save replaces the first
    assert restore_sharded(d, device="cpu").iteration == net.iteration
    with AsyncShardedSaver() as saver:
        net.fit(x, y)
        saver.save(d, net)
    assert restore_sharded(d, device="cpu").iteration == net.iteration
    os.remove(os.path.join(d, "meta.json"))
    os.remove(os.path.join(d, "config.json"))
    with pytest.raises(RuntimeError, match="no committed sidecar"):
        restore_sharded(d, net)
    # a restore onto a sharding needs its mesh too (the refusal that
    # named ROADMAP.md A7.8 before it was ported)
    with pytest.raises(ValueError, match="both"):
        restore_sharded(d, net, shardings=object())


def test_checkpoint_listener_sharded_mode(tmp_path):
    net, x, y = _trained()
    d = str(tmp_path / "ck")
    lis = CheckpointListener(d, every_n_iterations=1, every_n_epochs=None,
                             keep_last=2, sharded=True)
    net.listeners.append(lis)
    for _ in range(4):
        net.fit(x, y)
    dirs = sorted(p for p in os.listdir(d) if p.startswith("checkpoint_"))
    assert dirs == ["checkpoint_iter_5", "checkpoint_iter_6"]
    last = CheckpointListener.last_checkpoint(d)
    assert last == os.path.join(d, "checkpoint_iter_6")
    restored = restore_sharded(last, device="cpu")
    _assert_same_state(restored, net)
    # a new listener over the directory counts the directories on disk
    again = CheckpointListener(d, every_n_iterations=1, keep_last=2,
                               sharded=True)
    assert len(again._written) == 2


def test_zero3_ranks_write_their_blocks_and_restore_whole(tmp_path):
    """Two gloo ranks fit through ``ParallelWrapper(zero3)`` with a sharded
    CheckpointListener: every rank writes its own file and its own blocks
    (no gather: the listener sees the params' storage released), and the
    last checkpoint, restored in this one process, equals each rank's
    whole state after the fit bitwise."""
    from torch.distributed.checkpoint import FileSystemReader

    conf = (JNNC.builder().seed(11).learning_rate(0.05).updater("adam")
            .list()
            .layer(DenseLayer(n_in=8, n_out=16, activation="tanh"))
            .layer(OutputLayer(n_in=16, n_out=3, loss="mcxent",
                               activation="softmax")).build())
    rng = np.random.default_rng(3)
    batches = [(rng.normal(size=(32, 8)).astype(np.float32),
                np.eye(3, dtype=np.float32)[rng.integers(0, 3, 32)])
               for _ in range(4)]
    d = str(tmp_path / "zero3")
    ranks = _torch_dist.run(2, [("ck", {
        "job": "checkpoint", "conf_json": conf.to_json(),
        "params": _np(JaxNet(conf).init().params_list), "batches": batches,
        "directory": d, "knobs": [("sharding", ("zero3",))]})], timeout=180)
    got = [r["ck"] for r in ranks]
    assert all(g["min_storage"] == 0 for g in got)  # only shards held
    last = CheckpointListener.last_checkpoint(d)
    assert last == os.path.join(d, "checkpoint_iter_4")
    state = os.path.join(last, "state")
    assert sorted(f for f in os.listdir(state) if f.endswith(".distcp")) \
        == ["__0_0.distcp", "__1_0.distcp"]
    keys = FileSystemReader(state).read_metadata().state_dict_metadata
    shard_keys = [k for k in keys if "@shard" in k]
    assert {k.split("@shard")[1][:4] for k in shard_keys} == {"0of2",
                                                             "1of2"}
    assert any(k.startswith("params/") for k in shard_keys)
    assert any(k.startswith("updater/") for k in shard_keys)
    back = restore_sharded(last, device="cpu")
    assert back.iteration == got[0]["iteration"] == 4
    for g in got:
        for a, b in zip(to_numpy(back.params_list), g["params"]):
            for k in b:
                np.testing.assert_array_equal(a[k], b[k])
        for a, b in zip(to_numpy(back.updater_state), g["updater"]):
            for k in b:
                for s in b[k]:
                    np.testing.assert_array_equal(a[k][s], b[k][s])
