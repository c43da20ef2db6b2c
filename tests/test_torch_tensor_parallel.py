"""The port's ``dp_tp`` placement (``parallel/tensor_parallel.py``,
``ParallelWrapper.sharding("dp_tp")``, ``mesh.shard_params_for_tp``) held
against the JAX package's ``dp_tp`` (GSPMD on the rules' specs) and
against single-device ``fit``.

The port runs SPMD on gloo CPU groups: 4 ranks for ``{data: 2, model:
2}``, 2 ranks for ``{data: 1, model: 2}`` (``tests/_torch_dist.py``); the
JAX references run in this process on the conftest's 8 virtual CPU
devices, the same meshes over the first 4 or 2. Stated tolerance, JAX's
own (``tests/test_partition_engine.py``): atol 1e-4, rtol 1e-4, dp_tp
being never bitwise (the model axis reorders sums). As in
``test_torch_pipeline.py``, the runs held against JAX train with SGD at
0.1; the transformer's own Adam config is held against the port's
single-device fit.
"""
import json
import os

import numpy as np
import pytest

import _torch_dist
from _torch_port import compile_cache_at, no_executable_cache
from deeplearning4j_tpu.datasets.dataset import DataSet as JDataSet
from deeplearning4j_tpu.datasets.iterators import (
    ListDataSetIterator as JList)
from deeplearning4j_tpu.models import (
    moe_transformer_lm as jmoe_lm, transformer_lm as jtransformer_lm)
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JNet
from deeplearning4j_tpu.parallel.mesh import build_mesh as jbuild_mesh
from deeplearning4j_tpu.parallel.wrapper import ParallelWrapper as JPW

VOCAB, WIDTH, HEADS, T, B = 8, 32, 4, 16, 8
ATOL = RTOL = 1e-4
#: the meshes (by rank count)
MESHES = {4: {"data": 2, "model": 2}, 2: {"data": 1, "model": 2}}


def _np(tree):
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_np(v) for v in tree]
    return np.asarray(tree)


def _lm_batches(n=3, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        ids = rng.integers(0, VOCAB, size=(B, T + 1))
        out.append((np.eye(VOCAB, dtype=np.float32)[ids[:, :-1]],
                    np.eye(VOCAB, dtype=np.float32)[ids[:, 1:]]))
    return out


def _image_batches(n=3, b=8, seed=4):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        x = rng.normal(size=(b, 12 * 12)).astype(np.float32)
        y = np.eye(4, dtype=np.float32)[rng.integers(0, 4, b)]
        out.append((x, y))
    return out


def _sgd(text, lr=0.1):
    d = json.loads(text)
    d["global_conf"].update(updater="sgd", learning_rate=lr)
    for layer in d["layers"]:
        layer.update(updater="sgd", learning_rate=lr, bias_learning_rate=lr)
    return json.dumps(d)


def _lm(heads=HEADS, width=WIDTH, sgd=True):
    text = jtransformer_lm(VOCAB, width=width, n_layers=2, n_heads=heads,
                           max_len=T, learning_rate=0.01).to_json()
    return _sgd(text) if sgd else text


def _moe():
    return _sgd(jmoe_lm(VOCAB, width=WIDTH, n_layers=2, n_heads=HEADS,
                        n_experts=4, max_len=T, learning_rate=0.01).to_json())


def _lenet_like():
    """Two convolutions, a pooling, a dense and an output layer: every
    split leaf gathered at use."""
    from deeplearning4j_tpu.nn.conf.builders import NeuralNetConfiguration
    from deeplearning4j_tpu.nn.conf.inputs import InputType
    from deeplearning4j_tpu.nn.conf.layers import (
        ConvolutionLayer, DenseLayer, OutputLayer, SubsamplingLayer)
    return (NeuralNetConfiguration.builder().seed(7).learning_rate(0.1)
            .updater("sgd").weight_init("xavier").list()
            .layer(ConvolutionLayer(n_out=4, kernel_size=(3, 3),
                                    stride=(1, 1), activation="relu"))
            .layer(SubsamplingLayer(pooling_type="max", kernel_size=(2, 2),
                                    stride=(2, 2)))
            .layer(ConvolutionLayer(n_out=6, kernel_size=(3, 3),
                                    stride=(1, 1), activation="identity"))
            .layer(DenseLayer(n_out=16, activation="relu"))
            .layer(OutputLayer(n_out=4, loss="mcxent", activation="softmax"))
            .set_input_type(InputType.convolutional_flat(12, 12, 1))
            .build()).to_json()


def _jconf(text):
    from deeplearning4j_tpu.nn.conf.multilayer import (
        MultiLayerConfiguration as JConf)
    return JConf.from_json(text)


def _close(got, want, atol=ATOL, rtol=RTOL):
    for g, w in zip(got, want):
        for k in w:
            np.testing.assert_allclose(g[k], np.asarray(w[k]), atol=atol,
                                       rtol=rtol, err_msg=k)


def _job(**kw):
    return kw


#: (name, config JSON maker, batch maker, meshes by rank count)
CASES = (("lm", _lm, _lm_batches, (4, 2)),
         ("moe", _moe, _lm_batches, (4, 2)),
         ("heads3", lambda: _lm(heads=3, width=24), _lm_batches, (2,)),
         ("lenet", _lenet_like, _image_batches, (4,)))


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    from deeplearning4j_tpu.parallel.mesh import shard_params_for_tp

    ref = {}
    jobs = {2: [], 4: []}
    with compile_cache_at(tmp_path_factory.mktemp("xcache")), \
            no_executable_cache():
        for name, make, batches_of, worlds in CASES:
            text = make()
            batches = batches_of()
            p0 = _np(JNet(_jconf(text)).init().params_list)
            single = JNet(_jconf(text)).init()
            for x, y in batches:
                single.fit(x, y)
            ref[name] = {"single": _np(single.params_list)}
            for w in worlds:
                net = JNet(_jconf(text)).init()
                (JPW.builder(net).mesh(jbuild_mesh(MESHES[w]))
                 .prefetch_buffer(0).sharding("dp_tp").build()
                 .fit(JList([JDataSet(x, y) for x, y in batches])))
                ref[name][w] = _np(net.params_list)
                jobs[w].append((name, _job(
                    job="wrapper", conf_json=text, params=p0,
                    batches=batches, axes=MESHES[w],
                    knobs=[("sharding", ("dp_tp",))], hold_check=True)))
            jobs[worlds[0]].append((f"{name}_single", _job(
                job="wrapper", conf_json=text, params=p0, batches=batches,
                single=True)))
        # the transformer's own Adam config
        adam = _lm(sgd=False)
        ap0 = _np(JNet(_jconf(adam)).init().params_list)
        batches = _lm_batches()
        jobs[4] += [("adam", _job(
            job="wrapper", conf_json=adam, params=ap0, batches=batches,
            axes=MESHES[4], knobs=[("sharding", ("dp_tp",))])),
            ("adam_single", _job(job="wrapper", conf_json=adam, params=ap0,
                                 batches=batches, single=True))]
        # shard_params_for_tp: each device's block of JAX's placement
        text = _lm()
        jnet = JNet(_jconf(text)).init()
        mesh = jbuild_mesh(MESHES[4])
        placed = shard_params_for_tp(jnet.params_list, jnet.conf, mesh)
        devices = list(mesh.devices.flatten())
        ref["placed"] = [
            [{k: np.asarray(next(s.data for s in v.addressable_shards
                                 if s.device == d))
              for k, v in layer.items()} for layer in placed]
            for d in devices]
        jobs[4].append(("placed", _job(job="shard_tp", conf_json=text,
                                       params=_np(jnet.params_list),
                                       axes=MESHES[4])))
        jobs[4].append(("nothing", _job(job="raises",
                                        what="dp_tp_nothing_shards")))
        # a sharded CheckpointListener inside the fit (the Adam config:
        # its moments are blocks too)
        ref["ck_dir"] = {}
        for w in (4, 2):
            d = str(tmp_path_factory.mktemp(f"ck{w}"))
            ref["ck_dir"][w] = d
            jobs[w].append(("ck", _job(
                job="checkpoint", conf_json=adam, params=ap0,
                batches=batches, directory=d, axes=MESHES[w],
                knobs=[("sharding", ("dp_tp",))])))
    ranks = {w: _torch_dist.run(w, j) for w, j in jobs.items()}
    return ref, ranks


@pytest.mark.parametrize("name,w", [(c[0], w) for c in CASES for w in c[3]])
def test_dp_tp_fit_equals_jax_and_single_device(run, name, w):
    ref, ranks = run
    worlds = next(c[3] for c in CASES if c[0] == name)
    single = ranks[worlds[0]][0][f"{name}_single"]
    for r in ranks[w]:
        got = r[name]
        _close(got["params"], ref[name][w])
        _close(got["params"], ref[name]["single"])
        _close(got["params"], single["params"])
        np.testing.assert_allclose(got["scores"], single["scores"],
                                   rtol=1e-5)
        assert got["iteration"] == 3
        assert got["collectives"].get("all_gather/tp_gather", 0) > 0


def test_dp_tp_adam_equals_single_device(run):
    _, ranks = run
    for r in ranks[4]:
        _close(r["adam"]["params"], ranks[4][0]["adam_single"]["params"])


@pytest.mark.parametrize("w", (4, 2))
def test_half_of_wqkv_per_model_rank(run, w):
    """Between steps each model rank holds half of each block's split
    leaves (``Wqkv`` as its heads' q, k, v columns) and the network's whole
    tensors give their storage back; the Megatron pairs engage in every
    block."""
    _, ranks = run
    for r in ranks[w]:
        for h in r["lm"]["holds"]:
            assert h["min_storage"] == 0
            for key in ("1", "2"):
                block, whole = h["blocks"][f"{key}/Wqkv"]
                assert block * 2 == whole
                assert h["megatron"][key] == ["W1", "W2", "Wo", "Wqkv",
                                              "b1"]
            # the embedding and the output layer: gathered at use
            assert "0/W" in h["blocks"] and "3/W" in h["blocks"]
            assert "0" not in h["megatron"] and "3" not in h["megatron"]
        moe = r["moe"]["holds"][0]["megatron"]
        assert moe["1"] == ["W1", "W2", "Wo", "Wqkv", "b1"]


def test_indivisible_heads_run_the_attention_gathered(run):
    """3 heads on a model axis of 2: the attention's leaves are split by
    the rules but the block attends gathered; its FFN is a Megatron pair."""
    _, ranks = run
    for r in ranks[2]:
        h = r["heads3"]["holds"][0]
        assert h["megatron"]["1"] == ["W1", "W2", "b1"]
        assert "1/Wqkv" in h["blocks"] and "1/Wo" in h["blocks"]


def test_lenet_like_net_gathers_at_use(run):
    _, ranks = run
    for r in ranks[4]:
        h = r["lenet"]["holds"][0]
        assert h["megatron"] == {}
        assert {"0/W", "2/W", "3/W", "4/W"} <= set(h["blocks"])


def test_shard_params_for_tp_equals_jax(run):
    """Each rank's blocks are the blocks JAX's placement puts on the device
    at the same mesh coordinates."""
    ref, ranks = run
    for rank, r in enumerate(ranks[4]):
        got = r["placed"]["blocks"]
        for layer_got, layer_want in zip(got, ref["placed"][rank]):
            assert set(layer_got) == set(layer_want)
            for k in layer_want:
                np.testing.assert_array_equal(layer_got[k], layer_want[k])


def test_nothing_would_shard(run):
    """An explicit dp_tp request on a net where no dim divides the model
    axis raises JAX's message at fit."""
    from deeplearning4j_tpu.nn.conf.builders import NeuralNetConfiguration
    from deeplearning4j_tpu.nn.conf.layers import DenseLayer, OutputLayer
    _, ranks = run
    conf = (NeuralNetConfiguration.builder().seed(1).list()
            .layer(DenseLayer(n_in=5, n_out=7, activation="tanh"))
            .layer(OutputLayer(n_in=7, n_out=3, loss="mcxent",
                               activation="softmax")).build())
    pw = (JPW.builder(JNet(conf).init()).mesh(jbuild_mesh(MESHES[4]))
          .prefetch_buffer(0).sharding("dp_tp").build())
    x = np.zeros((8, 5), np.float32)
    y = np.eye(3, dtype=np.float32)[np.zeros(8, int)]
    with pytest.raises(ValueError) as want:
        pw.fit(JList([JDataSet(x, y)]))
    assert "nothing would shard" in str(want.value)
    for r in ranks[4]:
        assert r["nothing"] == {"type": "ValueError", "msg": str(want.value)}


def test_model_axis_and_frequency_errors_carry_jax_messages():
    from deeplearning4j_tpu_torch.convert import from_jax
    from deeplearning4j_tpu_torch.parallel import ParallelWrapper
    from deeplearning4j_tpu_torch.parallel.mesh import build_mesh

    text = _lm()
    jnet = JNet(_jconf(text)).init()
    net = from_jax(text, _np(jnet.params_list), device="cpu")
    with pytest.raises(ValueError) as want:
        JPW.builder(jnet).workers(1).sharding("dp_tp").build()
    with pytest.raises(ValueError) as got:
        ParallelWrapper.builder(net).sharding("dp_tp").build()
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError) as want:
        (JPW.builder(jnet).mesh(jbuild_mesh({"data": 1, "model": 1}))
         .averaging_frequency(4).sharding("dp_tp").build())
    with pytest.raises(ValueError) as got:
        (ParallelWrapper.builder(net).mesh(build_mesh({"data": 1,
                                                       "model": 1}))
         .averaging_frequency(4).sharding("dp_tp").build())
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="runs alone"):
        (ParallelWrapper.builder(net).mesh(build_mesh({"data": 1,
                                                       "model": 1}))
         .sharding("dp_tp").shard_optimizer_state().build())


@pytest.mark.parametrize("w", (4, 2))
def test_sharded_checkpoint_saves_blocks_and_restores_whole(run, w):
    """A ``CheckpointListener(sharded=True)`` inside a dp_tp fit: each model
    rank writes its blocks with no gather (``Wqkv``'s as its heads' q, k
    and v thirds), a data replica's alike once, and the last checkpoint
    restores bitwise to the whole state every rank ends the fit with."""
    from torch.distributed.checkpoint import FileSystemReader

    from deeplearning4j_tpu_torch.optimize.listeners import (
        CheckpointListener)
    from deeplearning4j_tpu_torch.utils.sharded_checkpoint import (
        restore_sharded)

    ref, ranks = run
    d = ref["ck_dir"][w]
    got = [r["ck"] for r in ranks[w]]
    assert all(g["min_storage"] == 0 for g in got)
    last = CheckpointListener.last_checkpoint(d)
    assert last == os.path.join(d, "checkpoint_iter_3")
    keys = FileSystemReader(os.path.join(last, "state")).read_metadata() \
        .state_dict_metadata
    for r in range(2):
        assert f"params/1/Wqkv@shard{r}of2@dim1@groups3" in keys
        assert f"updater/1/Wqkv/m@shard{r}of2@dim1@groups3" in keys
        assert f"params/1/Wo@shard{r}of2@dim0" in keys
    assert "params/1/Wqkv" not in keys
    back = restore_sharded(last, device="cpu")
    assert back.iteration == got[0]["iteration"] == 3
    for g in got:
        _same_state(back, g)


def test_listeners_reading_whole_state_refused(tmp_path):
    """A zip checkpoint and the param log inside a dp_tp fit (the name is
    kept from when the fit refused them): on ``{data: 1, model: 1}`` with
    no process group every split leaf is held as a block of one with its
    whole tensor's storage given back, so they fire inside a whole view
    each iteration; the last zip is bitwise the state the fit leaves, the
    log's rows read the whole params, and the fit counts its views."""
    from deeplearning4j_tpu_torch.convert import from_jax, to_numpy
    from deeplearning4j_tpu_torch.datasets import DataSet, ListDataSetIterator
    from deeplearning4j_tpu_torch.optimize.listeners import (
        CheckpointListener, ParamAndGradientIterationListener)
    from deeplearning4j_tpu_torch.parallel import ParallelWrapper
    from deeplearning4j_tpu_torch.parallel.mesh import build_mesh
    from deeplearning4j_tpu_torch.utils.model_serializer import (
        restore_multi_layer_network)

    text = _lm(sgd=False)
    p0 = _np(JNet(_jconf(text)).init().params_list)
    batches = _lm_batches(2)
    net = from_jax(text, p0, device="cpu")
    log = ParamAndGradientIterationListener(print_mean_magnitudes=False)
    net.set_listeners(CheckpointListener(str(tmp_path), every_n_iterations=1,
                                         every_n_epochs=None), log)
    pw = (ParallelWrapper.builder(net)
          .mesh(build_mesh({"data": 1, "model": 1}))
          .prefetch_buffer(0).sharding("dp_tp").build())
    pw.fit(ListDataSetIterator([DataSet(x, y) for x, y in batches]))
    assert net.iteration == 2 and len(log.rows) == 2
    assert pw.stats()["whole_views"] == 2
    assert pw.stats()["whole_view_bytes"] > 0
    back = restore_multi_layer_network(
        str(tmp_path / "checkpoint_iter_2.zip"), device="cpu")
    _same_state(back, {"params": to_numpy(net.params_list),
                       "updater": to_numpy(net.updater_state)})
    row = log.rows[-1]
    for i, layer in enumerate(to_numpy(net.params_list)):
        for k, v in layer.items():
            assert row[f"param_{i}_{k}"] == pytest.approx(
                float(np.mean(np.abs(v))), rel=1e-6)


def _same_state(back, g):
    """A restored network's params and updater state bitwise equal to a
    rank's (numpy trees)."""
    for a, b in zip(back.params_list, g["params"]):
        for k in b:
            np.testing.assert_array_equal(a[k].detach().numpy(), b[k])
    for a, b in zip(back.updater_state, g["updater"]):
        for k in b:
            for slot in b[k]:
                np.testing.assert_array_equal(
                    a[k][slot].detach().numpy(), b[k][slot])


def test_group_of_one_equals_fit():
    """``{data: 1, model: 1}`` without a process group: every Megatron pair
    and gathered leaf on one rank, equal to the network's own steps, and
    the leaves whole again after fit."""
    from deeplearning4j_tpu_torch.convert import from_jax
    from deeplearning4j_tpu_torch.datasets import DataSet, ListDataSetIterator
    from deeplearning4j_tpu_torch.parallel import ParallelWrapper
    from deeplearning4j_tpu_torch.parallel.mesh import build_mesh

    text = _lm(sgd=False)
    p0 = _np(JNet(_jconf(text)).init().params_list)
    batches = _lm_batches(2)
    a = from_jax(text, p0, device="cpu")
    for x, y in batches:
        a.fit(x, y)
    b = from_jax(text, p0, device="cpu")
    pw = (ParallelWrapper.builder(b).mesh(build_mesh({"data": 1, "model": 1}))
          .prefetch_buffer(0).sharding("dp_tp").build())
    pw.fit(ListDataSetIterator([DataSet(x, y) for x, y in batches]))
    assert pw._sync_step.sharding.megatron[1] == {"W1", "W2", "Wo", "Wqkv",
                                                  "b1"}
    for da, db in zip(a.params_list, b.params_list):
        for k in da:
            np.testing.assert_allclose(db[k].detach().numpy(),
                                       da[k].detach().numpy(), atol=2e-6)
