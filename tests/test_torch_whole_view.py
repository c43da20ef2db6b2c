"""A sharded fit's state seen whole, and a restore onto a sharding, on gloo
CPU ranks (``tests/_torch_dist.py``).

The JAX package's arrays are global: its listeners read a sharded fit's
params and updater state whole, and ``restore_sharded(shardings=)`` places
each leaf on its sharding as it is read (``tests/test_sharded_checkpoint.py``
``test_restore_onto_mesh_sharding``). The port holds blocks on each rank:

- **Whole views.** A zip ``CheckpointListener`` and
  ``ParamAndGradientIterationListener`` inside a fit on two ranks, for each
  placement that holds blocks between steps: ``dp_tp`` on ``{data: 1,
  model: 2}``, ``zero3``, FSDP and ZeRO-1 on ``{data: 2}``, and
  ``PipelineTrainer`` on ``{stage: 2}``. The last iteration's zip, restored
  whole, is bitwise the params and updater state the fit leaves on every
  rank, which are bitwise those of the same fit without the listeners;
  every step starts with the placement and held bytes it had before; rank
  0 alone keeps the param log; the fit counts its views.
- **Restore onto a sharding.** A checkpoint saved whole and one saved by a
  ``dp_tp`` fit (blocks, ``Wqkv`` in its ``@groups3`` layout), restored
  onto the ``dp_tp`` rules' specs on ``{data: 1, model: 2}``: each rank's
  blocks (params and Adam's slots) bitwise the saved leaves' slices, own
  blocks read alone where the saved split matches, the whole tensors
  without storage, ``output`` bitwise a whole restore's (gathered at use,
  given back after), and a ``dp_tp`` fit from it bitwise the same fit from
  a whole restore. On four ranks, JAX's ``model: 8`` case: every 2-D
  leaf's output dim over ``{model: 4}``.

The configs are the JAX package's transformer LM (``convert.from_jax``
weights). The JAX package's own ``dp_tp`` fit with a zip
``CheckpointListener`` writes the zip its listener sees; the port's is
held to it within JAX's ``dp_tp`` tolerance (atol 1e-4, rtol 1e-4, the
model axis reordering sums), on SGD as ``test_torch_tensor_parallel.py``
holds its fits against JAX.
"""
import json
import os

import numpy as np
import pytest

import _torch_dist
from _torch_port import compile_cache_at, jax_train, no_executable_cache
from deeplearning4j_tpu.models import transformer_lm as jtransformer_lm
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JNet
from deeplearning4j_tpu_torch.convert import from_jax, to_numpy
from deeplearning4j_tpu_torch.optimize.listeners import CheckpointListener
from deeplearning4j_tpu_torch.parallel.mesh import build_mesh
from deeplearning4j_tpu_torch.parallel.partition import PartitionSpec as P
from deeplearning4j_tpu_torch.utils.model_serializer import (
    restore_multi_layer_network)
from deeplearning4j_tpu_torch.utils.sharded_checkpoint import (
    restore_sharded, save_sharded)

VOCAB, WIDTH, HEADS, T, B = 8, 32, 4, 16, 8
STEPS = 3
#: C6: the mesh of the specs that split two dims
TWO_DIM_AXES = {"data": 2, "model": 2}
#: the ZeRO fit under those specs against one device's fit (the port's:
#: the reduce-scatter sums the batch's halves; JAX's: its tolerance for a
#: transformer's parallel fit, DEEP_JAX_* of test_torch_parallel.py)
TWO_DIM_ATOL, TWO_DIM_JAX_ATOL, TWO_DIM_JAX_RTOL = 2e-5, 5e-5, 1e-4

#: (name, mesh, wrapper knobs or None for the pipeline, held parts)
VIEW_MODES = (
    ("dp_tp", {"data": 1, "model": 2}, [("sharding", ("dp_tp",))],
     ("params", "updater")),
    ("zero3", {"data": 2}, [("sharding", ("zero3",))],
     ("params", "updater")),
    ("fsdp", {"data": 2}, [("shard_parameters", ())],
     ("params", "updater")),
    ("zero1", {"data": 2}, [("shard_optimizer_state", ())], ("updater",)),
    ("pipeline", {"stage": 2}, None, ("params", "updater")),
)


def _np(tree):
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_np(v) for v in tree]
    return np.asarray(tree)


def _lm_batches(n, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        ids = rng.integers(0, VOCAB, size=(B, T + 1))
        out.append((np.eye(VOCAB, dtype=np.float32)[ids[:, :-1]],
                    np.eye(VOCAB, dtype=np.float32)[ids[:, 1:]]))
    return out


def _conf(n_layers):
    return jtransformer_lm(VOCAB, width=WIDTH, n_layers=n_layers,
                           n_heads=HEADS, max_len=T,
                           learning_rate=0.01).to_json()


def _sgd(text, lr=0.1):
    d = json.loads(text)
    d["global_conf"].update(updater="sgd", learning_rate=lr)
    for layer in d["layers"]:
        layer.update(updater="sgd", learning_rate=lr, bias_learning_rate=lr)
    return json.dumps(d)


def _jax_dp_tp_zip(text, batches, directory, cache):
    """The JAX package's dp_tp fit on {data: 1, model: 2} (its first two
    of the conftest's 8 CPU devices) with a zip CheckpointListener at the
    last iteration; returns the zip's path."""
    from deeplearning4j_tpu.datasets.dataset import DataSet as JDataSet
    from deeplearning4j_tpu.datasets.iterators import (
        ListDataSetIterator as JList)
    from deeplearning4j_tpu.nn.conf.multilayer import (
        MultiLayerConfiguration as JConf)
    from deeplearning4j_tpu.optimize.listeners import (
        CheckpointListener as JCheckpointListener)
    from deeplearning4j_tpu.parallel.mesh import build_mesh as jbuild_mesh
    from deeplearning4j_tpu.parallel.wrapper import ParallelWrapper as JPW
    with compile_cache_at(cache), no_executable_cache():
        jnet = JNet(JConf.from_json(text)).init()
        jnet.set_listeners(JCheckpointListener(
            directory, every_n_iterations=len(batches), every_n_epochs=None))
        (JPW.builder(jnet).mesh(jbuild_mesh({"data": 1, "model": 2}))
         .prefetch_buffer(0).sharding("dp_tp").build()
         .fit(JList([JDataSet(x, y) for x, y in batches])))
    return os.path.join(directory, f"checkpoint_iter_{len(batches)}.zip")


def _same(a, b):
    """Two numpy trees bitwise equal."""
    if isinstance(a, dict):
        assert sorted(a) == sorted(b)
        for k in a:
            _same(a[k], b[k])
    elif isinstance(a, list):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    text = _conf(4)
    p0 = _jinit(text)
    batches = _lm_batches(STEPS)
    ref = {"text": text, "p0": p0, "batches": batches, "dirs": {}}
    jobs2 = []
    for name, axes, knobs, _parts in VIEW_MODES:
        d = str(tmp_path_factory.mktemp(f"view_{name}"))
        ref["dirs"][name] = d
        extra = ({"n_micro": 2} if knobs is None else {"knobs": knobs})
        jobs2.append((name, dict(job="whole_view", conf_json=text, params=p0,
                                 batches=batches, directory=d, axes=axes,
                                 **extra)))
        if knobs is None:
            jobs2.append((f"{name}_plain", dict(
                job="pipeline", conf_json=text, params=p0, batches=batches,
                axes=axes, n_micro=2)))
        else:
            jobs2.append((f"{name}_plain", dict(
                job="wrapper", conf_json=text, params=p0, batches=batches,
                axes=axes, knobs=knobs, ksteps=1)))
    # the JAX package's dp_tp fit with a zip listener, and the port's
    sgd = _sgd(text)
    ref["jax_zip"] = _jax_dp_tp_zip(
        sgd, batches, str(tmp_path_factory.mktemp("jax_zip")),
        tmp_path_factory.mktemp("xcache"))
    ref["dirs"]["dp_tp_sgd"] = str(tmp_path_factory.mktemp("view_sgd"))
    jobs2.append(("dp_tp_sgd", dict(
        job="whole_view", conf_json=sgd, params=p0, batches=batches,
        directory=ref["dirs"]["dp_tp_sgd"], axes={"data": 1, "model": 2},
        knobs=[("sharding", ("dp_tp",))])))
    # the checkpoints to restore: saved whole after 2 steps, and saved by a
    # dp_tp fit of those 2 steps (its blocks)
    small = _conf(2)
    sp0 = _jinit(small)
    net = from_jax(small, sp0, device="cpu")
    for x, y in batches[:2]:
        net.fit(x, y)
    whole_dir = save_sharded(str(tmp_path_factory.mktemp("whole") / "ck"),
                             net)
    tp_dir = str(tmp_path_factory.mktemp("tp"))
    _torch_dist.run(2, [("ck", dict(
        job="checkpoint", conf_json=small, params=sp0, batches=batches[:2],
        directory=tp_dir, axes={"data": 1, "model": 2},
        knobs=[("sharding", ("dp_tp",))]))])
    tp_dir = CheckpointListener.last_checkpoint(tp_dir)
    x = batches[2][0]
    ref.update(small=small, sp0=sp0, x=x,
               restore_dirs={"whole": whole_dir, "tp": tp_dir})
    for how, d in ref["restore_dirs"].items():
        jobs2.append((f"restore_{how}", dict(
            job="restore_onto", conf_json=small, params=sp0, directory=d,
            axes={"data": 1, "model": 2}, x=x, rules="dp_tp",
            batches=batches[2:], knobs=[("sharding", ("dp_tp",))])))
    # JAX's model: 8 case on four ranks: every 2-D leaf's output dim split
    specs = [{k: (P(None, "model") if np.ndim(v) == 2
                  and np.shape(v)[1] % 4 == 0 else P())
              for k, v in layer.items()} for layer in sp0]
    ref["specs4"] = specs
    jobs4 = [("restore", dict(job="restore_onto", conf_json=small,
                              params=sp0, directory=whole_dir,
                              axes={"model": 4}, x=x, specs=specs))]
    # C6: specs that split two dims, on {data: 2, model: 2}: a restore onto
    # them, and the ZeRO placement (params and Adam's state) under them
    specs2 = [{k: (("data", "model") if np.ndim(v) == 2 else ())
               for k, v in layer.items()} for layer in sp0]
    ref["specs2"] = specs2
    jobs4.append(("restore2d", dict(
        job="restore_onto", conf_json=small, params=sp0, directory=whole_dir,
        axes=TWO_DIM_AXES, x=x,
        specs=[{k: P(*v) for k, v in layer.items()} for layer in specs2])))
    jobs4.append(("zero2d", dict(
        job="wrapper", conf_json=small, params=sp0, batches=batches[:2],
        axes=TWO_DIM_AXES, zero_specs=specs2,
        knobs=[("shard_parameters", ()), ("shard_optimizer_state", ())])))
    jobs4.append(("zero2d_single", dict(
        job="wrapper", conf_json=small, params=sp0, batches=batches[:2],
        single=True)))
    with compile_cache_at(tmp_path_factory.mktemp("xcache2")), \
            no_executable_cache():
        ref["jax_fit2"] = jax_train(
            small, [(x_, y_, None, None) for x_, y_ in batches[:2]],
            tmp_path_factory.mktemp("xcache3"))
    ranks = {2: _torch_dist.run(2, jobs2, timeout=300),
             4: _torch_dist.run(4, jobs4, timeout=300)}
    return ref, ranks


def _jinit(text):
    from deeplearning4j_tpu.nn.conf.multilayer import (
        MultiLayerConfiguration as JConf)
    return _np(JNet(JConf.from_json(text)).init().params_list)


@pytest.mark.parametrize("name,parts", [(m[0], m[3]) for m in VIEW_MODES])
def test_listeners_read_a_whole_view(run, name, parts):
    ref, ranks = run
    got = [r[name] for r in ranks[2]]
    d = ref["dirs"][name]
    back = restore_multi_layer_network(
        os.path.join(d, f"checkpoint_iter_{STEPS}.zip"), device="cpu")
    for g, plain in zip(got, [r[f"{name}_plain"] for r in ranks[2]]):
        assert g["iteration"] == STEPS
        # the zip of the last iteration is the state the fit leaves, which
        # is the state of the same fit without these listeners
        _same(to_numpy(back.params_list), g["params"])
        _same(to_numpy(back.updater_state), g["updater"])
        _same(g["params"], plain["params"])
        _same(g["updater"], plain["updater"])
        # a view each iteration the param log fires at (the zip alone,
        # once, where only the updater is held)
        assert g["views"] == (STEPS if "params" in parts else 1)
        assert g["view_bytes"] > 0
        # every step found the placement as the first did
        assert all(h == g["holds"][0] for h in g["holds"])
        if "params" in parts:
            assert g["holds"][0]["min_storage"] == 0
    # rank 0 keeps the log and writes the files
    assert len(got[0]["rows"]) == STEPS and got[1]["rows"] == []
    last = got[0]["rows"][-1]
    for i, layer in enumerate(got[0]["params"]):
        for k, v in layer.items():
            assert last[f"param_{i}_{k}"] == pytest.approx(
                float(np.mean(np.abs(v))), rel=1e-6)
    assert sorted(f for f in os.listdir(d) if f.endswith(".zip")) == [
        f"checkpoint_iter_{STEPS}.zip", "latest.zip"]


def test_whole_view_zip_equals_jax_listeners_zip(run):
    """The zip a listener writes inside the port's dp_tp fit against the
    one the JAX package's listener writes inside its own, both restored by
    the port (the zip format is shared)."""
    ref, ranks = run
    mine = restore_multi_layer_network(os.path.join(
        ref["dirs"]["dp_tp_sgd"], f"checkpoint_iter_{STEPS}.zip"),
        device="cpu")
    theirs = restore_multi_layer_network(ref["jax_zip"], device="cpu")
    assert mine.iteration == theirs.iteration == STEPS
    for a, b in zip(to_numpy(mine.params_list), to_numpy(theirs.params_list)):
        for k in b:
            np.testing.assert_allclose(a[k], b[k], atol=1e-4, rtol=1e-4,
                                       err_msg=k)
    _same(to_numpy(mine.params_list), ranks[2][0]["dp_tp_sgd"]["params"])


@pytest.mark.parametrize("how", ["whole", "tp"])
def test_restore_onto_dp_tp_sharding(run, how):
    ref, ranks = run
    whole = restore_sharded(ref["restore_dirs"][how], device="cpu")
    out = whole.output(ref["x"]).detach().numpy()
    own = 0
    for rank, r in enumerate(ranks[2]):
        g = r[f"restore_{how}"]
        assert g["iteration"] == 2
        for key, (block, dim) in g["blocks"].items():
            parts = key.split("/")
            layer, name = int(parts[0]), parts[1]
            t = (whole.params_list[layer][name] if len(parts) == 2
                 else whole.updater_state[layer][name][parts[2]])
            np.testing.assert_array_equal(
                block, t.detach().movedim(dim, 0).chunk(2)[rank].numpy(),
                err_msg=key)
            assert g["storage"].get(key, 0) == 0
        # the blocks of Wqkv, W1, b1, Wo, W2 of both blocks and the rest
        # of the rules' split leaves, and Adam's two slots of each
        assert len(g["blocks"]) == 3 * sum(
            1 for k in g["storage"] if g["storage"][k] == 0)
        np.testing.assert_array_equal(g["output"], out)
        np.testing.assert_array_equal(g["output_again"], out)
        assert g["storage_after_output"] == 0 and g["views"] == 2
        own += g["reads"]["own_blocks"]
        fit = g["fit"]
        _same(fit["sharded"]["params"], fit["whole"]["params"])
        _same(fit["sharded"]["updater"], fit["whole"]["updater"])
        assert fit["sharded"]["scores"] == fit["whole"]["scores"]
        assert fit["sharded"]["held"]  # the fit ends whole, no placement
    if how == "whole":
        assert own == 0  # a leaf saved whole is read whole
    else:
        # the dp_tp fit saved every split leaf but Wqkv in the spec's
        # layout: those blocks are read alone
        assert own == 2 * (len(g["blocks"]) - 6)


def test_restore_onto_four_ranks_model_axis(run):
    ref, ranks = run
    whole = restore_sharded(ref["restore_dirs"]["whole"], device="cpu")
    out = whole.output(ref["x"]).detach().numpy()
    for rank, r in enumerate(ranks[4]):
        g = r["restore"]
        split = {f"{i}/{k}" for i, layer in enumerate(ref["specs4"])
                 for k, s in layer.items() if s}
        assert {k for k in g["blocks"] if k.count("/") == 1} == split
        for key, (block, dim) in g["blocks"].items():
            parts = key.split("/")
            t = (whole.params_list[int(parts[0])][parts[1]]
                 if len(parts) == 2 else
                 whole.updater_state[int(parts[0])][parts[1]][parts[2]])
            np.testing.assert_array_equal(
                block, t.detach().movedim(dim, 0).chunk(4)[rank].numpy())
        np.testing.assert_array_equal(g["output"], out)


def test_restore_onto_refuses_a_device_mesh_and_half_a_placement(tmp_path):
    text = _conf(2)
    net = from_jax(text, _jinit(text), device="cpu")
    d = save_sharded(str(tmp_path / "ck"), net)
    with pytest.raises(ValueError, match="make_predict_fn"):
        restore_sharded(d, net, shardings=P(),
                        mesh=build_mesh({"data": 2}, devices=["cpu"] * 2))
    with pytest.raises(ValueError, match="both"):
        restore_sharded(d, net, shardings=P())
    with pytest.raises(ValueError, match="both"):
        restore_sharded(d, net, mesh=build_mesh({"data": 1}))


def test_restore_onto_a_group_of_one(tmp_path):
    """``{model: 1}`` with no process group: every block is the whole
    leaf, held as a block; ``output`` reads a view, any other entry point
    settles the network whole for good, and a fit goes on from it bitwise
    as from a whole restore."""
    text = _conf(2)
    p0 = _jinit(text)
    net = from_jax(text, p0, device="cpu")
    x, y = _lm_batches(1)[0]
    net.fit(x, y)
    d = save_sharded(str(tmp_path / "ck"), net)
    mesh = build_mesh({"model": 1})
    got = from_jax(text, p0, device="cpu")
    restore_sharded(d, got, shardings=P(None, "model"), mesh=mesh)
    held = got._held_sharding
    assert held is not None and held.held_parts() == {"params", "updater"}
    np.testing.assert_array_equal(got.output(x).numpy(),
                                  net.output(x).numpy())
    assert held.views == 1 and got._held_sharding is held
    got.fit(x, y)  # settles first
    assert got._held_sharding is None
    net.fit(x, y)
    _same(to_numpy(got.params_list), to_numpy(net.params_list))


def _jax_blocks(leaf, spec):
    """Each of the four devices' block of ``leaf`` under ``spec`` as JAX's
    ``NamedSharding`` lays it out on the first four of the 8 CPU devices
    (``TWO_DIM_AXES``), in the mesh's row-major order."""
    import jax
    from jax.sharding import Mesh as JMesh, NamedSharding, PartitionSpec as JP
    devs = np.array(jax.devices()[:4]).reshape(2, 2)
    placed = jax.device_put(leaf, NamedSharding(JMesh(devs, ("data",
                                                             "model")),
                                                JP(*spec)))
    by_dev = {s.device: np.asarray(s.data) for s in placed.addressable_shards}
    return [by_dev[d] for d in devs.reshape(-1)]


def test_restore_onto_two_dim_spec(run):
    """C6: a restore onto specs that split two dims (``P("data",
    "model")``) on four ranks: each rank holds JAX's ``NamedSharding``
    block of each leaf (the updater slots cut as their params) bitwise,
    the whole tensors give their storage back, and ``output`` is a whole
    restore's bitwise."""
    ref, ranks = run
    whole = restore_sharded(ref["restore_dirs"]["whole"], device="cpu")
    out = whole.output(ref["x"]).detach().numpy()
    for rank, r in enumerate(ranks[4]):
        g = r["restore2d"]
        assert not g["blocks"]  # every split leaf is split on two dims
        want_keys = set()
        for i, layer in enumerate(ref["specs2"]):
            for k, spec in layer.items():
                if not spec:
                    continue
                leaves = {f"{i}/{k}": whole.params_list[i][k]}
                leaves.update({f"{i}/{k}/{s}": t for s, t in
                               whole.updater_state[i][k].items()})
                for key, t in leaves.items():
                    want_keys.add(key)
                    np.testing.assert_array_equal(
                        g["grid_blocks"][key],
                        _jax_blocks(t.detach().numpy(), spec)[rank],
                        err_msg=key)
                assert g["storage"][f"{i}/{k}"] == 0
        assert set(g["grid_blocks"]) == want_keys
        np.testing.assert_array_equal(g["output"], out)
        np.testing.assert_array_equal(g["output_again"], out)


def test_zero_placement_two_dim_spec(run):
    """C6: the ZeRO placement (params and Adam's state split at rest) under
    specs that split two dims, on four ranks: each rank's param shards are
    JAX's ``NamedSharding`` blocks of the fit's params, bitwise; the fit
    equals one device's fit (the port's within TWO_DIM_ATOL, JAX's within
    its parallel-fit tolerance) and is the same on every rank."""
    ref, ranks = run
    single = ranks[4][0]["zero2d_single"]["params"]
    jax_params = ref["jax_fit2"]["params"]
    for rank, r in enumerate(ranks[4]):
        got = r["zero2d"]
        for i, layer in enumerate(ref["specs2"]):
            for k, spec in layer.items():
                np.testing.assert_array_equal(
                    got["params"][i][k], ranks[4][0]["zero2d"]["params"][i][k])
                np.testing.assert_allclose(got["params"][i][k], single[i][k],
                                           atol=TWO_DIM_ATOL, err_msg=k)
                np.testing.assert_allclose(
                    got["params"][i][k], jax_params[i][k],
                    atol=TWO_DIM_JAX_ATOL, rtol=TWO_DIM_JAX_RTOL, err_msg=k)
                if spec:
                    np.testing.assert_array_equal(
                        got["shards"][f"{i}/{k}"],
                        _jax_blocks(got["params"][i][k], spec)[rank])
        assert got["iteration"] == 2


def test_two_dim_blocks_stored_and_joined_whole():
    """C6: the checkpoint keys of a leaf split on two dims name both
    (``@shard<i>of<n>@dim<d>`` a dim), and the stored blocks join back
    into the leaf bitwise."""
    import types
    import torch
    from deeplearning4j_tpu_torch.parallel.partition import block_of
    from deeplearning4j_tpu_torch.utils.sharded_checkpoint import (
        _join, _layout, stored_block)
    leaf = torch.arange(8 * 6 * 4, dtype=torch.float32).reshape(8, 6, 4)
    splits = ((0, ("data",)), (2, ("model",)))
    flat = {}
    for coords in ({"data": 0, "model": 0}, {"data": 0, "model": 1},
                   {"data": 1, "model": 0}, {"data": 1, "model": 1}):
        mesh = types.SimpleNamespace(
            axis_size=lambda *a: 2 ** len(a),
            index=lambda *a, c=coords: int(np.ravel_multi_index(
                [c[x] for x in a], [2] * len(a))))
        suffix, block = stored_block(block_of(leaf, splits, mesh), splits,
                                     mesh)
        assert suffix == (f"@shard{coords['data']}of2@dim0"
                          f"@shard{coords['model']}of2@dim2")
        flat["params/0/W" + suffix] = block
    entry = _layout(flat)["params/0/W"]
    assert entry[:2] == (((2, 0), (2, 2)), 1)
    assert torch.equal(_join("params/0/W", entry, flat, "here"), leaf)
