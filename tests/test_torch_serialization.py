"""The port's model files (``utils/model_serializer.py``), the flat tree
order (``utils/pytree.py``), the normalizers and the YAML config, held
against the JAX package on the CPU.

- The committed golden zips (written by the JAX serializer) restore in the
  port: outputs within the JAX golden test's own bound (rtol 1e-6, atol
  1e-7; the two packages' float32 dense forwards of these 6-10-3 and
  two-input nets agree to 9e-8), and the flat updater state bitwise, which
  holds only if the port's flat order is the JAX pytree order.
- A JAX ``write_model`` after 2 steps restores in the port with every leaf
  and the counters bitwise, and the port's next 2 steps from the zip follow
  the JAX network's next 2 steps: a small LeNet (Nesterov) within 1e-5
  relative (losses) and atol 1e-5 (params), as ``test_torch_lenet.py``
  holds LeNet; ResNet-18 at 32x32 (B = 4, Nesterov at 0.01, batch norm's
  running state in the zip) within 1e-4 relative (losses) and, as
  ``test_torch_resnet.py`` bounds a 2-step trajectory, 0.25 of the
  distance the params moved (the JAX ``fit``'s jitted XLA:CPU step
  computes some deep batch-norm gradients off its own un-jitted gradient):
  0.047 was seen, and 0.98 (second loss 4.55 against 7.53) with the zip's
  updater state left out. The config's own rate 0.1 at B = 4 sends
  ResNet-18's loss from 2.4 to 9.3 in one step, where float32 rounding
  alone parts the two packages' trajectories, so the resume runs at 0.01.
- A zip the port writes restores in the JAX package with the same leaves
  bitwise and outputs within atol 1e-5 of the port's (LeNet, a graph and
  the MoE LM of ``lm_golden.zip`` after 2 steps).
- ``lm_golden.zip`` restores with the JAX golden test's bound (1e-5).
- A bf16 leaf is stored as 16-bit patterns (``'V2'``) and read back bitwise
  into a bf16 template; another template raises.
- ``to_yaml`` is the JAX ``to_yaml`` text, and reads back in either package.
"""
import io
import json
import os
import zipfile

import numpy as np
import pytest
import torch

from _torch_port import _np_tree as _np
from _torch_port import compile_cache_at
from deeplearning4j_tpu.datasets.dataset import (
    NormalizerMinMaxScaler as JMinMax)
from deeplearning4j_tpu.datasets.dataset import (
    NormalizerStandardize as JStandardize)
from deeplearning4j_tpu.datasets.dataset import DataSet as JDataSet
from deeplearning4j_tpu.models.lenet import lenet_mnist as jax_lenet
from deeplearning4j_tpu.models.resnet import resnet18 as jax_resnet18
from deeplearning4j_tpu.nn.conf.builders import NeuralNetConfiguration as JNNC
from deeplearning4j_tpu.nn.conf.inputs import InputType as JInputType
from deeplearning4j_tpu.nn.conf.layers import (
    ConvolutionLayer, DenseLayer, OutputLayer, SubsamplingLayer)
from deeplearning4j_tpu.nn.conf.multilayer import (
    MultiLayerConfiguration as JConf)
from deeplearning4j_tpu.nn.graph_network import ComputationGraph as JGraph
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JNet
from deeplearning4j_tpu.utils import model_serializer as jser
from deeplearning4j_tpu.utils.pytree import flatten_params as jflatten
from deeplearning4j_tpu_torch.convert import to_numpy
from deeplearning4j_tpu_torch.datasets.dataset import (
    DataSet, NormalizerMinMaxScaler, NormalizerStandardize)
from deeplearning4j_tpu_torch.models import lenet_mnist
from deeplearning4j_tpu_torch.nn.conf.multilayer import MultiLayerConfiguration
from deeplearning4j_tpu_torch.nn.graph_network import ComputationGraph
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.utils import model_serializer as ser
from deeplearning4j_tpu_torch.utils import pytree

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
LENET_REL, LENET_ATOL = 1e-5, 1e-5
RES_REL, RES_MOVED_REL = 1e-4, 0.25


def _leaves(tree):
    return [(k, np.asarray(v)) for k, v in pytree.leaves_with_paths(tree)]


def _assert_same_leaves(ours, ref):
    a, b = _leaves(to_numpy(ours)), _leaves(_np(ref))
    assert [k for k, _ in a] == [k for k, _ in b]
    for (k, x), (_, y) in zip(a, b):
        assert x.dtype == y.dtype and x.shape == y.shape, k
        np.testing.assert_array_equal(x, y, err_msg=str(k))


# ------------------------------------------------------------ flat order
def test_flat_order_is_the_jax_pytree_order():
    rng = np.random.default_rng(0)

    def r(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    tree = {"b": [{"W": r(2, 3), "a": r(2)}, {}],
            "a": {"z": r(1), "y": [r(4)]}, "c": None}
    ours = pytree.flatten_params(tree).numpy()
    np.testing.assert_array_equal(ours, np.asarray(jflatten(tree, None)))
    assert pytree.num_params(tree) == ours.size == 13
    back = pytree.unflatten_params(pytree.tree_map(torch.as_tensor, tree),
                                   torch.from_numpy(ours))
    _assert_same_leaves(back, tree)
    with pytest.raises(ValueError, match="Flat vector length"):
        pytree.unflatten_params(tree, torch.zeros(14))
    avg = pytree.tree_average([{"a": torch.ones(2)}, {"a": torch.zeros(2)}])
    assert torch.equal(avg["a"], torch.full((2,), 0.5))
    assert pytree.flatten_params({}).shape == (0,)


# ------------------------------------------------------------- normalizers
def test_normalizers_match_jax():
    x = np.random.default_rng(1).normal(2.0, 3.0, (20, 3, 4)).astype(np.float32)
    for jcls, tcls in ((JStandardize, NormalizerStandardize),
                       (JMinMax, NormalizerMinMaxScaler)):
        jn, tn = jcls(), tcls()
        jd, td = JDataSet(x.copy(), x[:, 0]), DataSet(x.copy(), x[:, 0])
        jn.fit(jd)
        tn.fit(td)
        jn.transform(jd)
        tn.transform(td)
        np.testing.assert_array_equal(td.features, jd.features)
        back = tcls.from_arrays(tn.to_arrays())
        back.revert(td)
        np.testing.assert_allclose(td.features, x, rtol=0, atol=1e-5)


# ------------------------------------------------------------ golden zips
def test_golden_zips_restore_with_the_jax_outputs_and_updater_state():
    exp = np.load(os.path.join(GOLDEN, "golden_expected.npz"))
    path = os.path.join(GOLDEN, "mln_golden.zip")
    net = ser.restore_multi_layer_network(path, device="cpu")
    norm = ser.restore_normalizer(path)
    assert isinstance(norm, NormalizerStandardize)
    ds = DataSet(exp["mln_in"].copy(),
                 np.zeros((len(exp["mln_in"]), 3), np.float32))
    norm.transform(ds)
    np.testing.assert_allclose(net.output(ds.features).numpy(), exp["mln_out"],
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_array_equal(
        pytree.flatten_params(net.updater_state, torch.float32).numpy(),
        exp["mln_updater_flat"])
    assert net.iteration == 3 and net.epoch == 0

    cg = ser.restore_computation_graph(os.path.join(GOLDEN, "cg_golden.zip"),
                                       device="cpu")
    out = cg.output(exp["cg_in_a"], exp["cg_in_b"])[0].numpy()
    np.testing.assert_allclose(out, exp["cg_out"], rtol=1e-6, atol=1e-7)
    np.testing.assert_array_equal(
        pytree.flatten_params(cg.updater_state, torch.float32).numpy(),
        exp["cg_updater_flat"])
    assert ser.restore_normalizer(os.path.join(GOLDEN, "cg_golden.zip")) is None


def test_guess_model_picks_the_type(tmp_path):
    assert type(ser.guess_model(os.path.join(GOLDEN, "mln_golden.zip"),
                                device="cpu")) is MultiLayerNetwork
    assert type(ser.guess_model(os.path.join(GOLDEN, "cg_golden.zip"),
                                device="cpu")) is ComputationGraph
    # without meta.json the config's "@type" decides
    for name, cls in (("mln_golden.zip", MultiLayerNetwork),
                      ("cg_golden.zip", ComputationGraph)):
        bare = tmp_path / name
        with zipfile.ZipFile(os.path.join(GOLDEN, name)) as src, \
                zipfile.ZipFile(bare, "w") as dst:
            for entry in src.namelist():
                if entry != ser.META_ENTRY:
                    dst.writestr(entry, src.read(entry))
        net = ser.guess_model(str(bare), device="cpu")
        assert type(net) is cls and net.iteration == 0


# ---------------------------------------------------- JAX zip -> the port
def _small_lenet():
    return (JNNC.builder().seed(11).learning_rate(0.05).updater("nesterovs")
            .momentum(0.9).weight_init("xavier").list()
            .layer(ConvolutionLayer(n_out=4, kernel_size=(5, 5),
                                    stride=(1, 1), activation="identity"))
            .layer(SubsamplingLayer(pooling_type="max", kernel_size=(2, 2),
                                    stride=(2, 2)))
            .layer(ConvolutionLayer(n_out=6, kernel_size=(5, 5),
                                    stride=(1, 1), activation="identity"))
            .layer(SubsamplingLayer(pooling_type="max", kernel_size=(2, 2),
                                    stride=(2, 2)))
            .layer(DenseLayer(n_out=32, activation="relu"))
            .layer(OutputLayer(n_out=10, loss="mcxent", activation="softmax"))
            .set_input_type(JInputType.convolutional_flat(28, 28, 1))
            .build())


def _small_lenet_port():
    return MultiLayerConfiguration.from_json(_small_lenet().to_json())


def _digits(rng, n=16):
    x = rng.random((n, 784)).astype(np.float32)
    return x, np.eye(10, dtype=np.float32)[rng.integers(0, 10, n)]


def _res_batch(rng, n=4, size=32):
    x = rng.standard_normal((n, size, size, 3)).astype(np.float32)
    return [x], [np.eye(10, dtype=np.float32)[rng.integers(0, 10, n)]]


def _jax_resume(kind, tmp_path):
    """A JAX network after 2 steps written to a zip, then its next 2 steps:
    the zip, the JAX leaves at the write and the next 2 losses and params."""
    rng = np.random.default_rng(5)
    if kind == "lenet":
        batches = [_digits(rng) for _ in range(4)]
        make = lambda: JNet(_small_lenet()).init()
    else:
        batches = [_res_batch(rng) for _ in range(4)]
        make = lambda: JGraph(jax_resnet18(n_classes=10, image_size=32,
                                           learning_rate=0.01)).init()
    path = str(tmp_path / f"{kind}.zip")
    with compile_cache_at(tmp_path / "xcache"):
        jnet = make()
        for x, y in batches[:2]:
            jnet.fit(x, y)
        jser.write_model(jnet, path)
        at_write = {"params": _np(jnet.params_list),
                    "state": _np(jnet.state_list),
                    "upd": _np(jnet.updater_state)}
        losses = []
        for x, y in batches[2:]:
            jnet.fit(x, y)
            losses.append(float(jnet.score_value))
        after = {"params": _np(jnet.params_list), "losses": losses,
                 "iteration": jnet.iteration}
    return path, batches, at_write, after


def _moved_rel(ours, ref, init):
    a, b, c = (np.concatenate([v.ravel() for _, v in _leaves(t)])
               for t in (ours, ref, init))
    return float(np.linalg.norm(a - b) / np.linalg.norm(b - c))


@pytest.mark.parametrize("kind", ["lenet", "resnet18"])
def test_jax_zip_restores_and_resumes_in_the_port(kind, tmp_path):
    path, batches, at_write, after = _jax_resume(kind, tmp_path)
    net = ser.guess_model(path, device="cpu")
    assert type(net) is (MultiLayerNetwork if kind == "lenet"
                         else ComputationGraph)
    _assert_same_leaves(net.params_list, at_write["params"])
    _assert_same_leaves(net.state_list, at_write["state"])
    _assert_same_leaves(net.updater_state, at_write["upd"])
    assert net.iteration == 2 and net.epoch == 0
    losses = []
    for x, y in batches[2:]:
        net.fit(x, y)
        losses.append(net.score_value)
    assert net.iteration == after["iteration"] == 4
    if kind == "lenet":
        np.testing.assert_allclose(losses, after["losses"], rtol=LENET_REL)
        for own, ref in zip(to_numpy(net.params_list), after["params"]):
            for k in ref:
                np.testing.assert_allclose(own[k], ref[k], rtol=0,
                                           atol=LENET_ATOL, err_msg=k)
    else:
        np.testing.assert_allclose(losses, after["losses"], rtol=RES_REL)
        assert _moved_rel(to_numpy(net.params_list), after["params"],
                          at_write["params"]) <= RES_MOVED_REL


# ---------------------------------------------------- the port's zip -> JAX
@pytest.mark.parametrize("kind", ["lenet", "graph", "moe_lm"])
def test_port_zip_restores_in_jax(kind, tmp_path):
    rng = np.random.default_rng(8)
    if kind == "lenet":
        net = MultiLayerNetwork(_small_lenet_port(), device="cpu").init()
        x, y = _digits(rng)
    elif kind == "moe_lm":
        # the MoE leaves: 3-D expert weights, the router, the aux state
        net = ser.restore_multi_layer_network(
            os.path.join(GOLDEN, "lm_golden.zip"), device="cpu")
        net.iteration = 0
        x = np.eye(8, dtype=np.float32)[rng.integers(0, 8, (4, 6))]
        y = x
    else:
        net = ser.restore_computation_graph(
            os.path.join(GOLDEN, "cg_golden.zip"), device="cpu")
        net.iteration = 0
        x = [rng.standard_normal((8, 4)).astype(np.float32),
             rng.standard_normal((8, 3)).astype(np.float32)]
        y = [np.eye(2, dtype=np.float32)[rng.integers(0, 2, 8)]]
    net.fit(x, y)
    net.fit(x, y)
    path = str(tmp_path / "port.zip")
    norm = NormalizerStandardize()
    norm.fit(DataSet(rng.random((10, 5)).astype(np.float32), None))
    ser.write_model(net, path, normalizer=norm)
    with zipfile.ZipFile(path) as zf:
        assert zf.namelist() == [ser.CONFIG_ENTRY, ser.PARAMS_ENTRY,
                                 ser.MODEL_STATE_ENTRY, ser.UPDATER_ENTRY,
                                 ser.NORMALIZER_ENTRY, ser.META_ENTRY]
        meta = json.loads(zf.read(ser.META_ENTRY))
    assert meta["iteration"] == 2 and meta["model_type"] == type(net).__name__
    with compile_cache_at(tmp_path / "x1"):
        jnet = jser.guess_model(path)
        _assert_same_leaves(net.params_list, jnet.params_list)
        _assert_same_leaves(net.updater_state, jnet.updater_state)
        _assert_same_leaves(net.state_list, jnet.state_list)
        assert jnet.iteration == 2
        jnorm = jser.restore_normalizer(path)
        np.testing.assert_array_equal(jnorm.mean, norm.mean)
        if kind != "graph":
            ref, ours = np.asarray(jnet.output(x)), net.output(x).numpy()
        else:
            ref = np.asarray(jnet.output(*x)[0])
            ours = net.output(*x)[0].numpy()
    np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-5)


def test_restore_without_updater_state(tmp_path):
    net = MultiLayerNetwork(_small_lenet_port(), device="cpu").init()
    x, y = _digits(np.random.default_rng(2))
    net.fit(x, y)
    path = str(tmp_path / "m.zip")
    ser.write_model(net, path, save_updater=False)
    back = ser.restore_multi_layer_network(path, device="cpu")
    _assert_same_leaves(back.params_list, to_numpy(net.params_list))
    # no updater state in the zip: it starts at zero, the counters still come
    assert all(float(v.abs().sum()) == 0
               for _, v in pytree.leaves_with_paths(back.updater_state))
    assert back.iteration == 1
    torch.testing.assert_close(back.output(x), net.output(x), rtol=0, atol=0)


# --------------------------------------------------------------- bfloat16
def test_bf16_leaf_round_trips_bitwise_and_refuses_other_templates():
    g = torch.Generator().manual_seed(0)
    tree = [{"W": torch.randn(3, 5, generator=g).to(torch.bfloat16),
             "b": torch.randn(5, generator=g)}]
    data = ser._tree_to_npz_bytes(tree)
    npz = np.load(io.BytesIO(data))
    assert npz["0/W"].dtype.kind == "V" and npz["0/W"].dtype.itemsize == 2
    back = ser._npz_bytes_to_tree(tree, data, "t")
    assert back[0]["W"].dtype == torch.bfloat16
    assert torch.equal(back[0]["W"].view(torch.int16),
                       tree[0]["W"].view(torch.int16))
    np.testing.assert_array_equal(back[0]["b"], tree[0]["b"].numpy())
    wrong = [{"W": torch.zeros(3, 5), "b": torch.zeros(5)}]
    with pytest.raises(ValueError, match="refusing to reinterpret"):
        ser._npz_bytes_to_tree(wrong, data, "t")
    # the JAX package's bf16 leaf (an ml_dtypes array through np.savez)
    # reads as the same bits
    import ml_dtypes
    jbuf = io.BytesIO()
    bits = tree[0]["W"].view(torch.int16).numpy()
    np.savez(jbuf, **{"0/W": bits.view(ml_dtypes.bfloat16),
                      "0/b": tree[0]["b"].numpy()})
    jback = ser._npz_bytes_to_tree(tree, jbuf.getvalue(), "t")
    assert torch.equal(jback[0]["W"].view(torch.int16),
                       tree[0]["W"].view(torch.int16))
    with pytest.raises(ValueError, match="has no leaf"):
        ser._npz_bytes_to_tree([{"W2": tree[0]["W"]}], data, "t")


# ------------------------------------------------------------------- YAML
@pytest.mark.parametrize("name", ["lenet", "small_lenet", "golden"])
def test_yaml_is_the_jax_text(name):
    if name == "lenet":
        jconf = jax_lenet()
    elif name == "small_lenet":
        jconf = _small_lenet()
    else:
        with zipfile.ZipFile(os.path.join(GOLDEN, "mln_golden.zip")) as zf:
            jconf = JConf.from_json(zf.read(ser.CONFIG_ENTRY).decode())
    tconf = MultiLayerConfiguration.from_json(jconf.to_json())
    text = tconf.to_yaml()
    assert text == jconf.to_yaml()
    back = MultiLayerConfiguration.from_yaml(text)
    assert back.to_json() == tconf.to_json()
    assert JConf.from_yaml(text).to_json() == jconf.to_json()
    assert lenet_mnist().to_yaml() == jax_lenet().to_yaml()


# ------------------------------------------------------------ the rest
def test_collections_match_jax():
    from deeplearning4j_tpu.utils import collections as jc
    from deeplearning4j_tpu_torch.utils import collections as tc

    results = []
    for m in (jc, tc):
        c = m.Counter()
        for key, amount in (("a", 2.0), ("b", 1.0), ("a", 1.0), ("c", 4.0)):
            c.increment_count(key, amount)
        row = [c.argmax(), c.max_count(), c.total_count(), c.get_count("z")]
        c.normalize()
        c.scale(3.0)
        c.remove_key("b")
        row += [sorted(c.items()), c.key_set(), c.is_empty()]
        q = m.PriorityQueue()
        for item, p in (("low", 1.0), ("high", 9.0), ("mid", 5.0),
                        ("tie", 5.0)):
            q.put(item, p)
        row += [q.peek(), q.get_priority()]
        row += [q.next() for _ in range(4)] + [q.has_next(), q.is_empty()]
        results.append(row)
    assert results[1] == results[0]


def test_the_moe_golden_zip_is_refused_until_moe_is_ported():
    """``lm_golden.zip`` (a transformer block and a Switch-MoE block, written
    by the JAX serializer) restores now that MoE is ported: its outputs
    within the JAX golden test's own bound (rtol and atol 1e-5) and its
    flat updater state bitwise."""
    exp = np.load(os.path.join(GOLDEN, "lm_golden_expected.npz"))
    net = ser.guess_model(os.path.join(GOLDEN, "lm_golden.zip"), device="cpu")
    assert type(net) is MultiLayerNetwork and net.layers[2].TYPE == \
        "MoETransformerBlock"
    np.testing.assert_allclose(net.output(exp["lm_in"]).numpy(),
                               exp["lm_out"], rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(
        pytree.flatten_params(net.updater_state, torch.float32).numpy(),
        exp["lm_updater_flat"])
