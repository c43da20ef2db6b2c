"""The port's model zoo (``vgg16``, ``alexnet``, ``googlenet``,
``moe_transformer_lm``) and dataset fetchers (CIFAR-10, LFW, Curves, Iris)
held against the JAX package on the CPU.

- Each config's JSON is the JAX one, field for field, at full size.
- Each network's parameter count is the JAX network's (its shapes by
  ``jax.eval_shape``, nothing drawn): AlexNet about 61 M, GoogLeNet within
  the JAX test's 5.5-7.5 M, VGG-16 138 M.
- AlexNet and GoogLeNet at 64x64, VGG-16 at 32x32 (B = 2, 5 classes, the
  configs' dropout at retain 1.0, since the two packages' RNGs differ),
  the port's weights given to the JAX network: ``output`` within 1e-5,
  the training loss (1e-5 relative) and every gradient (within 1e-4 of
  each leaf's largest magnitude: float32 convolutions summed in another
  order by XLA and by PyTorch) against the JAX ones, and one ``fit`` step
  against the JAX Nesterov updater applied to the JAX gradient.
- The fetchers' synthetic batches are bitwise the JAX ones from the same
  seeds, and local CIFAR-10 binaries and an LFW image directory are read
  as the JAX package reads them.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from deeplearning4j_tpu import models as jmodels
from deeplearning4j_tpu.datasets import fetchers as jfetch
from deeplearning4j_tpu.nn import multilayer as jmultilayer
from deeplearning4j_tpu.nn import updaters as jupdaters
from deeplearning4j_tpu.nn.graph_network import ComputationGraph as JGraph
from deeplearning4j_tpu.nn.graph_network import graph_loss
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JNet
from deeplearning4j_tpu.nn.multilayer import loss_fn
from deeplearning4j_tpu_torch import models
from deeplearning4j_tpu_torch.convert import to_numpy
from deeplearning4j_tpu_torch.datasets import fetchers
from deeplearning4j_tpu_torch.nn.conf.graphconf import (
    ComputationGraphConfiguration)
from deeplearning4j_tpu_torch.nn.conf.multilayer import (
    MultiLayerConfiguration)
from deeplearning4j_tpu_torch.nn.graph_network import ComputationGraph
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork

ZOO = {"vgg16": (), "alexnet": (), "googlenet": (),
       "moe_transformer_lm": (256,)}
GRAPHS = ("googlenet",)


@pytest.mark.parametrize("name", sorted(ZOO))
def test_config_json_matches_jax(name):
    ours = json.loads(getattr(models, name)(*ZOO[name]).to_json())
    theirs = json.loads(getattr(jmodels, name)(*ZOO[name]).to_json())
    assert ours == theirs
    assert list(ours) == list(theirs)
    reader = (ComputationGraphConfiguration if name in GRAPHS
              else MultiLayerConfiguration)
    assert json.loads(reader.from_json(json.dumps(theirs)).to_json()) == theirs


def _jax_count(conf, graph: bool) -> int:
    cls = JGraph if graph else JNet
    shapes = jax.eval_shape(lambda: cls(conf).init().params_list)
    return int(sum(np.prod(s.shape) for s in jax.tree_util.tree_leaves(shapes)))


@pytest.mark.parametrize("name,low,high", [
    ("alexnet", 55e6, 66e6), ("googlenet", 5.5e6, 7.5e6),
    ("vgg16", 138e6, 139e6)])
def test_param_counts_match_jax(name, low, high):
    graph = name in GRAPHS
    conf = getattr(models, name)()
    net = (ComputationGraph if graph else MultiLayerNetwork)(conf,
                                                             device="cpu")
    n = net.num_params()
    assert n == _jax_count(getattr(jmodels, name)(), graph)
    assert low < n < high, n


SMALL = {"alexnet": 64, "googlenet": 64, "vgg16": 32}


@pytest.mark.parametrize("name", sorted(SMALL))
def test_small_forward_and_step_match_jax(name):
    """The port's weights (drawn by its own init) given to the JAX network:
    ``output``, the train loss and every gradient (the JAX ones jitted), and
    one ``fit`` step against the JAX updater applied to the JAX gradient."""
    graph = name in GRAPHS
    size = SMALL[name]
    kw = dict(n_classes=5, image_size=size, dropout=1.0, learning_rate=0.01)
    tnet = (ComputationGraph if graph else MultiLayerNetwork)(
        getattr(models, name)(**kw), device="cpu").init()
    jconf = getattr(jmodels, name)(**kw)
    jnet = (JGraph if graph else JNet)(jconf)
    if graph:
        jconf.topological_order = jconf.topo_sort()
    # copies: the port's step writes its params in place
    jparams = jax.tree_util.tree_map(lambda a: jnp.array(np.array(a)),
                                     to_numpy(tnet.params_list))
    jnet.params_list = jparams
    jnet.state_list = jax.tree_util.tree_map(jnp.asarray,
                                             to_numpy(tnet.state_list))
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, size, size, 3)).astype(np.float32)
    y = np.eye(5, dtype=np.float32)[[1, 3]]
    jout, tout = jnet.output(x), tnet.output(x)
    if graph:
        jout, tout = jout[0], tout[0]
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), rtol=0,
                               atol=1e-5)
    if graph:
        def jloss(p):
            return graph_loss(jconf, p, jnet.state_list, [jnp.asarray(x)],
                              [jnp.asarray(y)], None)[0]
        tgrads, tloss = tnet.gradient_and_score([x], [y])
        layers = {n: jconf.vertices[n].layer for n in jparams if jparams[n]}
    else:
        def jloss(p):
            return loss_fn(jconf, p, jnet.state_list, jnp.asarray(x),
                           jnp.asarray(y), None)[0]
        tgrads, tloss = tnet.gradient_and_score(x, y)
        layers = dict(enumerate(jconf.layers))
    jl, jgrads = jax.jit(jax.value_and_grad(jloss))(jparams)
    np.testing.assert_allclose(tloss, float(jl), rtol=1e-5)
    tnet.fit(*(([x], [y]) if graph else (x, y)))
    np.testing.assert_allclose(tnet.score_value, float(jl), rtol=1e-5)
    specs = {i: jmultilayer._updater_spec(layer) for i, layer in layers.items()}

    def jax_step(params, grads):
        # the JAX updater's first step from its zero state
        out = {}
        for i, layer in layers.items():
            out[i] = {}
            for k, p in params[i].items():
                step, _ = jupdaters.updater_step_with_param(
                    specs[i], grads[i][k], p,
                    jupdaters.updater_init(specs[i], p),
                    jnp.float32(layer.learning_rate), 0)
                out[i][k] = p - step
        return out

    as_dict = (lambda t: t) if graph else (lambda t: dict(enumerate(t)))
    expect = jax.jit(jax_step)(as_dict(jparams), as_dict(jgrads))
    for i in layers:
        for k, g in jgrads[i].items():
            g = np.asarray(g)
            np.testing.assert_allclose(
                to_numpy(tgrads[i][k]), g, rtol=0,
                atol=1e-4 * max(float(np.abs(g).max()), 1e-3),
                err_msg=f"{i} {k}")
            np.testing.assert_allclose(
                to_numpy(tnet.params_list[i][k]), np.asarray(expect[i][k]),
                rtol=0, atol=1e-6 * max(float(np.abs(g).max()), 1.0),
                err_msg=f"{i} {k} after the step")


FETCHERS = {
    "cifar_train": ("CifarDataSetIterator", dict(batch=16, num_examples=64)),
    "cifar_test_flat": ("CifarDataSetIterator",
                        dict(batch=16, num_examples=48, train=False,
                             flatten=True, shuffle=False)),
    "lfw": ("LFWDataSetIterator", dict(batch=16, num_examples=64)),
    "curves": ("CurvesDataSetIterator", dict(batch=16, num_examples=64)),
    "iris": ("IrisDataSetIterator", dict(batch=30)),
}


def _assert_same_batches(a, b, epochs=2):
    for _ in range(epochs):
        n = 0
        for x, y in zip(a, b):
            assert x.features.dtype == y.features.dtype
            np.testing.assert_array_equal(x.features, y.features)
            np.testing.assert_array_equal(x.labels, y.labels)
            n += 1
        assert n > 0


@pytest.mark.parametrize("case", sorted(FETCHERS))
def test_fetchers_synthetic_batches_equal_jax(case, monkeypatch, tmp_path):
    monkeypatch.setenv("HOME", str(tmp_path))  # no local data files
    for env in ("CIFAR_DIR", "LFW_DIR"):
        monkeypatch.delenv(env, raising=False)
    monkeypatch.setattr(jfetch, "_CIFAR_DIRS", [])
    monkeypatch.setattr(jfetch, "_LFW_DIRS", [])
    cls, kw = FETCHERS[case]
    ours = getattr(fetchers, cls)(**kw)
    assert ours.synthetic
    _assert_same_batches(ours, getattr(jfetch, cls)(**kw))


def test_fetchers_read_local_files_as_jax(monkeypatch, tmp_path):
    """CIFAR-10 binaries (channel-major records) and an LFW directory of
    per-person images, read from the directories the port searches."""
    from PIL import Image

    rng = np.random.default_rng(3)
    cifar = tmp_path / "cifar"
    cifar.mkdir()
    for i in (1, 2):
        recs = rng.integers(0, 256, (7, 3073), dtype=np.uint8)
        recs[:, 0] %= 10
        (cifar / f"data_batch_{i}.bin").write_bytes(recs.tobytes())
    lfw = tmp_path / "lfw"
    for person in ("ann", "bob", "cy"):
        (lfw / person).mkdir(parents=True)
        for j in range(3):
            Image.fromarray(rng.integers(0, 256, (40, 30), dtype=np.uint8)
                            ).save(lfw / person / f"{j}.png")
    monkeypatch.setenv("CIFAR_DIR", str(cifar))
    monkeypatch.setenv("LFW_DIR", str(lfw))
    monkeypatch.setattr(jfetch, "_CIFAR_DIRS", [str(cifar)])
    monkeypatch.setattr(jfetch, "_LFW_DIRS", [str(lfw)])
    ours = fetchers.CifarDataSetIterator(batch=7, shuffle=False)
    assert not ours.synthetic and ours.features.shape == (14, 32, 32, 3)
    raw = np.frombuffer((cifar / "data_batch_1.bin").read_bytes(), np.uint8)
    np.testing.assert_array_equal(
        ours.features[0, :, :, 1],
        raw[1 + 1024:1 + 2048].reshape(32, 32) / np.float32(255.0))
    _assert_same_batches(ours, jfetch.CifarDataSetIterator(batch=7,
                                                           shuffle=False))
    faces = fetchers.LFWDataSetIterator(batch=3, num_examples=8,
                                        image_size=12, shuffle=False)
    assert not faces.synthetic and faces.labels.shape == (8, 3)
    _assert_same_batches(faces, jfetch.LFWDataSetIterator(
        batch=3, num_examples=8, image_size=12, shuffle=False))
    assert os.environ["LFW_DIR"] == str(lfw)
