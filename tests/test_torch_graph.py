"""The port's graph configuration (``GraphBuilder``, the twelve vertices,
``ComputationGraphConfiguration``'s JSON), ``ComputationGraph`` and
serving a graph, held against the JAX package on the CPU.

Each vertex is read into the port from the JAX vertex's JSON object and
writes the same object back; forward and ``output_type`` agree (atol 1e-6:
one float32 operation or a short sum). The JSON of full ``resnet50()``,
``resnet18()`` and a two-input merge/subset graph with an automatic
preprocessor is the JAX ``to_json()`` dict, and a JAX JSON reads back
unchanged. A two-input graph (tanh, no kinks) trains for 3 ``fit`` steps
on ``MultiDataSet``\\ s as the JAX graph does: losses within 1e-5
relative, params and updater state within atol 1e-5 + rtol 1e-5. Serving
a one-input graph with batch norm: ``PredictFn`` float32 within atol 1e-5
of the JAX ``PredictFn``, int8 within atol 1e-5 of the JAX int8 pin.
"""
import dataclasses
import http.client
import json

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from _torch_port import compile_cache_at
from deeplearning4j_tpu.models.resnet import resnet18 as jax_resnet18
from deeplearning4j_tpu.models.resnet import resnet50 as jax_resnet50
from deeplearning4j_tpu.nn.conf import layers as JL
from deeplearning4j_tpu.nn.conf import preprocessors as JP
from deeplearning4j_tpu.nn.conf import serde as jserde
from deeplearning4j_tpu.nn.conf import vertices as JV
from deeplearning4j_tpu.nn.conf.builders import (
    NeuralNetConfiguration as JNNC)
from deeplearning4j_tpu.nn.conf.graphconf import (
    ComputationGraphConfiguration as JGraphConf)
from deeplearning4j_tpu.nn.conf.inputs import InputType as JInputType
from deeplearning4j_tpu.nn.graph_network import ComputationGraph as JGraph
from deeplearning4j_tpu.nn.graph_network import MultiDataSet as JMDS
from deeplearning4j_tpu.nn.inference import PredictFn as JPredictFn
from deeplearning4j_tpu_torch.convert import from_jax, to_numpy
from deeplearning4j_tpu_torch.datasets.dataset import DataSet
from deeplearning4j_tpu_torch.keras_server import InferenceServer
from deeplearning4j_tpu_torch.models import resnet18, resnet50
from deeplearning4j_tpu_torch.nn.conf import (
    ComputationGraphConfiguration, InputType, NeuralNetConfiguration)
from deeplearning4j_tpu_torch.nn.conf import layers as TL
from deeplearning4j_tpu_torch.nn.conf import vertices as TV
from deeplearning4j_tpu_torch.nn.conf.preprocessors import (
    CnnToFeedForwardPreProcessor)
from deeplearning4j_tpu_torch.nn.graph_network import (
    ComputationGraph, MultiDataSet)
from deeplearning4j_tpu_torch.nn.inference import PredictFn

ATOL = RTOL = 1e-5


def _np(tree):
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    return np.asarray(tree)


def _r(*shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _itype_dict(t):
    return {k: v for k, v in dataclasses.asdict(t).items()}


# (JAX vertex, input arrays, JAX input types, mask)
B = 3
VERTICES = {
    "merge": (JV.MergeVertex(), [_r(B, 3), _r(B, 4, seed=1)],
              [JInputType.feed_forward(3), JInputType.feed_forward(4)], None),
    "merge_cnn": (JV.MergeVertex(), [_r(B, 2, 2, 3), _r(B, 2, 2, 1, seed=1)],
                  [JInputType.convolutional(2, 2, 3),
                   JInputType.convolutional(2, 2, 1)], None),
    "add": (JV.ElementWiseVertex(op="add"),
            [_r(B, 4), _r(B, 4, seed=1), _r(B, 4, seed=2)],
            [JInputType.feed_forward(4)] * 3, None),
    "subtract": (JV.ElementWiseVertex(op="subtract"),
                 [_r(B, 4), _r(B, 4, seed=1)],
                 [JInputType.feed_forward(4)] * 2, None),
    "product": (JV.ElementWiseVertex(op="product"),
                [_r(B, 4), _r(B, 4, seed=1), _r(B, 4, seed=2)],
                [JInputType.feed_forward(4)] * 3, None),
    "max": (JV.ElementWiseVertex(op="max"), [_r(B, 4), _r(B, 4, seed=1)],
            [JInputType.feed_forward(4)] * 2, None),
    "average": (JV.ElementWiseVertex(op="average"),
                [_r(B, 4), _r(B, 4, seed=1), _r(B, 4, seed=2)],
                [JInputType.feed_forward(4)] * 3, None),
    "subset": (JV.SubsetVertex(start=1, end=3), [_r(B, 5, 6)],
               [JInputType.recurrent(6, 5)], None),
    "l2normalize": (JV.L2NormalizeVertex(), [_r(B, 2, 3, 4)],
                    [JInputType.convolutional(2, 3, 4)], None),
    "l2": (JV.L2Vertex(), [_r(B, 5), _r(B, 5, seed=1)],
           [JInputType.feed_forward(5)] * 2, None),
    "scale": (JV.ScaleVertex(scale=2.5), [_r(B, 4)],
              [JInputType.feed_forward(4)], None),
    "shift": (JV.ShiftVertex(shift=-1.5), [_r(B, 4)],
              [JInputType.feed_forward(4)], None),
    "stack": (JV.StackVertex(), [_r(B, 4), _r(B, 4, seed=1)],
              [JInputType.feed_forward(4)] * 2, None),
    "unstack": (JV.UnstackVertex(index=1, num_stacks=3), [_r(2 * B, 4)],
                [JInputType.feed_forward(4)], None),
    "preprocessor": (JV.PreprocessorVertex(
        preprocessor=JP.CnnToFeedForwardPreProcessor(2, 3, 4)),
        [_r(B, 2, 3, 4)], [JInputType.convolutional(2, 3, 4)], None),
    "last_step": (JV.LastTimeStepVertex(), [_r(B, 5, 4)],
                  [JInputType.recurrent(4, 5)], None),
    "last_step_masked": (JV.LastTimeStepVertex(mask_input="in"),
                         [_r(B, 5, 4)], [JInputType.recurrent(4, 5)],
                         np.array([[1, 1, 1, 0, 0], [1, 1, 1, 1, 1],
                                   [0, 0, 0, 0, 0]], np.float32)),
    "duplicate": (JV.DuplicateToTimeSeriesVertex(ts_input="seq"),
                  [_r(B, 4), _r(B, 6, 2, seed=1)],
                  [JInputType.feed_forward(4), JInputType.recurrent(2, 6)],
                  None),
}


@pytest.mark.parametrize("case", sorted(VERTICES))
def test_vertex_matches_jax(case):
    jv, xs, itypes, mask = VERTICES[case]
    d = jserde.to_dict(jv)
    tv = TV.vertex_from_dict(d)
    assert tv.to_dict() == d and type(tv).__name__ == type(jv).__name__
    jm = None if mask is None else jnp.asarray(mask)
    want, _ = jv.apply({}, {}, [jnp.asarray(x) for x in xs], mask=jm)
    got = tv.apply([torch.tensor(x) for x in xs],
                   None if mask is None else torch.tensor(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-6)
    t_itypes = [InputType.from_dict(_itype_dict(t)) for t in itypes]
    assert _itype_dict(tv.output_type(t_itypes)) == _itype_dict(
        jv.output_type(itypes))


def test_layer_vertex_matches_jax():
    jl = JL.DenseLayer(n_in=3, n_out=5, activation="tanh")
    jv = JV.LayerVertex(layer=jl)
    d = jserde.to_dict(jv)
    tv = TV.vertex_from_dict(d)
    assert tv.to_dict() == d
    it = JInputType.convolutional(2, 2, 3)
    assert _itype_dict(tv.output_type([InputType.from_dict(
        _itype_dict(it))])) == _itype_dict(jv.output_type([it]))
    assert sorted(TV.VERTEX_TYPES) == sorted(
        n for n in ("LayerVertex", "MergeVertex", "ElementWiseVertex",
                    "SubsetVertex", "L2NormalizeVertex", "L2Vertex",
                    "ScaleVertex", "ShiftVertex", "StackVertex",
                    "UnstackVertex", "PreprocessorVertex",
                    "LastTimeStepVertex", "DuplicateToTimeSeriesVertex"))
    with pytest.raises(ValueError):
        TV.ElementWiseVertex(op="nope").apply([torch.zeros(1)])


def _merge_graph(pkg, remat=False):
    """Two inputs (4x4x2 images, 5 features): conv -> dense (an automatic
    CnnToFeedForward preprocessor), dense, merged, a subset, the output."""
    jax_side = pkg == "jax"
    L = JL if jax_side else TL
    V = JV if jax_side else TV
    IT = JInputType if jax_side else InputType
    NNC = JNNC if jax_side else NeuralNetConfiguration

    def layer(cls, **kw):
        return getattr(L, cls)(**kw) if jax_side else getattr(L, cls).conf(**kw)

    return (NNC.builder().seed(9).learning_rate(0.05).updater("nesterovs")
            .momentum(0.9).weight_init("xavier").activation("tanh")
            .gradient_checkpointing(remat)
            .graph_builder()
            .add_inputs("img", "feat")
            .add_layer("conv", layer("ConvolutionLayer", n_out=3,
                                     kernel_size=(3, 3),
                                     convolution_mode="same"), "img")
            .add_layer("dense_img", layer("DenseLayer", n_out=6), "conv")
            .add_layer("dense_feat", layer("DenseLayer", n_out=4), "feat")
            .add_vertex("merge", V.MergeVertex(), "dense_img", "dense_feat")
            .add_vertex("subset", V.SubsetVertex(start=2, end=8), "merge")
            .add_layer("out", layer("OutputLayer", n_out=3, loss="mcxent",
                                    activation="softmax"), "subset")
            .set_outputs("out")
            .set_input_types(IT.convolutional(4, 4, 2), IT.feed_forward(5))
            .build())


def _jd(conf):
    return json.loads(conf.to_json())


@pytest.mark.parametrize("name", ["resnet50", "resnet18", "merge"])
def test_graph_json_matches_jax(name):
    if name == "merge":
        jconf, tconf = _merge_graph("jax"), _merge_graph("port")
        assert "dense_img-preprocessor" in tconf.vertices
        assert isinstance(tconf.vertices["dense_img-preprocessor"]
                          .preprocessor, CnnToFeedForwardPreProcessor)
    else:
        jfn, tfn = {"resnet50": (jax_resnet50, resnet50),
                    "resnet18": (jax_resnet18, resnet18)}[name]
        jconf, tconf = jfn(), tfn()
    assert _jd(tconf) == _jd(jconf)
    assert tconf.topological_order == jconf.topological_order
    # each package reads the other's JSON and writes back the same dict
    back = ComputationGraphConfiguration.from_json(jconf.to_json())
    assert _jd(back) == _jd(jconf)
    assert _jd(JGraphConf.from_json(tconf.to_json())) == _jd(jconf)


def test_graph_builder_checks_like_jax():
    g = NeuralNetConfiguration.builder().graph_builder().add_inputs("in")
    g.add_layer("a", TL.DenseLayer.conf(n_in=2, n_out=2), "missing")
    g.set_outputs("a")
    with pytest.raises(ValueError, match="undefined"):
        g.build()
    g = NeuralNetConfiguration.builder().graph_builder().add_inputs("in")
    g.add_layer("a", TL.DenseLayer.conf(n_in=2, n_out=2), "b")
    g.add_layer("b", TL.DenseLayer.conf(n_in=2, n_out=2), "a")
    g.set_outputs("nope")
    with pytest.raises(ValueError, match="not a vertex"):
        g.build()
    g.set_outputs("b")
    with pytest.raises(ValueError, match="cycle"):
        g.build()
    with pytest.raises(TypeError):
        g.add_layer("c", JL.DenseLayer(n_out=2), "in")


@pytest.fixture(scope="module")
def merge(tmp_path_factory):
    """The JAX two-input graph, 3 ``fit`` steps on MultiDataSets."""
    conf = _merge_graph("jax")
    rng = np.random.default_rng(3)
    batches = [JMDS([rng.standard_normal((8, 4, 4, 2)).astype(np.float32),
                     rng.standard_normal((8, 5)).astype(np.float32)],
                    [np.eye(3, dtype=np.float32)[rng.integers(0, 3, 8)]])
               for _ in range(3)]
    with compile_cache_at(tmp_path_factory.mktemp("xcache")):
        jnet = JGraph(conf).init()
        out = {"conf": conf, "batches": batches, "p0": _np(jnet.params_list),
               "flat": np.asarray(jnet.params()), "losses": []}
        x0 = batches[0].features
        out["out0"] = np.asarray(jnet.output(*x0)[0])
        for mds in batches:
            jnet.fit(mds)
            out["losses"].append(float(jnet.score_value))
        out["params"] = _np(jnet.params_list)
        out["upd"] = _np(jnet.updater_state)
        out["score"] = jnet.score(batches[0])
    return out


def _mds(j):
    return MultiDataSet(list(j.features), list(j.labels))


@pytest.mark.parametrize("remat", [False, True], ids=["plain", "checkpointed"])
def test_two_input_graph_trains_as_jax(merge, remat):
    conf_json = _merge_graph("jax", remat).to_json()
    net = from_jax(conf_json, merge["p0"], device="cpu")
    assert isinstance(net, ComputationGraph)
    np.testing.assert_array_equal(net.params().numpy(), merge["flat"])
    assert net.num_params() == merge["flat"].size
    out = net.output(*merge["batches"][0].features)
    assert isinstance(out, list) and len(out) == 1
    np.testing.assert_allclose(out[0].numpy(), merge["out0"], rtol=RTOL,
                               atol=ATOL)
    losses = []
    for mds in merge["batches"]:
        net.fit(_mds(mds))
        losses.append(net.score_value)
    np.testing.assert_allclose(losses, merge["losses"], rtol=1e-5)
    got, got_upd = to_numpy(net.params_list), to_numpy(net.updater_state)
    for n, leaves in merge["params"].items():
        for k, v in leaves.items():
            np.testing.assert_allclose(got[n][k], v, rtol=RTOL, atol=ATOL)
            np.testing.assert_allclose(got_upd[n][k]["v"], merge["upd"][n][k]["v"],
                                       rtol=RTOL, atol=ATOL)
    assert abs(net.score(_mds(merge["batches"][0])) - merge["score"]) <= \
        1e-5 * abs(merge["score"])
    assert net.iteration == 3


def test_graph_params_round_trip_and_fit_forms(merge):
    net = from_jax(merge["conf"].to_json(), merge["p0"], device="cpu")
    flat = net.params()
    net.set_params(torch.zeros_like(flat))
    assert float(net.params().abs().sum()) == 0
    net.set_params(flat)
    assert torch.equal(net.params(), flat)
    # lists of inputs and labels, and an iterable of MultiDataSets, take the
    # same steps as fit(MultiDataSet)
    a = from_jax(merge["conf"].to_json(), merge["p0"], device="cpu")
    b = from_jax(merge["conf"].to_json(), merge["p0"], device="cpu")
    a.fit([_mds(m) for m in merge["batches"]])
    for m in merge["batches"]:
        b.fit(list(m.features), list(m.labels))
    assert torch.equal(a.params(), b.params()) and a.epoch == 1
    c = a.clone()
    assert torch.equal(c.params(), a.params()) and c.iteration == 3
    c.fit(_mds(merge["batches"][0]))
    assert not torch.equal(c.params(), a.params())
    # from_jax with the updater state and iteration continues a run: the
    # next step is bitwise the one the running network takes
    d = from_jax(merge["conf"].to_json(), to_numpy(a.params_list),
                 device="cpu", updater_state=to_numpy(a.updater_state),
                 iteration=a.iteration)
    a.fit(_mds(merge["batches"][1]))
    d.fit(_mds(merge["batches"][1]))
    assert torch.equal(d.params(), a.params()) and d.iteration == 4


def test_unported_graph_paths_raise(merge):
    """What a graph without a pretraining vertex does with the pretraining
    entry points, as the JAX package: ``pretrain`` moves nothing,
    ``pretrain_layer`` of a convolution raises (not pretrainable), and a
    ``pretrain`` config's ``fit`` on a ``MultiDataSet`` takes the
    supervised step alone. (Layerwise pretraining itself is held against
    JAX in tests/test_torch_pretrain.py; the Solver algorithms train a
    graph: an LBFGS config's ``fit`` runs the Solver here, and
    ``tests/test_torch_solvers.py`` holds it against JAX.)"""
    net = from_jax(merge["conf"].to_json(), merge["p0"], device="cpu")
    mds = _mds(merge["batches"][0])
    before = net.params()
    net.pretrain([mds])
    assert torch.equal(net.params(), before) and net.iteration == 0
    with pytest.raises(ValueError, match="not pretrainable"):
        net.pretrain_layer("conv", [mds])
    d = _jd(merge["conf"])
    for field, value in (("optimization_algo", "lbfgs"),):
        d2 = json.loads(json.dumps(d))
        d2["global_conf"][field] = value
        other = from_jax(json.dumps(d2), merge["p0"], device="cpu")
        before = other.score(mds)
        other.fit(mds)
        assert other.iteration == 1 and other._solver is not None
        assert other.score_value < before
    d2 = json.loads(json.dumps(d))
    d2["pretrain"] = True
    flagged = from_jax(json.dumps(d2), merge["p0"], device="cpu")
    plain = from_jax(merge["conf"].to_json(), merge["p0"], device="cpu")
    flagged.fit(mds)
    plain.fit(mds)
    assert flagged.iteration == 1
    assert torch.equal(flagged.params(), plain.params())


def _tiny_residual(pkg):
    """One input, batch norm and a residual add: served by PredictFn."""
    jax_side = pkg == "jax"
    L = JL if jax_side else TL
    V = JV if jax_side else TV
    IT = JInputType if jax_side else InputType
    NNC = JNNC if jax_side else NeuralNetConfiguration

    def layer(cls, **kw):
        return getattr(L, cls)(**kw) if jax_side else getattr(L, cls).conf(**kw)

    return (NNC.builder().seed(4).learning_rate(0.1).updater("nesterovs")
            .weight_init("relu").graph_builder().add_inputs("input")
            .add_layer("c1", layer("ConvolutionLayer", n_out=16,
                                   kernel_size=(3, 3), convolution_mode="same",
                                   has_bias=False, activation="identity"),
                       "input")
            .add_layer("b1", layer("BatchNormalization", activation="relu"),
                       "c1")
            .add_layer("c2", layer("ConvolutionLayer", n_out=16,
                                   kernel_size=(3, 3), convolution_mode="same",
                                   has_bias=False, activation="identity"),
                       "b1")
            .add_layer("b2", layer("BatchNormalization",
                                   activation="identity"), "c2")
            .add_vertex("add", V.ElementWiseVertex(op="add"), "b2", "b1")
            .add_layer("pool", layer("GlobalPoolingLayer",
                                     pooling_type="avg"), "add")
            .add_layer("fc", layer("OutputLayer", n_out=80, loss="mcxent",
                                   activation="softmax"), "pool")
            .set_outputs("fc")
            .set_input_types(IT.convolutional(6, 6, 3))
            .build())


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    conf = _tiny_residual("jax")
    rng = np.random.default_rng(8)
    x = rng.standard_normal((4, 6, 6, 3)).astype(np.float32)
    y = np.eye(80, dtype=np.float32)[rng.integers(0, 80, 4)]
    with compile_cache_at(tmp_path_factory.mktemp("xcache")):
        jnet = JGraph(conf).init()
        jnet.fit([x], [y])  # running statistics away from (0, 1)
        out = {"conf": conf, "x": x, "y": y, "params": _np(jnet.params_list),
               "state": _np(jnet.state_list)}
        out["f32"] = np.asarray(JPredictFn(jnet)(x))
        # a clone: the JAX net caches its predict program by name, so a
        # second PredictFn on the same net would reuse the float32 one
        out["int8"] = np.asarray(JPredictFn(jnet.clone(), quant="int8")(x))
    assert _jd(_tiny_residual("port")) == _jd(conf)
    return out


@pytest.mark.parametrize("quant", [None, "int8"])
def test_predict_fn_serves_a_graph_as_jax(tiny, quant):
    net = from_jax(tiny["conf"].to_json(), tiny["params"], device="cpu",
                   state_list=tiny["state"])
    pf = PredictFn(net, quant=quant, device="cpu")
    got = pf(tiny["x"]).numpy()
    want = tiny["int8" if quant else "f32"]
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    if quant is None:
        np.testing.assert_array_equal(got, net.output(tiny["x"])[0].numpy())
    else:
        assert pf.param_bytes < PredictFn(net, device="cpu").param_bytes
    # the pin is a snapshot: a later fit moves the network, params and
    # running statistics, not what is served
    net.fit([tiny["x"]], [tiny["y"]])
    assert not np.allclose(net.output(tiny["x"])[0].numpy(), got, atol=1e-4)
    np.testing.assert_array_equal(pf(tiny["x"]).numpy(), got)


def test_http_predict_serves_a_graph(tiny):
    net = from_jax(tiny["conf"].to_json(), tiny["params"], device="cpu",
                   state_list=tiny["state"])
    srv = InferenceServer(device="cpu", max_batch=8).start()
    try:
        mv = srv.register("res", net)
        # a graph has the rnn_time_step seam, as in the JAX registry
        assert mv.streaming_capable
        conn = http.client.HTTPConnection("127.0.0.1", srv.port, timeout=120)
        conn.request("POST", "/v1/predict", json.dumps(
            {"model": "res", "inputs": tiny["x"][:2].tolist()}),
            {"Content-Type": "application/json"})
        resp = conn.getresponse()
        body = json.loads(resp.read().decode())
        conn.close()
    finally:
        srv.stop()
    assert resp.status == 200
    np.testing.assert_allclose(np.asarray(body["predictions"], np.float32),
                               tiny["f32"][:2], rtol=0, atol=ATOL)


def test_graph_evaluate_and_score_examples(tiny):
    net = from_jax(tiny["conf"].to_json(), tiny["params"], device="cpu",
                   state_list=tiny["state"])
    ds = DataSet(tiny["x"], tiny["y"])
    ev = net.evaluate([ds])
    pred = net.output(tiny["x"])[0].numpy().argmax(-1)
    assert ev.num_examples == 4
    assert ev.accuracy() == float(np.mean(pred == tiny["y"].argmax(-1)))
    per = net.score_examples(ds)
    assert per.shape == (4,)
    np.testing.assert_allclose(per.mean(), net.score(ds), rtol=1e-5)
    # a graph of two inputs serves through PredictFn: one array per input,
    # the JAX PredictFn's answer; one array alone is refused, naming 2
    jgraph = JGraph(_merge_graph("jax")).init()
    two = PredictFn(from_jax(jgraph.conf.to_json(), _np(jgraph.params_list),
                             device="cpu"), device="cpu")
    assert two.n_inputs == 2
    rng = np.random.default_rng(4)
    img = rng.normal(size=(3, 4, 4, 2)).astype(np.float32)
    feat = rng.normal(size=(3, 5)).astype(np.float32)
    np.testing.assert_allclose(two(img, feat).numpy(),
                               np.asarray(JPredictFn(jgraph)(img, feat)),
                               rtol=0, atol=ATOL)
    with pytest.raises(ValueError, match="2 input"):
        two(img)
