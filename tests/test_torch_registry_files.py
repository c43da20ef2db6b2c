"""The port's registry loading model files and warming their buckets
(``keras_server/registry.py``), held against the JAX registry on the CPU.

- ``load`` of a model zip (either network type) serves ``/v1/predict``
  over HTTP exactly as the same network registered from memory serves it
  (bitwise: the same weights through the same forward).
- ``warmup_buckets`` is the JAX ladder; the example warmup derives is the
  JAX one (shape, or none) for a dense stack, LeNet, an LSTM, a transformer
  and a graph.
- Warmup runs one forward a bucket, before the version goes active, for a
  dense stack, and none for a graph without ``warmup_example`` or a stack
  whose derived example does not fit it (as the JAX warmup ends for
  those); with an example a graph warms every bucket, and a bad explicit
  example raises.
- A file that is not a zip is read as a Keras HDF5 archive
  (``modelimport/``); one that is not HDF5, or is cut short, raises.
"""
import http.client
import json

import numpy as np
import pytest

from _torch_port import compile_cache_at
from deeplearning4j_tpu.keras_server.registry import (
    ModelRegistry as JRegistry)
from deeplearning4j_tpu.keras_server.registry import (
    _derive_warmup_example as jderive)
from deeplearning4j_tpu.models.char_rnn import char_rnn_lstm as jchar_rnn
from deeplearning4j_tpu.models.lenet import lenet_mnist as jlenet
from deeplearning4j_tpu.models.resnet import resnet18 as jresnet18
from deeplearning4j_tpu.models.transformer import transformer_lm as jlm
from deeplearning4j_tpu.nn.conf.builders import NeuralNetConfiguration as JNNC
from deeplearning4j_tpu.nn.conf.layers import DenseLayer, OutputLayer
from deeplearning4j_tpu.nn.graph_network import ComputationGraph as JGraph
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JNet
from deeplearning4j_tpu_torch.keras_server import InferenceServer
from deeplearning4j_tpu_torch.keras_server.registry import (
    ModelRegistry, _derive_warmup_example, load_model_file)
from deeplearning4j_tpu_torch.nn.conf.graphconf import (
    ComputationGraphConfiguration)
from deeplearning4j_tpu_torch.nn.conf.multilayer import MultiLayerConfiguration
from deeplearning4j_tpu_torch.nn.graph_network import ComputationGraph
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.utils.model_serializer import write_model


def _post(port, path, body):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    try:
        conn.request("POST", path, json.dumps(body),
                     {"Content-Type": "application/json"})
        resp = conn.getresponse()
        return resp.status, resp.read().decode()
    finally:
        conn.close()


def _dense_conf():
    return (JNNC.builder().seed(3).list()
            .layer(DenseLayer(n_in=6, n_out=8, activation="tanh"))
            .layer(OutputLayer(n_in=8, n_out=3, loss="mcxent",
                               activation="softmax"))
            .build())


def _port(jconf, graph=False):
    if graph:
        return ComputationGraph(ComputationGraphConfiguration.from_json(
            jconf.to_json()), device="cpu").init()
    return MultiLayerNetwork(MultiLayerConfiguration.from_json(
        jconf.to_json()), device="cpu").init()


def _small_resnet():
    return jresnet18(n_classes=4, image_size=32)


@pytest.mark.parametrize("kind", ["dense", "graph"])
def test_load_serves_predict_as_the_in_memory_network(kind, tmp_path):
    rng = np.random.default_rng(0)
    if kind == "dense":
        net, classes = _port(_dense_conf()), 3
        x = rng.standard_normal((5, 6)).astype(np.float32)
    else:
        net, classes = _port(_small_resnet(), graph=True), 4
        x = rng.standard_normal((3, 32, 32, 3)).astype(np.float32)
    net.fit(x, np.eye(classes, dtype=np.float32)[rng.integers(0, classes,
                                                              len(x))])
    path = str(tmp_path / "m.zip")
    write_model(net, path)
    srv = InferenceServer(device="cpu", max_batch=8).start()
    try:
        srv.register("mem", net)
        mv = srv.load("file", path)
        assert mv.source == path and type(mv.net) is type(net)
        answers = []
        for name in ("mem", "file"):
            code, text = _post(srv.port, "/v1/predict",
                               {"model": name, "inputs": x.tolist()})
            assert code == 200, text
            answers.append(np.asarray(json.loads(text)["predictions"]))
        st = srv.status()
    finally:
        srv.stop()
    np.testing.assert_array_equal(answers[1], answers[0])
    assert st["models"]["file"]["versions"]["v1"]["source"] == path
    direct = net.output(x)
    direct = (direct[0] if kind == "graph" else direct).numpy()
    np.testing.assert_allclose(answers[1], direct, rtol=0, atol=1e-6)


@pytest.mark.parametrize("max_batch", [1, 5, 32, 48])
def test_warmup_buckets_are_the_jax_ladder(max_batch):
    assert ModelRegistry.warmup_buckets(max_batch) == \
        JRegistry.warmup_buckets(max_batch)


@pytest.mark.parametrize("model", ["dense", "lenet", "char_rnn",
                                   "transformer", "graph"])
def test_derived_warmup_example_is_the_jax_one(model, tmp_path):
    jconf, graph = {
        "dense": (_dense_conf, False), "lenet": (jlenet, False),
        "char_rnn": (lambda: jchar_rnn(16, hidden=8), False),
        "transformer": (lambda: jlm(16, width=16, n_layers=1, n_heads=2,
                                    max_len=8), False),
        "graph": (_small_resnet, True)}[model]
    jconf = jconf()
    with compile_cache_at(tmp_path):
        jnet = (JGraph if graph else JNet)(jconf)
    ref, ours = jderive(jnet), _derive_warmup_example(_port(jconf, graph))
    if ref is None:
        assert ours is None
    else:
        assert ours.shape == ref.shape and ours.dtype == ref.dtype
        assert not ours.any()


def test_warmup_runs_once_a_bucket_before_the_version_is_active(monkeypatch):
    reg = ModelRegistry(warmup_max_batch=6)
    net = _port(_dense_conf())
    seen = {}
    orig = ModelRegistry._warmup

    def spy(self, pf, net, example=None):
        seen["active"] = self._active.get("m")
        orig(self, pf, net, example)

    monkeypatch.setattr(ModelRegistry, "_warmup", spy)
    mv = reg.register("m", net, device="cpu")
    assert seen["active"] is None
    assert sorted(mv.predict_fn.warmed) == [1, 2, 4, 6]
    assert mv.predict_fn.calls == 0 and reg.last_warmup_s > 0
    mv2 = reg.register("m", net, device="cpu")
    assert seen["active"] == "v1" and reg.active("m") is mv2
    # off by default
    assert ModelRegistry().register("m", net, device="cpu"
                                    ).predict_fn.warmed == []


def test_warmup_skips_what_it_cannot_derive_and_takes_an_example():
    reg = ModelRegistry(warmup_max_batch=4)
    graph = _port(_small_resnet(), graph=True)
    assert reg.register("g", graph, device="cpu").predict_fn.warmed == []
    mv = reg.register("g", graph, device="cpu",
                      warmup_example=np.zeros((1, 32, 32, 3), np.float32))
    assert sorted(mv.predict_fn.warmed) == [1, 2, 4]
    lm = _port(jlm(16, width=16, n_layers=1, n_heads=2, max_len=8))
    assert reg.register("lm", lm, device="cpu").predict_fn.warmed == []
    with pytest.raises(Exception):
        reg.register("g2", graph, device="cpu",
                     warmup_example=np.zeros((1, 7), np.float32))
    assert "g2" not in reg.status()["models"]
    # InferenceServer(warmup=True) opts its registry in at its max_batch
    srv = InferenceServer(device="cpu", warmup=True, max_batch=8).start()
    try:
        assert srv.registry.warmup_max_batch == 8
        mv = srv.register("d", _port(_dense_conf()))
        assert sorted(mv.predict_fn.warmed) == [1, 2, 4, 8]
    finally:
        srv.stop()


def test_a_file_that_is_not_a_zip_raises_naming_a8(tmp_path):
    """A file that is not a zip is read as a Keras HDF5 archive (A8.1,
    ``modelimport/``): a truncated one and one that is not HDF5 at all
    raise ``OSError`` saying so, through both entry points."""
    path = tmp_path / "model.h5"
    path.write_bytes(b"\x89HDF\r\n\x1a\n" + b"\0" * 64)
    with pytest.raises(OSError, match="truncated HDF5 file"):
        load_model_file(str(path), device="cpu")
    with pytest.raises(OSError, match="truncated HDF5 file"):
        ModelRegistry().load("m", str(path), device="cpu")
    path.write_bytes(b"not an archive" * 8)
    with pytest.raises(OSError, match="not an HDF5 file"):
        load_model_file(str(path), device="cpu")
