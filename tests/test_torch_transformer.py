"""The port's ``transformer_lm`` forward held against the JAX package.

Weights cross only through ``convert.from_jax``. Whole-model outputs agree
at atol 1e-5 (float32; the JAX CPU path runs plain XLA attention, the port
its flash kernel's plain version). Also pinned: the port's own
``transformer_lm`` writes the JAX config's fields, the config reader refuses
unknown types, the port imports no JAX, and entry points refuse a host
without CUDA unless asked for the CPU.
"""
import json
import subprocess
import sys

import numpy as np
import pytest
import torch

from _torch_port import jax_lm
from deeplearning4j_tpu.models.transformer import transformer_lm as jax_transformer_lm
from deeplearning4j_tpu_torch.convert import from_jax
from deeplearning4j_tpu_torch.models import lenet_mnist, transformer_lm
from deeplearning4j_tpu_torch.nn.conf import MultiLayerConfiguration
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork

TOL = 1e-5


@pytest.fixture(scope="module")
def lm():
    net, params = jax_lm(vocab=128, width=128, n_layers=2, n_heads=2,
                         max_len=64, seed=3)
    return net, params, from_jax(net.conf.to_json(), params, device="cpu")


@pytest.mark.parametrize("encoding", ["one_hot", "ids"])
def test_forward_matches_jax(lm, encoding):
    jnet, _, tnet = lm
    ids = np.random.default_rng(0).integers(0, 128, size=(2, 32))
    one_hot = np.eye(128, dtype=np.float32)[ids]
    ref = np.asarray(jnet.output(one_hot))
    x = one_hot if encoding == "one_hot" else ids.astype(np.float32)
    out = tnet.output(x)
    assert out.shape == (2, 32, 128) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=TOL)


def test_params_keep_jax_names_and_layout(lm):
    _, params, tnet = lm
    for given, own in zip(params, tnet.params_list):
        assert sorted(given) == sorted(own)
        for k in given:
            assert np.array_equal(own[k].detach().numpy(), given[k])
    bad = [dict(p) for p in params]
    bad[1] = {k: v for k, v in bad[1].items() if k != "Wo"}
    with pytest.raises(ValueError):
        from_jax(lm[0].conf.to_json(), bad, device="cpu")


def test_port_transformer_lm_config_matches_jax():
    ours = json.loads(transformer_lm(256).to_json())
    theirs = json.loads(jax_transformer_lm(256).to_json())
    assert [l["@type"] for l in ours["layers"]] == \
        [l["@type"] for l in theirs["layers"]]
    for a, b in zip(ours["layers"], theirs["layers"]):
        for key, value in a.items():
            assert b[key] == value, key
    # the embedding's activation is the global default, not identity
    assert ours["layers"][0]["activation"] == "sigmoid"
    assert ours["input_type"] == theirs["input_type"]
    assert ours["global_conf"]["seed"] == theirs["global_conf"]["seed"]
    conf = MultiLayerConfiguration.from_json(transformer_lm(64, width=32).to_json())
    net = MultiLayerNetwork(conf, device="cpu").init(seed=7)
    again = MultiLayerNetwork(conf, device="cpu").init(seed=7)
    for a, b in zip(net.params_list, again.params_list):
        assert all(torch.equal(a[k], b[k]) for k in a)
    assert net.output(np.zeros((1, 5), np.float32)).shape == (1, 5, 64)


def test_config_reader_refuses_unknown_and_unported_types():
    """An unknown ``@type`` raises; every type the JAX package registers is
    read (the MoE types too, since they were ported)."""
    d = json.loads(transformer_lm(16, width=8, n_layers=1, n_heads=2).to_json())
    d["layers"][1]["@type"] = "NoSuchLayer"
    with pytest.raises(ValueError):
        MultiLayerConfiguration.from_dict(d)
    d["layers"][1]["@type"] = "MoE"
    conf = MultiLayerConfiguration.from_dict(d)
    assert conf.layers[1].type == "MoE"
    from deeplearning4j_tpu.nn.conf import serde as jserde
    from deeplearning4j_tpu.nn.conf.layers.base import Layer as JLayer
    from deeplearning4j_tpu_torch.nn.conf.serde import LAYER_TYPES, layer_class
    layer_class("Dense")
    # the package's own types: a test elsewhere registers a custom layer in
    # the same process
    jax_types = {k for k, v in jserde._REGISTRY.items()
                 if isinstance(v, type) and issubclass(v, JLayer)
                 and v.__module__.startswith("deeplearning4j_tpu.")}
    assert jax_types == set(LAYER_TYPES)


def test_port_imports_no_jax():
    code = ("import sys, deeplearning4j_tpu_torch.keras_server, "
            "deeplearning4j_tpu_torch.convert, deeplearning4j_tpu_torch.models, "
            "deeplearning4j_tpu_torch.nn.multilayer, "
            "deeplearning4j_tpu_torch.nn.updaters, "
            "deeplearning4j_tpu_torch.nn.weights, "
            "deeplearning4j_tpu_torch.datasets, "
            "deeplearning4j_tpu_torch.ops.losses, "
            "deeplearning4j_tpu_torch.ops.softmax_xent, "
            "deeplearning4j_tpu_torch.ops.flash_attention, "
            "deeplearning4j_tpu_torch.ops.lstm, "
            "deeplearning4j_tpu_torch.nn.conf.layers.recurrent, "
            "deeplearning4j_tpu_torch.models.char_rnn, "
            "deeplearning4j_tpu_torch.keras_server.streaming, "
            "deeplearning4j_tpu_torch.nn.conf.builders, "
            "deeplearning4j_tpu_torch.nn.conf.preprocessors, "
            "deeplearning4j_tpu_torch.nn.conf.layers.convolutional, "
            "deeplearning4j_tpu_torch.eval, "
            "deeplearning4j_tpu_torch.datasets.iterators, "
            "deeplearning4j_tpu_torch.datasets.mnist, "
            "deeplearning4j_tpu_torch.models.lenet, "
            "deeplearning4j_tpu_torch.models.resnet, "
            "deeplearning4j_tpu_torch.ops.batch_norm, "
            "deeplearning4j_tpu_torch.nn.conf.layers.normalization, "
            "deeplearning4j_tpu_torch.nn.conf.vertices, "
            "deeplearning4j_tpu_torch.nn.conf.graphconf, "
            "deeplearning4j_tpu_torch.nn.graph_network, "
            "deeplearning4j_tpu_torch.nn.ksteps, "
            "deeplearning4j_tpu_torch.datasets.prefetch, "
            "deeplearning4j_tpu_torch.utils.batching, "
            "deeplearning4j_tpu_torch.nn.inference, "
            "deeplearning4j_tpu_torch.utils.pytree, "
            "deeplearning4j_tpu_torch.utils.model_serializer, "
            "deeplearning4j_tpu_torch.utils.collections, "
            "deeplearning4j_tpu_torch.optimize, "
            "deeplearning4j_tpu_torch.optimize.listeners, "
            "deeplearning4j_tpu_torch.optimize.solvers, "
            "deeplearning4j_tpu_torch.earlystopping, "
            "deeplearning4j_tpu_torch.nn.gradientcheck, "
            "deeplearning4j_tpu_torch.keras_server.registry, "
            "deeplearning4j_tpu_torch.keras_server.replica, "
            "deeplearning4j_tpu_torch.keras_server.autoscaler, "
            "deeplearning4j_tpu_torch.keras_server.loadgen, "
            "deeplearning4j_tpu_torch.nn.conf.layers.moe, "
            "deeplearning4j_tpu_torch.nn.conf.layers.variational, "
            "deeplearning4j_tpu_torch.nn.conf.layers.attention, "
            "deeplearning4j_tpu_torch.nn.conf.layers.feedforward, "
            "deeplearning4j_tpu_torch.models.vgg, "
            "deeplearning4j_tpu_torch.models.alexnet, "
            "deeplearning4j_tpu_torch.models.googlenet, "
            "deeplearning4j_tpu_torch.models.transformer, "
            "deeplearning4j_tpu_torch.datasets.fetchers, "
            "deeplearning4j_tpu_torch.parallel, "
            "deeplearning4j_tpu_torch.parallel.mesh, "
            "deeplearning4j_tpu_torch.parallel.partition, "
            "deeplearning4j_tpu_torch.parallel.context, "
            "deeplearning4j_tpu_torch.parallel.compile_seam, "
            "deeplearning4j_tpu_torch.parallel.ring_attention, "
            "deeplearning4j_tpu_torch.parallel.pipeline, "
            "deeplearning4j_tpu_torch.parallel.pipeline_trainer, "
            "deeplearning4j_tpu_torch.parallel.moe, "
            "deeplearning4j_tpu_torch.parallel.tensor_parallel, "
            "deeplearning4j_tpu_torch.nn.param_blocks, "
            "deeplearning4j_tpu_torch.keras_server.serving, "
            "deeplearning4j_tpu_torch.keras_server.batcher, "
            "deeplearning4j_tpu_torch.ops.quant, "
            "deeplearning4j_tpu_torch.parallel.wrapper, "
            "deeplearning4j_tpu_torch.parallel.training_master, "
            "deeplearning4j_tpu_torch.streaming.wire, "
            "deeplearning4j_tpu_torch.parallel.param_server, "
            "deeplearning4j_tpu_torch.parallel.ps_transport, "
            "deeplearning4j_tpu_torch.parallel.ps_worker, "
            "deeplearning4j_tpu_torch.streaming, "
            "deeplearning4j_tpu_torch.streaming.broker, "
            "deeplearning4j_tpu_torch.cloud, "
            "deeplearning4j_tpu_torch.observability.flight_recorder, "
            "deeplearning4j_tpu_torch.observability.watchdog, "
            "deeplearning4j_tpu_torch.observability.health, "
            "deeplearning4j_tpu_torch.utils.sharded_checkpoint, "
            "deeplearning4j_tpu_torch.parallel.elastic, "
            "deeplearning4j_tpu_torch.modelimport, "
            "deeplearning4j_tpu_torch.modelimport.hdf5, "
            "deeplearning4j_tpu_torch.modelimport.keras_import, "
            "deeplearning4j_tpu_torch.nativert, "
            "deeplearning4j_tpu_torch.datavec, "
            "deeplearning4j_tpu_torch.datavec.records, "
            "deeplearning4j_tpu_torch.datavec.iterators, "
            "deeplearning4j_tpu_torch.ops.fixed_matmul, "
            "deeplearning4j_tpu_torch.nlp, "
            "deeplearning4j_tpu_torch.nlp.tokenization, "
            "deeplearning4j_tpu_torch.nlp.vocab, "
            "deeplearning4j_tpu_torch.nlp.lookup, "
            "deeplearning4j_tpu_torch.nlp.learning, "
            "deeplearning4j_tpu_torch.nlp.sequencevectors, "
            "deeplearning4j_tpu_torch.nlp.word2vec, "
            "deeplearning4j_tpu_torch.nlp.iterators, "
            "deeplearning4j_tpu_torch.nlp.paragraph_vectors, "
            "deeplearning4j_tpu_torch.nlp.glove, "
            "deeplearning4j_tpu_torch.nlp.bagofwords, "
            "deeplearning4j_tpu_torch.nlp.serializer, "
            "deeplearning4j_tpu_torch.nlp.distributed, "
            "deeplearning4j_tpu_torch.nlp.languages, "
            "deeplearning4j_tpu_torch.nlp.ja_lexicon, "
            "deeplearning4j_tpu_torch.nlp.annotators, "
            "deeplearning4j_tpu_torch.graph, "
            "deeplearning4j_tpu_torch.graph.graph, "
            "deeplearning4j_tpu_torch.graph.walkers, "
            "deeplearning4j_tpu_torch.graph.deepwalk, "
            "deeplearning4j_tpu_torch.clustering, "
            "deeplearning4j_tpu_torch.clustering.kdtree, "
            "deeplearning4j_tpu_torch.clustering.kmeans, "
            "deeplearning4j_tpu_torch.clustering.quadtree, "
            "deeplearning4j_tpu_torch.clustering.vptree, "
            "deeplearning4j_tpu_torch.plot, "
            "deeplearning4j_tpu_torch.plot.tsne, "
            "deeplearning4j_tpu_torch.observability, "
            "deeplearning4j_tpu_torch.observability.metrics, "
            "deeplearning4j_tpu_torch.observability.names, "
            "deeplearning4j_tpu_torch.observability.tracing, "
            "deeplearning4j_tpu_torch.observability.spans, "
            "deeplearning4j_tpu_torch.observability.slo, "
            "deeplearning4j_tpu_torch.ui, "
            "deeplearning4j_tpu_torch.ui.storage;"
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.') "
            "or m.startswith('jaxlib') or m == 'deeplearning4j_tpu' "
            "or m.startswith('deeplearning4j_tpu.') or m == 'ml_dtypes' "
            "or m.startswith('ml_dtypes.') or m == 'h5py' "
            "or m.startswith('h5py.')];"
            "print(bad); sys.exit(1 if bad else 0)")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


def test_entry_points_raise_without_cuda(monkeypatch):
    from deeplearning4j_tpu_torch.keras_server import DecodeEngine, InferenceServer
    from deeplearning4j_tpu_torch.nn.inference import PredictFn
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    conf = transformer_lm(16, width=8, n_layers=1, n_heads=2)
    with pytest.raises(RuntimeError, match="CUDA"):
        InferenceServer()
    with pytest.raises(RuntimeError, match="CUDA"):
        MultiLayerNetwork(conf)
    with pytest.raises(RuntimeError, match="CUDA"):
        MultiLayerNetwork(lenet_mnist())
    net = MultiLayerNetwork(conf, device="cpu").init()
    with pytest.raises(RuntimeError, match="CUDA"):
        PredictFn(net)
    with pytest.raises(RuntimeError, match="CUDA"):
        DecodeEngine(net)
    from deeplearning4j_tpu_torch.keras_server import ModelRegistry, StreamSessions
    with pytest.raises(RuntimeError, match="CUDA"):
        StreamSessions(ModelRegistry())
    from deeplearning4j_tpu_torch.keras_server import ReplicaSet
    with pytest.raises(RuntimeError, match="CUDA"):
        ReplicaSet(2)
    with pytest.raises(RuntimeError, match="CUDA"):
        InferenceServer(replicas=2)
