"""The port's builder DSL, ``InputType`` and preprocessors held against the
JAX package.

The same builder calls go through both packages (``Layer(**kw)`` there,
``Layer.conf(**kw)`` here): the two ``to_json()`` dicts are equal, each JSON
reads into the other package and writes back the same dict, and the built
networks (JAX weights carried over by ``convert.from_jax``) give the same
output and gradients within atol 1e-5 + rtol 1e-5 (float32). The configs
together use every layer type and every preprocessor this port adds.
"""
import json

import numpy as np
import pytest
import torch

from _torch_port import compile_cache_at
from deeplearning4j_tpu.models.lenet import lenet_mnist as jax_lenet
from deeplearning4j_tpu.nn.conf import layers as JL
from deeplearning4j_tpu.nn.conf import preprocessors as JP
from deeplearning4j_tpu.nn.conf.builders import (
    NeuralNetConfiguration as JNNC)
from deeplearning4j_tpu.nn.conf.inputs import InputType as JInputType
from deeplearning4j_tpu.nn.conf.multilayer import (
    MultiLayerConfiguration as JMLC)
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JNet
from deeplearning4j_tpu_torch.convert import from_jax
from deeplearning4j_tpu_torch.models import lenet_mnist
from deeplearning4j_tpu_torch.nn.conf import (
    InputType, MultiLayerConfiguration, NeuralNetConfiguration)
from deeplearning4j_tpu_torch.nn.conf import layers as TL
from deeplearning4j_tpu_torch.nn.conf import preprocessors as TP

ATOL = RTOL = 1e-5

#: (global setter calls, input type, layers, explicit preprocessors)
CONFIGS = {
    # every convolutional layer type, strided "same", dilation, pnorm, a
    # global max pool, then the dense family
    "cnn_all": (
        dict(seed=7, learning_rate=0.05, updater="adam", weight_init="relu",
             activation="tanh", l2=1e-4, regularization=True),
        ("convolutional_flat", (12, 12, 2)),
        [("ConvolutionLayer", dict(n_out=4, kernel_size=(3, 3),
                                   stride=(2, 2), convolution_mode="same")),
         ("ZeroPaddingLayer", dict(padding=(1, 1))),
         ("SubsamplingLayer", dict(pooling_type="avg", kernel_size=(2, 2),
                                   stride=(2, 2))),
         ("Upsampling2D", dict(size=(2, 2))),
         # tanh, not relu, before the pnorm: a window of ReLU zeros has an
         # infinite pnorm derivative, and the two frameworks then differ
         # (ROADMAP.md, section C, "checked, not a fault")
         ("ConvolutionLayer", dict(n_out=3, kernel_size=(3, 3),
                                   dilation=(2, 2), activation="tanh")),
         ("SubsamplingLayer", dict(pooling_type="pnorm", kernel_size=(2, 2),
                                   stride=(1, 1), pnorm=3)),
         ("GlobalPoolingLayer", dict(pooling_type="max")),
         ("DenseLayer", dict(n_out=8, activation="elu")),
         ("DropoutLayer", dict(dropout=0.9)),
         ("ActivationLayer", dict(activation="softsign")),
         ("OutputLayer", dict(n_out=5, loss="mcxent", activation="softmax"))],
        {}),
    # NHWC input straight in: CnnToFeedForward before the dense layer, a
    # parameter-free loss layer at the end
    "cnn_dense_loss": (
        dict(seed=3, updater="sgd", learning_rate=0.1),
        ("convolutional", (6, 6, 2)),
        [("ConvolutionLayer", dict(n_out=3, kernel_size=(3, 3),
                                   activation="sigmoid")),
         ("DenseLayer", dict(n_out=4, activation="identity")),
         ("LossLayer", dict(loss="mse", activation="identity"))],
        {}),
    # images into an LSTM: CnnToRnn inferred
    "cnn_rnn": (
        dict(seed=5, updater="rmsprop"),
        ("convolutional", (4, 4, 1)),
        [("ConvolutionLayer", dict(n_out=2, kernel_size=(3, 3),
                                   activation="relu")),
         ("GravesLSTM", dict(n_out=5, activation="tanh")),
         ("RnnOutputLayer", dict(n_out=3, loss="mcxent",
                                 activation="softmax"))],
        {}),
    # the other three preprocessors, set explicitly
    "explicit_pre": (
        dict(seed=11, updater="nesterovs", momentum=0.8),
        ("recurrent", (6, 4)),
        [("DenseLayer", dict(n_out=8, activation="tanh")),
         ("LSTM", dict(n_out=6, activation="tanh")),
         ("ConvolutionLayer", dict(n_out=2, kernel_size=(2, 2),
                                   activation="identity")),
         ("OutputLayer", dict(n_out=3, loss="mcxent", activation="softmax"))],
        {0: ("RnnToFeedForwardPreProcessor", {}),
         1: ("FeedForwardToRnnPreProcessor", dict(timesteps=4)),
         2: ("RnnToCnnPreProcessor", dict(height=2, width=3, channels=1))}),
}


def build(jax_side: bool, name: str):
    g, (itype, args), layers, pps = CONFIGS[name]
    b = (JNNC if jax_side else NeuralNetConfiguration).builder()
    for k, v in g.items():
        b = getattr(b, k)(v)
    lb = b.list()
    for cls, kw in layers:
        lb = lb.layer(getattr(JL, cls)(**kw) if jax_side
                      else getattr(TL, cls).conf(**kw))
    for i, (cls, kw) in pps.items():
        lb = lb.input_pre_processor(i, getattr(JP if jax_side else TP,
                                               cls)(**kw))
    it = getattr(JInputType if jax_side else InputType, itype)(*args)
    return lb.set_input_type(it).build()


def test_lenet_config_matches_jax_dict():
    ours, theirs = lenet_mnist(), jax_lenet()
    assert json.loads(ours.to_json()) == json.loads(theirs.to_json())
    assert json.loads(lenet_mnist(seed=3, learning_rate=0.2).to_json()) == \
        json.loads(jax_lenet(seed=3, learning_rate=0.2).to_json())
    # n_in inferred through the preprocessors: 1 and 20 channels, 800 flat
    assert [lc.get("n_in") for lc in ours.layers] == [1, None, 20, None,
                                                      800, 500]
    assert sorted(ours.preprocessors) == ["0", "4"]


@pytest.mark.parametrize("name", ["lenet"] + sorted(CONFIGS))
def test_json_reads_into_the_other_package(name):
    if name == "lenet":
        ours, theirs = lenet_mnist(), jax_lenet()
    else:
        ours, theirs = build(False, name), build(True, name)
    want = json.loads(theirs.to_json())
    assert json.loads(ours.to_json()) == want
    # JAX JSON -> port -> JSON, and port JSON -> JAX -> JSON
    assert json.loads(MultiLayerConfiguration.from_json(
        theirs.to_json()).to_json()) == want
    assert json.loads(JMLC.from_json(ours.to_json()).to_json()) == want


def _labels(shape, rng, one_hot=True):
    if not one_hot:
        return rng.standard_normal(shape).astype(np.float32)
    return np.eye(shape[-1], dtype=np.float32)[
        rng.integers(0, shape[-1], shape[:-1])]


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_built_network_matches_jax(name, tmp_path):
    """Output and gradients of the built network against the JAX network
    with the same weights: every layer and preprocessor in the forward and
    the backward."""
    conf = build(True, name)
    rng = np.random.default_rng(0)
    B = 3
    with compile_cache_at(tmp_path):
        jnet = JNet(conf).init()
        params = [{k: np.asarray(v) for k, v in p.items()}
                  for p in jnet.params_list]
        x = rng.random(conf.input_type.array_shape(B)).astype(np.float32)
        ref = np.asarray(jnet.output(x))
        y = _labels(ref.shape, rng, one_hot=name != "cnn_dense_loss")
        jgrads, jscore = jnet.gradient_and_score(x, y)
    tnet = from_jax(conf.to_json(), params, device="cpu")
    assert json.loads(tnet.conf.to_json()) == json.loads(conf.to_json())
    out = tnet.output(x)
    np.testing.assert_allclose(out.numpy(), ref, rtol=RTOL, atol=ATOL)
    grads, score = tnet.gradient_and_score(x, y)
    np.testing.assert_allclose(score, jscore, rtol=RTOL, atol=ATOL)
    for g, jg in zip(grads, jgrads):
        assert sorted(g) == sorted(jg)
        for k in g:
            np.testing.assert_allclose(g[k].numpy(), np.asarray(jg[k]),
                                       rtol=RTOL, atol=ATOL)
    acts = tnet.feed_forward(x)
    assert len(acts) == len(conf.layers)
    assert torch.equal(acts[-1], out)


@pytest.mark.parametrize("factory,args", [
    ("feed_forward", (7,)), ("recurrent", (5, 9)), ("recurrent", (5,)),
    ("convolutional", (4, 5, 3)), ("convolutional_flat", (28, 28, 1))])
def test_input_type_matches_jax(factory, args):
    from deeplearning4j_tpu.nn.conf import serde as jserde
    ours = getattr(InputType, factory)(*args)
    theirs = getattr(JInputType, factory)(*args)
    assert ours.to_dict() == jserde.to_dict(theirs)
    assert ours.flat_size() == theirs.flat_size()
    assert ours.array_shape(2) == theirs.array_shape(2)
    assert InputType().to_dict() == jserde.to_dict(JInputType())


@pytest.mark.parametrize("name,kw,shape", [
    ("FeedForwardToCnnPreProcessor", dict(height=3, width=4, channels=2),
     (2, 24)),
    ("CnnToFeedForwardPreProcessor", dict(height=3, width=4, channels=2),
     (2, 3, 4, 2)),
    ("RnnToFeedForwardPreProcessor", {}, (2, 5, 3)),
    ("FeedForwardToRnnPreProcessor", dict(timesteps=5), (10, 3)),
    ("CnnToRnnPreProcessor", dict(timesteps=2), (4, 3, 2, 2)),
    ("RnnToCnnPreProcessor", dict(height=2, width=3, channels=1), (2, 4, 6))])
def test_preprocessor_matches_jax(name, kw, shape):
    """The same reshape (NHWC flattened in (h, w, c) order), output type
    and JSON object."""
    import jax.numpy as jnp
    from deeplearning4j_tpu.nn.conf import serde as jserde
    x = np.arange(np.prod(shape), dtype=np.float32).reshape(shape)
    ours, theirs = getattr(TP, name)(**kw), getattr(JP, name)(**kw)
    np.testing.assert_array_equal(ours.pre_process(torch.tensor(x)).numpy(),
                                  np.asarray(theirs.pre_process(
                                      jnp.asarray(x))))
    assert ours.to_dict() == jserde.to_dict(theirs)
    assert TP.preprocessor_from_dict(ours.to_dict()) == ours
    it = InputType.convolutional(3, 4, 2)
    assert ours.output_type(it).to_dict() == jserde.to_dict(
        theirs.output_type(JInputType.convolutional(3, 4, 2)))


def test_builder_refuses_what_the_jax_builder_refuses():
    b = NeuralNetConfiguration.builder()
    with pytest.raises(AttributeError):
        b.no_such_field(1)
    with pytest.raises(ValueError, match="dtype"):
        b.dtype("float33").list().layer(
            TL.OutputLayer.conf(n_in=2, n_out=2)).build()
    lb = NeuralNetConfiguration.builder().list()
    with pytest.raises(ValueError, match="in order"):
        lb.layer(1, TL.DenseLayer.conf(n_in=2, n_out=2))
    with pytest.raises(TypeError):
        TL.DenseLayer.conf(n_out=2, kernel_size=(3, 3))
    with pytest.raises(TypeError, match="LayerConf"):
        lb.layer(TL.DenseLayer)
    # graph_builder() is ported: its build() refuses what the JAX one does
    gb = NeuralNetConfiguration.builder().dtype("float33").graph_builder()
    gb.add_inputs("in").add_layer("out", TL.OutputLayer.conf(n_in=2, n_out=2),
                                  "in").set_outputs("out")
    with pytest.raises(ValueError, match="dtype"):
        gb.build()
    with pytest.raises(TypeError, match="LayerConf"):
        gb.add_layer("d", TL.DenseLayer, "in")
    with pytest.raises(ValueError, match="preprocessor"):
        TP.preprocessor_from_dict({"@type": "NoSuch"})


def test_builder_settings_reach_the_config():
    """The training settings, the camelCase aliases and ``mini_batch``."""
    conf = (NeuralNetConfiguration.builder().optimizationAlgo(
        "stochastic_gradient_descent").regularization(True).l1(0.01)
        .mini_batch(False).list()
        .layer(0, TL.GravesLSTM.conf(n_out=4))
        .layer(1, TL.RnnOutputLayer.conf(n_out=3))
        .set_input_type(InputType.recurrent(5)).backprop_type("TruncatedBPTT")
        .t_bptt_forward_length(7).t_bptt_backward_length(6).pretrain(False)
        .backprop(True).build())
    theirs = (JNNC.builder().optimizationAlgo("stochastic_gradient_descent")
              .regularization(True).l1(0.01).mini_batch(False).list()
              .layer(0, JL.GravesLSTM(n_out=4))
              .layer(1, JL.RnnOutputLayer(n_out=3))
              .set_input_type(JInputType.recurrent(5))
              .backprop_type("TruncatedBPTT").t_bptt_forward_length(7)
              .t_bptt_backward_length(6).pretrain(False).backprop(True)
              .build())
    assert json.loads(conf.to_json()) == json.loads(theirs.to_json())
    g = conf.global_conf
    assert g.use_regularization and not g.minibatch and not g.mini_batch
    assert conf.tbptt_fwd_length == 7 and conf.layers[0]["n_in"] == 5
