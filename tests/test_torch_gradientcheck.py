"""The port's ``check_gradients`` (``nn/gradientcheck.py``) on the networks
the JAX package's gradient checks run (``tests/test_gradients.py``), with
the JAX networks' weights carried over by ``convert.from_jax``.

Each check is the JAX one's: central differences at ``eps`` 1e-6 in
float64 against autograd, a parameter failing above 1e-3 relative error
and 1e-8 absolute. The JAX package's own check runs on the same network
and data beside it, and both must pass. An activation whose backward is
made 10% wrong must fail the check, and a network on the card raises with
the message to pass a CPU clone.

Not checked here: the JAX package's attention and MoE cases (the MoE
layer's check runs in tests/test_torch_moe.py, the pretraining checks in
tests/test_torch_pretrain.py). The port's attention is the flash
kernels' arithmetic, float32 inside even for float64 operands (its
wrappers take float32 and bf16 only), so a float64
central difference through ``TransformerBlock`` measures float32 rounding,
not the gradient; the JAX suite runs its transformer case without
asserting the result.
"""
import numpy as np
import pytest
import torch

from _torch_port import compile_cache_at
from deeplearning4j_tpu.nn.conf.builders import NeuralNetConfiguration as JNNC
from deeplearning4j_tpu.nn.conf.inputs import InputType as JInputType
from deeplearning4j_tpu.nn.conf.layers import (
    BatchNormalization, ConvolutionLayer, DenseLayer, GlobalPoolingLayer,
    GravesLSTM, OutputLayer, RnnOutputLayer, SubsamplingLayer, Upsampling2D,
    ZeroPaddingLayer)
from deeplearning4j_tpu.nn.gradientcheck import check_gradients as jcheck
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JNet
from deeplearning4j_tpu_torch.convert import from_jax
from deeplearning4j_tpu_torch.nn.gradientcheck import check_gradients
from deeplearning4j_tpu_torch.ops import activations as tact

SEED = 7


def rand(shape, seed=0):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def onehot(n, c, seed=1):
    y = np.zeros((n, c), np.float32)
    y[np.arange(n), np.random.default_rng(seed).integers(0, c, n)] = 1
    return y


def seq_labels(b, t, c, seed=4):
    idx = np.random.default_rng(seed).integers(0, c, (b, t))
    return np.eye(c, dtype=np.float32)[idx]


def _conv(h, w, c):
    return JInputType.convolutional(h, w, c)


#: name -> (layers, input type, global settings, x, y, subset): the JAX
#: package's gradient-check networks that the port has layers for
CASES = {
    "dense_softmax_mcxent": (
        lambda: [DenseLayer(n_in=4, n_out=6, activation="tanh"),
                 OutputLayer(n_in=6, n_out=3, loss="mcxent",
                             activation="softmax")],
        None, {}, lambda: rand((5, 4)), lambda: onehot(5, 3), None),
    "dense_sigmoid_xent": (
        lambda: [DenseLayer(n_in=4, n_out=6, activation="relu"),
                 OutputLayer(n_in=6, n_out=2, loss="xent",
                             activation="sigmoid")],
        None, {}, lambda: rand((5, 4)),
        lambda: (np.random.default_rng(2).uniform(size=(5, 2)) > 0.5
                 ).astype(np.float32), None),
    "mse_identity": (
        lambda: [DenseLayer(n_in=3, n_out=5, activation="tanh"),
                 OutputLayer(n_in=5, n_out=2, loss="mse",
                             activation="identity")],
        None, {}, lambda: rand((4, 3)), lambda: rand((4, 2), seed=3), None),
    "l1_l2": (
        lambda: [DenseLayer(n_in=4, n_out=5, activation="sigmoid", l1=0.01,
                            l2=0.02),
                 OutputLayer(n_in=5, n_out=3, loss="mcxent",
                             activation="softmax", l1=0.01, l2=0.02)],
        None, {"use_regularization": True}, lambda: rand((5, 4)),
        lambda: onehot(5, 3), None),
    "cnn_dense_output": (
        lambda: [ConvolutionLayer(n_out=3, kernel_size=(2, 2), stride=(1, 1),
                                  activation="tanh"),
                 SubsamplingLayer(pooling_type="max", kernel_size=(2, 2),
                                  stride=(2, 2)),
                 DenseLayer(n_out=8, activation="relu"),
                 OutputLayer(n_out=2, loss="mcxent", activation="softmax")],
        _conv(6, 6, 2), {}, lambda: rand((3, 6, 6, 2)), lambda: onehot(3, 2),
        60),
    "batchnorm": (
        lambda: [DenseLayer(n_in=4, n_out=6, activation="identity"),
                 BatchNormalization(n_in=6),
                 OutputLayer(n_in=6, n_out=3, loss="mcxent",
                             activation="softmax")],
        None, {}, lambda: rand((8, 4)), lambda: onehot(8, 3), 40),
    **{f"convolution_mode_{mode}": (
        lambda mode=mode: [
            ConvolutionLayer(n_out=3, kernel_size=(3, 3), stride=(2, 2),
                             convolution_mode=mode, activation="tanh"),
            DenseLayer(n_out=6, activation="relu"),
            OutputLayer(n_out=2, loss="mcxent", activation="softmax")],
        _conv(7, 7, 2), {}, lambda: rand((3, 7, 7, 2)), lambda: onehot(3, 2),
        60) for mode in ("same", "truncate")},
    **{f"pooling_{p}": (
        lambda p=p: [
            ConvolutionLayer(n_out=2, kernel_size=(2, 2), stride=(1, 1),
                             activation="tanh"),
            SubsamplingLayer(pooling_type=p, kernel_size=(2, 2), stride=(2, 2),
                             pnorm=2),
            OutputLayer(n_out=2, loss="mcxent", activation="softmax")],
        _conv(5, 5, 1), {}, lambda: rand((3, 5, 5, 1)), lambda: onehot(3, 2),
        60) for p in ("max", "avg", "pnorm")},
    **{f"global_pooling_{p}": (
        lambda p=p: [
            ConvolutionLayer(n_out=3, kernel_size=(2, 2), stride=(1, 1),
                             activation="tanh"),
            GlobalPoolingLayer(pooling_type=p),
            OutputLayer(n_out=2, loss="mcxent", activation="softmax")],
        _conv(5, 5, 2), {}, lambda: rand((3, 5, 5, 2)), lambda: onehot(3, 2),
        60) for p in ("avg", "max", "sum")},
    "upsampling_zeropadding": (
        lambda: [ZeroPaddingLayer(padding=(1, 1)),
                 ConvolutionLayer(n_out=2, kernel_size=(3, 3), stride=(1, 1),
                                  activation="tanh"),
                 Upsampling2D(size=(2, 2)),
                 DenseLayer(n_out=6, activation="relu"),
                 OutputLayer(n_out=2, loss="mcxent", activation="softmax")],
        _conv(4, 4, 1), {}, lambda: rand((2, 4, 4, 1)), lambda: onehot(2, 2),
        60),
    "dilated_convolution": (
        lambda: [ConvolutionLayer(n_out=3, kernel_size=(2, 2), stride=(1, 1),
                                  dilation=(2, 2), activation="tanh"),
                 DenseLayer(n_out=6, activation="relu"),
                 OutputLayer(n_out=2, loss="mcxent", activation="softmax")],
        _conv(7, 7, 1), {}, lambda: rand((2, 7, 7, 1)), lambda: onehot(2, 2),
        60),
    "lstm_rnn_output": (
        lambda: [GravesLSTM(n_in=3, n_out=4, activation="tanh"),
                 RnnOutputLayer(n_in=4, n_out=2, loss="mcxent",
                                activation="softmax")],
        None, {}, lambda: rand((2, 5, 3)), lambda: seq_labels(2, 5, 2), 60),
}


def _jax_net(name, tmp_path):
    layers, itype, glob, _, _, _ = CASES[name]
    b = JNNC.builder().seed(SEED)
    for k, v in glob.items():
        b = getattr(b, k)(v)
    lb = b.list()
    for layer in layers():
        lb = lb.layer(layer)
    if itype is not None:
        lb = lb.set_input_type(itype)
    with compile_cache_at(tmp_path):
        return JNet(lb.build()).init()


def _port(jnet):
    params = [{k: np.asarray(v) for k, v in p.items()}
              for p in jnet.params_list]
    states = [{k: np.asarray(v) for k, v in s.items()}
              for s in jnet.state_list]
    return from_jax(jnet.conf.to_json(), params, device="cpu",
                    state_list=states)


@pytest.mark.parametrize("name", sorted(CASES))
def test_check_gradients_passes_as_in_jax(name, tmp_path):
    jnet = _jax_net(name, tmp_path)
    _, _, _, x, y, subset = CASES[name]
    x, y = x(), y()
    net = _port(jnet)
    assert check_gradients(net, x, y, subset=subset, verbose=True)
    with compile_cache_at(tmp_path):
        assert jcheck(jnet, x, y, subset=subset)
    # the check works on float64 copies: the network is untouched
    assert all(v.dtype == torch.float32 for p in net.params_list
               for v in p.values())


class _WrongTanhGrad(torch.autograd.Function):
    """tanh forward; a backward 10% too large."""

    @staticmethod
    def forward(ctx, x):
        y = torch.tanh(x)
        ctx.save_for_backward(y)
        return y

    @staticmethod
    def backward(ctx, g):
        (y,) = ctx.saved_tensors
        return 1.1 * g * (1 - y * y)


def test_check_gradients_fails_on_a_wrong_gradient(tmp_path, monkeypatch):
    jnet = _jax_net("dense_softmax_mcxent", tmp_path)
    x, y = rand((5, 4)), onehot(5, 3)
    monkeypatch.setitem(tact.ACTIVATIONS, "tanh", _WrongTanhGrad.apply)
    assert not check_gradients(_port(jnet), x, y)
    monkeypatch.undo()
    assert check_gradients(_port(jnet), x, y)


def test_check_gradients_refuses_a_card_network(tmp_path, monkeypatch):
    net = _port(_jax_net("mse_identity", tmp_path))
    monkeypatch.setattr(net, "device", torch.device("cuda"))
    with pytest.raises(ValueError, match="pass a CPU clone"):
        check_gradients(net, rand((4, 3)), rand((4, 2), seed=3))
