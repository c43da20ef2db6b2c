"""The port's activations and its convolutional, pooling and dense-family
layers held against the JAX package on the CPU.

Each layer is the JAX dataclass, baked with the JAX global defaults, read
into the port through its JSON (``serde.to_dict``); its params come from
the JAX ``init_params`` as numpy. The forward and the gradients (params and
input, ``jax.grad`` against autograd, one random cotangent) agree within
atol 1e-5 + rtol 1e-5 (float32; sums in another order). Max pooling over
tied inputs (small integers) routes each window's gradient to the same
element as XLA does: they agree exactly.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deeplearning4j_tpu.nn.conf import layers as JL
from deeplearning4j_tpu.nn.conf import serde as jserde
from deeplearning4j_tpu.nn.conf.builders import GlobalConf as JGlobalConf
from deeplearning4j_tpu.nn.conf.builders import bake_layer_defaults as jbake
from deeplearning4j_tpu.nn.conf.inputs import InputType as JInputType
from deeplearning4j_tpu.ops import activations as jact
from deeplearning4j_tpu.ops import losses as jlosses
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.conf.multilayer import LayerConf
from deeplearning4j_tpu_torch.nn.conf.serde import layer_class
from deeplearning4j_tpu_torch.ops import activations as tact
from deeplearning4j_tpu_torch.ops import losses as tlosses

ATOL = RTOL = 1e-5
CPU = torch.device("cpu")


def port_layer(jlayer):
    """The JAX layer (baked with the JAX defaults) and its port module, made
    from the JAX layer's JSON object."""
    jbake(jlayer, JGlobalConf())
    d = jserde.to_dict(jlayer)
    t = d.pop("@type")
    return layer_class(t)(LayerConf(t, d), CPU)


def _close(got, want, exact=False):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    if exact:
        np.testing.assert_array_equal(got, np.asarray(want))
    else:
        np.testing.assert_allclose(got, np.asarray(want), rtol=RTOL, atol=ATOL)


def check_layer(jlayer, itype, x, mask=None, seed=0, exact=False):
    """Forward, input gradient and param gradients of ``jlayer`` against its
    port; the output shape against the JAX ``output_type``."""
    tl = port_layer(jlayer)
    jp = jlayer.init_params(jax.random.PRNGKey(seed), itype)
    params = {k: np.asarray(v) for k, v in jp.items()}
    jm = None if mask is None else jnp.asarray(mask)

    def f(p, xx):
        return jlayer.apply(p, {}, xx, mask=jm)[0]

    out = np.asarray(f(jp, jnp.asarray(x)))
    ct = np.random.default_rng(seed + 1).standard_normal(out.shape)
    ct = ct.astype(np.float32)
    gp, gx = jax.grad(lambda p, xx: jnp.sum(f(p, xx) * ct),
                      argnums=(0, 1))(jp, jnp.asarray(x))
    tp = {k: torch.tensor(v, requires_grad=True) for k, v in params.items()}
    xt = torch.tensor(x, requires_grad=True)
    o = tl.apply(tp, xt, None if mask is None else torch.tensor(mask))
    _close(o, out, exact)
    (o * torch.tensor(ct)).sum().backward()
    _close(xt.grad, gx, exact)
    assert sorted(tp) == sorted(gp)
    for k in tp:
        _close(tp[k].grad, gp[k], exact)
    # the port's output type is the JAX one, and the output has its shape
    fields = jserde.to_dict(jlayer)
    ot = type(tl).output_type(fields,
                              InputType.from_dict(jserde.to_dict(itype)))
    assert ot.to_dict() == jserde.to_dict(jlayer.output_type(itype))
    if ot.kind == "convolutional":
        assert tuple(o.shape[1:]) == (ot.height, ot.width, ot.channels)
    return o


def _images(B=2, H=8, W=9, C=3, seed=0):
    return np.random.default_rng(seed).standard_normal((B, H, W, C)
                                                       ).astype(np.float32)


# ---------------------------------------------------------------- activations
NEW_ACTIVATIONS = ["relu6", "leakyrelu", "elu", "selu", "hardsigmoid",
                   "hardtanh", "rationaltanh", "rectifiedtanh", "logsoftmax",
                   "softplus", "softsign", "cube", "swish"]


@pytest.mark.parametrize("name", NEW_ACTIVATIONS + [
    "identity", "relu", "sigmoid", "tanh", "softmax", "gelu"])
def test_activation_matches_jax(name):
    # scaled to reach relu6's and hardsigmoid's upper knees and elu's
    # negative side; exact zeros, where the two frameworks' subgradients
    # differ, have probability 0
    x = (np.random.default_rng(1).standard_normal((4, 7)) * 4).astype(
        np.float32)
    ct = np.random.default_rng(2).standard_normal((4, 7)).astype(np.float32)
    jf = jact.get_activation(name)
    tf = tact.get_activation(name.upper())  # names match case-insensitively
    assert tf.__name__ == jf.__name__
    ref = np.asarray(jf(jnp.asarray(x)))
    gref = np.asarray(jax.grad(lambda v: jnp.sum(jf(v) * ct))(jnp.asarray(x)))
    xt = torch.tensor(x, requires_grad=True)
    out = tf(xt)
    _close(out, ref)
    (out * torch.tensor(ct)).sum().backward()
    _close(xt.grad, gref)


def test_activation_names_are_the_jax_set():
    assert sorted(tact.ACTIVATIONS) == sorted(jact.ACTIVATIONS)
    with pytest.raises(ValueError, match="Known"):
        tact.get_activation("nosuch")


def test_logsoftmax_mcxent_takes_the_fused_path(monkeypatch):
    """``logsoftmax`` + ``mcxent`` goes through the fused softmax
    cross-entropy, as in the JAX package, and gives the JAX loss."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((6, 10)).astype(np.float32)
    y = np.eye(10, dtype=np.float32)[rng.integers(0, 10, 6)]
    calls = []
    real = tlosses.FusedSoftmaxXent.apply
    monkeypatch.setattr(tlosses.FusedSoftmaxXent, "apply",
                        lambda *a: calls.append(1) or real(*a))
    got = tlosses.get_loss("mcxent")(torch.tensor(y), torch.tensor(x),
                                     tact.get_activation("logsoftmax"))
    ref = jlosses.get_loss("mcxent")(jnp.asarray(y), jnp.asarray(x),
                                     jact.get_activation("logsoftmax"))
    assert calls == [1]
    np.testing.assert_allclose(float(got), float(ref), rtol=RTOL, atol=ATOL)


# ---------------------------------------------------------------- convolution
@pytest.mark.parametrize("kw", [
    # stride 2 with "same": asymmetric XLA padding (H 8: 0 above, 1 below)
    dict(kernel_size=(3, 3), stride=(2, 2), convolution_mode="same"),
    # dilation 2, no padding
    dict(kernel_size=(3, 3), dilation=(2, 2)),
    # dilation 2 with "same": the dilated extent sets the padding
    dict(kernel_size=(3, 2), dilation=(2, 2), convolution_mode="same"),
    # explicit padding, uneven stride
    dict(kernel_size=(3, 3), padding=(1, 2), stride=(1, 2)),
    # LeNet's own: 5x5, stride 1, no padding
    dict(kernel_size=(5, 5)),
    # no bias
    dict(kernel_size=(2, 2), has_bias=False)])
def test_convolution_matches_jax(kw):
    layer = JL.ConvolutionLayer(n_in=3, n_out=4, activation="tanh", **kw)
    check_layer(layer, JInputType.convolutional(8, 9, 3), _images())


def test_convolution_set_n_in_refuses_flat_input():
    from deeplearning4j_tpu_torch.nn.conf.layers import ConvolutionLayer
    fields = ConvolutionLayer.conf(n_out=4).fields
    with pytest.raises(ValueError, match="convolutional input"):
        ConvolutionLayer.set_n_in(fields, InputType.feed_forward(10))
    ConvolutionLayer.set_n_in(fields, InputType.convolutional(5, 5, 7))
    assert fields["n_in"] == 7


# ---------------------------------------------------------------- pooling
POOL_GEOMETRIES = [
    dict(kernel_size=(3, 3), stride=(2, 2), convolution_mode="same"),
    dict(kernel_size=(2, 2), stride=(2, 2)),
    dict(kernel_size=(3, 2), stride=(1, 2), padding=(1, 1)),
    dict(kernel_size=(2, 3), stride=(1, 1), convolution_mode="same")]


@pytest.mark.parametrize("ptype", ["max", "avg", "sum", "pnorm"])
@pytest.mark.parametrize("geom", range(len(POOL_GEOMETRIES)))
def test_subsampling_matches_jax(ptype, geom):
    layer = JL.SubsamplingLayer(pooling_type=ptype, activation="identity",
                                **POOL_GEOMETRIES[geom])
    check_layer(layer, JInputType.convolutional(8, 9, 3), _images(seed=geom))


@pytest.mark.parametrize("geom", range(len(POOL_GEOMETRIES)))
def test_max_pool_ties_route_the_gradient_as_xla(geom):
    """Inputs of 0, 1 and 2 tie in most windows: XLA's select-and-scatter
    and PyTorch's max-pool backward both give the window's gradient to its
    first maximum, so the input gradients are equal, not only close."""
    x = np.random.default_rng(geom).integers(0, 3, (2, 8, 9, 3)).astype(
        np.float32)
    layer = JL.SubsamplingLayer(pooling_type="max", activation="identity",
                                **POOL_GEOMETRIES[geom])
    check_layer(layer, JInputType.convolutional(8, 9, 3), x, exact=True)


def test_conv_relu_pool_stack_gradient_matches_jax():
    """LeNet's pattern, conv -> ReLU -> max pool, where the ReLU's zeros
    tie: the conv weights' gradient against ``jax.grad``."""
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 12, 12, 2)).astype(np.float32)
    conv = JL.ConvolutionLayer(n_in=2, n_out=5, kernel_size=(3, 3),
                               activation="relu")
    pool = JL.SubsamplingLayer(pooling_type="max", activation="identity")
    tconv, tpool = port_layer(conv), port_layer(pool)
    jp = conv.init_params(jax.random.PRNGKey(0),
                          JInputType.convolutional(12, 12, 2))
    ct = rng.standard_normal((2, 5, 5, 5)).astype(np.float32)

    def f(p):
        h = conv.apply(p, {}, jnp.asarray(x))[0]
        return jnp.sum(pool.apply({}, {}, h)[0] * ct)

    gref = jax.grad(f)(jp)
    tp = {k: torch.tensor(np.asarray(v), requires_grad=True)
          for k, v in jp.items()}
    out = tpool.apply({}, tconv.apply(tp, torch.tensor(x)))
    assert (out == 0).any()  # ReLU zeros reached the pooled output: ties
    (out * torch.tensor(ct)).sum().backward()
    for k in tp:
        _close(tp[k].grad, gref[k])


# ---------------------------------------------------------------- the others
@pytest.mark.parametrize("size", [(2, 2), (2, 3)])
def test_upsampling2d_matches_jax(size):
    check_layer(JL.Upsampling2D(size=size, activation="identity"),
                JInputType.convolutional(8, 9, 3), _images())


@pytest.mark.parametrize("padding", [(1, 1), (2, 0)])
def test_zero_padding_matches_jax(padding):
    check_layer(JL.ZeroPaddingLayer(padding=padding, activation="identity"),
                JInputType.convolutional(8, 9, 3), _images())


@pytest.mark.parametrize("ptype", ["avg", "max", "sum"])
def test_global_pooling_cnn_matches_jax(ptype):
    check_layer(JL.GlobalPoolingLayer(pooling_type=ptype,
                                      activation="identity"),
                JInputType.convolutional(8, 9, 3), _images())


@pytest.mark.parametrize("ptype", ["avg", "max", "sum"])
@pytest.mark.parametrize("masked", [False, True])
def test_global_pooling_rnn_matches_jax(ptype, masked):
    rng = np.random.default_rng(5)
    x = rng.standard_normal((3, 6, 4)).astype(np.float32)
    # ragged lengths 6, 4 and 1: every row keeps at least one step
    mask = (np.arange(6)[None, :] < np.array([[6], [4], [1]])).astype(
        np.float32) if masked else None
    check_layer(JL.GlobalPoolingLayer(pooling_type=ptype,
                                      activation="identity"),
                JInputType.recurrent(4, 6), x, mask=mask)


def _rows(n=5, f=7, seed=6):
    return np.random.default_rng(seed).standard_normal((n, f)).astype(
        np.float32)


@pytest.mark.parametrize("act", ["relu", "tanh", "swish"])
def test_dense_matches_jax(act):
    check_layer(JL.DenseLayer(n_in=7, n_out=6, activation=act),
                JInputType.feed_forward(7), _rows())


def test_dense_broadcasts_over_time_as_jax():
    x = np.random.default_rng(7).standard_normal((2, 3, 7)).astype(np.float32)
    check_layer(JL.DenseLayer(n_in=7, n_out=6, activation="tanh"),
                JInputType.recurrent(7, 3), x)


def test_activation_and_dropout_layers_match_jax():
    check_layer(JL.ActivationLayer(activation="elu"),
                JInputType.feed_forward(7), _rows())
    # dropout at retain 1.0 keeps every value, in training too
    drop = JL.DropoutLayer(activation="identity", dropout=1.0)
    tl = port_layer(drop)
    x = _rows()
    ref = drop.apply({}, {}, jnp.asarray(x), train=True,
                     rng=jax.random.PRNGKey(0))[0]
    got = tl.apply({}, torch.tensor(x), None, True,
                   torch.Generator().manual_seed(0))
    _close(got, ref, exact=True)
    check_layer(drop, JInputType.feed_forward(7), x)


@pytest.mark.parametrize("loss,act", [("mcxent", "softmax"),
                                      ("mse", "identity"),
                                      ("xent", "sigmoid")])
@pytest.mark.parametrize("kind", ["Output", "Loss"])
def test_output_and_loss_layers_match_jax(kind, loss, act):
    """The forward, and the loss's gradients by params and input (the
    fused softmax cross-entropy's plain version on the CPU, JAX's
    ``log_softmax`` there)."""
    rng = np.random.default_rng(8)
    n_out = 6
    x = _rows(f=7 if kind == "Output" else n_out)
    y = np.eye(n_out, dtype=np.float32)[rng.integers(0, n_out, 5)]
    if kind == "Output":
        jlayer = JL.OutputLayer(n_in=7, n_out=n_out, loss=loss, activation=act)
        itype = JInputType.feed_forward(7)
    else:
        jlayer = JL.LossLayer(loss=loss, activation=act)
        itype = JInputType.feed_forward(n_out)
    check_layer(jlayer, itype, x)
    tl = port_layer(jlayer)
    jp = jlayer.init_params(jax.random.PRNGKey(0), itype)
    lref, (gp, gx) = jax.value_and_grad(
        lambda p, xx: jlayer.compute_loss(p, xx, jnp.asarray(y)),
        argnums=(0, 1))(jp, jnp.asarray(x))
    tp = {k: torch.tensor(np.asarray(v), requires_grad=True)
          for k, v in jp.items()}
    xt = torch.tensor(x, requires_grad=True)
    got = tl.compute_loss(tp, xt, torch.tensor(y))
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(lref), rtol=RTOL,
                               atol=ATOL)
    _close(xt.grad, gx)
    for k in tp:
        _close(tp[k].grad, gp[k])
    assert tl.has_loss() and tuple(tl.regularizable_params()) == \
        tuple(jlayer.regularizable_params())
