"""The port's mixture-of-experts layers and ``SelfAttentionLayer`` held
against the JAX package on the CPU.

- ``MoELayer`` routing (the top-1 expert of every token equal, gates and
  router probabilities within 1e-6), the Switch balance term, and each
  token's output through its own expert (the twins of ``tests/test_moe.py``).
- ``MoELayer`` and ``MoETransformerBlock`` in a network: the training loss
  (with the weighted balance term) and every gradient against
  ``jax.value_and_grad`` of the JAX ``loss_fn`` (losses 1e-5 relative,
  gradients 1e-5 absolute), a masked batch too; the term enters the
  objective of both network types and of graph TBPTT, and is 0 in eval;
  the port's float64 gradient check passes on a MoE layer.
- ``moe_transformer_lm``: 2 Adam ``fit`` steps against the JAX ``fit``
  (losses 1e-5 relative; params within 1e-5 but for 0.1% of them, and
  all within the port's Adam bound of 2 lr a step), the K-step dispatch
  bitwise equal to single steps, and int8 ``PredictFn`` (3-D expert
  leaves quantized per output channel, dequantized in the forward)
  against the JAX one within 1e-5.
- ``SelfAttentionLayer``: non-causal by default, with and without a key
  mask; forward and gradients against JAX (its attention is the flash
  kernels' plain version here, XLA's math in the JAX package).
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import _np_tree as _np
from _torch_port import jax_train
from deeplearning4j_tpu.models.transformer import (
    moe_transformer_lm as jax_moe_lm)
from deeplearning4j_tpu.nn.conf.builders import NeuralNetConfiguration as JNNC
from deeplearning4j_tpu.nn.conf.inputs import InputType as JInputType
from deeplearning4j_tpu.nn.conf.layers import GlobalPoolingLayer as JPool
from deeplearning4j_tpu.nn.conf.layers import GravesLSTM as JLSTM
from deeplearning4j_tpu.nn.conf.layers import OutputLayer as JOut
from deeplearning4j_tpu.nn.conf.layers import RnnOutputLayer as JRnnOut
from deeplearning4j_tpu.nn.conf.layers import SelfAttentionLayer as JSA
from deeplearning4j_tpu.nn.conf.layers.moe import MoELayer as JMoE
from deeplearning4j_tpu.nn.conf.layers.moe import (
    MoETransformerBlock as JMoEBlock)
from deeplearning4j_tpu.nn.graph_network import ComputationGraph as JGraph
from deeplearning4j_tpu.nn.graph_network import graph_loss as jgraph_loss
from deeplearning4j_tpu.nn.inference import PredictFn as JPredictFn
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JNet
from deeplearning4j_tpu.nn.multilayer import loss_fn as jloss_fn
from deeplearning4j_tpu_torch.convert import from_jax, to_numpy
from deeplearning4j_tpu_torch.models import moe_transformer_lm
from deeplearning4j_tpu_torch.nn.inference import PredictFn
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork, loss_fn

REL, ATOL = 1e-5, 1e-5


def _list_net(first, head, input_type, seed=11, lr=0.05):
    conf = (JNNC.builder().seed(seed).learning_rate(lr).updater("adam").list()
            .layer(first).layer(head).set_input_type(input_type).build())
    jnet = JNet(conf).init()
    return jnet, from_jax(conf.to_json(), _np(jnet.params_list),
                          device="cpu", state_list=_np(jnet.state_list))


def _moe_net(aux_w=0.01, activation="identity"):
    return _list_net(
        JMoE(n_in=8, n_out=8, n_experts=4, expert_hidden=16,
             activation=activation, aux_loss_weight=aux_w),
        JRnnOut(n_in=8, n_out=3, loss="mcxent", activation="softmax"),
        JInputType.recurrent(8, 4))


def _block_net():
    return _list_net(
        JMoEBlock(n_in=8, n_out=8, n_heads=2, n_experts=3, expert_hidden=12,
                  causal=True, activation="identity"),
        JRnnOut(n_in=8, n_out=3, loss="mcxent", activation="softmax"),
        JInputType.recurrent(8, 5))


def _seq(shape, seed=0):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _labels(B, T, C, seed=1):
    return np.eye(C, dtype=np.float32)[
        np.random.default_rng(seed).integers(0, C, (B, T))]


def test_routing_and_balance_term_match_jax():
    jnet, tnet = _moe_net()
    jl, tl = jnet.conf.layers[0], tnet.layers[0]
    jp, tp = jnet.params_list[0], tnet.params_list[0]
    x2d = _seq((64, 8), seed=3)
    je, jg, jprobs = jl.route(jp, jnp.asarray(x2d))
    with torch.no_grad():
        te, tg, tprobs = tl.route(tp, torch.from_numpy(x2d))
        lb = float(tl.load_balance_loss(tp, torch.from_numpy(x2d)))
    np.testing.assert_array_equal(te.numpy(), np.asarray(je))
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), atol=1e-6)
    np.testing.assert_allclose(tprobs.numpy(), np.asarray(jprobs), atol=1e-6)
    np.testing.assert_allclose(
        lb, float(jl.load_balance_loss(jp, jnp.asarray(x2d))), rtol=REL)
    assert 0.99 <= lb < 4.0  # 1 is a perfect balance
    # each token through its own expert, scaled by its gate
    x = torch.from_numpy(_seq((2, 4, 8)))
    with torch.no_grad():
        y = tnet.output(x).reshape(-1, 3)
        h = tl.apply(tp, x).reshape(-1, 8)
        e, g, _ = tl.route(tp, x.reshape(-1, 8))
        for s in (0, 3, 7):
            hid = torch.relu(x.reshape(-1, 8)[s] @ tp["W1"][e[s]]
                             + tp["b1"][e[s]])
            torch.testing.assert_close(
                h[s], (hid @ tp["W2"][e[s]] + tp["b2"][e[s]]) * g[s],
                rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(y.numpy(), np.asarray(jnet.output(
        x.numpy())).reshape(-1, 3), atol=1e-6)


def _jax_loss_and_grads(jnet, x, y, fmask=None):
    def lf(p):
        return jloss_fn(jnet.conf, p, jnet.state_list, jnp.asarray(x),
                        jnp.asarray(y), None,
                        None if fmask is None else jnp.asarray(fmask))
    (loss, states), grads = jax.jit(jax.value_and_grad(lf, has_aux=True))(
        jnet.params_list)
    return float(loss), grads, states


def _assert_grads(tgrads, jgrads):
    for tg, jg in zip(tgrads, jgrads):
        for k in jg:
            np.testing.assert_allclose(to_numpy(tg[k]), np.asarray(jg[k]),
                                       rtol=0, atol=ATOL, err_msg=k)


@pytest.mark.parametrize("kind", ["moe_layer", "moe_block",
                                  "moe_block_masked"])
def test_training_loss_and_gradients_match_jax(kind):
    """The train-mode loss, balance term included, and every gradient; the
    layer publishes the term in its state in training and 0 in eval."""
    jnet, tnet = _moe_net() if kind == "moe_layer" else _block_net()
    T = 4 if kind == "moe_layer" else 5
    x, y = _seq((3, T, 8), seed=4), _labels(3, T, 3)
    fmask = None
    if kind.endswith("masked"):
        fmask = np.ones((3, T), np.float32)
        fmask[1, 3:] = 0
        fmask[2, 1:] = 0
    jloss, jgrads, jstates = _jax_loss_and_grads(jnet, x, y, fmask)
    tp = tnet.params_list
    tloss, tstates = loss_fn(tnet, tp, torch.from_numpy(x),
                             torch.from_numpy(y),
                             fmask=None if fmask is None
                             else torch.from_numpy(fmask))
    np.testing.assert_allclose(float(tloss.detach()), jloss, rtol=REL)
    np.testing.assert_allclose(float(tstates[0]["aux_loss"].detach()),
                               float(jstates[0]["aux_loss"]), rtol=REL)
    keys = [(i, k) for i, p in enumerate(tp) for k in p]
    got = torch.autograd.grad(tloss, [tp[i][k] for i, k in keys])
    tgrads = [{} for _ in tp]
    for (i, k), g in zip(keys, got):
        tgrads[i][k] = g
    _assert_grads(tgrads, jgrads)
    assert float(tgrads[0]["Wg"].abs().sum()) > 0
    with torch.no_grad():
        _, eval_state = tnet.layers[0].apply_with_state(
            tp[0], tnet.state_list[0], torch.from_numpy(x))
    assert float(eval_state["aux_loss"]) == 0.0


def test_moe_layer_gradient_check_passes():
    """The JAX battery's MoE layer case through the port's float64 check
    (the router's argmax does not flip at eps 1e-6 on this data)."""
    from deeplearning4j_tpu_torch.nn.gradientcheck import check_gradients

    _, tnet = _moe_net()
    x, y = _seq((2, 4, 8), seed=13), _labels(2, 4, 3, seed=13)
    assert check_gradients(tnet, x, y, subset=80)


def test_balance_term_enters_both_objectives():
    """Weight 0.5 against 0 on the same params: the losses differ by half
    the term, in a list network and in a graph, as in the JAX package."""
    x, y = _seq((32, 6), seed=0), np.eye(3, dtype=np.float32)[
        np.random.default_rng(0).integers(0, 3, 32)]
    for build in ("list", "graph"):
        losses, terms = {}, {}
        for w in (0.0, 0.5):
            moe = JMoE(n_in=6, n_out=6, n_experts=4, expert_hidden=8,
                       activation="relu", aux_loss_weight=w)
            out = JOut(n_in=6, n_out=3, loss="mcxent", activation="softmax")
            if build == "list":
                conf = JNNC.builder().seed(11).list().layer(moe).layer(
                    out).build()
                jnet = JNet(conf).init(seed=11)
            else:
                conf = (JNNC.builder().seed(11).graph_builder()
                        .add_inputs("in").add_layer("moe", moe, "in")
                        .add_layer("out", out, "moe").set_outputs("out")
                        .build())
                jnet = JGraph(conf).init(seed=11)
            tnet = from_jax(conf.to_json(), _np(jnet.params_list),
                            device="cpu")
            _, loss = tnet.gradient_and_score(
                *(([x], [y]) if build == "graph" else (x, y)))
            if build == "graph":
                jloss = jax.jit(lambda p: jgraph_loss(
                    conf, p, jnet.state_list, [x], [y], None)[0])(
                        jnet.params_list)
            else:
                jloss = jax.jit(lambda p: jloss_fn(
                    conf, p, jnet.state_list, x, y, None)[0])(jnet.params_list)
            np.testing.assert_allclose(loss, jloss, rtol=REL)
            losses[w] = loss
            layer = (tnet.vertex_layers["moe"] if build == "graph"
                     else tnet.layers[0])
            params = (tnet.params_list["moe"] if build == "graph"
                      else tnet.params_list[0])
            with torch.no_grad():
                terms[w] = float(layer.load_balance_loss(
                    params, torch.from_numpy(x)))
        np.testing.assert_allclose(losses[0.5] - losses[0.0],
                                   0.5 * terms[0.5], rtol=1e-4)


def test_moe_vertex_graph_tbptt_keeps_balance_term():
    """A MoE vertex under graph TBPTT keeps its balance term (the JAX
    package's own test, held to the JAX graph's loss)."""
    def build(aux_w):
        return (JNNC.builder().seed(9).learning_rate(0.0)
                .graph_builder().add_inputs("in")
                .add_layer("lstm", JLSTM(n_in=4, n_out=8, activation="tanh"),
                           "in")
                .add_layer("moe", JMoE(n_in=8, n_out=8, n_experts=4,
                                       expert_hidden=8, activation="identity",
                                       aux_loss_weight=aux_w), "lstm")
                .add_layer("out", JRnnOut(n_in=8, n_out=4, loss="mcxent",
                                          activation="softmax"), "moe")
                .set_outputs("out").backprop_type("TruncatedBPTT")
                .t_bptt_forward_length(4).build())

    x = _seq((4, 8, 4), seed=5)
    y = _labels(4, 8, 4, seed=5)
    losses = {}
    for w in (0.0, 0.5):
        jnet = JGraph(build(w)).init()
        tnet = from_jax(jnet.conf.to_json(), _np(jnet.params_list),
                        device="cpu")
        jnet.fit([x], [y])
        tnet.fit([x], [y])
        np.testing.assert_allclose(tnet.score_value, float(jnet.score_value),
                                   rtol=REL)
        losses[w] = tnet.score_value
    assert losses[0.5] > losses[0.0] + 0.4


def _lm_batch(B=4, T=8, V=16, seed=2):
    ids = np.random.default_rng(seed).integers(0, V, (B, T))
    x = np.eye(V, dtype=np.float32)[ids]
    return x, x.copy()


def test_moe_transformer_lm_config_and_two_steps_match_jax(tmp_path):
    conf = jax_moe_lm(16, width=16, n_layers=2, n_heads=2, n_experts=4,
                      max_len=8, learning_rate=0.01)
    assert json.loads(moe_transformer_lm(
        16, width=16, n_layers=2, n_heads=2, n_experts=4, max_len=8,
        learning_rate=0.01).to_json()) == json.loads(conf.to_json())
    x, y = _lm_batch()
    ref = jax_train(conf.to_json(), [(x, y, None, None)] * 2, tmp_path)
    tnet = from_jax(conf.to_json(), ref["params0"], device="cpu")
    losses = []
    for _ in range(2):
        tnet.fit(x, y)
        losses.append(tnet.score_value)
    np.testing.assert_allclose(losses, ref["losses"], rtol=REL)
    # Adam divides by the gradient's own size, so a gradient within
    # rounding of 0 can step either way: every param within 2 lr a step
    # (the port's Adam bound, tests/test_torch_training.py), and all but
    # 0.1% of them within 1e-5
    diffs = np.concatenate([np.abs(to_numpy(tp[k]) - jp[k]).ravel()
                            for tp, jp in zip(tnet.params_list, ref["params"])
                            for k in jp])
    assert diffs.max() <= 2 * 0.01 * 2
    assert np.mean(diffs > ATOL) < 1e-3
    # routing of the trained network is the JAX one, token by token
    jnet = JNet(conf).init()
    jnet.params_list = [{k: jnp.asarray(v) for k, v in p.items()}
                        for p in ref["params"]]
    h = torch.from_numpy(x)
    with torch.no_grad():
        h = tnet.layers[0].apply(tnet.params_list[0], h)
    block, jblock = tnet.layers[1], conf.layers[1]
    with torch.no_grad():
        te = block.route(tnet.params_list[1], h.reshape(-1, 16))[0]
    je = jblock.route(jnet.params_list[1], jnp.asarray(h.numpy()).reshape(
        -1, 16))[0]
    np.testing.assert_array_equal(te.numpy(), np.asarray(je))


def test_moe_lm_ksteps_equal_single_steps():
    """``fit(x, y, epochs=4)`` through the K-step dispatch (a plain loop of
    the step on the CPU) equals four single steps bitwise."""
    conf = moe_transformer_lm(16, width=16, n_layers=2, n_heads=2,
                              n_experts=4, max_len=8, learning_rate=0.01)
    a = MultiLayerNetwork(conf, device="cpu").init()
    b = a.clone()
    a.dispatch_ksteps = 2
    x, y = _lm_batch()
    a.fit(x, y, epochs=4)
    for _ in range(4):
        b.fit(x, y)
    assert a.iteration == b.iteration == 4
    for pa, pb in zip(a.params_list + a.state_list,
                      b.params_list + b.state_list):
        for k in pa:
            assert torch.equal(pa[k], pb[k]), k


def test_int8_predict_matches_jax():
    """int8 serving quantizes the 3-D expert leaves (one scale per output
    channel, shared across experts) and the forward dequantizes them; the
    port's int8 answer is the JAX one."""
    conf = jax_moe_lm(32, width=32, n_layers=1, n_heads=2, n_experts=4,
                      max_len=8)
    jnet = JNet(conf).init()
    tnet = from_jax(conf.to_json(), _np(jnet.params_list), device="cpu")
    x, _ = _lm_batch(B=2, V=32)
    pf = PredictFn(tnet, quant="int8", device="cpu")
    w1 = pf._params[1]["W1"]
    assert w1.q.dtype == torch.int8 and tuple(w1.scale.shape) == (128,)
    ref = np.asarray(JPredictFn(jnet, quant="int8")(x))
    np.testing.assert_allclose(pf(x).numpy(), ref, rtol=0, atol=1e-5)
    dense = PredictFn(tnet, device="cpu")(x).numpy()
    assert np.abs(dense - ref).max() > 0  # the int8 answer is its own


# ------------------------------------------------------------ self-attention
def _attention_net(causal=None):
    fields = {} if causal is None else {"causal": causal}
    conf = (JNNC.builder().seed(5).learning_rate(0.05).updater("adam").list()
            .layer(JSA(n_in=8, n_out=8, n_heads=2, activation="identity",
                       **fields))
            .layer(JPool(pooling_type="avg"))
            .layer(JOut(n_in=8, n_out=3, loss="mcxent", activation="softmax"))
            .set_input_type(JInputType.recurrent(8, 6)).build())
    jnet = JNet(conf).init()
    return jnet, from_jax(conf.to_json(), _np(jnet.params_list), device="cpu")


@pytest.mark.parametrize("case", ["default", "masked", "causal"])
def test_self_attention_matches_jax(case):
    """Non-causal by default (a later key changes an earlier output), with
    a ragged key mask, and causal: the loss and every gradient against
    JAX, and two ``fit`` steps."""
    jnet, tnet = _attention_net(True if case == "causal" else None)
    assert tnet.layers[0].causal is (case == "causal")
    x = _seq((3, 6, 8), seed=6)
    y = np.eye(3, dtype=np.float32)[[0, 2, 1]]
    fmask = None
    if case == "masked":
        fmask = np.ones((3, 6), np.float32)
        fmask[0, 4:] = 0
        fmask[2, 2:] = 0
    jgrads, jloss = jnet.gradient_and_score(x, y, fmask=fmask)
    tgrads, tloss = tnet.gradient_and_score(x, y, fmask=fmask)
    np.testing.assert_allclose(tloss, jloss, rtol=REL)
    _assert_grads(tgrads, jgrads)
    if case == "default":
        later = x.copy()
        later[:, -1] += 1.0
        with torch.no_grad():
            a = tnet.layers[0].apply(tnet.params_list[0], torch.from_numpy(x))
            b = tnet.layers[0].apply(tnet.params_list[0],
                                     torch.from_numpy(later))
        assert float((a[:, 0] - b[:, 0]).abs().max()) > 1e-4
        np.testing.assert_allclose(tnet.output(x).numpy(),
                                   np.asarray(jnet.output(x)), atol=1e-6)
    for _ in range(2):
        jnet.fit(x, y, fmask=fmask)
        tnet.fit(x, y, fmask=fmask)
        np.testing.assert_allclose(tnet.score_value, float(jnet.score_value),
                                   rtol=REL)
