"""The port's batch norm (``ops/batch_norm.py``, the ``BatchNormalization``
layer and its running state in ``MultiLayerNetwork``) and
``LocalResponseNormalization`` held against the JAX package on the CPU.

Each layer is the JAX dataclass, baked with the JAX global defaults, read
into the port through its JSON; params and state come from the JAX side
as numpy. Tolerances (float32, sums in another order): forward, new state
and gradients (``jax.grad`` through the JAX ``custom_vjp`` against
autograd, one random cotangent) within atol 1e-5 + rtol 1e-5; the output
of a constant channel, where the mean's rounding is scaled by
gamma / sqrt(eps), within atol 1e-3. A list config with batch norm
trained by ``fit`` for 2 steps: losses within 1e-5 relative, params and
running state within atol 1e-5, with and without
``gradient_checkpointing`` (which leaves the port's params and state
bitwise unchanged).
"""
import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from _torch_port import compile_cache_at
from deeplearning4j_tpu.nn.conf import layers as JL
from deeplearning4j_tpu.nn.conf import serde as jserde
from deeplearning4j_tpu.nn.conf.builders import GlobalConf as JGlobalConf
from deeplearning4j_tpu.nn.conf.builders import (
    NeuralNetConfiguration as JNNC)
from deeplearning4j_tpu.nn.conf.builders import bake_layer_defaults as jbake
from deeplearning4j_tpu.nn.conf.inputs import InputType as JInputType
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JNet
from deeplearning4j_tpu.ops.pallas_kernels import batch_norm_train as jbn
from deeplearning4j_tpu_torch.convert import from_jax, to_numpy
from deeplearning4j_tpu_torch.nn.conf.multilayer import (
    LayerConf, MultiLayerConfiguration)
from deeplearning4j_tpu_torch.nn.conf.serde import layer_class
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.ops.batch_norm import (
    batch_norm_stats, batch_norm_train)

ATOL = RTOL = 1e-5
CPU = torch.device("cpu")


def port_layer(jlayer):
    jbake(jlayer, JGlobalConf())
    d = jserde.to_dict(jlayer)
    t = d.pop("@type")
    return layer_class(t)(LayerConf(t, d), CPU)


def _close(got, want, atol=ATOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want), rtol=RTOL, atol=atol)


def _x(shape, seed=0, scale=1.0, shift=0.0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) * scale + shift).astype(np.float32)


SHAPES = {"nhwc": ((4, 5, 5, 8), JInputType.convolutional(5, 5, 8)),
          "ff": ((6, 7), JInputType.feed_forward(7))}


def _bn_case(kind, lock=False, **kw):
    shape, itype = SHAPES[kind]
    jl = JL.BatchNormalization(activation="relu", lock_gamma_beta=lock, **kw)
    jl.set_n_in(itype)
    tl = port_layer(jl)
    rng = np.random.default_rng(5)
    n = shape[-1]
    jp = {} if lock else {
        "gamma": jnp.asarray(rng.uniform(0.5, 1.5, n).astype(np.float32)),
        "beta": jnp.asarray(rng.standard_normal(n).astype(np.float32))}
    state = {"mean": rng.standard_normal(n).astype(np.float32),
             "var": rng.uniform(0.5, 2.0, n).astype(np.float32)}
    return jl, tl, jp, state


@pytest.mark.parametrize("train", [True, False], ids=["train", "infer"])
@pytest.mark.parametrize("lock", [False, True], ids=["params", "locked"])
@pytest.mark.parametrize("kind", sorted(SHAPES))
def test_batch_norm_forward_and_state_match_jax(kind, lock, train):
    jl, tl, jp, state = _bn_case(kind, lock, gamma=1.3, beta=-0.2)
    x = _x(SHAPES[kind][0], shift=0.5)
    jout, jstate = jl.apply(jp, {k: jnp.asarray(v) for k, v in state.items()},
                            jnp.asarray(x), train=train)
    assert sorted(tl.params()) == sorted(jp)
    tp = {k: torch.tensor(np.asarray(v)) for k, v in jp.items()}
    ts = {k: torch.tensor(v) for k, v in state.items()}
    tout, tstate = tl.apply_with_state(tp, ts, torch.tensor(x), train=train)
    _close(tout, jout)
    for k in ("mean", "var"):
        _close(tstate[k], jstate[k])
    if not train:
        assert tstate is ts  # inference hands the state back unchanged
    assert tl.regularizable_params() == ()


def test_batch_norm_constant_channel_clamps_var_at_zero():
    """A constant channel: E[x^2] - mean^2 rounds below 0 in float32 and is
    clamped at 0 in both packages; the output there is beta, up to the
    rounding of the mean times gamma / sqrt(eps)."""
    x = _x((8, 3, 3, 4), seed=1)
    x[..., 2] = np.float32(1.0000001)
    xt = torch.tensor(x)
    inv_n = 1.0 / 72
    raw = (xt * xt).sum((0, 1, 2)) * inv_n - (xt.sum((0, 1, 2)) * inv_n) ** 2
    assert float(raw[2]) < 0  # the cancellation this test is about
    mean, var = batch_norm_stats(xt)
    jmean, jvar = jbn(jnp.asarray(x), jnp.ones(4), jnp.zeros(4), (0, 1, 2),
                      1e-5, jnp.float32)[1:]
    assert float(var[2]) == 0.0 and float(jvar[2]) == 0.0
    _close(mean, jmean)
    _close(var, jvar)
    gamma, beta = torch.full((4,), 2.0), torch.full((4,), 0.25)
    out, _, _ = batch_norm_train(xt, gamma, beta, 1e-5)
    jout = jbn(jnp.asarray(x), jnp.full(4, 2.0), jnp.full(4, 0.25),
               (0, 1, 2), 1e-5, jnp.float32)[0]
    _close(out, jout, atol=1e-3)
    np.testing.assert_allclose(out[..., 2].numpy(), 0.25, atol=1e-3)


@pytest.mark.parametrize("kind", sorted(SHAPES))
def test_batch_norm_backward_matches_jax_custom_vjp(kind):
    shape = SHAPES[kind][0]
    n = shape[-1]
    axes = tuple(range(len(shape) - 1))
    x = _x(shape, seed=2, scale=2.0, shift=1.0)
    g = np.random.default_rng(3).uniform(0.5, 1.5, n).astype(np.float32)
    b = np.random.default_rng(4).standard_normal(n).astype(np.float32)
    ct = _x(shape, seed=6)

    def f(xx, gg, bb):
        return jnp.sum(jbn(xx, gg, bb, axes, 1e-5, jnp.float32)[0] * ct)

    jgx, jgg, jgb = jax.grad(f, argnums=(0, 1, 2))(
        jnp.asarray(x), jnp.asarray(g), jnp.asarray(b))
    xt, gt, bt = (torch.tensor(a, requires_grad=True) for a in (x, g, b))
    out, mean, var = batch_norm_train(xt, gt, bt, 1e-5)
    assert not mean.requires_grad and not var.requires_grad
    (out * torch.tensor(ct)).sum().backward()
    _close(xt.grad, jgx)
    _close(gt.grad, jgg)
    _close(bt.grad, jgb)


def test_batch_norm_layer_gradients_match_jax():
    """Through the layer (ReLU after the normalization), train mode."""
    jl, tl, jp, state = _bn_case("nhwc")
    x = _x(SHAPES["nhwc"][0], seed=7)
    js = {k: jnp.asarray(v) for k, v in state.items()}
    ct = _x(SHAPES["nhwc"][0], seed=8)
    jg = jax.grad(lambda p, xx: jnp.sum(
        jl.apply(p, js, xx, train=True)[0] * ct), argnums=(0, 1))(
            jp, jnp.asarray(x))
    tp = {k: torch.tensor(np.asarray(v), requires_grad=True)
          for k, v in jp.items()}
    xt = torch.tensor(x, requires_grad=True)
    out, _ = tl.apply_with_state(tp, {k: torch.tensor(v) for k, v in
                                      state.items()}, xt, train=True)
    (out * torch.tensor(ct)).sum().backward()
    _close(xt.grad, jg[1])
    for k in jp:
        _close(tp[k].grad, jg[0][k])


def test_local_response_normalization_matches_jax():
    jl = JL.LocalResponseNormalization(k=1.5, n=3, alpha=0.01, beta=0.6)
    tl = port_layer(jl)
    x = _x((2, 4, 4, 7), seed=9, scale=3.0)
    ct = _x((2, 4, 4, 7), seed=10)
    jout, jgx = jax.value_and_grad(
        lambda xx: jnp.sum(jl.apply({}, {}, xx)[0] * ct))(jnp.asarray(x))
    xt = torch.tensor(x, requires_grad=True)
    out = tl.apply({}, xt)
    _close(out, jl.apply({}, {}, jnp.asarray(x))[0])
    (out * torch.tensor(ct)).sum().backward()
    _close(xt.grad, jgx)
    assert tl.params() == {} and tl.regularizable_params() == ()


def _bn_list_conf(remat=False, lr=0.1):
    """Dense -> BN (ReLU) -> Output, Nesterov, a bias rate of its own (BN's
    beta takes it)."""
    b = (JNNC.builder().seed(3).learning_rate(lr).bias_learning_rate(0.05)
         .updater("nesterovs").momentum(0.9).weight_init("xavier")
         .gradient_checkpointing(remat))
    return (b.list()
            .layer(JL.DenseLayer(n_out=12, activation="identity"))
            .layer(JL.BatchNormalization(activation="relu", decay=0.8))
            .layer(JL.OutputLayer(n_out=3, loss="mcxent",
                                  activation="softmax"))
            .set_input_type(JInputType.feed_forward(5)).build())


def _bn_batches(n=2):
    rng = np.random.default_rng(11)
    return [(rng.standard_normal((16, 5)).astype(np.float32) * 2 + 1,
             np.eye(3, dtype=np.float32)[rng.integers(0, 3, 16)], None, None)
            for _ in range(n)]


def _jax_fit(conf, batches, cache):
    """The JAX network from its seed, fit one step a batch: its initial
    params and state, and its losses, params and state after."""
    with compile_cache_at(cache):
        jnet = JNet(conf).init()
        out = {"params0": _np_list(jnet.params_list),
               "state0": _np_list(jnet.state_list), "losses": []}
        for x, y, _, _ in batches:
            jnet.fit(x, y)
            out["losses"].append(float(jnet.score_value))
        out["params"] = _np_list(jnet.params_list)
        out["state"] = _np_list(jnet.state_list)
        out["net"] = jnet
    return out


def _np_list(tree):
    return [{k: np.asarray(v) for k, v in d.items()} for d in tree]


@pytest.mark.parametrize("remat", [False, True], ids=["plain", "checkpointed"])
def test_list_config_with_batch_norm_trains_as_jax(remat, tmp_path):
    """Two ``fit`` steps: losses, params and the running state (decay 0.8,
    biased variance, one EMA step a fit step) as in the JAX package, with
    and without ``gradient_checkpointing``."""
    conf = _bn_list_conf(remat)
    batches = _bn_batches()
    ref = _jax_fit(conf, batches, tmp_path)
    net = from_jax(conf.to_json(), ref["params0"], device="cpu",
                   state_list=ref["state0"])
    losses = []
    for x, y, _, _ in batches:
        net.fit(x, y)
        losses.append(net.score_value)
    np.testing.assert_allclose(losses, ref["losses"], rtol=1e-5)
    for got, want in ((net.params_list, ref["params"]),
                      (net.state_list, ref["state"])):
        for g, w in zip(to_numpy(got), want):
            assert sorted(g) == sorted(w)
            for k in w:
                _close(g[k], w[k])
    assert ref["state"][1]["var"].min() > 0


def test_gradient_checkpointing_writes_the_state_once(tmp_path):
    """The checkpointed step runs the BN forward again in the backward; the
    state it writes and the params it takes are bitwise those of the plain
    step."""
    params0 = _jax_fit(_bn_list_conf(), [], tmp_path)["params0"]
    nets = []
    for remat in (False, True):
        net = from_jax(_bn_list_conf(remat).to_json(), params0, device="cpu")
        for x, y, _, _ in _bn_batches():
            net.fit(x, y)
        nets.append(net)
    for attr in ("state_list", "params_list"):
        for a, b in zip(getattr(nets[0], attr), getattr(nets[1], attr)):
            for k in a:
                assert torch.equal(a[k], b[k]), (attr, k)


def test_clone_and_load_params_carry_the_state(tmp_path):
    """``clone`` and ``load_params``/``from_jax`` carry the batch-norm state
    as well as the params: the eval-mode outputs match the JAX network's."""
    conf = _bn_list_conf()
    ref = _jax_fit(conf, _bn_batches(), tmp_path)
    x = _bn_batches(1)[0][0]
    want = np.asarray(ref["net"].output(x))
    net = from_jax(conf.to_json(), ref["params"], device="cpu",
                   state_list=ref["state"])
    _close(net.output(x), want)
    # without the state the eval-mode function differs
    without = from_jax(conf.to_json(), ref["params"], device="cpu")
    assert not np.allclose(without.output(x).numpy(), want, atol=1e-3)
    twin = MultiLayerNetwork(json_conf_port(conf), device="cpu").load_params(
        ref["params"], ref["state"])
    _close(twin.output(x), want)
    clone = net.clone()
    _close(clone.output(x), want)
    # copies, not aliases: training the clone leaves the source's state
    before = [{k: v.clone() for k, v in s.items()} for s in net.state_list]
    clone.fit(x, np.eye(3, dtype=np.float32)[np.arange(16) % 3])
    for a, b in zip(before, net.state_list):
        for k in a:
            assert torch.equal(a[k], b[k])
    assert not torch.equal(clone.state_list[1]["mean"],
                           net.state_list[1]["mean"])
    with pytest.raises(ValueError):
        net.load_state([{}, {"mean": np.zeros(12)}, {}])


def json_conf_port(jconf):
    return MultiLayerConfiguration.from_json(jconf.to_json())


def test_batch_norm_config_round_trips_with_jax():
    conf = _bn_list_conf()
    port = json_conf_port(conf)
    assert json.loads(port.to_json()) == json.loads(conf.to_json())
