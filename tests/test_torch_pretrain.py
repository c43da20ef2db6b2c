"""The port's layerwise pretraining held against the JAX package on the CPU:
``AutoEncoder``, ``RBM`` and ``VariationalAutoencoder`` (its four
reconstruction distributions), ``MultiLayerNetwork`` and
``ComputationGraph`` ``pretrain``/``pretrain_layer``, ``fit_iterator`` of a
``pretrain(True)`` config, and the pretraining gradient checks.

``jax.random`` bits cannot be made in torch, so every comparison of a
random objective passes the JAX draws in ``noise=``: the uniforms of a
Bernoulli draw (``jax.random.bernoulli(key, p, shape)`` is
``uniform(key, shape) < p``, pinned below), the RBM's ``2k + 1`` keys'
uniforms, the VAE's ``num_samples`` keys' normals. Losses agree within
1e-5 relative and gradients within 1e-5 absolute (float32 sums in another
order); parameters after 3 pretraining steps within 1e-5. Loops whose JAX
draws cannot be passed in (``pretrain_layer`` draws from the network's own
key) run on deterministic objectives: an AutoEncoder without corruption.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import _np_tree as _np
from deeplearning4j_tpu.datasets.dataset import DataSet as JDataSet
from deeplearning4j_tpu.datasets.iterators import (
    ExistingDataSetIterator as JExisting)
from deeplearning4j_tpu.nn.conf.builders import NeuralNetConfiguration as JNNC
from deeplearning4j_tpu.nn.conf.layers import AutoEncoder as JAE
from deeplearning4j_tpu.nn.conf.layers import DenseLayer as JDense
from deeplearning4j_tpu.nn.conf.layers import OutputLayer as JOut
from deeplearning4j_tpu.nn.conf.layers import RBM as JRBM
from deeplearning4j_tpu.nn.conf.layers import VariationalAutoencoder as JVAE
from deeplearning4j_tpu.nn.conf.layers import variational as jvar
from deeplearning4j_tpu.nn.conf.multilayer import (
    MultiLayerConfiguration as JConf)
from deeplearning4j_tpu.nn.graph_network import ComputationGraph as JGraph
from deeplearning4j_tpu.nn.graph_network import (
    make_graph_pretrain_step as jgraph_pretrain_step)
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JNet
from deeplearning4j_tpu.nn.multilayer import (
    make_pretrain_step as jpretrain_step)
from deeplearning4j_tpu_torch.convert import from_jax, to_numpy
from deeplearning4j_tpu_torch.datasets.dataset import DataSet
from deeplearning4j_tpu_torch.datasets.iterators import (
    ExistingDataSetIterator)
from deeplearning4j_tpu_torch.nn.conf.builders import NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.conf.layers import (
    RBM, AutoEncoder, CompositeReconstructionDistribution, DenseLayer,
    ExponentialReconstructionDistribution, GaussianReconstructionDistribution,
    OutputLayer, VariationalAutoencoder)
from deeplearning4j_tpu_torch.nn.conf.multilayer import (
    MultiLayerConfiguration)
from deeplearning4j_tpu_torch.nn.gradientcheck import (
    check_graph_pretrain_gradients, check_pretrain_gradients)
from deeplearning4j_tpu_torch.nn.graph_network import (
    make_graph_pretrain_step)
from deeplearning4j_tpu_torch.nn.multilayer import make_pretrain_step

REL, ATOL = 1e-5, 1e-5


def _composite():
    return (jvar.CompositeReconstructionDistribution()
            .add(2, jvar.GaussianReconstructionDistribution(activation="tanh"))
            .add(2, jvar.BernoulliReconstructionDistribution())
            .add(2, jvar.ExponentialReconstructionDistribution()))


#: one pretraining layer a case (n_in 6), and the data it is held on
LAYERS = {
    "ae": lambda: JAE(n_in=6, n_out=4, activation="sigmoid",
                      corruption_level=0.3),
    "ae_sparse_xent": lambda: JAE(n_in=6, n_out=4, activation="sigmoid",
                                  corruption_level=0.2, sparsity=0.05,
                                  pretrain_loss_fn="xent"),
    "rbm_k1": lambda: JRBM(n_in=6, n_out=5, k=1, activation="sigmoid"),
    "rbm_k2": lambda: JRBM(n_in=6, n_out=5, k=2, activation="sigmoid"),
    "rbm_gaussian": lambda: JRBM(n_in=6, n_out=5, k=2, activation="sigmoid",
                                 visible_unit="gaussian"),
    "vae_gaussian": lambda: JVAE(n_in=6, n_out=3, encoder_layer_sizes=(7, 5),
                                 decoder_layer_sizes=(5,), activation="tanh",
                                 num_samples=2),
    "vae_bernoulli": lambda: JVAE(n_in=6, n_out=3, encoder_layer_sizes=(7,),
                                  decoder_layer_sizes=(7,),
                                  activation="relu",
                                  reconstruction_distribution="bernoulli"),
    "vae_composite": lambda: JVAE(n_in=6, n_out=3, encoder_layer_sizes=(5,),
                                  decoder_layer_sizes=(5,), activation="tanh",
                                  reconstruction_distribution=_composite(),
                                  num_samples=3),
}


def _data(case, n=8, seed=0):
    rng = np.random.default_rng(seed)
    if case.startswith("rbm") and "gaussian" not in case or case in (
            "vae_bernoulli", "ae_sparse_xent"):
        return (rng.uniform(size=(n, 6)) > 0.5).astype(np.float32)
    if case == "vae_composite":
        return np.concatenate([rng.normal(size=(n, 2)),
                               (rng.uniform(size=(n, 2)) > 0.5),
                               rng.exponential(size=(n, 2))],
                              axis=1).astype(np.float32)
    if case.startswith("ae"):
        return rng.uniform(size=(n, 6)).astype(np.float32)
    return rng.normal(size=(n, 6)).astype(np.float32)


def jax_noise(layer, key, n):
    """The draws the JAX layer's ``pretrain_loss(rng=key)`` makes on an
    ``[n, n_in]`` batch, as the port's ``noise`` argument takes them."""
    if isinstance(layer, JAE):
        return np.asarray(jax.random.uniform(key, (n, layer.n_in)))
    if isinstance(layer, JRBM):
        keys = jax.random.split(key, 2 * layer.k + 1)
        shapes = ([(n, layer.n_out)]
                  + [(n, layer.n_in), (n, layer.n_out)] * layer.k)
        return [np.asarray(jax.random.uniform(k, s))
                for k, s in zip(keys, shapes)]
    keys = jax.random.split(key, layer.num_samples)
    return [np.asarray(jax.random.normal(k, (n, layer.n_out)))
            for k in keys]


def _torch_noise(noise):
    if isinstance(noise, list):
        return [torch.tensor(a) for a in noise]
    return torch.tensor(noise)


def _stack(layer, updater="sgd", pretrain=False, lr=0.05):
    """A JAX net: a dense layer, the pretraining layer, an output layer."""
    lb = (JNNC.builder().seed(7).learning_rate(lr).updater(updater).list()
          .layer(JDense(n_in=5, n_out=6, activation="tanh"))
          .layer(layer)
          .layer(JOut(n_in=layer.n_out, n_out=3, loss="mcxent",
                      activation="softmax")))
    if pretrain:
        lb = lb.pretrain(True)
    return JNet(lb.build()).init()


def _assert_tree_close(ours, ref, atol, what):
    for k in ref:
        np.testing.assert_allclose(to_numpy(ours[k]), np.asarray(ref[k]),
                                   rtol=0, atol=atol, err_msg=f"{what} {k}")


def test_jax_bernoulli_is_uniform_below_p():
    key = jax.random.PRNGKey(3)
    p = jnp.linspace(0.0, 1.0, 40).reshape(5, 8)
    assert np.array_equal(np.asarray(jax.random.bernoulli(key, p)),
                          np.asarray(jax.random.uniform(key, p.shape) < p))
    assert np.array_equal(
        np.asarray(jax.random.bernoulli(key, 0.7, (5, 8))),
        np.asarray(jax.random.uniform(key, (5, 8)) < 0.7))


@pytest.mark.parametrize("case", sorted(LAYERS))
def test_pretrain_loss_and_gradients_match_jax(case):
    jnet = _stack(LAYERS[case]())
    tnet = from_jax(jnet.conf.to_json(), _np(jnet.params_list), device="cpu")
    jlayer, tlayer = jnet.conf.layers[1], tnet.layers[1]
    assert tlayer.is_pretrain_layer() and not tnet.layers[0].is_pretrain_layer()
    x = _data(case)
    key = jax.random.PRNGKey(11)
    noise = jax_noise(jlayer, key, len(x))
    jp = jnet.params_list[1]
    jloss, jgrads = jax.value_and_grad(
        lambda p: jlayer.pretrain_loss(p, jnp.asarray(x), rng=key))(jp)
    tp = tnet.params_list[1]
    tloss = tlayer.pretrain_loss(tp, torch.from_numpy(x),
                                 noise=_torch_noise(noise))
    tgrads = torch.autograd.grad(tloss, [tp[k] for k in sorted(tp)])
    np.testing.assert_allclose(float(tloss.detach()), float(jloss), rtol=REL)
    scale = max(1.0, max(float(np.abs(np.asarray(g)).max())
                         for g in jgrads.values()))
    _assert_tree_close(dict(zip(sorted(tp), tgrads)), jgrads, ATOL * scale,
                       case)


def test_cd_surrogate_gradient_is_the_cd_update():
    """The RBM surrogate's gradient is the negative CD-1 update, computed
    by hand from the chain (twin of the JAX gradient battery's check)."""
    jnet = _stack(JRBM(n_in=6, n_out=5, k=1, activation="sigmoid"))
    tnet = from_jax(jnet.conf.to_json(), _np(jnet.params_list), device="cpu")
    rbm, p = tnet.layers[1], tnet.params_list[1]
    x = torch.from_numpy(_data("rbm_k1"))
    noise = _torch_noise(jax_noise(jnet.conf.layers[1], jax.random.PRNGKey(9),
                                   len(x)))
    ph, vk, hk, draws = rbm.gibbs_chain(p, x, noise=noise)
    assert len(draws) == 2 and all(torch.equal(s, (u < q).float())
                                   for u, q, s in draws)
    grads = dict(zip(("W", "b", "vb"), torch.autograd.grad(
        rbm.pretrain_loss(p, x, noise=noise), [p["W"], p["b"], p["vb"]])))
    n = x.shape[0]
    expect = {"W": -(x.t() @ ph - vk.t() @ hk) / n,
              "vb": -(x.mean(0) - vk.mean(0)),
              "b": -(ph.mean(0) - hk.mean(0))}
    for k in expect:
        torch.testing.assert_close(grads[k], expect[k], rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("case", ["vae_gaussian", "vae_bernoulli",
                                  "vae_composite"])
def test_vae_forward_reconstruct_and_log_probability_match_jax(case):
    jnet = _stack(LAYERS[case]())
    tnet = from_jax(jnet.conf.to_json(), _np(jnet.params_list), device="cpu")
    jlayer, tlayer = jnet.conf.layers[1], tnet.layers[1]
    x = _data(case, seed=3)
    jp, tp = jnet.params_list[1], tnet.params_list[1]
    np.testing.assert_allclose(
        tnet.output(np.random.default_rng(4).normal(size=(8, 5))
                    .astype(np.float32)).numpy(),
        np.asarray(jnet.output(np.random.default_rng(4).normal(size=(8, 5))
                               .astype(np.float32))), rtol=0, atol=1e-6)
    with torch.no_grad():
        np.testing.assert_allclose(
            tlayer.reconstruct(tp, torch.from_numpy(x)).numpy(),
            np.asarray(jlayer.reconstruct(jp, jnp.asarray(x))), atol=1e-6)
        key = jax.random.PRNGKey(5)
        ref = jlayer.reconstruction_log_probability(jp, jnp.asarray(x),
                                                    rng=key, num_samples=4)
        noise = [np.asarray(jax.random.normal(k, (8, 3)))
                 for k in jax.random.split(key, 4)]
        got = tlayer.reconstruction_log_probability(
            tp, torch.from_numpy(x), noise=_torch_noise(noise),
            num_samples=4)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=REL,
                               atol=1e-5)


def test_composite_distribution_json_matches_jax():
    """A Composite distribution writes the JAX JSON, reads back in both
    packages, and the JAX reader rebuilds the distribution objects (the
    twin of the JAX config serde test)."""
    jconf = (JNNC.builder().seed(1).list()
             .layer(JVAE(n_in=5, n_out=2, reconstruction_distribution=(
                 jvar.CompositeReconstructionDistribution()
                 .add(3, jvar.GaussianReconstructionDistribution(
                     activation="tanh"))
                 .add(2, jvar.ExponentialReconstructionDistribution()))))
             .layer(JOut(n_in=2, n_out=2, loss="mse", activation="identity"))
             .build())
    comp = (CompositeReconstructionDistribution()
            .add(3, GaussianReconstructionDistribution(activation="tanh"))
            .add(2, ExponentialReconstructionDistribution()))
    tconf = (NeuralNetConfiguration.builder().seed(1).list()
             .layer(VariationalAutoencoder.conf(
                 n_in=5, n_out=2, reconstruction_distribution=comp))
             .layer(OutputLayer.conf(n_in=2, n_out=2, loss="mse",
                                     activation="identity"))
             .build())
    assert json.loads(tconf.to_json()) == json.loads(jconf.to_json())
    again = MultiLayerConfiguration.from_json(jconf.to_json())
    assert json.loads(again.to_json()) == json.loads(jconf.to_json())
    rd = JConf.from_json(tconf.to_json()).layers[0].reconstruction_distribution
    assert isinstance(rd, jvar.CompositeReconstructionDistribution)
    assert rd.input_size(5) == 3 * 2 + 2
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    net = MultiLayerNetwork(again, device="cpu")
    assert net.layers[0].recon_dist.input_size(5) == 8
    assert tuple(net.layers[0].params()["outW"].shape) == (100, 8)


# ------------------------------------------------------- the pretrain steps
def _graph(updater="adam", pretrain=False):
    gb = (JNNC.builder().seed(11).learning_rate(0.05).updater(updater)
          .graph_builder()
          .add_inputs("in")
          .add_layer("ae", JAE(n_in=6, n_out=5, activation="sigmoid",
                               corruption_level=0.25), "in")
          .add_layer("vae", JVAE(n_in=5, n_out=4, encoder_layer_sizes=(8,),
                                 decoder_layer_sizes=(8,)), "ae")
          .add_layer("rbm", JRBM(n_in=4, n_out=3, activation="sigmoid"),
                     "vae")
          .add_layer("out", JOut(n_in=3, n_out=3, loss="mcxent",
                                 activation="softmax"), "rbm")
          .set_outputs("out"))
    if pretrain:
        gb = gb.pretrain(True)
    return JGraph(gb.build()).init()


@pytest.mark.parametrize("kind", ["multilayer", "graph"])
def test_pretrain_steps_follow_jax_with_its_draws(kind):
    """Three Adam pretraining steps of every pretraining layer, the port's
    step fed the JAX step's draws: losses, the layer's params and updater
    state follow JAX, the other layers' params do not move, and the
    iteration given is the one read (the step does not advance it)."""
    if kind == "multilayer":
        jnet = _stack(JVAE(n_in=6, n_out=3, encoder_layer_sizes=(7,),
                           decoder_layer_sizes=(7,), activation="tanh"),
                      updater="adam")
        targets = [1]
    else:
        jnet = _graph()
        targets = ["ae", "vae", "rbm"]
    tnet = from_jax(jnet.conf.to_json(), _np(jnet.params_list), device="cpu")
    rng = np.random.default_rng(2)
    xs = [rng.uniform(size=(8, 5 if kind == "multilayer" else 6))
          .astype(np.float32) for _ in range(3)]
    before = to_numpy(tnet.params_list)
    iteration = 4
    for t in targets:
        if kind == "multilayer":
            jstep = jax.jit(jpretrain_step(jnet.conf, t))
            tstep = make_pretrain_step(tnet, t)
            jlayer = jnet.conf.layers[t]
        else:
            jstep = jax.jit(jgraph_pretrain_step(jnet.conf, t))
            tstep = make_graph_pretrain_step(tnet, t)
            jlayer = jnet.conf.vertices[t].layer
        for n, x in enumerate(xs):
            key = jax.random.PRNGKey(100 + n)
            jin = jnp.asarray(x) if kind == "multilayer" else [jnp.asarray(x)]
            p_new, u_new, jloss = jstep(jnet.params_list, jnet.state_list,
                                        jnet.updater_state[t], jin, key,
                                        jnp.int32(iteration))
            jnet.params_list[t] = p_new
            jnet.updater_state[t] = u_new
            tin = (torch.from_numpy(x) if kind == "multilayer"
                   else [torch.from_numpy(x)])
            # the layer's input decides the draws' shapes
            noise = _torch_noise(jax_noise(jlayer, key, 8))
            tnet.updater_state[t], tloss = tstep(
                tnet.params_list, tnet.state_list, tnet.updater_state[t],
                tin, None, iteration, noise)
            np.testing.assert_allclose(float(tloss), float(jloss), rtol=REL)
        _assert_tree_close(tnet.params_list[t], jnet.params_list[t], ATOL, t)
        for name, slots in jnet.updater_state[t].items():
            _assert_tree_close(tnet.updater_state[t][name], slots, ATOL,
                               f"{t} {name}")
    after = to_numpy(tnet.params_list)
    others = (range(len(after)) if kind == "multilayer" else after)
    for o in others:
        if o in targets:
            continue
        for k in after[o]:
            np.testing.assert_array_equal(after[o][k], before[o][k])


def _ae_stack(pretrain=False):
    """Two deterministic pretraining layers (no corruption) in a stack."""
    lb = (JNNC.builder().seed(5).learning_rate(0.1).updater("adam").list()
          .layer(JAE(n_in=6, n_out=5, activation="sigmoid",
                     corruption_level=0.0))
          .layer(JAE(n_in=5, n_out=4, activation="tanh", corruption_level=0.0,
                     sparsity=0.1))
          .layer(JOut(n_in=4, n_out=3, loss="mcxent", activation="softmax")))
    if pretrain:
        lb = lb.pretrain(True)
    return JNet(lb.build()).init()


def _batches(n=3, seed=6):
    rng = np.random.default_rng(seed)
    return [(rng.uniform(size=(8, 6)).astype(np.float32),
             np.eye(3, dtype=np.float32)[rng.integers(0, 3, 8)])
            for _ in range(n)]


@pytest.mark.parametrize("entry", ["pretrain_layer", "pretrain",
                                   "fit_iterator"])
def test_pretraining_loops_follow_jax(entry):
    """``pretrain_layer``, ``pretrain`` and ``fit_iterator`` of a
    ``pretrain(True)`` config on a deterministic stack: the port's params
    follow the JAX ones, ``score_value`` is the last pretraining loss, and
    only the supervised steps advance the iteration."""
    jnet = _ae_stack(pretrain=entry == "fit_iterator")
    tnet = from_jax(jnet.conf.to_json(), _np(jnet.params_list), device="cpu")
    batches = _batches()
    jit = JExisting([JDataSet(x, y) for x, y in batches])
    tit = ExistingDataSetIterator([DataSet(x, y) for x, y in batches])
    if entry == "pretrain_layer":
        for net, it in ((jnet, jit), (tnet, tit)):
            net.pretrain_layer(1, it)
            net.pretrain_layer(1, it)
        np.testing.assert_allclose(tnet.score_value, jnet.score_value,
                                   rtol=REL)
        assert tnet.iteration == jnet.iteration == 0
    elif entry == "pretrain":
        jnet.pretrain(jit)
        tnet.pretrain(tit)
        assert tnet.iteration == jnet.iteration == 0
    else:
        jnet.fit_iterator(jit, epochs=2)
        tnet.fit_iterator(tit, epochs=2)
        assert tnet.iteration == jnet.iteration == 6
        np.testing.assert_allclose(tnet.score_value, jnet.score_value,
                                   rtol=REL)
    for i, jp in enumerate(jnet.params_list):
        _assert_tree_close(tnet.params_list[i], jp, ATOL, f"layer {i}")
    with pytest.raises(ValueError, match="not pretrainable"):
        tnet.pretrain_layer(2, tit)
    with pytest.raises(ValueError, match="out of range"):
        tnet.pretrain_layer(3, tit)


def test_graph_pretraining_loops_follow_jax():
    """The graph twin: ``pretrain_layer`` of one vertex and ``pretrain`` of
    every vertex on deterministic AutoEncoder vertices, then
    ``fit_iterator`` of a ``pretrain(True)`` graph; errors name the
    vertex."""
    def build(pretrain):
        gb = (JNNC.builder().seed(11).learning_rate(0.05).updater("adam")
              .graph_builder()
              .add_inputs("in")
              .add_layer("ae1", JAE(n_in=6, n_out=5, activation="sigmoid",
                                    corruption_level=0.0), "in")
              .add_layer("ae2", JAE(n_in=5, n_out=4, activation="sigmoid",
                                    corruption_level=0.0), "ae1")
              .add_layer("out", JOut(n_in=4, n_out=3, loss="mcxent",
                                     activation="softmax"), "ae2")
              .set_outputs("out"))
        if pretrain:
            gb = gb.pretrain(True)
        return JGraph(gb.build()).init()

    batches = _batches()
    for pretrain, run in ((False, lambda net, it: (net.pretrain_layer("ae2", it),
                                                   net.pretrain(it))),
                          (True, lambda net, it: net.fit_iterator(it))):
        jnet = build(pretrain)
        tnet = from_jax(jnet.conf.to_json(), _np(jnet.params_list),
                        device="cpu")
        run(jnet, JExisting([JDataSet(x, y) for x, y in batches]))
        tit = ExistingDataSetIterator([DataSet(x, y) for x, y in batches])
        run(tnet, tit)
        assert tnet.iteration == jnet.iteration == (3 if pretrain else 0)
        np.testing.assert_allclose(tnet.score_value, jnet.score_value,
                                   rtol=REL)
        for name, jp in jnet.params_list.items():
            _assert_tree_close(tnet.params_list[name], jp, ATOL, name)
    with pytest.raises(ValueError, match="not pretrainable"):
        tnet.pretrain_layer("out", tit)
    with pytest.raises(ValueError, match="Unknown vertex"):
        tnet.pretrain_layer("nope", tit)


# ------------------------------------------------------- gradient checks
def _port(layer_conf):
    lb = (NeuralNetConfiguration.builder().seed(7).list().layer(layer_conf)
          .layer(OutputLayer.conf(n_in=layer_conf["n_out"], n_out=2,
                                  loss="mcxent", activation="softmax")))
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    return MultiLayerNetwork(lb.build(), device="cpu").init()


@pytest.mark.parametrize("case", ["vae_gaussian", "vae_bernoulli",
                                  "vae_composite", "ae"])
def test_pretrain_gradient_checks_pass(case):
    """The JAX battery's pretraining gradient checks on the port (float64
    central differences against autograd), with the draws held fixed."""
    jl = LAYERS[case]()
    fields = json.loads(_stack(jl).conf.to_json())["layers"][1]
    fields.pop("@type")
    cls = {"ae": AutoEncoder}.get(case, VariationalAutoencoder)
    net = _port(cls.conf(**{k: v for k, v in fields.items()
                            if k not in ("name",)}))
    assert check_pretrain_gradients(net, 0, _data(case, n=4), subset=60)


def test_graph_pretrain_gradient_checks_pass():
    """The graph check on a VAE and an AutoEncoder vertex (the JAX
    battery's graph case; an RBM's surrogate is checked against the CD
    update instead); a network on the card is refused."""
    jnet = _graph()
    tnet = from_jax(jnet.conf.to_json(), _np(jnet.params_list), device="cpu")
    x = np.random.default_rng(2).normal(size=(4, 6))
    assert check_graph_pretrain_gradients(tnet, "vae", [x], subset=60)
    assert check_graph_pretrain_gradients(tnet, "ae", [x], subset=60)
    tnet.device = torch.device("cuda")
    with pytest.raises(ValueError, match="CPU clone"):
        check_graph_pretrain_gradients(tnet, "ae", [x])


def test_port_builds_pretraining_layers_with_the_jax_json():
    """The port's builder writes the JAX JSON for every pretraining layer
    type with its defaults."""
    tconf = (NeuralNetConfiguration.builder().seed(3).list()
             .layer(AutoEncoder.conf(n_in=6, n_out=5))
             .layer(RBM.conf(n_out=4))
             .layer(VariationalAutoencoder.conf(n_out=3))
             .layer(DenseLayer.conf(n_out=3))
             .layer(OutputLayer.conf(n_out=2))
             .pretrain(True).build())
    jconf = (JNNC.builder().seed(3).list()
             .layer(JAE(n_in=6, n_out=5)).layer(JRBM(n_out=4))
             .layer(JVAE(n_out=3)).layer(JDense(n_out=3))
             .layer(JOut(n_out=2)).pretrain(True).build())
    assert json.loads(tconf.to_json()) == json.loads(jconf.to_json())
