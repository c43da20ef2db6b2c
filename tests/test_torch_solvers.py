"""The port's full-batch solvers (``optimize/solvers.py``) held against the
JAX package's ``lax.while_loop`` versions on the CPU.

- On an ill-conditioned quadratic and on Rosenbrock, in float64 (the JAX
  side under ``enable_x64``): the same iteration count, and the final loss
  and ``x`` within 1e-5 relative (absolute 1e-12 for a loss at the
  minimum, where both sit at 1e-17). The gradients come from two autodiff
  systems that round differently, so the runs part where the problem
  amplifies rounding: nonlinear CG on Rosenbrock parts from the JAX run by
  6e-7 in ``x`` after 50 iterations and by 3e-2 after 200 (its restarts
  make it chaotic there), so it is held at 20 iterations. In float32 the
  quadratic is held where rounding has not yet taken over: CG parts by
  2.7e-6 in ``x`` at 15 iterations and 6.6e-5 at 20 (it loses conjugacy
  in float32), so float32 CG is held at 10.
- ``fit`` under ``optimization_algo`` lbfgs, conjugate_gradient and
  line_gradient_descent, on a small LeNet and on a two-input graph, from
  the same converted weights as the JAX network's ``fit`` (two calls of
  ``iterations`` 5): the iteration count exactly, the losses within 1e-3
  relative and the params within 1e-3 of their largest magnitude (float32,
  sums in another order, over 10 iterations of line searches). CG on the
  LeNet is the worst case, 3.4e-4 (second loss) and 2.2e-4 (params) seen,
  for the reason above; the other five are at or under 5.3e-5 and 2.0e-5.
  A solver that took a wrong step would miss by the step itself: the
  second call moves the loss by 17% to 80%.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import _np_tree as _np
from _torch_port import compile_cache_at
from deeplearning4j_tpu import jax_compat
from deeplearning4j_tpu.nn.conf.builders import NeuralNetConfiguration as JNNC
from deeplearning4j_tpu.nn.conf.inputs import InputType as JInputType
from deeplearning4j_tpu.nn.conf.layers import (
    ConvolutionLayer, DenseLayer, OutputLayer, SubsamplingLayer)
from deeplearning4j_tpu.nn.conf.vertices import MergeVertex
from deeplearning4j_tpu.nn.graph_network import ComputationGraph as JGraph
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JNet
from deeplearning4j_tpu.optimize import solvers as jsolvers
from deeplearning4j_tpu_torch.convert import from_jax, to_numpy
from deeplearning4j_tpu_torch.optimize import solvers as tsolvers
from deeplearning4j_tpu_torch.optimize.listeners import (
    CollectScoresIterationListener)

#: see the module docstring
FIT_REL = 1e-3
ALGOS = ("lbfgs", "conjugate_gradient", "line_gradient_descent")
FNS = {"lbfgs": "minimize_lbfgs", "conjugate_gradient": "minimize_cg",
       "line_gradient_descent": "minimize_line_gd"}


def _rosen(v):
    return (1 - v[0]) ** 2 + 100.0 * (v[1] - v[0] ** 2) ** 2


def _quad_j(v):
    return jnp.sum(jnp.array([1.0, 10.0, 100.0, 3.0], v.dtype)
                   * (v - jnp.arange(4.0, dtype=v.dtype)) ** 2)


def _quad_t(v):
    return torch.sum(torch.tensor([1.0, 10.0, 100.0, 3.0], dtype=v.dtype)
                     * (v - torch.arange(4.0, dtype=v.dtype)) ** 2)


PROBLEMS = {"quadratic": (_quad_j, _quad_t, [0.0, 0.0, 0.0, 0.0]),
            "rosenbrock": (_rosen, _rosen, [-1.2, 1.0])}


@pytest.mark.parametrize("problem,algo,iters,dtype", [
    ("quadratic", "lbfgs", 200, "float64"),
    ("quadratic", "conjugate_gradient", 200, "float64"),
    ("quadratic", "line_gradient_descent", 1000, "float64"),
    ("rosenbrock", "lbfgs", 200, "float64"),
    ("rosenbrock", "conjugate_gradient", 20, "float64"),
    ("rosenbrock", "line_gradient_descent", 1000, "float64"),
    ("quadratic", "lbfgs", 50, "float32"),
    ("quadratic", "conjugate_gradient", 10, "float32"),
    ("quadratic", "line_gradient_descent", 200, "float32"),
    ("rosenbrock", "line_gradient_descent", 5, "float32"),
])
def test_minimizers_follow_jax(problem, algo, iters, dtype):
    fj, ft, x0 = PROBLEMS[problem]
    name = FNS[algo]
    with jax_compat.enable_x64(dtype == "float64"):
        ref = jax.jit(lambda x: getattr(jsolvers, name)(
            fj, x, max_iters=iters))(jnp.asarray(x0, dtype))
        ref_x, ref_loss = np.asarray(ref.x), float(ref.loss)
        ref_iters = int(ref.iterations)
    got = getattr(tsolvers, name)(
        ft, torch.tensor(x0, dtype=getattr(torch, dtype)), max_iters=iters)
    assert got.iterations == ref_iters
    assert got.x.dtype == getattr(torch, dtype)
    np.testing.assert_allclose(float(got.loss), ref_loss, rtol=1e-5,
                               atol=1e-12)
    np.testing.assert_allclose(got.x.numpy(), ref_x, rtol=1e-5, atol=1e-12)


def test_backtrack_refuses_a_non_descent_step():
    f = lambda v: torch.sum(v ** 2)
    x = torch.tensor([1.0, 2.0])
    fx, g = f(x), 2 * x
    step, nx, nf = tsolvers._backtrack(f, x, fx, g, g, 1.0)  # uphill
    assert float(step) == 0.0 and torch.equal(nx, x) and nf == fx


# ------------------------------------------------------------- fit paths
def _lenet(algo):
    return (JNNC.builder().seed(4).learning_rate(0.1).optimization_algo(algo)
            .iterations(5).weight_init("xavier").list()
            .layer(ConvolutionLayer(n_out=3, kernel_size=(3, 3),
                                    stride=(1, 1), activation="tanh"))
            .layer(SubsamplingLayer(pooling_type="max", kernel_size=(2, 2),
                                    stride=(2, 2)))
            .layer(DenseLayer(n_out=12, activation="tanh"))
            .layer(OutputLayer(n_out=4, loss="mcxent", activation="softmax"))
            .set_input_type(JInputType.convolutional_flat(10, 10, 1))
            .build())


def _graph(algo):
    return (JNNC.builder().seed(5).learning_rate(0.1).optimization_algo(algo)
            .iterations(5).weight_init("xavier").graph_builder()
            .add_inputs("a", "b")
            .add_layer("da", DenseLayer(n_in=4, n_out=6, activation="tanh"), "a")
            .add_layer("db", DenseLayer(n_in=3, n_out=5, activation="tanh"), "b")
            .add_vertex("m", MergeVertex(), "da", "db")
            .add_layer("out", OutputLayer(n_in=11, n_out=3, loss="mcxent",
                                          activation="softmax"), "m")
            .set_outputs("out")
            .build())


def _flat(tree):
    if isinstance(tree, dict):
        return np.concatenate([_flat(tree[k]) for k in sorted(tree)]
                              or [np.zeros(0)])
    if isinstance(tree, list):
        return np.concatenate([_flat(v) for v in tree] or [np.zeros(0)])
    return np.asarray(tree).ravel()


@pytest.mark.parametrize("kind", ["lenet", "graph"])
@pytest.mark.parametrize("algo", ALGOS)
def test_fit_with_each_algorithm_follows_jax(kind, algo, tmp_path):
    rng = np.random.default_rng(6)
    if kind == "lenet":
        x = [rng.random((16, 100)).astype(np.float32)]
        y = [np.eye(4, dtype=np.float32)[rng.integers(0, 4, 16)]]
        conf, cls = _lenet(algo), JNet
    else:
        x = [rng.standard_normal((12, 4)).astype(np.float32),
             rng.standard_normal((12, 3)).astype(np.float32)]
        y = [np.eye(3, dtype=np.float32)[rng.integers(0, 3, 12)]]
        conf, cls = _graph(algo), JGraph
    args = (x[0], y[0]) if kind == "lenet" else (x, y)
    ref = {"losses": [], "iterations": []}
    with compile_cache_at(tmp_path):
        jnet = cls(conf).init()
        p0 = _np(jnet.params_list)
        for _ in range(2):
            jnet.fit(*args)
            ref["losses"].append(float(jnet.score_value))
            ref["iterations"].append(jnet.iteration)
        ref["params"] = _np(jnet.params_list)
    net = from_jax(conf.to_json(), p0, device="cpu")
    scores = CollectScoresIterationListener()
    net.set_listeners(scores)
    losses, iterations = [], []
    for _ in range(2):
        net.fit(*args)
        losses.append(net.score_value)
        iterations.append(net.iteration)
    assert iterations == ref["iterations"]
    assert 0 < iterations[0] <= 5
    # the listeners fire once a fit call, at the new iteration
    assert [i for i, _ in scores.scores] == iterations
    np.testing.assert_allclose(losses, ref["losses"], rtol=FIT_REL)
    assert losses[1] < losses[0]
    ours, theirs = _flat(to_numpy(net.params_list)), _flat(ref["params"])
    assert np.abs(ours - theirs).max() <= FIT_REL * np.abs(theirs).max()


def _port_net(conf):
    from deeplearning4j_tpu_torch.nn.conf.multilayer import (
        MultiLayerConfiguration)
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    return MultiLayerNetwork(MultiLayerConfiguration.from_json(
        conf.to_json()), device="cpu").init()


def test_solver_facade_and_sgd_route():
    rng = np.random.default_rng(1)
    x = rng.random((8, 100)).astype(np.float32)
    y = np.eye(4, dtype=np.float32)[rng.integers(0, 4, 8)]
    net = _port_net(_lenet("lbfgs"))
    s0 = net.score(x, y)
    s1 = tsolvers.Solver(net, max_iters=20).optimize(x, y)
    assert s1 < 0.5 * s0 and net.iteration > 5
    bad = tsolvers.Solver(net)
    bad.algo = "newton"
    with pytest.raises(ValueError, match="Unknown optimization_algo"):
        bad.optimize(x, y)
    # an SGD config: the Solver hands the batch to the network's own step
    sgd = _port_net(_lenet("stochastic_gradient_descent"))
    assert tsolvers.Solver(sgd).optimize(x, y) == sgd.score_value
    assert sgd.iteration == 5 and sgd._solver is None
