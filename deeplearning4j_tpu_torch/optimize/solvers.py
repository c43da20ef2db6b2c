"""Full-batch optimizers: LBFGS, nonlinear conjugate gradient and line
gradient descent, over a network's flat parameter vector.

Counterpart of ``deeplearning4j_tpu/optimize/solvers.py``. The JAX package
runs each optimizer as one compiled ``lax.while_loop``; here the loop is a
Python loop of the same steps, on the vector's device, with
``torch.autograd.grad`` for the gradients. Each loop keeps the JAX
package's arithmetic: the Armijo backtracking search (``c1 = 1e-4``,
halving, at most 20 tries, no move when none is found), LBFGS's two-loop
recursion over a ring of ``history`` pairs (a pair is stored only when
``s.y > 1e-10``; the ring's slots are read by iteration count, as there),
Polak-Ribiere+ with a restart on a non-descent direction, and the stop at
``|g| < tol`` or a zero step. ``MinimizeResult.iterations`` counts
iterations, not loss evaluations.

:class:`Solver` is the facade ``fit`` uses when the config's
``optimization_algo`` is one of ``lbfgs``, ``conjugate_gradient`` and
``line_gradient_descent``: the network's training loss on the batch
(train-mode forward without dropout, regularization included) as a
function of the flat vector, minimized for ``iterations`` iterations,
then written back into the params.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from ..utils.pytree import flatten_params, unflatten_params


def _value_and_grad(f: Callable[[torch.Tensor], torch.Tensor],
                    x: torch.Tensor):
    with torch.enable_grad():
        xv = x.detach().requires_grad_(True)
        fx = f(xv)
        (g,) = torch.autograd.grad(fx, xv)
    return fx.detach(), g.detach()


def _backtrack(f, x, fx, g, d, step0, c1: float = 1e-4, rho: float = 0.5,
               max_steps: int = 20):
    """Armijo backtracking: ``(step, new_x, new_f)``; ``step`` 0 and ``x``
    unchanged when no step of at most ``max_steps`` halvings decreases
    ``f`` enough."""
    gd = torch.dot(g, d)
    step = torch.as_tensor(step0, dtype=x.dtype, device=x.device)
    with torch.no_grad():
        for _ in range(max_steps):
            nx = x + step * d
            nf = f(nx)
            if bool(nf <= fx + c1 * step * gd):
                return step, nx, nf
            step = step * rho
    return torch.zeros((), dtype=x.dtype, device=x.device), x, fx


class MinimizeResult(NamedTuple):
    x: torch.Tensor
    loss: torch.Tensor
    iterations: int


def minimize_lbfgs(f: Callable[[torch.Tensor], torch.Tensor],
                   x0: torch.Tensor, max_iters: int = 100, history: int = 10,
                   tol: float = 1e-6) -> MinimizeResult:
    """Limited-memory BFGS with a ring of ``history`` (s, y) pairs."""
    m = history
    n = x0.shape[0]
    S = torch.zeros((m, n), dtype=x0.dtype, device=x0.device)
    Y = torch.zeros_like(S)
    rho = torch.zeros(m, dtype=x0.dtype, device=x0.device)

    def two_loop(g, k):
        q = g
        alpha = torch.zeros(m, dtype=g.dtype, device=g.device)
        used = min(k, m)
        for i in range(used):
            idx = (k - 1 - i) % m
            a = rho[idx] * torch.dot(S[idx], q)
            q = q - a * Y[idx]
            alpha[idx] = a
        last = (k - 1) % m
        if k > 0:
            gamma = torch.dot(S[last], Y[last]) / torch.clamp_min(
                torch.dot(Y[last], Y[last]), 1e-20)
        else:
            gamma = 1.0
        r = gamma * q
        for i in range(used):
            idx = (k - used + i) % m
            beta = rho[idx] * torch.dot(Y[idx], r)
            r = r + (alpha[idx] - beta) * S[idx]
        return r

    x = x0.detach()
    fx, g = _value_and_grad(f, x)
    k = 0
    while k < max_iters:
        d = -two_loop(g, k)
        if not bool(torch.dot(g, d) < 0):
            d = -g
        step0 = (1.0 / torch.clamp_min(torch.linalg.norm(g), 1.0)
                 if k == 0 else 1.0)
        step, nx, nf = _backtrack(f, x, fx, g, d, step0)
        _, ng = _value_and_grad(f, nx)
        s, y = nx - x, ng - g
        sy = torch.dot(s, y)
        if bool(sy > 1e-10):
            slot = k % m
            S[slot], Y[slot] = s, y
            rho[slot] = 1.0 / torch.clamp_min(sy, 1e-20)
        x, fx, g = nx, nf, ng
        k += 1
        if float(torch.linalg.norm(ng)) < tol or float(step) == 0.0:
            break
    return MinimizeResult(x, fx, k)


def minimize_cg(f: Callable[[torch.Tensor], torch.Tensor], x0: torch.Tensor,
                max_iters: int = 100, tol: float = 1e-6) -> MinimizeResult:
    """Polak-Ribiere+ nonlinear conjugate gradient with the Armijo search."""
    x = x0.detach()
    fx, g = _value_and_grad(f, x)
    d = -g
    k = 0
    while k < max_iters:
        step, nx, nf = _backtrack(f, x, fx, g, d, 1.0)
        _, ng = _value_and_grad(f, nx)
        beta = torch.clamp_min(torch.dot(ng, ng - g) / torch.clamp_min(
            torch.dot(g, g), 1e-20), 0.0)
        nd = -ng + beta * d
        if not bool(torch.dot(ng, nd) < 0):
            nd = -ng
        x, fx, g, d = nx, nf, ng, nd
        k += 1
        if float(torch.linalg.norm(ng)) < tol or float(step) == 0.0:
            break
    return MinimizeResult(x, fx, k)


def minimize_line_gd(f: Callable[[torch.Tensor], torch.Tensor],
                     x0: torch.Tensor, max_iters: int = 100,
                     tol: float = 1e-6) -> MinimizeResult:
    """Steepest descent with the Armijo search."""
    x = x0.detach()
    fx, g = _value_and_grad(f, x)
    k = 0
    while k < max_iters:
        step, nx, nf = _backtrack(f, x, fx, g, -g, 1.0)
        _, ng = _value_and_grad(f, nx)
        x, fx, g = nx, nf, ng
        k += 1
        if float(torch.linalg.norm(ng)) < tol or float(step) == 0.0:
            break
    return MinimizeResult(x, fx, k)


_ALGOS = {
    "lbfgs": minimize_lbfgs,
    "conjugate_gradient": minimize_cg,
    "line_gradient_descent": minimize_line_gd,
}


class Solver:
    """The ``optimization_algo`` dispatch of a network's ``fit``: SGD is
    the network's own step; the full-batch algorithms minimize the loss on
    the batch over the flat parameter vector for ``max_iters`` iterations
    (default: the config's ``iterations``)."""

    def __init__(self, model, max_iters: int = None):
        self.model = model
        g = model.conf.global_conf
        self.algo = g.optimization_algo
        self.max_iters = (max_iters if max_iters is not None
                          else max(1, g.iterations))

    def optimize(self, x, y) -> float:
        """Minimize the loss on ``(x, y)`` (lists of arrays for a graph),
        write the result into the params, add the iterations to the
        network's ``iteration`` and call its listeners once."""
        from ..common import wrap_with_policy
        from ..nn.graph_network import ComputationGraph, graph_loss
        from ..nn.multilayer import loss_fn

        net = self.model
        if self.algo == "stochastic_gradient_descent":
            net.fit(x, y)
            return net.score_value
        if self.algo not in _ALGOS:
            raise ValueError(f"Unknown optimization_algo: {self.algo}")
        net._require_init()
        template = net.params_list
        states = net.state_list
        if isinstance(net, ComputationGraph):
            xs = net._to_devices(x if isinstance(x, list) else [x])
            ys = net._to_devices(y if isinstance(y, list) else [y])

            def loss(flat):
                return graph_loss(net, unflatten_params(template, flat),
                                  states, xs, ys, None)[0]
        else:
            xa, ya = net._to_device(x), net._to_device(y)

            def loss(flat):
                return loss_fn(net, unflatten_params(template, flat), xa, ya,
                               None, state_list=states)[0]

        loss = wrap_with_policy(loss, net.conf.global_conf.dtype)
        result = _ALGOS[self.algo](
            loss, flatten_params(template, torch.float32),
            max_iters=self.max_iters)
        net.set_params(result.x)
        net.score_value = float(result.loss)
        net.iteration += int(result.iterations)
        for listener in net.listeners:
            listener.iteration_done(net, net.iteration)
        return net.score_value
