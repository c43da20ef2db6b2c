"""Gradient checks: central differences in float64 against autograd.

Counterpart of ``check_gradients`` in
``deeplearning4j_tpu/nn/gradientcheck.py``: each parameter (or a random
``subset`` of them) is moved by ``+-eps`` in float64 and
``(f(p + eps) - f(p - eps)) / (2 eps)`` is compared with the autograd
gradient; a parameter fails when the relative error exceeds
``max_rel_error`` and the absolute error exceeds ``min_abs_error``. ``f``
is the network's training loss (train-mode forward without dropout,
regularization included) on float64 copies of the params, the layer states
and the data, under an all-float64 dtype policy, as the JAX package runs it
under ``enable_x64``.

:func:`check_pretrain_gradients` and :func:`check_graph_pretrain_gradients`
check one pretraining layer's (vertex's) unsupervised objective with
respect to its own params, on the float64 eval forward of the input to it,
with the objective's random draws held fixed.

The checks run on the CPU: the CUDA kernels take float32 and bf16 only, so
a network on the card raises and asks for a CPU clone.
"""
from __future__ import annotations

import logging
from typing import Optional

import numpy as np
import torch

from ..common import override_policy, set_policy
from ..utils.pytree import flatten_params, tree_map, unflatten_params

log = logging.getLogger(__name__)


def _f64(tree):
    return tree_map(lambda t: t.detach().to("cpu", torch.float64, copy=True),
                    tree)


def check_gradients(net, x, y, *, eps: float = 1e-6,
                    max_rel_error: float = 1e-3, min_abs_error: float = 1e-8,
                    subset: Optional[int] = None, seed: int = 0,
                    verbose: bool = False) -> bool:
    """Gradient-check a CPU ``MultiLayerNetwork`` on ``(x, y)``; ``subset``
    randomly chosen parameters (``np.random.default_rng(seed)``), all when
    None. True when no parameter fails."""
    from .multilayer import loss_fn

    _require_cpu(net, "check_gradients")
    params64 = _f64(net.params_list)
    states64 = _f64(net.state_list)
    x64 = torch.as_tensor(np.asarray(x), dtype=torch.float64)
    y64 = torch.as_tensor(np.asarray(y), dtype=torch.float64)

    def score(p):
        return loss_fn(net, p, x64, y64, None, state_list=states64)[0]

    return _fd_check(score, params64, eps=eps, max_rel_error=max_rel_error,
                     min_abs_error=min_abs_error, subset=subset, seed=seed,
                     verbose=verbose, tag="gradient check")


def _require_cpu(net, what: str) -> None:
    if net.device.type != "cpu":
        raise ValueError(
            f"{what} runs in float64 on the CPU and the network is on "
            f"{net.device} (its CUDA kernels take float32 and bf16 only); "
            f"pass a CPU clone: {what}(net.clone(device='cpu'), ...)")


def _pretrain_score(layer, h, rng_seed: int, noise):
    """The layer's pretraining objective as a function of its params, with
    its random draws held fixed: ``noise`` when given, else a CPU generator
    seeded with ``rng_seed`` afresh at every evaluation."""
    def score(p):
        gen = torch.Generator(device="cpu").manual_seed(rng_seed)
        return layer.pretrain_loss(p, h, gen=gen, noise=noise)
    return score


def check_pretrain_gradients(net, layer_idx: int, x, *, eps: float = 1e-6,
                             max_rel_error: float = 1e-3,
                             min_abs_error: float = 1e-8,
                             subset: Optional[int] = None, seed: int = 0,
                             rng_seed: int = 5, noise=None,
                             verbose: bool = False) -> bool:
    """Gradient-check layer ``layer_idx``'s pretraining objective of a CPU
    ``MultiLayerNetwork`` with respect to that layer's params, on the
    float64 eval forward of ``x`` to it; the random draws held fixed
    (``noise``, else ``rng_seed``)."""
    from .multilayer import eval_forward_to_layer

    _require_cpu(net, "check_pretrain_gradients")
    params64 = _f64(net.params_list)
    states64 = _f64(net.state_list)
    with override_policy("float32"):
        set_policy(torch.float64, torch.float64, torch.float64)
        with torch.no_grad():
            h = eval_forward_to_layer(
                net, params64, states64,
                torch.as_tensor(np.asarray(x), dtype=torch.float64),
                layer_idx)
        score = _pretrain_score(net.layers[layer_idx], h, rng_seed, noise)
        return _fd_check(score, params64[layer_idx], eps=eps,
                         max_rel_error=max_rel_error,
                         min_abs_error=min_abs_error, subset=subset,
                         seed=seed, verbose=verbose, tag="pretrain")


def check_graph_pretrain_gradients(net, vertex_name: str, xs, *,
                                   eps: float = 1e-6,
                                   max_rel_error: float = 1e-3,
                                   min_abs_error: float = 1e-8,
                                   subset: Optional[int] = None,
                                   seed: int = 0, rng_seed: int = 5,
                                   noise=None, verbose: bool = False) -> bool:
    """:func:`check_pretrain_gradients` for vertex ``vertex_name`` of a CPU
    ``ComputationGraph``: its ancestors' float64 eval forward of ``xs``,
    then its pretraining objective against its params."""
    from .graph_network import eval_forward_to_vertex

    _require_cpu(net, "check_graph_pretrain_gradients")
    params64 = _f64(net.params_list)
    states64 = _f64(net.state_list)
    with override_policy("float32"):
        set_policy(torch.float64, torch.float64, torch.float64)
        inputs = [torch.as_tensor(np.asarray(x), dtype=torch.float64)
                  for x in xs]
        with torch.no_grad():
            h = eval_forward_to_vertex(net, params64, states64, inputs,
                                       vertex_name)
        score = _pretrain_score(net.vertex_layers[vertex_name], h, rng_seed,
                                noise)
        return _fd_check(score, params64[vertex_name], eps=eps,
                         max_rel_error=max_rel_error,
                         min_abs_error=min_abs_error, subset=subset,
                         seed=seed, verbose=verbose,
                         tag=f"graph pretrain[{vertex_name}]")


def _fd_check(score, params64, *, eps, max_rel_error, min_abs_error,
              subset, seed, verbose, tag) -> bool:
    """Central differences of ``score`` over the float64 param tree
    ``params64`` against its autograd gradient; run under the all-float64
    policy. True when no parameter fails."""
    # set_policy inside an override changes this context's policy only, and
    # the block's end restores the one in force
    with override_policy("float32"):
        set_policy(torch.float64, torch.float64, torch.float64)
        flat_params = flatten_params(params64, torch.float64)
        with torch.enable_grad():
            flat = flat_params.clone().requires_grad_(True)
            (analytic,) = torch.autograd.grad(
                score(unflatten_params(params64, flat)), flat)
        flat_analytic = analytic.numpy()
        flat_np = flat_params.numpy()
        n = len(flat_np)
        if subset is not None and subset < n:
            indices = np.random.default_rng(seed).choice(n, subset,
                                                         replace=False)
        else:
            indices = np.arange(n)
        fails = 0
        max_err = 0.0
        with torch.no_grad():
            for i in indices:
                plus = flat_np.copy()
                plus[i] += eps
                minus = flat_np.copy()
                minus[i] -= eps
                f_plus = float(score(unflatten_params(
                    params64, torch.from_numpy(plus))))
                f_minus = float(score(unflatten_params(
                    params64, torch.from_numpy(minus))))
                numeric = (f_plus - f_minus) / (2 * eps)
                a = float(flat_analytic[i])
                denom = max(abs(numeric), abs(a))
                rel = abs(numeric - a) / denom if denom > 0 else 0.0
                if rel > max_rel_error and abs(numeric - a) > min_abs_error:
                    fails += 1
                    if verbose:
                        log.info("param %d: analytic=%.8g numeric=%.8g "
                                 "rel=%.3g", i, a, numeric, rel)
                max_err = max(max_err, rel if abs(numeric - a) > min_abs_error
                              else 0.0)
    if verbose:
        log.info("%s: %d params, max rel err %.3g, %d failures", tag,
                 len(indices), max_err, fails)
    return fails == 0
