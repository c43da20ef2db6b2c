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

The check runs on the CPU: the CUDA kernels take float32 and bf16 only, so
a network on the card raises and asks for a CPU clone. The pretraining
checks come with layerwise pretraining (ROADMAP.md).
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

    if net.device.type != "cpu":
        raise ValueError(
            f"check_gradients runs in float64 on the CPU and the network is "
            f"on {net.device} (its CUDA kernels take float32 and bf16 only); "
            "pass a CPU clone: check_gradients(net.clone(device='cpu'), ...)")
    params64 = _f64(net.params_list)
    states64 = _f64(net.state_list)
    x64 = torch.as_tensor(np.asarray(x), dtype=torch.float64)
    y64 = torch.as_tensor(np.asarray(y), dtype=torch.float64)

    def score(p):
        return loss_fn(net, p, x64, y64, None, state_list=states64)[0]

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
        log.info("gradient check: %d params, max rel err %.3g, %d failures",
                 len(indices), max_err, fails)
    return fails == 0
