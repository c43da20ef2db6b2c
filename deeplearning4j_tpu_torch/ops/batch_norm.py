"""Train-mode batch normalization with the JAX package's formulas.

Counterpart of ``batch_norm_stats`` and ``batch_norm_train`` in
``deeplearning4j_tpu/ops/pallas_kernels.py``. That one is a
``jax.custom_vjp`` over XLA ops, not a Pallas kernel, so this is plain
PyTorch: a ``torch.autograd.Function`` with the same forward and the same
hand-written backward.

- Statistics in one pass: ``mean = E[x]``, ``var = E[x^2] - mean^2``
  clamped at 0 (the biased variance), over every axis but the last
  (``(N, H, W)`` of an NHWC tensor, ``N`` of ``[N, F]``).
- Forward: ``x * scale + shift`` with ``scale = gamma / sqrt(var + eps)``
  and ``shift = beta - mean * scale``.
- Backward: ``dbeta = sum(dy)``, ``dgamma = sum(dy * xhat)`` and
  ``dx = gamma / sqrt(var + eps) * (dy - dbeta / n - xhat * dgamma / n)``.

``F.batch_norm`` computes another function: its statistics take two passes
and its running update takes the unbiased variance. The ``mean`` and ``var``
outputs feed the layer's running average only and are not differentiated.
"""
from __future__ import annotations

from typing import Tuple

import torch

from ..common import at_least_f32

Tensor = torch.Tensor


def _dims(x: Tensor) -> Tuple[int, ...]:
    return tuple(range(x.ndim - 1))


def batch_norm_stats(x: Tensor) -> Tuple[Tensor, Tensor]:
    """``(mean, biased var)`` per channel (last axis) in one pass over
    ``x``, in at least float32; the variance is clamped at 0 against the
    cancellation of ``E[x^2] - mean^2``."""
    xs = x.to(at_least_f32(x.dtype))
    dims = _dims(x)
    inv_n = 1.0 / (x.numel() // x.shape[-1])
    mean = xs.sum(dims) * inv_n
    var = torch.clamp_min((xs * xs).sum(dims) * inv_n - mean * mean, 0.0)
    return mean, var


class BatchNormTrain(torch.autograd.Function):
    """``(out, mean, var)`` of a train-mode batch norm; the backward is the
    JAX package's hand-written VJP (``_bn_train_bwd``)."""

    @staticmethod
    def forward(ctx, x: Tensor, gamma: Tensor, beta: Tensor, eps: float):
        mean, var = batch_norm_stats(x)
        inv = torch.rsqrt(var + eps)
        scale = gamma.to(inv.dtype) * inv
        shift = beta.to(inv.dtype) - mean * scale
        out = x * scale.to(x.dtype) + shift.to(x.dtype)
        ctx.save_for_backward(x, gamma, mean, inv)
        ctx.mark_non_differentiable(mean, var)
        return out, mean, var

    @staticmethod
    def backward(ctx, dy: Tensor, _dmean, _dvar):
        x, gamma, mean, inv = ctx.saved_tensors
        dims = _dims(x)
        wide = inv.dtype
        xhat = (x - mean.to(x.dtype)) * inv.to(x.dtype)
        dbeta = dy.to(wide).sum(dims)
        dgamma = (dy * xhat).to(wide).sum(dims)
        inv_n = 1.0 / (x.numel() // x.shape[-1])
        k = gamma.to(wide) * inv
        dx = k.to(x.dtype) * (dy - (dbeta * inv_n).to(x.dtype)
                              - xhat * (dgamma * inv_n).to(x.dtype))
        return dx, dgamma.to(gamma.dtype), dbeta.to(gamma.dtype), None


def batch_norm_train(x: Tensor, gamma: Tensor, beta: Tensor,
                     eps: float) -> Tuple[Tensor, Tensor, Tensor]:
    """Train-mode batch norm over every axis of ``x`` but the last:
    ``(out, mean, var)``, ``var`` biased. Differentiable in ``x``, ``gamma``
    and ``beta``; ``mean`` and ``var`` are not."""
    return BatchNormTrain.apply(x, gamma, beta, float(eps))


def batch_norm_infer(x: Tensor, gamma: Tensor, beta: Tensor, mean: Tensor,
                     var: Tensor, eps: float) -> Tensor:
    """Inference batch norm: the running statistics folded into one scale
    and one shift a channel, applied in ``x``'s dtype."""
    wide = at_least_f32(x.dtype)
    inv = torch.rsqrt(var.to(wide) + eps)
    scale = gamma.to(wide) * inv
    shift = beta.to(wide) - mean.to(wide) * scale
    return x * scale.to(x.dtype) + shift.to(x.dtype)
