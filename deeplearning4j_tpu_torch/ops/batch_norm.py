"""Train-mode batch normalization with the JAX package's formulas.

Counterpart of ``batch_norm_stats`` and ``batch_norm_train`` in
``deeplearning4j_tpu/ops/pallas_kernels.py``. That one is a
``jax.custom_vjp`` over XLA ops, not a Pallas kernel, so this is plain
PyTorch: a ``torch.autograd.Function`` with the same forward and the same
hand-written backward.

- Statistics in one pass: ``mean = E[x]``, ``var = E[x^2] - mean^2``
  clamped at 0 (the biased variance), over every axis but the last
  (``(N, H, W)`` of an NHWC tensor, ``N`` of ``[N, F]``), in
  ``stat_dtype`` (the policy's :meth:`~..common.DtypePolicy.stat_dtype`).
  A bfloat16 ``stat_dtype`` (the ``bfloat16_flagship`` policy) makes both
  sums bfloat16 results, as XLA's bf16 reduce does: ``sum`` over a bf16
  tensor accumulates in float32 and rounds once. No running sum is ever
  kept in bfloat16 (at 128 x 112 x 112 values a channel one would stop
  moving).
- Forward: ``x * scale + shift`` in ``x``'s dtype, with ``scale = gamma /
  sqrt(var + eps)`` and ``shift = beta - mean * scale`` formed in at least
  float32.
- Backward: ``dbeta = sum(dy)``, ``dgamma = sum(dy * xhat)`` (in
  ``stat_dtype``) and
  ``dx = gamma / sqrt(var + eps) * (dy - dbeta / n - xhat * dgamma / n)``.

With a process group (a data-parallel step's batch ranks) the statistics
are the global batch's: the forward all-reduces each rank's count, sum and
sum of squares (in float32, the sums formed in ``stat_dtype`` as above),
and the backward all-reduces ``sum(dy)`` and ``sum(dy * xhat)`` for ``dx``.
The gradients of gamma and beta stay this rank's own sums: the step
averages every param's gradient over the ranks afterwards. No group is the
single-device code path.

``F.batch_norm`` computes another function: its statistics take two passes
and its running update takes the unbiased variance. The ``mean`` and ``var``
outputs feed the layer's running average only and are not differentiated.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

import torch.distributed as dist

from ..common import at_least_f32

Tensor = torch.Tensor


def _dims(x: Tensor) -> Tuple[int, ...]:
    return tuple(range(x.ndim - 1))


def _stat(x: Tensor, stat_dtype: Optional[torch.dtype]) -> torch.dtype:
    return at_least_f32(x.dtype) if stat_dtype is None else stat_dtype


def batch_norm_stats(x: Tensor, stat_dtype: Optional[torch.dtype] = None
                     ) -> Tuple[Tensor, Tensor]:
    """``(mean, biased var)`` per channel (last axis) in one pass over
    ``x`` (sum and sum of squares), in ``stat_dtype`` (default: at least
    float32); the variance is clamped at 0 against the cancellation of
    ``E[x^2] - mean^2``."""
    xs = x.to(_stat(x, stat_dtype))
    dims = _dims(x)
    inv_n = 1.0 / (x.numel() // x.shape[-1])
    mean = xs.sum(dims) * inv_n
    var = torch.clamp_min((xs * xs).sum(dims) * inv_n - mean * mean, 0.0)
    return mean, var


def _group_stats(x: Tensor, stat_dtype: torch.dtype, group
                 ) -> Tuple[Tensor, Tensor, float]:
    """``(mean, biased var, 1 / global count)`` over the ranks of
    ``group``: each rank's count, sum and sum of squares all-reduced
    together in float32."""
    xs = x.to(stat_dtype)
    dims = _dims(x)
    s1, s2 = xs.sum(dims), (xs * xs).sum(dims)
    n_local = torch.full((1,), x.numel() // x.shape[-1], dtype=torch.float32,
                         device=x.device)
    buf = torch.cat([s1.to(torch.float32), s2.to(torch.float32), n_local])
    dist.all_reduce(buf, group=group)
    c = s1.shape[0]
    inv_n = 1.0 / buf[2 * c]
    mean = (buf[:c] * inv_n).to(stat_dtype)
    var = torch.clamp_min((buf[c:2 * c] * inv_n).to(stat_dtype) - mean * mean,
                          0.0)
    return mean, var, inv_n


class BatchNormTrain(torch.autograd.Function):
    """``(out, mean, var)`` of a train-mode batch norm; the backward is the
    JAX package's hand-written VJP (``_bn_train_bwd``). With ``group`` the
    statistics and the backward's two sums are the group's (the group is
    kept in ``ctx``: the backward runs on autograd's thread)."""

    @staticmethod
    def forward(ctx, x: Tensor, gamma: Tensor, beta: Tensor, eps: float,
                stat_dtype: torch.dtype, group=None):
        if group is None:
            mean, var = batch_norm_stats(x, stat_dtype)
            inv_n = 1.0 / (x.numel() // x.shape[-1])
        else:
            mean, var, inv_n = _group_stats(x, stat_dtype, group)
        # inv in at least float32: a bf16 rsqrt costs accuracy on a
        # channel-sized vector for no saving
        wide = torch.promote_types(stat_dtype, torch.float32)
        inv = torch.rsqrt(var.to(wide) + eps)
        scale = gamma.to(wide) * inv
        shift = beta.to(wide) - mean.to(wide) * scale
        out = x * scale.to(x.dtype) + shift.to(x.dtype)
        ctx.save_for_backward(x, gamma, mean, inv)
        ctx.stat_dtype = stat_dtype
        ctx.group, ctx.inv_n = group, inv_n
        ctx.mark_non_differentiable(mean, var)
        return out, mean, var

    @staticmethod
    def backward(ctx, dy: Tensor, _dmean, _dvar):
        x, gamma, mean, inv = ctx.saved_tensors
        dims = _dims(x)
        wide, sd = inv.dtype, ctx.stat_dtype
        xhat = (x - mean.to(x.dtype)) * inv.to(x.dtype)
        dbeta = dy.to(sd).sum(dims)
        dgamma = (dy * xhat).to(sd).sum(dims)
        inv_n = ctx.inv_n
        sb, sg = dbeta, dgamma
        if ctx.group is not None:
            c = dbeta.shape[0]
            buf = torch.cat([dbeta.to(torch.float32),
                             dgamma.to(torch.float32)])
            dist.all_reduce(buf, group=ctx.group)
            sb, sg = buf[:c].to(sd), buf[c:].to(sd)
        k = gamma.to(wide) * inv
        dx = k.to(x.dtype) * (dy - (sb.to(wide) * inv_n).to(x.dtype)
                              - xhat * (sg.to(wide) * inv_n).to(x.dtype))
        return (dx.to(x.dtype), dgamma.to(gamma.dtype), dbeta.to(gamma.dtype),
                None, None, None)


def batch_norm_train(x: Tensor, gamma: Tensor, beta: Tensor, eps: float,
                     stat_dtype: Optional[torch.dtype] = None, group=None
                     ) -> Tuple[Tensor, Tensor, Tensor]:
    """Train-mode batch norm over every axis of ``x`` but the last:
    ``(out, mean, var)``, ``var`` biased, the statistics in ``stat_dtype``
    (default: at least float32) and ``out`` in ``x``'s dtype, over the ranks
    of ``group`` when one is given. Differentiable in ``x``, ``gamma`` and
    ``beta``; ``mean`` and ``var`` are not."""
    return BatchNormTrain.apply(x, gamma, beta, float(eps),
                                _stat(x, stat_dtype), group)


def batch_norm_infer(x: Tensor, gamma: Tensor, beta: Tensor, mean: Tensor,
                     var: Tensor, eps: float) -> Tensor:
    """Inference batch norm: the running statistics folded into one scale
    and one shift a channel, applied in ``x``'s dtype."""
    wide = at_least_f32(x.dtype)
    inv = torch.rsqrt(var.to(wide) + eps)
    scale = gamma.to(wide) * inv
    shift = beta.to(wide) - mean.to(wide) * scale
    return x * scale.to(x.dtype) + shift.to(x.dtype)
