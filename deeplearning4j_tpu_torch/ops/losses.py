"""Loss functions.

Counterpart of ``deeplearning4j_tpu/ops/losses.py``. Each loss is a function
``loss(labels, preout, activation, mask) -> scalar`` where ``preout`` is the
final layer's pre-activation output; the activation is applied inside the
loss so the stable fused forms can be used. Per-example scores are reduced
to a mean, or to a masked sum over ``max(sum(mask), 1)``.

``mcxent`` with a softmax activation goes through :class:`FusedSoftmaxXent`,
the counterpart of the JAX ``_fused_sm_xent_per`` ``custom_vjp``: its forward
calls the fused kernel (``ops/softmax_xent.py``, a CUDA launch on CUDA
tensors) and saves ``softmax - labels``, and its backward replays that saved
gradient. The TPU's ``DL4J_FUSED_XENT`` switch is not carried over: the
fused path is taken for every float32 or bfloat16 softmax output.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn.functional as F

from ..common import at_least_f32
from .softmax_xent import softmax_cross_entropy

Tensor = torch.Tensor


def _reduce(per_example: Tensor, mask: Optional[Tensor]) -> Tensor:
    """Mean over examples (``per_example`` has a trailing dim of 1), or, with
    a {0,1} mask over the leading (batch[, time]) dims, the masked sum over
    ``max(sum(mask), 1)``."""
    if mask is None:
        return per_example.mean()
    mask = mask.to(per_example.dtype)
    while mask.ndim < per_example.ndim:
        mask = mask[..., None]
    return (per_example * mask).sum() / torch.clamp_min(mask.sum(), 1.0)


def mse(labels: Tensor, preout: Tensor, activation, mask=None) -> Tensor:
    out = activation(preout)
    per = ((labels - out) ** 2).sum(dim=-1, keepdim=True) / labels.shape[-1]
    return _reduce(per, mask)


def l2(labels: Tensor, preout: Tensor, activation, mask=None) -> Tensor:
    out = activation(preout)
    per = ((labels - out) ** 2).sum(dim=-1, keepdim=True)
    return _reduce(per, mask)


def mae(labels: Tensor, preout: Tensor, activation, mask=None) -> Tensor:
    out = activation(preout)
    per = (labels - out).abs().sum(dim=-1, keepdim=True) / labels.shape[-1]
    return _reduce(per, mask)


def l1(labels: Tensor, preout: Tensor, activation, mask=None) -> Tensor:
    out = activation(preout)
    per = (labels - out).abs().sum(dim=-1, keepdim=True)
    return _reduce(per, mask)


def mape(labels: Tensor, preout: Tensor, activation, mask=None) -> Tensor:
    out = activation(preout)
    denom = torch.where(labels == 0, torch.full_like(labels, 1e-8), labels)
    per = 100.0 * ((labels - out) / denom).abs().sum(dim=-1, keepdim=True) \
        / labels.shape[-1]
    return _reduce(per, mask)


def msle(labels: Tensor, preout: Tensor, activation, mask=None) -> Tensor:
    out = activation(preout)
    per = ((torch.log1p(torch.clamp_min(labels, 0))
            - torch.log1p(torch.clamp_min(out, -0.999999))) ** 2
           ).sum(dim=-1, keepdim=True) / labels.shape[-1]
    return _reduce(per, mask)


def _is_softmax(activation) -> bool:
    return getattr(activation, "__name__", "") in ("softmax", "logsoftmax")


def _is_sigmoid(activation) -> bool:
    return getattr(activation, "__name__", "") == "sigmoid"


class FusedSoftmaxXent(torch.autograd.Function):
    """Per-row softmax cross entropy ``(N, 1)`` float32 for labels and logits
    ``(N, C)``. The forward computes the loss and ``dlogits`` in one pass
    (:func:`~.softmax_xent.softmax_cross_entropy`); the backward returns
    ``ct * dlogits`` for the logits and nothing for the labels, which are
    data (DL4J's LossMCXENT)."""

    @staticmethod
    def forward(ctx, labels, preout):
        loss, grad = softmax_cross_entropy(preout, labels)
        ctx.save_for_backward(grad)
        return loss[:, None]

    @staticmethod
    def backward(ctx, ct):
        (grad,) = ctx.saved_tensors
        d = ct.to(torch.float32) * grad.to(torch.float32)
        return None, d.to(grad.dtype)


def mcxent(labels: Tensor, preout: Tensor, activation, mask=None) -> Tensor:
    """Multi-class cross entropy (DL4J LossMCXENT). With a softmax output the
    per-row loss and gradient come from the fused kernel, with the labels in
    the logits' dtype; float64 and other activations take the plain autograd
    path. Through :func:`get_loss` (the training path) bfloat16 inputs arrive
    upcast to float32, so training launches the float32 kernel; the bfloat16
    branch serves direct callers."""
    if _is_softmax(activation):
        if preout.dtype in (torch.float32, torch.bfloat16):
            C = preout.shape[-1]
            per = FusedSoftmaxXent.apply(
                labels.reshape(-1, C).to(preout.dtype).contiguous(),
                preout.reshape(-1, C).contiguous())
            per = per.reshape(preout.shape[:-1] + (1,)).to(preout.dtype)
            return _reduce(per, mask)
        logp = F.log_softmax(preout, dim=-1)
    else:
        out = activation(preout)
        logp = torch.log(torch.clamp(out, 1e-10, 1.0))
    per = -(labels * logp).sum(dim=-1, keepdim=True)
    return _reduce(per, mask)


def negativeloglikelihood(labels, preout, activation, mask=None) -> Tensor:
    return mcxent(labels, preout, activation, mask)


def xent(labels: Tensor, preout: Tensor, activation, mask=None) -> Tensor:
    """Binary cross entropy (DL4J LossBinaryXENT); stable form for sigmoid."""
    if _is_sigmoid(activation):
        # log(sigmoid(x)) = -softplus(-x); log(1-sigmoid(x)) = -softplus(x)
        per = (labels * F.softplus(-preout) + (1 - labels) * F.softplus(preout)
               ).sum(dim=-1, keepdim=True)
    else:
        out = torch.clamp(activation(preout), 1e-10, 1 - 1e-10)
        per = -(labels * torch.log(out) + (1 - labels) * torch.log(1 - out)
                ).sum(dim=-1, keepdim=True)
    return _reduce(per, mask)


def hinge(labels: Tensor, preout: Tensor, activation, mask=None) -> Tensor:
    out = activation(preout)
    # labels in {-1, +1} or {0, 1} (mapped)
    y = torch.where(labels <= 0, -1.0, 1.0).to(out.dtype)
    per = torch.clamp_min(1.0 - y * out, 0.0).sum(dim=-1, keepdim=True)
    return _reduce(per, mask)


def squared_hinge(labels: Tensor, preout: Tensor, activation, mask=None) -> Tensor:
    out = activation(preout)
    y = torch.where(labels <= 0, -1.0, 1.0).to(out.dtype)
    per = (torch.clamp_min(1.0 - y * out, 0.0) ** 2).sum(dim=-1, keepdim=True)
    return _reduce(per, mask)


def kl_divergence(labels: Tensor, preout: Tensor, activation, mask=None) -> Tensor:
    out = torch.clamp(activation(preout), 1e-10, 1.0)
    lbl = torch.clamp(labels, 1e-10, 1.0)
    per = (lbl * (torch.log(lbl) - torch.log(out))).sum(dim=-1, keepdim=True)
    return _reduce(per, mask)


def poisson(labels: Tensor, preout: Tensor, activation, mask=None) -> Tensor:
    out = torch.clamp_min(activation(preout), 1e-10)
    per = (out - labels * torch.log(out)).sum(dim=-1, keepdim=True)
    return _reduce(per, mask)


def cosine_proximity(labels: Tensor, preout: Tensor, activation, mask=None) -> Tensor:
    out = activation(preout)
    ln = torch.linalg.vector_norm(labels, dim=-1, keepdim=True)
    on = torch.linalg.vector_norm(out, dim=-1, keepdim=True)
    per = -(labels * out).sum(dim=-1, keepdim=True) / torch.clamp_min(ln * on, 1e-10)
    return _reduce(per, mask)


LOSSES: dict[str, Callable] = {
    "mse": mse,
    "l2": l2,
    "mae": mae,
    "l1": l1,
    "mape": mape,
    "msle": msle,
    "mcxent": mcxent,
    "negativeloglikelihood": negativeloglikelihood,
    "xent": xent,
    "hinge": hinge,
    "squared_hinge": squared_hinge,
    "squaredhinge": squared_hinge,
    "kl_divergence": kl_divergence,
    "kld": kl_divergence,
    "reconstruction_crossentropy": xent,
    "poisson": poisson,
    "cosine_proximity": cosine_proximity,
}


def _f32_entry(fn: Callable) -> Callable:
    """Losses compute in at least float32: bfloat16 labels and
    pre-activations are upcast on entry (float64 passes unchanged)."""

    def _upcast(a) -> Tensor:
        a = torch.as_tensor(a)
        if a.is_floating_point():
            return a.to(at_least_f32(a.dtype))
        return a

    def wrapped(labels, preout, activation, mask=None):
        return fn(_upcast(labels), _upcast(preout), activation, mask)
    return wrapped


def get_loss(name) -> Callable:
    """A loss by DL4J-style name (case-insensitive), or a callable wrapped
    the same way; an unknown name raises."""
    if callable(name):
        return _f32_entry(name)
    key = str(name).lower()
    if key not in LOSSES:
        raise ValueError(f"Unknown loss '{name}'. Known: {sorted(LOSSES)}")
    return _f32_entry(LOSSES[key])
