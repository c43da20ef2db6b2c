"""Fused softmax cross-entropy: per-row loss and the logits' gradient.

Counterpart of ``softmax_cross_entropy`` in
``deeplearning4j_tpu/ops/pallas_kernels.py``. On CUDA tensors it launches
``csrc/sm_xent.cu`` at every shape, along the route :func:`sm_xent_plan`
gives; on CPU tensors it runs the plain version. Labels are dense ``[N, C]``,
as in the JAX package.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from . import _cuda

_DTYPES = (torch.float32, torch.bfloat16)
#: the widest row a warp takes (64 values a lane); wider rows take a block
WARP_MAX_C = 2048
#: rows of a block on the warp route (8 warps of 32 lanes)
WARP_ROWS = 8


class SmXentPlan(NamedTuple):
    route: str     #: "warp" (a warp a row) or "block" (a block a row)
    rows: int      #: rows of a block
    grid: int      #: blocks
    vec: int       #: elements of a lane's chunk (one 16- or 8-byte access)
    per_lane: int  #: values a lane holds (an instantiation; >= its share)


def sm_xent_plan(N: int, C: int, dtype: torch.dtype = torch.float32
                 ) -> SmXentPlan:
    """The launch of ``csrc/sm_xent.cu`` for ``N`` rows of ``C`` logits of
    ``dtype``; the C side follows it. Up to :data:`WARP_MAX_C` a warp takes a
    row into registers: lane ``l`` holds chunks ``l, l + 32, ...`` of ``vec``
    neighbouring elements (4, 2 or 1: the widest that divides ``C`` and still
    gives every lane a chunk), ``per_lane`` the least power of two (2 or more)
    that holds its share; 8 rows a block. Wider rows take a block each."""
    if dtype not in _DTYPES:
        raise TypeError(f"sm_xent_plan takes float32/bfloat16, got {dtype}")
    if C > WARP_MAX_C:
        return SmXentPlan("block", 1, N, 1, 0)
    vec = next(v for v in (4, 2, 1) if C % v == 0 and (C >= 32 * v or v == 1))
    share = -(-C // (32 * vec)) * vec
    per_lane = max(2, vec, 1 << (share - 1).bit_length())
    return SmXentPlan("warp", WARP_ROWS, -(-N // WARP_ROWS), vec, per_lane)


def softmax_cross_entropy_plain(logits: torch.Tensor, labels: torch.Tensor
                                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version: ``loss = -sum y * log_softmax(x)`` in float32 and
    ``grad = softmax(x) - y`` in the logits' dtype, as the kernel computes."""
    x = logits.to(torch.float32)
    y = labels.to(torch.float32)
    m = x.amax(dim=1, keepdim=True)
    e = torch.exp(x - m)
    z = e.sum(dim=1, keepdim=True)
    logp = x - m - torch.log(z)
    loss = -(y * logp).sum(dim=1)
    return loss, (e / z - y).to(logits.dtype)


_ARGS = [_cuda.PTR] * 4 + [_cuda.INT] * 9 + [_cuda.PTR]


@_cuda.counted
def softmax_cross_entropy(logits: torch.Tensor, labels: torch.Tensor
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(loss [N] float32, grad [N, C] in the logits' dtype)`` for logits and
    labels ``[N, C]`` (float32 or bfloat16 each). On CUDA tensors this
    launches ``csrc/sm_xent.cu`` along :func:`sm_xent_plan`; on CPU tensors
    it runs the plain version."""
    if logits.ndim != 2 or labels.shape != logits.shape:
        raise ValueError(f"softmax_cross_entropy needs logits and labels "
                         f"[N, C], got {tuple(logits.shape)} and "
                         f"{tuple(labels.shape)}")
    if logits.dtype not in _DTYPES or labels.dtype not in _DTYPES:
        raise TypeError(f"softmax_cross_entropy takes float32/bfloat16, got "
                        f"{logits.dtype} and {labels.dtype}")
    if logits.device != labels.device:
        raise ValueError("softmax_cross_entropy operands must share one device")
    if logits.device.type == "cpu":
        return softmax_cross_entropy_plain(logits, labels)
    if logits.device.type != "cuda":
        raise ValueError(f"softmax_cross_entropy: unsupported device "
                         f"{logits.device}")
    if not (logits.is_contiguous() and labels.is_contiguous()):
        raise ValueError("softmax_cross_entropy needs contiguous operands")
    N, C = logits.shape
    loss = torch.empty(N, dtype=torch.float32, device=logits.device)
    grad = torch.empty_like(logits)
    if N == 0 or C == 0:
        return loss.fill_(0.0), grad
    plan = sm_xent_plan(N, C, logits.dtype)
    fn = _cuda.function("sm_xent", "sm_xent", _ARGS)
    rc = fn(logits.data_ptr(), labels.data_ptr(), loss.data_ptr(),
            grad.data_ptr(), N, C, int(logits.dtype == torch.bfloat16),
            int(labels.dtype == torch.bfloat16), int(plan.route == "warp"),
            plan.rows, plan.grid, plan.vec, plan.per_lane,
            _cuda.stream_handle())
    _cuda.check(rc, "sm_xent", "sm_xent launch")
    _cuda.count(softmax_cross_entropy)
    return loss, grad
