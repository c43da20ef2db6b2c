"""Fused softmax cross-entropy: per-row loss and the logits' gradient.

Counterpart of ``softmax_cross_entropy`` in
``deeplearning4j_tpu/ops/pallas_kernels.py``. On CUDA tensors it launches
``csrc/sm_xent.cu`` at every shape; on CPU tensors it runs the plain version.
Labels are dense ``[N, C]``, as in the JAX package.
"""
from __future__ import annotations

from typing import Tuple

import torch

from . import _cuda

_DTYPES = (torch.float32, torch.bfloat16)


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


_ARGS = [_cuda.PTR, _cuda.PTR, _cuda.PTR, _cuda.PTR, _cuda.INT, _cuda.INT,
         _cuda.INT, _cuda.INT, _cuda.PTR]


def softmax_cross_entropy(logits: torch.Tensor, labels: torch.Tensor
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(loss [N] float32, grad [N, C] in the logits' dtype)`` for logits and
    labels ``[N, C]`` (float32 or bfloat16 each). On CUDA tensors this
    launches ``csrc/sm_xent.cu``; on CPU tensors it runs the plain version."""
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
    fn = _cuda.function("sm_xent", "sm_xent", _ARGS)
    rc = fn(logits.data_ptr(), labels.data_ptr(), loss.data_ptr(),
            grad.data_ptr(), N, C, int(logits.dtype == torch.bfloat16),
            int(labels.dtype == torch.bfloat16), _cuda.stream_handle())
    _cuda.check(rc, "sm_xent", "sm_xent launch")
    softmax_cross_entropy.launches += 1
    return loss, grad


softmax_cross_entropy.launches = 0
