"""A float32 matmul whose answer for a row does not depend on the batch.

The serving pins (``nn/inference.py``) run their dense products through
:func:`fixed_matmul` (``csrc/fixed_matmul.cu``): each output element is one
chain of fused multiply-adds over K in order, in one thread, with no
split-K, so a row gets the same float32 bits at every row count M. cuBLAS
chooses its algorithm by M, so under it a sharded pin, which runs each
data slot's share of a batch, parts from the whole pin in the last bits;
the JAX package's sharded pin is bitwise the single-device pin at every
batch size. Training and ``fit`` keep cuBLAS.

:func:`row_invariant_matmuls` turns the route on for the products of the
dense-family and attention layers (``policy_matmul``) made by the calling
thread inside the block, where the policy computes in float32. On a CPU
tensor the wrapper takes its plain version, ``torch.matmul``.
"""
from __future__ import annotations

import contextlib
import threading

import torch

from . import _cuda

_ARGS = [_cuda.PTR, _cuda.PTR, _cuda.PTR, _cuda.INT, _cuda.INT, _cuda.INT,
         _cuda.PTR]
#: the kernel's row tile; the grid's y dimension is M over it
_BM = 64
_MAX_GRID_Y = 65535

_state = threading.local()


@contextlib.contextmanager
def row_invariant_matmuls():
    """Within the block, this thread's float32 ``policy_matmul`` products
    take :func:`fixed_matmul`."""
    prev = getattr(_state, "on", False)
    _state.on = True
    try:
        yield
    finally:
        _state.on = prev


def row_invariant() -> bool:
    """Whether this thread is inside :func:`row_invariant_matmuls`."""
    return getattr(_state, "on", False)


def fixed_matmul_plain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The plain version: ``x @ w``."""
    return torch.matmul(x, w)


@_cuda.counted
def fixed_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x [..., K] @ w [K, N]`` in float32, each row's answer the same at
    every row count (the module docstring)."""
    if w.ndim != 2 or x.shape[-1] != w.shape[0]:
        raise ValueError(f"fixed_matmul needs x [..., K] and w [K, N]; got "
                         f"{tuple(x.shape)}, {tuple(w.shape)}")
    if x.dtype != torch.float32 or w.dtype != torch.float32:
        raise TypeError(f"fixed_matmul takes float32, got {x.dtype}, "
                        f"{w.dtype}")
    if x.device != w.device:
        raise ValueError("fixed_matmul operands must share one device")
    if x.device.type == "cpu":
        return fixed_matmul_plain(x, w)
    if x.device.type != "cuda":
        raise ValueError(f"fixed_matmul: unsupported device {x.device}")
    K, N = w.shape
    a = x.reshape(-1, K).contiguous()
    b = w.contiguous()
    M = a.shape[0]
    if -(-M // _BM) > _MAX_GRID_Y:
        raise ValueError(f"fixed_matmul: {M} rows pass the grid's limit")
    out = torch.empty((M, N), dtype=torch.float32, device=x.device)
    if out.numel() and K:
        fn = _cuda.function("fixed_matmul", "fixed_matmul", _ARGS)
        with torch.cuda.device(x.device):
            rc = fn(a.data_ptr(), b.data_ptr(), out.data_ptr(), M, N, K,
                    _cuda.stream_handle())
        _cuda.check(rc, "fixed_matmul", "fixed_matmul launch")
        _cuda.count(fixed_matmul)
    elif out.numel():
        out.zero_()
    return out.reshape(*x.shape[:-1], N)
