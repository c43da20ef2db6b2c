"""A float32 matmul whose answer for a row does not depend on the batch.

The serving pins (``nn/inference.py``) run their dense products through
:func:`fixed_matmul` (``csrc/fixed_matmul.cu``). cuBLAS chooses its
algorithm by the row count M, so under it a sharded pin, which runs each
data slot's share of a batch, parts from the whole pin in the last bits;
the JAX package's sharded pin is bitwise the single-device pin at every
batch size. Training and ``fit`` keep cuBLAS.

The kernel runs on the tensor cores in split TF32 (each operand cut into
``hi + lo``, hi rounded to nearest so that the split is unbiased, three
TF32 products a step) and sums every output element in
one order fixed by K alone (:func:`fixed_matmul_plan`): K in chunks of
:data:`FIXED_MM_CHUNK` rows from 0, one tensor-core accumulator chain a
chunk over its 8-deep steps in order, the three products of a step in
:data:`FIXED_MM_PASSES` order, and each chunk's partial added to a float32
total in chunk order. The chain restarts every chunk because the tensor
core truncates its accumulator after each step: one chain over K = 1,024
drifts past 2e-5 of float32 at unit-scale outputs. No split-K, no
reduction across threads. So a row gets the same float32 bits at every M.

:func:`row_invariant_matmuls` turns the route on for the products of the
dense-family and attention layers (``policy_matmul``) made by the calling
thread inside the block, where the policy computes in float32. On a CPU
tensor the wrapper takes its plain version, ``torch.matmul``.
"""
from __future__ import annotations

import contextlib
import functools
import threading
from typing import NamedTuple, Tuple

import torch

from . import _cuda

_ARGS = [_cuda.PTR, _cuda.PTR, _cuda.PTR] + [_cuda.INT] * 10 + [_cuda.PTR]
#: rows of K a ``cp.async`` stage (``csrc/fixed_matmul.cu`` BK)
FIXED_MM_BK = 32
#: rows of K a tensor-core accumulator chain runs over before its partial
#: is added to the float32 total (``csrc/fixed_matmul.cu`` CHUNK)
FIXED_MM_CHUNK = 32
#: the order of a step's three split-TF32 products into the chain
FIXED_MM_PASSES = ("hi.lo", "lo.hi", "hi.hi")
#: the kernel's tiles ``(bm, bn, wm, wn, stages)``, largest first: a
#: block's rows and columns of C, a warp's, and the ``cp.async`` ring's
#: slots (each is instantiated in ``csrc/fixed_matmul.cu``)
FIXED_MM_TILES = ((64, 128, 32, 64, 3), (64, 64, 32, 32, 3),
                  (64, 32, 16, 32, 4))
#: the row count at which a tile must fill the card: a data slot's share
#: of the whole pin's ``[8, 512]`` predict
FIXED_MM_REF_M = 2048
#: the least share of its waves (of one block an SM) a tile's grid must
#: fill at :data:`FIXED_MM_REF_M` rows
FIXED_MM_WAVE_FILL = 0.9
#: CUDA's grid limits: x (M tiles) and y (N tiles)
_MAX_GRID = (2 ** 31 - 1, 65535)


class FixedMatmulPlan(NamedTuple):
    bm: int      #: rows of C a block
    bn: int      #: columns of C a block
    wm: int      #: rows of C a warp (a whole number of 16-row mma tiles)
    wn: int      #: columns of C a warp (of 8-column mma tiles)
    stages: int  #: slots of the ``cp.async`` ring
    smem: int    #: dynamic shared memory of a block, bytes
    grid: Tuple[int, int]  #: (M tiles, N tiles)
    chunk: int   #: rows of K an accumulator chain; K padded to a whole chunk
    passes: Tuple[str, ...]  #: a step's products, in order


@functools.lru_cache(maxsize=None)
def _tile(N: int, sms: int) -> Tuple[int, int, int, int, int]:
    """The largest of :data:`FIXED_MM_TILES` whose grid at
    :data:`FIXED_MM_REF_M` rows gives every SM a block and fills its waves
    of ``sms`` blocks to :data:`FIXED_MM_WAVE_FILL`; else the smallest."""
    for tile in FIXED_MM_TILES:
        bm, bn = tile[:2]
        blocks = -(-FIXED_MM_REF_M // bm) * -(-N // bn)
        waves = -(-blocks // sms)
        if blocks >= sms and blocks >= FIXED_MM_WAVE_FILL * waves * sms:
            return tile
    return FIXED_MM_TILES[-1]


def fixed_matmul_plan(M: int, K: int, N: int, sms: int) -> FixedMatmulPlan:
    """The launch of ``[M, K] @ [K, N]`` on a card of ``sms`` SMs. The tile
    depends on N and ``sms`` alone, and the K order (``chunk``, ``passes``)
    on nothing, so every M of a product runs one instantiation and sums a
    row alike; only the grid's M tiles follow M. Raises when the grid
    passes CUDA's limits."""
    if min(M, K, N) < 1:
        raise ValueError(f"fixed_matmul_plan: empty product {M}x{K}x{N}")
    bm, bn, wm, wn, stages = _tile(N, sms)
    grid = (-(-M // bm), -(-N // bn))
    if grid[0] > _MAX_GRID[0] or grid[1] > _MAX_GRID[1]:
        raise ValueError(f"fixed_matmul: [{M}, {K}] @ [{K}, {N}] passes the "
                         f"grid's limits ({grid} blocks of {bm} x {bn})")
    smem = 4 * stages * (bm * (FIXED_MM_BK + 4) + FIXED_MM_BK * (bn + 8))
    return FixedMatmulPlan(bm, bn, wm, wn, stages, smem, grid,
                           FIXED_MM_CHUNK, FIXED_MM_PASSES)


@functools.lru_cache(maxsize=4096)
def _launch_args(M: int, K: int, N: int, device: int) -> tuple:
    """The C entry point's integer arguments for a product on ``device``."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    p = fixed_matmul_plan(M, K, N, sms)
    return (M, N, K, p.bm, p.bn, p.wm, p.wn, p.stages, p.smem, device)


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
    dev = x.device
    if dev != w.device:
        raise ValueError("fixed_matmul operands must share one device")
    if dev.type == "cpu":
        return fixed_matmul_plain(x, w)
    if dev.type != "cuda":
        raise ValueError(f"fixed_matmul: unsupported device {dev}")
    # the host's work a call is kept small (no reshape of a contiguous x
    # or of the output): at a data slot's rows the kernel takes tens of
    # microseconds, about what a Python wrapper costs
    K, N = w.shape
    a = x.contiguous()
    b = w.contiguous()
    out = torch.empty(x.shape[:-1] + (N,), dtype=torch.float32, device=dev)
    M = out.numel() // N if N else 0
    if M and K:
        index = (dev.index if dev.index is not None
                 else torch.cuda.current_device())
        fn = _cuda.function("fixed_matmul", "fixed_matmul", _ARGS)
        rc = fn(a.data_ptr(), b.data_ptr(), out.data_ptr(),
                *_launch_args(M, K, N, index),
                torch._C._cuda_getCurrentRawStream(index))
        _cuda.check(rc, "fixed_matmul", "fixed_matmul launch")
        _cuda.count(fixed_matmul)
    elif M:
        out.zero_()
    return out
