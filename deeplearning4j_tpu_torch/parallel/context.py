"""The active parallelism context: how layers find the mesh they run under.

Counterpart of ``deeplearning4j_tpu/parallel/context.py``. A trainer
(``ParallelWrapper``) publishes the mesh and the axis roles here while its
step runs, and the layers read them in their forward: attention dispatches
ring or Ulysses attention over the sequence axis (``attend``), batch norm
reduces its statistics over the batch's ranks, and the MoE layers reduce
their routing shares. Without a context every layer runs its
single-device math.

The JAX package reads the context while it traces a step; the port's step
is eager, so the context is read while the step runs: in the forward,
which runs in the caller's thread, and inside the K-step CUDA graph's
capture, which runs there too. Autograd runs the backward on a thread of
its own, where this thread-local context is not set: a backward never
reads it, and each ``autograd.Function`` keeps the process group its
backward needs in its ``ctx``.
"""
from __future__ import annotations

import dataclasses
import threading
from contextlib import contextmanager
from typing import Optional, Tuple

from .mesh import Mesh

_state = threading.local()


@dataclasses.dataclass(frozen=True)
class ParallelContext:
    """Mesh and axis roles of the step running now.

    ``seq_axis``: the mesh axis the time axis is split over; attention
    layers run ring or Ulysses attention over it. ``seq_mode``:
    ``"ulysses"`` (all-to-all head swap, heads must divide the axis) or
    ``"ring"`` (K/V rotation). ``expert_axis``: the expert-parallel axis
    (A7.6, refused by ``ParallelWrapper``). ``data_axis``: the axis the
    batch's rows are split over."""

    mesh: Mesh
    seq_axis: Optional[str] = None
    seq_mode: str = "ulysses"
    expert_axis: Optional[str] = None
    capacity_factor: float = 2.0
    data_axis: Optional[str] = None

    def __post_init__(self):
        for ax in (self.seq_axis, self.expert_axis, self.data_axis):
            if ax is not None and ax not in self.mesh.shape:
                raise ValueError(f"axis {ax!r} not in mesh axes "
                                 f"{tuple(self.mesh.shape)}")
        if self.seq_mode not in ("ulysses", "ring"):
            raise ValueError(f"unknown seq_mode {self.seq_mode!r}")

    def batch_axes(self) -> Tuple[str, ...]:
        """The axes that split the batch's examples or tokens: a statistic
        over the batch is reduced over these ranks."""
        return tuple(a for a in (self.data_axis, self.seq_axis)
                     if a is not None)

    def batch_group(self):
        """``(process group, size)`` of :meth:`batch_axes`; the group is
        None for a group of one without a process group."""
        axes = self.batch_axes()
        if not axes:
            return None, 1
        return self.mesh.group(*axes), self.mesh.axis_size(*axes)


def current() -> Optional[ParallelContext]:
    """The context of the step running in this thread now, or None."""
    return getattr(_state, "ctx", None)


@contextmanager
def parallel_context(mesh: Mesh, *, seq_axis: Optional[str] = None,
                     seq_mode: str = "ulysses",
                     expert_axis: Optional[str] = None,
                     capacity_factor: float = 2.0,
                     data_axis: Optional[str] = None):
    """Publish the mesh and axis roles while a distributed step runs."""
    prev = current()
    _state.ctx = ParallelContext(mesh, seq_axis=seq_axis, seq_mode=seq_mode,
                                 expert_axis=expert_axis,
                                 capacity_factor=capacity_factor,
                                 data_axis=data_axis)
    try:
        yield _state.ctx
    finally:
        _state.ctx = prev


def batch_group():
    """``(process group, size)`` the current step's batch statistics are
    reduced over; ``(None, 1)`` outside a parallel step."""
    ctx = current()
    return (None, 1) if ctx is None else ctx.batch_group()


@contextmanager
def no_context():
    """Run a block as a single-device step (no context), inside a parallel
    fit: the wrapper's unsharded fallback."""
    prev = current()
    _state.ctx = None
    try:
        yield
    finally:
        _state.ctx = prev
