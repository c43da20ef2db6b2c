"""Device prefetch: stage the next group while the current one runs.

Counterpart of ``deeplearning4j_tpu/datasets/prefetch.py``.
:class:`DevicePrefetcher` pulls items from a source on a producer thread,
runs ``stage`` on each and hands them over in order through a bounded queue
(depth 2 by default: the next group is staged while the consumer runs the
current one). Depth <= 0 stages inline on the consumer's thread.

On the card, the fit loops' ``stage`` (:func:`stage_to_device`) stacks a
K-step group into pinned host memory and copies it with ``non_blocking``
on a side CUDA stream, recording an event; the consumer makes its stream
wait on that event (:func:`consume_staged`) before the group's first step,
so the copy of group n+1 overlaps the steps of group n. Every staged group
is a fresh device buffer that no step writes (the steps read it into their
own input buffers), the counterpart of the JAX note on donation safety.

The JAX module's Prometheus series belong to its observability plane, not
ported yet; the prefetcher keeps plain counters instead: groups staged,
producer seconds staging, consumer seconds waiting, and bytes staged.
"""
from __future__ import annotations

import queue
import threading
import time
from typing import Callable, Iterable, Optional

import numpy as np
import torch

_DONE = object()  # queue sentinel: the producer finished or was stopped


class DevicePrefetcher:
    """``stage(item)`` for each item of ``source``, yielded in order.

    Single-use iterable. An error raised by the source or by ``stage``
    reaches the consumer after every item staged before it: the consumer
    sees the prefix the synchronous loop would. ``close()`` (also run when
    iteration ends or the consumer's loop exits early) stops the producer;
    its bounded put polls a stop flag, so it never stays blocked on a full
    queue."""

    def __init__(self, source: Iterable, stage: Optional[Callable] = None,
                 *, depth: int = 2):
        self._source = source
        self._stage = stage
        self._depth = depth
        self._q: queue.Queue = queue.Queue(maxsize=max(1, depth))
        self._stop = threading.Event()
        self._error: Optional[BaseException] = None
        self.thread: Optional[threading.Thread] = None
        #: items staged, producer seconds spent pulling and staging them,
        #: consumer seconds spent waiting for them, and bytes of the staged
        #: tensors
        self.staged = 0
        self.staging_s = 0.0
        self.wait_s = 0.0
        self.bytes = 0

    def _staged(self, item):
        t0 = time.perf_counter()
        if self._stage is not None:
            item = self._stage(item)
        self.staging_s += time.perf_counter() - t0
        self.staged += 1
        self.bytes += _nbytes(item)
        return item

    # ---------------------------------------------------------------- producer
    def _put(self, item) -> bool:
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.05)
                return True
            except queue.Full:
                continue
        return False

    def _run(self) -> None:
        try:
            for item in self._source:
                if self._stop.is_set() or not self._put(self._staged(item)):
                    return
        except Exception as e:  # handed to the consumer, in order
            self._error = e
        finally:
            self._put(_DONE)

    # ---------------------------------------------------------------- consumer
    def __iter__(self):
        if self._depth <= 0:
            for item in self._source:
                t0 = time.perf_counter()
                item = self._staged(item)
                self.wait_s += time.perf_counter() - t0
                yield item
            return
        self.thread = threading.Thread(target=self._run, daemon=True,
                                       name="dl4j-prefetch")
        self.thread.start()
        try:
            while True:
                t0 = time.perf_counter()
                item = self._q.get()
                self.wait_s += time.perf_counter() - t0
                if item is _DONE:
                    if self._error is not None:
                        raise self._error
                    return
                yield item
        finally:
            self.close()

    def close(self) -> None:
        """Stop the producer, drain the queue so it is not blocked, and join
        it. Safe to call more than once."""
        self._stop.set()
        if self.thread is None:
            return
        while True:
            try:
                self._q.get_nowait()
            except queue.Empty:
                break
        if self.thread.is_alive():
            self.thread.join(timeout=5.0)

    def __enter__(self) -> "DevicePrefetcher":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def _nbytes(item) -> int:
    if isinstance(item, torch.Tensor):
        return item.numel() * item.element_size()
    if isinstance(item, np.ndarray):
        return item.nbytes
    if isinstance(item, (list, tuple)):
        return sum(_nbytes(v) for v in item)
    if isinstance(item, StagedGroup):
        return _nbytes(item.xs) + _nbytes(item.ys)
    return 0


class StagedGroup:
    """A K-step group on the device: one ``[K, B, ...]`` tensor per network
    input (``xs``) and per output (``ys``), ``n`` steps, and on the card the
    event its copy recorded on the staging stream."""

    def __init__(self, xs: list, ys: list, n: int,
                 ready: Optional[torch.cuda.Event] = None):
        self.xs, self.ys, self.n, self.ready = xs, ys, n, ready


def _stack(arrays: list, dtype, pin: bool) -> torch.Tensor:
    """``arrays`` stacked on a new leading axis into one host tensor, pinned
    when ``pin``, in ``dtype`` (default: float64 becomes float32, as JAX
    stages it)."""
    first = np.asarray(arrays[0])
    if dtype is None:
        dtype = (torch.float32 if first.dtype == np.float64
                 else torch.from_numpy(first[:0]).dtype)
    shape = (len(arrays),) + first.shape
    out = torch.empty(shape, dtype=dtype, pin_memory=pin)
    for i, a in enumerate(arrays):
        out[i].copy_(torch.as_tensor(np.asarray(a)))
    return out


def stage_to_device(batches: list, device: torch.device, stage_dtype=None,
                    stream: Optional[torch.cuda.Stream] = None) -> StagedGroup:
    """Stack a group of ``(inputs, labels)`` lists of host arrays, one per
    step, into ``[K, B, ...]`` tensors on ``device``. Features take
    ``stage_dtype`` on the host, before the copy. On the card the stacks
    are pinned and copied with ``non_blocking`` on ``stream`` (a side
    stream), and the returned group carries the copy's event."""
    n_in, n_out = len(batches[0][0]), len(batches[0][1])
    cuda = device.type == "cuda"
    xs = [_stack([b[0][i] for b in batches], stage_dtype, cuda)
          for i in range(n_in)]
    ys = [_stack([b[1][i] for b in batches], None, cuda) for i in range(n_out)]
    if not cuda:
        return StagedGroup(xs, ys, len(batches))
    with torch.cuda.stream(stream):
        xs = [t.to(device, non_blocking=True) for t in xs]
        ys = [t.to(device, non_blocking=True) for t in ys]
        ready = torch.cuda.Event()
        ready.record(stream)
    return StagedGroup(xs, ys, len(batches), ready)


def consume_staged(group: StagedGroup) -> None:
    """Make the current stream wait for a staged group's copy, and tell the
    caching allocator that the current stream uses its buffers (they were
    allocated on the staging stream)."""
    if group.ready is None:
        return
    cur = torch.cuda.current_stream()
    cur.wait_event(group.ready)
    for t in group.xs + group.ys:
        t.record_stream(cur)
