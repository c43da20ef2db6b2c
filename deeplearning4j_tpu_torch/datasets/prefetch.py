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

The prefetcher writes the JAX module's series, one labelset a fit path
(``path``): the queue's depth, bytes staged, producer seconds staging,
consumer seconds waiting and the overlap ratio (1 - wait / staging). Every
second is a host clock around host work (pulling an item, stacking it,
queuing its copy, waiting on the queue); nothing synchronizes the card to
measure. Its own counters (``staged``, ``staging_s``, ``wait_s``,
``bytes``) read the same work for one prefetcher. ``wait_series`` (the fit
loops' ``dl4j_fit_phase_seconds{phase="staging"}``) observes each wait.
"""
from __future__ import annotations

import queue
import threading
import time
from typing import Callable, Iterable, Optional

import numpy as np
import torch

from ..observability.metrics import global_registry
from ..observability.names import (
    PREFETCH_BYTES_TOTAL, PREFETCH_DEPTH, PREFETCH_OVERLAP_RATIO,
    PREFETCH_STAGING_SECONDS_TOTAL, PREFETCH_WAIT_SECONDS_TOTAL)

# families resolved once; a prefetcher resolves its path's series once
_depth_gauge = global_registry().gauge(
    PREFETCH_DEPTH,
    "staged items currently queued ahead of the dispatch loop, by fit path")
_bytes_total = global_registry().counter(
    PREFETCH_BYTES_TOTAL,
    "bytes of staged device arrays handed to the prefetch queue, by fit path")
_staging_total = global_registry().counter(
    PREFETCH_STAGING_SECONDS_TOTAL,
    "producer-thread seconds spent pulling + staging items (the work hidden "
    "behind dispatch when overlap works), by fit path")
_wait_total = global_registry().counter(
    PREFETCH_WAIT_SECONDS_TOTAL,
    "consumer seconds blocked waiting for a staged item (staging NOT hidden "
    "behind dispatch), by fit path")
_overlap_gauge = global_registry().gauge(
    PREFETCH_OVERLAP_RATIO,
    "1 - wait/staging over this prefetcher's lifetime: fraction of staging "
    "time hidden behind dispatch (1.0 = fully overlapped)")

_DONE = object()  # queue sentinel: the producer finished or was stopped


class DevicePrefetcher:
    """``stage(item)`` for each item of ``source``, yielded in order.

    Single-use iterable. An error raised by the source or by ``stage``
    reaches the consumer after every item staged before it: the consumer
    sees the prefix the synchronous loop would. ``close()`` (also run when
    iteration ends or the consumer's loop exits early) stops the producer;
    its bounded put polls a stop flag, so it never stays blocked on a full
    queue. ``path`` labels its series (None: no series);
    ``wait_series`` observes each wait of the consumer (at depth <= 0,
    each inline staging)."""

    def __init__(self, source: Iterable, stage: Optional[Callable] = None,
                 *, depth: int = 2, path: Optional[str] = "default",
                 wait_series=None):
        self._source = source
        self._stage = stage
        self._depth = depth
        self._wait_series = wait_series
        self._m = None if path is None else {
            "depth": _depth_gauge.labels(path=path),
            "bytes": _bytes_total.labels(path=path),
            "staging": _staging_total.labels(path=path),
            "wait": _wait_total.labels(path=path),
            "overlap": _overlap_gauge.labels(path=path)}
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

    def _staged(self, item, t0: float):
        """``item`` staged; ``t0`` is when its pull began."""
        if self._stage is not None:
            item = self._stage(item)
        dt = time.perf_counter() - t0
        nbytes = _nbytes(item)
        self.staging_s += dt
        self.staged += 1
        self.bytes += nbytes
        if self._m is not None:
            self._m["staging"].inc(dt)
            if nbytes:
                self._m["bytes"].inc(nbytes)
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
            it = iter(self._source)
            while not self._stop.is_set():
                t0 = time.perf_counter()
                try:
                    item = next(it)
                except StopIteration:
                    break
                if not self._put(self._staged(item, t0)):
                    return
                if self._m is not None:
                    self._m["depth"].set(self._q.qsize())
        except Exception as e:  # handed to the consumer, in order
            self._error = e
        finally:
            self._put(_DONE)

    # ---------------------------------------------------------------- consumer
    def __iter__(self):
        if self._depth <= 0:
            for item in self._source:
                t0 = time.perf_counter()
                item = self._staged(item, t0)
                dt = time.perf_counter() - t0
                self.wait_s += dt
                if self._wait_series is not None:
                    self._wait_series.observe(dt)
                yield item
            return
        self.thread = threading.Thread(target=self._run, daemon=True,
                                       name="dl4j-prefetch")
        self.thread.start()
        try:
            while True:
                t0 = time.perf_counter()
                item = self._q.get()
                wait = time.perf_counter() - t0
                if item is _DONE:
                    if self._error is not None:
                        raise self._error
                    return
                self.wait_s += wait
                if self._m is not None:
                    self._m["wait"].inc(wait)
                    self._m["depth"].set(self._q.qsize())
                    if self.staging_s > 0.0:
                        self._m["overlap"].set(max(0.0, min(
                            1.0, 1.0 - self.wait_s / self.staging_s)))
                if self._wait_series is not None:
                    self._wait_series.observe(wait)
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
