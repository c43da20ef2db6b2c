"""Dynamic micro-batching with padded power-of-two batch buckets.

Counterpart of ``deeplearning4j_tpu/keras_server/batcher.py``. Concurrent
requests group by model and by each input's per-example shape and dtype; a
group dispatches when it reaches ``max_batch`` or its oldest request has
waited ``max_latency_s``. The rows are zero-padded to the next power-of-two
bucket (capped at ``max_batch``). Rows are independent under the inference
forward, so padding does not change any request's answer. A graph with
several inputs takes a list of arrays sharing the leading axis, concatenated
and padded input by input; with several outputs each answer is a list.
A ``ReplicaSet`` member carries its ``replica`` index into every answer.
"""
from __future__ import annotations

import threading
import time
from concurrent.futures import Future
from typing import List, Optional, Tuple

import numpy as np

from ..common import host_numpy
from .admission import AdmissionController
from .registry import ModelRegistry


def batch_bucket(n: int, max_batch: int) -> int:
    """Next power of two >= n, capped at max_batch."""
    if n >= max_batch:
        return max_batch
    b = 1
    while b < n:
        b <<= 1
    return min(b, max_batch)


class _Request:
    __slots__ = ("model", "xs", "n", "key", "future", "t_enqueue")

    def __init__(self, model: str, xs: Tuple[np.ndarray, ...], key: Tuple,
                 t_enqueue: float):
        self.model = model
        self.xs = xs
        self.n = int(xs[0].shape[0])
        self.key = key
        self.future: Future = Future()
        self.t_enqueue = t_enqueue


class MicroBatcher:
    """Coalesces concurrent predict requests into padded micro-batches.

    ``submit()`` is the producer side (HTTP handler threads); one daemon
    dispatcher thread drains the queue."""

    def __init__(self, registry: ModelRegistry, *, max_batch: int = 32,
                 max_latency_s: float = 0.002, max_queue: int = 256,
                 admission: Optional[AdmissionController] = None,
                 replica: Optional[int] = None):
        if max_batch < 1:
            raise ValueError("max_batch must be >= 1")
        self.registry = registry
        #: ReplicaSet member index, or None for a standalone batcher
        self.replica = replica
        self.max_batch = int(max_batch)
        self.max_latency_s = float(max_latency_s)
        self.admission = admission or AdmissionController(
            max_pending=max_queue, expected_latency_s=max_latency_s)
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._queue: List[_Request] = []
        self._closed = False
        self._dispatches = 0
        self._errors = 0
        self._occupancy_sum = 0.0
        self._buckets_seen: set = set()
        self._thread = threading.Thread(
            target=self._loop, daemon=True,
            name="serve-microbatcher" if replica is None
            else f"serve-microbatcher-r{replica}")
        self._thread.start()

    def submit(self, model: str, x, *, priority: str = "high",
               tenant: str = "-") -> Future:
        """Queue one request (``x`` carries a leading batch axis; a graph
        with several inputs takes a list or tuple of arrays sharing it).
        Raises :class:`RejectedError` when admission refuses (HTTP 429);
        ``priority`` and ``tenant`` go to admission."""
        if isinstance(x, (list, tuple)):
            xs = tuple(np.asarray(a) for a in x)
            if not xs:
                raise ValueError("empty input list")
        else:
            xs = (np.asarray(x),)
        for a in xs:
            if a.ndim < 2:
                raise ValueError(f"request needs a leading batch axis, got "
                                 f"shape {a.shape}")
        if len({a.shape[0] for a in xs}) != 1:
            raise ValueError("multi-input request arrays must share the "
                             f"leading batch axis, got "
                             f"{[a.shape[0] for a in xs]}")
        if xs[0].shape[0] > self.max_batch:
            raise ValueError(f"request batch {xs[0].shape[0]} exceeds "
                             f"max_batch {self.max_batch}; split it "
                             "client-side")
        self.admission.admit(priority=priority, tenant=tenant)
        key = (model,) + tuple((a.shape[1:], str(a.dtype)) for a in xs)
        req = _Request(model, xs, key, time.perf_counter())
        with self._cond:
            if self._closed:
                self.admission.release()
                raise RuntimeError("MicroBatcher is closed")
            self._queue.append(req)
            self._cond.notify()
        return req.future

    #: requires-lock: _cond
    def _take_group(self) -> Optional[List[_Request]]:
        """Under the lock: wait for work, honor the fill-or-deadline policy,
        then cut one shape-compatible group from the queue."""
        while True:
            if self._closed and not self._queue:
                return None
            if not self._queue:
                self._cond.wait(0.05)
                continue
            head = self._queue[0]
            rows = 0
            group: List[_Request] = []
            for r in self._queue:
                if r.key == head.key and rows + r.n <= self.max_batch:
                    group.append(r)
                    rows += r.n
                    if rows == self.max_batch:
                        break
            deadline = head.t_enqueue + self.max_latency_s
            now = time.perf_counter()
            if rows < self.max_batch and now < deadline and not self._closed:
                self._cond.wait(deadline - now)
                continue
            taken = set(map(id, group))
            self._queue = [r for r in self._queue if id(r) not in taken]
            return group

    def _dispatch(self, group: List[_Request]) -> None:
        rows = sum(r.n for r in group)
        bucket = batch_bucket(rows, self.max_batch)
        try:
            # the version resolves here, at dispatch time
            mv = self.registry.active(group[0].model)
            xs = []
            for j in range(len(group[0].xs)):
                x = np.concatenate([r.xs[j] for r in group], axis=0)
                if bucket > rows:
                    pad = np.zeros((bucket - rows,) + x.shape[1:], x.dtype)
                    x = np.concatenate([x, pad], axis=0)
                xs.append(x)
            raw = mv.predict_fn(*xs)
            multi_out = isinstance(raw, (list, tuple))
            # .cpu() is this dispatch's sync point: the response is host data
            outs = [host_numpy(o) for o in (raw if multi_out else [raw])]
        except Exception as e:
            with self._lock:
                self._errors += len(group)
            for r in group:
                r.future.set_exception(e)
            return
        finally:
            self.admission.release(len(group))
        with self._lock:
            self._dispatches += 1
            self._occupancy_sum += rows / bucket
            self._buckets_seen.add((group[0].key, bucket))
        off = 0
        for r in group:
            pred = [o[off:off + r.n] for o in outs]
            r.future.set_result(
                {"predictions": pred if multi_out else pred[0],
                 "model": mv.name, "version": mv.version, "batch_rows": rows,
                 "bucket": bucket, "replica": self.replica})
            off += r.n

    def _loop(self) -> None:
        while True:
            with self._cond:
                group = self._take_group()
            if group is None:
                return
            self._dispatch(group)

    def stats(self) -> dict:
        with self._lock:
            return {
                "queue_depth": len(self._queue),
                "pending": self.admission.pending,
                "max_queue": self.admission.max_pending,
                "rejected": self.admission.rejected,
                "dispatches": self._dispatches,
                "errors": self._errors,
                "mean_occupancy": (self._occupancy_sum / self._dispatches
                                   if self._dispatches else 0.0),
                "bucket_count": len(self._buckets_seen),
                "max_batch": self.max_batch,
                "max_latency_s": self.max_latency_s,
                "replica": self.replica,
                "admission": self.admission.stats(),
            }

    def close(self, timeout_s: float = 5.0) -> None:
        """Stop accepting work; the dispatcher drains the queue first."""
        with self._cond:
            self._closed = True
            self._cond.notify_all()
        self._thread.join(timeout_s)
