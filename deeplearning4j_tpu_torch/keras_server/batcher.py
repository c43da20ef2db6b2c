"""Dynamic micro-batching with padded power-of-two batch buckets.

Counterpart of ``deeplearning4j_tpu/keras_server/batcher.py``. Concurrent
requests group by model and by each input's per-example shape and dtype; a
group dispatches when it reaches ``max_batch`` or its oldest request has
waited ``max_latency_s``. The rows are zero-padded to the next power-of-two
bucket (capped at ``max_batch``). Rows are independent under the inference
forward, so padding does not change any request's answer. A graph with
several inputs takes a list of arrays sharing the leading axis, concatenated
and padded input by input; with several outputs each answer is a list.
A ``ReplicaSet`` member carries its ``replica`` index into every answer
and into the labels of its queue-depth and occupancy gauges. Requests,
batches (by model), errors, the dispatch wall time and the occupancy of
the last dispatch go to the metrics registry (``metrics``, the global one
by default); none of them reads a device value. Each dispatch records a
``serve_batch`` event in the flight recorder and beats the watchdog; a
dispatch that fails dumps the recorder (``serve-dispatch-error``) before
its requests get the error, as in the JAX package.

Tracing (``observability/tracing.py``): each request opens ``batch.queue``
on the submitting thread, under its ambient span, and carries it on the
request to the dispatcher, which finishes it at the group cut; the group's
``batch.dispatch`` span is a root of its own that *links* every member's
queue span (a batch has no one honest parent) and carries ``version``,
``rows``, ``bucket``, ``requests``, the dispatch time and
``compile_cache_hit`` (always None: the port has no compile cache, which is
what the JAX package stamps with its cache off).
"""
from __future__ import annotations

import threading
import time
from concurrent.futures import Future
from typing import List, Optional, Tuple

import numpy as np

from ..common import host_numpy
from ..observability import names as _n
from ..observability.flight_recorder import global_recorder
from ..observability.metrics import global_registry
from ..observability.tracing import start_span
from ..observability.watchdog import beat
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
    __slots__ = ("model", "xs", "n", "key", "future", "t_enqueue", "span")

    def __init__(self, model: str, xs: Tuple[np.ndarray, ...], key: Tuple,
                 t_enqueue: float):
        self.model = model
        self.xs = xs
        self.n = int(xs[0].shape[0])
        self.key = key
        self.future: Future = Future()
        self.t_enqueue = t_enqueue
        # started on the submitting thread, where the request's trace is
        # ambient; the dispatcher finishes it (contextvars do not follow)
        self.span = start_span("batch.queue", model=model, rows=self.n)


class MicroBatcher:
    """Coalesces concurrent predict requests into padded micro-batches.

    ``submit()`` is the producer side (HTTP handler threads); one daemon
    dispatcher thread drains the queue."""

    def __init__(self, registry: ModelRegistry, *, max_batch: int = 32,
                 max_latency_s: float = 0.002, max_queue: int = 256,
                 admission: Optional[AdmissionController] = None,
                 metrics=None, replica: Optional[int] = None):
        if max_batch < 1:
            raise ValueError("max_batch must be >= 1")
        self.registry = registry
        #: ReplicaSet member index, or None for a standalone batcher
        self.replica = replica
        self.max_batch = int(max_batch)
        self.max_latency_s = float(max_latency_s)
        self.admission = admission or AdmissionController(
            max_pending=max_queue, expected_latency_s=max_latency_s,
            metrics=metrics)
        m = metrics or global_registry()
        self._g_replica_queue = self._g_replica_occ = None
        if replica is not None:
            self._g_replica_queue = m.gauge(
                _n.SERVE_REPLICA_QUEUE_DEPTH,
                "admitted-but-unanswered requests per replica").labels(
                    replica=str(replica))
            self._g_replica_occ = m.gauge(
                _n.SERVE_REPLICA_OCCUPANCY,
                "rows/bucket of the replica's last dispatch").labels(
                    replica=str(replica))
        self._c_requests = m.counter(
            _n.SERVE_REQUESTS_TOTAL, "predict requests admitted")
        self._c_errors = m.counter(
            _n.SERVE_ERRORS_TOTAL, "predict requests failed in dispatch")
        self._c_batches = m.counter(
            _n.SERVE_BATCHES_TOTAL, "micro-batches dispatched")
        self._h_dispatch = m.histogram(
            _n.SERVE_BATCH_DISPATCH_SECONDS, "device time per micro-batch")
        self._g_occupancy = m.gauge(
            _n.SERVE_BATCH_OCCUPANCY,
            "real rows / padded bucket size of the last dispatch")
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
        self._c_requests.labels(model=model).inc()
        key = (model,) + tuple((a.shape[1:], str(a.dtype)) for a in xs)
        req = _Request(model, xs, key, time.perf_counter())
        with self._cond:
            if self._closed:
                self.admission.release()
                req.span.set_status("error").finish()
                raise RuntimeError("MicroBatcher is closed")
            self._queue.append(req)
            self._cond.notify()
        if self._g_replica_queue is not None:
            self._g_replica_queue.set(self.admission.pending)
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
        # close each member's queue span at the group cut; one dispatch
        # span on its own trace links them all
        links = []
        for r in group:
            r.span.set_attr(bucket=bucket)
            ref = r.span.ref()
            if ref is not None:
                links.append(ref)
            r.span.finish()
        dspan = start_span("batch.dispatch", links=tuple(links),
                           model=group[0].model, rows=rows, bucket=bucket,
                           requests=len(group))
        if self.replica is not None:
            dspan.set_attr(replica=self.replica)
        try:
            self._dispatch_inner(group, rows, bucket, dspan)
        finally:
            dspan.finish()

    def _dispatch_inner(self, group: List[_Request], rows: int, bucket: int,
                        dspan) -> None:
        try:
            # the version resolves here, at dispatch time
            mv = self.registry.active(group[0].model)
            dspan.set_attr(version=mv.version, compile_cache_hit=None)
            xs = []
            for j in range(len(group[0].xs)):
                x = np.concatenate([r.xs[j] for r in group], axis=0)
                if bucket > rows:
                    pad = np.zeros((bucket - rows,) + x.shape[1:], x.dtype)
                    x = np.concatenate([x, pad], axis=0)
                xs.append(x)
            t0 = time.perf_counter()
            raw = mv.predict_fn(*xs)
            multi_out = isinstance(raw, (list, tuple))
            # .cpu() is this dispatch's sync point: the response is host data
            outs = [host_numpy(o) for o in (raw if multi_out else [raw])]
            dt = time.perf_counter() - t0
        except Exception as e:  # each request of the group gets it
            self._c_errors.inc(len(group))
            with self._lock:
                self._errors += len(group)
            dspan.set_status("error").set_attr(error=repr(e))
            global_recorder().dump(
                reason="serve-dispatch-error",
                extra={"model": group[0].model, "rows": rows,
                       "bucket": bucket, "error": repr(e)})
            for r in group:
                r.future.set_exception(e)
            return
        finally:
            self.admission.release(len(group))
            if self._g_replica_queue is not None:
                self._g_replica_queue.set(self.admission.pending)
        occupancy = rows / bucket
        dspan.set_attr(dispatch_s=round(dt, 6), occupancy=round(occupancy, 4))
        self._c_batches.labels(model=mv.name).inc()
        self._h_dispatch.observe(dt)
        self._g_occupancy.set(occupancy)
        if self._g_replica_occ is not None:
            self._g_replica_occ.set(occupancy)
        with self._lock:
            self._dispatches += 1
            self._occupancy_sum += occupancy
            self._buckets_seen.add((group[0].key, bucket))
            n_dispatch = self._dispatches
        global_recorder().record(
            "serve_batch", model=mv.name, version=mv.version, rows=rows,
            bucket=bucket, requests=len(group), dispatch_s=dt,
            **({"replica": self.replica} if self.replica is not None else {}))
        beat(n_dispatch)
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
