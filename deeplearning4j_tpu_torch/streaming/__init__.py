"""Streaming routes: online training and model serving over queues.

Counterpart of ``deeplearning4j_tpu/streaming/__init__.py`` (the
dl4j-streaming Camel+Kafka routes): a :class:`Route` consumes messages on
a background thread and hands them to a handler. ``source`` is anything
with the queue seam (``get(timeout)``, ``task_done``, ``unfinished_tasks``,
``all_tasks_done``): a ``queue.Queue``, or the broker's
``ReconnectingConsumer`` (``streaming/broker.py``). A handler that raises
does not stop the route: the error is kept in ``errors``, counted in
``dl4j_route_errors_total`` by route class and recorded as a
``route_error`` event in the flight recorder, as in the JAX package;
:meth:`Route.stats` keeps the route's own counts.
"""
from __future__ import annotations

import queue
import threading
import time
from typing import Any, Callable, List, Optional

import numpy as np

from ..common import host_numpy
from ..observability.flight_recorder import global_recorder
from ..observability.metrics import global_registry
from ..observability.names import ROUTE_ERRORS_TOTAL

_route_errors = global_registry().counter(
    ROUTE_ERRORS_TOTAL, "handler exceptions swallowed by streaming routes, "
                        "by route class")


class Route:
    """A consume loop on a background thread."""

    def __init__(self, source: "queue.Queue", handler: Callable[[Any], None]):
        self.source = source
        self.handler = handler
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.processed = 0
        self.errors: List[str] = []
        self._err_series = _route_errors.labels(route=type(self).__name__)

    def start(self) -> "Route":
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()
        return self

    def _run(self) -> None:
        while not self._stop.is_set():
            try:
                msg = self.source.get(timeout=0.05)
            except queue.Empty:
                continue
            try:
                self.handler(msg)
                self.processed += 1
            except Exception as e:  # the route keeps consuming, and says so
                self.errors.append(f"{type(e).__name__}: {e}")
                self._err_series.inc()
                global_recorder().record(
                    "route_error", route=type(self).__name__,
                    error=f"{type(e).__name__}: {e}")
            finally:
                self.source.task_done()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=30)

    def drain(self, timeout: float = 30.0) -> None:
        """Block until every queued message has been handled, not only
        taken (the queue's task count: a handler mid-fit is pending)."""
        deadline = time.time() + timeout
        with self.source.all_tasks_done:
            while self.source.unfinished_tasks and time.time() < deadline:
                self.source.all_tasks_done.wait(0.05)

    def stats(self) -> dict:
        return {"route": type(self).__name__, "processed": self.processed,
                "errors": len(self.errors)}


class TrainingRoute(Route):
    """Online training: ``(features, labels)`` messages -> ``model.fit``."""

    def __init__(self, model, capacity: int = 64):
        self.model = model
        super().__init__(queue.Queue(maxsize=capacity), self._train)

    def _train(self, msg) -> None:
        x, y = msg
        self.model.fit(np.asarray(x, np.float32), np.asarray(y, np.float32))

    def send(self, features, labels, timeout: float = 10.0) -> None:
        self.source.put((features, labels), timeout=timeout)


class ServingRoute(Route):
    """Model serving: feature messages -> ``(request_id, predictions)`` on
    the output queue (host numpy)."""

    def __init__(self, model, capacity: int = 64):
        self.model = model
        self.output: "queue.Queue" = queue.Queue()
        super().__init__(queue.Queue(maxsize=capacity), self._serve)

    def _serve(self, msg) -> None:
        request_id, features = msg
        out = self.model.output(np.asarray(features, np.float32))
        self.output.put((request_id, host_numpy(out)))

    def send(self, request_id, features, timeout: float = 10.0) -> None:
        self.source.put((request_id, features), timeout=timeout)

    def receive(self, timeout: float = 10.0):
        return self.output.get(timeout=timeout)
