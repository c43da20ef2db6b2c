"""Span API: one ``with span("epoch/3/fwd")`` feeds every viewer.

Counterpart of ``deeplearning4j_tpu/observability/spans.py``. A span does
four things at once: ``torch.profiler.record_function`` names the phase in
a profiler trace (the JAX package's ``jax.profiler.TraceAnnotation``), the
registry histogram ``dl4j_span_seconds{name=...}`` keeps an always-on
latency distribution a ``/metrics`` scraper can watch with no profiler
running, ``span_enter``/``span_exit`` events go into the flight recorder's
ring (a crash bundle names the phase the run died in), and under an
ambient trace (``tracing.py``) it opens a real trace span, so a phase
called inside a traced request shows in its ``/serve/traces/<id>`` tree.
Outside any trace that last part is the no-op singleton.

Span names are hierarchical by convention (``"epoch/3/stage"``); the
registry series is labeled with the name verbatim, so pass
``metric_name`` to collapse per-index names into a bounded series.

Nothing here reads a device value or allocates device memory:
``record_function`` is a host-side profiler range, so a span may sit
inside a CUDA graph capture (the K-step path captures its step).
"""
from __future__ import annotations

import contextlib
import time
from typing import Optional

import torch

from .flight_recorder import global_recorder
from .metrics import global_registry
from .names import SPAN_SECONDS
from .tracing import NOOP_SPAN, current_span, trace_span


@contextlib.contextmanager
def span(name: str, metric_name: Optional[str] = None, registry=None,
         recorder=None):
    """Name a phase in profiler traces, record its wall time in
    ``dl4j_span_seconds{name=...}``, leave ``span_enter``/``span_exit``
    events in the flight recorder's ring, and open a trace span under the
    ambient trace context.

    ``metric_name`` overrides the histogram label (and the trace span's
    name), to collapse per-index names like ``epoch/3`` into ``epoch``.
    """
    reg = registry if registry is not None else global_registry()
    # an explicit None check: an empty recorder is falsy (__len__ == 0)
    rec = recorder if recorder is not None else global_recorder()
    series = reg.histogram(
        SPAN_SECONDS, "wall seconds of user/framework span() phases").labels(
            name=metric_name or name)
    rec.record("span_enter", name=name)
    # a real trace span only under an ambient trace: a bare training phase
    # must not mint root traces into the ring
    tspan = trace_span(metric_name or name) if current_span() is not None \
        else NOOP_SPAN
    t0 = time.perf_counter()
    with torch.profiler.record_function(name), tspan:
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            series.observe(dt)
            rec.record("span_exit", name=name, dur_s=dt)
