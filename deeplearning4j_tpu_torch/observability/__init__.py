"""Telemetry for the port: the metrics plane (A9.1), request tracing and
SLOs (A9.2) and the diagnostics plane (A9.3).

Counterpart of ``deeplearning4j_tpu/observability``, for the parts ported so
far: the process-global :class:`MetricsRegistry` with its Prometheus text
exposition (the serving front end's ``GET /metrics``) and JSONL snapshots,
:mod:`names` (the metric names with the JAX package's strings), the flight
recorder (a ring of step and fault events, dumped as a bundle on an
unhandled exception, an alarm, a stall or a signal), the step watchdog,
the training-health monitor the fit loops run in their step, the span API,
the W3C ``traceparent`` trace store with its tail sampler, and the SLO
engine's burn-rate alerts.

    from deeplearning4j_tpu_torch.observability import (
        global_registry, global_recorder, HealthMonitor, install_watchdog,
        span, trace_span, global_trace_store, SLOEngine)
"""
from . import names
from .flight_recorder import (
    FlightRecorder, dump_on_unhandled, global_recorder,
    install_signal_handlers, uninstall_signal_handlers)
from .health import (
    HealthMonitor, NanAlertListener, TrainingDivergedError, health_terms,
    is_invalid_score)
from .metrics import (DEFAULT_BUCKETS, MetricsRegistry, global_registry,
                      render_prometheus, tree_nbytes)
from .slo import SLO, SLOEngine, default_serve_objectives
from .spans import span
from .tracing import (
    TRACEPARENT_HEADER, Span, SpanRef, TraceStore, current_span,
    format_traceparent, global_trace_store, parse_traceparent,
    set_global_trace_store, start_span, trace_span)
from .watchdog import (
    StepWatchdog, beat, global_watchdog, install_watchdog, uninstall_watchdog)

__all__ = ["MetricsRegistry", "global_registry", "DEFAULT_BUCKETS",
           "render_prometheus", "tree_nbytes", "names", "span",
           "TraceStore", "Span", "SpanRef", "trace_span", "start_span",
           "current_span", "parse_traceparent", "format_traceparent",
           "global_trace_store", "set_global_trace_store",
           "TRACEPARENT_HEADER", "SLO", "SLOEngine",
           "default_serve_objectives",
           "FlightRecorder", "global_recorder", "dump_on_unhandled",
           "install_signal_handlers", "uninstall_signal_handlers",
           "HealthMonitor", "NanAlertListener", "TrainingDivergedError",
           "is_invalid_score", "health_terms",
           "StepWatchdog", "install_watchdog", "uninstall_watchdog",
           "global_watchdog", "beat"]
