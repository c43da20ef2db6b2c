"""Telemetry for the port: the metrics registry and its names (A9.1).

Counterpart of ``deeplearning4j_tpu/observability``, for the parts ported so
far: the process-global :class:`MetricsRegistry` with its Prometheus text
exposition (the serving front end's ``GET /metrics``) and JSONL snapshots,
and :mod:`names`, the metric names with the JAX package's strings.

    from deeplearning4j_tpu_torch.observability import global_registry
"""
from . import names
from .metrics import (DEFAULT_BUCKETS, MetricsRegistry, global_registry,
                      render_prometheus, tree_nbytes)

__all__ = ["MetricsRegistry", "global_registry", "DEFAULT_BUCKETS",
           "render_prometheus", "tree_nbytes", "names"]
