"""Process-global metrics registry: counters, gauges, fixed-bucket histograms.

Counterpart of ``deeplearning4j_tpu/observability/metrics.py``: the same
families, exposition and snapshot format, so a ``/metrics`` scrape of the
port reads as one of the JAX package. The serving path (admission, the
micro-batcher, decode, streams, the registry, the replicas and the HTTP
front end) writes its series here, and ``GET /metrics`` renders them.

Design constraints:

* **Host only.** A series holds Python floats and is set from host
  counters (the pool's page count, the batcher's rows); no instrument point
  reads a CUDA tensor, so recording never synchronizes the device.
* **Hot-path cost.** Every ``inc``/``observe``/``set`` is one lock acquire
  plus float arithmetic; label resolution (the dict work) happens once at
  ``labels()`` time, so call sites hold a pre-resolved series handle.
* **Lock-safe.** Request threads, dispatcher threads and the decode pump
  all touch the registry; one registry-wide ``threading.Lock`` guards
  series creation and every mutation, which keeps snapshot and exposition
  consistent.
* **Kill switch.** ``set_enabled(False)`` turns every mutation into a no-op
  for overhead A/Bs; exposition still works on whatever was recorded.
"""
from __future__ import annotations

import json
import logging
import math
import os
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from . import names as _names

log = logging.getLogger(__name__)

#: default histogram buckets (seconds): 100us .. ~100s, log-ish spacing —
#: covers everything from a request's dispatch to a model's warmup
DEFAULT_BUCKETS = (1e-4, 5e-4, 1e-3, 5e-3, 1e-2, 5e-2, 0.1, 0.5, 1.0, 5.0,
                   10.0, 60.0, 120.0)

_VALID_TYPES = ("counter", "gauge", "histogram")

#: max distinct labelsets one family will register; past it, labels() hands
#: back a detached overflow series (mutations work, exposition skips it) so
#: an unbounded label — a trace id, a session id — can never OOM the registry
LABELSET_CAP_ENV = "DL4J_METRICS_MAX_LABELSETS"
DEFAULT_MAX_LABELSETS = 256


def _labelset_cap() -> int:
    try:
        return int(os.environ.get(LABELSET_CAP_ENV, DEFAULT_MAX_LABELSETS))
    except (TypeError, ValueError):
        return DEFAULT_MAX_LABELSETS


class _Series:
    """One (metric, labelset) time series. Mutations take the registry lock."""

    __slots__ = ("family", "labels", "value", "bucket_counts", "sum", "count")

    def __init__(self, family: "_Family", labels: Tuple[Tuple[str, str], ...]):
        self.family = family
        self.labels = labels
        self.value = 0.0                      # counter / gauge
        if family.type == "histogram":
            self.bucket_counts = [0] * (len(family.buckets) + 1)  # +inf last
            self.sum = 0.0
            self.count = 0

    # -- mutation (call-site API; handles are cached by callers) ------------
    def inc(self, amount: float = 1.0) -> None:
        reg = self.family.registry
        if not reg._enabled:
            return
        if amount < 0:
            raise ValueError("counters only go up; use a gauge")
        with reg._lock:
            self.value += amount

    def set(self, value: float) -> None:
        reg = self.family.registry
        if not reg._enabled:
            return
        with reg._lock:
            self.value = float(value)

    def observe(self, value: float) -> None:
        reg = self.family.registry
        if not reg._enabled:
            return
        fam = self.family
        with reg._lock:
            self.sum += value
            self.count += 1
            i = 0
            n = len(fam.buckets)
            while i < n and value > fam.buckets[i]:
                i += 1
            self.bucket_counts[i] += 1

    def time(self):
        """``with series.time():`` — observe the block's wall seconds."""
        return _Timer(self)


class _Timer:
    __slots__ = ("series", "_t0")

    def __init__(self, series: _Series):
        self.series = series

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.series.observe(time.perf_counter() - self._t0)
        return False


class _Family:
    """A named metric with a help string; holds one series per labelset."""

    def __init__(self, registry: "MetricsRegistry", name: str, help: str,
                 type: str, buckets: Sequence[float] = DEFAULT_BUCKETS):
        self.registry = registry
        self.name = name
        self.help = help
        self.type = type
        self.buckets = tuple(buckets) if type == "histogram" else ()
        self._series: Dict[Tuple[Tuple[str, str], ...], _Series] = {}
        self._overflow: Optional[_Series] = None

    def labels(self, **labels: str) -> _Series:
        """Resolve (and memoize) the series for this labelset. Do this ONCE
        per call site, not per step — the returned handle is the hot path.

        Cardinality guard: once a family holds ``DL4J_METRICS_MAX_LABELSETS``
        distinct labelsets (default 256), unseen labelsets resolve to one
        shared detached series — writable but never exported — and each such
        call counts into ``dl4j_metrics_dropped_labelsets_total``."""
        key = tuple(sorted((k, str(v)) for k, v in labels.items()))
        reg = self.registry
        dropped = False
        with reg._lock:
            s = self._series.get(key)
            if s is None:
                if (len(self._series) >= reg._max_labelsets
                        and self.name !=
                        _names.METRICS_DROPPED_LABELSETS_TOTAL):
                    if self._overflow is None:
                        self._overflow = _Series(
                            self, (("overflow", "true"),))
                    s = self._overflow
                    dropped = True
                else:
                    s = self._series[key] = _Series(self, key)
        if dropped:
            reg._note_dropped_labelset(self.name)
        return s

    # label-less convenience: family acts as its own default series
    def inc(self, amount: float = 1.0) -> None:
        self.labels().inc(amount)

    def set(self, value: float) -> None:
        self.labels().set(value)

    def observe(self, value: float) -> None:
        self.labels().observe(value)

    def time(self):
        return self.labels().time()


class MetricsRegistry:
    """Prometheus-style registry: get-or-create families, text exposition,
    JSONL snapshots. One process-global instance (``global_registry()``)
    backs the framework instrumentation; tests construct private ones."""

    def __init__(self):
        self._lock = threading.Lock()
        self._families: Dict[str, _Family] = {}
        self._enabled = True
        self._max_labelsets = _labelset_cap()
        self._warned_families: Dict[str, float] = {}  #: guarded-by: _lock

    def _note_dropped_labelset(self, family: str) -> None:
        """Called (outside the lock) when a family refused a new labelset:
        count it, and warn at most once a minute per family."""
        self.counter(
            _names.METRICS_DROPPED_LABELSETS_TOTAL,
            "labels() calls refused a new series by the cardinality cap"
        ).labels(family=family).inc()
        now = time.time()
        # check-then-set on the rate-limit map must be atomic: two request
        # threads hitting the cap together both read a stale `last` and
        # both warn. The counter above already released self._lock, so
        # taking it here cannot deadlock.
        with self._lock:
            last = self._warned_families.get(family)
            warn = last is None or now - last >= 60.0
            if warn:
                self._warned_families[family] = now
        if warn:
            log.warning(
                "metric family %s hit the labelset cap (%d); further "
                "labelsets collapse into an unexported overflow series "
                "(raise %s to widen)", family, self._max_labelsets,
                LABELSET_CAP_ENV)

    # ------------------------------------------------------------- creation
    def _family(self, name: str, help: str, type: str,
                buckets: Sequence[float] = DEFAULT_BUCKETS) -> _Family:
        if type not in _VALID_TYPES:
            raise ValueError(f"unknown metric type {type!r}")
        with self._lock:
            fam = self._families.get(name)
            if fam is None:
                fam = self._families[name] = _Family(self, name, help, type,
                                                     buckets)
            elif fam.type != type:
                raise ValueError(
                    f"metric {name!r} already registered as {fam.type}, "
                    f"not {type}")
            return fam

    def counter(self, name: str, help: str = "") -> _Family:
        return self._family(name, help, "counter")

    def gauge(self, name: str, help: str = "") -> _Family:
        return self._family(name, help, "gauge")

    def histogram(self, name: str, help: str = "",
                  buckets: Sequence[float] = DEFAULT_BUCKETS) -> _Family:
        return self._family(name, help, "histogram", buckets)

    # -------------------------------------------------------------- control
    def set_enabled(self, flag: bool) -> None:
        """Kill switch: False turns every inc/set/observe into a no-op
        (the overhead-A/B lever; exposition of recorded data still works)."""
        self._enabled = bool(flag)

    @property
    def enabled(self) -> bool:
        return self._enabled

    def clear(self) -> None:
        """Drop all recorded series (keeps family definitions). Test hook."""
        with self._lock:
            for fam in self._families.values():
                fam._series.clear()
                fam._overflow = None

    # ----------------------------------------------------------- exposition
    @staticmethod
    def _fmt_labels(labels: Tuple[Tuple[str, str], ...],
                    extra: Optional[Tuple[Tuple[str, str], ...]] = None) -> str:
        pairs = list(labels) + list(extra or ())
        if not pairs:
            return ""
        def esc(v: str) -> str:
            return v.replace("\\", "\\\\").replace('"', '\\"').replace(
                "\n", "\\n")
        return "{" + ",".join(f'{k}="{esc(v)}"' for k, v in pairs) + "}"

    @staticmethod
    def _fmt_value(v: float) -> str:
        if math.isinf(v):
            return "+Inf" if v > 0 else "-Inf"
        return repr(float(v))

    def prometheus_text(self) -> str:
        """Prometheus text exposition format (the ``/metrics`` payload):
        ``# HELP`` / ``# TYPE`` headers, histogram ``_bucket``/``_sum``/
        ``_count`` expansion with cumulative ``le`` labels.

        Rendering goes through :func:`render_prometheus` over ``snapshot()``,
        which also renders a snapshot that crossed the wire as JSON."""
        return render_prometheus(self.snapshot())

    def snapshot(self) -> dict:
        """JSON-ready dump of every series (the body of a
        :meth:`write_jsonl` record)."""
        out: Dict[str, dict] = {}
        with self._lock:
            for name, fam in sorted(self._families.items()):
                series = []
                for key in sorted(fam._series):
                    s = fam._series[key]
                    row: dict = {"labels": dict(key)}
                    if fam.type == "histogram":
                        row.update(sum=s.sum, count=s.count,
                                   buckets=list(fam.buckets),
                                   bucket_counts=list(s.bucket_counts))
                    else:
                        row["value"] = s.value
                    series.append(row)
                if series:
                    out[name] = {"type": fam.type, "help": fam.help,
                                 "series": series}
        return out

    def write_jsonl(self, path: str, **meta) -> None:
        """Append ONE JSON line (`{"ts": ..., "metrics": {...}, **meta}`) to
        ``path``, the snapshot export format. Appending (not truncating)
        keeps one file per run valid across retries."""
        rec = {"ts": time.time(), **meta, "metrics": self.snapshot()}
        with open(path, "a") as f:
            f.write(json.dumps(rec) + "\n")


def render_prometheus(snapshot: dict,
                      extra_labels: Optional[Dict[str, str]] = None) -> str:
    """Render a ``MetricsRegistry.snapshot()``-shaped dict as Prometheus
    text exposition. ``extra_labels`` (e.g. ``{"worker": ..., "role": ...}``)
    are appended to every series, to tell the members of a fleet apart.
    Works on any snapshot dict, local or one that
    crossed the wire as JSON."""
    extra = tuple(sorted((k, str(v)) for k, v in (extra_labels or {}).items()))
    fmt_labels = MetricsRegistry._fmt_labels
    fmt_value = MetricsRegistry._fmt_value
    lines: List[str] = []
    for name in sorted(snapshot):
        fam = snapshot[name]
        series = fam.get("series") or []
        if not series:
            continue
        if fam.get("help"):
            lines.append(f"# HELP {name} {fam['help']}")
        lines.append(f"# TYPE {name} {fam['type']}")
        for row in sorted(series,
                          key=lambda r: sorted(r["labels"].items())):
            key = tuple(sorted(
                (k, str(v)) for k, v in row["labels"].items())) + extra
            if fam["type"] == "histogram":
                cum = 0
                counts = row["bucket_counts"]
                for i, le in enumerate(row["buckets"]):
                    cum += counts[i]
                    lbl = fmt_labels(key, (("le", f"{le:g}"),))
                    lines.append(f"{name}_bucket{lbl} {cum}")
                cum += counts[-1]
                lbl = fmt_labels(key, (("le", "+Inf"),))
                lines.append(f"{name}_bucket{lbl} {cum}")
                lbl = fmt_labels(key)
                lines.append(f"{name}_sum{lbl} {fmt_value(row['sum'])}")
                lines.append(f"{name}_count{lbl} {row['count']}")
            else:
                lbl = fmt_labels(key)
                lines.append(f"{name}{lbl} {fmt_value(row['value'])}")
    return "\n".join(lines) + ("\n" if lines else "")


class LabeledSeries:
    """A family's series by label values, each resolved once (the call
    site's handle) and kept, so a module's ``stats()`` reads back what its
    series recorded: ``counts = LabeledSeries(reg.counter(...), "op",
    "site")``, ``counts("all_reduce", "grad").inc(n)``, ``counts.read()``."""

    def __init__(self, family: _Family, *label_names: str):
        self.family = family
        self.names = label_names
        self._by: Dict[tuple, _Series] = {}

    def __call__(self, *values) -> _Series:
        s = self._by.get(values)
        if s is None:
            s = self._by.setdefault(values, self.family.labels(
                **dict(zip(self.names, values))))
        return s

    def read(self) -> dict:
        """``{label values: value}`` (a single label's value as the key),
        integral values as ints."""
        out = {}
        for key, s in list(self._by.items()):
            v = s.value
            out[key[0] if len(key) == 1 else key] = \
                int(v) if float(v).is_integer() else v
        return out


_GLOBAL = MetricsRegistry()


def global_registry() -> MetricsRegistry:
    """THE process-global registry every framework instrument writes to."""
    return _GLOBAL


def tree_nbytes(tree) -> int:
    """Total bytes of the array leaves of a tree of dicts, lists and tuples
    (a state dict, a params list): tensors (``meta`` ones too), numpy
    arrays and any object with a ``shape`` and a ``dtype``. Only shapes and
    dtypes are read, never the data, so a CUDA leaf costs no sync."""
    total = 0
    stack = [tree]
    while stack:
        leaf = stack.pop()
        if isinstance(leaf, dict):
            stack.extend(leaf.values())
            continue
        if isinstance(leaf, (list, tuple)):
            stack.extend(leaf)
            continue
        if isinstance(leaf, torch.Tensor):
            total += leaf.numel() * leaf.element_size()
            continue
        shape = getattr(leaf, "shape", None)
        dtype = getattr(leaf, "dtype", None)
        if shape is None or dtype is None:
            continue
        size = dtype.itemsize if isinstance(dtype, torch.dtype) \
            else np.dtype(dtype).itemsize
        total += int(np.prod(shape, dtype=np.int64)) * size
    return total
