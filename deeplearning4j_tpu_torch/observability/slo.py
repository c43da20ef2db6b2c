"""Declarative SLOs and multi-window burn-rate alerts over the serve metrics.

Counterpart of ``deeplearning4j_tpu/observability/slo.py``. The autoscaler
needs a decision signal, not raw histograms: "is the TTFT objective burning
its error budget fast enough to matter". Google-SRE shaped:

- An :class:`SLO` declares an objective over metrics that already exist: a
  latency objective ("99% of requests complete within ``threshold_s``")
  over a ``dl4j_serve_*`` histogram, or an availability objective ("99.9%
  of requests succeed") over a pair of counters.
- :class:`SLOEngine` snapshots the cumulative counts on a cadence and
  evaluates windowed deltas: the burn rate over a window W is
  ``bad_fraction(W) / (1 - target)`` (burn 1.0 spends exactly the budget
  over the SLO period; 14.4 empties a 30-day budget in 2 days). An alert
  needs every configured window to burn past its threshold (default
  5m at 14.4x and 1h at 6x).
- An alert is an action: the ``dl4j_slo_*`` gauges flip, an alert counter
  counts the transition, a flight-recorder bundle dumps (reason
  ``slo-burn-<name>``), and the evaluation carries an exemplar, the worst
  recent trace id the trace store saw for the objective's histogram, so a
  burning SLO links to an offending request tree under
  ``/serve/traces/<id>``.

The engine is pull-friendly (``evaluate()`` runs on ``GET /serve/slo``)
and push-capable (``start()`` runs a daemon ticker so alarms fire with no
scraper). The clock is injectable. It reads only the metrics registry's
``snapshot()`` (host numbers). Thresholds: ``DL4J_SLO_P99_MS``,
``DL4J_SLO_TTFT_MS``, ``DL4J_SLO_AVAILABILITY``. The JAX engine also
snapshots every fleet member's recorder on an alert; that waits for the
fleet federation (ROADMAP.md A9.4).
"""
from __future__ import annotations

import os
import threading
import time
from collections import deque
from typing import Dict, List, Optional, Tuple

from . import names as _n

#: (window_seconds, burn_rate_threshold) pairs; ALL must exceed to alert
DEFAULT_WINDOWS: Tuple[Tuple[float, float], ...] = ((300.0, 14.4),
                                                    (3600.0, 6.0))
#: min seconds between flight-recorder dumps for one objective
DEFAULT_COOLDOWN_S = 300.0


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, default))
    except (TypeError, ValueError):
        return default


class SLO:
    """One objective. ``kind="latency"``: ``target`` fraction of
    observations in histogram ``metric`` must be <= ``threshold_s``
    (target 0.99 == "p99 <= threshold"). ``kind="availability"``:
    ``target`` fraction of ``total_metric`` must not appear in
    ``bad_metric``."""

    def __init__(self, name: str, *, kind: str = "latency",
                 metric: Optional[str] = None,
                 threshold_s: Optional[float] = None,
                 target: float = 0.99,
                 total_metric: Optional[str] = None,
                 bad_metric: Optional[str] = None,
                 description: str = ""):
        if kind not in ("latency", "availability"):
            raise ValueError(f"unknown SLO kind {kind!r}")
        if kind == "latency" and (metric is None or threshold_s is None):
            raise ValueError("latency SLOs need metric= and threshold_s=")
        if kind == "availability" and (total_metric is None
                                       or bad_metric is None):
            raise ValueError(
                "availability SLOs need total_metric= and bad_metric=")
        if not 0.0 < target < 1.0:
            raise ValueError("target must be in (0, 1)")
        self.name = name
        self.kind = kind
        self.metric = metric
        self.threshold_s = threshold_s
        self.target = target
        self.total_metric = total_metric
        self.bad_metric = bad_metric
        self.description = description

    @property
    def budget(self) -> float:
        """The error budget: the tolerable bad fraction (1 - target)."""
        return 1.0 - self.target

    # -- cumulative (total, bad) from one registry snapshot -------------
    def counts(self, snapshot: dict) -> Tuple[float, float]:
        if self.kind == "latency":
            fam = snapshot.get(self.metric)
            if not fam:
                return 0.0, 0.0
            total = good = 0.0
            for row in fam.get("series", ()):
                buckets = row.get("buckets") or []
                bc = row.get("bucket_counts") or []
                count = float(row.get("count", 0))
                total += count
                idx = None
                for i, le in enumerate(buckets):
                    if le >= self.threshold_s:
                        idx = i
                        break
                if idx is None:
                    # threshold beyond the last finite bucket: only the
                    # +Inf overflow counts as bad
                    good += count - float(bc[-1] if bc else 0)
                else:
                    good += float(sum(bc[:idx + 1]))
            return total, total - good
        fam = snapshot.get(self.total_metric) or {}
        total = sum(float(r.get("value", 0.0))
                    for r in fam.get("series", ()))
        fam = snapshot.get(self.bad_metric) or {}
        bad = sum(float(r.get("value", 0.0))
                  for r in fam.get("series", ()))
        return total, bad

    def describe(self) -> dict:
        d = {"name": self.name, "kind": self.kind, "target": self.target,
             "description": self.description}
        if self.kind == "latency":
            d.update(metric=self.metric, threshold_s=self.threshold_s)
        else:
            d.update(total_metric=self.total_metric,
                     bad_metric=self.bad_metric)
        return d


def default_serve_objectives() -> List[SLO]:
    """The stock serving objectives (env-tunable thresholds): request p99,
    TTFT p99, availability."""
    p99_s = _env_float("DL4J_SLO_P99_MS", 250.0) / 1e3
    ttft_s = _env_float("DL4J_SLO_TTFT_MS", 500.0) / 1e3
    avail = _env_float("DL4J_SLO_AVAILABILITY", 0.999)
    return [
        SLO("request_p99", kind="latency", metric=_n.SERVE_REQUEST_SECONDS,
            threshold_s=p99_s, target=0.99,
            description=f"99% of HTTP requests within {p99_s * 1e3:g}ms"),
        SLO("ttft_p99", kind="latency", metric=_n.SERVE_TTFT_SECONDS,
            threshold_s=ttft_s, target=0.99,
            description=f"99% of first tokens within {ttft_s * 1e3:g}ms"),
        SLO("availability", kind="availability",
            total_metric=_n.SERVE_REQUESTS_TOTAL,
            bad_metric=_n.SERVE_ERRORS_TOTAL, target=avail,
            description=f"{avail:.3%} of requests succeed"),
    ]


class SLOEngine:
    """Evaluates objectives over windowed deltas of cumulative metrics.

    ``tick()`` appends one (t, counts) snapshot; ``evaluate()`` computes
    per-window burn rates against the snapshot nearest each window's left
    edge, exports the ``dl4j_slo_*`` gauges, and on an alert transition
    (cooldown-limited) dumps a flight-recorder bundle carrying the
    evaluation + exemplar. Never raises into the caller."""

    def __init__(self, objectives: Optional[List[SLO]] = None, *,
                 registry=None, store=None, recorder=None,
                 windows: Tuple[Tuple[float, float], ...] = DEFAULT_WINDOWS,
                 cooldown_s: float = DEFAULT_COOLDOWN_S,
                 clock=time.monotonic):
        if registry is None:
            from .metrics import global_registry
            registry = global_registry()
        self.registry = registry
        self.objectives = list(objectives if objectives is not None
                               else default_serve_objectives())
        self._store = store
        self._recorder = recorder
        self.windows = tuple(windows)
        self.cooldown_s = cooldown_s
        self._clock = clock
        self._lock = threading.Lock()
        #: (t, {slo_name: (total, bad)}) — bounded history
        self._snaps: deque = deque(maxlen=2048)
        self._alerting: Dict[str, bool] = {}
        self._last_dump: Dict[str, float] = {}
        self._g_burn = registry.gauge(
            _n.SLO_BURN_RATE, "error-budget burn rate per SLO and window")
        self._g_budget = registry.gauge(
            _n.SLO_BUDGET_REMAINING,
            "fraction of the error budget left over the longest window")
        self._g_alerting = registry.gauge(
            _n.SLO_ALERTING, "1 while an SLO's multi-window alert is firing")
        self._c_alerts = registry.counter(
            _n.SLO_ALERTS_TOTAL, "SLO alert transitions (not-firing->firing)")
        self._ticker: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self.tick()  # baseline so the first window has a left edge

    def _store_or_none(self):
        if self._store is not None:
            return self._store
        try:
            from .tracing import global_trace_store
            return global_trace_store()
        except Exception:
            return None

    def _recorder_or_none(self):
        if self._recorder is not None:
            return self._recorder
        from .flight_recorder import global_recorder
        return global_recorder()

    # -- sampling -------------------------------------------------------
    def tick(self, now: Optional[float] = None) -> None:
        now = self._clock() if now is None else now
        snap = self.registry.snapshot()
        counts = {slo.name: slo.counts(snap) for slo in self.objectives}
        with self._lock:
            self._snaps.append((now, counts))

    def _window_delta(self, name: str, now: float,
                      window_s: float) -> Tuple[float, float]:
        """(total, bad) accrued over the last ``window_s`` — delta between
        the newest snapshot and the one nearest the window's left edge
        (the oldest snapshot when history is shorter than the window)."""
        with self._lock:
            snaps = list(self._snaps)
        if not snaps:
            return 0.0, 0.0
        t_now, cur = snaps[-1]
        left = now - window_s
        base = snaps[0]
        for t, counts in snaps:
            if t <= left:
                base = (t, counts)
            else:
                break
        ct, cb = cur.get(name, (0.0, 0.0))
        bt, bb = base[1].get(name, (0.0, 0.0))
        return max(0.0, ct - bt), max(0.0, cb - bb)

    # -- evaluation -----------------------------------------------------
    def evaluate(self, now: Optional[float] = None) -> List[dict]:
        """Tick, compute burn rates, export gauges, fire alert actions.
        Returns the ``/serve/slo`` payload."""
        now = self._clock() if now is None else now
        self.tick(now)
        out = []
        for slo in self.objectives:
            rows = []
            firing = True
            for window_s, burn_threshold in self.windows:
                total, bad = self._window_delta(slo.name, now, window_s)
                frac = (bad / total) if total > 0 else 0.0
                burn = frac / slo.budget
                self._g_burn.labels(
                    slo=slo.name, window=f"{int(window_s)}s").set(burn)
                rows.append({"window_s": window_s, "total": total,
                             "bad": bad, "bad_fraction": round(frac, 6),
                             "burn_rate": round(burn, 3),
                             "threshold": burn_threshold})
                if total <= 0 or burn < burn_threshold:
                    firing = False
            long_row = rows[-1] if rows else None
            budget_left = 1.0
            if long_row and long_row["total"] > 0:
                budget_left = max(
                    0.0, 1.0 - long_row["bad_fraction"] / slo.budget)
            self._g_budget.labels(slo=slo.name).set(budget_left)
            self._g_alerting.labels(slo=slo.name).set(1.0 if firing else 0.0)
            exemplar = None
            if slo.kind == "latency":
                store = self._store_or_none()
                if store is not None:
                    exemplar = store.exemplar(slo.metric)
            entry = dict(slo.describe(), windows=rows, alerting=firing,
                         budget_remaining=round(budget_left, 6),
                         exemplar=exemplar)
            was = self._alerting.get(slo.name, False)
            self._alerting[slo.name] = firing
            if firing and not was:
                self._c_alerts.labels(slo=slo.name).inc()
                self._dump_alert(slo, entry, now)
            out.append(entry)
        return out

    def _dump_alert(self, slo: SLO, entry: dict, now: float) -> None:
        last = self._last_dump.get(slo.name)
        if last is not None and now - last < self.cooldown_s:
            return
        self._last_dump[slo.name] = now
        try:
            self._recorder_or_none().dump(
                reason=f"slo-burn-{slo.name}", extra={"slo": entry})
        except Exception:  # an alarm dump must never take down serving
            pass

    # -- background ticker ---------------------------------------------
    def start(self, interval_s: float = 5.0) -> "SLOEngine":
        if self._ticker is not None:
            return self
        self._stop.clear()

        def run():
            while not self._stop.wait(interval_s):
                try:
                    self.evaluate()
                except Exception:  # the ticker outlives a transient error
                    pass

        self._ticker = threading.Thread(target=run, daemon=True,
                                        name="dl4j-slo-ticker")
        self._ticker.start()
        return self

    def stop(self) -> None:
        if self._ticker is None:
            return
        self._stop.set()
        self._ticker.join(timeout=2.0)
        self._ticker = None
