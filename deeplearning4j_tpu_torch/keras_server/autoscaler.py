"""Autoscaler: queue pressure and SLO burn in, fleet size out.

Counterpart of ``deeplearning4j_tpu/keras_server/autoscaler.py``. Each tick
reads two signals:

- **queue pressure**: the mean admitted-but-unanswered fraction across the
  replicas (pending / max_pending), which rises before latency does;
- **SLO burn**: the short-window burn rate of each objective from
  ``slo_engine.evaluate()``, duck-typed (anything with ``evaluate()``
  returning ``[{"alerting": bool, "windows": [{"burn_rate": x}, ...]}]``;
  the port's own SLO engine waits for ROADMAP.md A9).

It drives ``ReplicaSet.add_replica()``/``remove_replica()`` under
hysteresis: at most one scale event per ``cooldown_s``, one replica a step,
the fleet within ``[min_replicas, max_replicas]``, and scale-in only after
``headroom_ticks`` consecutive low-pressure ticks. Scale-out registers the
catalog on the new replica before the router sees it; scale-in drains
without loss. ``last_scale_out_latency_s`` is the decision-to-routable wall
time. ``clock`` is injectable, so the hysteresis is testable with a fake
clock. Scale events are kept in a bounded list in :meth:`status`, where the
JAX package records them in its flight recorder. The zombie sweep (replicas
whose membership lease lapsed) waits for ROADMAP.md A7.4.
"""
from __future__ import annotations

import threading
import time
from typing import Callable, List, Optional

#: scale events :meth:`Autoscaler.status` keeps, and shows
_EVENTS_KEPT, _EVENTS_SHOWN = 64, 16


class Autoscaler:
    """Drives a :class:`~.replica.ReplicaSet`'s size from queue pressure
    and SLO burn rates, with hysteresis."""

    def __init__(self, replica_set, *, slo_engine=None,
                 min_replicas: int = 1, max_replicas: int = 8,
                 cooldown_s: float = 30.0, interval_s: float = 2.0,
                 scale_out_burn: float = 1.0, scale_in_burn: float = 0.5,
                 queue_high: float = 0.5, queue_low: float = 0.1,
                 headroom_ticks: int = 3,
                 clock: Callable[[], float] = time.monotonic):
        if min_replicas < 1:
            raise ValueError("min_replicas must be >= 1")
        if max_replicas < min_replicas:
            raise ValueError("max_replicas must be >= min_replicas")
        self.replica_set = replica_set
        self.slo_engine = slo_engine
        self.min_replicas = int(min_replicas)
        self.max_replicas = int(max_replicas)
        self.cooldown_s = float(cooldown_s)
        self.interval_s = float(interval_s)
        self.scale_out_burn = float(scale_out_burn)
        self.scale_in_burn = float(scale_in_burn)
        self.queue_high = float(queue_high)
        self.queue_low = float(queue_low)
        self.headroom_ticks = int(headroom_ticks)
        self.clock = clock
        self._lock = threading.Lock()
        self._last_scale_at: Optional[float] = None
        self._low_ticks = 0
        self._ticks = 0
        self._last_decision = "none"
        self._last_reason = "startup"
        self._events: List[dict] = []
        #: ticks the background loop failed, and the last failure
        self.errors = 0
        self.last_error: Optional[str] = None
        self.last_scale_out_latency_s: Optional[float] = None
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # ------------------------------------------------------------- signals
    def _slo_signals(self) -> tuple:
        """(max short-window burn rate, any objective alerting)."""
        if self.slo_engine is None:
            return 0.0, False
        burn, alerting = 0.0, False
        for obj in self.slo_engine.evaluate():
            windows = obj.get("windows") or []
            if windows:
                burn = max(burn, float(windows[0].get("burn_rate", 0.0)))
            alerting = alerting or bool(obj.get("alerting"))
        return burn, alerting

    def _queue_fraction(self) -> float:
        """Mean pending / max_pending across replicas; 1.0 is saturated."""
        fracs = []
        for r in self.replica_set.replicas:
            cap = r.batcher.admission.max_pending
            fracs.append(r.queue_depth() / cap if cap else 0.0)
        return sum(fracs) / len(fracs) if fracs else 0.0

    # ---------------------------------------------------------------- tick
    def _in_cooldown(self, now: float) -> bool:
        return (self._last_scale_at is not None
                and now - self._last_scale_at < self.cooldown_s)

    def _record(self, direction: str, reason: str, now: float, size: int,
                latency_s: Optional[float] = None) -> None:
        ev = {"direction": direction, "reason": reason, "t": now,
              "size": size}
        if latency_s is not None:
            ev["scale_out_latency_s"] = latency_s
        with self._lock:
            self._last_decision = direction
            self._last_reason = reason
            self._events.append(ev)
            del self._events[:-_EVENTS_KEPT]

    def _scale_out(self, reason: str, now: float) -> None:
        t0 = self.clock()
        self.replica_set.add_replica(reason=reason)
        latency = self.clock() - t0
        self.last_scale_out_latency_s = latency
        self._last_scale_at = now
        self._low_ticks = 0
        self._record("out", reason, now, self.replica_set.n_replicas,
                     latency_s=latency)

    def _scale_in(self, reason: str, now: float) -> None:
        self.replica_set.remove_replica(reason=reason)
        self._last_scale_at = now
        self._low_ticks = 0
        self._record("in", reason, now, self.replica_set.n_replicas)

    def tick(self, now: Optional[float] = None) -> str:
        """One control decision: ``"out"``, ``"in"`` or ``"none"``. Safe to
        call from a test without :meth:`start`."""
        now = self.clock() if now is None else now
        self._ticks += 1
        rs = self.replica_set
        # bounds are correctness, not capacity: a fleet below its floor is
        # filled outside the hysteresis window
        while rs.n_replicas < self.min_replicas:
            self._scale_out("below-min", now)
        burn, alerting = self._slo_signals()
        qfrac = self._queue_fraction()
        if self._in_cooldown(now):
            return "none"
        if rs.n_replicas < self.max_replicas and (
                alerting or burn >= self.scale_out_burn
                or qfrac > self.queue_high):
            reason = "queue-depth" if qfrac > self.queue_high \
                and not (alerting or burn >= self.scale_out_burn) \
                else "slo-burn"
            self._scale_out(reason, now)
            return "out"
        if rs.n_replicas > self.min_replicas and burn < self.scale_in_burn \
                and qfrac < self.queue_low:
            self._low_ticks += 1
            if self._low_ticks >= self.headroom_ticks:
                self._scale_in("headroom", now)
                return "in"
        else:
            self._low_ticks = 0
        return "none"

    # -------------------------------------------------------------- control
    def start(self, interval_s: Optional[float] = None) -> None:
        if self._thread is not None:
            return
        if interval_s is not None:
            self.interval_s = float(interval_s)
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._loop, name="serve-autoscaler", daemon=True)
        self._thread.start()

    def _loop(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.tick()
            except Exception as e:
                # a failed decision must not take serving down
                self.errors += 1
                self.last_error = repr(e)

    def stop(self) -> None:
        self._stop.set()
        t = self._thread
        self._thread = None
        if t is not None:
            t.join(5.0)

    def status(self) -> dict:
        """The status "autoscaler" block."""
        now = self.clock()
        with self._lock:
            events = list(self._events[-_EVENTS_SHOWN:])
            decision, reason = self._last_decision, self._last_reason
        cooldown_left = 0.0
        if self._last_scale_at is not None:
            cooldown_left = max(
                0.0, self.cooldown_s - (now - self._last_scale_at))
        return {
            "running": self._thread is not None,
            "min_replicas": self.min_replicas,
            "max_replicas": self.max_replicas,
            "n_replicas": self.replica_set.n_replicas,
            "cooldown_s": self.cooldown_s,
            "cooldown_remaining_s": round(cooldown_left, 3),
            "interval_s": self.interval_s,
            "ticks": self._ticks,
            "last_decision": decision,
            "last_reason": reason,
            "last_scale_out_latency_s": self.last_scale_out_latency_s,
            "events": events,
            "errors": self.errors,
            "last_error": self.last_error,
        }
