"""Step watchdog: a background thread that notices when training stops.

Counterpart of ``deeplearning4j_tpu/observability/watchdog.py``. Fit loops
call :func:`beat` after every completed dispatch (a global read and a
return when no watchdog is installed); the watchdog's thread wakes every
``poll_s`` and, once the wall time since the last beat passes
``threshold_s``,

* logs every thread's Python stack at ERROR (the hang site is in the log
  even if the process is SIGKILLed later),
* dumps the flight recorder (reason ``watchdog-stall``), and
* increments ``dl4j_watchdog_stalls_total``

once a stall: the alarm re-arms at the next beat, so a run that recovers
and stalls again is reported again, and one wedged step gives one bundle.
Host only: a beat is two attribute stores, and the thread reads no tensor.
"""
from __future__ import annotations

import logging
import threading
import time
from typing import Optional

from .metrics import global_registry
from .names import WATCHDOG_STALLS_TOTAL

log = logging.getLogger(__name__)

#: default stall threshold: generous enough for a first step's kernel build
#: and graph capture; tune it down for short production steps
DEFAULT_THRESHOLD_S = 300.0


class StepWatchdog:
    """Watches the wall time since the last completed training step.

    It arms at the first :meth:`heartbeat`: an installed watchdog that sees
    no beat (before ``fit``, after it returns) never fires.
    ``start()``/``stop()`` run the daemon thread; the instance is also a
    context manager."""

    def __init__(self, threshold_s: float = DEFAULT_THRESHOLD_S, *,
                 poll_s: Optional[float] = None, recorder=None,
                 registry=None):
        self.threshold_s = float(threshold_s)
        self.poll_s = max(0.01, float(poll_s) if poll_s is not None
                          else min(self.threshold_s / 4.0, 5.0))
        self._recorder = recorder
        self._registry = registry
        self._last_beat: Optional[float] = None
        self._last_step = None
        self._fired = False
        self.stalls = 0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    @property
    def registry(self):
        return self._registry if self._registry is not None \
            else global_registry()

    def _recorder_or_global(self):
        if self._recorder is not None:
            return self._recorder
        from .flight_recorder import global_recorder

        return global_recorder()

    def heartbeat(self, step=None) -> None:
        """A training step just completed: two attribute stores, no lock
        (the watchdog's thread tolerates a torn read)."""
        self._last_beat = time.monotonic()
        self._last_step = step
        self._fired = False  # re-arm: training made progress

    def start(self) -> "StepWatchdog":
        if self._thread is not None and self._thread.is_alive():
            return self
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._run, name="dl4j-step-watchdog", daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=max(1.0, self.poll_s * 4))
        self._thread = None

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()
        return False

    def _run(self) -> None:
        while not self._stop.wait(self.poll_s):
            last = self._last_beat
            if last is None or self._fired:
                continue
            stalled = time.monotonic() - last
            if stalled >= self.threshold_s:
                self._fired = True
                self._on_stall(stalled)

    def _on_stall(self, stalled_s: float) -> None:
        self.stalls += 1
        self.registry.counter(
            WATCHDOG_STALLS_TOTAL,
            "training stalls detected by the step watchdog").inc()
        from .flight_recorder import thread_stacks

        log.error(
            "watchdog: no training step completed for %.1fs "
            "(threshold %.1fs, last step %s); all-thread stacks follow\n%s",
            stalled_s, self.threshold_s, self._last_step, thread_stacks())
        rec = self._recorder_or_global()
        rec.record("watchdog_stall", stalled_s=stalled_s,
                   threshold_s=self.threshold_s, step=self._last_step)
        try:
            rec.dump(reason="watchdog-stall")
        except Exception:  # the watchdog's thread must survive a bad dump
            log.exception("watchdog: flight recorder dump failed")


_GLOBAL: Optional[StepWatchdog] = None


def install_watchdog(threshold_s: float = DEFAULT_THRESHOLD_S,
                     **kwargs) -> StepWatchdog:
    """Create, start and register the process watchdog the fit loops beat;
    stops any earlier one."""
    global _GLOBAL
    if _GLOBAL is not None:
        _GLOBAL.stop()
    _GLOBAL = StepWatchdog(threshold_s, **kwargs).start()
    return _GLOBAL


def uninstall_watchdog() -> None:
    global _GLOBAL
    if _GLOBAL is not None:
        _GLOBAL.stop()
        _GLOBAL = None


def global_watchdog() -> Optional[StepWatchdog]:
    return _GLOBAL


def beat(step=None) -> None:
    """The fit loops' heartbeat: a global read and a return when no
    watchdog is installed."""
    wd = _GLOBAL
    if wd is not None:
        wd.heartbeat(step)
