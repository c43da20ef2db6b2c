"""Training-health monitor: NaN and divergence detection inside the step.

Counterpart of ``deeplearning4j_tpu/observability/health.py``. When a
monitor is attached and its cadence is due, the fit loops run the health
variant of the train step, which also computes a small summary on the
device (global gradient norm, global parameter-update norm, count of
non-finite gradient elements, loss). Off-cadence steps run the plain step,
bitwise those of unmonitored training, and the only host read is the
summary's, when it is polled.

Flow of a cadence-due step::

    _train_call(..., health=True) -> (..., packed)   # on the device
    monitor.offer(packed, it)   # copy to pinned host memory + event, no wait
    listener polls an iteration later -> waits on that event only
        -> gauges, the loss-EMA divergence rule, alarm -> recorder dump

The port's updater subtracts each step from its parameter in place, so the
health variant first copies the parameters into a buffer it owns
(:class:`ParamSnapshot`, float32 like the parameters under every policy)
and takes the update as new minus old, as the JAX step does from its two
arrays. The plain step copies nothing.

:func:`is_invalid_score` is the one definition of "invalid" that the alarm
path and early stopping's ``InvalidScoreIterationTerminationCondition``
share.
"""
from __future__ import annotations

import logging
import math
import threading
from typing import Any, Dict, Optional

import numpy as np
import torch

from .metrics import global_registry
from .names import (HEALTH_ALARMS_TOTAL, HEALTH_CHECKS_TOTAL,
                    HEALTH_GRAD_NORM, HEALTH_LOSS_EMA,
                    HEALTH_NONFINITE_GRADS, HEALTH_UPDATE_NORM)

log = logging.getLogger(__name__)

#: the default cadence in training steps: rare enough that the extra
#: reductions are noise, often enough that a NaN shows within seconds
DEFAULT_CADENCE = 50

#: the packed vector's layout (:func:`health_terms`, ``_resolve``)
_PACK_FIELDS = ("grad_norm", "update_norm", "nonfinite_grads", "loss")


class TrainingDivergedError(RuntimeError):
    """Raised by ``NanAlertListener(raise_on_alarm=True)`` when the monitor
    reports a non-finite or diverged training step."""


def is_invalid_score(score: Any) -> bool:
    """The shared predicate for "this score means training is broken":
    None, NaN, +/-inf, or not a number at all."""
    if score is None:
        return True
    try:
        value = float(score)
    except (TypeError, ValueError):
        return True
    return math.isnan(value) or math.isinf(value)


def _leaves(tree):
    """The tensors of a nested dict/list in the JAX pytree order (dict keys
    sorted)."""
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k])
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)


def _flat(tree) -> torch.Tensor:
    return torch.cat([t.detach().reshape(-1).float() for t in _leaves(tree)])


def health_terms(grads, params, new_params, loss) -> torch.Tensor:
    """The packed float32 summary ``[grad_norm, update_norm,
    nonfinite_grads, loss]`` (``_PACK_FIELDS``), on the device of its
    inputs. ``params`` and ``new_params`` are trees of the same structure
    (or a flat buffer of the same leaves in the same order, such as
    :meth:`ParamSnapshot.take` gives); each is read, never written."""
    g = _flat(grads)
    d = _flat(new_params) - _flat(params)
    return torch.stack([(g * g).sum().sqrt(), (d * d).sum().sqrt(),
                        (~torch.isfinite(g)).sum().float(),
                        torch.as_tensor(loss).detach().float().reshape(())])


class ParamSnapshot:
    """The parameters as they were before a monitored step's in-place
    update, in one flat float32 buffer this object owns (allocated at the
    first snapshot, in the eager step or a captured step's warm-up, and
    reused; a captured step reads and writes it at a fixed address)."""

    def __init__(self):
        self.buf: Optional[torch.Tensor] = None

    def take(self, params) -> torch.Tensor:
        leaves = [t.detach().reshape(-1).float() for t in _leaves(params)]
        n = sum(t.numel() for t in leaves)
        dev = leaves[0].device
        if self.buf is None or self.buf.numel() != n \
                or self.buf.device != dev:
            self.buf = torch.empty(n, dtype=torch.float32, device=dev)
        torch.cat(leaves, out=self.buf)
        return self.buf


class _Pending:
    """A summary on its way to the host: a pinned copy and the event that
    marks its end on the card (CPU: the vector itself)."""

    __slots__ = ("host", "event", "iteration")

    def __init__(self, packed: torch.Tensor, iteration: int):
        self.iteration = int(iteration)
        self.event = None
        if packed.device.type == "cuda":
            self.host = torch.empty(packed.shape, dtype=packed.dtype,
                                    pin_memory=True)
            self.host.copy_(packed, non_blocking=True)
            self.event = torch.cuda.Event()
            self.event.record()
        else:
            self.host = packed.detach().clone()

    def values(self) -> list:
        if self.event is not None:
            self.event.synchronize()
        return np_asarray(self.host).tolist()


class HealthMonitor:
    """Cadenced health checks in the step, with an alarm on the host.

    Attach with ``monitor.attach(net)`` (or set ``net.health_monitor``); the
    fit loops then run the health variant of the step at each iteration
    that ``due()`` names, and at the first due iteration of a K-step group
    (``due_index``): one check a group, as the JAX package checks one row
    of its stacked group output. Summaries arrive through :meth:`offer`
    (a copy started, no wait) and are read by :meth:`poll`, normally from
    ``NanAlertListener`` an iteration later, when the step is done."""

    def __init__(self, cadence: int = DEFAULT_CADENCE, *,
                 ema_alpha: float = 0.98, divergence_factor: float = 25.0,
                 min_ema_samples: int = 5, dump_on_alarm: bool = True,
                 recorder=None, registry=None):
        self.cadence = int(cadence)
        self.ema_alpha = float(ema_alpha)
        self.divergence_factor = float(divergence_factor)
        self.min_ema_samples = int(min_ema_samples)
        self.dump_on_alarm = dump_on_alarm
        self._recorder = recorder
        self._registry = registry
        self._lock = threading.Lock()
        self._pending: Optional[_Pending] = None
        self._dumped = False
        self.loss_ema: Optional[float] = None
        self._ema_samples = 0
        self.checks = 0
        self.alarms = 0
        self.alarm: Optional[Dict[str, Any]] = None  # last alarm, sticky
        self.last: Optional[Dict[str, Any]] = None   # last resolved summary

    def attach(self, net):
        """Set this monitor as ``net.health_monitor``; returns the monitor."""
        net.health_monitor = self
        return self

    @property
    def registry(self):
        return self._registry if self._registry is not None \
            else global_registry()

    def _recorder_or_global(self):
        if self._recorder is not None:
            return self._recorder
        from .flight_recorder import global_recorder

        return global_recorder()

    # ------------------------------------------------------------ cadence
    def due(self, iteration: int) -> bool:
        """True when the step at ``iteration`` carries the summary."""
        return self.cadence > 0 and iteration % self.cadence == 0

    def due_range(self, start: int, n: int) -> bool:
        """True when an iteration in ``[start, start + n)`` is due."""
        return self.due_index(start, n) is not None

    def due_index(self, start: int, n: int) -> Optional[int]:
        """The offset in ``[start, start + n)`` of the first due iteration,
        or None: the K-step group's one monitored step."""
        if self.cadence <= 0 or n <= 0:
            return None
        first_due = ((start + self.cadence - 1) // self.cadence) * self.cadence
        return first_due - start if first_due < start + n else None

    # ------------------------------------------------------------ results
    def offer(self, packed: torch.Tensor, iteration: int) -> None:
        """Take a health step's packed vector: its copy to pinned host
        memory is queued on the current stream (a captured step's output is
        overwritten by its next replay, so the copy starts now) and nothing
        waits. An earlier offer nobody polled is resolved now; its step is
        long done."""
        pending = _Pending(packed, iteration)
        with self._lock:
            prev, self._pending = self._pending, pending
        if prev is not None:
            self._resolve(prev)

    def poll(self) -> Optional[Dict[str, Any]]:
        """Read the pending summary, if any (the health path's one wait, on
        that summary's event only); returns the alarm dict when it tripped
        the alarm, else None."""
        with self._lock:
            pending, self._pending = self._pending, None
        if pending is None:
            return None
        return self._resolve(pending)

    def _resolve(self, pending: _Pending) -> Optional[Dict[str, Any]]:
        summary = dict(zip(_PACK_FIELDS, pending.values()))
        summary["iteration"] = pending.iteration
        reg = self.registry
        reg.gauge(HEALTH_GRAD_NORM,
                  "global grad L2 norm at the last health check").set(
                      summary["grad_norm"])
        reg.gauge(HEALTH_UPDATE_NORM,
                  "global param-update L2 norm at the last health check").set(
                      summary["update_norm"])
        reg.gauge(HEALTH_NONFINITE_GRADS,
                  "non-finite grad elements at the last health check").set(
                      summary["nonfinite_grads"])
        reg.counter(HEALTH_CHECKS_TOTAL,
                    "health summaries resolved on the host").inc()
        self.checks += 1
        loss = summary["loss"]
        why = None
        if summary["nonfinite_grads"] > 0:
            why = "nonfinite-grads"
        elif is_invalid_score(loss):
            why = "invalid-loss"
        elif not (math.isfinite(summary["grad_norm"])
                  and math.isfinite(summary["update_norm"])):
            why = "nonfinite-norms"
        else:
            if (self.loss_ema is not None
                    and self._ema_samples >= self.min_ema_samples
                    and loss > self.divergence_factor
                    * max(abs(self.loss_ema), 1e-8)):
                why = "loss-divergence"
            a = self.ema_alpha
            self.loss_ema = loss if self.loss_ema is None \
                else a * self.loss_ema + (1.0 - a) * loss
            self._ema_samples += 1
            reg.gauge(HEALTH_LOSS_EMA,
                      "EMA of the training loss at health checks").set(
                          self.loss_ema)
        self.last = summary
        if why is None:
            return None
        return self._raise_alarm(why, summary)

    def _raise_alarm(self, why: str, summary: Dict[str, Any]):
        alarm = dict(summary, why=why, ema=self.loss_ema)
        self.alarm = alarm
        self.alarms += 1
        self.registry.counter(
            HEALTH_ALARMS_TOTAL,
            "health alarms (non-finite or diverged training)").labels(
                why=why).inc()
        rec = self._recorder_or_global()
        rec.record("health_alarm", **alarm)
        log.error("health alarm at iteration %d: %s (loss=%g grad_norm=%g "
                  "update_norm=%g nonfinite_grads=%g ema=%s)",
                  summary["iteration"], why, summary["loss"],
                  summary["grad_norm"], summary["update_norm"],
                  summary["nonfinite_grads"], self.loss_ema)
        if self.dump_on_alarm and not self._dumped:
            if rec.dump(reason=f"health-alarm-{why}") is not None:
                self._dumped = True
        return alarm


def np_asarray(x):
    """A resolved health vector on the host as float64 numpy (its pinned
    copy: the copy's event was waited on first)."""
    return np.asarray(torch.as_tensor(x).detach().cpu(), dtype=np.float64)


class NanAlertListener:
    """A listener that polls the attached :class:`HealthMonitor` and acts
    on its alarms: the monitor records and dumps; with
    ``raise_on_alarm=True`` a :class:`TrainingDivergedError` stops the fit.
    Without a monitor it checks ``score_value`` every ``check_every``
    iterations (a host read of the loss at that cadence), as the
    reference's ``NanScoreWatcher`` does."""

    def __init__(self, monitor: Optional[HealthMonitor] = None, *,
                 check_every: int = 1, raise_on_alarm: bool = False,
                 recorder=None):
        self.monitor = monitor
        self.check_every = max(1, int(check_every))
        self.raise_on_alarm = raise_on_alarm
        self._recorder = recorder
        self._score_alarmed = False
        self._seen_alarm = None

    def _recorder_or_global(self):
        if self._recorder is not None:
            return self._recorder
        from .flight_recorder import global_recorder

        return global_recorder()

    def iteration_done(self, model, iteration: int) -> None:
        hm = self.monitor or getattr(model, "health_monitor", None)
        if hm is not None:
            hm.poll()
            # the sticky alarm covers a summary resolved by offer()'s
            # backlog path too, which poll() never returned here
            alarm = hm.alarm
            if (alarm is not None and alarm is not self._seen_alarm
                    and self.raise_on_alarm):
                self._seen_alarm = alarm
                raise TrainingDivergedError(
                    f"training health alarm at iteration "
                    f"{alarm['iteration']}: {alarm['why']} "
                    f"(loss={alarm['loss']!r})")
            return
        if iteration % self.check_every != 0:
            return
        score = model.score_value  # the host read, as the reference's
        if not is_invalid_score(score) or self._score_alarmed:
            return
        self._score_alarmed = True
        global_registry().counter(
            HEALTH_ALARMS_TOTAL,
            "health alarms (non-finite or diverged training)").labels(
                why="invalid-score").inc()
        rec = self._recorder_or_global()
        rec.record("health_alarm", why="invalid-score", iteration=iteration,
                   loss=None if score is None else float(score))
        rec.dump(reason="health-alarm-invalid-score")
        if self.raise_on_alarm:
            raise TrainingDivergedError(
                f"invalid score {score!r} at iteration {iteration}")
