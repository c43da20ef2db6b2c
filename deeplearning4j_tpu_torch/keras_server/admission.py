"""Admission control: bounded pending work, fail-fast overload.

Counterpart of ``deeplearning4j_tpu/keras_server/admission.py``. The
controller caps admitted-but-unfinished requests; past the cap ``admit()``
raises :class:`RejectedError`, which the HTTP layer maps to 429 with a
``Retry-After`` hint. Each priority (``low`` < ``normal`` < ``high``) sees a
fraction of the budget, so under saturation low priorities are shed first.
A request may name its tenant (the HTTP layer reads ``X-DL4J-Tenant``);
priority sheds are counted by tenant and by priority in :meth:`stats`,
where the JAX package counts them in ``dl4j_serve_shed_total{tenant,
priority}``.
"""
from __future__ import annotations

import threading
from collections import Counter

#: recognized priority tags, lowest first (shed order under saturation)
PRIORITY_LEVELS = ("low", "normal", "high")

#: fraction of ``max_pending`` each priority may fill before it is shed
PRIORITY_FLOORS = {"low": 0.5, "normal": 0.75, "high": 1.0}


def normalize_priority(priority) -> str:
    """Map an untrusted tag onto a known level; unknown or missing tags get
    the full budget (``high``)."""
    p = str(priority).strip().lower() if priority else "high"
    return p if p in PRIORITY_FLOORS else "high"


class RejectedError(RuntimeError):
    """Request refused at admission (maps to HTTP 429)."""

    def __init__(self, pending: int, limit: int, retry_after_s: float,
                 priority: str = "high", shed: bool = False):
        super().__init__(
            f"serving queue full ({pending}/{limit} pending); "
            f"retry in ~{retry_after_s:.3f}s")
        self.pending = pending
        self.limit = limit
        self.retry_after_s = retry_after_s
        self.priority = priority
        #: True when the refusal was a priority shed, False when hard-full
        self.shed = shed


class AdmissionController:
    """Counting semaphore with a Retry-After estimate."""

    def __init__(self, max_pending: int = 256,
                 expected_latency_s: float = 0.05):
        if max_pending < 1:
            raise ValueError("max_pending must be >= 1")
        self.max_pending = int(max_pending)
        self.expected_latency_s = float(expected_latency_s)
        self._lock = threading.Lock()
        self._pending = 0
        self.rejected = 0
        self.shed = 0
        #: priority sheds by (tenant, priority), by tenant, by priority
        self.shed_by: Counter = Counter()

    @property
    def pending(self) -> int:
        with self._lock:
            return self._pending

    def limit_for(self, priority: str) -> int:
        """The pending budget ``priority`` may fill before it is shed."""
        return max(1, int(self.max_pending * PRIORITY_FLOORS.get(priority, 1.0)))

    def admit(self, n: int = 1, priority: str = "high",
              tenant: str = "-") -> None:
        """Admit ``n`` requests or raise :class:`RejectedError`; a priority
        shed is counted against ``tenant``."""
        limit = self.limit_for(priority)
        with self._lock:
            if self._pending + n > limit:
                shed = limit < self.max_pending
                self.rejected += n
                if shed:
                    self.shed += n
                    self.shed_by[(tenant, priority)] += n
                raise RejectedError(self._pending, limit,
                                    self.expected_latency_s,
                                    priority=priority, shed=shed)
            self._pending += n

    def release(self, n: int = 1) -> None:
        with self._lock:
            self._pending = max(0, self._pending - n)

    def stats(self) -> dict:
        """Pending work, refusals and priority sheds, by tenant and by
        priority (a hard-full refusal is a reject, never a shed)."""
        with self._lock:
            by_tenant: Counter = Counter()
            by_priority: Counter = Counter()
            for (tenant, priority), n in self.shed_by.items():
                by_tenant[tenant] += n
                by_priority[priority] += n
            return {"pending": self._pending, "max_pending": self.max_pending,
                    "rejected": self.rejected, "shed": self.shed,
                    "shed_by_tenant": dict(sorted(by_tenant.items())),
                    "shed_by_priority": dict(sorted(by_priority.items()))}
