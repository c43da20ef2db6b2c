"""Multi-replica serving: N pinned forwards behind a least-queue router.

Counterpart of ``deeplearning4j_tpu/keras_server/replica.py``. A
:class:`ReplicaSet` runs N replicas independently: each owns its own
``ModelRegistry`` (its own pinned snapshots), its own
``AdmissionController`` and its own ``MicroBatcher`` dispatcher thread, so
replicas share no lock on the hot path. The router picks the replica with
the fewest admitted-but-unanswered requests (ties to the lowest index) and
falls through to the next on an admission refusal: a 429 comes only when
every replica refused.

Placement: every replica pins on ``device`` (``None`` means CUDA);
placement over several devices (``devices=``) waits for ROADMAP.md A7. On
one card the replicas share it: every
dispatcher thread launches on the card's default stream, so kernels run in
launch order and ``int8_matmul``'s split-K workspace (kept per stream)
never serves two kernels at once. Sharded replicas
(``sharding=``) wait for ROADMAP.md A7.8 and lease fencing
(``membership=``, the ``cloud.MembershipOracle``) for A7.4.

**Rolling hot swap.** :meth:`ReplicaSet.register` upgrades one replica at a
time: mark it draining (the router stops sending it new work while a
sibling can serve), wait for its queue to empty, swap its registry's active
pointer, undrain, then the next. In-flight requests complete against the
version they resolved at dispatch, so no request is lost across a fleet
upgrade and the fleet serves at N - 1 replicas during the roll.

**Elastic fleet.** :meth:`add_replica` and :meth:`remove_replica` are the
autoscaler's actuators. Indices are allocated monotonically and never
reused. A new replica registers the active version of every model in the
catalog (warmed when the registration names an example) before the router
sees it; removal drains, unlinks, then closes the dispatcher, so every
admitted request completes. Where the JAX package records metrics, this
module keeps plain counters in :meth:`stats`.
"""
from __future__ import annotations

import threading
import time
from collections import Counter
from concurrent.futures import Future
from typing import Dict, List, Optional

from ..common import resolve_device
from .admission import RejectedError
from .batcher import MicroBatcher
from .registry import ModelRegistry, ModelVersion, load_model_file


def refuse_sharded(sharding=None, membership=None, mesh_axes=None,
                   devices=None) -> None:
    """Raise for the placements that wait for the parallel modes."""
    if devices is not None:
        raise NotImplementedError(
            "replicas placed over several devices (devices=, "
            "replica_devices=) wait for the parallel modes (ROADMAP.md A7)")
    if sharding is not None or mesh_axes is not None:
        raise NotImplementedError(
            "sharded replicas (sharding=, mesh axes) place a PredictFn over "
            "the A7.1 mesh and rule engine, and wait for ROADMAP.md A7.8")
    if membership is not None:
        raise NotImplementedError(
            "replica lease fencing (membership=, cloud.MembershipOracle) "
            "waits for ROADMAP.md A7.4")


class Replica:
    """One serving lane: private registry, admission and dispatcher."""

    def __init__(self, index: int, *, device=None, sharding=None,
                 max_batch: int = 32, max_latency_s: float = 0.002,
                 max_queue: int = 256, warmup: bool = False):
        refuse_sharded(sharding)
        self.index = index
        self.device = resolve_device(device)
        self.sharding = None
        #: router-visible: a draining replica takes no new requests while
        #: its registry swaps versions (its queued work still completes)
        self.draining = False
        self.registry = ModelRegistry(
            warmup_max_batch=max_batch if warmup else None)
        self.batcher = MicroBatcher(
            self.registry, max_batch=max_batch, max_latency_s=max_latency_s,
            max_queue=max_queue, replica=index)

    def queue_depth(self) -> int:
        """Admitted-but-unanswered requests (the router's load signal)."""
        return self.batcher.admission.pending

    def devices(self) -> list:
        return [str(self.device)]


class ReplicaSet:
    """N independent replicas behind a least-queue-depth router."""

    def __init__(self, n_replicas: int, *, device=None, devices=None,
                 sharding=None, mesh_axes=None, max_batch: int = 32,
                 max_latency_s: float = 0.002, max_queue: int = 256,
                 drain_timeout_s: float = 30.0, warmup: bool = False,
                 membership=None):
        refuse_sharded(sharding, membership, mesh_axes, devices)
        if n_replicas < 1:
            raise ValueError("n_replicas must be >= 1")
        self.sharding = None
        self.drain_timeout_s = float(drain_timeout_s)
        self.device = resolve_device(device)
        self._max_batch = max_batch
        self._max_latency_s = max_latency_s
        self._max_queue = max_queue
        self._lock = threading.Lock()
        # serializes fleet mutations (a register roll, add/remove) against
        # each other, so a replica added mid-roll cannot miss a version;
        # the router's submit() never takes it
        self._mutate_lock = threading.RLock()
        self._versions: Dict[str, List[str]] = {}
        #: name -> (version, net, source, quant, warmup example) of the
        #: active version: what a new replica registers before it joins
        self._catalog: Dict[str, tuple] = {}
        self._routed: Dict[int, int] = {i: 0 for i in range(n_replicas)}
        #: (replica, model) -> its active version
        self._active_version: Dict[tuple, str] = {}
        #: fleet size changes by (direction, reason)
        self.scale_events: Counter = Counter()
        self._next_index = n_replicas
        #: guarded-by: _lock
        self._replicas = [self._new_replica(i, warmup)
                          for i in range(n_replicas)]

    def _new_replica(self, i: int, warmup: bool) -> Replica:
        return Replica(i, device=self.device,
                       max_batch=self._max_batch,
                       max_latency_s=self._max_latency_s,
                       max_queue=self._max_queue, warmup=warmup)

    # ------------------------------------------------------------ registry
    @property
    def n_replicas(self) -> int:
        with self._lock:
            return len(self._replicas)

    @property
    def replicas(self) -> List[Replica]:
        with self._lock:
            return list(self._replicas)

    @property
    def primary_registry(self) -> ModelRegistry:
        """Replica 0's registry, the front door's model lookup (404s,
        streaming, decode); ``remove_replica`` never takes replica 0."""
        with self._lock:
            return self._replicas[0].registry

    def _wait_drained(self, replica: Replica) -> bool:
        deadline = time.monotonic() + self.drain_timeout_s
        while time.monotonic() < deadline:
            if replica.queue_depth() == 0:
                return True
            time.sleep(0.002)
        return False

    def register(self, name: str, net, version: Optional[str] = None,
                 source: str = "memory", quant: Optional[str] = None,
                 warmup_example=None) -> ModelVersion:
        """Rolling registration: pin ``net`` on every replica, one at a
        time, draining each before its pointer swap. The version is
        allocated once, so every replica agrees on the catalog."""
        with self._mutate_lock:
            with self._lock:
                versions = self._versions.setdefault(name, [])
                version = version or f"v{len(versions) + 1}"
                if version in versions:
                    raise ValueError(
                        f"model {name!r} already has version {version!r}; "
                        "versions are immutable - register a new one")
                versions.append(version)
                fleet = list(self._replicas)
            first: Optional[ModelVersion] = None
            for r in fleet:
                # drain only when a sibling can take the traffic: a lone
                # replica swaps atomically under load instead of pausing
                drain = any(not o.draining for o in fleet if o is not r)
                r.draining = drain
                try:
                    if drain:
                        self._wait_drained(r)
                    mv = self._register_on(r, name, net, version, source,
                                           quant, warmup_example)
                finally:
                    r.draining = False
                if first is None:
                    first = mv
            with self._lock:
                self._catalog[name] = (version, net, source, quant,
                                       warmup_example)
            return first

    #: requires-lock: _mutate_lock
    def _register_on(self, r: Replica, name: str, net, version: str,
                     source: str, quant: Optional[str],
                     warmup_example=None) -> ModelVersion:
        mv = r.registry.register(name, net, version=version, quant=quant,
                                 device=r.device, source=source,
                                 warmup_example=warmup_example,
                                 replica=r.index)
        with self._lock:
            self._active_version[(r.index, name)] = version
        return mv

    def load(self, name: str, path: str, version: Optional[str] = None,
             quant: Optional[str] = None,
             warmup_example=None) -> ModelVersion:
        """Read a model file once (on the first replica's device) and roll
        it onto every replica."""
        return self.register(name, load_model_file(path,
                                                   device=self.device),
                             version=version, source=path, quant=quant,
                             warmup_example=warmup_example)

    # ------------------------------------------------------- fleet scaling
    def add_replica(self, reason: str = "manual") -> Replica:
        """Grow the fleet by one: the new replica (warmup on) registers the
        active version of every model in the catalog before it is appended
        to the routable list, so the router never sees it empty."""
        with self._mutate_lock:
            with self._lock:
                idx = self._next_index
                self._next_index += 1
                catalog = dict(self._catalog)
            r = self._new_replica(idx, warmup=True)
            for name, (version, net, source, quant, ex) in catalog.items():
                self._register_on(r, name, net, version, source, quant, ex)
            with self._lock:
                self._replicas.append(r)
                self._routed[idx] = 0
                self.scale_events[("out", reason)] += 1
            return r

    def remove_replica(self, index: Optional[int] = None,
                       reason: str = "manual") -> bool:
        """Shrink the fleet by one without loss: mark draining, wait for the
        queue to empty, unlink, then close the dispatcher (which answers
        anything that slipped in before the unlink). Defaults to the
        highest index; the primary replica and the last one stay."""
        with self._mutate_lock:
            with self._lock:
                if len(self._replicas) <= 1:
                    raise ValueError("cannot remove the last replica")
                primary = self._replicas[0]
                if index is None:
                    r = max(self._replicas[1:], key=lambda o: o.index)
                else:
                    found = [o for o in self._replicas
                             if o.index == int(index)]
                    if not found:
                        return False
                    r = found[0]
                    if r is primary:
                        raise ValueError(
                            "cannot remove the primary replica (its "
                            "registry is the front door)")
            r.draining = True
            self._wait_drained(r)
            with self._lock:
                self._replicas = [o for o in self._replicas if o is not r]
            r.batcher.close(self.drain_timeout_s)
            with self._lock:
                for name in r.registry.names():
                    self._active_version.pop((r.index, name), None)
                self.scale_events[("in", reason)] += 1
            return True

    # -------------------------------------------------------------- router
    def submit(self, model: str, x, *, priority: str = "high",
               tenant: str = "-") -> Future:
        """Route one request to the least-loaded replica that is not
        draining, falling through on an admission refusal; raises the last
        :class:`RejectedError` when every replica refused."""
        with self._lock:
            fleet = list(self._replicas)
        candidates = [r for r in fleet if not r.draining] or fleet
        last: Optional[RejectedError] = None
        for r in sorted(candidates, key=lambda r: (r.queue_depth(), r.index)):
            try:
                fut = r.batcher.submit(model, x, priority=priority,
                                       tenant=tenant)
            except RejectedError as e:
                last = e
                continue
            with self._lock:
                self._routed[r.index] = self._routed.get(r.index, 0) + 1
            return fut
        assert last is not None
        raise last

    # ------------------------------------------------------------- control
    def queue_stats(self) -> dict:
        """Aggregate stats in the single batcher's shape (the status
        "queue" block keeps its schema in replica mode)."""
        per = [r.batcher.stats() for r in self.replicas]
        dispatches = sum(s["dispatches"] for s in per)
        return {
            "queue_depth": sum(s["queue_depth"] for s in per),
            "pending": sum(s["pending"] for s in per),
            "max_queue": sum(s["max_queue"] for s in per),
            "rejected": sum(s["rejected"] for s in per),
            "dispatches": dispatches,
            "errors": sum(s["errors"] for s in per),
            "mean_occupancy": (
                sum(s["mean_occupancy"] * s["dispatches"] for s in per)
                / dispatches if dispatches else 0.0),
            "bucket_count": sum(s["bucket_count"] for s in per),
            "max_batch": per[0]["max_batch"],
            "max_latency_s": per[0]["max_latency_s"],
            "replicas": len(per),
        }

    def stats(self) -> dict:
        """Per-replica detail for the status "replicas" block."""
        with self._lock:
            routed = dict(self._routed)
            fleet = list(self._replicas)
            events = [{"direction": d, "reason": why, "count": n}
                      for (d, why), n in sorted(self.scale_events.items())]
        reps = []
        for r in fleet:
            s = r.batcher.stats()
            reps.append({
                "replica": r.index, "draining": r.draining,
                "queue_depth": r.queue_depth(),
                "routed": routed.get(r.index, 0),
                "dispatches": s["dispatches"],
                "mean_occupancy": s["mean_occupancy"],
                "bucket_count": s["bucket_count"],
                "rejected": s["rejected"], "sharding": r.sharding,
                "devices": r.devices(),
                "active": {name: r.registry.active(name).version
                           for name in r.registry.names()},
            })
        return {"n_replicas": len(fleet), "sharding": self.sharding,
                "replicas": reps, "scale_events": events}

    def close(self, timeout_s: float = 5.0) -> None:
        for r in self.replicas:
            r.batcher.close(timeout_s)
