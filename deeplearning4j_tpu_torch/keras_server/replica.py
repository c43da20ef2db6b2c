"""Multi-replica serving: N pinned forwards behind a least-queue router.

Counterpart of ``deeplearning4j_tpu/keras_server/replica.py``. A
:class:`ReplicaSet` runs N replicas independently: each owns its own
``ModelRegistry`` (its own pinned snapshots), its own
``AdmissionController`` and its own ``MicroBatcher`` dispatcher thread, so
replicas share no lock on the hot path. The router picks the replica with
the fewest admitted-but-unanswered requests (ties to the lowest index) and
falls through to the next on an admission refusal: a 429 comes only when
every replica refused. The routing decision is the trace span
``replica.route`` (``replica``, ``tried``; ``rejected`` when every replica
refused); the chosen replica's ``admission`` and ``batch.queue`` spans open
under it on the caller's thread, so the request's trace reaches the
replica's dispatcher through its queue span.

Placement, as the JAX package's ``_placement_for``:

- unsharded, replica i pins on ``devices[i % len(devices)]`` (no
  ``devices``: every replica on ``device``, ``None`` meaning CUDA);
- ``sharding="dp_tp"`` (any rule set): the device list (default every
  card, ``cuda:0`` .. ``cuda:N-1``) is cut into N contiguous slices and
  each replica pins sharded over a device mesh of its slice
  (``build_mesh(mesh_axes, devices=slice)``; by default ``{"data":
  per // model, "model": model}``, ``model`` 2 when the slice is even), so
  tensor-parallel serving and replica scale-out compose. A slice is a run
  of positions in the list; a device may repeat (``["cuda:0"] * 8`` on one
  card).

On one card the replicas share it: every dispatcher thread launches on the
card's default stream, so kernels run in launch order and
``int8_matmul``'s split-K workspace (kept per stream) never serves two
kernels at once.

**Lease fencing.** With ``membership=`` (a ``cloud.MembershipOracle``,
``role="replica"``) every replica registers a lease when it joins the set
and deregisters when it is removed; :meth:`ReplicaSet.heartbeat` renews
the leases of the replicas in the set (in one process, being in the
routable list is liveness). A replica whose ``(member, epoch)`` no longer
validates (evicted, or lapsed) is fenced: the router never dispatches to
it, :meth:`ReplicaSet.fenced_replicas` lists it, and the autoscaler's
sweep removes it and fills the fleet back to its floor. A heartbeat never
revives a dead lease.

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
admitted request completes.

Metrics (``metrics=``, the global registry by default): each replica's
batcher and admission write their series labelled by replica, and the set
keeps the fleet size, the routed requests by replica, the active version
(1 on the ``(replica, model, version)`` series in force, 0 on the ones it
replaced) and the scale events by direction and reason; :meth:`stats` has
the same counts.
"""
from __future__ import annotations

import threading
import time
from collections import Counter
from concurrent.futures import Future
from typing import Dict, List, Optional

import numpy as np
import torch

from ..common import resolve_device
from ..observability import names as _n
from ..observability.metrics import global_registry
from ..observability.tracing import trace_span
from .admission import RejectedError
from .batcher import MicroBatcher
from .registry import ModelRegistry, ModelVersion, load_model_file


class Replica:
    """One serving lane: private registry, admission and dispatcher, on one
    device or, sharded, on a device mesh (``mesh``; ``slots`` are its
    positions in the set's device list)."""

    def __init__(self, index: int, *, device=None, mesh=None, sharding=None,
                 slots=None, max_batch: int = 32, max_latency_s: float = 0.002,
                 max_queue: int = 256, warmup: bool = False, metrics=None):
        self.index = index
        self.mesh = mesh
        self.device = None if mesh is not None else resolve_device(device)
        self.sharding = sharding
        #: the positions in the set's device list this replica's mesh holds
        self.slots = list(slots) if slots is not None else []
        #: router-visible: a draining replica takes no new requests while
        #: its registry swaps versions (its queued work still completes)
        self.draining = False
        #: the replica's membership lease (a cloud.WorkerLease) in a fenced
        #: set, else None
        self.lease = None
        self.registry = ModelRegistry(
            metrics=metrics, warmup_max_batch=max_batch if warmup else None)
        self.batcher = MicroBatcher(
            self.registry, max_batch=max_batch, max_latency_s=max_latency_s,
            max_queue=max_queue, metrics=metrics, replica=index)

    def queue_depth(self) -> int:
        """Admitted-but-unanswered requests (the router's load signal)."""
        return self.batcher.admission.pending

    def devices(self) -> list:
        if self.mesh is not None:
            return [str(d) for d in self.mesh.devices.reshape(-1)]
        return [str(self.device)]


class ReplicaSet:
    """N independent replicas behind a least-queue-depth router."""

    def __init__(self, n_replicas: int, *, device=None, devices=None,
                 sharding=None, mesh_axes=None, max_batch: int = 32,
                 max_latency_s: float = 0.002, max_queue: int = 256,
                 drain_timeout_s: float = 30.0, warmup: bool = False,
                 membership=None, metrics=None):
        if n_replicas < 1:
            raise ValueError("n_replicas must be >= 1")
        self.sharding = sharding
        self.drain_timeout_s = float(drain_timeout_s)
        #: where the set reads model files: ``device``, else the first of
        #: ``devices``, else CUDA
        self.device = resolve_device(
            devices[0] if device is None and devices else device)
        self._mesh_axes = dict(mesh_axes) if mesh_axes is not None else None
        if devices is None and sharding is not None:
            if self.device.type != "cuda":
                raise ValueError("sharded replicas on the CPU need a device "
                                 "list (devices=)")
            devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
        self._devices = list(devices) if devices is not None else None
        #: devices a sharded replica's slice holds (fixed at construction)
        self._slice_per: Optional[int] = None
        self._max_batch = max_batch
        self._max_latency_s = max_latency_s
        self._max_queue = max_queue
        self._m = m = metrics or global_registry()
        self._c_routed = m.counter(
            _n.SERVE_REPLICA_ROUTED_TOTAL,
            "requests routed per replica (least-queue-depth dispatch)")
        self._g_active_version = m.gauge(
            _n.SERVE_REPLICA_ACTIVE_VERSION,
            "1 on the (replica, model, version) series currently active")
        self._g_fleet = m.gauge(
            _n.SERVE_FLEET_SIZE, "live serving replicas in the set")
        self._c_scale = m.counter(
            _n.SERVE_SCALE_EVENTS_TOTAL,
            "fleet size changes, by direction (out/in) and reason")
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
        self._membership = membership
        #: guarded-by: _lock
        self._replicas = [self._new_replica(i, warmup, n_total=n_replicas)
                          for i in range(n_replicas)]
        for r in self._replicas:
            self._join(r)
        self._g_fleet.set(len(self._replicas))

    def _join(self, r: Replica) -> None:
        if self._membership is not None:
            r.lease = self._membership.register(
                shard=r.index, worker=f"replica-{r.index}")

    def _new_replica(self, i: int, warmup: bool,
                     n_total: Optional[int] = None) -> Replica:
        return Replica(i, max_batch=self._max_batch,
                       max_latency_s=self._max_latency_s,
                       max_queue=self._max_queue, warmup=warmup,
                       metrics=self._m, **self._placement_for(i, n_total))

    def _placement_for(self, i: int, n_total: Optional[int] = None) -> dict:
        """Replica ``i``'s placement (JAX ``_placement_for``). ``n_total``
        sizes the mesh slices at construction; afterwards the slice width
        is fixed, so a sharded scale-out succeeds only while unclaimed
        slices remain."""
        devs = self._devices
        if self.sharding is None:
            if devs is None:
                return {"device": self.device}
            return {"device": devs[i % len(devs)]}
        from ..parallel.mesh import build_mesh
        if n_total is not None:
            per = len(devs) // n_total
            if per < 1:
                raise ValueError(
                    f"{n_total} sharded replicas need >= {n_total} devices, "
                    f"have {len(devs)}")
            if self._mesh_axes is None:
                # the model axis gets the factor of two when there is one:
                # dp_tp with model=1 would shard nothing
                model = 2 if per % 2 == 0 else 1
                self._mesh_axes = {"data": per // model, "model": model}
            self._slice_per = per
        per = self._slice_per
        need = int(np.prod(list(self._mesh_axes.values())))
        if need > per:
            raise ValueError(
                f"mesh_axes {self._mesh_axes} needs {need} devices per "
                f"replica but only {per} are available for each replica")
        if i * per + need > len(devs):
            raise ValueError(
                f"no free device slice for sharded replica {i}: "
                f"{len(devs)} devices at {per} per replica")
        at = range(i * per, i * per + need)
        return {"mesh": build_mesh(self._mesh_axes,
                                   devices=[devs[j] for j in at]),
                "sharding": self.sharding, "slots": at}

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
                                 replica=r.index, sharding=r.sharding,
                                 mesh=r.mesh)
        with self._lock:
            prev = self._active_version.get((r.index, name))
            self._active_version[(r.index, name)] = version
        if prev is not None:
            self._g_active_version.labels(
                replica=str(r.index), model=name, version=prev).set(0)
        self._g_active_version.labels(
            replica=str(r.index), model=name, version=version).set(1)
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
            self._join(r)
            with self._lock:
                self._replicas.append(r)
                self._routed[idx] = 0
                self.scale_events[("out", reason)] += 1
                self._g_fleet.set(len(self._replicas))
            self._c_scale.labels(direction="out", reason=reason).inc()
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
                self._g_fleet.set(len(self._replicas))
            r.batcher.close(self.drain_timeout_s)
            if self._membership is not None and r.lease is not None:
                self._membership.deregister(r.lease.member, r.lease.epoch,
                                            reason=reason)
            with self._lock:
                retired = {name: self._active_version.pop((r.index, name),
                                                          None)
                           for name in r.registry.names()}
                self.scale_events[("in", reason)] += 1
            for name, prev in retired.items():
                if prev is not None:
                    self._g_active_version.labels(
                        replica=str(r.index), model=name,
                        version=prev).set(0)
            self._c_scale.labels(direction="in", reason=reason).inc()
            return True

    # ----------------------------------------------------------- membership
    def heartbeat(self) -> None:
        """Renew the lease of every replica in the set. An evicted or
        superseded lease stays dead."""
        if self._membership is None:
            return
        for r in self.replicas:
            if r.lease is not None:
                self._membership.heartbeat(r.lease.member, r.lease.epoch)

    def _lease_ok(self, r: Replica) -> bool:
        if self._membership is None or r.lease is None:
            return True
        return self._membership.validate(r.lease.member, r.lease.epoch)

    def fenced_replicas(self) -> List[Replica]:
        """Replicas whose lease no longer validates (the autoscaler's
        sweep removes and replaces them)."""
        return [r for r in self.replicas if not self._lease_ok(r)]

    # -------------------------------------------------------------- router
    def submit(self, model: str, x, *, priority: str = "high",
               tenant: str = "-") -> Future:
        """Route one request to the least-loaded replica that is not
        draining, falling through on an admission refusal; raises the last
        :class:`RejectedError` when every replica refused. A fenced replica
        gets nothing while a live one is in the set."""
        with self._lock:
            fleet = list(self._replicas)
        live = [r for r in fleet if self._lease_ok(r)] or fleet
        candidates = [r for r in live if not r.draining] or live
        last: Optional[RejectedError] = None
        with trace_span("replica.route", model=model) as sp:
            tried = 0
            for r in sorted(candidates,
                            key=lambda r: (r.queue_depth(), r.index)):
                tried += 1
                try:
                    fut = r.batcher.submit(model, x, priority=priority,
                                           tenant=tenant)
                except RejectedError as e:
                    last = e
                    continue
                self._c_routed.labels(replica=str(r.index)).inc()
                sp.set_attr(replica=r.index, tried=tried)
                with self._lock:
                    self._routed[r.index] = self._routed.get(r.index, 0) + 1
                return fut
            sp.set_status("rejected").set_attr(tried=tried)
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
                "fenced": not self._lease_ok(r),
                "queue_depth": r.queue_depth(),
                "routed": routed.get(r.index, 0),
                "dispatches": s["dispatches"],
                "mean_occupancy": s["mean_occupancy"],
                "bucket_count": s["bucket_count"],
                "rejected": s["rejected"], "sharding": r.sharding,
                "devices": r.devices(),
                "mesh": dict(r.mesh.shape) if r.mesh is not None else None,
                "slots": list(r.slots),
                "active": {name: r.registry.active(name).version
                           for name in r.registry.names()},
            })
        return {"n_replicas": len(fleet), "sharding": self.sharding,
                "replicas": reps, "scale_events": events}

    def close(self, timeout_s: float = 5.0) -> None:
        for r in self.replicas:
            r.batcher.close(timeout_s)
