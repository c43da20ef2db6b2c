"""Staleness-bounded asynchronous parameter-server training.

Counterpart of ``deeplearning4j_tpu/parallel/param_server.py``
(deeplearning4j-scaleout ``ParameterServerParallelWrapper``).

* **Server** (:class:`ParameterServer`): the canonical parameters are one
  float32 numpy vector on the host behind a lock, with a version that
  counts applied pushes. Workers push deltas (local params minus the base
  they pulled); a push ``s`` versions behind is weighted ``1/(1+s)``
  through the server's optimizer, and one staler than ``staleness_cap`` is
  rejected, so the worker rebases and pushes again. With a membership
  oracle, pushes that carry a dead ``(member, epoch)`` are fenced.
* **Transports** (``parallel/ps_transport.py``): ``inproc`` (worker
  threads, each with a ``clone()`` of the model on the model's device),
  ``tcp`` and ``shm`` (worker processes, ``parallel/ps_worker.py``, on the
  model's device too: the card unless the caller asked for the CPU).
* **Overlap**: :class:`_BackgroundPuller` fetches fresh params on a thread
  while the worker trains.

The vector's order is the JAX ``tree_leaves`` order of the params (a
network's ``params_list``: layers in order, or a graph's vertices by
name, each layer's names sorted), so the same weights carried across with
``convert.from_jax`` give the same vector. A worker's pull, push and
rebase copy between that host vector and the replica's tensors on its
device (:func:`flatten_tree`, :func:`unflatten_into`), in the worker's own
thread, so they never race a step of the same replica. The worker's step
is the replica network's own train step (``_eager_step`` over
``make_train_step``); on the card it launches the network's kernels.

Telemetry as in the JAX module: ``dl4j_ps_pushes_total`` by outcome,
``dl4j_ps_pulls_total``, the staleness and push-weight histograms,
``dl4j_ps_version``, ``dl4j_ps_worker_steps_total`` by worker and
``dl4j_elastic_fenced_pushes_total``, process-wide series; a rejected or
fenced push and a worker's crash are flight-recorder events, each applied
push beats the watchdog, and ``fit`` dumps once on an unhandled exception.
:meth:`ParameterServer.stats` keeps one server's own counts (a process may
hold several) and the workers their stats.

Tracing: a worker's push window is the span ``ps.push_window``, parented on
the ambient span or on the transport's ``trace_parent`` (the consume span of
the batch being trained, bound by the elastic worker); with neither it opens
no span. The transport's RPC span and the server's ``ps.apply`` nest under
it (``ps_transport.py``).
"""
from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import threading
import time
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..common import host_numpy
from ..observability.flight_recorder import dump_on_unhandled, global_recorder
from ..observability.metrics import global_registry
from ..observability.tracing import current_span, trace_span
from ..observability.names import (
    ELASTIC_FENCED_PUSHES_TOTAL, PS_PULLS_TOTAL, PS_PUSH_WEIGHT,
    PS_PUSHES_TOTAL, PS_STALENESS, PS_VERSION, PS_WORKER_STEPS_TOTAL)
from ..observability.watchdog import beat

#: default hard staleness bound: a push based more than 8 versions back is
#: rejected
DEFAULT_STALENESS_CAP = 8

_pushes = global_registry().counter(
    PS_PUSHES_TOTAL, "delta pushes by outcome (applied|rejected)")
_pushes_applied = _pushes.labels(outcome="applied")
_pushes_rejected = _pushes.labels(outcome="rejected")
_pulls = global_registry().counter(PS_PULLS_TOTAL,
                                   "server param pulls").labels()
_staleness_hist = global_registry().histogram(
    PS_STALENESS, "versions behind head at push time",
    buckets=(0, 1, 2, 4, 8, 16, 32, 64)).labels()
_weight_hist = global_registry().histogram(
    PS_PUSH_WEIGHT, "staleness down-weight 1/(1+s) applied to each delta",
    buckets=(0.05, 0.1, 0.2, 0.3, 0.5, 0.8, 1.0)).labels()
_version_gauge = global_registry().gauge(
    PS_VERSION, "server param version (total applied pushes)").labels()
_worker_steps = global_registry().counter(
    PS_WORKER_STEPS_TOTAL, "local train steps by PS workers")
_fenced_pushes = global_registry().counter(
    ELASTIC_FENCED_PUSHES_TOTAL,
    "pushes rejected because the worker's membership epoch is dead "
    "(zombie fencing)").labels()

#: how long a fit waits for its worker threads or processes to end
WORKER_TIMEOUT_S = 600.0
#: the root of the checkout, put on a worker process's PYTHONPATH
_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


# --------------------------------------------------------------------------
# flat-vector codec: the whole param tree as one contiguous float32 vector

_LEAF = object()


def tree_leaves(tree) -> list:
    """The leaves of a nested dict/list/tuple in the JAX ``tree_leaves``
    order: dict keys sorted, sequences in order, None an empty subtree."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [l for k in sorted(tree) for l in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [l for v in tree for l in tree_leaves(v)]
    return [tree]


def _skeleton(tree):
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _skeleton(tree[k]) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_skeleton(v) for v in tree)
    return _LEAF


def _rebuild(skel, leaves):
    if skel is _LEAF:
        return next(leaves)
    if isinstance(skel, dict):
        return {k: _rebuild(v, leaves) for k, v in skel.items()}
    if isinstance(skel, (list, tuple)):
        return type(skel)(_rebuild(v, leaves) for v in skel)
    return None


@dataclasses.dataclass(frozen=True)
class TreeSpec:
    treedef: object
    shapes: Tuple[Tuple[int, ...], ...]
    dtypes: Tuple[object, ...]
    sizes: Tuple[int, ...]


def _host_dtype(leaf) -> np.dtype:
    """The numpy dtype a leaf comes back as (bfloat16, which numpy lacks,
    as float32)."""
    if isinstance(leaf, torch.Tensor):
        dt = torch.float32 if leaf.dtype == torch.bfloat16 else leaf.dtype
        return torch.empty(0, dtype=dt).numpy().dtype
    return np.asarray(leaf).dtype


def flatten_tree(tree) -> Tuple[np.ndarray, TreeSpec]:
    """The tree's leaves (tensors on any device, or numpy arrays) as one
    float32 host vector, and the spec to rebuild it. Device leaves are
    concatenated on their device and copied to the host once."""
    leaves = tree_leaves(tree)
    shapes = tuple(tuple(l.shape) for l in leaves)
    sizes = tuple(int(np.prod(s, dtype=np.int64)) for s in shapes)
    spec = TreeSpec(_skeleton(tree), shapes,
                    tuple(_host_dtype(l) for l in leaves), sizes)
    if not leaves:
        return np.zeros(0, np.float32), spec
    if all(isinstance(l, torch.Tensor) for l in leaves):
        with torch.no_grad():
            flat = torch.cat([l.detach().reshape(-1).float() for l in leaves])
        return host_numpy(flat), spec
    vec = np.concatenate([
        (host_numpy(l) if isinstance(l, torch.Tensor) else np.asarray(l))
        .astype(np.float32, copy=False).ravel() for l in leaves])
    return vec, spec


def unflatten_tree(vec: np.ndarray, spec: TreeSpec):
    """The tree of ``spec`` with numpy leaves cut from ``vec``."""
    leaves, off = [], 0
    for shape, dtype, size in zip(spec.shapes, spec.dtypes, spec.sizes):
        leaves.append(vec[off:off + size].reshape(shape).astype(
            dtype, copy=False))
        off += size
    return _rebuild(spec.treedef, iter(leaves))


@torch.no_grad()
def unflatten_into(vec: np.ndarray, tree) -> None:
    """Write ``vec`` into the tree's tensors in place: one host-to-device
    copy, then a device copy into each leaf."""
    leaves = tree_leaves(tree)
    if not leaves:
        return
    if not vec.flags.writeable:
        vec = vec.copy()  # torch.from_numpy wants a writable buffer
    src = torch.from_numpy(vec).to(leaves[0].device)
    off = 0
    for leaf in leaves:
        n = leaf.numel()
        leaf.copy_(src[off:off + n].view(leaf.shape))
        off += n
    if off != src.numel():
        raise ValueError(f"a vector of {src.numel()} values for a tree of "
                         f"{off}")


# --------------------------------------------------------------------------
# server

@dataclasses.dataclass
class PushResult:
    """Outcome of one delta push. ``params``/``version`` carry the server's
    state after the push (a rejected push's forced re-pull rides the same
    round trip). ``fenced`` marks an epoch-fenced rejection: the pusher's
    lease is dead and no retry can succeed."""
    accepted: bool
    version: int
    staleness: int
    weight: float
    params: Optional[np.ndarray] = None
    fenced: bool = False


class StaleEpochFenced(RuntimeError):
    """The worker's membership epoch was fenced (its lease lapsed or was
    superseded): the server rejects its pushes for good, and the worker
    must exit; a replacement registers with a fresh epoch."""


class _ServerOptimizer:
    """The server's update rule for pushed deltas: SGD applies ``lr *
    weight * delta``; momentum folds deltas into a velocity first."""

    def __init__(self, kind: str = "sgd", lr: float = 1.0,
                 momentum: float = 0.9):
        if kind not in ("sgd", "momentum"):
            raise ValueError(f"unknown server optimizer {kind!r}; "
                             "expected 'sgd' or 'momentum'")
        self.kind, self.lr, self.momentum = kind, lr, momentum
        self._vel: Optional[np.ndarray] = None

    def apply(self, params: np.ndarray, delta: np.ndarray,
              weight: float) -> np.ndarray:
        if self.kind == "sgd":
            params += (self.lr * weight) * delta
        else:
            if self._vel is None:
                self._vel = np.zeros_like(params)
            self._vel *= self.momentum
            self._vel += weight * delta
            params += self.lr * self._vel
        return params


class ParameterServer:
    """Versioned canonical param store. Every mutation happens under one
    lock; ``version`` counts applied pushes. The TCP frontend
    (``parallel/ps_transport.py``) serves the same object to worker
    processes."""

    def __init__(self, initial_params, *,
                 staleness_cap: int = DEFAULT_STALENESS_CAP,
                 optimizer: str = "sgd", server_lr: float = 1.0,
                 momentum: float = 0.9, membership=None):
        vec, spec = flatten_tree(initial_params)
        self._vec = vec
        self._spec = spec
        self._opt = _ServerOptimizer(optimizer, server_lr, momentum)
        self._lock = threading.Lock()
        self.staleness_cap = int(staleness_cap)
        self.version = 0
        self.pushes = 0          # applied
        self.rejected = 0
        self.pulls = 0
        #: a cloud.MembershipOracle (or None): pushes that carry a
        #: (member, epoch) identity are fenced against its leases
        self.membership = membership
        self.fenced = 0
        #: staleness of every push, applied or not, by value
        self.staleness_counts: dict = {}

    @property
    def spec(self) -> TreeSpec:
        return self._spec

    def push_delta(self, delta: np.ndarray, base_version: int, *,
                   member: Optional[int] = None,
                   epoch: Optional[int] = None) -> PushResult:
        """Apply a worker delta computed against ``base_version``:
        staleness ``s = version - base_version``, weight ``1/(1+s)``; a push
        with ``s > staleness_cap`` is rejected (weight 0) and the caller
        rebases onto the returned state. With an oracle and an identity, a
        dead or superseded epoch is fenced, for good."""
        delta = np.asarray(delta, np.float32)
        if (self.membership is not None and member is not None
                and not self.membership.validate(member, epoch)):
            with self._lock:
                self.fenced += 1
                self.rejected += 1
                _fenced_pushes.inc()
                _pushes_rejected.inc()
                global_recorder().record(
                    "ps_push_fenced", member=member, epoch=epoch,
                    version=self.version)
                return PushResult(False, self.version,
                                  self.version - int(base_version), 0.0,
                                  np.copy(self._vec), fenced=True)
        with self._lock:
            staleness = self.version - int(base_version)
            self.staleness_counts[staleness] = (
                self.staleness_counts.get(staleness, 0) + 1)
            _staleness_hist.observe(staleness)
            if staleness > self.staleness_cap:
                self.rejected += 1
                _pushes_rejected.inc()
                global_recorder().record(
                    "ps_push_rejected", staleness=staleness,
                    cap=self.staleness_cap, version=self.version)
                return PushResult(False, self.version, staleness, 0.0,
                                  np.copy(self._vec))
            weight = 1.0 / (1.0 + max(0, staleness))
            self._vec = self._opt.apply(self._vec, delta, weight)
            self.version += 1
            self.pushes += 1
            _pushes_applied.inc()
            _weight_hist.observe(weight)
            _version_gauge.set(self.version)
            beat(self.version)
            return PushResult(True, self.version, staleness, weight,
                              np.copy(self._vec))

    def pull_flat(self) -> Tuple[int, np.ndarray]:
        _pulls.inc()
        with self._lock:
            self.pulls += 1
            return self.version, np.copy(self._vec)

    def push(self, params, base_version: Optional[int] = None) -> PushResult:
        """Full-param push (the older API): a delta against the caller's
        base or, with no base version, against the current head (weight
        1, staleness 0)."""
        vec, _ = flatten_tree(params)
        with self._lock:
            head = np.copy(self._vec)
            base = self.version if base_version is None else base_version
        return self.push_delta(vec - head, base)

    def pull(self):
        _, vec = self.pull_flat()
        return unflatten_tree(vec, self._spec)

    def stats(self) -> dict:
        with self._lock:
            return {"version": self.version, "pushes": self.pushes,
                    "rejected": self.rejected, "fenced": self.fenced,
                    "pulls": self.pulls,
                    "staleness": dict(self.staleness_counts)}


# --------------------------------------------------------------------------
# hooks

class ParameterServerTrainingHook:
    """Callbacks around each worker's local update (the reference
    ParameterServerTrainingHook SPI)."""

    def pre_update(self, dataset, model) -> None:
        pass

    def post_update(self, dataset, model) -> None:
        pass


# --------------------------------------------------------------------------
# background pull

class _BackgroundPuller:
    """Fetch fresh ``(version, params)`` on a daemon thread while the worker
    computes. ``latest()`` does not block; ``request()`` forces a fetch at
    once; between requests the thread polls at ``poll_interval_s``,
    doubling the interval up to ``idle_backoff_cap_s`` while the version
    stands still."""

    def __init__(self, pull_fn: Callable[[], Tuple[int, np.ndarray]],
                 poll_interval_s: float = 0.05,
                 idle_backoff_cap_s: float = 0.8):
        self._pull = pull_fn
        self._interval = poll_interval_s
        self._idle_cap = max(poll_interval_s, idle_backoff_cap_s)
        self._buf: Optional[Tuple[int, np.ndarray]] = None
        self._lock = threading.Lock()
        self._wake = threading.Event()
        self._stop = False
        self.errors = 0
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self) -> None:
        wait = self._interval
        last_version = -1
        while True:
            requested = self._wake.wait(wait)
            self._wake.clear()
            if self._stop:
                return
            try:
                got = self._pull()
            except (OSError, RuntimeError) as e:
                # the transport closing under the worker's exit
                self.errors += 1
                global_recorder().record("ps_bg_pull_error", error=str(e))
                continue
            fresh = got[0] > last_version
            last_version = max(last_version, got[0])
            with self._lock:
                if self._buf is None or got[0] > self._buf[0]:
                    self._buf = got
            wait = (self._interval if requested or fresh
                    else min(wait * 2.0, self._idle_cap))

    def request(self) -> None:
        self._wake.set()

    def latest(self) -> Optional[Tuple[int, np.ndarray]]:
        with self._lock:
            buf, self._buf = self._buf, None
        return buf

    def stop(self) -> None:
        self._stop = True
        self._wake.set()
        self._thread.join(timeout=10)


# --------------------------------------------------------------------------
# worker loop (in-process threads and ``python -m ...ps_worker``)

def run_worker_loop(*, transport, replica, step_fn, next_batch,
                    push_frequency: int,
                    hooks: Sequence[ParameterServerTrainingHook] = (),
                    delay_s: float = 0.0, worker_id: int = 0,
                    background_pull: bool = True,
                    on_push: Optional[Callable[[bool], None]] = None) -> dict:
    """Train ``replica`` on batches from ``next_batch()`` (None: done),
    pushing a delta every ``push_frequency`` steps; returns the worker's
    stats.

    ``step_fn(replica, x, y)`` is the replica's train step
    (:func:`make_compiled_worker_step`); None falls back to
    ``replica.fit``. ``delay_s`` sleeps before every step
    (straggler fault injection). ``on_push(accepted)`` fires when a push
    window resolves (the elastic worker commits its broker offsets there).
    A fenced push raises :class:`StaleEpochFenced` at once."""
    version, base_vec = transport.pull()
    steps = pushes = rejected = rebased = 0
    steps_since_push = 0
    step_series = _worker_steps.labels(worker=str(worker_id))

    def _set_replica(vec: np.ndarray) -> None:
        unflatten_into(vec, replica.params_list)

    def _local() -> np.ndarray:
        return flatten_tree(replica.params_list)[0]

    _set_replica(base_vec)
    # the puller gets a connection of its own where the transport has
    # one to give (tcp), so its fetches overlap the pushes
    bg_transport = (transport.clone() if background_pull
                    and hasattr(transport, "clone") else transport)
    puller = (_BackgroundPuller(bg_transport.pull)
              if background_pull else None)
    if puller is not None:
        puller.request()

    def _push_window() -> None:
        # the window's push RPCs nest under one span parented on the
        # batch's consume span; with no parent a worker would only mint
        # root traces, so it opens none
        parent = current_span() or getattr(transport, "trace_parent", None)
        if parent is None:
            return _push_window_inner()
        with trace_span("ps.push_window", parent=parent,
                        worker=str(worker_id)):
            return _push_window_inner()

    def _push_window_inner() -> None:
        nonlocal version, base_vec, steps_since_push, pushes, rejected
        delta = _local() - base_vec
        # a delta does not depend on where it lands (the server applies
        # head + w * delta), so the freshest pulled version is this
        # window's honest base
        if puller is not None:
            got = puller.latest()
            if got is not None and got[0] > version:
                version = got[0]
        res = transport.push(delta, version)
        if res.fenced:
            raise StaleEpochFenced(
                f"worker {worker_id}: push fenced at version {res.version}")
        if not res.accepted:
            # rejected: rebase onto the returned state and push again
            rejected += 1
            res2 = transport.push(delta, res.version)
            if res2.fenced:
                raise StaleEpochFenced(
                    f"worker {worker_id}: push fenced at version "
                    f"{res2.version}")
            res = res2 if res2.accepted else res
        if res.accepted:
            pushes += 1
        version, base_vec = res.version, res.params
        _set_replica(base_vec)
        steps_since_push = 0
        if on_push is not None:
            on_push(res.accepted)
        if puller is not None:
            puller.request()

    try:
        while True:
            ds = next_batch()
            if ds is None:
                break
            if delay_s > 0.0:
                time.sleep(delay_s)
            # fold fresh global progress under the local window
            if puller is not None and steps_since_push > 0:
                got = puller.latest()
                if got is not None and got[0] > version:
                    local = _local()
                    version, fresh = got
                    _set_replica(fresh + (local - base_vec))
                    base_vec = fresh
                    rebased += 1
                    puller.request()
            for hook in hooks:
                hook.pre_update(ds, replica)
            if step_fn is not None:
                step_fn(replica, ds.features, ds.labels)
            else:
                replica.fit(ds.features, ds.labels)
            for hook in hooks:
                hook.post_update(ds, replica)
            steps += 1
            step_series.inc()
            steps_since_push += 1
            if steps_since_push >= push_frequency:
                _push_window()
        # flush only a partial window: re-pushing the last full window's
        # delta would count it twice
        if steps_since_push > 0:
            _push_window()
    finally:
        # the puller stops on every exit, fenced or crashed included
        if puller is not None:
            puller.stop()
            if bg_transport is not transport:
                bg_transport.close()
    return {"worker_id": worker_id, "steps": steps, "pushes": pushes,
            "rejected": rejected, "rebased": rebased,
            "final_version": version}


def _worker_step(replica, x, y):
    """One train step of the replica on its device: the network's own
    step (``_eager_step`` over ``make_train_step``, under the config's
    dtype policy), the iteration counted; the loss as a device scalar."""
    x, y = replica._to_device(x), replica._to_device(y)
    replica.last_batch_size = int(x.shape[0]) if x.ndim else 0
    loss = replica._eager_step([x], [y], replica.iteration)
    replica.score_value = loss
    replica.iteration += 1
    return loss


def make_compiled_worker_step(net) -> Optional[Callable]:
    """The worker step of a ``MultiLayerNetwork``; None for other models,
    whose workers fall back to ``replica.fit``."""
    from ..nn.multilayer import MultiLayerNetwork
    return _worker_step if isinstance(net, MultiLayerNetwork) else None


def worker_command(module: str, args: list) -> list:
    return [sys.executable, "-m", module] + [str(a) for a in args]


def worker_env() -> dict:
    """A worker process's environment: this one's, with the checkout on
    PYTHONPATH."""
    env = os.environ.copy()
    env["PYTHONPATH"] = _REPO_ROOT + os.pathsep + env.get("PYTHONPATH", "")
    return env


# --------------------------------------------------------------------------
# wrapper

class ParameterServerParallelWrapper:
    """Async data-parallel trainer (reference
    ParameterServerParallelWrapper)."""

    def __init__(self, model, workers: int = 2, push_frequency: int = 4,
                 prefetch: int = 2,
                 training_hooks: Optional[List[ParameterServerTrainingHook]] = None,
                 staleness: int = DEFAULT_STALENESS_CAP,
                 compression: str = "none",
                 transport: str = "inproc",
                 server_optimizer: str = "sgd", server_lr: float = 1.0,
                 worker_delays: Optional[Sequence[float]] = None):
        if transport not in ("inproc", "tcp", "shm"):
            raise ValueError(f"unknown transport {transport!r}; "
                             "expected 'inproc', 'tcp' or 'shm'")
        if compression not in ("none", "bf16"):
            raise ValueError(f"unknown compression {compression!r}; "
                             "expected 'none' or 'bf16'")
        if transport in ("tcp", "shm") and training_hooks:
            raise ValueError(
                "training hooks run in the worker's interpreter; the tcp "
                "transport trains in separate processes — use inproc")
        self.model = model
        self.workers = workers
        self.push_frequency = max(1, push_frequency)
        self.prefetch = prefetch
        self.training_hooks = list(training_hooks or [])
        self.staleness = int(staleness)
        self.compression = compression
        self.transport = transport
        self.server_optimizer = server_optimizer
        self.server_lr = server_lr
        self.worker_delays = list(worker_delays or [])
        self.worker_stats: List[dict] = []
        #: how each worker process got its shard: "shm" or "npz"
        self.shard_routes: List[str] = []
        self.server: Optional[ParameterServer] = None

    class Builder:
        def __init__(self, model):
            self._model = model
            self._kw = {}

        def workers(self, n: int):
            self._kw["workers"] = n
            return self

        def push_frequency(self, n: int):
            self._kw["push_frequency"] = n
            return self

        def training_hooks(self, *hooks):
            self._kw["training_hooks"] = list(hooks)
            return self

        def staleness(self, cap: int):
            """Hard staleness bound: pushes based more than ``cap`` versions
            behind are rejected (the weight already decays as 1/(1+s))."""
            self._kw["staleness"] = cap
            return self

        def compression(self, codec: str):
            """Wire codec of pushed deltas: "bf16" halves push bytes."""
            self._kw["compression"] = codec
            return self

        def transport(self, kind: str):
            """"inproc" (worker threads), "tcp" (worker processes over
            loopback sockets) or "shm" (worker processes; tensor bytes in
            shared-memory rings, control verbs on the socket; tcp frames
            when the segments cannot attach)."""
            self._kw["transport"] = kind
            return self

        def server_optimizer(self, kind: str, lr: float = 1.0):
            self._kw["server_optimizer"] = kind
            self._kw["server_lr"] = lr
            return self

        def worker_delays(self, *delays: float):
            """Fault injection: worker i sleeps delays[i] seconds before
            every step (the straggler model)."""
            self._kw["worker_delays"] = list(delays)
            return self

        def build(self) -> "ParameterServerParallelWrapper":
            return ParameterServerParallelWrapper(self._model, **self._kw)

    @staticmethod
    def builder(model) -> "ParameterServerParallelWrapper.Builder":
        return ParameterServerParallelWrapper.Builder(model)

    # ------------------------------------------------------------------ fit
    @dump_on_unhandled("ParameterServerParallelWrapper.fit")
    def fit(self, iterator, epochs: int = 1) -> None:
        self.server = ParameterServer(
            self.model.params_list, staleness_cap=self.staleness,
            optimizer=self.server_optimizer, server_lr=self.server_lr)
        if self.transport in ("tcp", "shm"):
            self._fit_processes(iterator, epochs)
        else:
            self._fit_inproc(iterator, epochs)
        unflatten_into(self.server.pull_flat()[1], self.model.params_list)

    def stats(self) -> dict:
        """The server's counters and each worker's stats."""
        return {"server": self.server.stats() if self.server else None,
                "workers": list(self.worker_stats),
                "shard_routes": list(self.shard_routes)}

    def _delay(self, worker_id: int) -> float:
        if worker_id < len(self.worker_delays):
            return float(self.worker_delays[worker_id])
        return 0.0

    def _fit_inproc(self, iterator, epochs: int) -> None:
        import queue as _queue

        from .ps_transport import InprocTransport

        model = self.model
        server = self.server
        step = make_compiled_worker_step(model)
        q: _queue.Queue = _queue.Queue(maxsize=self.workers * max(
            1, self.prefetch))
        failed: List[BaseException] = []
        self.worker_stats = [None] * self.workers

        def make_worker(worker_id: int):
            def run():
                replica = model.clone() if hasattr(model, "clone") else model

                def next_batch():
                    ds = q.get()
                    q.task_done()
                    return ds

                try:
                    self.worker_stats[worker_id] = run_worker_loop(
                        transport=InprocTransport(server), replica=replica,
                        step_fn=step, next_batch=next_batch,
                        push_frequency=self.push_frequency,
                        hooks=self.training_hooks,
                        delay_s=self._delay(worker_id),
                        worker_id=worker_id)
                except BaseException as e:
                    failed.append(e)
                    global_recorder().record(
                        "ps_worker_crash", worker=worker_id, error=repr(e))
                    raise
            return threading.Thread(target=run, daemon=True,
                                    name=f"ps-worker-{worker_id}")

        threads = [make_worker(i) for i in range(self.workers)]
        for t in threads:
            t.start()
        for _ in range(epochs):
            if hasattr(iterator, "reset"):
                iterator.reset()
            for ds in iterator:
                while not failed:
                    try:
                        q.put(ds, timeout=1.0)
                        break
                    except _queue.Full:
                        continue
                if failed:
                    break
        deadline = time.monotonic() + WORKER_TIMEOUT_S
        for _ in threads:
            while not failed:
                try:
                    q.put(None, timeout=1.0)
                    break
                except _queue.Full:
                    if time.monotonic() > deadline:
                        break
        for t in threads:
            t.join(timeout=max(0.0, deadline - time.monotonic()))
        if failed:
            raise RuntimeError("parameter-server worker crashed") from failed[0]
        if any(t.is_alive() for t in threads):
            raise RuntimeError(f"parameter-server workers still running after "
                               f"{WORKER_TIMEOUT_S:.0f}s")

    def _fit_processes(self, iterator, epochs: int) -> None:
        """Worker processes over loopback TCP: the iterator's batches are
        materialized, split round robin and shipped to each worker, through
        a shared-memory segment on the "shm" transport (an .npz where no
        segment can be made: ``shard_routes`` says which), as an .npz
        otherwise. The config rides as JSON; each worker runs on this
        model's device and pulls the initial params from this process's
        server."""
        from . import ps_transport as _pst

        batches = []
        for _ in range(epochs):
            if hasattr(iterator, "reset"):
                iterator.reset()
            batches.extend(iterator)
        shards = [batches[i::self.workers] for i in range(self.workers)]

        frontend = _pst.ParameterServerTcpFrontend(self.server).start()
        procs = []
        segments: List[str] = []
        self.shard_routes = []
        try:
            with tempfile.TemporaryDirectory(prefix="dl4j_ps_") as tmp:
                conf_path = os.path.join(tmp, "conf.json")
                with open(conf_path, "w") as f:
                    f.write(self.model.conf.to_json())
                env = worker_env()
                for i, shard in enumerate(shards):
                    x = np.stack([_host(d.features) for d in shard])
                    y = np.stack([_host(d.labels) for d in shard])
                    data_path = None
                    if self.transport == "shm":
                        try:
                            seg = _pst.write_shard_segment(
                                {"x": x, "y": y}, kind=f"shard{i}")
                            segments.append(seg)
                            data_path = "shm://" + seg
                        except OSError:
                            data_path = None  # an .npz instead
                    self.shard_routes.append("shm" if data_path else "npz")
                    if data_path is None:
                        data_path = os.path.join(tmp, f"worker{i}.npz")
                        np.savez(data_path, x=x, y=y)
                    cmd = worker_command(
                        "deeplearning4j_tpu_torch.parallel.ps_worker",
                        ["--addr", f"127.0.0.1:{frontend.port}",
                         "--conf", conf_path, "--data", data_path,
                         "--worker-id", i,
                         "--push-frequency", self.push_frequency,
                         "--codec", self.compression,
                         "--ps-transport", self.transport,
                         "--delay", self._delay(i),
                         "--device", str(self.model.device)])
                    procs.append(subprocess.Popen(
                        cmd, env=env, stdout=subprocess.PIPE,
                        stderr=subprocess.PIPE, text=True))
                self.worker_stats = []
                deadline = time.monotonic() + WORKER_TIMEOUT_S
                for i, p in enumerate(procs):
                    stdout, stderr = p.communicate(
                        timeout=max(1.0, deadline - time.monotonic()))
                    if p.returncode != 0:
                        raise RuntimeError(
                            f"tcp PS worker {i} failed (rc={p.returncode}):\n"
                            + stderr[-2000:])
                    self.worker_stats.append(
                        json.loads(stdout.strip().splitlines()[-1]))
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait(timeout=30)
            frontend.stop()
            for seg in segments:
                _pst.release_segment_by_name(seg)


def _host(a) -> np.ndarray:
    return host_numpy(a) if isinstance(a, torch.Tensor) else np.asarray(a)
