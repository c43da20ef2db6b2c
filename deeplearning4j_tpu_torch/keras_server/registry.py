"""Model registry: versioned serving models with an atomic active pointer.

Counterpart of ``deeplearning4j_tpu/keras_server/registry.py``. A registry
maps ``name -> {version -> ModelVersion}``; each version pins a
:class:`~deeplearning4j_tpu_torch.nn.inference.PredictFn` over a parameter
snapshot, built before the active pointer moves, so a hot swap is a dict
assignment under the lock and in-flight requests finish on the version they
resolved; :meth:`ModelRegistry.set_active` moves the pointer back to an
older version (the rollback). Models register from in-memory networks (a
``MultiLayerNetwork`` or a ``ComputationGraph``) or load from
``model_serializer`` zips (either network type, through ``guess_model``)
or Keras HDF5 exports (``modelimport/keras_import.py``). A model may be
linked as the speculative-decode draft of another (:meth:`link_draft`):
the draft is an ordinary registered model, so a hot swap of it retires the
target's decode engines as a swap of the target does.

``warmup_max_batch`` opts registration into warmup: before the active
pointer moves, the new version's ``PredictFn`` runs one forward at every
micro-batch bucket up to that cap (:meth:`ModelRegistry.warmup_buckets`),
so the kernels are built and cuDNN and cuBLAS have chosen their algorithms
before the first request. The example comes from ``warmup_example`` or, for
a stack whose first layer is a feed-forward one, from its ``n_in``; a graph
or any other first layer is warmed only with an explicit example, as in
the JAX package. Warmup is an optimization, never a correctness gate: a
bucket whose forward fails (an explicit example the network rejects, or an
example derived from an ``n_in`` it does not take: an embedding's ``n_in``
is its vocabulary) is logged and skipped, and the version goes active all
the same, as the JAX package's ``warm_parallel`` does. Each registration
that warms observes the whole pass in ``dl4j_warmup_seconds{site="registry"}``
and keeps it in ``last_warmup_s``. A registration is the trace span
``registry.register`` (``model``, ``version``, ``warmup``, ``hot_swap``).

The model versions held (``dl4j_serve_models_loaded``) and the hot swaps by
model (``dl4j_serve_hot_swaps_total``: a registration over an active
version, or a rollback that moves the pointer) go to the metrics registry
(``metrics``, the global one by default).
"""
from __future__ import annotations

import logging
import threading
import time
import zipfile
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional

import numpy as np

from ..nn.conf.serde import layer_class
from ..nn.inference import PredictFn, make_predict_fn
from ..observability import names as _n
from ..observability.metrics import global_registry
from ..observability.tracing import trace_span

log = logging.getLogger(__name__)


def load_model_file(path: str, device=None):
    """The network a serving model file holds, on ``device``: a
    ``model_serializer`` zip of either network type, or a Keras HDF5
    export (a Sequential archive first, then a functional one, as the JAX
    package tries them)."""
    if zipfile.is_zipfile(path):
        from ..utils.model_serializer import guess_model
        return guess_model(path, device=device)
    from ..modelimport.keras_import import KerasModelImport
    try:
        return KerasModelImport.import_keras_sequential_model_and_weights(
            path, device=device)
    except ValueError:
        return KerasModelImport.import_keras_model_and_weights(
            path, device=device)


def _derive_warmup_example(net) -> Optional[np.ndarray]:
    """``(1, n_in)`` float32 zeros for a stack whose first layer is a
    feed-forward one; None (no warmup) for a graph or any other first
    layer, whose input layout ``n_in`` does not give."""
    if type(net).__name__ == "ComputationGraph":
        return None
    layers = getattr(getattr(net, "conf", None), "layers", None)
    if not layers:
        return None
    first = layers[0]
    if layer_class(first.type).__module__.rsplit(".", 1)[-1] != "feedforward":
        return None
    n_in = first.get("n_in")
    if not n_in:
        return None
    return np.zeros((1, int(n_in)), np.float32)


class ModelVersion:
    """One immutable (name, version) serving unit."""

    def __init__(self, name: str, version: str, net, predict_fn: PredictFn,
                 source: str = "memory"):
        self.name = name
        self.version = version
        self.net = net
        self.predict_fn = predict_fn
        #: "memory", or the file the version was loaded from
        self.source = source
        #: serving dtype policy of this version (None, or "int8"; "bf16"
        #: serves at the network's policy dtype and is stored as None)
        self.quant = predict_fn.quant
        #: whether /v1/stream can serve it (the rnn_time_step seam)
        self.streaming_capable = hasattr(net, "rnn_time_step")

    def describe(self) -> dict:
        return {"name": self.name, "version": self.version,
                "source": self.source, "quant": self.quant,
                "streaming_capable": self.streaming_capable,
                "device": str(self.predict_fn.device),
                "sharding": self.predict_fn.sharding,
                "devices": self.predict_fn.devices(),
                "param_bytes": self.predict_fn.param_bytes,
                "predict_calls": self.predict_fn.calls,
                "warmed_buckets": list(self.predict_fn.warmed)}


class ModelRegistry:
    """Thread-safe versioned model store. ``warmup_max_batch`` (None: off)
    opts every registration into bucket warmup on ``warmup_workers``
    threads."""

    def __init__(self, metrics=None, warmup_max_batch: Optional[int] = None,
                 warmup_workers: int = 4):
        self._lock = threading.RLock()
        self._versions: Dict[str, Dict[str, ModelVersion]] = {}
        self._active: Dict[str, str] = {}
        #: target model name -> draft model name (speculative decoding)
        self._drafts: Dict[str, str] = {}
        self.warmup_max_batch = warmup_max_batch
        self.warmup_workers = warmup_workers
        #: seconds the last registration's warmup took (None: no warmup ran)
        self.last_warmup_s: Optional[float] = None
        self.metrics = metrics or global_registry()
        self._g_models = self.metrics.gauge(
            _n.SERVE_MODELS_LOADED, "model versions held by the registry")
        self._c_swaps = self.metrics.counter(
            _n.SERVE_HOT_SWAPS_TOTAL, "active-version hot swaps")
        self._h_warmup = self.metrics.histogram(
            _n.WARMUP_SECONDS,
            "wall time of one warmup pass (all buckets)").labels(
                site="registry")

    def register(self, name: str, net, version: Optional[str] = None,
                 quant: Optional[str] = None, device=None,
                 source: str = "memory", warmup_example=None,
                 replica: Optional[int] = None, sharding=None, mesh=None,
                 draft_for: Optional[str] = None) -> ModelVersion:
        """Pin ``net`` on ``device`` (``None`` means CUDA), warm it when the
        registry warms, and make it the active version. ``quant="int8"``
        keeps int8 weights at rest for the predict path and for this
        version's decode engines. ``warmup_example`` is one input batch (an
        array, or a tuple of arrays) whose row shape warmup uses.
        ``sharding`` and ``mesh`` pin it sharded over a device mesh
        instead (``nn/inference.py``; a ``ReplicaSet`` passes each
        replica's). ``replica`` decorates the pin's name (a ``ReplicaSet``
        member's);
        ``draft_for`` also links this model as the speculative-decode draft
        of the named target (:meth:`link_draft`)."""
        with self._lock:
            version = version or f"v{len(self._versions.get(name, {})) + 1}"
            if version in self._versions.get(name, {}):
                raise ValueError(
                    f"model {name!r} already has version {version!r}; "
                    "versions are immutable - register a new one")
        with trace_span("registry.register", model=name, version=version,
                        warmup=bool(self.warmup_max_batch)) as rsp:
            pf = make_predict_fn(net, version=version, quant=quant,
                                 device=device, replica=replica,
                                 sharding=sharding, mesh=mesh)
            if self.warmup_max_batch:
                # off the serving path: an older version keeps serving
                self._warmup(pf, net, warmup_example)
            with self._lock:
                swapping = name in self._active
                mv = ModelVersion(name, version, net, pf, source=source)
                self._versions.setdefault(name, {})[version] = mv
                self._active[name] = version
                self._g_models.set(
                    sum(len(v) for v in self._versions.values()))
                if swapping:
                    self._c_swaps.labels(model=name).inc()
            rsp.set_attr(hot_swap=swapping)
        if draft_for is not None:
            self.link_draft(draft_for, name)
        return mv

    # ------------------------------------------------- speculative drafts
    def link_draft(self, name: str, draft_name: str) -> None:
        """Name ``draft_name`` as the speculative-decode draft of ``name``.
        The draft's active version resolves per decode engine."""
        with self._lock:
            if draft_name not in self._versions:
                raise KeyError(
                    f"draft model {draft_name!r} is not registered "
                    f"(loaded: {sorted(self._versions)})")
            if draft_name == name:
                raise ValueError(
                    f"model {name!r} cannot be its own spec-decode draft")
            self._drafts[name] = draft_name

    def draft_of(self, name: str) -> Optional[str]:
        """The linked draft model name of ``name``, or None."""
        with self._lock:
            return self._drafts.get(name)

    @staticmethod
    def warmup_buckets(max_batch: int) -> List[int]:
        """The micro-batcher's bucket ladder: powers of two below
        ``max_batch``, then ``max_batch``."""
        buckets, b = [], 1
        while b < max_batch:
            buckets.append(b)
            b *= 2
        buckets.append(max_batch)
        return buckets

    def _warmup(self, pf: PredictFn, net, example=None) -> None:
        """One forward of ``pf`` at every bucket size, with zeros of the
        example's row shape and dtype, on the warmup pool; skipped when no
        example is given or derivable. A bucket that fails is logged and
        the others go on (JAX ``compile_cache.warm_parallel``)."""
        if example is None:
            example = _derive_warmup_example(net)
            if example is None:
                return
        examples = [np.asarray(e) for e in
                    (example if isinstance(example, (tuple, list))
                     else (example,))]

        def one(b):
            pf.warm(*[np.zeros((b,) + e.shape[1:], e.dtype)
                      for e in examples])

        buckets = self.warmup_buckets(self.warmup_max_batch)
        failed = {}
        t0 = time.perf_counter()
        with ThreadPoolExecutor(
                max_workers=max(1, min(self.warmup_workers, len(buckets))),
                thread_name_prefix="dl4j-warmup") as ex:
            for b, fut in [(b, ex.submit(one, b)) for b in buckets]:
                try:
                    fut.result()
                except Exception as e:
                    failed[b] = e
        if failed:
            log.warning("warmup of %s failed at buckets %s: %r",
                        type(net).__name__, sorted(failed),
                        next(iter(failed.values())))
        self.last_warmup_s = time.perf_counter() - t0
        self._h_warmup.observe(self.last_warmup_s)

    def load(self, name: str, path: str, version: Optional[str] = None,
             quant: Optional[str] = None, device=None,
             warmup_example=None) -> ModelVersion:
        """Load a model file (a zip or a Keras HDF5 archive, see
        :func:`load_model_file`) on ``device`` and register it."""
        return self.register(name, load_model_file(path, device=device),
                             version=version, quant=quant, device=device,
                             source=path, warmup_example=warmup_example)

    def active(self, name: str) -> ModelVersion:
        with self._lock:
            try:
                return self._versions[name][self._active[name]]
            except KeyError:
                raise KeyError(
                    f"no model {name!r} in registry "
                    f"(loaded: {sorted(self._versions)})") from None

    def get(self, name: str, version: str) -> ModelVersion:
        with self._lock:
            return self._versions[name][version]

    def set_active(self, name: str, version: str) -> ModelVersion:
        """Point ``name`` at an already-registered version (the rollback)."""
        with self._lock:
            mv = self._versions[name][version]  # KeyError: no such version
            if self._active[name] != version:
                self._active[name] = version
                self._c_swaps.labels(model=name).inc()
            return mv

    def names(self) -> List[str]:
        with self._lock:
            return sorted(self._versions)

    def status(self) -> dict:
        with self._lock:
            return {"models": {
                name: {"active": self._active[name],
                       "versions": {v: mv.describe()
                                    for v, mv in sorted(versions.items())}}
                for name, versions in sorted(self._versions.items())},
                "drafts": dict(sorted(self._drafts.items()))}


_GLOBAL: Optional[ModelRegistry] = None
_GLOBAL_LOCK = threading.Lock()


def global_model_registry() -> ModelRegistry:
    """The process-wide registry, made at first use."""
    global _GLOBAL
    with _GLOBAL_LOCK:
        if _GLOBAL is None:
            _GLOBAL = ModelRegistry()
        return _GLOBAL


def set_global_model_registry(
        registry: Optional[ModelRegistry]) -> Optional[ModelRegistry]:
    """Swap the process-wide registry; returns the previous one."""
    global _GLOBAL
    with _GLOBAL_LOCK:
        prev, _GLOBAL = _GLOBAL, registry
        return prev
