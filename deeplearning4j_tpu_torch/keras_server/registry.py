"""Model registry: versioned serving models with an atomic active pointer.

Counterpart of ``deeplearning4j_tpu/keras_server/registry.py``. A registry
maps ``name -> {version -> ModelVersion}``; each version pins a
:class:`~deeplearning4j_tpu_torch.nn.inference.PredictFn` over a parameter
snapshot, built before the active pointer moves, so a hot swap is a dict
assignment under the lock and in-flight requests finish on the version they
resolved. Models register from in-memory networks; loading files, drafts
and warmup are not part of this port yet (ROADMAP.md).
"""
from __future__ import annotations

import threading
from typing import Dict, Optional

from ..nn.inference import PredictFn


class ModelVersion:
    """One immutable (name, version) serving unit."""

    def __init__(self, name: str, version: str, net, predict_fn: PredictFn):
        self.name = name
        self.version = version
        self.net = net
        self.predict_fn = predict_fn
        #: serving dtype policy of this version (None, or "int8")
        self.quant = predict_fn.quant
        #: whether /v1/stream can serve it (the rnn_time_step seam)
        self.streaming_capable = hasattr(net, "rnn_time_step")

    def describe(self) -> dict:
        return {"name": self.name, "version": self.version,
                "quant": self.quant,
                "streaming_capable": self.streaming_capable,
                "device": str(self.predict_fn.device),
                "param_bytes": self.predict_fn.param_bytes,
                "predict_calls": self.predict_fn.calls}


class ModelRegistry:
    """Thread-safe versioned model store."""

    def __init__(self):
        self._lock = threading.RLock()
        self._versions: Dict[str, Dict[str, ModelVersion]] = {}
        self._active: Dict[str, str] = {}

    def register(self, name: str, net, version: Optional[str] = None,
                 quant: Optional[str] = None, device=None) -> ModelVersion:
        """Pin ``net`` on ``device`` (``None`` means CUDA) and make it the
        active version. ``quant="int8"`` keeps int8 weights at rest for the
        predict path and for this version's decode engines."""
        with self._lock:
            version = version or f"v{len(self._versions.get(name, {})) + 1}"
            if version in self._versions.get(name, {}):
                raise ValueError(
                    f"model {name!r} already has version {version!r}; "
                    "versions are immutable - register a new one")
        pf = PredictFn(net, quant=quant, device=device)
        with self._lock:
            mv = ModelVersion(name, version, net, pf)
            self._versions.setdefault(name, {})[version] = mv
            self._active[name] = version
        return mv

    def active(self, name: str) -> ModelVersion:
        with self._lock:
            try:
                return self._versions[name][self._active[name]]
            except KeyError:
                raise KeyError(
                    f"no model {name!r} in registry "
                    f"(loaded: {sorted(self._versions)})") from None

    def status(self) -> dict:
        with self._lock:
            return {"models": {
                name: {"active": self._active[name],
                       "versions": {v: mv.describe()
                                    for v, mv in sorted(versions.items())}}
                for name, versions in sorted(self._versions.items())}}
