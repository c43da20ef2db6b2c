"""Streaming timestep inference over the ``rnn_time_step`` seam.

Counterpart of ``deeplearning4j_tpu/keras_server/streaming.py``. Server-side
sessions over ``rnn_time_step`` and ``rnn_get/set_previous_state``:

- one streaming clone per (model, version), on the server's device, so
  streaming state never touches the registry's pinned predict snapshot, and
  shared by every session of that version;
- each session's state is parked between calls and swapped into the clone
  under the model's lock for each step;
- sessions idle past ``ttl_s`` are evicted on the next touch; eviction and
  ``reset`` release the parked state: the clone's live ``_rnn_state`` is
  un-aliased first (the most recently stepped session's parked state *is*
  that attribute), then the state's tensors are dropped, so the caching
  allocator can reuse their device memory at once.

The JAX package's metrics (sessions, steps, evictions) belong to its
observability plane, which is not ported yet (ROADMAP.md).
"""
from __future__ import annotations

import threading
import time
from typing import Dict, Tuple

import numpy as np

from ..common import resolve_device
from .registry import ModelRegistry


class _StreamModel:
    """The shared streaming clone and its per-session parked states."""

    def __init__(self, net, device):
        self.net = net.clone(device=device)
        self.lock = threading.Lock()
        #: session id -> (parked rnn state, last-touch monotonic time)
        self.states: Dict[str, Tuple[list, float]] = {}


class StreamSessions:
    """Server-side ``rnn_time_step`` sessions with TTL eviction, on
    ``device`` (``None`` means CUDA)."""

    def __init__(self, registry: ModelRegistry, ttl_s: float = 300.0,
                 device=None):
        self.registry = registry
        self.ttl_s = float(ttl_s)
        self.device = resolve_device(device)
        self._lock = threading.Lock()
        self._models: Dict[Tuple[str, str], _StreamModel] = {}

    def _model(self, name: str) -> Tuple[_StreamModel, str]:
        mv = self.registry.active(name)
        if not mv.streaming_capable:
            raise ValueError(f"model {name!r} has no rnn_time_step seam")
        key = (mv.name, mv.version)
        with self._lock:
            sm = self._models.get(key)
            if sm is None:
                sm = self._models[key] = _StreamModel(mv.net, self.device)
            # a hot swap moved the active pointer: drop this model's stale
            # clones once they park no sessions (new steps resolve the active
            # version, so an empty stale clone can never refill)
            for (n0, v0), old in list(self._models.items()):
                if n0 == mv.name and v0 != mv.version and not old.states:
                    del self._models[(n0, v0)]
            return sm, mv.version

    @staticmethod
    def _release_state(sm: _StreamModel, state) -> None:
        """Free a parked state (caller holds ``sm.lock``): un-alias the
        clone's live state first, then drop every tensor."""
        if sm.net.rnn_get_previous_state() is state:
            sm.net.rnn_clear_previous_state()
        for layer_state in state or ():
            layer_state.clear()

    def _evict_expired(self, sm: _StreamModel, now: float) -> None:
        for sid, (state, t) in list(sm.states.items()):
            if now - t > self.ttl_s:
                del sm.states[sid]
                self._release_state(sm, state)

    def step(self, model: str, session: str, x) -> dict:
        """Advance one session by the timesteps of ``x`` (``[B, T, F]``, or
        ``[B, F]`` as T = 1) and return the outputs of those steps (numpy)
        with the model version serving the session. The state persists
        server-side under ``session``."""
        x = np.asarray(x, dtype=np.float32)
        if x.ndim == 2:
            x = x[:, None, :]
        if x.ndim != 3:
            raise ValueError(
                f"streaming input must be [B,T,F] or [B,F], got {x.shape}")
        sm, version = self._model(model)
        with sm.lock:
            now = time.monotonic()
            self._evict_expired(sm, now)
            parked = sm.states.get(session)
            sm.net.rnn_set_previous_state(
                parked[0] if parked is not None else None)
            out = sm.net.rnn_time_step(x).cpu().numpy()
            sm.states[session] = (sm.net.rnn_get_previous_state(), now)
        return {"output": out, "model": model, "version": version,
                "session": session, "timesteps": int(x.shape[1])}

    def reset(self, model: str, session: str) -> bool:
        """Drop a session's parked state (True if it existed)."""
        try:
            sm, _ = self._model(model)
        except KeyError:
            return False
        with sm.lock:
            parked = sm.states.pop(session, None)
            if parked is not None:
                self._release_state(sm, parked[0])
        return parked is not None

    def status(self) -> dict:
        """``{"<model>@<version>": [session ids]}``."""
        with self._lock:
            return {f"{name}@{version}": sorted(sm.states)
                    for (name, version), sm in sorted(self._models.items())}
