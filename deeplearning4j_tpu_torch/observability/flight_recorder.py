"""Flight recorder: a bounded in-memory event log with crash-time egress.

Counterpart of ``deeplearning4j_tpu/observability/flight_recorder.py``.
The metrics registry says what X is now; the recorder says what the
training loop was doing before it died. Every fit path appends cheap,
structured step events (step index, dispatch wall time, batch size, K-step
group size) to a process-global ring; the health monitor and the watchdog
append alarms, the parameter server, the elastic trainer and the broker
their membership and fault events. When something goes wrong (an exception
escapes a fit loop, a health alarm fires, the watchdog sees a stall, an
operator sends SIGUSR1), ``dump()`` writes a self-contained bundle.

Design constraints:

* **Hot-path cost.** ``record()`` is one dict build and a locked deque
  append: no registry traffic, no device work, no I/O. Fit loops record once
  a dispatch (once a K-step group). Events carry host values only (ints,
  floats, strings): a CUDA tensor in an event would make ``dump()`` wait on
  the card, which a dump during a hang must never do.
* **A dump never touches the card.** The bundle comes from host state: the
  ring, the registry's snapshot, the captured step graphs' records and the
  kernels' launch counts, and ``sys._current_frames()``. The card is
  described only when CUDA was initialized already (its name and the
  allocator's statistics, which are host counters); a dump never
  initializes CUDA and never synchronizes, so it finishes during a hung
  kernel and from a signal handler.
* **Kill switch.** ``set_enabled(False)`` turns ``record()`` into a no-op;
  ``dump()`` still writes whatever was recorded.
"""
from __future__ import annotations

import functools
import json
import logging
import os
import platform
import re
import signal
import sys
import threading
import time
import traceback
from collections import deque
from typing import Any, Dict, List, Optional

from .metrics import global_registry
from .names import FLIGHT_DUMPS_TOTAL

log = logging.getLogger(__name__)

#: default ring capacity: at one event a K-step dispatch, hours of training
#: for a few hundred KB of host memory
DEFAULT_CAPACITY = 4096

#: environment variable naming the default dump directory
DUMP_DIR_ENV = "DL4J_FLIGHT_RECORDER_DIR"

#: environment variables snapshotted into the bundle (prefix match)
_ENV_PREFIXES = ("CUDA_", "TORCH_", "NCCL_", "DL4J_", "PYTORCH_")

#: the files every bundle holds, so consumers can rely on the set
BUNDLE_FILES = ("events.jsonl", "metrics.json", "environment.json",
                "threads.txt", "cost_analysis.json", "manifest.json")


def _slug(text: str, max_len: int = 48) -> str:
    return re.sub(r"[^A-Za-z0-9_.-]+", "-", str(text)).strip("-")[:max_len] \
        or "dump"


def thread_stacks() -> str:
    """Every thread's Python stack from ``sys._current_frames()``: where
    each one is stuck (the bundle's ``threads.txt``, and what the watchdog
    logs on a stall)."""
    names = {t.ident: t.name for t in threading.enumerate()}
    lines: List[str] = []
    for ident, frame in sorted(sys._current_frames().items()):
        lines.append(f"--- thread {names.get(ident, '<unknown>')} "
                     f"(ident {ident}) ---")
        lines.extend(s.rstrip("\n") for s in traceback.format_stack(frame))
        lines.append("")
    return "\n".join(lines) + "\n"


def _cuda_devices() -> Optional[list]:
    """The cards of a process that initialized CUDA already (names, memory
    and the allocator's counters, all host reads), else None. Never
    initializes CUDA and never synchronizes."""
    torch = sys.modules.get("torch")
    if torch is None or not torch.cuda.is_initialized():
        return None
    devices = []
    for i in range(torch.cuda.device_count()):
        props = torch.cuda.get_device_properties(i)
        devices.append({
            "index": i, "name": props.name,
            "total_memory": props.total_memory,
            "capability": f"{props.major}.{props.minor}",
            "memory_allocated": torch.cuda.memory_allocated(i),
            "memory_reserved": torch.cuda.memory_reserved(i),
            "max_memory_allocated": torch.cuda.max_memory_allocated(i)})
    return devices


def collect_environment() -> dict:
    """The host, and the cards when CUDA is up already, for the bundle."""
    info: Dict[str, Any] = {
        "time": time.time(),
        "pid": os.getpid(),
        "argv": list(sys.argv),
        "cwd": os.getcwd(),
        "python": sys.version,
        "platform": platform.platform(),
        "env": {k: v for k, v in sorted(os.environ.items())
                if k.startswith(_ENV_PREFIXES)},
    }
    torch = sys.modules.get("torch")
    if torch is not None:
        info["torch_version"] = torch.__version__
        info["cuda_version"] = torch.version.cuda
    try:
        devices = _cuda_devices()
    except RuntimeError as e:  # CUDA up but unhealthy: say so
        info["devices_error"] = repr(e)
    else:
        if devices is not None:
            info["backend"] = "cuda"
            info["device_count"] = len(devices)
            info["devices"] = devices
    common = sys.modules.get("deeplearning4j_tpu_torch.common")
    if common is not None:
        info["dtype_policy"] = repr(common.policy_key())
    return info


def _cost_analysis() -> dict:
    """What the port knows of its compiled work without compiling anything:
    the live captured train steps (launches a replay by kernel, replays,
    the memory pool each capture grew) and every kernel wrapper's launch
    count. Read from modules already imported only."""
    out: Dict[str, Any] = {}
    ksteps = sys.modules.get("deeplearning4j_tpu_torch.nn.ksteps")
    if ksteps is not None:
        out["step_graphs"] = [sg.describe() for sg in ksteps.live_graphs()]
    cuda = sys.modules.get("deeplearning4j_tpu_torch.ops._cuda")
    if cuda is not None:
        out["launches"] = {fn.__name__: n
                           for fn, n in cuda.launch_counts().items()}
    return out


def _jsonable(obj):
    try:
        json.dumps(obj)
        return obj
    except (TypeError, ValueError):
        return repr(obj)


class FlightRecorder:
    """Thread-safe ring of structured events with a ``dump()`` that writes a
    self-contained diagnostic bundle. One process-global instance
    (:func:`global_recorder`) serves the fit loops and the alarm paths;
    tests make private ones."""

    def __init__(self, capacity: int = DEFAULT_CAPACITY,
                 dump_dir: Optional[str] = None, registry=None):
        self._lock = threading.Lock()
        self._events: deque = deque(maxlen=max(1, int(capacity)))
        self._enabled = True
        self._dropped = 0
        self._dump_seq = 0
        self._registry = registry
        self.dump_dir = dump_dir if dump_dir is not None \
            else os.environ.get(DUMP_DIR_ENV) or None

    # -------------------------------------------------------------- control
    @property
    def capacity(self) -> int:
        return self._events.maxlen

    def set_enabled(self, flag: bool) -> None:
        """Kill switch: False turns every ``record()`` into a no-op (dump
        still works)."""
        self._enabled = bool(flag)

    @property
    def enabled(self) -> bool:
        return self._enabled

    def set_dump_dir(self, path: Optional[str]) -> None:
        """Where automatic dumps land; None turns them off (an explicit
        ``dump(dir=...)`` still writes)."""
        self.dump_dir = path

    def clear(self) -> None:
        with self._lock:
            self._events.clear()
            self._dropped = 0

    def __len__(self) -> int:
        with self._lock:
            return len(self._events)

    # ------------------------------------------------------------ recording
    def record(self, kind: str, **fields) -> None:
        """Append one event of host values (never a tensor)."""
        if not self._enabled:
            return
        event = {"kind": kind, "ts": time.time(), **fields}
        with self._lock:
            if len(self._events) == self._events.maxlen:
                self._dropped += 1
            self._events.append(event)

    def snapshot(self) -> List[dict]:
        with self._lock:
            return list(self._events)

    @property
    def dropped(self) -> int:
        """Events the ring evicted since the last ``clear()``."""
        return self._dropped

    # ---------------------------------------------------------------- dump
    def _registry_or_global(self):
        return self._registry if self._registry is not None \
            else global_registry()

    def dump(self, dir: Optional[str] = None, reason: str = "manual",
             extra: Optional[dict] = None) -> Optional[str]:
        """Write a bundle and return its path, or None when no directory is
        configured (automatic dump sites are then free no-ops).

        Every bundle holds ``BUNDLE_FILES``: ``events.jsonl``,
        ``metrics.json``, ``environment.json``, ``threads.txt``,
        ``cost_analysis.json`` and ``manifest.json``; and ``extra.json``
        when ``extra`` is given."""
        base = dir or self.dump_dir
        if base is None:
            return None
        with self._lock:
            self._dump_seq += 1
            seq = self._dump_seq
            events = list(self._events)
            dropped = self._dropped
        stamp = time.strftime("%Y%m%d-%H%M%S")
        name = f"flight-{stamp}-p{os.getpid()}-{seq:03d}-{_slug(reason)}"
        path = os.path.join(base, name)
        try:
            os.makedirs(path, exist_ok=True)
            files = []

            def write_json(fname, obj):
                with open(os.path.join(path, fname), "w") as f:
                    json.dump(obj, f, indent=2, default=repr)
                    f.write("\n")
                files.append(fname)

            with open(os.path.join(path, "events.jsonl"), "w") as f:
                for ev in events:
                    f.write(json.dumps(
                        {k: _jsonable(v) for k, v in ev.items()}) + "\n")
            files.append("events.jsonl")
            write_json("metrics.json", self._registry_or_global().snapshot())
            write_json("environment.json", collect_environment())
            with open(os.path.join(path, "threads.txt"), "w") as f:
                f.write(thread_stacks())
            files.append("threads.txt")
            write_json("cost_analysis.json", _cost_analysis())
            if extra is not None:
                write_json("extra.json",
                           {k: _jsonable(v) for k, v in extra.items()})
            write_json("manifest.json", {
                "reason": reason, "ts": time.time(), "pid": os.getpid(),
                "events": len(events), "events_dropped": dropped,
                "capacity": self.capacity, "files": files + ["manifest.json"],
            })
        except OSError as e:
            log.error("flight recorder could not write bundle %s: %r",
                      path, e)
            return None
        self._registry_or_global().counter(
            FLIGHT_DUMPS_TOTAL,
            "flight-recorder diagnostic bundles written").labels(
                reason=_slug(reason)).inc()
        log.warning("flight recorder: wrote diagnostic bundle %s (%s)",
                    path, reason)
        return path

    def list_bundles(self, dir: Optional[str] = None) -> List[dict]:
        """The manifests of the bundles under the dump directory, newest
        first, each with its ``path``."""
        base = dir or self.dump_dir
        out: List[dict] = []
        if not base or not os.path.isdir(base):
            return out
        for entry in sorted(os.listdir(base), reverse=True):
            manifest = os.path.join(base, entry, "manifest.json")
            if not os.path.isfile(manifest):
                continue
            try:
                with open(manifest) as f:
                    m = json.load(f)
            except (OSError, ValueError):
                m = {"error": "unreadable manifest"}
            m["path"] = os.path.join(base, entry)
            out.append(m)
        return out


_GLOBAL = FlightRecorder()


def global_recorder() -> FlightRecorder:
    """The process-global recorder the fit loops and alarm paths write to."""
    return _GLOBAL


# ------------------------------------------------------- exception egress
def dump_on_unhandled(site: str):
    """Decorator for the fit entry points: an exception escaping the call
    records an event and (with a dump directory) writes one bundle, then
    propagates unchanged. Nested decorated frames (``fit`` ->
    ``fit_iterator``) dump once: the exception is marked after the first
    bundle."""

    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            try:
                return fn(*args, **kwargs)
            except Exception as e:
                _note_unhandled(site, e)
                raise
        return wrapper

    return deco


def _note_unhandled(site: str, e: BaseException) -> None:
    rec = global_recorder()
    rec.record("exception", site=site, error=repr(e)[:500])
    if getattr(e, "_dl4j_recorder_dumped", False):
        return
    try:
        if rec.dump(reason=f"exception-{site}") is not None:
            e._dl4j_recorder_dumped = True
    except Exception:  # the training error propagates, not the dump's
        log.exception("flight recorder dump failed while handling an "
                      "exception from %s", site)


# --------------------------------------------------------- signal egress
def install_signal_handlers(recorder: Optional[FlightRecorder] = None,
                            signals: Optional[tuple] = None) -> dict:
    """SIGTERM/SIGUSR1 dump hooks (main thread only: CPython's signal
    rule). SIGUSR1 dumps and the run goes on; SIGTERM dumps, then chains to
    the previous handler (or re-raises the default termination), so an
    orchestrator's kill still ends the process. Returns ``{signum:
    previous_handler}`` for :func:`uninstall_signal_handlers`."""
    # an empty recorder is falsy (__len__ 0): compare with None
    rec = recorder if recorder is not None else global_recorder()
    sigs = signals or (signal.SIGTERM, signal.SIGUSR1)
    previous: dict = {}

    def handler(signum, frame):
        try:
            sig_name = signal.Signals(signum).name
        except ValueError:
            sig_name = str(signum)
        rec.record("signal", signum=signum, name=sig_name)
        try:
            rec.dump(reason=f"signal-{sig_name}")
        except Exception:  # the chain below must still run
            log.exception("flight recorder dump failed in %s handler",
                          sig_name)
        prev = previous.get(signum)
        if callable(prev):
            prev(signum, frame)
        elif prev == signal.SIG_DFL and signum != signal.SIGUSR1:
            # the default disposition back, the signal again: SIGTERM still
            # terminates after the dump
            signal.signal(signum, signal.SIG_DFL)
            os.kill(os.getpid(), signum)

    for s in sigs:
        previous[s] = signal.signal(s, handler)
    return previous


def uninstall_signal_handlers(previous: dict) -> None:
    for signum, prev in previous.items():
        signal.signal(signum, prev)
