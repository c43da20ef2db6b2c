"""Parameter-server transports: one API, three backends.

Counterpart of ``deeplearning4j_tpu/parallel/ps_transport.py``. The worker
loop (``param_server.run_worker_loop``) sees only ``pull()`` and
``push(delta, base_version)``:

* :class:`InprocTransport`: direct calls into a shared
  :class:`~.param_server.ParameterServer` (worker threads).
* :class:`TcpTransport` + :class:`ParameterServerTcpFrontend`: stdlib
  sockets and ``streaming/wire.py``'s frames (the JAX package's frames,
  byte for byte), workers in separate processes. Deltas may ride as bf16
  (``codec="bf16"``); pulls and the server's state stay float32.
* :class:`ShmTransport`: control verbs on the TCP connection, tensor bytes
  in a pair of per-worker double-buffered ``multiprocessing.shared_memory``
  rings with seqlock stamps, negotiated over the socket (``shm_open``).
  When the rings cannot attach, the transport degrades to the TCP frames
  for good, and says so: ``stats()["shm_active"]`` is False,
  ``shm_pushes``/``shm_pulls`` stay 0 and a ``ps_shm_fallback`` event names
  the error.

The membership verbs (``register``, ``heartbeat``, ``deregister``) ride the
same seam, so liveness and pushes share one failure domain.

Tracing crosses the process boundary in the frame header: a pull or push
made under an ambient span (or the transport's bound ``trace_parent``)
opens the client span ``ps.pull``/``ps.push`` and stamps its
``traceparent`` into the header; the frontend opens ``ps.apply`` parented
from that header around the server's ``push_delta`` (``push`` and
``push_shm``), so the worker's trace id lands in the server process's trace
store. The inproc transport's ``ps.push`` covers the server's apply, in
the same process, as in the JAX package. RPCs with no parent (the background puller, the heartbeat) carry no
header and open no span. The JAX
frontend's fleet-observability verbs (``metrics_push``, ``trace_push``,
``dump_fleet``) wait for ROADMAP.md A9.4: the frontend answers them with
an error reply that says so.

Every segment a process creates is named ``dl4j_pt_shm_<pid>_<n>_<kind>``
and unlinked at exit; :func:`reap_orphans` unlinks the segments of dead
creators (SIGKILL skips atexit). The prefix is the port's own, so neither
package's reaper touches the other's segments (a session hands the names
over the socket, so a JAX worker attaches to a port server's rings all
the same). Workers only attach. A segment larger than the free space
of ``/dev/shm`` is refused with ``OSError`` (writing past a full tmpfs
kills the writer with SIGBUS), which the callers turn into their
fallbacks.

Telemetry as in the JAX module: ``dl4j_ps_wire_bytes_total`` (a push's
bytes sent, a pull's payload received, by op and codec),
``dl4j_shm_segments`` (segments this process owns), ``dl4j_shm_bytes_total``
by direction (push and pull rings, shard segments) and
``dl4j_shm_reaped_total``; the frontend's start, stop, errors and shm
sessions, a transport's fallback and a reap are flight-recorder events, and
the frontend's accept loop and every request it serves beat the watchdog.
The transports' ``stats()`` keep their own counts beside the series, and
:func:`segment_stats` reads the reaped and shard bytes back from them.
"""
from __future__ import annotations

import atexit
import itertools
import json
import os
import socket
import struct
import threading
import time
from collections import Counter
from multiprocessing import shared_memory
from typing import Dict, Optional, Tuple

import numpy as np

from ..observability.flight_recorder import global_recorder
from ..observability.metrics import global_registry
from ..observability.names import (
    PS_WIRE_BYTES_TOTAL, SHM_BYTES_TOTAL, SHM_REAPED_TOTAL, SHM_SEGMENTS)
from ..observability.tracing import (
    NOOP_SPAN, current_span, parse_traceparent, start_span)
from ..observability.watchdog import beat
from ..streaming import wire
from .param_server import ParameterServer, PushResult

_wire_bytes = global_registry().counter(
    PS_WIRE_BYTES_TOTAL, "PS bytes on the wire, by op and codec")
_shm_gauge = global_registry().gauge(
    SHM_SEGMENTS, "shared-memory segments currently owned (created, not yet "
                  "unlinked) by this process").labels()
_shm_bytes = global_registry().counter(
    SHM_BYTES_TOTAL, "tensor bytes staged through shared-memory segments, "
                     "by direction")
_shm_shard_bytes = _shm_bytes.labels(direction="shard")
_shm_reaped = global_registry().counter(
    SHM_REAPED_TOTAL, "orphaned dl4j shared-memory segments unlinked by "
                      "reap_orphans (creator pid dead)").labels()

# --------------------------------------------------------------------------
# shared-memory segments: creation registry + reaper

#: every segment name starts with this prefix and the creator's pid
_SHM_PREFIX = "dl4j_pt_shm_"
_SHM_DIR = "/dev/shm"

_shm_lock = threading.Lock()
_shm_created: Dict[str, shared_memory.SharedMemory] = {}
_shm_counter = itertools.count()
#: segments created and unlinked by this process
_shm_counts: Counter = Counter()


def segment_stats() -> dict:
    """Segments created, unlinked and owned by this process, and the
    reaped segments and shard bytes read back from their series."""
    with _shm_lock:
        out = {**dict(_shm_counts), "owned": len(_shm_created)}
    reaped, shard = int(_shm_reaped.value), int(_shm_shard_bytes.value)
    out.update({k: v for k, v in (("reaped", reaped), ("shard_bytes", shard))
                if v})
    return out


def _pid_alive(pid: int) -> bool:
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    except PermissionError:
        return True  # alive, someone else's
    return True


def create_segment(nbytes: int, kind: str) -> shared_memory.SharedMemory:
    """Create an owned segment ``dl4j_pt_shm_<pid>_<n>_<kind>``, registered
    for unlink at exit and for orphan reaping."""
    try:
        st = os.statvfs(_SHM_DIR)
    except OSError:
        st = None
    if st is not None and nbytes > st.f_bavail * st.f_frsize:
        raise OSError(f"{nbytes} bytes exceed the {st.f_bavail * st.f_frsize}"
                      f" free in {_SHM_DIR}")
    name = f"{_SHM_PREFIX}{os.getpid()}_{next(_shm_counter)}_{kind}"
    shm = shared_memory.SharedMemory(name=name, create=True, size=nbytes)
    with _shm_lock:
        _shm_created[shm.name] = shm
        _shm_counts["created"] += 1
        _shm_gauge.set(len(_shm_created))
    return shm


def attach_segment(name: str) -> shared_memory.SharedMemory:
    """Attach a peer's segment without adopting it: Python registers every
    attach with its resource tracker, which would unlink the creator's
    segment when this process exits, so the attach is unregistered at
    once (the creator owns it; the reaper covers crashes)."""
    shm = shared_memory.SharedMemory(name=name)
    with _shm_lock:
        own = name in _shm_created
    if not own:  # an attach in the creating process keeps its registration
        try:
            from multiprocessing import resource_tracker
            resource_tracker.unregister(getattr(shm, "_name", "/" + name),
                                        "shared_memory")
        except Exception:
            pass  # tracker internals vary by version: a warning at exit
    return shm


def release_segment(shm: shared_memory.SharedMemory,
                    unlink: bool = False) -> None:
    """Close (and, for the owner, unlink) a segment. A ``BufferError`` on
    close means a view is still alive: the mapping goes at exit, and the
    unlink, which is what prevents a leak, still happens."""
    try:
        shm.close()
    except BufferError:
        pass
    if unlink:
        try:
            shm.unlink()
        except FileNotFoundError:
            pass  # reaped already
        with _shm_lock:
            if _shm_created.pop(shm.name, None) is not None:
                _shm_counts["unlinked"] += 1
            _shm_gauge.set(len(_shm_created))


def release_segment_by_name(name: str) -> bool:
    """Unlink a segment this process created (shard shipping hands names
    across the spawn boundary)."""
    with _shm_lock:
        shm = _shm_created.get(name)
    if shm is None:
        return False
    release_segment(shm, unlink=True)
    return True


def _atexit_unlink_all() -> None:
    with _shm_lock:
        segs = list(_shm_created.values())
    for shm in segs:
        release_segment(shm, unlink=True)


atexit.register(_atexit_unlink_all)


def orphan_segments(shm_dir: str = _SHM_DIR) -> list:
    """Names of ``dl4j_pt_shm_<pid>_*`` segments whose creator is dead."""
    try:
        names = os.listdir(shm_dir)
    except OSError:
        return []
    out = []
    for name in names:
        if not name.startswith(_SHM_PREFIX):
            continue
        try:
            pid = int(name[len(_SHM_PREFIX):].split("_", 1)[0])
        except ValueError:
            continue
        if pid != os.getpid() and not _pid_alive(pid):
            out.append(name)
    return out


def reap_orphans(shm_dir: str = _SHM_DIR) -> int:
    """Unlink every segment whose creator is dead; returns how many. A
    no-op on a host without ``/dev/shm``."""
    reaped = 0
    for name in orphan_segments(shm_dir):
        try:
            os.unlink(os.path.join(shm_dir, name))
        except OSError:
            continue
        reaped += 1
    if reaped:
        _shm_reaped.inc(reaped)
        global_recorder().record("shm_reaped", count=reaped)
    return reaped


# --------------------------------------------------------------------------
# seqlock double buffer: the tensor lane of the shm transport

class ShmRing:
    """Two slots in one segment, each ``[seq, version, nbytes | data]``.

    One writer: it alternates slots, makes the slot's seq odd before
    touching the data, writes, then publishes the even seq, the version
    and the size. A reader returns a view only when the stored seq is even
    and equals the seq the control message promised; a torn or stale slot
    raises. The control RPC carrying ``(slot, seq)`` orders both sides, so
    the stamps check integrity, they do not synchronize."""

    SLOT_HDR = struct.Struct("!QQQ")  # seq, version, payload nbytes

    def __init__(self, shm: shared_memory.SharedMemory, capacity: int,
                 direction: str = "push"):
        self.shm = shm
        self.capacity = int(capacity)
        self._next = 0
        #: bytes written through this ring
        self.bytes = 0
        self._bytes = _shm_bytes.labels(direction=direction)

    @classmethod
    def segment_size(cls, capacity: int) -> int:
        return 2 * (cls.SLOT_HDR.size + int(capacity))

    def _base(self, slot: int) -> int:
        return slot * (self.SLOT_HDR.size + self.capacity)

    def write(self, view, version: int) -> Tuple[int, int]:
        """Copy ``view`` (bytes) into the next slot; returns ``(slot,
        seq)`` for the control message. That copy is the transfer."""
        nbytes = view.nbytes if isinstance(view, memoryview) else len(view)
        if nbytes > self.capacity:
            raise ValueError(f"shm slot overflow: {nbytes} > "
                             f"capacity {self.capacity}")
        slot = self._next
        self._next ^= 1
        base = self._base(slot)
        buf = self.shm.buf
        seq = self.SLOT_HDR.unpack_from(buf, base)[0]
        self.SLOT_HDR.pack_into(buf, base, seq + 1, int(version), nbytes)
        data = base + self.SLOT_HDR.size
        buf[data:data + nbytes] = view
        self.SLOT_HDR.pack_into(buf, base, seq + 2, int(version), nbytes)
        self.bytes += nbytes
        self._bytes.inc(nbytes)
        return slot, seq + 2

    def read(self, slot: int, seq: int) -> Tuple[int, memoryview]:
        """``(version, data view)``; the view aliases the slot, so consume
        it before the writer's next write to the slot."""
        base = self._base(int(slot))
        got, version, nbytes = self.SLOT_HDR.unpack_from(self.shm.buf, base)
        if got != seq or got % 2:
            raise ConnectionError(
                f"shm seqlock mismatch: slot {slot} has seq {got}, control "
                f"message promised {seq}" + (" (torn write)" if got % 2
                                             else ""))
        data = base + self.SLOT_HDR.size
        return version, self.shm.buf[data:data + nbytes]


class TransportError(OSError):
    """The server is unreachable after the transport's whole retry budget.
    A worker takes it as its own eviction: stop, clean up, exit (its lease
    lapses at the server anyway)."""


class Transport:
    """What a PS worker holds: pull the versioned params, push a delta
    against the version it pulled, and the membership verbs."""

    def pull(self) -> Tuple[int, np.ndarray]:
        raise NotImplementedError

    def push(self, delta: np.ndarray, base_version: int) -> PushResult:
        raise NotImplementedError

    def bind_member(self, member: int, epoch: int) -> None:
        """Attach a ``(member, epoch)`` identity: later pushes carry it and
        the server fences them against the oracle's leases."""
        self._member, self._epoch = int(member), int(epoch)

    @property
    def member_identity(self) -> Optional[Tuple[int, int]]:
        member = getattr(self, "_member", None)
        return None if member is None else (member, self._epoch)

    def register(self, shard: int, worker: str = "") -> dict:
        raise NotImplementedError

    def heartbeat(self) -> bool:
        raise NotImplementedError

    def deregister(self, reason: str = "done") -> bool:
        raise NotImplementedError

    def stats(self) -> dict:
        return {}

    def close(self) -> None:
        pass

    def bind_trace_parent(self, ref) -> None:
        """The SpanRef later pushes and pulls parent under when no ambient
        span is set: the elastic worker binds the consume span of the batch
        it trains on, so its push joins the producer's trace (None
        clears)."""
        self._trace_ref = ref

    @property
    def trace_parent(self):
        return getattr(self, "_trace_ref", None)

    def _traced(self, name: str, header: dict, **attrs):
        """Open the client span of one RPC and stamp its ``traceparent``
        into the frame header, from which the server parents its
        ``ps.apply``. An RPC with no parent carries no header and opens no
        span. The caller finishes the span."""
        parent = current_span() or self.trace_parent
        if parent is None:
            return NOOP_SPAN
        sp = start_span(name, parent=parent, **attrs)
        tp = sp.traceparent()
        if tp:
            header["traceparent"] = tp
        return sp


def _apply_span(header: dict):
    """The server's half of a wire-propagated trace: a push carrying a
    ``traceparent`` gets a ``ps.apply`` span parented on the client's RPC
    span, in this process's trace store."""
    ref = parse_traceparent(header.get("traceparent"))
    if ref is None:
        return NOOP_SPAN
    return start_span("ps.apply", parent=ref, member=header.get("member"),
                      epoch=header.get("epoch"))


def _traced_push(server: ParameterServer, header: dict, delta):
    """``server.push_delta`` under the header's ``ps.apply`` span."""
    sp = _apply_span(header)
    try:
        res = server.push_delta(delta, header["base_version"],
                                member=header.get("member"),
                                epoch=header.get("epoch"))
        sp.set_attr(accepted=res.accepted, version=res.version,
                    fenced=res.fenced)
        return res
    finally:
        sp.finish()


class InprocTransport(Transport):
    def __init__(self, server: ParameterServer):
        self._server = server

    def pull(self) -> Tuple[int, np.ndarray]:
        return self._server.pull_flat()

    def push(self, delta: np.ndarray, base_version: int) -> PushResult:
        sp = self._traced("ps.push", {}, transport="inproc")
        try:
            ident = self.member_identity
            if ident is None:
                res = self._server.push_delta(delta, base_version)
            else:
                res = self._server.push_delta(delta, base_version,
                                              member=ident[0],
                                              epoch=ident[1])
            sp.set_attr(accepted=res.accepted, version=res.version)
            return res
        finally:
            sp.finish()

    def _membership(self):
        oracle = self._server.membership
        if oracle is None:
            raise RuntimeError("ParameterServer has no membership oracle")
        return oracle

    def register(self, shard: int, worker: str = "") -> dict:
        lease = self._membership().register(shard, worker=worker)
        return {"member": lease.member, "epoch": lease.epoch,
                "lease_s": self._membership().lease_timeout_s}

    def heartbeat(self) -> bool:
        ident = self.member_identity
        return (ident is not None
                and self._membership().heartbeat(ident[0], ident[1]))

    def deregister(self, reason: str = "done") -> bool:
        ident = self.member_identity
        return (ident is not None
                and self._membership().deregister(ident[0], ident[1],
                                                  reason=reason))


class TcpTransport(Transport):
    """Client side of the framed loopback protocol. Not thread-safe for
    concurrent use: each worker thread (the background puller, the
    heartbeat) opens its own connection through ``clone()``.

    It connects lazily and bounds every RPC: a connect timeout, a read
    timeout and a retry budget with exponential backoff, after which the
    RPC raises :class:`TransportError`. A retried push is at least once
    (the reply may be lost after the delta applied), which the
    staleness-weighted server takes like any other delta. An error reply
    (``RuntimeError``) is not retried: the server is alive."""

    def __init__(self, addr: Tuple[str, int], codec: str = "none",
                 timeout: float = 60.0, connect_timeout: float = 5.0,
                 retries: int = 3, backoff_s: float = 0.1,
                 backoff_cap_s: float = 2.0):
        self._addr = tuple(addr)
        self._codec = codec
        self._timeout = timeout
        self._connect_timeout = connect_timeout
        self._retries = max(0, int(retries))
        self._backoff_s = backoff_s
        self._backoff_cap_s = backoff_cap_s
        # reentrant: ShmTransport's fallback calls super().pull()/push()
        # while holding it
        self._lock = threading.RLock()
        self._sock: Optional[socket.socket] = None
        #: RPCs by op, bytes sent (the pushes' apart) and received, retries
        self.counts: Counter = Counter()
        self._tx = _wire_bytes.labels(op="push", codec=codec)
        self._rx = _wire_bytes.labels(op="pull", codec="none")

    def clone(self) -> "TcpTransport":
        t = type(self)(self._addr, self._codec, self._timeout,
                       self._connect_timeout, self._retries,
                       self._backoff_s, self._backoff_cap_s)
        ident = self.member_identity
        if ident is not None:
            t.bind_member(*ident)
        return t

    def stats(self) -> dict:
        with self._lock:
            return {"transport": "tcp", "codec": self._codec,
                    **dict(self.counts)}

    def _drop_sock(self) -> None:
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass  # already dead, which is why it is dropped
            self._sock = None

    def _rpc(self, header: dict, payload=b""):
        """One request and reply, with reconnect and bounded backoff.
        Caller holds ``self._lock``."""
        last: Optional[BaseException] = None
        for attempt in range(self._retries + 1):
            if attempt:
                self.counts["retries"] += 1
                time.sleep(min(self._backoff_s * (2 ** (attempt - 1)),
                               self._backoff_cap_s))
            try:
                if self._sock is None:
                    self._sock = wire.connect(
                        self._addr, timeout=self._connect_timeout)
                    self._sock.settimeout(self._timeout)
                reply, buf, sent = wire.request(self._sock, header, payload)
            except RuntimeError:
                raise
            except (socket.timeout, ConnectionError, OSError) as e:
                last = e
                self._drop_sock()
                continue
            self.counts[header.get("op")] += 1
            self.counts["bytes_sent"] += sent
            self.counts["bytes_received"] += len(buf)
            return reply, buf, sent
        raise TransportError(
            f"PS at {self._addr} unreachable after {self._retries + 1} "
            f"attempts (op={header.get('op')!r}): {last!r}") from last

    def _identify(self, header: dict) -> dict:
        ident = self.member_identity
        if ident is not None:
            header["member"], header["epoch"] = ident
        return header

    def pull(self) -> Tuple[int, np.ndarray]:
        header = {"op": "pull"}
        sp = self._traced("ps.pull", header, transport="tcp")
        try:
            with self._lock:
                reply, payload, _ = self._rpc(header)
            self._rx.inc(len(payload))
            sp.set_attr(version=reply["version"])
            return reply["version"], wire.decode_array(reply["array"],
                                                       payload)
        finally:
            sp.finish()

    def push(self, delta: np.ndarray, base_version: int) -> PushResult:
        meta, payload = wire.encode_array(
            np.asarray(delta, np.float32), self._codec)
        header = self._identify({"op": "push",
                                 "base_version": int(base_version),
                                 "array": meta})
        sp = self._traced("ps.push", header, transport="tcp",
                          base_version=int(base_version))
        try:
            with self._lock:
                reply, buf, sent = self._rpc(header, payload)
                self.counts["push_bytes"] += sent
            self._tx.inc(sent)
            sp.set_attr(accepted=reply["accepted"], version=reply["version"])
            return PushResult(accepted=reply["accepted"],
                              version=reply["version"],
                              staleness=reply["staleness"],
                              weight=reply["weight"],
                              params=wire.decode_array(reply["array"], buf),
                              fenced=reply.get("fenced", False))
        finally:
            sp.finish()

    def register(self, shard: int, worker: str = "") -> dict:
        with self._lock:
            reply, _, _ = self._rpc(
                {"op": "register", "shard": int(shard), "worker": worker})
        return reply

    def heartbeat(self) -> bool:
        ident = self.member_identity
        if ident is None:
            return False
        with self._lock:
            reply, _, _ = self._rpc(
                {"op": "heartbeat", "member": ident[0], "epoch": ident[1]})
        return bool(reply.get("ok"))

    def deregister(self, reason: str = "done") -> bool:
        ident = self.member_identity
        if ident is None:
            return False
        with self._lock:
            reply, _, _ = self._rpc(
                {"op": "deregister", "member": ident[0],
                 "epoch": ident[1], "reason": reason})
        return bool(reply.get("ok"))

    def close(self) -> None:
        with self._lock:
            self._drop_sock()


class ShmTransport(TcpTransport):
    """Same-host fast path: tensor bytes in per-worker shared-memory rings,
    only control verbs (slot, seq, version, array meta) on the socket.

    The first pull or push sends ``shm_open`` over the TCP connection; the
    server makes a (push ring, pull ring) pair sized to the param vector,
    keyed by a session token (not by the connection, so a reconnect keeps
    the rings). When the open is refused or the segments cannot attach,
    the transport is a :class:`TcpTransport` from then on, and its stats
    say so. Params are copied out of the pull ring before returning (the
    slot is reused two pulls later); a pushed delta is read by the server
    from the push ring in place."""

    def __init__(self, addr: Tuple[str, int], codec: str = "none",
                 timeout: float = 60.0, connect_timeout: float = 5.0,
                 retries: int = 3, backoff_s: float = 0.1,
                 backoff_cap_s: float = 2.0):
        super().__init__(addr, codec, timeout, connect_timeout, retries,
                         backoff_s, backoff_cap_s)
        self._token: Optional[str] = None
        self._push_ring: Optional[ShmRing] = None
        self._pull_ring: Optional[ShmRing] = None
        self._shm_ok: Optional[bool] = None  # None: not yet negotiated
        self.fallback_reason: Optional[str] = None

    def _negotiate(self) -> bool:
        """Caller holds ``self._lock``. One attempt a transport: the rings
        attach, or it is a TcpTransport from now on."""
        if self._shm_ok is not None:
            return self._shm_ok
        push_seg = pull_seg = None
        try:
            reply, _, _ = self._rpc({"op": "shm_open", "pid": os.getpid()})
            if not reply.get("ok"):
                raise OSError(reply.get("error", "shm_open refused"))
            push_seg = attach_segment(reply["push"])
            pull_seg = attach_segment(reply["pull"])
            cap = int(reply["capacity"])
            self._push_ring = ShmRing(push_seg, cap, direction="push")
            self._pull_ring = ShmRing(pull_seg, cap, direction="pull")
            self._token = reply["token"]
            self._shm_ok = True
        except (RuntimeError, OSError, KeyError, ValueError) as e:
            # an error reply (a server without shm) or segments that do
            # not attach: the inherited TCP frames from here on
            for seg in (push_seg, pull_seg):
                if seg is not None:
                    release_segment(seg)
            self._push_ring = self._pull_ring = None
            self._shm_ok = False
            self.fallback_reason = repr(e)
            global_recorder().record("ps_shm_fallback", addr=str(self._addr),
                                     error=repr(e))
        return self._shm_ok

    @property
    def shm_active(self) -> Optional[bool]:
        return self._shm_ok

    def stats(self) -> dict:
        with self._lock:
            return {**super().stats(), "transport": "shm",
                    "shm_active": bool(self._shm_ok),
                    "shm_pushes": self.counts["push_shm"],
                    "shm_pulls": self.counts["pull_shm"],
                    "shm_push_bytes": (self._push_ring.bytes
                                       if self._push_ring else 0),
                    "fallback_reason": self.fallback_reason}

    def pull(self) -> Tuple[int, np.ndarray]:
        with self._lock:
            if not self._negotiate():
                return super().pull()
            header = {"op": "pull_shm", "token": self._token}
            sp = self._traced("ps.pull", header, transport="shm")
            try:
                reply, _, _ = self._rpc(header)
                _, view = self._pull_ring.read(reply["slot"], reply["seq"])
                # a copy: the slot is reused two pulls later
                vec = np.frombuffer(view, dtype=np.float32).copy()
                del view
                sp.set_attr(version=reply["version"])
            finally:
                sp.finish()
        return reply["version"], vec

    def push(self, delta: np.ndarray, base_version: int) -> PushResult:
        meta, payload = wire.encode_array(
            np.asarray(delta, np.float32), self._codec)
        header = self._identify({"op": "push_shm",
                                 "base_version": int(base_version),
                                 "array": meta})
        with self._lock:
            if not self._negotiate():
                return super().push(delta, base_version)
            sp = self._traced("ps.push", header, transport="shm",
                              base_version=int(base_version))
            try:
                header["token"] = self._token
                header["slot"], header["seq"] = self._push_ring.write(
                    payload, int(base_version))
                reply, _, _ = self._rpc(header)
                _, pview = self._pull_ring.read(reply["pslot"],
                                                reply["pseq"])
                params = np.frombuffer(pview, dtype=np.float32).copy()
                del pview
                sp.set_attr(accepted=reply["accepted"],
                            version=reply["version"])
            finally:
                sp.finish()
        return PushResult(accepted=reply["accepted"],
                          version=reply["version"],
                          staleness=reply["staleness"],
                          weight=reply["weight"], params=params,
                          fenced=reply.get("fenced", False))

    def close(self) -> None:
        with self._lock:
            for ring in (self._push_ring, self._pull_ring):
                if ring is not None:
                    release_segment(ring.shm)  # an attach: close only
            self._push_ring = self._pull_ring = None
            self._shm_ok = None
            self._token = None
            self._drop_sock()


# --------------------------------------------------------------------------
# shard shipping: (x, y) batches through one segment instead of an npz

def write_shard_segment(arrays: Dict[str, np.ndarray], kind: str = "shard",
                        ) -> str:
    """Pack named arrays into a fresh owned segment (``!Q json_len | json
    metas | array bytes``); returns its name (ship it as
    ``shm://<name>``)."""
    metas, views = wire.pack_arrays(arrays)
    hdr = json.dumps(metas, separators=(",", ":")).encode("utf-8")
    total = 8 + len(hdr) + sum(v.nbytes for v in views)
    seg = create_segment(total, kind)
    buf = seg.buf
    struct.pack_into("!Q", buf, 0, len(hdr))
    buf[8:8 + len(hdr)] = hdr
    off = 8 + len(hdr)
    for v in views:
        buf[off:off + v.nbytes] = v
        off += v.nbytes
    _shm_shard_bytes.inc(total)
    return seg.name


def read_shard_segment(name: str) -> Dict[str, np.ndarray]:
    """Attach and decode a shard segment. The arrays own their data (the
    coordinator may unlink the segment while the worker trains)."""
    shm = attach_segment(name)
    try:
        (hdr_len,) = struct.unpack_from("!Q", shm.buf, 0)
        metas = json.loads(bytes(shm.buf[8:8 + hdr_len]).decode("utf-8"))
        body = shm.buf[8 + hdr_len:]
        out = {k: np.array(v) for k, v in
               wire.unpack_arrays(metas, body).items()}
        del body
    finally:
        release_segment(shm)
    return out


#: the JAX frontend's fleet-observability verbs, not served here yet
_FEDERATION_OPS = ("metrics_push", "trace_push", "dump_fleet")


class ParameterServerTcpFrontend:
    """Serves one :class:`~.param_server.ParameterServer` to TCP workers:
    an accept loop and a thread a connection, framed request and reply."""

    def __init__(self, server: ParameterServer, host: str = "127.0.0.1",
                 port: int = 0, federation=None, collector=None):
        if federation is not None or collector is not None:
            raise NotImplementedError(
                "the fleet-observability verbs (federation=, collector=) "
                "wait for ROADMAP.md A9.4")
        self._server = server
        self._host, self._port = host, port
        self._lsock: Optional[socket.socket] = None
        self._stop = threading.Event()
        self._threads: list = []
        self._conns: list = []
        self._lock = threading.Lock()
        # shm sessions are keyed by token, not connection; they end with
        # stop()
        self._shm_sessions: Dict[str, Tuple[ShmRing, ShmRing]] = {}
        self._shm_next = itertools.count(1)
        #: requests by op, error replies
        self.counts: Counter = Counter()

    @property
    def port(self) -> int:
        return self._port

    def start(self) -> "ParameterServerTcpFrontend":
        self._lsock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._lsock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._lsock.bind((self._host, self._port))
        self._lsock.listen(64)
        self._lsock.settimeout(0.2)
        self._port = self._lsock.getsockname()[1]
        t = threading.Thread(target=self._accept_loop, daemon=True,
                             name="ps-tcp-accept")
        t.start()
        self._threads.append(t)
        global_recorder().record("ps_server_start", port=self._port)
        return self

    def _accept_loop(self) -> None:
        while not self._stop.is_set():
            beat()
            try:
                conn, peer = self._lsock.accept()
            except socket.timeout:
                continue
            except OSError:
                break  # listener closed by stop()
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            with self._lock:
                self._conns.append(conn)
            t = threading.Thread(target=self._serve_conn, daemon=True,
                                 args=(conn, peer), name="ps-tcp-conn")
            t.start()
            self._threads.append(t)

    def _serve_conn(self, conn: socket.socket, peer=None) -> None:
        # one reusable receive buffer a connection: every op consumes its
        # payload inside _handle (a push applies under the server lock
        # before the reply), so the next frame may overwrite it
        rbuf = bytearray()
        with conn:
            while not self._stop.is_set():
                try:
                    header, payload = wire.recv_frame(conn, rbuf)
                except (ConnectionError, OSError):
                    return  # the worker hung up
                try:
                    reply, buf = self._handle(header, payload)
                    payload = None  # let rbuf grow in place next time
                except Exception as e:  # replied to the worker, recorded
                    with self._lock:
                        self.counts["errors"] += 1
                    global_recorder().record("ps_server_error",
                                             peer=str(peer), error=repr(e))
                    try:
                        wire.send_frame(conn, {"error": repr(e)})
                    except OSError:
                        pass  # the peer is gone already
                    return
                beat(self._server.version)
                try:
                    wire.send_frame(conn, reply, buf)
                except (ConnectionError, OSError):
                    return  # the worker died mid-reply

    def _push_reply(self, res: PushResult) -> dict:
        return {"accepted": res.accepted, "version": res.version,
                "staleness": res.staleness, "weight": res.weight,
                "fenced": res.fenced}

    def _handle(self, header: dict, payload):
        op = header.get("op")
        with self._lock:
            self.counts[op] += 1
        if op == "pull":
            version, vec = self._server.pull_flat()
            meta, buf = wire.encode_array(vec, "none")
            return {"version": version, "array": meta}, buf
        if op == "push":
            delta = wire.decode_array(header["array"], payload)
            res = _traced_push(self._server, header, delta)
            meta, buf = wire.encode_array(res.params, "none")
            return dict(self._push_reply(res), array=meta), buf
        if op in _FEDERATION_OPS:
            raise ValueError(
                f"PS op {op!r} needs the fleet-observability plane, which "
                "waits for ROADMAP.md A9.4")
        if op == "register":
            oracle = self._require_membership(op)
            lease = oracle.register(header["shard"],
                                    worker=header.get("worker", ""))
            return {"member": lease.member, "epoch": lease.epoch,
                    "lease_s": oracle.lease_timeout_s}, b""
        if op == "heartbeat":
            oracle = self._require_membership(op)
            return {"ok": oracle.heartbeat(header["member"],
                                           header["epoch"])}, b""
        if op == "deregister":
            oracle = self._require_membership(op)
            return {"ok": oracle.deregister(
                header["member"], header["epoch"],
                reason=header.get("reason", "done"))}, b""
        if op == "shm_open":
            return self._shm_open(header), b""
        if op == "pull_shm":
            _, pull_ring = self._shm_session(header)
            version, vec = self._server.pull_flat()
            slot, seq = pull_ring.write(wire._byteview(vec), version)
            return {"version": version, "slot": slot, "seq": seq}, b""
        if op == "push_shm":
            push_ring, pull_ring = self._shm_session(header)
            _, dview = push_ring.read(header["slot"], header["seq"])
            # the delta view aliases the client's push slot; push_delta
            # consumes it under the server lock before the reply lets the
            # client write again
            delta = wire.decode_array(header["array"], dview)
            res = _traced_push(self._server, header, delta)
            del delta, dview
            pslot, pseq = pull_ring.write(wire._byteview(res.params),
                                          res.version)
            return dict(self._push_reply(res), pslot=pslot, pseq=pseq), b""
        raise ValueError(f"unknown PS op {op!r}")

    def _shm_open(self, header: dict) -> dict:
        reap_orphans()  # every new session sweeps dead fleets' segments
        capacity = self._server.pull_flat()[1].nbytes
        push_seg = pull_seg = None
        try:
            push_seg = create_segment(ShmRing.segment_size(capacity), "push")
            pull_seg = create_segment(ShmRing.segment_size(capacity), "pull")
        except OSError as e:
            if push_seg is not None:
                release_segment(push_seg, unlink=True)
            return {"ok": False, "error": repr(e)}
        with self._lock:
            token = f"shm{next(self._shm_next)}"
            self._shm_sessions[token] = (
                ShmRing(push_seg, capacity, direction="push"),
                ShmRing(pull_seg, capacity, direction="pull"))
        global_recorder().record("ps_shm_open", token=token,
                                 pid=header.get("pid"), capacity=capacity)
        return {"ok": True, "token": token, "push": push_seg.name,
                "pull": pull_seg.name, "capacity": capacity}

    def _shm_session(self, header: dict) -> Tuple[ShmRing, ShmRing]:
        with self._lock:
            sess = self._shm_sessions.get(header.get("token"))
        if sess is None:
            raise ValueError(f"unknown shm token {header.get('token')!r} "
                             "(server restarted? reopen the session)")
        return sess

    def _require_membership(self, op: str):
        oracle = getattr(self._server, "membership", None)
        if oracle is None:
            raise ValueError(
                f"PS op {op!r} requires a membership oracle "
                "(ParameterServer(..., membership=MembershipOracle()))")
        return oracle

    def stats(self) -> dict:
        with self._lock:
            return {**dict(self.counts),
                    "shm_sessions": len(self._shm_sessions)}

    def stop(self) -> None:
        self._stop.set()
        if self._lsock is not None:
            self._lsock.close()
        with self._lock:
            for conn in self._conns:
                try:
                    conn.close()
                except OSError:
                    pass  # closed by its handler thread already
        for t in self._threads:
            t.join(timeout=5)
        with self._lock:
            sessions, self._shm_sessions = self._shm_sessions, {}
        for push_ring, pull_ring in sessions.values():
            release_segment(push_ring.shm, unlink=True)
            release_segment(pull_ring.shm, unlink=True)
        global_recorder().record("ps_server_stop", port=self._port,
                                 version=self._server.version,
                                 pushes=self._server.pushes,
                                 rejected=self._server.rejected)
