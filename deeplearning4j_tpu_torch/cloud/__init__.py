"""Cloud storage, provisioning and the membership oracle.

Counterpart of ``deeplearning4j_tpu/cloud/__init__.py`` (deeplearning4j-
aws): a ``StorageProvider`` SPI with a local-filesystem backend and an HTTP
object-store backend (``serve_storage`` stands up a loopback server for
it), a gated ``S3Provider``, and ``TpuProvisioner``, which renders an
accelerator-pool request dict (it keeps the JAX package's name, fields and
defaults: it only renders a request). ``MembershipOracle`` grows it into
the elastic-training membership authority: leases, heartbeats and fencing
epochs. As in the JAX package, the oracle writes
``dl4j_elastic_live_workers``, ``dl4j_elastic_joins_total`` and
``dl4j_elastic_lease_expiries_total`` and records ``{role}_join``,
``{role}_leave`` and ``{role}_lost`` events in the flight recorder; one
oracle's own counts are :meth:`MembershipOracle.stats` (a process may hold
several oracles: a trainer's and a serving fleet's).
"""
from __future__ import annotations

import dataclasses
import shutil
import threading
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional

from ..observability.flight_recorder import global_recorder
from ..observability.metrics import global_registry
from ..observability.names import (
    ELASTIC_JOINS_TOTAL, ELASTIC_LEASE_EXPIRIES_TOTAL, ELASTIC_LIVE_WORKERS)

_live_workers = global_registry().gauge(
    ELASTIC_LIVE_WORKERS, "workers holding a live membership lease").labels()
_lease_expiries = global_registry().counter(
    ELASTIC_LEASE_EXPIRIES_TOTAL,
    "membership leases declared dead after missing heartbeats").labels()
_joins = global_registry().counter(
    ELASTIC_JOINS_TOTAL, "worker registrations with the membership "
                         "oracle").labels()


class StorageProvider:
    """Artifact upload and download SPI."""

    def upload(self, local_path: str, remote_path: str) -> str:
        raise NotImplementedError

    def download(self, remote_path: str, local_path: str) -> str:
        raise NotImplementedError

    def list(self, remote_prefix: str) -> List[str]:
        raise NotImplementedError


class LocalFileSystemProvider(StorageProvider):
    """A store under a directory (also the backend for a mounted object
    store)."""

    def __init__(self, root: str):
        self.root = Path(root)
        self.root.mkdir(parents=True, exist_ok=True)

    def _resolve(self, remote_path: str) -> Path:
        p = (self.root / remote_path.lstrip("/")).resolve()
        if not p.is_relative_to(self.root.resolve()):
            raise ValueError(f"remote path escapes store root: {remote_path}")
        return p

    def upload(self, local_path: str, remote_path: str) -> str:
        dst = self._resolve(remote_path)
        dst.parent.mkdir(parents=True, exist_ok=True)
        shutil.copy2(local_path, dst)
        return str(dst)

    def download(self, remote_path: str, local_path: str) -> str:
        src = self._resolve(remote_path)
        Path(local_path).parent.mkdir(parents=True, exist_ok=True)
        shutil.copy2(src, local_path)
        return local_path

    def list(self, remote_prefix: str = "") -> List[str]:
        base = self._resolve(remote_prefix) if remote_prefix else self.root
        if not base.exists():
            return []
        return sorted(str(p.relative_to(self.root))
                      for p in base.rglob("*") if p.is_file())


class HttpStorageProvider(StorageProvider):
    """An object store over plain HTTP: PUT an object, GET it, GET
    ``?prefix=`` to list (S3's REST shape). :func:`serve_storage` stands
    up a loopback server for it."""

    def __init__(self, base_url: str, token: Optional[str] = None,
                 timeout: float = 30.0):
        self.base_url = base_url.rstrip("/")
        self.token = token
        self.timeout = timeout

    def _request(self, method: str, path: str, data=None,
                 headers: Optional[dict] = None):
        import urllib.request

        req = urllib.request.Request(
            f"{self.base_url}/{path.lstrip('/')}", data=data, method=method,
            headers=dict(headers or {}))
        if self.token:
            req.add_header("Authorization", f"Bearer {self.token}")
        return urllib.request.urlopen(req, timeout=self.timeout)

    def upload(self, local_path: str, remote_path: str) -> str:
        # a file object with Content-Length streams chunk by chunk
        size = Path(local_path).stat().st_size
        with open(local_path, "rb") as f:
            with self._request("PUT", remote_path, data=f,
                               headers={"Content-Length": str(size)}) as resp:
                if resp.status not in (200, 201, 204):
                    raise IOError(f"upload failed: HTTP {resp.status}")
        return f"{self.base_url}/{remote_path.lstrip('/')}"

    def download(self, remote_path: str, local_path: str) -> str:
        Path(local_path).parent.mkdir(parents=True, exist_ok=True)
        with self._request("GET", remote_path) as resp:
            with open(local_path, "wb") as f:
                shutil.copyfileobj(resp, f)
        return local_path

    def list(self, remote_prefix: str = "") -> List[str]:
        import urllib.parse

        q = urllib.parse.urlencode({"prefix": remote_prefix})
        with self._request("GET", f"?{q}") as resp:
            body = resp.read().decode("utf-8")
        return [line for line in body.splitlines() if line]


def serve_storage(root: str, host: str = "127.0.0.1", port: int = 0,
                  token: Optional[str] = None):
    """Loopback artifact server for :class:`HttpStorageProvider`: PUT
    stores, GET serves, ``GET /?prefix=`` lists. Returns ``(server,
    base_url)``; run ``server.serve_forever()`` on a thread and
    ``server.shutdown()`` when done. The root is a
    :class:`LocalFileSystemProvider`, so remote names cannot escape it."""
    import urllib.parse
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    store = LocalFileSystemProvider(root)

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):
            pass

        def _reply(self, status: int) -> None:
            self.send_response(status)
            self.end_headers()

        def _authed(self) -> bool:
            if token is None or (self.headers.get("Authorization")
                                 == f"Bearer {token}"):
                return True
            self._reply(401)
            return False

        def do_PUT(self):
            if not self._authed():
                return
            try:
                dst = store._resolve(urllib.parse.unquote(self.path))
            except ValueError:
                return self._reply(400)
            if "Content-Length" not in self.headers:
                return self._reply(411)  # length required: no silent empties
            remaining = int(self.headers["Content-Length"])
            dst.parent.mkdir(parents=True, exist_ok=True)
            with open(dst, "wb") as f:
                while remaining > 0:
                    chunk = self.rfile.read(min(1 << 20, remaining))
                    if not chunk:
                        break
                    f.write(chunk)
                    remaining -= len(chunk)
            if remaining:
                # a truncated body is never acknowledged
                dst.unlink(missing_ok=True)
                return self._reply(400)
            self._reply(201)

        def do_GET(self):
            if not self._authed():
                return
            parsed = urllib.parse.urlsplit(self.path)
            if parsed.path in ("", "/"):
                prefix = urllib.parse.parse_qs(parsed.query).get(
                    "prefix", [""])[0]
                try:
                    names = store.list(prefix)
                except ValueError:
                    return self._reply(400)
                body = "\n".join(names).encode("utf-8")
                self.send_response(200)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
                return
            try:
                src = store._resolve(urllib.parse.unquote(parsed.path))
            except ValueError:
                return self._reply(400)
            if not src.is_file():
                return self._reply(404)
            self.send_response(200)
            self.send_header("Content-Length", str(src.stat().st_size))
            self.end_headers()
            with open(src, "rb") as f:
                shutil.copyfileobj(f, self.wfile)

    server = ThreadingHTTPServer((host, port), Handler)
    return server, f"http://{host}:{server.server_address[1]}"


class S3Provider(StorageProvider):
    """Gated object-store backend: it needs network egress and an S3
    client; constructing it raises with what to use instead."""

    def __init__(self, bucket: str):
        raise RuntimeError(
            "S3/object-store transfer requires network egress and an S3 "
            "client, neither of which is available in this environment. Use "
            "LocalFileSystemProvider against a mounted path, or deploy with "
            f"an object-store client to reach bucket {bucket!r}.")


@dataclasses.dataclass
class TpuProvisioner:
    """Accelerator-pool request builder: ``render()`` gives the request dict
    a deployment tool would submit (the JAX package's fields and
    defaults)."""

    accelerator_type: str = "v5litepod-16"
    runtime_version: str = "tpu-ubuntu2204-base"
    zone: str = "us-central1-a"
    num_slices: int = 1
    preemptible: bool = False

    def render(self, name: str) -> dict:
        return {
            "name": name,
            "accelerator_type": self.accelerator_type,
            "runtime_version": self.runtime_version,
            "zone": self.zone,
            "num_slices": self.num_slices,
            "spot": self.preemptible,
        }


@dataclasses.dataclass
class WorkerLease:
    """One member's record: a fencing ``epoch`` (monotonic over every
    registration) and a deadline that heartbeats renew."""

    member: int
    epoch: int
    shard: int
    name: str
    deadline: float
    alive: bool = True
    reason: Optional[str] = None   # why the lease ended, once it has


@dataclasses.dataclass
class MembershipOracle(TpuProvisioner):
    """The membership authority of elastic training and of the serving
    fleet.

    Members ``register`` (a member id, a fencing epoch and a lease), renew
    with ``heartbeat`` and leave with ``deregister``. A lease not renewed
    within ``lease_timeout_s`` is dead: liveness is decided here, never by
    the member. Every registration draws a fresh epoch, and the parameter
    server (``ParameterServer(..., membership=oracle)``) rejects pushes that
    carry a dead or superseded ``(member, epoch)``: a zombie can still
    talk, but its pushes no longer land. Pushes do not renew a lease; only
    heartbeats do. ``clock`` is injectable (default ``time.monotonic``);
    ``role`` (``"worker"`` or ``"replica"``) names default members."""

    lease_timeout_s: float = 15.0
    clock: Callable[[], float] = time.monotonic
    role: str = "worker"

    def __post_init__(self) -> None:
        self._lock = threading.Lock()
        self._members: Dict[int, WorkerLease] = {}
        self._epoch = 0
        self.lease_expiries = 0
        self.joins = 0
        self.evictions = 0
        self.leaves = 0

    # ----------------------------------------------------------- membership
    def register(self, shard: int, worker: str = "") -> WorkerLease:
        with self._lock:
            self._epoch += 1
            lease = WorkerLease(
                member=self._epoch, epoch=self._epoch, shard=int(shard),
                name=worker or f"{self.role}-{self._epoch}",
                deadline=self.clock() + self.lease_timeout_s)
            self._members[lease.member] = lease
            self.joins += 1
            _joins.inc()
            self._update_gauge_locked()
        global_recorder().record(
            f"{self.role}_join", member=lease.member, epoch=lease.epoch,
            shard=lease.shard, worker=lease.name)
        return lease

    def _live_locked(self, member: int, epoch: int) -> Optional[WorkerLease]:
        """The named lease when it is live and unlapsed (a lapsed one is
        expired on the way); else None."""
        lease = self._members.get(int(member))
        if lease is None or lease.epoch != int(epoch) or not lease.alive:
            return None
        if self.clock() > lease.deadline:
            self._expire_locked(lease, reason="lease-lapsed")
            return None
        return lease

    def heartbeat(self, member: int, epoch: int) -> bool:
        """Renew ``member``'s lease; False means it is gone (dead,
        superseded or lapsed) and the member must stop pushing."""
        with self._lock:
            lease = self._live_locked(member, epoch)
            if lease is None:
                return False
            lease.deadline = self.clock() + self.lease_timeout_s
            return True

    def deregister(self, member: int, epoch: int,
                   reason: str = "done") -> bool:
        """A graceful leave: the lease ends without counting as an
        expiry."""
        with self._lock:
            lease = self._members.get(int(member))
            if lease is None or lease.epoch != int(epoch) or not lease.alive:
                return False
            lease.alive = False
            lease.reason = reason
            self.leaves += 1
            self._update_gauge_locked()
        global_recorder().record(
            f"{self.role}_leave", member=lease.member, shard=lease.shard,
            reason=reason)
        return True

    def validate(self, member: int, epoch: int) -> bool:
        """The fencing check at push time: ``(member, epoch)`` names a
        live, unlapsed lease. A lapsed lease is expired here, so fencing
        holds between :meth:`expire` sweeps; nothing is renewed."""
        with self._lock:
            return self._live_locked(member, epoch) is not None

    def expire(self, now: Optional[float] = None) -> List[WorkerLease]:
        """Sweep: declare every lapsed lease dead; returns the newly
        dead."""
        now = self.clock() if now is None else now
        with self._lock:
            lapsed = [l for l in self._members.values()
                      if l.alive and now > l.deadline]
            for lease in lapsed:
                self._expire_locked(lease, reason="lease-lapsed")
        return lapsed

    def evict(self, member: int, reason: str = "process-exit") -> bool:
        """A death the coordinator saw (a killed process): fence the lease
        now, without waiting out its timeout. Not an expiry."""
        with self._lock:
            lease = self._members.get(int(member))
            if lease is None or not lease.alive:
                return False
            lease.alive = False
            lease.reason = reason
            self.evictions += 1
            self._update_gauge_locked()
        global_recorder().record(
            f"{self.role}_lost", member=lease.member, shard=lease.shard,
            reason=reason)
        return True

    # ------------------------------------------------------------- queries
    def live_members(self) -> List[WorkerLease]:
        with self._lock:
            return [l for l in self._members.values() if l.alive]

    def live_member_for_shard(self, shard: int) -> Optional[WorkerLease]:
        with self._lock:
            live = [l for l in self._members.values()
                    if l.alive and l.shard == int(shard)]
        return max(live, key=lambda l: l.epoch) if live else None

    def member_by_name(self, name: str) -> Optional[WorkerLease]:
        with self._lock:
            named = [l for l in self._members.values() if l.name == name]
        return max(named, key=lambda l: l.epoch) if named else None

    def lease(self, member: int) -> Optional[WorkerLease]:
        with self._lock:
            return self._members.get(int(member))

    def stats(self) -> dict:
        with self._lock:
            live = sum(1 for l in self._members.values() if l.alive)
            return {"live": live, "joins": self.joins,
                    "lease_expiries": self.lease_expiries,
                    "evictions": self.evictions, "leaves": self.leaves}

    def _expire_locked(self, lease: WorkerLease, reason: str) -> None:
        lease.alive = False
        lease.reason = reason
        self.lease_expiries += 1
        _lease_expiries.inc()
        self._update_gauge_locked()
        global_recorder().record(
            f"{self.role}_lost", member=lease.member, shard=lease.shard,
            reason=reason)

    def _update_gauge_locked(self) -> None:
        _live_workers.set(
            sum(1 for l in self._members.values() if l.alive))
