"""Training-stats storage.

Counterpart of ``deeplearning4j_tpu/ui/storage.py`` (reference
deeplearning4j-core api/storage/{StatsStorage,StatsStorageRouter,
StatsStorageListener,Persistable}.java): a Persistable record is keyed by
(sessionID, typeID, workerID, timestamp); the backends are an in-memory dict
store and a stdlib-sqlite3 file store sharing one API, and listeners receive
post events. The sqlite schema is the JAX package's, so either package reads
a file the other wrote (the trace index ``trace_index.db`` of
``observability/tracing.py`` is one). Standard library only.
"""
from __future__ import annotations

import sqlite3
import threading
from typing import Callable, Dict, List, Optional, Tuple


class Persistable:
    """Binary-encodable record (reference api/storage/Persistable.java)."""

    def get_session_id(self) -> str:
        raise NotImplementedError

    def get_type_id(self) -> str:
        raise NotImplementedError

    def get_worker_id(self) -> str:
        raise NotImplementedError

    def get_timestamp(self) -> int:
        raise NotImplementedError

    def encode(self) -> bytes:
        raise NotImplementedError

    @classmethod
    def decode(cls, data: bytes) -> "Persistable":
        raise NotImplementedError


class StatsStorageEvent:
    def __init__(self, kind: str, session_id: str, type_id: str, worker_id: str,
                 timestamp: int):
        self.kind = kind  # NewSessionID / NewTypeID / NewWorkerID / PostStaticInfo / PostUpdate
        self.session_id = session_id
        self.type_id = type_id
        self.worker_id = worker_id
        self.timestamp = timestamp


class StatsStorageRouter:
    """Write-side interface (reference StatsStorageRouter.java)."""

    def put_static_info(self, record: Persistable) -> None:
        raise NotImplementedError

    def put_update(self, record: Persistable) -> None:
        raise NotImplementedError


class StatsStorage(StatsStorageRouter):
    """Read+write+listen (reference StatsStorage.java)."""

    def __init__(self):
        self._listeners: List[Callable[[StatsStorageEvent], None]] = []

    # ------------------------------------------------------------------ listeners
    def register_stats_storage_listener(self, listener) -> None:
        self._listeners.append(listener)

    def deregister_stats_storage_listener(self, listener) -> None:
        self._listeners.remove(listener)

    def _notify(self, event: StatsStorageEvent) -> None:
        for cb in self._listeners:
            cb(event)

    # ------------------------------------------------------------------ read API
    def list_session_ids(self) -> List[str]:
        raise NotImplementedError

    def list_type_ids_for_session(self, session_id: str) -> List[str]:
        raise NotImplementedError

    def list_worker_ids_for_session(self, session_id: str) -> List[str]:
        raise NotImplementedError

    def get_all_updates_after(self, session_id: str, type_id: str,
                              worker_id: str, timestamp: int) -> List[bytes]:
        raise NotImplementedError

    def get_latest_update(self, session_id: str, type_id: str,
                          worker_id: str) -> Optional[bytes]:
        raise NotImplementedError

    def get_static_info(self, session_id: str, type_id: str,
                        worker_id: str) -> Optional[bytes]:
        raise NotImplementedError

    def get_num_updates(self, session_id: str, type_id: str,
                        worker_id: str) -> int:
        return len(self.get_all_updates_after(session_id, type_id, worker_id, -1))


class InMemoryStatsStorage(StatsStorage):
    """reference ui-model storage/InMemoryStatsStorage.java"""

    def __init__(self):
        super().__init__()
        self._static: Dict[Tuple[str, str, str], bytes] = {}
        self._updates: Dict[Tuple[str, str, str], List[Tuple[int, bytes]]] = {}
        self._lock = threading.Lock()

    def put_static_info(self, record: Persistable) -> None:
        key = (record.get_session_id(), record.get_type_id(), record.get_worker_id())
        with self._lock:
            new_session = key[0] not in {k[0] for k in
                                         list(self._static) + list(self._updates)}
            self._static[key] = record.encode()
        if new_session:
            self._notify(StatsStorageEvent("NewSessionID", *key, record.get_timestamp()))
        self._notify(StatsStorageEvent("PostStaticInfo", *key, record.get_timestamp()))

    def put_update(self, record: Persistable) -> None:
        key = (record.get_session_id(), record.get_type_id(), record.get_worker_id())
        with self._lock:
            self._updates.setdefault(key, []).append(
                (record.get_timestamp(), record.encode()))
        self._notify(StatsStorageEvent("PostUpdate", *key, record.get_timestamp()))

    def list_session_ids(self) -> List[str]:
        return sorted({k[0] for k in list(self._static) + list(self._updates)})

    def list_type_ids_for_session(self, session_id: str) -> List[str]:
        return sorted({k[1] for k in list(self._static) + list(self._updates)
                       if k[0] == session_id})

    def list_worker_ids_for_session(self, session_id: str) -> List[str]:
        return sorted({k[2] for k in list(self._static) + list(self._updates)
                       if k[0] == session_id})

    def get_all_updates_after(self, session_id: str, type_id: str, worker_id: str,
                              timestamp: int) -> List[bytes]:
        rows = self._updates.get((session_id, type_id, worker_id), [])
        return [b for ts, b in rows if ts > timestamp]

    def get_latest_update(self, session_id: str, type_id: str,
                          worker_id: str) -> Optional[bytes]:
        rows = self._updates.get((session_id, type_id, worker_id), [])
        return rows[-1][1] if rows else None

    def get_static_info(self, session_id: str, type_id: str,
                        worker_id: str) -> Optional[bytes]:
        return self._static.get((session_id, type_id, worker_id))


class FileStatsStorage(StatsStorage):
    """Durable single-file storage over stdlib sqlite3 (reference
    J7FileStatsStorage.java, which is also SQLite-backed)."""

    def __init__(self, path: str):
        super().__init__()
        self.path = path
        self._lock = threading.Lock()
        self._conn = sqlite3.connect(path, check_same_thread=False)
        with self._conn:
            self._conn.execute(
                "CREATE TABLE IF NOT EXISTS static_info ("
                "session_id TEXT, type_id TEXT, worker_id TEXT, ts INTEGER, "
                "data BLOB, PRIMARY KEY (session_id, type_id, worker_id))")
            self._conn.execute(
                "CREATE TABLE IF NOT EXISTS updates ("
                "session_id TEXT, type_id TEXT, worker_id TEXT, ts INTEGER, "
                "data BLOB)")

    def close(self) -> None:
        self._conn.close()

    def put_static_info(self, record: Persistable) -> None:
        key = (record.get_session_id(), record.get_type_id(), record.get_worker_id())
        with self._lock, self._conn:
            self._conn.execute(
                "INSERT OR REPLACE INTO static_info VALUES (?,?,?,?,?)",
                (*key, record.get_timestamp(), record.encode()))
        self._notify(StatsStorageEvent("PostStaticInfo", *key, record.get_timestamp()))

    def put_update(self, record: Persistable) -> None:
        key = (record.get_session_id(), record.get_type_id(), record.get_worker_id())
        with self._lock, self._conn:
            self._conn.execute("INSERT INTO updates VALUES (?,?,?,?,?)",
                               (*key, record.get_timestamp(), record.encode()))
        self._notify(StatsStorageEvent("PostUpdate", *key, record.get_timestamp()))

    def list_session_ids(self) -> List[str]:
        cur = self._conn.execute(
            "SELECT DISTINCT session_id FROM updates "
            "UNION SELECT DISTINCT session_id FROM static_info")
        return sorted(r[0] for r in cur.fetchall())

    def list_type_ids_for_session(self, session_id: str) -> List[str]:
        cur = self._conn.execute(
            "SELECT DISTINCT type_id FROM updates WHERE session_id=? "
            "UNION SELECT DISTINCT type_id FROM static_info WHERE session_id=?",
            (session_id, session_id))
        return sorted(r[0] for r in cur.fetchall())

    def list_worker_ids_for_session(self, session_id: str) -> List[str]:
        cur = self._conn.execute(
            "SELECT DISTINCT worker_id FROM updates WHERE session_id=? "
            "UNION SELECT DISTINCT worker_id FROM static_info WHERE session_id=?",
            (session_id, session_id))
        return sorted(r[0] for r in cur.fetchall())

    def get_all_updates_after(self, session_id: str, type_id: str, worker_id: str,
                              timestamp: int) -> List[bytes]:
        cur = self._conn.execute(
            "SELECT data FROM updates WHERE session_id=? AND type_id=? AND "
            "worker_id=? AND ts>? ORDER BY ts", (session_id, type_id, worker_id,
                                                 timestamp))
        return [r[0] for r in cur.fetchall()]

    def get_latest_update(self, session_id: str, type_id: str,
                          worker_id: str) -> Optional[bytes]:
        cur = self._conn.execute(
            "SELECT data FROM updates WHERE session_id=? AND type_id=? AND "
            "worker_id=? ORDER BY ts DESC LIMIT 1", (session_id, type_id, worker_id))
        row = cur.fetchone()
        return row[0] if row else None

    def get_static_info(self, session_id: str, type_id: str,
                        worker_id: str) -> Optional[bytes]:
        cur = self._conn.execute(
            "SELECT data FROM static_info WHERE session_id=? AND type_id=? AND "
            "worker_id=?", (session_id, type_id, worker_id))
        row = cur.fetchone()
        return row[0] if row else None
