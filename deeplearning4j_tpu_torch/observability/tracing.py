"""End-to-end request tracing: W3C trace context and a tail-sampled store.

Counterpart of ``deeplearning4j_tpu/observability/tracing.py``. The metrics
registry and the flight recorder answer "how is the fleet doing"; this plane
answers "where did this request's time go": admission, the batcher's queue,
the dispatch, a paged-KV park, the decode phases. It is Dapper-shaped:

- **Ids** are W3C ``traceparent`` strings, ``00-<32 hex trace>-<16 hex
  span>-<2 hex flags>``. :func:`parse_traceparent` accepts an incoming
  header (so an upstream gateway's ids propagate through the server; a
  malformed one mints a fresh trace) and :meth:`Span.traceparent`
  serializes one for the response echo or the next hop.
- **Propagation** is a ``contextvars`` variable: ``trace_span(name)``
  parents under the ambient span of the running thread. Work that crosses
  threads (the micro-batcher's dispatcher, the decode pump, a replica's
  batcher, a PS server thread) carries an explicit :class:`SpanRef` on the
  request or session object instead, and the other side parents or links
  from it; across processes the ``traceparent`` rides a frame header or a
  broker message's meta.
- **Fan-in** uses span links: one batch dispatch span *links* the N member
  requests' spans (OTel batch-consumer semantics).
- **Sampling is tail-based**: every span of a live trace is buffered and
  the keep/drop decision runs when the trace completes, so errors,
  rejections (a 429) and roots above the rolling p99 are always kept, even
  at a head probability of 0; other traces are kept with probability
  ``DL4J_TRACE_SAMPLE`` (default 1.0: the ring bounds memory, not the
  sampler).
- **Nothing allocated when off**: ``trace_span()`` and ``start_span()``
  return one process-wide no-op singleton when tracing is disabled.

Everything here is host bookkeeping (``time.perf_counter``, dicts, a
lock): no span reads a device value or allocates device memory, so a span
may sit on the decode pump's path or inside a CUDA graph capture.

Kept traces append to ``traces.jsonl`` and index into ``trace_index.db`` (a
:class:`~deeplearning4j_tpu_torch.ui.storage.FileStatsStorage` sqlite file,
the JAX package's schema) when a base directory is set
(``DL4J_TRACE_DIR``); the in-memory ring serves ``GET /serve/traces``
either way. Environment: ``DL4J_TRACE`` (0/false/off disables),
``DL4J_TRACE_SAMPLE``, ``DL4J_TRACE_DIR``, ``DL4J_TRACE_CAPACITY``.
"""
from __future__ import annotations

import collections
import contextvars
import json
import os
import random
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

from . import names as _n

ENABLE_ENV = "DL4J_TRACE"
SAMPLE_ENV = "DL4J_TRACE_SAMPLE"
DIR_ENV = "DL4J_TRACE_DIR"
CAPACITY_ENV = "DL4J_TRACE_CAPACITY"
TRACEPARENT_HEADER = "traceparent"
INDEX_DB = "trace_index.db"
TRACES_JSONL = "traces.jsonl"
#: completed traces retained in memory (ring; oldest evicted)
DEFAULT_CAPACITY = 512
#: sqlite index session/type ids (FileStatsStorage vocabulary)
_INDEX_SESSION = "traces"
_INDEX_TYPE = "TraceRecord"

_rand = random.Random()


# --------------------------------------------------------------------- ids

def _new_trace_id() -> str:
    return f"{_rand.getrandbits(128):032x}"


def _new_span_id() -> str:
    return f"{_rand.getrandbits(64):016x}"


def parse_traceparent(header: Optional[str]) -> Optional["SpanRef"]:
    """``00-<32hex>-<16hex>-<2hex>`` -> SpanRef, else None (malformed
    headers mint a fresh trace rather than erroring the request)."""
    if not header:
        return None
    parts = header.strip().split("-")
    if len(parts) != 4:
        return None
    ver, trace_id, span_id, _flags = parts
    if len(ver) != 2 or len(trace_id) != 32 or len(span_id) != 16:
        return None
    try:
        int(ver, 16), int(trace_id, 16), int(span_id, 16)
    except ValueError:
        return None
    if ver == "ff" or trace_id == "0" * 32 or span_id == "0" * 16:
        return None
    return SpanRef(trace_id, span_id)


def format_traceparent(trace_id: str, span_id: str) -> str:
    return f"00-{trace_id}-{span_id}-01"


class SpanRef:
    """A (trace_id, span_id) pair that travels across threads/objects where
    the contextvar cannot — on ``_Request`` slots, ``DecodeSession``s, and
    as batch span links."""

    __slots__ = ("trace_id", "span_id")

    def __init__(self, trace_id: str, span_id: str):
        self.trace_id = trace_id
        self.span_id = span_id

    def traceparent(self) -> str:
        return format_traceparent(self.trace_id, self.span_id)

    def __repr__(self):  # pragma: no cover - debugging aid
        return f"SpanRef({self.traceparent()})"


# ------------------------------------------------------------------- spans

_current: contextvars.ContextVar[Optional["Span"]] = \
    contextvars.ContextVar("dl4j_trace_span", default=None)


class Span:
    """One timed operation. Context-manager entry makes it the ambient
    parent for the thread; manual ``start_span``/``finish()`` use skips the
    contextvar entirely (cross-thread spans owned by request/session
    objects)."""

    __slots__ = ("trace_id", "span_id", "parent_id", "name", "ts", "mono",
                 "status", "attrs", "links", "_store", "_t0", "_token",
                 "_finished")

    def __init__(self, store: "TraceStore", name: str,
                 parent: Optional[object], links: Tuple[SpanRef, ...],
                 attrs: Optional[Dict[str, Any]]):
        if parent is None:
            parent = _current.get()
        if parent is not None:
            self.trace_id = parent.trace_id
            self.parent_id = parent.span_id
        else:
            self.trace_id = _new_trace_id()
            self.parent_id = None
        self.span_id = _new_span_id()
        self.name = name
        self.ts = time.time()
        self.mono = time.perf_counter()
        self._t0 = self.mono
        self.status = "ok"
        self.attrs = attrs or {}
        self.links = tuple(links)
        self._store = store
        self._token = None
        self._finished = False
        store._open(self)

    # -- mutation -------------------------------------------------------
    def set_attr(self, **kv) -> "Span":
        self.attrs.update(kv)
        return self

    def add_link(self, ref: Optional[SpanRef]) -> "Span":
        if ref is not None:
            self.links = self.links + (ref,)
        return self

    def set_status(self, status: str) -> "Span":
        self.status = status
        return self

    # -- identity -------------------------------------------------------
    def ref(self) -> SpanRef:
        return SpanRef(self.trace_id, self.span_id)

    def traceparent(self) -> str:
        return format_traceparent(self.trace_id, self.span_id)

    # -- lifecycle ------------------------------------------------------
    def finish(self) -> None:
        if self._finished:
            return
        self._finished = True
        dur = time.perf_counter() - self._t0
        self._store._close(self, dur)

    def __enter__(self) -> "Span":
        self._token = _current.set(self)
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        if self._token is not None:
            _current.reset(self._token)
            self._token = None
        if exc_type is not None and self.status == "ok":
            self.status = "error"
            self.attrs.setdefault("error", repr(exc))
        self.finish()
        return False


class _NoopSpan:
    """The disabled path: one shared instance, every method a no-op, usable
    both as a context manager and via manual finish()."""

    __slots__ = ()
    trace_id = ""
    span_id = ""
    parent_id = None
    name = ""
    status = "ok"
    links = ()

    def set_attr(self, **kv):
        return self

    def add_link(self, ref):
        return self

    def set_status(self, status):
        return self

    def ref(self):
        return None

    def traceparent(self) -> str:
        return ""

    def finish(self) -> None:
        pass

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        return False


NOOP_SPAN = _NoopSpan()


def trace_span(name: str, *, parent: Optional[object] = None,
               links: Tuple[SpanRef, ...] = (), **attrs):
    """Start a span for ``with`` use: child of ``parent`` (a Span or
    SpanRef), else of the thread's ambient span, else a new trace root.
    Returns the no-op singleton when tracing is off."""
    st = _STORE
    if st is None or not st.enabled:
        return NOOP_SPAN
    return Span(st, name, parent, links, attrs)


def start_span(name: str, *, parent: Optional[object] = None,
               links: Tuple[SpanRef, ...] = (), **attrs):
    """Start a span WITHOUT entering it (the cross-thread form: the caller
    owns it on an object attribute and calls ``finish()`` later; the
    ambient contextvar is untouched)."""
    st = _STORE
    if st is None or not st.enabled:
        return NOOP_SPAN
    return Span(st, name, parent, links, attrs)


def current_span() -> Optional[Span]:
    """The thread's ambient span (None outside any ``with trace_span``)."""
    return _current.get()


# ------------------------------------------------------------------- store

def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, default))
    except (TypeError, ValueError):
        return default


def _env_int(name: str, default: int) -> int:
    try:
        return int(os.environ.get(name, default))
    except (TypeError, ValueError):
        return default


class _TraceRecord:
    """Duck-typed Persistable for the FileStatsStorage sqlite index (the
    JAX package's session and type ids, so either package reads it)."""

    def __init__(self, entry: dict):
        self.entry = entry

    def get_session_id(self) -> str:
        return _INDEX_SESSION

    def get_type_id(self) -> str:
        return _INDEX_TYPE

    def get_worker_id(self) -> str:
        return self.entry.get("trace_id", "?")

    def get_timestamp(self) -> int:
        return int(self.entry.get("ts", 0.0) * 1000)

    def encode(self) -> bytes:
        return json.dumps(self.entry).encode("utf-8")

    @classmethod
    def decode(cls, data: bytes) -> "_TraceRecord":
        return cls(json.loads(data.decode("utf-8")))


class TraceStore:
    """Bounded store of completed span trees with tail-based sampling.

    Live traces accumulate finished spans in ``_live``; when a trace's last
    open span closes the tree is finalized and the keep/drop decision runs:
    error/rejected status and roots slower than the rolling p99 ALWAYS
    keep, everything else keeps with probability ``sample``. Kept traces
    enter the in-memory ring (and the JSONL + sqlite index when
    ``base_dir`` is set); dropped traces count into
    ``dl4j_trace_traces_dropped_total`` and vanish.
    """

    def __init__(self, *, capacity: Optional[int] = None,
                 sample: Optional[float] = None,
                 base_dir: Optional[str] = None,
                 enabled: Optional[bool] = None,
                 registry=None):
        if enabled is None:
            enabled = os.environ.get(ENABLE_ENV, "1").lower() \
                not in ("0", "false", "off")
        self.enabled = bool(enabled)
        self.capacity = capacity if capacity is not None \
            else _env_int(CAPACITY_ENV, DEFAULT_CAPACITY)
        self.sample = sample if sample is not None \
            else _env_float(SAMPLE_ENV, 1.0)
        self.base_dir = base_dir if base_dir is not None \
            else os.environ.get(DIR_ENV) or None
        self._lock = threading.Lock()
        #: trace_id -> {"open": int, "spans": [span dict, ...]}
        self._live: Dict[str, dict] = {}
        #: trace_id -> finalized record (insertion-ordered ring)
        self._ring: "collections.OrderedDict[str, dict]" = \
            collections.OrderedDict()
        self._durs: collections.deque = collections.deque(maxlen=512)  #: guarded-by: _lock
        #: cached rolling p99 — re-sorting 512 floats on EVERY finalize is
        #: the single biggest cost on the serve hot path, and a tail
        #: threshold that lags by <32 traces samples identically in
        #: practice
        self._p99_cache: Optional[float] = None  #: guarded-by: _lock
        self._p99_stale = 0  #: guarded-by: _lock
        #: metric name -> [(value, trace_id, ts), ...] worst-first, <=8
        self._exemplars: Dict[str, List[Tuple[float, str, float]]] = {}
        if registry is None:
            from .metrics import global_registry
            registry = global_registry()
        self._c_spans = registry.counter(
            _n.TRACE_SPANS_TOTAL, "trace spans finished")
        self._c_kept = registry.counter(
            _n.TRACE_TRACES_KEPT_TOTAL,
            "completed traces kept by the tail sampler (by reason)")
        self._c_dropped = registry.counter(
            _n.TRACE_TRACES_DROPPED_TOTAL,
            "completed traces dropped by the tail sampler")
        self._g_live = registry.gauge(
            _n.TRACE_LIVE_TRACES, "traces with open spans right now")
        #: pre-resolved label series — labels() re-keys the labelset dict
        #: on every call, which adds up at one spans-counter inc per span
        self._s_spans: Dict[str, object] = {}
        self._s_kept = {r: self._c_kept.labels(reason=r)
                        for r in ("error", "p99", "sampled")}
        self._s_dropped = {r: self._c_dropped.labels(reason=r)
                           for r in ("sampled_out", "live_overflow")}
        self._sg_live = self._g_live.labels()
        self._index_failed = False
        #: monotonic finalize counter; every record entering the ring gets
        #: the next value so drain_finished() can ship "new since seq N"
        #: to the fleet federation without re-sending the whole ring
        self._seq = 0  #: guarded-by: _lock

    # -- span bookkeeping ----------------------------------------------
    def _open(self, span: Span) -> None:
        with self._lock:
            t = self._live.get(span.trace_id)
            if t is None:
                # leak guard: a span started but never finished (a crashed
                # session) must not pin memory forever
                if len(self._live) >= 4 * self.capacity:
                    self._live.pop(next(iter(self._live)))
                    self._s_dropped["live_overflow"].inc()
                t = self._live[span.trace_id] = {"open": 0, "spans": []}
                self._sg_live.set(len(self._live))
            t["open"] += 1

    def _close(self, span: Span, dur_s: float) -> None:
        series = self._s_spans.get(span.name)
        if series is None:
            # span names are a small code-defined set; cap the handle
            # cache anyway so a buggy dynamic name can't grow it
            series = self._c_spans.labels(name=span.name)
            if len(self._s_spans) < 64:
                self._s_spans[span.name] = series
        series.inc()
        done = None
        with self._lock:
            t = self._live.get(span.trace_id)
            if t is None:  # evicted by the leak guard mid-flight
                return
            t["spans"].append({
                "trace_id": span.trace_id, "span_id": span.span_id,
                "parent_id": span.parent_id, "name": span.name,
                "ts": span.ts, "mono": span.mono,
                "dur_s": round(dur_s, 9), "status": span.status,
                "attrs": span.attrs,
                "links": [r.traceparent() for r in span.links],
            })
            t["open"] -= 1
            if t["open"] <= 0:
                done = self._live.pop(span.trace_id)
                self._sg_live.set(len(self._live))
        if done is not None:
            self._finalize(span.trace_id, done["spans"])

    # -- tail sampling --------------------------------------------------
    #: requires-lock: _lock
    def _p99(self) -> Optional[float]:
        if len(self._durs) < 20:
            return None
        if self._p99_cache is None or self._p99_stale >= 32:
            s = sorted(self._durs)
            self._p99_cache = s[min(len(s) - 1, int(len(s) * 0.99))]
            self._p99_stale = 0
        return self._p99_cache

    def _finalize(self, trace_id: str, spans: List[dict]) -> None:
        spans.sort(key=lambda s: s["mono"])
        root = next((s for s in spans if s["parent_id"] is None), spans[0])
        dur = root["dur_s"]
        bad = any(s["status"] != "ok" for s in spans)
        # tail-sampler state is shared by every finishing request thread:
        # unlocked, two finalizes race the p99 cache refresh, and
        # sorted(_durs) can see the deque mutate mid-iteration
        with self._lock:
            p99 = self._p99()
            self._durs.append(dur)
            self._p99_stale += 1
        if bad:
            reason = "error"
        elif p99 is not None and dur > p99:
            reason = "p99"
        elif self.sample >= 1.0 or _rand.random() < self.sample:
            reason = "sampled"
        else:
            self._s_dropped["sampled_out"].inc()
            return
        record = {"trace_id": trace_id, "root": root["name"],
                  "status": ("error" if bad else "ok"),
                  "ts": root["ts"], "dur_s": dur,
                  "n_spans": len(spans), "keep_reason": reason,
                  "spans": spans}
        with self._lock:
            prior = self._ring.pop(trace_id, None)
            if prior is not None:  # late fragment: merge, keep root info
                merged = prior["spans"] + spans
                merged.sort(key=lambda s: s["mono"])
                prior["spans"] = merged
                prior["n_spans"] = len(merged)
                record = prior
            self._seq += 1
            record["seq"] = self._seq
            self._ring[trace_id] = record
            while len(self._ring) > self.capacity:
                self._ring.popitem(last=False)
        self._s_kept[reason].inc()
        if self.base_dir:
            self._persist(record)

    # -- persistence ----------------------------------------------------
    def _persist(self, record: dict) -> None:
        try:
            os.makedirs(self.base_dir, exist_ok=True)
            with open(os.path.join(self.base_dir, TRACES_JSONL), "a",
                      encoding="utf-8") as f:
                f.write(json.dumps(record) + "\n")
            entry = {k: record[k] for k in
                     ("trace_id", "root", "status", "ts", "dur_s",
                      "n_spans", "keep_reason")}
            from ..ui.storage import FileStatsStorage
            st = FileStatsStorage(os.path.join(self.base_dir, INDEX_DB))
            try:
                st.put_update(_TraceRecord(entry))
            finally:
                st.close()
        except Exception:
            # persistence must never fail a request; note once
            self._index_failed = True

    def index_entries(self) -> List[dict]:
        """Decoded rows of trace_index.db, newest first (empty when no
        base_dir or nothing kept yet)."""
        if not self.base_dir:
            return []
        path = os.path.join(self.base_dir, INDEX_DB)
        if not os.path.exists(path):
            return []
        from ..ui.storage import FileStatsStorage
        st = FileStatsStorage(path)
        out = []
        try:
            for wid in st.list_worker_ids_for_session(_INDEX_SESSION):
                for blob in st.get_all_updates_after(
                        _INDEX_SESSION, _INDEX_TYPE, wid, -1):
                    try:
                        out.append(_TraceRecord.decode(blob).entry)
                    except (ValueError, UnicodeDecodeError):
                        continue
        finally:
            st.close()
        out.sort(key=lambda e: e.get("ts", 0.0), reverse=True)
        return out

    # -- reads ----------------------------------------------------------
    def get(self, trace_id: str) -> Optional[dict]:
        with self._lock:
            rec = self._ring.get(trace_id)
            return dict(rec) if rec is not None else None

    def list(self, n: int = 50) -> List[dict]:
        """Newest-first summaries (no span bodies) for /serve/traces."""
        with self._lock:
            recs = list(self._ring.values())[-n:]
        return [{k: r[k] for k in ("trace_id", "root", "status", "ts",
                                   "dur_s", "n_spans", "keep_reason")}
                for r in reversed(recs)]

    def __len__(self) -> int:
        with self._lock:
            return len(self._ring)

    # -- federation (cross-process stitch) ------------------------------
    def drain_finished(self, after_seq: int = 0) -> Tuple[int, List[dict]]:
        """Records finalized since ``after_seq`` (the export cursor of the
        fleet federation, ROADMAP.md A9.4), plus the new cursor. A late-fragment merge re-stamps its
        record with a fresh seq, so a trace that grew after its first ship
        ships again — the receiving :meth:`ingest` dedups by span id."""
        with self._lock:
            recs = [dict(r) for r in self._ring.values()
                    if r.get("seq", 0) > after_seq]
            return self._seq, recs

    def ingest(self, record: dict) -> None:
        """Merge a finalized trace record from ANOTHER process into this
        store — the cross-process half of the late-fragment merge. A
        worker's ``broker.consume``/``ps.push`` fragment lands on the
        coordinator's copy of the same trace id: spans are deduped by span
        id and re-sorted by wall ``ts`` (mono clocks do not compare across
        processes), and the summary row (root, status, dur) is recomputed
        over the union so ``/serve/traces`` shows one stitched tree."""
        spans = list(record.get("spans") or ())
        trace_id = record.get("trace_id")
        if not trace_id or not spans:
            return
        with self._lock:
            prior = self._ring.pop(trace_id, None)
            if prior is not None:
                seen = {s.get("span_id") for s in prior["spans"]}
                spans = [s for s in spans if s.get("span_id") not in seen]
                merged = prior["spans"] + spans
                rec = dict(prior)
            else:
                merged = spans
                rec = {"trace_id": trace_id,
                       "keep_reason": record.get("keep_reason", "ingested")}
            merged.sort(key=lambda s: s.get("ts", 0.0))
            root = next((s for s in merged if s.get("parent_id") is None),
                        merged[0])
            rec["spans"] = merged
            rec["n_spans"] = len(merged)
            rec["root"] = root.get("name", "?")
            rec["ts"] = root.get("ts", 0.0)
            rec["dur_s"] = root.get("dur_s", 0.0)
            rec["status"] = "error" if any(
                s.get("status") != "ok" for s in merged) else "ok"
            self._seq += 1
            rec["seq"] = self._seq
            self._ring[trace_id] = rec
            while len(self._ring) > self.capacity:
                self._ring.popitem(last=False)

    # -- exemplars ------------------------------------------------------
    def put_exemplar(self, metric: str, value: float,
                     trace_id: str) -> None:
        """Attach a trace id to a histogram observation so a burning SLO
        over that histogram can name an offending trace. Keeps the <=8
        worst observations of the last 10 minutes per metric."""
        if not trace_id:
            return
        now = time.time()
        with self._lock:
            ex = self._exemplars.setdefault(metric, [])
            ex.append((value, trace_id, now))
            ex[:] = sorted((e for e in ex if now - e[2] < 600.0),
                           reverse=True)[:8]

    def exemplar(self, metric: str,
                 window_s: Optional[float] = None) -> Optional[dict]:
        now = time.time()
        with self._lock:
            for value, trace_id, ts in self._exemplars.get(metric, ()):
                if window_s is None or now - ts <= window_s:
                    return {"trace_id": trace_id, "value": value, "ts": ts}
        return None


# ----------------------------------------------------------------- globals

_STORE: Optional[TraceStore] = None
_STORE_LOCK = threading.Lock()


def global_trace_store() -> TraceStore:
    global _STORE
    if _STORE is None:
        with _STORE_LOCK:
            if _STORE is None:
                _STORE = TraceStore()
    return _STORE


def set_global_trace_store(store: Optional[TraceStore]) -> None:
    """Swap the process store (tests install a fresh one per case)."""
    global _STORE
    _STORE = store


def configure(*, enabled: Optional[bool] = None,
              sample: Optional[float] = None,
              base_dir: Optional[str] = None,
              capacity: Optional[int] = None) -> TraceStore:
    """Adjust the global store in place (creating it if needed) and return
    it."""
    st = global_trace_store()
    if enabled is not None:
        st.enabled = bool(enabled)
    if sample is not None:
        st.sample = float(sample)
    if base_dir is not None:
        st.base_dir = base_dir or None
    if capacity is not None:
        st.capacity = int(capacity)
    return st
