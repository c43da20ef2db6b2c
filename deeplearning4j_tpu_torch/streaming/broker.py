"""Loopback TCP broker and a reconnecting consumer behind the Route API.

Counterpart of ``deeplearning4j_tpu/streaming/broker.py`` (the Kafka leg
of dl4j-streaming's routes), with Kafka's two load-bearing properties:

* **offset-addressed topic logs**: every published message gets a dense
  offset in its topic, and consumers fetch from an offset, so delivery can
  be replayed;
* **committed consumer offsets**: a consumer group commits the offset it
  has handled; after a dropped connection the consumer asks for its
  committed offset and resumes at the next message, so nothing is lost (at
  least once: a message handled but not yet committed is redelivered).

Frames are ``streaming/wire.py``'s, the same the parameter server's TCP
transport speaks, so a JAX producer feeds a port consumer and the other way
round. :class:`ReconnectingConsumer` has the queue seam a ``Route``
consumes, so ``BrokerTrainingRoute`` is ``TrainingRoute`` over the network.
Arrays decode through ``wire.decode_array``. A consumer takes the JAX
signature's ``native_decode`` flag, and decodes through the wire with it
too: the host runtime's ``nativert.decode_records`` gives the same float32
values bitwise and was no faster on these frames (``PERF.md``). As in the
JAX package, messages published and delivered count in
``dl4j_broker_messages_total`` by op and consumer reconnects in
``dl4j_broker_reconnects_total``; a broker error, a fault-injected drop and
a reconnect are flight-recorder events. ``stats()`` keeps one broker's
counts. A publish under an ambient span stamps that span's
``traceparent`` into the message meta (``wire.py``); a consumer that
fetches such a message opens and finishes ``broker.consume`` parented on
it, and keeps that span's ref in ``last_trace_ref`` for the work the message
feeds (the elastic worker's push window parents there).
"""
from __future__ import annotations

import queue
import socket
import threading
import time
from collections import Counter
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..observability.flight_recorder import global_recorder
from ..observability.metrics import global_registry
from ..observability.tracing import (
    TRACEPARENT_HEADER, current_span, parse_traceparent, start_span)
from ..observability.names import (
    BROKER_MESSAGES_TOTAL, BROKER_RECONNECTS_TOTAL)
from . import Route, wire

_messages = global_registry().counter(
    BROKER_MESSAGES_TOTAL, "broker messages by op (publish|deliver)")
_published = _messages.labels(op="publish")
_delivered = _messages.labels(op="deliver")
_reconnects = global_registry().counter(
    BROKER_RECONNECTS_TOTAL, "consumer reconnects after a dropped broker "
                             "connection").labels()


class LoopbackBroker:
    """In-memory topic logs served over loopback TCP.

    Ops: ``publish(topic)`` -> offset; ``fetch(topic, offset, max_wait_s)``
    -> one message or ``{"eof": true}``; ``commit(topic, group, offset)``;
    ``committed(topic, group)`` -> offset. :meth:`drop_connections` closes
    every client socket (fault injection)."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0):
        self._host, self._port = host, port
        self._topics: Dict[str, List[Tuple[dict, bytes]]] = {}
        self._commits: Dict[Tuple[str, str], int] = {}
        self._cond = threading.Condition()
        self._stop = threading.Event()
        self._lsock: Optional[socket.socket] = None
        self._conns: List[socket.socket] = []
        self._threads: List[threading.Thread] = []
        #: messages by op (publish, deliver) and connection drops
        self.counts: Counter = Counter()

    @property
    def port(self) -> int:
        return self._port

    @property
    def address(self) -> Tuple[str, int]:
        return (self._host, self._port)

    def start(self) -> "LoopbackBroker":
        self._lsock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._lsock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._lsock.bind((self._host, self._port))
        self._lsock.listen(32)
        self._lsock.settimeout(0.2)
        self._port = self._lsock.getsockname()[1]
        t = threading.Thread(target=self._accept_loop, daemon=True,
                             name="broker-accept")
        t.start()
        self._threads.append(t)
        return self

    def _accept_loop(self) -> None:
        while not self._stop.is_set():
            try:
                conn, _ = self._lsock.accept()
            except socket.timeout:
                continue
            except OSError:
                break  # listener closed by stop()
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            with self._cond:
                self._conns.append(conn)
            t = threading.Thread(target=self._serve_conn, args=(conn,),
                                 daemon=True, name="broker-conn")
            t.start()
            self._threads.append(t)

    def _serve_conn(self, conn: socket.socket) -> None:
        with conn:
            while not self._stop.is_set():
                try:
                    header, payload = wire.recv_frame(conn)
                    reply, buf = self._handle(header, payload)
                    wire.send_frame(conn, reply, buf)
                except (ConnectionError, OSError):
                    return  # client gone, or dropped by fault injection
                except Exception as e:  # replied to the client, recorded
                    with self._cond:
                        self.counts["errors"] += 1
                    global_recorder().record("broker_error", error=repr(e))
                    try:
                        wire.send_frame(conn, {"error": repr(e)})
                    except OSError:
                        pass  # the peer is gone already
                    return

    def _handle(self, header: dict, payload):
        op = header.get("op")
        if op == "publish":
            with self._cond:
                log = self._topics.setdefault(header["topic"], [])
                offset = len(log)
                log.append((header.get("meta", {}), bytes(payload)))
                self.counts["publish"] += 1
                _published.inc()
                self._cond.notify_all()
            return {"offset": offset}, b""
        if op == "fetch":
            topic, offset = header["topic"], int(header["offset"])
            deadline = time.time() + float(header.get("max_wait_s", 0.0))
            with self._cond:
                while True:
                    log = self._topics.get(topic, [])
                    if offset < len(log):
                        meta, buf = log[offset]
                        self.counts["deliver"] += 1
                        _delivered.inc()
                        return {"offset": offset, "meta": meta}, buf
                    left = deadline - time.time()
                    if left <= 0 or self._stop.is_set():
                        return {"eof": True}, b""
                    self._cond.wait(min(left, 0.1))
        if op == "commit":
            with self._cond:
                key = (header["topic"], header["group"])
                self._commits[key] = max(self._commits.get(key, -1),
                                         int(header["offset"]))
            return {"ok": True}, b""
        if op == "committed":
            with self._cond:
                off = self._commits.get((header["topic"], header["group"]),
                                        -1)
            return {"offset": off}, b""
        raise ValueError(f"unknown broker op {op!r}")

    def depth(self, topic: str) -> int:
        with self._cond:
            return len(self._topics.get(topic, []))

    def committed(self, topic: str, group: str) -> int:
        """A group's committed offset (-1: nothing committed), which the
        elastic coordinator compares with a shard's fin offset."""
        with self._cond:
            return self._commits.get((topic, group), -1)

    def drop_connections(self) -> int:
        """Fault injection: close every live client socket (consumers
        reconnect and resume from their committed offset)."""
        with self._cond:
            conns, self._conns = self._conns, []
            self.counts["dropped"] += len(conns)
        global_recorder().record("broker_drop_connections", n=len(conns))
        for conn in conns:
            try:
                conn.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass  # the client closed first
            conn.close()
        return len(conns)

    def stats(self) -> dict:
        with self._cond:
            return {**dict(self.counts), "topics": {
                t: len(log) for t, log in self._topics.items()}}

    def stop(self) -> None:
        self._stop.set()
        with self._cond:
            self._cond.notify_all()
        if self._lsock is not None:
            self._lsock.close()
        self.drop_connections()
        for t in self._threads:
            t.join(timeout=5)


class BrokerProducer:
    """Publish framed array messages to a topic. A dead connection (after
    the broker's fault-injection drop) reconnects and retries once: a
    publish returns its offset or raises."""

    def __init__(self, addr: Tuple[str, int]):
        self._addr = tuple(addr)
        self._sock = wire.connect(self._addr)

    def publish(self, topic: str, arrays: Dict[str, np.ndarray],
                meta: Optional[dict] = None, codec: str = "none") -> int:
        metas, payload = wire.pack_arrays(arrays, codec)
        full_meta = dict(meta or {}, arrays=metas)
        # the ambient span rides the message, so the consumer's process
        # parents under the same trace id
        sp = current_span()
        if sp is not None and TRACEPARENT_HEADER not in full_meta:
            full_meta[TRACEPARENT_HEADER] = sp.traceparent()
        header = {"op": "publish", "topic": topic, "meta": full_meta}
        try:
            reply, _, _ = wire.request(self._sock, header, payload)
        except (ConnectionError, OSError):
            self._sock.close()
            self._sock = wire.connect(self._addr)
            reply, _, _ = wire.request(self._sock, header, payload)
        return reply["offset"]

    def close(self) -> None:
        self._sock.close()


class ReconnectingConsumer:
    """A queue-shaped view of one ``(topic, group)`` subscription.

    It has the seam ``Route._run`` and ``Route.drain`` consume (``get``,
    ``task_done``, ``unfinished_tasks``, ``all_tasks_done``) over a broker
    connection that may die: every socket error reconnects and resumes
    from the committed offset. ``task_done`` commits the delivered offset
    (handled, then committed: at least once)."""

    def __init__(self, addr: Tuple[str, int], topic: str,
                 group: str = "default", reconnect_backoff_s: float = 0.05,
                 reconnect_backoff_cap_s: float = 1.0,
                 native_decode: bool = False):
        del native_decode  # the wire decode serves both settings
        self._addr = tuple(addr)
        self.topic, self.group = topic, group
        self._backoff = reconnect_backoff_s
        self._backoff_cap = max(reconnect_backoff_s, reconnect_backoff_cap_s)
        self._cur_backoff = reconnect_backoff_s
        self._sock: Optional[socket.socket] = None
        self._next: Optional[int] = None   # next offset to fetch
        self._delivered: Optional[int] = None  # offset awaiting task_done
        self._last_delivered: Optional[int] = None  # high-water mark
        #: the last delivered message's broker.consume span (None when it
        #: carried no trace)
        self.last_trace_ref = None
        self.reconnects = 0
        self.unfinished_tasks = 0
        self.all_tasks_done = threading.Condition()

    def _connect(self) -> None:
        self._sock = wire.connect(self._addr, timeout=10.0)
        reply, _, _ = wire.request(
            self._sock, {"op": "committed", "topic": self.topic,
                         "group": self.group})
        self._next = reply["offset"] + 1  # resume after the committed one

    def _ensure(self) -> None:
        if self._sock is None:
            if self._next is not None:  # not the first connect: a drop
                self.reconnects += 1
                _reconnects.inc()
                global_recorder().record(
                    "broker_reconnect", topic=self.topic, group=self.group,
                    n=self.reconnects)
            self._connect()

    def _drop(self) -> None:
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass  # already dead, which is why it is dropped
            self._sock = None

    def get(self, timeout: float = 0.05):
        """The next message as ``(meta, {name: array})``; raises
        ``queue.Empty`` when the log has nothing within ``timeout``."""
        deadline = time.time() + timeout
        while True:
            try:
                self._ensure()
                reply, payload, _ = wire.request(
                    self._sock,
                    {"op": "fetch", "topic": self.topic,
                     "offset": self._next,
                     "max_wait_s": max(0.0, deadline - time.time())})
            except (ConnectionError, OSError, RuntimeError):
                self._drop()
                if time.time() >= deadline:
                    raise queue.Empty from None
                # back off exponentially while the broker stays away
                time.sleep(min(self._cur_backoff,
                               max(0.0, deadline - time.time())))
                self._cur_backoff = min(self._cur_backoff * 2.0,
                                        self._backoff_cap)
                continue
            if reply.get("eof"):
                raise queue.Empty
            meta = reply["meta"]
            arrays = wire.unpack_arrays(meta.get("arrays", []), payload)
            self._cur_backoff = self._backoff
            self._delivered = reply["offset"]
            self._last_delivered = reply["offset"]
            self._next = reply["offset"] + 1
            ref = parse_traceparent(meta.get(TRACEPARENT_HEADER))
            if ref is not None:
                # the consume hop, parented on the producer's span and
                # finished at once; the handling work parents on its ref
                csp = start_span("broker.consume", parent=ref,
                                 topic=self.topic, group=self.group,
                                 offset=reply["offset"])
                csp.finish()
                self.last_trace_ref = csp.ref()
            else:
                self.last_trace_ref = None
            with self.all_tasks_done:
                self.unfinished_tasks += 1
            return meta, arrays

    def _commit(self, offset: int) -> bool:
        try:
            self._ensure()
            wire.request(self._sock,
                         {"op": "commit", "topic": self.topic,
                          "group": self.group, "offset": offset})
        except (ConnectionError, OSError, RuntimeError):
            # the commit is lost with the connection: the message is
            # delivered again after the reconnect, never skipped
            self._drop()
            return False
        return True

    def task_done(self) -> None:
        offset, self._delivered = self._delivered, None
        if offset is not None:
            self._commit(offset)
        with self.all_tasks_done:
            if self.unfinished_tasks > 0:
                self.unfinished_tasks -= 1
            if not self.unfinished_tasks:
                self.all_tasks_done.notify_all()

    def commit_delivered(self) -> Optional[int]:
        """Commit the highest offset delivered so far, without the
        ``task_done`` count: the elastic worker calls it once a push window
        has landed on the server, so a crash redelivers at most one
        window. Returns the committed offset, or None (nothing delivered
        yet, or the commit was lost, which is not retried: redelivery is
        the safe direction)."""
        offset = self._last_delivered
        if offset is None:
            return None
        return offset if self._commit(offset) else None

    def close(self) -> None:
        self._drop()


class BrokerIngestSource:
    """Iterable over a subscription's array messages, for
    ``datasets.prefetch.DevicePrefetcher``. Iteration ends at a
    ``fin``-marked message or after ``idle_timeout_s`` without data."""

    def __init__(self, consumer: ReconnectingConsumer,
                 idle_timeout_s: float = 5.0):
        self._consumer = consumer
        self._idle_timeout_s = float(idle_timeout_s)

    def __iter__(self):
        idle_deadline = time.time() + self._idle_timeout_s
        while True:
            try:
                meta, arrays = self._consumer.get(timeout=0.25)
            except queue.Empty:
                if time.time() >= idle_deadline:
                    return
                continue
            idle_deadline = time.time() + self._idle_timeout_s
            self._consumer.task_done()
            if meta.get("fin"):
                return
            yield arrays


class BrokerTrainingRoute(Route):
    """Online training fed by the broker: ``(x, y)`` array messages from a
    ``(topic, group)`` subscription -> ``model.fit``, surviving dropped
    broker connections."""

    def __init__(self, model, addr: Tuple[str, int], topic: str,
                 group: str = "train"):
        self.model = model
        super().__init__(ReconnectingConsumer(addr, topic, group),
                         self._train)

    def _train(self, msg) -> None:
        _, arrays = msg
        self.model.fit(np.asarray(arrays["x"], np.float32),
                       np.asarray(arrays["y"], np.float32))

    def stop(self) -> None:
        super().stop()
        self.source.close()
