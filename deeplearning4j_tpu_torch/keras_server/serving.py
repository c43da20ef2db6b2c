"""HTTP inference front-end: ``/v1/predict``, ``/v1/generate``, status.

Counterpart of ``deeplearning4j_tpu/keras_server/serving.py``: a stdlib
``ThreadingHTTPServer`` bound to loopback by default, one handler thread per
connection. Routes:

- ``POST /v1/predict`` body ``{"model": m, "inputs": [[...], ...]}``:
  micro-batched forward; 200 with ``{"predictions", "model", "version",
  "batched_with", "bucket"}`` (and ``"replica"`` in replica mode), 429 with
  ``Retry-After`` on admission overflow, 404 for unknown models, 503 on
  dispatch timeout. ``X-DL4J-Priority`` and ``X-DL4J-Tenant`` go to
  admission: under saturation low priorities are shed first, and sheds are
  counted by tenant.
- ``POST /v1/generate`` body ``{"model": m, "prompt": [ids],
  "max_new_tokens": n}``: generation over the continuous-batching
  :class:`DecodeEngine`, streamed as newline-delimited JSON, one line per
  token, then a ``{"done": true, ...}`` line. With a draft model
  (``decode_spec_draft=`` or ``registry.link_draft``) the engine decodes
  speculatively; the tokens are the same.
- ``POST /v1/stream`` body ``{"model": m, "session": s, "inputs":
  [B,T,F]}``: newline-delimited JSON, one line per timestep as it is
  computed over the ``rnn_time_step`` seam (:class:`StreamSessions`), then
  a ``{"done": true, ...}`` line; the hidden state persists server-side
  under ``session`` across requests.
- ``POST /v1/stream/reset`` body ``{"model": m, "session": s}``: drop a
  session's parked state.
- ``GET /serve/status``: models, versions, drafts, queue, decode-engine
  stats, the streaming sessions, and in replica mode the replicas and the
  autoscaler.
- ``GET /metrics``: the process-global metrics registry as Prometheus
  text (``Content-Type: text/plain; version=0.0.4``): admission, batches,
  decode, streams, the registry, the replicas, and each POST route's wall
  time in ``dl4j_serve_request_seconds{route=...}``.
- ``GET /serve/traces`` and ``GET /serve/traces/<id>``: the tail-sampled
  trace summaries, and one whole span tree (``observability/tracing.py``).
- ``GET /serve/slo``: the SLO engine's burn-rate evaluation, with trace
  exemplars (``observability/slo.py``).

Every POST reads the caller's W3C ``traceparent`` header (or mints a
trace), opens the root span ``http <path>`` as the handler thread's
ambient span, and echoes the root span's ``traceparent`` on every
response, so a client can fetch ``/serve/traces/<id>``; a 429 marks the
root ``rejected`` and a 503 or 500 ``error`` (the tail sampler keeps
both). Below the root: ``admission``, ``batch.queue`` (finished by the
dispatcher), ``replica.route`` in replica mode, ``decode.queue`` with its
``decode.prefill``/``decode.decode``/``decode.park``/``decode.preempt``
children; each ``batch.dispatch`` is a root of its own that links its
member requests. The request latency and the TTFT carry trace exemplars.

``replicas=N`` serves ``/v1/predict`` through a :class:`ReplicaSet` (a
least-queue router over N batchers, rolling hot swaps) and ``autoscale=``
sizes it with an :class:`Autoscaler` on queue pressure, the replicas then
fenced by the leases of a ``cloud.MembershipOracle`` (``membership``).
``sharding=`` (with
``replica_devices=`` and ``replica_mesh_axes=``) shards each replica's pin
over a device mesh of its slice of the device list (``replica.py``), and
``replica_devices=`` alone places unsharded replicas round-robin. The
server's :class:`SLOEngine` (``slo``, ticking while the server runs) is the
autoscaler's burn input. The fleet routes and ``active_server``/
``serve_slo`` wait for A9.4 and A9.5.
"""
from __future__ import annotations

import json
import queue
import threading
import time
from concurrent.futures import TimeoutError as _FutureTimeout
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional
from urllib.parse import urlparse

import numpy as np

from ..common import resolve_device
from ..observability import names as _n
from ..observability.metrics import global_registry
from ..observability.slo import SLOEngine
from ..observability.tracing import (
    TRACEPARENT_HEADER, global_trace_store, parse_traceparent, trace_span)
from .admission import RejectedError, normalize_priority
from .autoscaler import Autoscaler
from .batcher import MicroBatcher
from .decode import DecodeEngine
from .registry import ModelRegistry
from .replica import ReplicaSet
from .streaming import StreamSessions

#: request tags for priority-aware shedding under saturation
PRIORITY_HEADER = "X-DL4J-Priority"
TENANT_HEADER = "X-DL4J-Tenant"


class _ServeHandler(BaseHTTPRequestHandler):
    engine: "InferenceServer"  # bound via type() subclass

    # keep-alive: every response carries Content-Length or chunked framing
    protocol_version = "HTTP/1.1"
    disable_nagle_algorithm = True

    def log_message(self, fmt, *args):  # silence request logging
        pass

    #: the root span of the request in flight (no-op singleton when off)
    _trace = None
    #: the root span's traceparent, echoed on every response ("" when off)
    _traceparent = ""

    def _json(self, obj, code=200, headers=()):
        body = json.dumps(obj).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        if self._traceparent:
            self.send_header(TRACEPARENT_HEADER, self._traceparent)
        for k, v in headers:
            self.send_header(k, v)
        self.end_headers()
        self.wfile.write(body)

    def _body(self) -> dict:
        n = int(self.headers.get("Content-Length", 0))
        if n <= 0:
            return {}
        obj = json.loads(self.rfile.read(n).decode())
        if not isinstance(obj, dict):
            raise ValueError("request body must be a JSON object")
        return obj

    def do_GET(self):
        path = urlparse(self.path).path
        self._traceparent = ""
        if path == "/serve/status":
            self._json(self.engine.status())
        elif path == "/serve/traces":
            self._json({"traces": global_trace_store().list()})
        elif path.startswith("/serve/traces/"):
            trace_id = path.rsplit("/", 1)[1]
            rec = global_trace_store().get(trace_id)
            if rec is None:
                self._json({"error": f"unknown trace {trace_id}"}, code=404)
            else:
                self._json(rec)
        elif path == "/serve/slo":
            self._json({"slo": self.engine.slo.evaluate()})
        elif path == "/metrics":
            body = global_registry().prometheus_text().encode()
            self.send_response(200)
            self.send_header("Content-Type", "text/plain; version=0.0.4")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)
        else:
            self._json({"error": f"unknown route {path}"}, code=404)

    def do_POST(self):
        path = urlparse(self.path).path
        t0 = time.perf_counter()
        # the caller's trace context (or a fresh trace) becomes the ambient
        # span of everything this handler thread does
        root = trace_span(f"http {path}", route=path, parent=parse_traceparent(
            self.headers.get(TRACEPARENT_HEADER)))
        self._trace = root
        self._traceparent = root.traceparent()
        try:
            with root:
                self._route(path)
        finally:
            dt = time.perf_counter() - t0
            self.engine._h_request.labels(route=path).observe(dt)
            if root.trace_id:
                global_trace_store().put_exemplar(
                    _n.SERVE_REQUEST_SECONDS, dt, root.trace_id)

    def _route(self, path: str) -> None:
        root = self._trace
        try:
            if path == "/v1/predict":
                self._predict()
            elif path == "/v1/generate":
                self._generate()
            elif path == "/v1/stream":
                self._stream()
            elif path == "/v1/stream/reset":
                req = self._body()
                existed = self.engine.sessions.reset(
                    str(req.get("model", "")), str(req.get("session", "")))
                self._json({"reset": existed})
            else:
                self._json({"error": f"unknown route {path}"}, code=404)
        except RejectedError as e:
            root.set_status("rejected").set_attr(http_status=429)
            self._json({"error": str(e), "pending": e.pending,
                        "limit": e.limit}, code=429,
                       headers=(("Retry-After",
                                 f"{max(e.retry_after_s, 0.001):.3f}"),))
        except KeyError as e:
            root.set_attr(http_status=404)
            self._json({"error": f"unknown model: {e}"}, code=404)
        except (ValueError, json.JSONDecodeError) as e:
            root.set_attr(http_status=400)
            self._json({"error": str(e)}, code=400)
        except TimeoutError as e:
            root.set_status("error").set_attr(http_status=503)
            self._json({"error": f"dispatch timed out: {e}"}, code=503)

    @staticmethod
    def _inputs(req: dict) -> np.ndarray:
        if "inputs" not in req:
            raise ValueError('request body needs an "inputs" field')
        return np.asarray(req["inputs"], dtype=np.float32)

    def _chunked_start(self) -> None:
        self.send_response(200)
        self.send_header("Content-Type", "application/x-ndjson")
        self.send_header("Transfer-Encoding", "chunked")
        if self._traceparent:
            self.send_header(TRACEPARENT_HEADER, self._traceparent)
        self.end_headers()

    def _chunk(self, obj: dict) -> None:
        line = (json.dumps(obj) + "\n").encode()
        self.wfile.write(f"{len(line):x}\r\n".encode() + line + b"\r\n")
        self.wfile.flush()

    def _predict(self) -> None:
        req = self._body()
        model = str(req.get("model", ""))
        x = self._inputs(req)
        if x.ndim == 1:
            x = x[None, :]
        self.engine.registry.active(model)  # 404 before queueing
        priority = normalize_priority(self.headers.get(PRIORITY_HEADER))
        tenant = str(self.headers.get(TENANT_HEADER) or "-")
        fut = self.engine.submit_predict(model, x, priority=priority,
                                         tenant=tenant)
        try:
            res = fut.result(timeout=self.engine.request_timeout_s)
        except (_FutureTimeout, TimeoutError):
            raise TimeoutError(
                f"no dispatch within {self.engine.request_timeout_s}s")
        except Exception as e:
            self._trace.set_status("error").set_attr(http_status=500)
            self._json({"error": f"{type(e).__name__}: {e}"}, code=500)
            return
        payload = {
            "predictions": np.asarray(res["predictions"]).tolist(),
            "model": res["model"], "version": res["version"],
            "batched_with": res["batch_rows"], "bucket": res["bucket"]}
        if res.get("replica") is not None:
            payload["replica"] = res["replica"]
        self._json(payload)

    def _generate(self) -> None:
        req = self._body()
        model = str(req.get("model", ""))
        prompt = req.get("prompt")
        if not isinstance(prompt, list) or not prompt:
            raise ValueError(
                'generate needs a non-empty "prompt" list of token ids')
        max_new = int(req.get("max_new_tokens", 32))
        eng = self.engine.decoder(model)
        tokens_q: "queue.Queue" = queue.Queue()
        sess = eng.submit(prompt, max_new,
                          stream=lambda sid, tok, t: tokens_q.put(tok))
        self._chunked_start()
        chunk = self._chunk
        i = 0
        deadline = time.monotonic() + self.engine.request_timeout_s
        while True:
            try:
                tok = tokens_q.get(timeout=0.02)
            except queue.Empty:
                if sess.done.is_set() and tokens_q.empty():
                    break
                if time.monotonic() > deadline:
                    chunk({"error": "generation timed out"})
                    break
                continue
            chunk({"i": i, "token": int(tok)})
            i += 1
        chunk({"done": True, "tokens": sess.tokens,
               "reason": sess.evict_reason, "ttft_s": sess.ttft_s})
        self.wfile.write(b"0\r\n\r\n")

    def _stream(self) -> None:
        req = self._body()
        model = str(req.get("model", ""))
        session = str(req.get("session") or f"conn-{id(self.connection)}")
        x = self._inputs(req)
        if x.ndim == 2:
            x = x[:, None, :]
        if x.ndim != 3:
            raise ValueError(
                f"stream inputs must be [B,T,F] or [B,F], got {x.shape}")
        self.engine.registry.active(model)  # 404 before the stream starts
        self._chunked_start()
        for t in range(x.shape[1]):
            step = self.engine.sessions.step(model, session, x[:, t:t + 1, :])
            self._chunk({"t": t, "output": step["output"][:, -1, :].tolist(),
                         "version": step["version"]})
        self._chunk({"done": True, "session": session,
                     "timesteps": int(x.shape[1])})
        self.wfile.write(b"0\r\n\r\n")


class InferenceServer:
    """The serving engine: registry + micro-batcher (or replicas) + decode
    engines + streaming sessions + HTTP front-end, all on ``device``
    (``None`` means CUDA; raises without one unless ``device="cpu"``)."""

    def __init__(self, registry: Optional[ModelRegistry] = None, *,
                 device=None, host: str = "127.0.0.1", port: int = 0,
                 max_batch: int = 32, max_latency_s: float = 0.002,
                 max_queue: int = 256, request_timeout_s: float = 30.0,
                 decode_min_slots: int = 2, decode_max_slots: int = 16,
                 decode_max_context: int = 256,
                 decode_eos_id: Optional[int] = None,
                 decode_kv: str = "dense", decode_page_size: int = 16,
                 decode_pool_pages: Optional[int] = None,
                 decode_spec_draft: Optional[str] = None,
                 decode_spec_tokens: int = 3,
                 stream_ttl_s: float = 300.0, warmup: bool = False,
                 replicas: int = 1, sharding=None, replica_devices=None,
                 replica_mesh_axes=None, autoscale: bool = False,
                 min_replicas: Optional[int] = None,
                 max_replicas: Optional[int] = None,
                 autoscale_cooldown_s: float = 30.0,
                 autoscale_interval_s: float = 2.0):
        self._h_request = global_registry().histogram(
            _n.SERVE_REQUEST_SECONDS, "HTTP request latency per route")
        #: the error-budget engine over this process's serve metrics:
        #: /serve/slo evaluates on demand, start() runs its ticker so burn
        #: alerts fire (and dump flight-recorder bundles) unscraped
        self.slo = SLOEngine()
        self.device = resolve_device(
            replica_devices[0] if device is None and replica_devices
            else device)
        self.replica_set: Optional[ReplicaSet] = None
        self.autoscaler: Optional[Autoscaler] = None
        self.batcher: Optional[MicroBatcher] = None
        self.membership = None
        if replicas > 1 or sharding is not None or autoscale:
            if registry is not None:
                raise ValueError(
                    "replica mode owns its per-replica registries; pass "
                    "registry=None and register through server.register()")
            if autoscale:
                # serving replicas are fenced members, as elastic training
                # workers are: a lapsed lease takes one out of the router
                from ..cloud import MembershipOracle
                self.membership = MembershipOracle(role="replica")
            self.replica_set = ReplicaSet(
                replicas, device=self.device, sharding=sharding,
                devices=replica_devices, mesh_axes=replica_mesh_axes,
                max_batch=max_batch, max_latency_s=max_latency_s,
                max_queue=max_queue, warmup=warmup,
                membership=self.membership)
            # replica 0's registry is the front door's catalog (404s,
            # streaming, decode); every roll keeps the replicas in step
            self.registry = self.replica_set.primary_registry
            if autoscale:
                self.autoscaler = Autoscaler(
                    self.replica_set, slo_engine=self.slo,
                    min_replicas=min_replicas or 1,
                    max_replicas=max_replicas or max(replicas, 8),
                    cooldown_s=autoscale_cooldown_s,
                    interval_s=autoscale_interval_s)
        else:
            self.registry = registry or ModelRegistry()
            if warmup:
                # this server's registrations warm every bucket up to
                # max_batch (a caller-supplied registry too)
                self.registry.warmup_max_batch = max_batch
            self.batcher = MicroBatcher(self.registry, max_batch=max_batch,
                                        max_latency_s=max_latency_s,
                                        max_queue=max_queue)
        self.request_timeout_s = float(request_timeout_s)
        self.sessions = StreamSessions(self.registry, ttl_s=stream_ttl_s,
                                       device=self.device)
        self._decode_opts = dict(
            min_slots=decode_min_slots, max_slots=decode_max_slots,
            max_context=decode_max_context, eos_id=decode_eos_id,
            kv=decode_kv, page_size=decode_page_size, n_pages=decode_pool_pages,
            spec_tokens=decode_spec_tokens)
        #: the draft model of every decoder; None falls back to the
        #: registry's link of each target (``registry.draft_of``)
        self._decode_spec_draft = decode_spec_draft
        self._decoders: dict = {}
        self._dec_lock = threading.Lock()
        handler = type("BoundServeHandler", (_ServeHandler,), {"engine": self})
        self._httpd = ThreadingHTTPServer((host, port), handler)
        self._httpd.daemon_threads = True
        self._thread: Optional[threading.Thread] = None

    @property
    def port(self) -> int:
        return self._httpd.server_address[1]

    def start(self) -> "InferenceServer":
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="serve-http", daemon=True)
        self._thread.start()
        self.slo.start()
        if self.autoscaler is not None:
            self.autoscaler.start()
        return self

    def register(self, name: str, net, version: Optional[str] = None,
                 quant: Optional[str] = None, warmup_example=None):
        """Register a model for serving, pinned on this server's device: a
        rolling registration over every replica in replica mode."""
        if self.replica_set is not None:
            return self.replica_set.register(name, net, version=version,
                                             quant=quant,
                                             warmup_example=warmup_example)
        return self.registry.register(name, net, version=version, quant=quant,
                                      device=self.device,
                                      warmup_example=warmup_example)

    def load(self, name: str, path: str, version: Optional[str] = None,
             quant: Optional[str] = None, warmup_example=None):
        """Restore a model zip on this server's device and register it."""
        if self.replica_set is not None:
            return self.replica_set.load(name, path, version=version,
                                         quant=quant,
                                         warmup_example=warmup_example)
        return self.registry.load(name, path, version=version, quant=quant,
                                  device=self.device,
                                  warmup_example=warmup_example)

    def submit_predict(self, model: str, x, *, priority: str = "high",
                       tenant: str = "-"):
        """The predict seam: the least-queue router over the replicas, or
        the one micro-batcher; ``priority`` and ``tenant`` go to
        admission."""
        if self.replica_set is not None:
            return self.replica_set.submit(model, x, priority=priority,
                                           tenant=tenant)
        return self.batcher.submit(model, x, priority=priority, tenant=tenant)

    def decoder(self, model: str) -> DecodeEngine:
        """The decode engine of ``model``'s active version, created at first
        use and shared by every /v1/generate request; a version's int8 policy
        follows how it was registered. With a draft model (the server's
        ``decode_spec_draft``, else the registry's link) the engine decodes
        speculatively against the draft's active version. Engines are keyed
        by both versions, so a hot swap of either retires the engine once it
        is idle."""
        mv = self.registry.active(model)
        draft_name = self._decode_spec_draft or self.registry.draft_of(model)
        draft_mv = (self.registry.active(draft_name)
                    if draft_name is not None else None)
        key = (mv.name, mv.version,
               None if draft_mv is None else draft_mv.version)
        with self._dec_lock:
            eng = self._decoders.get(key)
            if eng is None:
                eng = self._decoders[key] = DecodeEngine(
                    mv.net, device=self.device, quant=mv.quant,
                    draft_net=None if draft_mv is None else draft_mv.net,
                    **self._decode_opts)
            for k0, stale in list(self._decoders.items()):
                if k0[0] == mv.name and k0 != key and stale.idle():
                    stale.close()
                    del self._decoders[k0]
            return eng

    def stop(self) -> None:
        if self.autoscaler is not None:
            self.autoscaler.stop()
        self.slo.stop()
        if self._thread is not None:
            # shutdown() waits for serve_forever, which only start() runs
            self._httpd.shutdown()
            self._thread.join(5.0)
        self._httpd.server_close()
        if self.batcher is not None:
            self.batcher.close()
        if self.replica_set is not None:
            self.replica_set.close()
        with self._dec_lock:
            for eng in self._decoders.values():
                eng.close()
            self._decoders.clear()

    def status(self) -> dict:
        with self._dec_lock:
            decode = {
                f"{name}@{version}"
                + (f"+draft@{dv}" if dv is not None else ""): eng.stats()
                for (name, version, dv), eng in sorted(
                    self._decoders.items(),
                    key=lambda kv: (kv[0][0], kv[0][1], kv[0][2] or ""))}
        st = {**self.registry.status(), "device": str(self.device),
              "queue": (self.batcher.stats() if self.batcher is not None
                        else self.replica_set.queue_stats()),
              "decode": decode, "streams": self.sessions.status()}
        if self.replica_set is not None:
            st["replicas"] = self.replica_set.stats()
        if self.autoscaler is not None:
            st["autoscaler"] = self.autoscaler.status()
        return st
