"""Load generation for the serving engine: open and closed loop over HTTP.

Counterpart of ``deeplearning4j_tpu/keras_server/loadgen.py``. The
open-loop client schedules requests on a fixed clock (``offered_qps``)
however fast the server answers, so saturation shows as growing latency
and 429s; latency counts from the request's scheduled time (no coordinated
omission). The closed-loop client (N workers, back to back) measures
best-case latency and peak throughput. The ``_proc`` variants run the
client in its own process (``python -m
deeplearning4j_tpu_torch.keras_server.loadgen``, :func:`_client_main`), so
client and server do not share one interpreter lock.

Harnesses, each returning (and optionally appending as JSONL) one record
with the JAX package's keys:

- :func:`run_ab`: unbatched (``max_batch=1``) against micro-batched at
  the same offered QPS;
- :func:`run_replica_ab`: one replica against N behind the router;
- :func:`run_ramp_ab`: an autoscaled fleet against a static one of the same
  average size under a low-high-low ramp;
- :func:`run_token_stream_load`, :func:`run_decode_ab` (continuous
  against static batching, int8 against float32), :func:`run_paged_ab`
  (dense against paged KV at equal state bytes) and :func:`run_spec_ab`
  (plain greedy against speculative decode).

Where the JAX harnesses read its compile tracker (one compile per batch or
capacity bucket), the port compiles nothing per bucket: ``recompiles``
holds the buckets the phase built (predict buckets, or decode capacity
buckets), so the JAX identity ``recompiles == bucket count`` holds by
construction, and ``kernel_launches`` holds each CUDA kernel's launches in
the phase, from ``ops/_cuda.launch_counts()``. Every harness takes
``device`` (``None`` means CUDA). Each predict request carries a fresh
client-minted W3C ``traceparent`` (what a fronting gateway sends), so the
server's span trees parent under the client's ids and a slow request is
findable by the id its response echoes.
"""
from __future__ import annotations

import http.client
import json
import os
import random
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from ..ops import _cuda


def percentile(sorted_vals: List[float], q: float) -> float:
    """Nearest-rank percentile on an already-sorted list (0 when empty)."""
    if not sorted_vals:
        return 0.0
    i = min(len(sorted_vals) - 1, max(0, int(q * len(sorted_vals))))
    return sorted_vals[i]


def _launches() -> Dict[str, int]:
    """Each CUDA kernel wrapper's launch count, by name."""
    return {fn.__name__: n for fn, n in _cuda.launch_counts().items()}


def _launch_delta(before: Dict[str, int]) -> Dict[str, int]:
    """Launches of each kernel since ``before`` (kernels that ran only)."""
    after = _launches()
    return {k: after[k] - before.get(k, 0) for k in sorted(after)
            if after[k] != before.get(k, 0)}


class _Stats:
    def __init__(self):
        self.lock = threading.Lock()
        self.latencies_ms: List[float] = []
        self.ok = 0
        self.rejected = 0
        self.errors = 0

    def record(self, status: int, latency_ms: float) -> None:
        with self.lock:
            if status == 200:
                self.ok += 1
                self.latencies_ms.append(latency_ms)
            elif status == 429:
                self.rejected += 1
            else:
                self.errors += 1

    def summary(self) -> dict:
        with self.lock:
            lat = sorted(self.latencies_ms)
            return {"ok": self.ok, "rejected": self.rejected,
                    "errors": self.errors,
                    "p50_ms": round(percentile(lat, 0.50), 3),
                    "p90_ms": round(percentile(lat, 0.90), 3),
                    "p99_ms": round(percentile(lat, 0.99), 3)}


def _connect(host: str, port: int,
             timeout: float = 30.0) -> http.client.HTTPConnection:
    """Persistent connection with Nagle off — mirrors the server side; a
    buffered small-segment request otherwise hits the 40ms delayed-ACK
    stall and the load test measures the kernel timer, not the server."""
    import socket
    conn = http.client.HTTPConnection(host, port, timeout=timeout)
    conn.connect()
    conn.sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
    return conn


#: trace-id source: an instance, not the global generator, so ids never
#: repeat across seeded runs and never perturb a seeded workload
_trace_rand = random.Random()


def _mint_traceparent() -> str:
    """A fresh client-side W3C trace context for one request."""
    return (f"00-{_trace_rand.getrandbits(128):032x}"
            f"-{_trace_rand.getrandbits(64):016x}-01")


def _post_predict(conn: http.client.HTTPConnection, model: str,
                  payload: bytes) -> int:
    conn.request("POST", "/v1/predict", body=payload,
                 headers={"Content-Type": "application/json",
                          "traceparent": _mint_traceparent()})
    resp = conn.getresponse()
    resp.read()
    return resp.status


def _worker_bodies(model: str, example) -> Callable[[int], bytes]:
    if callable(example):
        return lambda i: json.dumps(
            {"model": model, "inputs": np.asarray(example(i)).tolist()}
        ).encode()
    body = json.dumps(
        {"model": model, "inputs": np.asarray(example).tolist()}).encode()
    return lambda i: body


def run_open_loop(port: int, model: str, example, *, qps: float,
                  duration_s: float, workers: int = 32,
                  host: str = "127.0.0.1") -> dict:
    """Fixed-rate load: request i fires at ``t0 + i/qps``; a late worker
    pool never thins the offered schedule (requests queue client-side and
    the latency clock keeps running from the scheduled instant)."""
    n_total = max(1, int(qps * duration_s))
    make_body = _worker_bodies(model, example)
    stats = _Stats()
    counter = {"i": 0}
    counter_lock = threading.Lock()
    t0 = time.perf_counter() + 0.05  # let workers reach their first wait

    def work():
        conn = _connect(host, port)
        while True:
            with counter_lock:
                i = counter["i"]
                if i >= n_total:
                    break
                counter["i"] = i + 1
            t_sched = t0 + i / qps
            delay = t_sched - time.perf_counter()
            if delay > 0:
                time.sleep(delay)
            try:
                status = _post_predict(conn, model, make_body(i))
            except OSError:
                conn.close()
                conn = _connect(host, port)
                stats.record(-1, 0.0)
                continue
            stats.record(status,
                         (time.perf_counter() - t_sched) * 1e3)
        conn.close()

    threads = [threading.Thread(target=work, daemon=True)
               for _ in range(max(1, min(workers, n_total)))]
    t_start = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = max(time.perf_counter() - t_start, 1e-9)
    out = stats.summary()
    out.update({"mode": "open", "offered_qps": round(qps, 3),
                "achieved_qps": round(out["ok"] / wall, 3),
                "duration_s": round(wall, 3), "requests": n_total})
    return out


def run_closed_loop(port: int, model: str, example, *, workers: int,
                    requests_per_worker: int,
                    host: str = "127.0.0.1") -> dict:
    """N concurrent streams, back-to-back requests: peak throughput."""
    make_body = _worker_bodies(model, example)
    stats = _Stats()

    def work(wid: int):
        conn = _connect(host, port)
        for j in range(requests_per_worker):
            t_send = time.perf_counter()
            try:
                status = _post_predict(
                    conn, model, make_body(wid * requests_per_worker + j))
            except OSError:
                conn.close()
                conn = _connect(host, port)
                stats.record(-1, 0.0)
                continue
            stats.record(status, (time.perf_counter() - t_send) * 1e3)
        conn.close()

    threads = [threading.Thread(target=work, args=(w,), daemon=True)
               for w in range(workers)]
    t_start = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = max(time.perf_counter() - t_start, 1e-9)
    out = stats.summary()
    out.update({"mode": "closed", "workers": workers,
                "achieved_qps": round(out["ok"] / wall, 3),
                "duration_s": round(wall, 3),
                "requests": workers * requests_per_worker})
    return out


def _client_cmd(port: int, model: str, shape, *, extra: List[str]) -> list:
    import sys
    return [sys.executable, "-m",
            "deeplearning4j_tpu_torch.keras_server.loadgen",
            "--port", str(port), "--model", model,
            "--shape", ",".join(str(int(s)) for s in shape)] + extra


def _run_client(cmd: list, timeout_s: float) -> dict:
    """Launch the load client in its own process and parse its JSON line."""
    import subprocess
    root = os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))))
    env = dict(os.environ)
    env["PYTHONPATH"] = root + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run(cmd, capture_output=True, text=True, env=env,
                          timeout=timeout_s)
    for line in reversed((proc.stdout or "").strip().splitlines()):
        try:
            rec = json.loads(line)
        except (json.JSONDecodeError, ValueError):
            continue
        if isinstance(rec, dict) and "achieved_qps" in rec:
            return rec
    raise RuntimeError(
        f"load client produced no record (rc={proc.returncode}): "
        + (proc.stderr or "")[-400:])


def run_open_loop_proc(port: int, model: str, shape, *, qps: float,
                       duration_s: float, workers: int = 32) -> dict:
    """run_open_loop in a separate process (own GIL); the client
    regenerates its payload from ``shape`` (load shape matters, values
    don't)."""
    return _run_client(
        _client_cmd(port, model, shape, extra=[
            "--qps", str(qps), "--duration", str(duration_s),
            "--workers", str(workers)]),
        timeout_s=duration_s * 20 + 120)


def run_closed_loop_proc(port: int, model: str, shape, *, workers: int,
                         requests_per_worker: int) -> dict:
    return _run_client(
        _client_cmd(port, model, shape, extra=[
            "--closed", "--workers", str(workers),
            "--requests", str(requests_per_worker)]),
        timeout_s=600)


def run_ab(net, *, model: str = "model", qps: float = 200.0,
           duration_s: float = 3.0, max_batch: int = 32,
           max_latency_s: float = 0.004, max_queue: int = 512,
           example=None, workers: int = 32,
           warmup_requests: int = 8, isolate_client: bool = True,
           record_path: Optional[str] = None, device=None) -> dict:
    """Serve ``net`` unbatched then micro-batched at the SAME offered QPS;
    return (and optionally append as JSONL) the A/B record.
    ``isolate_client=False`` keeps the load client in-process (faster to
    start, but client GIL contention depresses both phases)."""
    from .registry import ModelRegistry
    from .serving import InferenceServer
    if example is None:
        raise ValueError("pass example= (one input row, shape [1, ...])")
    example = np.asarray(example)
    phases = {}
    for phase, batch in (("unbatched", 1), ("batched", max_batch)):
        launches_before = _launches()
        # a fresh pin per phase (PredictFn copies the weights)
        registry = ModelRegistry()
        registry.register(model, net, version="v1", device=device)
        server = InferenceServer(
            registry, device=device, max_batch=batch,
            max_latency_s=(0.0 if batch == 1 else max_latency_s),
            max_queue=max_queue).start()
        try:
            # the first dispatch of each bucket off the clock
            run_closed_loop(server.port, model, example, workers=1,
                            requests_per_worker=warmup_requests)
            if isolate_client:
                res = run_open_loop_proc(
                    server.port, model, example.shape, qps=qps,
                    duration_s=duration_s, workers=workers)
            else:
                res = run_open_loop(server.port, model, example, qps=qps,
                                    duration_s=duration_s, workers=workers)
            bstats = server.batcher.stats()
        finally:
            server.stop()
        res["batch_occupancy"] = round(bstats["mean_occupancy"], 4)
        res["bucket_count"] = bstats["bucket_count"]
        res["dispatches"] = bstats["dispatches"]
        res["recompiles"] = bstats["bucket_count"]
        res["kernel_launches"] = _launch_delta(launches_before)
        res["max_batch"] = batch
        phases[phase] = res
    rec = {
        "harness": "keras_server.loadgen.run_ab",
        "model": model, "offered_qps": qps, "duration_s": duration_s,
        "max_batch": max_batch, "max_latency_s": max_latency_s,
        "unbatched": phases["unbatched"], "batched": phases["batched"],
        "batched_speedup": round(
            phases["batched"]["achieved_qps"]
            / max(phases["unbatched"]["achieved_qps"], 1e-9), 3),
        "p99_improvement": round(
            phases["unbatched"]["p99_ms"]
            / max(phases["batched"]["p99_ms"], 1e-9), 3),
    }
    if record_path:
        os.makedirs(os.path.dirname(os.path.abspath(record_path)),
                    exist_ok=True)
        with open(record_path, "a") as f:
            f.write(json.dumps(rec) + "\n")
    return rec


def run_replica_ab(net, *, model: str = "model", replicas: int = 2,
                   sharding: Optional[str] = None, qps: float = 200.0,
                   duration_s: float = 3.0, max_batch: int = 32,
                   max_latency_s: float = 0.004, max_queue: int = 512,
                   example=None, workers: int = 32,
                   warmup_requests: int = 8, isolate_client: bool = True,
                   record_path: Optional[str] = None, device=None) -> dict:
    """QPS-vs-replicas scaling A/B: 1 replica vs ``replicas`` behind the
    least-queue router, at the SAME offered QPS (pick one that saturates
    the single replica, so the scaled phase shows real headroom). The
    scaled phase reports each replica's routed requests, dispatches and
    buckets. ``sharding`` shards every replica's pin over its slice of the
    cards (``InferenceServer(sharding=)``, ``replica.py``)."""
    from .registry import ModelRegistry
    from .serving import InferenceServer
    if example is None:
        raise ValueError("pass example= (one input row, shape [1, ...])")
    example = np.asarray(example)
    phases = {}
    for phase, n in (("baseline", 1), ("scaled", max(replicas, 1))):
        launches_before = _launches()
        # the baseline stays on the single-batcher path unless sharding
        # forces replica mode
        if n > 1 or sharding is not None:
            server = InferenceServer(
                replicas=n, sharding=sharding, max_batch=max_batch,
                max_latency_s=max_latency_s, max_queue=max_queue,
                device=device)
            server.register(model, net, version="v1")
        else:
            registry = ModelRegistry()
            registry.register(model, net, version="v1", device=device)
            server = InferenceServer(
                registry, max_batch=max_batch, max_latency_s=max_latency_s,
                max_queue=max_queue, device=device)
        server.start()
        try:
            # every replica's first dispatches off the clock: concurrent
            # closed-loop workers spread over the router
            run_closed_loop(server.port, model, example,
                            workers=max(2, 2 * n),
                            requests_per_worker=warmup_requests)
            if isolate_client:
                res = run_open_loop_proc(
                    server.port, model, example.shape, qps=qps,
                    duration_s=duration_s, workers=workers)
            else:
                res = run_open_loop(server.port, model, example, qps=qps,
                                    duration_s=duration_s, workers=workers)
            if server.replica_set is not None:
                qstats = server.replica_set.queue_stats()
                rstats = server.replica_set.stats()["replicas"]
            else:
                qstats = server.batcher.stats()
                rstats = None
        finally:
            server.stop()
        res["batch_occupancy"] = round(qstats["mean_occupancy"], 4)
        res["bucket_count"] = qstats["bucket_count"]
        res["dispatches"] = qstats["dispatches"]
        res["recompiles"] = qstats["bucket_count"]
        res["kernel_launches"] = _launch_delta(launches_before)
        res["replicas"] = n
        if rstats is not None:
            res["per_replica"] = [
                {"replica": r["replica"], "routed": r["routed"],
                 "dispatches": r["dispatches"],
                 "bucket_count": r["bucket_count"],
                 "recompiles": r["bucket_count"],
                 "recompiles_match_buckets": True}
                for r in rstats]
        phases[phase] = res
    rec = {
        "harness": "keras_server.loadgen.run_replica_ab",
        "model": model, "offered_qps": qps, "duration_s": duration_s,
        "max_batch": max_batch, "replicas": replicas,
        "sharding": sharding or "none",
        "replicas_1": phases["baseline"], "replicas_n": phases["scaled"],
        "replica_speedup": round(
            phases["scaled"]["achieved_qps"]
            / max(phases["baseline"]["achieved_qps"], 1e-9), 3),
        "recompiles_match_buckets": all(
            p["recompiles_match_buckets"]
            for p in phases["scaled"].get("per_replica", [])),
    }
    if record_path:
        os.makedirs(os.path.dirname(os.path.abspath(record_path)),
                    exist_ok=True)
        with open(record_path, "a") as f:
            f.write(json.dumps(rec) + "\n")
    return rec


def _run_ramp_phase(port: int, model: str, example, *,
                    segments, workers: int = 16,
                    host: str = "127.0.0.1") -> List[tuple]:
    """Open-loop ramp client: ``segments`` is a sequence of
    ``(qps, seconds)`` steps played back to back. Send times are fixed by
    the schedule (latency measured from the SCHEDULED instant — no
    coordinated omission, same contract as :func:`run_open_loop`).
    Returns per-request ``(t_sched_s, status, latency_ms)`` samples."""
    bodies = _worker_bodies(model, example)
    offsets: List[float] = []
    t = 0.0
    for qps, seg_s in segments:
        n = max(1, int(qps * seg_s))
        offsets.extend(t + i / qps for i in range(n))
        t += seg_s
    samples: List[tuple] = []
    lock = threading.Lock()
    next_i = [0]
    t0 = time.perf_counter()

    def worker():
        conn = _connect(host, port)
        try:
            while True:
                with lock:
                    i = next_i[0]
                    if i >= len(offsets):
                        return
                    next_i[0] += 1
                sched = offsets[i]
                delay = t0 + sched - time.perf_counter()
                if delay > 0:
                    time.sleep(delay)
                try:
                    status = _post_predict(conn, model, bodies(i))
                except Exception:
                    status = -1
                    conn.close()
                    conn = _connect(host, port)
                lat_ms = (time.perf_counter() - (t0 + sched)) * 1e3
                with lock:
                    samples.append((sched, status, lat_ms))
        finally:
            conn.close()

    threads = [threading.Thread(target=worker, daemon=True)
               for _ in range(workers)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    return samples


def _ramp_summary(samples: List[tuple], slo_ms: float) -> dict:
    """Fold ramp samples into SLO-violation-seconds: a wall-clock second
    is in violation when its p99 exceeds ``slo_ms`` or any request in it
    was rejected or errored. ``lost`` counts admitted-but-failed requests
    (a 429 is an explicit reject, not a loss)."""
    by_second: Dict[int, List[tuple]] = {}
    for sched, status, lat_ms in samples:
        by_second.setdefault(int(sched), []).append((status, lat_ms))
    violation_s = 0
    for sec in sorted(by_second):
        rows = by_second[sec]
        lat = sorted(l for s, l in rows if s == 200)
        bad = any(s != 200 for s, _ in rows)
        if bad or (lat and percentile(lat, 0.99) > slo_ms):
            violation_s += 1
    lat_all = sorted(l for _, s, l in samples if s == 200)
    return {
        "requests": len(samples),
        "ok": sum(1 for _, s, _ in samples if s == 200),
        "rejected": sum(1 for _, s, _ in samples if s == 429),
        "lost": sum(1 for _, s, _ in samples if s not in (200, 429)),
        "p50_ms": round(percentile(lat_all, 0.50), 3),
        "p99_ms": round(percentile(lat_all, 0.99), 3),
        "slo_violation_seconds": violation_s,
    }


def run_ramp_ab(net, *, model: str = "model", qps_low: float = 20.0,
                qps_high: Optional[float] = None, segment_s: float = 2.0,
                slo_ms: float = 250.0, min_replicas: int = 1,
                max_replicas: int = 4, cooldown_s: float = 1.0,
                interval_s: float = 0.2, max_batch: int = 32,
                max_latency_s: float = 0.004, max_queue: int = 64,
                example=None, workers: int = 16,
                warmup_requests: int = 8,
                record_path: Optional[str] = None, device=None) -> dict:
    """The autoscaling headline A/B: an open-loop ramp (low → high → low,
    default 10x swing) against (a) an autoscaled fleet and (b) a static
    fleet sized to the autoscaled run's time-weighted AVERAGE replica
    count — same average hardware, different placement in time. The
    record carries ``slo_violation_seconds_auto/static`` (the acceptance
    floor: auto strictly below static), ``lost_requests`` (must be zero:
    scale-in drains without loss) and ``scale_out_latency_s`` (decision →
    routable, warm-path bounded)."""
    from .registry import ModelRegistry
    from .serving import InferenceServer
    if example is None:
        raise ValueError("pass example= (one input row, shape [1, ...])")
    example = np.asarray(example)
    qps_high = qps_high if qps_high is not None else 10.0 * qps_low
    segments = ((qps_low, segment_s), (qps_high, segment_s),
                (qps_low, segment_s))

    # ---- phase 1: autoscaled fleet, fleet-size sampler alongside
    server = InferenceServer(
        replicas=min_replicas, autoscale=True, min_replicas=min_replicas,
        max_replicas=max_replicas, autoscale_cooldown_s=cooldown_s,
        autoscale_interval_s=interval_s, max_batch=max_batch,
        max_latency_s=max_latency_s, max_queue=max_queue, warmup=True,
        device=device)
    server.register(model, net, version="v1", warmup_example=example)
    fleet_samples: List[tuple] = []
    stop = threading.Event()

    def sampler():
        while not stop.wait(0.05):
            fleet_samples.append(
                (time.perf_counter(), server.replica_set.n_replicas))

    server.start()
    sth = threading.Thread(target=sampler, daemon=True)
    sth.start()
    try:
        run_closed_loop(server.port, model, example, workers=2,
                        requests_per_worker=warmup_requests)
        auto_samples = _run_ramp_phase(
            server.port, model, example, segments=segments,
            workers=workers)
        scaler = server.autoscaler.status()
    finally:
        stop.set()
        sth.join(2.0)
        server.stop()
    auto = _ramp_summary(auto_samples, slo_ms)
    if len(fleet_samples) > 1:
        weighted = sum(
            n * (fleet_samples[i + 1][0] - fleet_samples[i][0])
            for i, (_, n) in enumerate(fleet_samples[:-1]))
        span = fleet_samples[-1][0] - fleet_samples[0][0]
        avg_replicas = weighted / span if span > 0 else float(min_replicas)
    else:
        avg_replicas = float(min_replicas)

    # ---- phase 2: static fleet at the SAME average replica count
    static_n = max(1, round(avg_replicas))
    if static_n > 1:
        server = InferenceServer(
            replicas=static_n, max_batch=max_batch,
            max_latency_s=max_latency_s, max_queue=max_queue, warmup=True,
            device=device)
        server.register(model, net, version="v1", warmup_example=example)
    else:
        registry = ModelRegistry()
        registry.register(model, net, version="v1", device=device)
        server = InferenceServer(
            registry, max_batch=max_batch, max_latency_s=max_latency_s,
            max_queue=max_queue, device=device)
    server.start()
    try:
        run_closed_loop(server.port, model, example, workers=2,
                        requests_per_worker=warmup_requests)
        static_samples = _run_ramp_phase(
            server.port, model, example, segments=segments,
            workers=workers)
    finally:
        server.stop()
    static = _ramp_summary(static_samples, slo_ms)

    rec = {
        "harness": "keras_server.loadgen.run_ramp_ab",
        "model": model, "qps_low": qps_low, "qps_high": qps_high,
        "segment_s": segment_s, "slo_ms": slo_ms,
        "min_replicas": min_replicas, "max_replicas": max_replicas,
        "avg_replicas_auto": round(avg_replicas, 3),
        "static_replicas": static_n,
        "auto": auto, "static": static,
        "slo_violation_seconds_auto": auto["slo_violation_seconds"],
        "slo_violation_seconds_static": static["slo_violation_seconds"],
        "lost_requests": auto["lost"],
        "scale_out_latency_s": scaler.get("last_scale_out_latency_s"),
        "scale_events": len(scaler.get("events", [])),
        "auto_beats_static": (auto["slo_violation_seconds"]
                              < static["slo_violation_seconds"]),
    }
    if record_path:
        os.makedirs(os.path.dirname(os.path.abspath(record_path)),
                    exist_ok=True)
        with open(record_path, "a") as f:
            f.write(json.dumps(rec) + "\n")
    return rec


# ----------------------------------------------------- token-streaming load
def _decode_workload(n_sessions: int, vocab: int, prompt_len: int,
                     max_new_tokens: int, seed: int):
    """One deterministic session mix shared by every A/B phase.

    Budgets are LONG-TAILED (3/4 short, 1/4 near the ceiling) because
    that is what decode traffic looks like and it is exactly what
    request-level batching is bad at: one near-ceiling session holds the
    whole batch hostage while the short ones sit drained in their slots.
    """
    rng = np.random.default_rng(seed)
    prompts = [list(map(int, rng.integers(0, vocab,
                                          size=int(rng.integers(1, prompt_len + 1)))))
               for _ in range(n_sessions)]
    short_hi = max(max_new_tokens // 3, 3)
    budgets = [int(rng.integers(max_new_tokens // 2, max_new_tokens + 1))
               if rng.random() < 0.25 else int(rng.integers(2, short_hi))
               for _ in range(n_sessions)]
    return prompts, budgets


def run_token_stream_load(engine, prompts, budgets, *,
                          offered_sps: float,
                          timeout_s: float = 600.0) -> dict:
    """Open-loop token-streaming load against a :class:`DecodeEngine`.

    Session ``i`` is OFFERED at ``t0 + i/offered_sps`` regardless of how
    fast the engine drains — a saturated engine shows up as growing TTFT,
    never as a politely-thinning arrival schedule (no coordinated
    omission: TTFT is measured from the scheduled arrival, which
    ``submit(t_sched=...)`` pins). Per-token host timestamps give the
    inter-token latency distribution; tokens/sec is counted over the wall
    clock from first offer to last completion.
    """
    t0, sessions = _offer_sessions(engine, prompts, budgets, offered_sps)
    for s in sessions:
        s.result(timeout=timeout_s)
    res = _summarize_sessions(sessions, t0)
    res["offered_sps"] = round(offered_sps, 3)
    return res


def _offer_sessions(engine, prompts, budgets, offered_sps: float):
    """Submit the whole mix on the open-loop clock; returns (t0, sessions)."""
    t0 = time.perf_counter() + 0.02
    sessions = []
    for i, (p, b) in enumerate(zip(prompts, budgets)):
        t_sched = t0 + i / offered_sps
        delay = t_sched - time.perf_counter()
        if delay > 0:
            time.sleep(delay)
        sessions.append(engine.submit(p, b, t_sched=t_sched))
    return t0, sessions


def run_decode_ab(net, *, model: str = "decode", slots: int = 8,
                  n_sessions: int = 48, prompt_len: int = 4,
                  max_new_tokens: int = 24, offered_sps: Optional[float] = None,
                  eos_id: Optional[int] = None, max_context: int = 128,
                  quant_ab: bool = True, seed: int = 0,
                  record_path: Optional[str] = None, device=None) -> dict:
    """Continuous vs static (request-level) decode at EQUAL offered
    sessions/sec, plus an int8-vs-dense accuracy/throughput A/B.

    Every phase runs the identical deterministic session mix on a fresh
    engine (its own pinned copy) at the same slot capacity. With
    ``offered_sps=None`` the rate is calibrated to saturate: 1.5x the
    continuous engine's drained session rate from a burst probe — the
    regime where slot occupancy, not arrival, is the binding constraint.
    The headline ratio is tokens/sec; TTFT p99 must not regress.
    """
    from .decode import DecodeEngine
    prompts, budgets = _decode_workload(
        n_sessions, _decode_vocab(net), prompt_len, max_new_tokens, seed)

    if offered_sps is None:
        probe = DecodeEngine(net, min_slots=slots, max_slots=slots,
                             eos_id=eos_id, max_context=max_context,
                             device=device)
        try:
            _decode_warmup(probe)
            n_probe = min(2 * slots, n_sessions)
            res = run_token_stream_load(
                probe, prompts[:n_probe], budgets[:n_probe],
                offered_sps=1e6)  # burst: measure drain rate, not arrival
        finally:
            probe.close()
        offered_sps = max(1.5 * res["achieved_sps"], 1.0)

    def phase(mode: str, quant=None, capture=False) -> Tuple[dict, list]:
        before = _launches()
        eng = DecodeEngine(net, min_slots=slots, max_slots=slots,
                           mode=mode, quant=quant, eos_id=eos_id,
                           max_context=max_context, capture_probs=capture,
                           device=device)
        try:
            _decode_warmup(eng)  # the bucket's first step off the clock
            t0, sessions = _offer_sessions(eng, prompts, budgets, offered_sps)
            for s in sessions:
                s.result(timeout=600.0)
            res = _summarize_sessions(sessions, t0)
            st = eng.stats()
        finally:
            eng.close()
        res.update({
            "mode": mode, "quant": quant,
            "offered_sps": round(offered_sps, 3),
            "mean_occupancy": round(st["mean_occupancy"], 4),
            "bucket_count": st["bucket_count"],
            "steps": st["steps"],
            "recompiles": st["bucket_count"],
            "kernel_launches": _launch_delta(before),
            "param_bytes": st["param_bytes"],
        })
        return res, sessions

    cont, cont_sessions = phase("continuous", capture=quant_ab)
    stat, _ = phase("static")
    rec = {
        "harness": "keras_server.loadgen.run_decode_ab",
        "model": model, "slots": slots, "n_sessions": n_sessions,
        "offered_sps": round(offered_sps, 3),
        "max_new_tokens": max_new_tokens, "prompt_len": prompt_len,
        "continuous": cont, "static": stat,
        "tokens_per_sec_ratio": round(
            cont["tokens_per_sec"] / max(stat["tokens_per_sec"], 1e-9), 3),
        "ttft_p99_ratio": round(
            stat["ttft_p99_ms"] / max(cont["ttft_p99_ms"], 1e-9), 3),
    }
    if quant_ab:
        q, q_sessions = phase("continuous", quant="int8", capture=True)
        drifts, agree = [], []
        for qs, ds in zip(q_sessions, cont_sessions):
            n = min(len(qs.probs), len(ds.probs))
            if not n:
                continue
            qp = np.stack(qs.probs[:n])
            dp = np.stack(ds.probs[:n])
            drifts.append(float(np.mean(np.abs(qp - dp))))
            agree.append(float(np.mean(
                qp.argmax(-1) == dp.argmax(-1))))
        rec["int8"] = q
        rec["int8_vs_dense"] = {
            "mean_prob_drift": round(float(np.mean(drifts)), 6),
            "top1_agreement": round(float(np.mean(agree)), 4),
            "tokens_per_sec_ratio": round(
                q["tokens_per_sec"] / max(cont["tokens_per_sec"], 1e-9), 3),
            "param_bytes_ratio": round(
                cont["param_bytes"] / max(q["param_bytes"], 1), 3),
        }
    if record_path:
        os.makedirs(os.path.dirname(os.path.abspath(record_path)),
                    exist_ok=True)
        with open(record_path, "a") as f:
            f.write(json.dumps(rec) + "\n")
    return rec


def run_paged_ab(net, *, model: str = "decode_paged",
                 dense_slots: int = 4, max_context: int = 128,
                 page_size: int = 16, n_sessions: int = 32,
                 prompt_len: int = 4, max_new_tokens: int = 24,
                 eos_id: Optional[int] = None, seed: int = 0,
                 record_path: Optional[str] = None, device=None) -> dict:
    """Dense vs paged KV decode at EQUAL device state bytes.

    The dense engine is pinned at ``dense_slots`` (its HBM ceiling:
    ``slots x max_context`` KV rows whether written or not). The paged
    engine gets a pool of ``dense_slots * max_context / page_size - 1``
    pages — exactly the dense engine's KV bytes including the trash page —
    but ``2 x dense_slots`` slot capacity, so the A/B measures how many
    MORE concurrent sessions the same bytes admit when slots only consume
    pages for tokens they have written. Token streams must be bitwise
    identical (the dense program is the oracle); the headline fields are
    ``sessions_ratio`` (peak concurrent paged / dense capacity) and the
    state-bytes pair that proves the comparison was fair.
    """
    from .decode import DecodeEngine
    prompts, budgets = _decode_workload(
        n_sessions, _decode_vocab(net), prompt_len, max_new_tokens, seed)
    n_pages = dense_slots * (max_context // page_size) - 1

    def phase(kv: str, slots: int, n_pages=None) -> Tuple[dict, list, int]:
        eng = DecodeEngine(net, min_slots=slots, max_slots=slots,
                           eos_id=eos_id, max_context=max_context,
                           kv=kv, page_size=page_size, n_pages=n_pages,
                           device=device)
        try:
            _decode_warmup(eng)
            t0, sessions = _offer_sessions(eng, prompts, budgets, 1e6)
            for s in sessions:
                s.result(timeout=600.0)
            res = _summarize_sessions(sessions, t0)
            st = eng.stats()
            bytes_ = eng.state_bytes()
        finally:
            eng.close()
        res.update({
            "kv": kv, "slots": slots,
            "state_bytes": bytes_,
            "peak_active": st["peak_active"],
            "mean_occupancy": round(st["mean_occupancy"], 4),
        })
        if kv == "paged":
            res.update({
                "pool_pages": st["pool_pages"],
                "prefix_share_ratio": round(st["prefix_share_ratio"], 4),
            })
        return res, sessions, bytes_

    dense, dsess, dbytes = phase("dense", dense_slots)
    paged, psess, pbytes = phase("paged", 2 * dense_slots, n_pages=n_pages)
    bitwise = all(a.tokens == b.tokens for a, b in zip(dsess, psess))
    rec = {
        "harness": "keras_server.loadgen.run_paged_ab",
        "model": model, "n_sessions": n_sessions,
        "max_context": max_context, "page_size": page_size,
        "dense": dense, "paged": paged,
        "bitwise_equal": bitwise,
        "state_bytes_ratio": round(pbytes / max(dbytes, 1), 4),
        "sessions_ratio": round(
            paged["peak_active"] / max(dense_slots, 1), 3),
        "tokens_per_sec_ratio": round(
            paged["tokens_per_sec"] / max(dense["tokens_per_sec"], 1e-9),
            3),
    }
    if record_path:
        os.makedirs(os.path.dirname(os.path.abspath(record_path)),
                    exist_ok=True)
        with open(record_path, "a") as f:
            f.write(json.dumps(rec) + "\n")
    return rec


def run_spec_ab(net, draft_net, *, model: str = "decode_spec",
                slots: int = 4, max_context: int = 128,
                spec_tokens: int = 3, n_sessions: int = 16,
                prompt_len: int = 4, max_new_tokens: int = 24,
                eos_id: Optional[int] = None, seed: int = 0,
                record_path: Optional[str] = None, device=None,
                quant: Optional[str] = None, kv: str = "dense",
                page_size: int = 16, prompts=None, budgets=None) -> dict:
    """Plain greedy vs speculative decode with ``draft_net`` proposing.

    Identical session mix through both engines; the emitted streams must
    be bitwise equal at ANY acceptance rate (greedy argmax verify is
    exact, acceptance only moves the speed). Headline fields:
    ``tokens_per_sec_ratio`` (the spec speedup) at the measured
    ``acceptance`` rate. ``quant``, ``kv`` and ``page_size`` configure
    the target in both engines (the draft is dense float32); ``prompts``
    and ``budgets`` replace the seeded mix. The record also holds each
    engine's ``stats()`` (``greedy_stats``, ``spec_stats``) and its
    ``kernel_launches``.
    """
    from .decode import DecodeEngine
    if prompts is None:
        prompts, budgets = _decode_workload(
            n_sessions, _decode_vocab(net), prompt_len, max_new_tokens, seed)
    n_sessions = len(prompts)

    def phase(draft) -> Tuple[dict, list, dict]:
        eng = DecodeEngine(net, min_slots=slots, max_slots=slots,
                           eos_id=eos_id, max_context=max_context,
                           draft_net=draft, spec_tokens=spec_tokens,
                           quant=quant, kv=kv, page_size=page_size,
                           device=device)
        try:
            _decode_warmup(eng)
            before, st0 = _launches(), eng.stats()
            t0, sessions = _offer_sessions(eng, prompts, budgets, 1e6)
            for s in sessions:
                s.result(timeout=600.0)
            res = _summarize_sessions(sessions, t0)
            res["kernel_launches"] = _launch_delta(before)
            st = eng.stats()
            # the measured run's own steps (rounds), past the warm-up's
            res["steps"] = st["steps"] - st0["steps"]
        finally:
            eng.close()
        return res, sessions, st

    greedy, gsess, gst = phase(None)
    spec, ssess, st = phase(draft_net)
    bitwise = all(a.tokens == b.tokens for a, b in zip(gsess, ssess))
    rec = {
        "harness": "keras_server.loadgen.run_spec_ab",
        "model": model, "n_sessions": n_sessions, "slots": slots,
        "spec_tokens": spec_tokens,
        "greedy": greedy, "spec": spec,
        "bitwise_equal": bitwise,
        "acceptance": round(st["spec_acceptance"], 4),
        "proposed": st["spec_proposed"],
        "greedy_stats": gst, "spec_stats": st,
        "tokens_per_sec_ratio": round(
            spec["tokens_per_sec"] / max(greedy["tokens_per_sec"], 1e-9),
            3),
    }
    if record_path:
        os.makedirs(os.path.dirname(os.path.abspath(record_path)),
                    exist_ok=True)
        with open(record_path, "a") as f:
            f.write(json.dumps(rec) + "\n")
    return rec


def _decode_vocab(net) -> int:
    return int(net.layers[-1].n_out)


def _decode_warmup(engine) -> None:
    """One throwaway session, so the capacity bucket's first step (kernel
    builds, library algorithm choices) never lands on the measurement
    clock."""
    engine.submit([0], 2).result(timeout=600.0)


def _summarize_sessions(sessions, t0: float) -> dict:
    t_end = max(s.t_done for s in sessions)
    wall = max(t_end - t0, 1e-9)
    n_tokens = sum(len(s.tokens) for s in sessions)
    ttft = sorted(s.ttft_s * 1e3 for s in sessions if s.ttft_s is not None)
    itl = sorted((b - a) * 1e3 for s in sessions
                 for a, b in zip(s.token_times, s.token_times[1:]))
    return {
        "sessions": len(sessions), "tokens": n_tokens,
        "achieved_sps": round(len(sessions) / wall, 3),
        "tokens_per_sec": round(n_tokens / wall, 3),
        "duration_s": round(wall, 3),
        "ttft_p50_ms": round(percentile(ttft, 0.50), 3),
        "ttft_p99_ms": round(percentile(ttft, 0.99), 3),
        "itl_p50_ms": round(percentile(itl, 0.50), 3),
        "itl_p99_ms": round(percentile(itl, 0.99), 3),
    }


def _client_main() -> None:
    """``python -m deeplearning4j_tpu_torch.keras_server.loadgen``: the load
    client the ``_proc`` runners launch in their own process. Prints one
    JSON line."""
    import argparse
    ap = argparse.ArgumentParser()
    ap.add_argument("--port", type=int, required=True)
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--model", required=True)
    ap.add_argument("--shape", required=True,
                    help="request input shape, comma-separated")
    ap.add_argument("--qps", type=float, default=200.0)
    ap.add_argument("--duration", type=float, default=3.0)
    ap.add_argument("--workers", type=int, default=32)
    ap.add_argument("--closed", action="store_true")
    ap.add_argument("--requests", type=int, default=100,
                    help="closed-loop requests per worker")
    args = ap.parse_args()
    shape = tuple(int(s) for s in args.shape.split(","))
    example = np.random.default_rng(0).normal(size=shape).astype(np.float32)
    if args.closed:
        res = run_closed_loop(args.port, args.model, example,
                              workers=args.workers,
                              requests_per_worker=args.requests,
                              host=args.host)
    else:
        res = run_open_loop(args.port, args.model, example, qps=args.qps,
                            duration_s=args.duration, workers=args.workers,
                            host=args.host)
    # the one JSON line on stdout is this process's result (_run_client)
    print(json.dumps(res), flush=True)


if __name__ == "__main__":
    _client_main()
