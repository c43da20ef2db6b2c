"""Parameter-server worker process.

Counterpart of ``deeplearning4j_tpu/parallel/ps_worker.py``.

Static-shard mode (started by ``ParameterServerParallelWrapper`` on the
``tcp`` and ``shm`` transports) trains a stack of batches from an ``.npz``
or from ``shm://<segment>``, a shared-memory segment the coordinator
wrote (``--ps-transport shm`` also moves the push and pull bytes into
shared-memory rings)::

    python -m deeplearning4j_tpu_torch.parallel.ps_worker \\
        --addr 127.0.0.1:<port> --conf conf.json --data worker0.npz \\
        --worker-id 0 --push-frequency 4 --codec bf16 --device cuda

Elastic mode (started by ``parallel.elastic.ElasticTrainer``) registers
with the membership oracle, heartbeats its lease and consumes its shard
from a broker topic under a committed-offset consumer group::

    python -m deeplearning4j_tpu_torch.parallel.ps_worker \\
        --addr 127.0.0.1:<ps_port> --conf conf.json \\
        --broker 127.0.0.1:<broker_port> --topic shard-0 --group shard-0 \\
        --shard 0 --worker-name shard0-gen0 --device cuda

A worker trains on ``--device`` (default ``cuda``; ``cpu`` only when asked;
TF32 off through ``resolve_device``), which is the coordinator network's
device: unlike the JAX package, whose workers run on the CPU, the port's
run their steps on the card. The worker pulls the initial params from the
server, trains asynchronously, and prints one JSON stats line on stdout as
its last line, with its own kernel launch counts (``"launches"``, by
wrapper name: the coordinator sees no counter of another process), its
transport's stats and its ``dl4j_ps_*``/``dl4j_shm_*`` series
(``"series"``). On every exit (clean, fenced or crashed) the shard
``.npz``, if any, is removed and a ``worker_exit`` event names the reason
in the process's flight recorder.
"""
from __future__ import annotations

import argparse
import atexit
import json
import os
import sys


def _parse_addr(addr: str):
    host, port = addr.rsplit(":", 1)
    return host, int(port)


def _run_npz(args, net, step, transport):
    import numpy as np

    from ..datasets.dataset import DataSet
    from .param_server import run_worker_loop

    if args.data.startswith("shm://"):
        from .ps_transport import read_shard_segment
        blob = read_shard_segment(args.data[len("shm://"):])
    else:
        blob = np.load(args.data)
    batches = [DataSet(x, y) for x, y in zip(blob["x"], blob["y"])]
    it = iter(batches)
    return run_worker_loop(
        transport=transport, replica=net, step_fn=step,
        next_batch=lambda: next(it, None),
        push_frequency=args.push_frequency,
        delay_s=args.delay, worker_id=args.worker_id)


def _run_elastic(args, net, step, transport):
    """Register, heartbeat, consume the shard topic, and commit offsets
    only when a push window has landed (a crash redelivers at most one
    window to the replacement)."""
    import queue
    import threading

    from ..datasets.dataset import DataSet
    from ..streaming.broker import ReconnectingConsumer
    from .param_server import StaleEpochFenced, run_worker_loop
    from .ps_transport import TransportError

    reg = transport.register(args.shard, worker=args.worker_name)
    member, epoch = reg["member"], reg["epoch"]
    lease_s = float(reg["lease_s"])
    transport.bind_member(member, epoch)

    stop = threading.Event()
    stop_reason = ["done"]
    hb = transport.clone()

    def _heartbeats() -> None:
        # renew at a third of the lease; a refused renewal means the
        # oracle has declared this worker dead: stop consuming
        interval = max(0.05, lease_s / 3.0)
        while not stop.wait(interval):
            try:
                if not hb.heartbeat():
                    stop_reason[0] = "lease-expired"
                    stop.set()
                    return
            except TransportError:
                stop_reason[0] = "coordinator-unreachable"
                stop.set()
                return

    beat = threading.Thread(target=_heartbeats, daemon=True,
                            name="ps-heartbeat")
    beat.start()
    consumer = ReconnectingConsumer(
        _parse_addr(args.broker), args.topic, group=args.group)
    saw_fin = [False]

    def next_batch():
        while not stop.is_set():
            try:
                meta, arrays = consumer.get(timeout=0.5)
            except queue.Empty:
                continue
            if meta.get("fin"):
                saw_fin[0] = True
                return None
            # the window's push parents under this batch's consume span:
            # producer, consume and push stitch into one trace
            transport.bind_trace_parent(consumer.last_trace_ref)
            return DataSet(arrays["x"], arrays["y"])
        return None

    def on_push(accepted: bool) -> None:
        # the window's delta landed: now its samples count as consumed
        if accepted:
            consumer.commit_delivered()

    try:
        stats = run_worker_loop(
            transport=transport, replica=net, step_fn=step,
            next_batch=next_batch, push_frequency=args.push_frequency,
            delay_s=args.delay, worker_id=member, on_push=on_push)
        if saw_fin[0] and not stop.is_set():
            # committing the fin marker tells the coordinator the shard is
            # complete
            consumer.commit_delivered()
    finally:
        stop.set()
        beat.join(timeout=10)
        consumer.close()
        hb.close()
    if stop_reason[0] == "lease-expired":
        raise StaleEpochFenced("membership lease expired mid-shard")
    if stop_reason[0] == "coordinator-unreachable":
        raise TransportError("heartbeat channel lost")
    try:
        transport.deregister("done")
    except TransportError:
        pass  # the lease lapses at the server; the work is committed
    stats.update(member=member, epoch=epoch, shard=args.shard,
                 fin=saw_fin[0])
    return stats


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--addr", required=True, help="host:port of the PS")
    ap.add_argument("--conf", required=True, help="model config JSON path")
    ap.add_argument("--data",
                    help=".npz with x (n,B,...) / y (n,B,...) batch stacks, "
                         "or shm://<segment>")
    ap.add_argument("--broker", help="host:port of the shard broker "
                                     "(elastic mode)")
    ap.add_argument("--topic", help="shard topic to consume (elastic mode)")
    ap.add_argument("--group", help="consumer group id; the replacement "
                                    "resumes this group's committed offset")
    ap.add_argument("--shard", type=int, default=0)
    ap.add_argument("--worker-name", default="",
                    help="coordinator-chosen name; maps this process to its "
                         "membership lease")
    ap.add_argument("--worker-id", type=int, default=0)
    ap.add_argument("--push-frequency", type=int, default=4)
    ap.add_argument("--codec", default="none", choices=("none", "bf16"))
    ap.add_argument("--ps-transport", default="tcp",
                    choices=("tcp", "shm"),
                    help="shm: tensor bytes through shared-memory rings "
                         "(negotiated; tcp frames if segments can't attach)")
    ap.add_argument("--delay", type=float, default=0.0,
                    help="straggler fault injection: sleep per step")
    ap.add_argument("--device", default="cuda",
                    help="the device the worker trains on (cuda, or cpu)")
    args = ap.parse_args(argv)
    if bool(args.broker) == bool(args.data):
        ap.error("exactly one of --data (static shard) or "
                 "--broker/--topic/--group (elastic) is required")
    if args.broker and not (args.topic and args.group):
        ap.error("--broker requires --topic and --group")

    from ..nn.conf.multilayer import MultiLayerConfiguration
    from ..nn.multilayer import MultiLayerNetwork
    from ..observability.flight_recorder import global_recorder
    from ..observability.metrics import global_registry
    from ..ops import _cuda
    from .param_server import StaleEpochFenced, make_compiled_worker_step
    from .ps_transport import ShmTransport, TcpTransport, TransportError

    def _cleanup_data() -> None:
        # the shard file is this worker's to delete (shm:// shards are the
        # coordinator's segments: it unlinks them)
        if args.data and not args.data.startswith("shm://"):
            try:
                os.unlink(args.data)
            except OSError:
                pass  # removed already, or the parent's tmpdir went first

    atexit.register(_cleanup_data)

    with open(args.conf) as f:
        conf = MultiLayerConfiguration.from_json(f.read())
    # shapes only: the params come from the server
    net = MultiLayerNetwork(conf, device=args.device).init()

    cls = ShmTransport if args.ps_transport == "shm" else TcpTransport
    transport = cls(_parse_addr(args.addr), codec=args.codec)
    step = make_compiled_worker_step(net)
    reason, rc, stats = "done", 0, None
    try:
        if args.broker:
            stats = _run_elastic(args, net, step, transport)
        else:
            stats = _run_npz(args, net, step, transport)
    except StaleEpochFenced as e:
        reason, rc = "fenced", 3
        sys.stderr.write(f"{e}\n")
    except TransportError as e:
        reason, rc = "coordinator-unreachable", 4
        sys.stderr.write(f"{e}\n")
    except BaseException as e:
        reason = f"error:{type(e).__name__}"
        raise
    finally:
        global_recorder().record(
            "worker_exit", worker=args.worker_name or str(args.worker_id),
            shard=args.shard, reason=reason)
        _cleanup_data()
        transport_stats = transport.stats()
        transport.close()
    if stats is not None:
        stats["exit_reason"] = reason
        stats["device"] = str(net.device)
        stats["transport"] = transport_stats
        stats["launches"] = {fn.__name__: n for fn, n in
                             _cuda.launch_counts().items()}
        # this process's transport series (the coordinator's registry
        # sees only the server's side)
        stats["series"] = {
            name: fam["series"] for name, fam in
            global_registry().snapshot().items()
            if name.startswith(("dl4j_ps_", "dl4j_shm_"))}
        # stdout's last line is the stats JSON: the parent's parse contract
        print(json.dumps(stats), flush=True)
    else:
        sys.stderr.write(f"worker exit: {reason}\n")
    return rc


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
