"""Elastic, preemption-tolerant training over the async parameter server.

Counterpart of ``deeplearning4j_tpu/parallel/elastic.py``. The
:class:`ElasticTrainer` joins three engines into a fleet that survives a
worker dying mid-``fit()``:

* **Membership**: ``cloud.MembershipOracle``. Workers register over the
  PS transport (a member id, a fencing epoch and a lease), heartbeats
  renew the lease, and a lapsed lease is declared dead by the server. The
  ``ParameterServer`` fences pushes by epoch, so a zombie resumed after
  expiry cannot touch the model.
* **Shard handoff**: shard *i* is a topic of the loopback broker
  (``streaming/broker.py``) consumed under group *i*; workers commit
  offsets only after a push window lands, and a replacement resumes the
  group at committed + 1. At least once: a crash redelivers at most one
  window, and nothing is skipped. The coordinator compares each group's
  committed offset with its topic's ``fin`` marker, and keeps no other
  assignment state.
* **Restore on join**: a joining worker pulls the current ``(version,
  params)``. With ``checkpoint(dir)`` the server starts from the last
  committed sharded checkpoint (``utils/sharded_checkpoint.py``; a torn
  save has no sidecar and is ignored) and async checkpoints are written
  while the fleet trains.

Workers are ``parallel/ps_worker.py`` processes on the model's device (the
card unless the caller asked for the CPU), started with ``subprocess``. A
dead worker whose shard has uncommitted samples is replaced; a worker
whose lease lapsed while it still runs is a zombie and is SIGKILLed before
its replacement starts, so one live worker owns each shard. Every wait on
a process is bounded. The JAX trainer's fleet-observability plane
(``FederatedRegistry``, ``FleetCollector``) waits for ROADMAP.md A9.4.

Telemetry as in the JAX trainer: ``dl4j_elastic_handoffs_total`` (and the
oracle's and the server's series), the ``elastic_restore``,
``elastic_chaos_kill``, ``shard_handoff`` and ``elastic_stats_unparsed``
events, a watchdog beat every pass of the monitor, the flight recorder's
dump directory handed to the workers, and one dump when an exception
escapes ``fit``. :attr:`ElasticTrainer.stats` holds the trainer's counts.
"""
from __future__ import annotations

import json
import os
import subprocess
import tempfile
import threading
import time
from typing import List, Optional, Sequence

from ..cloud import MembershipOracle
from ..observability.flight_recorder import (
    DUMP_DIR_ENV, dump_on_unhandled, global_recorder)
from ..observability.metrics import global_registry
from ..observability.names import ELASTIC_HANDOFFS_TOTAL
from ..observability.tracing import trace_span
from ..observability.watchdog import beat
from .param_server import (
    DEFAULT_STALENESS_CAP, ParameterServer, _host, unflatten_into,
    worker_command, worker_env,
)
from .ps_transport import ParameterServerTcpFrontend, reap_orphans

_handoffs = global_registry().counter(
    ELASTIC_HANDOFFS_TOTAL,
    "shard handoffs to a replacement worker after a worker died").labels()


class _Shard:
    """The coordinator's view of one shard: its topic and group, its fin
    offset, and the worker process generation that owns it."""

    def __init__(self, shard: int):
        self.shard = shard
        self.topic = f"shard-{shard}"
        self.group = f"shard-{shard}"
        self.fin_offset = -1
        self.committed = -1
        self.gen = 0
        self.name = ""
        self.proc: Optional[subprocess.Popen] = None
        self.done = False
        self.handoffs = 0


class ElasticTrainer:
    """Preemption-tolerant async-PS trainer: workers are separate processes;
    kill one mid-fit and its shard passes to a freshly registered
    replacement."""

    def __init__(self, model, workers: int = 2, push_frequency: int = 4,
                 staleness: int = DEFAULT_STALENESS_CAP,
                 compression: str = "none",
                 transport: str = "tcp",
                 server_optimizer: str = "sgd", server_lr: float = 1.0,
                 lease_timeout_s: float = 15.0,
                 respawn: bool = True, max_handoffs_per_shard: int = 4,
                 checkpoint_dir: Optional[str] = None,
                 checkpoint_interval_s: float = 30.0,
                 worker_delays: Optional[Sequence[float]] = None,
                 fit_timeout_s: float = 900.0):
        if compression not in ("none", "bf16"):
            raise ValueError(f"unknown compression {compression!r}; "
                             "expected 'none' or 'bf16'")
        if transport not in ("tcp", "shm"):
            raise ValueError(f"unknown transport {transport!r}; "
                             "expected 'tcp' or 'shm'")
        self.model = model
        self.workers = int(workers)
        self.push_frequency = max(1, push_frequency)
        self.staleness = int(staleness)
        self.compression = compression
        self.transport = transport
        self.server_optimizer = server_optimizer
        self.server_lr = server_lr
        self.lease_timeout_s = float(lease_timeout_s)
        self.respawn = bool(respawn)
        self.max_handoffs_per_shard = int(max_handoffs_per_shard)
        self.checkpoint_dir = checkpoint_dir
        self.checkpoint_interval_s = float(checkpoint_interval_s)
        self.worker_delays = list(worker_delays or [])
        self.fit_timeout_s = float(fit_timeout_s)
        self.server: Optional[ParameterServer] = None
        self.oracle: Optional[MembershipOracle] = None
        self.worker_stats: List[dict] = []
        self.published = 0
        self.restored_from_checkpoint = False
        #: async checkpoints committed during and after fit
        self.checkpoints = 0
        #: zombies SIGKILLed, orphan segments reaped after the fit
        self.zombies_killed = 0
        self.reaped = 0
        self._shards: List[_Shard] = []
        self._proc_lock = threading.Lock()
        self._broker = None
        self._conf_path = ""
        self._ps_port = self._broker_port = 0

    class Builder:
        def __init__(self, model):
            self._model = model
            self._kw = {}

        def workers(self, n: int):
            self._kw["workers"] = n
            return self

        def push_frequency(self, n: int):
            self._kw["push_frequency"] = n
            return self

        def staleness(self, cap: int):
            self._kw["staleness"] = cap
            return self

        def compression(self, codec: str):
            self._kw["compression"] = codec
            return self

        def transport(self, kind: str):
            """"tcp" (framed sockets) or "shm" (tensor bytes in per-worker
            shared-memory rings, control verbs on the socket; tcp frames
            when the segments cannot attach)."""
            self._kw["transport"] = kind
            return self

        def server_optimizer(self, kind: str, lr: float = 1.0):
            self._kw["server_optimizer"] = kind
            self._kw["server_lr"] = lr
            return self

        def lease_timeout(self, seconds: float):
            """A worker silent this long is declared dead, its epoch fenced
            and its shard handed off."""
            self._kw["lease_timeout_s"] = seconds
            return self

        def respawn(self, enabled: bool, max_per_shard: int = 4):
            """Start a replacement for a dead worker whose shard still has
            uncommitted samples."""
            self._kw["respawn"] = enabled
            self._kw["max_handoffs_per_shard"] = max_per_shard
            return self

        def checkpoint(self, directory: str, interval_s: float = 30.0):
            """Async sharded checkpoints while training; fit() restores the
            last committed one before workers join."""
            self._kw["checkpoint_dir"] = directory
            self._kw["checkpoint_interval_s"] = interval_s
            return self

        def worker_delays(self, *delays: float):
            """Fault injection: shard i's worker sleeps delays[i] seconds a
            step."""
            self._kw["worker_delays"] = list(delays)
            return self

        def fit_timeout(self, seconds: float):
            self._kw["fit_timeout_s"] = seconds
            return self

        def build(self) -> "ElasticTrainer":
            return ElasticTrainer(self._model, **self._kw)

    @staticmethod
    def builder(model) -> "ElasticTrainer.Builder":
        return ElasticTrainer.Builder(model)

    # ----------------------------------------------------------------- fit
    @dump_on_unhandled("ElasticTrainer.fit")
    def fit(self, iterator, epochs: int = 1) -> None:
        from ..streaming.broker import LoopbackBroker

        self._maybe_restore()
        self.oracle = MembershipOracle(
            preemptible=True, lease_timeout_s=self.lease_timeout_s)
        self.server = ParameterServer(
            self.model.params_list, staleness_cap=self.staleness,
            optimizer=self.server_optimizer, server_lr=self.server_lr,
            membership=self.oracle)
        frontend = ParameterServerTcpFrontend(self.server).start()
        broker = self._broker = LoopbackBroker().start()
        self._ps_port, self._broker_port = frontend.port, broker.port
        saver = None
        if self.checkpoint_dir is not None:
            from ..utils.sharded_checkpoint import AsyncShardedSaver
            saver = AsyncShardedSaver()
        self.worker_stats = []
        self._shards = [_Shard(i) for i in range(self.workers)]
        try:
            with tempfile.TemporaryDirectory(prefix="dl4j_elastic_") as tmp:
                self._publish_shards(broker, iterator, epochs)
                self._conf_path = os.path.join(tmp, "conf.json")
                with open(self._conf_path, "w") as f:
                    f.write(self.model.conf.to_json())
                for shard in self._shards:
                    self._spawn(shard)
                self._monitor(broker, saver)
        finally:
            with self._proc_lock:
                for shard in self._shards:
                    if shard.proc is not None and shard.proc.poll() is None:
                        shard.proc.kill()
                        shard.proc.communicate(timeout=30)
            frontend.stop()
            broker.stop()
            # a SIGKILLed worker leaves no atexit: sweep its segments
            self.reaped += reap_orphans()
        unflatten_into(self.server.pull_flat()[1], self.model.params_list)
        if saver is not None:
            # the final committed state: the next fit()'s warm start
            saver.save(self.checkpoint_dir, self.model,
                       step=self.server.version)
            saver.close()
            self.checkpoints = saver.committed

    def _maybe_restore(self) -> None:
        """Warm start after a server restart, only from a committed
        checkpoint (its sidecar present)."""
        if self.checkpoint_dir is None:
            return
        from ..utils.sharded_checkpoint import is_committed, restore_sharded
        if not is_committed(self.checkpoint_dir):
            return
        restore_sharded(self.checkpoint_dir, self.model)
        self.restored_from_checkpoint = True
        global_recorder().record(
            "elastic_restore", directory=self.checkpoint_dir,
            iteration=self.model.iteration)

    def _publish_shards(self, broker, iterator, epochs: int) -> None:
        from ..streaming.broker import BrokerProducer

        batches = []
        for _ in range(epochs):
            if hasattr(iterator, "reset"):
                iterator.reset()
            batches.extend(iterator)
        producer = BrokerProducer(broker.address)
        try:
            for shard in self._shards:
                # one trace root a shard: every message carries this span's
                # traceparent, so the consume and the push stitch under it
                with trace_span("shard.publish", topic=shard.topic,
                                shard=shard.shard):
                    for ds in batches[shard.shard::self.workers]:
                        producer.publish(shard.topic,
                                         {"x": _host(ds.features),
                                          "y": _host(ds.labels)})
                        self.published += 1
                    # the fin marker closes the shard: a group whose
                    # committed offset reaches it consumed every sample at
                    # least once
                    shard.fin_offset = producer.publish(
                        shard.topic, {}, meta={"fin": True})
        finally:
            producer.close()

    def _delay(self, shard: int) -> float:
        if shard < len(self.worker_delays):
            return float(self.worker_delays[shard])
        return 0.0

    def _spawn(self, shard: _Shard) -> None:
        shard.name = f"shard{shard.shard}-gen{shard.gen}"
        cmd = worker_command(
            "deeplearning4j_tpu_torch.parallel.ps_worker",
            ["--addr", f"127.0.0.1:{self._ps_port}",
             "--conf", self._conf_path,
             "--broker", f"127.0.0.1:{self._broker_port}",
             "--topic", shard.topic, "--group", shard.group,
             "--shard", shard.shard, "--worker-name", shard.name,
             "--push-frequency", self.push_frequency,
             "--codec", self.compression,
             "--ps-transport", self.transport,
             "--delay", self._delay(shard.shard),
             "--device", str(self.model.device)])
        env = worker_env()
        rec = global_recorder()
        if rec.dump_dir:
            # a worker's last bundle lands beside the coordinator's (a
            # set_dump_dir() here never reaches os.environ)
            env[DUMP_DIR_ENV] = rec.dump_dir
        with self._proc_lock:
            shard.proc = subprocess.Popen(
                cmd, env=env, stdout=subprocess.PIPE,
                stderr=subprocess.PIPE, text=True)
        shard.gen += 1

    def chaos_kill(self, shard: int) -> bool:
        """Fault injection: SIGKILL the process that owns ``shard``.
        Returns True if a live process was killed."""
        with self._proc_lock:
            if shard >= len(self._shards):
                return False
            s = self._shards[shard]
            if s.proc is None or s.proc.poll() is not None:
                return False
            s.proc.kill()
        global_recorder().record("elastic_chaos_kill", shard=shard,
                                 worker=s.name)
        return True

    def committed_offset(self, shard: int) -> int:
        """The committed offset of ``shard``'s group while the fleet runs
        (-1: nothing committed yet, or no fit running)."""
        broker = self._broker
        if broker is None or shard >= len(self._shards):
            return -1
        s = self._shards[shard]
        return broker.committed(s.topic, s.group)

    def _monitor(self, broker, saver) -> None:
        deadline = time.time() + self.fit_timeout_s
        last_ckpt = time.time()
        while not all(s.done for s in self._shards):
            if time.time() > deadline:
                raise RuntimeError(
                    f"elastic fit exceeded {self.fit_timeout_s:.0f}s; "
                    f"shards done: {[s.done for s in self._shards]}")
            self.oracle.expire()
            for shard in self._shards:
                if not shard.done:
                    self._tend(shard, broker)
            beat(self.server.version)
            if (saver is not None and time.time() - last_ckpt
                    > self.checkpoint_interval_s):
                self._snapshot(saver)
                last_ckpt = time.time()
            time.sleep(0.05)

    def _tend(self, shard: _Shard, broker) -> None:
        lease = self.oracle.member_by_name(shard.name)
        rc = shard.proc.poll()
        if rc is None:
            if (lease is not None and not lease.alive
                    and lease.reason == "lease-lapsed"):
                # a zombie: declared dead but still running. Its pushes are
                # fenced already; kill the body so one worker owns the
                # shard before the replacement starts
                shard.proc.kill()
                self.zombies_killed += 1
            return
        stdout, stderr = shard.proc.communicate(timeout=30)
        committed = shard.committed = broker.committed(shard.topic,
                                                       shard.group)
        if rc == 0:
            shard.done = True
            try:
                self.worker_stats.append(
                    json.loads(stdout.strip().splitlines()[-1]))
            except (ValueError, IndexError):
                self.worker_stats.append({"unparsed": stdout[-2000:]})
                global_recorder().record("elastic_stats_unparsed",
                                         worker=shard.name)
            return
        if lease is not None and lease.alive:
            self.oracle.evict(lease.member, reason=f"exit-rc{rc}")
        if committed >= shard.fin_offset:
            # it died after committing its fin marker: every sample of the
            # shard was consumed
            shard.done = True
            return
        if self.respawn and shard.handoffs < self.max_handoffs_per_shard:
            shard.handoffs += 1
            _handoffs.inc()
            global_recorder().record(
                "shard_handoff", shard=shard.shard, gen=shard.gen,
                committed=committed, fin=shard.fin_offset, rc=rc)
            self._spawn(shard)
            return
        raise RuntimeError(
            f"elastic worker for shard {shard.shard} died (rc={rc}) with "
            f"uncommitted samples and no respawn budget:\n" + stderr[-2000:])

    def _snapshot(self, saver) -> None:
        # the coordinator's model carries the server's current vector into
        # an async save (its sidecar commits once the write has landed)
        unflatten_into(self.server.pull_flat()[1], self.model.params_list)
        saver.save(self.checkpoint_dir, self.model, step=self.server.version)

    # ----------------------------------------------------------- accessors
    @property
    def handoffs(self) -> int:
        return sum(s.handoffs for s in self._shards)

    @property
    def shard_commits(self) -> List[dict]:
        """Each shard's group's final committed offset beside its topic's
        fin marker: ``committed >= fin`` proves no window was dropped."""
        return [{"shard": s.shard, "committed": s.committed,
                 "fin": s.fin_offset, "handoffs": s.handoffs}
                for s in self._shards]

    @property
    def stats(self) -> dict:
        return {
            "published": self.published,
            "steps": sum(int(s.get("steps", 0)) for s in self.worker_stats),
            "handoffs": self.handoffs,
            "fenced": self.server.fenced if self.server else 0,
            "lease_expiries": (self.oracle.lease_expiries
                               if self.oracle else 0),
            "joins": self.oracle.joins if self.oracle else 0,
            "restored": self.restored_from_checkpoint,
            "zombies_killed": self.zombies_killed,
            "reaped": self.reaped,
            "checkpoints": self.checkpoints,
        }

