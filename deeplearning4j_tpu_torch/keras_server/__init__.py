"""The Keras training gateway and the serving engine.

Counterpart of ``deeplearning4j_tpu/keras_server/__init__.py``. Two
services live in this package:

- the **training gateway** (below), the reference's deeplearning4j-keras
  (a py4j ``GatewayServer`` exposing ``DeepLearning4jEntryPoint.fit``): a
  newline-delimited-JSON TCP server whose entry point imports a Keras
  archive (``modelimport/``) and trains, evaluates or predicts with it on
  the port's device, over directories of HDF5 minibatch files;
- **serving**: the registry, admission, micro-batching, replicas behind a
  router, the autoscaler, paged, LSTM and speculative decode, streaming
  sessions, HTTP and the load generator.
"""
from __future__ import annotations

import hmac
import json
import re
import socket
import socketserver
import threading
from pathlib import Path
from typing import List, Optional

import numpy as np

from ..modelimport.hdf5 import H5File


class HDF5MiniBatchDataSetIterator:
    """A directory of per-batch HDF5 files, each holding one array under
    ``dataset_name``, ordered by the integer in the file name (``0.h5``,
    ``1.h5``, ..., ``10.h5``)."""

    def __init__(self, directory: str, dataset_name: str = "data"):
        self.directory = Path(directory)
        self.dataset_name = dataset_name

        def batch_no(p: Path) -> int:
            m = re.search(r"(\d+)", p.stem)
            return int(m.group(1)) if m else 0

        self.files: List[Path] = sorted(
            (p for p in self.directory.iterdir() if p.suffix == ".h5"),
            key=batch_no)
        if not self.files:
            raise FileNotFoundError(f"no .h5 batch files in {directory}")

    def __len__(self) -> int:
        return len(self.files)

    def read(self, i: int) -> np.ndarray:
        with H5File(str(self.files[i])) as f:
            return f.read_dataset(f"/{self.dataset_name}")

    def __iter__(self):
        for i in range(len(self.files)):
            yield self.read(i)


class DeepLearning4jEntryPoint:
    """The RPC surface (the reference's ``DeepLearning4jEntryPoint``): each
    method imports the Sequential archive at ``model_file_path`` onto
    ``device`` (``None`` means CUDA) the first time it is named, and keeps
    the network for later calls."""

    def __init__(self, device=None):
        self.device = device
        self._models: dict = {}

    def _import(self, model_file_path: str):
        from ..modelimport.keras_import import KerasModelImport
        return KerasModelImport.import_keras_sequential_model_and_weights(
            model_file_path, device=self.device)

    def _model(self, model_file_path: str):
        net = self._models.get(model_file_path)
        if net is None:
            net = self._models[model_file_path] = self._import(
                model_file_path)
        return net

    def fit(self, model_file_path: str, nb_epoch: int,
            train_features_directory: str, train_labels_directory: str,
            dim_ordering: str = "tf", model_type: str = "sequential") -> dict:
        if model_type != "sequential":
            raise ValueError("only sequential models supported (reference "
                             "DeepLearning4jEntryPoint parity)")
        net = self._import(model_file_path)
        xs = HDF5MiniBatchDataSetIterator(train_features_directory)
        ys = HDF5MiniBatchDataSetIterator(train_labels_directory)
        if len(xs) != len(ys):
            raise ValueError("feature/label batch counts differ")
        for _ in range(int(nb_epoch)):
            for x, y in zip(xs, ys):
                net.fit(np.asarray(x, np.float32), np.asarray(y, np.float32))
        self._models[model_file_path] = net
        return {"batches": len(xs), "epochs": int(nb_epoch),
                "score": float(net.score_value)}

    def evaluate(self, model_file_path: str, features_directory: str,
                 labels_directory: str) -> dict:
        net = self._model(model_file_path)
        xs = HDF5MiniBatchDataSetIterator(features_directory)
        ys = HDF5MiniBatchDataSetIterator(labels_directory)
        correct = total = 0
        for x, y in zip(xs, ys):
            out = net.output(np.asarray(x, np.float32))
            pred = np.argmax(out.detach().cpu().numpy(), axis=-1)
            correct += int(np.sum(pred == np.argmax(y, axis=-1)))
            total += len(y)
        return {"accuracy": correct / max(total, 1), "examples": total}

    def predict(self, model_file_path: str, features: list) -> dict:
        net = self._model(model_file_path)
        out = net.output(np.asarray(features, np.float32))
        return {"predictions": out.detach().cpu().numpy().tolist()}


_RPC_METHODS = frozenset({"fit", "evaluate", "predict"})

_LOOPBACK_HOSTS = frozenset({"127.0.0.1", "::1", "localhost", ""})


class _Handler(socketserver.StreamRequestHandler):
    def handle(self):
        for line in self.rfile:
            line = line.strip()
            if not line:
                continue
            try:
                req = json.loads(line)
                token = self.server.auth_token
                if token is not None:
                    supplied = str(req.get("token", ""))
                    if not hmac.compare_digest(supplied, token):
                        raise PermissionError("invalid or missing auth token")
                name = req["method"]
                if name not in _RPC_METHODS:
                    raise ValueError(f"unknown method {name!r} "
                                     f"(allowed: {sorted(_RPC_METHODS)})")
                method = getattr(self.server.entry_point, name)
                resp = {"ok": True, "result": method(**req.get("params", {}))}
            except Exception as e:  # report it to the caller, keep serving
                resp = {"ok": False, "error": f"{type(e).__name__}: {e}"}
            self.wfile.write((json.dumps(resp) + "\n").encode())
            self.wfile.flush()


class Server:
    """The JSON-lines TCP gateway (the reference's py4j ``GatewayServer``);
    :meth:`start` serves on a background thread.

    The methods read model and dataset files from paths the caller names,
    so a bind beyond loopback needs an ``auth_token``, which every request
    must then carry as ``token`` (checked in constant time)."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 entry_point: Optional[DeepLearning4jEntryPoint] = None,
                 auth_token: Optional[str] = None, device=None):
        if host not in _LOOPBACK_HOSTS and not auth_token:
            raise ValueError(
                f"refusing to bind {host!r}: the gateway executes file-path "
                "RPCs; pass auth_token= to expose it beyond loopback")
        self._srv = socketserver.ThreadingTCPServer(
            (host, port), _Handler, bind_and_activate=True)
        self._srv.daemon_threads = True
        self._srv.entry_point = entry_point or DeepLearning4jEntryPoint(
            device=device)
        self._srv.auth_token = auth_token
        self._thread: Optional[threading.Thread] = None

    @property
    def port(self) -> int:
        return self._srv.server_address[1]

    def start(self) -> "Server":
        self._thread = threading.Thread(target=self._srv.serve_forever,
                                        daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._srv.shutdown()
        self._srv.server_close()
        if self._thread is not None:
            self._thread.join(timeout=10)


def call(host: str, port: int, method: str, token: Optional[str] = None,
         **params):
    """One request to the gateway; returns its result or raises
    ``RuntimeError`` with the server's error."""
    req = {"method": method, "params": params}
    if token is not None:
        req["token"] = token
    with socket.create_connection((host, port)) as s:
        s.sendall((json.dumps(req) + "\n").encode())
        buf = b""
        while not buf.endswith(b"\n"):
            chunk = s.recv(65536)
            if not chunk:
                break
            buf += chunk
    resp = json.loads(buf.decode())
    if not resp.get("ok"):
        raise RuntimeError(resp.get("error", "gateway call failed"))
    return resp["result"]


# ------------------------------------------------------------------ serving
from .admission import (  # noqa: E402
    AdmissionController, RejectedError, normalize_priority)
from .autoscaler import Autoscaler
from .batcher import MicroBatcher, batch_bucket
from .decode import DecodeEngine, DecodeSession
from .loadgen import (
    run_ab, run_closed_loop, run_decode_ab, run_open_loop, run_paged_ab,
    run_ramp_ab, run_replica_ab, run_spec_ab, run_token_stream_load,
)
from .paging import PagePool
from .registry import (
    ModelRegistry, ModelVersion, global_model_registry,
    set_global_model_registry,
)
from .replica import Replica, ReplicaSet
from .serving import InferenceServer
from .streaming import StreamSessions

__all__ = ["AdmissionController", "Autoscaler", "DecodeEngine",
           "DecodeSession", "DeepLearning4jEntryPoint",
           "HDF5MiniBatchDataSetIterator", "InferenceServer", "MicroBatcher",
           "ModelRegistry", "ModelVersion", "PagePool", "RejectedError",
           "Replica", "ReplicaSet", "Server", "StreamSessions", "batch_bucket",
           "call", "global_model_registry", "normalize_priority", "run_ab",
           "run_closed_loop", "run_decode_ab", "run_open_loop", "run_paged_ab",
           "run_ramp_ab", "run_replica_ab", "run_spec_ab",
           "run_token_stream_load", "set_global_model_registry"]
