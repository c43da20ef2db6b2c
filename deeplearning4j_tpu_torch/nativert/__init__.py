"""The port's host runtime: a C++ library that stages host data.

Counterpart of ``deeplearning4j_tpu/nativert/__init__.py``. The library is
the port's own copy of the JAX package's ``native/src/dl4j_runtime.cpp``
(``dl4j_runtime.cpp`` beside this file): the IDX and CIFAR parsers, a
producer thread assembling normalized float32 batches into a bounded queue
(``AsyncNativeLoader``, the reference's ``AsyncDataSetIterator``), a strict
numeric CSV reader, the DLTS stats codec, a batched record decoder
(``decode_records``, ``IngestDecoder``) and a parallel token counter. It
touches host memory only; the card sees what the loaders hand to ``fit``.

It is built at first use (:func:`get_runtime`) into ``_build/`` inside the
package, with the JAX package's flags (``-O3 -std=c++17 -fPIC -shared
-pthread``), by the compiler ``$CXX`` names, else the first of ``g++``,
``c++`` and ``clang++`` on the path; :data:`build_info` says which, and
how long the build took. The library's name hashes the source, the flags
and the compiler, so an edited source is rebuilt. A build that fails
raises with the compiler's output, after a ``native_build_failed`` event
in the flight recorder; nothing falls back to Python. The record decoders
count their input bytes in ``dl4j_ingest_decode_bytes_total`` by path
(``native``, ``python``), as the JAX module does.

Each entry point has a plain Python version here (``*_py``), which the
tests hold bitwise against the native one. ``read_csv_numeric`` with
``strict=True`` returns None on a field that is not a number, and
``count_tokens_file`` returns None on non-ASCII text: that is what those
readers mean (their callers then take the general string reader and the
unicode tokenizer), not a missing library.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import struct
import subprocess
import threading
import time
from collections import Counter
from pathlib import Path
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from ..observability.flight_recorder import global_recorder
from ..observability.metrics import global_registry
from ..observability.names import INGEST_DECODE_BYTES_TOTAL

_ingest_bytes = global_registry().counter(
    INGEST_DECODE_BYTES_TOTAL,
    "raw record bytes decoded to f32 batches, by path (native/python)")
_ingest_native = _ingest_bytes.labels(path="native")
_ingest_python = _ingest_bytes.labels(path="python")

_PKG = Path(__file__).resolve().parents[1]
SRC_PATH = Path(__file__).resolve().parent / "dl4j_runtime.cpp"
BUILD_DIR = _PKG / "_build"
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-shared", "-pthread")
#: the C side's ``dl4j_runtime_version``
RUNTIME_VERSION = 4

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
#: the last build or load: ``{"compiler", "seconds", "library", "built"}``
build_info: Dict[str, object] = {}

c_i64 = ctypes.c_int64
c_f32p = ctypes.POINTER(ctypes.c_float)
c_u8p = ctypes.POINTER(ctypes.c_uint8)
c_i32p = ctypes.POINTER(ctypes.c_int32)
c_i64p = ctypes.POINTER(ctypes.c_int64)


# ------------------------------------------------------------------- build
def compiler() -> str:
    """The C++ compiler: ``$CXX``, else the first of ``g++``, ``c++`` and
    ``clang++`` on the path."""
    cxx = os.environ.get("CXX")
    if cxx:
        found = shutil.which(cxx)
        if found is None:
            raise RuntimeError(f"$CXX={cxx!r} is not an executable")
        return found
    for name in ("g++", "c++", "clang++"):
        found = shutil.which(name)
        if found:
            return found
    raise RuntimeError("no C++ compiler: set $CXX or put g++, c++ or clang++ "
                       "on the path to build the host runtime")


def _so_path(cxx: str) -> Path:
    h = hashlib.sha256(SRC_PATH.read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    h.update(cxx.encode())
    return BUILD_DIR / f"libdl4j_runtime-{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile ``dl4j_runtime.cpp`` unless an up-to-date library exists;
    raises ``RuntimeError`` with the compiler's output if it fails."""
    cxx = compiler()
    out = _so_path(cxx)
    t0 = time.perf_counter()
    built = False
    if not out.exists():
        out.parent.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [cxx, *CXX_FLAGS, str(SRC_PATH), "-o", str(tmp)]
        try:
            r = subprocess.run(cmd, capture_output=True, text=True,
                               timeout=300)
        except (OSError, subprocess.SubprocessError) as e:
            global_recorder().record("native_build_failed",
                                     src=str(SRC_PATH), error=repr(e))
            raise RuntimeError(f"building the host runtime with {cxx} "
                               f"failed: {e!r}") from e
        if r.returncode != 0 or not tmp.exists():
            global_recorder().record(
                "native_build_failed", src=str(SRC_PATH),
                error=f"exit {r.returncode}", stderr=r.stderr[-500:])
            raise RuntimeError(
                f"building the host runtime failed: {' '.join(cmd)} exited "
                f"{r.returncode}:\n{r.stdout}{r.stderr}")
        os.replace(tmp, out)
        built = True
    if built or build_info.get("library") != str(out):
        # a later call that finds the library keeps the build's record
        build_info.update(compiler=cxx, seconds=time.perf_counter() - t0,
                          library=str(out), built=built)
    return out


def _declare(lib: ctypes.CDLL) -> None:
    def sig(name, restype, argtypes):
        fn = getattr(lib, name)
        fn.restype, fn.argtypes = restype, argtypes

    vp, ci, cc = ctypes.c_void_p, ctypes.c_int, ctypes.c_char_p
    sig("dl4j_idx_open", vp, [cc])
    sig("dl4j_idx_ndim", ci, [vp])
    sig("dl4j_idx_dims", None, [vp, c_i64p])
    sig("dl4j_idx_read", None, [vp, c_u8p])
    sig("dl4j_idx_close", None, [vp])
    sig("dl4j_loader_create_from_arrays", vp,
        [c_u8p, c_u8p, c_i64, c_i64, ci, ci, ci, ci, ctypes.c_uint64, ci])
    sig("dl4j_mnist_loader_create", vp,
        [cc, cc, ci, ci, ci, ctypes.c_uint64, ci])
    sig("dl4j_cifar_loader_create", vp,
        [ctypes.POINTER(cc), ci, ci, ci, ci, ctypes.c_uint64])
    for name in ("dl4j_loader_num_examples", "dl4j_loader_feature_size"):
        sig(name, c_i64, [vp])
    for name in ("dl4j_loader_num_classes", "dl4j_loader_batch_size"):
        sig(name, ci, [vp])
    sig("dl4j_loader_next", ci, [vp, c_f32p, c_f32p])
    sig("dl4j_loader_reset", None, [vp])
    sig("dl4j_loader_close", None, [vp])
    sig("dl4j_csv_open2", vp, [cc, ctypes.c_char, ci, ci])
    sig("dl4j_csv_rows", c_i64, [vp])
    sig("dl4j_csv_cols", c_i64, [vp])
    sig("dl4j_csv_read", None, [vp, c_f32p])
    sig("dl4j_csv_close", None, [vp])
    sig("dl4j_stats_begin", vp, [cc, cc, c_i64, ctypes.c_int32,
                                 ctypes.c_double, ctypes.c_double,
                                 ctypes.c_double, c_i64, c_i64])
    sig("dl4j_stats_add", ci, [vp, ci, cc, ctypes.c_double, ctypes.c_double,
                               ctypes.c_double, c_i32p, ci])
    sig("dl4j_stats_finish", c_i64, [vp, c_u8p, c_i64])
    sig("dl4j_stats_abort", None, [vp])
    sig("dl4j_runtime_version", ci, [])
    sig("dl4j_vocab_count_file", vp, [cc, ci, ci])
    sig("dl4j_vocab_num_words", c_i64, [vp])
    sig("dl4j_vocab_total_tokens", c_i64, [vp])
    sig("dl4j_vocab_entry", c_i64, [vp, c_i64, cc, c_i64])
    sig("dl4j_vocab_close", None, [vp])
    sig("dl4j_ingest_decode", c_i64, [c_u8p, c_i64, ci, c_f32p, c_i64])
    sig("dl4j_ingest_create", vp, [ci])
    sig("dl4j_ingest_submit", ci, [vp, c_u8p, c_i64, ci])
    sig("dl4j_ingest_next", c_i64, [vp, c_f32p, c_i64])
    sig("dl4j_ingest_close", None, [vp])


def get_runtime() -> ctypes.CDLL:
    """The loaded runtime, built at first use; raises if it cannot be."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            _declare(lib)
            if lib.dl4j_runtime_version() != RUNTIME_VERSION:
                raise RuntimeError("the host runtime library is version "
                                   f"{lib.dl4j_runtime_version()}, not "
                                   f"{RUNTIME_VERSION}")
            _lib = lib
        return _lib


def native_available() -> bool:
    """True once the runtime is built and loaded (a failed build raises)."""
    return get_runtime() is not None


# --------------------------------------------------------------------- IDX
def read_idx_py(path: str) -> np.ndarray:
    """The plain version of :func:`read_idx`: the same checks and array."""
    with open(path, "rb") as f:
        data = f.read()
    if len(data) < 4:
        raise ValueError(f"{path}: not a uint8 IDX file")
    magic = struct.unpack(">I", data[:4])[0]
    ndim = magic & 0xFF
    if (magic >> 8) & 0xFF != 0x08 or not 1 <= ndim <= 4 \
            or len(data) < 4 + 4 * ndim:
        raise ValueError(f"{path}: not a uint8 IDX file")
    dims = list(struct.unpack(f">{ndim}I", data[4:4 + 4 * ndim]))
    total = int(np.prod(dims))
    if min(dims) <= 0 or len(data) - 4 - 4 * ndim < total:
        raise ValueError(f"{path}: IDX dims {dims} exceed the file")
    return np.frombuffer(data, np.uint8, total, 4 + 4 * ndim).reshape(dims)


def read_idx(path: str) -> np.ndarray:
    """An IDX (MNIST-format) uint8 file parsed natively; raises
    ``ValueError`` for a file that is not one."""
    lib = get_runtime()
    h = lib.dl4j_idx_open(str(path).encode())
    if not h:
        raise ValueError(f"{path}: not a uint8 IDX file (or unreadable)")
    try:
        ndim = lib.dl4j_idx_ndim(h)
        dims = np.zeros(ndim, np.int64)
        lib.dl4j_idx_dims(h, dims.ctypes.data_as(c_i64p))
        out = np.empty(int(dims.prod()), np.uint8)
        lib.dl4j_idx_read(h, out.ctypes.data_as(c_u8p))
        return out.reshape(dims.tolist())
    finally:
        lib.dl4j_idx_close(h)


# --------------------------------------------------------------------- CSV
#: the prefix strtof consumes as a number: leading whitespace, then a
#: decimal or hex float, inf or nan
_STRTOF = re.compile(
    r"[ \t\n\v\f\r]*[+-]?(?:0[xX](?:[0-9a-fA-F]+\.?[0-9a-fA-F]*|"
    r"\.[0-9a-fA-F]+)(?:[pP][+-]?\d+)?|(?:\d+\.?\d*|\.\d+)(?:[eE][+-]?\d+)?"
    r"|inf(?:inity)?|nan)", re.IGNORECASE)
#: what may follow a number in a field that is one
_TRAILER = re.compile(r"[ \t\r]*")


def _strtof(field: str) -> Tuple[np.float32, bool]:
    """``(value, whole)``: the number a field starts with (0 if none) and
    whether the field is that number and trailing blanks only."""
    m = _STRTOF.match(field)
    if m is None:
        return np.float32(0.0), False
    s = m.group().strip(" \t\n\v\f\r").lower()
    if "x" in s:
        sign = -1.0 if s.startswith("-") else 1.0
        v = np.float32(sign * float.fromhex(s.lstrip("+-")))
    else:
        v = np.float32(s)
    return v, _TRAILER.fullmatch(field, m.end()) is not None


def read_csv_numeric_py(path: str, delimiter: str = ",", skip_lines: int = 0,
                        strict: bool = False) -> Optional[np.ndarray]:
    """The plain version of :func:`read_csv_numeric`: lines split at
    ``\\n``, empty lines skipped, each field parsed as the C library's
    ``strtof`` parses it."""
    with open(path, "rb") as f:
        text = f.read().decode("latin-1")
    rows: List[List[float]] = []
    cols = 0
    for i, line in enumerate(text.split("\n")):
        if i < skip_lines or not line:
            continue
        vals = []
        for field in line.split(delimiter):
            v, whole = _strtof(field)
            if strict and not whole:
                return None
            vals.append(v)
        if not cols:
            cols = len(vals)
        if len(vals) != cols:
            if strict:
                return None
            vals = (vals + [np.float32(0.0)] * cols)[:cols]
        rows.append(vals)
    return np.asarray(rows, np.float32).reshape(len(rows), cols)


def read_csv_numeric(path: str, delimiter: str = ",", skip_lines: int = 0,
                     strict: bool = False) -> Optional[np.ndarray]:
    """A numeric CSV -> float32 ``[rows, cols]`` in one native pass.

    ``strict=False``: a field reads as the number it starts with (0 if
    none), a short row is padded with 0 and a long one cut.
    ``strict=True``: None on the first empty or non-numeric field or
    ragged row, so the caller can take its general string-preserving
    reader. Raises ``OSError`` for a file that cannot be read."""
    lib = get_runtime()
    if not os.path.isfile(path):
        raise OSError(f"cannot read {path}")
    h = lib.dl4j_csv_open2(str(path).encode(), delimiter.encode()[:1],
                           int(skip_lines), 1 if strict else 0)
    if not h:
        if strict:
            return None
        raise OSError(f"cannot read {path}")
    try:
        rows, cols = lib.dl4j_csv_rows(h), lib.dl4j_csv_cols(h)
        out = np.empty((int(rows), int(cols)), np.float32)
        if rows and cols:
            lib.dl4j_csv_read(h, out.ctypes.data_as(c_f32p))
        return out
    finally:
        lib.dl4j_csv_close(h)


# ------------------------------------------------------------- the loaders
_SM_GAMMA = np.uint64(0x9E3779B97F4A7C15)


def shuffle_order_py(n: int, seed: int) -> np.ndarray:
    """The loader's permutation of ``range(n)`` for ``seed`` (the C side's
    ``shuffle_order``: Fisher-Yates from the end over splitmix64)."""
    order = np.arange(n, dtype=np.int64)
    if n < 2:
        return order
    k = np.arange(1, n, dtype=np.uint64)
    with np.errstate(over="ignore"):
        z = np.uint64(seed % 2**64) + k * _SM_GAMMA
        z = (z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
        z = (z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
        z = z ^ (z >> np.uint64(31))
    bounds = np.arange(n, 1, -1, dtype=np.uint64)  # i + 1 for i = n-1 .. 1
    js = (z % bounds).astype(np.int64).tolist()
    o = order.tolist()
    for i, j in zip(range(n - 1, 0, -1), js):
        o[i], o[j] = o[j], o[i]
    return np.asarray(o, np.int64)


def loader_batches_py(features: np.ndarray, labels: np.ndarray,
                      num_classes: int, batch: int, shuffle: bool = True,
                      seed: int = 0, normalize: bool = True, epoch: int = 0
                      ) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """The plain version of an :class:`AsyncNativeLoader` epoch: the same
    ``(features [B, F] float32, one-hot labels [B, C] float32)`` batches,
    the last partial batch dropped."""
    f = np.ascontiguousarray(features, np.uint8).reshape(len(features), -1)
    lab = np.ascontiguousarray(labels, np.uint8).ravel()
    n = len(f)
    order = shuffle_order_py(n, seed + epoch) if shuffle \
        else np.arange(n, dtype=np.int64)
    scale = np.float32(1.0 / 255.0) if normalize else np.float32(1.0)
    for b in range(n // batch):
        idx = order[b * batch:(b + 1) * batch]
        x = f[idx].astype(np.float32) * scale
        y = np.zeros((batch, num_classes), np.float32)
        cls = lab[idx].astype(np.int64)
        ok = cls < num_classes
        y[np.arange(batch)[ok], cls[ok]] = 1.0
        yield x, y


def read_cifar_py(paths: Sequence[str]) -> Tuple[np.ndarray, np.ndarray]:
    """CIFAR-10 binary records (a label byte, then 3,072 pixel bytes) as
    ``(features [N, 3072] uint8, labels [N] uint8)``, the records the native
    CIFAR loader reads."""
    feats, labs = [], []
    for p in paths:
        raw = np.fromfile(p, np.uint8)
        recs = raw[:len(raw) // 3073 * 3073].reshape(-1, 3073)
        labs.append(recs[:, 0])
        feats.append(recs[:, 1:])
    return np.concatenate(feats), np.concatenate(labs)


class AsyncNativeLoader:
    """Native async batch loader: a C++ producer thread assembles
    normalized float32 batches (one-hot labels) into a bounded queue of
    ``capacity``; iteration blocks on the queue; :meth:`reset` restarts the
    epoch with the next shuffle (``seed + epoch``). Use after
    :meth:`close` raises ``ValueError``."""

    def __init__(self, handle, lib, what: str):
        if not handle:
            raise ValueError(f"native loader creation failed: {what}")
        self._h = handle
        self._lib = lib
        self.batch = lib.dl4j_loader_batch_size(handle)
        self.feature_size = int(lib.dl4j_loader_feature_size(handle))
        self.num_classes = lib.dl4j_loader_num_classes(handle)
        self.num_examples = int(lib.dl4j_loader_num_examples(handle))

    @classmethod
    def from_arrays(cls, features: np.ndarray, labels: np.ndarray,
                    num_classes: int, batch: int, capacity: int = 4,
                    shuffle: bool = True, seed: int = 0,
                    normalize: bool = True) -> "AsyncNativeLoader":
        lib = get_runtime()
        f = np.ascontiguousarray(features, np.uint8).reshape(len(features), -1)
        lab = np.ascontiguousarray(labels, np.uint8).ravel()
        h = lib.dl4j_loader_create_from_arrays(
            f.ctypes.data_as(c_u8p), lab.ctypes.data_as(c_u8p),
            f.shape[0], f.shape[1], num_classes, batch, capacity,
            int(shuffle), seed, int(normalize))
        return cls(h, lib, f"{f.shape[0]} examples at batch {batch}")

    @classmethod
    def mnist(cls, images_path: str, labels_path: str, batch: int,
              capacity: int = 4, shuffle: bool = True, seed: int = 0,
              normalize: bool = True) -> "AsyncNativeLoader":
        lib = get_runtime()
        h = lib.dl4j_mnist_loader_create(
            str(images_path).encode(), str(labels_path).encode(), batch,
            capacity, int(shuffle), seed, int(normalize))
        return cls(h, lib, f"IDX files {images_path}, {labels_path}")

    @classmethod
    def cifar(cls, paths: Sequence[str], batch: int, capacity: int = 4,
              shuffle: bool = True, seed: int = 0) -> "AsyncNativeLoader":
        lib = get_runtime()
        arr = (ctypes.c_char_p * len(paths))(
            *[str(p).encode() for p in paths])
        h = lib.dl4j_cifar_loader_create(arr, len(paths), batch, capacity,
                                         int(shuffle), seed)
        return cls(h, lib, f"CIFAR files {list(paths)}")

    def __len__(self) -> int:
        return self.num_examples // self.batch

    def next(self) -> Optional[tuple]:
        """The next ``(features [B, F] f32, one-hot labels [B, C] f32)``, or
        None at the end of the epoch."""
        if not self._h:
            raise ValueError("loader is closed")
        x = np.empty((self.batch, self.feature_size), np.float32)
        y = np.empty((self.batch, self.num_classes), np.float32)
        ok = self._lib.dl4j_loader_next(
            self._h, x.ctypes.data_as(c_f32p), y.ctypes.data_as(c_f32p))
        return (x, y) if ok else None

    def reset(self) -> None:
        if not self._h:
            raise ValueError("loader is closed")
        self._lib.dl4j_loader_reset(self._h)

    def __iter__(self):
        while True:
            b = self.next()
            if b is None:
                return
            yield b

    def close(self) -> None:
        if self._h:
            self._lib.dl4j_loader_close(self._h)
            self._h = None

    def __del__(self):
        if getattr(self, "_h", None):
            self.close()


# ------------------------------------------------------------- stats codec
def encode_stats_py(session_id: str, worker_id: str, timestamp: int,
                    iteration: int, score: float, iter_time_ms: float,
                    samples_per_sec: float, mem_rss: int, device_mem: int,
                    sections: List[dict]) -> bytes:
    """The plain version of :func:`encode_stats_native`: the DLTS bytes."""
    out = bytearray(b"DLTS")
    out += struct.pack("<H", 1)
    for s in (session_id, worker_id):
        b = s.encode()
        out += struct.pack("<H", len(b)) + b
    out += struct.pack("<qidddqq", timestamp, iteration, score, iter_time_ms,
                       samples_per_sec, mem_rss, device_mem)
    for section in list(sections[:3]) + [{}] * (3 - len(sections[:3])):
        out += struct.pack("<H", len(section))
        for name, (mm, hist, (lo, hi)) in section.items():
            nb = name.encode()
            out += struct.pack("<H", len(nb)) + nb
            out += struct.pack("<dddH", mm, lo, hi, len(hist))
            out += struct.pack(f"<{len(hist)}i", *hist)
    return bytes(out)


def encode_stats_native(session_id: str, worker_id: str, timestamp: int,
                        iteration: int, score: float, iter_time_ms: float,
                        samples_per_sec: float, mem_rss: int, device_mem: int,
                        sections: List[dict]) -> bytes:
    """A StatsReport in the DLTS wire format, encoded natively.
    ``sections`` is ``[params, gradients, updates]``, each ``name ->
    (mean magnitude, histogram, (lo, hi))``."""
    lib = get_runtime()
    h = lib.dl4j_stats_begin(session_id.encode(), worker_id.encode(),
                             timestamp, iteration, score, iter_time_ms,
                             samples_per_sec, mem_rss, device_mem)
    if not h:
        raise RuntimeError("dl4j_stats_begin failed")
    try:
        for si, section in enumerate(sections[:3]):
            for name, (mm, hist, (lo, hi)) in section.items():
                ha = np.asarray(hist, np.int32)
                lib.dl4j_stats_add(h, si, name.encode(), float(mm), float(lo),
                                   float(hi), ha.ctypes.data_as(c_i32p),
                                   len(ha))
        n = lib.dl4j_stats_finish(h, None, 0)
        out = np.empty(int(n), np.uint8)
        written = lib.dl4j_stats_finish(h, out.ctypes.data_as(c_u8p), n)
        h = None  # finish with a large enough buffer frees the builder
        if written != n:
            raise RuntimeError(f"dl4j_stats_finish wrote {written} of {n}")
        return out.tobytes()
    finally:
        if h:
            lib.dl4j_stats_abort(h)


# ----------------------------------------------------------- ingest decode
#: codec ids shared with dl4j_runtime.cpp (kIngestF32/Bf16/U8)
INGEST_CODECS = {"f32": 0, "none": 0, "bf16": 1, "u8": 2}
#: bytes per element, by codec id
_INGEST_WIDTH = {0: 4, 1: 2, 2: 1}


def decode_records_py(buf, codec: str = "f32") -> np.ndarray:
    """The plain version of :func:`decode_records`."""
    cid = INGEST_CODECS[codec]
    raw = np.frombuffer(buf, np.uint8)
    if len(raw) % _INGEST_WIDTH[cid]:
        raise ValueError(f"ragged record: {len(raw)} bytes is not a whole "
                         f"number of {codec} elements")
    _ingest_python.inc(len(raw))
    if cid == 0:
        return raw.view(np.float32).copy()
    if cid == 1:
        bits = raw.view("<u2").astype(np.uint32) << np.uint32(16)
        return bits.view(np.float32)
    # the float32 reciprocal, as the native decoder and loader multiply
    return raw.astype(np.float32) * np.float32(1.0 / 255.0)


def decode_records(buf, codec: str = "f32") -> np.ndarray:
    """One record's bytes -> float32, decoded natively (ctypes releases
    the interpreter lock for the call); raises ``ValueError`` on a length
    that is not a whole number of elements."""
    lib = get_runtime()
    cid = INGEST_CODECS[codec]
    raw = np.frombuffer(buf, np.uint8)
    if len(raw) % _INGEST_WIDTH[cid]:
        raise ValueError(f"ragged record: {len(raw)} bytes is not a whole "
                         f"number of {codec} elements")
    n = len(raw) // _INGEST_WIDTH[cid]
    out = np.empty(n, np.float32)
    wrote = lib.dl4j_ingest_decode(raw.ctypes.data_as(c_u8p), len(raw), cid,
                                   out.ctypes.data_as(c_f32p), n)
    if wrote != n:
        raise RuntimeError(f"dl4j_ingest_decode wrote {wrote} of {n}")
    _ingest_native.inc(len(raw))
    return out


class IngestDecoder:
    """Pipelined native decoder: :meth:`submit` stages a record's bytes
    into a bounded native queue, a C++ worker thread decodes them, and
    :meth:`next` returns finished records in submission order (None when
    all are collected). ``submit`` blocks once ``capacity`` records are in
    flight, so interleave it with ``next`` past that."""

    def __init__(self, capacity: int = 8):
        lib = get_runtime()
        self._lib = lib
        self._h = lib.dl4j_ingest_create(int(capacity))
        if not self._h:
            raise RuntimeError("native ingest creation failed")
        self._sizes: List[int] = []  # expected output lengths, in order

    def submit(self, buf, codec: str = "f32") -> None:
        if not self._h:
            raise ValueError("decoder is closed")
        cid = INGEST_CODECS[codec]
        raw = np.frombuffer(buf, np.uint8)
        if len(raw) % _INGEST_WIDTH[cid]:
            raise ValueError(f"ragged record: {len(raw)} bytes is not a "
                             f"whole number of {codec} elements")
        rc = self._lib.dl4j_ingest_submit(
            self._h, raw.ctypes.data_as(c_u8p), len(raw), cid)
        if rc != 0:
            raise RuntimeError("ingest pipeline poisoned by a bad record")
        _ingest_native.inc(len(raw))
        self._sizes.append(len(raw) // _INGEST_WIDTH[cid])

    def next(self) -> Optional[np.ndarray]:
        if not self._h:
            raise ValueError("decoder is closed")
        if not self._sizes:
            return None
        n = self._sizes.pop(0)
        out = np.empty(n, np.float32)
        wrote = self._lib.dl4j_ingest_next(
            self._h, out.ctypes.data_as(c_f32p), n)
        if wrote != n:
            raise RuntimeError(f"ingest decode returned {wrote}, "
                               f"expected {n}")
        return out

    def close(self) -> None:
        if self._h:
            self._lib.dl4j_ingest_close(self._h)
            self._h = None

    def __del__(self):
        if getattr(self, "_h", None):
            self.close()


# --------------------------------------------------------- token counting
#: Python ``str.split()`` whitespace in the ASCII range
_SPACE = re.compile(r"[\t\n\v\f\r \x1c-\x1f]+")
#: CommonPreprocessor's stripped characters
_STRIP = re.compile(r"[\d.:,\"'()\[\]|/?!;]+")


def count_tokens_py(path: str, common_preprocess: bool = False
                    ) -> Optional[List[tuple]]:
    """The plain version of :func:`count_tokens_file`."""
    with open(path, "rb") as f:
        data = f.read()
    if any(b >= 0x80 or (b < 0x20 and b not in b"\t\n\v\f\r\x1c\x1d\x1e\x1f")
           for b in set(data)):
        return None
    counts: Counter = Counter()
    for tok in _SPACE.split(data.decode("ascii")):
        if common_preprocess:
            tok = _STRIP.sub("", tok).lower()
        if tok:
            counts[tok] += 1
    return sorted(counts.items(), key=lambda kv: (-kv[1], kv[0]))


def count_tokens_file(path: str, common_preprocess: bool = False,
                      nthreads: int = 0) -> Optional[List[tuple]]:
    """Whitespace tokens of an ASCII text file counted by worker threads:
    ``[(word, count), ...]`` by count, then word. None for text with
    non-ASCII or control bytes (the unicode tokenizer's job); raises
    ``OSError`` for a file that cannot be read. ``common_preprocess``
    applies CommonPreprocessor's rules (strip punctuation and digits,
    lowercase) during the scan."""
    lib = get_runtime()
    if not os.path.isfile(path):
        raise OSError(f"cannot read {path}")
    h = lib.dl4j_vocab_count_file(str(path).encode(),
                                  1 if common_preprocess else 0,
                                  int(nthreads))
    if not h:
        return None
    try:
        n = lib.dl4j_vocab_num_words(h)
        cap = 65536
        buf = ctypes.create_string_buffer(cap)
        out = []
        for i in range(int(n)):
            cnt = lib.dl4j_vocab_entry(h, i, buf, cap)
            word = buf.value.decode("ascii")
            if cnt < 0 or len(word) >= cap - 1:
                return None  # a token the C ABI may have cut
            out.append((word, int(cnt)))
        return out
    finally:
        lib.dl4j_vocab_close(h)
