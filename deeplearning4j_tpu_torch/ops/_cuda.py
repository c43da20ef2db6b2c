"""Build and load the hand-written CUDA kernels under ``csrc/``.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for Hopper (``sm_90a``)
into its own shared library with a plain C interface, at first use, and
loaded with ``ctypes``. No PyTorch header is included, so a build takes
seconds. Libraries go to ``_build/`` inside the package (listed in
``.gitignore``), named by a hash of the source, the shared headers
(``csrc/*.cuh``) and the flags, so an edited source or header is rebuilt
and an unchanged one is reused. :func:`build` starts one
``nvcc`` per source, all at once.

``csrc/lstm.cu`` synchronizes its grid with cooperative groups'
``grid.sync()``. With CUDA 12 that needs a cooperative launch
(``cudaLaunchCooperativeKernel``) and no extra compiler flag (no ``-rdc``;
checked with nvcc 12.8 on the H100), so every source builds with the same
flags.

Each wrapper of a kernel is registered with :func:`counted` and counts
its launches in ``.launches``, a plain integer it increments through
:func:`count` where it launches its kernel. :func:`count` adds under one
lock, so wrappers called from several threads at once (replicas' batcher
threads, a decode pump beside them) lose no launch. A replayed CUDA graph
runs no Python: a capture runs inside :func:`capturing`, which diverts the
counts of launches made on the capture's stream (the backward's too, made
from autograd's own thread) into a record, while other streams' launches
count as usual; the code that replays the graph adds that record once a
replay.

Every C entry point takes its pointers and the CUDA stream as
``void*`` and returns ``cudaGetLastError()`` after the launch; wrappers
pass the result to :func:`check`, which raises on anything but 0.
Kernels launch on PyTorch's current stream and allocate nothing; wrappers
allocate outputs with ``torch.empty``. A temporary a wrapper hands to a
kernel may be freed when the wrapper returns: PyTorch's caching allocator
reuses memory in stream order, after the kernel.
"""
from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, Optional

_PKG = Path(__file__).resolve().parents[1]
SRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
_fns: Dict[tuple, object] = {}
#: nvcc's stderr per kernel source (ptxas register / shared-memory report)
build_log: Dict[str, str] = {}
#: wall seconds of the last :func:`build` call
build_seconds: Optional[float] = None
#: every kernel wrapper, each counting its launches in ``.launches``
COUNTED: list = []


def counted(fn):
    """Register a kernel wrapper and give it a launch count of 0."""
    fn.launches = 0
    COUNTED.append(fn)
    return fn


#: guards every read-modify-write of a ``.launches`` count
_count_lock = threading.Lock()
#: stream handle -> the record of the CUDA graph capture on that stream
_captures: Dict[int, Dict[object, int]] = {}


def _current_stream() -> int:
    import torch
    return torch.cuda.current_stream().cuda_stream


def count(fn, n: int = 1) -> None:
    """Add ``n`` to ``fn.launches`` under a lock (``fn.launches += n`` is a
    read-modify-write that loses increments when threads race). A launch
    on a stream that :func:`capturing` holds goes to that capture's record
    instead: a capture launches nothing."""
    with _count_lock:
        rec = _captures.get(_current_stream()) if _captures else None
        if rec is not None:
            rec[fn] = rec.get(fn, 0) + n
        else:
            fn.launches += n


@contextlib.contextmanager
def capturing(stream):
    """Record, as ``{wrapper: n}``, the launches counted on ``stream`` (a
    ``torch.cuda.Stream`` that a CUDA graph captures) from any thread;
    launches on other streams meanwhile count as usual."""
    key = stream.cuda_stream
    with _count_lock:
        if key in _captures:
            raise RuntimeError("a capture already records this stream")
        _captures[key] = rec = {}
    try:
        yield rec
    finally:
        with _count_lock:
            del _captures[key]


def launch_counts() -> Dict[object, int]:
    """Each registered wrapper's launch count."""
    return {fn: fn.launches for fn in COUNTED}


def sources() -> list:
    """Names of the kernel sources (``csrc/<name>.cu``)."""
    return sorted(p.stem for p in SRC_DIR.glob("*.cu"))


def nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit (nvcc on PATH or under /usr/local/cuda)")
    return path


def _so_path(name: str) -> Path:
    h = hashlib.sha256((SRC_DIR / f"{name}.cu").read_bytes())
    for header in sorted(SRC_DIR.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names: Optional[Iterable[str]] = None) -> Dict[str, Path]:
    """Compile every named source that has no up-to-date library yet, one
    ``nvcc`` process per source, all started together. Raises with the
    compiler's output when any build fails."""
    global build_seconds
    names = list(sources() if names is None else names)
    out = {n: _so_path(n) for n in names}
    todo = [n for n in names if not out[n].exists()]
    t0 = time.perf_counter()
    if todo:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        exe = nvcc()
        procs = {}
        for n in todo:
            tmp = out[n].with_suffix(f".{os.getpid()}.tmp")
            cmd = [exe, *NVCC_FLAGS, "-o", str(tmp), str(SRC_DIR / f"{n}.cu")]
            procs[n] = (tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
        errors = []
        for n, (tmp, p) in procs.items():
            so, se = p.communicate()
            build_log[n] = so + se
            if p.returncode != 0:
                errors.append(f"nvcc failed for {n}.cu (exit {p.returncode}):\n"
                              f"{so}{se}")
                continue
            os.replace(tmp, out[n])
        if errors:
            raise RuntimeError("\n".join(errors))
    build_seconds = time.perf_counter() - t0
    return out


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            path = build([name])[name]
            lib = _libs[name] = ctypes.CDLL(str(path))
            lib.error_string.argtypes = [ctypes.c_int]
            lib.error_string.restype = ctypes.c_char_p
        return lib


def function(lib_name: str, symbol: str, argtypes: list):
    """C entry point ``symbol`` of ``csrc/<lib_name>.cu`` with its argument
    types set (``c_void_p`` for every pointer and the stream, so ctypes
    never truncates a pointer to 32 bits) and an ``int`` result."""
    key = (lib_name, symbol)
    fn = _fns.get(key)
    if fn is None:
        fn = getattr(library(lib_name), symbol)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _fns[key] = fn
    return fn


def check(rc: int, lib_name: str, what: str) -> None:
    """Raise when a launch returned a CUDA error: a refused launch never
    runs, and a later synchronize would not report it."""
    if rc != 0:
        msg = library(lib_name).error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")


def stream_handle() -> int:
    """The raw ``cudaStream_t`` of PyTorch's current stream on this thread."""
    import torch
    return torch.cuda.current_stream().cuda_stream


PTR = ctypes.c_void_p
INT = ctypes.c_int
LONG = ctypes.c_longlong
FLOAT = ctypes.c_float
