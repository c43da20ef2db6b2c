"""Length-prefixed framed messages over stdlib sockets, and array serde.

Counterpart of ``deeplearning4j_tpu/streaming/wire.py``, byte for byte: a
frame written by either package reads in the other. One wire format serves
the parameter server's TCP transport (``parallel/ps_transport.py``) and the
loopback broker (``streaming/broker.py``). A frame is::

    !II          header_len, payload_len   (8-byte big-endian prefix)
    header_len   UTF-8 JSON header (op, offsets, array metadata, ...)
    payload_len  raw array bytes (concatenated, C-order)

Arrays ride the payload with their ``(name, dtype, shape, codec)`` in the
header under ``"arrays"``, so a frame describes itself. The ``bf16`` codec
halves float32 wire bytes (pushed parameter deltas); the server's state
stays float32. The JAX package takes bfloat16 from ``ml_dtypes``; the port
rounds in numpy on the float32 bit pattern (round to nearest, ties to
even; infinities, subnormals and -0 as they fall; every NaN to the quiet
NaN of its sign), which gives ``ml_dtypes``' codes bit for bit.

Tensor bytes are ``memoryview``\\ s end to end: ``encode_array`` returns a
view of the array's own buffer, ``pack_arrays`` leaves the views unjoined,
``send_frame`` hands them to ``socket.sendmsg``, ``recv_frame`` reads with
``recv_into`` and ``decode_array`` returns a read-only ``np.frombuffer``
view. Where bytes are copied (``copy=True`` decodes, the fallback without
``sendmsg``) they are counted in ``dl4j_wire_copy_bytes_total`` by site,
as in the JAX package; :func:`stats` reads the series back.

Trace propagation: the header key ``traceparent`` (and the same key inside
a broker message's ``meta``) is reserved for a W3C traceparent string. The
PS transports and the broker producer stamp it on outbound frames when an
ambient span exists, and the receiving side parents its handling span
(``ps.apply``, ``broker.consume``) from it: that is the whole cross-process
trace contract; the framing itself is unchanged.
"""
from __future__ import annotations

import json
import socket
import struct
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from ..observability.metrics import LabeledSeries, global_registry
from ..observability.names import WIRE_COPY_BYTES_TOTAL

_PREFIX = struct.Struct("!II")

#: codecs understood by encode_array/decode_array
CODECS = ("none", "bf16")

#: one buffer or a scatter-gather list of them (send_frame's payload type)
Buffers = Union[bytes, bytearray, memoryview,
                Sequence[Union[bytes, bytearray, memoryview]]]

_copy_bytes = LabeledSeries(global_registry().counter(
    WIRE_COPY_BYTES_TOTAL,
    "tensor bytes COPIED on the wire hot path, by site — flat under load "
    "is the zero-copy proof; any growth names the regressing call site"),
    "site")


def _count_copy(site: str, n: int) -> None:
    _copy_bytes(site).inc(int(n))


def stats() -> dict:
    """``{"copy_bytes": {site: bytes}}``: tensor bytes copied on the wire
    path, by site (``decode``, ``send_fallback``), read back from
    ``dl4j_wire_copy_bytes_total``."""
    return {"copy_bytes": _copy_bytes.read()}


def bf16_encode(a: np.ndarray) -> np.ndarray:
    """float32 values -> their bfloat16 codes as ``uint16`` (round to
    nearest, ties to even; a NaN becomes the quiet NaN of its sign)."""
    u = np.ascontiguousarray(a, dtype=np.float32).view(np.uint32)
    out = ((u + (0x7FFF + ((u >> 16) & 1))) >> 16).astype(np.uint16)
    nan = (u & 0x7FFFFFFF) > 0x7F800000
    if nan.any():
        out[nan] = ((u[nan] >> 16) & 0x8000).astype(np.uint16) | 0x7FC0
    return out


def bf16_decode(codes: np.ndarray, dtype="float32") -> np.ndarray:
    """bfloat16 codes (``uint16``) -> values of ``dtype`` (exact: every
    bfloat16 is a float32)."""
    wide = codes.astype(np.uint32) << 16
    return wide.view(np.float32).astype(dtype, copy=False)


def _byteview(buf) -> memoryview:
    """A flat unsigned-byte view of any buffer (ndarray, bytes, bytearray,
    memoryview) without copying."""
    v = buf if isinstance(buf, memoryview) else memoryview(buf)
    return v if v.format == "B" and v.ndim == 1 else v.cast("B")


def encode_array(a: np.ndarray, codec: str = "none",
                 ) -> Tuple[dict, memoryview]:
    """-> (metadata dict, payload view). The view aliases the (contiguous)
    array's own buffer: do not mutate ``a`` until it has been sent.
    ``bf16`` compresses floating arrays only; others pass unchanged and
    say so in the meta."""
    shape = list(a.shape)  # before ascontiguousarray, which 1-d-ifies 0-dim
    a = np.ascontiguousarray(a)
    if codec == "bf16" and a.dtype.kind == "f":
        meta = {"dtype": str(a.dtype), "shape": shape, "codec": "bf16"}
        a = bf16_encode(a)
    elif codec in CODECS:
        meta = {"dtype": str(a.dtype), "shape": shape, "codec": "none"}
    else:
        raise ValueError(f"unknown wire codec {codec!r}; expected {CODECS}")
    return meta, _byteview(a.reshape(-1))


def decode_array(meta: dict, buf, *, copy: bool = False) -> np.ndarray:
    """One array from its payload bytes or view: a read-only
    ``np.frombuffer`` view by default (``bf16`` widens to the recorded
    dtype); ``copy=True`` gives a private writable array and counts the
    bytes."""
    shape = tuple(meta["shape"])
    if meta["codec"] == "bf16":
        a = bf16_decode(np.frombuffer(buf, dtype=np.uint16), meta["dtype"])
    else:
        a = np.frombuffer(buf, dtype=np.dtype(meta["dtype"]))
        if copy:
            _count_copy("decode", a.nbytes)
            a = a.copy()
    return a.reshape(shape)


def pack_arrays(arrays: Dict[str, np.ndarray], codec: str = "none",
                ) -> Tuple[List[dict], List[memoryview]]:
    """Named arrays -> ordered metadata list + scatter-gather view list
    (feed the list straight to ``send_frame``; nothing is joined)."""
    metas, views = [], []
    for name, a in arrays.items():
        meta, buf = encode_array(np.asarray(a), codec)
        meta["name"] = name
        meta["nbytes"] = buf.nbytes
        metas.append(meta)
        views.append(buf)
    return metas, views


def unpack_arrays(metas: List[dict], payload) -> Dict[str, np.ndarray]:
    """Inverse of pack_arrays; the arrays are views into ``payload``."""
    view = _byteview(payload) if payload else memoryview(b"")
    out, off = {}, 0
    for meta in metas:
        n = meta["nbytes"]
        out[meta["name"]] = decode_array(meta, view[off:off + n])
        off += n
    return out


def send_frame(sock: socket.socket, header: dict,
               payload: Buffers = b"") -> int:
    """Write one frame; returns the bytes put on the wire. A list payload
    goes to ``socket.sendmsg`` as it is (no join)."""
    hdr = json.dumps(header, separators=(",", ":")).encode("utf-8")
    bufs = payload if isinstance(payload, (list, tuple)) else [payload]
    views = [_byteview(b) for b in bufs if len(b)]
    payload_len = sum(v.nbytes for v in views)
    prefix = _PREFIX.pack(len(hdr), payload_len)
    total = len(prefix) + len(hdr) + payload_len
    pending = [memoryview(prefix), memoryview(hdr)] + views
    sendmsg = getattr(sock, "sendmsg", None)
    if sendmsg is None:  # no sendmsg: one joined copy, counted
        _count_copy("send_fallback", payload_len)
        sock.sendall(b"".join(pending))
        return total
    while pending:
        n = sendmsg(pending)
        while pending and n >= pending[0].nbytes:
            n -= pending[0].nbytes
            pending.pop(0)
        if pending and n:
            pending[0] = pending[0][n:]
    return total


def _recv_into_exact(sock: socket.socket, view: memoryview) -> None:
    while view.nbytes:
        n = sock.recv_into(view, view.nbytes)
        if not n:
            raise ConnectionError("peer closed mid-frame")
        view = view[n:]


def recv_frame(sock: socket.socket, buffer: Optional[bytearray] = None,
               ) -> Tuple[dict, memoryview]:
    """Read one frame: ``(header, payload view)``; raises
    ``ConnectionError`` at EOF or on a truncated stream. Without ``buffer``
    the payload lands in a fresh bytearray (safe to keep); with a reusable
    ``buffer`` (grown in place) the next call on it overwrites the payload,
    so only a caller that consumes each payload first may pass one."""
    prefix = bytearray(_PREFIX.size)
    _recv_into_exact(sock, memoryview(prefix))
    hdr_len, payload_len = _PREFIX.unpack(prefix)
    hdr = bytearray(hdr_len)
    _recv_into_exact(sock, memoryview(hdr))
    header = json.loads(hdr.decode("utf-8"))
    if not payload_len:
        return header, memoryview(b"")
    if buffer is None:
        buffer = bytearray(payload_len)
    elif len(buffer) < payload_len:
        try:
            buffer.extend(bytes(payload_len - len(buffer)))
        except BufferError:
            # a view of an earlier frame is still alive: allocate anew
            buffer = bytearray(payload_len)
    view = memoryview(buffer)[:payload_len]
    _recv_into_exact(sock, view)
    return header, view.toreadonly()


def request(sock: socket.socket, header: dict, payload: Buffers = b"",
            buffer: Optional[bytearray] = None,
            ) -> Tuple[dict, memoryview, int]:
    """One round trip: send a frame, read the reply frame. Returns
    ``(reply_header, reply_payload, bytes_sent)``; an error reply raises
    ``RuntimeError``."""
    sent = send_frame(sock, header, payload)
    reply, buf = recv_frame(sock, buffer)
    if "error" in reply:
        raise RuntimeError(f"peer error for op={header.get('op')!r}: "
                           f"{reply['error']}")
    return reply, buf, sent


def connect(addr: Tuple[str, int], timeout: Optional[float] = 30.0,
            ) -> socket.socket:
    sock = socket.create_connection(addr, timeout=timeout)
    sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
    return sock
