"""The subset of HDF5 that Keras-1 archives use, read and written with
numpy and the standard library.

Counterpart of ``deeplearning4j_tpu/modelimport/hdf5.py``, which binds
``libhdf5`` through ctypes. The port needs no HDF5 library: it parses and
lays out the file format itself, with the JAX ``H5File``'s API
(``exists``, ``list_group``, ``read_dataset``, ``read_attr``,
``has_attr``, ``create_group``, ``write_dataset``, ``write_attr``,
``close`` and the context manager).

What it reads is what ``libhdf5``'s default ("earliest") format writes,
which is what the JAX ``H5File`` and ``h5py`` write by default:

* superblock version 0 or 1, 8-byte offsets and lengths;
* version-1 object headers, with their continuation blocks;
* symbol-table groups: version-1 B-trees of any depth, symbol-table nodes
  and local heaps;
* the dataspace, datatype (fixed-point, floating-point including float16,
  fixed- and variable-length strings), fill value, data layout (version 3
  or 4, contiguous or compact) and attribute (versions 1 to 3) messages;
* variable-length strings in global heap collections, and a dataset whose
  data was never written (an undefined address: its fill value, or zeros).

Anything else raises :class:`UnsupportedHDF5Feature`, naming the feature:
chunked layout, a filter pipeline, version-2 object headers or
superblocks, dense attribute storage, link-message groups, shared
messages, other datatype classes.

Writing emits the same subset. A dataset's bytes go to the end of the file
when it is written, so an archive is never held in memory twice; object
headers, local heaps, B-trees and symbol-table nodes are laid out at
:meth:`H5File.close`, then the superblock. Strings are written as the JAX
``H5File`` writes them: fixed-length, null-terminated ASCII-class strings
one byte longer than the longest value; numeric attributes as 1-D arrays.
An attribute message larger than a version-1 header message can hold
(65,535 bytes) raises, as ``libhdf5`` refuses it in this format.
"""
from __future__ import annotations

import struct
import threading
from typing import Dict, List, Optional, Tuple, Union

import numpy as np

SIGNATURE = b"\x89HDF\r\n\x1a\n"
UNDEF = 0xFFFFFFFFFFFFFFFF
#: the B-tree K values the writer declares (libhdf5's defaults): a
#: symbol-table node holds 2 * LEAF_K entries, a B-tree node 2 * NODE_K
#: children
LEAF_K, NODE_K = 4, 16
#: the largest message a version-1 object header holds (a 2-byte size)
MAX_MESSAGE = 0xFFFF

# message types
_NIL, _DATASPACE, _LINK_INFO, _DATATYPE, _FILL = 0, 1, 2, 3, 5
_LINK, _LAYOUT, _FILTERS, _ATTRIBUTE = 6, 8, 11, 12
_CONTINUATION, _SYMBOL_TABLE, _ATTRIBUTE_INFO = 16, 17, 21

# datatype classes
_FIXED, _FLOAT, _STRING, _VLEN = 0, 1, 3, 9
_CLASS_NAMES = {2: "time", 4: "bitfield", 5: "opaque", 6: "compound",
                7: "reference", 8: "enumeration", 10: "array"}

#: numpy dtypes the writer stores as themselves (the JAX ``H5File``'s set
#: and float16); any other array is written as float32, as there
WRITE_DTYPES = frozenset(np.dtype(t) for t in (
    np.float16, np.float32, np.float64, np.int8, np.uint8, np.int16,
    np.uint16, np.int32, np.uint32, np.int64, np.uint64))

#: IEEE layouts by size: (sign bit, exponent location, exponent size,
#: mantissa size, exponent bias)
_IEEE = {2: (15, 10, 5, 10, 15), 4: (31, 23, 8, 23, 127),
         8: (63, 52, 11, 52, 1023)}


class UnsupportedHDF5Feature(ValueError):
    """The file uses a part of HDF5 outside the subset this module reads."""


def hdf5_available() -> bool:
    """Always True: the port reads and writes HDF5 without a library."""
    return True


def _pad8(n: int) -> int:
    return (n + 7) & ~7


# --------------------------------------------------------------- datatypes
class _Type:
    """A decoded datatype message: ``kind`` is ``"num"`` (with ``dtype``),
    ``"str"`` (fixed length ``size``) or ``"vstr"`` (variable length)."""

    __slots__ = ("kind", "dtype", "size")

    def __init__(self, kind: str, dtype=None, size: int = 0):
        self.kind, self.dtype, self.size = kind, dtype, size


def _decode_type(b: bytes) -> _Type:
    cls, version = b[0] & 0x0F, b[0] >> 4
    bits = b[1] | (b[2] << 8) | (b[3] << 16)
    size = struct.unpack_from("<I", b, 4)[0]
    if cls == _FIXED:
        if size not in (1, 2, 4, 8):
            raise UnsupportedHDF5Feature(f"a {size}-byte integer datatype")
        order = ">" if bits & 1 else "<"
        kind = "i" if bits & 0x08 else "u"
        return _Type("num", np.dtype(f"{order}{kind}{size}"), size)
    if cls == _FLOAT:
        if size not in _IEEE:
            raise UnsupportedHDF5Feature(f"a {size}-byte float datatype")
        _off, prec, eloc, esize, _mloc, msize, bias = struct.unpack_from(
            "<HHBBBBI", b, 8)
        sign = (bits >> 8) & 0xFF
        if (sign, eloc, esize, msize, bias) != _IEEE[size] or prec != 8 * size:
            raise UnsupportedHDF5Feature(
                f"a non-IEEE {size}-byte float datatype")
        if bits & 0x40:
            raise UnsupportedHDF5Feature("a VAX-order float datatype")
        order = ">" if bits & 1 else "<"
        return _Type("num", np.dtype(f"{order}f{size}"), size)
    if cls == _STRING:
        return _Type("str", None, size)
    if cls == _VLEN:
        if bits & 0x0F != 1:
            raise UnsupportedHDF5Feature(
                "a variable-length sequence datatype (not a string)")
        return _Type("vstr", None, size)
    name = _CLASS_NAMES.get(cls, f"class {cls}")
    raise UnsupportedHDF5Feature(f"the {name} datatype (version {version})")


def _encode_num_type(dt: np.dtype) -> bytes:
    size = dt.itemsize
    if dt.kind == "f":
        sign, eloc, esize, msize, bias = _IEEE[size]
        head = struct.pack("<BBBBI", 0x10 | _FLOAT, 0x20, sign, 0, size)
        return head + struct.pack("<HHBBBBI", 0, 8 * size, eloc, esize, 0,
                                  msize, bias)
    signed = 0x08 if dt.kind == "i" else 0
    head = struct.pack("<BBBBI", 0x10 | _FIXED, signed, 0, 0, size)
    return head + struct.pack("<HH", 0, 8 * size)


def _encode_str_type(size: int) -> bytes:
    # null-terminated padding (0), ASCII character set: H5T_C_S1 sized
    return struct.pack("<BBBBI", 0x10 | _STRING, 0, 0, 0, size)


# -------------------------------------------------------------- dataspaces
def _decode_space(b: bytes) -> Tuple[int, ...]:
    """The shape of a dataspace message (``()`` scalar); a null dataspace
    reads as ``(0,)``."""
    version, rank = b[0], b[1]
    if version == 1:
        off = 8
    elif version == 2:
        if b[3] == 2:  # null
            return (0,)
        off = 4
    else:
        raise UnsupportedHDF5Feature(f"dataspace message version {version}")
    return tuple(struct.unpack_from(f"<{rank}Q", b, off)) if rank else ()


def _encode_space(shape: Tuple[int, ...]) -> bytes:
    # version 1, no maximum dims: a scalar is rank 0
    return struct.pack(f"<BBBBI{len(shape)}Q", 1, len(shape), 0, 0, 0, *shape)


# ---------------------------------------------------------------- the tree
class _Node:
    """A group or a dataset: its attributes by name (decoded values) and,
    for a dataset, its type, shape and where its data is; for a group, its
    children by name. ``error`` names a feature outside the subset that
    reading this node would need."""

    def __init__(self, is_group: bool):
        self.is_group = is_group
        self.children: Dict[str, "_Node"] = {}
        self.attrs: Dict[str, object] = {}
        self.attr_bytes: Dict[str, bytes] = {}  # encoded, for the writer
        self.type: Optional[_Type] = None
        self.shape: Tuple[int, ...] = ()
        self.addr = UNDEF
        self.size = 0
        self.compact: Optional[bytes] = None
        self.fill: Optional[bytes] = None
        self.error: Optional[str] = None


class _Reader:
    """Parses the metadata of a file into a tree of :class:`_Node`."""

    def __init__(self, f):
        self.f = f
        self.base = self._find_superblock()
        sb = self._read(self.base, 96)
        version = sb[8]
        if version not in (0, 1):
            raise UnsupportedHDF5Feature(f"superblock version {version}")
        if sb[13] != 8 or sb[14] != 8:
            raise UnsupportedHDF5Feature(
                f"{sb[13]}-byte offsets and {sb[14]}-byte lengths")
        off = 24 + (4 if version == 1 else 0)
        # base, free space, end of file, driver info; then the root entry
        root_header = struct.unpack_from("<Q", self._read(
            self.base + off + 32 + 8, 8))[0]
        self._gheaps: Dict[int, Dict[int, bytes]] = {}
        self.root = self.node(root_header, True)

    def _find_superblock(self) -> int:
        self.f.seek(0, 2)
        end = self.f.tell()
        at = 0
        while at + 8 <= end:
            if self._read(at, 8) == SIGNATURE:
                return at
            at = 512 if at == 0 else 2 * at
        raise OSError("not an HDF5 file (no superblock signature)")

    def _read(self, addr: int, n: int) -> bytes:
        self.f.seek(addr)
        b = self.f.read(n)
        if len(b) != n:
            raise OSError(f"truncated HDF5 file: {n} bytes at {addr}")
        return b

    def _at(self, addr: int) -> int:
        return self.base + addr

    # ---- object headers
    def messages(self, addr: int) -> List[Tuple[int, int, bytes]]:
        """``(type, flags, data)`` of every message of the object header at
        ``addr``, continuation blocks followed."""
        head = self._read(self._at(addr), 16)
        if head[:4] == b"OHDR":
            raise UnsupportedHDF5Feature("version-2 object headers (OHDR)")
        if head[0] != 1:
            raise UnsupportedHDF5Feature(f"object header version {head[0]}")
        size = struct.unpack_from("<I", head, 8)[0]
        chunks = [(addr + 16, size)]
        out = []
        while chunks:
            caddr, clen = chunks.pop(0)
            data = self._read(self._at(caddr), clen)
            p = 0
            while p + 8 <= clen:
                mtype, msize, flags = struct.unpack_from("<HHB", data, p)
                body = data[p + 8:p + 8 + msize]
                p += 8 + msize
                if mtype == _CONTINUATION:
                    chunks.append(struct.unpack_from("<QQ", body))
                elif mtype != _NIL:
                    if flags & 0x02:
                        raise UnsupportedHDF5Feature(
                            f"a shared message (type {mtype})")
                    out.append((mtype, flags, body))
        return out

    def node(self, addr: int, is_group: Optional[bool] = None) -> _Node:
        msgs = self.messages(addr)
        types = {m[0] for m in msgs}
        group = _SYMBOL_TABLE in types or _LINK_INFO in types or \
            _LINK in types or (is_group is True and _LAYOUT not in types)
        node = _Node(group)
        for mtype, _flags, body in msgs:
            if mtype == _ATTRIBUTE:
                name, value = self._attribute(body)
                node.attrs[name] = value
            elif mtype == _ATTRIBUTE_INFO:
                heap = struct.unpack_from("<Q", body, 2 + (2 if body[1] & 1
                                                             else 0))[0]
                if heap != UNDEF:
                    node.error = node.error or "dense attribute storage"
        if group:
            if _LINK_INFO in types or _LINK in types:
                node.error = "link-message groups (the new-style group format)"
                return node
            for mtype, _flags, body in msgs:
                if mtype == _SYMBOL_TABLE:
                    btree, heap = struct.unpack_from("<QQ", body)
                    for name, child in self._group_entries(btree, heap):
                        node.children[name] = self.node(child)
            return node
        for mtype, _flags, body in msgs:
            if mtype == _DATATYPE:
                node.type = _decode_type(body)
            elif mtype == _DATASPACE:
                node.shape = _decode_space(body)
            elif mtype == _FILL and body[0] in (2, 3):
                node.fill = self._fill(body)
            elif mtype == _FILTERS:
                node.error = "a filter pipeline (compression or a checksum)"
            elif mtype == _LAYOUT:
                self._layout(node, body)
        return node

    def _fill(self, body: bytes) -> Optional[bytes]:
        if body[0] == 2:
            if not body[3]:
                return None
            n = struct.unpack_from("<I", body, 4)[0]
            return body[8:8 + n] if n else None
        flags = body[1]
        if not flags & 0x20:
            return None
        n = struct.unpack_from("<I", body, 2)[0]
        return body[6:6 + n] if n else None

    def _layout(self, node: _Node, body: bytes) -> None:
        version, cls = body[0], body[1]
        if version not in (3, 4):
            node.error = f"data layout message version {version}"
        elif cls == 1:
            node.addr, node.size = struct.unpack_from("<QQ", body, 2)
        elif cls == 0:
            n = struct.unpack_from("<H", body, 2)[0]
            node.compact = body[4:4 + n]
        elif cls == 2:
            node.error = node.error or "chunked layout"
        else:
            node.error = f"data layout class {cls}"

    # ---- groups
    def _heap(self, addr: int) -> bytes:
        head = self._read(self._at(addr), 32)
        if head[:4] != b"HEAP":
            raise OSError(f"no local heap at {addr}")
        size, _free, data = struct.unpack_from("<QQQ", head, 8)
        return self._read(self._at(data), size)

    def _group_entries(self, btree: int, heap_addr: int):
        heap = self._heap(heap_addr)

        def name(off):
            return heap[off:heap.index(b"\x00", off)].decode("utf-8")

        out = []
        stack = [btree]
        while stack:
            addr = stack.pop(0)
            head = self._read(self._at(addr), 24)
            if head[:4] != b"TREE" or head[4] != 0:
                raise OSError(f"no group B-tree node at {addr}")
            level, used = head[5], struct.unpack_from("<H", head, 6)[0]
            body = self._read(self._at(addr) + 24, 16 * used + 8)
            kids = [struct.unpack_from("<Q", body, 16 * i + 8)[0]
                    for i in range(used)]
            if level:
                stack[:0] = kids
                continue
            for snod in kids:
                shead = self._read(self._at(snod), 8)
                if shead[:4] != b"SNOD":
                    raise OSError(f"no symbol-table node at {snod}")
                n = struct.unpack_from("<H", shead, 6)[0]
                ents = self._read(self._at(snod) + 8, 40 * n)
                for i in range(n):
                    off, header = struct.unpack_from("<QQ", ents, 40 * i)
                    out.append((name(off), header))
        return out

    # ---- attributes
    def _attribute(self, body: bytes):
        version = body[0]
        if version not in (1, 2, 3):
            raise UnsupportedHDF5Feature(f"attribute message version "
                                         f"{version}")
        if version > 1 and body[1] & 0x03:
            raise UnsupportedHDF5Feature("a shared attribute datatype or "
                                         "dataspace")
        nsize, tsize, ssize = struct.unpack_from("<HHH", body, 2)
        p = 8 + (1 if version == 3 else 0)
        pad = _pad8 if version == 1 else (lambda n: n)
        name = body[p:p + nsize].split(b"\x00")[0].decode("utf-8")
        p += pad(nsize)
        typ = _decode_type(body[p:p + tsize])
        p += pad(tsize)
        shape = _decode_space(body[p:p + ssize])
        p += pad(ssize)
        return name, self._values(typ, shape, body[p:])

    def _values(self, typ: _Type, shape, raw: bytes):
        n = int(np.prod(shape)) if shape else 1
        if typ.kind == "num":
            out = np.frombuffer(raw, typ.dtype, n).astype(
                typ.dtype.newbyteorder("="))
            return out[0] if n == 1 else out
        if typ.kind == "str":
            vals = [raw[i * typ.size:(i + 1) * typ.size].split(b"\x00")[0]
                    .decode("utf-8", "replace") for i in range(n)]
        else:
            vals = []
            for i in range(n):
                length, coll, idx = struct.unpack_from("<IQI", raw, 16 * i)
                obj = self._global(coll, idx) if coll not in (0, UNDEF) \
                    else b""
                vals.append(obj[:length].decode("utf-8", "replace"))
        return vals[0] if n == 1 else vals

    def _global(self, addr: int, index: int) -> bytes:
        objs = self._gheaps.get(addr)
        if objs is None:
            head = self._read(self._at(addr), 16)
            if head[:4] != b"GCOL":
                raise OSError(f"no global heap collection at {addr}")
            size = struct.unpack_from("<Q", head, 8)[0]
            data = self._read(self._at(addr), size)
            objs, p = {}, 16
            while p + 16 <= size:
                idx, _refs, _r, osize = struct.unpack_from("<HHIQ", data, p)
                if idx == 0:  # the free space: the rest of the collection
                    break
                objs[idx] = data[p + 16:p + 16 + osize]
                p += 16 + _pad8(osize)
            self._gheaps[addr] = objs
        return objs[index]


class H5File:
    """A Keras archive's HDF5 file, read (``mode="r"``) or written
    (``mode="w"``). Paths are ``/``-separated."""

    def __init__(self, path: str, mode: str = "r"):
        if mode not in ("r", "w"):
            raise ValueError("mode must be 'r' or 'w'")
        self.path, self.mode = str(path), mode
        self._lock = threading.RLock()
        try:
            self._f = open(self.path, "rb" if mode == "r" else "w+b")
        except OSError as e:
            raise OSError(f"cannot open HDF5 file {path!r} (mode={mode}): "
                          f"{e}") from e
        try:
            if mode == "r":
                reader = _Reader(self._f)
                self._root, self._base = reader.root, reader.base
            else:
                self._root, self._base = _Node(True), 0
                self._f.write(b"\x00" * 96)  # the superblock, at close
                self._eof = 96
        except BaseException:
            self._f.close()
            raise

    # ------------------------------------------------------------ lifecycle
    def close(self) -> None:
        with self._lock:
            if self._f is None:
                return
            try:
                if self.mode == "w":
                    _Writer(self._f, self._eof).finish(self._root)
            finally:
                self._f.close()
                self._f = None

    def __enter__(self) -> "H5File":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def __del__(self):
        if getattr(self, "_f", None) is not None:
            self.close()

    # --------------------------------------------------------------- lookup
    def _find(self, path: str) -> Optional[_Node]:
        node = self._root
        for part in (p for p in path.strip("/").split("/") if p):
            if not node.is_group:
                return None
            if node.error:
                raise UnsupportedHDF5Feature(node.error)
            node = node.children.get(part)
            if node is None:
                return None
        return node

    def _node(self, path: str, what: str = "object") -> _Node:
        node = self._find(path)
        if node is None:
            raise KeyError(f"no such {what}: {path}")
        return node

    # -------------------------------------------------------------- reading
    def exists(self, path: str) -> bool:
        with self._lock:
            return self._find(path) is not None

    def list_group(self, path: str = "/") -> List[str]:
        """The names in the group, in byte order (libhdf5's name index)."""
        with self._lock:
            node = self._find(path)
            if node is None or not node.is_group:
                raise KeyError(f"no such group: {path}")
            if node.error:
                raise UnsupportedHDF5Feature(node.error)
            return sorted(node.children, key=lambda n: n.encode("utf-8"))

    def read_dataset(self, path: str) -> np.ndarray:
        with self._lock:
            node = self._find(path)
            if node is None or node.is_group:
                raise KeyError(f"no such dataset: {path}")
            if node.error:
                raise UnsupportedHDF5Feature(f"{path}: {node.error}")
            if node.type.kind != "num":
                raise UnsupportedHDF5Feature(
                    f"{path}: a string dataset (numeric datasets only)")
            dt = node.type.dtype
            n = int(np.prod(node.shape)) if node.shape else 1
            if node.compact is not None:
                out = np.frombuffer(node.compact, dt, n).copy()
            elif node.addr == UNDEF or n == 0:
                fill = node.fill or b"\x00" * dt.itemsize
                out = np.full(n, np.frombuffer(fill, dt, 1)[0], dt)
            else:
                if node.size < n * dt.itemsize:
                    raise OSError(f"{path}: {node.size} bytes stored for "
                                  f"{n} x {dt}")
                out = np.empty(n, dt)
                self._f.seek(node.addr + self._base)
                if self._f.readinto(memoryview(out).cast("B")) != out.nbytes:
                    raise OSError(f"truncated HDF5 file reading {path}")
            out = out.reshape(node.shape)
            native = dt.newbyteorder("=")
            return out if dt == native else out.astype(native)

    def read_attr(self, obj_path: str, name: str):
        with self._lock:
            node = self._node(obj_path)
            if node.error == "dense attribute storage":
                raise UnsupportedHDF5Feature(f"{obj_path}: {node.error}")
            if name not in node.attrs:
                raise KeyError(f"no attribute {name!r} on {obj_path}")
            value = node.attrs[name]
            return value.copy() if isinstance(value, np.ndarray) else value

    def has_attr(self, obj_path: str, name: str) -> bool:
        with self._lock:
            node = self._find(obj_path)
            return node is not None and name in node.attrs

    # -------------------------------------------------------------- writing
    def _writable(self) -> None:
        if self.mode != "w" or self._f is None:
            raise OSError(f"{self.path} is not open for writing")

    def create_group(self, path: str) -> None:
        with self._lock:
            self._writable()
            node = self._root
            for part in (p for p in path.strip("/").split("/") if p):
                child = node.children.get(part)
                if child is None:
                    child = node.children[part] = _Node(True)
                elif not child.is_group:
                    raise OSError(f"cannot create group {path}: {part} is a "
                                  "dataset")
                node = child

    def write_dataset(self, path: str, arr: np.ndarray) -> None:
        """Writes ``arr``'s bytes to the file now; a dtype outside
        :data:`WRITE_DTYPES` is written as float32."""
        with self._lock:
            self._writable()
            arr = np.ascontiguousarray(arr)
            if arr.dtype not in WRITE_DTYPES:
                arr = arr.astype(np.float32)
            arr = arr.astype(arr.dtype.newbyteorder("<"), copy=False)
            parent, _, name = path.strip("/").rpartition("/")
            if not name:
                raise OSError(f"cannot create dataset {path}")
            self.create_group(parent)
            group = self._find(parent)
            if name in group.children:
                raise OSError(f"cannot create dataset {path}: it exists")
            node = _Node(False)
            node.type = _Type("num", arr.dtype, arr.dtype.itemsize)
            node.shape = tuple(int(d) for d in arr.shape)
            node.size = arr.nbytes
            if arr.nbytes:
                node.addr = self._eof
                self._f.seek(self._eof)
                self._f.write(memoryview(arr).cast("B"))
                self._eof = _pad8(self._eof + arr.nbytes)
            group.children[name] = node

    def write_attr(self, obj_path: str,
                   name: str, value: Union[str, List[str], np.ndarray, int,
                                           float]) -> None:
        """Writes (or overwrites) an attribute: a string as a scalar, a
        list of strings as a 1-D array of fixed-length strings, anything
        else as a 1-D numeric array (float64 outside :data:`WRITE_DTYPES`)."""
        with self._lock:
            self._writable()
            node = self._node(obj_path)
            if isinstance(value, str) or (
                    isinstance(value, list)
                    and all(isinstance(v, str) for v in value)):
                strs = [value] if isinstance(value, str) else list(value)
                enc = [v.encode("utf-8") for v in strs]
                size = max(max((len(e) for e in enc), default=0) + 1, 1)
                typ = _encode_str_type(size)
                shape = () if isinstance(value, str) else (len(enc),)
                data = b"".join(e.ljust(size, b"\x00") for e in enc)
                stored = value if isinstance(value, str) else strs
                if len(strs) == 1 and not isinstance(value, str):
                    stored = strs[0]
            else:
                arr = np.atleast_1d(np.asarray(value))
                if arr.dtype not in WRITE_DTYPES:
                    arr = arr.astype(np.float64)
                arr = np.ascontiguousarray(arr.reshape(-1)).astype(
                    arr.dtype.newbyteorder("<"), copy=False)
                typ = _encode_num_type(arr.dtype)
                shape = (arr.size,)
                data = arr.tobytes()
                native = arr.astype(arr.dtype.newbyteorder("="))
                stored = native[0] if arr.size == 1 else native
            nb = name.encode("utf-8") + b"\x00"
            space = _encode_space(shape)
            msg = (struct.pack("<BBHHH", 1, 0, len(nb), len(typ), len(space))
                   + nb.ljust(_pad8(len(nb)), b"\x00")
                   + typ.ljust(_pad8(len(typ)), b"\x00")
                   + space.ljust(_pad8(len(space)), b"\x00") + data)
            if _pad8(len(msg)) > MAX_MESSAGE:
                raise ValueError(
                    f"attribute {name!r} on {obj_path} takes {len(msg)} "
                    f"bytes; a version-1 object header message holds at most "
                    f"{MAX_MESSAGE} (libhdf5 refuses it in this format too)")
            node.attrs.pop(name, None)
            node.attrs[name] = stored
            node.attr_bytes[name] = msg


class _Writer:
    """Lays out the tree's metadata after the data, then the superblock."""

    def __init__(self, f, eof: int):
        self.f, self.eof = f, eof

    def _put(self, data: bytes) -> int:
        addr = self.eof
        self.f.seek(addr)
        self.f.write(data)
        self.eof = _pad8(addr + len(data))
        return addr

    def _header(self, msgs: List[Tuple[int, bytes]]) -> int:
        """A version-1 object header holding ``msgs`` in one chunk."""
        body = b"".join(struct.pack("<HHB3x", t, _pad8(len(d)), 0)
                        + d.ljust(_pad8(len(d)), b"\x00") for t, d in msgs)
        head = struct.pack("<BBHII4x", 1, 0, len(msgs), 1, len(body))
        return self._put(head + body)

    def _attr_msgs(self, node: _Node) -> List[Tuple[int, bytes]]:
        return [(_ATTRIBUTE, node.attr_bytes[n]) for n in node.attrs]

    def _dataset(self, node: _Node) -> int:
        layout = struct.pack("<BBQQ", 3, 1, node.addr, node.size)
        # fill value version 2: allocation late, written if set, undefined
        fill = struct.pack("<BBBB", 2, 2, 2, 0)
        return self._header([(_DATASPACE, _encode_space(node.shape)),
                             (_DATATYPE, _encode_num_type(node.type.dtype)),
                             (_FILL, fill), (_LAYOUT, layout)]
                            + self._attr_msgs(node))

    def _group(self, node: _Node) -> Tuple[int, int, int]:
        """``(object header, B-tree, local heap)`` addresses of a group,
        its children laid out first."""
        kids = sorted(node.children.items(), key=lambda kv: kv[0].encode())
        addrs = [(name, self._node(child)) for name, child in kids]
        # the local heap: "" at offset 0, then each name null-terminated
        # and padded to 8 bytes
        heap, offsets = bytearray(8), {}
        for name, _ in addrs:
            offsets[name] = len(heap)
            nb = name.encode("utf-8") + b"\x00"
            heap += nb.ljust(_pad8(len(nb)), b"\x00")
        data = self._put(bytes(heap))
        # no free block: libhdf5 marks the empty free list with offset 1
        heap_addr = self._put(b"HEAP" + struct.pack("<B3xQQQ", 0, len(heap),
                                                    1, data))
        # symbol-table nodes of up to 2 * LEAF_K entries, allocated whole
        leaves = []
        for i in range(0, len(addrs), 2 * LEAF_K):
            part = addrs[i:i + 2 * LEAF_K]
            ents = b"".join(struct.pack("<QQI4x16x", offsets[n], a, 0)
                            for n, a in part)
            snod = (b"SNOD" + struct.pack("<BBH", 1, 0, len(part)) + ents)
            leaves.append((self._put(snod.ljust(8 + 2 * LEAF_K * 40,
                                                b"\x00")),
                           offsets[part[-1][0]]))
        # B-tree levels of up to 2 * NODE_K children; key 0 is the empty
        # name, key i + 1 the last name under child i
        level, nodes = 0, leaves
        while True:
            parents = []
            for i in range(0, max(len(nodes), 1), 2 * NODE_K):
                part = nodes[i:i + 2 * NODE_K]
                body = struct.pack("<Q", 0) + b"".join(
                    struct.pack("<QQ", child, key) for child, key in part)
                tree = (b"TREE" + struct.pack("<BBHQQ", 0, level, len(part),
                                              UNDEF, UNDEF) + body)
                size = 24 + (2 * NODE_K + 1) * 8 + 2 * NODE_K * 8
                parents.append((self._put(tree.ljust(size, b"\x00")),
                                part[-1][1] if part else 0))
            if len(parents) == 1:
                btree = parents[0][0]
                break
            level, nodes = level + 1, parents
        header = self._header([(_SYMBOL_TABLE, struct.pack("<QQ", btree,
                                                           heap_addr))]
                              + self._attr_msgs(node))
        return header, btree, heap_addr

    def _node(self, node: _Node) -> int:
        return self._group(node)[0] if node.is_group else self._dataset(node)

    def finish(self, root: _Node) -> None:
        header, btree, heap = self._group(root)
        self.f.seek(0, 2)
        end = max(self.eof, self.f.tell())
        self.f.truncate(end)
        sb = (SIGNATURE + bytes([0, 0, 0, 0, 0, 8, 8, 0])
              + struct.pack("<HHI", LEAF_K, NODE_K, 0)
              + struct.pack("<QQQQ", 0, UNDEF, end, UNDEF)
              + struct.pack("<QQI4xQQ", 0, header, 1, btree, heap))
        self.f.seek(0)
        self.f.write(sb)
        self.f.flush()
