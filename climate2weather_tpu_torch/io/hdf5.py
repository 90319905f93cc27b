"""HDF5 reader and writer in the standard library and numpy (no h5py).

The port reads and writes the JAX package's HDF5 files without h5py, which
a GPU host may lack: the training file of ``merged_to_normed_h5``,
the grid files of ``GridDataset.to_file`` (``.nc`` names, HDF5 inside) and
the quantile files of ``QuantileDataset.to_file``. This module covers the
structures that h5py (HDF5 1.14, default ``libver``) writes for them:

- superblock version 0; version-1 object headers with continuation blocks;
- groups held as a symbol table (a version-1 B-tree of symbol-table nodes
  and a local heap);
- contiguous and chunked layouts (layout message version 3), the chunks
  indexed by a version-1 B-tree;
- integer and floating-point data of either byte order, fixed-length and
  variable-length strings (the latter in the global heap);
- the deflate and shuffle filters.

Attributes of other types (the object references of dimension scales, for
example) are skipped. Anything else raises ``NotImplementedError`` naming
what it found (a superblock of version 2 or 3, a version-2 object header,
a version-2 B-tree, a fractal heap, ...), so a file is read right or not at
all.

:class:`File` opens a file for reading. A chunked dataset's index is read
when the dataset is opened; a slice then reads only the chunks it overlaps.
:class:`Writer` writes the same structures without filters: raw data as it
is given, the metadata when it is closed.
"""

from __future__ import annotations

import os
import struct
import zlib
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

SIGNATURE = b"\x89HDF\r\n\x1a\n"
UNDEF = 0xFFFFFFFFFFFFFFFF

# object header message types
MSG_NIL, MSG_DATASPACE, MSG_LINK_INFO, MSG_DATATYPE = 0x0, 0x1, 0x2, 0x3
MSG_FILL_OLD, MSG_FILL, MSG_LINK, MSG_EXTERNAL, MSG_LAYOUT = 0x4, 0x5, 0x6, 0x7, 0x8
MSG_GROUP_INFO, MSG_FILTERS, MSG_ATTRIBUTE = 0xA, 0xB, 0xC
MSG_CONTINUATION, MSG_SYMBOL_TABLE, MSG_ATTRIBUTE_INFO = 0x10, 0x11, 0x15

FILTER_DEFLATE, FILTER_SHUFFLE = 1, 2


class _Unsupported(Exception):
    """A datatype this reader does not decode (attributes of such types are
    skipped; datasets of such types raise ``NotImplementedError``)."""


# ---------------------------------------------------------------------------
# low-level reading


class _Source:
    """Positional reads from one file descriptor (safe across threads)."""

    def __init__(self, path: str):
        self.path = os.fspath(path)
        self.fd = os.open(self.path, os.O_RDONLY)

    def read(self, addr: int, n: int) -> bytes:
        out = os.pread(self.fd, n, addr)
        if len(out) != n:
            raise OSError(f"{self.path}: short read of {n} bytes at {addr} (truncated file?)")
        return out

    def close(self) -> None:
        if self.fd >= 0:
            os.close(self.fd)
            self.fd = -1

    def __del__(self):
        self.close()


def _uint(buf: bytes, pos: int, size: int) -> int:
    return int.from_bytes(buf[pos:pos + size], "little")


# ---------------------------------------------------------------------------
# datatypes


class _Datatype:
    """A decoded datatype message: ``kind`` in {"int", "float", "str",
    "vlen_str"}; ``dtype`` the numpy dtype of one element where there is one."""

    def __init__(self, kind: str, size: int, dtype=None, padding: int = 0):
        self.kind, self.size, self.dtype, self.padding = kind, size, dtype, padding


def _parse_datatype(buf: bytes, pos: int) -> Tuple[_Datatype, int]:
    """(datatype, bytes used) of the datatype message at ``buf[pos:]``."""
    cls = buf[pos] & 0x0F
    bits = buf[pos + 1] | (buf[pos + 2] << 8) | (buf[pos + 3] << 16)
    size = _uint(buf, pos + 4, 4)
    order = ">" if bits & 1 else "<"
    if cls == 0:  # fixed-point
        if size not in (1, 2, 4, 8):
            raise _Unsupported(f"integer of {size} bytes")
        signed = bool(bits & 0x8)
        return _Datatype("int", size, np.dtype(f"{order}{'i' if signed else 'u'}{size}")), 12
    if cls == 1:  # floating-point
        if size not in (2, 4, 8):
            raise _Unsupported(f"float of {size} bytes")
        if bits & 0x1 and bits & 0x40:
            raise _Unsupported("VAX byte order")
        return _Datatype("float", size, np.dtype(f"{order}f{size}")), 20
    if cls == 3:  # fixed-length string
        return _Datatype("str", size, np.dtype(f"S{size}"), padding=bits & 0x0F), 8
    if cls == 9:  # variable-length
        if bits & 0x0F != 1:
            raise _Unsupported("variable-length sequence")
        _, used = _parse_datatype(buf, pos + 8)
        return _Datatype("vlen_str", size), 8 + used
    names = {2: "time", 4: "bitfield", 5: "opaque", 6: "compound", 7: "reference",
             8: "enumerated", 10: "array"}
    raise _Unsupported(f"datatype class {cls} ({names.get(cls, 'unknown')})")


def _parse_dataspace(buf: bytes, pos: int) -> Optional[Tuple[int, ...]]:
    """The shape of the dataspace message at ``buf[pos:]``; None for a null
    dataspace, () for a scalar."""
    version, rank, flags = buf[pos], buf[pos + 1], buf[pos + 2]
    if version == 1:
        start = pos + 8
    elif version == 2:
        if buf[pos + 3] == 2:
            return None
        start = pos + 4
    else:
        raise NotImplementedError(f"dataspace message version {version}")
    return tuple(_uint(buf, start + 8 * i, 8) for i in range(rank))


# ---------------------------------------------------------------------------
# objects


class _Object:
    """What an object header holds: its messages, decoded attributes and,
    for a group, its members."""

    def __init__(self, f: "File", addr: int):
        self.file, self.addr = f, addr
        self.messages: List[Tuple[int, bytes]] = []
        self._read_header(addr)
        self.attrs: Dict[str, object] = {}
        for mtype, data in self.messages:
            if mtype == MSG_ATTRIBUTE:
                name, value = f._parse_attribute(data)
                if name is not None:
                    self.attrs[name] = value
            elif mtype == MSG_ATTRIBUTE_INFO:
                raise NotImplementedError("dense attribute storage (attribute info message)")

    def _read_header(self, addr: int) -> None:
        src = self.file._src
        head = src.read(addr, 16)
        if head[:4] == b"OHDR":
            raise NotImplementedError("version-2 object header (OHDR)")
        if head[0] != 1:
            raise NotImplementedError(f"object header version {head[0]}")
        n_msgs = _uint(head, 2, 2)
        blocks = [(addr + 16, _uint(head, 8, 4))]
        while blocks and len(self.messages) < n_msgs:
            start, length = blocks.pop(0)
            data = src.read(start, length)
            pos = 0
            while pos + 8 <= length and len(self.messages) < n_msgs:
                mtype, size, flags = _uint(data, pos, 2), _uint(data, pos + 2, 2), data[pos + 4]
                body = data[pos + 8:pos + 8 + size]
                pos += 8 + size
                if mtype == MSG_CONTINUATION:
                    blocks.append((_uint(body, 0, 8), _uint(body, 8, 8)))
                    self.messages.append((mtype, body))
                    continue
                if flags & 0x02 and mtype in (MSG_DATATYPE, MSG_FILL, MSG_FILTERS, MSG_ATTRIBUTE):
                    raise NotImplementedError(f"shared object header message (type {mtype})")
                self.messages.append((mtype, body))

    def find(self, mtype: int) -> Optional[bytes]:
        for t, data in self.messages:
            if t == mtype:
                return data
        return None


class Group:
    """A group: ``keys()``, ``[name]`` (a :class:`Group` or :class:`Dataset`,
    nested paths with ``/``), ``in`` and ``attrs``."""

    def __init__(self, f: "File", obj: _Object, name: str):
        self.file, self.name, self._obj = f, name, obj
        self.attrs = obj.attrs
        st = obj.find(MSG_SYMBOL_TABLE)
        if st is None:
            if obj.find(MSG_LINK_INFO) is not None or obj.find(MSG_LINK) is not None:
                raise NotImplementedError("new-style group (link messages)")
            raise ValueError(f"{name}: object is not a group")
        self._members = f._read_symbol_table(_uint(st, 0, 8), _uint(st, 8, 8))

    def keys(self) -> List[str]:
        return list(self._members)

    def __iter__(self):
        return iter(self._members)

    def __contains__(self, name: str) -> bool:
        try:
            self[name]
        except KeyError:
            return False
        return True

    def __getitem__(self, name: str):
        head, _, rest = name.strip("/").partition("/")
        if head not in self._members:
            raise KeyError(f"{head!r} not in {self.name}")
        child = self.file._open(self._members[head], f"{self.name.rstrip('/')}/{head}")
        return child[rest] if rest else child


class Dataset:
    """A dataset: ``shape``, ``dtype``, ``ndim``, ``chunks``, ``attrs`` and
    numpy-style reads by integers and unit-step slices (``ds[()]``,
    ``ds[:]``, ``ds[t0:t1]``, ``ds[i, :, 2:5]``)."""

    def __init__(self, f: "File", obj: _Object, name: str):
        self.file, self.name, self._obj = f, name, obj
        self.attrs = obj.attrs
        space = obj.find(MSG_DATASPACE)
        dt = obj.find(MSG_DATATYPE)
        layout = obj.find(MSG_LAYOUT)
        if space is None or dt is None or layout is None:
            raise ValueError(f"{name}: object is not a dataset")
        shape = _parse_dataspace(space, 0)
        self.shape = () if shape is None else shape
        try:
            self._type, _ = _parse_datatype(dt, 0)
        except _Unsupported as e:
            raise NotImplementedError(f"{name}: {e}") from None
        if self._type.kind == "vlen_str":
            raise NotImplementedError(f"{name}: variable-length string dataset")
        self.dtype = self._type.dtype  # the file's byte order, as h5py keeps it
        if obj.find(MSG_EXTERNAL) is not None:
            raise NotImplementedError(f"{name}: external storage")
        self._filters = _parse_filters(obj.find(MSG_FILTERS))
        self._parse_layout(layout)

    @property
    def ndim(self) -> int:
        return len(self.shape)

    def __len__(self) -> int:
        if not self.shape:
            raise TypeError("len() of a scalar dataset")
        return self.shape[0]

    def _parse_layout(self, buf: bytes) -> None:
        version, cls = buf[0], buf[1]
        if version != 3:
            raise NotImplementedError(f"{self.name}: data layout message version {version}")
        self.chunks = None
        if cls == 1:  # contiguous
            self._addr = _uint(buf, 2, 8)
            self._kind = "contiguous"
        elif cls == 2:  # chunked, v1 B-tree index
            dims = buf[2]
            self._btree = _uint(buf, 3, 8)
            cdims = tuple(_uint(buf, 11 + 4 * i, 4) for i in range(dims))
            self.chunks = cdims[:-1]
            self._kind = "chunked"
            self._last_chunk = None
            self._index = self.file._read_chunk_index(self._btree, len(self.shape)) \
                if self._btree != UNDEF else []
        else:
            raise NotImplementedError(f"{self.name}: layout class {cls} (only contiguous and chunked)")

    # -- reads ---------------------------------------------------------------
    def _decode(self, raw: bytes, count: int) -> np.ndarray:
        return np.frombuffer(raw, dtype=self.dtype, count=count).copy()

    def _selection(self, key) -> Tuple[List[Tuple[int, int]], List[bool]]:
        """Per axis, the [start, stop) range and whether the axis is kept."""
        if not isinstance(key, tuple):
            key = (key,)
        if len(key) > self.ndim:
            raise IndexError(f"{len(key)} indices for {self.ndim} dimensions")
        key = key + (slice(None),) * (self.ndim - len(key))
        ranges, keep = [], []
        for k, n in zip(key, self.shape):
            if isinstance(k, slice):
                start, stop, step = k.indices(n)
                if step != 1:
                    raise NotImplementedError("strided slices")
                ranges.append((start, max(start, stop)))
                keep.append(True)
            elif isinstance(k, (int, np.integer)):
                i = int(k) + n if k < 0 else int(k)
                if not 0 <= i < n:
                    raise IndexError(f"index {k} out of range for axis of {n}")
                ranges.append((i, i + 1))
                keep.append(False)
            else:
                raise NotImplementedError(f"index {k!r}")
        return ranges, keep

    def __getitem__(self, key) -> np.ndarray:
        if isinstance(key, (list, np.ndarray)):  # rows of the first axis, in order
            return np.stack([self[int(i)] for i in key]) if len(key) else \
                np.zeros((0,) + tuple(self.shape[1:]), self.dtype)
        ranges, keep = self._selection(key)
        out = self._read(ranges)
        shape = tuple(b - a for (a, b), k in zip(ranges, keep) if k)
        out = out.reshape(shape)
        return out[()] if out.ndim == 0 else out

    def _read(self, ranges: List[Tuple[int, int]]) -> np.ndarray:
        sel_shape = tuple(b - a for a, b in ranges)
        n_total = int(np.prod(self.shape, dtype=np.int64))
        if self._kind == "contiguous":
            if self._addr == UNDEF:
                raw = None
            else:
                # contiguous rows [r0, r1) of the first axis are one read
                if self.ndim:
                    row = int(np.prod(self.shape[1:], dtype=np.int64)) * self._type.size
                    r0, r1 = ranges[0]
                    raw = self.file._src.read(self._addr + r0 * row, (r1 - r0) * row)
                    full = self._decode(raw, (r1 - r0) * row // self._type.size)
                    full = full.reshape((r1 - r0,) + tuple(self.shape[1:]))
                    idx = (slice(None),) + tuple(slice(a, b) for a, b in ranges[1:])
                    return np.ascontiguousarray(full[idx])
                raw = self.file._src.read(self._addr, n_total * self._type.size)
            if raw is None:
                return np.zeros(sel_shape, self.dtype)
            full = self._decode(raw, n_total).reshape(self.shape)
            return np.ascontiguousarray(full[tuple(slice(a, b) for a, b in ranges)])
        out = np.zeros(sel_shape, self.dtype)
        csize = int(np.prod(self.chunks, dtype=np.int64))
        for offset, mask, nbytes, addr in self._index:
            lo = [max(a, o) for (a, _), o in zip(ranges, offset)]
            hi = [min(b, o + c) for (_, b), o, c in zip(ranges, offset, self.chunks)]
            if any(h <= l for l, h in zip(lo, hi)):
                continue
            chunk = self._chunk(addr, nbytes, mask, csize)
            src = tuple(slice(l - o, h - o) for l, h, o in zip(lo, hi, offset))
            dst = tuple(slice(l - a, h - a) for l, h, (a, _) in zip(lo, hi, ranges))
            out[dst] = chunk[src]
        return out

    def _chunk(self, addr: int, nbytes: int, mask: int, count: int) -> np.ndarray:
        """The decoded chunk at ``addr``; the last one is kept, so reads of
        neighbouring rows decode each chunk once."""
        last = self._last_chunk
        if last is not None and last[0] == addr:
            return last[1]
        raw = _unfilter(self.file._src.read(addr, nbytes), self._filters, mask, self._type.size)
        chunk = self._decode(raw, count).reshape(self.chunks)
        self._last_chunk = (addr, chunk)
        return chunk


def _parse_filters(buf: Optional[bytes]) -> List[Tuple[int, Tuple[int, ...]]]:
    """[(filter id, client values)] of a filter pipeline message."""
    if buf is None:
        return []
    version, n = buf[0], buf[1]
    pos = 8 if version == 1 else 2
    filters = []
    for _ in range(n):
        fid = _uint(buf, pos, 2)
        if version == 1 or fid >= 256:
            name_len = _uint(buf, pos + 2, 2)
            pos += 4
        else:
            name_len = 0
            pos += 2
        nvals = _uint(buf, pos + 2, 2)
        pos += 4
        if version == 1:
            name_len = (name_len + 7) // 8 * 8
        pos += name_len
        vals = tuple(_uint(buf, pos + 4 * i, 4) for i in range(nvals))
        pos += 4 * nvals
        if version == 1 and nvals % 2:
            pos += 4
        if fid not in (FILTER_DEFLATE, FILTER_SHUFFLE):
            raise NotImplementedError(f"filter {fid} (only deflate and shuffle)")
        filters.append((fid, vals))
    return filters


def _unfilter(raw: bytes, filters, mask: int, itemsize: int) -> bytes:
    """Undo a chunk's filters, last applied first; bit i of ``mask`` set
    means filter i was skipped for this chunk."""
    for i in reversed(range(len(filters))):
        if mask & (1 << i):
            continue
        fid, _ = filters[i]
        if fid == FILTER_DEFLATE:
            raw = zlib.decompress(raw)
        elif fid == FILTER_SHUFFLE:
            if itemsize > 1:
                n = len(raw) // itemsize
                body = np.frombuffer(raw, np.uint8, count=n * itemsize)
                raw = body.reshape(itemsize, n).T.tobytes() + raw[n * itemsize:]
    return raw


class File(Group):
    """An HDF5 file opened for reading; the root :class:`Group`. Use as a
    context manager or call :meth:`close`."""

    def __init__(self, path, mode: str = "r"):
        if mode != "r":
            raise ValueError("File opens for reading only; write with Writer")
        self._src = _Source(path)
        self.filename = self._src.path
        try:
            root = self._read_superblock()
            Group.__init__(self, self, _Object(self, root), "/")
        except BaseException:
            self._src.close()
            raise

    def _read_superblock(self) -> int:
        base = None
        for off in (0, 512, 1024, 2048, 4096):
            try:
                if self._src.read(off, 8) == SIGNATURE:
                    base = off
                    break
            except OSError:
                break
        if base is None:
            raise OSError(f"{self.filename}: not an HDF5 file")
        head = self._src.read(base, 24)
        version = head[8]
        if version in (2, 3):
            raise NotImplementedError(f"superblock version {version} (as netCDF4 or libver='latest' write)")
        if version not in (0, 1):
            raise NotImplementedError(f"superblock version {version}")
        if head[13] != 8 or head[14] != 8:
            raise NotImplementedError(f"offsets of {head[13]} and lengths of {head[14]} bytes")
        pos = base + 24 + (4 if version == 1 else 0)
        addrs = self._src.read(pos, 32)
        if _uint(addrs, 0, 8) != 0:
            raise NotImplementedError("superblock base address other than 0")
        entry = self._src.read(pos + 32, 40)
        return _uint(entry, 8, 8)

    def _open(self, addr: int, name: str):
        obj = _Object(self, addr)
        if obj.find(MSG_SYMBOL_TABLE) is not None or obj.find(MSG_LINK_INFO) is not None:
            return Group(self, obj, name)
        return Dataset(self, obj, name)

    # -- groups ----------------------------------------------------------------
    def _local_heap_data(self, addr: int) -> bytes:
        head = self._src.read(addr, 32)
        if head[:4] != b"HEAP":
            raise OSError(f"no local heap at {addr}")
        return self._src.read(_uint(head, 24, 8), _uint(head, 8, 8))

    def _read_symbol_table(self, btree: int, heap: int) -> Dict[str, int]:
        names = self._local_heap_data(heap)
        members: Dict[str, int] = {}
        for snod in self._btree_children(btree, node_type=0, rank=0):
            head = self._src.read(snod, 8)
            if head[:4] != b"SNOD":
                raise OSError(f"no symbol table node at {snod}")
            n = _uint(head, 6, 2)
            entries = self._src.read(snod + 8, 40 * n)
            for i in range(n):
                e = entries[40 * i:40 * (i + 1)]
                off = _uint(e, 0, 8)
                name = names[off:names.index(b"\0", off)].decode("utf-8")
                members[name] = _uint(e, 8, 8)
        return members

    def _btree_node(self, addr: int, node_type: int, rank: int):
        """(level, [(key bytes, child address)]) of a v1 B-tree node."""
        head = self._src.read(addr, 24)
        if head[:4] == b"BTHD":
            raise NotImplementedError("version-2 B-tree")
        if head[:4] != b"TREE":
            raise OSError(f"no v1 B-tree node at {addr}")
        if head[4] != node_type:
            raise OSError(f"B-tree node type {head[4]}, expected {node_type}")
        level, n = head[5], _uint(head, 6, 2)
        key_size = 8 if node_type == 0 else 8 + 8 * (rank + 1)
        body = self._src.read(addr + 24, n * (key_size + 8) + key_size)
        entries = []
        for i in range(n):
            k = i * (key_size + 8)
            entries.append((body[k:k + key_size], _uint(body, k + key_size, 8)))
        return level, entries

    def _btree_children(self, addr: int, node_type: int, rank: int):
        """(key, leaf child address) of every leaf entry, in order."""
        level, entries = self._btree_node(addr, node_type, rank)
        out = []
        for key, child in entries:
            if level == 0:
                out.append(child if node_type == 0 else (key, child))
            else:
                out.extend(self._btree_children(child, node_type, rank))
        return out

    def _read_chunk_index(self, btree: int, rank: int):
        """[(offset tuple, filter mask, stored bytes, address)] of every chunk."""
        index = []
        for key, addr in self._btree_children(btree, node_type=1, rank=rank):
            nbytes, mask = _uint(key, 0, 4), _uint(key, 4, 4)
            offset = tuple(_uint(key, 8 + 8 * i, 8) for i in range(rank))
            index.append((offset, mask, nbytes, addr))
        return index

    # -- attributes --------------------------------------------------------------
    def _global_heap_object(self, collection: int, index: int) -> bytes:
        cache = self.__dict__.setdefault("_gcol", {})
        if collection not in cache:
            head = self._src.read(collection, 16)
            if head[:4] != b"GCOL":
                raise OSError(f"no global heap collection at {collection}")
            data = self._src.read(collection, _uint(head, 8, 8))
            objects, pos = {}, 16
            while pos + 16 <= len(data):
                idx, size = _uint(data, pos, 2), _uint(data, pos + 8, 8)
                if idx == 0:  # free space; its size counts its own header
                    pos += max(size, 16)
                    continue
                objects[idx] = data[pos + 16:pos + 16 + size]
                pos += 16 + (size + 7) // 8 * 8
            cache[collection] = objects
        return cache[collection][index]

    def _parse_attribute(self, buf: bytes):
        """(name, value) of an attribute message; (None, None) for an
        attribute of a type this reader skips."""
        version = buf[0]
        name_size, type_size, space_size = _uint(buf, 2, 2), _uint(buf, 4, 2), _uint(buf, 6, 2)
        if version == 1:
            pad = lambda n: (n + 7) // 8 * 8  # noqa: E731
            pos = 8
        elif version in (2, 3):
            pad = lambda n: n  # noqa: E731
            pos = 8 if version == 2 else 9
        else:
            raise NotImplementedError(f"attribute message version {version}")
        name = buf[pos:pos + name_size].split(b"\0", 1)[0].decode("utf-8")
        pos += pad(name_size)
        tpos = pos
        pos += pad(type_size)
        shape = _parse_dataspace(buf, pos)
        pos += pad(space_size)
        try:
            dtype, _ = _parse_datatype(buf, tpos)
        except _Unsupported:
            return None, None
        if shape is None:
            return name, None
        count = int(np.prod(shape, dtype=np.int64))
        data = buf[pos:pos + count * dtype.size]
        if dtype.kind == "vlen_str":
            vals = []
            for i in range(count):
                e = data[16 * i:16 * (i + 1)]
                n, coll, idx = _uint(e, 0, 4), _uint(e, 4, 8), _uint(e, 12, 4)
                vals.append(self._global_heap_object(coll, idx)[:n].decode("utf-8") if coll else "")
            arr = np.array(vals, dtype=object).reshape(shape)
        elif dtype.kind == "str":
            arr = np.frombuffer(data, dtype.dtype, count=count).reshape(shape)
            if dtype.padding == 2:  # space padded
                arr = np.char.rstrip(arr, b" ")
        else:
            arr = np.frombuffer(data, dtype.dtype, count=count).astype(
                dtype.dtype.newbyteorder("=")).reshape(shape)
        if arr.ndim == 0:
            value = arr[()]
            return name, value if dtype.kind != "vlen_str" else str(value)
        return name, arr

    def close(self) -> None:
        self._src.close()

    def __enter__(self) -> "File":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def open_file(path):
    """An HDF5 file opened for reading by :class:`File`; where it raises
    ``NotImplementedError`` (a netCDF4 file of superblock 2 or 3, say) and
    h5py is installed, by ``h5py.File`` instead. Both give ``keys()``,
    ``[name]``, ``attrs`` and numpy-style reads."""
    try:
        return File(path)
    except NotImplementedError as unsupported:
        try:
            import h5py
        except ImportError:
            raise unsupported from None
        return h5py.File(path, "r")


# ---------------------------------------------------------------------------
# writing


def _pad8(b: bytes) -> bytes:
    return b + b"\0" * (-len(b) % 8)


def _datatype_message(dtype: np.dtype) -> bytes:
    dtype = np.dtype(dtype)
    if dtype.kind == "f":
        le = dtype.newbyteorder("<")
        size = le.itemsize
        exp_loc, exp_size, mant, bias = {4: (23, 8, 23, 127), 8: (52, 11, 52, 1023)}[size]
        bits = bytes([0x20, size * 8 - 1, 0])
        props = struct.pack("<HHBBBBI", 0, size * 8, exp_loc, exp_size, 0, mant, bias)
        return bytes([0x11]) + bits + struct.pack("<I", size) + props
    if dtype.kind in "iu":
        size = dtype.itemsize
        bits = bytes([0x08 if dtype.kind == "i" else 0x00, 0, 0])
        return bytes([0x10]) + bits + struct.pack("<I", size) + struct.pack("<HH", 0, size * 8)
    raise NotImplementedError(f"writing {dtype} data")


# variable-length UTF-8 string: base type one unsigned byte
_VLEN_STR_TYPE = bytes([0x19, 0x01, 0x01, 0x00]) + struct.pack("<I", 16) + \
    bytes([0x10, 0, 0, 0]) + struct.pack("<I", 1) + struct.pack("<HH", 0, 8)


def _dataspace_message(shape: Sequence[int], maxshape: Optional[Sequence[Optional[int]]] = None) -> bytes:
    flags = 1 if maxshape is not None else 0
    out = bytes([1, len(shape), flags, 0]) + b"\0" * 4
    out += b"".join(struct.pack("<Q", int(n)) for n in shape)
    if maxshape is not None:
        out += b"".join(struct.pack("<Q", UNDEF if m is None else int(m)) for m in maxshape)
    return out


def _message(mtype: int, body: bytes, flags: int = 0) -> bytes:
    body = _pad8(body)
    return struct.pack("<HHB3x", mtype, len(body), flags) + body


class _PendingDataset:
    def __init__(self, shape, dtype, chunks, attrs):
        self.shape, self.dtype, self.chunks, self.attrs = tuple(shape), np.dtype(dtype), chunks, attrs
        self.addr, self.nbytes = UNDEF, 0
        self.chunk_index: List[Tuple[Tuple[int, ...], int, int]] = []


class Writer:
    """Writes an HDF5 file of one root group holding datasets and string,
    integer or float attributes, in the structures :class:`File` reads and
    h5py (HDF5 1.14) reads back: superblock 0, version-1 object headers, a
    symbol-table root group, contiguous datasets, or chunked ones indexed by
    a version-1 B-tree, without filters.

    ``create_dataset(name, data=..., chunks=None, attrs=None)`` writes a
    whole array; ``create_dataset(name, shape=..., dtype=..., chunks=...)``
    returns a handle whose :meth:`_DatasetHandle.write_rows` writes blocks of
    whole chunks along the first axis as they come. ``attrs`` is the root's
    attributes. The metadata are written by :meth:`close`.
    """

    _SUPERBLOCK_SIZE = 96

    def __init__(self, path):
        self.path = os.fspath(path)
        self._f = open(self.path, "wb")
        self._f.write(b"\0" * self._SUPERBLOCK_SIZE)
        self._datasets: Dict[str, _PendingDataset] = {}
        self.attrs: Dict[str, object] = {}
        self._closed = False

    def _tell(self) -> int:
        return self._f.tell()

    def _append(self, data: bytes) -> int:
        addr = self._tell()
        self._f.write(data)
        pad = -len(data) % 8
        if pad:
            self._f.write(b"\0" * pad)
        return addr

    def create_dataset(self, name: str, data=None, *, shape=None, dtype=None, chunks=None,
                       attrs: Optional[dict] = None):
        if "/" in name.strip("/") or not name.strip("/"):
            raise ValueError(f"dataset names are plain root members, got {name!r}")
        name = name.strip("/")
        if name in self._datasets:
            raise ValueError(f"dataset {name!r} exists")
        if data is not None:
            data = np.asarray(data)
            if data.dtype.kind not in "fiu":
                raise NotImplementedError(f"writing {data.dtype} data")
            data = np.ascontiguousarray(data, data.dtype.newbyteorder("<"))
            shape, dtype = data.shape, data.dtype
        if shape is None or dtype is None:
            raise ValueError("give data, or shape and dtype")
        ds = _PendingDataset(shape, np.dtype(dtype).newbyteorder("<"), None, dict(attrs or {}))
        self._datasets[name] = ds
        if chunks is not None:
            chunks = tuple(int(c) for c in chunks)
            if len(chunks) != len(ds.shape) or any(c < 1 for c in chunks):
                raise ValueError(f"chunks {chunks} for shape {ds.shape}")
            if any(c != s for c, s in zip(chunks[1:], ds.shape[1:])):
                raise NotImplementedError("chunks must span every axis but the first")
            ds.chunks = chunks
        handle = _DatasetHandle(self, ds)
        if data is not None:
            handle.write_rows(0, data)
        return handle

    # -- metadata ----------------------------------------------------------------
    @staticmethod
    def _strings_of(value) -> Optional[List[bytes]]:
        """The UTF-8 strings of a str or bytes attribute value, or of a
        non-empty sequence of str; None for a numeric value."""
        if isinstance(value, (str, bytes)):
            return [value.encode("utf-8") if isinstance(value, str) else bytes(value)]
        if isinstance(value, (list, tuple, np.ndarray)) and len(value) and \
                all(isinstance(v, str) for v in value):
            return [v.encode("utf-8") for v in value]
        return None

    def _attribute_message(self, name: str, value, heap: int, index: List[int]) -> bytes:
        """An attribute message; vlen strings refer to objects of the global
        heap collection at ``heap``, numbered on from ``index[0]``."""
        strings = self._strings_of(value)
        if strings is not None:
            shape = () if isinstance(value, (str, bytes)) else (len(strings),)
            data = b""
            for raw in strings:
                index[0] += 1
                data += struct.pack("<IQI", len(raw), heap, index[0])
            dtype_msg = _VLEN_STR_TYPE
        else:
            arr = np.asarray(value)
            if arr.dtype.kind not in "fiu":
                raise NotImplementedError(f"attribute {name!r} of {arr.dtype}")
            arr = np.ascontiguousarray(arr, arr.dtype.newbyteorder("<"))
            shape, data, dtype_msg = arr.shape, arr.tobytes(), _datatype_message(arr.dtype)
        name_b = name.encode("utf-8") + b"\0"
        space = _dataspace_message(shape)
        body = struct.pack("<BBHHH", 1, 0, len(name_b), len(dtype_msg), len(space))
        body += _pad8(name_b) + _pad8(dtype_msg) + _pad8(space) + data
        return _message(MSG_ATTRIBUTE, body)

    def _object_header(self, messages: List[bytes]) -> int:
        body = b"".join(messages)
        head = struct.pack("<BBHII", 1, 0, len(messages), 1, len(body)) + b"\0" * 4
        return self._append(head + body)

    def _chunk_btree(self, ds: _PendingDataset) -> int:
        """Write the v1 B-tree over ``ds``'s chunks (at most 64 entries a
        node, the default K of 32); returns the root's address."""
        rank = len(ds.shape)
        csize = int(np.prod(ds.chunks, dtype=np.int64)) * ds.dtype.itemsize
        k2 = 64
        key_size = 8 + 8 * (rank + 1)

        def key(offset):
            return struct.pack("<II", csize, 0) + b"".join(struct.pack("<Q", o) for o in offset) + \
                struct.pack("<Q", 0)

        entries = sorted(ds.chunk_index)
        end = tuple(s for s in ds.shape)  # the key after the last chunk
        end_key = key(tuple(int(np.ceil(s / c)) * c for s, c in zip(end, ds.chunks)))
        level = 0
        nodes = [(entries[i:i + k2]) for i in range(0, len(entries), k2)] or [[]]
        # each node: list of (first key bytes, child address), then its last key
        level_items = []
        for group in nodes:
            level_items.append(([(key(off), addr) for off, addr, _ in group], None))
        while True:
            written = []
            for i, (items, _) in enumerate(level_items):
                next_key = level_items[i + 1][0][0][0] if i + 1 < len(level_items) else end_key
                body = b"".join(k + struct.pack("<Q", a) for k, a in items) + next_key
                body += b"\0" * ((k2 - len(items)) * (key_size + 8))
                head = b"TREE" + struct.pack("<BBHQQ", 1, level, len(items), UNDEF, UNDEF)
                written.append((items[0][0] if items else key((0,) * rank), self._append(head + body)))
            if len(written) == 1:
                return written[0][1]
            level += 1
            level_items = [(written[i:i + k2], None) for i in range(0, len(written), k2)]

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        headers: Dict[str, int] = {}
        owners = [(name, ds.attrs) for name, ds in self._datasets.items()] + [("/", self.attrs)]
        strings = [raw for _, attrs in owners for v in attrs.values()
                   for raw in (self._strings_of(v) or [])]
        heap, index = self._global_heap(strings), [0]
        attr_messages = {name: [self._attribute_message(k, v, heap, index) for k, v in attrs.items()]
                         for name, attrs in owners}
        for name, ds in self._datasets.items():
            if ds.chunks is not None:
                missing = [o for o in self._chunk_offsets(ds)
                           if o not in {off for off, _, _ in ds.chunk_index}]
                if missing:
                    raise ValueError(f"{name}: chunks at {missing[:3]} were never written")
                btree = self._chunk_btree(ds) if ds.chunk_index else UNDEF
                layout = bytes([3, 2, len(ds.shape) + 1]) + struct.pack("<Q", btree)
                layout += b"".join(struct.pack("<I", c) for c in ds.chunks)
                layout += struct.pack("<I", ds.dtype.itemsize)
                maxshape = (None,) + ds.shape[1:]
                fill = bytes([2, 3, 2, 0])  # incremental allocation, fill value undefined
            else:
                if ds.nbytes != int(np.prod(ds.shape, dtype=np.int64)) * ds.dtype.itemsize:
                    raise ValueError(f"{name}: data never written")
                layout = bytes([3, 1]) + struct.pack("<QQ", ds.addr, ds.nbytes)
                maxshape = None
                fill = bytes([2, 2, 2, 0])  # late allocation, fill value undefined
            messages = [
                _message(MSG_DATASPACE, _dataspace_message(ds.shape, maxshape)),
                _message(MSG_DATATYPE, _datatype_message(ds.dtype), flags=1),
                _message(MSG_FILL, fill, flags=1),
                _message(MSG_LAYOUT, layout),
                *attr_messages[name],
            ]
            headers[name] = self._object_header(messages)
        btree, heap = self._root_symbol_table(headers)
        root = self._object_header([_message(MSG_SYMBOL_TABLE, struct.pack("<QQ", btree, heap)),
                                    *attr_messages["/"]])
        eof = self._tell()
        sb = SIGNATURE + bytes([0, 0, 0, 0, 0, 8, 8, 0]) + struct.pack("<HHI", 4, 16, 0)
        sb += struct.pack("<QQQQ", 0, UNDEF, eof, UNDEF)
        sb += struct.pack("<QQII", 0, root, 1, 0) + struct.pack("<QQ", btree, heap)
        assert len(sb) == self._SUPERBLOCK_SIZE
        self._f.seek(0)
        self._f.write(sb)
        self._f.close()

    @staticmethod
    def _chunk_offsets(ds: _PendingDataset):
        return [(t,) + (0,) * (len(ds.shape) - 1) for t in range(0, ds.shape[0], ds.chunks[0])]

    def _global_heap(self, strings: List[bytes]) -> int:
        """One global heap collection holding ``strings`` as objects 1, 2,
        ...; its address (UNDEF when there are none)."""
        if not strings:
            return UNDEF
        body = b"".join(struct.pack("<HH4xQ", i, 1, len(s)) + _pad8(s)
                        for i, s in enumerate(strings, start=1))
        size = max(4096, 16 + len(body) + 16)
        free = size - 16 - len(body)  # object 0, the free space, counts its own header
        body += struct.pack("<HH4xQ", 0, 0, free) + b"\0" * (free - 16)
        return self._append(b"GCOL" + bytes([1, 0, 0, 0]) + struct.pack("<Q", size) + body)

    def _root_symbol_table(self, headers: Dict[str, int]) -> Tuple[int, int]:
        """Local heap, symbol-table nodes (8 entries each) and one B-tree
        node over them (at most 32 nodes); returns (B-tree, heap) addresses."""
        names = sorted(headers, key=lambda s: s.encode("utf-8"))
        if len(names) > 8 * 32:
            raise NotImplementedError(f"{len(names)} members (at most 256)")
        heap_data, offsets = b"\0" * 8, {}
        for n in names:
            offsets[n] = len(heap_data)
            heap_data += _pad8(n.encode("utf-8") + b"\0")
        heap_data += b"\0" * 16  # a free block at the end, as HDF5 keeps one
        free_off = len(heap_data) - 16
        heap_data = heap_data[:free_off] + struct.pack("<QQ", 1, 16)
        data_addr = self._append(heap_data)
        heap = self._append(b"HEAP" + bytes([0, 0, 0, 0]) +
                            struct.pack("<QQQ", len(heap_data), free_off, data_addr))
        snods = []
        for i in range(0, max(1, len(names)), 8):
            group = names[i:i + 8]
            body = b"".join(struct.pack("<QQII16x", offsets[n], headers[n], 0, 0) for n in group)
            body += b"\0" * (40 * (8 - len(group)))
            snods.append((group, self._append(b"SNOD" + bytes([1, 0]) +
                                              struct.pack("<H", len(group)) + body)))
        keys = [0] + [offsets[g[-1]] if g else 0 for g, _ in snods]
        body = b""
        for (group, addr), k in zip(snods, keys):
            body += struct.pack("<QQ", k, addr)
        body += struct.pack("<Q", keys[-1])
        body += b"\0" * (16 * (32 - len(snods)))
        btree = self._append(b"TREE" + struct.pack("<BBHQQ", 0, 0, len(snods), UNDEF, UNDEF) + body)
        return btree, heap

    def __enter__(self) -> "Writer":
        return self

    def __exit__(self, exc_type, *exc) -> None:
        if exc_type is None:
            self.close()
        else:
            self._closed = True
            self._f.close()


class _DatasetHandle:
    """A dataset being written: :meth:`write_rows` writes rows of the first
    axis (whole chunks for a chunked dataset, the whole array otherwise)."""

    def __init__(self, writer: Writer, ds: _PendingDataset):
        self._w, self._ds = writer, ds

    def write_rows(self, start: int, block) -> None:
        ds = self._ds
        block = np.ascontiguousarray(np.asarray(block), ds.dtype)
        if block.shape[1:] != ds.shape[1:] or start + block.shape[0] > ds.shape[0]:
            raise ValueError(f"block {block.shape} at row {start} does not fit {ds.shape}")
        if ds.chunks is None:
            if start != 0 or block.shape != ds.shape:
                raise ValueError("a contiguous dataset is written whole")
            ds.addr = self._w._append(block.tobytes()) if block.size else UNDEF
            ds.nbytes = block.nbytes
            return
        rows = ds.chunks[0]
        if start % rows or (block.shape[0] % rows and start + block.shape[0] != ds.shape[0]):
            raise ValueError(f"rows [{start}, {start + block.shape[0]}) are not whole chunks of {rows}")
        for r in range(0, block.shape[0], rows):
            part = block[r:r + rows]
            if part.shape[0] < rows:  # the edge chunk is stored at full size
                part = np.concatenate([part, np.zeros((rows - part.shape[0],) + part.shape[1:], ds.dtype)])
            addr = self._w._append(part.tobytes())
            offset = (start + r,) + (0,) * (len(ds.shape) - 1)
            ds.chunk_index.append((offset, addr, part.nbytes))
