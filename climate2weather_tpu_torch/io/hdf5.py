"""HDF5 reader and writer in the standard library and numpy (no h5py).

The port reads and writes the JAX package's HDF5 files without h5py, which
a GPU host may lack: the training file of ``merged_to_normed_h5``,
the grid files of ``GridDataset.to_file`` (``.nc`` names, HDF5 inside) and
the quantile files of ``QuantileDataset.to_file``. It also reads what
HDF5 1.8 and later write for netCDF-4 files (netCDF-C >= 4.4 sets the 1.8
low bound) and what h5py writes with any ``libver``. This module covers:

- superblock versions 0, 2 and 3;
- version-1 object headers with continuation blocks, and version-2 object
  headers (``OHDR``, continuation blocks ``OCHK``);
- groups held as a symbol table (a version-1 B-tree of symbol-table nodes
  and a local heap), and new-style groups: compact (link messages) or dense
  (a fractal heap of links, indexed by a version-2 B-tree by name or by
  creation order);
- hard, soft and external links, in either kind of group: every link is
  listed; a soft link resolves by its path, an external link in the file
  HDF5 finds for its name (``HDF5_EXT_PREFIX``, then beside the linking
  file, then from the working directory); a dangling link raises
  ``KeyError`` and a user-defined one ``NotImplementedError``, both only
  when followed;
- attributes in the object header, or dense (a fractal heap of attribute
  messages indexed by a version-2 B-tree by name or by creation order);
  fractal heaps with direct and indirect blocks, their managed, tiny and
  unfiltered huge objects;
- compact, contiguous, chunked and virtual layouts (layout message versions
  3 and 4): chunks indexed by a version-1 B-tree, a single-chunk index, the
  implicit index, a fixed array (``FAHD``/``FADB``, paged or not), an
  extensible array (``EAHD``, ``EAIB``, ``EASB``, ``EADB``) along one
  unlimited axis (swizzled to the slowest where it is not the first), or a
  version-2 B-tree (record types 10 and 11); a virtual dataset's mappings
  (all, regular and irregular hyperslabs) from sources in the same file
  (``"."``) or found as external links' files are (under
  ``HDF5_VDS_PREFIX``), elements no source maps reading as the fill value,
  and its unlimited mappings under h5py's default view (the last
  available): a printf-named source (``%b``, the block number; ``%%``)
  for each block of an unlimited count up to the first missing file, an
  unlimited source selection clipped to its source's current extent, the
  dataset's extent theirs;
- contiguous data in external raw storage (the external data files list):
  segments across files, found under ``HDF5_EXTFILE_PREFIX`` (a leading
  ``${ORIGIN}`` the file's directory) or else from the working directory,
  a short file reading as zeros past its end, a missing one raising
  ``OSError`` when read, as HDF5 1.14 reads them;
- integer (of partial precision too, shifted and sign-extended as HDF5
  converts it), floating-point, bitfield (as the unsigned integer of its
  size, as h5py reads it), enumerated (as its base integers, or bool as
  h5py writes it), array (as trailing axes) and compound (a structured
  dtype) data of either byte order, fixed-length and variable-length
  strings (the latter in the global heap), committed datatypes and the
  shared datatype messages of datasets and attributes that point at them;
- the fill value (the fill value message, versions 1-3, or the old one):
  storage never written, an unallocated chunk or a contiguous dataset with
  no address, reads as it, or as zeros where the file defines none, as
  h5py reads it;
- the deflate, shuffle, fletcher32 (verified; a mismatch raises
  :class:`ChecksumError`), n-bit, scale-offset (integers, and floats by
  D-scale), szip (through the host codec ``data/native/szip.cc``: a
  damaged stream raises ``OSError`` naming the dataset and the chunk) and
  lzf (h5py's, through ``data/native/blosc.cc``) filters;
- reads as h5py takes them: integers, slices of positive step, ``...`` and
  one increasing list of indices; what h5py refuses raises as it does.

Every Jenkins lookup3 checksum of these structures is verified: a mismatch
raises :class:`ChecksumError`. Attributes of other types (the object
references of dimension scales, for example) are skipped. Anything else
raises ``NotImplementedError`` naming what it found, so a file is read
right or not at all: shared-message tables and the "don't filter partial
edge chunks" flag (h5py here can write neither, so no file holds the
reading to), reference, opaque and time datatypes and variable-length
sequences (the package's readers take data as float32, which fails on
them under h5py too; h5py refuses time), bitfields of partial precision
(h5py writes none), layout messages of versions 1 and 2 (no HDF5 since
1.6.3 writes them), filtered fractal heaps (they hold links and
attributes, not data), a virtual dataset's point selections (HDF5 1.14
refuses to write them) and printf-named mappings unlimited in their
block.

:class:`File` opens a file for reading. A chunked dataset's index is read
when the dataset is opened; a slice then reads only the chunks it overlaps,
and a strided slice or an index list only the chunks (rows, where the
dataset is not chunked) that hold its elements.
:class:`Writer` writes superblock 0, version-1 object headers and a
symbol-table root group without filters: raw data as it is given, the
metadata when it is closed.
"""

from __future__ import annotations

import itertools
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
MSG_SHARED_TABLE, MSG_CONTINUATION, MSG_SYMBOL_TABLE, MSG_ATTRIBUTE_INFO = 0x0F, 0x10, 0x11, 0x15

# version-2 B-tree record types
BT2_LINK_NAME, BT2_LINK_ORDER, BT2_ATTR_NAME, BT2_ATTR_ORDER, BT2_HUGE = 5, 6, 8, 9, 1


class _Unsupported(Exception):
    """A datatype this reader does not decode (attributes of such types are
    skipped; datasets of such types raise ``NotImplementedError``)."""


class ChecksumError(OSError):
    """A structure's stored checksum differs from its contents' (a damaged
    file)."""


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


_M32 = 0xFFFFFFFF


def _rot(x: int, k: int) -> int:
    return ((x << k) | (x >> (32 - k))) & _M32


def lookup3(data: bytes) -> int:
    """Bob Jenkins' lookup3 ``hashlittle`` with an initial value of 0, the
    checksum of HDF5's metadata (``H5_checksum_metadata``)."""
    n = len(data)
    a = b = c = (0xDEADBEEF + n) & _M32
    if n == 0:
        return c
    tail = n - ((n - 1) // 12) * 12  # the last 1..12 bytes go to the final mix
    words = np.frombuffer(bytes(data) + b"\0" * (12 - tail), "<u4").tolist()
    for i in range(0, len(words) - 3, 3):
        a, b, c = (a + words[i]) & _M32, (b + words[i + 1]) & _M32, (c + words[i + 2]) & _M32
        for r1, r2, r3 in ((4, 6, 8), (16, 19, 4)):  # mix(a, b, c)
            a = ((a - c) & _M32) ^ _rot(c, r1)
            c = (c + b) & _M32
            b = ((b - a) & _M32) ^ _rot(a, r2)
            a = (a + c) & _M32
            c = ((c - b) & _M32) ^ _rot(b, r3)
            b = (b + a) & _M32
    a, b, c = (a + words[-3]) & _M32, (b + words[-2]) & _M32, (c + words[-1]) & _M32
    for r1, r2, r3 in ((14, 11, 25), (16, 4, 14)):  # final(a, b, c)
        c = ((c ^ b) - _rot(b, r1)) & _M32
        a = ((a ^ c) - _rot(c, r2)) & _M32
        b = ((b ^ a) - _rot(a, r3)) & _M32
    c = ((c ^ b) - _rot(b, 24)) & _M32
    return c


def _limit_enc_size(n: int) -> int:
    """Bytes HDF5 uses to encode counts up to ``n`` (``H5VM_limit_enc_size``)."""
    return (max(n, 1).bit_length() - 1) // 8 + 1


# ---------------------------------------------------------------------------
# datatypes


class _Datatype:
    """A decoded datatype message: ``kind`` in {"int", "float", "str",
    "vlen_str", "enum", "compound", "array"}; ``dtype`` the numpy dtype h5py
    gives an element; ``bits`` (precision, bit offset) of an integer whose
    value does not fill its bytes, read as HDF5 converts it (shifted down,
    sign-extended)."""

    def __init__(self, kind: str, size: int, dtype=None, padding: int = 0, bits=None):
        self.kind, self.size, self.dtype, self.padding, self.bits = kind, size, dtype, padding, bits


_IEEE_FLOATS = {2: (0, 16, 10, 5, 0, 10, 15), 4: (0, 32, 23, 8, 0, 23, 127), 8: (0, 64, 52, 11, 0, 52, 1023)}
_CLASS_NAMES = {2: "time", 5: "opaque", 7: "reference"}


def _name_at(buf: bytes, pos: int, padded: bool) -> Tuple[bytes, int]:
    """(name, position after it) of a NUL-terminated name, padded to a
    multiple of 8 bytes in the older message versions."""
    end = buf.index(b"\0", pos)
    return buf[pos:end], (pos + (end - pos) // 8 * 8 + 8 if padded else end + 1)


def _plain(dt: "_Datatype", what: str) -> "_Datatype":
    """``dt`` where it can be a member of a compound, enum or array type."""
    if dt.kind == "vlen_str" or dt.bits is not None:
        raise _Unsupported(f"{what} of {'variable length' if dt.kind == 'vlen_str' else 'a partial-precision integer'}")
    return dt


def _parse_datatype(buf: bytes, pos: int) -> Tuple[_Datatype, int]:
    """(datatype, bytes used) of the datatype message at ``buf[pos:]``."""
    cls, version = buf[pos] & 0x0F, buf[pos] >> 4
    bits = buf[pos + 1] | (buf[pos + 2] << 8) | (buf[pos + 3] << 16)
    size = _uint(buf, pos + 4, 4)
    order = ">" if bits & 1 else "<"
    if cls == 0:  # fixed-point
        if size not in (1, 2, 4, 8):
            raise _Unsupported(f"integer of {size} bytes")
        signed = bool(bits & 0x8)
        offset, precision = _uint(buf, pos + 8, 2), _uint(buf, pos + 10, 2)
        partial = (precision, offset) if (precision, offset) != (8 * size, 0) else None
        return _Datatype("int", size, np.dtype(f"{order}{'i' if signed else 'u'}{size}"), bits=partial), 12
    if cls == 4:  # bitfield: h5py reads it as the unsigned integer of its size
        offset, precision = _uint(buf, pos + 8, 2), _uint(buf, pos + 10, 2)
        if size not in (1, 2, 4, 8) or (precision, offset) != (8 * size, 0):
            raise _Unsupported(f"bitfield of {size} bytes, {precision} bits at bit {offset}")
        return _Datatype("int", size, np.dtype(f"{order}u{size}")), 12
    if cls == 1:  # floating-point
        if size not in (2, 4, 8):
            raise _Unsupported(f"float of {size} bytes")
        if bits & 0x1 and bits & 0x40:
            raise _Unsupported("VAX byte order")
        fields = (_uint(buf, pos + 8, 2), _uint(buf, pos + 10, 2), *buf[pos + 12:pos + 16], _uint(buf, pos + 16, 4))
        if fields != _IEEE_FLOATS[size]:
            raise _Unsupported(f"float of {size} bytes in a non-IEEE layout (bit offset, precision, exponent "
                               f"and mantissa fields, bias {fields})")
        return _Datatype("float", size, np.dtype(f"{order}f{size}")), 20
    if cls == 3:  # fixed-length string
        return _Datatype("str", size, np.dtype(f"S{size}"), padding=bits & 0x0F), 8
    if cls == 9:  # variable-length
        if bits & 0x0F != 1:
            raise _Unsupported("variable-length sequence")
        _, used = _parse_datatype(buf, pos + 8)
        return _Datatype("vlen_str", size), 8 + used
    if cls == 6:  # compound: a structured dtype of h5py's names, formats and offsets
        names, formats, offsets, at = [], [], [], pos + 8
        for _ in range(bits & 0xFFFF):
            name, at = _name_at(buf, at, version < 3)
            if version < 3:
                offset, ndims, at = _uint(buf, at, 4), buf[at + 4], at + 4
                if version == 1:  # the member's own array dimensions, then its type
                    dims, at = tuple(_uint(buf, at + 12 + 4 * i, 4) for i in range(ndims)), at + 28
            else:
                n = _limit_enc_size(size)
                offset, at, ndims = _uint(buf, at, n), at + n, 0
            member, used = _parse_datatype(buf, at)
            at += used
            member = _plain(member, f"compound member {name.decode()!r}")
            names.append(name.decode("utf-8"))
            formats.append(np.dtype((member.dtype, dims)) if version == 1 and ndims else member.dtype)
            offsets.append(offset)
        dtype = np.dtype({"names": names, "formats": formats, "offsets": offsets, "itemsize": size})
        return _Datatype("compound", size, dtype), at - pos
    if cls == 8:  # enumerated: its base integers, or bool where h5py writes numpy's bool so
        n = bits & 0xFFFF
        base, used = _parse_datatype(buf, pos + 8)
        base, at, names = _plain(base, "enumeration"), pos + 8 + used, []
        for _ in range(n):
            name, at = _name_at(buf, at, version < 3)
            names.append(name)
        values = np.frombuffer(buf, base.dtype, count=n, offset=at).tolist()
        at += n * base.size
        as_bool = base.size == 1 and base.kind == "int" and names == [b"FALSE", b"TRUE"] and values == [0, 1]
        return _Datatype("enum", size, np.dtype(bool) if as_bool else base.dtype), at - pos
    if cls == 10:  # array: trailing axes of its base type
        ndims = buf[pos + 8]
        at = pos + (12 if version < 3 else 9)
        dims = tuple(_uint(buf, at + 4 * i, 4) for i in range(ndims))
        at += 4 * ndims * (2 if version < 3 else 1)  # version 2 adds a permutation
        base, used = _parse_datatype(buf, at)
        base = _plain(base, "array")
        return _Datatype("array", size, np.dtype((base.dtype, dims))), at + used - pos
    raise _Unsupported(f"datatype class {cls} ({_CLASS_NAMES.get(cls, 'unknown')})")


def _members_only(raw: np.ndarray) -> np.ndarray:
    """Compound elements with the bytes between their members zeroed, as
    HDF5's conversion member by member into h5py's zeroed buffer leaves
    them (the file may hold anything there)."""
    out = np.zeros(raw.shape, raw.dtype)
    for name in raw.dtype.names:
        out[name] = raw[name]
    return out


def _parse_dataspace(buf: bytes, pos: int) -> Tuple[Optional[Tuple[int, ...]], Optional[tuple]]:
    """(shape, maximum shape) of the dataspace message at ``buf[pos:]``: None
    for a null dataspace, () for a scalar; an unlimited axis is None in the
    maximum shape."""
    version, rank, flags = buf[pos], buf[pos + 1], buf[pos + 2]
    if version == 1:
        start = pos + 8
    elif version == 2:
        if buf[pos + 3] == 2:
            return None, None
        start = pos + 4
    else:
        raise NotImplementedError(f"dataspace message version {version}")
    shape = tuple(_uint(buf, start + 8 * i, 8) for i in range(rank))
    if not flags & 1:
        return shape, shape
    top = (_uint(buf, start + 8 * (rank + i), 8) for i in range(rank))
    return shape, tuple(None if m == UNDEF else m for m in top)


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
                self._add_attribute(data)
            elif mtype == MSG_ATTRIBUTE_INFO:
                for raw in f._dense_attributes(data):
                    self._add_attribute(raw)

    def _add_attribute(self, data: bytes) -> None:
        name, value = self.file._parse_attribute(data)
        if name is not None:
            self.attrs[name] = value

    def _read_header(self, addr: int) -> None:
        src = self.file._src
        head = src.read(addr, 16)
        if head[:4] == b"OHDR":
            self._read_header_v2(addr)
            return
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
                self._add_message(mtype, flags, body, blocks)

    def _read_header_v2(self, addr: int) -> None:
        """A version-2 object header: the prefix and chunk 0 under one
        checksum, continuation blocks (``OCHK``) under their own."""
        src = self.file._src
        head = src.read(addr, 6)
        if head[4] != 2:
            raise NotImplementedError(f"version-2 object header of version {head[4]}")
        flags = head[5]
        pos = 6 + (16 if flags & 0x20 else 0) + (4 if flags & 0x10 else 0)  # times, attribute phase
        size_len = 1 << (flags & 0x03)
        chunk0 = _uint(src.read(addr + pos, size_len), 0, size_len)
        pos += size_len
        buf = self.file._checked(addr, pos + chunk0 + 4, b"OHDR", "object header")
        blocks: List[Tuple[int, int]] = []
        self._messages_v2(buf, pos, pos + chunk0, flags, blocks)
        while blocks:
            caddr, length = blocks.pop(0)
            buf = self.file._checked(caddr, length, b"OCHK", "object header continuation block")
            self._messages_v2(buf, 4, length - 4, flags, blocks)

    def _messages_v2(self, buf: bytes, pos: int, end: int, flags: int, blocks) -> None:
        hsize = 6 if flags & 0x04 else 4  # with each message's creation order
        while pos + hsize <= end:  # what is left below a message header is a gap
            mtype, size, mflags = buf[pos], _uint(buf, pos + 1, 2), buf[pos + 3]
            body = buf[pos + hsize:pos + hsize + size]
            pos += hsize + size
            self._add_message(mtype, mflags, body, blocks)

    def _add_message(self, mtype: int, flags: int, body: bytes, blocks) -> None:
        if mtype == MSG_CONTINUATION:
            blocks.append((_uint(body, 0, 8), _uint(body, 8, 8)))
        elif flags & 0x02 and mtype == MSG_DATATYPE:  # a committed datatype's
            body = self.file._shared_datatype(body)
        elif flags & 0x02 and mtype in (MSG_FILL, MSG_FILTERS, MSG_ATTRIBUTE):
            raise NotImplementedError(f"shared object header message (type {mtype})")
        self.messages.append((mtype, body))  # null messages too: version 1 counts them

    def find(self, mtype: int) -> Optional[bytes]:
        for t, data in self.messages:
            if t == mtype:
                return data
        return None

    def find_all(self, mtype: int) -> List[bytes]:
        return [data for t, data in self.messages if t == mtype]


MAX_LINK_DEPTH = 16  # soft and external links followed in one lookup (HDF5's default limit)


class Group:
    """A group: ``keys()``, ``[name]`` (a :class:`Group`, :class:`Dataset`
    or :class:`Datatype`, nested and absolute paths with ``/``, through hard,
    soft and external links), ``in`` and ``attrs``. Every link is listed,
    whatever its type; a link that does not resolve raises only when it is
    followed: ``KeyError`` where its target is missing, as h5py raises,
    ``NotImplementedError`` for a user-defined link."""

    def __init__(self, f: "File", obj: _Object, name: str):
        self.file, self.name, self._obj = f, name, obj
        self.attrs = obj.attrs
        st, linfo = obj.find(MSG_SYMBOL_TABLE), obj.find(MSG_LINK_INFO)
        if st is not None:
            self._members = f._read_symbol_table(_uint(st, 0, 8), _uint(st, 8, 8))
        elif linfo is not None or obj.find(MSG_LINK) is not None:
            self._members = f._read_links(obj.find_all(MSG_LINK), linfo, name)
        else:
            raise ValueError(f"{name}: object is not a group")

    def keys(self) -> List[str]:
        return list(self._members)

    def __iter__(self):
        return iter(self._members)

    def __len__(self) -> int:
        return len(self._members)

    def __contains__(self, name: str) -> bool:
        """Whether the path's last link exists, as h5py answers: a dangling
        soft or external link is in its group."""
        parent, _, last = name.rstrip("/").rpartition("/")
        if not last:
            return True
        try:
            group = self[parent] if parent else self.file if name.startswith("/") else self
        except KeyError:
            return False
        return isinstance(group, Group) and last in group._members

    def __getitem__(self, name: str):
        return self.file._resolve(self, name, 0)

    def _follow(self, part: str, depth: int):
        """The object the link ``part`` of this group leads to."""
        if part not in self._members:
            raise KeyError(f"{part!r} not in {self.name}")
        link, path = self._members[part], f"{self.name.rstrip('/')}/{part}"
        if isinstance(link, int):
            return self.file._open(link, path)
        if depth >= MAX_LINK_DEPTH:
            raise KeyError(f"Unable to open {path!r}: more than {MAX_LINK_DEPTH} soft or external links")
        if link[0] == "soft":
            try:
                return self.file._resolve(self, link[1], depth + 1)
            except KeyError:
                raise KeyError(f"Unable to open {path!r}: soft link to {link[1]!r} (component not found)") from None
        if link[0] == "external":
            target = self.file._external_file(link[1], "HDF5_EXT_PREFIX")
            if target is None:
                raise KeyError(f"Unable to open {path!r}: external link to {link[1]!r} (can't open file)")
            try:
                return target._resolve(target, link[2], depth + 1)
            except KeyError:
                raise KeyError(f"Unable to open {path!r}: external link to {link[1]}:{link[2]} "
                               f"(object doesn't exist)") from None
        raise NotImplementedError(f"{path}: user-defined link (type {link[1]})")


class Datatype:
    """A committed (named) datatype: ``dtype``, ``name`` and ``attrs``, as
    h5py gives them."""

    def __init__(self, f: "File", obj: _Object, name: str):
        self.file, self.name, self.attrs = f, name, obj.attrs
        try:
            self.dtype = _parse_datatype(obj.find(MSG_DATATYPE), 0)[0].dtype
        except _Unsupported as e:
            raise NotImplementedError(f"{name}: {e}") from None


class Dataset:
    """A dataset: ``shape``, ``dtype``, ``ndim``, ``chunks``, ``attrs`` and
    reads as h5py reads: integers, slices of positive step, ``...`` and one
    increasing list or array of indices (``ds[()]``, ``ds[:]``,
    ``ds[t0:t1]``, ``ds[::2]``, ``ds[i, :, 2:5]``, ``ds[[0, 3, 4]]``)."""

    def __init__(self, f: "File", obj: _Object, name: str):
        self.file, self.name, self._obj = f, name, obj
        self.attrs = obj.attrs
        space = obj.find(MSG_DATASPACE)
        dt = obj.find(MSG_DATATYPE)
        layout = obj.find(MSG_LAYOUT)
        if space is None or dt is None or layout is None:
            raise ValueError(f"{name}: object is not a dataset")
        shape, maxshape = _parse_dataspace(space, 0)
        self.shape, self._maxshape = ((), ()) if shape is None else (shape, maxshape)
        try:
            self._type, _ = _parse_datatype(dt, 0)
        except _Unsupported as e:
            raise NotImplementedError(f"{name}: {e}") from None
        if self._type.kind == "vlen_str":
            raise NotImplementedError(f"{name}: variable-length string dataset")
        self.dtype = self._type.dtype  # the file's byte order, as h5py keeps it
        # what one stored element decodes to before _finish: raw bytes of an
        # array element, the unsigned word of a partial-precision integer
        self._elem = np.dtype(f"V{self._type.size}") if self._type.kind == "array" else \
            np.dtype(self.dtype.str.replace("i", "u")) if self._type.bits is not None else self.dtype
        external = obj.find(MSG_EXTERNAL)
        self._segments = None if external is None else self._external_segments(external)
        self._filters = _parse_filters(obj.find(MSG_FILTERS), name)
        self._fill = _parse_fill(obj.find(MSG_FILL), obj.find(MSG_FILL_OLD), self._type.size, name)
        self.fillvalue = None if self._fill is None else \
            self._finish(np.frombuffer(self._fill, self._elem, count=1))[0]
        self._parse_layout(layout)

    @property
    def ndim(self) -> int:
        return len(self.shape)

    def __len__(self) -> int:
        if not self.shape:
            raise TypeError("len() of a scalar dataset")
        return self.shape[0]

    def _external_segments(self, buf: bytes) -> List[Tuple[str, int, int]]:
        """[(path, offset in the file, size)] of external raw storage (the
        external data files list message): each name from the message's
        local heap, found as HDF5 1.14 finds it (``H5D__build_file_prefix``):
        under the ``HDF5_EXTFILE_PREFIX`` variable, whose leading
        ``${ORIGIN}`` stands for this file's directory, else from the
        working directory. The last size may be unlimited (``UNDEF``)."""
        if buf[0] != 1:
            raise NotImplementedError(f"{self.name}: external data files list version {buf[0]}")
        used, heap = _uint(buf, 6, 2), _uint(buf, 8, 8)
        names = self.file._local_heap_data(heap)
        prefix = os.environ.get("HDF5_EXTFILE_PREFIX", "")
        if prefix.startswith("${ORIGIN}"):
            prefix = self.file._dir + "/" + prefix[len("${ORIGIN}"):]
        segments = []
        for i in range(used):
            at = 16 + 24 * i
            off = _uint(buf, at, 8)
            name = names[off:names.index(b"\0", off)].decode("utf-8")
            if prefix and prefix != "." and not os.path.isabs(name):
                name = prefix + ("" if prefix.endswith("/") else "/") + name
            segments.append((name, _uint(buf, at + 8, 8), _uint(buf, at + 16, 8)))
        return segments

    def _external_read(self, start: int, n: int) -> bytes:
        """``n`` bytes from ``start`` of external raw storage, across its
        segments and files; a file shorter than its segment reads as zeros
        past its end and a missing one raises, as HDF5 reads them."""
        out, at = [], 0
        for path, offset, size in self._segments:
            if n <= 0:
                break
            end = at + size if size != UNDEF else start + n
            if end > start:
                skip = start - at
                count = min(end - start, n)
                try:
                    fd = os.open(path, os.O_RDONLY)
                except OSError:
                    raise OSError(f"{self.file.filename}: {self.name}: unable to open external raw data file "
                                  f"{path!r}") from None
                try:
                    got = os.pread(fd, count, offset + skip)
                finally:
                    os.close(fd)
                out.append(got + b"\0" * (count - len(got)))
                start, n = start + count, n - count
            at = end
        if n > 0:
            raise OSError(f"{self.file.filename}: {self.name}: read past the end of its external storage")
        return b"".join(out)

    def _parse_layout(self, buf: bytes) -> None:
        version, cls = buf[0], buf[1]
        if version not in (3, 4):
            raise NotImplementedError(f"{self.name}: data layout message version {version}")
        self.chunks = None
        if cls == 0:  # compact: the raw data sit in the message
            self._kind, self._compact = "compact", buf[4:4 + _uint(buf, 2, 2)]
            return
        if cls == 1:  # contiguous
            self._addr = _uint(buf, 2, 8)
            self._kind = "contiguous"
            return
        if cls == 3:  # virtual: the mappings are an object of the global heap
            self._kind = "virtual"
            self._sources: Dict[Tuple[str, str], Optional[Dataset]] = {}
            self._mappings = self._expand_mappings(
                self.file._virtual_mappings(_uint(buf, 2, 8), _uint(buf, 10, 4), self.name))
            return
        if cls != 2:
            raise NotImplementedError(f"{self.name}: layout class {cls} (unknown)")
        self._kind = "chunked"
        self._last_chunk = self._where = None  # the last chunk decoded; the index by chunk coordinates
        rank = len(self.shape)
        if version == 3:  # a version-1 B-tree index
            dims = buf[2]
            btree = _uint(buf, 3, 8)
            self.chunks = tuple(_uint(buf, 11 + 4 * i, 4) for i in range(dims))[:-1]
            self._index = self.file._read_chunk_index(btree, rank) if btree != UNDEF else []
            return
        flags, dims, enc = buf[2], buf[3], buf[4]
        self.chunks = tuple(_uint(buf, 5 + enc * i, enc) for i in range(dims))[:-1]
        pos = 5 + enc * dims
        itype, pos = buf[pos], pos + 1
        if flags & 0x01:
            raise NotImplementedError(f"{self.name}: unfiltered partial edge chunks")
        nbytes = int(np.prod(self.chunks, dtype=np.int64)) * self._type.size
        if itype == 1:  # single chunk
            size, mask = nbytes, 0
            if flags & 0x02:  # filtered: its stored size and filter mask
                size, mask, pos = _uint(buf, pos, 8), _uint(buf, pos + 8, 4), pos + 12
            addr = _uint(buf, pos, 8)
            self._index = [] if addr == UNDEF else [((0,) * rank, mask, size, addr)]
        elif itype == 2:  # implicit: every chunk of the grid, in row-major order, from one address
            addr = _uint(buf, pos, 8)
            count = int(np.prod(self._grid(), dtype=np.int64)) if addr != UNDEF else 0
            self._index = self._grid_entries([(0, nbytes, addr + i * nbytes) for i in range(count)])
        elif itype in (3, 4):  # fixed array; extensible array along one unlimited axis
            addr = _uint(buf, pos + (1 if itype == 3 else 5), 8)
            unlimited = [i for i, m in enumerate(self._maxshape) if m is None]
            if itype == 4 and len(unlimited) != 1:
                raise OSError(f"{self.name}: extensible-array chunk index over unlimited axes {unlimited}")
            read = self.file._fixed_array if itype == 3 else self.file._extensible_array
            entries = read(addr, nbytes) if addr != UNDEF else []
            self._index = self._grid_entries(entries, unlimited[0] if itype == 4 else None)
        elif itype == 5:  # version-2 B-tree of records 10 (address, scaled offsets) or 11 (filtered)
            addr = _uint(buf, pos + 6, 8)
            filtered = bool(self._filters)
            self._index = []
            for rec in (self.file._btree2_records(addr, 11 if filtered else 10) if addr != UNDEF else []):
                at = len(rec) - 8 * rank  # the scaled offsets end the record
                offset = tuple(_uint(rec, at + 8 * i, 8) * c for i, c in enumerate(self.chunks))
                size, mask = (_uint(rec, 8, at - 12), _uint(rec, at - 4, 4)) if filtered else (nbytes, 0)
                self._index.append((offset, mask, size, _uint(rec, 0, 8)))
        else:
            raise NotImplementedError(f"{self.name}: chunk index type {itype} (unknown)")

    def _grid(self) -> List[int]:
        """Chunks along each axis of the maximum shape (0 where unlimited)."""
        return [-(-m // c) if m is not None else 0 for m, c in zip(self._maxshape, self.chunks)]

    def _grid_entries(self, entries, unlimited: Optional[int] = None) -> list:
        """The chunk index of ``entries`` [(filter mask, stored bytes,
        address)] in row-major order over the chunk grid of the maximum
        shape; an extensible array's unlimited axis is swizzled to the
        slowest place (``H5VM_swizzle_coords``). Chunks unallocated or
        outside the current shape are dropped."""
        grid = self._grid()
        order = list(range(len(grid)))
        if unlimited is not None:
            order = [unlimited] + [d for d in order if d != unlimited]
        index = []
        for i, (mask, size, caddr) in enumerate(entries):
            scaled = [0] * len(grid)
            for d in reversed(order[1:]):
                i, scaled[d] = divmod(i, grid[d])
            if order:
                scaled[order[0]] = i
            offset = tuple(s * c for s, c in zip(scaled, self.chunks))
            if caddr != UNDEF and all(o < n for o, n in zip(offset, self.shape)):
                index.append((offset, mask, size, caddr))
        return index

    # -- selections --------------------------------------------------------------
    def _selection(self, key) -> list:
        """Per axis: a slice (start, stop, step >= 1), an int, or an
        increasing array of indices, as h5py takes them (one index list at
        most; a step below 1 or an index list out of order raises as h5py
        raises)."""
        if not isinstance(key, tuple):
            key = (key,)
        ellipses = [i for i, k in enumerate(key) if k is Ellipsis]
        if len(ellipses) > 1:
            raise ValueError("Only one ellipsis may be used.")
        if ellipses:
            i = ellipses[0]
            key = key[:i] + (slice(None),) * max(0, self.ndim - len(key) + 1) + key[i + 1:]
        if len(key) > self.ndim:
            raise IndexError(f"{len(key)} indices for {self.ndim} dimensions")
        key = key + (slice(None),) * (self.ndim - len(key))
        if sum(isinstance(k, (list, np.ndarray)) for k in key) > 1:
            raise TypeError("Only one indexing vector or array is currently allowed for fancy indexing")
        axes = []
        for k, n in zip(key, self.shape):
            if isinstance(k, slice):
                if k.step is not None and k.step < 1:
                    raise ValueError(f"Step must be >= 1 (got {k.step})")
                start, stop, step = k.indices(n)
                axes.append(slice(start, max(start, stop), step))
            elif isinstance(k, (int, np.integer)) and not isinstance(k, (bool, np.bool_)):
                i = int(k) + n if k < 0 else int(k)
                if not 0 <= i < n:
                    raise IndexError(f"index {k} out of range for axis of {n}")
                axes.append(i)
            elif isinstance(k, (list, np.ndarray)):
                idx = np.asarray(k)
                if idx.dtype == bool:
                    raise NotImplementedError("boolean index arrays")
                if idx.ndim != 1 or idx.size and idx.dtype.kind not in "iu":
                    raise TypeError(f"index list {k!r}: a list of integers is expected")
                idx = idx.astype(np.int64)
                idx = np.where(idx < 0, idx + n, idx)
                if ((idx < 0) | (idx >= n)).any():
                    raise IndexError(f"index list {k!r} out of range for axis of {n}")
                if (np.diff(idx) <= 0).any():
                    raise TypeError("Indexing elements must be in increasing order")
                axes.append(idx)
            else:
                raise NotImplementedError(f"index {k!r}")
        return axes

    def __getitem__(self, key) -> np.ndarray:
        axes = self._selection(key)
        picks = [np.arange(a.start, a.stop, a.step) if isinstance(a, slice) else
                 np.array([a]) if isinstance(a, int) else a for a in axes]
        out = self._gather(picks)[tuple(0 if isinstance(a, int) else slice(None) for a in axes)]
        out = self._finish(out if out.ndim and out.flags.c_contiguous else np.array(out, order="C"))
        scalar = out.ndim == 0 and not (key is Ellipsis or isinstance(key, tuple) and Ellipsis in key)
        return out[()] if scalar else out

    def _runs(self, axis: int, sel: np.ndarray) -> List[np.ndarray]:
        """The increasing indices ``sel`` along ``axis`` cut into runs that
        are each read as one span: a run ends where the next index skips
        ahead into another chunk (for the other layouts, another row of the
        first axis), so a sparse or strided selection reads and decodes only
        the chunks or rows that hold its elements."""
        if not sel.size:
            return []
        unit = self.chunks[axis] if self.chunks else 1 if axis == 0 else self.shape[axis]
        cut = np.nonzero((np.diff(sel) != 1) & (sel[1:] // unit != sel[:-1] // unit))[0] + 1
        return np.split(sel, cut)

    def _gather(self, picks: List[np.ndarray]) -> np.ndarray:
        """The stored elements at the outer product of ``picks``, one
        increasing index array per axis, read one box per combination of
        the axes' runs (:meth:`_runs`); a single box is returned as read."""
        per_axis = []
        for axis, sel in enumerate(picks):
            runs, at = [], 0
            for run in self._runs(axis, sel):
                local = slice(None) if run[-1] - run[0] + 1 == len(run) else run - run[0]
                runs.append(((int(run[0]), int(run[-1]) + 1), local, slice(at, at + len(run))))
                at += len(run)
            per_axis.append(runs)
        combos = list(itertools.product(*per_axis))
        out = None if len(combos) == 1 else np.empty(tuple(len(p) for p in picks), self._elem)
        for combo in combos:
            box, local, dst = zip(*combo) if combo else ((), (), ())
            block = self._read(list(box))
            if sum(not isinstance(i, slice) for i in local) > 1:
                local = np.ix_(*[np.arange(b - a) if isinstance(i, slice) else i for (a, b), i in zip(box, local)])
            if out is None:
                return block[tuple(local)]
            out[dst] = block[tuple(local)]
        return out

    def _finish(self, raw: np.ndarray) -> np.ndarray:
        """Stored elements as h5py returns them: an array type's base
        values in trailing axes; a partial-precision integer shifted down
        to its value and sign-extended."""
        if self._type.kind == "array":
            base, dims = self.dtype.subdtype
            return np.frombuffer(raw.tobytes(), base).reshape(raw.shape + dims).copy()
        if self._type.kind == "compound":
            return _members_only(raw)
        if self._type.bits is not None:
            precision, offset = self._type.bits
            value = (raw.astype(np.uint64) >> np.uint64(offset)) & np.uint64((1 << precision) - 1)
            if self.dtype.kind == "i":
                value = value.astype(np.int64)
                value = np.where(value >= 1 << (precision - 1), value - (1 << precision), value)
            return value.astype(self.dtype)
        return raw

    # -- reads ---------------------------------------------------------------
    def _decode(self, raw: bytes, count: int) -> np.ndarray:
        return np.frombuffer(raw, dtype=self._elem, count=count).copy()

    def _read(self, ranges: List[Tuple[int, int]]) -> np.ndarray:
        """The stored elements of the box ``ranges`` ([start, stop) per axis)."""
        sel_shape = tuple(b - a for a, b in ranges)
        n_total = int(np.prod(self.shape, dtype=np.int64))
        if self._kind == "virtual":
            return self._read_virtual(ranges)
        if self._kind == "compact":
            full = self._decode(self._compact, n_total).reshape(self.shape)
            return np.ascontiguousarray(full[tuple(slice(a, b) for a, b in ranges)])
        if self._kind == "contiguous":
            if self._addr == UNDEF and self._segments is None:  # never written
                return self._filled(sel_shape)
            read = self._external_read if self._segments is not None else \
                lambda start, n: self.file._src.read(self._addr + start, n)
            if self.ndim:  # contiguous rows [r0, r1) of the first axis are one read
                row = int(np.prod(self.shape[1:], dtype=np.int64)) * self._type.size
                r0, r1 = ranges[0]
                raw = read(r0 * row, (r1 - r0) * row)
                full = self._decode(raw, (r1 - r0) * row // self._type.size)
                full = full.reshape((r1 - r0,) + tuple(self.shape[1:]))
                idx = (slice(None),) + tuple(slice(a, b) for a, b in ranges[1:])
                return np.ascontiguousarray(full[idx])
            return self._decode(read(0, self._type.size), 1).reshape(())
        out = self._filled(sel_shape)  # what no allocated chunk covers reads as the fill value
        csize = int(np.prod(self.chunks, dtype=np.int64))
        if self._where is None:
            self._where = {tuple(o // c for o, c in zip(e[0], self.chunks)): e for e in self._index}
        for coords in itertools.product(*[range(a // c, -(-b // c)) for (a, b), c in zip(ranges, self.chunks)]):
            if coords not in self._where:
                continue
            offset, mask, nbytes, addr = self._where[coords]
            lo = [max(a, o) for (a, _), o in zip(ranges, offset)]
            hi = [min(b, o + c) for (_, b), o, c in zip(ranges, offset, self.chunks)]
            if any(h <= l for l, h in zip(lo, hi)):
                continue
            chunk = self._chunk(addr, nbytes, mask, csize)
            src = tuple(slice(l - o, h - o) for l, h, o in zip(lo, hi, offset))
            dst = tuple(slice(l - a, h - a) for l, h, (a, _) in zip(lo, hi, ranges))
            out[dst] = chunk[src]
        return out

    def _filled(self, shape) -> np.ndarray:
        """Storage never written, as HDF5 returns it: the dataset's fill
        value, or zeros where the file defines none."""
        n = int(np.prod(shape, dtype=np.int64))
        if self._fill is None:
            return np.zeros(shape, self._elem)
        return np.frombuffer(self._fill * n, self._elem, count=n).reshape(shape).copy()

    def _chunk(self, addr: int, nbytes: int, mask: int, count: int) -> np.ndarray:
        """The decoded chunk at ``addr``; the last one is kept, so reads of
        neighbouring rows decode each chunk once."""
        last = self._last_chunk
        if last is not None and last[0] == addr:
            return last[1]
        raw = _unfilter(self.file._src.read(addr, nbytes), self._filters, mask, self._type.size,
                        count * self._type.size, f"{self.file.filename}: {self.name}: the chunk at {addr}")
        chunk = self._decode(raw, count).reshape(self.chunks)
        self._last_chunk = (addr, chunk)
        return chunk

    # -- virtual datasets ---------------------------------------------------------
    def _expand_mappings(self, mappings: list) -> list:
        """The mappings as fixed selections, and the dataset's extent as
        h5py's default view (``H5D_VDS_LAST_AVAILABLE``) gives it: a mapping
        unlimited along an axis of the virtual space covers what its sources
        now hold. A printf-named source (``%b`` in its file or dataset name)
        maps block ``b`` of its virtual selection's unlimited count to the
        source named with ``b``, for b = 0, 1, ... up to the first that is
        missing (HDF5's default printf gap of 0); any other unlimited mapping
        maps the slices of its source's unlimited selection within the
        source's extent to as many slices of its virtual selection. Along
        such an axis the extent is the end of the last slice mapped, or of a
        fixed mapping where that lies further; elsewhere it is the
        dataspace's."""
        out, ends, fixed_ends = [], {}, [0] * len(self.shape)
        for file_name, dset_name, src_sel, virt_sel in mappings:
            axis = _unlimited_axis(virt_sel)
            if axis is None:
                v = _Selected(virt_sel, self.shape)
                if not v.empty:
                    fixed_ends = [max(e, h) for e, h in zip(fixed_ends, v.hi)]
                out.append((_printf_name(file_name, None), _printf_name(dset_name, None), src_sel, virt_sel))
                continue
            start, stride, count, block = virt_sel[1][axis]
            if "%b" in file_name.replace("%%", "") or "%b" in dset_name.replace("%%", ""):
                if count is not None or block is None:  # one source per block of the unlimited count
                    raise NotImplementedError(f"{self.name}: a printf-named mapping unlimited in its block")
                b = 0
                while True:
                    names = _printf_name(file_name, b), _printf_name(dset_name, b)
                    if self._source(*names) is None:
                        break
                    dims = list(virt_sel[1])
                    dims[axis] = (start + b * stride, 1, 1, block)
                    out.append((*names, src_sel, ("regular", dims)))
                    b += 1
                ends[axis] = max(ends.get(axis, 0), start + (b - 1) * stride + block if b else 0)
                continue
            names = _printf_name(file_name, None), _printf_name(dset_name, None)
            src, src_axis = self._source(*names), _unlimited_axis(src_sel)
            if src_axis is None:
                raise NotImplementedError(f"{self.name}: an unlimited mapping from a limited source selection")
            picked = 0 if src is None else _slices_within(*src_sel[1][src_axis], src.shape[src_axis])
            ends.setdefault(axis, 0)
            if picked:
                src_axes = [_unlimited_indices(*d, picked if i == src_axis else None)
                            for i, d in enumerate(src_sel[1])]
                virt_axes = [_unlimited_indices(*d, picked if i == axis else None)
                             for i, d in enumerate(virt_sel[1])]
                out.append((*names, ("axes", src_axes), ("axes", virt_axes)))
                ends[axis] = max(ends[axis], int(virt_axes[axis][-1]) + 1)
        self.shape = tuple(max(ends[d], fixed_ends[d]) if d in ends else n for d, n in enumerate(self.shape))
        return out

    def _source(self, file_name: str, dset_name: str) -> Optional["Dataset"]:
        """A mapping's source dataset; None where its file or dataset is
        missing (HDF5 then reads the mapped elements as the fill value)."""
        key = (file_name, dset_name)
        if key not in self._sources:
            f = self.file if file_name == "." else self.file._external_file(file_name, "HDF5_VDS_PREFIX")
            try:
                src = None if f is None else f[dset_name]
            except KeyError:
                src = None
            if src is not None and (not isinstance(src, Dataset) or src.dtype.newbyteorder("=") !=
                                    self.dtype.newbyteorder("=") or src._type.kind != self._type.kind):
                raise NotImplementedError(f"{self.name}: virtual source {file_name}:{dset_name} of "
                                          f"{getattr(src, 'dtype', 'no')} datatype (the dataset's is {self.dtype})")
            self._sources[key] = src
        return self._sources[key]

    def _read_virtual(self, ranges: List[Tuple[int, int]]) -> np.ndarray:
        """The box ``ranges`` of a virtual dataset: each mapping's source
        elements in its selection's row-major order put at its virtual
        selection's elements in theirs; the rest the fill value."""
        out = self._filled(tuple(b - a for a, b in ranges))
        lo = np.array([a for a, _ in ranges], np.int64)
        for file_name, dset_name, src_sel, virt_sel in self._mappings:
            v = _Selected(virt_sel, self.shape)
            if v.empty or any(h <= a or l >= b for l, h, (a, b) in zip(v.lo, v.hi, ranges)):
                continue
            src = self._source(file_name, dset_name)
            if src is None:
                continue
            s = _Selected(src_sel, src.shape)
            if s.count != v.count:
                raise OSError(f"{self.name}: a mapping of {file_name}:{dset_name} selects {s.count} source and "
                              f"{v.count} virtual elements")
            if v.axes is not None and s.axes is not None and [len(a) for a in v.axes] == [len(a) for a in s.axes]:
                # products of per-axis indices of equal lengths: read only what the box needs
                pick = [np.nonzero((a >= l) & (a < h))[0] for a, (l, h) in zip(v.axes, ranges)]
                if any(p.size == 0 for p in pick):
                    continue
                vals = src._gather([a[p] for a, p in zip(s.axes, pick)])
                out[np.ix_(*[a[p] - l for a, p, l in zip(v.axes, pick, lo)])] = vals.astype(self._elem)
                continue
            vals = src._read(list(zip(s.lo, s.hi)))[s.mask()].astype(self._elem)
            coords = np.nonzero(v.mask())
            coords = [c + l for c, l in zip(coords, v.lo)]
            inside = np.ones(len(vals), bool)
            for c, (a, b) in zip(coords, ranges):
                inside &= (c >= a) & (c < b)
            out[tuple(c[inside] - l for c, l in zip(coords, lo))] = vals[inside]
        return out


class _Selected:
    """A dataspace selection of a virtual dataset's mapping over ``shape``:
    its bounding box [lo, hi), per-axis index arrays where it is a product
    of them (all, a regular hyperslab, one block), and its mask over the box."""

    def __init__(self, sel: tuple, shape: Tuple[int, ...]):
        kind = sel[0]
        self.axes: Optional[List[np.ndarray]] = None
        self._blocks = None
        if kind == "all":
            self.axes = [np.arange(n, dtype=np.int64) for n in shape]
        elif kind == "axes":
            self.axes = list(sel[1])
        elif kind == "regular":
            self.axes = [(st + sd * np.arange(cn, dtype=np.int64)[:, None] + np.arange(bk)).ravel()
                         for st, sd, cn, bk in sel[1]]
        elif kind == "blocks" and len(sel[1]) == 1:
            self.axes = [np.arange(a, b + 1, dtype=np.int64) for a, b in zip(*sel[1][0])]
        elif kind == "blocks":
            self._blocks = sel[1]
        if kind == "none" or self._blocks == [] or self.axes is not None and any(a.size == 0 for a in self.axes):
            self.empty, self.count, self.lo, self.hi = True, 0, (), ()
            return
        self.empty = False
        if self.axes is not None:
            self.lo = tuple(int(a[0]) for a in self.axes)
            self.hi = tuple(int(a[-1]) + 1 for a in self.axes)
            self.count = int(np.prod([a.size for a in self.axes], dtype=np.int64))
        else:
            self.lo = tuple(int(min(st[d] for st, _ in self._blocks)) for d in range(len(shape)))
            self.hi = tuple(int(max(en[d] for _, en in self._blocks)) + 1 for d in range(len(shape)))
            self.count = int(self.mask().sum())

    def mask(self) -> np.ndarray:
        """The selected elements of the bounding box (row-major order is
        HDF5's order of a selection's elements)."""
        m = np.zeros([h - l for l, h in zip(self.lo, self.hi)], bool)
        if self.axes is not None:
            m[np.ix_(*[a - l for a, l in zip(self.axes, self.lo)])] = True
        else:
            for st, en in self._blocks:
                m[tuple(slice(a - l, b + 1 - l) for a, b, l in zip(st, en, self.lo))] = True
        return m


def _unlimited_axis(sel: tuple) -> Optional[int]:
    """The axis of a regular hyperslab whose count or block is unlimited."""
    if sel[0] != "regular":
        return None
    return next((d for d, (_, _, cn, bk) in enumerate(sel[1]) if cn is None or bk is None), None)


def _slices_within(start: int, stride: int, count: Optional[int], block: Optional[int], extent: int) -> int:
    """How many slices of a regular hyperslab's axis lie below ``extent``."""
    if extent <= start:
        return 0
    if block is None:
        return extent - start
    q, r = divmod(extent - start, stride)
    n = q * block + min(r, block)
    return n if count is None else min(n, count * block)


def _unlimited_indices(start: int, stride: int, count: Optional[int], block: Optional[int],
                       n: Optional[int]) -> np.ndarray:
    """The first ``n`` indices a regular hyperslab selects along one axis
    (all of them where ``n`` is None: the axis is limited)."""
    if block is None:
        return start + np.arange(n, dtype=np.int64)
    blocks = count if n is None else -(-n // block)
    idx = (start + stride * np.arange(blocks, dtype=np.int64)[:, None] + np.arange(block)).ravel()
    return idx if n is None else idx[:n]


def _printf_name(text: str, block: Optional[int]) -> str:
    """A virtual mapping's source name with ``%b`` replaced by ``block``
    and ``%%`` by ``%`` (HDF5's printf-style names); another ``%`` raises."""
    out, i = [], 0
    while i < len(text):
        nxt = text[i + 1:i + 2]
        if text[i] != "%":
            out.append(text[i])
            i += 1
            continue
        if nxt == "%" or nxt == "b" and block is not None:
            out.append("%" if nxt == "%" else str(block))
        else:
            raise NotImplementedError(f"virtual source name {text!r}: the specifier %{nxt} (HDF5 takes %b and %%)")
        i += 2
    return "".join(out)


def _parse_selection(buf: bytes, pos: int, what: str) -> Tuple[tuple, int]:
    """(selection, position after it) of a serialized dataspace selection
    (``H5S_SELECT_SERIALIZE``): ("all",), ("none",), ("regular", [(start,
    stride, count, block) per axis], an unlimited count or block None) or
    ("blocks", [(starts, ends)]) with inclusive ends. Point selections
    raise."""
    stype, version = _uint(buf, pos, 4), _uint(buf, pos + 4, 4)
    if stype in (0, 3):  # none, all: type, version, 8 reserved bytes
        return ("none",) if stype == 0 else ("all",), pos + 16
    if stype == 1:
        raise NotImplementedError(f"{what}: a point selection")
    if stype != 2:
        raise NotImplementedError(f"{what}: selection type {stype}")
    if version == 1:  # reserved, length, rank, block count, then 4-byte corners
        rank, n, at = _uint(buf, pos + 16, 4), _uint(buf, pos + 20, 4), pos + 24
        corners = [tuple(_uint(buf, at + 4 * (2 * rank * b + i), 4) for i in range(2 * rank)) for b in range(n)]
        return ("blocks", [(c[:rank], c[rank:]) for c in corners]), at + 8 * rank * n
    flags = buf[pos + 8]
    if version == 2:  # flags, length, rank, then 8-byte fields
        enc, rank, at = 8, _uint(buf, pos + 13, 4), pos + 17
    elif version == 3:  # flags, the fields' size, rank
        enc, rank, at = buf[pos + 9], _uint(buf, pos + 10, 4), pos + 14
    else:
        raise NotImplementedError(f"{what}: hyperslab selection version {version}")
    unlimited = (1 << (8 * enc)) - 1
    if flags & 0x01:  # regular: start, stride, count, block per axis (None where unlimited)
        dims = [tuple(None if v == unlimited else v for v in (_uint(buf, at + enc * (4 * d + j), enc)
                                                                for j in range(4))) for d in range(rank)]
        return ("regular", dims), at + 4 * enc * rank
    if version < 3:
        raise NotImplementedError(f"{what}: an irregular hyperslab of version {version}")
    n, at = _uint(buf, at, enc), at + enc
    corners = [tuple(_uint(buf, at + enc * (2 * rank * b + i), enc) for i in range(2 * rank)) for b in range(n)]
    return ("blocks", [(c[:rank], c[rank:]) for c in corners]), at + 2 * enc * rank * n


FILL_TIME_NEVER = 1  # the fill value's write time: never written to unwritten storage


def _parse_fill(new: Optional[bytes], old: Optional[bytes], size: int, name: str) -> Optional[bytes]:
    """The stored bytes of the value that storage never written reads as,
    from the fill value message (type 0x5, versions 1-3) or, where a file
    has only that, the old one (0x4, a size and the value, with no flags);
    None where the file defines no value (undefined or the library's
    default, both read as zeros) or never writes it (fill time "never":
    HDF5 then leaves the reader's buffer, which h5py fills with zeros). The
    value is one element of the dataset's datatype, ``size`` bytes."""
    if new is not None:
        version = new[0]
        if version in (1, 2):
            fill_time, has_value, pos = new[2], bool(new[3]), 4
        elif version == 3:
            flags = new[1]
            fill_time, has_value, pos = (flags >> 2) & 0x3, bool(flags & 0x20), 2
        else:
            raise NotImplementedError(f"{name}: fill value message version {version}")
        if not has_value or fill_time == FILL_TIME_NEVER:
            return None
        n = _uint(new, pos, 4)
        raw = new[pos + 4:pos + 4 + n]
    elif old is not None:
        n = _uint(old, 0, 4)
        raw = old[4:4 + n]
    else:
        return None
    if n == 0:  # defined as the library's default: zeros
        return None
    if n != size or len(raw) != n:
        raise NotImplementedError(f"{name}: a fill value of {n} bytes for elements of {size}")
    return bytes(raw)


FILTER_DEFLATE, FILTER_SHUFFLE, FILTER_FLETCHER32, FILTER_SZIP, FILTER_NBIT, FILTER_SCALEOFFSET = 1, 2, 3, 4, 5, 6
FILTER_LZF = 32000  # h5py's own filter
_FILTERS_READ = (FILTER_DEFLATE, FILTER_SHUFFLE, FILTER_FLETCHER32, FILTER_SZIP, FILTER_NBIT, FILTER_SCALEOFFSET,
                 FILTER_LZF)
_FILTER_NAMES = {307: "bzip2", 32001: "blosc", 32004: "lz4", 32008: "bitshuffle", 32015: "zstd"}


def _parse_filters(buf: Optional[bytes], name: str = "") -> List[Tuple[int, Tuple[int, ...]]]:
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
        if fid not in _FILTERS_READ:
            raise NotImplementedError(f"{name}: filter {fid} ({_FILTER_NAMES.get(fid, 'unknown')}; deflate, "
                                      f"shuffle, fletcher32, szip, n-bit, scale-offset and lzf are read)")
        filters.append((fid, vals))
    return filters


def _unfilter(raw: bytes, filters, mask: int, itemsize: int, nbytes: int, where: str = "a chunk") -> bytes:
    """Undo a chunk's filters, last applied first; bit i of ``mask`` set
    means filter i was skipped for this chunk. ``nbytes``, the decoded
    chunk's size, bounds what lzf and szip may write (a filter's output
    exceeds it by 21 bytes at most: scale-offset's header; fletcher32 adds
    4). A corrupt szip stream raises ``OSError`` naming ``where``."""
    for i in reversed(range(len(filters))):
        if mask & (1 << i):
            continue
        fid, vals = filters[i]
        if fid == FILTER_DEFLATE:
            raw = zlib.decompress(raw)
        elif fid == FILTER_SHUFFLE:
            if itemsize > 1:
                n = len(raw) // itemsize
                body = np.frombuffer(raw, np.uint8, count=n * itemsize)
                raw = body.reshape(itemsize, n).T.tobytes() + raw[n * itemsize:]
        elif fid == FILTER_FLETCHER32:
            raw = _fletcher32_checked(raw, where)
        elif fid == FILTER_LZF:
            from climate2weather_tpu_torch.data import native_blosc

            raw = native_blosc.lzf_decompress(raw, vals[2] if len(vals) > 2 and vals[2] else
                                              nbytes + 32 * len(filters))
        elif fid == FILTER_SZIP:
            from climate2weather_tpu_torch.data import native_blosc

            try:
                raw = native_blosc.szip_decompress(raw, vals, nbytes + 32 * len(filters))
            except ValueError as e:
                raise OSError(f"{where}: {e}") from None
        elif fid == FILTER_NBIT:
            raw = _nbit_decode(raw, vals)
        else:
            raw = _scaleoffset_decode(raw, vals, where)
    return raw


def fletcher32(data: bytes) -> int:
    """HDF5's Fletcher-32 (``H5_checksum_fletcher32``): big-endian 16-bit
    words summed in blocks of 360, each sum folded to 17 bits after a block,
    a last odd byte as the high byte of a word."""
    n = len(data) // 2
    words = np.frombuffer(data, ">u2", count=n).astype(np.int64)
    blocks = [words[i:i + 360] for i in range(0, n, 360)]
    if len(data) % 2:
        blocks.append(np.array([data[-1] << 8], np.int64))
    sum1 = sum2 = 0
    for w in blocks:
        # after a block: sum2 gains len * sum1 + the sums of the block's prefixes
        sum2 = (sum2 + len(w) * sum1 + int((w * np.arange(len(w), 0, -1)).sum())) & _M32
        sum1 = (sum1 + int(w.sum())) & _M32
        sum1, sum2 = (sum1 & 0xFFFF) + (sum1 >> 16), (sum2 & 0xFFFF) + (sum2 >> 16)
    sum1, sum2 = (sum1 & 0xFFFF) + (sum1 >> 16), (sum2 & 0xFFFF) + (sum2 >> 16)
    return (sum2 << 16) | sum1


def _fletcher32_checked(raw: bytes, where: str) -> bytes:
    """``raw`` without its trailing checksum, which must be the Fletcher-32
    of the rest (in either byte order: older libraries stored it swapped)."""
    body, stored = raw[:-4], _uint(raw, len(raw) - 4, 4)
    value = fletcher32(body)
    if stored not in (value, int.from_bytes(value.to_bytes(4, "little"), "big")):
        raise ChecksumError(f"{where}: fletcher32 checksum mismatch")
    return body


def _unpack_bits(raw: bytes, n: int, width: int) -> np.ndarray:
    """``n`` unsigned values of ``width`` bits packed most significant bit
    first from the start of ``raw``, as uint64. Value ``8k + j`` starts
    ``width`` bytes after value ``8(k-1) + j`` and at the same bit of its
    byte, so each phase ``j`` is a strided view of the 8 bytes from its
    start (shifted by that bit) and the 9th byte's first bits."""
    if width == 0:
        return np.zeros(n, np.uint64)
    m = -(-n // 8)
    data = np.frombuffer(raw, np.uint8, count=-(-n * width // 8))
    buf = np.zeros((m + 1) * width + 9, np.uint8)
    buf[:data.size] = data
    out = np.empty(8 * m, np.uint64)
    for j in range(8):
        start, bit = divmod(j * width, 8)
        word = np.ndarray((m,), ">u8", buf, start, (width,)).astype(np.uint64)
        ninth = np.ndarray((m,), np.uint8, buf, start + 8, (width,)).astype(np.uint64)
        out[j::8] = ((word << np.uint64(bit)) | (ninth >> np.uint64(8 - bit))) >> np.uint64(64 - width)
    return out[:n]


def _nbit_decode(raw: bytes, vals) -> bytes:
    """Undo the n-bit filter over an atomic datatype: each element's
    ``precision`` significant bits, packed, put back at its bit offset
    (``H5Z__nbit_decompress``)."""
    if vals[1]:  # the datatype uses all its bits: the chunk is stored as it is
        return raw
    if vals[3] != 1:
        raise NotImplementedError("n-bit filter over a compound or array datatype")
    n, size, order, precision, offset = vals[2], vals[4], vals[5], vals[6], vals[7]
    value = _unpack_bits(raw, n, precision) << np.uint64(offset)
    return value.astype(f"{'>' if order else '<'}u{size}").tobytes()


SO_FLOAT_DSCALE, SO_INT = 0, 2


def _scaleoffset_decode(raw: bytes, vals, where: str) -> bytes:
    """Undo the scale-offset filter (``H5Z__filter_scaleoffset``): a header
    of the bits per value and the minimum, the values' offsets from it
    packed in that many bits; integers add the minimum back, floats of the
    D-scale variant divide by 10^D and add it. A fill value, where the
    dataset defines one, is coded as the largest value of those bits."""
    scale_type, scale_factor, n, cls, size, signed, order, fill_defined = vals[:8]
    if scale_type not in (SO_FLOAT_DSCALE, SO_INT):
        raise NotImplementedError(f"{where}: scale-offset of scale type {scale_type} (E-scale)")
    minbits = _uint(raw, 0, 4)
    minval = _uint(raw, 5, min(8, raw[4]))
    utype, full = np.dtype(f"<u{size}"), np.uint64((1 << (8 * size)) - 1)
    if minbits == 8 * size:  # stored as they are, in memory order
        codes = np.frombuffer(raw, utype, count=n, offset=21).astype(np.uint64)
    else:
        codes = _unpack_bits(raw[21:], n, minbits)
    fill = b"".join(v.to_bytes(4, "little") for v in vals[8:])[:size] if fill_defined else None
    is_fill = codes == np.uint64((1 << minbits) - 1) if fill is not None and minbits < 8 * size else None
    if cls == 0:  # integers
        out = codes if minbits == 8 * size else (codes + np.uint64(minval)) & full
        out = out.astype(utype)
        if is_fill is not None:
            out[is_fill] = np.frombuffer(fill, utype)[0]
        kind = f"{'i' if signed else 'u'}{size}"
    else:  # in the element's own precision, as H5Z_scaleoffset_modify_3/4 (powf for floats)
        kind = f"f{size}"
        ftype = np.dtype(f"<f{size}")
        if minbits == 8 * size:
            out = codes.astype(utype).view(ftype)
        else:
            minimum = np.frombuffer(minval.to_bytes(8, "little")[:size], ftype)[0]
            signed_codes = codes.astype(utype).view(f"<i{size}").astype(ftype)
            out = signed_codes / ftype.type(10.0) ** ftype.type(scale_factor) + minimum
        if is_fill is not None:
            out[is_fill] = np.frombuffer(fill, ftype)[0]
    return out.view(f"<{kind}").astype(f"{'>' if order else '<'}{kind}").tobytes()


def _chunk_entries(buf: bytes, client: int, esize: int, nbytes: int) -> List[Tuple[int, int, int]]:
    """[(filter mask, stored bytes, address)] of the elements of a fixed or
    extensible array chunk index: an address (client 0), or an address, the
    filtered chunk's size and its filter mask (client 1)."""
    if client == 0:
        return [(0, nbytes, _uint(buf, i, 8)) for i in range(0, len(buf), esize)]
    if client != 1:
        raise NotImplementedError(f"array chunk index of client {client}")
    size_len = esize - 12
    return [(_uint(buf, i + 8 + size_len, 4), _uint(buf, i + 8, size_len), _uint(buf, i, 8))
            for i in range(0, len(buf), esize)]


def _parse_link(buf: bytes) -> tuple:
    """(creation order or None, name, link) of a link message: the object
    header address of a hard link, ("soft", path), ("external", file name,
    object path) or ("user", link type)."""
    if buf[0] != 1:
        raise NotImplementedError(f"link message version {buf[0]}")
    flags, pos = buf[1], 2
    ltype = 0
    if flags & 0x08:
        ltype, pos = buf[pos], pos + 1
    order = None
    if flags & 0x04:
        order, pos = _uint(buf, pos, 8), pos + 8
    if flags & 0x10:
        pos += 1  # the name's character set: ASCII or UTF-8 both decode as UTF-8
    size_len = 1 << (flags & 0x03)
    n, pos = _uint(buf, pos, size_len), pos + size_len
    name = buf[pos:pos + n].decode("utf-8")
    pos += n
    if ltype == 0:
        return order, name, _uint(buf, pos, 8)
    info = buf[pos + 2:pos + 2 + _uint(buf, pos, 2)]
    if ltype == 1:
        return order, name, ("soft", info.decode("utf-8"))
    if ltype == 64:  # a version and flags byte, then the file name and the object path
        file_name, path, _ = info[1:].split(b"\0", 2)
        return order, name, ("external", file_name.decode("utf-8"), path.decode("utf-8"))
    return order, name, ("user", ltype)


class _FractalHeap:
    """A fractal heap (``FRHP``): its objects by heap ID. Managed objects
    sit in direct blocks (``FHDB``) reached through a tree of indirect
    blocks (``FHIB``), a doubling table of ``width`` blocks a row; tiny
    objects sit in the ID itself; unfiltered huge objects are found through
    a version-2 B-tree of record type 1."""

    def __init__(self, f: "File", addr: int):
        self.file = f
        head = f._checked(addr, 146, b"FRHP", "fractal heap header")
        if head[4] != 0:
            raise NotImplementedError(f"fractal heap version {head[4]}")
        if _uint(head, 7, 2):
            raise NotImplementedError("filtered fractal heap (I/O filters on its blocks)")
        self.id_len, self.flags = _uint(head, 5, 2), head[9]
        self.max_man = _uint(head, 10, 4)
        self.huge_btree = _uint(head, 22, 8)
        self.width, self.start = _uint(head, 110, 2), _uint(head, 112, 8)
        self.max_direct, max_bits = _uint(head, 120, 8), _uint(head, 128, 2)
        root, root_rows = _uint(head, 132, 8), _uint(head, 140, 2)
        self.off_size = (max_bits + 7) // 8
        self.len_size = min((self.max_direct.bit_length() - 1 + 7) // 8, _limit_enc_size(self.max_man))
        self.max_direct_rows = (self.max_direct.bit_length() - self.start.bit_length()) + 2
        self.blocks: List[Tuple[int, int, int]] = []  # (heap offset, size, address) of each direct block
        self._cache: Dict[int, bytes] = {}
        self._huge: Optional[Dict[int, Tuple[int, int]]] = None
        if root == UNDEF:
            return
        if root_rows == 0:
            self.blocks.append((0, self.start, root))
        else:
            self._indirect(root, root_rows, 0)
        self.blocks.sort()

    def _row_size(self, r: int) -> int:
        return self.start if r == 0 else self.start << (r - 1)

    def _row_offset(self, r: int) -> int:
        return 0 if r == 0 else (self.start * self.width) << (r - 1)

    def _indirect(self, addr: int, nrows: int, offset: int) -> None:
        n_direct = min(nrows, self.max_direct_rows)
        entries = nrows * self.width
        size = 4 + 1 + 8 + self.off_size + 8 * entries + 4
        buf = self.file._checked(addr, size, b"FHIB", "fractal heap indirect block")
        if _uint(buf, 13, self.off_size) != offset:
            raise OSError(f"{self.file.filename}: fractal heap indirect block at {addr} has offset "
                          f"{_uint(buf, 13, self.off_size)}, expected {offset}")
        pos = 13 + self.off_size
        for r in range(nrows):
            for c in range(self.width):
                child = _uint(buf, pos, 8)
                pos += 8
                if child == UNDEF:
                    continue
                at = offset + self._row_offset(r) + c * self._row_size(r)
                if r < n_direct:
                    self.blocks.append((at, self._row_size(r), child))
                else:  # an indirect block spanning this entry's share of the heap
                    rows = (self._row_size(r).bit_length() - 1) - (self.start.bit_length() - 1) \
                        - (self.width.bit_length() - 1) + 1
                    self._indirect(child, rows, at)

    def _direct(self, offset: int, size: int, addr: int) -> bytes:
        if addr not in self._cache:
            buf = bytearray(self.file._src.read(addr, size))
            if buf[:4] != b"FHDB":
                raise OSError(f"{self.file.filename}: no fractal heap direct block at {addr}")
            if self.flags & 0x02:  # checksummed, over the block with the checksum zeroed
                at = 13 + self.off_size
                stored = _uint(buf, at, 4)
                buf[at:at + 4] = b"\0\0\0\0"
                if lookup3(bytes(buf)) != stored:
                    raise ChecksumError(f"{self.file.filename}: checksum mismatch in the fractal heap "
                                        f"direct block at {addr}")
            if _uint(buf, 13, self.off_size) != offset:
                raise OSError(f"{self.file.filename}: fractal heap direct block at {addr} has offset "
                              f"{_uint(buf, 13, self.off_size)}, expected {offset}")
            self._cache[addr] = bytes(buf)
        return self._cache[addr]

    def get(self, hid: bytes) -> bytes:
        """The object of heap ID ``hid``."""
        if hid[0] >> 6 != 0:
            raise NotImplementedError(f"fractal heap ID version {hid[0] >> 6}")
        kind = (hid[0] >> 4) & 0x03
        if kind == 0:  # managed: offset and length in the heap's space
            off = _uint(hid, 1, self.off_size)
            n = _uint(hid, 1 + self.off_size, self.len_size)
            for start, size, addr in self.blocks:
                if start <= off < start + size:
                    block = self._direct(start, size, addr)
                    return block[off - start:off - start + n]
            raise OSError(f"{self.file.filename}: fractal heap object at offset {off} is in no block")
        if kind == 2:  # tiny: the object is in the ID
            if self.id_len <= 18:
                n = (hid[0] & 0x0F) + 1
                return hid[1:1 + n]
            n = ((hid[0] & 0x0F) << 8 | hid[1]) + 1
            return hid[2:2 + n]
        if kind == 1:  # huge, unfiltered
            if self.id_len - 1 >= 16:  # the address and length are in the ID
                return self.file._src.read(_uint(hid, 1, 8), _uint(hid, 9, 8))
            if self._huge is None:
                self._huge = {}
                for rec in self.file._btree2_records(self.huge_btree, BT2_HUGE):
                    self._huge[_uint(rec, 16, 8)] = (_uint(rec, 0, 8), _uint(rec, 8, 8))
            addr, n = self._huge[_uint(hid, 1, min(self.id_len - 1, 8))]
            return self.file._src.read(addr, n)
        raise NotImplementedError(f"fractal heap object of type {kind}")


class File(Group):
    """An HDF5 file opened for reading; the root :class:`Group`. Use as a
    context manager or call :meth:`close`."""

    def __init__(self, path, mode: str = "r"):
        if mode != "r":
            raise ValueError("File opens for reading only; write with Writer")
        self._src = _Source(path)
        self.filename = self._src.path
        self._dir = os.path.dirname(os.path.abspath(self.filename))  # where external names resolve
        self._heaps: Dict[int, "_FractalHeap"] = {}
        self._externals: Dict[str, "File"] = {}
        self._committed: Dict[int, bytes] = {}
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
            return self._read_superblock_v2(base, head)
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

    def _read_superblock_v2(self, base: int, head: bytes) -> int:
        """Superblock version 2 or 3 (HDF5 1.8 and later): the root group's
        object header address; a superblock extension holding a shared
        message table raises."""
        if head[9] != 8 or head[10] != 8:
            raise NotImplementedError(f"offsets of {head[9]} and lengths of {head[10]} bytes")
        sb = self._checked(base, 48, SIGNATURE, f"superblock version {head[8]}")
        if _uint(sb, 12, 8) != 0:
            raise NotImplementedError("superblock base address other than 0")
        extension = _uint(sb, 20, 8)
        if extension != UNDEF and _Object(self, extension).find(MSG_SHARED_TABLE) is not None:
            raise NotImplementedError("shared object header messages (a shared message table)")
        return _uint(sb, 36, 8)

    def _checked(self, addr: int, size: int, signature: bytes, what: str) -> bytes:
        """``size`` bytes at ``addr`` that start with ``signature`` and end
        with the lookup3 checksum of the rest."""
        buf = self._src.read(addr, size)
        if buf[:len(signature)] != signature:
            raise OSError(f"{self.filename}: no {what} at {addr} (signature {buf[:len(signature)]!r})")
        if lookup3(buf[:-4]) != _uint(buf, size - 4, 4):
            raise ChecksumError(f"{self.filename}: checksum mismatch in the {what} at {addr}")
        return buf

    def _open(self, addr: int, name: str):
        obj = _Object(self, addr)
        if obj.find(MSG_SYMBOL_TABLE) is not None or obj.find(MSG_LINK_INFO) is not None:
            return Group(self, obj, name)
        if obj.find(MSG_DATATYPE) is not None and obj.find(MSG_LAYOUT) is None:
            return Datatype(self, obj, name)
        return Dataset(self, obj, name)

    def _resolve(self, group: Group, path: str, depth: int):
        """The object at ``path`` from ``group`` (from this file's root
        where the path is absolute)."""
        obj = self if path.startswith("/") else group
        for part in path.split("/"):
            if part in ("", "."):
                continue
            if not isinstance(obj, Group):
                raise KeyError(f"{obj.name} is not a group (looking up {path!r})")
            obj = obj._follow(part, depth)
        return obj

    def _external_file(self, name: str, prefix_variable: str) -> Optional["File"]:
        """The file an external link or a virtual dataset's mapping names,
        found as HDF5 finds it (``H5F_prefix_open_file``): an absolute name
        as it is, else its base name; then under each directory of the
        colon-separated list in the environment variable ``prefix_variable``;
        then in this file's directory; then from the working directory.
        None where no candidate opens."""
        candidates = []
        if os.path.isabs(name):
            candidates.append(name)
            name = os.path.basename(name)
        for prefix in filter(None, os.environ.get(prefix_variable, "").split(":")):
            candidates.append(os.path.join(prefix, name))
        candidates += [os.path.join(self._dir, name), name]
        for path in candidates:
            key = os.path.realpath(path)
            if key == os.path.realpath(self.filename):
                return self
            if key not in self._externals and os.path.isfile(path):
                try:
                    self._externals[key] = File(path)
                except (OSError, NotImplementedError):
                    continue
            if key in self._externals:
                return self._externals[key]
        return None

    def _shared_datatype(self, body: bytes) -> bytes:
        """The datatype message of the committed datatype that a shared
        datatype message (of a dataset or an attribute) points at."""
        version, kind = body[0], body[1]
        if version == 1:
            addr = _uint(body, 16, 8)  # after 6 reserved bytes and a local heap offset
        elif version == 2 or version == 3 and kind == 2:
            addr = _uint(body, 2, 8)
        elif version == 3 and kind == 1:
            raise NotImplementedError("shared datatype in a shared message table")
        else:
            raise NotImplementedError(f"shared message version {version} of type {kind}")
        if addr not in self._committed:
            msg = _Object(self, addr).find(MSG_DATATYPE)
            if msg is None:
                raise OSError(f"{self.filename}: no committed datatype at {addr}")
            self._committed[addr] = msg
        return self._committed[addr]

    # -- new-style groups and dense attributes -----------------------------------
    def _read_links(self, messages: List[bytes], linfo: Optional[bytes], name: str) -> Dict[str, object]:
        """{name: link (see :func:`_parse_link`)} of a new-style group: its link
        messages, or those in its fractal heap (dense storage), in creation
        order where the group tracks it."""
        if linfo is not None:
            if linfo[0] != 0:
                raise NotImplementedError(f"link info message version {linfo[0]}")
            flags = linfo[1]
            pos = 2 + (8 if flags & 0x01 else 0)
            heap, by_name = _uint(linfo, pos, 8), _uint(linfo, pos + 8, 8)
            by_order = _uint(linfo, pos + 16, 8) if flags & 0x02 else UNDEF
            if heap != UNDEF:
                messages = self._dense_objects(heap, by_name, by_order, BT2_LINK_NAME, BT2_LINK_ORDER)
        links = [_parse_link(m) for m in messages]
        links.sort(key=lambda link: (link[0] is None, link[0] or 0, link[1]))
        return {n: link for _, n, link in links}

    def _dense_attributes(self, info: bytes) -> List[bytes]:
        """The attribute messages of an attribute info message's dense
        storage (none where the attributes are compact)."""
        if info[0] != 0:
            raise NotImplementedError(f"attribute info message version {info[0]}")
        flags = info[1]
        pos = 2 + (2 if flags & 0x01 else 0)
        heap, by_name = _uint(info, pos, 8), _uint(info, pos + 8, 8)
        by_order = _uint(info, pos + 16, 8) if flags & 0x02 else UNDEF
        if heap == UNDEF:
            return []
        return self._dense_objects(heap, by_name, by_order, BT2_ATTR_NAME, BT2_ATTR_ORDER)

    def _dense_objects(self, heap: int, by_name: int, by_order: int, name_type: int,
                       order_type: int) -> List[bytes]:
        """The fractal heap's objects that its version-2 B-trees index: in
        creation order where that index exists (it must list the objects
        the name index lists), else in the name index's order."""
        if heap not in self._heaps:
            self._heaps[heap] = _FractalHeap(self, heap)
        ids = self._heap_ids(by_name, name_type)
        if by_order != UNDEF:
            ordered = self._heap_ids(by_order, order_type)
            if sorted(ordered) != sorted(ids):
                raise OSError(f"{self.filename}: the name and creation-order indexes of the fractal heap at "
                              f"{heap} disagree")
            ids = ordered
        return [self._heaps[heap].get(hid) for hid in ids]

    def _heap_ids(self, btree: int, rtype: int) -> List[bytes]:
        """The heap IDs in the records of a link (types 5, 6) or attribute
        (types 8, 9) index."""
        out = []
        for rec in self._btree2_records(btree, rtype):
            if rtype == BT2_LINK_NAME:  # hash, heap ID
                out.append(rec[4:])
            elif rtype == BT2_LINK_ORDER:  # creation order, heap ID
                out.append(rec[8:])
            else:  # heap ID (8), message flags, creation order [, hash]
                if rec[8] & 0x02:
                    raise NotImplementedError("shared attribute message in dense storage")
                out.append(rec[:8])
        return out

    # -- version-2 B-trees --------------------------------------------------------
    def _btree2_records(self, addr: int, rtype: int) -> List[bytes]:
        """Every record of the version-2 B-tree at ``addr``, in key order;
        the tree must hold records of type ``rtype``."""
        head = self._checked(addr, 38, b"BTHD", "version-2 B-tree header")
        if head[4] != 0:
            raise NotImplementedError(f"version-2 B-tree header version {head[4]}")
        if head[5] != rtype:
            raise OSError(f"{self.filename}: version-2 B-tree of record type {head[5]} at {addr}, "
                          f"expected {rtype}")
        node_size, rsize, depth = _uint(head, 6, 4), _uint(head, 10, 2), _uint(head, 12, 2)
        root, root_n = _uint(head, 16, 8), _uint(head, 24, 2)
        # per depth: (pointer bytes of a child below, its count bytes, its total-count bytes)
        leaf_max = (node_size - 10) // rsize
        n_size = _limit_enc_size(leaf_max)
        cum, cum_size, ptr = [leaf_max], [0], [0]
        for d in range(1, depth + 1):
            ptr.append(8 + n_size + (cum_size[d - 1] if d > 1 else 0))
            max_n = (node_size - 10 - ptr[d]) // (rsize + ptr[d])
            cum.append((max_n + 1) * cum[d - 1] + max_n)
            cum_size.append(_limit_enc_size(cum[d]))
        out: List[bytes] = []

        def walk(node: int, d: int, n: int) -> None:
            if node == UNDEF or n == 0 and d == 0:
                return
            sig = b"BTLF" if d == 0 else b"BTIN"
            size = 6 + n * rsize + ((n + 1) * ptr[d] if d else 0) + 4
            buf = self._checked(node, size, sig, "version-2 B-tree node")
            if buf[5] != rtype:
                raise OSError(f"{self.filename}: version-2 B-tree node of record type {buf[5]} at {node}")
            records = [buf[6 + i * rsize:6 + (i + 1) * rsize] for i in range(n)]
            if d == 0:
                out.extend(records)
                return
            pos = 6 + n * rsize
            for i in range(n + 1):
                child, child_n = _uint(buf, pos, 8), _uint(buf, pos + 8, n_size)
                pos += ptr[d]
                walk(child, d - 1, child_n)
                if i < n:
                    out.append(records[i])

        walk(root, depth, root_n)
        return out

    # -- virtual datasets --------------------------------------------------------
    def _virtual_mappings(self, collection: int, index: int, name: str) -> list:
        """[(source file, source dataset, source selection, virtual
        selection)] of a virtual dataset's global heap object (encoding
        version 0, under a lookup3 checksum), the names as stored, printf
        specifiers and all (:meth:`Dataset._expand_mappings` resolves them)."""
        raw = self._global_heap_object(collection, index)
        if raw[0] != 0:
            raise NotImplementedError(f"{name}: virtual dataset mappings of encoding version {raw[0]}")
        if lookup3(raw[:-4]) != _uint(raw, len(raw) - 4, 4):
            raise ChecksumError(f"{self.filename}: checksum mismatch in the mappings of the virtual dataset {name}")
        n, pos, out = _uint(raw, 1, 8), 9, []
        for _ in range(n):
            names = []
            for _ in range(2):
                text, pos = _name_at(raw, pos, False)
                names.append(text.decode("utf-8"))
            src_sel, pos = _parse_selection(raw, pos, f"{name}: the source selection of {names[0]}:{names[1]}")
            virt_sel, pos = _parse_selection(raw, pos, f"{name}: the virtual selection of {names[0]}:{names[1]}")
            out.append((names[0], names[1], src_sel, virt_sel))
        return out

    # -- chunk indexes of layout version 4 ----------------------------------------
    def _fixed_array(self, addr: int, nbytes: int) -> List[Tuple[int, int, int]]:
        """[(filter mask, stored bytes, address)] of a fixed-array chunk
        index, one entry per chunk of the grid."""
        head = self._checked(addr, 28, b"FAHD", "fixed array header")
        client, esize, page_bits = head[5], head[6], head[7]
        n, dblock = _uint(head, 8, 8), _uint(head, 16, 8)
        if dblock == UNDEF:
            return []
        page = 1 << page_bits
        if n <= page:
            buf = self._checked(dblock, 14 + n * esize + 4, b"FADB", "fixed array data block")
            return _chunk_entries(buf[14:14 + n * esize], client, esize, nbytes)
        npages = -(-n // page)
        prefix = 14 + (npages + 7) // 8 + 4
        bitmap = self._checked(dblock, prefix, b"FADB", "fixed array data block")[14:prefix - 4]
        out, pos = [], dblock + prefix
        for p in range(npages):
            count = min(page, n - p * page)
            if bitmap[p // 8] & (0x80 >> (p % 8)):
                buf = self._checked(pos, count * esize + 4, b"", "fixed array data block page")
                out += _chunk_entries(buf[:-4], client, esize, nbytes)
            else:
                out += [(0, 0, UNDEF)] * count
            pos += count * esize + 4
        return out

    def _extensible_array(self, addr: int, nbytes: int) -> List[Tuple[int, int, int]]:
        """[(filter mask, stored bytes, address)] of an extensible-array
        chunk index, in element order up to the largest index set."""
        head = self._checked(addr, 72, b"EAHD", "extensible array header")
        client, esize, max_bits, iblk_n, dblk_min, sblk_min, page_bits = head[5:12]
        max_idx, iblock = _uint(head, 44, 8), _uint(head, 60, 8)
        if iblock == UNDEF or max_idx == 0:
            return []
        off_size = (max_bits + 7) // 8
        nsblks = 1 + max_bits - (dblk_min.bit_length() - 1)
        # super block u: 2^(u // 2) data blocks of dblk_min * 2^((u + 1) // 2) elements
        sblks = [(1 << (u // 2), dblk_min << ((u + 1) // 2)) for u in range(nsblks)]
        i_sblks = 2 * (sblk_min.bit_length() - 1)  # those whose data blocks the index block lists
        n_dblk_addrs, n_sblk_addrs = 2 * (sblk_min - 1), nsblks - i_sblks
        size = 14 + iblk_n * esize + 8 * (n_dblk_addrs + n_sblk_addrs) + 4
        buf = self._checked(iblock, size, b"EAIB", "extensible array index block")
        out = _chunk_entries(buf[14:14 + iblk_n * esize], client, esize, nbytes)
        pos = 14 + iblk_n * esize
        dblk_addrs = [_uint(buf, pos + 8 * i, 8) for i in range(n_dblk_addrs)]
        sblk_addrs = [_uint(buf, pos + 8 * (n_dblk_addrs + i), 8) for i in range(n_sblk_addrs)]
        page = 1 << page_bits

        def data_block(daddr: int, count: int, bitmap: Optional[bytes] = None, bit: int = 0) -> list:
            """A data block's entries; a paged one's pages are set where
            their bits (from ``bit`` on, in the super block's bitmap) are."""
            if daddr == UNDEF:
                return [(0, 0, UNDEF)] * count
            if bitmap is None:
                blk = self._checked(daddr, 14 + off_size + count * esize + 4, b"EADB",
                                    "extensible array data block")
                return _chunk_entries(blk[14 + off_size:-4], client, esize, nbytes)
            self._checked(daddr, 14 + off_size + 4, b"EADB", "extensible array data block")
            entries, at = [], daddr + 14 + off_size + 4
            for p in range(bit, bit + count // page):
                if bitmap[p // 8] & (0x80 >> (p % 8)):
                    blk = self._checked(at, page * esize + 4, b"", "extensible array data block page")
                    entries += _chunk_entries(blk[:-4], client, esize, nbytes)
                else:
                    entries += [(0, 0, UNDEF)] * page
                at += page * esize + 4
            return entries

        d = 0
        for u, (ndblks, count) in enumerate(sblks):
            if len(out) >= max_idx:
                break
            if u < i_sblks:
                for _ in range(ndblks):
                    out += data_block(dblk_addrs[d], count)
                    d += 1
                continue
            saddr = sblk_addrs[u - i_sblks]
            if saddr == UNDEF:
                out += [(0, 0, UNDEF)] * (ndblks * count)
                continue
            npages = count // page if count > page else 0
            bitmap_len = ndblks * ((npages + 7) // 8)
            sb = self._checked(saddr, 14 + off_size + bitmap_len + 8 * ndblks + 4, b"EASB",
                               "extensible array super block")
            at = 14 + off_size
            bitmap = sb[at:at + bitmap_len] if npages else None
            at += bitmap_len
            for i in range(ndblks):  # the bits of data block i start at i * npages
                out += data_block(_uint(sb, at + 8 * i, 8), count, bitmap, i * npages)
        return out[:max_idx]

    # -- groups ----------------------------------------------------------------
    def _local_heap_data(self, addr: int) -> bytes:
        head = self._src.read(addr, 32)
        if head[:4] != b"HEAP":
            raise OSError(f"no local heap at {addr}")
        return self._src.read(_uint(head, 24, 8), _uint(head, 8, 8))

    def _read_symbol_table(self, btree: int, heap: int) -> Dict[str, object]:
        """{name: link} of an old-style group: an object header address, or
        ("soft", path) for an entry of cache type 2 (its scratch pad holds
        the path's offset in the group's local heap)."""
        names = self._local_heap_data(heap)

        def text(off: int) -> str:
            return names[off:names.index(b"\0", off)].decode("utf-8")

        members: Dict[str, object] = {}
        for snod in self._btree_children(btree, node_type=0, rank=0):
            head = self._src.read(snod, 8)
            if head[:4] != b"SNOD":
                raise OSError(f"no symbol table node at {snod}")
            n = _uint(head, 6, 2)
            entries = self._src.read(snod + 8, 40 * n)
            for i in range(n):
                e = entries[40 * i:40 * (i + 1)]
                soft = _uint(e, 16, 4) == 2
                members[text(_uint(e, 0, 8))] = ("soft", text(_uint(e, 24, 4))) if soft else _uint(e, 8, 8)
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
            if buf[1] & 0x02:
                raise NotImplementedError("attribute of a shared dataspace")
            pad = lambda n: n  # noqa: E731
            pos = 8 if version == 2 else 9  # version 3 adds the name's character set
        else:
            raise NotImplementedError(f"attribute message version {version}")
        name = buf[pos:pos + name_size].split(b"\0", 1)[0].decode("utf-8")
        pos += pad(name_size)
        tpos = pos
        pos += pad(type_size)
        shape, _ = _parse_dataspace(buf, pos)
        pos += pad(space_size)
        type_buf, tpos = (self._shared_datatype(buf[tpos:tpos + type_size]), 0) if version > 1 and buf[1] & 0x01 \
            else (buf, tpos)
        try:
            dtype, _ = _parse_datatype(type_buf, tpos)
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
        elif dtype.kind == "compound":  # h5py keeps the members' byte order
            arr = _members_only(np.frombuffer(data, dtype.dtype, count=count).reshape(shape))
        else:
            arr = np.frombuffer(data, dtype.dtype, count=count).astype(
                dtype.dtype.newbyteorder("=")).reshape(shape)
        if arr.ndim == 0:
            value = arr[()]
            return name, value if dtype.kind != "vlen_str" else str(value)
        return name, arr

    def close(self) -> None:
        for other in self._externals.values():
            other.close()
        self._src.close()

    def __enter__(self) -> "File":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def open_file(path):
    """An HDF5 file opened for reading by :class:`File`; where it raises
    ``NotImplementedError`` (a shared-message table, say) and
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
