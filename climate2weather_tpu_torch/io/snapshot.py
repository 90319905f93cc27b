"""Inference snapshots, read with the standard library and numpy only.

A snapshot directory (written by climate2weather_tpu/training/checkpoint.py
``save_snapshot``) holds ``params.msgpack``, flax's msgpack encoding of the
parameter tree, and ``config.yaml``. :func:`load_snapshot` is the counterpart
of the JAX package's ``load_snapshot``: it returns the tree as float32 numpy
arrays and the config as the dict ``yaml.safe_load`` would give.

Two small readers carry this, so the port needs neither ``msgpack`` nor
PyYAML:

- :func:`msgpack_loads` decodes maps, arrays, strings, binaries, scalars and
  flax's array extension (code 1: a msgpack triple ``(shape, dtype name,
  C-order bytes)``) for float16, float32 and bfloat16;
- :func:`yaml_loads` reads the YAML the repository's configs use: ``#``
  comments, nested block maps, ``- item`` lists, ``[a, b]`` flow lists of
  scalars, and plain or simply quoted scalars resolved as YAML 1.1 does
  (``1e-3`` without a dot stays a string, ``yes`` is true,
  ``2014-04-07-04`` is a string). Anything else raises.

Their writers, :func:`msgpack_dumps` (the bytes flax's ``to_bytes`` writes
for the same tree) and :func:`yaml_dump` (block YAML of the same subset,
keys sorted as PyYAML's ``safe_dump`` sorts them), write the training
checkpoints and snapshots in the JAX package's formats.
"""

from __future__ import annotations

import os
import re
import struct
from typing import Any

import numpy as np

# --------------------------------------------------------------------------
# msgpack

# flax's extension codes (flax/serialization.py _MsgpackExtType)
_EXT_NDARRAY, _EXT_NPSCALAR = 1, 3
_ARRAY_DTYPES = ("float16", "float32", "float64", "int8", "int16", "int32", "int64",
                 "uint8", "uint16", "uint32", "uint64", "bool")


class _MsgpackReader:
    def __init__(self, data: bytes):
        self.buf = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.buf):
            raise ValueError("msgpack: truncated input")
        out = self.buf[self.pos : self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def value(self) -> Any:
        b = self.unpack(">B")
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return self.array(b & 0x0F)
        if 0xA0 <= b <= 0xBF:
            return self.str(b & 0x1F)
        fixed = {
            0xC0: lambda: None, 0xC2: lambda: False, 0xC3: lambda: True,
            0xC4: lambda: bytes(self.take(self.unpack(">B"))),
            0xC5: lambda: bytes(self.take(self.unpack(">H"))),
            0xC6: lambda: bytes(self.take(self.unpack(">I"))),
            0xC7: lambda: self.ext(self.unpack(">B")),
            0xC8: lambda: self.ext(self.unpack(">H")),
            0xC9: lambda: self.ext(self.unpack(">I")),
            0xCA: lambda: self.unpack(">f"), 0xCB: lambda: self.unpack(">d"),
            0xCC: lambda: self.unpack(">B"), 0xCD: lambda: self.unpack(">H"),
            0xCE: lambda: self.unpack(">I"), 0xCF: lambda: self.unpack(">Q"),
            0xD0: lambda: self.unpack(">b"), 0xD1: lambda: self.unpack(">h"),
            0xD2: lambda: self.unpack(">i"), 0xD3: lambda: self.unpack(">q"),
            0xD4: lambda: self.ext(1), 0xD5: lambda: self.ext(2),
            0xD6: lambda: self.ext(4), 0xD7: lambda: self.ext(8),
            0xD8: lambda: self.ext(16),
            0xD9: lambda: self.str(self.unpack(">B")),
            0xDA: lambda: self.str(self.unpack(">H")),
            0xDB: lambda: self.str(self.unpack(">I")),
            0xDC: lambda: self.array(self.unpack(">H")),
            0xDD: lambda: self.array(self.unpack(">I")),
            0xDE: lambda: self.map(self.unpack(">H")),
            0xDF: lambda: self.map(self.unpack(">I")),
        }
        if b not in fixed:
            raise ValueError(f"msgpack: unsupported type byte 0x{b:02x}")
        return fixed[b]()

    def str(self, n: int) -> str:
        return bytes(self.take(n)).decode("utf-8")

    def array(self, n: int) -> list:
        return [self.value() for _ in range(n)]

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.value()
            out[key] = self.value()
        return out

    def ext(self, n: int) -> np.ndarray:
        code = self.unpack(">b")
        payload = self.take(n)
        if code == _EXT_NDARRAY:
            return _flax_ndarray(payload)
        if code == _EXT_NPSCALAR:
            return _flax_ndarray(payload)[()]
        raise ValueError(f"msgpack: unsupported extension code {code}")


def _flax_ndarray(payload: memoryview) -> np.ndarray:
    inner = _MsgpackReader(payload)
    triple = inner.value()
    if inner.pos != len(payload) or not (isinstance(triple, list) and len(triple) == 3):
        raise ValueError("msgpack: malformed flax array record")
    shape, dtype_name, raw = triple
    if isinstance(dtype_name, bytes):
        dtype_name = dtype_name.decode()
    shape = tuple(int(s) for s in shape)
    if dtype_name in _ARRAY_DTYPES:
        arr = np.frombuffer(raw, dtype=np.dtype(dtype_name))
    elif dtype_name == "bfloat16":
        # bf16 is the upper half of an fp32: widen by a 16-bit shift
        arr = (np.frombuffer(raw, dtype="<u2").astype(np.uint32) << 16).view(np.float32)
    else:
        raise ValueError(f"msgpack: unsupported array dtype {dtype_name!r}")
    if arr.size != int(np.prod(shape, dtype=np.int64)):
        raise ValueError(f"msgpack: {arr.size} values for shape {shape}")
    return arr.reshape(shape)


def msgpack_loads(data: bytes) -> Any:
    """Decode one msgpack object (flax's layout); raises on trailing bytes."""
    reader = _MsgpackReader(data)
    out = reader.value()
    if reader.pos != len(data):
        raise ValueError("msgpack: trailing bytes after the top-level object")
    return out


def _pack_length(out: bytearray, n: int, fix, fixmax: int, codes) -> None:
    """Header of a str/bin/array/map/ext of length n: the shortest form, as
    msgpack-python's packer chooses it."""
    if fix is not None and n <= fixmax:
        out.append(fix | n)
        return
    for code, fmt in codes:
        if n < 1 << (8 * struct.calcsize(fmt)):
            out += struct.pack(">B" + fmt[1:], code, n)
            return
    raise ValueError(f"msgpack: object of length {n} too long")


def _pack_int(out: bytearray, v: int) -> None:
    if 0 <= v < 0x80:
        out.append(v)
    elif -0x20 <= v < 0:
        out += struct.pack(">b", v)
    elif v >= 0:
        for code, fmt, top in ((0xCC, ">B", 0xFF), (0xCD, ">H", 0xFFFF),
                               (0xCE, ">I", 0xFFFFFFFF), (0xCF, ">Q", (1 << 64) - 1)):
            if v <= top:
                out.append(code)
                out += struct.pack(fmt, v)
                return
        raise ValueError(f"msgpack: int {v} out of range")
    else:
        for code, fmt, low in ((0xD0, ">b", -0x80), (0xD1, ">h", -0x8000),
                               (0xD2, ">i", -0x80000000), (0xD3, ">q", -(1 << 63))):
            if v >= low:
                out.append(code)
                out += struct.pack(fmt, v)
                return
        raise ValueError(f"msgpack: int {v} out of range")


def _pack_ext(out: bytearray, code: int, payload: bytes) -> None:
    fixext = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if len(payload) in fixext:
        out.append(fixext[len(payload)])
    else:
        _pack_length(out, len(payload), None, 0, ((0xC7, ">B"), (0xC8, ">H"), (0xC9, ">I")))
    out += struct.pack(">b", code)
    out += payload


def _ndarray_payload(arr: np.ndarray) -> bytes:
    if arr.dtype.name not in _ARRAY_DTYPES:
        raise ValueError(f"msgpack: unsupported array dtype {arr.dtype}")
    return msgpack_dumps([list(arr.shape), arr.dtype.name, arr.tobytes("C")])


def _pack(out: bytearray, obj: Any) -> None:
    if obj is None:
        out.append(0xC0)
    elif obj is True or obj is False:
        out.append(0xC3 if obj else 0xC2)
    elif type(obj) is int:
        _pack_int(out, obj)
    elif type(obj) is float:
        out.append(0xCB)
        out += struct.pack(">d", obj)
    elif type(obj) is str:
        raw = obj.encode("utf-8")
        _pack_length(out, len(raw), 0xA0, 31, ((0xD9, ">B"), (0xDA, ">H"), (0xDB, ">I")))
        out += raw
    elif type(obj) is bytes:
        _pack_length(out, len(obj), None, 0, ((0xC4, ">B"), (0xC5, ">H"), (0xC6, ">I")))
        out += obj
    elif type(obj) in (list, tuple):
        _pack_length(out, len(obj), 0x90, 15, ((0xDC, ">H"), (0xDD, ">I")))
        for item in obj:
            _pack(out, item)
    elif isinstance(obj, dict):
        _pack_length(out, len(obj), 0x80, 15, ((0xDE, ">H"), (0xDF, ">I")))
        for key, val in obj.items():
            _pack(out, key)
            _pack(out, val)
    elif isinstance(obj, np.ndarray):
        _pack_ext(out, _EXT_NDARRAY, _ndarray_payload(obj))
    elif isinstance(obj, np.generic):
        _pack_ext(out, _EXT_NPSCALAR, _ndarray_payload(np.asarray(obj)))
    else:
        raise TypeError(f"msgpack: cannot pack {type(obj).__name__}")


def msgpack_dumps(obj: Any) -> bytes:
    """Encode nested dicts, lists, scalars and numpy arrays as flax's
    ``msgpack_serialize`` does: an array is extension 1 holding the msgpack
    triple ``(shape, dtype name, C-order bytes)``, a numpy scalar extension
    3. Arrays above flax's 1 GiB chunking limit are not supported."""
    out = bytearray()
    _pack(out, obj)
    return bytes(out)


# --------------------------------------------------------------------------
# YAML subset

_BOOL = {
    **dict.fromkeys(("yes", "Yes", "YES", "true", "True", "TRUE", "on", "On", "ON"), True),
    **dict.fromkeys(("no", "No", "NO", "false", "False", "FALSE", "off", "Off", "OFF"), False),
}
_NULL = ("~", "null", "Null", "NULL", "")
# PyYAML's YAML 1.1 implicit resolvers (yaml/resolver.py)
_INT = re.compile(
    r"^(?:[-+]?0b[0-1_]+|[-+]?0[0-7_]+|[-+]?(?:0|[1-9][0-9_]*)"
    r"|[-+]?0x[0-9a-fA-F_]+|[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+)$"
)
_FLOAT = re.compile(
    r"^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?"
    r"|\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?"
    r"|[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*"
    r"|[-+]?\.(?:inf|Inf|INF)|\.(?:nan|NaN|NAN))$"
)
_TIMESTAMP = re.compile(
    r"^(?:[0-9][0-9][0-9][0-9]-[0-9][0-9]-[0-9][0-9]"
    r"|[0-9][0-9][0-9][0-9]-[0-9][0-9]?-[0-9][0-9]?"
    r"(?:[Tt]|[ \t]+)[0-9][0-9]?:[0-9][0-9]:[0-9][0-9](?:\.[0-9]*)?"
    r"(?:[ \t]*(?:Z|[-+][0-9][0-9]?(?::[0-9][0-9])?))?)$"
)


def _yaml_error(lineno: int, msg: str) -> ValueError:
    return ValueError(f"yaml subset, line {lineno}: {msg}")


def _scalar(text: str, lineno: int) -> Any:
    text = text.strip()
    if text[:1] in ("'", '"'):
        q = text[0]
        if len(text) < 2 or text[-1] != q:
            raise _yaml_error(lineno, f"unterminated quoted scalar {text!r}")
        body = text[1:-1]
        if q == "'":
            if re.search(r"(?<!')'(?!')", body):
                raise _yaml_error(lineno, f"stray quote in {text!r}")
            return body.replace("''", "'")
        if "\\" in body or '"' in body:
            raise _yaml_error(lineno, f"escapes are not supported: {text!r}")
        return body
    if text[:1] in ("&", "*", "!", "|", ">", "{", "%", "@", "`"):
        raise _yaml_error(lineno, f"unsupported YAML construct {text!r}")
    if text in _NULL:
        return None
    if text in _BOOL:
        return _BOOL[text]
    if _INT.match(text):
        if ":" in text:
            raise _yaml_error(lineno, f"sexagesimal int {text!r} is not supported")
        v = text.replace("_", "")
        sign = -1 if v[0] == "-" else 1
        v = v.lstrip("+-")
        if v == "0":
            return 0
        if v.startswith("0b"):
            return sign * int(v[2:], 2)
        if v.startswith("0x"):
            return sign * int(v[2:], 16)
        if v[0] == "0":
            return sign * int(v, 8)
        return sign * int(v)
    if _FLOAT.match(text):
        if ":" in text:
            raise _yaml_error(lineno, f"sexagesimal float {text!r} is not supported")
        v = text.replace("_", "").lower()
        if v.endswith(".inf"):
            return float("-inf") if v[0] == "-" else float("inf")
        if v.endswith(".nan"):
            return float("nan")
        return float(v)
    if _TIMESTAMP.match(text):
        raise _yaml_error(lineno, f"timestamps are not supported: {text!r}")
    return text


def _value(text: str, lineno: int) -> Any:
    text = text.strip()
    if text == "{}":
        return {}
    if text.startswith("["):
        if not text.endswith("]"):
            raise _yaml_error(lineno, f"unterminated flow list {text!r}")
        body = text[1:-1].strip()
        if any(ch in body for ch in "[]{}'\""):
            raise _yaml_error(lineno, f"nested or quoted flow items {text!r}")
        if not body:
            return []
        items = [item.strip() for item in body.split(",")]
        if not all(items):
            raise _yaml_error(lineno, f"empty flow-list item in {text!r}")
        return [_scalar(item, lineno) for item in items]
    if text[:1] not in ("'", '"') and (re.search(r":(\s|$)", text) or text.startswith("- ")):
        raise _yaml_error(lineno, f"nested block content in a scalar: {text!r}")
    return _scalar(text, lineno)


def _strip_comment(line: str) -> str:
    """Drop a ``#`` comment (at the start, or after a space, outside quotes)."""
    quote = None
    for i, ch in enumerate(line):
        if quote:
            if ch == quote:
                quote = None
        elif ch in ("'", '"') and (i == 0 or line[i - 1] in " :[,-"):
            quote = ch
        elif ch == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i].rstrip()
    return line.rstrip()


def _split_key(content: str, lineno: int):
    m = re.match(r"^([^'\"\[\]{}#&*!|>%@`][^:]*?|'[^']*'|\"[^\"]*\"):(?:\s+(.*))?$", content)
    if m is None:
        raise _yaml_error(lineno, f"expected 'key: value', got {content!r}")
    return _scalar(m.group(1), lineno), (m.group(2) or "").strip()


def yaml_loads(text: str) -> Any:
    """Parse the YAML subset described in the module docstring."""
    lines = []
    for lineno, raw in enumerate(text.splitlines(), 1):
        if "\t" in raw[: len(raw) - len(raw.lstrip())]:
            raise _yaml_error(lineno, "tab indentation")
        content = _strip_comment(raw)
        if not content.strip():
            continue
        if content.strip() in ("---", "...") and not content.startswith(" "):
            raise _yaml_error(lineno, "document markers are not supported")
        indent = len(content) - len(content.lstrip(" "))
        lines.append((indent, content.strip(), lineno))
    if not lines:
        return None
    node, pos = _block(lines, 0, lines[0][0])
    if pos != len(lines):
        raise _yaml_error(lines[pos][2], "unexpected indentation")
    return node


def _is_item(content: str) -> bool:
    return content == "-" or content.startswith("- ")


def _block(lines, pos: int, indent: int):
    if _is_item(lines[pos][1]):
        return _sequence(lines, pos, indent)
    return _mapping(lines, pos, indent)


def _sequence(lines, pos: int, indent: int):
    out = []
    while pos < len(lines) and lines[pos][0] == indent and _is_item(lines[pos][1]):
        _, content, lineno = lines[pos]
        item = content[1:].strip()
        if not item or re.match(r"^[^'\"\[]*?:(\s|$)", item):
            raise _yaml_error(lineno, "only scalar or flow-list sequence items are supported")
        out.append(_value(item, lineno))
        pos += 1
    return out, pos


def _mapping(lines, pos: int, indent: int):
    out = {}
    while pos < len(lines) and lines[pos][0] == indent:
        _, content, lineno = lines[pos]
        if _is_item(content):
            raise _yaml_error(lineno, "sequence item inside a mapping")
        key, rest = _split_key(content, lineno)
        pos += 1
        if rest:
            out[key] = _value(rest, lineno)
            continue
        nxt = lines[pos] if pos < len(lines) else None
        if nxt is not None and (nxt[0] > indent or (nxt[0] == indent and _is_item(nxt[1]))):
            out[key], pos = _block(lines, pos, nxt[0])
        else:
            out[key] = None
    if pos < len(lines) and lines[pos][0] > indent:
        raise _yaml_error(lines[pos][2], "unexpected indentation")
    return out, pos


def yaml_load_file(path) -> Any:
    with open(path, encoding="utf-8") as f:
        return yaml_loads(f.read())


def _yaml_scalar(v: Any) -> str:
    """A scalar as PyYAML's safe_dump writes it, quoted where the plain form
    would read back as something else."""
    if v is None:
        return "null"
    if v is True or v is False:
        return "true" if v else "false"
    if isinstance(v, (int, np.integer)):
        return str(int(v))
    if isinstance(v, (float, np.floating)):
        v = float(v)
        if v != v:
            return ".nan"
        if v in (float("inf"), float("-inf")):
            return ".inf" if v > 0 else "-.inf"
        text = repr(v).lower()
        if "." not in text and "e" in text:  # YAML 1.1 floats need a dot
            text = text.replace("e", ".0e", 1)
        return text
    if not isinstance(v, str):
        raise TypeError(f"yaml_dump: cannot write {type(v).__name__}")
    if "\n" in v or "\r" in v:
        raise ValueError(f"yaml_dump: multi-line strings are not supported: {v!r}")
    try:
        plain = v == v.strip() and _value(v, 0) == v and "#" not in v and ":" not in v
    except ValueError:
        plain = False
    if plain and v[:1] not in ("-", "?", ",", "[", "]", "{", "}", "'", '"'):
        return v
    return "'" + v.replace("'", "''") + "'"


def _yaml_lines(node: Any, indent: int, out: list) -> None:
    pad = " " * indent
    if isinstance(node, dict):
        for key in sorted(node):
            val = node[key]
            head = f"{pad}{_yaml_scalar(key)}:"
            if isinstance(val, dict) and val:
                out.append(head)
                _yaml_lines(val, indent + 2, out)
            elif isinstance(val, (list, tuple)) and len(val):
                out.append(head)
                _yaml_lines(val, indent, out)
            elif isinstance(val, (list, tuple)):
                out.append(f"{head} []")
            elif isinstance(val, dict):
                out.append(f"{head} {{}}")
            else:
                out.append(f"{head} {_yaml_scalar(val)}")
        return
    for item in node:  # a non-empty list
        if isinstance(item, (list, tuple)):
            flat = [_yaml_scalar(x) for x in item]
            if any(isinstance(x, (list, tuple, dict)) or f[:1] in ("'", '"') or "," in f
                   for x, f in zip(item, flat)):
                raise ValueError(f"yaml_dump: nested list {item!r} is not supported")
            out.append(f"{pad}- [{', '.join(flat)}]")
        elif isinstance(item, dict):
            raise ValueError("yaml_dump: maps inside lists are not supported")
        else:
            out.append(f"{pad}- {_yaml_scalar(item)}")


def yaml_dump(data: dict) -> str:
    """Block YAML of nested dicts, lists and scalars, keys sorted, that
    PyYAML's ``safe_load`` and :func:`yaml_loads` both read back to ``data``
    (tuples come back as lists). Raises on what the reader does not take."""
    if not isinstance(data, dict):
        raise TypeError("yaml_dump writes a mapping at the top level")
    out: list = []
    _yaml_lines(data, 0, out)
    return "\n".join(out) + "\n" if out else "{}\n"


def yaml_dump_file(data: dict, path) -> None:
    with open(path, "w", encoding="utf-8") as f:
        f.write(yaml_dump(data))


# --------------------------------------------------------------------------
# snapshots


def load_snapshot(snap_dir: str):
    """``(params, config)`` of a snapshot directory: the flax parameter tree
    as nested dicts of float32 numpy arrays, and the parsed config.yaml."""
    config = yaml_load_file(os.path.join(snap_dir, "config.yaml"))
    with open(os.path.join(snap_dir, "params.msgpack"), "rb") as f:
        tree = msgpack_loads(f.read())

    def to_f32(node):
        if isinstance(node, dict):
            return {k: to_f32(v) for k, v in node.items()}
        if isinstance(node, np.ndarray):
            return node.astype(np.float32)
        raise ValueError(f"unexpected leaf {type(node).__name__} in params.msgpack")

    return to_f32(tree), config
