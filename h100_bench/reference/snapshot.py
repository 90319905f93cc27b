"""Read a snapshot's ``params.msgpack`` into the reference's parameters.

The file is flax's msgpack encoding of the parameter tree: nested maps of
strings, with every array as msgpack extension 1 holding a msgpack triple
(shape, dtype name, C-order little-endian bytes). Flax conv kernels are
[k, k, in, out] and dense kernels [in, out]; they are turned into
[out, in, k, k] and [out, in] here. Only what such a file holds is decoded.
"""

from __future__ import annotations

import struct

import numpy as np
import torch


class _Reader:
    def __init__(self, data):
        self.buf = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.buf):
            raise ValueError("msgpack: truncated")
        out = self.buf[self.pos:self.pos + n]
        self.pos += n
        return out

    def num(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def value(self):
        b = self.num(">B")
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if b & 0xF0 == 0x80:
            return self.map(b & 0x0F)
        if b & 0xF0 == 0x90:
            return [self.value() for _ in range(b & 0x0F)]
        if b & 0xE0 == 0xA0:
            return bytes(self.take(b & 0x1F)).decode()
        sized = {0xC4: ">B", 0xC5: ">H", 0xC6: ">I"}  # bin
        if b in sized:
            return bytes(self.take(self.num(sized[b])))
        strs = {0xD9: ">B", 0xDA: ">H", 0xDB: ">I"}
        if b in strs:
            return bytes(self.take(self.num(strs[b]))).decode()
        exts = {0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}
        if b in exts:
            return self.ext(self.num(exts[b]))
        fixext = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
        if b in fixext:
            return self.ext(fixext[b])
        ints = {0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q", 0xD0: ">b", 0xD1: ">h", 0xD2: ">i",
                0xD3: ">q", 0xCA: ">f", 0xCB: ">d"}
        if b in ints:
            return self.num(ints[b])
        if b in (0xDC, 0xDD):
            return [self.value() for _ in range(self.num(">H" if b == 0xDC else ">I"))]
        if b in (0xDE, 0xDF):
            return self.map(self.num(">H" if b == 0xDE else ">I"))
        if b in (0xC0, 0xC2, 0xC3):
            return {0xC0: None, 0xC2: False, 0xC3: True}[b]
        raise ValueError(f"msgpack: type byte 0x{b:02x}")

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.value()
            out[key] = self.value()
        return out

    def ext(self, n: int):
        code = self.num(">b")
        payload = self.take(n)
        if code != 1:
            raise ValueError(f"msgpack: extension {code}")
        shape, dtype, raw = _Reader(payload).value()
        dtype = dtype.decode() if isinstance(dtype, bytes) else dtype
        if dtype == "bfloat16":
            arr = (np.frombuffer(raw, "<u2").astype(np.uint32) << 16).view(np.float32)
        else:
            arr = np.frombuffer(raw, np.dtype(dtype).newbyteorder("<"))
        return arr.reshape([int(s) for s in shape]).astype(np.float32)


def _leaves(tree: dict, prefix: str = ""):
    for key, val in tree.items():
        path = f"{prefix}.{key}" if prefix else key
        if isinstance(val, dict):
            yield from _leaves(val, path)
        else:
            yield path, val


def read_params(path, device) -> dict:
    """``params.msgpack`` at ``path`` as the reference's float32 tensors on
    ``device``."""
    with open(path, "rb") as f:
        tree = _Reader(f.read()).value()
    tree = tree.get("params", tree)
    out = {}
    for name, arr in _leaves(tree):
        module, _, leaf = name.rpartition(".")
        if leaf == "kernel":
            arr = arr.transpose(3, 2, 0, 1) if arr.ndim == 4 else arr.T
            name = module + ".weight"
        out[name] = torch.from_numpy(np.ascontiguousarray(arr)).to(device)
    return out
