"""Zarr-v2 directory store for GridDataset (port of
climate2weather_tpu/data/zarr_store.py), in the standard library and numpy.

- group: ``.zgroup`` (zarr_format 2) + ``.zattrs`` (GridDataset attrs);
- arrays: ``<var>/.zarray`` (C order, no filters, time-chunked by day) +
  ``<var>/.zattrs`` carrying the xarray ``_ARRAY_DIMENSIONS`` convention
  and CF time units, + full-size zero-padded chunk files ``i.j.k``;
- chunks zlib-compressed, uncompressed or **blosc**: the external default
  ``Blosc(cname='lz4', shuffle=1)`` is read and, with
  ``write_zarr(compressor="blosc-lz4")``, written by the native codec
  (``data/native_blosc.py``, built at first use).

Stores are readable by real zarr/xarray installs and by the JAX package,
and stores they write read here. :meth:`GridDataset.to_file` routes
``*.zarr`` paths to :func:`write_zarr`; :func:`open_grid` routes any
directory holding ``.zgroup`` to :func:`read_zarr`.
"""

from __future__ import annotations

import json
import math
import os
import zlib
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

_FMT = 2
_LEVEL = 4  # zlib level: fast, ~2x on weather fields
COMPRESSORS = ("zlib", "blosc-lz4", "none")


def _write_json(path: str, obj: dict) -> None:
    with open(path, "w") as f:
        json.dump(obj, f, indent=2, sort_keys=True)


def _chunk_grid(shape: Tuple[int, ...], chunks: Tuple[int, ...]):
    counts = [math.ceil(s / c) for s, c in zip(shape, chunks)]
    idx = np.indices(counts).reshape(len(counts), -1).T
    return [tuple(map(int, i)) for i in idx]


def _compressor_meta(compressor: str) -> Optional[dict]:
    if compressor == "none":
        return None
    if compressor == "blosc-lz4":
        # numcodecs Blosc metadata; shuffle 1 = byte-shuffle
        return {"id": "blosc", "cname": "lz4", "clevel": 5, "shuffle": 1, "blocksize": 0}
    if compressor == "zlib":
        return {"id": "zlib", "level": _LEVEL}
    raise ValueError(f"unknown zarr compressor {compressor!r}; options: {list(COMPRESSORS)}")


def _write_array(root: str, name: str, data: np.ndarray, chunks: Optional[Tuple[int, ...]] = None,
                 attrs: Optional[dict] = None, compressor: str = "zlib") -> None:
    data = np.ascontiguousarray(data)
    if chunks is None:
        chunks = data.shape
    chunks = tuple(min(c, s) for c, s in zip(chunks, data.shape))
    comp_meta = _compressor_meta(compressor)
    adir = os.path.join(root, name)
    os.makedirs(adir, exist_ok=True)
    meta = {
        "zarr_format": _FMT,
        "shape": list(data.shape),
        "chunks": list(chunks),
        "dtype": data.dtype.str,  # e.g. "<f4"
        "compressor": comp_meta,
        # null, not 0: xarray's open_zarr masks values equal to fill_value
        # (CF _FillValue semantics), and time[0] is always exactly 0.0
        "fill_value": None,
        "order": "C",
        "filters": None,
    }
    _write_json(os.path.join(adir, ".zarray"), meta)
    if attrs:
        _write_json(os.path.join(adir, ".zattrs"), attrs)
    for ci in _chunk_grid(data.shape, chunks):
        sel = tuple(slice(i * c, min((i + 1) * c, s)) for i, c, s in zip(ci, chunks, data.shape))
        block = data[sel]
        if block.shape != chunks:  # zarr v2 chunks are always full-size
            pad = np.zeros(chunks, data.dtype)
            pad[tuple(slice(0, b) for b in block.shape)] = block
            block = pad
        raw = np.ascontiguousarray(block).tobytes()
        if compressor == "blosc-lz4":
            from climate2weather_tpu_torch.data import native_blosc

            raw = native_blosc.compress(raw, data.dtype.itemsize, shuffle=True)
        elif compressor == "zlib":
            raw = zlib.compress(raw, _LEVEL)
        with open(os.path.join(adir, ".".join(map(str, ci))), "wb") as f:
            f.write(raw)


def _read_array(root: str, name: str) -> Tuple[np.ndarray, dict]:
    adir = os.path.join(root, name)
    with open(os.path.join(adir, ".zarray")) as f:
        meta = json.load(f)
    where = f"zarr store {root!r}, array {name!r}"
    if meta.get("zarr_format") != _FMT:
        raise ValueError(f"{where}: zarr_format {meta.get('zarr_format')!r}; only version {_FMT} is read")
    if meta.get("order", "C") != "C":
        raise ValueError(f"{where}: F-order stores not supported")
    if meta.get("filters"):
        raise ValueError(f"{where}: filter pipelines not supported ({meta['filters']!r})")
    comp = meta.get("compressor")
    comp_id = None if comp is None else comp.get("id")
    if comp_id == "blosc":
        from climate2weather_tpu_torch.data import native_blosc

        # the native codec handles lz4/memcpy chunks with byte-shuffle, the
        # external default Blosc(cname='lz4', shuffle=1); chunk-level errors
        # below name the store and the failing codec
        try:
            native_blosc.load()
        except RuntimeError as e:
            raise ValueError(f"{where}: blosc-compressed chunks need the native codec, which failed to "
                             f"build; rewrite the store with compressor=zlib\n{e}") from e
    elif comp_id not in (None, "zlib"):
        raise ValueError(
            f"{where}: unsupported compressor {comp_id!r} — this dependency-free reader handles zlib, "
            f"blosc(lz4) or uncompressed chunks (rewrite with compressor=zlib, blosc-lz4 or none)")
    shape = tuple(meta["shape"])
    chunks = tuple(meta["chunks"])
    dtype = np.dtype(meta["dtype"])
    out = np.empty(shape, dtype)
    for ci in _chunk_grid(shape, chunks):
        fname = os.path.join(adir, ".".join(map(str, ci)))
        sel = tuple(slice(i * c, min((i + 1) * c, s)) for i, c, s in zip(ci, chunks, shape))
        want = tuple(s.stop - s.start for s in sel)
        if not os.path.exists(fname):  # missing chunk = fill_value
            out[sel] = meta.get("fill_value") or 0
            continue
        with open(fname, "rb") as f:
            raw = f.read()
        if comp_id == "blosc":
            try:
                raw = native_blosc.decompress(raw)
            except ValueError as e:
                raise ValueError(f"zarr store {root!r}, chunk {fname!r}: {e}") from None
        elif comp_id == "zlib":
            raw = zlib.decompress(raw)
        block = np.frombuffer(raw, dtype).reshape(chunks)
        out[sel] = block[tuple(slice(0, w) for w in want)]
    attrs = {}
    zattrs = os.path.join(adir, ".zattrs")
    if os.path.exists(zattrs):
        with open(zattrs) as f:
            attrs = json.load(f)
    return out, attrs


def write_zarr(ds, path: str, dtype: str = "float32", compressor: str = "zlib") -> None:
    """Write a GridDataset as a zarr-v2 directory store (xarray layout).

    ``compressor``: ``"zlib"`` (default, stdlib-only), ``"blosc-lz4"`` (the
    native codec, the format external zarr installs write by default) or
    ``"none"``."""
    from climate2weather_tpu_torch.data.grid import _encode_cf_time

    _compressor_meta(compressor)  # an unknown name fails before anything is written
    os.makedirs(path, exist_ok=True)
    _write_json(os.path.join(path, ".zgroup"), {"zarr_format": _FMT})
    _write_json(os.path.join(path, ".zattrs"), json.loads(json.dumps(ds.attrs, default=str)))
    hours, units = _encode_cf_time(ds.time)
    _write_array(path, "time", np.asarray(hours, np.float64),
                 attrs={"_ARRAY_DIMENSIONS": ["time"], "units": units, "standard_name": "time"},
                 compressor="none")
    _write_array(path, "rlat", np.asarray(ds.rlat, np.float64), attrs={"_ARRAY_DIMENSIONS": ["rlat"]},
                 compressor="none")
    _write_array(path, "rlon", np.asarray(ds.rlon, np.float64), attrs={"_ARRAY_DIMENSIONS": ["rlon"]},
                 compressor="none")
    t_chunk = min(24, len(ds.time))  # day-chunked like the HDF5 build
    for k, v in ds.data_vars.items():
        _write_array(path, k, np.asarray(v, dtype), chunks=(t_chunk,) + tuple(v.shape[1:]),
                     attrs={"_ARRAY_DIMENSIONS": ["time", "rlat", "rlon"]}, compressor=compressor)


def read_zarr(path: str, data_vars: Optional[Sequence[str]] = None):
    """Open a zarr-v2 directory store as a GridDataset."""
    from climate2weather_tpu_torch.data.grid import _NS, GridDataset, _decode_cf_time

    names = [n for n in sorted(os.listdir(path))
             if os.path.isdir(os.path.join(path, n)) and os.path.exists(os.path.join(path, n, ".zarray"))]
    coord_names = {"time", "rlat", "rlon", "lat", "lon", "latitude", "longitude"}
    if "time" in names:
        tvals, tattrs = _read_array(path, "time")
        units = tattrs.get("units", "")
        time = _decode_cf_time(tvals, units) if units else np.asarray(tvals, _NS)
    else:
        # stores without a time coordinate get an index axis, as rlat/rlon
        # do below; only 3-D [T, H, W] arrays define the time length
        tlen = 0
        for n in names:
            if n not in coord_names:
                with open(os.path.join(path, n, ".zarray")) as f:
                    shape = json.load(f)["shape"]
                if len(shape) == 3:
                    tlen = shape[0]
                    break
        time = np.arange(tlen, dtype=np.int64).astype(_NS)
    coords: Dict[str, np.ndarray] = {"time": time}
    for c in ("rlat", "rlon"):
        if c in names:
            coords[c], _ = _read_array(path, c)
    if data_vars is None:
        data_vars = [n for n in names if n not in coord_names]
    dv = {}
    for k in sorted(data_vars):
        arr, _ = _read_array(path, k)
        if arr.ndim != 3:
            continue
        dv[k] = np.asarray(arr, np.float32)
    if dv:
        first = next(iter(dv.values()))
        coords.setdefault("rlat", np.arange(first.shape[1], dtype=np.float64))
        coords.setdefault("rlon", np.arange(first.shape[2], dtype=np.float64))
    attrs = {}
    zattrs = os.path.join(path, ".zattrs")
    if os.path.exists(zattrs):
        with open(zattrs) as f:
            attrs = json.load(f)
    return GridDataset(dv, coords, attrs)


def is_zarr(path: str) -> bool:
    return os.path.isdir(path) and os.path.exists(os.path.join(path, ".zgroup"))
