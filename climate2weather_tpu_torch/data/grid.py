"""Labeled gridded datasets (port of climate2weather_tpu/data/grid.py).

- :class:`GridDataset`: named [time, rlat, rlon] variables with coordinates,
  time selection, spatial coarsening and HDF5 round-tripping;
- :func:`open_grid`: a grid file (``.nc`` names, HDF5 inside) or a zarr-v2
  store (a directory holding ``.zgroup``) into a :class:`GridDataset`;
- :class:`QuantileDataset`: per-variable quantiles over (time, rlat, rlon);
- the CF time helpers.

Files are read and written through ``io/hdf5.py``, so no h5py is needed.
The writer leaves out the dimension-scale attachments that h5py adds (the
JAX readers and the port's do not read them). Zarr stores go through
``data/zarr_store.py``. The netCDF4-library branch of the JAX module is not
ported: the port always writes HDF5 through its own writer.
"""

from __future__ import annotations

import json
import re
from dataclasses import dataclass, field
from datetime import datetime
from typing import Dict, List, Optional, Sequence

import numpy as np

from climate2weather_tpu_torch.data import zarr_store
from climate2weather_tpu_torch.io import hdf5

_NS = "datetime64[ns]"


def convert_to_datetime(date_str: str) -> datetime:
    """Parse 'YYYY-MM-DD-HH' or 'YYYY-MM-DD'."""
    try:
        return datetime.strptime(date_str, "%Y-%m-%d-%H")
    except ValueError:
        return datetime.strptime(date_str, "%Y-%m-%d")


def _decode_cf_time(values: np.ndarray, units: str) -> np.ndarray:
    """Minimal CF time decoding: '<unit> since <epoch>' -> datetime64[ns]."""
    m = re.match(r"(seconds|minutes|hours|days)\s+since\s+(.+)", units.strip(), re.I)
    if not m:
        raise ValueError(f"Unsupported CF time units: {units!r}")
    unit, epoch_s = m.group(1).lower(), m.group(2).strip()
    epoch_s = epoch_s.split("UTC")[0].strip().rstrip("Z").strip()
    for fmt in ("%Y-%m-%d %H:%M:%S.%f", "%Y-%m-%d %H:%M:%S", "%Y-%m-%d %H:%M",
                "%Y-%m-%dT%H:%M:%S", "%Y-%m-%d"):
        try:
            epoch = datetime.strptime(epoch_s, fmt)
            break
        except ValueError:
            continue
    else:
        raise ValueError(f"Unparseable CF epoch: {epoch_s!r}")
    scale = {"seconds": 1, "minutes": 60, "hours": 3600, "days": 86400}[unit]
    base = np.datetime64(epoch, "ns")
    return base + (np.asarray(values, np.float64) * scale * 1e9).astype("timedelta64[ns]")


def _encode_cf_time(times: np.ndarray) -> tuple:
    times = np.asarray(times, _NS)
    epoch = times[0]
    hours = (times - epoch) / np.timedelta64(1, "h")
    epoch_dt = epoch.astype("datetime64[s]").item()
    return hours.astype(np.float64), f"hours since {epoch_dt.strftime('%Y-%m-%d %H:%M:%S')}"


def _text(value) -> str:
    return value.decode() if isinstance(value, bytes) else str(value)


@dataclass
class GridDataset:
    """Named [time, rlat, rlon] variables with coordinates."""

    data_vars: Dict[str, np.ndarray]
    coords: Dict[str, np.ndarray]
    attrs: Dict[str, object] = field(default_factory=dict)

    def __post_init__(self):
        shape = (len(self.coords["time"]), len(self.coords["rlat"]), len(self.coords["rlon"]))
        for k, v in self.data_vars.items():
            if v.shape != shape:
                raise ValueError(f"{k}: shape {v.shape}, coordinates give {shape}")

    @property
    def time(self) -> np.ndarray:
        return self.coords["time"]

    @property
    def rlat(self) -> np.ndarray:
        return self.coords["rlat"]

    @property
    def rlon(self) -> np.ndarray:
        return self.coords["rlon"]

    @property
    def sizes(self) -> Dict[str, int]:
        return {"time": len(self.time), "rlat": len(self.rlat), "rlon": len(self.rlon)}

    def var_names(self) -> List[str]:
        return sorted(self.data_vars)

    def sel_time(self, start: datetime, end: datetime) -> "GridDataset":
        """Inclusive time slice (xarray ``sel(time=slice(...))``)."""
        lo, hi = np.datetime64(start, "ns"), np.datetime64(end, "ns")
        return self.isel_time(np.nonzero((self.time >= lo) & (self.time <= hi))[0])

    def isel_time(self, idx) -> "GridDataset":
        idx = np.asarray(idx)
        return GridDataset({k: v[idx] for k, v in self.data_vars.items()},
                           {**self.coords, "time": self.time[idx]}, dict(self.attrs))

    def select_vars(self, names: Sequence[str]) -> "GridDataset":
        names = sorted(names)
        missing = set(names) - set(self.data_vars)
        if missing:
            raise KeyError(f"missing variables: {sorted(missing)}")
        return GridDataset({k: self.data_vars[k] for k in names}, dict(self.coords), dict(self.attrs))

    def coarsen_mean(self, s: int) -> "GridDataset":
        """Block-mean coarsening over (rlat, rlon) by factor ``s``."""
        t, y, x = len(self.time), len(self.rlat), len(self.rlon)
        if y % s or x % s:
            raise ValueError(f"grid {y} x {x} is not divisible by {s}")
        dv = {k: v.reshape(t, y // s, s, x // s, s).mean(axis=(2, 4)) for k, v in self.data_vars.items()}
        coords = {"time": self.time, "rlat": self.rlat.reshape(y // s, s).mean(axis=1),
                  "rlon": self.rlon.reshape(x // s, s).mean(axis=1)}
        return GridDataset(dv, coords, dict(self.attrs))

    def map(self, fn) -> "GridDataset":
        """Apply ``fn(name, values) -> values`` per variable."""
        return GridDataset({k: fn(k, v) for k, v in self.data_vars.items()}, dict(self.coords),
                           dict(self.attrs))

    def nan_report(self) -> Optional[dict]:
        """Times containing NaNs per variable ({name: {"nr_of_times",
        "which_times"}}); None when clean."""
        report = {}
        for k, v in self.data_vars.items():
            isnan = np.isnan(v)
            if isnan.any():
                which_times = np.unique(np.argwhere(isnan)[:, 0])
                report[k] = {"nr_of_times": len(which_times), "which_times": which_times}
        return report or None

    @staticmethod
    def concat_time(parts: Sequence["GridDataset"]) -> "GridDataset":
        """The parts one after another along time (the first part's spatial
        coordinates and attributes)."""
        names = parts[0].var_names()
        return GridDataset({k: np.concatenate([p.data_vars[k] for p in parts], axis=0) for k in names},
                           {**parts[0].coords, "time": np.concatenate([p.time for p in parts])},
                           dict(parts[0].attrs))

    def to_file(self, path: str, dtype: str = "float32") -> None:
        """Write an HDF5 file as the JAX ``GridDataset.to_file`` does through
        h5py: ``time`` (hours, CF ``units``), ``rlat``, ``rlon``, one
        [time, rlat, rlon] dataset per variable with a ``dims`` attribute,
        and the ``grid_attrs`` JSON attribute. Paths ending in ``.zarr``
        write a zarr-v2 directory store (:func:`~climate2weather_tpu_torch.data.zarr_store.write_zarr`,
        zlib chunks)."""
        if str(path).rstrip("/").endswith(".zarr"):
            zarr_store.write_zarr(self, str(path), dtype)
            return
        hours, units = _encode_cf_time(self.time)
        with hdf5.Writer(path) as w:
            w.create_dataset("time", data=hours, attrs={"units": units, "standard_name": "time"})
            w.create_dataset("rlat", data=np.asarray(self.rlat, np.float64))
            w.create_dataset("rlon", data=np.asarray(self.rlon, np.float64))
            for k, v in self.data_vars.items():
                w.create_dataset(k, data=np.asarray(v, dtype), attrs={"dims": ["time", "rlat", "rlon"]})
            w.attrs["grid_attrs"] = json.dumps(self.attrs, default=str)


def open_grid(path: str, data_vars: Optional[Sequence[str]] = None) -> GridDataset:
    """Open an HDF5/netCDF4 grid file into a :class:`GridDataset`: files of
    :meth:`GridDataset.to_file` and CF files of per-variable
    [time, rlat, rlon] datasets with coordinate variables; a directory
    holding ``.zgroup`` is read as a zarr-v2 store, whatever its name."""
    if zarr_store.is_zarr(path):
        return zarr_store.read_zarr(path, data_vars)
    f = hdf5.open_file(path)
    try:
        keys = list(f.keys())
        coord_names = {"time", "rlat", "rlon", "lat", "lon", "rotated_pole"}
        if data_vars is None:
            data_vars = [k for k in keys if k not in coord_names and hasattr(f[k], "shape")
                         and len(f[k].shape) == 3]
        tvals = f["time"][:]
        units = _text(f["time"].attrs.get("units", b""))
        time = _decode_cf_time(tvals, units) if units else np.asarray(tvals, _NS)
        coords = {
            "time": time,
            "rlat": np.asarray(f["rlat"][:], np.float64) if "rlat" in f
            else np.arange(f[data_vars[0]].shape[1], dtype=np.float64),
            "rlon": np.asarray(f["rlon"][:], np.float64) if "rlon" in f
            else np.arange(f[data_vars[0]].shape[2], dtype=np.float64),
        }
        dv = {}
        for k in sorted(data_vars):
            arr = np.asarray(f[k][:], np.float32)
            fill = f[k].attrs.get("_FillValue")
            if fill is not None:
                arr = np.where(arr == np.float32(fill), np.nan, arr)
            dv[k] = arr
        raw = f.attrs.get("grid_attrs")
        attrs = json.loads(_text(raw)) if raw is not None else {}
    finally:
        f.close()
    return GridDataset(dv, coords, attrs)


@dataclass
class QuantileDataset:
    """Per-variable scalar quantiles over (time, rlat, rlon)."""

    quantiles: np.ndarray  # [nq] quantile levels
    values: Dict[str, np.ndarray]  # var -> [nq]

    def sel(self, q: float) -> Dict[str, float]:
        i = int(np.argmin(np.abs(self.quantiles - q)))
        if not np.isclose(self.quantiles[i], q):
            raise KeyError(f"quantile {q} not in {self.quantiles}")
        return {k: float(v[i]) for k, v in self.values.items()}

    def to_file(self, path: str) -> None:
        with hdf5.Writer(path) as w:
            w.create_dataset("quantile", data=np.asarray(self.quantiles, np.float64))
            for k, v in self.values.items():
                w.create_dataset(k, data=np.asarray(v, np.float64))

    @staticmethod
    def from_file(path: str) -> "QuantileDataset":
        f = hdf5.open_file(path)
        try:
            qs = np.asarray(f["quantile"][:], np.float64)
            # standard CF quantile files may carry [nq] or [nq, 1, 1]
            values = {k: np.asarray(f[k][:], np.float64).reshape(len(qs))
                      for k in f.keys() if k != "quantile"}
        finally:
            f.close()
        return QuantileDataset(qs, values)
