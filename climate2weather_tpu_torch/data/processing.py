"""Offline data engineering (port of climate2weather_tpu/data/processing.py).

- ``extract_patch``: slice the study region out of full-domain files by
  index ranges (production: rows [344, 472) x cols [371, 499), a 128 x 128
  patch), with the NaN audit (``<stem>_with_missing.h5``,
  ``<stem>_nan_stats.npz``) and PCHIP repair of NaN time steps along time;
- ``filter_files_by_years`` / ``extract_patch_folder``: the per-variable
  archive-folder extraction, keeping each file's name;
- ``merge_time`` / ``select_dates`` / ``merge_vars``: what the ``cdo``
  binary's mergetime / seldate / merge do, in numpy;
- ``compute_quantiles``: 9 quantiles (0 .. 1) over (time, rlat, rlon);
- ``mean_climatology``: the mean over years per hour of the year,
  broadcast back to the time axis;
- ``merged_to_normed_h5``: the normalized training file (dataset ``x``
  [T, C, H, W] float32, ``vars`` and ``norm_mode`` attributes), through the
  port's HDF5 writer; raises on NaN.

The PCHIP is the port's own in numpy (scipy's ``PchipInterpolator`` in the
JAX package): the same interior slopes, the same one-sided end slopes with
their shape-preserving fixes, and the same evaluation of the Hermite cubic.
"""

from __future__ import annotations

import pathlib
import re
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from climate2weather_tpu_torch.data.grid import (
    GridDataset,
    QuantileDataset,
    convert_to_datetime,
    open_grid,
)
from climate2weather_tpu_torch.data.pipeline import normalize_ds
from climate2weather_tpu_torch.io import hdf5

DEFAULT_PATCH = dict(lat_range=(344, 472), lon_range=(371, 499))
# raw archive names carry a 12-digit start stamp, e.g.
# psl_EUR-6km_ECMWF-ERAINT_REA6_r1i1p1f1_COSMO_v1_200601010000-200612312300.nc
_RAW_FILE_RE = re.compile(r"^.+_(?P<start_time>\d{12})-.+\.nc$")


def extract_patch(ds: GridDataset, lat_range: Tuple[int, int] = DEFAULT_PATCH["lat_range"],
                  lon_range: Tuple[int, int] = DEFAULT_PATCH["lon_range"], interpolate_nans: bool = True,
                  audit_path: Optional[str] = None) -> GridDataset:
    """Slice the patch by index ranges; PCHIP-interpolate NaN times.

    Where NaNs are found and ``audit_path`` (a path stem) is set, the audit
    artifacts are written first: ``<stem>_with_missing.h5`` (the patch
    before interpolation) and ``<stem>_nan_stats.npz`` (per variable, the
    count and indices of the NaN times). NaNs that survive interpolation
    raise; without ``interpolate_nans`` any NaN raises.
    """
    la0, la1 = lat_range
    lo0, lo1 = lon_range
    patch = GridDataset({k: v[:, la0:la1, lo0:lo1] for k, v in ds.data_vars.items()},
                        {"time": ds.time, "rlat": ds.rlat[la0:la1], "rlon": ds.rlon[lo0:lo1]}, dict(ds.attrs))
    report = patch.nan_report()
    if report is None:
        return patch
    if not interpolate_nans:
        raise RuntimeError(f"NaNs in patch: {report}")
    if audit_path:
        patch.to_file(f"{audit_path}_with_missing.h5")
        stats = {}
        for k, r in report.items():
            stats[f"{k}_nr_of_times"] = np.asarray(r["nr_of_times"])
            stats[f"{k}_which_times"] = np.asarray(r["which_times"])
        np.savez(f"{audit_path}_nan_stats.npz", **stats)
        print(f"NaN audit written: {audit_path}_with_missing.h5, {audit_path}_nan_stats.npz")
    patch = _interpolate_nan_times(patch, report)
    remaining = patch.nan_report()
    if remaining is not None:
        raise RuntimeError(f"NaNs survived pchip interpolation — giving up: {remaining}")
    return patch


def _pchip_edge_slope(h0, h1, m0, m1) -> np.ndarray:
    """The one-sided three-point end slope, set to 0 where its sign differs
    from the end segment's and to 3 m0 where the two end segments' signs
    differ and it exceeds 3 |m0| (scipy's ``PchipInterpolator._edge_case``)."""
    d = ((2 * h0 + h1) * m0 - h0 * m1) / (h0 + h1)
    mask = np.sign(d) != np.sign(m0)
    mmm = ~mask & (np.sign(m0) != np.sign(m1)) & (np.abs(d) > 3.0 * np.abs(m0))
    d[mask] = 0.0
    d[mmm] = 3.0 * m0[mmm]
    return d


def pchip(x: np.ndarray, y: np.ndarray, xnew: np.ndarray) -> np.ndarray:
    """The monotone piecewise-cubic Hermite interpolant of (``x``, ``y``)
    along ``y``'s first axis at ``xnew`` (float64; outside ``x`` the first
    or last piece extended), as scipy's ``PchipInterpolator(x, y, axis=0)``
    computes it."""
    x = np.asarray(x, np.float64)
    y = np.asarray(y, np.float64).reshape(len(x), -1)
    if len(x) < 2 or np.any(np.diff(x) <= 0):
        raise ValueError("x must be a strictly increasing sequence of at least 2 points")
    if not np.isfinite(y).all():
        raise ValueError("y must contain only finite values")
    hk = np.diff(x)[:, None]
    mk = (y[1:] - y[:-1]) / hk
    if len(x) == 2:
        dk = np.concatenate([mk, mk])
    else:
        # interior: 0 at a sign change or a flat segment, else the weighted harmonic mean
        smk = np.sign(mk)
        condition = (smk[1:] != smk[:-1]) | (mk[1:] == 0) | (mk[:-1] == 0)
        w1 = 2 * hk[1:] + hk[:-1]
        w2 = hk[1:] + 2 * hk[:-1]
        with np.errstate(divide="ignore", invalid="ignore"):
            whmean = (w1 / mk[:-1] + w2 / mk[1:]) / (w1 + w2)
        dk = np.zeros_like(y)
        dk[1:-1][~condition] = 1.0 / whmean[~condition]
        dk[0] = _pchip_edge_slope(hk[0], hk[1], mk[0], mk[1])
        dk[-1] = _pchip_edge_slope(hk[-1], hk[-2], mk[-1], mk[-2])
    # the Hermite cubic of each interval in powers of s = xnew - x[i]
    t = (dk[:-1] + dk[1:] - 2 * mk) / hk
    c0, c1, c2, c3 = t / hk, (mk - dk[:-1]) / hk - t, dk[:-1], y[:-1]
    xnew = np.asarray(xnew, np.float64)
    i = np.clip(np.searchsorted(x, xnew, side="right") - 1, 0, len(x) - 2)
    s = (xnew - x[i])[:, None]
    s2 = s * s
    return ((c3[i] + c2[i] * s) + c1[i] * s2) + c0[i] * (s2 * s)


def _interpolate_nan_times(ds: GridDataset, report: dict) -> GridDataset:
    """Replace fully or partially NaN time steps by PCHIP interpolation
    along time, per pixel, from the clean time steps."""
    out = {}
    t_axis = np.arange(len(ds.time), dtype=np.float64)
    for k, v in ds.data_vars.items():
        if k not in report:
            out[k] = v
            continue
        bad_times = report[k]["which_times"]
        good = np.setdiff1d(t_axis.astype(int), bad_times)
        flat = v.reshape(len(t_axis), -1)
        fixed = flat.copy()
        fixed[bad_times] = pchip(t_axis[good], flat[good], t_axis[bad_times])
        out[k] = fixed.reshape(v.shape)
        print(f"Interpolated {len(bad_times)} NaN time steps for {k}")
    return GridDataset(out, dict(ds.coords), dict(ds.attrs))


def filter_files_by_years(file_list, start_year: int, end_year: int):
    """The raw archive files whose 12-digit start stamp falls in
    [start_year, end_year]; a name without one raises."""
    out = []
    for f in file_list:
        m = _RAW_FILE_RE.match(f.name)
        if not m:
            raise ValueError(f"File name '{f.name}' does not match the required format")
        if start_year <= int(m.group("start_time")[:4]) <= end_year:
            out.append(f)
    return out


def extract_patch_folder(var_folder: str, out_folder: str, years: Optional[str] = None,
                         lat_range: Tuple[int, int] = DEFAULT_PATCH["lat_range"],
                         lon_range: Tuple[int, int] = DEFAULT_PATCH["lon_range"]) -> list:
    """Extract the patch from every raw ``*.nc`` file of one variable's
    archive folder, in name order, optionally only those whose start year
    lies in ``years`` ("2006-2019", inclusive), each with the NaN audit and
    repair, written under its own name in ``out_folder``."""
    var_folder = pathlib.Path(var_folder)
    if not var_folder.is_dir():
        raise ValueError(f"{var_folder} is not a directory.")
    out = pathlib.Path(out_folder)
    out.mkdir(parents=True, exist_ok=True)
    files = sorted(var_folder.glob("*.nc"))
    if not files:
        raise ValueError(f"No netCDF files found in {var_folder}. This runs per variable.")
    if years is not None:
        y0, y1 = map(int, str(years).split("-"))
        files = filter_files_by_years(files, y0, y1)
        if not files:
            raise ValueError(f"No files in {var_folder} match years {years}")
    written = []
    for f in files:
        dst = out / f.name
        patch = extract_patch(open_grid(str(f)), lat_range, lon_range, interpolate_nans=True,
                              audit_path=str(dst.with_suffix("")))
        patch.to_file(str(dst))
        written.append(dst)
        print(f"Wrote {dst}: {patch.sizes}")
    return written


# ---------------------------------------------------------------------------
# what cdo's mergetime / seldate / merge do


def merge_time(parts: Sequence[GridDataset]) -> GridDataset:
    """Concatenate along time in chronological order (cdo mergetime)."""
    return GridDataset.concat_time(sorted(parts, key=lambda p: p.time[0]))


def select_dates(ds: GridDataset, start: str, end: str) -> GridDataset:
    """Inclusive date-range selection (cdo seldate)."""
    return ds.sel_time(convert_to_datetime(start), convert_to_datetime(end))


def merge_vars(datasets: Sequence[GridDataset]) -> GridDataset:
    """Merge single-variable datasets on the same time axis (cdo merge)."""
    base = datasets[0]
    dv = {}
    for d in datasets:
        if len(d.time) != len(base.time):
            raise ValueError(f"merging {len(d.time)} time steps into {len(base.time)}")
        dv.update(d.data_vars)
    return GridDataset(dv, dict(base.coords), dict(base.attrs))


# ---------------------------------------------------------------------------
# statistics


def compute_quantiles(ds: GridDataset, quantiles: Sequence[float] = (
        0.0, 0.01, 0.05, 0.25, 0.5, 0.75, 0.95, 0.99, 1.0)) -> QuantileDataset:
    """Scalar per-variable quantiles over all of (time, rlat, rlon)."""
    qs = np.asarray(quantiles, np.float64)
    return QuantileDataset(qs, {k: np.quantile(v.astype(np.float64), qs) for k, v in ds.data_vars.items()})


def mean_climatology(ds: GridDataset) -> GridDataset:
    """Mean over years per (day of year, hour) slot, broadcast back to the
    time axis."""
    t = ds.time.astype("datetime64[s]")
    doy = (t.astype("datetime64[D]") - t.astype("datetime64[Y]")).astype(int)
    hour = (t - t.astype("datetime64[D]")).astype("timedelta64[h]").astype(int)
    slot = doy * 24 + hour
    out = {}
    for k, v in ds.data_vars.items():
        sums: Dict[int, np.ndarray] = {}
        counts: Dict[int, int] = {}
        for i, s in enumerate(slot):
            if s not in sums:
                sums[s] = v[i].astype(np.float64).copy()
                counts[s] = 1
            else:
                sums[s] += v[i]
                counts[s] += 1
        out[k] = np.stack([sums[s] / counts[s] for s in slot]).astype(np.float32)
    return GridDataset(out, dict(ds.coords), dict(ds.attrs))


# ---------------------------------------------------------------------------
# the training file


def merged_to_normed_h5(merged_path: str, quantile_path: str, out_path: str,
                        norm_mode: str = "quant95", data_vars: Optional[Sequence[str]] = None,
                        chunk_hours: int = 24) -> str:
    """Normalize a merged grid file into the training HDF5 layout, as the
    JAX ``merged_to_normed_h5`` does: dataset ``x`` [T, C, H, W] float32 in
    chunks of ``chunk_hours`` frames (unlimited first axis), with the
    ``vars`` and ``norm_mode`` attributes; raises on NaN."""
    ds = open_grid(merged_path, data_vars)
    data_vars = ds.var_names()
    normed = normalize_ds(ds, quantile_path, norm_mode)
    T, H, W, C = len(normed.time), len(normed.rlat), len(normed.rlon), len(data_vars)
    with hdf5.Writer(out_path) as w:
        x = w.create_dataset("x", shape=(T, C, H, W), dtype=np.float32,
                             chunks=(min(chunk_hours, T), C, H, W))
        rows = min(chunk_hours, T)
        for t0 in range(0, T, rows):
            t1 = min(t0 + rows, T)
            block = np.stack([normed.data_vars[v][t0:t1] for v in data_vars], axis=1).astype(np.float32)
            if np.isnan(block).any():
                raise RuntimeError(f"NaN detected in normalized block [{t0}:{t1}]")
            x.write_rows(t0, block)
        w.attrs["vars"] = data_vars
        w.attrs["norm_mode"] = norm_mode
    return out_path
