"""Normalization and tensor <-> grid conversion (port of
climate2weather_tpu/data/pipeline.py), with the two functions of the JAX
``data/processing.py`` that make the files the port's own runs need:
``compute_quantiles`` and ``merged_to_normed_h5``.

- ``load_processed``: open a merged grid file, keep the requested
  variables, slice (start_time, num_hours);
- ``normalize_ds`` / ``unnormalize_ds``: quantile-based (de)normalization in
  the modes minmax / robust / robust95 / quant95 / quant99;
- ``ds_to_sorted_np`` / ``np_to_ds``: conversions with sorted-variable
  channel order, "LCHW" or "CLHW"; ``nhwc_to_nchw`` / ``nchw_to_nhwc``.
"""

from __future__ import annotations

from datetime import timedelta
from typing import Optional, Sequence, Union

import numpy as np

from climate2weather_tpu_torch.data.grid import (
    GridDataset,
    QuantileDataset,
    convert_to_datetime,
    open_grid,
)
from climate2weather_tpu_torch.io import hdf5

NORM_MODES = ("minmax", "robust", "robust95", "quant95", "quant99")


def load_processed(ds_path: str, data_vars: Sequence[str], start_time: str, num_hours: int,
                   do_nan_check: bool = False) -> GridDataset:
    data_vars = sorted(data_vars)
    start_dt = convert_to_datetime(start_time)
    end_dt = start_dt + timedelta(hours=num_hours - 1)
    ds = open_grid(ds_path).select_vars(data_vars).sel_time(start_dt, end_dt)
    if do_nan_check:
        bad = {k: int(np.isnan(v).any(axis=(1, 2)).sum()) for k, v in ds.data_vars.items()
               if np.isnan(v).any()}
        if bad:
            raise RuntimeError(f"missing values in {ds_path} (frames with NaN per variable): {bad}")
    return ds


def _scale_offset(quantile_ds: QuantileDataset, mode: str):
    """Per-variable (offset, scale) such that normalized = (x - offset) / scale."""
    if mode == "minmax":
        lo, hi = quantile_ds.sel(0.0), quantile_ds.sel(1.0)
        return lo, {k: hi[k] - lo[k] for k in lo}
    if mode == "robust":
        med, q25, q75 = quantile_ds.sel(0.5), quantile_ds.sel(0.25), quantile_ds.sel(0.75)
        return med, {k: q75[k] - q25[k] for k in med}
    if mode == "robust95":
        med, q05, q95 = quantile_ds.sel(0.5), quantile_ds.sel(0.05), quantile_ds.sel(0.95)
        return med, {k: q95[k] - q05[k] for k in med}
    if mode == "quant95":
        q05, q95 = quantile_ds.sel(0.05), quantile_ds.sel(0.95)
        return q05, {k: q95[k] - q05[k] for k in q05}
    if mode == "quant99":
        q01, q99 = quantile_ds.sel(0.01), quantile_ds.sel(0.99)
        return q01, {k: q99[k] - q01[k] for k in q01}
    raise ValueError(f"Invalid mode: {mode}")


def _as_datasets(ds, quantile_ds):
    if isinstance(quantile_ds, str):
        quantile_ds = QuantileDataset.from_file(quantile_ds)
    if isinstance(ds, str):
        ds = open_grid(ds)
    return ds, quantile_ds


def normalize_ds(ds: Union[GridDataset, str], quantile_ds: Union[QuantileDataset, str],
                 mode: str) -> GridDataset:
    ds, quantile_ds = _as_datasets(ds, quantile_ds)
    offset, scale = _scale_offset(quantile_ds, mode)
    return ds.map(lambda k, v: (v - offset[k]) / scale[k])


def unnormalize_ds(ds: Union[GridDataset, str], quantile_ds: Union[QuantileDataset, str],
                   mode: str) -> GridDataset:
    ds, quantile_ds = _as_datasets(ds, quantile_ds)
    offset, scale = _scale_offset(quantile_ds, mode)
    return ds.map(lambda k, v: v * scale[k] + offset[k])


def ds_to_sorted_np(ds: GridDataset, data_vars: Sequence[str], ordering: str = "LCHW") -> np.ndarray:
    """Stack sorted variables into [L, C, H, W] (or [C, L, H, W])."""
    if ordering not in ("LCHW", "CLHW"):
        raise ValueError(f"Invalid ordering: {ordering}")
    return np.stack([ds.data_vars[v] for v in sorted(data_vars)], axis=0 if ordering == "CLHW" else 1)


def np_to_ds(np_arr: np.ndarray, reference_ds: GridDataset, data_vars: Sequence[str]) -> GridDataset:
    """[L, C, H, W] array -> GridDataset with the reference's coords."""
    want = (len(reference_ds.time), len(data_vars), len(reference_ds.rlat), len(reference_ds.rlon))
    if tuple(np_arr.shape) != want:
        raise ValueError(f"array {np_arr.shape}, reference and variables give {want}")
    return GridDataset({v: np.asarray(np_arr[:, i]) for i, v in enumerate(sorted(data_vars))},
                       dict(reference_ds.coords), dict(reference_ds.attrs))


def nhwc_to_nchw(x: np.ndarray) -> np.ndarray:
    """[L, H, W, C] device layout -> [L, C, H, W] storage layout."""
    return np.ascontiguousarray(np.moveaxis(x, -1, 1))


def nchw_to_nhwc(x: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(np.moveaxis(x, 1, -1))


def compute_quantiles(ds: GridDataset, quantiles: Sequence[float] = (
        0.0, 0.01, 0.05, 0.25, 0.5, 0.75, 0.95, 0.99, 1.0)) -> QuantileDataset:
    """Scalar per-variable quantiles over all of (time, rlat, rlon)."""
    qs = np.asarray(quantiles, np.float64)
    return QuantileDataset(qs, {k: np.quantile(v.astype(np.float64), qs) for k, v in ds.data_vars.items()})


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
