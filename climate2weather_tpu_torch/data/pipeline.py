"""Normalization and tensor <-> grid conversion (port of
climate2weather_tpu/data/pipeline.py). ``compute_quantiles`` and
``merged_to_normed_h5`` are in ``data/processing.py`` and importable from
here too.

- ``load_processed``: open a merged grid file, keep the requested
  variables, slice (start_time, num_hours);
- ``normalize_ds`` / ``unnormalize_ds``: quantile-based (de)normalization in
  the modes minmax / robust / robust95 / quant95 / quant99;
- ``ds_to_sorted_np`` / ``np_to_ds``: conversions with sorted-variable
  channel order, "LCHW" or "CLHW"; ``nhwc_to_nchw`` / ``nchw_to_nhwc``.
"""

from __future__ import annotations

from datetime import timedelta
from typing import Sequence, Union

import numpy as np

from climate2weather_tpu_torch.data.grid import (
    GridDataset,
    QuantileDataset,
    convert_to_datetime,
    open_grid,
)

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


def __getattr__(name: str):
    """``compute_quantiles`` and ``merged_to_normed_h5`` live in
    ``data/processing.py``, as in the JAX package; they stay importable from
    here."""
    if name in ("compute_quantiles", "merged_to_normed_h5"):
        from climate2weather_tpu_torch.data import processing

        return getattr(processing, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
