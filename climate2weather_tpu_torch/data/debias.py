"""Quantile-mapping bias correction of climate-model inputs (port of
climate2weather_tpu/data/debias.py).

The year-downscaling experiments condition on raw ("biased") or
quantile-mapping-debiased CMIP6 fields
(``exp/configs/001_clim-downscaling/qm_debiased_*.yml``). This module makes
the debiased ones: per variable, each value goes through the climate
model's empirical CDF onto the reference's quantile function, both
estimated over a calibration period.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from climate2weather_tpu_torch.data.grid import GridDataset


def fit_quantile_mapping(model_ds: GridDataset, reference_ds: GridDataset,
                         n_quantiles: int = 199) -> Dict[str, Dict[str, np.ndarray]]:
    """Per variable, the transfer function model -> reference: both
    datasets' quantiles over all of (time, rlat, rlon) at levels
    1 / (n + 1), ..., n / (n + 1)."""
    qs = np.arange(1, n_quantiles + 1) / (n_quantiles + 1)
    mapping = {}
    for var in sorted(model_ds.data_vars):
        if var not in reference_ds.data_vars:
            raise KeyError(f"{var} is not in the reference")
        src_q = np.quantile(model_ds.data_vars[var].astype(np.float64), qs)
        ref_q = np.quantile(reference_ds.data_vars[var].astype(np.float64), qs)
        mapping[var] = {"quantiles": qs, "src": src_q, "ref": ref_q}
    return mapping


def apply_quantile_mapping(ds: GridDataset, mapping: Dict[str, Dict[str, np.ndarray]]) -> GridDataset:
    """Map values through the fitted transfer functions: linear between
    the quantile anchors, extended linearly beyond them."""

    def transform(var: str, values: np.ndarray) -> np.ndarray:
        src, ref = mapping[var]["src"], mapping[var]["ref"]
        out = np.interp(values, src, ref)
        # np.interp clamps outside [src[0], src[-1]]: extend the end segments instead
        lo_slope = (ref[1] - ref[0]) / max(src[1] - src[0], 1e-12)
        hi_slope = (ref[-1] - ref[-2]) / max(src[-1] - src[-2], 1e-12)
        out = np.where(values < src[0], ref[0] + (values - src[0]) * lo_slope, out)
        out = np.where(values > src[-1], ref[-1] + (values - src[-1]) * hi_slope, out)
        return out.astype(np.float32)

    return ds.map(lambda k, v: transform(k, v) if k in mapping else v)


def debias(model_ds: GridDataset, reference_ds: GridDataset, target_ds: Optional[GridDataset] = None,
           n_quantiles: int = 199) -> GridDataset:
    """Fit on (``model_ds``, ``reference_ds``) over a calibration period and
    apply to ``target_ds`` (by default ``model_ds``)."""
    mapping = fit_quantile_mapping(model_ds, reference_ds, n_quantiles)
    return apply_quantile_mapping(target_ds if target_ds is not None else model_ds, mapping)
