"""Experiment output loading (port of climate2weather_tpu/exp/exputil.py).

``setup(exp_dir)`` loads the generated sample ensemble (``gen_sample_*.nc``
with sample ids parsed from filenames), the ground truth, and the
observation through the port's ``data/grid.open_grid`` (no h5py needed),
converting ``psl`` from Pa to hPa as the reference does.
"""

from __future__ import annotations

import pathlib
import re
from typing import List, Tuple

from climate2weather_tpu_torch.data.grid import GridDataset, open_grid


def _pa_to_hpa(ds: GridDataset) -> GridDataset:
    if "psl" in ds.data_vars:
        return ds.map(lambda k, v: v / 100.0 if k == "psl" else v)
    return ds


def setup(exp_dir: str) -> Tuple[List[GridDataset], GridDataset, GridDataset]:
    """Returns (samples, ground_truth, observation); ``samples`` is a list
    indexed by sample_id."""
    exp_dir = pathlib.Path(exp_dir)
    sample_files = sorted(exp_dir.glob("gen_sample*.nc"))
    if not sample_files:
        raise FileNotFoundError(f"No gen_sample*.nc in {exp_dir}")

    samples = []
    for f in sample_files:
        m = re.search(r"gen_sample_?(\d+)", f.stem)
        sid = int(m.group(1)) if m else len(samples)
        ds = _pa_to_hpa(open_grid(str(f)))
        ds.attrs["sample_id"] = sid
        samples.append(ds)
    samples.sort(key=lambda d: d.attrs["sample_id"])

    gt = _pa_to_hpa(open_grid(str(exp_dir / "ground_truth.nc")))
    obs = _pa_to_hpa(open_grid(str(exp_dir / "observation.nc")))
    return samples, gt, obs
