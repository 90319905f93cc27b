"""The data-engineering command line (port of climate2weather_tpu/data/cli.py,
with argparse in place of click): the same ten commands, option names and
defaults, no ``cdo`` binary needed.

Usage:
    python -m climate2weather_tpu_torch.data.cli extract-patch --in-path F --out-path G
    python -m climate2weather_tpu_torch.data.cli extract-patch-folder --var-folder D --out-folder E \
        [--years 2006-2019]
    python -m climate2weather_tpu_torch.data.cli merge-time --out-path G F1 F2 ...
    python -m climate2weather_tpu_torch.data.cli select-dates --in-path F --out-path G --start S --end E
    python -m climate2weather_tpu_torch.data.cli merge-vars --out-path G F1 F2 ...
    python -m climate2weather_tpu_torch.data.cli quantiles --in-path F --out-path Q
    python -m climate2weather_tpu_torch.data.cli to-normed-h5 --merged-path F --quantile-path Q --out-path H
    python -m climate2weather_tpu_torch.data.cli debias --model-path M --reference-path R --out-path G
    python -m climate2weather_tpu_torch.data.cli synth --out-dir D [--spectrum mesoscale]
    python -m climate2weather_tpu_torch.data.cli preproc-all --raw-dir D --out-dir E
"""

from __future__ import annotations

import argparse
import os
import pathlib
import sys
from typing import Optional, Sequence

from climate2weather_tpu_torch.data import processing as proc
from climate2weather_tpu_torch.data.grid import open_grid


def extract_patch(a) -> None:
    """Slice the study patch by index ranges, interpolating NaN time steps;
    NaN occurrences write audit artifacts next to the output and the
    interpolation is checked again."""
    stem = os.path.splitext(a.out_path)[0]
    patch = proc.extract_patch(open_grid(a.in_path), (a.lat0, a.lat1), (a.lon0, a.lon1),
                               interpolate_nans=not a.no_interp, audit_path=None if a.no_audit else stem)
    patch.to_file(a.out_path)
    print(f"Wrote {a.out_path}: {patch.sizes}")


def extract_patch_folder(a) -> None:
    """Extract the study patch from every raw file of one variable's archive
    folder; the output files keep their archive names for preproc-all."""
    proc.extract_patch_folder(a.var_folder, a.out_folder, a.years, (a.lat0, a.lat1), (a.lon0, a.lon1))


def merge_time(a) -> None:
    """Concatenate files chronologically (cdo mergetime)."""
    proc.merge_time([open_grid(p) for p in a.in_paths]).to_file(a.out_path)
    print(f"Wrote {a.out_path}")


def select_dates(a) -> None:
    """Date-range split (cdo seldate; the reference uses 2006-2013 train,
    2014-2018 test)."""
    proc.select_dates(open_grid(a.in_path), a.start, a.end).to_file(a.out_path)
    print(f"Wrote {a.out_path}")


def merge_vars(a) -> None:
    """Merge single-variable files (cdo merge)."""
    proc.merge_vars([open_grid(p) for p in a.in_paths]).to_file(a.out_path)
    print(f"Wrote {a.out_path}")


def quantiles(a) -> None:
    """9 quantiles over (time, rlat, rlon) per variable."""
    qd = proc.compute_quantiles(open_grid(a.in_path))
    qd.to_file(a.out_path)
    print(f"Wrote {a.out_path}: {sorted(qd.values)}")


def to_normed_h5(a) -> None:
    """Build the [T, C, H, W] float32 training HDF5."""
    proc.merged_to_normed_h5(a.merged_path, a.quantile_path, a.out_path, a.norm_mode)
    print(f"Wrote {a.out_path}")


def debias(a) -> None:
    """Quantile-mapping bias correction of climate inputs (the
    'qm-debiased' conditioning files of the clim-downscaling experiments)."""
    from climate2weather_tpu_torch.data.debias import debias as qm_debias

    target = open_grid(a.target_path) if a.target_path else None
    qm_debias(open_grid(a.model_path), open_grid(a.reference_path), target, a.n_quantiles).to_file(a.out_path)
    print(f"Wrote {a.out_path}")


def synth(a) -> None:
    """Generate a synthetic COSMO-like workload (train h5, quantiles and a
    held-out eval grid)."""
    from climate2weather_tpu_torch.data.synthetic import build_synthetic_dataset

    build_synthetic_dataset(a.out_dir, train_hours=a.train_hours, eval_hours=a.eval_hours, res=a.res,
                            seed=a.seed, norm_mode=a.norm_mode, spectrum=a.spectrum)


def preproc_all(a) -> None:
    """The whole offline pipeline: mergetime per variable -> train/test
    splits -> quantiles (train) -> merge variables -> normalized training
    h5."""
    raw, out = pathlib.Path(a.raw_dir), pathlib.Path(a.out_dir)
    out.mkdir(parents=True, exist_ok=True)
    var_dirs = sorted(d for d in raw.iterdir() if d.is_dir())
    if not var_dirs:
        raise ValueError(f"No per-variable subdirectories in {a.raw_dir}")
    splits = {"train": a.train_range.split(","), "test": a.test_range.split(",")}
    merged_by_split = {}
    for split, (start, end) in splits.items():
        per_var = []
        for vd in var_dirs:
            # the *_with_missing.h5 NaN-audit artifacts of extract-patch repeat
            # time steps and are diagnostics, not data
            files = [f for f in sorted(vd.glob("*.nc")) + sorted(vd.glob("*.h5"))
                     if not f.name.endswith("_with_missing.h5")]
            merged = proc.merge_time([open_grid(str(f)) for f in files])
            per_var.append(proc.select_dates(merged, start, end))
        merged_by_split[split] = proc.merge_vars(per_var)
        path = out / f"{split}_merged-allvars.nc"
        merged_by_split[split].to_file(str(path))
        print(f"Wrote {path}")
    qd = proc.compute_quantiles(merged_by_split["train"])
    qpath = out / "train_quantiles.nc"
    qd.to_file(str(qpath))
    print(f"Wrote {qpath}")
    h5 = proc.merged_to_normed_h5(str(out / "train_merged-allvars.nc"), str(qpath), str(out / "train_normed.h5"),
                                  a.norm_mode)
    print(f"Wrote {h5}")


def _patch_options(p: argparse.ArgumentParser) -> None:
    (lat0, lat1), (lon0, lon1) = proc.DEFAULT_PATCH["lat_range"], proc.DEFAULT_PATCH["lon_range"]
    for name, default in (("--lat0", lat0), ("--lat1", lat1), ("--lon0", lon0), ("--lon1", lon1)):
        p.add_argument(name, type=int, default=default, help=f"(default {default})")


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m climate2weather_tpu_torch.data.cli",
                                 description=__doc__.splitlines()[0])
    sub = ap.add_subparsers(dest="command", required=True)

    def command(name, fn):
        p = sub.add_parser(name, help=fn.__doc__.splitlines()[0], description=fn.__doc__)
        p.set_defaults(fn=fn)
        return p

    p = command("extract-patch", extract_patch)
    p.add_argument("--in-path", required=True, help="Full-domain grid file")
    p.add_argument("--out-path", required=True)
    _patch_options(p)
    p.add_argument("--no-interp", action="store_true", help="Fail on NaN instead of interpolating")
    p.add_argument("--no-audit", action="store_true",
                   help="Skip the *_with_missing / *_nan_stats audit artifacts on NaN")
    p = command("extract-patch-folder", extract_patch_folder)
    p.add_argument("--var-folder", required=True, help="Per-variable folder of raw archive netCDF files")
    p.add_argument("--out-folder", required=True)
    p.add_argument("--years", default=None, help="Inclusive start-year filter on filenames, e.g. 2006-2019")
    _patch_options(p)
    for name, fn in (("merge-time", merge_time), ("merge-vars", merge_vars)):
        p = command(name, fn)
        p.add_argument("--out-path", required=True)
        p.add_argument("in_paths", nargs="+")
    p = command("select-dates", select_dates)
    p.add_argument("--in-path", required=True)
    p.add_argument("--out-path", required=True)
    p.add_argument("--start", required=True, help="YYYY-MM-DD[-HH]")
    p.add_argument("--end", required=True, help="YYYY-MM-DD[-HH]")
    p = command("quantiles", quantiles)
    p.add_argument("--in-path", required=True)
    p.add_argument("--out-path", required=True)
    p = command("to-normed-h5", to_normed_h5)
    p.add_argument("--merged-path", required=True)
    p.add_argument("--quantile-path", required=True)
    p.add_argument("--out-path", required=True)
    p.add_argument("--norm-mode", default="quant95", help="(default quant95)")
    p = command("debias", debias)
    p.add_argument("--model-path", required=True, help="Biased climate-model file")
    p.add_argument("--reference-path", required=True, help="Reanalysis reference file")
    p.add_argument("--target-path", default=None, help="File to transform (default: model-path)")
    p.add_argument("--out-path", required=True)
    p.add_argument("--n-quantiles", type=int, default=199, help="(default 199)")
    p = command("synth", synth)
    p.add_argument("--out-dir", required=True)
    p.add_argument("--train-hours", type=int, default=8784, help="(default 8784)")
    p.add_argument("--eval-hours", type=int, default=1488, help="(default 1488)")
    p.add_argument("--res", type=int, default=128, help="(default 128)")
    p.add_argument("--seed", type=int, default=0, help="(default 0)")
    p.add_argument("--norm-mode", default="quant95", help="(default quant95)")
    p.add_argument("--spectrum", default="smooth", choices=("smooth", "mesoscale"),
                   help="Spatial-spectrum family: 'mesoscale' is the realistic k^-3 -> k^-5/3 atmospheric "
                        "shape (for spectral-fidelity evaluation); 'smooth' the hyper-smooth law "
                        "(default smooth)")
    p = command("preproc-all", preproc_all)
    p.add_argument("--raw-dir", required=True, help="Directory with per-variable subdirs of grid files")
    p.add_argument("--out-dir", required=True)
    p.add_argument("--train-range", default="2006-01-01,2013-12-31", help="(default 2006-01-01,2013-12-31)")
    p.add_argument("--test-range", default="2014-01-01,2018-12-31", help="(default 2014-01-01,2018-12-31)")
    p.add_argument("--norm-mode", default="quant95", help="(default quant95)")
    return ap


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    args.fn(args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
