"""Absolute-amplitude ratio diagnostic for saved fidelity ensembles (port of
the JAX repository's ``scripts/amplitude_ratio.py``).

Every committed gating metric is shape-normalized (MELR over normalized
RAPSD) or gt-standardized (sliced W2, CRPS), so a uniform amplitude error
in the generated fields never surfaces as its own line item — H6
(`docs/fidelity/meso128/H6_RESULT.md`) had to discover the production
model's 3–6× absolute over-amplitude indirectly, through the normalized
spectral re-weighting a power-budget change causes. This tool measures the
quantity directly, per H8_PREREG.md:

    r[s, t] = std_space(sample[s, t]) / std_space(gt[t])

in physical units on time-aligned frames, reporting the median over
(s, t) (the H8 gate statistic) and mean ± std (context), per variable.

It is strictly POST-HOC: it reads the ``gen_sample_*.nc`` /
``ground_truth.nc`` files a fidelity eval already wrote (reference layout
parity: exp/downscaling.py save path; see
climate2weather_tpu_torch/exp/downscaling.py gen_sample writer).

Usage::

    python -m climate2weather_tpu_torch.scripts.amplitude_ratio CFG_DIR [CFG_DIR ...] [--out -]

CFG_DIR is a downscaling output config dir (e.g.
``runs/h8_eval_sde/guided/001_config``) containing ``gen_sample_*.nc``
and ``ground_truth.nc``.
"""

from __future__ import annotations

import argparse
import pathlib
import sys

import numpy as np

from climate2weather_tpu_torch.data.grid import open_grid


def frame_std(fields: np.ndarray) -> np.ndarray:
    """Spatial std per leading index of [T, H, W] (float64)."""
    x = np.asarray(fields, np.float64)
    return x.reshape(x.shape[0], -1).std(axis=1)


def amplitude_ratios(cfg_dir: pathlib.Path):
    """{var: ratios [S, T]} for one config dir, frames aligned by time."""
    gt_ds = open_grid(str(cfg_dir / "ground_truth.nc"))
    gt_times = np.asarray(gt_ds.time)
    samples = sorted(cfg_dir.glob("gen_sample_*.nc"))
    if not samples:
        raise SystemExit(f"amplitude_ratio: no gen_sample_*.nc in {cfg_dir}")
    out = {v: [] for v in gt_ds.var_names()}
    gt_std = {v: frame_std(gt_ds.data_vars[v]) for v in gt_ds.var_names()}
    for path in samples:
        ds = open_grid(str(path))
        sel = np.isin(gt_times, np.asarray(ds.time))
        if sel.sum() != ds.sizes["time"]:
            raise SystemExit(
                f"amplitude_ratio: {path.name}: ground_truth covers "
                f"{int(sel.sum())} of {ds.sizes['time']} sample times"
            )
        for v in out:
            denom = gt_std[v][sel]
            if not np.all(denom > 0):
                raise SystemExit(
                    f"amplitude_ratio: zero-variance gt frame for {v}"
                )
            out[v].append(frame_std(ds.data_vars[v]) / denom)
    return {v: np.stack(r) for v, r in out.items()}


def report(cfg_dirs) -> str:
    lines = ["# Absolute-amplitude ratio (sample std / truth std, physical units)", ""]
    for d in cfg_dirs:
        cfg = pathlib.Path(d)
        ratios = amplitude_ratios(cfg)
        n_s = next(iter(ratios.values())).shape[0]
        lines += [
            f"## {d}",
            "",
            f"{n_s} samples × {next(iter(ratios.values())).shape[1]} frames",
            "",
            "| variable | median | mean ± std |",
            "|---|---|---|",
        ]
        for v in sorted(ratios):
            r = ratios[v]
            lines.append(
                f"| {v} | {np.median(r):.3f} | "
                f"{r.mean():.3f} ± {r.std():.3f} |"
            )
        lines.append("")
    return "\n".join(lines) + "\n"


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m climate2weather_tpu_torch.scripts.amplitude_ratio")
    ap.add_argument("cfg_dirs", nargs="+")
    ap.add_argument("--out", default="-")
    args = ap.parse_args(argv)
    text = report(args.cfg_dirs)
    if args.out == "-":
        sys.stdout.write(text)
    else:
        pathlib.Path(args.out).write_text(text)


if __name__ == "__main__":
    main()
