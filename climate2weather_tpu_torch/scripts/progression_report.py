"""Collect per-checkpoint fidelity-probe metrics into a progression table
(the port's own copy of the JAX repository's ``scripts/progression_report.py``).

Each probe directory (one per training snapshot, e.g. produced by running
``python -m climate2weather_tpu_torch.exp.fidelity --out PROBES/<kdata> ...``
per snapshot, as ``probe_watcher`` does) contains a guided prediction run
with its metrics pickle.  This
tool tabulates the quality trajectory across training — the
reference-protocol metrics (sliced W2 / MELR / SSIM, exp/metrics.py:219-296)
plus the ensemble-calibration measures (fair CRPS, spread/skill,
rank-reliability) — one row per checkpoint, one column group per variable.

Usage::

    python -m climate2weather_tpu_torch.scripts.progression_report PROBE_ROOT [--metrics w2,ssim,...]
"""

from __future__ import annotations

import argparse
import pathlib
import pickle

import numpy as np

# short name -> (metrics.pickle key, format)
METRIC_KEYS = {
    "w2": ("wasserstein", "{:.1f}"),
    "melr": ("melr", "{:.2f}"),
    "ssim": ("ssim", "{:.3f}"),
    "crps": ("crps", "{:.3f}"),
    "spread_skill": ("spread_skill", "{:.2f}"),
    "rank_ri": ("rank_reliability", "{:.2f}"),
}


def load_probe_metrics(probe_dir: pathlib.Path) -> dict | None:
    """Load the guided run's metrics pickle from one probe directory."""
    hits = sorted(probe_dir.glob("guided/*/metrics/run/metrics.pickle"))
    if not hits:
        return None
    with open(hits[-1], "rb") as f:
        return pickle.load(f)


def progression_rows(root: pathlib.Path):
    """Yield (kdata, metrics dict) sorted by checkpoint, skipping incomplete
    probes."""
    for sub in sorted(root.iterdir()):
        if not (sub.is_dir() and sub.name.isdigit()):
            continue
        m = load_probe_metrics(sub)
        if m is not None:
            yield int(sub.name), m


def format_table(rows, metric_names) -> str:
    lines = []
    for short in metric_names:
        key, fmt = METRIC_KEYS[short]
        variables = None
        body = []
        for kdata, m in rows:
            if key not in m or not m[key]:
                continue
            if variables is None:
                variables = sorted(m[key])
            vals = []
            for v in variables:
                entry = m[key].get(v, {}).get("global")
                vals.append(fmt.format(np.mean(entry)) if entry is not None
                            else "n/a")
            # snapshot numbers are kdata = ndata // 1000 (training/checkpoint.py)
            body.append(f"| {kdata / 1000:.2f}M | " + " / ".join(vals) + " |")
        if not body:
            continue
        lines.append(f"### {key} ({' / '.join(variables)})")
        lines.append("")
        lines.append("| checkpoint | " + key + " |")
        lines.append("|---|---|")
        lines.extend(body)
        lines.append("")
    return "\n".join(lines)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="python -m climate2weather_tpu_torch.scripts.progression_report")
    ap.add_argument("probe_root")
    ap.add_argument(
        "--metrics",
        default="w2,melr,ssim,crps,spread_skill,rank_ri",
        help=f"comma list from {sorted(METRIC_KEYS)}",
    )
    args = ap.parse_args(argv)
    rows = list(progression_rows(pathlib.Path(args.probe_root)))
    if not rows:
        raise SystemExit(f"No completed probes under {args.probe_root}")
    print(format_table(rows, [m.strip() for m in args.metrics.split(",")]))


if __name__ == "__main__":
    main()
