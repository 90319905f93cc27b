"""Watch a training run and probe new snapshots for the progression table
(port of the JAX repository's ``scripts/probe_watcher.py``).

Polls RUN_DIR for ``network-snapshot-*-{rate}`` directories; for each
snapshot on the probe cadence (every N Mi of ndata), runs a small guided
fidelity probe (``python -m climate2weather_tpu_torch.exp.fidelity``, a
child process on the card) into ``PROBE_ROOT/<kdata>/``, the layout
``progression_report`` tabulates. Probes are serialized and may run beside
training on the same card. A probe failure (e.g. a wedge that the training
supervisor recovers from) is logged and retried on the next poll rather
than killing the watcher.

Usage::

  python -m climate2weather_tpu_torch.scripts.probe_watcher RUN_DIR PROBE_ROOT \
      --data-nc runs/synth/eval_merged.nc --quantiles runs/synth/quantiles.h5 \
      --start-time 2014-01-07-00 [--every-mi 2] [--rate 0.999000] [--device cuda]
"""

from __future__ import annotations

import argparse
import pathlib
import re
import subprocess
import sys
import time

from climate2weather_tpu_torch.scripts import child_env

SNAP_RE = re.compile(r"network-snapshot-(\d{7})-([\d.]+)$")


def due_snapshots(run_dir: pathlib.Path, rate: str, every_mi: int):
    """(kdata, path) for snapshots on the cadence, sorted ascending."""
    out = []
    if not run_dir.is_dir():  # trainer may not have created it yet
        return out
    for p in run_dir.iterdir():
        m = SNAP_RE.match(p.name)
        if not m or m.group(2) != rate:
            continue
        kdata = int(m.group(1))
        # On-cadence = within a quarter-Mi of a multiple of every_mi. A plain
        # round() would also catch half-Mi snapshots (round-half-even pulls
        # 2.5Mi -> 2) when the trainer snapshots at sub-Mi intervals.
        mi_f = kdata / 1048.576
        near = round(mi_f / every_mi) * every_mi
        if near > 0 and abs(mi_f - near) <= 0.25:
            out.append((kdata, p))
    return sorted(out)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="python -m climate2weather_tpu_torch.scripts.probe_watcher")
    ap.add_argument("run_dir")
    ap.add_argument("probe_root")
    ap.add_argument("--data-nc", required=True)
    ap.add_argument("--quantiles", required=True)
    ap.add_argument("--start-time", required=True)
    ap.add_argument("--every-mi", type=int, default=2)
    ap.add_argument("--rate", default="0.999000")
    ap.add_argument("--num-samples", type=int, default=6)
    ap.add_argument("--steps", type=int, default=32)
    ap.add_argument("--poll-sec", type=int, default=300)
    ap.add_argument("--max-idle-polls", type=int, default=48,
                    help="exit after this many polls with nothing new due")
    ap.add_argument("--device", default="cuda", help="the probes' --device: cuda (the default) or cpu")
    args = ap.parse_args(argv)

    run_dir = pathlib.Path(args.run_dir)
    probe_root = pathlib.Path(args.probe_root)
    probe_root.mkdir(parents=True, exist_ok=True)
    idle = 0
    failures: dict[int, int] = {}
    max_failures = 3
    while idle < args.max_idle_polls:
        succeeded = False
        for kdata, snap in due_snapshots(run_dir, args.rate, args.every_mi):
            out = probe_root / str(kdata)
            if (out / "FIDELITY.md").exists():
                continue  # probed already
            if failures.get(kdata, 0) >= max_failures:
                continue  # permanently failing snapshot: give up, don't spin
            print(f"[probe_watcher] probing {snap.name} -> {out}", flush=True)
            cmd = [
                sys.executable, "-m", "climate2weather_tpu_torch.exp.fidelity",
                "--snapshot", str(snap),
                "--data-nc", args.data_nc,
                "--quantiles", args.quantiles,
                "--out", str(out),
                "--start-time", args.start_time,
                "--num-samples", str(args.num_samples),
                "--num-sampling-steps", str(args.steps),
                "--uncond-samples", "2",
                "--skip-figures",
                "--device", args.device,
            ]
            rc = subprocess.run(cmd, env=child_env()).returncode
            print(f"[probe_watcher] {snap.name} rc={rc}", flush=True)
            if rc == 0:
                succeeded = True
            else:
                failures[kdata] = failures.get(kdata, 0) + 1
        # only a successful probe resets the idle clock: a permanently
        # failing probe must not keep the watcher alive forever
        idle = 0 if succeeded else idle + 1
        time.sleep(args.poll_sec)
    print("[probe_watcher] idle limit reached; exiting", flush=True)


if __name__ == "__main__":
    main()
