"""Training soak with fault injection (port of the JAX repository's
``scripts/soak_training.py``).

Drives ``python -m climate2weather_tpu_torch.train`` as a chain of short
jobs, alternating clean slice exits (``--slice-data``, the reference's
time-limited-SLURM mechanism) with hard kills (SIGKILL mid-slice), and
asserts the recovery contract:

1. every restart resumes from the latest checkpoint (always-on
   ``load_latest``);
2. the chained and killed run's loss series equals, at every common ndata
   point, that of one uninterrupted run, bit for bit: the data stream, the
   per-step draws and the optimizer state resume exactly;
3. training reaches the target ndata, with finite and falling losses.

A killed start is SIGKILLed ``--kill-after`` seconds in, or, with
``--kill-past-checkpoint``, once it has written a checkpoint past its resume
point and logged a ``train/ndata`` beyond that checkpoint (read from
``metrics.jsonl``), so that the kill lands mid-slice however loaded the
host is.

Usage (CPU smoke)::

    python -m climate2weather_tpu_torch.scripts.soak_training --total 64Ki --slices 4 --device cpu

Production soak (the card)::

    python -m climate2weather_tpu_torch.scripts.soak_training --total 50Mi --slices 16 --kill-every 3

Writes SOAK.json in the soak's run dir with the assertion results.
:func:`soak` takes the train command, the data and the uninterrupted
reference run from its caller.
"""

from __future__ import annotations

import argparse
import json
import math
import pathlib
import shutil
import signal
import subprocess
import sys
import time
from typing import Callable, Optional

import numpy as np

from climate2weather_tpu_torch.scripts import REPO, child_env



def build_data(data_dir: pathlib.Path, res: int = 32, t: int = 256) -> str:
    from climate2weather_tpu_torch.data.grid import GridDataset
    from climate2weather_tpu_torch.data.processing import compute_quantiles, merged_to_normed_h5

    data_dir.mkdir(parents=True, exist_ok=True)
    h5 = data_dir / "train.h5"
    if h5.exists():
        return str(h5)
    rng = np.random.RandomState(0)
    time_ax = np.datetime64("2014-01-01T00", "ns") + np.arange(t) * np.timedelta64(1, "h")
    ds = GridDataset(
        {v: rng.randn(t, res, res).astype(np.float32) for v in ("psl", "tas", "uas", "vas")},
        {"time": time_ax, "rlat": np.linspace(-2, 2, res), "rlon": np.linspace(0, 4, res)},
    )
    ds.to_file(str(data_dir / "merged.nc"))
    compute_quantiles(ds).to_file(str(data_dir / "quantiles.nc"))
    merged_to_normed_h5(str(data_dir / "merged.nc"), str(data_dir / "quantiles.nc"), str(h5))
    return str(h5)


def train_cmd(run_dir, run_id, h5, total, batch, slice_data=None, platform=None):
    # Interval math scales with --total: a small CPU smoke wants checkpoints
    # every few steps so kills always have something to resume from, while
    # a 50Mi soak would drown in checkpoint writes. The loop asserts every
    # interval is a multiple of batch, checkpoint and snapshot also of 1024.
    total_nd = int(total)
    slice_nd = int(slice_data) if slice_data else total_nd

    def _round_to(n, quantum):
        return max(quantum, (n // quantum) * quantum)

    ckpt_quantum = batch * 1024 // math.gcd(batch, 1024)
    checkpoint = _round_to(min(slice_nd // 4, max(4 * batch, total_nd // 256)), ckpt_quantum)
    logging = _round_to(max(2 * batch, total_nd // 256), batch)
    status = _round_to(max(16 << 10, total_nd // 64), batch)
    cmd = [
        sys.executable, "-m", "climate2weather_tpu_torch.train",
        "--run-dir", str(run_dir), "--run-id", run_id,
        "--train-data", h5, "--spatial-res", "32", "--num-features", "4",
        "--markov-order", "2",
        "--model-config", str(REPO / "configs" / "tiny_unet.yml"),
        "--cache-data",
        "--lr", "1e-3", "--total-ndata", str(total_nd), "--batch", str(batch),
        "--status", str(status), "--snapshot", "1Gi",
        "--checkpoint", str(checkpoint), "--logging", str(logging),
        "--valid", "1Gi", "--seed", "42", "--device", platform or "cuda",
    ]
    if slice_data:
        cmd += ["--slice-data", slice_data]
    return cmd, child_env()


def read_losses(run_dir: pathlib.Path) -> dict:
    """{ndata: [losses]} from metrics.jsonl.

    Keyed on the exact stream position ``train/ndata``: after a mid-slice
    kill the replayed interval logs the same positions again, and bit-exact
    resume demands the replayed losses match the originals exactly.
    """
    out = {}
    path = run_dir / "metrics.jsonl"
    if not path.exists():
        return out
    for line in path.read_text().splitlines():
        try:
            rec = json.loads(line)
        except json.JSONDecodeError:
            continue
        if "train/loss" in rec:
            # kdata = ndata // 1000 is lossy; exact train/ndata is on every
            # record the loop writes, the fallback serves older logs only
            key = rec.get("train/ndata", rec["train/kdata"] * 1000)
            out.setdefault(key, []).append(rec["train/loss"])
    return out


def _checkpoints(run_dir: pathlib.Path) -> set:
    return {p.name for p in run_dir.glob("training-state-*.ckpt")} if run_dir.is_dir() else set()


def past_checkpoint(run_dir: pathlib.Path) -> Callable[[], bool]:
    """The kill condition of one start, read from its run directory: true
    once a checkpoint that was not there at the start exists and
    ``metrics.jsonl`` then logs a ``train/ndata`` beyond every position
    logged when it appeared; that ndata is kept as the condition's
    ``ndata``."""
    before = _checkpoints(run_dir)
    seen_at = []

    def due() -> bool:
        logged = max(read_losses(run_dir), default=0)
        if not seen_at:
            if _checkpoints(run_dir) - before:
                seen_at.append(logged)
            return False
        if logged > seen_at[0]:
            due.ndata = logged
            return True
        return False

    due.ndata = None
    return due


def run_to_completion(cmd, env, log, kill_after=None, kill_when=None, poll=1.0):
    """Run ``cmd`` to its end, appending its output to ``log``; returns its
    exit code, or -9 where it was SIGKILLed: ``kill_after`` seconds in, or
    once ``kill_when()`` is true (checked every ``poll`` seconds)."""
    with open(log, "ab") as f:
        proc = subprocess.Popen(cmd, stdout=f, stderr=subprocess.STDOUT, env=env)
        if kill_after is None and kill_when is None:
            return proc.wait()
        deadline = None if kill_after is None else time.time() + kill_after
        while deadline is None or time.time() < deadline:
            if proc.poll() is not None:
                return proc.returncode  # finished before the kill
            if kill_when is not None and kill_when():
                break
            time.sleep(poll)
        proc.send_signal(signal.SIGKILL)
        proc.wait()
        return -9


def check(results: dict, soak_dir: pathlib.Path, ref_dir: Optional[pathlib.Path]) -> dict:
    """The soak's assertions on its losses, recorded in ``results``."""
    soak_losses = read_losses(soak_dir)
    # 1. no interval logged twice with different values (a rerun of
    #    already-trained data would log differing losses)
    dupes = {k: v for k, v in soak_losses.items() if len(set(np.float32(x) for x in v)) > 1}
    results["duplicate_interval_mismatches"] = len(dupes)
    results["replayed_log_points"] = sum(1 for v in soak_losses.values() if len(v) > 1)
    assert not dupes, f"re-trained intervals produced different losses: {dupes}"

    final_losses = {k: v[-1] for k, v in soak_losses.items()}
    ks = sorted(final_losses)
    assert all(np.isfinite(final_losses[k]) for k in ks), "non-finite loss"
    results["first_loss"] = final_losses[ks[0]]
    results["final_loss"] = final_losses[ks[-1]]
    assert final_losses[ks[-1]] < final_losses[ks[0]], "loss did not decrease"

    # 2. bit-exact parity with the uninterrupted run at every common ndata
    if ref_dir is not None:
        ref_losses = {k: v[-1] for k, v in read_losses(ref_dir).items()}
        common = sorted(set(ref_losses) & set(final_losses))
        assert common, "no common kdata points between ref and soak runs"
        mism = [k for k in common if np.float32(ref_losses[k]) != np.float32(final_losses[k])]
        results["common_log_points"] = len(common)
        results["loss_parity_mismatches"] = len(mism)
        assert not mism, (f"loss series diverged from the uninterrupted run at ndata {mism[:5]}"
                          " — ndata-resume is not bit-exact")
    return results


def chain(start_cmd: Callable[[], tuple], soak_dir: pathlib.Path, log, total: int, killed: Callable[[int], bool],
          results: dict, kill_after=None, kill_past_checkpoint=False, max_starts=24, poll=1.0) -> dict:
    """Start ``start_cmd()`` until ``soak_dir`` has logged ``total``; start n
    (from 1) is SIGKILLed where ``killed(n)``. Each start's record goes to
    ``results["restarts"]``."""
    n_starts = 0
    t0 = time.time()
    while True:
        kill = killed(n_starts + 1)
        cmd, env = start_cmd()
        when = past_checkpoint(soak_dir) if kill and kill_past_checkpoint else None
        rc = run_to_completion(cmd, env, log, kill_after=kill_after if kill and when is None else None,
                               kill_when=when, poll=poll)
        n_starts += 1
        losses = read_losses(soak_dir)
        rec = {"start": n_starts, "rc": rc, "killed": kill and rc == -9, "max_ndata": max(losses) if losses else 0}
        if rec["killed"] and when is not None:
            rec["killed_at_ndata"] = when.ndata
        results["restarts"].append(rec)
        print(f"slice {n_starts}: rc={rc} kill={kill} "
              f"progress={max(losses) if losses else 0} / {total} ndata", flush=True)
        if losses and max(losses) >= total:
            break
        assert n_starts < max_starts, f"soak not converging after {n_starts} starts; see {log}"
    results["soak_wall_s"] = round(time.time() - t0, 1)
    results["n_starts"] = n_starts
    return results


def soak(work: pathlib.Path, total: int, slices: int, batch: int, kill_every: int = 2, kill_after=45.0,
         platform=None, skip_reference_run=False, resume=False, kill_past_checkpoint=False,
         cmd_fn: Optional[Callable] = None, ref_dir: Optional[pathlib.Path] = None, poll=1.0) -> dict:
    """The soak in ``work``. ``cmd_fn(run_dir, run_id, slice_data=None)``
    gives a start's ``(cmd, env)``, its data included (default:
    :func:`train_cmd` on the tiny net and :func:`build_data`'s file), and
    ``ref_dir`` a finished uninterrupted run to hold the losses against
    (default: one run here, unless ``skip_reference_run``). Returns the
    results, also written to SOAK.json."""
    work = pathlib.Path(work)
    # per-start data budget, rounded down so batch divides it; the chain
    # below runs until total is reached, so rounding only shifts boundaries
    slice_nd = (total // slices // batch) * batch
    assert slice_nd > 0, "--slices too large for --total at this --batch"
    if cmd_fn is None:
        h5 = build_data(work / "data")
        cmd_fn = lambda run_dir, run_id, slice_data=None: train_cmd(  # noqa: E731
            run_dir, run_id, h5, str(total), batch, slice_data=slice_data, platform=platform)

    results = {"total_ndata": total, "slices": slices, "restarts": []}

    # --- uninterrupted reference run -------------------------------------
    if ref_dir is None and not skip_reference_run:
        ref_dir = work / "runs" / "ref"
        ref_done = resume and max(read_losses(ref_dir), default=0) >= total
        if ref_done:
            print(f"resume: reference run already complete in {ref_dir}")
        else:
            if ref_dir.exists():
                shutil.rmtree(ref_dir)
            cmd, env = cmd_fn(work / "runs", "ref")
            t0 = time.time()
            rc = run_to_completion(cmd, env, work / "ref.log")
            assert rc == 0, f"reference run failed rc={rc}; see {work}/ref.log"
            results["ref_wall_s"] = round(time.time() - t0, 1)

    # --- chained + killed run --------------------------------------------
    soak_dir = work / "runs" / "soak"
    if soak_dir.exists() and not resume:
        shutil.rmtree(soak_dir)
    if resume:
        prior = max(read_losses(soak_dir), default=0)
        results["resumed_at_ndata"] = prior
        print(f"resume: continuing soak from {prior} / {total} ndata")
    work.mkdir(parents=True, exist_ok=True)
    chain(lambda: cmd_fn(work / "runs", "soak", str(slice_nd)), soak_dir, work / "soak.log", total,
          lambda n: n % kill_every == 0, results, kill_after=kill_after,
          kill_past_checkpoint=kill_past_checkpoint, max_starts=slices * 4 + 8, poll=poll)

    check(results, soak_dir, ref_dir)
    out = soak_dir / "SOAK.json"
    out.write_text(json.dumps(results, indent=2))
    print(json.dumps(results, indent=2))
    print(f"SOAK PASSED: {results['n_starts']} starts "
          f"({sum(1 for r in results['restarts'] if r['killed'])} hard kills), "
          f"loss parity on {results.get('common_log_points', 'n/a')} points")
    return results


def main(argv=None):
    from climate2weather_tpu_torch.utils.ndata import parse_ndata

    ap = argparse.ArgumentParser(prog="python -m climate2weather_tpu_torch.scripts.soak_training")
    ap.add_argument("--total", default="64Ki")
    ap.add_argument("--slices", type=int, default=4)
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--kill-every", type=int, default=2,
                    help="hard-kill every Nth slice instead of clean exit")
    ap.add_argument("--kill-after", type=float, default=45.0,
                    help="seconds into a killed slice before SIGKILL")
    ap.add_argument("--kill-past-checkpoint", action="store_true",
                    help="SIGKILL a killed slice once it has written a checkpoint past its resume point and "
                         "logged a train/ndata beyond it (metrics.jsonl), instead of after --kill-after")
    ap.add_argument("--device", "--platform", dest="device", default="cuda",
                    help="the trainer's --device: cuda (the default) or cpu")
    ap.add_argument("--work-dir", default="/tmp/c2w_soak")
    ap.add_argument("--skip-reference-run", action="store_true",
                    help="skip the uninterrupted run (no loss-parity check)")
    ap.add_argument("--resume", action="store_true",
                    help="continue an interrupted soak in --work-dir instead of "
                    "wiping it (an externally-killed soak is itself a fault "
                    "injection; the same bit-exact-resume assertions apply)")
    args = ap.parse_args(argv)
    soak(pathlib.Path(args.work_dir), parse_ndata(args.total), args.slices, args.batch,
         kill_every=args.kill_every, kill_after=args.kill_after, platform=args.device,
         skip_reference_run=args.skip_reference_run, resume=args.resume,
         kill_past_checkpoint=args.kill_past_checkpoint, poll=0.1 if args.kill_past_checkpoint else 1.0)


if __name__ == "__main__":
    main()
