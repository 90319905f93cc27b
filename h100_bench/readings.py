"""The readings a cell's limits are set from, on the card.

    python3 h100_bench/readings.py --workload <cell> --seeds 1000-1011 --control-seeds 1000-1002 [--out FILE]

For each of ``--seeds`` it runs the program's timed path as a run does
(sampling: one ensemble group through ``iter_samples``; training: the
checked steps of the train step) and the check's comparison against the
float32 reference, and prints the numbers compared. For each of
``--control-seeds`` it prints the same numbers for the control, the
reference with the network's tensors held in float8 e4m3 put in the
program's place, and, for a training cell, for the reference with the
planted fault of half of every round's rows left out. Each side's numbers
are held against the cell's own ``limits/<cell>.json`` by the check a run
makes, and its line gives the verdict as ``correct``. One JSON line each,
on standard output and appended to ``--out``. The benchmark's own runs do
not run this.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from h100_bench import harness, run  # noqa: E402


def seed_list(text: str) -> list:
    out = []
    for part in text.split(","):
        if part:
            a, _, b = part.partition("-")
            out += list(range(int(a), int(b or a) + 1))
    return out


def sampling_readings(cell: dict, seeds: list, control_seeds: list, dev, emit) -> None:
    from climate2weather_tpu_torch.exp.downscaling import iter_samples, load_net

    drv, config, traffic = cell["driver"], cell["config"], cell["traffic"]
    L, res, C = int(traffic["hours"]), int(config["resolution"]), int(config["variables"])
    members = int(traffic["sampler"]["ensemble_batch"])
    net, snap_cfg = load_net(str(harness.ROOT / config["weights"]["snapshot"]), dev)

    def numbers(side, seed, got, flags, ref, t):
        compared = drv.compare(got, flags, ref, cell["limits"])
        emit({"seed": seed, "side": side, **{k: v["value"] for k, v in compared.items.items()},
              "correct": compared.correct(), "s": time.time() - t})

    for seed in sorted(set(seeds) | set(control_seeds)):
        t = time.time()
        gt, train = drv.synthetic_inputs(L, res, res, C, int(traffic["calibration_frames"]),
                                         harness.seed_for(seed, "inputs"), dev)
        program_seed = harness.seed_for(seed, "sampler")
        mi = int(np.random.default_rng(harness.seed_for(seed, "check")).integers(members))
        ref = drv.reference_member(config, traffic, dev, gt, train, program_seed, mi)
        if seed in seeds:
            sids, samples, flags = next(iter_samples(net, snap_cfg, drv.sampler_config(traffic, program_seed, members),
                                                     gt, train, dev))
            numbers("program", seed, samples[mi], [(samples, flags)], ref, t)
        if seed in control_seeds:
            ctl = drv.reference_member(config, traffic, dev, gt, train, program_seed, mi, cast="fp8")
            numbers("control_fp8", seed, ctl, [(ctl.cpu().numpy(), np.zeros(1, bool))], ref, t)


def training_readings(cell: dict, seeds: list, control_seeds: list, dev, emit) -> None:
    drv, config, traffic = cell["driver"], cell["config"], cell["traffic"]
    n = int(traffic["check_steps"])

    def numbers(side, seed, got, ref, t):
        compared = drv.compare({**got, "window_losses": []}, ref, cell["limits"])
        emit({"seed": seed, "side": side, **drv.gaps(got, ref), "compared": sorted(compared.items),
              "correct": compared.correct(), "s": time.time() - t})

    for seed in sorted(set(seeds) | set(control_seeds)):
        t = time.time()
        got = None
        if seed in seeds:
            prog = drv.Program(config, traffic, dev, seed)
            got = prog.checked_steps(n)
            del prog
            torch.cuda.empty_cache()
        ref = drv.reference_run(config, traffic, dev, seed, n)
        if got is not None:
            numbers("program", seed, got, ref, t)
        if seed in control_seeds:
            numbers("control_fp8", seed, drv.reference_run(config, traffic, dev, seed, n, cast="fp8"), ref, t)
            numbers("fault_half_batch", seed, drv.reference_run(config, traffic, dev, seed, n, fault="half_batch"),
                    ref, t)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description="the readings a cell's limits are set from")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    cell = run.load_cell(args.workload)
    if not torch.cuda.is_available():
        run.fail("the readings are taken on the card")
    dev = torch.device("cuda", 0)
    out = open(args.out, "a") if args.out else None

    def emit(rec):
        rec = {"workload": args.workload, "card": torch.cuda.get_device_name(0), **rec}
        print(json.dumps(rec), flush=True)
        if out is not None:
            out.write(json.dumps(rec) + "\n")
            out.flush()

    try:
        readings = sampling_readings if cell["traffic"]["driver"] == "ensemble_sampling" else training_readings
        readings(cell, seed_list(args.seeds), seed_list(args.control_seeds), dev, emit)
    finally:
        if out is not None:
            out.close()


if __name__ == "__main__":
    main()
