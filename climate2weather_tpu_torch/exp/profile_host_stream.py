"""What the host-streaming tier's second staging buffer gives on the card.

    python -m climate2weather_tpu_torch.exp.profile_host_stream [--hours 523] [--reps 5]

Loads the 72.1M snapshot (bf16) and times one host-streamed evaluation,
:class:`HostStreamingScoreFn` over a ``[hours, 128, 128, C]`` noise
trajectory in chunks of ``--batch`` windows, with two staging buffers a
direction (``slots = 2``: the host's copies overlap the card's forwards)
and with one (``slots = 1``: each chunk's copies wait for its forward),
alternating, ``--reps`` times each after a warm-up of each, on the host
clock (an evaluation returns a host array, so its end waits for the card).
It prints one JSON line per setting with every reading, their mean and the
host seconds in copies, and a last line with the mean gain of two slots over
one, the spread of either setting's readings, and whether both settings
gave the same bits. It runs on the card; ``--device cpu`` (with a small
``--res``, ``--hours`` and ``--batch``) only rehearses the script.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import time

import numpy as np
import torch

REPO = pathlib.Path(__file__).resolve().parents[2]
SNAPSHOT = REPO / "artifacts" / "network-snapshot-0009437-0.999900"


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--hours", type=int, default=523)
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--res", type=int, default=128)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--snapshot", default=str(SNAPSHOT))
    ap.add_argument("--device", default="cuda", help="cpu only to rehearse the script")
    args = ap.parse_args(argv)
    from climate2weather_tpu_torch.diffusion.host_stream import HostStreamingScoreFn
    from climate2weather_tpu_torch.exp.downscaling import load_net
    from climate2weather_tpu_torch.utils.device import resolve_device, set_reference_numerics

    dev = resolve_device(args.device)
    set_reference_numerics()
    net, snap = load_net(args.snapshot, dev)
    window = int(snap["dataset_kwargs"]["train"]["window"])
    C = int(snap["dataset_kwargs"]["train"]["num_features"])
    x = np.random.default_rng(0).standard_normal((args.hours, args.res, args.res, C), dtype=np.float32)
    scores = {slots: HostStreamingScoreFn(net, window // 2, batch_size=args.batch, device=dev) for slots in (2, 1)}
    readings = {slots: [] for slots in scores}
    outs = {}
    with torch.no_grad():
        for slots, score in scores.items():
            score.slots = slots
            outs[slots] = score(x, 0.5)  # the warm-up
            score.timings.update(evals=0, eval_s=0.0, copy_s=0.0)
        for _ in range(args.reps):
            for slots, score in scores.items():
                t0 = time.perf_counter()
                score(x, 0.5)
                readings[slots].append(time.perf_counter() - t0)
    name = torch.cuda.get_device_name(0) if dev.type == "cuda" else "cpu"
    n = args.hours - 2 * (window // 2)
    for slots, score in scores.items():
        print(json.dumps({"device": name, "slots": slots, "hours": args.hours, "batch": args.batch,
                          "chunks": -(-n // min(n, args.batch)), "eval_s": readings[slots],
                          "eval_s_mean": float(np.mean(readings[slots])),
                          "copy_s_mean": score.timings["copy_s"] / score.timings["evals"]}), flush=True)
    one, two = (float(np.mean(readings[s])) for s in (1, 2))
    print(json.dumps({"device": name, "gain_s": one - two, "gain_share": (one - two) / one,
                      "spread_s": max(float(np.ptp(readings[s])) for s in (1, 2)),
                      "bits_equal": bool(np.array_equal(outs[1], outs[2]))}), flush=True)


if __name__ == "__main__":
    main()
