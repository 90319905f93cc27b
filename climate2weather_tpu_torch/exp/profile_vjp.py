"""What exact-gradient guidance costs per window batch on the card.

    python -m climate2weather_tpu_torch.exp.profile_vjp [--windows 32 64 96 128]

Loads the 72.1M snapshot and, for each window batch of ``[B, 128, 128, 52]``,
times the forward with no graph (the detached evaluation's network pass) and
:meth:`WindowScoreFn._windows_vjp`, the forward under grad and the backward
to the windows alone that exact guidance adds per window chunk, each the
mean of 3 calls after a warm-up, between ``torch.cuda.synchronize()`` calls
on the host clock. It prints one JSON line per batch with both times and
the VJP's peak device memory above what was allocated before it
(``max_memory_allocated``): the numbers that set ``window.VJP_WINDOWS``. It
runs on the card; ``--device cpu`` (with a small ``--res``) only rehearses
the script.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import time

import torch

REPO = pathlib.Path(__file__).resolve().parents[2]
SNAPSHOT = REPO / "artifacts" / "network-snapshot-0009437-0.999900"


def _mean_s(fn, device, reps=3) -> float:
    fn()
    if device.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    if device.type == "cuda":
        torch.cuda.synchronize()
    return (time.perf_counter() - t0) / reps


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--windows", type=int, nargs="+", default=[32, 64, 96, 128])
    ap.add_argument("--res", type=int, default=128)
    ap.add_argument("--snapshot", default=str(SNAPSHOT))
    ap.add_argument("--device", default="cuda", help="cpu only to rehearse the script")
    args = ap.parse_args(argv)
    from climate2weather_tpu_torch.diffusion.window import WindowScoreFn
    from climate2weather_tpu_torch.exp.downscaling import load_net
    from climate2weather_tpu_torch.utils.device import resolve_device, set_reference_numerics

    dev = resolve_device(args.device)
    set_reference_numerics()
    net, snap = load_net(args.snapshot, dev)
    window = int(snap["dataset_kwargs"]["train"]["window"])
    channels = int(snap["network_kwargs"]["channels"])
    score = WindowScoreFn(net, window // 2)
    g = torch.Generator(device=dev).manual_seed(0)
    for b in args.windows:
        xw = torch.randn((b, args.res, args.res, channels), generator=g, device=dev)
        co = torch.randn((b, args.res, args.res, channels), generator=g, device=dev)
        with torch.no_grad():
            fwd_s = _mean_s(lambda: net(xw, 0.5), dev)
        if dev.type == "cuda":
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated() if dev.type == "cuda" else 0
        vjp_s = _mean_s(lambda: score._windows_vjp(xw, 0.5, co), dev)
        peak = torch.cuda.max_memory_allocated() - base if dev.type == "cuda" else None
        print(json.dumps({"device": torch.cuda.get_device_name(0) if dev.type == "cuda" else "cpu",
                          "windows": b, "forward_s": fwd_s, "vjp_s": vjp_s, "vjp_over_forward": vjp_s / fwd_s,
                          "vjp_peak_bytes_over_base": peak,
                          "per_window_bytes": None if peak is None else peak / b}), flush=True)
        del xw, co


if __name__ == "__main__":
    main()
