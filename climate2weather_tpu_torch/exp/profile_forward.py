"""Where a guided network evaluation spends its time on the card.

    python -m climate2weather_tpu_torch.exp.profile_forward [--members 3] [--out DIR]

Loads the 72.1M snapshot, then traces with ``torch.profiler`` (CPU and CUDA
activities) one guided evaluation of the s16_t6_spectral slice: the window
gather, two chunked UNet forwards over ``members x 32`` windows and the
detached guidance on a ``[members, 49, 128, 128, 4]`` trajectory. It prints
one JSON line: device time by kernel group, the top kernels, the wall time
of the traced evaluation, and the device's busy share of it. The Chrome
trace goes to ``--out``. It runs on the card; ``--device cpu`` (with a small
``--res``) only rehearses the script.
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
CONFIG = REPO / "exp" / "configs" / "000_on-model-eval" / "s16_t6_spectral.yml"

# kernel-name fragments -> group (first match wins)
GROUPS = (
    ("attention_fwd", "attention kernel"),
    ("attention_bwd", "attention backward kernel"),
    ("conv", "convolution"), ("xmma", "convolution"), ("cudnn", "convolution"),
    ("gemm", "matmul"), ("cutlass", "matmul"), ("cublas", "matmul"),
    ("reduce", "reduction"), ("fft", "fft"), ("index", "gather/scatter"),
    ("gather", "gather/scatter"), ("scatter", "gather/scatter"), ("copy", "copy"),
    ("elementwise", "elementwise"), ("upsample", "elementwise"),
)


def group_of(name: str) -> str:
    low = name.lower()
    for frag, group in GROUPS:
        if frag in low:
            return group
    return "other"


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--members", type=int, default=3)
    ap.add_argument("--res", type=int, default=128)
    ap.add_argument("--device", default="cuda", help="cpu only to rehearse the script")
    ap.add_argument("--out", default=str(REPO / "chiprun_out" / "profile"))
    args = ap.parse_args(argv)
    from climate2weather_tpu_torch.diffusion.guidance import (
        GaussianGuidance,
        SpatioTemporalCoarsening,
        per_channel,
    )
    from climate2weather_tpu_torch.diffusion.process import construct_process
    from climate2weather_tpu_torch.diffusion.window import WindowScoreFn
    from climate2weather_tpu_torch.exp.downscaling import load_net
    from climate2weather_tpu_torch.io.snapshot import yaml_load_file
    from climate2weather_tpu_torch.utils.device import resolve_device, set_reference_numerics

    dev = resolve_device(args.device)
    set_reference_numerics()
    net, snap = load_net(str(SNAPSHOT), dev)
    cfg = yaml_load_file(CONFIG)
    process = construct_process(**snap["pipeline_kwargs"])
    window = int(snap["dataset_kwargs"]["train"]["window"])
    C = int(snap["dataset_kwargs"]["train"]["num_features"])
    L, res = int(cfg["num_hours"]), args.res
    A = SpatioTemporalCoarsening(int(cfg["s_step"]), int(cfg["t_step"]))
    g = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn((args.members, L, res, res, C), generator=g, device=dev)
    guidance = GaussianGuidance(
        A=A, y=A(torch.randn((L, res, res, C), generator=g, device=dev)),
        std=per_channel(cfg["likelihood_std"], C, dev), gamma=per_channel(cfg["likelihood_gamma"], C, dev),
    )
    score = WindowScoreFn(net, window // 2, chunk_size=int(cfg["batch_size"]))

    def evaluation():
        return guidance.guided_eps(score, process, x, 0.5)

    with torch.no_grad():
        for _ in range(2):
            evaluation()
        sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
        sync()
        acts = [torch.profiler.ProfilerActivity.CPU]
        if dev.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.time()
            evaluation()
            sync()
            wall_ms = 1e3 * (time.time() - t0)
    pathlib.Path(args.out).mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(pathlib.Path(args.out) / "guided_evaluation.json"))

    kernels = {}
    for evt in prof.events():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            kernels.setdefault(evt.name, [0.0, 0])
            kernels[evt.name][0] += evt.device_time / 1e3  # us -> ms
            kernels[evt.name][1] += 1
    device_ms = sum(v[0] for v in kernels.values())
    groups = {}
    for name, (ms, _) in kernels.items():
        groups[group_of(name)] = groups.get(group_of(name), 0.0) + ms
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:12]
    print(json.dumps({
        "device": torch.cuda.get_device_name(0) if dev.type == "cuda" else "cpu",
        "members": args.members, "windows_per_forward": args.members * int(cfg["batch_size"]),
        "wall_ms": wall_ms, "device_kernel_ms": device_ms,
        "device_busy_share": device_ms / wall_ms if wall_ms else None,
        "groups_ms": dict(sorted(groups.items(), key=lambda kv: -kv[1])),
        "top_kernels": [{"name": n[:90], "ms": v[0], "calls": v[1]} for n, v in top],
        "kernel_launches": int(np.sum([v[1] for v in kernels.values()])),
    }), flush=True)


if __name__ == "__main__":
    main()
