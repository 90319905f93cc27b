"""Where a training step spends its time on the card.

    python -m climate2weather_tpu_torch.exp.profile_train_step [--batch 64] [--batch-gpu 32] [--out DIR]

Builds the network of ``configs/sda_unet.yml`` (flax-style init from a
seed; 52 channels = 4 variables x a 13-frame window; bf16 compute, fp32
parameters) and a device-resident random [frames, 4, res, res] dataset,
takes three warm train steps of the device-data path (gradient
accumulation over ``batch / batch_gpu`` microbatches, AdamW, EMA), then
traces two more with ``torch.profiler`` (CPU and CUDA activities). It
prints one JSON line: the wall time per step, device kernel time by group,
the top kernels, the device's busy share, and the program's spans
(``utils/trace.py``, enabled for the traced steps) per step. The Chrome
trace, which carries the spans, goes to ``--out``. It runs on the card;
``--device cpu`` with a small ``--res`` and ``--model-config
configs/tiny_unet.yml`` only rehearses the script.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import time

import numpy as np
import torch

from climate2weather_tpu_torch.exp.profile_forward import device_kernels, group_of, span_totals

REPO = pathlib.Path(__file__).resolve().parents[2]


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--batch-gpu", type=int, default=32)
    ap.add_argument("--res", type=int, default=128)
    ap.add_argument("--frames", type=int, default=140)
    ap.add_argument("--model-config", default=str(REPO / "configs" / "sda_unet.yml"))
    ap.add_argument("--device", default="cuda", help="cpu only to rehearse the script")
    ap.add_argument("--out", default=str(REPO / "runs" / "profile"))
    args = ap.parse_args(argv)
    from climate2weather_tpu_torch.diffusion.process import VPCosineProcess
    from climate2weather_tpu_torch.io.snapshot import yaml_load_file
    from climate2weather_tpu_torch.models.init import init_params
    from climate2weather_tpu_torch.models.score_net import build_score_unet
    from climate2weather_tpu_torch.training.state import (
        init_train_state,
        make_device_data_train_step,
        make_optimizer,
        step_generator,
    )
    from climate2weather_tpu_torch.utils import trace
    from climate2weather_tpu_torch.utils.device import resolve_device, set_reference_numerics

    dev = resolve_device(args.device)
    set_reference_numerics()
    window, n_features = 13, 4
    net = build_score_unet({"channels": n_features * window, **yaml_load_file(args.model_config)},
                           dtype=torch.bfloat16 if dev.type == "cuda" else torch.float32)
    init_params(net, torch.Generator().manual_seed(0))
    net = net.to(dev)
    state = init_train_state(net, make_optimizer(net.parameters(), {}), (0.9999,))
    step = make_device_data_train_step(VPCosineProcess(), lambda s: 2e-4, window, (0.9999,))
    g = torch.Generator(device=dev).manual_seed(0)
    data = torch.randn((args.frames, n_features, args.res, args.res), generator=g, device=dev)
    rounds = args.batch // args.batch_gpu
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)

    def one_step():
        idx = torch.randint(0, args.frames - window + 1, (rounds, args.batch_gpu), generator=g,
                            device=dev)
        step(state, data, idx, step_generator(0, state.step, dev))

    for _ in range(3):
        one_step()
    sync()
    acts = [torch.profiler.ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    traced = 2
    trace.reset()
    trace.enable()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.time()
        for _ in range(traced):
            one_step()
        sync()
        wall_ms = 1e3 * (time.time() - t0)
    trace.disable()
    pathlib.Path(args.out).mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(pathlib.Path(args.out) / "train_step.json"))

    kernels = device_kernels(prof)
    device_ms = sum(v[0] for v in kernels.values())
    groups = {}
    for name, (ms, _) in kernels.items():
        groups[group_of(name)] = groups.get(group_of(name), 0.0) + ms / traced
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:12]
    print(json.dumps({
        "device": torch.cuda.get_device_name(0) if dev.type == "cuda" else "cpu",
        "batch": args.batch, "batch_gpu": args.batch_gpu, "res": args.res,
        "params": sum(p.numel() for p in net.parameters()), "traced_steps": traced,
        "wall_ms_per_step": wall_ms / traced, "device_kernel_ms_per_step": device_ms / traced,
        "device_busy_share": device_ms / wall_ms if wall_ms else None,
        "groups_ms_per_step": dict(sorted(groups.items(), key=lambda kv: -kv[1])),
        "top_kernels": [{"name": n[:90], "ms_per_step": v[0] / traced, "calls": v[1]}
                        for n, v in top],
        "kernel_launches_per_step": int(np.sum([v[1] for v in kernels.values()])) // traced,
        "spans_per_step": span_totals(trace.records(), traced),
    }), flush=True)


if __name__ == "__main__":
    main()
