"""Cells of the benchmark cut to a size the CPU runs in seconds, for the
harness's tests: the drivers, readers and checks of the real cells over a
two-level net at 32 x 32, 2 variables and a 5-frame window."""

from __future__ import annotations

import copy
import time

import numpy as np
import torch

from h100_bench import harness, run

# the tiny cells' limits: several times what sound tiny runs read, far under
# what the faults and the float8 control read
SAMPLING_LIMITS = {"sample_rel_rms": 0.03}  # sound tiny runs read ~0.006 (bf16 net)
TRAINING_LIMITS = {"loss_gap": 1e-4, "grad1_gap": 1e-3, "change_gap": 1e-2, "ema_change_gap": 1e-2}

TINY_MODEL = {"class_name": "score_unet", "channels": 10, "embedding_dim": 32, "noise_features": 8,
              "hidden_blocks": [1, 1], "hidden_channels": [8, 16], "kernel_size": 3, "attention_levels": [1]}


def tiny_config(snapshot=None) -> dict:
    cfg = {"name": "tiny", "model": dict(TINY_MODEL), "variables": 2, "window": 5, "resolution": 32,
           "compute_dtype": "float32", "weights": {}}
    if snapshot is not None:
        cfg["weights"]["snapshot"] = str(snapshot)
    return cfg


def write_snapshot(directory, seed: int = 0):
    """A snapshot of the tiny net with weights drawn from ``seed``, as the
    program's training loop writes one; returns its directory."""
    from climate2weather_tpu_torch.models.score_net import build_score_unet
    from climate2weather_tpu_torch.training.checkpoint import save_snapshot

    torch.manual_seed(seed)
    net = build_score_unet(TINY_MODEL)
    with torch.no_grad():
        for p in net.parameters():
            p.normal_(0.0, 0.3)
    config = {"network_kwargs": dict(TINY_MODEL),
              "dataset_kwargs": {"train": {"num_features": 2, "window": 5, "spatial_res": 32}},
              "pipeline_kwargs": {"class_name": "vp_cosine"}}
    return save_snapshot(str(directory), 1, "0.999900", dict(net.state_dict()), config)


def sampling_traffic() -> dict:
    traffic = copy.deepcopy(harness.read_json(harness.BENCH_DIR / "traffic" / "sample_dpm64.json"))
    traffic.update(hours=13, calibration_frames=8, max_groups=3, trace_from=1, trace_evals=2)
    traffic["sampler"].update(num_sampling_steps=3, batch_size=4, ensemble_batch=2,
                              likelihood_std=traffic["sampler"]["likelihood_std"][:2])
    return traffic


def training_traffic() -> dict:
    traffic = copy.deepcopy(harness.read_json(harness.BENCH_DIR / "traffic" / "train_b128.json"))
    traffic.update(frames=12, batch=8, microbatch=4, trace_steps=1, reference_block=4)
    traffic["optimizer"]["lr"] = 1e-3  # steps that move the tiny net visibly
    return traffic


def context(kind: str, config: dict, traffic: dict, limits: dict, *, seed: int = 1, seconds: float = 0.5,
            trace: bool = False) -> dict:
    """A run's context for the tiny cell ``kind`` ("sample" or "train") on
    the CPU, named as the real cell of that kind is."""
    bench = harness.read_json(harness.ROOT / "BENCHMARK.json")
    name = next(w["name"] for w in bench["workloads"]
                if harness.read_json(harness.BENCH_DIR / "traffic" / f"{w['traffic']}.json")["driver"]
                == {"sample": "ensemble_sampling", "train": "train_steps"}[kind])
    entry = next(w for w in bench["workloads"] if w["name"] == name)
    driver = traffic["driver"]
    return {"bench": bench, "entry": entry, "config": config, "traffic": traffic, "limits": limits,
            "driver": harness.load_module(harness.BENCH_DIR / "drivers" / f"{driver}.py", f"tiny_{driver}"),
            "seed": seed, "seconds": seconds, "trace": trace, "device": torch.device("cpu"),
            "t_start": time.time(), "stages": harness.Stages(time.time()), "name": name}


def execute(ctx: dict) -> dict:
    torch.manual_seed(0)
    np.random.seed(0)
    return run.execute(ctx)
