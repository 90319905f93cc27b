"""Nothing on the chip smoke's path needs a package beyond the standard
library, torch and numpy, and the smoke's phases run end to end.

A subprocess blocks the import of jax, flax, optax, msgpack, yaml, h5py,
scipy, click, netCDF4, xarray, ml_dtypes, ninja, matplotlib, PIL and
climate2weather_tpu, imports
the port and ``chip_smoke``, and runs the smoke's phase-3 and phase-4
functions on the CPU with a tiny snapshot, its phase-5 training at a tiny
size, its phase-6 ``predict`` from files (written and read through
``io/hdf5.py``), its phase-7 training drive and a Winograd call, or its
phase-8 year path at a tiny size (the kernel phases need the card).
"""

import json
import pathlib
import subprocess
import sys

import torch

from _torch_parity import jax_net_and_params, tiny_config, write_snapshot

REPO = pathlib.Path(__file__).resolve().parents[1]

CHILD = r"""
import importlib.abc, json, pathlib, pkgutil, sys

BLOCKED = {"jax", "flax", "optax", "msgpack", "yaml", "h5py", "scipy", "click", "netCDF4", "xarray",
           "ml_dtypes", "ninja", "matplotlib", "PIL", "climate2weather_tpu"}

class Blocker(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError(f"blocked for the hygiene check: {name}")
        return None

sys.meta_path.insert(0, Blocker())
# absent, as on a machine without them: imports fail, and probes such as
# importlib.util.find_spec (torch's optimizers make some) answer None
for name in BLOCKED:
    sys.modules[name] = None
repo, mode, snap, threads = sys.argv[1], sys.argv[2], sys.argv[3], int(sys.argv[4])
sys.path.insert(0, repo)
import torch
torch.set_num_threads(threads)  # the parent's share of the cores
import climate2weather_tpu_torch
mods = [m.name for m in pkgutil.walk_packages(climate2weather_tpu_torch.__path__, "climate2weather_tpu_torch.")]
for m in mods:
    __import__(m)
import chip_smoke

cpu = torch.device("cpu")
if mode == "sampling":
    p3 = chip_smoke.phase3_network(snap, cpu, batch=2, res=32, compare_plain=False)
    p4 = chip_smoke.phase4_slice(snap, chip_smoke.CONFIG, cpu, L=49, res=32, n_train=8,
                                 overrides={"num_sampling_steps": 8})
    out = {"p3": p3, "p4_forwards": p4["unet_forwards"], "p4_shape": p4["samples_shape"]}
elif mode == "predict":
    from climate2weather_tpu_torch.ops import winograd
    p6 = chip_smoke.phase6_predict(snap, cpu, res=32, steps_override=2)
    p7 = chip_smoke.phase7_tiny_training(cpu, steps=2)
    x = torch.randn(2, 8, 8, 16)
    k, b = torch.randn(3, 3, 16, 16) / 12, torch.zeros(16)
    wino = winograd.winograd_conv3x3(x, k, b, torch.randn(2, 16), x, "norm", 0)
    out = {"p6": p6["runs"], "p7_losses": p7["losses"], "p7_checked": len(p7["per_launch"]),
           "wino_shape": list(wino.shape), "wino_finite": bool(torch.isfinite(wino).all()),
           "wino_launches": winograd.launch_counts["winograd_conv3x3"]}
elif mode == "year":
    # the year config above a threshold lowered to 16 frames: 31 hours at
    # 32 x 32, 24 steps (3 calls of 8, a resume file after the second), the
    # resume at 31 frames and the bf16 trajectory at 4003
    p8 = chip_smoke.phase8_year(snap, cpu, res=32, hours=31,
                                overrides={"long_trajectory_threshold": 16, "num_sampling_steps": 24})
    out = {"p8": {k: p8[k] for k in ("8a", "8b", "8c", "8d")}}
else:
    p5 = chip_smoke.phase5_training(cpu, model_config=chip_smoke.REPO / "configs" / "tiny_unet.yml",
                                    res=16, frames=40, compute_dtype=torch.float32)
    out = {"p5": {k: v for k, v in p5.items() if k != "bwd_per_launch"},
           "bwd_checked": len(p5["bwd_per_launch"])}
leaked = sorted(m for m, mod in sys.modules.items() if mod is not None and m.split(".")[0] in BLOCKED)
print(json.dumps({"modules": mods, "leaked": leaked, **out}))
"""


def test_port_and_smoke_need_only_stdlib_torch_numpy(tmp_path):
    # the smoke's snapshot layout: 4 variables x a 13-frame window
    cfg = tiny_config(channels=52, window=13)
    _, params = jax_net_and_params(cfg, hw=32)
    snap = write_snapshot(tmp_path, cfg, params)
    proc = subprocess.run(
        [sys.executable, "-c", CHILD, str(REPO), "sampling", snap, str(torch.get_num_threads())],
        capture_output=True, text=True, timeout=600, cwd=str(tmp_path),
    )
    assert proc.returncode == 0, proc.stderr[-4000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["leaked"] == []
    assert "climate2weather_tpu_torch.exp.downscaling" in out["modules"]
    assert out["p3"]["shape"] == [2, 32, 32, 52] and out["p3"]["launches"] == 0
    # 3 samples in one group x (8 steps + final denoise) x 2 chunks of windows
    assert out["p4_forwards"] == 18
    assert out["p4_shape"] == [3, 49, 32, 32, 4]


def test_smoke_training_phase_needs_only_stdlib_torch_numpy(tmp_path):
    """Phase 5 end to end on the CPU with the tiny net at 16 x 16: two
    loop runs (16 + 16 steps), the exact restore, the resumed step's draws
    and loss, the per-launch backward checks and the snapshot's forward,
    with nothing beyond stdlib, torch and numpy importable."""
    proc = subprocess.run(
        [sys.executable, "-c", CHILD, str(REPO), "training", "", str(torch.get_num_threads())],
        capture_output=True, text=True, timeout=600, cwd=str(tmp_path),
    )
    assert proc.returncode == 0, proc.stderr[-4000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["leaked"] == []
    assert "climate2weather_tpu_torch.training.loop" in out["modules"]
    assert "climate2weather_tpu_torch.train" in out["modules"]
    p5 = out["p5"]
    assert p5["steps"] == 32 and p5["restored_exact"] and p5["resume_draws_equal"]
    assert p5["resume_loss_diff"] == 0.0  # the CPU forwards run the same ops on the same bits
    assert p5["last4_mean"] < p5["first4_mean"] and p5["snapshot_forward_finite"]
    assert p5["launches"] == {"attention_fwd": 0, "attention_bwd": 0}  # no kernel on the CPU
    assert out["bwd_checked"] == 4  # one step: 2 microbatches x the tiny net's 2 attention blocks


def test_predict_hdf5_and_winograd_need_only_stdlib_torch_numpy(tmp_path):
    """Phase 6 (``predict`` from files the port writes and reads back
    through ``io/hdf5.py``, all four runs, 2 steps each) and phase 7 (the
    tiny training drive from a file) on the CPU, and a Winograd call, with
    h5py, click, yaml and the rest unimportable."""
    cfg = tiny_config(channels=52, window=13)
    _, params = jax_net_and_params(cfg, hw=32)
    snap = write_snapshot(tmp_path, cfg, params)
    proc = subprocess.run(
        [sys.executable, "-c", CHILD, str(REPO), "predict", snap, str(torch.get_num_threads())],
        capture_output=True, text=True, timeout=600, cwd=str(tmp_path),
    )
    assert proc.returncode == 0, proc.stderr[-4000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["leaked"] == []
    assert "climate2weather_tpu_torch.io.hdf5" in out["modules"]
    assert "climate2weather_tpu_torch.experiment" in out["modules"]
    runs = {r["run"]: r for r in out["p6"]}
    assert sorted(runs) == ["external_observation", "guidance_off", "s16_t6", "s16_t6_spectral"]
    for r in runs.values():
        assert r["finite"] and "ground_truth.nc" in r["outputs"] and "gen_sample_002.nc" in r["outputs"]
    for name in ("s16_t6_spectral", "external_observation", "guidance_off"):  # the projected runs
        assert runs[name]["A_x_minus_y_max"] <= runs[name]["A_tol"]
    assert len(out["p7_losses"]) == 2 and out["p7_checked"] == 8
    assert out["wino_shape"] == [2, 8, 8, 16] and out["wino_finite"] and out["wino_launches"] == 0


def test_year_path_and_metrics_need_only_stdlib_torch_numpy(tmp_path):
    """Phase 8 on the CPU with the tiny snapshot, with h5py, scipy and the
    rest unimportable: ``predict`` on the year config takes the long path,
    writes and removes its resume file, and keeps A(x) = y; a crashed run
    resumes to the uninterrupted one's bits; 4003 frames run in bf16; the
    metrics of the written run are finite."""
    cfg = tiny_config(channels=52, window=13)
    _, params = jax_net_and_params(cfg, hw=32)
    snap = write_snapshot(tmp_path, cfg, params)
    proc = subprocess.run(
        [sys.executable, "-c", CHILD, str(REPO), "year", snap, str(torch.get_num_threads())],
        capture_output=True, text=True, timeout=600, cwd=str(tmp_path),
    )
    assert proc.returncode == 0, proc.stderr[-4000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["leaked"] == []
    for name in ("diffusion.long_sampler", "exp.metrics", "exp.exputil"):
        assert f"climate2weather_tpu_torch.{name}" in out["modules"]
    a, b, c, d = (out["p8"][k] for k in ("8a", "8b", "8c", "8d"))
    assert a["long_path"] and a["finite"] and a["A_x_minus_y_max"] <= a["A_tol"]
    assert a["resume_saves_at_step"] == [16] and ".sample_resume_000.npz" not in a["left_in_dir"]
    assert a["unet_forwards"] == 25 and a["attention_launches"] == 0  # 24 steps + the final denoise
    assert b["resumed_equal"] and b["uninterrupted_equal"] and b["saved_step"] == 8
    assert b["resumed_forwards"] == b["expected_forwards"] == 8
    assert c["traj_dtype"] == "torch.bfloat16" and c["finite"] and c["A_x_minus_y_max"] <= c["A_tol"]
    assert d["finite"] and d["scores"] == 32 and d["protocol"] == {"time_stride": 1, "num_times": 6}


def test_smoke_refuses_to_run_without_a_card(tmp_path):
    """``python3 chip_smoke.py`` has no CPU mode: without CUDA it exits
    non-zero and prints no result (forced here by hiding every card)."""
    proc = subprocess.run(
        [sys.executable, str(REPO / "chip_smoke.py")],
        capture_output=True, text=True, timeout=300, cwd=str(tmp_path),
        env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin", "HOME": str(tmp_path)},
    )
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
