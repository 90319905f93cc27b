"""Nothing on the chip smoke's path needs a package beyond the standard
library, torch and numpy, and the smoke's phases run end to end.

A subprocess blocks the import of jax, flax, optax, msgpack, yaml, h5py,
netCDF4, xarray, ml_dtypes, ninja and climate2weather_tpu, imports the port
and ``chip_smoke``, and runs the smoke's phase-3 and phase-4 functions on the
CPU with a tiny snapshot (the kernel phases need the card).
"""

import json
import pathlib
import subprocess
import sys

from _torch_parity import jax_net_and_params, tiny_config, write_snapshot

REPO = pathlib.Path(__file__).resolve().parents[1]

CHILD = r"""
import importlib.abc, json, pathlib, pkgutil, sys

BLOCKED = {"jax", "flax", "optax", "msgpack", "yaml", "h5py", "netCDF4", "xarray",
           "ml_dtypes", "ninja", "climate2weather_tpu"}

class Blocker(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError(f"blocked for the hygiene check: {name}")
        return None

sys.meta_path.insert(0, Blocker())
repo, snap = sys.argv[1], sys.argv[2]
sys.path.insert(0, repo)
import torch
import climate2weather_tpu_torch
mods = [m.name for m in pkgutil.walk_packages(climate2weather_tpu_torch.__path__, "climate2weather_tpu_torch.")]
for m in mods:
    __import__(m)
import chip_smoke

cpu = torch.device("cpu")
p3 = chip_smoke.phase3_network(snap, cpu, batch=2, res=32, compare_plain=False)
p4 = chip_smoke.phase4_slice(snap, chip_smoke.CONFIG, cpu, L=49, res=32, n_train=8,
                             overrides={"num_sampling_steps": 8})
leaked = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
print(json.dumps({"modules": mods, "p3": p3, "p4_forwards": p4["unet_forwards"],
                  "p4_shape": p4["samples_shape"], "leaked": leaked}))
"""


def test_port_and_smoke_need_only_stdlib_torch_numpy(tmp_path):
    # the smoke's snapshot layout: 4 variables x a 13-frame window
    cfg = tiny_config(channels=52, window=13)
    _, params = jax_net_and_params(cfg, hw=32)
    snap = write_snapshot(tmp_path, cfg, params)
    proc = subprocess.run(
        [sys.executable, "-c", CHILD, str(REPO), snap],
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
