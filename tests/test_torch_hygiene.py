"""Nothing on the chip smoke's path needs a package beyond the standard
library, torch and numpy, and the smoke's phases run end to end.

A subprocess blocks the import of jax, flax, optax, msgpack, yaml, h5py,
scipy, click, netCDF4, xarray, ml_dtypes, ninja, matplotlib, PIL and
climate2weather_tpu, imports
the port and ``chip_smoke``, and runs the smoke's phase-3 and phase-4
functions on the CPU with a tiny snapshot, its phase-5 training at a tiny
size, its phase-6 ``predict`` from files (written and read through
``io/hdf5.py``), its phase-7 training drive and a Winograd call, its
phase-8 year path, its phase-9 sampler and guidance modes (exact
gradients, DPM-Solver++(3M), the bilinear prolongation, the sweep and the
fidelity harness), its phase-11 data layer (the netCDF-C fixtures, the
archive drill through the data command line, synth, debias and a guided
predict from the debiased file, every process it starts blocked itself), its
phase-13 stores and figure data (fill values, the zarr store and its codec,
a predict from zarr stores, every figure kind's data), its phase-14
host-streaming tier (eps against the device path, a sample against the long
path, a host-streamed predict), its phase-15 study and operations drivers
(every process they start blocked by a ``sitecustomize`` on its path), or
its phase-10 multi-process runs (every rank's process
blocked the same way, by a ``sitecustomize`` on its path) at a tiny size (the
kernel phases need the card).
"""

import json
import os
import pathlib
import subprocess
import sys

import pytest
import torch

from _torch_parity import jax_net_and_params, tiny_config, write_snapshot

REPO = pathlib.Path(__file__).resolve().parents[1]

CHILD = r"""
import importlib.abc, json, pathlib, pkgutil, sys

BLOCKED = {"jax", "flax", "optax", "msgpack", "yaml", "h5py", "scipy", "click", "netCDF4", "xarray",
           "ml_dtypes", "ninja", "matplotlib", "PIL", "scripts", "climate2weather_tpu"}

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
    p6 = chip_smoke.phase6_predict(snap, cpu, res=32, steps_override=2, observation=None)
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
elif mode == "ranks":
    # phase 10 over gloo on the CPU: the tiny net at 16 x 16, 2 steps of predict
    # 10e: the year config above a threshold lowered to 16 frames (31 hours,
    # 19 windows in 3 chunks of 8), 2 steps each
    p10 = chip_smoke.phase10_multi_process(snap, cpu, model_config=chip_smoke.REPO / "configs" / "tiny_unet.yml",
                                           res=16, frames=40, predict_res=32, predict_steps=2,
                                           split={"year": (31, 2), "short": (49, 2, 64), "exact": (19, 2, 64),
                                                  "year_overrides": {"long_trajectory_threshold": 16,
                                                                     "batch_size": 8}})
    out = {"p10": chip_smoke.phase10_summary(p10), "p10e": p10["10e"],
           "p10b": {k: p10["10b"][k] for k in ("launches_per_rank", "losses", "expected_per_rank")},
           "p10b_step": p10["10b"]["step_check"]["ranks"], "p10c_equal": p10["10c"]["samples_equal"],
           "p10c_writes": p10["10c"]["writes"], "p10d_events": p10["10d"]["events"]}
elif mode == "data":
    # phase 11 at a 40 x 44 archive (a 32 x 32 patch), synth at 32 x 32 for
    # 96 + 56 hours, 2 training and 2 sampling steps
    p11 = chip_smoke.phase11_data(snap, cpu, nlat=40, nlon=44, patch=((4, 36), (6, 38)), res=32,
                                  synth_hours=(96, 56), train_steps=2, predict_steps=2)
    out = {"p11": chip_smoke.phase11_summary(p11), "p11a": p11["11a"], "p11b": p11["11b"], "p11d": p11["11d"]}
elif mode == "model":
    # phase 12 at 32 x 32: the tiny snapshot as the reference's pickle,
    # imported; batch 2; 2 steps of predict; tiny_unet's widths in 1-D on
    # [2, 64] and in 3-D on [1, 16, 16, 16] (512 tokens at level 1)
    p12 = chip_smoke.phase12_model(snap, cpu, res=32, batch=2, fused_batch=2, predict_steps=2,
                                   model_config=chip_smoke.REPO / "configs" / "tiny_unet.yml",
                                   nd_cases=((1, (2, 64)), (3, (1, 16, 16, 16))))
    out = {"p12": chip_smoke.phase12_summary(p12), **{k: p12[k] for k in ("12a", "12b", "12c", "12d", "12e")}}
elif mode == "store":
    # phase 13 at 32 x 32 with the tiny snapshot, 2 steps of predict; 13d
    # compares 13c's directory with itself; 13e sums the 72.1M snapshot
    p13 = chip_smoke.phase13_store(snap, cpu, res=32, steps=2)
    out = {"p13": chip_smoke.phase13_summary(p13), **{k: p13[k] for k in ("13a", "13b", "13c", "13d", "13e")}}
elif mode == "stream":
    # phase 14 at 32 x 32: 31 frames (19 windows in chunks of 8, the last
    # shifted back) and 20 (8 windows, one chunk), 2 steps, a 2-step
    # predict; 14b-fp32 on 23 frames (11 windows in 3 chunks of 4); the
    # net in fp32 throughout
    p14 = chip_smoke.phase14_host_stream(snap, cpu, res=32, hours=(31, 20), batch=8, steps=(2, 2), exact=(23, 4),
                                         predict_steps=2, compute_dtype=torch.float32)
    out = {"p14": chip_smoke.phase14_summary(p14),
           **{k: p14[k] for k in ("14a", "14b", "14b-fp32", "14c", "14d", "14e")}}
elif mode == "modes":
    # phase 9 with 4 steps in 9a and 9b, and the year config above a
    # threshold lowered to 16 frames for 31 hours in 9c
    p9 = chip_smoke.phase9_modes(snap, cpu, res=32, hours=49, long_hours=31,
                                 overrides={"num_sampling_steps": 4},
                                 long_overrides={"long_trajectory_threshold": 16})
    out = {"p9": p9}
elif mode == "study":
    # phase 15 at 32 x 32 with the tiny snapshot and its architecture as the
    # model config: 40 training frames, 15b with its own plain run
    p15 = chip_smoke.phase15_study(snap, cpu, model_config=pathlib.Path(snap).parent / "study_model.yml", res=32,
                                   frames=40)
    out = {"p15": chip_smoke.phase15_summary(p15), **{k: p15[k] for k in ("15a", "15b", "15c", "15d", "15e", "15f")}}
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
    assert a["resume_bytes"] > 0
    assert a["unet_forwards"] == 25 and a["attention_launches"] == 0  # 24 steps + the final denoise
    assert b["resumed_equal"] and b["uninterrupted_equal"] and b["saved_step"] == 8
    assert b["resumed_forwards"] == b["expected_forwards"] == 8
    assert c["traj_dtype"] == "torch.bfloat16" and c["finite"] and c["A_x_minus_y_max"] <= c["A_tol"]
    assert d["finite"] and d["scores"] == 32 and d["protocol"] == {"time_stride": 1, "num_times": 6}


def test_sampler_and_guidance_modes_need_only_stdlib_torch_numpy(tmp_path):
    """Phase 9 on the CPU with the tiny snapshot, with h5py, scipy, jax, yaml,
    msgpack and the JAX package unimportable (so no module of the port,
    those this slice adds among them, reaches climate2weather_tpu): exact
    guidance through ``run_arrays`` and its gradient check (the planted
    double count caught), ``run`` with DPM-Solver++(3M) and the bilinear
    prolongation, the order-3 resume and exact guidance on the long path,
    the ``hparam-sweep`` command and the fidelity harness."""
    cfg = tiny_config(channels=52, window=13)
    _, params = jax_net_and_params(cfg, hw=32)
    snap = write_snapshot(tmp_path, cfg, params)
    proc = subprocess.run(
        [sys.executable, "-c", CHILD, str(REPO), "modes", snap, str(torch.get_num_threads())],
        capture_output=True, text=True, timeout=600, cwd=str(tmp_path),
    )
    assert proc.returncode == 0, proc.stderr[-4000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["leaked"] == []
    for name in ("exp.fidelity", "exp.downscaling", "diffusion.window", "diffusion.guidance", "experiment"):
        assert f"climate2weather_tpu_torch.{name}" in out["modules"]
    p9 = out["p9"]
    a, grad = p9["9a"], p9["9a_gradient"]
    assert a["finite"] and a["A_x_minus_y_max"] <= a["A_tol"] and a["samples_shape"] == [3, 49, 32, 32, 4]
    assert a["attention_launches"] == {"attention_fwd": 0, "attention_bwd": 0}  # no kernel on the CPU
    assert grad["err"] <= grad["limit"] < grad["double_count_err"]
    assert [r["run"] for r in p9["9b"]] == ["dpmpp3m", "bilinear"]
    for r in p9["9b"]:
        assert r["finite"] and r["A_x_minus_y_max"] <= r["A_tol"]
    c = p9["9c"]
    assert c["resume"]["resumed_equal"] and c["resume"]["order"] == 3 and "prev2_x0" in c["resume"]["carry"]
    assert c["long_path"] and c["finite"] and c["A_x_minus_y_max"] <= c["A_tol"]
    d, e = p9["9d"], p9["9e"]
    assert d["dirs"] == ["001_sweep", "002_sweep"] and all(d["finite"]) and len(d["trials"]) == 2
    assert e["report"] and e["finite"] and e["rows"] == 24


def test_data_layer_phase_needs_only_stdlib_torch_numpy(tmp_path):
    """Phase 11 on the CPU with the tiny snapshot, with jax, h5py, scipy,
    click and the rest unimportable here and in every process it starts:
    the committed netCDF-C fixtures equal their contents and every kind of
    checksummed structure catches a flipped byte; the archive drill through
    ``data.cli`` (``extract-patch-folder`` per variable, ``preproc-all``)
    and ``train`` on its file; ``synth`` and ``debias``; ``experiment
    predict`` from the debiased file and ``metrics run``."""
    cfg = tiny_config(channels=52, window=13)
    _, params = jax_net_and_params(cfg, hw=32)
    snap = write_snapshot(tmp_path, cfg, params)
    proc = subprocess.run(
        [sys.executable, "-c", CHILD, str(REPO), "data", snap, str(torch.get_num_threads())],
        capture_output=True, text=True, timeout=600, cwd=str(tmp_path),
    )
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-4000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["leaked"] == []
    for name in ("data.cli", "data.processing", "data.debias", "data.synthetic", "io.hdf5"):
        assert f"climate2weather_tpu_torch.{name}" in out["modules"]
    a, b, d, p11 = out["p11a"], out["p11b"], out["p11d"], out["p11"]
    for name in ("v108", "latest"):
        assert all(a[name]["equal"].values()) and len(a[name]["equal"]) == 12
    assert a["latest"]["superblock"] == 3 and a["v108"]["superblock"] == 2
    assert len(a["checksum_faults"]) == 14 and all(a["checksum_faults"].values())
    layouts = a["h5py_layouts"]  # the structures h5py writes, read with h5py blocked
    assert layouts["equal"] and layouts["datasets"] == 81 and layouts["undamaged_read"]
    assert layouts["fletcher32_fault"] == "fletcher32 checksum mismatch" and all(layouts["dangling_raise"].values())
    assert layouts["observation"] == [9, 8, 8] and layouts["observations_equal"]
    storage = layouts["storage"]  # szip, external raw storage, multi-year virtual datasets
    assert storage["szip_masks"] == [0] and storage["szip_datasets"] == 16
    assert "szip decompress failed: truncated" in storage["szip_truncated"]
    assert "szip decompress failed: corrupt" in storage["szip_flipped"]
    assert 0 < storage["szip_byte_flips"]["raised"] < storage["szip_byte_flips"]["bytes"]
    assert "unable to open external raw data file" in storage["external_missing"]
    assert storage["multiyear"]["x"] == [12, 4, 6, 6] and storage["multiyear"]["year_held_by_no_file_nan"]
    rates = storage["codec_rates"]
    assert rates["decoded_bytes"] == 24 * 4 * 128 * 128 * 4
    assert all(rates[c]["mb_s"] > 0 for c in ("szip", "lzf", "deflate"))
    assert b["kept"] == dict.fromkeys(["psl", "tas", "uas", "vas"], 3) and b["test_hours"] == 12
    assert b["train_x_shape"] == [24, 4, 32, 32] and b["nan_audit"] == {"nr_of_times": 1, "which_times": [5]}
    assert len(b["losses"]) == 2 and b["train_launches"] == {"attention_fwd": 0, "attention_bwd": 0}  # the CPU
    for v, err in p11["quantile_error_debiased"].items():
        assert err <= 0.1 * p11["quantile_error_biased"][v]
    assert d["finite"] and d["A_x_minus_y_max"] <= d["A_tol"] and d["observation_frames"] == 9
    assert d["metrics_scores"] > 0 and "gen_sample_002.nc" in d["outputs"]


def test_model_layer_phase_needs_only_stdlib_torch_numpy(tmp_path):
    """Phase 12 on the CPU with the tiny snapshot, with jax, flax, yaml,
    msgpack, h5py, ``scripts`` and the JAX package unimportable here and in
    the importer's process: the snapshot written as the reference's pickle
    and imported bit for bit (fp16-rounded), the imported net's forward
    equal to the rounded net's with ``norm_ddof: 1``, ``experiment predict``
    from it, the fused tail against float64, and the 1-D and 3-D nets'
    forward and backward with every attention call checked."""
    cfg = tiny_config(channels=52, window=13)
    _, params = jax_net_and_params(cfg, hw=32)
    snap = write_snapshot(tmp_path, cfg, params)
    proc = subprocess.run(
        [sys.executable, "-c", CHILD, str(REPO), "model", snap, str(torch.get_num_threads())],
        capture_output=True, text=True, timeout=600, cwd=str(tmp_path),
    )
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-4000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["leaked"] == []
    for name in ("import_reference_snapshot", "models.unet", "models.score_net", "models.init", "convert"):
        assert f"climate2weather_tpu_torch.{name}" in out["modules"]
    a, b, c, d, e = (out[k] for k in ("12a", "12b", "12c", "12d", "12e"))
    assert a["architecture_equal"] and a["tensors_differ"] == [] and a["norm_ddof"] == 1 and a["tensors"] == 44
    assert set(a["fixture_golden_err_over_tol"]) == {"tiny", "prod"}
    assert all(e <= 1.0 for e in a["fixture_golden_err_over_tol"].values())
    assert b["bit_equal"] and b["ddof0_max_abs_diff"] > 0 and b["shape"] == [2, 32, 32, 52]
    assert c["finite"] and c["A_x_minus_y_max"] <= c["A_tol"] and "gen_sample_002.nc" in c["outputs"]
    assert d["fused_tails"] == 1 and d["fused_vs_f64"][0] <= 2 * d["plain_vs_f64"][0]
    assert e["1"]["out_shape"] == [2, 64, 52] and e["3"]["out_shape"] == [1, 16, 16, 16, 52]
    for r in e.values():
        assert r["finite"] and r["grads_finite"] and len(r["fwd_checks"]) == len(r["bwd_checks"]) == 2
        assert r["launches"] == {"attention_fwd": 0, "attention_bwd": 0}  # no kernel on the CPU
    assert set(e["3"]["conv_input_layouts"].values()) == {"channels_last_3d"}


def test_store_and_figures_phase_needs_only_stdlib_torch_numpy(tmp_path):
    """Phase 13 on the CPU with the tiny snapshot, with jax, h5py, scipy,
    matplotlib, PIL, click and the rest unimportable here and in the
    ``data.cli`` process it starts: the fill-value fixtures, the codec built
    and the JAX-written stores read and rewritten byte for byte, a corrupted
    chunk named, ``experiment predict`` from zarr stores loading the ``.nc``
    files' bits, every figure kind's data, the refusal to draw, and the
    72.1M summary."""
    cfg = tiny_config(channels=52, window=13)
    _, params = jax_net_and_params(cfg, hw=32)
    snap = write_snapshot(tmp_path, cfg, params)
    proc = subprocess.run(
        [sys.executable, "-c", CHILD, str(REPO), "store", snap, str(torch.get_num_threads())],
        capture_output=True, text=True, timeout=600, cwd=str(tmp_path),
    )
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-4000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["leaked"] == []
    for name in ("data.zarr_store", "data.native_blosc", "exp.figures", "exp.plotting_util", "exp.windpower",
                 "exp.geodata", "utils.summary"):
        assert f"climate2weather_tpu_torch.{name}" in out["modules"]
    a, b, c, d, e = (out[k] for k in ("13a", "13b", "13c", "13d", "13e"))
    for libver in ("latest", "earliest"):
        assert all(a[libver]["equal"].values()) and all(a[libver]["nan_where_fill"].values())
        assert a[libver]["unwritten_frames"] == {"psl": 8, "tas": 8, "uas": 0, "vas": 12}
    assert all(b["goldens"].values()) and all(all(r.values()) for r in b["reads"].values())
    assert all(not w["differ"] for w in b["writes"].values()) and b["writes"]["none"]["extra"] == ["tas/1.0.0"]
    assert "corrupt.zarr" in b["corrupt_error"] and b["build"]["seconds"] > 0
    assert c["inputs_equal"] == {"data": True, "obs": True} and c["compressors"] == {"data": "blosc", "obs": "zlib"}
    assert c["finite"] and c["A_x_minus_y_max"] <= c["A_tol"] and c["attention_fwd_launches"] == 0  # the CPU
    assert c["metrics_scores"] > 0 and "gen_sample_002.nc" in c["outputs"]
    assert all(k["finite"] and k["shapes_ok"] for k in d["kinds"].values()) and len(d["kinds"]) == 10
    assert "matplotlib" in d["refusal"] and not d["figures_dir_written"]
    assert e["total"] == e["snapshot_params"] and 72.0e6 < e["total"] < 72.2e6


def test_host_stream_phase_needs_only_stdlib_torch_numpy(tmp_path):
    """Phase 14 on the CPU with the tiny snapshot, with jax, h5py, scipy and
    the rest unimportable: the host tier's eps equal to the device path's bit
    for bit and the off-by-one chunk caught, its DPM-Solver++(2M) sample
    within JAX's bar of the long path's and both planted faults outside it,
    the seeded SDE run reproducible, PC finite, and ``experiment predict``
    under ``host_streaming`` writing finite samples."""
    cfg = tiny_config(channels=52, window=13)
    _, params = jax_net_and_params(cfg, hw=32)
    snap = write_snapshot(tmp_path, cfg, params)
    proc = subprocess.run(
        [sys.executable, "-c", CHILD, str(REPO), "stream", snap, str(torch.get_num_threads())],
        capture_output=True, text=True, timeout=600, cwd=str(tmp_path),
    )
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-4000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["leaked"] == []
    assert "climate2weather_tpu_torch.diffusion.host_stream" in out["modules"]
    a, b, x, c, d, e = (out[k] for k in ("14a", "14b", "14b-fp32", "14c", "14d", "14e"))
    assert a["bits_equal"] and a["fault_max_abs_diff"] > 0 and a["chunks"] == 3
    assert a["attention_launches"] == a["expected_launches"] == 0  # no kernel on the CPU
    assert b["finite"] and b["evals"] == 3
    assert x["finite"] and x["max_abs_diff"] <= x["limit"] and x["chunks"] == 3
    assert x["fault_second_order_dropped"] > x["limit"] and x["fault_guidance_sign_flipped"] > x["limit"]
    assert b["peak_host_tier"] is None and d["peak_long"] is None  # device memory is the card's
    assert c["sde_equal"] and c["sde_finite"] and c["pc_finite"] and c["L"] == 20
    assert e["finite"] and "gen_sample_001.nc" in e["outputs"] and "observation.nc" in e["outputs"]


def test_study_phase_needs_only_stdlib_torch_numpy(tmp_path):
    """Phase 15 on the CPU with the tiny snapshot, with jax, flax, yaml,
    msgpack, h5py, scipy, matplotlib, click and the JAX package unimportable
    here and, through the phase's ``sitecustomize``, in every process it
    starts and their children: the fabricated checkpoint resumed by ``train``
    for two fresh-AdamW updates bit for bit against this process's, the old
    loader's fault told apart; the soak's chain killed past its checkpoint
    with loss parity and its planted ulp caught; the scored sweep, two
    ablation rows, one watcher poll probing exactly the due snapshot, and the
    post-hoc diagnostics finite."""
    from climate2weather_tpu_torch.io.snapshot import yaml_dump_file

    cfg = tiny_config(channels=52, window=13)
    _, params = jax_net_and_params(cfg, hw=32)
    snap = write_snapshot(tmp_path, cfg, params)
    yaml_dump_file({k: v for k, v in cfg["network_kwargs"].items() if k != "channels"},
                   pathlib.Path(snap).parent / "study_model.yml")
    proc = subprocess.run(
        [sys.executable, "-c", CHILD, str(REPO), "study", snap, str(torch.get_num_threads())],
        capture_output=True, text=True, timeout=900, cwd=str(tmp_path),
    )
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-4000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["leaked"] == []
    for name in ("fabricate_resume_state", "soak_training", "likelihood_sweep", "sampler_ablation",
                 "probe_watcher", "progression_report", "spectral_bands", "amplitude_ratio",
                 "calibration_design_study"):
        assert f"climate2weather_tpu_torch.scripts.{name}" in out["modules"]
    a, b, c, d, e, f = (out[k] for k in ("15a", "15b", "15c", "15d", "15e", "15f"))
    assert a["bits_equal"] and a["fault_max_abs_diff"] > 0 and (a["adam_count"], a["schedule_count"]) == (2, 147408)
    assert a["logged_loss"] == a["fresh_loss"] and a["launches"] == {"attention_fwd": 0, "attention_bwd": 0}
    assert [r["killed"] for r in b["restarts"]] == [True, False] and b["fault_caught"]
    assert b["common_log_points"] == 32 and b["loss_parity_mismatches"] == 0
    assert [r["trial"] for r in c["rows"]] == [0, 1] and c["drawn_equal"] and not c["fault_drawn_equal"]
    assert len(d["rows"]) == 2 and d["finite"] and all(d["reports"])
    assert e["probe_dirs"] == ["9437"] and len(e["probed"]) == 1 and e["idle_exit"]
    assert all(f["finite"].values()) and not f["fault_finite"]
    # at their exits: the resume, the plain run, the soak's finishing start
    # (the killed one cannot), the watcher and its probe, the design study
    assert out["p15"]["processes"] == 6


# what no module of the port, nor chip_smoke.py and the pickle writer it
# runs, may import, at any depth of the file (h5py is the HDF5 reader's
# optional fallback, which the blocked runs above show is never needed)
FORBIDDEN = {"jax", "flax", "optax", "yaml", "msgpack", "scripts", "climate2weather_tpu"}
PORT_FILES = sorted(str(p.relative_to(REPO)) for p in (REPO / "climate2weather_tpu_torch").rglob("*.py")) + [
    "chip_smoke.py", "tests/_reference_pickle.py"]


SHELL_DRIVERS = sorted(str(p.relative_to(REPO)) for p in (REPO / "climate2weather_tpu_torch" / "scripts").glob("*.sh"))


@pytest.mark.parametrize("path", SHELL_DRIVERS)
def test_shell_drivers_run_only_the_port(path):
    """A shell driver of the port starts no module of the JAX package, no
    root ``experiment.py``/``train.py`` and no JAX script of ``scripts/``:
    only ``python -m climate2weather_tpu_torch...`` and the repository's
    text-only verdict composers (``"$REPO/scripts/*_verdict.py"``); it sets
    no JAX platform variable."""
    import re

    text = (REPO / path).read_text()
    code = "\n".join(line for line in text.splitlines() if not line.lstrip().startswith("#"))
    assert not re.search(r"climate2weather_tpu\.|C2W_PLATFORM|JAX_|experiment\.py|train\.py|__graft_entry__", code)
    for call in re.findall(r"python3? +(\S+)", code):
        assert call == "-m" or re.fullmatch(r'"\$REPO/scripts/\w+_verdict\.py"', call), (path, call)
    for module in re.findall(r"python3? +-m +(\S+)", code):
        assert module.startswith("climate2weather_tpu_torch.") or module == "pytest", (path, module)


@pytest.mark.parametrize("path", PORT_FILES)
def test_no_import_of_jax_flax_yaml_msgpack_or_scripts(path):
    """Every ``import`` and ``from ... import`` statement of the file,
    functions' bodies included, names none of FORBIDDEN."""
    import ast

    tree = ast.parse((REPO / path).read_text())
    names = [a.name for node in ast.walk(tree) if isinstance(node, ast.Import) for a in node.names]
    names += [node.module for node in ast.walk(tree)
              if isinstance(node, ast.ImportFrom) and node.module and node.level == 0]
    assert not [n for n in names if n.split(".")[0] in FORBIDDEN], (path, names)


SITECUSTOMIZE = r"""
import atexit, importlib.abc, os, sys

BLOCKED = {"jax", "flax", "optax", "msgpack", "yaml", "h5py", "scipy", "click", "netCDF4", "xarray",
           "ml_dtypes", "ninja", "matplotlib", "PIL", "climate2weather_tpu"}

class Blocker(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError(f"blocked for the hygiene check: {name}")
        return None

sys.meta_path.insert(0, Blocker())
for name in BLOCKED:
    sys.modules[name] = None

def report():
    leaked = sorted(m for m, mod in sys.modules.items() if mod is not None and m.split(".")[0] in BLOCKED)
    with open(LOG, "a") as f:
        f.write(f"{os.getpid()} {' '.join(sys.argv[:4])} leaked={leaked}\n")

atexit.register(report)
"""


def test_multi_process_phase_needs_only_stdlib_torch_numpy(tmp_path):
    """Phase 10 on the CPU over gloo (the world of one under
    ``torch.distributed.run``, the 2-rank step check with its planted fault,
    2-rank training with a checkpoint and a resume, the striped ``predict``
    against one process, the supervisor recovering a stopped run, one
    sample split over 2 ranks with its planted faults), with
    every process it starts blocked from jax, flax, the JAX package, h5py,
    scipy, msgpack and the rest, as this process is."""
    cfg = tiny_config(channels=52, window=13)
    _, params = jax_net_and_params(cfg, hw=32)
    snap = write_snapshot(tmp_path, cfg, params)
    site, log = tmp_path / "site", tmp_path / "processes.log"
    site.mkdir()
    (site / "sitecustomize.py").write_text(f"LOG = {str(log)!r}\n" + SITECUSTOMIZE)
    proc = subprocess.run(
        [sys.executable, "-c", CHILD, str(REPO), "ranks", snap, str(torch.get_num_threads())],
        capture_output=True, text=True, timeout=600, cwd=str(tmp_path),
        env=dict(os.environ, PYTHONPATH=str(site)),
    )
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-4000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["leaked"] == []
    assert "climate2weather_tpu_torch.parallel.mesh" in out["modules"]
    assert "climate2weather_tpu_torch.training.supervisor" in out["modules"]
    p10 = out["p10"]
    assert p10["world_one_equal"]
    step = out["p10b_step"]
    assert all(r["correct"]["equal"] for r in step) and step[0]["fault"]["equal"]
    assert not step[1]["fault"]["equal"] and step[1]["fault"]["max_abs_diff"] > 0
    assert len(out["p10b"]["losses"]) == 16
    assert out["p10b"]["launches_per_rank"] == [{"attention_fwd": 0, "attention_bwd": 0}] * 2  # the CPU
    assert all(out["p10c_equal"].values()) and len(out["p10c_equal"]) == 6
    assert out["p10c_writes"][1] == ["gen_sample_003.nc", "gen_sample_004.nc", "gen_sample_005.nc"]
    assert out["p10d_events"] == ["start", "stall", "killed", "start", "exit"]
    # 10e: the year path's dealt chunks bit for bit, the cut chunks within
    # the limit, every planted fault seen, the windows split
    split = out["p10e"]["jobs"]
    assert p10["split_year_bits_equal"] and not split["year"]["fault_shift_bits_equal"]
    for name in ("short", "exact"):
        assert split[name]["diff_in_std"] <= p10["split_limit"] < split[name]["fault_shift_in_std"]
    assert p10["split_fault_own_caught"] == [True, True]
    for job in split.values():
        assert sum(job["windows_per_rank"]) == job["windows_one"] and min(job["windows_per_rank"]) > 0
    # the processes phase 10 started reported at exit (the stopped child is
    # killed before it can): none imported a blocked package
    lines = log.read_text().splitlines()
    assert all(ln.endswith("leaked=[]") for ln in lines), lines
    count = lambda part: sum(part in ln for ln in lines)  # noqa: E731
    # 10a's launched and plain runs and 10d's relaunch; 10b's 2 x 2 ranks,
    # 10c's 2 and 10e's 2; the supervisor
    assert count("climate2weather_tpu_torch/train.py") >= 3, lines
    assert count("chip_smoke.py --child") >= 8, lines
    assert count("supervisor") >= 1, lines


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
