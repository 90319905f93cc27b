"""The port's study and operations drivers (``climate2weather_tpu_torch.scripts``)
held against the JAX repository's ``scripts/``, each loaded with importlib
as ``tests/test_probe_tools.py`` does, on the same seeded numpy inputs.

Exact for the numpy-only functions; the repository's rtol/atol 2e-4 where
the metrics suite is inside (``score_trial``: the port's numpy copy of
scipy's box filter in SSIM)."""

import importlib.util
import json
import pathlib
import pickle
import shutil

import numpy as np
import pytest

from climate2weather_tpu_torch.data.grid import GridDataset
from climate2weather_tpu_torch.scripts import (
    amplitude_ratio,
    calibration_design_study,
    likelihood_sweep,
    probe_watcher,
    progression_report,
    sampler_ablation,
    soak_training,
    spectral_bands,
)

REPO = pathlib.Path(__file__).resolve().parents[1]
VARS = ("psl", "tas", "uas", "vas")
RTOL = ATOL = 2e-4


def _jax(name):
    spec = importlib.util.spec_from_file_location(f"jax_script_{name}", REPO / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _equal(got, want):
    if isinstance(want, dict):
        assert set(got) == set(want)
        for k in want:
            _equal(got[k], want[k])
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want)
        for a, b in zip(got, want):
            _equal(a, b)
    elif isinstance(want, np.ndarray):
        assert np.array_equal(np.asarray(got), want, equal_nan=True)
    else:
        assert got == want or (got != got and want != want)


# ------------------------------------------------------------------ inputs

def _grid(rng, hours, hw, offsets=None, start="2014-04-07T04", step=1):
    time = np.datetime64(start, "ns") + np.arange(hours) * step * np.timedelta64(1, "h")
    coords = {"time": time, "rlat": np.linspace(-2, 2, hw), "rlon": np.linspace(0, 4, hw)}
    offsets = offsets or {"psl": 101000.0, "tas": 285.0, "uas": 0.0, "vas": 0.0}
    return GridDataset({v: (rng.randn(hours, hw, hw) * 3 + offsets[v]).astype(np.float32) for v in VARS},
                       coords, {})


@pytest.fixture(scope="module")
def exp_dir(tmp_path_factory):
    """A downscaling output directory at 32 x 32: 25 hours of ground truth,
    its 16x block means every 6th hour as the observation, and 3 samples."""
    root = tmp_path_factory.mktemp("exp") / "001_config"
    root.mkdir()
    rng = np.random.RandomState(0)
    gt = _grid(rng, 25, 32)
    gt.to_file(str(root / "ground_truth.nc"))
    obs = gt.coarsen_mean(16).isel_time(np.arange(0, 25, 6))
    obs.to_file(str(root / "observation.nc"))
    for s in range(3):
        _grid(rng, 25, 32).to_file(str(root / f"gen_sample_{s:03d}.nc"))
    return root


# ---------------------------------------------------------- probe watcher

@pytest.mark.parametrize("every_mi,rate", [(2, "0.999000"), (1, "0.999000"), (3, "0.999900")])
def test_due_snapshots(tmp_path, every_mi, rate):
    mi = lambda n: f"{round(n * 1048.576):07d}"  # noqa: E731
    run = tmp_path / "run"
    run.mkdir()
    for n in (1, 2, 2.5, 3, 3.5, 4, 6, 9):
        for r in ("0.999000", "0.999900"):
            (run / f"network-snapshot-{mi(n)}-{r}").mkdir()
    (run / "training-state-0001234.ckpt").write_bytes(b"")
    (run / "figures").mkdir()
    want = _jax("probe_watcher").due_snapshots(run, rate, every_mi)
    assert want and probe_watcher.due_snapshots(run, rate, every_mi) == want
    assert probe_watcher.due_snapshots(tmp_path / "absent", rate, every_mi) == []


# ------------------------------------------------------ progression report

def _probe(root, kdata, rng, kinds):
    d = root / str(kdata) / "guided" / "001_config" / "metrics" / "run"
    d.mkdir(parents=True)
    m = {k: {v: {"global": rng.rand(3), "interp_baseline": rng.rand(1)} for v in VARS} for k in kinds}
    with open(d / "metrics.pickle", "wb") as f:
        pickle.dump(m, f)


@pytest.mark.parametrize("metric_names", [["w2", "melr", "ssim", "crps", "spread_skill", "rank_ri"], ["ssim", "w2"]])
def test_progression_rows_and_table(tmp_path, metric_names):
    rng = np.random.RandomState(1)
    for kdata in (4194, 2097, 6291):
        _probe(tmp_path, kdata, rng, ("wasserstein", "melr", "ssim", "crps", "spread_skill"))
    (tmp_path / "8388").mkdir()  # an incomplete probe
    (tmp_path / "notes").mkdir()
    jax_pr = _jax("progression_report")
    want = list(jax_pr.progression_rows(tmp_path))
    got = list(progression_report.progression_rows(tmp_path))
    _equal(got, want)
    assert [k for k, _ in got] == [2097, 4194, 6291]
    assert progression_report.format_table(got, metric_names) == jax_pr.format_table(want, metric_names)


# ------------------------------------------------------- amplitude ratio

def test_frame_std():
    x = np.random.RandomState(2).randn(7, 16, 12).astype(np.float32)
    _equal(amplitude_ratio.frame_std(x), _jax("amplitude_ratio").frame_std(x))


@pytest.mark.parametrize("fn", ["amplitude_ratios", "report"])
def test_amplitude_ratio(exp_dir, fn):
    jax_ar = _jax("amplitude_ratio")
    if fn == "report":
        assert amplitude_ratio.report([str(exp_dir)]) == jax_ar.report([str(exp_dir)])
    else:
        _equal(amplitude_ratio.amplitude_ratios(exp_dir), jax_ar.amplitude_ratios(exp_dir))


# ------------------------------------------------------- spectral bands

@pytest.mark.parametrize("d,s_step", [(6.0, 16), (6.0, 8), (2.5, 4)])
def test_band_masks_and_banded_melr(d, s_step):
    jax_sb = _jax("spectral_bands")
    wl = np.concatenate([[np.inf], 1.0 / np.linspace(1 / 400, 1 / 12, 20)])
    want = jax_sb.band_masks(wl, d, s_step)
    got = spectral_bands.band_masks(wl, d, s_step)
    assert list(got) == list(want)
    _equal(got, want)
    rng = np.random.RandomState(3)
    sample, gt = rng.rand(3, 5, len(wl)) + 0.1, rng.rand(5, len(wl)) + 0.1
    for m in want.values():
        _equal(spectral_bands.banded_melr(sample, gt, m), jax_sb.banded_melr(sample, gt, m))


@pytest.mark.parametrize("var", VARS)
def test_baseline_psd(exp_dir, var):
    want = _jax("spectral_bands").baseline_psd(exp_dir, var, 6.0)
    got = spectral_bands.baseline_psd(exp_dir, var, 6.0)
    _equal(got, want)


# ------------------------------------------------- calibration design study

def _trajectory(rng, L=13, H=32, W=32, C=4):
    return rng.randn(L, H, W, C).astype(np.float32), rng.randn((L - 1) // 6 + 1, H // 16, W // 16, C)


@pytest.mark.parametrize("iters", [1, 2])
def test_np_project(iters):
    x, y = _trajectory(np.random.RandomState(4))
    _equal(calibration_design_study.np_project(x, y, iters),
           _jax("calibration_design_study").np_project(x, y, iters))


@pytest.mark.parametrize("k_min,per_frame", [(0, True), (8, True), (0, False), (4, False)])
def test_np_calibrate(k_min, per_frame):
    rng = np.random.RandomState(5)
    x, _ = _trajectory(rng)
    target = (rng.rand(4, 16) + 0.05).astype(np.float32)
    _equal(calibration_design_study.np_calibrate(x, target, k_min=k_min, per_frame=per_frame),
           _jax("calibration_design_study").np_calibrate(x, target, k_min=k_min, per_frame=per_frame))


# ------------------------------------------------------- likelihood sweep

def test_score_trial(exp_dir, tmp_path):
    """The composite from the metrics suite: the port's ``metrics.run`` on
    one copy of the directory, JAX's on another, at 2e-4."""
    a, b = tmp_path / "port", tmp_path / "jax"
    shutil.copytree(exp_dir, a)
    shutil.copytree(exp_dir, b)
    got = likelihood_sweep.score_trial(a)
    want = _jax("likelihood_sweep").score_trial(b)
    assert set(got) == set(want) and set(got["per_var"]) == set(VARS)
    for k in ("w2_ratio", "melr_ratio", "calib_penalty", "score"):
        np.testing.assert_allclose(got[k], want[k], rtol=RTOL, atol=ATOL)
    for v in VARS:
        assert set(got["per_var"][v]) == set(want["per_var"][v])
        for k, x in want["per_var"][v].items():
            np.testing.assert_allclose(got["per_var"][v][k], x, rtol=RTOL, atol=ATOL)


def _row(rng):
    return {"per_var": {v: {"ssim": float(rng.rand()), "wasserstein": float(rng.rand())} for v in VARS}}


@pytest.mark.parametrize("gate_vars", [("uas", "vas"), ("tas",), (), ("uas", "missing")])
def test_trial_feasible(gate_vars):
    rng = np.random.RandomState(6)
    floors = {v: {"ssim": 0.5, "wasserstein": 0.5, "melr": 1.0} for v in VARS}
    jax_sw = _jax("likelihood_sweep")
    rows = [_row(rng) for _ in range(12)] + [{}]
    got = [likelihood_sweep.trial_feasible(r, floors, gate_vars) for r in rows]
    assert got == [jax_sw.trial_feasible(r, floors, gate_vars) for r in rows]


@pytest.mark.parametrize("trial", [1, 2, 3])
def test_drawn_point_equals_jax(trial):
    """Trial n of ``--base-seed 99``: the (sigma, gamma) the port's sweep
    draws equal JAX's exactly."""
    from climate2weather_tpu.exp import downscaling as jax_downscaling
    from climate2weather_tpu.utils.seeding import set_random_seed as jax_seed
    from climate2weather_tpu_torch.exp import downscaling
    from climate2weather_tpu_torch.utils.seeding import set_random_seed

    jax_seed(99, trial)
    want = jax_downscaling._draw_likelihood_hparams()
    set_random_seed(99, trial)
    got = downscaling._draw_likelihood_hparams()
    assert got == want


# ------------------------------------------------------- sampler ablation

def test_summarize():
    rng = np.random.RandomState(7)
    kinds = ("wasserstein", "melr", "ssim", "crps", "spread_skill")
    results = {name: {k: {v: {"global": rng.rand(3)} for v in VARS if not (k == "crps" and v == "psl")}
                      for k in kinds} for name in ("pc_corr0", "dpmpp2m64")}
    assert sampler_ablation.summarize(results) == _jax("sampler_ablation").summarize(results)
    assert sampler_ablation.summarize({}) == "(no completed cells)"
    assert [n for n, _ in sampler_ablation.MATRIX] == [n for n, _ in _jax("sampler_ablation").MATRIX]
    _equal(dict(sampler_ablation.MATRIX), dict(_jax("sampler_ablation").MATRIX))


# ------------------------------------------------------------------ soak

def test_read_losses(tmp_path):
    recs = [{"train/loss": 2.5, "train/kdata": 0, "train/ndata": 256},
            {"train/loss": 2.25, "train/kdata": 0, "train/ndata": 512},
            {"train/kdata": 0, "valid/sample_nan-0.999900": False},
            {"train/loss": 2.0, "train/kdata": 1},  # an older log without ndata
            {"train/loss": 2.25, "train/kdata": 0, "train/ndata": 512}]
    lines = [json.dumps(r) for r in recs] + ["{not json"]
    (tmp_path / "metrics.jsonl").write_text("\n".join(lines) + "\n")
    got = soak_training.read_losses(tmp_path)
    assert got == _jax("soak_training").read_losses(tmp_path)
    assert got == {256: [2.5], 512: [2.25, 2.25], 1000: [2.0]}
    assert soak_training.read_losses(tmp_path / "absent") == {}


def _flags(cmd) -> dict:
    keys = ("--total-ndata", "--batch", "--status", "--snapshot", "--checkpoint", "--logging", "--valid",
            "--slice-data", "--spatial-res", "--markov-order", "--lr", "--seed", "--run-id")
    return {k: cmd[cmd.index(k) + 1] for k in keys if k in cmd}


@pytest.mark.parametrize("total,batch,slice_data", [
    (65536, 256, "16384"), (65536, 256, None), (52428800, 256, "3276800"), (4096, 64, "2048"),
    (2048, 128, "2048"), (1 << 20, 512, "131072"), (3000 * 96, 96, "96000")])
def test_train_cmd_intervals(tmp_path, total, batch, slice_data):
    """The interval arithmetic of each start's command, and the child the
    port starts (the port's ``train`` on its device)."""
    want, _ = _jax("soak_training").train_cmd(tmp_path, "soak", "d.h5", str(total), batch, slice_data)
    got, env = soak_training.train_cmd(tmp_path, "soak", "d.h5", str(total), batch, slice_data, platform="cpu")
    assert _flags(got) == _flags(want)
    assert got[1:3] == ["-m", "climate2weather_tpu_torch.train"] and got[got.index("--device") + 1] == "cpu"
    assert "--cache-data" in got and env["PYTHONUNBUFFERED"] == "1"
    assert str(REPO) in env["PYTHONPATH"].split(":")
