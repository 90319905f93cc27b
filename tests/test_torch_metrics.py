"""The port's metrics (``exp/metrics.py``, ``exp/exputil.py``) against the JAX
package's: each score on the same arrays, and ``metrics.run`` on one
experiment directory (written by the port's grid writer; JAX reads it
through h5py, the port through ``io/hdf5.py``), at 2e-4 relative. SSIM's
numpy box filter against scipy's ``uniform_filter`` at 1e-6 in float64."""

import pathlib
import pickle
import shutil

import numpy as np
import pytest
from scipy.ndimage import uniform_filter

from climate2weather_tpu.exp import metrics as jax_metrics
from climate2weather_tpu_torch import experiment
from climate2weather_tpu_torch.data.grid import GridDataset
from climate2weather_tpu_torch.exp import metrics

HOURS, HW, S_STEP, T_STEP, SAMPLES = 25, 32, 8, 6, 3
OFFSETS = {"psl": (101000.0, 600.0), "tas": (285.0, 4.0), "uas": (0.0, 3.0), "vas": (0.0, 3.0)}


@pytest.mark.parametrize("shape", [(32, 32), (128, 128), (8, 8), (5, 40), (3, 4, 6)])
@pytest.mark.parametrize("size", [15, 4, 1])
def test_box_filter_matches_scipy_uniform_filter(shape, size):
    x = np.random.RandomState(sum(shape) + size).randn(*shape) * 30 + 7
    np.testing.assert_allclose(metrics.box_filter(x, size), uniform_filter(x, size=size), rtol=0, atol=1e-6)


@pytest.fixture(scope="module")
def fields():
    rng = np.random.RandomState(0)
    gt = np.cumsum(rng.randn(12, HW, HW), axis=0)
    samples = gt[None] + 0.7 * rng.randn(SAMPLES, 12, HW, HW)
    obs = gt.reshape(12, HW // S_STEP, S_STEP, HW // S_STEP, S_STEP).mean(axis=(2, 4))
    return samples, gt, obs


def _melr(m, samples, gt):
    r = m.rapsd_over_time(samples, gt)
    return [m.melr(r["sample_rapsd_over_time"], r["gt_rapsd_over_time"], do_weighted=w, do_max=x)
            for w, x in ((False, False), (True, False), (False, True))]


SCORES = {
    "sliced_wasserstein": lambda m, s, g, o: m.compute_wasserstein_nd(s, g),
    "sliced_wasserstein_unequal": lambda m, s, g, o: m.sliced_wasserstein_distance(
        s[0].reshape(12, -1), g[:7].reshape(7, -1)),
    "rapsd": lambda m, s, g, o: m.rapsd_over_time(s, g, o),
    "melr": lambda m, s, g, o: _melr(m, s, g),
    "ssim": lambda m, s, g, o: m.ssim_ensemble(s, g),
    "crps": lambda m, s, g, o: m.crps_ensemble(s, g),
    "spread_skill": lambda m, s, g, o: m.spread_skill_ratio(s, g),
    "rank_histogram": lambda m, s, g, o: m.rank_histogram(s, g),
    "reliability": lambda m, s, g, o: m.reliability_index(m.rank_histogram(s, g)),
    "upsample_observation": lambda m, s, g, o: m.upsample_observation(o, HW, HW),
}


def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], prefix + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, prefix + (i,))
    else:
        yield prefix, np.asarray(tree, np.float64)


def _assert_same_scores(got, want):
    got, want = dict(_leaves(got)), dict(_leaves(want))
    assert sorted(got) == sorted(want)
    for key in want:
        np.testing.assert_allclose(got[key], want[key], rtol=2e-4, atol=0, err_msg=str(key))


@pytest.mark.parametrize("score", sorted(SCORES))
def test_score_matches_jax(fields, score):
    _assert_same_scores(SCORES[score](metrics, *fields), SCORES[score](jax_metrics, *fields))


@pytest.fixture(scope="module")
def exp_dir(tmp_path_factory):
    """An experiment directory as ``predict`` writes it: ground truth,
    observation (block means every 6 hours) and 3 samples, psl in Pa."""
    root = tmp_path_factory.mktemp("exp") / "001_run"
    root.mkdir()
    rng = np.random.RandomState(1)
    time = np.datetime64("2014-01-01T00", "ns") + np.arange(HOURS) * np.timedelta64(1, "h")
    coords = {"time": time, "rlat": np.linspace(-2, 2, HW), "rlon": np.linspace(0, 4, HW)}
    walk = np.cumsum(rng.randn(HOURS, HW, HW, 4), axis=0) / 3

    def grid(x):
        return GridDataset({v: (x[..., i] * sc + off).astype(np.float32)
                            for i, (v, (off, sc)) in enumerate(sorted(OFFSETS.items()))}, coords, {})

    gt = grid(walk)
    gt.to_file(str(root / "ground_truth.nc"))
    gt.coarsen_mean(S_STEP).isel_time(np.arange(0, HOURS, T_STEP)).to_file(str(root / "observation.nc"))
    for sid in range(SAMPLES):
        grid(walk + 0.5 * rng.randn(*walk.shape)).to_file(str(root / f"gen_sample_{sid:03d}.nc"))
    return root


@pytest.mark.parametrize("time_stride", [1, 2])
def test_metrics_run_matches_jax_on_one_directory(exp_dir, tmp_path, time_stride):
    dirs = {side: tmp_path / side / exp_dir.name for side in ("jax", "port")}
    for d in dirs.values():  # each side its own copy: the RAPSD cache is per directory
        shutil.copytree(exp_dir, d)
    want = jax_metrics.run(str(dirs["jax"]), time_stride=time_stride)
    got = metrics.run(str(dirs["port"]), time_stride=time_stride)
    assert got["protocol"] == want["protocol"] == {"time_stride": time_stride,
                                                   "num_times": len(range(0, HOURS, T_STEP * time_stride))}
    assert sorted(got["melr"]["tas"]) == ["global", "interp_baseline"]
    _assert_same_scores(got, want)
    with open(dirs["port"] / "metrics" / "run" / "metrics.pickle", "rb") as f:
        _assert_same_scores(pickle.load(f), want)
    for v in OFFSETS:
        a = np.load(dirs["port"] / "metrics" / "run" / f"{v}_rank_hist.npz")["counts"]
        np.testing.assert_array_equal(a, np.load(dirs["jax"] / "metrics" / "run" / f"{v}_rank_hist.npz")["counts"])
    # a second run serves the cached spectra of the same ensemble
    _assert_same_scores(metrics.run(str(dirs["port"]), time_stride=time_stride), want)


def test_experiment_cli_runs_and_loads_metrics(exp_dir, tmp_path, capsys):
    d = pathlib.Path(shutil.copytree(exp_dir, tmp_path / exp_dir.name))
    assert experiment.main(["metrics", "run", str(d), "--time-stride", "2"]) == 0
    with open(d / "metrics" / "run" / "metrics.pickle", "rb") as f:
        saved = pickle.load(f)
    assert saved["protocol"]["time_stride"] == 2
    assert all(np.isfinite(v).all() for _, v in _leaves({k: saved[k] for k in saved if k != "protocol"}))
    capsys.readouterr()
    assert experiment.main(["metrics", "load", str(d)]) == 0
    printed = capsys.readouterr().out
    assert "wasserstein" in printed and "time_stride: 2" in printed


def test_setup_needs_samples(tmp_path):
    with pytest.raises(FileNotFoundError):
        metrics.run(str(tmp_path))
