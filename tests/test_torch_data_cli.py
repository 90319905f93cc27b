"""The port's data command line against the JAX package's, on the drill of
tests/test_cosmo_layout.py at a reduced domain: a raw archive of four
per-variable folders (a 2005 decoy, a fully missing tas hour) over 40 x 44,
``extract-patch-folder --years 2006-2014`` per variable with a 32 x 32
patch, then ``preproc-all``.

The port's commands run as ``python -m climate2weather_tpu_torch.data.cli``
in processes where jax, h5py, scipy, click and the JAX package cannot be
imported; the JAX commands run in this process through click's
``CliRunner``. Their files hold equal contents: bit for bit, except where
the NaN hour was repaired (the port's PCHIP against scipy's: one float32
ulp) and what derives from it (the quantiles and the normalized training
file: 4 float32 ulps of the largest value). Then the port trains on its
file and runs a guided ``predict`` on the test split, on the CPU.
"""

import json
import pathlib
import subprocess
import sys

import h5py
import numpy as np
import pytest
import yaml
from click.testing import CliRunner

from climate2weather_tpu.data.cli import cli as jax_cli
from climate2weather_tpu.data.grid import QuantileDataset as JQuantiles
from climate2weather_tpu.data.grid import open_grid as jax_open_grid
from climate2weather_tpu_torch.data.grid import QuantileDataset, open_grid
from climate2weather_tpu_torch.io import hdf5

REPO = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
import chip_smoke  # noqa: E402

VARS = ("psl", "tas", "uas", "vas")
PATCH = ["--lat0", "4", "--lat1", "36", "--lon0", "6", "--lon1", "38"]


def _port_cli(*argv, module="climate2weather_tpu_torch.data.cli", timeout=120):
    proc = subprocess.run(chip_smoke._blocked("module", module, *argv), capture_output=True, text=True,
                          timeout=timeout, cwd=str(REPO))
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    return proc.stdout


@pytest.fixture(scope="module")
def drill(tmp_path_factory):
    root = tmp_path_factory.mktemp("drill")
    chip_smoke.write_cosmo_archive(root / "archive", nlat=40, nlon=44)
    runner = CliRunner()
    for var in VARS:
        _port_cli("extract-patch-folder", "--var-folder", root / "archive" / var, "--out-folder",
                  root / "port" / var, "--years", "2006-2014", *PATCH)
        r = runner.invoke(jax_cli, ["extract-patch-folder", "--var-folder", str(root / "archive" / var),
                                    "--out-folder", str(root / "jax" / var), "--years", "2006-2014", *PATCH],
                          catch_exceptions=False)
        assert r.exit_code == 0, r.output
    _port_cli("preproc-all", "--raw-dir", root / "port", "--out-dir", root / "port_proc")
    r = runner.invoke(jax_cli, ["preproc-all", "--raw-dir", str(root / "jax"), "--out-dir", str(root / "jax_proc")],
                      catch_exceptions=False)
    assert r.exit_code == 0, r.output
    return root


def _assert_grids(got, want, ulps):
    np.testing.assert_array_equal(got.time, want.time)
    np.testing.assert_array_equal(got.rlat, want.rlat)
    np.testing.assert_array_equal(got.rlon, want.rlon)
    assert sorted(got.data_vars) == sorted(want.data_vars)
    for v, w in want.data_vars.items():
        g = got.data_vars[v]
        assert g.dtype == w.dtype and g.shape == w.shape, v
        if ulps == 0 or np.isnan(w).any():
            np.testing.assert_array_equal(g, w)
        else:
            assert np.abs(g - w).max() <= ulps * np.spacing(np.abs(w).max()), v


def test_extracted_patches_and_audit_equal_the_jax_clis(drill):
    for var in VARS:
        names = sorted(p.name for p in (drill / "port" / var).iterdir())
        assert names == sorted(p.name for p in (drill / "jax" / var).iterdir())
        nc = [n for n in names if n.endswith(".nc")]
        assert len(nc) == 3 and all(n.startswith(f"{var}_EUR-6km_") for n in nc)  # the 2005 decoy dropped
        for n in nc:
            got, want = open_grid(str(drill / "port" / var / n)), jax_open_grid(str(drill / "jax" / var / n))
            assert got.data_vars[var].shape == (12, 32, 32)
            _assert_grids(got, want, ulps=1 if var == "tas" else 0)
    audits = sorted((drill / "port" / "tas").glob("*_nan_stats.npz"))
    assert len(audits) == 1 and [a.name for a in (drill / "jax" / "tas").glob("*_nan_stats.npz")] == [audits[0].name]
    got, want = np.load(audits[0]), np.load(drill / "jax" / "tas" / audits[0].name)
    assert sorted(got.files) == sorted(want.files) == ["tas_nr_of_times", "tas_which_times"]
    assert got["tas_nr_of_times"] == 1 and list(got["tas_which_times"]) == [5]
    np.testing.assert_array_equal(got["tas_which_times"], want["tas_which_times"])
    missing = audits[0].name.replace("_nan_stats.npz", "_with_missing.h5")
    _assert_grids(open_grid(str(drill / "port" / "tas" / missing)),
                  jax_open_grid(str(drill / "jax" / "tas" / missing)), ulps=0)
    fixed = open_grid(str(drill / "port" / "tas" / missing.replace("_with_missing.h5", ".nc")))
    assert np.isfinite(fixed.data_vars["tas"]).all()


def test_preproc_outputs_equal_the_jax_clis(drill):
    port, jax = drill / "port_proc", drill / "jax_proc"
    assert sorted(p.name for p in port.iterdir()) == sorted(p.name for p in jax.iterdir())
    for name in ("train_merged-allvars.nc", "test_merged-allvars.nc"):
        _assert_grids(open_grid(str(port / name)), jax_open_grid(str(jax / name)), ulps=1)
    test_ds = open_grid(str(port / "test_merged-allvars.nc"))
    assert len(test_ds.time) == 12 and sorted(test_ds.data_vars) == sorted(VARS)
    gq, wq = QuantileDataset.from_file(str(port / "train_quantiles.nc")), \
        JQuantiles.from_file(str(jax / "train_quantiles.nc"))
    assert sorted(gq.values) == sorted(wq.values) == sorted(VARS)
    for v in VARS:
        np.testing.assert_allclose(gq.values[v], wq.values[v], rtol=0,
                                   atol=4 * np.spacing(np.float32(np.abs(wq.values[v]).max())))
    with hdf5.File(port / "train_normed.h5") as p, h5py.File(jax / "train_normed.h5") as h:
        x, want = p["x"][()], h["x"][()]
        assert x.shape == want.shape == (24, 4, 32, 32) and np.isfinite(x).all()
        np.testing.assert_allclose(x, want, rtol=0, atol=4 * np.spacing(np.float32(np.abs(want).max())))
        assert [str(v) for v in p.attrs["vars"]] == sorted(VARS)
        assert p.attrs["norm_mode"] == "quant95"


def test_train_and_guided_predict_on_the_drills_files(drill, tmp_path):
    """The port trains on its ``train_normed.h5`` (1024 samples of the tiny
    net at 32 x 32, a snapshot at the end) and runs ``experiment predict``
    on the test split from that snapshot, each a blocked process on the
    CPU."""
    runs = tmp_path / "runs"
    _port_cli("--run-dir", runs, "--run-id", "drill", "--train-data", drill / "port_proc" / "train_normed.h5",
              "--spatial-res", "32", "--num-features", "4", "--markov-order", "1",
              "--model-config", REPO / "configs" / "tiny_unet.yml", "--lr", "1e-3", "--total-ndata", "1024",
              "--batch", "64", "--batch-gpu", "64", "--status", "1024", "--snapshot", "1024",
              "--checkpoint", "1024", "--logging", "256", "--valid", "0", "--device", "cpu",
              module="climate2weather_tpu_torch.train", timeout=300)
    lines = (runs / "drill" / "metrics.jsonl").read_text().splitlines()
    losses = [json.loads(ln)["train/loss"] for ln in lines if "train/loss" in json.loads(ln)]
    assert len(losses) == 4 and np.isfinite(losses).all()
    snaps = sorted((runs / "drill").glob("network-snapshot-*"))
    assert snaps, sorted(p.name for p in (runs / "drill").iterdir())
    test_nc = str(drill / "port_proc" / "test_merged-allvars.nc")
    cfg = dict(model_path=str(snaps[0]), data_path=test_nc,
               quantile_path=str(drill / "port_proc" / "train_quantiles.nc"), start_time="2014-01-01-00",
               num_hours=9, data_norm_mode="quant95", observation_path=test_nc, data_vars=list(VARS),
               num_sampling_steps=2, num_samples=1, num_corrections=0, likelihood_std=[0.17, 0.04, 0.33, 0.33],
               likelihood_gamma=7e-4, t_step=4, s_step=16, batch_size=4, seed=0, use_exact_grad=False)
    (tmp_path / "exp.yml").write_text(yaml.safe_dump(cfg))
    _port_cli("predict", "--device", "cpu", "--save-path", tmp_path / "out", "--config-path", tmp_path / "exp.yml",
              module="climate2weather_tpu_torch.experiment", timeout=300)
    (exp_dir,) = list((tmp_path / "out").iterdir())
    sample = open_grid(str(exp_dir / "gen_sample_000.nc"))
    assert sorted(sample.data_vars) == sorted(VARS)
    for v in VARS:
        assert sample.data_vars[v].shape == (9, 32, 32) and np.isfinite(sample.data_vars[v]).all()
