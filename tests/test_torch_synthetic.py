"""climate2weather_tpu_torch.data.synthetic against the JAX package's
data/synthetic.py on the CPU.

The seeded draws are the same; the inverse FFTs are numpy's in the port
and scipy's in JAX, so the float32 fields agree to within 8 float32 ulps
of each variable's largest magnitude (4 observed at res 32), not bit for
bit.
"""

import h5py
import numpy as np
import pytest

from climate2weather_tpu.data import synthetic as jsyn
from climate2weather_tpu.data.grid import QuantileDataset as JQuantiles
from climate2weather_tpu.data.grid import open_grid as jax_open_grid
from climate2weather_tpu.exp.metrics import rapsd
from climate2weather_tpu_torch.data import synthetic as tsyn
from climate2weather_tpu_torch.data.grid import QuantileDataset, open_grid
from climate2weather_tpu_torch.io import hdf5

ULPS = 8


def _assert_close(got, want):
    np.testing.assert_array_equal(got.time, want.time)
    np.testing.assert_array_equal(got.rlat, want.rlat)
    assert got.attrs == want.attrs
    for v, w in want.data_vars.items():
        g = got.data_vars[v]
        assert g.dtype == w.dtype == np.float32 and g.shape == w.shape, v
        assert np.abs(g - w).max() <= ULPS * np.spacing(np.abs(w).max()), v


@pytest.mark.parametrize("spectrum", ["smooth", "mesoscale"])
def test_synthesize_matches_jax(spectrum):
    got = tsyn.synthesize_cosmo_like(30, res=32, seed=3, spectrum=spectrum, chunk_hours=12)
    want = jsyn.synthesize_cosmo_like(30, res=32, seed=3, spectrum=spectrum, chunk_hours=12)
    _assert_close(got, want)


def test_deterministic_and_distinct_seeds():
    a = tsyn.synthesize_cosmo_like(8, res=32, seed=7)
    b = tsyn.synthesize_cosmo_like(8, res=32, seed=7)
    c = tsyn.synthesize_cosmo_like(8, res=32, seed=8)
    np.testing.assert_array_equal(a.data_vars["psl"], b.data_vars["psl"])
    assert not np.allclose(a.data_vars["psl"], c.data_vars["psl"])


def test_mesoscale_spectrum_and_invariants():
    ds = tsyn.synthesize_cosmo_like(24, res=64, seed=3, spectrum="mesoscale")
    f = np.arange(1, 33)
    for var in ("uas", "vas", "tas"):
        psd = np.mean([rapsd(x)[0] for x in ds.data_vars[var][::6]], axis=0)
        tail = np.polyfit(np.log(f[12:30]), np.log(psd[12:30] + 1e-300), 1)[0]
        assert -3.4 < tail < -2.0, (var, tail)
    assert 95000 < ds.data_vars["psl"].mean() < 107000
    uas, vas = ds.data_vars["uas"][0], ds.data_vars["vas"][0]
    div = np.gradient(uas, axis=1) + np.gradient(vas, axis=0)
    assert np.abs(div).mean() / (np.abs(np.gradient(uas, axis=1)).mean() + 1e-12) < 0.5
    with pytest.raises(ValueError, match="unknown spectrum"):
        tsyn.synthesize_cosmo_like(2, res=8, spectrum="flat")


def test_build_synthetic_dataset_matches_jax(tmp_path):
    kw = dict(train_hours=40, eval_hours=14, res=16, seed=2, spectrum="mesoscale")
    got = tsyn.build_synthetic_dataset(str(tmp_path / "port"), **kw)
    want = jsyn.build_synthetic_dataset(str(tmp_path / "jax"), **kw)
    assert sorted(got) == sorted(want)
    for k in ("train_merged", "eval_merged"):
        _assert_close(open_grid(got[k]), jax_open_grid(want[k]))
    gq, wq = QuantileDataset.from_file(got["quantiles"]), JQuantiles.from_file(want["quantiles"])
    for v in wq.values:  # quantiles of the fields: the fields' limit
        limit = ULPS * np.spacing(np.float32(np.abs(wq.values[v]).max()))
        np.testing.assert_allclose(gq.values[v], wq.values[v], rtol=0, atol=limit)
    with hdf5.File(got["train_h5"]) as p, h5py.File(want["train_h5"]) as h:
        assert p["x"].shape == h["x"].shape == (40, 4, 16, 16)
        np.testing.assert_allclose(p["x"][:], h["x"][:], rtol=0, atol=1e-5)
        assert list(p.attrs["vars"]) == [v.decode() if isinstance(v, bytes) else v for v in h.attrs["vars"]]
