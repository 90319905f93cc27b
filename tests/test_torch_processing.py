"""climate2weather_tpu_torch.data.processing against the JAX package's
data/processing.py on the CPU, on seeded numpy inputs at a small size.

The port's PCHIP is its own numpy code (scipy's ``PchipInterpolator`` in
JAX): in float64 it matches scipy to 1e-12 relative, at interior NaN hours
and at the first and last frames (extrapolated with the end-slope rules);
the repaired float32 grids match the JAX ones to one float32 ulp. Every
other function matches bit for bit.
"""

import pathlib

import numpy as np
import pytest
from scipy.interpolate import PchipInterpolator

from climate2weather_tpu.data import processing as jproc
from climate2weather_tpu.data.grid import GridDataset as JGrid
from climate2weather_tpu.data.grid import open_grid as jax_open_grid
from climate2weather_tpu_torch.data import pipeline as tpipe
from climate2weather_tpu_torch.data import processing as tproc
from climate2weather_tpu_torch.data.grid import GridDataset as TGrid
from climate2weather_tpu_torch.data.grid import open_grid

VARS = ("psl", "tas", "uas", "vas")


def _fields(t=30, h=10, w=12, seed=0, start="2006-01-01T00", step_h=1):
    rng = np.random.default_rng(seed)
    time = np.datetime64(start, "ns") + np.arange(t) * np.timedelta64(step_h, "h")
    coords = {"time": time, "rlat": np.linspace(-3.0, 3.0, h), "rlon": np.linspace(-4.0, 4.0, w)}
    data = {v: (np.cumsum(rng.standard_normal((t, h, w)), axis=0) + 10 * i).astype(np.float32)
            for i, v in enumerate(VARS)}
    return data, coords


def _pair(data, coords, attrs=None):
    return (JGrid({k: v.copy() for k, v in data.items()}, dict(coords), dict(attrs or {})),
            TGrid({k: v.copy() for k, v in data.items()}, dict(coords), dict(attrs or {})))


def _assert_grid_equal(got, want, ulps=0):
    assert sorted(got.data_vars) == sorted(want.data_vars)
    np.testing.assert_array_equal(got.time, want.time)
    np.testing.assert_array_equal(got.rlat, want.rlat)
    np.testing.assert_array_equal(got.rlon, want.rlon)
    for k in want.data_vars:
        g, w = got.data_vars[k], want.data_vars[k]
        assert g.dtype == w.dtype and g.shape == w.shape, k
        if ulps == 0:
            assert g.tobytes() == w.tobytes(), k
        else:
            np.testing.assert_array_less(np.abs(g - w), ulps * np.spacing(np.abs(w)) + 1e-30)


@pytest.mark.parametrize("bad", [[5], [0], [29], [0, 1, 14, 28, 29], [3, 4, 5, 6]],
                         ids=["interior", "first", "last", "ends_and_interior", "run"])
def test_pchip_matches_scipy(bad):
    rng = np.random.default_rng(1)
    t = np.arange(30, dtype=np.float64)
    y = np.cumsum(rng.standard_normal((30, 40)), axis=0)
    y[10:13, :5] = 2.0  # flat segments and sign changes
    good = np.setdiff1d(np.arange(30), bad)
    got = tproc.pchip(t[good], y[good], t[bad])
    want = PchipInterpolator(t[good], y[good], axis=0)(t[bad])
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12 * np.abs(y).max())


def test_pchip_of_two_points_is_linear():
    x, y = np.array([0.0, 4.0]), np.array([[1.0, -2.0], [3.0, 6.0]])
    want = PchipInterpolator(x, y, axis=0)(np.array([-1.0, 1.0, 5.0]))
    np.testing.assert_allclose(tproc.pchip(x, y, np.array([-1.0, 1.0, 5.0])), want, rtol=1e-15)


@pytest.mark.parametrize("nan_times", [[7], [0, 29], [3, 4, 20]], ids=["interior", "ends", "several"])
def test_extract_patch_with_nan_hours_matches_jax(tmp_path, nan_times):
    data, coords = _fields(t=30, h=20, w=24)
    data["tas"][nan_times] = np.nan
    data["uas"][nan_times[0], 3:5, 4:9] = np.nan  # a partly missing hour
    jds, tds = _pair(data, coords, {"source": "archive"})
    want = jproc.extract_patch(jds, (4, 16), (6, 22), audit_path=str(tmp_path / "jax"))
    got = tproc.extract_patch(tds, (4, 16), (6, 22), audit_path=str(tmp_path / "port"))
    _assert_grid_equal(got, want, ulps=1)
    assert got.attrs == want.attrs == {"source": "archive"}
    assert np.isfinite(got.data_vars["tas"]).all()
    for k in ("psl", "vas"):  # no NaN: untouched
        assert got.data_vars[k].tobytes() == want.data_vars[k].tobytes()
    jst, tst = np.load(tmp_path / "jax_nan_stats.npz"), np.load(tmp_path / "port_nan_stats.npz")
    assert sorted(jst.files) == sorted(tst.files) == ["tas_nr_of_times", "tas_which_times", "uas_nr_of_times",
                                                      "uas_which_times"]
    for k in jst.files:
        np.testing.assert_array_equal(tst[k], jst[k])
    _assert_grid_equal(open_grid(str(tmp_path / "port_with_missing.h5")),
                       jax_open_grid(str(tmp_path / "jax_with_missing.h5")))


def test_extract_patch_raises_as_jax():
    data, coords = _fields(t=6, h=8, w=8)
    data["psl"][2] = np.nan
    for proc, grid in zip((jproc, tproc), _pair(data, coords)):
        with pytest.raises(RuntimeError, match="NaNs in patch"):
            proc.extract_patch(grid, (0, 8), (0, 8), interpolate_nans=False)
    data["psl"][:] = np.nan  # nothing to interpolate from
    for proc, grid in zip((jproc, tproc), _pair(data, coords)):
        with pytest.raises(Exception):
            proc.extract_patch(grid, (0, 8), (0, 8))
    clean, _ = _fields(t=6, h=8, w=8)
    for proc, grid in zip((jproc, tproc), _pair(clean, coords)):
        assert proc.extract_patch(grid, (1, 5), (2, 7)).data_vars["tas"].shape == (6, 4, 5)


def test_merge_time_select_dates_merge_vars_match_jax():
    parts = []
    for i, start in enumerate(("2006-01-02T00", "2006-01-01T00", "2006-01-01T12")):
        data, coords = _fields(t=12, h=6, w=7, seed=i, start=start)
        parts.append(_pair(data, coords))
    want = jproc.merge_time([j for j, _ in parts])
    got = tproc.merge_time([t for _, t in parts])
    _assert_grid_equal(got, want)
    assert str(got.time[0]) == "2006-01-01T00:00:00.000000000" and len(got.time) == 36
    for start, end in (("2006-01-01-06", "2006-01-02-03"), ("2006-01-01", "2006-01-01"), ("2005-01-01", "2007-01-01")):
        _assert_grid_equal(tproc.select_dates(got, start, end), jproc.select_dates(want, start, end))
    jv = [JGrid({v: want.data_vars[v]}, dict(want.coords)) for v in VARS]
    tv = [TGrid({v: got.data_vars[v]}, dict(got.coords)) for v in VARS]
    _assert_grid_equal(tproc.merge_vars(tv), jproc.merge_vars(jv))
    with pytest.raises(ValueError, match="merging"):
        tproc.merge_vars([tv[0], tproc.select_dates(tv[1], "2006-01-01", "2006-01-01")])


def test_mean_climatology_and_quantiles_match_jax():
    data, coords = _fields(t=24 * 3, h=5, w=6, start="2006-03-01T00", step_h=24 * 365 // 3 + 5)
    jds, tds = _pair(data, coords)
    _assert_grid_equal(tproc.mean_climatology(tds), jproc.mean_climatology(jds))
    data, coords = _fields(t=48, h=5, w=6, start="2006-03-01T00")
    jds, tds = _pair(data, coords)
    _assert_grid_equal(tproc.mean_climatology(tds), jproc.mean_climatology(jds))
    jq, tq = jproc.compute_quantiles(jds), tproc.compute_quantiles(tds)
    np.testing.assert_array_equal(tq.quantiles, jq.quantiles)
    for k in VARS:
        assert tq.values[k].tobytes() == jq.values[k].tobytes()
    # the names stay importable from data/pipeline.py
    assert tpipe.compute_quantiles is tproc.compute_quantiles
    assert tpipe.merged_to_normed_h5 is tproc.merged_to_normed_h5
    with pytest.raises(AttributeError):
        tpipe.no_such_name


ARCHIVE = "{var}_EUR-6km_ECMWF-ERAINT_REA6_r1i1p1f1_COSMO_v1_{t0}-{t1}.nc"


def test_filter_files_by_years_matches_jax(tmp_path):
    names = [ARCHIVE.format(var="psl", t0=f"{y}01010000", t1=f"{y}12312300") for y in (2005, 2006, 2013, 2014, 2020)]
    files = [tmp_path / n for n in names]
    for y0, y1 in ((2006, 2014), (2006, 2006), (2015, 2019)):
        want = jproc.filter_files_by_years(files, y0, y1)
        assert tproc.filter_files_by_years(files, y0, y1) == want
    assert [f.name[-28:-24] for f in tproc.filter_files_by_years(files, 2006, 2014)] == ["2006", "2013", "2014"]
    for proc in (jproc, tproc):
        with pytest.raises(ValueError, match="does not match the required format"):
            proc.filter_files_by_years([tmp_path / "psl_2006.nc"], 2006, 2014)


def test_extract_patch_folder_matches_jax(tmp_path):
    raw = tmp_path / "raw" / "tas"
    raw.mkdir(parents=True)
    for i, (start, t0, t1) in enumerate((("2005-12-31T12", "200512311200", "200512312300"),
                                         ("2006-01-01T00", "200601010000", "200601011100"),
                                         ("2006-01-01T12", "200601011200", "200601012300"))):
        data, coords = _fields(t=12, h=14, w=16, seed=i, start=start)
        if i == 2:
            data["tas"][5] = np.nan
        JGrid({"tas": data["tas"]}, coords).to_file(str(raw / ARCHIVE.format(var="tas", t0=t0, t1=t1)))
    want = jproc.extract_patch_folder(str(raw), str(tmp_path / "jax"), "2006-2014", (2, 10), (3, 11))
    got = tproc.extract_patch_folder(str(raw), str(tmp_path / "port"), "2006-2014", (2, 10), (3, 11))
    assert [p.name for p in got] == [p.name for p in want] and len(got) == 2
    for g, w in zip(got, want):
        _assert_grid_equal(open_grid(str(g)), jax_open_grid(str(w)), ulps=1)
    names = sorted(p.name for p in pathlib.Path(tmp_path / "port").iterdir())
    assert names == sorted(p.name for p in pathlib.Path(tmp_path / "jax").iterdir())
    assert sum(n.endswith("_nan_stats.npz") for n in names) == 1
    assert sum(n.endswith("_with_missing.h5") for n in names) == 1
    with pytest.raises(ValueError, match="match years"):
        tproc.extract_patch_folder(str(raw), str(tmp_path / "none"), "2019-2020")
    with pytest.raises(ValueError, match="not a directory"):
        tproc.extract_patch_folder(str(tmp_path / "missing"), str(tmp_path / "none"))
