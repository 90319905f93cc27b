"""climate2weather_tpu_torch.data.grid and .pipeline against the JAX
package's modules on the same files: values at rtol/atol 2e-4, calendar
fields and quantiles exactly."""

import numpy as np
import pytest

from _torch_parity import close
from climate2weather_tpu.data import grid as jgrid
from climate2weather_tpu.data import pipeline as jpipe
from climate2weather_tpu.data.processing import compute_quantiles as jax_quantiles
from climate2weather_tpu_torch.data import grid as tgrid
from climate2weather_tpu_torch.data import pipeline as tpipe

VARS = ["psl", "tas", "uas", "vas"]


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """A JAX-written 60-hour 16 x 16 grid (physical-looking values) and its
    quantile file."""
    tmp = tmp_path_factory.mktemp("grid")
    rng = np.random.RandomState(0)
    t = 60
    time = np.datetime64("2014-04-07T04", "ns") + np.arange(t) * np.timedelta64(1, "h")
    coords = {"time": time, "rlat": np.linspace(-3, 3, 16), "rlon": np.linspace(1, 7, 16)}
    offsets = {"psl": 101000.0, "tas": 285.0, "uas": 0.0, "vas": 0.0}
    ds = jgrid.GridDataset({v: (rng.randn(t, 16, 16) * 3 + offsets[v]).astype(np.float32) for v in VARS},
                           coords, {"run": "x"})
    data, quant = str(tmp / "merged.nc"), str(tmp / "q.nc")
    ds.to_file(data)
    jax_quantiles(ds).to_file(quant)
    return data, quant


def _same_grid(got, want, exact=False):
    np.testing.assert_array_equal(got.time, want.time)
    assert got.time.dtype == want.time.dtype
    close(got.rlat, want.rlat)
    close(got.rlon, want.rlon)
    assert got.var_names() == want.var_names() and got.attrs == want.attrs
    for k in want.data_vars:
        assert got.data_vars[k].shape == want.data_vars[k].shape
        if exact:
            np.testing.assert_array_equal(got.data_vars[k], want.data_vars[k])
        else:
            close(got.data_vars[k], want.data_vars[k])


def test_open_grid_matches_jax(files):
    data, _ = files
    _same_grid(tgrid.open_grid(data), jgrid.open_grid(data), exact=True)
    _same_grid(tgrid.open_grid(data, ["tas", "psl"]), jgrid.open_grid(data, ["tas", "psl"]), exact=True)


def test_quantiles_match_jax_exactly(files):
    _, quant = files
    got, want = tgrid.QuantileDataset.from_file(quant), jgrid.QuantileDataset.from_file(quant)
    np.testing.assert_array_equal(got.quantiles, want.quantiles)
    for k in VARS:
        np.testing.assert_array_equal(got.values[k], want.values[k])
        assert got.sel(0.95)[k] == want.sel(0.95)[k]
    port_q = tpipe.compute_quantiles(tgrid.open_grid(files[0]))
    for k in VARS:
        np.testing.assert_array_equal(port_q.values[k], want.values[k])


@pytest.mark.parametrize("start,hours", [("2014-04-07-04", 49), ("2014-04-07-10", 13), ("2014-04-08", 6)])
def test_load_processed_matches_jax(files, start, hours):
    data, _ = files
    _same_grid(tpipe.load_processed(data, VARS, start, hours), jpipe.load_processed(data, VARS, start, hours),
               exact=True)


@pytest.mark.parametrize("mode", ["minmax", "robust", "robust95", "quant95", "quant99"])
def test_normalize_round_trip_matches_jax(files, mode):
    data, quant = files
    got = tpipe.normalize_ds(data, quant, mode)
    want = jpipe.normalize_ds(data, quant, mode)
    _same_grid(got, want)
    _same_grid(tpipe.unnormalize_ds(got, quant, mode), jpipe.unnormalize_ds(want, quant, mode))
    with pytest.raises(ValueError):
        tpipe.normalize_ds(data, quant, "zscore")


def test_layout_helpers_and_coarsen_match_jax(files):
    data, quant = files
    t_ds, j_ds = tgrid.open_grid(data), jgrid.open_grid(data)
    for order in ("LCHW", "CLHW"):
        np.testing.assert_array_equal(tpipe.ds_to_sorted_np(t_ds, VARS, order),
                                      jpipe.ds_to_sorted_np(j_ds, VARS, order))
    arr = jpipe.ds_to_sorted_np(j_ds, VARS)
    np.testing.assert_array_equal(tpipe.nchw_to_nhwc(arr), jpipe.nchw_to_nhwc(arr))
    np.testing.assert_array_equal(tpipe.nhwc_to_nchw(tpipe.nchw_to_nhwc(arr)), arr)
    _same_grid(tpipe.np_to_ds(arr * 2, t_ds, VARS), jpipe.np_to_ds(arr * 2, j_ds, VARS), exact=True)
    _same_grid(t_ds.coarsen_mean(4), j_ds.coarsen_mean(4))
    _same_grid(t_ds.coarsen_mean(8).isel_time(np.arange(0, 49, 6)),
               j_ds.coarsen_mean(8).isel_time(np.arange(0, 49, 6)))


def test_cf_time_round_trip_matches_jax():
    times = np.datetime64("2014-04-07T04", "ns") + np.array([0, 1, 6, 49, 8760]) * np.timedelta64(1, "h")
    hours, units = tgrid._encode_cf_time(times)
    j_hours, j_units = jgrid._encode_cf_time(times)
    assert units == j_units == "hours since 2014-04-07 04:00:00"
    np.testing.assert_array_equal(hours, j_hours)
    back = tgrid._decode_cf_time(hours, units)
    np.testing.assert_array_equal(back, times)
    # calendar fields exactly
    for u in ("days since 2000-01-01", "minutes since 1999-12-31 23:00:00", "seconds since 2014-04-07T04:00:00"):
        vals = np.array([0.0, 1.5, 36.0, 400.0])
        np.testing.assert_array_equal(tgrid._decode_cf_time(vals, u), jgrid._decode_cf_time(vals, u))
    for s in ("2014-04-07-04", "2014-04-07"):
        assert tgrid.convert_to_datetime(s) == jgrid.convert_to_datetime(s)
    with pytest.raises(ValueError):
        tgrid._decode_cf_time(np.zeros(1), "fortnights since 2000-01-01")


def test_port_written_files_match_the_jax_written_ones(files, tmp_path):
    """A grid and quantiles written by the port read back, through both
    packages' readers, equal to what was written; merged_to_normed_h5 of the
    port writes the same ``x`` as the JAX one."""
    import h5py

    from climate2weather_tpu.data.processing import merged_to_normed_h5 as jax_normed

    data, quant = files
    ds = tgrid.open_grid(data)
    ds.to_file(str(tmp_path / "port.nc"))
    _same_grid(jgrid.open_grid(str(tmp_path / "port.nc")), jgrid.open_grid(data), exact=True)
    tpipe.merged_to_normed_h5(str(tmp_path / "port.nc"), quant, str(tmp_path / "port.h5"))
    jax_normed(data, quant, str(tmp_path / "jax.h5"))
    with h5py.File(tmp_path / "port.h5") as p, h5py.File(tmp_path / "jax.h5") as j:
        np.testing.assert_array_equal(p["x"][:], j["x"][:])
        assert p["x"].chunks == j["x"].chunks and p["x"].maxshape == j["x"].maxshape
        assert list(p.attrs["vars"]) == list(j.attrs["vars"]) and p.attrs["norm_mode"] == j.attrs["norm_mode"]


def test_zarr_is_not_ported(files, tmp_path):
    """Kept under its first name, from when the port refused zarr: now a
    round trip through ``to_file`` and ``open_grid`` on a ``.zarr`` path,
    read back by both packages, and the same store read without the
    suffix."""
    import shutil

    ds = tgrid.open_grid(files[0])
    ds.to_file(str(tmp_path / "store.zarr"))
    _same_grid(tgrid.open_grid(str(tmp_path / "store.zarr")), ds, exact=True)
    _same_grid(jgrid.open_grid(str(tmp_path / "store.zarr")), ds, exact=True)
    assert tgrid.open_grid(str(tmp_path / "store.zarr")).attrs == ds.attrs == {"run": "x"}
    shutil.move(str(tmp_path / "store.zarr"), str(tmp_path / "renamed"))
    _same_grid(tgrid.open_grid(str(tmp_path / "renamed")), ds, exact=True)
