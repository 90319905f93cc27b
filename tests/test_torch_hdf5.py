"""climate2weather_tpu_torch.io.hdf5 against h5py: the port's reader reads
what the JAX package's writers (through h5py) produce, arrays and attributes
exactly; what the port's writer produces reads back exactly through h5py and
the JAX readers; layouts it does not cover raise NotImplementedError."""

import json

import h5py
import numpy as np
import pytest

from climate2weather_tpu.data.grid import GridDataset as JaxGrid
from climate2weather_tpu.data.grid import QuantileDataset as JaxQuantiles
from climate2weather_tpu.data.grid import open_grid as jax_open_grid
from climate2weather_tpu.data.processing import compute_quantiles, merged_to_normed_h5
from climate2weather_tpu_torch.data.dataset import WindowDataset
from climate2weather_tpu_torch.io import hdf5

VARS = ("psl", "tas", "uas", "vas")


def _jax_grid(t=30, hw=8, seed=0):
    rng = np.random.RandomState(seed)
    time = np.datetime64("2014-04-07T04", "ns") + np.arange(t) * np.timedelta64(1, "h")
    coords = {"time": time, "rlat": np.linspace(-2, 2, hw), "rlon": np.linspace(0, 4, hw)}
    return JaxGrid({v: rng.randn(t, hw, hw).astype(np.float32) for v in VARS}, coords,
                   {"source": "test", "n": 3})


def _assert_attr_equal(got, want, name):
    if isinstance(want, np.ndarray):
        assert isinstance(got, np.ndarray) and got.dtype == want.dtype, (name, got, want)
        np.testing.assert_array_equal(got, want)
    else:
        assert type(got) is type(want) and got == want, (name, got, want)


def _assert_same_attrs(h, p):
    for k in h.attrs:
        if k in ("DIMENSION_LIST", "REFERENCE_LIST"):  # object references: skipped
            assert k not in p.attrs
            continue
        _assert_attr_equal(p.attrs[k], h.attrs[k], f"{h.name}.{k}")
    assert all(k in h.attrs for k in p.attrs)


def _assert_same_group(h, p):
    assert sorted(p.keys()) == sorted(h.keys())
    _assert_same_attrs(h, p)
    for name in h.keys():
        hd, pd = h[name], p[name]
        if isinstance(hd, h5py.Group):
            assert isinstance(pd, hdf5.Group), name
            _assert_same_group(hd, pd)
            continue
        assert pd.shape == hd.shape and pd.dtype == hd.dtype and pd.chunks == hd.chunks, name
        np.testing.assert_array_equal(pd[()], hd[()])
        _assert_same_attrs(hd, pd)


def _assert_same_file(path):
    """Every dataset, group and attribute h5py sees, the port's reader sees
    equal (dimension-scale attributes of reference type are skipped)."""
    with h5py.File(path, "r") as h, hdf5.File(path) as p:
        _assert_same_group(h, p)


def test_reads_the_tiny_h5_fixture(tiny_h5):
    path, x = tiny_h5
    _assert_same_file(path)
    with hdf5.File(path) as f:
        np.testing.assert_array_equal(f["x"][3:9], x[3:9])
        assert list(f.attrs["vars"]) == ["tas", "uas"] and f.attrs["norm_mode"] == "quant95"


def test_reads_merged_to_normed_h5_chunked(tmp_path):
    ds = _jax_grid(t=53)
    ds.to_file(str(tmp_path / "merged.nc"))
    compute_quantiles(ds).to_file(str(tmp_path / "q.nc"))
    out = merged_to_normed_h5(str(tmp_path / "merged.nc"), str(tmp_path / "q.nc"),
                              str(tmp_path / "train.h5"))
    _assert_same_file(out)
    with h5py.File(out) as h, hdf5.File(out) as p:
        assert p["x"].chunks == (24, 4, 8, 8)
        for sl in (np.s_[0:1], np.s_[20:30], np.s_[47:53], np.s_[5, 2, 1:4], np.s_[-1]):
            np.testing.assert_array_equal(p["x"][sl], h["x"][sl])


def test_reads_grid_and_quantile_files(tmp_path):
    ds = _jax_grid()
    ds.to_file(str(tmp_path / "grid.nc"))
    compute_quantiles(ds).to_file(str(tmp_path / "q.nc"))
    for name in ("grid.nc", "q.nc"):
        _assert_same_file(str(tmp_path / name))
    with hdf5.File(tmp_path / "grid.nc") as f:
        assert json.loads(f.attrs["grid_attrs"]) == {"source": "test", "n": 3}
        assert f["time"].attrs["units"] == "hours since 2014-04-07 04:00:00"
        assert list(f["tas"].attrs["dims"]) == ["time", "rlat", "rlon"]


@pytest.mark.parametrize("filters", [
    dict(compression="gzip", shuffle=True),
    dict(compression="gzip", compression_opts=9),
])
def test_reads_filtered_chunked_files(tmp_path, filters):
    rng = np.random.RandomState(2)
    path = tmp_path / "filtered.h5"
    with h5py.File(path, "w") as f:
        f.create_dataset("x", data=rng.randn(50, 3, 5).astype(np.float32), chunks=(7, 3, 5), **filters)
        f.create_dataset("d", data=rng.randn(9, 4), chunks=(2, 3), **filters)  # ragged edge chunks
        f.create_dataset("b", data=np.arange(27, dtype=">i4").reshape(3, 9), chunks=(2, 4), **filters)
        f.attrs["fixed"] = np.bytes_("fixed-length")
        f.attrs["number"] = 3.5
        f.attrs["ints"] = np.arange(4, dtype=np.int16)
    _assert_same_file(str(path))


def test_reads_groups_many_members_and_continued_headers(tmp_path):
    path = tmp_path / "groups.h5"
    rng = np.random.RandomState(3)
    with h5py.File(path, "w") as f:
        for i in range(40):  # several symbol-table nodes
            f.create_dataset(f"v{i:02d}", data=rng.randn(3))
        g = f.create_group("sub")
        g.create_dataset("y", data=np.arange(5.0))
        d = f["v00"]
        for i in range(30):  # attributes added later continue the object header
            d.attrs[f"a{i:02d}"] = "x" * i
    _assert_same_file(str(path))
    with hdf5.File(path) as f:
        np.testing.assert_array_equal(f["sub/y"][:], np.arange(5.0))
        assert "sub" in f and "nope" not in f


def test_writer_output_reads_back_through_h5py_and_the_jax_readers(tmp_path):
    rng = np.random.RandomState(4)
    x = rng.randn(61, 4, 6, 6).astype(np.float32)
    path = tmp_path / "written.h5"
    with hdf5.Writer(path) as w:
        w.create_dataset("x", data=x, chunks=(24, 4, 6, 6))
        w.create_dataset("time", data=np.arange(5.0), attrs={"units": "hours since 2014-01-01 00:00:00"})
        w.create_dataset("i", data=np.arange(7, dtype=np.int32))
        for i in range(20):  # several symbol-table nodes
            w.create_dataset(f"m{i:02d}", data=rng.randn(2).astype(np.float32), attrs={"dims": ["a", "b"]})
        w.attrs["vars"] = list(VARS)
        w.attrs["norm_mode"] = "quant95"
        w.attrs["scale"] = 2.5
    with h5py.File(path) as h:
        assert h["x"].chunks == (24, 4, 6, 6) and h["x"].maxshape == (None, 4, 6, 6)
        np.testing.assert_array_equal(h["x"][:], x)
        np.testing.assert_array_equal(h["x"][30:50], x[30:50])
        np.testing.assert_array_equal(h["i"][:], np.arange(7, dtype=np.int32))
        assert list(h.attrs["vars"]) == list(VARS) and h.attrs["norm_mode"] == "quant95"
        assert h.attrs["scale"] == 2.5 and list(h["m07"].attrs["dims"]) == ["a", "b"]
        assert h["time"].attrs["units"] == "hours since 2014-01-01 00:00:00"
    _assert_same_file(str(path))


def test_writer_streams_whole_chunks_and_many_of_them(tmp_path):
    """A chunk index deeper than one B-tree node (200 chunks), written in
    blocks, reads back through h5py."""
    rng = np.random.RandomState(5)
    y = rng.randn(200, 3).astype(np.float32)
    path = tmp_path / "many.h5"
    with hdf5.Writer(path) as w:
        d = w.create_dataset("x", shape=y.shape, dtype=np.float32, chunks=(1, 3))
        for t0 in range(0, 200, 50):
            d.write_rows(t0, y[t0:t0 + 50])
    with h5py.File(path) as h:
        np.testing.assert_array_equal(h["x"][:], y)
        np.testing.assert_array_equal(h["x"][150:170], y[150:170])
    with hdf5.File(path) as p:
        np.testing.assert_array_equal(p["x"][77:190], y[77:190])


def test_port_grid_files_read_back_through_the_jax_readers(tmp_path):
    from climate2weather_tpu_torch.data.grid import GridDataset, QuantileDataset

    want = _jax_grid(t=12)
    GridDataset(dict(want.data_vars), dict(want.coords), dict(want.attrs)).to_file(str(tmp_path / "g.nc"))
    got = jax_open_grid(str(tmp_path / "g.nc"))
    np.testing.assert_array_equal(got.time, want.time)
    np.testing.assert_array_equal(got.rlat, want.rlat)
    assert got.attrs == want.attrs
    for k in VARS:
        np.testing.assert_array_equal(got.data_vars[k], want.data_vars[k])
    q = compute_quantiles(want)
    QuantileDataset(q.quantiles, q.values).to_file(str(tmp_path / "q.nc"))
    back = JaxQuantiles.from_file(str(tmp_path / "q.nc"))
    np.testing.assert_array_equal(back.quantiles, q.quantiles)
    for k in VARS:
        np.testing.assert_array_equal(back.values[k], q.values[k])


def test_latest_libver_raises_not_implemented(tmp_path):
    path = tmp_path / "latest.h5"
    with h5py.File(path, "w", libver="latest") as f:
        f.create_dataset("x", data=np.ones(3))
    with pytest.raises(NotImplementedError, match="superblock version"):
        hdf5.File(path)


def _compact_dataset(f):
    dcpl = h5py.h5p.create(h5py.h5p.DATASET_CREATE)
    dcpl.set_layout(h5py.h5d.COMPACT)
    space = h5py.h5s.create_simple((4,))
    h5py.h5d.create(f.id, b"x", h5py.h5t.NATIVE_FLOAT, space, dcpl=dcpl).write(
        h5py.h5s.ALL, h5py.h5s.ALL, np.arange(4, dtype=np.float32))


# No writer of the JAX package asks for a checksum or a compact layout
@pytest.mark.parametrize("make, match", [
    (lambda f: f.create_dataset("x", data=np.arange(8.0), chunks=(4,), fletcher32=True), "filter 3"),
    (_compact_dataset, "layout class 0"),
], ids=["fletcher32", "compact_layout"])
def test_uncovered_dataset_features_raise_not_implemented(tmp_path, make, match):
    path = tmp_path / "uncovered.h5"
    with h5py.File(path, "w") as f:
        make(f)
    with h5py.File(path, "r") as f:
        assert f["x"][:].size in (4, 8)
    with hdf5.File(path) as f, pytest.raises(NotImplementedError, match=match):
        f["x"]


def test_open_file_falls_back_to_h5py_where_installed(tmp_path):
    """A layout the port does not read opens through h5py when h5py is
    installed (as here); the port's own files open through the port."""
    path = tmp_path / "latest.h5"
    with h5py.File(path, "w", libver="latest") as f:
        f.create_dataset("x", data=np.arange(6.0).reshape(2, 3))
    with hdf5.open_file(path) as f:
        assert isinstance(f, h5py.File)
        np.testing.assert_array_equal(f["x"][1], [3.0, 4.0, 5.0])
    with hdf5.Writer(tmp_path / "port.h5") as w:
        w.create_dataset("x", data=np.ones(2))
    with hdf5.open_file(tmp_path / "port.h5") as f:
        assert isinstance(f, hdf5.File)


def test_not_hdf5_raises(tmp_path):
    path = tmp_path / "text.h5"
    path.write_text("not an HDF5 file")
    with pytest.raises(OSError, match="not an HDF5 file"):
        hdf5.File(path)


def test_window_dataset_reads_as_h5py_and_touches_only_its_chunks(tmp_path, monkeypatch):
    ds = _jax_grid(t=80)
    ds.to_file(str(tmp_path / "merged.nc"))
    compute_quantiles(ds).to_file(str(tmp_path / "q.nc"))
    path = merged_to_normed_h5(str(tmp_path / "merged.nc"), str(tmp_path / "q.nc"),
                               str(tmp_path / "train.h5"))
    port = WindowDataset(path, num_features=4, spatial_res=8, window=5)
    with h5py.File(path) as h:
        x = h["x"][:]
    for i in (0, 19, 22, 75):
        np.testing.assert_array_equal(port.load_window(i), x[i:i + 5])
        np.testing.assert_array_equal(port[i], x[i:i + 5].transpose(2, 3, 0, 1).reshape(8, 8, 20))
    reads = []
    src = port._reader().file._src
    real = src.read
    monkeypatch.setattr(src, "read", lambda addr, n: reads.append(n) or real(addr, n))
    port.load_window(30)  # frames 30..34: inside the chunk of frames 24..47
    chunk_bytes = 24 * 4 * 8 * 8 * 4
    assert reads == [chunk_bytes]
