"""Fill values in climate2weather_tpu_torch.io.hdf5: storage a file never
wrote reads as the dataset's fill value, as h5py reads it, and
``open_grid`` masks it to NaN as the JAX ``open_grid`` does.

Every comparison is bit for bit (the arrays' bytes). The cases: the
committed partly written fixtures (``tests/_fill_fixtures.py``) against
their goldens; h5py-written datasets of every chunk index the reader takes
(version-1 B-tree, single chunk, fixed array, extensible array) and
contiguous storage never written, with a user-defined fill value, the
library's default, fill time "never" and a big-endian integer type; the
old fill value message (type 0x4) alone and the new one (0x5) at version
1; partial reads; and the port's own writer, whose files define no fill
value and read as before.
"""

import struct

import h5py
import numpy as np
import pytest

from _fill_fixtures import FILL, LIBVERS, VARS, WRITTEN, contents, fixture_path, write_partly_written
from climate2weather_tpu.data.grid import open_grid as jax_open_grid
from climate2weather_tpu_torch.data.grid import GridDataset, open_grid
from climate2weather_tpu_torch.io import hdf5

GOLDENS = fixture_path("latest").parent / "fill_contents.npz"


def _bits_equal(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype, (got.shape, want.shape, got.dtype, want.dtype)
    assert got.tobytes() == want.tobytes()


def _chunk_index(ds) -> str:
    """The kind of storage index of a port ``Dataset``, from its layout message."""
    buf = ds._obj.find(hdf5.MSG_LAYOUT)
    if buf[1] == 1:
        return "contiguous"
    if buf[0] == 3:
        return "v1 B-tree"
    pos = 5 + buf[4] * buf[3]
    return {1: "single chunk", 3: "fixed array", 4: "extensible array"}[buf[pos]]


@pytest.mark.parametrize("libver", LIBVERS)
def test_committed_fixtures_read_their_goldens(libver):
    goldens = np.load(GOLDENS)
    with hdf5.File(fixture_path(libver)) as f:
        assert sorted(f.keys()) == sorted(k.split("/")[1] for k in goldens if k.startswith(libver + "/"))
        for k in f.keys():
            _bits_equal(f[k][()], goldens[f"{libver}/{k}"])
        kinds = {v: _chunk_index(f[v]) for v in VARS}
        for v in VARS:
            assert np.float32(f[v].fillvalue) == FILL and f[v].attrs["_FillValue"] == FILL
    if libver == "latest":
        assert kinds == {"psl": "extensible array", "tas": "fixed array", "uas": "fixed array", "vas": "contiguous"}
    else:
        assert kinds == {"psl": "v1 B-tree", "tas": "v1 B-tree", "uas": "v1 B-tree", "vas": "contiguous"}
    # the unwritten frames hold the fill value, the written ones the data
    data = contents()
    for v in VARS:
        frames = np.zeros(data[v].shape[0], bool)
        frames[WRITTEN[v]] = True
        _bits_equal(goldens[f"{libver}/{v}"][frames], data[v][frames])
        assert (goldens[f"{libver}/{v}"][~frames] == FILL).all()


@pytest.mark.parametrize("libver", LIBVERS)
def test_fixture_through_open_grid_is_nan_where_jax_is(libver):
    got, want = open_grid(str(fixture_path(libver))), jax_open_grid(str(fixture_path(libver)))
    assert got.var_names() == want.var_names() == sorted(VARS)
    np.testing.assert_array_equal(got.time, want.time)
    for v in VARS:
        _bits_equal(np.isnan(got.data_vars[v]), np.isnan(want.data_vars[v]))
        _bits_equal(np.nan_to_num(got.data_vars[v]), np.nan_to_num(want.data_vars[v]))
        unwritten = np.ones(got.sizes["time"], bool)
        unwritten[WRITTEN[v]] = False
        assert np.isnan(got.data_vars[v][unwritten]).all()
        assert not np.isnan(got.data_vars[v][~unwritten]).any()


@pytest.mark.parametrize("libver", LIBVERS)
def test_fixture_writer_is_deterministic_in_content(libver, tmp_path):
    """The helper, rerun here, writes what the committed goldens hold."""
    path = tmp_path / "again.nc"
    write_partly_written(path, libver, contents())
    goldens = np.load(GOLDENS)
    with hdf5.File(path) as f:
        for k in f.keys():
            _bits_equal(f[k][()], goldens[f"{libver}/{k}"])


# (name, h5py create_dataset keywords, written first-axis rows, chunk index under 'latest')
LAYOUTS = [
    ("extensible", dict(maxshape=(None, 5, 6), chunks=(3, 5, 6)), slice(0, 3), "extensible array"),
    ("fixed", dict(chunks=(3, 5, 6)), slice(3, 6), "fixed array"),
    ("fixed_paged", dict(chunks=(1, 5, 2)), slice(2, 9), "fixed array"),
    ("ragged", dict(chunks=(4, 3, 4)), slice(1, 5), "fixed array"),
    ("single", dict(chunks=(10, 5, 6)), slice(0, 0), "single chunk"),
    ("single_written", dict(chunks=(10, 5, 6)), slice(0, 10), "single chunk"),
    ("never_allocated", dict(chunks=(3, 5, 6)), slice(0, 0), "fixed array"),
    ("contiguous", dict(), slice(0, 0), "contiguous"),
]
# (name, dtype, h5py keywords): a user-defined value, the library's default,
# fill time "never" (HDF5 leaves the buffer; h5py's is zeros) and a
# big-endian integer
FILLS = [
    ("defined", np.float32, dict(fillvalue=FILL)),
    ("default", np.float32, dict()),
    ("time_never", np.float32, dict(fillvalue=FILL, fill_time="never")),
    ("int16_be", np.dtype(">i2"), dict(fillvalue=-7)),
    ("float64", np.float64, dict(fillvalue=-1.5e300)),
]


CASES = [(lay, fill) for lay in LAYOUTS for fill in FILLS]


@pytest.mark.parametrize("layout,fill", CASES, ids=[f"{lay[0]}-{fill[0]}" for lay, fill in CASES])
@pytest.mark.parametrize("libver", LIBVERS)
def test_h5py_written_datasets_read_as_h5py_reads_them(libver, layout, fill, tmp_path):
    name, kw, rows, index = layout
    _, dtype, fkw = fill
    path = tmp_path / "f.h5"
    rng = np.random.default_rng(3)
    with h5py.File(path, "w", libver=libver) as f:
        d = f.create_dataset("x", shape=(10, 5, 6), dtype=dtype, **kw, **fkw)
        if rows.stop > rows.start:
            d[rows] = (100 * rng.standard_normal((rows.stop - rows.start, 5, 6))).astype(dtype)
    with h5py.File(path, "r") as h, hdf5.File(path) as p:
        kind = _chunk_index(p["x"])
        assert kind == (index if libver == "latest" or index == "contiguous" else "v1 B-tree")
        for key in ((), slice(2, 7), 5, (slice(1, 9), slice(1, 4), 2)):
            _bits_equal(p["x"][key], h["x"][key])


def _earliest_with_fill(path):
    """An 'earliest' file whose one dataset has frames 0-2 written and a fill
    value of 9.96921e36: HDF5 writes both the new fill message (version 2)
    and the old one; returns the file's bytes and the new message's body's
    offset."""
    with h5py.File(path, "w", libver="earliest") as f:
        d = f.create_dataset("x", shape=(9, 4, 4), dtype=np.float32, chunks=(3, 4, 4), fillvalue=FILL)
        d[:3] = 1.0
    raw = bytearray(path.read_bytes())
    body = bytes([2]) + bytes([3, 2, 1]) + struct.pack("<I", 4) + FILL.tobytes()
    return raw, raw.index(body)


def test_old_fill_message_alone(tmp_path):
    """With the new message made a null message, HDF5 and the port take
    the old one (0x4: a size and the value, no flags)."""
    path = tmp_path / "old.h5"
    raw, at = _earliest_with_fill(path)
    header = at - 8  # a version-1 message header: type (2 bytes), size (2), flags (1), reserved (3)
    assert struct.unpack_from("<H", raw, header)[0] == hdf5.MSG_FILL
    struct.pack_into("<H", raw, header, hdf5.MSG_NIL)
    path.write_bytes(bytes(raw))
    with h5py.File(path, "r") as h, hdf5.File(path) as p:
        assert p["x"]._obj.find(hdf5.MSG_FILL) is None and p["x"]._obj.find(hdf5.MSG_FILL_OLD) is not None
        _bits_equal(p["x"][()], h["x"][()])
        assert (p["x"][3:] == FILL).all()


def test_new_fill_message_version_1(tmp_path):
    """Version 1 of the new message lays out its fields as version 2 does
    when the value is defined."""
    path = tmp_path / "v1.h5"
    raw, at = _earliest_with_fill(path)
    raw[at] = 1
    path.write_bytes(bytes(raw))
    with h5py.File(path, "r") as h, hdf5.File(path) as p:
        _bits_equal(p["x"][()], h["x"][()])
        assert (p["x"][3:] == FILL).all()


def test_new_fill_message_undefined_reads_zeros(tmp_path):
    """Version 2 with the value undefined (no size field follows) and
    version 3 with its 'undefined' flag: zeros, as h5py reads."""
    path = tmp_path / "undef.h5"
    raw, at = _earliest_with_fill(path)
    raw[at + 3] = 0  # defined -> undefined; the size and value that follow are then not read
    path.write_bytes(bytes(raw))
    with h5py.File(path, "r") as h, hdf5.File(path) as p:
        _bits_equal(p["x"][()], h["x"][()])
        assert p["x"].fillvalue is None and (p["x"][3:] == 0).all()


def test_port_writer_files_define_no_fill_and_read_as_before(tmp_path):
    rng = np.random.default_rng(0)
    time = np.datetime64("2014-04-07T04", "ns") + np.arange(6) * np.timedelta64(1, "h")
    ds = GridDataset({v: rng.standard_normal((6, 4, 5)).astype(np.float32) for v in VARS},
                     {"time": time, "rlat": np.linspace(0, 1, 4), "rlon": np.linspace(0, 1, 5)})
    ds.to_file(str(tmp_path / "g.nc"))
    with hdf5.File(tmp_path / "g.nc") as p, h5py.File(tmp_path / "g.nc", "r") as h:
        for v in VARS:
            assert p[v].fillvalue is None
            _bits_equal(p[v][()], ds.data_vars[v])
            _bits_equal(p[v][()], h[v][()])
    path = tmp_path / "chunked.h5"
    with hdf5.Writer(str(path)) as w:
        w.create_dataset("x", data=np.arange(24, dtype=np.float32).reshape(6, 4), chunks=(2, 4))
    with hdf5.File(path) as p, h5py.File(path, "r") as h:
        assert p["x"].fillvalue is None
        _bits_equal(p["x"][()], h["x"][()])
