"""climate2weather_tpu_torch.io.hdf5 on the files HDF5 1.8+ writes for
netCDF-4 (superblocks 2 and 3, version-2 object headers, new-style groups,
dense attribute and link storage in fractal heaps and version-2 B-trees,
layout version 4 with single-chunk, fixed-array and extensible-array chunk
indexes), written by h5py as netCDF-C lays them out.

The port's own ``File`` is called throughout (``open_file`` would fall back
to h5py here): every dataset and attribute equals h5py's reading bit for
bit; the committed fixtures equal their ``.npz``; ``open_grid`` equals the
JAX ``open_grid``, also in a subprocess where h5py cannot be imported; a
flipped byte inside any checksummed structure raises ``ChecksumError``; a
structure the reader does not decode raises ``NotImplementedError`` naming
it.
"""

import json
import pathlib
import subprocess
import sys

import h5py
import numpy as np
import pytest

from _h5py_layout_fixtures import write_small_addresses, write_user_defined_link
from _netcdf_fixtures import LIBVERS, VARS, contents, fixture_path, write_netcdf_like
from climate2weather_tpu.data.grid import open_grid as jax_open_grid
from climate2weather_tpu_torch.data.grid import open_grid
from climate2weather_tpu_torch.io import hdf5

REPO = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
import chip_smoke  # noqa: E402

SKIPPED_ATTRS = ("DIMENSION_LIST", "REFERENCE_LIST")  # object references and compounds: not decoded


def _assert_attrs_equal(h, p, where):
    want = {k: h.attrs[k] for k in h.attrs if k not in SKIPPED_ATTRS}
    assert sorted(p.attrs) == sorted(want), where
    for k, v in want.items():
        got = p.attrs[k]
        if isinstance(v, np.ndarray):
            assert isinstance(got, np.ndarray) and got.dtype == v.dtype, (where, k)
            np.testing.assert_array_equal(got, v)
        else:
            assert type(got) is type(v) and got == v, (where, k, got, v)


def _assert_same(path):
    """Every group, dataset and attribute of ``path`` as h5py reads it, the
    port's reader reads equal, bit for bit."""
    def same(h, p, where):
        assert sorted(p.keys()) == sorted(h.keys()), where
        _assert_attrs_equal(h, p, where)
        for name in h.keys():
            if isinstance(h[name], h5py.Group):
                same(h[name], p[name], f"{where}{name}/")
                continue
            hd, pd = h[name], p[name]
            assert (pd.shape, pd.dtype, pd.chunks) == (hd.shape, hd.dtype, hd.chunks), name
            want = hd[()]
            assert pd[()].tobytes() == want.tobytes(), name
            _assert_attrs_equal(hd, pd, where + name)

    with h5py.File(path, "r") as h, hdf5.File(path) as p:
        same(h, p, "/")


@pytest.mark.parametrize("libver", sorted(LIBVERS))
@pytest.mark.parametrize("long_attrs", [0, 12])
def test_netcdf_layout_reads_as_h5py(tmp_path, libver, long_attrs):
    path = tmp_path / f"{libver}.nc"
    write_netcdf_like(path, LIBVERS[libver], contents(seed=1), long_attrs=long_attrs)
    _assert_same(path)
    with hdf5.File(path) as f:
        assert f.attrs["Conventions"] == "CF-1.6" and f.attrs["_NCProperties"].startswith(b"version=2")
        assert list(f["psl"].attrs["_Netcdf4Coordinates"]) == [0, 1, 2]
        assert f["time"].attrs["CLASS"] == b"DIMENSION_SCALE"
        # netCDF-C tracks creation order: members come in it
        assert f.keys()[:4] == ["time", "rlat", "rlon", "bnds"]


@pytest.mark.parametrize("name", sorted(LIBVERS))
def test_committed_fixtures_equal_their_contents_and_h5py(name):
    path = fixture_path(name)
    raw = path.read_bytes()
    assert raw[8] == {"v108": 2, "latest": 3}[name]  # the superblock's version
    for sig in (b"OHDR", b"FRHP", b"FHDB", b"FHIB", b"BTHD", b"BTLF"):
        assert sig in raw, sig
    if name == "latest":
        for sig in (b"FAHD", b"FADB", b"EAHD", b"EAIB", b"EASB", b"EADB"):
            assert sig in raw, sig
    _assert_same(path)
    want = np.load(fixture_path("contents").with_suffix(".npz"))
    with hdf5.File(path) as f:
        for k in want.files:
            got = f[k][()]
            assert got.dtype == want[k].dtype and got.tobytes() == want[k].tobytes(), k


@pytest.mark.parametrize("name", sorted(LIBVERS))
def test_open_grid_equals_the_jax_open_grid(name):
    got, want = open_grid(str(fixture_path(name))), jax_open_grid(str(fixture_path(name)))
    assert sorted(got.data_vars) == sorted(want.data_vars) == sorted(VARS)
    np.testing.assert_array_equal(got.time, want.time)
    for c in ("rlat", "rlon"):
        np.testing.assert_array_equal(got.coords[c], want.coords[c])
    for v in VARS:
        assert got.data_vars[v].tobytes() == want.data_vars[v].tobytes(), v
    assert str(got.time[0]) == "2006-01-01T00:00:00.000000000"


CHILD = r"""
import importlib.abc, json, sys

BLOCKED = {"h5py", "jax", "scipy", "click", "netCDF4", "xarray", "climate2weather_tpu"}

class Blocker(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError(f"blocked: {name}")
        return None

sys.meta_path.insert(0, Blocker())
for name in BLOCKED:
    sys.modules[name] = None
sys.path.insert(0, sys.argv[1])
import numpy as np
from climate2weather_tpu_torch.data.grid import open_grid
want = np.load(sys.argv[2])
out = {}
for path in sys.argv[3:]:
    g = open_grid(path)
    out[path] = {v: g.data_vars[v].tobytes() == want[v].tobytes() for v in g.data_vars}
    out[path]["rlat"] = g.rlat.tobytes() == want["rlat"].tobytes()
    out[path]["t0"] = str(g.time[0])
leaked = sorted(m for m, mod in sys.modules.items() if mod is not None and m.split(".")[0] in BLOCKED)
print(json.dumps({"out": out, "leaked": leaked}))
"""


def test_open_grid_reads_the_fixtures_without_h5py(tmp_path):
    paths = [str(fixture_path(n)) for n in sorted(LIBVERS)]
    proc = subprocess.run([sys.executable, "-c", CHILD, str(REPO), str(fixture_path("contents").with_suffix(".npz")),
                           *paths], capture_output=True, text=True, timeout=120, cwd=str(tmp_path))
    assert proc.returncode == 0, proc.stderr[-4000:]
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    assert res["leaked"] == []
    for p in paths:
        got = res["out"][p]
        assert got.pop("t0") == "2006-01-01T00:00:00.000000000"
        assert got == dict.fromkeys(list(VARS) + ["rlat"], True), got


def _read_everything(path):
    with hdf5.File(path) as f:
        def walk(g):
            dict(g.attrs)
            for k in g.keys():
                child = g[k]
                if isinstance(child, hdf5.Group):
                    walk(child)
                elif isinstance(child, hdf5.Dataset):
                    child[()]
        walk(f)


@pytest.mark.parametrize("sig", chip_smoke.CHECKSUMMED, ids=chip_smoke.sig_name)
def test_a_flipped_byte_in_a_checksummed_structure_raises(tmp_path, sig):
    raw = bytearray(fixture_path("latest").read_bytes())
    _read_everything(fixture_path("latest"))
    raw[chip_smoke.checksummed_byte(bytes(raw), sig)] ^= 0x10
    path = tmp_path / "flipped.nc"
    path.write_bytes(bytes(raw))
    with pytest.raises(hdf5.ChecksumError, match="checksum mismatch"):
        _read_everything(path)


def _compact(f):
    dcpl = h5py.h5p.create(h5py.h5p.DATASET_CREATE)
    dcpl.set_layout(h5py.h5d.COMPACT)
    h5py.h5d.create(f.id, b"x", h5py.h5t.NATIVE_FLOAT, h5py.h5s.create_simple((4,)), dcpl=dcpl)


def _implicit(f):
    dcpl = h5py.h5p.create(h5py.h5p.DATASET_CREATE)
    dcpl.set_chunk((2,))
    dcpl.set_alloc_time(h5py.h5d.ALLOC_TIME_EARLY)
    h5py.h5d.create(f.id, b"x", h5py.h5t.NATIVE_FLOAT, h5py.h5s.create_simple((8,)), dcpl=dcpl)


def _shared_type(f):
    f["zz_type"] = np.dtype("f4")  # read after "x" and "y"
    f.create_dataset("x", data=np.ones(2))
    f["x"].attrs.create("a", data=np.ones(2, "f4"), dtype=f["zz_type"])


def _bitfield(f):
    h5py.h5d.create(f.id, b"x", h5py.h5t.STD_B8LE, h5py.h5s.create_simple((3,)))


# structures h5py writes that the reader leaves unread (ROADMAP A 10's held ones)
@pytest.mark.parametrize("make, match", [
    (lambda f: f.create_dataset("x", shape=(2,), dtype=h5py.ref_dtype), "class 7 \\(reference\\)"),
    (lambda f: f.create_dataset("x", data=np.array([b"ab", b"cd"], "V2")), "class 5 \\(opaque\\)"),
    (lambda f: f.create_dataset("x", shape=(2,), dtype=h5py.vlen_dtype(np.int32)), "variable-length sequence"),
], ids=["reference", "opaque", "vlen_sequence"])
def test_unsupported_datasets_raise_naming_the_structure(tmp_path, make, match):
    path = tmp_path / "unsupported.h5"
    with h5py.File(path, "w", libver="latest") as f:
        make(f)
    with hdf5.File(path) as f, pytest.raises(NotImplementedError, match=match):
        f["x"]


# the former cases of the test above: read since the structures h5py writes are
@pytest.mark.parametrize("make", [
    lambda f: f.create_dataset("x", shape=(4, 4), maxshape=(None, None), chunks=(2, 2), dtype="f4"),
    _implicit,
    _compact,
    lambda f: f.create_dataset("x", data=np.arange(8.0), chunks=(4,), fletcher32=True),
    lambda f: f.create_dataset("x", data=np.arange(8.0), maxshape=(None,), chunks=(4,), scaleoffset=2),
    lambda f: f.create_dataset("x", data=np.arange(64.0), chunks=(32,), compression="szip"),
    _bitfield,
], ids=["v2_btree_index", "implicit_index", "compact_layout", "fletcher32", "scaleoffset", "szip", "bitfield"])
def test_formerly_unsupported_datasets_read_as_h5py(tmp_path, make):
    path = tmp_path / "supported.h5"
    with h5py.File(path, "w", libver="latest") as f:
        make(f)
    _assert_same(path)


def _vlen_strings(path):
    with h5py.File(path, "w", libver="latest") as f:
        f.create_dataset("y", data=np.ones(2))
        f.create_dataset("x", data=["ab", "cde"], dtype=h5py.string_dtype())


# what stays unread of links, files and storage (ROADMAP A 10's held ones)
@pytest.mark.parametrize("make, match", [
    (write_user_defined_link, "/u: user-defined link \\(type 65\\)"),
    (write_small_addresses, "offsets of 4 and lengths of 4 bytes"),
    (_vlen_strings, "/x: variable-length string dataset"),
], ids=["user_defined_link", "small_addresses", "vlen_string_dataset"])
def test_unsupported_links_and_attributes_raise_naming_them(tmp_path, make, match):
    path = tmp_path / "unsupported.h5"
    make(path)
    with pytest.raises(NotImplementedError, match=match):
        _read_everything(path)


# the former cases of the test above: read since the structures h5py writes are
@pytest.mark.parametrize("make", [
    lambda f: f.__setitem__("s", h5py.SoftLink("/y")),
    lambda f: f.__setitem__("e", h5py.ExternalLink("other.h5", "/x")),
    _shared_type,
    lambda f: f.__setitem__("t", np.dtype("f4")),
    lambda f: f.create_dataset("x", data=np.arange(4.0),
                               external=[(str(pathlib.Path(f.filename).parent / "raw.bin"), 0, 32)]),
], ids=["soft_link", "external_link", "committed_datatype_attribute", "committed_datatype", "external_storage"])
def test_formerly_unsupported_links_and_attributes_read_as_h5py(tmp_path, make):
    with h5py.File(tmp_path / "other.h5", "w") as f:
        f.create_dataset("x", data=np.arange(3.0))
    path = tmp_path / "supported.h5"
    with h5py.File(path, "w", libver="latest") as f:
        f.create_dataset("y", data=np.ones(2))
        make(f)
    _read_everything(path)
    with h5py.File(path, "r") as h, hdf5.File(path) as p:
        assert sorted(p.keys()) == sorted(h.keys())
        for name in h:
            if isinstance(h[name], h5py.Datatype):
                assert isinstance(p[name], hdf5.Datatype) and p[name].dtype == h[name].dtype
            else:
                assert p[name][()].tobytes() == h[name][()].tobytes(), name
                _assert_attrs_equal(h[name], p[name], name)


@pytest.mark.parametrize("libver", sorted(LIBVERS))
@pytest.mark.parametrize("track_order", [False, True])
def test_dense_storage_at_depth(tmp_path, libver, track_order):
    """Thousands of links and attributes: version-2 B-trees of depth 2
    (by name, and by creation order where it is tracked), fractal heaps
    with indirect blocks below the root, and attributes larger than a
    managed object (huge objects through their own B-tree)."""
    path = tmp_path / "dense.h5"
    with h5py.File(path, "w", libver=LIBVERS[libver], track_order=track_order) as f:
        x = f.create_dataset("x", data=np.arange(3.0), track_order=track_order)
        for i in range(9000):
            f[f"{i:06d}" + "n" * 60] = x
        for i in range(1500):
            x.attrs[f"attribute_{i:05d}"] = "value " * (i % 50)
        x.attrs["huge"] = "H" * 5000
        f.attrs["huge_array"] = np.arange(3000, dtype=np.int32)
        g = f.create_group("sub", track_order=track_order)
        g.create_dataset("y", data=np.arange(4))
    raw = path.read_bytes()
    assert raw.count(b"FHIB") >= 2 and raw.count(b"BTIN") >= 2
    with h5py.File(path) as h, hdf5.File(path) as p:
        assert sorted(p.keys()) == sorted(h.keys()) and len(p.keys()) == 9002
        if track_order:
            assert p.keys() == list(h.keys())
        _assert_attrs_equal(h["x"], p["x"], "x")
        _assert_attrs_equal(h, p, "/")
        np.testing.assert_array_equal(p["sub/y"][:], np.arange(4))
        np.testing.assert_array_equal(p["000123" + "n" * 60][:], np.arange(3.0))


def test_chunk_indexes_of_layout_version_4(tmp_path):
    """Fixed arrays paged and not, filtered and not, over a maximum shape
    larger than the current one; extensible arrays over several super
    blocks, filtered, partly written and empty; single chunks with and
    without a filter; big-endian data."""
    rng = np.random.default_rng(0)
    path = tmp_path / "layouts.h5"
    with h5py.File(path, "w", libver="latest") as f:
        f.create_dataset("fa_paged", data=rng.standard_normal((3000, 4)).astype(np.float32), chunks=(2, 4))
        f.create_dataset("fa_paged_filtered", data=np.arange(6000, dtype=np.int32).reshape(3000, 2), chunks=(2, 2),
                         compression="gzip", shuffle=True)
        f.create_dataset("fa_maxshape", data=np.arange(20.0).reshape(4, 5), maxshape=(8, 10), chunks=(3, 3))
        d = f.create_dataset("fa_partial", shape=(50, 4), chunks=(3, 3), dtype=np.float64)
        d[10:20, 1:3] = 5.0
        f.create_dataset("ea_many", data=rng.standard_normal((3000, 3)), maxshape=(None, 3), chunks=(1, 3))
        f.create_dataset("ea_filtered", data=rng.standard_normal((700, 5)).astype(np.float32), maxshape=(None, 5),
                         chunks=(1, 2), compression="gzip")
        d = f.create_dataset("ea_partial", shape=(50, 4), maxshape=(None, 8), chunks=(3, 3), dtype=np.float64)
        d[10:20, 1:3] = 7.0
        f.create_dataset("ea_empty", shape=(0, 2), maxshape=(None, 2), chunks=(5, 2), dtype=np.float32)
        f.create_dataset("single", data=np.arange(12.0).reshape(3, 4), chunks=(3, 4))
        f.create_dataset("single_filtered", data=np.arange(12.0).reshape(3, 4), chunks=(3, 4), compression="gzip")
        f.create_dataset("big_endian", data=np.arange(30, dtype=">f8").reshape(10, 3), chunks=(4, 3))
    raw = path.read_bytes()
    assert raw.count(b"EASB") >= 2 and b"FADB" in raw
    _assert_same(path)
    with hdf5.File(path) as p, h5py.File(path) as h:
        for sl in (np.s_[1500:1503], np.s_[-1], np.s_[7, 1:3]):
            np.testing.assert_array_equal(p["ea_many"][sl], h["ea_many"][sl])
            np.testing.assert_array_equal(p["fa_paged"][sl], h["fa_paged"][sl])


def test_extensible_array_with_paged_data_blocks(tmp_path):
    """More than 131,060 chunks along the unlimited axis: the extensible
    array's later data blocks are paged (pages of 1024 entries)."""
    path = tmp_path / "paged.h5"
    with h5py.File(path, "w", libver="latest") as f:
        d = f.create_dataset("x", shape=(140000,), maxshape=(None,), chunks=(1,), dtype=np.int16)
        d[:] = np.arange(140000) % 3000
    with hdf5.File(path) as p:
        np.testing.assert_array_equal(p["x"][:], np.arange(140000) % 3000)
        np.testing.assert_array_equal(p["x"][139990:], np.arange(139990, 140000) % 3000)
