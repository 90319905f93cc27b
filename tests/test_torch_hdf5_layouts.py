"""climate2weather_tpu_torch.io.hdf5 on the HDF5 structures h5py writes beyond
netCDF-C's: soft, external and user-defined links (in new-style and
symbol-table groups), the implicit, version-2 B-tree and swizzled
extensible-array chunk indexes, compact and virtual layouts, the fletcher32,
lzf, n-bit and scale-offset filters, enum, array, compound and committed
datatypes, and h5py's selections (``tests/_h5py_layout_fixtures.py``).

The port's own ``File`` is called throughout (``open_file`` would fall back
to h5py here): every dataset, attribute and selection equals h5py's reading
bit for bit (a compound's members: the bytes between them hold no data),
with and without ``libver='latest'`` where both apply, from another working
directory than the files'; the committed fixtures equal their ``.npz``; the
JAX readers (``open_grid``, ``WindowDataset``, ``climatological_annulus_psd``)
and the port's agree on them; a predict from inputs rewritten in these
structures equals the predict from the port-written originals; what stays
unread raises ``NotImplementedError`` naming itself, and a damaged
fletcher32 chunk ``ChecksumError``.
"""

import os
import pathlib
import shutil
import sys
import time

import h5py
import numpy as np
import pytest

from _h5py_layout_fixtures import (DANGLING, KINDS, LIBVERS, OBSERVATION, SOURCE, USER_DEFINED, WRITERS, canonical,
                                   fixture_path, read_contents, rewrite_in_new_layouts, write_source,
                                   write_user_defined_link)
from climate2weather_tpu.data.dataset import WindowDataset as JaxWindowDataset
from climate2weather_tpu.data.grid import open_grid as jax_open_grid
from climate2weather_tpu.diffusion.calibrate import climatological_annulus_psd as jax_annulus_psd
from climate2weather_tpu_torch.data.dataset import WindowDataset
from climate2weather_tpu_torch.data.grid import open_grid
from climate2weather_tpu_torch.diffusion import calibrate
from climate2weather_tpu_torch.diffusion.calibrate import climatological_annulus_psd
from climate2weather_tpu_torch.io import hdf5

REPO = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
import chip_smoke  # noqa: E402

FIXTURES = REPO / "tests" / "fixtures"
CASES = [(kind, libver) for kind in KINDS for libver in ("earliest", "latest")
         if not (kind == "chunk_indexes" and libver == "earliest")]  # those indexes need the 1.10 format


def _same(got, want, where):
    assert chip_smoke._bits_equal(got, canonical(want)), (where, got, want)


def _assert_attrs_equal(h, p, where):
    assert sorted(p.attrs) == sorted(h.attrs), where
    for k in h.attrs:
        want, got = h.attrs[k], p.attrs[k]
        if isinstance(want, (np.ndarray, np.void)):
            _same(got, want, (where, k))
        else:
            assert type(got) is type(want) and got == want, (where, k, got, want)


def _assert_same(path):
    """Every link, group, dataset, committed datatype and attribute of
    ``path`` as h5py reads it, the port reads equal; a link h5py cannot
    follow raises ``KeyError`` in the port too."""
    def same(h, p, where):
        assert sorted(p.keys()) == sorted(h.keys()), where
        _assert_attrs_equal(h, p, where)
        for name in h.keys():
            assert name in p
            try:
                hc = h[name]
            except KeyError:
                with pytest.raises(KeyError):
                    p[name]
                continue
            pc = p[name]
            if isinstance(hc, h5py.Group):
                assert isinstance(pc, hdf5.Group), where + name
                same(hc, pc, f"{where}{name}/")
            elif isinstance(hc, h5py.Datatype):
                assert isinstance(pc, hdf5.Datatype) and pc.dtype == hc.dtype, where + name
            else:
                assert (pc.shape, pc.dtype, pc.chunks) == (hc.shape, hc.dtype, hc.chunks), where + name
                _same(pc[()], hc[()], where + name)
                _assert_attrs_equal(hc, pc, where + name)

    with h5py.File(path, "r") as h, hdf5.File(path) as p:
        same(h, p, "/")


@pytest.mark.parametrize("kind, libver", CASES, ids=[f"{k}-{v}" for k, v in CASES])
def test_structures_read_as_h5py(tmp_path, monkeypatch, kind, libver):
    files, elsewhere = tmp_path / "files", tmp_path / "elsewhere"
    files.mkdir()
    elsewhere.mkdir()
    write_source(files, libver)
    path = files / fixture_path(kind).name
    WRITERS[kind](path, libver)
    monkeypatch.chdir(elsewhere)  # external names resolve beside the linking file
    _assert_same(path)
    if kind == "selections":
        with h5py.File(path, "r") as h, hdf5.File(path) as p:
            for label, (name, key) in chip_smoke.LAYOUT_SELECTIONS.items():
                _same(p[name][key], h[name][key], label)
    if kind == "links":
        with hdf5.File(path) as p:
            assert isinstance(p["/grp"].file, hdf5.File) and p["e"].file.filename.endswith(SOURCE)
            np.testing.assert_array_equal(p["sg/rel"][()], np.arange(3))


@pytest.mark.parametrize("kind", KINDS)
def test_committed_fixtures_equal_their_contents_and_h5py(kind):
    path = fixture_path(kind)
    _assert_same(path)
    want = np.load(FIXTURES / "h5py_layouts_contents.npz")
    keys = [k for k in want.files if k.startswith(kind + "/")]
    assert keys
    with hdf5.File(path) as f:
        for key in keys:
            name = key.split("/", 1)[1]
            name, sel = chip_smoke.LAYOUT_SELECTIONS.get(name, (name, ())) if kind == "selections" else (name, ())
            assert chip_smoke._bits_equal(f[name][sel], want[key]), key
    assert path.read_bytes()[8] == {"earliest": 0, "latest": 3}[LIBVERS[kind]]  # the superblock's version


def test_committed_contents_are_h5py_reading(tmp_path):
    """The ``.npz`` is what h5py reads from the committed files, and the
    fixture script writes them again with the same contents."""
    want = np.load(FIXTURES / "h5py_layouts_contents.npz")
    got = read_contents(FIXTURES)
    assert sorted(got) == sorted(want.files)
    for k in want.files:
        assert chip_smoke._bits_equal(got[k], want[k]), k
    total = sum(p.stat().st_size for p in FIXTURES.glob("h5py_*")) + (FIXTURES / OBSERVATION).stat().st_size
    assert total < 300_000


@pytest.mark.parametrize("libver", ["earliest", "latest"])
def test_links_list_and_raise_only_when_followed(tmp_path, libver):
    """A group holding dangling soft and external links and a user-defined
    link opens and lists every one; ``in`` answers as h5py (the link
    exists); following a dangling one raises ``KeyError``, the user-defined
    one ``NotImplementedError`` naming it; the other members read."""
    write_source(tmp_path, libver)
    WRITERS["links"](tmp_path / "links.h5", libver)
    write_user_defined_link(tmp_path / "user.h5", libver)
    with hdf5.File(tmp_path / "links.h5") as f, h5py.File(tmp_path / "links.h5") as h:
        assert sorted(f.keys()) == sorted(h.keys())
        for name in DANGLING:
            assert name in f and name in h
            with pytest.raises(KeyError):
                h[name]
            with pytest.raises(KeyError, match=f"'/{name}'"):
                f[name]
        assert ("d/x" in f, "nothing" in f) == ("d/x" in h, "nothing" in h) == (False, False)
        np.testing.assert_array_equal(f["s"][()], h["b"][()])
    with hdf5.File(tmp_path / "user.h5") as f:
        assert sorted(f.keys()) == [USER_DEFINED, "x"] and USER_DEFINED in f
        np.testing.assert_array_equal(f["x"][()], np.arange(3.0))
        with pytest.raises(NotImplementedError, match="user-defined link \\(type 65\\)"):
            f[USER_DEFINED]


def test_external_names_resolve_as_hdf5(tmp_path, monkeypatch):
    """An absolute name that does not exist falls back to its base name
    beside the linking file; the directories of ``HDF5_EXT_PREFIX`` (a
    colon-separated list) are searched before it; a relative name is found
    from the working directory when nothing else holds it."""
    (tmp_path / "beside").mkdir()
    (tmp_path / "prefix").mkdir()
    (tmp_path / "cwd").mkdir()
    for d, value in (("beside", 1.0), ("prefix", 2.0), ("cwd", 3.0)):
        with h5py.File(tmp_path / d / "t.h5", "w") as f:
            f["v"] = np.float64(value)
    with h5py.File(tmp_path / "beside" / "l.h5", "w", libver="latest") as f:
        f["abs"] = h5py.ExternalLink("/no/such/dir/t.h5", "/v")
        f["rel"] = h5py.ExternalLink("t.h5", "/v")
        f["only_cwd"] = h5py.ExternalLink("u.h5", "/v")
    shutil.copy(tmp_path / "cwd" / "t.h5", tmp_path / "cwd" / "u.h5")
    monkeypatch.chdir(tmp_path / "cwd")
    for env, want in ((None, 1.0), (str(tmp_path / "prefix"), 2.0),
                      (f"{tmp_path / 'nowhere'}:{tmp_path / 'prefix'}", 2.0)):
        if env is None:
            monkeypatch.delenv("HDF5_EXT_PREFIX", raising=False)
        else:
            monkeypatch.setenv("HDF5_EXT_PREFIX", env)
        with hdf5.File(tmp_path / "beside" / "l.h5") as f, h5py.File(tmp_path / "beside" / "l.h5") as h:
            for name in ("abs", "rel", "only_cwd"):
                assert f[name][()] == h[name][()], (env, name)
            assert f["rel"][()] == want and f["only_cwd"][()] == 3.0


@pytest.mark.parametrize("key", [[2, 0], [1, 1], ([0, 1], [1, 2]), np.s_[::-1], np.s_[..., ...]],
                         ids=["decreasing", "repeated", "two_lists", "negative_step", "two_ellipses"])
def test_selections_h5py_refuses_raise_as_h5py(tmp_path, key):
    path = tmp_path / "s.h5"
    with h5py.File(path, "w") as f:
        f.create_dataset("x", data=np.arange(12.0).reshape(3, 4))
    with h5py.File(path) as h, hdf5.File(path) as p:
        with pytest.raises(Exception) as want:
            h["x"][key]
        with pytest.raises(type(want.value)):
            p["x"][key]


@pytest.mark.parametrize("layout", ["chunked", "contiguous", "virtual"])
def test_sparse_selections_read_only_the_chunks_or_rows_they_touch(tmp_path, layout):
    """The calibration's ``x[take]`` (16 frames spread over 600) and strided
    slices equal h5py's reading, and the bytes read from the file are those
    of the chunks (rows) holding the selected elements, not of their span."""
    T, frame = 600, (2, 8, 8)
    data = np.random.default_rng(0).standard_normal((T,) + frame).astype(np.float32)
    path = tmp_path / "t.h5"
    with h5py.File(path, "w", libver="latest") as f:
        kw = {"chunks": (4,) + frame, "compression": "gzip"} if layout == "chunked" else {}
        f.create_dataset("src" if layout == "virtual" else "x", data=data, **kw)
        if layout == "virtual":
            v = h5py.VirtualLayout(shape=data.shape, dtype=data.dtype)
            v[:] = h5py.VirtualSource(".", "src", shape=data.shape)
            f.create_virtual_dataset("x", v)
    take = calibrate._frame_stride(T, 16)
    keys = {"take": take, "step": np.s_[::50], "strided": np.s_[3::97, :, ::3, 1::2], "list": [5, 6, 7, 599]}
    with h5py.File(path, "r") as h, hdf5.File(path) as p:
        x = p["x"]
        stored = x if layout != "virtual" else p["src"]
        unit = stored.chunks[0] if stored.chunks else 1
        row = int(np.prod(frame)) * 4
        most = max((size for _, _, size, _ in stored._index), default=0) if stored.chunks else unit * row
        x[0]  # a virtual dataset opens its source on its first read
        read, counted = p._src.read, []
        p._src.read = lambda addr, n: counted.append(n) or read(addr, n)
        for label, key in keys.items():
            counted.clear()
            _same(x[key], h["x"][key], label)
            rows = np.arange(T)[key[0] if isinstance(key, tuple) else key]
            assert sum(counted) <= len(np.unique(rows // unit)) * most, (label, sum(counted))


def _vds(f, vspace, sspace, source=b"."):
    dcpl = h5py.h5p.create(h5py.h5p.DATASET_CREATE)
    dcpl.set_virtual(vspace, source, b"src", sspace)
    h5py.h5d.create(f.id, b"x", h5py.h5t.NATIVE_DOUBLE, vspace.copy(), dcpl=dcpl)


def _vds_unlimited(f):
    f.create_dataset("src", data=np.arange(6.0), maxshape=(None,), chunks=(2,))
    vspace = h5py.h5s.create_simple((4,), (h5py.h5s.UNLIMITED,))
    sspace = h5py.h5s.create_simple((4,), (h5py.h5s.UNLIMITED,))
    for space in (vspace, sspace):
        space.select_hyperslab((0,), (1,), block=(h5py.h5s.UNLIMITED,))
    _vds(f, vspace, sspace)


def _vds_printf(f):
    """Blocks of 2 from files part_0.h5, part_1.h5, ... (HDF5 takes a
    printf name with an unlimited count of virtual blocks only), the first
    three of them beside the file."""
    for b in range(3):
        with h5py.File(pathlib.Path(f.filename).parent / f"part_{b}.h5", "w") as part:
            part.create_dataset("src", data=np.arange(2.0) + 10 * b)
    vspace = h5py.h5s.create_simple((4,), (h5py.h5s.UNLIMITED,))
    vspace.select_hyperslab((0,), (h5py.h5s.UNLIMITED,), stride=(2,), block=(2,))
    sspace = h5py.h5s.create_simple((2,))
    _vds(f, vspace, sspace, b"part_%b.h5")


def _typed(tid):
    def make(f):
        h5py.h5d.create(f.id, b"x", tid, h5py.h5s.create_simple((3,)))
    return make


# what h5py writes and the port leaves unread (ROADMAP A 10's held ones)
@pytest.mark.parametrize("make, match", [
    (lambda f: f.create_dataset("x", shape=(2,), dtype=h5py.ref_dtype), "datatype class 7 \\(reference\\)"),
    (lambda f: f.create_dataset("x", data=np.array([b"ab", b"cd"], "V2")), "datatype class 5 \\(opaque\\)"),
    (lambda f: f.create_dataset("x", shape=(2,), dtype=h5py.vlen_dtype(np.int32)), "variable-length sequence"),
], ids=["reference", "opaque", "vlen_sequence"])
def test_held_leftovers_raise_naming_themselves(tmp_path, make, match):
    path = tmp_path / "left.h5"
    with h5py.File(path, "w", libver="latest") as f:
        f.create_dataset("y", data=np.ones(2))
        make(f)
    with hdf5.File(path) as f:
        np.testing.assert_array_equal(f["y"][()], np.ones(2))
        with pytest.raises(NotImplementedError, match=match):
            f["x"]


# the former cases of the test above: read since A 10's last (szip, bitfields,
# a virtual dataset's unlimited and printf-named mappings)
@pytest.mark.parametrize("make", [
    lambda f: f.create_dataset("x", data=np.arange(64.0), chunks=(32,), compression="szip"),
    _typed(h5py.h5t.STD_B8LE),
    _vds_unlimited,
    _vds_printf,
], ids=["szip", "bitfield", "virtual_unlimited", "virtual_printf"])
def test_formerly_held_leftovers_read_as_h5py(tmp_path, make):
    path = tmp_path / "left.h5"
    with h5py.File(path, "w", libver="latest") as f:
        f.create_dataset("y", data=np.ones(2))
        make(f)
    _assert_same(path)
    with hdf5.File(path) as f:
        assert f["x"].shape == {"virtual_unlimited": (6,), "virtual_printf": (6,)}.get(
            f["x"]._kind == "virtual" and ("virtual_printf" if f["x"]._mappings[0][0] != "." else
                                           "virtual_unlimited"), f["x"].shape)


def test_a_damaged_fletcher32_chunk_raises_checksum_error(tmp_path):
    with h5py.File(tmp_path / "c.h5", "w") as f:
        f.create_dataset("x", data=np.arange(40.0), chunks=(8,), fletcher32=True)
        f.create_dataset("odd", data=np.arange(9, dtype=np.int8), chunks=(9,), fletcher32=True)
    _assert_same(tmp_path / "c.h5")  # an odd byte count takes the checksum's last-byte step
    with hdf5.File(tmp_path / "c.h5") as f:
        _, _, size, addr = f["x"]._index[2]
    raw = bytearray((tmp_path / "c.h5").read_bytes())
    raw[addr + 3] ^= 0x01
    (tmp_path / "d.h5").write_bytes(bytes(raw))
    with hdf5.File(tmp_path / "d.h5") as f:
        np.testing.assert_array_equal(f["x"][:16], np.arange(16.0))  # the chunks before it
        with pytest.raises(hdf5.ChecksumError, match="fletcher32 checksum mismatch"):
            f["x"][()]


def _fletcher32_by_words(data: bytes) -> int:
    """HDF5's Fletcher-32 one word at a time, as ``H5_checksum_fletcher32``."""
    sum1 = sum2 = 0
    n, i = len(data) // 2, 0
    while n:
        t = min(n, 360)
        n -= t
        for _ in range(t):
            sum1 += (data[i] << 8) | data[i + 1]
            sum2 += sum1
            i += 2
        sum1, sum2 = (sum1 & 0xFFFF) + (sum1 >> 16), (sum2 & 0xFFFF) + (sum2 >> 16)
    if len(data) % 2:
        sum1 += data[-1] << 8
        sum2 += sum1
        sum1, sum2 = (sum1 & 0xFFFF) + (sum1 >> 16), (sum2 & 0xFFFF) + (sum2 >> 16)
    sum1, sum2 = (sum1 & 0xFFFF) + (sum1 >> 16), (sum2 & 0xFFFF) + (sum2 >> 16)
    return (sum2 << 16) | sum1


@pytest.mark.parametrize("n", [0, 1, 2, 719, 720, 721, 5001])
def test_fletcher32_equals_the_word_by_word_sum(n):
    data = np.random.default_rng(n).integers(0, 256, n).astype(np.uint8).tobytes()
    assert hdf5.fletcher32(data) == _fletcher32_by_words(data)
    assert hdf5.fletcher32(b"\xff" * n) == _fletcher32_by_words(b"\xff" * n)


def test_an_lzf_chunk_without_its_size_decodes_into_the_chunks_size(tmp_path):
    """A chunk of one repeated value compresses far beyond 4:1; where the
    filter's values do not give the decoded size, the chunk's own bounds
    the output."""
    with h5py.File(tmp_path / "c.h5", "w") as f:
        f.create_dataset("x", data=np.full(1 << 16, 7.0, np.float32), chunks=(1 << 16,), compression="lzf")
    with hdf5.File(tmp_path / "c.h5") as f:
        x = f["x"]
        (_, mask, size, addr), = x._index
        raw = f._src.read(addr, size)
    assert len(raw) * 8 < 1 << 18
    out = hdf5._unfilter(raw, [(hdf5.FILTER_LZF, ())], mask, 4, 1 << 18)
    np.testing.assert_array_equal(np.frombuffer(out, np.float32), np.full(1 << 16, 7.0, np.float32))


def test_a_mebibyte_lzf_chunk_reads_as_h5py(tmp_path):
    """One 1 MiB chunk of a smooth field with shuffle and lzf (long matches)
    and one of noise (short literal runs) decode equal to h5py's reading."""
    rng = np.random.default_rng(0)
    with h5py.File(tmp_path / "big.h5", "w") as f:
        f.create_dataset("smooth", data=np.cumsum(rng.standard_normal(1 << 18)).astype(np.float32),
                         chunks=(1 << 18,), compression="lzf", shuffle=True)
        f.create_dataset("noise", data=rng.integers(0, 40, 1 << 20).astype(np.uint8), chunks=(1 << 20,),
                         compression="lzf")
    t0 = time.perf_counter()
    _assert_same(tmp_path / "big.h5")
    assert time.perf_counter() - t0 < 10


def test_jax_open_grid_agrees_on_the_observation_fixture():
    path = str(FIXTURES / OBSERVATION)
    got, want = open_grid(path), jax_open_grid(path)
    assert sorted(got.data_vars) == sorted(want.data_vars) == ["psl", "tas", "uas", "vas"]
    np.testing.assert_array_equal(got.time, want.time)
    for c in ("rlat", "rlon"):
        assert got.coords[c].tobytes() == want.coords[c].tobytes()
    for v in got.data_vars:
        assert got.data_vars[v].tobytes() == want.data_vars[v].tobytes(), v
    ref = chip_smoke.coarse_observation(chip_smoke.predict_grid())
    np.testing.assert_array_equal(got.time, ref.time)
    with hdf5.File(path) as f:
        assert f["time"].chunks is None and f["psl"].chunks == (3, 4, 4)


@pytest.fixture(scope="module")
def originals(tmp_path_factory):
    """A 13-hour 32 x 32 grid, its quantiles, training file and a coarse
    observation, written by the port's writers; and their copies rewritten
    in the new structures (the training file's ``x`` a virtual dataset over
    two files)."""
    from climate2weather_tpu_torch.data.grid import GridDataset
    from climate2weather_tpu_torch.data.pipeline import compute_quantiles, merged_to_normed_h5

    tmp = tmp_path_factory.mktemp("rewritten")
    rng = np.random.default_rng(7)
    hours, hw = 13, 32
    time_axis = np.datetime64("2014-04-07T04", "ns") + np.arange(hours) * np.timedelta64(1, "h")
    ds = GridDataset({v: (np.cumsum(rng.standard_normal((hours, hw, hw)), 0) * 3 + off).astype(np.float32)
                      for v, off in (("psl", 101000.0), ("tas", 285.0), ("uas", 0.0), ("vas", 0.0))},
                     {"time": time_axis, "rlat": np.linspace(-2, 2, hw), "rlon": np.linspace(0, 4, hw)}, {})
    (tmp / "orig").mkdir()
    (tmp / "new").mkdir()
    paths = {k: tmp / "orig" / f for k, f in (("data", "merged.nc"), ("quantiles", "q.nc"),
                                              ("train", "train_normed.h5"), ("obs", "obs.nc"))}
    ds.to_file(str(paths["data"]))
    compute_quantiles(ds).to_file(str(paths["quantiles"]))
    merged_to_normed_h5(str(paths["data"]), str(paths["quantiles"]), str(paths["train"]))
    chip_smoke.coarse_observation(ds).to_file(str(paths["obs"]))
    new = {k: tmp / "new" / p.name for k, p in paths.items()}
    for k in paths:
        rewrite_in_new_layouts(paths[k], new[k], split="x" if k == "train" else "")
    return {k: str(v) for k, v in paths.items()}, {k: str(v) for k, v in new.items()}


def test_rewritten_inputs_hold_the_new_structures(originals):
    orig, new = originals
    raw = pathlib.Path(new["train"]).read_bytes()
    assert raw[8] == 3
    with hdf5.File(new["train"]) as f, hdf5.File(orig["train"]) as o:
        assert f["x"]._kind == "virtual" and len(f["x"]._mappings) == 2
        assert chip_smoke._bits_equal(f["x"][()], o["x"][()])
    with hdf5.File(new["data"]) as f:
        assert f["time"]._kind == "compact" and f["psl"]._filters and f["psl"]._maxshape == (None,) * 3


def test_jax_window_dataset_agrees_on_the_new_structures(originals):
    _, new = originals
    port, jax_ds = (cls(new["train"], num_features=4, spatial_res=32, window=5) for cls in
                    (WindowDataset, JaxWindowDataset))
    assert len(port) == len(jax_ds) == 9
    for i in (0, 3, 8):
        assert port[i].tobytes() == jax_ds[i].tobytes()
        assert port.load_window(i).tobytes() == jax_ds.load_window(i).tobytes()


def test_jax_annulus_psd_agrees_on_the_new_structures(originals):
    orig, new = originals
    with h5py.File(new["train"]) as h, hdf5.File(new["train"]) as p:
        take = np.unique(np.linspace(0, 12, 5).round().astype(int))
        assert p["x"][take].tobytes() == h["x"][take].tobytes()
    for n_frames in (5, 256):
        got = climatological_annulus_psd(new["train"], s_step=16, n_frames=n_frames)
        assert got.tobytes() == jax_annulus_psd(new["train"], s_step=16, n_frames=n_frames).tobytes()
        assert got.tobytes() == climatological_annulus_psd(orig["train"], s_step=16, n_frames=n_frames).tobytes()


def test_predict_from_rewritten_inputs_equals_the_original(originals, tmp_path):
    """``exp.downscaling.run`` on the CPU (the tiny net at 32 x 32, with
    spectral calibration from the training file and an external
    observation) from the rewritten inputs writes what it writes from the
    port-written originals, bit for bit."""
    import yaml

    from _torch_parity import jax_net_and_params, tiny_config, write_snapshot
    from climate2weather_tpu_torch.exp import downscaling

    cfg_net = tiny_config(channels=4 * 5, window=5)
    _, params = jax_net_and_params(cfg_net, hw=32)
    snap = write_snapshot(tmp_path, cfg_net, params)
    outputs = {}
    for label, paths in zip(("orig", "new"), originals):
        cfg = yaml.safe_load((REPO / "exp" / "configs" / "000_on-model-eval" / "s16_t6_spectral.yml").read_text())
        cfg.update(model_path=snap, data_path=paths["data"], quantile_path=paths["quantiles"],
                   observation_path=paths["obs"], spectral_calibrate=paths["train"], num_hours=13, batch_size=4,
                   num_samples=1, ensemble_batch=1, num_sampling_steps=2)
        config = tmp_path / f"{label}.yml"
        config.write_text(yaml.safe_dump(cfg))
        out = downscaling.run(str(tmp_path / label), str(config), device="cpu")
        outputs[label] = {p.name: open_grid(str(p)) for p in sorted(pathlib.Path(out).glob("*.nc"))}
    assert sorted(outputs["orig"]) == sorted(outputs["new"]) == ["gen_sample_000.nc", "ground_truth.nc",
                                                               "observation.nc"]
    for name, want in outputs["orig"].items():
        got = outputs["new"][name]
        np.testing.assert_array_equal(got.time, want.time)
        for v in want.data_vars:
            assert got.data_vars[v].tobytes() == want.data_vars[v].tobytes(), (name, v)
            assert np.isfinite(got.data_vars[v]).all()


def test_open_file_reads_the_new_structures_without_h5py(tmp_path):
    """``open_grid`` on the observation fixture and every committed fixture
    read in a process where h5py cannot be imported."""
    import json
    import subprocess

    child = r"""
import importlib.abc, json, sys
BLOCKED = {"h5py", "jax", "scipy", "climate2weather_tpu"}
class Blocker(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError(name)
sys.meta_path.insert(0, Blocker())
for name in BLOCKED:
    sys.modules[name] = None
sys.path.insert(0, sys.argv[1])
import pathlib, tempfile
import chip_smoke
from climate2weather_tpu_torch.data.grid import open_grid
rec = chip_smoke._layout_fixtures(pathlib.Path(tempfile.mkdtemp()))
g = open_grid(str(chip_smoke.OBSERVATION_FIXTURE))
leaked = sorted(m for m, mod in sys.modules.items() if mod is not None and m.split(".")[0] in BLOCKED)
print(json.dumps({"rec": rec, "vars": sorted(g.data_vars), "leaked": leaked}))
"""
    proc = subprocess.run([sys.executable, "-c", child, str(REPO)], capture_output=True, text=True, timeout=120,
                          cwd=str(tmp_path), env={**os.environ, "HDF5_EXT_PREFIX": ""})
    assert proc.returncode == 0, proc.stderr[-4000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["leaked"] == [] and out["vars"] == ["psl", "tas", "uas", "vas"]
    assert out["rec"]["equal"] and out["rec"]["fletcher32_fault"] == "fletcher32 checksum mismatch"
