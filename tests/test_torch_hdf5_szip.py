"""climate2weather_tpu_torch.io.hdf5 on the last structures h5py writes that
it had refused: the szip filter (decoded by ``data/native/szip.cc``),
external raw storage, a virtual dataset's unlimited and printf-named
mappings, and bitfields (``tests/_h5py_layout_fixtures.py``).

The port's own ``File`` is called throughout (``open_file`` would fall back
to h5py here): every dataset equals h5py's reading bit for bit, every szip
chunk counted is stored filtered (mask 0); a damaged szip stream raises
``OSError`` naming the dataset and the chunk (in a subprocess: a crash of
the codec fails one test); external names resolve as HDF5 1.14 resolves
them; the JAX readers (``open_grid``, ``WindowDataset``,
``climatological_annulus_psd``) and the port's agree on szip-compressed and
multi-year files.
"""

import json
import os
import pathlib
import subprocess
import sys

import h5py
import numpy as np
import pytest

from _h5py_layout_fixtures import (EXTERNAL_RAW, OBSERVATION, OBSERVATION_SZIP, STORAGE_KINDS, SZIP_CASES, YEAR,
                                   YEAR_SHAPE, chunk_masks, fixture_path, open_with_extfile_origin, szip_field,
                                   write_external, write_multiyear)
from climate2weather_tpu.data.dataset import WindowDataset as JaxWindowDataset
from climate2weather_tpu.data.grid import open_grid as jax_open_grid
from climate2weather_tpu.diffusion.calibrate import climatological_annulus_psd as jax_annulus_psd
from climate2weather_tpu_torch.data.dataset import WindowDataset
from climate2weather_tpu_torch.data.grid import open_grid
from climate2weather_tpu_torch.diffusion.calibrate import climatological_annulus_psd
from climate2weather_tpu_torch.io import hdf5

REPO = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
import chip_smoke  # noqa: E402

FIXTURES = REPO / "tests" / "fixtures"
CONTENTS = FIXTURES / "h5py_layouts_contents.npz"
VARS = ("psl", "tas", "uas", "vas")


@pytest.fixture
def origin(monkeypatch):
    """External raw storage found beside its file, as
    ``HDF5_EXTFILE_PREFIX=${ORIGIN}`` has HDF5 find it."""
    monkeypatch.setenv("HDF5_EXTFILE_PREFIX", "${ORIGIN}")


@pytest.mark.parametrize("name", [c[0] for c in SZIP_CASES])
def test_szip_fixture_reads_as_h5py_from_filtered_chunks(name):
    path = fixture_path("szip")
    with h5py.File(path, "r") as h, hdf5.File(path) as p:
        masks = chunk_masks(h[name])
        assert masks and set(masks) == {0}  # HDF5 kept every chunk szip-coded
        assert sorted(m for _, m, _, _ in p[name]._index) == masks
        assert [f[0] for f in p[name]._filters][-1] == hdf5.FILTER_SZIP
        got, want = p[name][()], h[name][()]
        assert chip_smoke._bits_equal(got, want)
        assert chip_smoke._bits_equal(got, np.load(CONTENTS)[f"szip/{name}"])
        assert chip_smoke._bits_equal(p[name][1::2], h[name][1::2])
        assert chip_smoke._bits_equal(p[name][..., ::3], h[name][..., ::3])


@pytest.mark.parametrize("kind", STORAGE_KINDS)
def test_committed_storage_fixtures_equal_their_contents(kind, origin):
    want = np.load(CONTENTS)
    keys = [k for k in want.files if k.startswith(kind + "/")]
    assert keys
    with hdf5.File(fixture_path(kind)) as f, h5py.File(fixture_path(kind), "r") as h:
        assert sorted(f.keys()) == sorted(k.split("/", 1)[1] for k in keys)
        for key in keys:
            name = key.split("/", 1)[1]
            assert chip_smoke._bits_equal(f[name][()], want[key]), key
            ds = open_with_extfile_origin(h, name) if kind == "external" else h[name]
            assert f[name].shape == ds.shape and f[name].dtype == ds.dtype, key
    with hdf5.File(fixture_path("bitfields")) as f:
        assert f["b8"].attrs["flags"].tolist() == [5, 40000]


def _noise_and_fields():
    rng = np.random.default_rng(31)
    return [
        ("weather_chunk", szip_field(rng, (3, 64, 64), "<f4"), (3, 64, 64), ("nn", 32), False),
        ("long_rsi_int16", szip_field(rng, (4, 600), "<u2"), (2, 600), ("nn", 16), False),
        ("be_double_2d", szip_field(rng, (9, 70), ">f8"), (4, 70), ("ec", 32), False),
        ("int32_shuffle_3d", szip_field(rng, (5, 6, 13), ">i4"), (3, 6, 13), ("nn", 8), True),
        ("noise_stored_raw", rng.standard_normal((48,)).astype("<f4"), (16,), ("nn", 8), False),
    ]


def test_szip_cases_made_now_read_as_h5py(tmp_path):
    """A weather-sized chunk, a scanline of 600 (600 / 16 blocks: scanline
    padding, runs of zero blocks to the segment's end), big-endian doubles,
    shuffle before szip, and noise HDF5 stores raw (mask 1, the optional
    filter skipped)."""
    path = tmp_path / "now.h5"
    with h5py.File(path, "w", libver="latest") as f:
        for name, data, chunks, opts, shuffle in _noise_and_fields():
            f.create_dataset(name, data=data, chunks=chunks, compression="szip", compression_opts=opts,
                             shuffle=shuffle)
    with h5py.File(path, "r") as h, hdf5.File(path) as p:
        for name, *_ in _noise_and_fields():
            masks = chunk_masks(h[name])
            assert set(masks) == ({1} if name == "noise_stored_raw" else {0}), (name, masks)
            assert chip_smoke._bits_equal(p[name][()], h[name][()]), name


FAULTS = r"""
import json, sys
import numpy as np
sys.path.insert(0, sys.argv[1])
from climate2weather_tpu_torch.io import hdf5

path, out = sys.argv[2], {}
with hdf5.File(path) as f:
    for name in ("f4_nn8", "i2_ec16", "u1_nn8"):
        d = f[name]
        _, mask, size, addr = d._index[0]
        raw = f._src.read(addr, size)
        nbytes = int(np.prod(d.chunks)) * d._type.size
        where = f"{path}: {d.name}: the chunk at {addr}"
        caught = []
        for cut in (3, 4, 5, size // 2, size - 1):
            try:
                hdf5._unfilter(raw[:cut], d._filters, mask, d._type.size, nbytes, where)
                caught.append(None)
            except OSError as e:
                caught.append(str(e))
        raised = 0
        for i in range(size):  # every byte flipped in turn: an error or a chunk, never a crash
            flipped = bytearray(raw)
            flipped[i] ^= 0x10
            try:
                assert len(hdf5._unfilter(bytes(flipped), d._filters, mask, d._type.size, nbytes, where)) == nbytes
            except OSError:
                raised += 1
        out[name] = {"addr": addr, "truncated": caught, "flips": size, "flips_raised": raised}
raw = bytearray(open(path, "rb").read())
raw[out["f4_nn8"]["addr"] + 4] ^= 0x10  # the first byte of the stream: its first block's option
open(sys.argv[3], "wb").write(bytes(raw))
with hdf5.File(sys.argv[3]) as f:
    try:
        f["f4_nn8"][()]
        out["file_flip"] = None
    except OSError as e:
        out["file_flip"] = str(e)
    out["undamaged"] = f["f4_nn8"][2:].tobytes() == hdf5.File(path)["f4_nn8"][2:].tobytes()
print(json.dumps(out))
"""


def test_damaged_szip_streams_raise_naming_the_chunk_in_a_subprocess(tmp_path):
    path = fixture_path("szip")
    proc = subprocess.run([sys.executable, "-c", FAULTS, str(REPO), str(path), str(tmp_path / "flipped.h5")],
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    for name in ("f4_nn8", "i2_ec16", "u1_nn8"):
        rec = out[name]
        assert all(e and f"/{name}: the chunk at {rec['addr']}: szip decompress failed" in e
                   for e in rec["truncated"]), rec
        assert 0 < rec["flips_raised"] < rec["flips"], rec  # szip carries no checksum: some flips only alter values
    assert out["file_flip"] and "/f4_nn8: the chunk at " in out["file_flip"] and "corrupt" in out["file_flip"]
    assert out["undamaged"]


@pytest.mark.parametrize("vals", [(169, 7, 32, 29), (169, 8, 33, 29), (169, 8, 32, 0), (169, 8, 32, 1 << 20),
                                  (169, 8)], ids=["odd_block", "bits_33", "no_scanline", "scanline_past_rsi",
                                                  "two_values"])
def test_szip_parameters_out_of_range_raise(vals):
    with hdf5.File(fixture_path("szip")) as f:
        (_, mask, size, addr), *_ = f["f4_nn8"]._index
        raw = f._src.read(addr, size)
    assert hdf5._unfilter(raw, [(hdf5.FILTER_SZIP, (169, 8, 32, 29))], mask, 4, 2 * 8 * 29 * 4)
    with pytest.raises(OSError, match="the chunk: szip decompress failed: (filter parameters out of range|"
                                      "2 filter parameters)"):
        hdf5._unfilter(raw, [(hdf5.FILTER_SZIP, vals)], mask, 4, 2 * 8 * 29 * 4, "the chunk")


def test_external_storage_reads_as_h5py(tmp_path, origin):
    """One segment, several across two files with the last unlimited, and a
    scalar; a file shorter than its segment reads as zeros past its end and
    a missing one raises ``OSError`` when read, as h5py does."""
    write_external(tmp_path / "e.h5")
    with h5py.File(tmp_path / "e.h5", "r") as h, hdf5.File(tmp_path / "e.h5") as p:
        for name in ("one", "several", "scalar"):
            want = open_with_extfile_origin(h, name)
            assert chip_smoke._bits_equal(p[name][()], want[()]), name
            assert chip_smoke._bits_equal(p[name][1:4, ::2], want[1:4, ::2]) if want.ndim else True
        assert p["several"]._segments[-1][2] == hdf5.UNDEF
    b = tmp_path / EXTERNAL_RAW[1]
    b.write_bytes(b.read_bytes()[:110])  # "several"'s last 10 bytes are past the end
    (tmp_path / EXTERNAL_RAW[0]).unlink()
    with h5py.File(tmp_path / "e.h5", "r") as h, hdf5.File(tmp_path / "e.h5") as p:
        assert chip_smoke._bits_equal(p["scalar"][()], open_with_extfile_origin(h, "scalar")[()])
        assert chip_smoke._bits_equal(p["several"][3:], open_with_extfile_origin(h, "several")[3:])
        with pytest.raises(OSError, match="unable to open external raw data file"):
            open_with_extfile_origin(h, "one")[()]
        with pytest.raises(OSError, match="unable to open external raw data file"):
            p["one"][()]
        with pytest.raises(OSError, match="unable to open external raw data file"):
            p["several"][()]  # its first segment is in the missing file
        tail = p["several"][3:].tobytes()
        assert tail[-10:] == bytes(10) and tail[-20:-10] != bytes(10)


READ_IN_CHILD = r"""
import json, sys
import h5py
print(json.dumps(h5py.File(sys.argv[1], "r")["several"][()].tolist()))
"""


@pytest.mark.parametrize("how", ["extfile_prefix_origin", "working_directory", "relative_prefix"])
def test_external_names_resolve_as_hdf5(tmp_path, monkeypatch, how):
    """A relative name is found under ``HDF5_EXTFILE_PREFIX`` (a leading
    ``${ORIGIN}`` the file's directory), else from the working directory,
    never beside the file by itself; h5py, whose HDF5 reads the variable
    when it starts, reads in a child process set up alike."""
    files = tmp_path / "files"
    files.mkdir()
    write_external(files / "e.h5")
    env, cwd = {"extfile_prefix_origin": ({"HDF5_EXTFILE_PREFIX": "${ORIGIN}/"}, tmp_path),
                "working_directory": ({}, files),
                "relative_prefix": ({"HDF5_EXTFILE_PREFIX": "files"}, tmp_path)}[how]
    child_env = {k: v for k, v in os.environ.items() if k != "HDF5_EXTFILE_PREFIX"}
    proc = subprocess.run([sys.executable, "-c", READ_IN_CHILD, str(files / "e.h5")], capture_output=True, text=True,
                          timeout=60, cwd=str(cwd), env={**child_env, **env})
    assert proc.returncode == 0, proc.stderr[-2000:]
    monkeypatch.delenv("HDF5_EXTFILE_PREFIX", raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    monkeypatch.chdir(cwd)
    with hdf5.File(files / "e.h5") as p:
        assert p["several"][()].tolist() == json.loads(proc.stdout.strip().splitlines()[-1])
    monkeypatch.chdir(tmp_path)
    monkeypatch.delenv("HDF5_EXTFILE_PREFIX", raising=False)
    with hdf5.File(files / "e.h5") as p, pytest.raises(OSError, match="unable to open external raw data file"):
        p["several"][()]  # beside the file is not searched


def test_multiyear_virtual_datasets_follow_their_sources(tmp_path):
    """The printf mapping stops at the first missing year (HDF5's printf
    gap of 0) and takes a year once its file exists; the unlimited mapping
    of the growing year follows its source's extent; the year no file
    holds reads as the fill value; all as h5py reads them."""
    path = tmp_path / "m.h5"
    write_multiyear(path)

    def same():
        with h5py.File(path, "r") as h, hdf5.File(path) as p:
            for name in ("x", "growing"):
                assert p[name].shape == h[name].shape, name
                assert chip_smoke._bits_equal(p[name][()], h[name][()]), name
                if h[name].shape[0] > 1:  # h5py cannot select from an empty virtual dataset
                    assert chip_smoke._bits_equal(p[name][1::3, 2, :, 1:4], h[name][1::3, 2, :, 1:4]), name
            return p["x"].shape[0], p["growing"].shape[0]

    t = YEAR_SHAPE[0]
    assert same() == (3 * t, 3 * t)
    with hdf5.File(path) as p:
        assert np.isnan(p["growing"][t:2 * t]).all() and p["growing"].fillvalue != p["growing"].fillvalue
    with h5py.File(tmp_path / YEAR.format(4), "a") as f:  # the ongoing year grows
        f["x"].resize((t + 3,) + YEAR_SHAPE[1:])
        f["x"][t:] = -1.0
    assert same() == (3 * t, 3 * t + 3)
    write_multiyear(path)
    with h5py.File(tmp_path / YEAR.format(3), "w") as f:  # the missing year arrives
        f.create_dataset("x", data=np.full(YEAR_SHAPE, 7.0, np.float32))
    assert same() == (5 * t, 3 * t)
    (tmp_path / YEAR.format(0)).unlink()
    assert same() == (0, 3 * t)


def _split_years(tmp_path, grid_path, train_path, hours_a_year, years):
    """The grid and training file cut into yearly files (``grid_<b>.h5``,
    ``train_<b>.h5``: times as hours since the grid's first, every year's
    variables unlimited along time) for the years ``years`` and stitched
    back by printf mappings into ``grid_multiyear.nc`` and
    ``train_multiyear.h5``, attributes copied."""
    unlimited = h5py.h5s.UNLIMITED
    out = {}
    for stem, src in (("grid", grid_path), ("train", train_path)):
        with h5py.File(src, "r") as s:
            names = [n for n in s if s[n].ndim and s[n].shape[0] == s["x" if stem == "train" else "time"].shape[0]]
            for year in years:
                with h5py.File(tmp_path / f"{stem}_{year}.h5", "w", libver="latest") as y:
                    for name in names:
                        part = s[name][year * hours_a_year:(year + 1) * hours_a_year]
                        y.create_dataset(name, data=part, maxshape=(None,) + part.shape[1:],
                                         chunks=(2,) + part.shape[1:])
            dst = tmp_path / f"{stem}_multiyear.{'nc' if stem == 'grid' else 'h5'}"
            with h5py.File(dst, "w", libver="latest") as d:
                for name in s:
                    if name not in names:
                        d.create_dataset(name, data=s[name][()])
                        continue
                    shape = (hours_a_year,) + s[name].shape[1:]
                    vspace = h5py.h5s.create_simple(shape, (unlimited,) + shape[1:])
                    ones = (1,) * (len(shape) - 1)
                    vspace.select_hyperslab((0,) * len(shape), (unlimited,) + ones, stride=(hours_a_year,) + ones,
                                            block=shape)
                    dcpl = h5py.h5p.create(h5py.h5p.DATASET_CREATE)
                    dcpl.set_virtual(vspace, f"{stem}_%b.h5".encode(), name.encode(), h5py.h5s.create_simple(shape))
                    h5py.h5d.create(d.id, name.encode(), h5py.h5t.py_create(s[name].dtype), vspace, dcpl=dcpl)
                for obj in [name for name in s] + [None]:
                    for k, v in (s.attrs if obj is None else s[obj].attrs).items():
                        target = d.attrs if obj is None else d[obj].attrs
                        target.create(k, v, dtype=h5py.string_dtype()) if getattr(v, "dtype", None) == object \
                            else target.__setitem__(k, v)
            out[stem] = str(dst)
    return out


def _szip_copies(tmp_path, grid_path, train_path):
    """The grid and training file rewritten by h5py with szip ``('nn', 32)``
    on chunks of 8 hours (the variables' chunks all stay filtered)."""
    out = {}
    for stem, src in (("grid", grid_path), ("train", train_path)):
        dst = tmp_path / f"{stem}_szip.{'nc' if stem == 'grid' else 'h5'}"
        with h5py.File(src, "r") as s, h5py.File(dst, "w", libver="latest") as d:
            for name in s:
                data = s[name][()]
                if data.ndim >= 3:
                    d.create_dataset(name, data=data, chunks=(8,) + data.shape[1:], compression="szip",
                                     compression_opts=("nn", 32))
                    assert set(chunk_masks(d[name])) == {0}, name
                else:
                    d.create_dataset(name, data=data)
                for k, v in s[name].attrs.items():
                    d[name].attrs.create(k, v, dtype=h5py.string_dtype()) if getattr(v, "dtype", None) == object \
                        else d[name].attrs.__setitem__(k, v)
            for k, v in s.attrs.items():
                d.attrs.create(k, v, dtype=h5py.string_dtype()) if getattr(v, "dtype", None) == object \
                    else d.attrs.__setitem__(k, v)
        out[stem] = str(dst)
    return out


@pytest.fixture(scope="module")
def grid_files(tmp_path_factory):
    """A [24, 4, 32, 32] grid and its training file (the port's writers),
    as szip copies, and as multi-year virtual datasets over years of 8
    hours (years 0-2 and 4; year 3 missing, so year 4 is not reached)."""
    from climate2weather_tpu_torch.data.pipeline import compute_quantiles, merged_to_normed_h5

    tmp = tmp_path_factory.mktemp("szip_grid")
    grid = chip_smoke.predict_grid(res=32, hours=24)
    plain = {"grid": str(tmp / "grid.nc"), "quantiles": str(tmp / "q.nc"), "train": str(tmp / "train.h5")}
    grid.to_file(plain["grid"])
    compute_quantiles(grid).to_file(plain["quantiles"])
    merged_to_normed_h5(plain["grid"], plain["quantiles"], plain["train"])
    (tmp / "years").mkdir()
    years = _split_years(tmp / "years", plain["grid"], plain["train"], 8, (0, 1, 2, 4))
    return plain, _szip_copies(tmp, plain["grid"], plain["train"]), years


@pytest.mark.parametrize("which", ["szip", "multiyear"])
def test_jax_readers_agree_with_the_port_on_szip_and_multiyear_files(grid_files, which):
    plain, szip, years = grid_files
    files = szip if which == "szip" else years
    for path in files.values():
        f = hdf5.open_file(path)
        assert isinstance(f, hdf5.File)  # the port reads it itself, not through h5py
        f.close()
    got, want, orig = open_grid(files["grid"]), jax_open_grid(files["grid"]), open_grid(plain["grid"])
    assert sorted(got.data_vars) == sorted(want.data_vars) == list(VARS)
    assert got.time.tobytes() == want.time.tobytes() == orig.time.tobytes()
    for c in ("rlat", "rlon"):
        assert got.coords[c].tobytes() == want.coords[c].tobytes()
    for v in VARS:
        assert got.data_vars[v].tobytes() == want.data_vars[v].tobytes() == orig.data_vars[v].tobytes(), v
    port, jax_ds = (cls(files["train"], num_features=4, spatial_res=32, window=5) for cls in
                    (WindowDataset, JaxWindowDataset))
    assert len(port) == len(jax_ds) == 20
    for i in (0, 7, 19):
        assert port.load_window(i).tobytes() == jax_ds.load_window(i).tobytes()
        assert port[i].tobytes() == jax_ds[i].tobytes()
    with hdf5.File(files["train"]) as p, h5py.File(plain["train"], "r") as h:
        assert p["x"][()].tobytes() == h["x"][()].tobytes()


def test_jax_annulus_psd_agrees_on_the_szip_training_file(grid_files):
    _, szip, _ = grid_files
    for n_frames in (5, 24):
        got = climatological_annulus_psd(szip["train"], s_step=16, n_frames=n_frames)
        want = jax_annulus_psd(szip["train"], s_step=16, n_frames=n_frames)
        np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)


def test_the_szip_observation_is_the_lzf_one(origin):
    """``observation_szip.nc`` (szip on a version-2 B-tree index, the
    coordinates in external raw storage) holds phase 6's observation bit
    for bit: ``observation_latest.nc``'s values, times and coordinates."""
    path = FIXTURES / OBSERVATION_SZIP
    with hdf5.File(path) as f, h5py.File(path, "r") as h:
        for v in VARS:
            assert set(chunk_masks(h[v])) == {0} and [m for _, m, _, _ in f[v]._index] == chunk_masks(h[v])
            assert f[v]._filters[-1][0] == hdf5.FILTER_SZIP and f[v]._maxshape == (None,) * 3
        for c in ("time", "rlat", "rlon"):
            assert f[c]._segments[0][0].endswith(path.with_suffix(".raw").name)
    got, lzf = open_grid(str(path)), open_grid(str(FIXTURES / OBSERVATION))
    assert got.time.tobytes() == lzf.time.tobytes() and got.attrs == lzf.attrs
    for c in ("rlat", "rlon"):
        assert got.coords[c].tobytes() == lzf.coords[c].tobytes()
    for v in VARS:
        assert got.data_vars[v].tobytes() == lzf.data_vars[v].tobytes(), v
    ref = chip_smoke.coarse_observation(chip_smoke.predict_grid())
    assert got.time.tobytes() == ref.time.tobytes()


def test_phase6_holds_both_observations_bit_for_bit(tmp_path):
    """Phase 6's check of the committed observations against the one it
    writes (128 x 128, 49 hours): both equal bit for bit, the run pointed
    at the szip one; a value changed in the written one is caught."""
    paths = chip_smoke.write_predict_inputs(tmp_path)
    fixtures = [pathlib.Path(p) for p in chip_smoke.OBSERVATION_FIXTURES]
    with chip_smoke.extfile_origin():
        rec = chip_smoke._fixture_observation(dict(paths), fixtures)
        assert [r["bits_equal"] for r in rec["observation_fixtures"].values()] == [True, True]
        assert rec["observation"] == "tests/fixtures/observation_szip.nc"
        obs = open_grid(paths["obs"])
        obs.data_vars["uas"][3, 2, 1] = np.nextafter(obs.data_vars["uas"][3, 2, 1], np.float32(np.inf))
        obs.to_file(paths["obs"])
        with pytest.raises(AssertionError, match="not phase 6's observation"):
            chip_smoke._fixture_observation(dict(paths), fixtures)


def test_a_tiled_szip_chunk_decodes_as_h5py(tmp_path):
    """``chip_smoke.codec_rates``' year chunk: the committed frame's szip
    stream tiled bit for bit is a chunk h5py decodes as the port does, to
    the frame's byte planes repeated."""
    with hdf5.File(FIXTURES / "codec_rate_frame.h5") as f:
        frame, pad = f["szip"][()], int(f["szip"].attrs["pad_bits"])
        (_, mask, size, addr), = f["szip"]._index
        chunk = f._src.read(addr, size)
    assert mask == 0
    tiled = chip_smoke.tiled_szip(chunk, 3, pad)
    with h5py.File(tmp_path / "t.h5", "w") as f:
        d = f.create_dataset("x", shape=(3,) + frame.shape[1:], dtype=frame.dtype, chunks=(3,) + frame.shape[1:],
                             compression="szip", compression_opts=("nn", 32))
        d.id.write_direct_chunk((0,) * 4, tiled)
    with h5py.File(tmp_path / "t.h5", "r") as h, hdf5.File(tmp_path / "t.h5") as p:
        want = h["x"][()]
        assert want.tobytes() == p["x"][()].tobytes() == chip_smoke.tiled_szip_bytes(frame.tobytes(), 3, 4)
