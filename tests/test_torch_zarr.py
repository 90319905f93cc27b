"""The port's zarr-v2 store (``data/zarr_store.py``) and its blosc codec
(``data/native/blosc.cc`` through ``data/native_blosc.py``) against the JAX
package's.

Everything is compared bit for bit (array bytes, or file bytes):

- the codec on the public-spec golden chunks of ``tests/test_blosc.py``,
  round trips through shuffle, split streams and leftover blocks, every
  entry of the error table, and its encoder's output equal to the JAX
  codec's on the same input;
- the committed stores the JAX package wrote (``tests/_zarr_fixtures.py``:
  zlib, blosc-lz4, uncompressed with a missing chunk) read by the port, and
  the same grid written by the port into the same files byte for byte;
- fresh stores written by each package read by the other, for each
  compressor, with missing chunks under ``fill_value`` null, 0 and "NaN";
- ``open_grid`` on a store without the ``.zarr`` suffix, ``to_file`` on a
  ``.zarr`` path, the errors that name the store, the array or chunk and
  the codec;
- ``data.cli`` and ``exp/downscaling`` (a tiny predict on the CPU) from
  ``.zarr`` stores against the same runs from ``.nc`` files.
"""

import ctypes
import json
import os
import pathlib
import shutil
import struct

import numpy as np
import pytest
import yaml

from _torch_parity import jax_net_and_params, tiny_config, write_snapshot
from _zarr_fixtures import COMPRESSORS, MISSING, VARS, grid, grid_arrays, store_path, write_jax_store
from climate2weather_tpu.data import native_blosc as jax_blosc
from climate2weather_tpu.data.grid import GridDataset as JaxGrid
from climate2weather_tpu.data.grid import open_grid as jax_open_grid
from climate2weather_tpu_torch.data import cli, native_blosc, zarr_store
from climate2weather_tpu_torch.data.grid import GridDataset, open_grid
from climate2weather_tpu_torch.data.processing import compute_quantiles
from climate2weather_tpu_torch.exp import downscaling

REPO = pathlib.Path(__file__).resolve().parents[1]
CONTENTS = store_path("zlib").parent / "zarr_contents.npz"


def _bits_equal(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype, (got.shape, want.shape, got.dtype, want.dtype)
    assert got.tobytes() == want.tobytes()


def _same_grid(got, want):
    assert got.var_names() == want.var_names()
    _bits_equal(got.time, want.time)
    _bits_equal(got.rlat, want.rlat)
    _bits_equal(got.rlon, want.rlon)
    for v in want.var_names():
        _bits_equal(got.data_vars[v], want.data_vars[v])
    assert got.attrs == want.attrs


def _files(root) -> dict:
    root = pathlib.Path(root)
    return {str(p.relative_to(root)): p.read_bytes() for p in sorted(root.rglob("*")) if p.is_file()}


# -- the codec ---------------------------------------------------------------


def _header(flags, typesize, nbytes, blocksize, cbytes):
    return bytes([2, 1, flags, typesize]) + struct.pack("<III", nbytes, blocksize, cbytes)


def golden_chunks():
    """(chunk, payload) of the public-spec goldens: a memcpy chunk, an
    all-literals LZ4 stream, and a match whose offset is below its length."""
    memcpy = (_header(0x2 | (1 << 5), 1, 8, 8, 16 + 8) + bytes(range(8)), bytes(range(8)))
    payload = b"abcdefgh"
    stream = bytes([len(payload) << 4]) + payload
    literals = (_header(1 << 5, 1, 8, 8, 16 + 4 + 4 + len(stream)) + struct.pack("<I", 20)
                + struct.pack("<I", len(stream)) + stream, payload)
    stream = bytes([0x40 | 0x04]) + b"abab" + struct.pack("<H", 2)
    match = (_header(1 << 5, 1, 12, 12, 16 + 4 + 4 + len(stream)) + struct.pack("<I", 20)
             + struct.pack("<I", len(stream)) + stream, b"abab" + b"ab" * 4)
    return {"memcpy": memcpy, "literals": literals, "match": match}


@pytest.mark.parametrize("name", sorted(golden_chunks()))
def test_codec_decodes_the_golden_chunks(name):
    chunk, payload = golden_chunks()[name]
    assert native_blosc.decompress(chunk) == payload == jax_blosc.decompress(chunk)


@pytest.mark.parametrize("dtype", [np.float32, np.float64, np.int16])
@pytest.mark.parametrize("shuffle", [True, False])
def test_codec_round_trip_equals_jax_bytes(dtype, shuffle):
    """Smooth fields over several 32 KiB blocks with split streams."""
    x = np.cumsum(np.random.RandomState(0).randn(40000).astype(dtype))
    raw = np.ascontiguousarray(x).tobytes()
    c = native_blosc.compress(raw, np.dtype(dtype).itemsize, shuffle=shuffle)
    assert c == jax_blosc.compress(raw, np.dtype(dtype).itemsize, shuffle=shuffle)
    if shuffle:
        assert len(c) < len(raw)
    assert native_blosc.decompress(c) == raw


@pytest.mark.parametrize("n", [0, 1, 7, 127, 128, 4096, 32768, 32769, 100001])
def test_codec_round_trip_sizes(n):
    """Empty, below the split threshold, one exact block, a leftover block."""
    rng = np.random.RandomState(n or 1)
    raw = (np.arange(n, dtype=np.uint8) // 7 + rng.randint(0, 2, n)).astype(np.uint8).tobytes()
    for typesize in (1, 4, 8):
        c = native_blosc.compress(raw, typesize, shuffle=True)
        assert c == jax_blosc.compress(raw, typesize, shuffle=True), (n, typesize)
        assert native_blosc.decompress(c) == raw, (n, typesize)
        assert jax_blosc.decompress(c) == raw


def test_codec_incompressible_is_a_memcpy_chunk():
    raw = np.random.RandomState(5).bytes(5000)
    c = native_blosc.compress(raw, 4, shuffle=True)
    assert len(c) == 16 + len(raw) and c[2] & 0x2
    assert native_blosc.decompress(c) == raw


def _u8(b):
    return (ctypes.c_uint8 * max(1, len(b))).from_buffer_copy(b or b"\0")


# error code -> the input that yields it: through the wrappers where they can
# reach it, else through the C entry points (a short output buffer, a length
# past 2 GiB)
ERROR_CASES = {
    -1: lambda lib: native_blosc.decompress(b"\x02\x01\x00"),
    -2: lambda lib: native_blosc._check(lib.c2w_blosc_decompress(_u8(golden_chunks()["memcpy"][0]), 24,
                                                                 _u8(bytes(4)), 4), "decompress"),
    -3: lambda lib: native_blosc.decompress(_header(4 << 5, 4, 64, 64, 16) + bytes(64)),
    -4: lambda lib: native_blosc.decompress(_header(0x4 | (1 << 5), 4, 64, 64, 16) + bytes(64)),
    -5: lambda lib: native_blosc.decompress(_header(1 << 5, 1, 12, 12, 30) + struct.pack("<I", 20)
                                            + struct.pack("<I", 6) + bytes([0x44]) + b"abab" + b"\x00"),
    -6: lambda lib: native_blosc._check(lib.c2w_blosc_compress(_u8(bytes(16)), 1 << 31, 4, 1, 0,
                                                               _u8(bytes(64)), 64), "compress"),
}


@pytest.mark.parametrize("code", sorted(ERROR_CASES))
def test_codec_error_table(code):
    assert set(native_blosc._ERRORS) == set(jax_blosc._ERRORS) == set(ERROR_CASES)
    assert native_blosc._ERRORS[code] == jax_blosc._ERRORS[code]
    with pytest.raises(ValueError) as e:
        ERROR_CASES[code](native_blosc.load())
    assert str(e.value).endswith(native_blosc._ERRORS[code])


def test_codec_build_is_keyed_and_reported(tmp_path):
    lib = native_blosc.build()
    assert lib.parent == native_blosc.BUILD_DIR and lib.name.startswith("libc2wblosc-")
    assert native_blosc.library_path(native_blosc.find_cxx()) == lib
    assert native_blosc.load().c2w_blosc_abi_version() == native_blosc.ABI_VERSION == 1
    rebuilt = native_blosc.build(rebuild=True)
    assert rebuilt == lib and native_blosc.build_info["seconds"] > 0 and native_blosc.build_info["compiler"]


def test_codec_build_failure_raises_with_the_compiler_output(monkeypatch, tmp_path):
    bad = tmp_path / "blosc.cc"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native_blosc, "SOURCE", bad)
    monkeypatch.setattr(native_blosc, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="failed to build") as e:
        native_blosc.build()
    assert "blosc.cc" in str(e.value) and "error" in str(e.value)
    monkeypatch.setattr(native_blosc, "_lib", None)
    with pytest.raises(ValueError, match="need the native codec, which failed to build") as e:
        open_grid(str(store_path("blosc-lz4")))
    assert str(store_path("blosc-lz4")) in str(e.value) and "blosc.cc" in str(e.value)
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.delenv("CXX", raising=False)
    with pytest.raises(RuntimeError, match="no C\\+\\+ compiler"):
        native_blosc.build()


# -- the committed JAX-written stores ----------------------------------------


@pytest.mark.parametrize("comp", COMPRESSORS)
def test_jax_written_fixture_reads_bit_for_bit(comp):
    contents = np.load(CONTENTS)
    got = open_grid(str(store_path(comp)))
    assert got.var_names() == sorted(VARS)
    for v in VARS:
        _bits_equal(got.data_vars[v], contents[f"{comp}/{v}"])
    _bits_equal(got.time, contents[f"{comp}/time"])
    _same_grid(got, jax_open_grid(str(store_path(comp))))
    if comp in MISSING:  # the missing chunk's frames read as the fill value (null: 0)
        assert (got.data_vars["tas"][24:] == 0).all()
        _bits_equal(got.data_vars["tas"][:24], contents["tas"][:24])
    else:
        for v in VARS:
            _bits_equal(got.data_vars[v], contents[v])


@pytest.mark.parametrize("comp", COMPRESSORS)
def test_port_writes_the_fixture_files_byte_for_byte(comp, tmp_path):
    out = tmp_path / "port.zarr"
    zarr_store.write_zarr(grid(GridDataset), str(out), compressor=comp)
    want, got = _files(store_path(comp)), _files(out)
    if comp in MISSING:
        assert MISSING[comp] not in want
        got.pop(MISSING[comp])
    assert sorted(got) == sorted(want)
    for name in want:
        assert got[name] == want[name], name


# -- both ways, fresh stores -------------------------------------------------


@pytest.mark.parametrize("fill", [None, 0, "NaN"], ids=["null", "zero", "nan"])
@pytest.mark.parametrize("comp", COMPRESSORS)
def test_jax_store_with_missing_chunks_reads_as_jax_reads(comp, fill, tmp_path):
    path = tmp_path / "jax.zarr"
    write_jax_store(path, comp, grid(JaxGrid, seed=1))
    for v in ("psl", "uas"):
        meta_path = path / v / ".zarray"
        meta = json.loads(meta_path.read_text())
        meta["fill_value"] = fill
        meta_path.write_text(json.dumps(meta))
        os.remove(path / v / "0.0.0")
    got, want = open_grid(str(path)), jax_open_grid(str(path))
    _same_grid(got, want)
    expect = {None: 0.0, 0: 0.0, "NaN": np.nan}[fill]
    np.testing.assert_array_equal(got.data_vars["psl"][:24], np.float32(expect))


@pytest.mark.parametrize("comp", COMPRESSORS)
def test_port_store_reads_in_jax_bit_for_bit(comp, tmp_path):
    ds = grid(GridDataset, seed=2)
    zarr_store.write_zarr(ds, str(tmp_path / "port.zarr"), compressor=comp)
    _same_grid(jax_open_grid(str(tmp_path / "port.zarr")), ds)
    _same_grid(open_grid(str(tmp_path / "port.zarr")), ds)


def test_open_grid_takes_a_store_without_the_suffix(tmp_path):
    shutil.copytree(store_path("blosc-lz4"), tmp_path / "store")
    _same_grid(open_grid(str(tmp_path / "store")), jax_open_grid(str(store_path("blosc-lz4"))))
    _same_grid(open_grid(str(tmp_path / "store"), data_vars=["tas"]),
               jax_open_grid(str(store_path("blosc-lz4")), data_vars=["tas"]))


def test_to_file_writes_a_zarr_store_for_a_zarr_path(tmp_path):
    ds = grid(GridDataset, seed=3)
    ds.to_file(str(tmp_path / "out.zarr"))
    assert zarr_store.is_zarr(str(tmp_path / "out.zarr"))
    assert json.loads((tmp_path / "out.zarr" / "psl" / ".zarray").read_text())["compressor"]["id"] == "zlib"
    JaxGrid(dict(ds.data_vars), dict(ds.coords), dict(ds.attrs)).to_file(str(tmp_path / "jax.zarr"))
    assert _files(tmp_path / "out.zarr") == _files(tmp_path / "jax.zarr")


def test_store_without_time_gets_an_index_axis(tmp_path):
    path = tmp_path / "notime.zarr"
    zarr_store.write_zarr(grid(GridDataset), str(path))
    shutil.rmtree(path / "time")
    _same_grid(open_grid(str(path)), jax_open_grid(str(path)))


def test_corrupt_blosc_chunk_names_the_store_and_the_chunk(tmp_path):
    path = tmp_path / "bad.zarr"
    shutil.copytree(store_path("blosc-lz4"), path)
    chunk = path / "tas" / "0.0.0"
    raw = bytearray(chunk.read_bytes())
    first_block = struct.unpack_from("<I", raw, 16)[0]
    raw[first_block + 3] ^= 0x40  # the high byte of its first stream's size: past the chunk's end
    chunk.write_bytes(bytes(raw))
    with pytest.raises(ValueError, match="blosc decompress failed") as e:
        open_grid(str(path))
    assert str(path) in str(e.value) and str(chunk) in str(e.value)


@pytest.mark.parametrize("change,match", [
    ({"compressor": {"id": "zstd", "level": 1}}, "unsupported compressor 'zstd'"),
    ({"order": "F"}, "F-order"),
    ({"filters": [{"id": "delta", "dtype": "<f4"}]}, "filter pipelines"),
    ({"zarr_format": 3}, "zarr_format 3"),
])
def test_unreadable_array_names_the_store_and_the_array(tmp_path, change, match):
    path = tmp_path / "odd.zarr"
    shutil.copytree(store_path("zlib"), path)
    meta = json.loads((path / "vas" / ".zarray").read_text())
    meta.update(change)
    (path / "vas" / ".zarray").write_text(json.dumps(meta))
    with pytest.raises(ValueError, match=match) as e:
        open_grid(str(path))
    assert str(path) in str(e.value) and "'vas'" in str(e.value)
    with pytest.raises((ValueError, AssertionError)):
        jax_open_grid(str(path))


def test_unknown_compressor_is_refused_before_writing(tmp_path):
    with pytest.raises(ValueError, match="unknown zarr compressor"):
        zarr_store.write_zarr(grid(GridDataset), str(tmp_path / "x.zarr"), compressor="zstd")
    assert not (tmp_path / "x.zarr").exists()


# -- the data command line and predict from stores ---------------------------


def test_data_cli_takes_zarr_paths(tmp_path):
    ds = grid(GridDataset, seed=4)
    ds.to_file(str(tmp_path / "in.nc"))
    zarr_store.write_zarr(ds, str(tmp_path / "in.zarr"), compressor="blosc-lz4")
    window = ["--start", "2014-04-07-10", "--end", "2014-04-08-06"]
    cli.main(["select-dates", "--in-path", str(tmp_path / "in.nc"), "--out-path", str(tmp_path / "s.nc"), *window])
    cli.main(["select-dates", "--in-path", str(tmp_path / "in.zarr"), "--out-path", str(tmp_path / "s.zarr"),
              *window])
    _same_grid(open_grid(str(tmp_path / "s.zarr")), open_grid(str(tmp_path / "s.nc")))
    _same_grid(jax_open_grid(str(tmp_path / "s.zarr")), open_grid(str(tmp_path / "s.nc")))
    cli.main(["merge-time", "--out-path", str(tmp_path / "m.zarr"), str(tmp_path / "s.zarr"), str(tmp_path / "in.zarr")])
    cli.main(["merge-time", "--out-path", str(tmp_path / "m.nc"), str(tmp_path / "s.nc"), str(tmp_path / "in.nc")])
    _same_grid(open_grid(str(tmp_path / "m.zarr")), open_grid(str(tmp_path / "m.nc")))
    cli.main(["quantiles", "--in-path", str(tmp_path / "in.zarr"), "--out-path", str(tmp_path / "qz.nc")])
    cli.main(["quantiles", "--in-path", str(tmp_path / "in.nc"), "--out-path", str(tmp_path / "qn.nc")])
    assert (tmp_path / "qz.nc").read_bytes() == (tmp_path / "qn.nc").read_bytes()


HOURS, HW, C, WINDOW = 25, 32, 4, 5


def test_predict_from_zarr_stores_equals_predict_from_files(tmp_path):
    """``exp/downscaling.run`` on the CPU with the tiny net: ground truth from
    a blosc-lz4 store and an external observation from a zlib store written
    by ``data.cli select-dates``, against the same run from ``.nc`` files."""
    cfg_net = tiny_config(channels=C * WINDOW, window=WINDOW)
    _, params = jax_net_and_params(cfg_net, hw=HW)
    snap = write_snapshot(tmp_path, cfg_net, params)
    a = grid_arrays(seed=5)
    time = a["time"][:1] + np.arange(HOURS) * np.timedelta64(1, "h")
    rng = np.random.default_rng(5)
    walk = np.cumsum(rng.standard_normal((HOURS, HW, HW, C)), axis=0) / 3
    offsets = {"psl": 101000.0, "tas": 285.0, "uas": 0.0, "vas": 0.0}
    ds = GridDataset({v: (walk[..., i] * 4 + offsets[v]).astype(np.float32) for i, v in enumerate(VARS)},
                     {"time": time, "rlat": np.linspace(-2, 2, HW), "rlon": np.linspace(0, 4, HW)}, {})
    obs = ds.coarsen_mean(16).isel_time(np.arange(0, HOURS, 6))
    ds.to_file(str(tmp_path / "data.nc"))
    obs.to_file(str(tmp_path / "obs.nc"))
    compute_quantiles(ds).to_file(str(tmp_path / "q.nc"))
    zarr_store.write_zarr(ds, str(tmp_path / "data.zarr"), compressor="blosc-lz4")
    cli.main(["select-dates", "--in-path", str(tmp_path / "obs.nc"), "--out-path", str(tmp_path / "obs.zarr"),
              "--start", "2014-04-07-04", "--end", "2014-04-08-04"])
    runs = {}
    for kind, data, observation in (("nc", "data.nc", "obs.nc"), ("zarr", "data.zarr", "obs.zarr")):
        cfg = yaml.safe_load((REPO / "exp" / "configs" / "000_on-model-eval" / "s16_t6.yml").read_text())
        cfg.update(model_path=snap, data_path=str(tmp_path / data), quantile_path=str(tmp_path / "q.nc"),
                   observation_path=str(tmp_path / observation), num_hours=HOURS, num_samples=2,
                   batch_size=16, ensemble_batch=2, num_sampling_steps=2, num_corrections=0)
        path = tmp_path / f"{kind}.yml"
        path.write_text(yaml.safe_dump(cfg))
        runs[kind] = pathlib.Path(downscaling.run(str(tmp_path / f"out_{kind}"), str(path), "cpu"))
    for name in ("ground_truth.nc", "observation.nc", "gen_sample_000.nc", "gen_sample_001.nc"):
        _same_grid(open_grid(str(runs["zarr"] / name)), open_grid(str(runs["nc"] / name)))
    assert np.isfinite(open_grid(str(runs["zarr"] / "gen_sample_001.nc")).data_vars["tas"]).all()
