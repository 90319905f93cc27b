"""HDF5 structures that h5py writes and ``io/hdf5.py`` reads, written with h5py.

One writer per kind of structure, each ``write_<kind>(path, libver)``:

- ``links``: soft links (absolute, relative, to a group, through a group,
  dangling), external links to a neighbouring file named bare (to a
  dataset, to a group, to a missing file, to a missing object); with
  ``libver='earliest'`` the groups are symbol tables, soft links entries
  of cache type 2; ``write_user_defined_link(path)`` writes a file beside
  them with a user-defined link (an external link message whose type byte
  is set to 65, its object header checksum made anew; h5py's listing of
  such a group crashes, so it is no committed fixture);
- ``chunk_indexes``: the implicit index (early allocation, no filter), the
  version-2 B-tree (two or more unlimited axes; filtered and not) and the
  extensible array over one unlimited axis that is not the first;
- ``layouts``: compact datasets, and a virtual dataset mapping a regular
  hyperslab of this file (``"."``), all of the neighbouring file's dataset,
  a strided column, an irregular hyperslab of two blocks and a missing
  file, its other elements the fill value;
- ``filters``: fletcher32 (with shuffle and deflate, and alone), lzf (with
  shuffle, and on noise that lzf cannot shrink), n-bit on partial-precision
  integers of either byte order, scale-offset on integers (with a fill
  value, one of all equal values, one of full width) and floats (D-scale);
- ``datatypes``: enum, bool, array, compound (padded, mixed byte order,
  chunked), a committed datatype with a dataset and an attribute of it,
  compound, enum, array and bool attributes;
- ``selections``: a chunked and a contiguous dataset that chip_smoke's
  ``LAYOUT_SELECTIONS`` read.

``write_source(directory, libver)`` writes ``h5py_source.h5`` beside them,
the external links' target and the virtual dataset's source;
``write_small_addresses(path)`` a file of 4-byte addresses.
``write_observation(path)`` writes phase 6's observation of chip_smoke
(``coarse_observation(predict_grid())``) as ``GridDataset.to_file`` lays it
out, in ``libver='latest'``: every variable chunked (3, 4, 4) under a
maximum shape unlimited on all axes (a version-2 B-tree index) with
shuffle, lzf and fletcher32, the coordinates compact.

Run as a script to rewrite the committed fixtures under ``tests/fixtures/``
(``h5py_<kind>.h5``, ``h5py_source.h5``, ``observation_latest.nc`` and
``h5py_layouts_contents.npz``, h5py's reading of every dataset keyed
``<kind>/<path>``, of every selection keyed ``selections/<label>``):
``python tests/_h5py_layout_fixtures.py``.
"""

from __future__ import annotations

import json
import pathlib
import sys

import h5py
import numpy as np

REPO = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
import chip_smoke  # noqa: E402
from climate2weather_tpu_torch.io import hdf5  # noqa: E402

FIXTURES = REPO / "tests" / "fixtures"
KINDS = ("links", "chunk_indexes", "layouts", "filters", "datatypes", "selections")
SOURCE = "h5py_source.h5"
OBSERVATION = "observation_latest.nc"
LIBVERS = {"links": "earliest", "chunk_indexes": "latest", "layouts": "latest", "filters": "earliest",
           "datatypes": "latest", "selections": "latest"}  # the committed fixtures' low bounds
DANGLING = chip_smoke.LAYOUT_DANGLING  # the links fixture's links that resolve to nothing
USER_DEFINED = "u"
ENUM = h5py.enum_dtype({"CALM": 0, "BREEZE": 1, "GALE": 7}, basetype="i2")
COMPOUND = np.dtype({"names": ["n", "v", "tag"], "formats": ["<i4", ">f8", "S3"], "offsets": [0, 8, 16],
                     "itemsize": 24})


def fixture_path(kind: str) -> pathlib.Path:
    return FIXTURES / f"h5py_{kind}.h5"


def _field(rng, shape, dtype=np.float32) -> np.ndarray:
    """A smooth random field (lzf and deflate find repeats in its bytes
    once shuffled)."""
    return np.cumsum(rng.standard_normal(shape), axis=0).astype(dtype)


def write_source(directory, libver: str = "latest") -> pathlib.Path:
    path = pathlib.Path(directory) / SOURCE
    with h5py.File(path, "w", libver=libver) as f:
        f.create_dataset("a", data=np.arange(30.0).reshape(6, 5))
        f.create_group("g").create_dataset("deep", data=np.arange(4, dtype=np.int16))
    return path


def _retype_link(path, name: str, ltype: int) -> None:
    """Set the type byte of the link message ``name`` (an external link,
    type 64) to ``ltype`` and make the checksum of the version-2 object
    header chunk holding it anew."""
    raw = bytearray(pathlib.Path(path).read_bytes())
    encoded = name.encode()
    at = next(i for i in range(len(raw)) if raw[i] == 1 and raw[i + 1] & 0x08 and raw[i + 2] == 64
              and raw[i + 4:i + 4 + len(encoded)] == encoded and raw[i + 3] == len(encoded))
    raw[at + 2] = ltype
    head = raw.rfind(b"OHDR", 0, at)
    if head >= 0:
        flags = raw[head + 5]
        pos = 6 + (16 if flags & 0x20 else 0) + (4 if flags & 0x10 else 0)
        size_len = 1 << (flags & 3)
        end = head + pos + size_len + int.from_bytes(raw[head + pos:head + pos + size_len], "little")
        if head < at < end:
            raw[end:end + 4] = hdf5.lookup3(bytes(raw[head:end])).to_bytes(4, "little")
    pathlib.Path(path).write_bytes(bytes(raw))


def write_links(path, libver: str) -> None:
    with h5py.File(path, "w", libver=libver) as f:
        f.create_dataset("b", data=np.arange(12.0).reshape(3, 4))
        g = f.create_group("grp")
        g.create_dataset("y", data=np.arange(3, dtype=np.int32))
        g["rel"] = h5py.SoftLink("y")
        g["up"] = h5py.SoftLink("/b")
        f["s"] = h5py.SoftLink("/b")
        f["sg"] = h5py.SoftLink("/grp")
        f["d"] = h5py.SoftLink("/nothing")
        f["e"] = h5py.ExternalLink(SOURCE, "/a")
        f["eg"] = h5py.ExternalLink(SOURCE, "/g")
        f["de"] = h5py.ExternalLink("missing.h5", "/a")
        f["de2"] = h5py.ExternalLink(SOURCE, "/nothing")


def write_user_defined_link(path, libver: str = "latest") -> None:
    with h5py.File(path, "w", libver=libver) as f:
        f.create_dataset("x", data=np.arange(3.0))
        f[USER_DEFINED] = h5py.ExternalLink(SOURCE, "/a")
    _retype_link(path, USER_DEFINED, 65)


def write_small_addresses(path) -> None:
    """A file of 4-byte addresses and lengths (which the reader refuses)."""
    fcpl = h5py.h5p.create(h5py.h5p.FILE_CREATE)
    fcpl.set_sizes(4, 4)
    with h5py.File(h5py.h5f.create(str(path).encode(), h5py.h5f.ACC_TRUNC, fcpl=fcpl)) as f:
        f.create_dataset("x", data=np.arange(6.0).reshape(2, 3))


def write_chunk_indexes(path, libver: str = "latest") -> None:
    rng = np.random.default_rng(1)
    field = _field(rng, (10, 6, 7))
    with h5py.File(path, "w", libver=libver) as f:
        dcpl = h5py.h5p.create(h5py.h5p.DATASET_CREATE)
        dcpl.set_chunk((4, 3))
        dcpl.set_alloc_time(h5py.h5d.ALLOC_TIME_EARLY)
        h5py.h5d.create(f.id, b"implicit", h5py.h5t.NATIVE_DOUBLE, h5py.h5s.create_simple((10, 7)),
                        dcpl=dcpl).write(h5py.h5s.ALL, h5py.h5s.ALL, rng.standard_normal((10, 7)))
        f.create_dataset("btree2", data=field, maxshape=(None, None, None), chunks=(4, 3, 2))
        f.create_dataset("btree2_filtered", data=field, maxshape=(None, 6, None), chunks=(4, 3, 2),
                         compression="gzip", shuffle=True)
        d = f.create_dataset("btree2_partial", shape=(8, 8), maxshape=(None, None), chunks=(3, 3), dtype="i4")
        d[2:5, 4:8] = 9
        f.create_dataset("earray_axis2", data=field, maxshape=(10, 6, None), chunks=(3, 4, 2))
        f.create_dataset("earray_axis1", data=field.astype(">f8"), maxshape=(10, None, 7), chunks=(3, 4, 2),
                         compression="gzip")


def write_layouts(path, libver: str = "latest") -> None:
    rng = np.random.default_rng(2)
    with h5py.File(path, "w", libver=libver) as f:
        for name, value in (("compact", rng.standard_normal((3, 5))), ("compact_int", np.arange(7, dtype=">i2"))):
            dcpl = h5py.h5p.create(h5py.h5p.DATASET_CREATE)
            dcpl.set_layout(h5py.h5d.COMPACT)
            dtype = h5py.h5t.py_create(value.dtype)
            h5py.h5d.create(f.id, name.encode(), dtype, h5py.h5s.create_simple(value.shape),
                            dcpl=dcpl).write(h5py.h5s.ALL, h5py.h5s.ALL, value)
        f.create_dataset("b", data=np.arange(100.0, 140.0).reshape(5, 8))
        lay = h5py.VirtualLayout(shape=(12, 9), dtype="f8")
        lay[0:6, 0:5] = h5py.VirtualSource(SOURCE, "a", shape=(6, 5))
        lay[6:9, 1:9] = h5py.VirtualSource(".", "b", shape=(5, 8))[1:4, :]
        lay[0:12:2, 7] = h5py.VirtualSource(".", "b", shape=(5, 8))[0, 1:7]
        lay[11, 0:5] = h5py.VirtualSource("missing.h5", "a", shape=(5,))
        f.create_virtual_dataset("virtual", lay, fillvalue=-1.0)
        # an irregular hyperslab: two blocks of the virtual space from two rows of b
        dcpl = h5py.h5p.create(h5py.h5p.DATASET_CREATE)
        dcpl.set_fill_value(np.array(-2.0))
        vspace = h5py.h5s.create_simple((4, 6))
        vspace.select_hyperslab((0, 0), (1, 1), block=(2, 2))
        vspace.select_hyperslab((1, 3), (1, 1), block=(2, 3), op=h5py.h5s.SELECT_OR)
        sspace = h5py.h5s.create_simple((5, 8))
        sspace.select_hyperslab((3, 0), (1, 1), block=(1, 8))
        sspace.select_hyperslab((4, 0), (1, 1), block=(1, 2), op=h5py.h5s.SELECT_OR)
        dcpl.set_virtual(vspace, b".", b"b", sspace)
        h5py.h5d.create(f.id, b"virtual_irregular", h5py.h5t.NATIVE_DOUBLE, h5py.h5s.create_simple((4, 6)),
                        dcpl=dcpl)


def write_filters(path, libver: str) -> None:
    rng = np.random.default_rng(3)
    field = _field(rng, (12, 6, 7))
    with h5py.File(path, "w", libver=libver) as f:
        f.create_dataset("fletcher32", data=field, chunks=(4, 3, 7), fletcher32=True)
        f.create_dataset("fletcher32_deflate", data=field, chunks=(4, 6, 7), fletcher32=True, shuffle=True,
                         compression="gzip")
        f.create_dataset("lzf", data=field, chunks=(4, 6, 7), compression="lzf", shuffle=True)
        f.create_dataset("lzf_noise", data=rng.standard_normal((12, 6)), chunks=(4, 6), compression="lzf")
        f.create_dataset("scaleoffset_int", data=rng.integers(-500, 900, (12, 6)).astype(np.int32), chunks=(4, 6),
                         scaleoffset=0)
        f.create_dataset("scaleoffset_int16_be", data=rng.integers(0, 900, (12, 6)).astype(">i2"), chunks=(4, 6),
                         scaleoffset=0)
        f.create_dataset("scaleoffset_full_width", data=rng.integers(-2**62, 2**62, 12), chunks=(4,), scaleoffset=0)
        f.create_dataset("scaleoffset_equal", data=np.full(8, 7, np.int32), chunks=(4,), scaleoffset=0)
        f.create_dataset("scaleoffset_fill", data=np.arange(-3, 13, dtype=np.int32), chunks=(4,), scaleoffset=0,
                         fillvalue=5)
        f.create_dataset("scaleoffset_float", data=field, chunks=(4, 6, 7), scaleoffset=3)
        f.create_dataset("scaleoffset_double", data=100 * field.astype(np.float64), chunks=(4, 6, 7), scaleoffset=2)
        f.create_dataset("scaleoffset_float_fill", data=np.linspace(-3, 3, 16, dtype=np.float32), chunks=(4,),
                         scaleoffset=2, fillvalue=1.5)
        for name, base, precision, offset, values in (
                ("nbit_int", h5py.h5t.STD_I32LE, 12, 4, rng.integers(-2000, 2000, 20).astype(np.int32)),
                ("nbit_uint16_be", h5py.h5t.STD_U16BE, 9, 3, rng.integers(0, 500, 20).astype(np.uint16)),
                ("nbit_full", h5py.h5t.IEEE_F32LE, None, None, rng.standard_normal(20).astype(np.float32))):
            dtype = base.copy()
            if precision:
                dtype.set_precision(precision)
                dtype.set_offset(offset)
            dcpl = h5py.h5p.create(h5py.h5p.DATASET_CREATE)
            dcpl.set_chunk((6,))
            dcpl.set_filter(h5py.h5z.FILTER_NBIT, 0)
            h5py.h5d.create(f.id, name.encode(), dtype, h5py.h5s.create_simple((20,)),
                            dcpl=dcpl).write(h5py.h5s.ALL, h5py.h5s.ALL, values)


def write_datatypes(path, libver: str) -> None:
    rng = np.random.default_rng(4)
    records = np.zeros(5, COMPOUND)
    records["n"], records["v"], records["tag"] = np.arange(5), np.linspace(0, 1, 5), b"ab"
    with h5py.File(path, "w", libver=libver) as f:
        f.create_dataset("enum", data=np.array([0, 1, 7, 1], "i2"), dtype=ENUM)
        f.create_dataset("bool", data=np.array([True, False, True]))
        d = f.create_dataset("array", shape=(4,), dtype=np.dtype(("<f4", (2, 3))))
        d[...] = rng.standard_normal((4, 2, 3)).astype(np.float32)
        d = f.create_dataset("array_chunked", shape=(6,), dtype=np.dtype((">i4", (3,))), chunks=(2,))
        d[...] = np.arange(18, dtype=">i4").reshape(6, 3)
        f.create_dataset("compound", data=records)
        f.create_dataset("compound_chunked", data=records, chunks=(2,), compression="gzip")
        f["named"] = np.dtype("<f8")
        f.create_dataset("of_named", data=np.arange(5.0), dtype=f["named"])
        f["of_named"].attrs.create("named_attr", data=np.ones(2), dtype=f["named"])
        f["of_named"].attrs["compound_attr"] = records[:2]
        f["of_named"].attrs["enum_attr"] = np.array([1, 7], "i2").astype(ENUM)
        f["of_named"].attrs["bool_attr"] = True


def write_selections(path, libver: str = "latest") -> None:
    rng = np.random.default_rng(5)
    with h5py.File(path, "w", libver=libver) as f:
        f.create_dataset("chunked", data=rng.standard_normal((9, 6, 5)).astype(np.float32), chunks=(2, 4, 5))
        f.create_dataset("contiguous", data=np.arange(54, dtype=np.int16).reshape(9, 6))


WRITERS = {"links": write_links, "chunk_indexes": write_chunk_indexes, "layouts": write_layouts,
           "filters": write_filters, "datatypes": write_datatypes, "selections": write_selections}


def write_observation(path) -> None:
    """Phase 6's observation in the structures above (see the module's
    docstring)."""
    obs = chip_smoke.coarse_observation(chip_smoke.predict_grid())
    epoch = obs.time[0].astype("datetime64[s]").item()
    hours = ((obs.time - obs.time[0]) / np.timedelta64(1, "h")).astype(np.float64)
    with h5py.File(path, "w", libver="latest") as f:
        for name, values in (("time", hours), ("rlat", obs.rlat), ("rlon", obs.rlon)):
            dcpl = h5py.h5p.create(h5py.h5p.DATASET_CREATE)
            dcpl.set_layout(h5py.h5d.COMPACT)
            h5py.h5d.create(f.id, name.encode(), h5py.h5t.IEEE_F64LE, h5py.h5s.create_simple(values.shape),
                            dcpl=dcpl).write(h5py.h5s.ALL, h5py.h5s.ALL, np.asarray(values, np.float64))
        f["time"].attrs["units"] = f"hours since {epoch.strftime('%Y-%m-%d %H:%M:%S')}"
        f["time"].attrs["standard_name"] = "time"
        for k, v in obs.data_vars.items():
            f.create_dataset(k, data=v, chunks=(3, 4, 4), maxshape=(None, None, None), shuffle=True,
                             compression="lzf", fletcher32=True)
            f[k].attrs["dims"] = ["time", "rlat", "rlon"]
        f.attrs["grid_attrs"] = json.dumps(obs.attrs)


def _copy_attrs(src, dst) -> None:
    for k, v in src.attrs.items():
        if isinstance(v, np.ndarray) and v.dtype == object:
            dst.attrs.create(k, v, dtype=h5py.string_dtype())
        else:
            dst.attrs[k] = v


def _new_layout_dataset(f, name: str, data: np.ndarray) -> None:
    """``data`` as ``name``: compact where it is 1-D, else chunked under a
    maximum shape unlimited on all axes (a version-2 B-tree index) with
    shuffle, lzf and fletcher32."""
    if data.ndim == 1:
        dcpl = h5py.h5p.create(h5py.h5p.DATASET_CREATE)
        dcpl.set_layout(h5py.h5d.COMPACT)
        h5py.h5d.create(f.id, name.encode(), h5py.h5t.py_create(data.dtype), h5py.h5s.create_simple(data.shape),
                        dcpl=dcpl).write(h5py.h5s.ALL, h5py.h5s.ALL, np.ascontiguousarray(data))
        return
    chunks = (min(3, data.shape[0]),) + tuple(min(16, n) for n in data.shape[1:])
    f.create_dataset(name, data=data, chunks=chunks, maxshape=(None,) * data.ndim, shuffle=True,
                     compression="lzf", fletcher32=True)


def rewrite_in_new_layouts(src, dst, split: str = "") -> None:
    """Copy the flat HDF5 file ``src`` (as h5py reads it) to ``dst`` in
    ``libver='latest'`` and the structures of :func:`_new_layout_dataset`,
    attributes included; the dataset ``split`` becomes a virtual dataset
    concatenating its two halves along the first axis, each a file beside
    ``dst`` named bare, as files of several years are concatenated."""
    dst = pathlib.Path(dst)
    with h5py.File(src, "r") as h, h5py.File(dst, "w", libver="latest") as f:
        _copy_attrs(h, f)
        for name, ds in h.items():
            data = ds[()]
            if name == split:
                half = data.shape[0] // 2
                lay = h5py.VirtualLayout(shape=data.shape, dtype=data.dtype)
                for i, part in enumerate((data[:half], data[half:])):
                    part_name = f"{dst.stem}_{name}_part{i}.h5"
                    with h5py.File(dst.parent / part_name, "w", libver="latest") as p:
                        _new_layout_dataset(p, name, part)
                    lay[i * half:i * half + len(part)] = h5py.VirtualSource(part_name, name, shape=part.shape)
                f.create_virtual_dataset(name, lay)
            else:
                _new_layout_dataset(f, name, data)
            _copy_attrs(ds, f[name])


def canonical(value: np.ndarray) -> np.ndarray:
    """h5py's reading in a form its bytes can be compared in: the bytes
    between a compound's members zeroed (h5py leaves whatever its buffer
    held there), an enum's names dropped from its dtype (.npz keeps none)."""
    value = np.asarray(value)
    if value.dtype.names:
        out = np.zeros(value.shape, np.dtype({"names": list(value.dtype.names), "itemsize": value.dtype.itemsize,
                                              "formats": [np.dtype(value.dtype.fields[n][0].str)
                                                          if not value.dtype.fields[n][0].subdtype
                                                          else value.dtype.fields[n][0]
                                                          for n in value.dtype.names],
                                              "offsets": [value.dtype.fields[n][1] for n in value.dtype.names]}))
        for n in value.dtype.names:
            out[n] = value[n]
        return out
    return value.view(value.dtype.str) if value.dtype.metadata else value


def read_contents(directory) -> dict:
    """h5py's reading of every dataset of the fixtures in ``directory``,
    links followed ("<kind>/<path>"), and of every selection of chip_smoke's
    ``LAYOUT_SELECTIONS`` ("selections/<label>")."""
    directory = pathlib.Path(directory)
    out = {}
    for kind in KINDS:
        with h5py.File(directory / fixture_path(kind).name, "r") as f:
            def visit(group, prefix):
                for name in group:
                    if prefix + name in DANGLING:
                        continue
                    child = group[name]
                    if isinstance(child, h5py.Group):
                        visit(child, f"{prefix}{name}/")
                    elif isinstance(child, h5py.Dataset):
                        out[f"{kind}/{prefix}{name}"] = canonical(child[()])
            visit(f, "")
            if kind == "selections":
                for label, (name, key) in chip_smoke.LAYOUT_SELECTIONS.items():
                    out[f"selections/{label}"] = canonical(f[name][key])
    return out


def write_all(directory) -> dict:
    """Every fixture, and h5py's reading of them, into ``directory``."""
    directory = pathlib.Path(directory)
    write_source(directory)
    for kind in KINDS:
        WRITERS[kind](directory / fixture_path(kind).name, LIBVERS[kind])
    write_observation(directory / OBSERVATION)
    return read_contents(directory)


if __name__ == "__main__":
    np.savez(FIXTURES / "h5py_layouts_contents.npz", **write_all(FIXTURES))
    for p in sorted(FIXTURES.glob("h5py_*")) + [FIXTURES / OBSERVATION]:
        print(p.name, p.stat().st_size)
