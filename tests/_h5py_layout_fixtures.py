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

The last structures the port came to read (``STORAGE_KINDS``), one file
each, written in ``libver='latest'``:

- ``szip``: the szip filter (``SZIP_CASES``) over float32 and float64 of
  either byte order, int8/16/32/64 and uint8/16, ``nn`` and ``ec``, 8, 16
  and 32 pixels a block, 1-, 2- and 3-D with edge chunks, and after
  shuffle, on smooth fields (:func:`szip_field`) whose every chunk HDF5
  keeps filtered (filter mask 0: szip is optional, and HDF5 stores a chunk
  it cannot shrink raw);
- ``external``: external raw storage in ``h5py_external_{a,b}.raw``, one
  segment and several across both files (the last unlimited), named
  relative to the file: HDF5 finds them under ``HDF5_EXTFILE_PREFIX`` set
  to ``${ORIGIN}`` (the file's directory), else from the working directory;
- ``multiyear``: virtual datasets over the yearly files
  ``h5py_multiyear_<b>.h5`` (b = 0, 1, 2 and 4; each ``x`` [4, 4, 6, 6],
  unlimited along time): ``x`` maps block b of an unlimited count to
  ``h5py_multiyear_%b.h5`` (the first missing year, 3, ends it: HDF5's
  default printf gap is 0); ``growing`` maps year 0, then year 4 by an
  unlimited selection of its source two years on, the year between held
  by no file (the fill value, NaN);
- ``bitfields``: bitfield datasets of 1, 2, 4 and 8 bytes in either byte
  order, chunked and deflated, and a bitfield attribute.

``write_source(directory, libver)`` writes ``h5py_source.h5`` beside them,
the external links' target and the virtual dataset's source;
``write_small_addresses(path)`` a file of 4-byte addresses.
``write_observation(path)`` writes phase 6's observation of chip_smoke
(``coarse_observation(predict_grid())``) as ``GridDataset.to_file`` lays it
out, in ``libver='latest'``: every variable chunked (3, 4, 4) under a
maximum shape unlimited on all axes (a version-2 B-tree index) with
shuffle, lzf and fletcher32, the coordinates compact.
``write_codec_rate_frame(path)`` writes ``codec_rate_frame.h5``: one
[1, 4, 32, 32] frame of a training file (phase 6's grid at 32 x 32,
normalized) as one szip ``('nn', 32)`` chunk and one shuffle + lzf chunk,
from which
``chip_smoke.codec_rates`` tiles a year's chunk; the szip dataset's
``pad_bits`` attribute gives the bits that end its stream's last byte.
``write_observation_szip(path)`` writes it again as ``observation_szip.nc``:
psl and tas szip ``('nn', 8)`` on chunks (3, 4, 4), uas and vas szip
``('nn', 32)`` on one chunk (9, 8, 8) (winds change sign: under smaller
blocks HDF5 stores their chunks raw), each over a version-2 B-tree index,
the coordinates in external raw storage in ``observation_szip.raw`` beside
it, named relative (read with ``HDF5_EXTFILE_PREFIX=${ORIGIN}``).

Run as a script to rewrite the committed fixtures under ``tests/fixtures/``
(``h5py_<kind>.h5`` and the files beside them, ``observation_latest.nc``,
``observation_szip.nc`` and ``.raw``, ``codec_rate_frame.h5`` and
``h5py_layouts_contents.npz``,
h5py's reading of every dataset keyed ``<kind>/<path>``, of every selection
keyed ``selections/<label>``): ``python tests/_h5py_layout_fixtures.py``.
"""

from __future__ import annotations

import json
import os
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
OBSERVATION_SZIP = "observation_szip.nc"
CODEC_RATE_FRAME = "codec_rate_frame.h5"
STORAGE_KINDS = ("szip", "external", "multiyear", "bitfields")
EXTERNAL_RAW = ("h5py_external_a.raw", "h5py_external_b.raw")
YEAR = "h5py_multiyear_{}.h5"
YEARS = (0, 1, 2, 4)  # year 3 is missing
YEAR_SHAPE = (4, 4, 6, 6)  # [hours, variables, H, W] of a year
# (name, dtype, szip options, shape, chunks, shuffle first)
SZIP_CASES = (
    ("f4_nn8", "<f4", ("nn", 8), (5, 8, 29), (2, 8, 29), False),
    ("f4be_ec16", ">f4", ("ec", 16), (5, 8, 29), (2, 8, 29), False),
    ("f8_nn32", "<f8", ("nn", 32), (5, 8, 29), (2, 8, 29), False),
    ("f8be_ec8", ">f8", ("ec", 8), (20, 30), (8, 30), False),
    ("i1_nn16", "i1", ("nn", 16), (25, 37), (10, 37), False),
    ("u1_ec8", "u1", ("ec", 8), (25, 37), (10, 37), False),
    ("u1_nn8", "u1", ("nn", 8), (300,), (128,), False),
    ("i2_ec16", "<i2", ("ec", 16), (20, 40), (8, 40), False),
    ("i2be_nn32", ">i2", ("nn", 32), (20, 40), (8, 40), False),
    ("u2_nn8", "<u2", ("nn", 8), (300,), (128,), False),
    ("u2be_ec32", ">u2", ("ec", 32), (6, 10, 12), (4, 10, 12), False),
    ("i4_nn8", "<i4", ("nn", 8), (20, 29), (8, 29), False),
    ("i4be_ec16", ">i4", ("ec", 16), (20, 29), (8, 29), False),
    ("i8_nn16", "<i8", ("nn", 16), (300,), (128,), False),
    ("f4_shuffle_nn8", "<f4", ("nn", 8), (5, 8, 29), (2, 8, 29), True),
    ("i2_shuffle_nn16", "<i2", ("nn", 16), (20, 40), (8, 40), True),
)
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


def szip_field(rng, shape, dtype) -> np.ndarray:
    """A smooth field (a cumulative sum along every axis) in ``dtype``, a
    flat patch at its start: floats in [-10, 30] on multiples of 1/64 (as
    packed data are), integers on up to 2^10 steps from a little below 0."""
    x = rng.standard_normal(shape)
    for axis in range(len(shape)):
        x = np.cumsum(x, axis=axis)
    x = (x - x.min()) / max(np.ptp(x), 1e-9)
    dt = np.dtype(dtype)
    if dt.kind == "f":
        x = np.round((x * 40 - 10) * 64) / 64
    else:
        span = min(2 ** (8 * dt.itemsize - 3), 2 ** 10)
        x = np.round(x * span) - (0 if dt.kind == "u" else span // 16)
    flat = tuple(slice(0, max(1, n // 3)) for n in shape)
    x[flat] = x[flat].flat[0]
    return x.astype(dtype)


def chunk_masks(dataset) -> list:
    """The filter mask of every chunk h5py's ``dataset`` stores (bit i set:
    filter i was skipped for that chunk)."""
    return [dataset.id.get_chunk_info(i).filter_mask for i in range(dataset.id.get_num_chunks())]


def write_szip(path, libver: str = "latest") -> None:
    rng = np.random.default_rng(21)
    with h5py.File(path, "w", libver=libver) as f:
        for name, dtype, opts, shape, chunks, shuffle in SZIP_CASES:
            f.create_dataset(name, data=szip_field(rng, shape, dtype), chunks=chunks, compression="szip",
                             compression_opts=opts, shuffle=shuffle)


def write_external(path, libver: str = "latest") -> None:
    """Datasets in raw files beside ``path``, named relative (see the
    module's docstring); the raw files' other bytes are a fill pattern."""
    directory = pathlib.Path(path).parent
    a, b = (directory / name for name in EXTERNAL_RAW)
    a.write_bytes(b"\xa5" * 64)
    b.write_bytes(b"\x5a" * 24)
    rng = np.random.default_rng(22)
    with h5py.File(path, "w", libver=libver) as f:
        kw = {"efile_prefix": "${ORIGIN}"}  # where h5py writes them
        f.create_dataset("one", data=rng.standard_normal((6, 7)).astype("<f4"), external=[(a.name, 64, 168)], **kw)
        f.create_dataset("several", data=np.arange(45, dtype=">i2").reshape(5, 9) * 7 - 100,
                         external=[(a.name, 300, 30), (b.name, 24, 40), (b.name, 100, h5py.h5f.UNLIMITED)], **kw)
        f.create_dataset("scalar", data=np.float64(2.5), external=[(b.name, 8, 8)], **kw)


def write_multiyear(path, libver: str = "latest") -> None:
    """The yearly files beside ``path`` and its virtual datasets (see the
    module's docstring)."""
    directory = pathlib.Path(path).parent
    for year in YEARS:
        with h5py.File(directory / YEAR.format(year), "w", libver=libver) as f:
            x = (year + 1) * 100 + np.arange(np.prod(YEAR_SHAPE)).reshape(YEAR_SHAPE) / 8
            f.create_dataset("x", data=x.astype(np.float32), maxshape=(None,) + YEAR_SHAPE[1:],
                             chunks=(2,) + YEAR_SHAPE[1:])
    t, rest, unlimited = YEAR_SHAPE[0], YEAR_SHAPE[1:], h5py.h5s.UNLIMITED
    with h5py.File(path, "w", libver=libver) as f:
        def create(name, shape, mappings):
            dcpl = h5py.h5p.create(h5py.h5p.DATASET_CREATE)
            dcpl.set_fill_value(np.array(np.nan, np.float32))
            for source, vsel, sspace in mappings:
                vspace = h5py.h5s.create_simple(shape, (unlimited,) + rest)
                vspace.select_hyperslab(*vsel)
                dcpl.set_virtual(vspace, source.encode(), b"x", sspace)
            h5py.h5d.create(f.id, name.encode(), h5py.h5t.IEEE_F32LE,
                            h5py.h5s.create_simple(shape, (unlimited,) + rest), dcpl=dcpl)

        zero = (0,) * len(rest)
        printf = ((0,) + zero, (unlimited,) + (1,) * len(rest), (t,) + (1,) * len(rest), (t,) + rest)
        create("x", (t,) + rest, [(YEAR.format("%b"), printf, h5py.h5s.create_simple(YEAR_SHAPE))])
        ongoing = h5py.h5s.create_simple(YEAR_SHAPE, (unlimited,) + rest)
        ongoing.select_hyperslab((0,) + zero, (1,) * len(YEAR_SHAPE), block=(unlimited,) + rest)
        create("growing", (t,) + rest, [
            (YEAR.format(0), ((0,) + zero, (1,) * len(YEAR_SHAPE), None, YEAR_SHAPE),
             h5py.h5s.create_simple(YEAR_SHAPE)),
            (YEAR.format(4), ((2 * t,) + zero, (1,) * len(YEAR_SHAPE), None, (unlimited,) + rest), ongoing)])


def write_bitfields(path, libver: str = "latest") -> None:
    rng = np.random.default_rng(23)
    with h5py.File(path, "w", libver=libver) as f:
        for name, tid, values in (("b8", h5py.h5t.STD_B8LE, rng.integers(0, 256, 7).astype("u1")),
                                  ("b16be", h5py.h5t.STD_B16BE, rng.integers(0, 2**16, (3, 4)).astype(">u2")),
                                  ("b32", h5py.h5t.STD_B32LE, rng.integers(0, 2**32, 5).astype("<u4")),
                                  ("b64be", h5py.h5t.STD_B64BE, rng.integers(0, 2**63, 4).astype(">u8"))):
            h5py.h5d.create(f.id, name.encode(), tid, h5py.h5s.create_simple(values.shape)).write(
                h5py.h5s.ALL, h5py.h5s.ALL, values)
        dcpl = h5py.h5p.create(h5py.h5p.DATASET_CREATE)
        dcpl.set_chunk((4, 3))
        dcpl.set_deflate(4)
        h5py.h5d.create(f.id, b"b16_chunked", h5py.h5t.STD_B16LE, h5py.h5s.create_simple((10, 6)), dcpl=dcpl).write(
            h5py.h5s.ALL, h5py.h5s.ALL, np.arange(60, dtype="<u2").reshape(10, 6) * 1000)
        attr = h5py.h5a.create(f["b8"].id, b"flags", h5py.h5t.STD_B16LE, h5py.h5s.create_simple((2,)))
        attr.write(np.array([5, 40000], "<u2"))


STORAGE_WRITERS = {"szip": write_szip, "external": write_external, "multiyear": write_multiyear,
                   "bitfields": write_bitfields}


def open_with_extfile_origin(f, name: str):
    """h5py's dataset ``name`` of ``f`` opened with the external file prefix
    ``${ORIGIN}`` (what ``HDF5_EXTFILE_PREFIX=${ORIGIN}`` gives; the
    variable is read when HDF5 starts, so a process sets it before)."""
    dapl = h5py.h5p.create(h5py.h5p.DATASET_ACCESS)
    dapl.set_efile_prefix(b"${ORIGIN}")
    return h5py.Dataset(h5py.h5d.open(f.id, name.encode(), dapl))


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


def write_observation_szip(path) -> None:
    """Phase 6's observation in szip and external raw storage (see the
    module's docstring)."""
    path = pathlib.Path(path)
    raw = path.with_suffix(".raw")
    obs = chip_smoke.coarse_observation(chip_smoke.predict_grid())
    epoch = obs.time[0].astype("datetime64[s]").item()
    coords = {"time": ((obs.time - obs.time[0]) / np.timedelta64(1, "h")).astype("<f8"),
              "rlat": np.asarray(obs.rlat, "<f8"), "rlon": np.asarray(obs.rlon, "<f8")}
    raw.write_bytes(b"".join(v.tobytes() for v in coords.values()))
    with h5py.File(path, "w", libver="latest") as f:
        at = 0
        for name, values in coords.items():
            f.create_dataset(name, shape=values.shape, dtype="<f8", external=[(raw.name, at, values.nbytes)])
            at += values.nbytes
        f["time"].attrs["units"] = f"hours since {epoch.strftime('%Y-%m-%d %H:%M:%S')}"
        f["time"].attrs["standard_name"] = "time"
        for k, v in obs.data_vars.items():
            chunks, opts = ((3, 4, 4), ("nn", 8)) if k in ("psl", "tas") else ((9, 8, 8), ("nn", 32))
            f.create_dataset(k, data=v, chunks=chunks, maxshape=(None, None, None), compression="szip",
                             compression_opts=opts)
            f[k].attrs["dims"] = ["time", "rlat", "rlon"]
        f.attrs["grid_attrs"] = json.dumps(obs.attrs)
    assert raw.read_bytes() == b"".join(v.tobytes() for v in coords.values())  # h5py left them as written
    with h5py.File(path, "r") as f:
        assert all(mask == 0 for k in obs.data_vars for mask in chunk_masks(f[k]))


def write_codec_rate_frame(path) -> None:
    """The frames of ``chip_smoke.codec_rates`` (see the module's
    docstring); the pad bits are those with which two tiled copies decode
    as h5py decodes them."""
    import tempfile

    from climate2weather_tpu_torch.data.pipeline import compute_quantiles, merged_to_normed_h5

    with tempfile.TemporaryDirectory() as tmp:
        grid = chip_smoke.predict_grid(res=32, hours=24)
        grid.to_file(f"{tmp}/g.nc")
        compute_quantiles(grid).to_file(f"{tmp}/q.nc")
        merged_to_normed_h5(f"{tmp}/g.nc", f"{tmp}/q.nc", f"{tmp}/t.h5")
        with h5py.File(f"{tmp}/t.h5", "r") as t:
            frame = t["x"][:1]
        with h5py.File(path, "w", libver="latest") as f:
            f.create_dataset("szip", data=frame, chunks=frame.shape, compression="szip", compression_opts=("nn", 32))
            f.create_dataset("lzf", data=frame, chunks=frame.shape, compression="lzf", shuffle=True)
            assert chunk_masks(f["szip"]) == chunk_masks(f["lzf"]) == [0]
            stream = f["szip"].id.read_direct_chunk((0,) * 4)[1]
        for pad in range(8):
            tiled = chip_smoke.tiled_szip(stream, 2, pad)
            probe = f"{tmp}/probe.h5"
            with h5py.File(probe, "w") as p:
                shape = (2,) + frame.shape[1:]
                d = p.create_dataset("x", shape=shape, dtype=frame.dtype, chunks=shape, compression="szip",
                                     compression_opts=("nn", 32))
                d.id.write_direct_chunk((0,) * 4, tiled)
            try:
                with h5py.File(probe, "r") as p:
                    got = p["x"][()]
            except OSError:
                continue
            if got.tobytes() == chip_smoke.tiled_szip_bytes(frame.tobytes(), 2, 4):
                with h5py.File(path, "a") as f:
                    f["szip"].attrs["pad_bits"] = pad
                return
    raise AssertionError("no pad of the szip stream tiles as h5py decodes it")


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
    for kind in STORAGE_KINDS:
        with h5py.File(directory / fixture_path(kind).name, "r") as f:
            for name in f:
                ds = open_with_extfile_origin(f, name) if kind == "external" else f[name]
                out[f"{kind}/{name}"] = canonical(ds[()])
    return out


def write_all(directory) -> dict:
    """Every fixture, and h5py's reading of them, into ``directory``."""
    directory = pathlib.Path(directory)
    write_source(directory)
    for kind in KINDS:
        WRITERS[kind](directory / fixture_path(kind).name, LIBVERS[kind])
    for kind in STORAGE_KINDS:
        STORAGE_WRITERS[kind](directory / fixture_path(kind).name)
    write_observation(directory / OBSERVATION)
    write_observation_szip(directory / OBSERVATION_SZIP)
    write_codec_rate_frame(directory / CODEC_RATE_FRAME)
    return read_contents(directory)


if __name__ == "__main__":
    os.environ.pop("HDF5_EXTFILE_PREFIX", None)
    np.savez_compressed(FIXTURES / "h5py_layouts_contents.npz", **write_all(FIXTURES))
    for p in sorted(FIXTURES.glob("h5py_*")) + [FIXTURES / n for n in (OBSERVATION, OBSERVATION_SZIP,
                                                                       CODEC_RATE_FRAME)]:
        print(p.name, p.stat().st_size)
