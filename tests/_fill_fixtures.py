"""Partly written grid files with a fill value, written with h5py.

A netCDF-4 variable that a writer extended without filling (a record
variable grown by another variable, an interrupted write) keeps chunks that
were never allocated and, for a contiguous variable, storage that was never
written. HDF5 returns the dataset's fill value there, and ``open_grid``
masks ``_FillValue`` to NaN. ``write_partly_written(path, libver, data)``
writes such a file: ``time`` (hours, CF ``units``), ``rlat``, ``rlon`` and
four [time, rlat, rlon] float32 variables, each with the fill value and
``_FillValue`` 9.96921e36 (netCDF-C's default for float):

- ``psl``: chunked (4, rlat, rlon) along an unlimited time axis, frames
  0-3 written (``libver='latest'``: an extensible-array index;
  ``'earliest'``: a version-1 B-tree);
- ``tas``: chunked (4, rlat, rlon) on fixed axes, frames 4-7 written (a
  fixed-array index, or a version-1 B-tree);
- ``uas``: chunked, every frame written;
- ``vas``: contiguous and never written.

Run as a script to rewrite the committed fixtures under ``tests/fixtures/``
(``fill_{latest,earliest}.nc`` and ``fill_contents.npz``, h5py's reading of
every dataset, keyed ``<libver>/<dataset>``): ``python tests/_fill_fixtures.py``.
"""

from __future__ import annotations

import pathlib

import h5py
import numpy as np

FILL = np.float32(9.96921e36)
HOURS, NLAT, NLON = 12, 8, 10
LIBVERS = ("latest", "earliest")
VARS = ("psl", "tas", "uas", "vas")
WRITTEN = {"psl": slice(0, 4), "tas": slice(4, 8), "uas": slice(0, HOURS), "vas": slice(0, 0)}
FIXTURES = pathlib.Path(__file__).resolve().parent / "fixtures"


def fixture_path(libver: str) -> pathlib.Path:
    return FIXTURES / f"fill_{libver}.nc"


def contents(seed: int = 0) -> dict:
    """The values each variable would hold if it were whole, and the
    coordinates."""
    rng = np.random.default_rng(seed)
    out = {v: (mean + std * rng.standard_normal((HOURS, NLAT, NLON))).astype(np.float32)
           for v, mean, std in zip(VARS, (101325.0, 285.0, 0.0, 0.0), (800.0, 5.0, 3.5, 3.5))}
    out["time"] = np.arange(HOURS, dtype=np.float64)
    out["rlat"] = np.linspace(-2.0, 2.0, NLAT)
    out["rlon"] = np.linspace(-3.0, 3.0, NLON)
    return out


def write_partly_written(path, libver: str, data: dict) -> None:
    """Write ``data`` (of :func:`contents`) with only the frames of
    ``WRITTEN`` stored."""
    with h5py.File(path, "w", libver=libver) as f:
        t = f.create_dataset("time", data=data["time"])
        t.attrs["units"] = "hours since 2014-04-07 04:00:00"
        f.create_dataset("rlat", data=data["rlat"])
        f.create_dataset("rlon", data=data["rlon"])
        layouts = {"psl": dict(maxshape=(None, NLAT, NLON), chunks=(4, NLAT, NLON)),
                   "tas": dict(chunks=(4, NLAT, NLON)), "uas": dict(chunks=(4, NLAT, NLON)), "vas": dict()}
        for v in VARS:
            d = f.create_dataset(v, shape=(HOURS, NLAT, NLON), dtype=np.float32, fillvalue=FILL, **layouts[v])
            d.attrs["_FillValue"] = FILL
            if WRITTEN[v].stop > WRITTEN[v].start:
                d[WRITTEN[v]] = data[v][WRITTEN[v]]


def read_all(path) -> dict:
    """Every dataset of ``path`` as h5py reads it."""
    with h5py.File(path, "r") as f:
        return {k: f[k][()] for k in f.keys()}


def main() -> None:
    data = contents()
    goldens = {}
    for libver in LIBVERS:
        write_partly_written(fixture_path(libver), libver, data)
        goldens.update({f"{libver}/{k}": v for k, v in read_all(fixture_path(libver)).items()})
    np.savez_compressed(FIXTURES / "fill_contents.npz", **goldens)
    for p in sorted(FIXTURES.glob("fill_*")):
        print(p.name, p.stat().st_size)


if __name__ == "__main__":
    main()
