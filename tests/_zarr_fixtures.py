"""Zarr-v2 stores written by the JAX package, the standard the port's store
is held to.

``write_jax_store(path, compressor, ds)`` writes ``ds`` with the JAX
package's ``write_zarr``: ``"zlib"`` and ``"blosc-lz4"`` as that function
writes them, ``"none"`` with every data variable rewritten uncompressed by
its ``_write_array(..., compress=False)``. The grid of :func:`grid` spans
two day-sized time chunks (24 + 6 hours, the second padded). The
uncompressed store loses one chunk (``tas/1.0.0``), which a reader takes as
the fill value (``null``: 0).

Run as a script to rewrite the committed fixtures under ``tests/fixtures/``
(``jax_{zlib,blosc-lz4,none}.zarr`` and ``zarr_contents.npz``, the grid's
arrays, keyed by variable, and the JAX package's reading of each store,
keyed ``<compressor>/<variable>``): ``python tests/_zarr_fixtures.py``.
"""

from __future__ import annotations

import os
import pathlib
import shutil

import numpy as np

COMPRESSORS = ("zlib", "blosc-lz4", "none")
VARS = ("psl", "tas", "uas", "vas")
HOURS, NLAT, NLON = 30, 12, 16
MISSING = {"none": "tas/1.0.0"}  # the chunk file a store lacks
FIXTURES = pathlib.Path(__file__).resolve().parent / "fixtures"


def store_path(compressor: str) -> pathlib.Path:
    return FIXTURES / f"jax_{compressor}.zarr"


def grid_arrays(seed: int = 0) -> dict:
    """Smooth fields at realistic magnitudes (so the codecs have work), the
    coordinates and the attributes."""
    rng = np.random.default_rng(seed)
    out = {}
    for v, mean, std in zip(VARS, (101325.0, 285.0, 0.0, 0.0), (800.0, 5.0, 3.5, 3.5)):
        walk = np.cumsum(rng.standard_normal((HOURS, NLAT, NLON)), axis=0)
        field = np.cumsum(np.cumsum(walk, axis=1), axis=2) / np.sqrt(NLAT * NLON * HOURS)
        out[v] = (mean + std * field).astype(np.float32)
    out["time"] = np.datetime64("2014-04-07T04", "ns") + np.arange(HOURS) * np.timedelta64(1, "h")
    out["rlat"] = np.linspace(-6.07, 0.92, NLAT)
    out["rlon"] = np.linspace(-4.22, 2.77, NLON)
    return out


def grid(cls, seed: int = 0):
    """The fixture grid as a ``GridDataset`` of ``cls`` (either package's)."""
    a = grid_arrays(seed)
    return cls({v: a[v] for v in VARS}, {k: a[k] for k in ("time", "rlat", "rlon")},
               {"source": "fixture", "seed": seed})


def write_jax_store(path, compressor: str, ds) -> None:
    from climate2weather_tpu.data import zarr_store as jzarr

    path = str(path)
    if os.path.exists(path):
        shutil.rmtree(path)
    jzarr.write_zarr(ds, path, compressor="zlib" if compressor == "none" else compressor)
    if compressor == "none":
        t_chunk = min(24, len(ds.time))
        for k, v in ds.data_vars.items():
            shutil.rmtree(os.path.join(path, k))
            jzarr._write_array(path, k, np.asarray(v, np.float32), chunks=(t_chunk,) + tuple(v.shape[1:]),
                               attrs={"_ARRAY_DIMENSIONS": ["time", "rlat", "rlon"]}, compress=False)
    if compressor in MISSING:
        os.remove(os.path.join(path, MISSING[compressor]))


def main() -> None:
    from climate2weather_tpu.data.grid import GridDataset, open_grid

    ds = grid(GridDataset)
    contents = {v: ds.data_vars[v] for v in VARS}
    for comp in COMPRESSORS:
        write_jax_store(store_path(comp), comp, ds)
        read = open_grid(str(store_path(comp)))
        contents.update({f"{comp}/{v}": read.data_vars[v] for v in VARS})
        contents[f"{comp}/time"] = read.time
    np.savez_compressed(FIXTURES / "zarr_contents.npz", **contents)
    for comp in COMPRESSORS:
        files = [p for p in store_path(comp).rglob("*") if p.is_file()]
        print(store_path(comp).name, len(files), sum(p.stat().st_size for p in files))


if __name__ == "__main__":
    main()
