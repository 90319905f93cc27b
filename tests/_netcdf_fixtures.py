"""HDF5 files laid out as the netCDF-C library writes them, written with h5py.

``write_netcdf_like(path, libver)`` writes a grid file in the layout of a
COSMO or CMIP6 netCDF-4 file: creation order tracked and indexed on every
group and variable (as netCDF-C sets it), ``time`` (hours, CF ``units``) on
an unlimited axis, ``rlat``, ``rlon`` and a ``bnds`` dimension as dimension
scales, the ``_Netcdf4Dimid`` / ``_Netcdf4Coordinates`` / ``_NCProperties``
attributes, twelve links in the root group and more than eight attributes on
the root and on ``psl`` (so both go to dense storage: fractal heaps and
version-2 B-trees; with ``long_attrs`` the root's attribute heap grows an
indirect block), and four [time, rlat, rlon] float32 variables:

- ``psl``: chunked (1, 3, 5) along the unlimited time axis, deflate and
  shuffle (with ``libver='latest'`` an extensible-array chunk index that
  reaches a secondary block; with ``'v108'`` a version-1 B-tree);
- ``tas``: chunked (4, 6, 10) on fixed axes (a fixed-array index);
- ``uas``: one chunk of the whole array with deflate (a single-chunk index);
- ``vas``: contiguous.

Run as a script to rewrite the committed fixtures under ``tests/fixtures/``:
``python tests/_netcdf_fixtures.py``.
"""

from __future__ import annotations

import pathlib

import h5py
import numpy as np

VARS = ("psl", "tas", "uas", "vas")
HOURS, NLAT, NLON = 16, 12, 20
FIXTURES = pathlib.Path(__file__).resolve().parent / "fixtures"
LIBVERS = {"v108": ("v108", "v108"), "latest": ("latest", "latest")}


def fixture_path(name: str) -> pathlib.Path:
    return FIXTURES / f"netcdf_c_{name}.nc"


def contents(seed: int = 0, hours: int = HOURS, nlat: int = NLAT, nlon: int = NLON) -> dict:
    """The arrays a fixture holds: smooth fields (so deflate has something
    to do) at realistic magnitudes, and the coordinates."""
    rng = np.random.default_rng(seed)
    out = {}
    for v, mean, std in zip(VARS, (101325.0, 285.0, 0.0, 0.0), (800.0, 5.0, 3.5, 3.5)):
        walk = np.cumsum(rng.standard_normal((hours, nlat, nlon)), axis=0)
        field = np.cumsum(np.cumsum(walk, axis=1), axis=2) / np.sqrt(nlat * nlon * hours)
        out[v] = (mean + std * field).astype(np.float32)
    out["time"] = np.arange(hours, dtype=np.float64) + 24.0 * 365
    out["rlat"] = np.linspace(-6.07, 0.92, nlat)
    out["rlon"] = np.linspace(-4.22, 2.77, nlon)
    out["time_bnds"] = np.stack([out["time"] - 0.5, out["time"] + 0.5], axis=1)
    return out


def write_netcdf_like(path, libver, data: dict, long_attrs: int = 0) -> None:
    """Write ``data`` (of :func:`contents`) in the netCDF-C layout at
    ``libver``; ``long_attrs`` more long root attributes grow the root's
    attribute heap past its first direct block."""
    hours, nlat, nlon = data["psl"].shape
    with h5py.File(path, "w", libver=libver, track_order=True) as f:
        f.attrs["_NCProperties"] = np.bytes_(b"version=2,netcdf=4.9.2,hdf5=1.14.6")
        for k, val in (("Conventions", "CF-1.6"), ("title", "COSMO-REA6 reanalysis, EUR-6km"),
                       ("institution", "Hans-Ertel-Centre for Weather Research"),
                       ("source", "COSMO_v1"), ("project_id", "REA6"), ("frequency", "1hr"),
                       ("experiment_id", "evaluation"), ("driving_model_id", "ECMWF-ERAINT"),
                       ("history", "cdo mergetime; " * 40), ("contact", "x@example.org")):
            f.attrs[k] = val
        for i in range(long_attrs):
            f.attrs[f"comment_{i:03d}"] = f"{i} " + "long attribute text " * (10 + i % 7)

        def scale(name, values, dimid, **kw):
            d = f.create_dataset(name, data=values, track_order=True, **kw)
            d.make_scale(name)
            d.attrs["_Netcdf4Dimid"] = np.int32(dimid)
            return d

        time = scale("time", data["time"], 0, maxshape=(None,), chunks=(8,))
        time.attrs["units"] = "hours since 2005-01-01 00:00:00"
        time.attrs["standard_name"] = "time"
        time.attrs["calendar"] = "proleptic_gregorian"
        time.attrs["bounds"] = "time_bnds"
        rlat = scale("rlat", data["rlat"], 1)
        rlon = scale("rlon", data["rlon"], 2)
        for d, axis in ((rlat, "Y"), (rlon, "X")):
            d.attrs["units"] = "degrees"
            d.attrs["axis"] = axis
        # a netCDF dimension without a coordinate variable
        bnds = f.create_dataset("bnds", shape=(2,), dtype=np.float32, track_order=True)
        bnds.make_scale("This is a netCDF dimension but not a netCDF variable.         2")
        bnds.attrs["_Netcdf4Dimid"] = np.int32(3)
        pole = f.create_dataset("rotated_pole", data=np.int32(0), track_order=True)
        pole.attrs["grid_mapping_name"] = "rotated_latitude_longitude"
        pole.attrs["grid_north_pole_latitude"] = 39.25
        pole.attrs["grid_north_pole_longitude"] = -162.0
        lat = f.create_dataset("lat", data=np.add.outer(data["rlat"], 0.1 * data["rlon"]) + 50.0,
                               track_order=True)
        lon = f.create_dataset("lon", data=np.add.outer(0.1 * data["rlat"], data["rlon"]) + 10.0,
                               track_order=True)
        tb = f.create_dataset("time_bnds", data=data["time_bnds"], maxshape=(None, 2), chunks=(8, 2),
                              track_order=True)
        tb.dims[0].attach_scale(time)
        tb.dims[1].attach_scale(bnds)
        for d in (lat, lon):
            d.dims[0].attach_scale(rlat)
            d.dims[1].attach_scale(rlon)
        layouts = {
            "psl": dict(maxshape=(None, nlat, nlon), chunks=(1, 3, 5), compression="gzip", shuffle=True),
            "tas": dict(chunks=(4, 6, 10)),
            "uas": dict(chunks=(hours, nlat, nlon), compression="gzip"),
            "vas": dict(),
        }
        for v in VARS:
            d = f.create_dataset(v, data=data[v], fillvalue=np.float32(1e20), track_order=True, **layouts[v])
            d.attrs["standard_name"] = {"psl": "air_pressure_at_sea_level", "tas": "air_temperature",
                                        "uas": "eastward_wind", "vas": "northward_wind"}[v]
            d.attrs["units"] = {"psl": "Pa", "tas": "K"}.get(v, "m s-1")
            d.attrs["grid_mapping"] = "rotated_pole"
            d.attrs["coordinates"] = "lon lat"
            d.attrs["_FillValue"] = np.float32(1e20)
            d.attrs["_Netcdf4Coordinates"] = np.array([0, 1, 2], np.int32)
            if v == "psl":  # more than eight attributes: dense storage
                d.attrs["long_name"] = "Sea Level Pressure"
                d.attrs["cell_methods"] = "time: point"
                d.attrs["missing_value"] = np.float32(1e20)
                d.attrs["comment"] = "reduced to mean sea level"
            for axis, s in enumerate((time, rlat, rlon)):
                d.dims[axis].attach_scale(s)


def main() -> None:
    data = contents()
    for name, libver in LIBVERS.items():
        write_netcdf_like(fixture_path(name), libver, data, long_attrs=12)
    np.savez_compressed(FIXTURES / "netcdf_c_contents.npz", **data)
    for p in sorted(FIXTURES.glob("netcdf_c_*")):
        print(p.name, p.stat().st_size)


if __name__ == "__main__":
    main()
