"""Map plotting, animations, and composite helpers (port of
climate2weather_tpu/exp/plotting_util.py).

Capability parity with the reference ``exp/plotting_util.py`` (542 LoC):
rotated-pole map plotting with borders (plot_map/add_borders, :58-143),
variable naming (var2name, :96), animations (:144,426), coarse-over-fine
overlays (assign_overlapping_values, :436), and RGB "sandwich" composites
(:483).

The reference draws ``pcolormesh(xda.longitude, xda.latitude, ...)`` on a
cartopy Mollweide axis (plotting_util.py:121-143, figures.py:281). Here the
projection pipeline is numpy: COSMO rotated-pole -> geographic lon/lat (the
stored-coords transform; COSMO-REA6 rotated north pole at 39.25N, -162E)
and the Mollweide forward projection, rendered with plain matplotlib
pcolormesh plus a graticule. Geographic context (coastlines/borders) comes
from cartopy when importable, else from the vendored coarse polyline set in
``exp/geodata.py``.

matplotlib is imported only inside the functions that draw, so the module
imports, and its projections run, without it.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np

# COSMO-REA6 grid: rotated north pole (CF grid_north_pole_latitude/longitude)
POLE_LAT = 39.25
POLE_LON = -162.0


def rotated_to_lonlat(
    rlon_deg: np.ndarray,
    rlat_deg: np.ndarray,
    pole_lon: float = POLE_LON,
    pole_lat: float = POLE_LAT,
) -> Tuple[np.ndarray, np.ndarray]:
    """Rotated-pole coordinates -> geographic lon/lat [deg].

    Standard COSMO/CF back-rotation: with the rotated north pole at
    geographic (pole_lon, pole_lat), a point at rotated (rlon, rlat) maps to

        lat = asin( sin(rlat) sin(pole_lat) + cos(rlat) cos(rlon) cos(pole_lat) )
        lon = pole_lon + atan2( cos(rlat) sin(rlon),
                                sin(pole_lat) cos(rlat) cos(rlon)
                                - cos(pole_lat) sin(rlat) ) + 180

    Accepts 1-D axes (broadcast to a 2-D grid) or matching 2-D arrays.
    """
    rlon = np.deg2rad(np.asarray(rlon_deg, np.float64))
    rlat = np.deg2rad(np.asarray(rlat_deg, np.float64))
    if rlon.ndim == 1 and rlat.ndim == 1:
        rlon, rlat = np.meshgrid(rlon, rlat)
    sp, cp = np.sin(np.deg2rad(pole_lat)), np.cos(np.deg2rad(pole_lat))
    lat = np.arcsin(np.sin(rlat) * sp + np.cos(rlat) * np.cos(rlon) * cp)
    lon = np.arctan2(
        np.cos(rlat) * np.sin(rlon),
        sp * np.cos(rlat) * np.cos(rlon) - cp * np.sin(rlat),
    )
    lon_deg = np.rad2deg(lon) + pole_lon + 180.0
    lon_deg = (lon_deg + 180.0) % 360.0 - 180.0
    return lon_deg, np.rad2deg(lat)


def mollweide_xy(
    lon_deg: np.ndarray, lat_deg: np.ndarray, lon0: float = 0.0
) -> Tuple[np.ndarray, np.ndarray]:
    """Mollweide forward projection (unit sphere), Newton-iterated.

    The reference renders every map on ``ctp.crs.Mollweide()``
    (figures.py:281 et al.); this is the same mapping without cartopy."""
    lam = np.deg2rad(((np.asarray(lon_deg) - lon0 + 180.0) % 360.0) - 180.0)
    phi = np.deg2rad(np.asarray(lat_deg))
    theta = phi.copy()
    for _ in range(8):  # Newton: 2θ + sin 2θ = π sin φ
        f = 2.0 * theta + np.sin(2.0 * theta) - np.pi * np.sin(phi)
        df = 2.0 + 2.0 * np.cos(2.0 * theta)
        theta = theta - f / np.maximum(df, 1e-9)
    x = (2.0 * np.sqrt(2.0) / np.pi) * lam * np.cos(theta)
    y = np.sqrt(2.0) * np.sin(theta)
    return x, y

VAR2NAME = {
    "psl": ("Sea-level pressure", "hPa"),
    "tas": ("2m temperature", "K"),
    "uas": ("10m eastward wind", "m/s"),
    "vas": ("10m northward wind", "m/s"),
}

VAR2CMAP = {
    "psl": "viridis",
    "tas": "RdBu_r",
    "uas": "PuOr_r",
    "vas": "PuOr_r",
}


def var2name(var: str) -> str:
    name, unit = VAR2NAME.get(var, (var, ""))
    return f"{name} [{unit}]" if unit else name


def _plt():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def _graticule(ax, lon_grid, lat_grid, lon0, step=2.0):
    """Lat/lon gridlines over the projected domain (the Mollweide axis'
    gridlines in the reference's cartopy rendering)."""
    lon_min, lon_max = float(lon_grid.min()), float(lon_grid.max())
    lat_min, lat_max = float(lat_grid.min()), float(lat_grid.max())
    lons = np.arange(np.floor(lon_min / step) * step, lon_max + step, step)
    lats = np.arange(np.floor(lat_min / step) * step, lat_max + step, step)
    for lo in lons:
        la = np.linspace(lat_min, lat_max, 50)
        x, y = mollweide_xy(np.full_like(la, lo), la, lon0)
        ax.plot(x, y, color="gray", lw=0.3, alpha=0.6, zorder=12)
    for la in lats:
        lo = np.linspace(lon_min, lon_max, 50)
        x, y = mollweide_xy(lo, np.full_like(lo, la), lon0)
        ax.plot(x, y, color="gray", lw=0.3, alpha=0.6, zorder=12)


def _draw_geography(ax, lon_grid, lat_grid, lon0):
    """Coastlines/borders over the projected domain.

    The reference adds cartopy NaturalEarth features to every map
    (plotting_util.py:58-95); cartopy is used when importable, otherwise the
    vendored coarse polyline set (exp/geodata.py) provides the context
    dependency-free."""
    try:  # full-fidelity cartopy features when available
        import cartopy.feature as cfeature  # type: ignore

        ax.add_feature(cfeature.BORDERS, linewidth=0.4)
        ax.coastlines(linewidth=0.4)
        return
    except Exception:
        pass
    from climate2weather_tpu_torch.exp.geodata import geography_segments

    bbox = (
        float(lon_grid.min()), float(lon_grid.max()),
        float(lat_grid.min()), float(lat_grid.max()),
    )
    for kind, color, lw in (
        ("coastlines", "black", 0.8),
        ("borders", "dimgray", 0.5),
    ):
        for seg in geography_segments(kind, bbox=bbox):
            x, y = mollweide_xy(seg[:, 0], seg[:, 1], lon0)
            ax.plot(x, y, color=color, lw=lw, alpha=0.9, zorder=13)


def plot_map(
    field: np.ndarray,
    rlat: Optional[np.ndarray] = None,
    rlon: Optional[np.ndarray] = None,
    var: Optional[str] = None,
    ax=None,
    vmin=None,
    vmax=None,
    add_colorbar: bool = True,
    title: Optional[str] = None,
    lon: Optional[np.ndarray] = None,
    lat: Optional[np.ndarray] = None,
    graticule: bool = True,
    geography: bool = True,
):
    """Render one [H, W] field on its geographic grid, Mollweide-projected
    (the reference's pcolormesh-on-cartopy pipeline, plotting_util.py:121-143).

    Coordinates: pass stored 2-D ``lon``/``lat`` aux coords directly, or the
    rotated-pole axes ``rlat``/``rlon`` (transformed via the COSMO-REA6
    pole).  With no coordinates at all, falls back to a plain imshow.
    Coastlines/borders are overlaid from cartopy when importable, else from
    the vendored polyline set (``geography=False`` disables).
    """
    plt = _plt()
    if ax is None:
        _, ax = plt.subplots(figsize=(4, 4))
    cmap = VAR2CMAP.get(var, "viridis")

    if lon is None and rlat is not None and rlon is not None:
        lon, lat = rotated_to_lonlat(rlon, rlat)
    if lon is not None:
        lon0 = float(np.mean(lon))
        x, y = mollweide_xy(lon, lat, lon0)
        im = ax.pcolormesh(
            x, y, field, cmap=cmap, vmin=vmin, vmax=vmax, shading="auto",
            zorder=11,
        )
        if graticule:
            _graticule(ax, lon, lat, lon0)
        ax.set_aspect("equal")
        ax.set_xticks([])
        ax.set_yticks([])
    else:
        im = ax.imshow(
            field, origin="lower", cmap=cmap, vmin=vmin, vmax=vmax
        )
    if lon is not None and geography:
        _draw_geography(ax, lon, lat, lon0)
    if title:
        ax.set_title(title, fontsize=9)
    elif title is None and var:  # title="" suppresses entirely
        ax.set_title(var2name(var), fontsize=9)
    if add_colorbar:
        plt.colorbar(im, ax=ax, shrink=0.8)
    return ax


def assign_overlapping_values(
    fine: np.ndarray, coarse: np.ndarray, corner: bool = True
) -> np.ndarray:
    """Overlay a coarse field into the corner (or center) of a fine field for
    side-by-side scale comparison (reference plotting_util.py:436)."""
    out = fine.copy()
    ch, cw = coarse.shape
    # nearest-upsample the coarse block to a quarter of the fine grid
    fh, fw = fine.shape
    th, tw = fh // 2, fw // 2
    ys = (np.arange(th) * ch // th).clip(0, ch - 1)
    xs = (np.arange(tw) * cw // tw).clip(0, cw - 1)
    block = coarse[np.ix_(ys, xs)]
    if corner:
        out[:th, :tw] = block
    else:
        y0, x0 = (fh - th) // 2, (fw - tw) // 2
        out[y0 : y0 + th, x0 : x0 + tw] = block
    return out


def sandwich(
    fields: Sequence[np.ndarray], cmaps: Optional[Sequence[str]] = None
) -> np.ndarray:
    """RGB composite of several normalized fields (reference
    plotting_util.py:483): multiply colormapped layers."""
    import matplotlib

    cmaps = cmaps or ["Blues", "Reds", "Greens"][: len(fields)]
    rgb = np.ones(fields[0].shape + (3,))
    for f, name in zip(fields, cmaps):
        lo, hi = np.nanmin(f), np.nanmax(f)
        norm = (f - lo) / max(hi - lo, 1e-12)
        layer = matplotlib.colormaps[name](norm)[..., :3]
        rgb *= layer
    return np.clip(rgb, 0, 1)


def setup_animation(ds_list, var: str, labels: Sequence[str]):
    """Figure + per-frame updater over time for a list of GridDatasets
    (reference setup_animation, plotting_util.py:144)."""
    plt = _plt()
    n = len(ds_list)
    fig, axes = plt.subplots(1, n, figsize=(4 * n, 4))
    axes = np.atleast_1d(axes)
    vmin = min(float(np.nanmin(d.data_vars[var])) for d in ds_list)
    vmax = max(float(np.nanmax(d.data_vars[var])) for d in ds_list)
    ims = []
    for ax, ds, label in zip(axes, ds_list, labels):
        im = ax.imshow(
            ds.data_vars[var][0], origin="lower", vmin=vmin, vmax=vmax,
            cmap=VAR2CMAP.get(var, "viridis"),
        )
        ax.set_title(label, fontsize=9)
        ax.set_xticks([])
        ax.set_yticks([])
        ims.append(im)

    def update(t):
        for im, ds in zip(ims, ds_list):
            ti = min(t, ds.sizes["time"] - 1)
            im.set_data(ds.data_vars[var][ti])
        fig.suptitle(str(ds_list[0].time[min(t, ds_list[0].sizes['time'] - 1)]
                         .astype("datetime64[h]")), fontsize=10)
        return ims

    return fig, update


def create_animation(ds_list, var: str, labels: Sequence[str], out_path: str,
                     fps: int = 6, max_frames: Optional[int] = None) -> str:
    """Write a GIF animation over time (reference create_animation,
    plotting_util.py:426; GIF via Pillow so no ffmpeg dependency)."""
    from matplotlib.animation import FuncAnimation, PillowWriter

    fig, update = setup_animation(ds_list, var, labels)
    frames = min(
        min(d.sizes["time"] for d in ds_list), max_frames or 10**9
    )
    anim = FuncAnimation(fig, update, frames=frames, blit=False)
    anim.save(out_path, writer=PillowWriter(fps=fps))
    _plt().close(fig)
    return out_path
