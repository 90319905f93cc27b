"""Vendored coarse geographic context: European coastlines and borders
(port of climate2weather_tpu/exp/geodata.py; the same polylines as data).

The reference overlays NaturalEarth coastlines/borders via cartopy on every
map (reference exp/plotting_util.py:58-95).  Where cartopy and its data are
absent, ``plotting_util.plot_map`` draws this small dependency-free polyline
set (a few KB) covering the COSMO-REA6 study region (central/western Europe)
and its surroundings.

The polylines are hand-digitized at ~0.5-1 degree fidelity from public
geographic knowledge — coarse by design: they provide orientation (which
coast is which, where a border runs), not survey geometry.  Each segment is
a list of (lon, lat) vertices in geographic degrees; use
:func:`geography_segments` to retrieve them clipped to a bounding box.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np

# --------------------------------------------------------------------------
# Coastlines (lon, lat) — each tuple below is one polyline.

_COASTLINES: Sequence[Sequence[Tuple[float, float]]] = (
    # Atlantic / Channel / North Sea mainland coast: Biscay -> Brittany ->
    # Channel -> Low Countries -> German Bight -> west Denmark -> Skagen
    (
        (-1.2, 44.6), (-1.1, 45.6), (-1.2, 46.3), (-2.0, 46.9), (-2.5, 47.3),
        (-4.3, 47.8), (-4.8, 48.4), (-4.2, 48.7), (-3.0, 48.8), (-1.6, 48.6),
        (-1.6, 49.7), (-1.2, 49.7), (-0.2, 49.3), (0.1, 49.4), (1.2, 49.9),
        (1.6, 50.2), (1.6, 50.9), (2.6, 51.1), (3.5, 51.4), (4.0, 51.5),
        (4.1, 52.0), (4.7, 52.9), (5.4, 53.2), (6.1, 53.4), (7.0, 53.3),
        (8.0, 53.5), (8.5, 53.9), (9.0, 53.9), (8.9, 54.4), (8.6, 55.0),
        (8.1, 55.6), (8.1, 56.5), (8.6, 57.1), (9.7, 57.6), (10.6, 57.7),
    ),
    # east Denmark -> Baltic south coast -> Gdansk bay
    (
        (10.6, 57.7), (10.3, 56.7), (11.0, 56.1), (10.2, 55.8), (9.6, 55.4),
        (9.5, 55.0), (9.4, 54.8), (10.0, 54.5), (10.2, 54.4), (10.8, 54.1),
        (11.1, 54.0), (11.5, 54.0), (12.1, 54.2), (12.6, 54.4), (13.0, 54.4),
        (13.5, 54.1), (14.0, 53.9), (14.3, 53.9), (15.3, 54.2), (16.2, 54.5),
        (17.0, 54.8), (18.4, 54.8), (18.5, 54.4), (19.4, 54.5), (19.9, 54.9),
        (21.0, 55.3),
    ),
    # Great Britain (coarse closed outline)
    (
        (-5.7, 50.0), (-4.0, 50.3), (-2.5, 50.6), (-1.3, 50.8), (0.3, 50.8),
        (1.4, 51.2), (0.9, 51.7), (1.7, 52.5), (0.3, 52.9), (0.1, 53.5),
        (-0.1, 53.6), (-1.2, 54.6), (-1.6, 55.0), (-2.0, 55.8), (-3.0, 56.0),
        (-2.2, 56.5), (-2.1, 57.5), (-3.1, 57.7), (-4.0, 57.9), (-5.0, 58.6),
        (-5.8, 57.9), (-5.6, 56.7), (-5.0, 56.0), (-4.8, 55.4), (-3.6, 54.9),
        (-3.2, 54.1), (-4.4, 53.3), (-4.6, 53.0), (-4.1, 52.9), (-4.8, 52.5),
        (-5.3, 51.9), (-4.0, 51.6), (-3.1, 51.4), (-4.0, 51.2), (-5.7, 50.0),
    ),
    # Ireland (coarse closed outline)
    (
        (-6.0, 52.2), (-6.4, 52.2), (-8.5, 51.5), (-9.8, 51.6), (-9.9, 52.6),
        (-9.1, 53.3), (-9.9, 53.5), (-9.9, 54.3), (-8.5, 54.3), (-8.2, 55.2),
        (-7.2, 55.3), (-6.2, 55.2), (-5.5, 54.6), (-6.0, 54.0), (-6.0, 53.5),
        (-6.1, 52.8), (-6.0, 52.2),
    ),
    # south Norway -> Oslofjord -> Swedish west/south coast
    (
        (4.7, 59.3), (5.5, 58.9), (7.0, 58.0), (8.8, 58.2), (9.7, 59.0),
        (10.5, 59.3), (11.2, 58.4), (11.9, 57.7), (12.0, 57.3), (12.9, 56.5),
        (12.6, 56.0), (13.0, 55.4), (14.2, 55.4), (14.7, 56.0), (15.8, 56.1),
        (16.5, 56.7),
    ),
    # Gulf of Lion -> Liguria -> Tyrrhenian coast (Rome, Naples)
    (
        (3.0, 43.0), (4.0, 43.5), (5.4, 43.3), (6.5, 43.1), (7.5, 43.7),
        (8.8, 44.4), (9.8, 44.0), (10.3, 43.5), (11.0, 42.5), (12.2, 41.9),
        (13.0, 41.3), (14.3, 40.8),
    ),
    # Adriatic: Po delta -> Venice -> Trieste -> Dalmatian coast
    (
        (12.4, 44.9), (12.3, 45.4), (13.1, 45.6), (13.8, 45.6), (14.0, 44.9),
        (15.2, 44.5), (16.5, 43.5), (18.0, 42.6),
    ),
)

# --------------------------------------------------------------------------
# Country borders (lon, lat) relevant to the study domain.

_BORDERS: Sequence[Sequence[Tuple[float, float]]] = (
    # Netherlands -- Germany
    ((7.0, 53.3), (7.0, 52.4), (6.0, 51.8), (6.1, 51.2), (6.0, 50.8)),
    # Belgium/Luxembourg -- Germany
    ((6.0, 50.8), (6.1, 50.2), (6.4, 49.8)),
    # France -- Germany (Rhine)
    ((6.4, 49.8), (7.4, 49.2), (8.2, 49.0), (8.1, 48.6), (7.6, 48.1), (7.5, 47.6)),
    # Switzerland north border (Basel -> Lake Constance)
    ((7.5, 47.6), (8.6, 47.8), (9.6, 47.5)),
    # Germany -- Austria
    ((9.6, 47.5), (10.2, 47.3), (11.0, 47.4), (12.2, 47.7), (12.8, 48.1), (13.5, 48.6)),
    # Germany -- Czechia
    ((13.5, 48.6), (13.8, 48.8), (12.5, 49.7), (12.1, 50.3), (13.0, 50.5), (14.4, 51.0)),
    # Germany -- Poland (Oder--Neisse)
    ((14.4, 51.0), (15.0, 51.3), (14.6, 52.1), (14.1, 52.8), (14.2, 53.9)),
    # Denmark -- Germany
    ((8.6, 54.9), (9.4, 54.8)),
    # France -- Belgium
    ((2.6, 51.1), (3.2, 50.7), (3.7, 50.3), (4.8, 50.0), (5.5, 49.8), (6.4, 49.8)),
    # France -- Switzerland (Jura / Geneva)
    ((7.5, 47.6), (6.9, 47.3), (6.1, 46.6), (6.0, 46.2)),
    # Czechia -- Poland (coarse)
    ((14.4, 51.0), (15.7, 50.7), (16.6, 50.2), (17.7, 50.3), (18.6, 49.9)),
    # Czechia -- Austria/Slovakia north border (coarse)
    ((13.5, 48.6), (14.7, 48.6), (15.8, 48.9), (16.9, 48.6)),
)


def geography_segments(
    kind: str = "both",
    bbox: Optional[Tuple[float, float, float, float]] = None,
    margin: float = 1.0,
) -> List[np.ndarray]:
    """Polyline segments as [N, 2] (lon, lat) arrays.

    ``kind``: "coastlines", "borders", or "both".  ``bbox`` =
    (lon_min, lon_max, lat_min, lat_max) drops vertices outside the box
    (+``margin`` deg), splitting a polyline where it leaves the box so no
    spurious chord is drawn across the clipped region.
    """
    src: List[Sequence[Tuple[float, float]]] = []
    if kind in ("coastlines", "both"):
        src += list(_COASTLINES)
    if kind in ("borders", "both"):
        src += list(_BORDERS)
    segs = [np.asarray(s, np.float64) for s in src]
    if bbox is None:
        return segs
    lo0, lo1, la0, la1 = bbox
    lo0, lo1 = lo0 - margin, lo1 + margin
    la0, la1 = la0 - margin, la1 + margin
    out: List[np.ndarray] = []
    for seg in segs:
        inside = (
            (seg[:, 0] >= lo0) & (seg[:, 0] <= lo1)
            & (seg[:, 1] >= la0) & (seg[:, 1] <= la1)
        )
        if not inside.any():
            continue
        # split into runs of consecutive inside vertices
        idx = np.nonzero(inside)[0]
        breaks = np.nonzero(np.diff(idx) > 1)[0]
        for run in np.split(idx, breaks + 1):
            if len(run) >= 2:
                out.append(seg[run])
    return out
