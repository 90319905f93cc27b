"""Wind-power conversion from 10m winds via a turbine power curve (port of
climate2weather_tpu/exp/windpower.py, numpy only).

Capability parity with the reference's windpower analysis
(exp/figures.py:1171-1230, `_calc_windpower`/`windpowers`), which used
windpowerlib's Enercon E-115/3000 turbine at 100 m hub height with a 1/7
power-law wind-profile extrapolation from 10 m.  The turbine model is
implemented directly instead of through windpowerlib: the E-115/3000 power
curve is public manufacturer data (3 MW rated, cut-in ~2.5 m/s, rated
~12 m/s), linearly interpolated.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

# Enercon E-115/3000: wind speed [m/s] -> power [W] (public curve, 3.0 MW rated)
E115_3000_CURVE: Tuple[np.ndarray, np.ndarray] = (
    np.array(
        [0.0, 1.0, 2.0, 3.0, 4.0, 5.0, 6.0, 7.0, 8.0, 9.0, 10.0,
         11.0, 12.0, 13.0, 14.0, 25.0, 25.01, 40.0]
    ),
    np.array(
        [0, 0, 3_000, 49_000, 155_000, 339_000, 628_000, 1_036_000,
         1_549_000, 2_090_000, 2_580_000, 2_900_000, 3_000_000, 3_000_000,
         3_000_000, 3_000_000, 0, 0],
        dtype=np.float64,
    ),
)

HUB_HEIGHT_M = 100.0
REFERENCE_HEIGHT_M = 10.0
HELLMANN_EXPONENT = 1.0 / 7.0  # neutral-stability power law


def wind_speed_at_hub(
    u10: np.ndarray,
    v10: np.ndarray,
    hub_height: float = HUB_HEIGHT_M,
    ref_height: float = REFERENCE_HEIGHT_M,
    alpha: float = HELLMANN_EXPONENT,
) -> np.ndarray:
    """|v| at hub height via the 1/7 power-law profile from 10 m winds."""
    speed10 = np.sqrt(np.square(u10) + np.square(v10))
    return speed10 * (hub_height / ref_height) ** alpha


def wind_power(
    u10: np.ndarray, v10: np.ndarray, curve=E115_3000_CURVE, **kwargs
) -> np.ndarray:
    """Turbine power output [W] from 10 m wind components (any shape)."""
    hub = wind_speed_at_hub(u10, v10, **kwargs)
    speeds, powers = curve
    return np.interp(hub, speeds, powers)


def capacity_factor(power: np.ndarray, rated: float = 3_000_000.0) -> np.ndarray:
    return np.asarray(power) / rated


def windpower_timeseries(ds) -> np.ndarray:
    """[T] spatial-mean power from a GridDataset with uas/vas."""
    p = wind_power(ds.data_vars["uas"], ds.data_vars["vas"])
    return p.mean(axis=(1, 2))
