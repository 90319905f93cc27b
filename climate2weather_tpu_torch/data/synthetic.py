"""Synthetic COSMO-like weather generator (port of
climate2weather_tpu/data/synthetic.py), the workload behind
``runs/synth_meso128/``, which the year configs read.

Hourly (psl, tas, uas, vas) fields on a res x res grid: power-law spatial
spectra (``smooth``, or the ``mesoscale`` k^-3 -> k^-5/3 shape with an
ageostrophic pressure part), each Fourier mode a complex AR(1) process with
a scale-dependent decorrelation time and uniform advection, winds from a
streamfunction (divergence-free), psl its geostrophic pressure, tas with
diurnal and seasonal cycles and warm advection, at realistic magnitudes.

The seeded draws are the JAX package's, in the same order. The inverse FFTs
are numpy's (scipy's there): the fields agree to a few float32 ulps, not
bit for bit.
"""

from __future__ import annotations

import os
from typing import Dict

import numpy as np

from climate2weather_tpu_torch.data.grid import GridDataset, convert_to_datetime


class _SpectralAR:
    """Complex AR(1) per Fourier mode: stationary amplitude ``amp(k)``,
    decorrelation time ``tau(k)`` hours, uniform advection (px/hour)."""

    def __init__(self, res, amp, tau, advect, rng):
        self.res = res
        self.amp = amp  # [res, res]
        rho = np.exp(-1.0 / np.maximum(tau, 1e-6))
        ky, kx = np.meshgrid(
            np.fft.fftfreq(res), np.fft.fftfreq(res), indexing="ij"
        )
        phase = np.exp(-2j * np.pi * (advect[0] * kx + advect[1] * ky))
        # complex64 throughout: numpy upcasts any float64 operand to
        # complex128 (twice the memory traffic)
        self.transfer = (rho * phase).astype(np.complex64)
        self.innov_scale = (
            amp * np.sqrt(np.maximum(1.0 - rho**2, 0.0))
        ).astype(np.float32)
        self.rng = rng
        # stationary initialization: no burn-in needed
        self.z = (amp * self._cnormal()).astype(np.complex64)

    def _cnormal(self):
        r = self.rng.standard_normal((self.res, self.res), np.float32)
        i = self.rng.standard_normal((self.res, self.res), np.float32)
        return (r + 1j * i) / np.float32(np.sqrt(2.0))

    def steps(self, n: int) -> np.ndarray:
        """Advance n hours; returns the mode history [n, res, res] complex."""
        out = np.empty((n, self.res, self.res), np.complex64)
        z = self.z
        for t in range(n):
            z = self.transfer * z + self.innov_scale * self._cnormal()
            out[t] = z
        self.z = z
        return out


def _wavenumbers(res: int):
    ky, kx = np.meshgrid(
        np.fft.fftfreq(res, d=1.0 / res),
        np.fft.fftfreq(res, d=1.0 / res),
        indexing="ij",
    )
    k = np.sqrt(kx**2 + ky**2)
    return kx, ky, k


def _broken_power_amp(k: np.ndarray, a_syn: float, a_meso: float,
                      k_t: float) -> np.ndarray:
    """Fourier *amplitude* with a broken power law: ``k^-a_syn`` below the
    transition wavenumber ``k_t`` and ``k^-a_meso`` above, continuous at
    ``k_t``; DC mode zeroed.  ``k`` is in cycles per domain (integer rings).
    """
    kk = np.maximum(k, 1.0)
    amp = np.where(
        kk <= k_t,
        kk ** -a_syn,
        (k_t ** (a_meso - a_syn)) * kk ** -a_meso,
    ).astype(np.float32)
    amp[k == 0] = 0.0
    return amp


_SPECTRA = ("smooth", "mesoscale")


def _spectral_amplitudes(k: np.ndarray, spectrum: str):
    """(amp_psi, amp_tas, amp_ageo|None) Fourier amplitudes for the named
    spectrum family.

    ``smooth`` — the original hyper-smooth single power law: streamfunction
    ``(k+1)^-2.75`` (wind RAPSD ~ k^-2.5, psl ~ k^-4.5), temperature
    ``(k+1)^-2`` (~ k^-3).  Its ground-truth PSD spans >10 decades, far below
    any generative model's sampling-noise floor at high wavenumber — fine for
    training/guidance validation, but it makes spectral metrics (MELR,
    reference exp/metrics.py:50-181) saturate on floor noise.

    ``mesoscale`` — realistic atmospheric shape: kinetic-energy RAPSD
    ``k^-3`` at synoptic scales breaking to ``k^-5/3`` in the mesoscale
    (the canonical Nastrom-Gage shape).  With u = grad-perp(psi),
    E_u(k) ~ k^3 |psi_hat|^2, so psi amplitudes of -3 / -7/3 give exactly
    those slopes; temperature spectra follow the same -3 / -5/3 shape via
    amplitudes -2 / -4/3.  The resolved tail then spans ~4.5 decades and
    stays *above* the generation noise floor, so MELR measures the model's
    actual spectral fidelity instead of the floor.

    Geostrophic pressure (psl = psi) inherits a steep tail (-5 -> -11/3
    integrated), so the ``mesoscale`` family also returns an *ageostrophic*
    pressure-perturbation amplitude (same -3 -> -5/3 shape as temperature,
    scaled to ~30 Pa by the caller — the observed magnitude of mesoscale /
    convective pressure perturbations), which takes over the psl spectrum
    at high wavenumber and keeps it resolvable as well.
    """
    if spectrum == "smooth":
        amp_psi = (k + 1.0) ** -2.75
        amp_psi[0, 0] = 0.0
        amp_tas = (k + 1.0) ** -2.0
        amp_tas[0, 0] = 0.0
        return amp_psi, amp_tas, None
    if spectrum == "mesoscale":
        k_t = 8.0  # synoptic/mesoscale break: wavelength ~ domain/8
        amp_psi = _broken_power_amp(k, 3.0, 7.0 / 3.0, k_t)
        amp_tas = _broken_power_amp(k, 2.0, 4.0 / 3.0, k_t)
        amp_ageo = _broken_power_amp(k, 2.0, 4.0 / 3.0, k_t)
        return amp_psi, amp_tas, amp_ageo
    raise ValueError(f"unknown spectrum {spectrum!r}; one of {_SPECTRA}")


def _real_field(modes: np.ndarray) -> np.ndarray:
    """[T, res, res] complex modes -> real fields via inverse FFT."""
    return np.fft.ifft2(np.ascontiguousarray(modes, np.complex64), axes=(-2, -1)).real.astype(np.float32)


def synthesize_cosmo_like(
    num_hours: int,
    res: int = 128,
    seed: int = 0,
    start_time: str = "2006-01-01-00",
    chunk_hours: int = 744,
    psl_mean: float = 101325.0,
    psl_std: float = 800.0,
    psl_ageo_std: float = 30.0,
    tas_mean: float = 285.0,
    tas_std: float = 5.0,
    wind_std: float = 3.5,
    tau0: float = 60.0,
    advect=(2.5, 1.0),
    spectrum: str = "smooth",
) -> GridDataset:
    """Generate a :class:`GridDataset` of (psl, tas, uas, vas) hourly fields.

    ``spectrum`` selects the spatial-spectrum family — see
    :func:`_spectral_amplitudes` (``smooth`` keeps the original hyper-smooth
    law; ``mesoscale`` is the realistic k^-3 -> k^-5/3 atmospheric shape,
    the right workload for spectral-fidelity metrics).  Slopes verified
    numerically in tests/test_synthetic.py.
    """
    rng = np.random.default_rng(seed)
    kx, ky, k = _wavenumbers(res)

    amp_psi, amp_tas, amp_ageo = _spectral_amplitudes(k, spectrum)
    # decorrelation time: synoptic scales ~ days, grid scales ~ hours
    tau = tau0 * (np.maximum(k, 1.0)) ** (-2.0 / 3.0)

    psi_ar = _SpectralAR(res, amp_psi, tau, advect, rng)
    tas_ar = _SpectralAR(res, amp_tas, tau, advect, rng)
    ageo_ar = (
        _SpectralAR(res, amp_ageo, tau, advect, rng)
        if amp_ageo is not None else None
    )

    psl = np.empty((num_hours, res, res), np.float32)
    tas = np.empty((num_hours, res, res), np.float32)
    uas = np.empty((num_hours, res, res), np.float32)
    vas = np.empty((num_hours, res, res), np.float32)
    ageo = (
        np.empty((num_hours, res, res), np.float32)
        if ageo_ar is not None else None
    )

    d_dy = (-1j * ky).astype(np.complex64)
    d_dx = (1j * kx).astype(np.complex64)
    for t0 in range(0, num_hours, chunk_hours):
        t1 = min(t0 + chunk_hours, num_hours)
        psi_hat = psi_ar.steps(t1 - t0)
        # divergence-free winds: u = -d(psi)/dy, v = d(psi)/dx (spectral)
        uas[t0:t1] = _real_field(psi_hat * d_dy)
        vas[t0:t1] = _real_field(psi_hat * d_dx)
        # geostrophic balance: pressure proportional to the streamfunction
        psl[t0:t1] = _real_field(psi_hat)
        tas[t0:t1] = _real_field(tas_ar.steps(t1 - t0))
        if ageo_ar is not None:
            ageo[t0:t1] = _real_field(ageo_ar.steps(t1 - t0))

    def _standardize(x):
        return (x - x.mean()) / max(x.std(), 1e-12)

    # preserve u/v relative magnitudes (joint rescale keeps incompressibility)
    wind_scale = wind_std / max(np.sqrt((uas.std() ** 2 + vas.std() ** 2) / 2), 1e-12)
    uas = (uas - uas.mean()) * wind_scale
    vas = (vas - vas.mean()) * wind_scale
    psl = _standardize(psl) * psl_std + psl_mean
    if ageo is not None:
        # ageostrophic (mesoscale/convective) pressure perturbations: small
        # in magnitude but spectrally shallow, they own the psl tail beyond
        # k ~ 25 where the geostrophic k^-11/3 spectrum has collapsed
        psl += _standardize(ageo) * np.float32(psl_ageo_std)
    tas_f = _standardize(tas) * tas_std

    # diurnal + seasonal cycle and warm advection for temperature
    start_dt = convert_to_datetime(start_time)
    hours = np.arange(num_hours, dtype=np.float64)
    hour_of_day = (start_dt.hour + hours) % 24.0
    doy = (
        start_dt.timetuple().tm_yday - 1 + (start_dt.hour + hours) / 24.0
    ) % 365.25
    # smooth, strictly positive amplitude map (~2 K mean swing)
    amp_modes = amp_tas * (
        rng.standard_normal((res, res)) + 1j * rng.standard_normal((res, res))
    )
    smooth = np.fft.ifft2(amp_modes).real
    diurnal_amp = np.clip(
        2.0 + smooth / max(smooth.std(), 1e-12), 0.5, None
    ).astype(np.float32)
    diurnal = np.cos(2 * np.pi * (hour_of_day - 15.0) / 24.0)
    seasonal = 8.0 * np.cos(2 * np.pi * (doy - 200.0) / 365.25)
    tas = (
        tas_mean
        + tas_f
        + diurnal[:, None, None] * diurnal_amp[None]
        + seasonal[:, None, None]
        + 0.3 * vas  # southerlies advect warm air
    ).astype(np.float32)

    time = np.datetime64(start_dt, "ns") + (
        hours * 3600e9
    ).astype("timedelta64[ns]")
    coords = {
        "time": time,
        "rlat": np.linspace(-6.07, 0.92, res),
        "rlon": np.linspace(-4.22, 2.77, res),
    }
    return GridDataset(
        {"psl": psl, "tas": tas, "uas": uas.astype(np.float32),
         "vas": vas.astype(np.float32)},
        coords,
        {"source": "climate2weather_tpu synthetic", "seed": seed},
    )


def build_synthetic_dataset(
    out_dir: str,
    train_hours: int = 8784,
    eval_hours: int = 1488,
    res: int = 128,
    seed: int = 0,
    norm_mode: str = "quant95",
    quantile_subsample: int = 4,
    spectrum: str = "smooth",
) -> Dict[str, str]:
    """Materialize the full offline-data-engineering outputs for a synthetic
    workload: train merged grid + quantile file + normalized training HDF5,
    plus a held-out eval grid (different seed/period) for downscaling +
    metrics.  Returns the paths dict.
    """
    from climate2weather_tpu_torch.data.processing import compute_quantiles, merged_to_normed_h5

    os.makedirs(out_dir, exist_ok=True)
    paths = {
        "train_merged": os.path.join(out_dir, "train_merged.nc"),
        "quantiles": os.path.join(out_dir, "quantiles.h5"),
        "train_h5": os.path.join(out_dir, "train_normed.h5"),
        "eval_merged": os.path.join(out_dir, "eval_merged.nc"),
    }

    print(f"Synthesizing {train_hours} train hours at {res}x{res} "
          f"({spectrum} spectrum) ...")
    train = synthesize_cosmo_like(
        train_hours, res=res, seed=seed, start_time="2006-01-01-00",
        spectrum=spectrum,
    )
    train.to_file(paths["train_merged"])

    print("Computing quantiles ...")
    q = compute_quantiles(train.isel_time(np.arange(0, train_hours, quantile_subsample)))
    q.to_file(paths["quantiles"])

    print("Building normalized training HDF5 ...")
    merged_to_normed_h5(
        paths["train_merged"], paths["quantiles"], paths["train_h5"], norm_mode
    )

    print(f"Synthesizing {eval_hours} eval hours ...")
    ev = synthesize_cosmo_like(
        eval_hours, res=res, seed=seed + 1, start_time="2014-01-01-00",
        spectrum=spectrum,
    )
    ev.to_file(paths["eval_merged"])
    print(f"Synthetic dataset written to {out_dir}")
    return paths
