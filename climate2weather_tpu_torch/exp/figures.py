"""Evaluation figures (port of climate2weather_tpu/exp/figures.py).

Capability parity targets from the reference ``exp/figures.py`` (2077 lines,
paper-specific): distributional KDE/PMF comparisons (:23), time series
(:280), storm snapshot grids (:501), spectra; the rotated-pole map rendering
and the windpower conversion live in ``plotting_util.py`` / ``windpower.py``.

Each kind is two functions: ``<kind>_data`` computes every array the figure
shows, in numpy, from the ``exputil.setup`` ensemble (what a host without
matplotlib can run and check), and ``draw_<kind>`` draws those arrays with
matplotlib, imported only there. The JAX package's figure functions
(``kde_and_pmf(samples, gt, out_dir)``, ...) keep their names and
signatures and chain the two; :data:`KINDS` and :func:`make` are as in JAX,
and :func:`kind_data` / :func:`figure_data` give a kind's data alone. The
Gaussian KDE is the port's own (:func:`gaussian_kde`, scipy's
``gaussian_kde`` semantics), so no scipy is needed.
"""

from __future__ import annotations

import os
import pathlib
from typing import Dict, List, Optional

import numpy as np

from climate2weather_tpu_torch.data.grid import GridDataset
from climate2weather_tpu_torch.exp import exputil
from climate2weather_tpu_torch.exp.metrics import rapsd

VAR2NAME = {
    "psl": ("Sea-level pressure", "hPa"),
    "tas": ("2m temperature", "K"),
    "uas": ("10m U wind", "m/s"),
    "vas": ("10m V wind", "m/s"),
}


def _plt():
    """matplotlib's pyplot on the Agg backend; raises ImportError naming
    matplotlib where it is not installed."""
    try:
        import matplotlib
    except ImportError as e:
        raise ImportError("drawing a figure needs matplotlib, which is not importable here; "
                          "figures.kind_data / figure_data compute a figure's arrays without it") from e
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def _save(fig, plt, out_dir: str, name: str, dpi: int = 120) -> str:
    fig.tight_layout()
    path = os.path.join(out_dir, name)
    fig.savefig(path, dpi=dpi)
    plt.close(fig)
    return path


def gaussian_kde(vals: np.ndarray, points: np.ndarray, block: int = 64) -> np.ndarray:
    """``scipy.stats.gaussian_kde(vals)(points)`` for 1-D ``vals``: equal
    weights, Scott's factor n^(-1/5), the weighted covariance with ddof 1 as
    scipy takes it; evaluated ``block`` points at a time."""
    vals = np.asarray(vals, np.float64).ravel()
    points = np.asarray(points, np.float64).ravel()
    n = vals.size
    weights = np.full(n, 1.0 / n)
    neff = 1.0 / np.sum(weights ** 2)
    factor = neff ** (-1.0 / 5)
    h = float(np.sqrt(np.cov(vals[None, :], rowvar=True, bias=False, aweights=weights))) * factor
    out = np.empty(points.size)
    for i in range(0, points.size, block):
        z = (points[i:i + block, None] - vals[None, :]) / h
        out[i:i + block] = np.exp(-0.5 * z * z) @ weights
    return out / (np.sqrt(2 * np.pi) * h)


def _kde(vals: np.ndarray, grid: np.ndarray, max_points: int = 20000) -> np.ndarray:
    """Gaussian KDE evaluated on ``grid`` (deterministic subsample keeps the
    O(n*m) evaluation tractable on full ensembles)."""
    vals = np.asarray(vals, np.float64).ravel()
    if vals.size > max_points:
        # ceil the stride so the subsample spans the full record instead of
        # a time-prefix (floor stride + [:max_points] truncates the tail)
        vals = vals[:: -(-vals.size // max_points)]
    if np.std(vals) < 1e-12:
        out = np.zeros_like(grid)
        out[np.argmin(np.abs(grid - vals.mean()))] = 1.0
        return out
    return gaussian_kde(vals, grid)


def _hist_step(ax, counts, bins, **kw):
    """``ax.hist(values, bins, density=True, histtype="step")`` drawn from
    the values' bin counts: one weighted value at each bin's centre gives
    the same heights."""
    centres = (bins[:-1] + bins[1:]) / 2
    ax.hist(centres, bins=bins, weights=counts, density=True, histtype="step", **kw)


# ---------------------------------------------------------------------------
# kde_and_pmf


def kde_and_pmf_data(samples: List[GridDataset], gt: GridDataset) -> Dict[str, dict]:
    """Per variable: the KDE grid (the 0.1-99.9 percentile band, padded)
    and the curves of the ground truth, the pooled ensemble and its first
    five members; the PMF bins over the full range and both bin counts."""
    out = {}
    for v in gt.var_names():
        gt_vals = gt.data_vars[v].ravel()
        s_vals = np.concatenate([s.data_vars[v].ravel() for s in samples])
        lo = float(min(gt_vals.min(), s_vals.min()))
        hi = float(max(gt_vals.max(), s_vals.max()))
        # KDE row shows the distribution BULK: rare generation outliers can
        # stretch the raw range 10x and squash the curves to a spike, so the
        # grid spans the 0.1-99.9 percentile band; the log-PMF row below
        # keeps the full range and exposes the tails.
        klo = float(min(np.quantile(gt_vals, 1e-3), np.quantile(s_vals, 1e-3)))
        khi = float(max(np.quantile(gt_vals, 1 - 1e-3), np.quantile(s_vals, 1 - 1e-3)))
        pad = 0.05 * (khi - klo) or 1.0
        grid = np.linspace(klo - pad, khi + pad, 256)
        bins = np.linspace(lo, hi, 80)
        out[v] = {"grid": grid, "kde_gt": _kde(gt_vals, grid), "kde_samples": _kde(s_vals, grid),
                  "kde_members": np.stack([_kde(s.data_vars[v], grid) for s in samples[:5]]),
                  "bins": bins, "hist_gt": np.histogram(gt_vals, bins)[0],
                  "hist_samples": np.histogram(s_vals, bins)[0]}
    return out


def draw_kde_and_pmf(data: Dict[str, dict], out_dir: str) -> str:
    plt = _plt()
    names = list(data)
    fig, axes = plt.subplots(2, len(names), figsize=(4 * len(names), 5.5), squeeze=False)
    for col, v in enumerate(names):
        d = data[v]
        ax = axes[0, col]
        ax.plot(d["grid"], d["kde_gt"], "k-", lw=2, label="ground truth")
        ax.plot(d["grid"], d["kde_samples"], "C0-", lw=2, label="samples")
        for curve in d["kde_members"]:  # per-member curves show ensemble spread
            ax.plot(d["grid"], curve, "C0-", lw=0.5, alpha=0.3)
        name, unit = VAR2NAME.get(v, (v, ""))
        ax.set_title(f"{name} [{unit}]")
        ax.set_ylabel("KDE density" if col == 0 else "")
        ax.legend(fontsize=7)
        # PMF: shared bins, log scale to expose tail behavior
        axp = axes[1, col]
        _hist_step(axp, d["hist_gt"], d["bins"], color="k", lw=1.5, label="ground truth")
        _hist_step(axp, d["hist_samples"], d["bins"], color="C0", lw=1.5, label="samples")
        axp.set_yscale("log")
        axp.set_ylabel("PMF (log)" if col == 0 else "")
    return _save(fig, plt, out_dir, "kde_and_pmf.png")


def kde_and_pmf(samples: List[GridDataset], gt: GridDataset, out_dir: str) -> str:
    """Per-variable value distributions, ensemble vs ground truth: true
    Gaussian-KDE curves (top row) and log-scale PMF histograms capturing the
    tails (bottom row) — the reference's kde_and_pmf (exp/figures.py:23)."""
    return draw_kde_and_pmf(kde_and_pmf_data(samples, gt), out_dir)


# ---------------------------------------------------------------------------
# timeseries


def timeseries_data(samples: List[GridDataset], gt: GridDataset, obs: GridDataset) -> dict:
    """Per variable: the spatial means of each member (min, max and mean
    over the ensemble), of the ground truth and of the observation; both
    time axes."""
    out = {"t_gt": gt.time.astype("datetime64[s]"), "t_obs": obs.time.astype("datetime64[s]"), "vars": {}}
    for v in gt.var_names():
        ens = np.stack([s.data_vars[v].mean(axis=(1, 2)) for s in samples])
        out["vars"][v] = {"ens_min": ens.min(0), "ens_max": ens.max(0), "ens_mean": ens.mean(0),
                          "gt": gt.data_vars[v].mean(axis=(1, 2)), "obs": obs.data_vars[v].mean(axis=(1, 2))}
    return out


def draw_timeseries(data: dict, out_dir: str) -> str:
    plt = _plt()
    names = list(data["vars"])
    fig, axes = plt.subplots(len(names), 1, figsize=(10, 2.5 * len(names)), sharex=True)
    t_gt = data["t_gt"]
    for ax, v in zip(np.atleast_1d(axes), names):
        d = data["vars"][v]
        n = len(d["ens_mean"])
        ax.fill_between(t_gt[:n], d["ens_min"], d["ens_max"], alpha=0.3, label="ensemble range")
        ax.plot(t_gt[:n], d["ens_mean"], lw=1, label="ensemble mean")
        ax.plot(t_gt, d["gt"], "k-", lw=1, label="gt")
        ax.plot(data["t_obs"], d["obs"], "r.", ms=4, label="obs")
        name, unit = VAR2NAME.get(v, (v, ""))
        ax.set_ylabel(f"{name}\n[{unit}]")
    np.atleast_1d(axes)[0].legend(ncol=4, fontsize=8)
    return _save(fig, plt, out_dir, "timeseries.png")


def timeseries(samples: List[GridDataset], gt: GridDataset, obs: GridDataset, out_dir: str) -> str:
    """Spatial-mean time series with ensemble spread vs gt vs obs
    (reference exp/figures.py:280)."""
    return draw_timeseries(timeseries_data(samples, gt, obs), out_dir)


# ---------------------------------------------------------------------------
# storm_grid


def storm_grid_data(samples: List[GridDataset], gt: GridDataset, obs: GridDataset, var: str = "uas",
                    n_times: int = 6) -> dict:
    """``n_times`` evenly spaced frames of ``var``: the nearest observation,
    the ground truth and the first (up to) three samples, with their
    rotated-pole axes, the ground truth's colour range and the titles."""
    T = gt.sizes["time"]
    t_idx = np.linspace(0, T - 1, n_times).astype(int)
    n_samples = min(len(samples), 3)
    o_idx = [int(np.argmin(np.abs(obs.time - gt.time[ti]))) for ti in t_idx]
    return {
        "var": var, "vmin": gt.data_vars[var].min(), "vmax": gt.data_vars[var].max(),
        "obs": obs.data_vars[var][o_idx], "gt": gt.data_vars[var][t_idx],
        "samples": np.stack([samples[r].data_vars[var][t_idx] for r in range(n_samples)]),
        "obs_axes": (obs.rlat, obs.rlon), "gt_axes": (gt.rlat, gt.rlon),
        "sample_axes": [(samples[r].rlat, samples[r].rlon) for r in range(n_samples)],
        "titles": [str(gt.time[ti].astype("datetime64[h]")) for ti in t_idx],
    }


def draw_storm_grid(data: dict, out_dir: str) -> str:
    from climate2weather_tpu_torch.exp.plotting_util import plot_map

    plt = _plt()
    var, n_times = data["var"], len(data["titles"])
    rows = 2 + len(data["samples"])
    fig, axes = plt.subplots(rows, n_times, figsize=(2 * n_times, 2 * rows))
    kw = dict(var=var, vmin=data["vmin"], vmax=data["vmax"], add_colorbar=False, title="")

    def panel(ax, field, axes_of):
        rlat, rlon = axes_of
        plot_map(field, rlat=rlat, rlon=rlon, ax=ax, graticule=False, **kw)

    for j in range(n_times):
        panel(axes[0, j], data["obs"][j], data["obs_axes"])
        panel(axes[1, j], data["gt"][j], data["gt_axes"])
        for r in range(rows - 2):
            panel(axes[2 + r, j], data["samples"][r][j], data["sample_axes"][r])
        axes[0, j].set_title(data["titles"][j], fontsize=7)
    for ax in axes.ravel():
        ax.set_xticks([])
        ax.set_yticks([])
    labels = ["obs", "gt"] + [f"sample {r}" for r in range(rows - 2)]
    for r, lab in enumerate(labels):
        axes[r, 0].set_ylabel(lab)
    return _save(fig, plt, out_dir, f"storm_grid_{var}.png")


def storm_grid(samples: List[GridDataset], gt: GridDataset, obs: GridDataset, out_dir: str, var: str = "uas",
               n_times: int = 6) -> str:
    """Snapshot grid: obs / gt / first samples across selected times,
    rendered on the Mollweide-projected geographic grid like the
    reference's cartopy storm grids (exp/figures.py:501-668)."""
    return draw_storm_grid(storm_grid_data(samples, gt, obs, var, n_times), out_dir)


# ---------------------------------------------------------------------------
# rapsd


def rapsd_data(samples: List[GridDataset], gt: GridDataset, d: float = 6.0,
               obs: Optional[GridDataset] = None) -> Dict[str, dict]:
    """Per variable: the wavenumbers and the mean radially averaged power
    spectra of the ground truth and of the first four samples over (up to)
    16 evenly spaced frames, and of the bilinear-interpolated observation
    (``None`` where the observation's grid does not divide the field's)."""
    from climate2weather_tpu_torch.exp.metrics import upsample_observation

    T = gt.sizes["time"]
    H, W = next(iter(gt.data_vars.values())).shape[-2:]
    t_idx = np.linspace(0, T - 1, min(T, 16)).astype(int)
    out = {}
    for v in gt.var_names():
        gt_psd = np.mean([rapsd(gt.data_vars[v][t], d=d)[0] for t in t_idx], axis=0)
        _, freq = rapsd(gt.data_vars[v][t_idx[0]], d=d)
        s_psd = np.mean([rapsd(s.data_vars[v][t], d=d)[0] for s in samples[:4] for t in t_idx], axis=0)
        b_psd = None
        if obs is not None and v in obs.data_vars:
            o = np.asarray(obs.data_vars[v], np.float64)
            if (o.ndim == 3 and o.shape[1] and o.shape[2] and H % o.shape[1] == 0 and W % o.shape[2] == 0
                    and (o.shape[1], o.shape[2]) != (H, W)):
                # <= 16 evenly spaced frames, matching the gt/sample t_idx
                # protocol (and bounding the FFT work at year scale)
                o_idx = np.linspace(0, o.shape[0] - 1, min(o.shape[0], 16))
                up = upsample_observation(o[o_idx.astype(int)], H, W)
                b_psd = np.mean([rapsd(up[t], d=d)[0] for t in range(up.shape[0])], axis=0)
        out[v] = {"freq": freq, "gt": gt_psd, "samples": s_psd, "interp_obs": b_psd}
    return out


def draw_rapsd(data: Dict[str, dict], out_dir: str) -> str:
    plt = _plt()
    names = list(data)
    fig, axes = plt.subplots(1, len(names), figsize=(4 * len(names), 3))
    for ax, v in zip(np.atleast_1d(axes), names):
        d = data[v]
        ax.loglog(d["freq"][1:], d["gt"][1:], "k-", label="gt")
        ax.loglog(d["freq"][1:], d["samples"][1:], "C0-", label="samples")
        if d["interp_obs"] is not None:
            ax.loglog(d["freq"][1:], d["interp_obs"][1:], "C3--", label="interp. obs")
        ax.set_title(v)
        ax.set_xlabel("wavenumber [1/km]")
        ax.legend()
    return _save(fig, plt, out_dir, "rapsd.png")


def rapsd_figure(samples: List[GridDataset], gt: GridDataset, out_dir: str, d: float = 6.0,
                 obs: Optional[GridDataset] = None) -> str:
    """Mean radially averaged power spectra: ensemble vs ground truth, plus
    the bilinear-interpolated coarse observation (the no-model baseline —
    its spectrum collapses above the obs Nyquist, which is exactly the band
    the diffusion ensemble must fill; see metrics.upsample_observation)."""
    return draw_rapsd(rapsd_data(samples, gt, d=d, obs=obs), out_dir)


# ---------------------------------------------------------------------------
# calibration


def calibration_data(samples: List[GridDataset], gt: GridDataset,
                     obs: Optional[GridDataset] = None) -> Dict[str, dict]:
    """Per variable, on the observation's time grid where there is one (the
    metrics' protocol): the rank histogram's frequencies, the reliability
    index, and the spread/skill ratio per comparison time (``None`` for
    fewer than two members)."""
    from climate2weather_tpu_torch.exp.metrics import (_sel_times, rank_histogram, reliability_index,
                                                       spread_skill_ratio)

    if obs is not None:
        times = obs.time[np.isin(obs.time, gt.time)]
        gt_cmp = _sel_times(gt, times)
        samples_cmp = [_sel_times(s, times) for s in samples]
    else:
        gt_cmp, samples_cmp = gt, list(samples)
    out = {}
    for v in gt.var_names():
        gt_np = np.asarray(gt_cmp.data_vars[v], np.float64)
        ens = np.stack([np.asarray(s.data_vars[v], np.float64) for s in samples_cmp])
        S = ens.shape[0]
        hist = rank_histogram(ens, gt_np)
        out[v] = {"members": S, "freq": hist / hist.sum(), "reliability": reliability_index(hist),
                  "spread_skill": spread_skill_ratio(ens, gt_np) if S >= 2 else None}
    return out


def draw_calibration(data: Dict[str, dict], out_dir: str) -> str:
    plt = _plt()
    names = list(data)
    fig, axes = plt.subplots(2, len(names), figsize=(3.2 * len(names), 5.4))
    axes = np.asarray(axes).reshape(2, -1)
    for j, v in enumerate(names):
        d = data[v]
        S = d["members"]
        ax = axes[0, j]
        ax.bar(np.arange(S + 1), d["freq"], color="C0", width=0.9)
        ax.axhline(1.0 / (S + 1), color="k", ls="--", lw=1)
        name, _ = VAR2NAME.get(v, (v, ""))
        ax.set_title(f"{name}  (RI={d['reliability']:.2f})", fontsize=9)
        ax.set_xlabel("rank of truth in ensemble", fontsize=8)
        if j == 0:
            ax.set_ylabel("frequency")
        ax2 = axes[1, j]
        if d["spread_skill"] is not None:
            ax2.plot(np.arange(len(d["spread_skill"])), d["spread_skill"], "C0.-", ms=4, lw=1)
        ax2.axhline(1.0, color="k", ls="--", lw=1)
        ax2.set_xlabel("comparison time index", fontsize=8)
        if j == 0:
            ax2.set_ylabel("spread / skill")
    return _save(fig, plt, out_dir, "calibration.png")


def calibration(samples: List[GridDataset], gt: GridDataset, out_dir: str,
                obs: Optional[GridDataset] = None) -> str:
    """Ensemble-calibration panel: rank histogram (top) and spread/skill
    ratio over comparison times (bottom), per variable.

    Visualizes the calibration metrics of exp/metrics.py (fair CRPS's
    companions): a reliable ensemble has a flat rank histogram and a
    spread/skill ratio of 1 (dashed lines). Comparison happens on the
    observation time grid when an observation is present, matching the
    metrics protocol (reference exp/metrics.py:233-240)."""
    return draw_calibration(calibration_data(samples, gt, obs=obs), out_dir)


# ---------------------------------------------------------------------------
# windpower and windpower_dist


def windpower_data(samples: List[GridDataset], gt: GridDataset) -> dict:
    """The spatial-mean turbine power [MW] of each member and of the ground
    truth over time."""
    from climate2weather_tpu_torch.exp.windpower import windpower_timeseries

    return {"t": gt.time.astype("datetime64[s]"),
            "ens": np.stack([windpower_timeseries(s) for s in samples]) / 1e6,
            "gt": windpower_timeseries(gt) / 1e6}


def draw_windpower(data: dict, out_dir: str) -> str:
    plt = _plt()
    fig, ax = plt.subplots(figsize=(10, 3))
    t, ens = data["t"], data["ens"]
    ax.fill_between(t[: ens.shape[1]], ens.min(0), ens.max(0), alpha=0.3, label="ensemble range")
    ax.plot(t[: ens.shape[1]], ens.mean(0), lw=1, label="ensemble mean")
    ax.plot(t, data["gt"], "k-", lw=1, label="gt")
    ax.set_ylabel("mean turbine power [MW]")
    ax.legend(ncol=3, fontsize=8)
    return _save(fig, plt, out_dir, "windpower.png")


def windpowers(samples: List[GridDataset], gt: GridDataset, out_dir: str) -> str:
    """Wind-power time series: ensemble vs ground truth through the turbine
    model (reference exp/figures.py:1288)."""
    return draw_windpower(windpower_data(samples, gt), out_dir)


def windpower_dist_data(samples: List[GridDataset], gt: GridDataset) -> dict:
    """The KDE of the spatial-mean capacity factor (ground truth, pooled
    ensemble, first five members) and the bin counts of the per-pixel
    capacity factors."""
    from climate2weather_tpu_torch.exp.windpower import capacity_factor, wind_power

    def cf_fields(ds):
        return capacity_factor(wind_power(ds.data_vars["uas"], ds.data_vars["vas"]))

    gt_cf = cf_fields(gt)
    s_cf = [cf_fields(s) for s in samples]
    grid = np.linspace(0.0, 1.0, 256)
    bins = np.linspace(0, 1, 60)
    return {"grid": grid, "kde_gt": _kde(gt_cf.mean(axis=(1, 2)), grid),
            "kde_samples": _kde(np.concatenate([c.mean(axis=(1, 2)) for c in s_cf]), grid),
            "kde_members": np.stack([_kde(c.mean(axis=(1, 2)), grid) for c in s_cf[:5]]),
            "bins": bins, "hist_gt": np.histogram(gt_cf.ravel(), bins)[0],
            "hist_samples": np.histogram(np.concatenate([c.ravel() for c in s_cf]), bins)[0]}


def draw_windpower_dist(data: dict, out_dir: str) -> str:
    plt = _plt()
    fig, (ax_kde, ax_pmf) = plt.subplots(1, 2, figsize=(9, 3.2))
    grid = data["grid"]
    ax_kde.plot(grid, data["kde_gt"], "k-", lw=2, label="ground truth")
    ax_kde.plot(grid, data["kde_samples"], "C0-", lw=2, label="samples")
    for curve in data["kde_members"]:
        ax_kde.plot(grid, curve, "C0-", lw=0.5, alpha=0.3)
    ax_kde.set_xlabel("spatial-mean capacity factor")
    ax_kde.set_ylabel("KDE density")
    ax_kde.legend(fontsize=8)
    _hist_step(ax_pmf, data["hist_gt"], data["bins"], color="k", lw=1.5, label="ground truth")
    _hist_step(ax_pmf, data["hist_samples"], data["bins"], color="C0", lw=1.5, label="samples")
    ax_pmf.set_yscale("log")
    ax_pmf.set_xlabel("per-pixel capacity factor")
    ax_pmf.set_ylabel("PMF (log)")
    ax_pmf.legend(fontsize=8)
    fig.suptitle("E-115/3000 @ 100 m hub, 1/7 power-law from 10 m winds", fontsize=9)
    return _save(fig, plt, out_dir, "windpower_dist.png")


def windpower_dist(samples: List[GridDataset], gt: GridDataset, out_dir: str) -> str:
    """Wind-power capacity-factor distributions: KDE of the per-hour
    spatial-mean capacity factor plus a log-PMF over per-pixel hourly
    capacity factors, ensemble vs ground truth (reference
    exp/figures.py:1171-1330 wind-power analysis)."""
    return draw_windpower_dist(windpower_dist_data(samples, gt), out_dir)


# ---------------------------------------------------------------------------
# climate_grid and big_grid


def climate_grid_data(samples: List[GridDataset], gt: GridDataset, obs: GridDataset, var: str = "tas",
                      n_times: int = 5) -> dict:
    """Up to ``n_times`` evenly spaced observation frames of ``var`` and the
    first (up to) three samples at the nearest ground-truth times, with the
    observation's colour range and the titles."""
    To = obs.sizes["time"]
    t_idx = np.linspace(0, To - 1, min(n_times, To)).astype(int)
    n_samples = min(len(samples), 3)
    g_idx = [int(np.argmin(np.abs(gt.time - obs.time[oi]))) for oi in t_idx]
    return {
        "var": var, "vmin": float(np.nanmin(obs.data_vars[var])), "vmax": float(np.nanmax(obs.data_vars[var])),
        "obs": obs.data_vars[var][t_idx],
        "samples": np.stack([samples[r].data_vars[var][g_idx] for r in range(n_samples)]),
        "titles": [str(obs.time[oi].astype("datetime64[h]")) for oi in t_idx],
    }


def draw_climate_grid(data: dict, out_dir: str) -> str:
    plt = _plt()
    n = len(data["titles"])
    nrows = 1 + len(data["samples"])
    fig, axes = plt.subplots(nrows, n, figsize=(2.2 * n, 2.2 * nrows))
    axes = np.atleast_2d(axes)
    vmin, vmax = data["vmin"], data["vmax"]
    for j in range(n):
        axes[0, j].imshow(data["obs"][j], vmin=vmin, vmax=vmax)
        axes[0, j].set_title(data["titles"][j], fontsize=7)
        for r in range(nrows - 1):
            axes[1 + r, j].imshow(data["samples"][r][j], vmin=vmin, vmax=vmax)
    for ax in axes.ravel():
        ax.set_xticks([])
        ax.set_yticks([])
    axes[0, 0].set_ylabel("climate input")
    for r in range(nrows - 1):
        axes[1 + r, 0].set_ylabel(f"sample {r}")
    return _save(fig, plt, out_dir, f"climate_grid_{data['var']}.png")


def climate_grid(samples: List[GridDataset], gt: GridDataset, obs: GridDataset, out_dir: str, var: str = "tas",
                 n_times: int = 5) -> str:
    """Coarse climate input vs downscaled ensemble at observation times
    (reference exp/figures.py:669) — like storm_grid but organized around
    the observation grid, with the coarse field overlaid at matching
    color scale."""
    return draw_climate_grid(climate_grid_data(samples, gt, obs, var, n_times), out_dir)


def big_grid_data(samples: List[GridDataset], gt: GridDataset, n_times: int = 8) -> Dict[str, dict]:
    """Per variable: up to ``n_times`` evenly spaced frames of the ground
    truth and of the first sample, and the ground truth's colour range."""
    T = gt.sizes["time"]
    t_idx = np.linspace(0, T - 1, min(n_times, T)).astype(int)
    return {v: {"vmin": float(np.nanmin(gt.data_vars[v])), "vmax": float(np.nanmax(gt.data_vars[v])),
                "gt": gt.data_vars[v][t_idx], "sample": samples[0].data_vars[v][t_idx]}
            for v in gt.var_names()}


def draw_big_grid(data: Dict[str, dict], out_dir: str) -> str:
    plt = _plt()
    names = list(data)
    n = len(data[names[0]]["gt"])
    nrows = 2 * len(names)
    fig, axes = plt.subplots(nrows, n, figsize=(2 * n, 2 * nrows))
    for vi, v in enumerate(names):
        d = data[v]
        for j in range(n):
            axes[2 * vi, j].imshow(d["gt"][j], vmin=d["vmin"], vmax=d["vmax"])
            axes[2 * vi + 1, j].imshow(d["sample"][j], vmin=d["vmin"], vmax=d["vmax"])
        axes[2 * vi, 0].set_ylabel(f"{v} gt", fontsize=8)
        axes[2 * vi + 1, 0].set_ylabel(f"{v} sample", fontsize=8)
    for ax in axes.ravel():
        ax.set_xticks([])
        ax.set_yticks([])
    return _save(fig, plt, out_dir, "big_grid.png", dpi=110)


def big_grid(samples: List[GridDataset], gt: GridDataset, out_dir: str, n_times: int = 8) -> str:
    """All variables x time for one sample against ground truth
    (reference exp/figures.py:1797)."""
    return draw_big_grid(big_grid_data(samples, gt, n_times), out_dir)


# ---------------------------------------------------------------------------
# downscaled_clim_dist


def downscaled_clim_dist_data(exp_dirs: List[str], labels: List[str]) -> Dict[str, dict]:
    """Per variable: one KDE grid over the ground truth's and every
    experiment's range, the ground truth's curve and each experiment's
    pooled ensemble's, in ``labels``' order."""
    loaded = [exputil.setup(d) for d in exp_dirs]
    gt = loaded[0][1]
    out = {}
    for v in gt.var_names():
        gt_vals = gt.data_vars[v].ravel()
        lo, hi = gt_vals.min(), gt_vals.max()
        for samples, _, _ in loaded:
            s_vals = np.concatenate([s.data_vars[v].ravel() for s in samples])
            lo, hi = min(lo, s_vals.min()), max(hi, s_vals.max())
        pad = 0.05 * (hi - lo) or 1.0
        grid = np.linspace(lo - pad, hi + pad, 256)
        curves = [_kde(np.concatenate([s.data_vars[v].ravel() for s in samples]), grid)
                  for samples, _, _ in loaded]
        out[v] = {"grid": grid, "kde_gt": _kde(gt_vals, grid), "labels": list(labels), "kde": np.stack(curves)}
    return out


def draw_downscaled_clim_dist(data: Dict[str, dict], out_dir: str) -> str:
    plt = _plt()
    names = list(data)
    fig, axes = plt.subplots(1, len(names), figsize=(4 * len(names), 3))
    for ax, v in zip(np.atleast_1d(axes), names):
        d = data[v]
        ax.plot(d["grid"], d["kde_gt"], "k-", lw=2, label="ground truth")
        for curve, label in zip(d["kde"], d["labels"]):
            ax.plot(d["grid"], curve, lw=1.5, label=label)
        name, unit = VAR2NAME.get(v, (v, ""))
        ax.set_title(f"{name} [{unit}]")
        ax.legend(fontsize=7)
    return _save(fig, plt, out_dir, "downscaled_clim_dist.png")


def downscaled_clim_dist(exp_dirs: List[str], labels: List[str], out_dir: str) -> str:
    """Per-variable value distributions of downscaled ensembles from
    multiple experiments (e.g. biased vs quantile-mapping-debiased CMIP6
    inputs) against the shared ground truth
    (reference exp/figures.py:871-906)."""
    return draw_downscaled_clim_dist(downscaled_clim_dist_data(exp_dirs, labels), out_dir)


# ---------------------------------------------------------------------------

KINDS = {
    "kde_and_pmf": lambda s, g, o, d: kde_and_pmf(s, g, d),
    "timeseries": timeseries,
    "storm_grid": storm_grid,
    "climate_grid": climate_grid,
    "big_grid": lambda s, g, o, d: big_grid(s, g, d),
    "rapsd": lambda s, g, o, d: rapsd_figure(s, g, d, obs=o),
    "calibration": lambda s, g, o, d: calibration(s, g, d, obs=o),
    "windpower": lambda s, g, o, d: windpowers(s, g, d),
    "windpower_dist": lambda s, g, o, d: windpower_dist(s, g, d),
}
# each kind of KINDS as (data from the ensemble, drawing of the data)
_PARTS = {
    "kde_and_pmf": (lambda s, g, o: kde_and_pmf_data(s, g), draw_kde_and_pmf),
    "timeseries": (timeseries_data, draw_timeseries),
    "storm_grid": (storm_grid_data, draw_storm_grid),
    "climate_grid": (climate_grid_data, draw_climate_grid),
    "big_grid": (lambda s, g, o: big_grid_data(s, g), draw_big_grid),
    "rapsd": (lambda s, g, o: rapsd_data(s, g, obs=o), draw_rapsd),
    "calibration": (lambda s, g, o: calibration_data(s, g, obs=o), draw_calibration),
    "windpower": (lambda s, g, o: windpower_data(s, g), draw_windpower),
    "windpower_dist": (lambda s, g, o: windpower_dist_data(s, g), draw_windpower_dist),
}


def kind_data(kind: str, samples: List[GridDataset], gt: GridDataset, obs: GridDataset):
    """The arrays figure ``kind`` of :data:`KINDS` shows, without drawing."""
    return _PARTS[kind][0](samples, gt, obs)


def figure_data(kind: str, exp_dir: str, compare: Optional[List[str]] = None):
    """The arrays of figure ``kind`` for an experiment directory (and, for
    ``downscaled_clim_dist``, the directories of ``compare``)."""
    if kind == "downscaled_clim_dist":
        dirs = [exp_dir] + list(compare or [])
        return downscaled_clim_dist_data(dirs, [pathlib.Path(d).name for d in dirs])
    return kind_data(kind, *exputil.setup(exp_dir))


def make(kind: str, exp_dir: str, out_dir: Optional[str] = None, compare: Optional[List[str]] = None) -> str:
    """Draw figure ``kind`` of the experiment in ``exp_dir`` into ``out_dir``
    (default ``exp_dir/figures``); returns its path. Without matplotlib it
    raises before reading or writing anything."""
    valid = sorted(KINDS) + ["downscaled_clim_dist"]
    if kind not in valid:
        raise ValueError(f"Unknown figure kind {kind!r}; options: {valid}")
    _plt()
    data = figure_data(kind, exp_dir, compare)
    out_dir = out_dir or str(pathlib.Path(exp_dir) / "figures")
    os.makedirs(out_dir, exist_ok=True)
    draw = draw_downscaled_clim_dist if kind == "downscaled_clim_dist" else _PARTS[kind][1]
    path = draw(data, out_dir)
    print(f"Saved {path}")
    return path
