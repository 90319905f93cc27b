"""Evaluation metrics (port of climate2weather_tpu/exp/metrics.py): sliced
Wasserstein, RAPSD, MELR, SSIM, and the ensemble-calibration scores (fair
CRPS, spread/skill ratio, rank histogram and its reliability index).

Host numpy, as in JAX, computed per variable over sample ensembles on the
observation time grid. ``run`` reads an experiment directory through the
port's ``exputil.setup`` (``data/grid.open_grid``, so no h5py) and pickles
the scores to ``<exp_dir>/metrics/run/metrics.pickle``; ``load`` prints
them. SSIM's uniform window is :func:`box_filter`, a numpy copy of
``scipy.ndimage.uniform_filter`` with its default ``reflect`` borders, so
nothing here needs scipy.
"""

from __future__ import annotations

import hashlib
import pathlib
import pickle
from typing import Dict, Optional

import numpy as np


def _ensemble_fingerprint(samples: np.ndarray) -> str:
    """Shape + content digest of a stacked sample ensemble [S, T, H, W]."""
    h = hashlib.blake2b(digest_size=16)
    arr = np.ascontiguousarray(samples, np.float32)
    h.update(str(arr.shape).encode())
    for s in arr:  # stream per sample: no whole-ensemble byte copy
        h.update(s.tobytes())
    return h.hexdigest()


# ---------------------------------------------------------------------------
# sliced Wasserstein


def sliced_wasserstein_distance(
    X: np.ndarray, Y: np.ndarray, n_projections: int = 100, seed: int = 0, p: int = 2
) -> float:
    """Sliced W_p between two point clouds X [n, d], Y [m, d]."""
    X = np.asarray(X, np.float64)
    Y = np.asarray(Y, np.float64)
    d = X.shape[1]
    rng = np.random.RandomState(seed)
    proj = rng.normal(size=(d, n_projections))
    proj /= np.linalg.norm(proj, axis=0, keepdims=True)
    Xp = X @ proj  # [n, P]
    Yp = Y @ proj  # [m, P]
    Xp.sort(axis=0)
    Yp.sort(axis=0)
    if X.shape[0] != Y.shape[0]:
        # quantile alignment for unequal sample counts
        qs = (np.arange(max(X.shape[0], Y.shape[0])) + 0.5) / max(
            X.shape[0], Y.shape[0]
        )
        Xp = np.stack([np.interp(qs, (np.arange(len(Xp)) + 0.5) / len(Xp), Xp[:, i]) for i in range(Xp.shape[1])], 1)
        Yp = np.stack([np.interp(qs, (np.arange(len(Yp)) + 0.5) / len(Yp), Yp[:, i]) for i in range(Yp.shape[1])], 1)
    cost = np.mean(np.abs(Xp - Yp) ** p, axis=0)  # [P]
    return float(np.mean(cost) ** (1.0 / p))


def compute_wasserstein_nd(
    sample_fields: np.ndarray, gt_fields: np.ndarray, n_projections: int = 100
) -> np.ndarray:
    """Per-sample sliced W2 between flattened space-time point clouds.

    ``sample_fields``: [S, T, H, W] ensemble; ``gt_fields``: [T, H, W].
    Each time step is a point in R^(H*W) (reference exp/metrics.py:13-44).
    """
    S, T = sample_fields.shape[:2]
    gt = gt_fields.reshape(T, -1)
    out = np.zeros(S)
    for s in range(S):
        out[s] = sliced_wasserstein_distance(
            sample_fields[s].reshape(T, -1), gt, n_projections=n_projections, seed=0
        )
    return out


# ---------------------------------------------------------------------------
# RAPSD


def rapsd(field: np.ndarray, d: float = 1.0, normalize: bool = True):
    """Radially averaged power spectral density of a square 2-D field.

    Returns (psd [L//2], freq [L//2]) following the pysteps convention:
    annulus r=0 is the DC bin; bin i collects wavenumbers with radius in
    [i - 0.5, i + 0.5); frequencies are fftfreq(L, d)[:L//2].
    """
    field = np.asarray(field, np.float64)
    L = field.shape[0]
    assert field.shape == (L, L), "rapsd expects a square field"
    F = np.fft.fftshift(np.fft.fft2(field))
    psd2 = np.abs(F) ** 2 / (L * L)

    yc, xc = L // 2, L // 2
    yy, xx = np.indices((L, L))
    r = np.sqrt((yy - yc) ** 2 + (xx - xc) ** 2)
    n_bins = L // 2
    # single-pass annulus means: bin i collects radius in [i-0.5, i+0.5)
    idx = np.round(r).astype(np.int64).ravel()
    counts = np.bincount(idx, minlength=n_bins)[:n_bins]
    sums = np.bincount(idx, weights=psd2.ravel(), minlength=n_bins)[:n_bins]
    psd = np.divide(sums, counts, out=np.zeros(n_bins), where=counts > 0)
    if normalize:
        total = psd.sum()
        if total > 0:
            psd = psd / total
    freq = np.fft.fftfreq(L, d=d)[:n_bins]
    freq[0] = 0.0
    return psd, freq


def rapsd_over_time(
    sample_fields: np.ndarray,
    gt_fields: np.ndarray,
    obs_fields: Optional[np.ndarray] = None,
    d: float = 6.0,
    obs_d_factor: float = 16.0,
) -> Dict[str, np.ndarray]:
    """RAPSD time series for an ensemble, its ground truth, and (optionally)
    the coarse observation (reference exp/metrics.py:50-112; d=6 km grid,
    obs at 16x coarser spacing)."""
    S, T = sample_fields.shape[:2]
    sample_psd = []
    gt_psd = []
    for t in range(T):
        sample_psd.append(
            np.stack([rapsd(sample_fields[s, t], d=d)[0] for s in range(S)])
        )
        psd, freq = rapsd(gt_fields[t], d=d)
        gt_psd.append(psd)
    out = dict(
        sample_rapsd_over_time=np.stack(sample_psd, axis=1),  # [S, T, K]
        gt_rapsd_over_time=np.stack(gt_psd),  # [T, K]
        wavelengths=1.0 / np.maximum(freq, 1e-12),
    )
    if obs_fields is not None and min(T, obs_fields.shape[0]) > 0:
        obs_psd = []
        ofreq = None
        for t in range(min(T, obs_fields.shape[0])):
            opsd, ofreq = rapsd(obs_fields[t], d=d * obs_d_factor)
            obs_psd.append(opsd)
        out["obs_rapsd_over_time"] = np.stack(obs_psd)
        out["obs_wavelengths"] = 1.0 / np.maximum(ofreq, 1e-12)
    return out


def _lerp_axis(arr: np.ndarray, coords: np.ndarray, axis: int) -> np.ndarray:
    """Linear interpolation of ``arr`` along ``axis`` at fractional index
    ``coords``, clamping at the edges."""
    n = arr.shape[axis]
    c = np.clip(coords, 0.0, n - 1.0)
    i0 = np.floor(c).astype(np.int64)
    i1 = np.minimum(i0 + 1, n - 1)
    frac = c - i0
    a0 = np.take(arr, i0, axis=axis)
    a1 = np.take(arr, i1, axis=axis)
    shape = [1] * arr.ndim
    shape[axis] = len(coords)
    return a0 + (a1 - a0) * frac.reshape(shape)


def upsample_observation(
    fields: np.ndarray, H: int, W: int, method: str = "bilinear"
) -> np.ndarray:
    """Upsample coarse observation fields [T, h, w] to the fine grid [T, H, W].

    This is the no-model downscaling baseline the guided sampler must beat on
    spectral fidelity: interpolation carries no energy above the observation's
    Nyquist wavenumber, so its fine-grid RAPSD collapses at high wavenumbers
    while the diffusion ensemble must reproduce the ground-truth spectrum.

    Coordinates are aligned with the avg-pool observation operator
    (diffusion/guidance.py): coarse pixel ``i`` is the mean of the ``s``-wide
    fine block starting at ``s*i``, so its center sits at fine coordinate
    ``s*i + (s-1)/2``.
    """
    fields = np.asarray(fields, np.float64)
    T, h, w = fields.shape
    sy, sx = H // h, W // w
    assert sy * h == H and sx * w == W, (
        f"observation grid {h}x{w} does not divide the target {H}x{W}"
    )
    if method == "nearest":
        return np.repeat(np.repeat(fields, sy, axis=1), sx, axis=2)
    assert method == "bilinear", method
    ys = (np.arange(H) - (sy - 1) / 2.0) / sy
    xs = (np.arange(W) - (sx - 1) / 2.0) / sx
    return _lerp_axis(_lerp_axis(fields, ys, axis=1), xs, axis=2)


def melr(
    sample_rapsd_over_time: np.ndarray,
    gt_rapsd_over_time: np.ndarray,
    do_weighted: bool = False,
    do_max: bool = False,
    skip_dc: bool = True,
) -> np.ndarray:
    """Mean (over time) error in log ratio of spectra, per sample
    (reference exp/metrics.py:115-181).  Returns [S]."""
    assert int(do_weighted) + int(do_max) < 2
    S, T, K = sample_rapsd_over_time.shape
    assert gt_rapsd_over_time.shape == (T, K)
    k0 = 1 if skip_dc else 0
    sp = sample_rapsd_over_time[..., k0:]
    gp = gt_rapsd_over_time[..., k0:]
    log_ratio = np.abs(np.log(sp / gp[None]))  # [S, T, K']
    if do_max:
        idx = np.argmax(gp, axis=-1)  # [T]
        vals = log_ratio[:, np.arange(T), idx]
    elif do_weighted:
        w = gp / gp.sum(axis=-1, keepdims=True)
        vals = (log_ratio * w[None]).sum(-1)
    else:
        vals = log_ratio.mean(-1)
    return vals.mean(axis=1)


# ---------------------------------------------------------------------------
# SSIM


def box_filter(x: np.ndarray, size: int) -> np.ndarray:
    """The mean over a ``size``-wide window along every axis of ``x``:
    ``scipy.ndimage.uniform_filter(x, size)`` with its default
    ``mode="reflect"`` borders (the edge value repeated, d c b a | a b c d),
    as running sums of the symmetrically padded array, in float64."""
    out = np.asarray(x, np.float64)
    left = size // 2
    for axis in range(out.ndim):
        pad = [(0, 0)] * out.ndim
        pad[axis] = (left, size - 1 - left)
        c = np.cumsum(np.pad(out, pad, mode="symmetric"), axis=axis)
        c = np.concatenate([np.zeros_like(np.take(c, [0], axis=axis)), c], axis=axis)
        n = out.shape[axis]
        out = (np.take(c, np.arange(size, size + n), axis=axis)
               - np.take(c, np.arange(n), axis=axis)) / size
    return out


def ssim2d(
    a: np.ndarray,
    b: np.ndarray,
    data_range: float,
    win_size: int = 15,
    K1: float = 0.01,
    K2: float = 0.03,
) -> float:
    """Mean SSIM between two 2-D fields with a uniform window and sample
    covariance, cropped to valid windows (skimage semantics)."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    NP = win_size**2
    cov_norm = NP / (NP - 1)
    filt = lambda x: box_filter(x, win_size)  # noqa: E731
    ua, ub = filt(a), filt(b)
    uaa, ubb, uab = filt(a * a), filt(b * b), filt(a * b)
    va = cov_norm * (uaa - ua * ua)
    vb = cov_norm * (ubb - ub * ub)
    vab = cov_norm * (uab - ua * ub)
    C1 = (K1 * data_range) ** 2
    C2 = (K2 * data_range) ** 2
    num = (2 * ua * ub + C1) * (2 * vab + C2)
    den = (ua**2 + ub**2 + C1) * (va + vb + C2)
    s = num / den
    pad = (win_size - 1) // 2
    return float(s[pad:-pad, pad:-pad].mean())


def ssim_ensemble(sample_fields: np.ndarray, gt_fields: np.ndarray) -> np.ndarray:
    """Per-sample mean-over-time SSIM with the shared ensemble/gt data range
    (reference exp/metrics.py:187-212)."""
    S, T = sample_fields.shape[:2]
    data_range = float(
        max(gt_fields.max(), sample_fields.max())
        - min(gt_fields.min(), sample_fields.min())
    )
    out = np.zeros((S, T))
    for s in range(S):
        for t in range(T):
            out[s, t] = ssim2d(sample_fields[s, t], gt_fields[t], data_range)
    return out.mean(axis=1)


# ---------------------------------------------------------------------------
# Ensemble calibration: CRPS, spread-skill, rank histogram
#
# The reference repo scores W2/MELR/SSIM only (exp/metrics.py:219-296); the
# paper's probabilistic claims additionally rest on ensemble calibration,
# which these standard forecast-verification metrics quantify (SURVEY.md §7
# step 7 "paper-fidelity criteria").  All operate on the same stacked
# [S, T, H, W] ensembles / [T, H, W] truth as the metrics above.


def _mean_pairwise_absdiff(x: np.ndarray) -> np.ndarray:
    """Mean |x_i - x_j| over the S(S-1) ordered pairs i != j along axis 0.

    Uses the sorted-sum identity
    ``sum_{i<j} (x_(j) - x_(i)) = sum_k (2k - S - 1) x_(k)`` (1-indexed k),
    so cost is O(S log S) per point instead of O(S^2) memory.
    """
    S = x.shape[0]
    assert S >= 2
    xs = np.sort(np.asarray(x, np.float64), axis=0)
    k = np.arange(1, S + 1, dtype=np.float64).reshape((S,) + (1,) * (x.ndim - 1))
    return 2.0 * np.sum((2.0 * k - S - 1.0) * xs, axis=0) / (S * (S - 1))


def crps_ensemble(sample_fields: np.ndarray, gt_fields: np.ndarray) -> np.ndarray:
    """Fair (unbiased) ensemble CRPS, spatially averaged, per time step.

    ``CRPS = mean_s |x_s - y| - (1/2) * mean_{s != s'} |x_s - x_s'|``
    (the fair estimator of Ferro 2014: with the 1/(S(S-1)) pair term the
    expectation equals the CRPS of the underlying distribution for any
    ensemble size).  For S = 1 the pair term vanishes and CRPS degenerates
    to the MAE of the point forecast — used for the deterministic
    interpolated-observation baseline.

    ``sample_fields``: [S, T, H, W]; ``gt_fields``: [T, H, W].  Returns [T].
    """
    samples = np.asarray(sample_fields, np.float64)
    gt = np.asarray(gt_fields, np.float64)
    S, T = samples.shape[:2]
    out = np.zeros(T)
    for t in range(T):  # per-step to bound the fp64 working set
        mae = np.mean(np.abs(samples[:, t] - gt[t][None]), axis=0)
        if S > 1:
            spread = _mean_pairwise_absdiff(samples[:, t])
        else:
            spread = 0.0
        out[t] = float(np.mean(mae - 0.5 * spread))
    return out


def spread_skill_ratio(
    sample_fields: np.ndarray, gt_fields: np.ndarray
) -> np.ndarray:
    """Spread/skill ratio per time step; ~1 for a calibrated ensemble.

    skill = RMSE of the ensemble mean; spread = sqrt((S+1)/S * mean ensemble
    variance) — the (S+1)/S factor makes E[skill^2] = E[spread^2] exact for a
    perfectly reliable S-member ensemble (Fortin et al. 2014).

    Direction: ideal = 1.  < 1 means under-dispersion (overconfident
    ensemble), > 1 over-dispersion (e.g. the 2.5 of the untuned-guidance
    meso64 probes = guided ensemble 2.5x too wide).  Pinned by
    tests/test_calibration_metrics.py on a synthetic calibrated ensemble.
    """
    samples = np.asarray(sample_fields, np.float64)
    gt = np.asarray(gt_fields, np.float64)
    S, T = samples.shape[:2]
    assert S >= 2, "spread requires an ensemble"
    out = np.zeros(T)
    for t in range(T):
        mean = samples[:, t].mean(axis=0)
        skill_sq = np.mean((mean - gt[t]) ** 2)
        var = samples[:, t].var(axis=0, ddof=1)
        spread_sq = (S + 1) / S * np.mean(var)
        out[t] = float(np.sqrt(spread_sq / max(skill_sq, 1e-300)))
    return out


def rank_histogram(sample_fields: np.ndarray, gt_fields: np.ndarray) -> np.ndarray:
    """Counts of the truth's rank within the ensemble, over all (t, h, w).

    Rank k = number of ensemble members strictly below the truth; a reliable
    ensemble gives a flat histogram over the S+1 ranks.  Returns integer
    counts [S + 1].  Ties (exact float equality) are credited to the lower
    rank — negligible for continuous fields.

    Direction/shape: flat = calibrated; ∩ (center-heavy) = over-dispersed
    ensemble (truth rarely in the tails); ∪ = under-dispersed; sloped =
    biased.  Pinned by tests/test_calibration_metrics.py.
    """
    samples = np.asarray(sample_fields)
    gt = np.asarray(gt_fields)
    S = samples.shape[0]
    ranks = (samples < gt[None]).sum(axis=0)  # [T, H, W] in 0..S
    return np.bincount(ranks.ravel(), minlength=S + 1)


def reliability_index(hist_counts: np.ndarray) -> float:
    """Delta reliability index: sum_k |f_k - 1/(S+1)| over the normalized
    rank histogram (Delle Monache et al. 2006).

    Direction: LOWER is better; 0 = perfectly flat histogram (calibrated
    ensemble), 2·S/(S+1) → worst case (all mass in one rank bin).  In the
    meso64 probe tables guided ≈0.45-0.70 vs unconditional ≈0.07-0.39 is
    therefore guided being *worse*-calibrated — real miscalibration from
    the overdispersed untuned guidance (spread/skill ≈2.5, ∩-shaped rank
    histogram), not a metric bug; see docs/fidelity/MESOSCALE.md."""
    counts = np.asarray(hist_counts, np.float64)
    f = counts / counts.sum()
    return float(np.abs(f - 1.0 / len(f)).sum())


# ---------------------------------------------------------------------------
# experiment driver


def run(exp_dir: str, time_stride: int = 1) -> dict:
    """Compute all paper metrics for an experiment directory and pickle them
    to <exp_dir>/metrics/run/metrics.pickle (reference exp/metrics.py:219-296).

    ``time_stride`` subsamples the observation time grid (every Nth observed
    frame) — the scoring protocol for year-scale runs, where the full
    1457-frame grid is hours of host time for statistically indistinguishable
    means; the stride used is recorded in the pickle."""
    from climate2weather_tpu_torch.exp import exputil

    exp_dir = pathlib.Path(exp_dir)
    print(f"Running metrics on experiment {exp_dir}")
    out_dir = exp_dir / "metrics"
    out_dir.mkdir(exist_ok=True)
    save_path = out_dir / "run"
    save_path.mkdir(exist_ok=True)

    sample_ds, gt_ds, obs_ds = exputil.setup(str(exp_dir))
    # Compare on the observation time grid only (only this method downscales
    # temporally; reference exp/metrics.py:233-240)
    obs_times = obs_ds.time
    if time_stride > 1:
        obs_times = obs_times[::time_stride]
        print(f"Scoring every {time_stride}th observed frame "
              f"({len(obs_times)} frames)")
    gt_on_obs = _sel_times(gt_ds, obs_times)
    feature_names = sorted(gt_ds.data_vars)

    metrics: dict = {
        "wasserstein": {},
        "melr": {},
        "ssim": {},
        "crps": {},
        "spread_skill": {},
        "rank_reliability": {},
    }
    rapsd_dir = out_dir / "rapsd"
    rapsd_dir.mkdir(exist_ok=True)

    for v in feature_names:
        gt_da = gt_on_obs.data_vars[v]  # [T, H, W]
        samples = np.stack(
            [_sel_times(sd, obs_times).data_vars[v] for sd in sample_ds]
        )  # [S, T, H, W]

        gtmean, gtstd = gt_da.mean(), gt_da.std()
        # gt-standardized copies, shared by the W2 and calibration metrics
        # below (each copy is multi-GB at year scale — materialize once).
        samples_std = (samples - gtmean) / gtstd
        gt_std = (np.asarray(gt_da) - gtmean) / gtstd
        metrics["wasserstein"][v] = {
            "global": compute_wasserstein_nd(samples_std, gt_std)
        }

        # Cache keyed on the ensemble contents, not just the variable name:
        # re-running after adding samples or regenerating the ensemble must
        # not silently serve stale spectra.
        fp = _ensemble_fingerprint(samples)
        cache = rapsd_dir / f"{v}_rapsd.npz"
        r = None
        if cache.exists():
            loaded = dict(np.load(cache))
            if str(loaded.pop("ensemble_fingerprint", None)) == fp:
                r = loaded
        if r is None:
            r = rapsd_over_time(samples, gt_da, obs_ds.data_vars[v])
            np.savez(cache, ensemble_fingerprint=fp, **r)
        metrics["melr"][v] = {
            "global": melr(r["sample_rapsd_over_time"], r["gt_rapsd_over_time"])
        }
        metrics["ssim"][v] = {"global": ssim_ensemble(samples, gt_da)}

        # Calibration metrics (computed on gt-standardized fields so CRPS is
        # comparable across variables, like the W2 protocol above).
        metrics["crps"][v] = {"global": crps_ensemble(samples_std, gt_std)}
        if samples.shape[0] >= 2:
            metrics["spread_skill"][v] = {
                "global": spread_skill_ratio(samples_std, gt_std)
            }
            hist = rank_histogram(samples, gt_da)
            np.savez(save_path / f"{v}_rank_hist.npz", counts=hist)
            metrics["rank_reliability"][v] = {
                "global": np.array([reliability_index(hist)])
            }

        # Interpolated-observation baseline: the no-model downscaling the
        # ensemble must beat. Its MELR exposes the spectral gain — bilinear
        # upsampling has no power above the obs Nyquist, the guided ensemble
        # must carry the full ground-truth spectrum. (Extends the reference
        # protocol, which stores the obs RAPSD for plotting only,
        # exp/metrics.py:88-95.)
        obs_np = np.asarray(obs_ds.data_vars[v], np.float64)[::time_stride]
        H, W = np.asarray(gt_da).shape[-2:]
        if (
            obs_np.shape[0] == len(obs_times)
            and obs_np.shape[1] and obs_np.shape[2]
            and H % obs_np.shape[1] == 0
            and W % obs_np.shape[2] == 0
            and (obs_np.shape[1], obs_np.shape[2]) != (H, W)
        ):
            base = upsample_observation(obs_np, H, W)[None]  # [1, T, H, W]
            base_std = (base - gtmean) / gtstd
            metrics["wasserstein"][v]["interp_baseline"] = (
                compute_wasserstein_nd(base_std, gt_std)
            )
            rb = rapsd_over_time(base, gt_da)
            metrics["melr"][v]["interp_baseline"] = melr(
                rb["sample_rapsd_over_time"], rb["gt_rapsd_over_time"]
            )
            metrics["ssim"][v]["interp_baseline"] = ssim_ensemble(base, gt_da)
            # deterministic forecast: fair CRPS degenerates to its MAE
            metrics["crps"][v]["interp_baseline"] = crps_ensemble(
                base_std, gt_std
            )

    for metrictype in metrics:
        for var in feature_names:
            for k, val in metrics[metrictype].get(var, {}).items():
                print(
                    f"{metrictype} {var} {k}: "
                    f"{np.mean(val):.4f} \\pm {np.std(val):.4f}"
                )

    metrics["protocol"] = {"time_stride": int(time_stride),
                           "num_times": int(len(obs_times))}
    with open(save_path / "metrics.pickle", "wb") as f:
        pickle.dump(metrics, f)
    return metrics


def _sel_times(ds, times):
    sel = np.isin(ds.time, times)
    return ds.isel_time(np.nonzero(sel)[0])


def load(exp_dir: str) -> dict:
    """Pretty-print a previously computed metrics pickle
    (reference exp/metrics.py:299-319)."""
    path = pathlib.Path(exp_dir) / "metrics" / "run" / "metrics.pickle"
    with open(path, "rb") as f:
        metrics = pickle.load(f)
    for metrictype, by_var in metrics.items():
        print(metrictype)
        if metrictype == "protocol":
            for k, v in by_var.items():
                print(f"  {k}: {v}")
            print()
            continue
        for var, entries in by_var.items():
            print(f"  {var}")
            for k, v in entries.items():
                print(f"    {k}: {np.mean(v):.4f} \\pm {np.std(v):.4f}")
        print()
    return metrics
