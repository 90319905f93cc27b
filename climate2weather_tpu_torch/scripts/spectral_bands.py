"""Post-hoc band-restricted spectral diagnostic for a fidelity eval dir
(port of the JAX repository's ``scripts/spectral_bands.py``).

The uniform MELR in the gating tables averages |log(PSD_sample/PSD_gt)|
over *all* wavenumbers above DC, so one saturated band (e.g. a generation
noise floor at near-grid scales on a steep spectrum) can dominate the
score even when the meteorologically relevant scales are faithful. This
tool splits the same log-ratio error into three physically meaningful
bands so the PREREG fallback analysis can *name* the limiting mechanism:

  - obs-resolved:  wavelength >= 2 * d * s_step (the observation's Nyquist;
                   interpolation carries energy here, guidance pins it)
  - generative:    obs Nyquist > wavelength >= 4 * d (the scales a
                   downscaler must synthesize — the regime H1 is about)
  - grid-scale:    wavelength < 4 * d (finest octave, where sampler noise
                   floors and residual eta-variance live)

It is strictly POST-HOC and NON-GATING: it re-reads the rapsd caches
written by `exp.metrics.run` (guided + unconditional) and recomputes the
bilinear-interp baseline's RAPSD from the stored observation.nc /
ground_truth.nc — the pre-registered pipeline is untouched.

Usage::

    python -m climate2weather_tpu_torch.scripts.spectral_bands EVAL_DIR [EVAL_DIR ...] \
        [--d 6.0] [--s-step 16] [--out -]

EVAL_DIR is a fidelity output dir containing guided/001_config and
uncond/001_config.
"""

from __future__ import annotations

import argparse
import pathlib

import numpy as np

from climate2weather_tpu_torch.exp.metrics import rapsd_over_time, upsample_observation


def band_masks(wavelengths: np.ndarray, d: float, s_step: int):
    """Boolean masks (excluding DC) for the three bands, by wavelength."""
    wl = wavelengths.copy()
    wl[0] = np.inf  # DC
    obs_nyq = 2.0 * d * s_step
    grid4 = 4.0 * d
    not_dc = np.arange(len(wl)) > 0
    return {
        f"obs-resolved (λ≥{obs_nyq:g} km)": not_dc & (wl >= obs_nyq),
        f"generative ({grid4:g}≤λ<{obs_nyq:g} km)": not_dc
        & (wl < obs_nyq)
        & (wl >= grid4),
        f"grid-scale (λ<{grid4:g} km)": not_dc & (wl < grid4),
    }


def banded_melr(sample_psd: np.ndarray, gt_psd: np.ndarray, mask: np.ndarray):
    """Mean |log(PSD_s/PSD_gt)| over the masked bins, time, and samples."""
    if not mask.any():
        return float("nan")
    lr = np.abs(np.log(sample_psd[..., mask] / gt_psd[None][..., mask]))
    return float(lr.mean())


def load_case(cfg_dir: pathlib.Path, var: str, d: float):
    """(sample_psd [S,T,K], gt_psd [T,K], wavelengths [K]) for one run."""
    cache = dict(np.load(cfg_dir / "metrics" / "rapsd" / f"{var}_rapsd.npz"))
    return (
        cache["sample_rapsd_over_time"],
        cache["gt_rapsd_over_time"],
        cache["wavelengths"],
    )


def baseline_psd(cfg_dir: pathlib.Path, var: str, d: float):
    """Bilinear-interp baseline RAPSD recomputed from the stored nc files."""
    from climate2weather_tpu_torch.data.grid import open_grid

    gt_ds = open_grid(str(cfg_dir / "ground_truth.nc"))
    obs_ds = open_grid(str(cfg_dir / "observation.nc"))
    gt = np.asarray(gt_ds.data_vars[var], np.float64)
    obs = np.asarray(obs_ds.data_vars[var], np.float64)
    obs_times = np.asarray(obs_ds.time)
    gt_times = np.asarray(gt_ds.time)
    sel = np.isin(gt_times, obs_times)
    # mirror metrics.run's coverage gate: a time-dtype or coverage mismatch
    # would silently misalign baseline frames against the gt (ADVICE r4)
    if sel.sum() != obs.shape[0]:
        raise SystemExit(
            f"{cfg_dir}: ground_truth covers {int(sel.sum())} of "
            f"{obs.shape[0]} observation times — cannot align the interp "
            "baseline RAPSD"
        )
    gt = gt[sel]
    H, W = gt.shape[-2:]
    if obs.shape[1:] == (H, W) or H % obs.shape[1] or W % obs.shape[2]:
        return None
    base = upsample_observation(obs, H, W)[None]
    r = rapsd_over_time(base, gt, d=d)
    return r["sample_rapsd_over_time"], r["gt_rapsd_over_time"], r["wavelengths"]


def main(argv=None) -> None:
    p = argparse.ArgumentParser(prog="python -m climate2weather_tpu_torch.scripts.spectral_bands")
    p.add_argument("eval_dirs", nargs="+")
    p.add_argument("--d", type=float, default=6.0, help="fine grid spacing, km")
    p.add_argument("--s-step", type=int, default=16)
    p.add_argument(
        "--vars", nargs="*", default=("psl", "tas", "uas", "vas"), dest="variables"
    )
    a = p.parse_args(argv)

    print("# Band-restricted spectral error (post-hoc, non-gating)")
    print()
    print(
        "Mean |log(PSD/PSD_gt)| per wavelength band; same log-ratio error "
        "as the gating MELR, split by scale."
    )
    for ed in a.eval_dirs:
        ed = pathlib.Path(ed)
        print(f"\n## {ed}\n")
        print("| variable | source | " + " | ".join(
            band_masks(np.array([np.inf, 1.0]), a.d, a.s_step).keys()
        ) + " |")
        print("|---|---|---|---|---|")
        for var in a.variables:
            rows = {}
            for label, sub in (("guided", "guided"), ("unconditional", "uncond")):
                cfg = ed / sub / "001_config"
                if not cfg.exists():
                    continue
                sp, gp, wl = load_case(cfg, var, a.d)
                masks = band_masks(wl, a.d, a.s_step)
                rows[label] = [banded_melr(sp, gp, m) for m in masks.values()]
            b = baseline_psd(ed / "guided" / "001_config", var, a.d)
            if b is not None:
                sp, gp, wl = b
                masks = band_masks(wl, a.d, a.s_step)
                rows["interp baseline"] = [
                    banded_melr(sp, gp, m) for m in masks.values()
                ]
            for label, vals in rows.items():
                cells = " | ".join(f"{x:.3f}" for x in vals)
                print(f"| {var} | {label} | {cells} |")


if __name__ == "__main__":
    main()
