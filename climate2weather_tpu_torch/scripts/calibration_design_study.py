"""Offline post-processing design study on the saved seed-0 COSMO-guided
ensemble (port of the JAX repository's ``scripts/calibration_design_study.py``;
H7 follow-up; explicitly EXPLORATORY — the registered H7 verdict stands; this
study measures WHY (b) failed and designs H8).

Because climatological spectral calibration and the t=0 projection are pure
post-processes, their design space can be swept on SAVED samples without
re-sampling: each variant is applied in normalized space to the same 12
guided draws, then scored with the exact metrics protocol
(exp/metrics.py: obs-time grid, gt-standardized sliced W2, MELR over
RAPSD, ensemble-data-range SSIM) plus a FIXED-GT-RANGE SSIM readout that
decouples the SSIM stabilizer constants from the ensemble's amplitude
(ssim_ensemble shares data_range across ensemble∪gt — an over-amplitude
ensemble inflates C1/C2 and therefore its own score; reference parity,
exp/metrics.py:187-212).

Usage (host numpy only)::

    python -m climate2weather_tpu_torch.scripts.calibration_design_study \
        --guided-dir runs/uncal_guided/001_uncal_guided \
        --train-h5 runs/synth_meso128/train_normed.h5 \
        --out runs/design_study.md
"""

from __future__ import annotations

import argparse
import pathlib

import numpy as np

from climate2weather_tpu_torch.data import pipeline as data_pipeline
from climate2weather_tpu_torch.data.grid import open_grid
from climate2weather_tpu_torch.diffusion.calibrate import (
    annulus_index_map,
    climatological_annulus_psd,
    obs_square_mask,
)
from climate2weather_tpu_torch.exp.metrics import (
    compute_wasserstein_nd,
    melr,
    rapsd_over_time,
    ssim2d,
    ssim_ensemble,
    upsample_observation,
)

S_STEP, T_STEP = 16, 6
VARS = ("psl", "tas", "uas", "vas")


def np_project(x, y, iters=2):
    """Numpy mirror of SpatioTemporalCoarsening.project(method='spectral')
    on one [L, H, W, C] trajectory."""
    L, H, W, C = x.shape
    lo, h, w, _ = y.shape
    s = S_STEP

    def _gain(n_coarse, n_fine):
        k = np.fft.fftfreq(n_coarse) * n_coarse
        with np.errstate(invalid="ignore", divide="ignore"):
            d = np.sin(np.pi * k * s / n_fine) / (s * np.sin(np.pi * k / n_fine))
        d[k == 0] = 1.0
        return d * np.exp(1j * np.pi * k * (s - 1) / n_fine)

    D = np.fft.fftshift(np.outer(_gain(h, H), _gain(w, W)))[None, :, :, None]
    y0, x0 = (H - h) // 2, (W - w) // 2
    x = x.astype(np.float64).copy()
    for _ in range(iters):
        r = y - x[::T_STEP].reshape(lo, h, s, w, s, C).mean(axis=(2, 4))
        spec = np.fft.fftshift(np.fft.fft2(r, axes=(1, 2)), axes=(1, 2)) / D
        pad = np.zeros((lo, H, W, C), complex)
        pad[:, y0 : y0 + h, x0 : x0 + w, :] = spec
        up = np.fft.ifft2(np.fft.ifftshift(pad, axes=(1, 2)), axes=(1, 2)).real
        x[::T_STEP] += up * (s * s)
    return x


def np_calibrate(x, target, k_min=0, per_frame=True, max_gain=10.0):
    """Numpy mirror of calibrate_trajectory + design knobs: annuli below
    k_min untouched; per_frame=False uses one trajectory-mean gain per
    annulus (preserves frame-to-frame amplitude variability)."""
    L, H, W, C = x.shape
    idx, n_bins = annulus_index_map(H, W)
    outside = ~obs_square_mask(H, W, S_STEP)
    sel_mask = outside & (idx >= k_min)
    F = np.fft.fftshift(np.fft.fft2(x.astype(np.float64), axes=(1, 2)),
                        axes=(1, 2))
    p2 = np.abs(F) ** 2 / (H * W)  # [L, H, W, C]
    flat_idx = idx[sel_mask]
    counts = np.bincount(flat_idx, minlength=n_bins).astype(float)
    gains = np.ones((L, H, W, C))
    for c in range(C):
        pc = p2[..., c][:, sel_mask]  # [L, n_sel]
        if not per_frame:
            pc = pc.mean(axis=0, keepdims=True)  # [1, n_sel]
        sums = np.zeros((pc.shape[0], n_bins))
        for li in range(pc.shape[0]):
            np.add.at(sums[li], flat_idx, pc[li])
        p_a = np.divide(sums, counts, out=np.zeros_like(sums),
                        where=counts > 0)
        scale = np.minimum(
            np.sqrt(target[c][None] / np.maximum(p_a, 1e-20)), max_gain
        )  # [L or 1, n_bins]
        per_bin = scale[:, idx]  # [L or 1, H, W]
        g = np.where(sel_mask[None], per_bin, 1.0)
        gains[..., c] = g if per_frame else np.broadcast_to(g, (L, H, W))
    out = np.fft.ifft2(np.fft.ifftshift(F * gains, axes=(1, 2)),
                       axes=(1, 2)).real
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m climate2weather_tpu_torch.scripts.calibration_design_study")
    ap.add_argument("--guided-dir", required=True)
    ap.add_argument("--train-h5", required=True)
    ap.add_argument("--quantiles", default="runs/synth_meso128/quantiles.h5")
    ap.add_argument("--out", default="runs/design_study.md")
    args = ap.parse_args(argv)

    d = pathlib.Path(args.guided_dir)
    gt_ds = open_grid(str(d / "ground_truth.nc"))
    obs_ds = open_grid(str(d / "observation.nc"))
    sample_files = sorted(d.glob("gen_sample_*.nc"))
    print(f"{len(sample_files)} guided samples, vars {VARS}")

    # normalized NHWC stacks
    def to_nhwc(ds):
        ds_n = data_pipeline.normalize_ds(ds, args.quantiles, "quant95")
        return data_pipeline.nchw_to_nhwc(
            data_pipeline.ds_to_sorted_np(ds_n, list(VARS))
        )

    gt_n = to_nhwc(gt_ds)  # [L, H, W, C]
    obs_n = to_nhwc(obs_ds)  # [lo, h, w, C]
    samples_n = [to_nhwc(open_grid(str(f))) for f in sample_files]
    target = climatological_annulus_psd(args.train_h5, s_step=S_STEP)

    # physical-space ground truth / obs on the obs time grid, for metrics
    gt_phys = {v: np.asarray(gt_ds.data_vars[v])[::T_STEP] for v in VARS}
    obs_phys = {v: np.asarray(obs_ds.data_vars[v]) for v in VARS}

    def denorm_stack(traj_list):
        """normalized NHWC trajectories -> physical [S, T_obs, H, W] per var"""
        per_var = {v: [] for v in VARS}
        for x in traj_list:
            ds = data_pipeline.np_to_ds(
                data_pipeline.nhwc_to_nchw(x.astype(np.float32)),
                reference_ds=data_pipeline.normalize_ds(
                    gt_ds, args.quantiles, "quant95"
                ),
                data_vars=list(VARS),
            )
            ds = data_pipeline.unnormalize_ds(ds, args.quantiles, "quant95")
            for v in VARS:
                per_var[v].append(np.asarray(ds.data_vars[v])[::T_STEP])
        return {v: np.stack(a) for v, a in per_var.items()}

    variants = {
        "raw guided": lambda x: x,
        "projection only": lambda x: np_project(x, obs_n),
        "calib(full,per-frame) + proj": lambda x: np_project(
            np_calibrate(x, target), obs_n),
        "calib(k>=8) + proj": lambda x: np_project(
            np_calibrate(x, target, k_min=8), obs_n),
        "calib(k>=12) + proj": lambda x: np_project(
            np_calibrate(x, target, k_min=12), obs_n),
        "calib(k>=16) + proj": lambda x: np_project(
            np_calibrate(x, target, k_min=16), obs_n),
        "calib(traj-mean) + proj": lambda x: np_project(
            np_calibrate(x, target, per_frame=False), obs_n),
        "calib(traj-mean,k>=8) + proj": lambda x: np_project(
            np_calibrate(x, target, k_min=8, per_frame=False), obs_n),
    }

    lines = [
        "# Post-processing design study (seed-0 guided ensemble, "
        f"{len(sample_files)} samples — EXPLORATORY, designs H8)",
        "",
        "| variant | var | MELR | SSIM (protocol) | SSIM (gt-range) | W2 |",
        "|---|---|---|---|---|---|",
    ]
    summary = {}
    for name, fn in variants.items():
        treated = [fn(x) for x in samples_n]
        phys = denorm_stack(treated)
        for v in ("uas", "vas"):
            sm, gtv = phys[v], gt_phys[v]
            gtmean, gtstd = gtv.mean(), gtv.std()
            w2 = float(np.mean(compute_wasserstein_nd(
                (sm - gtmean) / gtstd, (gtv - gtmean) / gtstd)))
            r = rapsd_over_time(sm, gtv)
            ml = float(np.mean(melr(r["sample_rapsd_over_time"],
                                    r["gt_rapsd_over_time"])))
            ss = float(np.mean(ssim_ensemble(sm, gtv)))
            # fixed data range: the gt's own range (amplitude-decoupled)
            dr = float(gtv.max() - gtv.min())
            ss_fix = float(np.mean([
                np.mean([ssim2d(sm[s, t], gtv[t], dr)
                         for t in range(gtv.shape[0])])
                for s in range(sm.shape[0])
            ]))
            lines.append(
                f"| {name} | {v} | {ml:.3f} | {ss:.3f} | {ss_fix:.3f} "
                f"| {w2:.3f} |")
            summary[(name, v)] = (ml, ss, ss_fix, w2)
        print(lines[-2]); print(lines[-1])

    # interp baseline under both SSIM conventions
    for v in ("uas", "vas"):
        gtv = gt_phys[v]
        base = upsample_observation(
            obs_phys[v].astype(np.float64), *gtv.shape[-2:])[None]
        gtmean, gtstd = gtv.mean(), gtv.std()
        w2 = float(np.mean(compute_wasserstein_nd(
            (base - gtmean) / gtstd, (gtv - gtmean) / gtstd)))
        r = rapsd_over_time(base, gtv)
        ml = float(np.mean(melr(r["sample_rapsd_over_time"],
                                r["gt_rapsd_over_time"])))
        ss = float(np.mean(ssim_ensemble(base, gtv)))
        dr = float(gtv.max() - gtv.min())
        ss_fix = float(np.mean([ssim2d(base[0, t], gtv[t], dr)
                                for t in range(gtv.shape[0])]))
        lines.append(
            f"| interp baseline | {v} | {ml:.3f} | {ss:.3f} | {ss_fix:.3f} "
            f"| {w2:.3f} |")
        print(lines[-1])

    pathlib.Path(args.out).write_text("\n".join(lines) + "\n")
    print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
