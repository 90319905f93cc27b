"""Statistical-fidelity acceptance harness (port of
climate2weather_tpu/exp/fidelity.py).

One command runs the on-model-eval protocol on a snapshot:

1. guided downscaling of a held-out window, conditioned on its own coarsened
   ground truth (``exp/configs/000_on-model-eval/s16_t6.yml``'s setup);
2. an unconditional ensemble of the same shape, the control that guided
   sampling must beat on W2 and SSIM;
3. the metrics of both (:func:`climate2weather_tpu_torch.exp.metrics.run`);
4. the guided run's figures (``exp/figures.py``: seven kinds, into
   ``guided/<run>/figures/``), unless ``skip_figures``; a figure that fails
   (matplotlib absent, say) is printed and the numbers stand;
5. a ``FIDELITY.md`` table.

Both runs go through the port's :func:`~climate2weather_tpu_torch.exp.downscaling.run`,
their configs written with the stdlib YAML writer.

    python -m climate2weather_tpu_torch.exp.fidelity --snapshot SNAP --data-nc DATA.nc \\
        --quantiles Q.nc --out OUT --start-time 2014-01-07-00 [--skip-figures] [--device cpu]

(also ``python -m climate2weather_tpu_torch.experiment fidelity ...``).
"""

from __future__ import annotations

import argparse
import os
import pathlib
import shutil
from typing import Optional, Sequence

import numpy as np
import torch

from climate2weather_tpu_torch.exp import downscaling, figures, metrics
from climate2weather_tpu_torch.io.snapshot import yaml_dump_file

# the figure kinds drawn for the guided run, in JAX's order
FIGURE_KINDS = ("kde_and_pmf", "rapsd", "timeseries", "storm_grid", "windpower_dist", "climate_grid",
                "calibration")
# the reference-tuned likelihood hyperparameters (s16_t6.yml)
DEFAULT_STD = [0.1692666615037876, 0.0425178630338289, 0.3268027589410125, 0.3268027589410125]
DEFAULT_GAMMA = 0.0007196856730011522


def _predict(out_dir: str, cfg: dict, device, compute_dtype) -> pathlib.Path:
    os.makedirs(out_dir, exist_ok=True)
    cfg_path = os.path.join(out_dir, "config.yml")
    yaml_dump_file(cfg, cfg_path)
    return downscaling.run(out_dir, cfg_path, device, compute_dtype=compute_dtype)


def _fmt(vals) -> str:
    return f"{np.mean(vals):.4f} ± {np.std(vals):.4f}"


def run(
    snapshot: str,
    data_nc: str,
    quantiles: str,
    out: str,
    start_time: str,
    num_hours: int = 49,
    num_samples: int = 30,
    num_sampling_steps: int = 256,
    corrections: int = 0,
    correction_tau: float = 0.5,
    corrector_variance_exact: bool = False,
    ensemble_batch: int = 3,
    batch_size: int = 128,
    t_step: int = 6,
    s_step: int = 16,
    data_vars: Sequence[str] = ("psl", "tas", "uas", "vas"),
    likelihood_std: Optional[Sequence[float]] = None,
    likelihood_gamma=DEFAULT_GAMMA,  # a scalar or one value per channel
    guidance_prolong: bool = False,
    guidance_anneal: float = 0.0,
    t0_project: str = "",
    t0_project_iters: int = 3,
    guidance_off: bool = False,
    spectral_calibrate: str = "",
    uncond_samples: Optional[int] = None,
    seed: int = 0,
    skip_figures: bool = False,
    denoise_final: bool = False,
    sampler_kind: str = "pc",
    sde_eta: float = 0.0,
    device="cuda",
    compute_dtype: torch.dtype = torch.bfloat16,
) -> dict:
    """The guided run and the unconditional control under ``out``, the
    metrics of both, the guided run's figures (unless ``skip_figures``) and
    ``out/FIDELITY.md``; returns ``{"guided": scores, "uncond": scores,
    "guided_dir": ..., "uncond_dir": ...}``. Arguments as in JAX; both runs
    are on the card unless ``device="cpu"``, with the network in
    ``compute_dtype``."""
    out_path = pathlib.Path(out)
    out_path.mkdir(parents=True, exist_ok=True)
    base = dict(
        model_path=snapshot,
        data_path=data_nc,
        quantile_path=quantiles,
        start_time=start_time,
        num_hours=int(num_hours),
        data_norm_mode="quant95",
        data_vars=list(data_vars),
        num_sampling_steps=int(num_sampling_steps),
        num_corrections=int(corrections),
        correction_tau=float(correction_tau),
        corrector_variance_exact=bool(corrector_variance_exact),
        t_step=int(t_step),
        s_step=int(s_step),
        batch_size=int(batch_size),
        ensemble_batch=int(ensemble_batch),
        seed=int(seed),
        use_exact_grad=False,
        denoise_final=bool(denoise_final),
        sampler_kind=str(sampler_kind),
        sde_eta=float(sde_eta),
    )

    print("=== guided (on-model-eval conditioning) ===")
    guided_dir = _predict(
        str(out_path / "guided"),
        dict(
            base,
            observation_path=data_nc,
            likelihood_std=list(likelihood_std or DEFAULT_STD),
            likelihood_gamma=(list(likelihood_gamma) if isinstance(likelihood_gamma, (list, tuple))
                              else float(likelihood_gamma)),
            guidance_prolong=bool(guidance_prolong),
            guidance_anneal=float(guidance_anneal),
            t0_project=str(t0_project),
            t0_project_iters=int(t0_project_iters),
            guidance_off=bool(guidance_off),
            spectral_calibrate=str(spectral_calibrate),
            num_samples=int(num_samples),
        ),
        device, compute_dtype,
    )

    print("=== unconditional control ===")
    uncond_dir = _predict(
        str(out_path / "uncond"),
        dict(base, observation_path=None, num_samples=int(uncond_samples or max(8, num_samples // 2))),
        device, compute_dtype,
    )
    # the metrics take their comparison times from an observation grid; the
    # unconditional run writes none, so it borrows the guided run's (the
    # same window and grid)
    if not (pathlib.Path(uncond_dir) / "observation.nc").exists():
        for name in ("observation.nc", "ground_truth.nc"):
            shutil.copy(pathlib.Path(guided_dir) / name, pathlib.Path(uncond_dir) / name)

    print("=== metrics: guided ===")
    m_guided = metrics.run(str(guided_dir))
    print("=== metrics: unconditional ===")
    m_uncond = metrics.run(str(uncond_dir))

    if not skip_figures:
        for kind in FIGURE_KINDS:
            try:
                figures.make(kind, str(guided_dir))
            except Exception as e:  # figures must not block the numbers
                print(f"figure {kind} failed: {type(e).__name__}: {e}")

    lines = [
        "# Statistical fidelity report",
        "",
        f"- snapshot: `{snapshot}`",
        f"- workload: {num_hours} h from {start_time}, {num_samples} guided "
        f"samples, {num_sampling_steps} steps, s_step={s_step}, "
        f"t_step={t_step} (reference on-model-eval protocol, "
        "exp/configs/000_on-model-eval/s16_t6.yml"
        + (f", sampler={sampler_kind}" if sampler_kind != "pc" else "")
        + (f", sde_eta={sde_eta}" if sde_eta else "")
        + (", final-denoise" if denoise_final else "")
        + (f", {corrections} Langevin correction(s) tau={correction_tau}"
           + (", variance-exact noise" if corrector_variance_exact else "")
           if corrections else "") + ")",
        "- metrics protocol: observation time grid, gt-standardized "
        "sliced W2 (100 proj.), MELR over RAPSD, SSIM "
        "(reference exp/metrics.py:219-296)",
        f"- likelihood hparams: sigma={list(likelihood_std or DEFAULT_STD)}, "
        f"gamma={likelihood_gamma}"
        + (", prolong (scale-selective) guidance" if guidance_prolong else "")
        + (f", anneal t_rel={guidance_anneal} (gamma(t) release)" if guidance_anneal else "")
        + (", guidance OFF (projection-only)" if guidance_off else "")
        + (f", t0-projection method={t0_project} iters={t0_project_iters}" if t0_project else "")
        + (f", climatological spectral calibration ({spectral_calibrate})" if spectral_calibrate else ""),
        "",
        "| metric | variable | guided | unconditional | interp. obs baseline |",
        "|---|---|---|---|---|",
    ]
    for kind in ("wasserstein", "melr", "ssim", "crps", "spread_skill", "rank_reliability"):
        for v in sorted(m_guided.get(kind, {})):
            bl = m_guided[kind][v].get("interp_baseline")
            uc = m_uncond.get(kind, {}).get(v, {}).get("global")
            lines.append(
                f"| {kind} | {v} | {_fmt(m_guided[kind][v]['global'])} "
                f"| {_fmt(uc) if uc is not None else 'n/a'} "
                f"| {_fmt(bl) if bl is not None else 'n/a'} |"
            )
    lines += [
        "",
        "Guided sampling must beat the unconditional control on W2 and SSIM "
        "(it is conditioned on coarsened truth); MELR measures spectral "
        "fidelity: guided must stay near the unconditional model's spectrum "
        "(both should be small) while beating the interpolated-observation "
        "baseline, which has no power above the observation Nyquist.",
        f"\nFigures: `{guided_dir}/figures/`",
    ]
    report = out_path / "FIDELITY.md"
    report.write_text("\n".join(lines) + "\n")
    print(f"Wrote {report}")
    return {"guided": m_guided, "uncond": m_uncond, "guided_dir": str(guided_dir), "uncond_dir": str(uncond_dir)}


def add_arguments(ap: argparse.ArgumentParser) -> argparse.ArgumentParser:
    """The harness's options (JAX's, and the port's ``--device``) on ``ap``."""
    ap.add_argument("--snapshot", required=True)
    ap.add_argument("--data-nc", required=True)
    ap.add_argument("--quantiles", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--start-time", required=True)
    ap.add_argument("--num-hours", default=49, type=int)
    ap.add_argument("--num-samples", default=30, type=int)
    ap.add_argument("--num-sampling-steps", default=256, type=int)
    ap.add_argument("--corrections", default=0, type=int, help="Langevin corrector steps per predictor step")
    ap.add_argument("--correction-tau", default=0.5, type=float)
    ap.add_argument("--corrector-variance-exact", action="store_true",
                    help="variance-exact Langevin corrector noise (steprules.langevin_noise_scale)")
    ap.add_argument("--ensemble-batch", default=3, type=int)
    ap.add_argument("--uncond-samples", default=None, type=int)
    ap.add_argument("--seed", default=0, type=int)
    ap.add_argument("--skip-figures", action="store_true",
                    help="draw no figures (they need matplotlib on this host)")
    ap.add_argument("--denoise-final", action="store_true",
                    help="an extra score pass at t=0 removes the sigma(0) = eta residual noise")
    ap.add_argument("--sampler-kind", default="pc", choices=["pc", "dpmpp2m", "dpmpp3m"],
                    help="reverse-process solver of both ensembles")
    ap.add_argument("--sde-eta", default=0.0, type=float,
                    help="SDE-DPM-Solver++(2M) noise strength (dpmpp2m only)")
    ap.add_argument("--likelihood-std", action="append", type=float,
                    help="per-channel guidance sigma (repeat 4x; default: the COSMO-tuned values)")
    ap.add_argument("--likelihood-gamma", action="append", type=float,
                    help="guidance gamma: once for a scalar, 4x per channel (default: the COSMO value)")
    ap.add_argument("--guidance-prolong", action="store_true",
                    help="spread the likelihood residual with the spectral prolongation instead of "
                         "the exact block adjoint")
    ap.add_argument("--guidance-anneal", default=0.0, type=float,
                    help="release time t_rel: the likelihood gradient weighted by min(t/t_rel, 1); 0 = off")
    ap.add_argument("--t0-project", default="", choices=["", "spectral", "block"],
                    help="t=0 data-consistency projection of each sample onto {x : A(x) = y}; empty = off")
    ap.add_argument("--t0-project-iters", default=3, type=int)
    ap.add_argument("--guidance-off", action="store_true",
                    help="sample the conditioned ensemble without likelihood guidance")
    ap.add_argument("--spectral-calibrate", default="",
                    help="the training normed h5: rescale each sample's out-of-band annuli to its climatology")
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    return ap


def build_parser() -> argparse.ArgumentParser:
    return add_arguments(argparse.ArgumentParser(prog="python -m climate2weather_tpu_torch.exp.fidelity",
                                                 description=__doc__.splitlines()[0]))


def run_from_args(kw: dict) -> dict:
    """:func:`run` from the parsed options of :func:`add_arguments`."""
    std = kw.pop("likelihood_std") or None
    gamma = kw.pop("likelihood_gamma") or []
    gamma = DEFAULT_GAMMA if not gamma else float(gamma[0]) if len(gamma) == 1 else list(gamma)
    return run(likelihood_std=list(std) if std else None, likelihood_gamma=gamma, **kw)


def main(argv=None) -> int:
    run_from_args(vars(build_parser().parse_args(argv)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
