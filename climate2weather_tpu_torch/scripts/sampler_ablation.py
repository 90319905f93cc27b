"""Sampler-knob ablation matrix on one snapshot: corrector and SDE levers
(port of the JAX repository's ``scripts/sampler_ablation.py``).

Runs the guided fidelity probe (exp/fidelity.py protocol: observation-grid
W2 / MELR / SSIM + calibration metrics) for a matrix of sampler settings
and prints one comparison table.  The round-2/3 study
(docs/fidelity/FIDELITY.md) measured the Langevin-corrector trade-off —
distributional/spectral calibration vs structural fidelity — with the
unadjusted Euler-Maruyama corrector; this driver extends it with the two
round-3 levers:

- ``variance-exact corrector noise`` (steprules.langevin_noise_scale):
  same mixing, no stationary-variance overshoot;
- ``SDE-DPM-Solver++(2M)`` (sde_eta): dispersion at zero extra evals.

Usage::

  python -m climate2weather_tpu_torch.scripts.sampler_ablation --snapshot SNAP --data-nc EVAL.nc \
      --quantiles Q.h5 --out runs/ablation --start-time 2014-01-07-00 \
      [--num-samples 6] [--steps 256] [--device cuda]
"""

from __future__ import annotations

import argparse
import json
import pathlib

import numpy as np

# (name, fidelity.run kwargs)
MATRIX = [
    ("pc_corr0", dict(corrections=0)),
    ("pc_corr1_tau05_em", dict(corrections=1, correction_tau=0.05)),
    ("pc_corr1_tau05_ve", dict(corrections=1, correction_tau=0.05,
                               corrector_variance_exact=True)),
    ("pc_corr1_tau5_ve", dict(corrections=1, correction_tau=0.5,
                              corrector_variance_exact=True)),
    ("dpmpp2m64", dict(sampler_kind="dpmpp2m", num_sampling_steps=64)),
    ("dpmpp2m64_sde04", dict(sampler_kind="dpmpp2m", num_sampling_steps=64,
                             sde_eta=0.4)),
    ("dpmpp2m64_sde10", dict(sampler_kind="dpmpp2m", num_sampling_steps=64,
                             sde_eta=1.0)),
    # VERDICT r3 next-step 3: the equal-snapshot quality matrix validating
    # the DPM step-count headline — all at the final-eval protocol
    # (denoise_final), PC-256 vs DPM++(2M)-64 vs (3M)-48 vs sde_eta.
    ("pc256_dn", dict(corrections=0, num_sampling_steps=256,
                      denoise_final=True)),
    ("dpmpp2m64_dn", dict(sampler_kind="dpmpp2m", num_sampling_steps=64,
                          denoise_final=True)),
    ("dpmpp3m48_dn", dict(sampler_kind="dpmpp3m", num_sampling_steps=48,
                          denoise_final=True)),
    ("dpmpp2m64_sde01_dn", dict(sampler_kind="dpmpp2m",
                                num_sampling_steps=64, sde_eta=0.1,
                                denoise_final=True)),
    ("dpmpp2m64_sde03_dn", dict(sampler_kind="dpmpp2m",
                                num_sampling_steps=64, sde_eta=0.3,
                                denoise_final=True)),
    # round-4 additions: the swept per-channel gamma composed with SDE —
    # the configuration that puts guided wind MELR below the unconditional
    # spectrum (docs/fidelity/ABLATION.md finding 3). gamma values are the
    # sweep winner (docs/fidelity/sweep_meso64/RANKING.md trial 112).
    ("tuned_sde01_dn", dict(sampler_kind="dpmpp2m", num_sampling_steps=64,
                            sde_eta=0.1, denoise_final=True,
                            likelihood_gamma=[0.003, 0.003, 0.04, 0.01])),
    ("tuned_sde03_dn", dict(sampler_kind="dpmpp2m", num_sampling_steps=64,
                            sde_eta=0.3, denoise_final=True,
                            likelihood_gamma=[0.003, 0.003, 0.04, 0.01])),
]


def run_matrix(args) -> dict:
    from climate2weather_tpu_torch.exp.fidelity import run as fidelity_run

    out_root = pathlib.Path(args.out)
    out_root.mkdir(parents=True, exist_ok=True)
    results = {}
    for name, extra in MATRIX:
        if args.only and name not in args.only:
            continue
        extra = dict(extra)  # .pop below must not mutate the module matrix
        if getattr(args, "likelihood_std", None):
            extra.setdefault("likelihood_std", list(args.likelihood_std))
        if getattr(args, "likelihood_gamma", None) is not None:
            extra.setdefault("likelihood_gamma", args.likelihood_gamma)
        out = out_root / name
        print(f"=== ablation: {name} ===", flush=True)
        try:
            r = fidelity_run(
                snapshot=args.snapshot,
                data_nc=args.data_nc,
                quantiles=args.quantiles,
                out=str(out),
                start_time=args.start_time,
                num_samples=args.num_samples,
                num_sampling_steps=extra.pop(
                    "num_sampling_steps", args.steps
                ),
                uncond_samples=2,  # progression-style probe: guided focus
                skip_figures=True,
                seed=args.seed,
                device=args.device,
                **extra,
            )
            results[name] = r["guided"]
        except Exception as e:  # a failed cell must not kill the matrix
            print(f"ablation cell {name} failed: {type(e).__name__}: {e}",
                  flush=True)
    return results


def summarize(results: dict) -> str:
    names = list(results)
    if not names:
        return "(no completed cells)"
    variables = sorted(next(iter(results.values()))["wasserstein"])
    lines = [
        "| setting | W2 (" + " / ".join(variables)
        + ") | MELR | SSIM | CRPS | spread/skill |",
        "|---|---|---|---|---|---|",
    ]
    for name in names:
        m = results[name]

        def row(kind):
            return " / ".join(
                f"{np.mean(m[kind][v]['global']):.2f}"
                if v in m.get(kind, {}) else "n/a"
                for v in variables
            )

        lines.append(
            f"| {name} | {row('wasserstein')} | {row('melr')} "
            f"| {row('ssim')} | {row('crps')} | {row('spread_skill')} |"
        )
    return "\n".join(lines)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="python -m climate2weather_tpu_torch.scripts.sampler_ablation")
    ap.add_argument("--snapshot", required=True)
    ap.add_argument("--data-nc", required=True)
    ap.add_argument("--quantiles", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--start-time", required=True)
    ap.add_argument("--num-samples", type=int, default=6)
    ap.add_argument("--steps", type=int, default=256)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--only", nargs="*", default=None,
                    help="subset of cell names to run")
    ap.add_argument("--likelihood-std", type=float, nargs="*", default=None,
                    help="per-channel sigma override (e.g. the swept optimum)")
    ap.add_argument("--likelihood-gamma", type=float, default=None)
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    results = run_matrix(args)
    table = summarize(results)
    print(table)
    out_root = pathlib.Path(args.out)
    (out_root / "ABLATION.md").write_text(
        "# Sampler-knob ablation\n\n"
        f"- snapshot: `{args.snapshot}`\n"
        f"- {args.num_samples} guided samples, PC rows at {args.steps} "
        f"steps, DPM rows at 64\n\n" + table + "\n"
    )
    summary = {
        name: {
            kind: {v: float(np.mean(d[v]["global"])) for v in d}
            for kind, d in m.items()
            if isinstance(m.get(kind), dict) and kind in
            ("wasserstein", "melr", "ssim", "crps", "spread_skill")
        }
        for name, m in results.items()
    }
    (out_root / "ablation.json").write_text(json.dumps(summary, indent=2))
    print(f"Wrote {out_root}/ABLATION.md")


if __name__ == "__main__":
    main()
