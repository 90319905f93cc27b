"""Scored likelihood-hyperparameter sweep (port of the JAX repository's
``scripts/likelihood_sweep.py``; VERDICT r3 next-step 2).

``exp.downscaling.sweep_likelihood_hparams`` generates trial ensembles but
never scores them; this driver closes the loop: for each (sigma, gamma)
trial it generates the evaluation ensemble, runs the full metrics suite,
and appends a scored JSONL row, ending with a ranked summary table.

Protocol (anchored to the reference's tuning tool,
exp/downscaling.py:290-321, which exists because the published (sigma,
gamma) were tuned per-dataset on COSMO):

  * trial 0 is the reference's COSMO-tuned point (the round-3 eval config)
    so every other trial reads as a paired improvement/regression;
  * trials 1..N re-seed and draw from the published log-uniform search
    space via ``_draw_likelihood_hparams``;
  * all trials share the sampling seed, so ensembles differ only through
    the guidance hyperparameters (paired comparison);
  * score (lower = better) =
        log(mean_v W2_v/W2_interp_v) + log(mean_v MELR_v/MELR_interp_v)
        +  mean_v |log spread_skill_v|
    i.e. distributional + spectral skill normalized by the no-model
    interpolated-observation baseline (ratio < 1 beats it — the H1
    criterion) plus a calibration penalty (0 when spread/skill = 1);
  * conditioning constraint (VERDICT r4 weak-item 4: "turn the guidance
    off" was a near-optimum of the unconstrained composite): with
    ``--uncond``, one shared unconditional control ensemble (gamma-
    independent) is generated and scored once, and a trial is FEASIBLE
    only if, for every ``--gate-vars`` variable, guided SSIM beats the
    unconditional control's and guided W2 is below it — guidance must
    demonstrably condition the gated channels before its spectral score
    counts.  Infeasible trials rank below all feasible ones.

Run on the card (one process)::

    python -m climate2weather_tpu_torch.scripts.likelihood_sweep --out runs/sweep_meso64 \
        --config runs/sweep_meso64/base.yml --trials 24 [--device cuda]
"""

import argparse
import json
import pathlib
import pickle

import numpy as np

from climate2weather_tpu_torch.exp import downscaling, metrics as metrics_mod
from climate2weather_tpu_torch.io.snapshot import yaml_dump_file, yaml_load_file
from climate2weather_tpu_torch.utils.seeding import set_random_seed


def score_trial(exp_dir: pathlib.Path) -> dict:
    """Full metrics suite -> scalar summaries per variable + composite."""
    m = metrics_mod.run(str(exp_dir))
    out = {"per_var": {}}
    w2_ratios, melr_ratios, ss_pens = [], [], []
    for v in sorted(m["wasserstein"]):
        row = {}
        for name in ("wasserstein", "melr", "ssim", "crps"):
            row[name] = float(np.mean(m[name][v]["global"]))
            if "interp_baseline" in m[name][v]:
                row[name + "_interp"] = float(np.mean(m[name][v]["interp_baseline"]))
        row["spread_skill"] = float(np.mean(m["spread_skill"][v]["global"]))
        row["rank_reliability"] = float(np.mean(m["rank_reliability"][v]["global"]))
        out["per_var"][v] = row
        if "wasserstein_interp" not in row:
            # interp baseline rows exist only when the obs grid strictly
            # divides the fine grid (metrics.run); without them the composite
            # is undefined — fail the SWEEP loudly before burning the budget
            # on ensembles that can never be scored (ADVICE r4)
            raise SystemExit(
                f"metrics for {exp_dir} carry no interp_baseline rows "
                f"(variable {v}): the observation grid must strictly divide "
                "the fine grid for the sweep composite to be defined"
            )
        w2_ratios.append(row["wasserstein"] / row["wasserstein_interp"])
        melr_ratios.append(row["melr"] / row["melr_interp"])
        ss_pens.append(abs(np.log(row["spread_skill"])))
    out["w2_ratio"] = float(np.mean(w2_ratios))
    out["melr_ratio"] = float(np.mean(melr_ratios))
    out["calib_penalty"] = float(np.mean(ss_pens))
    # log scale so a 2x improvement counts the same for W2 and MELR (raw
    # W2/interp ratios are O(10-100) and would otherwise drown the rest)
    out["score"] = float(np.log(out["w2_ratio"]) + np.log(out["melr_ratio"])
                         + out["calib_penalty"])
    return out


def run_uncond_control(out: pathlib.Path, config_path: str,
                       num_samples: int, trial0_exp: pathlib.Path, device="cuda") -> dict:
    """One shared unconditional ensemble (gamma-independent) scored once;
    its per-variable W2/SSIM are the conditioning floors every trial must
    beat on the gated variables."""
    import shutil

    metrics_json = out / "uncond_metrics.json"
    if metrics_json.exists():
        return json.loads(metrics_json.read_text())
    cfg = yaml_load_file(config_path)
    cfg.pop("observation_path", None)  # no observation -> unconditional
    uncfg = out / "uncond_config.yml"
    yaml_dump_file(cfg, uncfg)
    exp_dir = pathlib.Path(downscaling.run(
        save_path=str(out / "uncond"), config_path=str(uncfg), device=device,
        num_samples=num_samples,
    ))
    # metrics need the observation/gt grids; the unconditional run saves
    # neither, so borrow trial 0's (same window, same grid)
    for nc in ("observation.nc", "ground_truth.nc"):
        if not (exp_dir / nc).exists():
            shutil.copy(trial0_exp / nc, exp_dir / nc)
    m = metrics_mod.run(str(exp_dir))
    floors = {
        v: {
            "ssim": float(np.mean(m["ssim"][v]["global"])),
            "wasserstein": float(np.mean(m["wasserstein"][v]["global"])),
            "melr": float(np.mean(m["melr"][v]["global"])),
        }
        for v in sorted(m["ssim"])
    }
    metrics_json.write_text(json.dumps(floors, indent=1))
    return floors


def trial_feasible(row: dict, floors: dict, gate_vars) -> bool:
    """Conditioning constraint: guided must beat the unconditional control
    on SSIM and W2 for every gated variable."""
    for v in gate_vars:
        pv = row.get("per_var", {}).get(v)
        if pv is None or v not in floors:
            return False
        if not (pv["ssim"] > floors[v]["ssim"]
                and pv["wasserstein"] < floors[v]["wasserstein"]):
            return False
    return True


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m climate2weather_tpu_torch.scripts.likelihood_sweep")
    ap.add_argument("--out", required=True)
    ap.add_argument("--config", required=True)
    ap.add_argument("--trials", type=int, default=24,
                    help="number of RANDOM trials; the COSMO-tuned reference "
                         "point always runs on top of these as trial 0, so "
                         "the total ensemble budget is trials+1 (ADVICE r4)")
    ap.add_argument("--num-samples", type=int, default=8)
    ap.add_argument("--base-seed", type=int, default=99)
    ap.add_argument("--start-trial", type=int, default=0,
                    help="resume a partial sweep (skips completed trials)")
    ap.add_argument("--point", action="append", default=None,
                    help="structured extra trial 's1,s2,s3,s4,g[,g2,g3,g4]' "
                         "(numbered from --point-base; repeatable; skips "
                         "the random draws)")
    ap.add_argument("--point-base", type=int, default=100)
    ap.add_argument("--guidance-prolong", action="store_true",
                    help="run every trial of this invocation with the "
                         "scale-selective prolong guidance (H2 formulation "
                         "axis; use distinct --point-base per formulation "
                         "when sharing an --out dir)")
    ap.add_argument("--guidance-anneal", type=float, default=0.0,
                    help="run every trial of this invocation with gamma(t) "
                         "release time t_rel (H4 formulation axis, "
                         "diffusion/guidance.py anneal); 0 = off")
    ap.add_argument("--uncond", action="store_true",
                    help="generate + score the shared unconditional control "
                         "and enforce the conditioning constraint at ranking")
    ap.add_argument("--uncond-samples", type=int, default=None)
    ap.add_argument("--gate-vars", default="uas,vas",
                    help="comma list of variables the conditioning "
                         "constraint applies to")
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    out = pathlib.Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    log_path = out / "sweep.jsonl"

    # trial 0: the reference's COSMO-tuned point (round-3 eval config values,
    # the reference's exp/configs/000_on-model-eval/s16_t6.yml:16-22)
    cosmo_sigma = (0.1692666615037876, 0.0425178630338289,
                   0.3268027589410125, 0.3268027589410125)
    cosmo_gamma = 0.0007196856730011522

    rows = []
    if log_path.exists():
        rows = [json.loads(l) for l in log_path.read_text().splitlines()]
    done = {r["trial"] for r in rows}

    if args.point:
        schedule = []
        for i, p in enumerate(args.point):
            vals = [float(x) for x in p.split(",")]
            # 5 values: per-channel sigma + scalar gamma; 8: + per-channel
            # gamma (guidance broadcasts gamma over channels already)
            assert len(vals) in (5, 8), p
            gamma = vals[4] if len(vals) == 5 else list(vals[4:])
            schedule.append((args.point_base + i, tuple(vals[:4]), gamma))
    else:
        schedule = [(n, None, None)
                    for n in range(args.start_trial, args.trials + 1)]

    for n, sigma, gamma in schedule:
        if n in done:
            continue
        if sigma is None and n == 0:
            sigma, gamma = cosmo_sigma, cosmo_gamma
        elif sigma is None:
            set_random_seed(args.base_seed, n)
            sigma, gamma = downscaling._draw_likelihood_hparams()
        print(f"=== trial {n}: sigma={sigma} gamma={gamma}", flush=True)
        trial_dir = out / "trials" / f"t{n:02d}"
        try:
            exp_dir = downscaling.run(
                save_path=str(trial_dir),
                config_path=args.config,
                device=args.device,
                likelihood_std=list(sigma),
                likelihood_gamma=gamma,
                guidance_prolong=bool(args.guidance_prolong),
                guidance_anneal=float(args.guidance_anneal),
                num_samples=args.num_samples,
            )
            row = {"trial": n, "sigma": list(sigma), "gamma": gamma,
                   "prolong": bool(args.guidance_prolong),
                   "anneal": float(args.guidance_anneal),
                   **score_trial(pathlib.Path(exp_dir))}
        except SystemExit:
            raise  # unscoreable protocol: abort before burning the budget
        except Exception as e:  # isolate failures like the reference sweep
            row = {"trial": n, "sigma": list(sigma), "gamma": gamma,
                   "prolong": bool(args.guidance_prolong),
                   "anneal": float(args.guidance_anneal),
                   "error": f"{type(e).__name__}: {e}"}
        rows.append(row)
        with open(log_path, "a") as f:
            f.write(json.dumps(row) + "\n")
        if "score" in row:
            print(f"  -> score {row['score']:.3f} (W2r {row['w2_ratio']:.3f} "
                  f"MELRr {row['melr_ratio']:.3f} calib {row['calib_penalty']:.3f})",
                  flush=True)

    floors = None
    if args.uncond:
        trial0 = sorted(out.glob("trials/t*/0*_*/observation.nc"))
        if not trial0:
            raise SystemExit(
                "--uncond needs at least one completed guided trial to "
                "borrow the observation/ground-truth grids from"
            )
        floors = run_uncond_control(
            out, args.config, args.uncond_samples or args.num_samples,
            trial0[0].parent, device=args.device,
        )

    gate_vars = [v.strip() for v in args.gate_vars.split(",") if v.strip()]
    ok = [r for r in rows if "score" in r]
    for r in ok:
        r["feasible"] = (trial_feasible(r, floors, gate_vars)
                         if floors is not None else None)
    # infeasible trials (guidance does nothing on the gated channels) rank
    # strictly below every feasible one, whatever their composite says
    ok.sort(key=lambda r: (r["feasible"] is False, r["score"]))

    def _fmt_gamma(g):
        return ("/".join(f"{x:.3g}" for x in g) if isinstance(g, list)
                else f"{g:.3g}")

    def _table_lines():
        yield ("| rank | trial | form | sigma | gamma | feasible | score "
               "| W2r | MELRr | calib |")
        yield "|---|---|---|---|---|---|---|---|---|---|"
        for i, r in enumerate(ok):
            sig = "/".join(f"{s:.3g}" for s in r["sigma"])
            form = "prolong" if r.get("prolong") else "adjoint"
            feas = {None: "n/a", True: "yes", False: "NO"}[r["feasible"]]
            yield (f"| {i+1} | {r['trial']} | {form} | {sig} | "
                   f"{_fmt_gamma(r['gamma'])} | {feas} | {r['score']:.3f} | "
                   f"{r['w2_ratio']:.3f} | {r['melr_ratio']:.3f} | "
                   f"{r['calib_penalty']:.3f} |")

    print()
    for line in _table_lines():
        print(line)
    with open(out / "RANKING.md", "w") as f:
        f.write("# Likelihood (sigma, gamma) sweep ranking\n\n")
        f.write("Trial 0 = reference COSMO-tuned point. Score = "
                "log mean W2/interp + log mean MELR/interp + mean "
                "|log spread_skill| (lower better; ratios < 1 beat the "
                "no-model baseline).\n")
        if floors is not None:
            f.write(f"\nConditioning constraint on {gate_vars}: guided SSIM "
                    "> unconditional AND guided W2 < unconditional "
                    "(shared control, `uncond_metrics.json`); infeasible "
                    "trials rank below all feasible ones.\n")
        f.write("\n")
        for line in _table_lines():
            f.write(line + "\n")
    with open(out / "sweep_rows.pickle", "wb") as f:
        pickle.dump(rows, f)


if __name__ == "__main__":
    main()
