"""Experiment command line of the port (the commands of the JAX package's
``experiment.py``):

    python -m climate2weather_tpu_torch.experiment predict \\
        --save-path OUT --config-path CONFIG.yml [--num-samples N] ... [--device cpu]
    python -m climate2weather_tpu_torch.experiment hparam-sweep \\
        --save-path OUT --config-path CONFIG.yml [--trials 10] [--base-seed 99] [--device cpu]
    python -m climate2weather_tpu_torch.experiment metrics run EXP_DIR [--time-stride N]
    python -m climate2weather_tpu_torch.experiment metrics load EXP_DIR
    python -m climate2weather_tpu_torch.experiment figures KIND EXP_DIR [--out-dir D] [--compare DIR ...]
    python -m climate2weather_tpu_torch.experiment fidelity --snapshot SNAP --data-nc DATA.nc \\
        --quantiles Q.nc --out OUT --start-time YYYY-MM-DD-HH [...] [--device cpu]
    python -m climate2weather_tpu_torch.experiment animation EXP_DIR [--var tas] [--out-path P] [--fps 6] \\
        [--max-frames 72]

``predict`` runs :func:`climate2weather_tpu_torch.exp.downscaling.run` with the
flags given as overrides of the config, on the card unless ``--device cpu``;
launched by torchrun (``torchrun --nproc_per_node N -m
climate2weather_tpu_torch.experiment predict ...``) it starts the process
group as ``train`` does, each rank on its own card (``--dist-backend`` as
for ``train``), and stripes the samples over gcd(num_samples, N) groups of
ranks; where N does not divide ``num_samples`` each group's ranks split
every sample's window evaluations (one sample on 8 cards included).
``hparam-sweep`` runs :func:`~climate2weather_tpu_torch.exp.downscaling.sweep_likelihood_hparams`
(one ``predict`` per trial at a random likelihood (sigma, gamma)), likewise.
``metrics run`` scores an experiment directory on the host
(:func:`climate2weather_tpu_torch.exp.metrics.run`), ``metrics load`` prints
the scores it saved. ``figures`` draws one of the paper's figures of an
experiment directory (:func:`climate2weather_tpu_torch.exp.figures.make`:
``kde_and_pmf``, ``timeseries``, ``storm_grid``, ``climate_grid``,
``big_grid``, ``rapsd``, ``calibration``, ``windpower``, ``windpower_dist``,
or ``downscaled_clim_dist`` over it and the ``--compare`` directories),
``fidelity`` runs the acceptance harness (:mod:`climate2weather_tpu_torch.exp.fidelity`)
and ``animation`` writes a GIF of the ground truth and the first two samples
over time; the drawing needs matplotlib (and Pillow for the GIF) on the
host. Every command but ``predict`` runs in one process and refuses a
torchrun world above one.
"""

from __future__ import annotations

import argparse
import os
import sys


def _bool(text: str) -> bool:
    value = text.strip().lower()
    if value in ("1", "true", "t", "yes", "y", "on"):
        return True
    if value in ("0", "false", "f", "no", "n", "off"):
        return False
    raise argparse.ArgumentTypeError(f"not a boolean: {text!r}")


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m climate2weather_tpu_torch.experiment",
                                 description=__doc__.splitlines()[0])
    sub = ap.add_subparsers(dest="command", required=True)
    p = sub.add_parser("predict", help="guided downscaling (exp/downscaling.run)")
    p.add_argument("--save-path", required=True)
    p.add_argument("--config-path", required=True)
    p.add_argument("--num-samples", type=int)
    p.add_argument("--num-hours", type=int)
    p.add_argument("--num-sampling-steps", type=int)
    p.add_argument("--num-corrections", type=int)
    p.add_argument("--corrector-variance-exact", type=_bool,
                   help="variance-exact Langevin corrector noise")
    p.add_argument("--sde-eta", type=float,
                   help="SDE-DPM-Solver++(2M) noise strength (sampler_kind dpmpp2m; 0 = deterministic)")
    p.add_argument("--batch-size", type=int)
    p.add_argument("--seed", type=int)
    p.add_argument("--observation-path")
    p.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    p.add_argument("--dist-backend", default=None,
                   help="torch.distributed backend under torchrun (default: nccl on the card, gloo on the CPU)")
    sw = sub.add_parser("hparam-sweep", help="random search over the likelihood's (sigma, gamma)")
    sw.add_argument("--save-path", required=True)
    sw.add_argument("--config-path", required=True)
    sw.add_argument("--trials", type=int, default=10)
    sw.add_argument("--base-seed", type=int, default=99)
    sw.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    m = sub.add_parser("metrics", help="score an experiment directory (exp/metrics)")
    msub = m.add_subparsers(dest="metrics_command", required=True)
    r = msub.add_parser("run", help="compute the scores and pickle them under EXP_DIR/metrics/run")
    r.add_argument("exp_dir")
    r.add_argument("--time-stride", type=int, default=1,
                   help="score every Nth observed frame (the year-scale protocol; recorded in the pickle)")
    ld = msub.add_parser("load", help="print the scores of an earlier metrics run")
    ld.add_argument("exp_dir")
    f = sub.add_parser("figures", help="one of the paper's figures of an experiment directory (exp/figures.make)")
    f.add_argument("kind", help="kde_and_pmf | timeseries | storm_grid | climate_grid | big_grid | rapsd | "
                                "calibration | windpower | windpower_dist | downscaled_clim_dist")
    f.add_argument("exp_dir")
    f.add_argument("--out-dir", default=None, help="(default EXP_DIR/figures)")
    f.add_argument("--compare", action="append", default=[],
                   help="another experiment directory (downscaled_clim_dist); repeat for more")
    from climate2weather_tpu_torch.exp.fidelity import add_arguments

    add_arguments(sub.add_parser("fidelity", help="guided + unconditional ensembles, their metrics, the "
                                                  "figures and FIDELITY.md (exp/fidelity.run)"))
    an = sub.add_parser("animation", help="GIF of the ground truth and the first two samples over time")
    an.add_argument("exp_dir")
    an.add_argument("--var", default="tas")
    an.add_argument("--out-path", default=None, help="(default EXP_DIR/figures/animation_VAR.gif)")
    an.add_argument("--fps", type=int, default=6)
    an.add_argument("--max-frames", type=int, default=72)
    return ap


def animation(exp_dir: str, var: str = "tas", out_path=None, fps: int = 6, max_frames: int = 72) -> str:
    """The ``animation`` command: a GIF of the ground truth and the first
    two samples of ``exp_dir`` (reference plotting_util.create_animation)."""
    from climate2weather_tpu_torch.exp import exputil
    from climate2weather_tpu_torch.exp.plotting_util import create_animation

    samples, gt, _ = exputil.setup(exp_dir)
    out_path = out_path or os.path.join(exp_dir, "figures", f"animation_{var}.gif")
    if os.path.dirname(out_path):
        os.makedirs(os.path.dirname(out_path), exist_ok=True)
    labels = ["ground truth"] + [f"sample {i}" for i in range(min(2, len(samples)))]
    create_animation([gt] + samples[:2], var, labels, out_path, fps=fps, max_frames=max_frames)
    print(f"Saved {out_path}")
    return out_path


def main(argv=None) -> int:
    from climate2weather_tpu_torch.parallel import mesh

    args = vars(build_parser().parse_args(argv))
    command = args.pop("command")
    if command != "predict" and mesh.launched() and int(os.environ["WORLD_SIZE"]) > 1:
        raise SystemExit(f"{command} runs in one process; it was launched as one of "
                         f"{os.environ['WORLD_SIZE']} ranks")
    if command == "predict":
        from climate2weather_tpu_torch.exp import downscaling

        save_path, config_path, device = args.pop("save_path"), args.pop("config_path"), args.pop("device")
        dev = mesh.maybe_init_distributed(device, args.pop("dist_backend"))
        try:
            downscaling.run(save_path, config_path, device=dev, **args)
        finally:
            mesh.shutdown()
    elif command == "hparam-sweep":
        from climate2weather_tpu_torch.exp import downscaling

        downscaling.sweep_likelihood_hparams(args["save_path"], args["config_path"], args["trials"],
                                             args["base_seed"], device=args["device"])
    elif command == "figures":
        from climate2weather_tpu_torch.exp import figures

        figures.make(args["kind"], args["exp_dir"], args["out_dir"], compare=args["compare"])
    elif command == "fidelity":
        from climate2weather_tpu_torch.exp import fidelity

        fidelity.run_from_args(args)
    elif command == "animation":
        animation(**args)
    else:
        from climate2weather_tpu_torch.exp import metrics

        if args["metrics_command"] == "run":
            metrics.run(args["exp_dir"], time_stride=args["time_stride"])
        else:
            metrics.load(args["exp_dir"])
    return 0


if __name__ == "__main__":
    sys.exit(main())
