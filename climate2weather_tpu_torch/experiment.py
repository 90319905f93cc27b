"""Experiment command line of the port (the ``predict`` and ``metrics``
commands of the JAX package's ``experiment.py``):

    python -m climate2weather_tpu_torch.experiment predict \\
        --save-path OUT --config-path CONFIG.yml [--num-samples N] ... [--device cpu]
    python -m climate2weather_tpu_torch.experiment metrics run EXP_DIR [--time-stride N]
    python -m climate2weather_tpu_torch.experiment metrics load EXP_DIR

``predict`` runs :func:`climate2weather_tpu_torch.exp.downscaling.run` with the
flags given as overrides of the config, on the card unless ``--device cpu``.
``metrics run`` scores an experiment directory on the host
(:func:`climate2weather_tpu_torch.exp.metrics.run`), ``metrics load`` prints
the scores it saved.
"""

from __future__ import annotations

import argparse
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
    m = sub.add_parser("metrics", help="score an experiment directory (exp/metrics)")
    msub = m.add_subparsers(dest="metrics_command", required=True)
    r = msub.add_parser("run", help="compute the scores and pickle them under EXP_DIR/metrics/run")
    r.add_argument("exp_dir")
    r.add_argument("--time-stride", type=int, default=1,
                   help="score every Nth observed frame (the year-scale protocol; recorded in the pickle)")
    ld = msub.add_parser("load", help="print the scores of an earlier metrics run")
    ld.add_argument("exp_dir")
    return ap


def main(argv=None) -> int:
    args = vars(build_parser().parse_args(argv))
    command = args.pop("command")
    if command == "predict":
        from climate2weather_tpu_torch.exp import downscaling

        save_path, config_path, device = args.pop("save_path"), args.pop("config_path"), args.pop("device")
        downscaling.run(save_path, config_path, device=device, **args)
    else:
        from climate2weather_tpu_torch.exp import metrics

        if args["metrics_command"] == "run":
            metrics.run(args["exp_dir"], time_stride=args["time_stride"])
        else:
            metrics.load(args["exp_dir"])
    return 0


if __name__ == "__main__":
    sys.exit(main())
