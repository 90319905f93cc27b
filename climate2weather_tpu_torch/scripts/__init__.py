"""Study and operations drivers (ports of the JAX repository's ``scripts/``).

Each keeps its JAX script's name, flags, defaults, printed lines and output
files, and runs as ``python -m climate2weather_tpu_torch.scripts.<name>``:

- ``fabricate_resume_state``: a trainer checkpoint from an inference snapshot
  (fresh Adam moments, the schedule's count at the snapshot's step);
- ``soak_training``: ``train`` chained over slices with SIGKILLs, its losses
  held bit for bit against an uninterrupted run;
- ``likelihood_sweep``: the scored (sigma, gamma) sweep with its ranking;
- ``sampler_ablation``: the corrector/SDE matrix through ``exp.fidelity``;
- ``probe_watcher`` and ``progression_report``: fidelity probes of a
  training run's snapshots, and their table;
- ``spectral_bands``, ``amplitude_ratio``, ``calibration_design_study``:
  post-hoc diagnostics of a fidelity directory;
- ``run_training.sh``: the production launcher under the stall supervisor.
"""

import os
import pathlib

REPO = pathlib.Path(__file__).resolve().parents[2]


def child_env() -> dict:
    """This process's environment with the repository first on the import
    path of a child ``python -m climate2weather_tpu_torch...`` and its output
    unbuffered."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([str(REPO)] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    env["PYTHONUNBUFFERED"] = "1"
    return env
