"""The round shell drivers of ``climate2weather_tpu_torch/scripts/`` against
the JAX repository's ``scripts/*.sh``.

Each JAX script and its port run in a temporary tree of their own, with a
stub ``python`` first on ``PATH`` that logs its arguments and makes what the
next line waits on (a fidelity run's ``--out`` directory, a predict's
experiment directory); ``/tmp/`` in both copies points at a directory of the
test, so no test reads or writes the machine's PID files, and no waiting
loop is entered (the markers they wait for exist; no PID file names a live
process). The port's log must be the JAX log under the port's mapping
(``python -m climate2weather_tpu.X`` to ``climate2weather_tpu_torch.X``,
``experiment.py`` to ``-m climate2weather_tpu_torch.experiment``, the ported
``scripts/*.py`` to ``-m climate2weather_tpu_torch.scripts.*``, the verdict
composers the repository's own, ``year_post.sh``'s test tier the port's
tests and its TPU dry run dropped), with the same printed lines and exit
code. ``deadline_stop.sh`` stops a real child process. ``year_post.sh``
runs ``metrics run`` and every figure for real on the CPU, on the ensemble
of a CPU predict.
"""

import os
import pathlib
import re
import shutil
import signal
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

REPO = pathlib.Path(__file__).resolve().parents[1]
PORT = REPO / "climate2weather_tpu_torch" / "scripts"
PORTED = ("likelihood_sweep", "progression_report", "spectral_bands", "amplitude_ratio")
DRIVERS = ("h2_sweep", "h3_final_eval", "h4_gate", "h5_gate", "h6_gate", "h7_gate", "h8_gate", "h9_gate",
           "meso128_final_eval", "year_post", "year_winning", "deadline_stop")

STUB = r"""#!/bin/bash
# logs its arguments, one line a call, fields split by the unit separator
printf '%s\x1f' "$@" >> "$STUB_LOG"
printf '\n' >> "$STUB_LOG"
args=("$@")
if [[ " $* " == *fidelity* ]]; then
  for ((i = 0; i < ${#args[@]}; i++)); do
    [ "${args[$i]}" = --out ] && mkdir -p "${args[$((i + 1))]}/guided/001_config"
  done
fi
for ((i = 0; i < ${#args[@]}; i++)); do
  [ "${args[$i]}" = --save-path ] && mkdir -p "${args[$((i + 1))]}/001_year2014_meso128_winning"
done
if [ -n "${STUB_FAIL:-}" ] && [[ " $* " == *"$STUB_FAIL"* ]]; then
  echo "stub: failing on purpose" >&2
  exit 3
fi
echo "stub python ran"
"""

SNAP_EXTENDED = "runs/meso128/network-snapshot-0013631-0.999900"
# scenario: (script, files, directories, stub failure pattern, exit code)
SCENARIOS = {
    "h2_sweep": ("h2_sweep", (), (), "", 0),
    "h3_final_eval": ("h3_final_eval", (), (SNAP_EXTENDED,), "", 0),
    "h3_no_snapshot": ("h3_final_eval", (), (), "", 1),
    "h4_gate": ("h4_gate", ("runs/h4_go",), (), "", 0),
    "h5_gate": ("h5_gate", ("runs/h4_gate.DONE", "runs/h3_eval.DONE", "runs/h3_eval_cosmo/FIDELITY.md"),
                (SNAP_EXTENDED,), "", 0),
    "h5_no_bar_source": ("h5_gate", ("runs/h4_gate.DONE", "runs/h3_eval.DONE"), (SNAP_EXTENDED,), "", 1),
    "h6_gate": ("h6_gate", ("runs/h6_go",), (), "", 0),
    "h7_gate": ("h7_gate", ("runs/h7_go",), (), "", 0),
    "h8_gate": ("h8_gate", (), (), "", 0),
    "h8_gate_fidelity_fails": ("h8_gate", (), (), "fidelity", 0),
    "h9_gate": ("h9_gate", (), (), "", 0),
    "meso128_final_eval": ("meso128_final_eval", (), ("runs/meso128/network-snapshot-0009437-0.999900",), "", 0),
    "year_post": ("year_post", (), (), "", 0),
    "year_post_metrics_fails": ("year_post", (), (), "metrics", 3),
    "year_winning": ("year_winning", ("runs/synth_meso128/eval_year.nc",), (), "", 0),
    "year_winning_predict_fails": ("year_winning", ("runs/synth_meso128/eval_year.nc",), (), "predict", 3),
    "year_winning_no_grid": ("year_winning", (), (), "", 1),
}
TIMESTAMP = re.compile(r"\d{4}-\d\d-\d\dT\d\d:\d\d:\d\dZ")


def _tree(root: pathlib.Path, script: str, port: bool, files, dirs) -> pathlib.Path:
    """A tree holding a copy of the JAX script (``scripts/``) or its port
    (``climate2weather_tpu_torch/scripts/``), ``/tmp/`` pointing at
    ``root/pids/``; returns the copy."""
    rel = pathlib.Path("climate2weather_tpu_torch/scripts" if port else "scripts") / f"{script}.sh"
    text = ((PORT if port else REPO / "scripts") / f"{script}.sh").read_text()
    copy = root / rel
    copy.parent.mkdir(parents=True)
    copy.write_text(text.replace("/tmp/", f"{root}/pids/"))
    (root / "pids").mkdir()
    for f in files:
        (root / f).parent.mkdir(parents=True, exist_ok=True)
        (root / f).write_text("")
    for d in dirs:
        (root / d).mkdir(parents=True)
    return copy


def _run(root: pathlib.Path, copy: pathlib.Path, stub: str, fail: str = "", timeout=30, extra_env=None):
    (root / "bin").mkdir(exist_ok=True)
    (root / "bin" / "python").write_text(stub)
    (root / "bin" / "python").chmod(0o755)
    env = {**os.environ, "PATH": f"{root / 'bin'}:{os.environ['PATH']}", "STUB_LOG": str(root / "calls.log"),
           "STUB_FAIL": fail, **(extra_env or {})}
    env.pop("C2W_IMMUTABLE_COPY", None)
    env.pop("C2W_REPO", None)
    proc = subprocess.run(["bash", str(copy)], capture_output=True, text=True, timeout=timeout, cwd=str(root),
                          env=env)
    log = (root / "calls.log").read_text().splitlines() if (root / "calls.log").exists() else []
    return proc, [line.split("\x1f")[:-1] for line in log]


def _jax_to_port(argv: list):
    """A JAX script's python call as the port makes it (None: dropped)."""
    a = list(argv)
    if a[:1] == ["__graft_entry__.py"]:
        return None
    if a[:1] == ["experiment.py"]:
        return ["-m", "climate2weather_tpu_torch.experiment"] + a[1:]
    if a[:1] and re.fullmatch(r"scripts/(\w+)\.py", a[0]) and a[0][8:-3] in PORTED:
        return ["-m", f"climate2weather_tpu_torch.scripts.{a[0][8:-3]}"] + a[1:]
    if a[:1] == ["-m"] and a[1].startswith("climate2weather_tpu."):
        return ["-m", "climate2weather_tpu_torch." + a[1][len("climate2weather_tpu."):]] + a[2:]
    if a[:3] == ["-m", "pytest", "tests/"]:
        return ["-m", "pytest", "tests/test_torch_*.py"] + a[3:]
    return a


def _lines(stdout: str, drop=()) -> list:
    """The printed lines, timestamps blanked; a line naming a step of
    ``drop`` goes with the next, the step's own output."""
    out, skip = [], 0
    for line in stdout.splitlines():
        if any(d in line for d in drop):
            skip = 2
        if skip:
            skip -= 1
            continue
        out.append(TIMESTAMP.sub("T", line))
    return out


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_driver_chains_the_jax_scripts_commands(tmp_path, scenario):
    script, files, dirs, fail, rc = SCENARIOS[scenario]
    jax_root, port_root = tmp_path / "jax", tmp_path / "port"
    jax_proc, jax_log = _run(jax_root, _tree(jax_root, script, False, files, dirs), STUB, fail)
    port_proc, port_log = _run(port_root, _tree(port_root, script, True, files, dirs), STUB, fail)
    assert jax_proc.returncode == port_proc.returncode == rc, (jax_proc.stderr, port_proc.stderr)
    port_log = [[arg.replace(f"{port_root}/", "") for arg in call] for call in port_log]
    want = [c for c in map(_jax_to_port, jax_log) if c is not None]
    assert port_log == want
    assert _lines(port_proc.stdout) == _lines(jax_proc.stdout, drop=("dryrun_multichip",))
    assert rc or port_log, "a driver that ran must have called python"
    # each left its immutable copy in runs/, as the JAX script does
    assert [p.name.split(".running.")[0] for p in (port_root / "runs").glob("*.running.*")] == [f"{script}.sh"]
    if scenario == "year_winning_predict_fails":  # aborted before metrics and figures
        assert [c[:3] for c in port_log] == [["-m", "climate2weather_tpu_torch.experiment", "predict"]]
        assert "aborting before metrics" in port_proc.stdout and not (port_root / "runs/year_winning.DONE").exists()


def test_every_round_driver_is_ported_and_executable():
    for name in DRIVERS:
        path = PORT / f"{name}.sh"
        assert path.exists() and os.access(path, os.X_OK), name
        text = path.read_text()
        assert "python scripts/" not in text and "climate2weather_tpu." not in text and "experiment.py" not in text
        subprocess.run(["bash", "-n", str(path)], check=True)


SLEEPY = "#!/bin/bash\nexec /bin/sleep 0.1\n"  # the waiting loops' sleeps, cut short


@pytest.mark.parametrize("branch", ["target", "deadline", "pid_gone"])
@pytest.mark.parametrize("port", [False, True], ids=["jax", "port"])
def test_deadline_stop_stops_a_real_child(tmp_path, branch, port):
    """The child exits on SIGTERM when the target path exists or the
    deadline has passed; a PID file naming no live process ends the watcher
    at once."""
    script = (PORT if port else REPO / "scripts") / "deadline_stop.sh"
    (tmp_path / "bin").mkdir()
    (tmp_path / "bin" / "sleep").write_text(SLEEPY)
    (tmp_path / "bin" / "sleep").chmod(0o755)
    child = subprocess.Popen(["/bin/sleep", "300"])
    threading.Thread(target=child.wait, daemon=True).start()  # reaped as soon as it exits
    pidfile = tmp_path / "child.pid"
    pidfile.write_text("" if branch == "pid_gone" else str(child.pid))
    target = tmp_path / "snapshot-dir"
    if branch == "target":
        target.mkdir()
    deadline = int(time.time()) + (-1 if branch == "deadline" else 3600)
    env = {**os.environ, "PATH": f"{tmp_path / 'bin'}:{os.environ['PATH']}"}
    try:
        proc = subprocess.run(["bash", str(script), str(pidfile), str(deadline), str(target)], capture_output=True,
                              text=True, timeout=30, env=env)
        assert proc.returncode == 0, proc.stderr
        out = _lines(proc.stdout)
        if branch == "pid_gone":
            assert out == ["[deadline_stop] pid gone on its own at T"] and child.poll() is None
        else:
            first = {"target": f"[deadline_stop] target {target} exists at T",
                     "deadline": "[deadline_stop] deadline reached at T"}[branch]
            assert out == [first, f"[deadline_stop] SIGTERM -> {child.pid}", "[deadline_stop] exited cleanly"]
            assert child.wait(timeout=5) == -signal.SIGTERM
    finally:
        if child.poll() is None:
            child.kill()


PASS_THROUGH = r"""#!/bin/bash
# logs every call; the calls named in $REAL run for real, the rest (the
# test tier among them) are logged and passed over
printf '%s\x1f' "$@" >> "$STUB_LOG"
printf '\n' >> "$STUB_LOG"
key=$4
[ "$3" = metrics ] && key=metrics
if [ "$1" != "-m" ] || [ "$2" != climate2weather_tpu_torch.experiment ] || [[ " $REAL " != *" $key "* ]]; then
  echo "stub python: not run here"
  exit 0
fi
exec __PYTHON__ "$@"
"""
FIGURES = ("rapsd", "calibration", "kde_and_pmf", "climate_grid", "timeseries", "windpower_dist")


@pytest.fixture(scope="module")
def cpu_ensemble(tmp_path_factory):
    """The experiment directory of a CPU predict: the tiny net (initialized
    by the port, no JAX) at 32 x 32, 13 hours, one sample, 2 steps."""
    import torch
    import yaml

    from _torch_parity import tiny_config
    from climate2weather_tpu_torch.data.grid import GridDataset
    from climate2weather_tpu_torch.data.pipeline import compute_quantiles
    from climate2weather_tpu_torch.exp import downscaling
    from climate2weather_tpu_torch.models.init import init_params
    from climate2weather_tpu_torch.models.score_net import build_score_unet
    from climate2weather_tpu_torch.training.checkpoint import save_snapshot

    inputs = tmp_path_factory.mktemp("ensemble")
    rng = np.random.default_rng(3)
    time_axis = np.datetime64("2014-01-01T00", "ns") + np.arange(13) * np.timedelta64(1, "h")
    ds = GridDataset({v: (np.cumsum(rng.standard_normal((13, 32, 32)), 0) + off).astype(np.float32)
                      for v, off in (("psl", 101000.0), ("tas", 285.0), ("uas", 0.0), ("vas", 0.0))},
                     {"time": time_axis, "rlat": np.linspace(-2, 2, 32), "rlon": np.linspace(0, 4, 32)}, {})
    ds.to_file(str(inputs / "merged.nc"))
    compute_quantiles(ds).to_file(str(inputs / "q.nc"))
    cfg_net = tiny_config(channels=4 * 5, window=5)
    net = init_params(build_score_unet(cfg_net["network_kwargs"], dtype=torch.float32),
                      torch.Generator().manual_seed(0))
    snap = save_snapshot(str(inputs), 1, "0.999900", net.state_dict(), cfg_net)
    cfg = yaml.safe_load((REPO / "exp" / "configs" / "000_on-model-eval" / "s16_t6.yml").read_text())
    cfg.update(model_path=snap, data_path=str(inputs / "merged.nc"), quantile_path=str(inputs / "q.nc"),
               observation_path=str(inputs / "merged.nc"), num_hours=13, batch_size=4, num_samples=1,
               ensemble_batch=1, num_sampling_steps=2, start_time="2014-01-01-00")
    (inputs / "year2014_meso128_dpm64.yml").write_text(yaml.safe_dump(cfg))
    return pathlib.Path(downscaling.run(str(inputs / "exp"), str(inputs / "year2014_meso128_dpm64.yml"),
                                        device="cpu"))


# the host steps run for real, a third in each case, each case well under its time limit
@pytest.mark.parametrize("real", [("metrics",) + FIGURES[:2], FIGURES[2:4], FIGURES[4:]],
                         ids=["metrics_rapsd_calibration", "kde_and_pmf_climate_grid", "timeseries_windpower_dist"])
def test_year_post_runs_metrics_and_figures_on_the_cpu(tmp_path, cpu_ensemble, real):
    """The port's ``year_post.sh`` runs ``metrics run`` and the figure kinds
    for real on the CPU, on the experiment directory of a CPU predict; every
    call is logged in the script's order, its test tier not run."""
    pytest.importorskip("matplotlib")
    root = tmp_path / "tree"
    _tree(root, "year_post", True, (), ())
    # the script's tree holds its copy; the package itself is the repository's
    (root / "climate2weather_tpu_torch").rename(root / "_scripts_only")
    (root / "climate2weather_tpu_torch").symlink_to(REPO / "climate2weather_tpu_torch")
    copy = root / "_scripts_only" / "scripts" / "year_post.sh"
    exp = root / "runs" / "year2014_meso128" / "001_year2014_meso128_dpm64"
    shutil.copytree(cpu_ensemble, exp)
    stub = PASS_THROUGH.replace("__PYTHON__", sys.executable)
    # the real calls of every case share compiled bytecode, kept beside the ensemble
    proc, log = _run(root, copy, stub, timeout=120,
                     extra_env={"REAL": " ".join(real), "PYTHONPYCACHEPREFIX": str(cpu_ensemble.parent.parent / "pyc"),
                                "PYTHONDONTWRITEBYTECODE": ""})
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    assert [c[:4] for c in log] == [["-m", "pytest", "tests/test_torch_*.py", "-q"],
                                    ["-m", "climate2weather_tpu_torch.experiment", "metrics", "run"]] + \
        [["-m", "climate2weather_tpu_torch.experiment", "figures", kind] for kind in FIGURES]
    assert "[year_post] DONE at" in proc.stdout and "failed" not in proc.stdout
    if "metrics" in real:
        assert (exp / "metrics").is_dir() and any((exp / "metrics").iterdir())
    drawn = sorted(p.name.split(".")[0] for p in (exp / "figures").iterdir())
    assert sorted({d if d in FIGURES else d.rsplit("_", 1)[0] for d in drawn}) == sorted(set(real) - {"metrics"})
