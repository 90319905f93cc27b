"""The port's study and operations drivers end to end on the CPU, through
their command lines: a chained training soak of tiny_unet at 32 x 32 with a
SIGKILLed start (killed by the ``metrics.jsonl`` condition, never by wall
time), the scored likelihood sweep with its unconditional control and a
per-channel-gamma point, two rows of the sampler ablation, one probe-watcher
poll and its progression table, and the jax-free verdict composer reading a
``FIDELITY.md`` that the port's ``exp/fidelity`` wrote."""

import importlib.util
import json
import os
import pathlib

import numpy as np
import pytest
import torch
import yaml

from _torch_parity import tiny_config
from climate2weather_tpu_torch.data.grid import GridDataset
from climate2weather_tpu_torch.data.processing import compute_quantiles
from climate2weather_tpu_torch.exp import downscaling
from climate2weather_tpu_torch.models.init import init_params
from climate2weather_tpu_torch.models.score_net import build_score_unet
from climate2weather_tpu_torch.scripts import (
    likelihood_sweep,
    probe_watcher,
    progression_report,
    sampler_ablation,
    soak_training,
)
from climate2weather_tpu_torch.training.checkpoint import save_snapshot
from climate2weather_tpu_torch.utils.seeding import set_random_seed

REPO = pathlib.Path(__file__).resolve().parents[1]
HOURS, HW, C, WINDOW = 49, 32, 4, 5
VARS = ["psl", "tas", "uas", "vas"]
START = "2014-04-07-04"


def _jax_script(name):
    spec = importlib.util.spec_from_file_location(f"jax_{name}", REPO / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """A tiny snapshot (window 5) and a 49-hour 32 x 32 grid with its
    quantiles, written by the port."""
    tmp = tmp_path_factory.mktemp("study")
    cfg_net = tiny_config(channels=C * WINDOW, window=WINDOW)
    net = build_score_unet(cfg_net["network_kwargs"])
    init_params(net, torch.Generator().manual_seed(1))
    snap = save_snapshot(str(tmp), 1, "0.999900", net.state_dict(), cfg_net)
    rng = np.random.RandomState(0)
    time = np.datetime64("2014-04-07T04", "ns") + np.arange(HOURS) * np.timedelta64(1, "h")
    coords = {"time": time, "rlat": np.linspace(-2, 2, HW), "rlon": np.linspace(0, 4, HW)}
    offsets = {"psl": 101000.0, "tas": 285.0, "uas": 0.0, "vas": 0.0}
    walk = np.cumsum(rng.randn(HOURS, HW, HW, C), axis=0) / 3
    ds = GridDataset({v: (walk[..., i] * 4 + offsets[v]).astype(np.float32) for i, v in enumerate(VARS)},
                     coords, {})
    paths = {"data": str(tmp / "merged.nc"), "quantiles": str(tmp / "q.nc")}
    ds.to_file(paths["data"])
    compute_quantiles(ds).to_file(paths["quantiles"])
    return tmp, snap, paths


def test_soak_cli_kill_mid_slice_and_loss_parity(tmp_path):
    """``--slices 1 --kill-every 1``: every start is killed once it has
    written a checkpoint past its resume point and logged beyond it; the
    start that reaches the end exits cleanly. The kill lands mid-slice, the
    replayed interval equals its replay and the series equals the
    uninterrupted run's at every logged ndata."""
    work = tmp_path / "soak"
    soak_training.main(["--total", "2Ki", "--slices", "1", "--batch", "128", "--kill-every", "1",
                        "--kill-past-checkpoint", "--device", "cpu", "--work-dir", str(work)])
    res = json.loads((work / "runs" / "soak" / "SOAK.json").read_text())
    starts = res["restarts"]
    assert [r["killed"] for r in starts] == [True, False], starts
    assert 1024 < starts[0]["killed_at_ndata"] < 2048  # past the 1024 checkpoint, before the end
    assert starts[-1]["rc"] == 0 and starts[-1]["max_ndata"] == 2048
    assert res["replayed_log_points"] >= 1 and res["duplicate_interval_mismatches"] == 0
    assert res["common_log_points"] == 8 and res["loss_parity_mismatches"] == 0
    losses = soak_training.read_losses(work / "runs" / "soak")
    assert sorted(losses) == list(range(256, 2049, 256))


def _sweep_config(tmp, snap, paths) -> pathlib.Path:
    cfg = yaml.safe_load((REPO / "exp" / "configs" / "000_on-model-eval" / "s16_t6.yml").read_text())
    cfg.update(model_path=snap, data_path=paths["data"], quantile_path=paths["quantiles"],
               observation_path=paths["data"], batch_size=16, ensemble_batch=2, num_sampling_steps=2,
               num_hours=25)
    path = tmp / "base.yml"
    path.write_text(yaml.safe_dump(cfg))
    return path


def test_likelihood_sweep_cli(inputs, tmp_path, capsys):
    """Trial 0 (the COSMO point) and one drawn trial with ``--uncond``, then
    an 8-value ``--point`` (per-channel gamma): scored JSONL rows, the drawn
    point equal to ``_draw_likelihood_hparams`` after ``set_random_seed(99,
    1)``, the ranked table, the control's floors, and the per-channel gamma
    reaching the run's frozen config."""
    tmp, snap, paths = inputs
    config = _sweep_config(tmp_path, snap, paths)
    out = tmp_path / "sweep"
    likelihood_sweep.main(["--out", str(out), "--config", str(config), "--trials", "1", "--num-samples", "2",
                           "--uncond", "--uncond-samples", "2", "--device", "cpu"])
    rows = [json.loads(line) for line in (out / "sweep.jsonl").read_text().splitlines()]
    assert [r["trial"] for r in rows] == [0, 1]
    set_random_seed(99, 1)
    sigma, gamma = downscaling._draw_likelihood_hparams()
    assert rows[1]["sigma"] == list(sigma) and rows[1]["gamma"] == gamma
    for r in rows:
        assert all(np.isfinite(r[k]) for k in ("score", "w2_ratio", "melr_ratio", "calib_penalty")), r
        assert set(r["per_var"]) == set(VARS)
    floors = json.loads((out / "uncond_metrics.json").read_text())
    assert set(floors) == set(VARS) and all(np.isfinite(v["ssim"]) for v in floors.values())
    ranking = (out / "RANKING.md").read_text().splitlines()
    table = [ln for ln in ranking if ln.startswith("| ") and ln[2].isdigit()]
    assert len(table) == 2 and {ln.split("|")[2].strip() for ln in table} == {"0", "1"}
    assert all(ln.split("|")[6].strip() in ("yes", "NO") for ln in table)
    capsys.readouterr()

    likelihood_sweep.main(["--out", str(out), "--config", str(config), "--num-samples", "2", "--device", "cpu",
                           "--point", "0.2,0.05,0.3,0.3,0.003,0.003,0.04,0.01"])
    rows = [json.loads(line) for line in (out / "sweep.jsonl").read_text().splitlines()]
    assert rows[-1]["trial"] == 100 and rows[-1]["gamma"] == [0.003, 0.003, 0.04, 0.01]
    assert np.isfinite(rows[-1]["score"])
    frozen = yaml.safe_load(next((out / "trials" / "t100").glob("*/config_freeze.yaml")).read_text())
    assert frozen["likelihood_gamma"] == [0.003, 0.003, 0.04, 0.01]


def test_sampler_ablation_cli_and_verdict_parser(inputs, tmp_path, capsys):
    """Two MATRIX rows through ``--only``: the table with a row each, the
    JSON summary, and each cell's ``FIDELITY.md`` parsed by the jax-free
    ``meso128_verdict.parse_table`` into every (metric, variable) row with
    the means the harness printed."""
    tmp, snap, paths = inputs
    out = tmp_path / "ablation"
    sampler_ablation.main(["--snapshot", snap, "--data-nc", paths["data"], "--quantiles", paths["quantiles"],
                           "--out", str(out), "--start-time", START, "--num-samples", "2", "--steps", "2",
                           "--only", "pc_corr0", "pc_corr1_tau05_ve", "--device", "cpu"])
    table = (out / "ABLATION.md").read_text()
    assert "| pc_corr0 |" in table and "| pc_corr1_tau05_ve |" in table
    summary = json.loads((out / "ablation.json").read_text())
    assert set(summary) == {"pc_corr0", "pc_corr1_tau05_ve"}
    for cell in summary.values():
        assert all(np.isfinite(x) for kind in cell.values() for x in kind.values())
    verdict = _jax_script("meso128_verdict")
    tab = verdict.parse_table(out / "pc_corr0" / "FIDELITY.md")
    kinds = ("wasserstein", "melr", "ssim", "crps", "spread_skill", "rank_reliability")
    assert set(tab) == {(k, v) for k in kinds for v in VARS}
    for v in VARS:
        assert tab[("wasserstein", v)]["guided"] == float(f"{summary['pc_corr0']['wasserstein'][v]:.4f}")
        assert tab[("melr", v)]["base"] is not None
    lines, _ = verdict.h1_rows(tab, "pc_corr0")
    assert len(lines) == 3


def test_probe_watcher_one_poll_and_progression(inputs, tmp_path, capsys):
    """One due and one off-cadence snapshot: one poll (interval 0) probes
    exactly the due one in a child process on the CPU, the idle poll ends
    the watcher, and ``progression_report`` tabulates the probe."""
    tmp, snap, paths = inputs
    run, probes = tmp_path / "run", tmp_path / "probes"
    run.mkdir()
    due, undue = round(2 * 1048.576), round(2.5 * 1048.576)
    for kdata in (due, undue):
        os.symlink(snap, run / f"network-snapshot-{kdata:07d}-0.999000")
    probe_watcher.main([str(run), str(probes), "--data-nc", paths["data"], "--quantiles", paths["quantiles"],
                        "--start-time", START, "--every-mi", "2", "--num-samples", "2", "--steps", "2",
                        "--poll-sec", "0", "--max-idle-polls", "1", "--device", "cpu"])
    out = capsys.readouterr().out
    assert out.count("[probe_watcher] probing") == 1 and f"{due:07d}" in out
    assert "rc=0" in out and "idle limit reached" in out
    assert sorted(p.name for p in probes.iterdir()) == [str(due)]
    assert (probes / str(due) / "FIDELITY.md").exists()
    rows = list(progression_report.progression_rows(probes))
    assert [k for k, _ in rows] == [due]
    progression_report.main([str(probes)])
    report = capsys.readouterr().out
    assert f"| {due / 1000:.2f}M |" in report and "### wasserstein" in report
