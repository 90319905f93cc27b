"""The likelihood sweep (``sweep_likelihood_hparams``, the ``hparam-sweep``
command) and the fidelity harness (``exp/fidelity.run``) against the JAX
package on tiny files: the sweep's draw sequence, one trial against JAX's
``run`` with the same overrides, and the fidelity runs, metrics and
``FIDELITY.md`` against JAX's.

Both sides run the tiny net in fp32 (JAX's ``run`` is patched to build it
so) with the PC sampler and no corrector, so that a run is a function of its
initial noise, which JAX draws and the port is given. Samples agree at 2e-4
of their largest magnitude (ROADMAP caveat 4, JAX jitted), the metrics
computed from them at rtol 2e-4.
"""

import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from _torch_parity import jax_net_and_params, tiny_config, write_snapshot
from climate2weather_tpu.data.grid import GridDataset, open_grid
from climate2weather_tpu.data.pipeline import ds_to_sorted_np, normalize_ds
from climate2weather_tpu.data.processing import compute_quantiles
from climate2weather_tpu.exp import downscaling as jax_downscaling
from climate2weather_tpu.exp import fidelity as jax_fidelity
from climate2weather_tpu.utils.seeding import derive_seed
from climate2weather_tpu.utils.seeding import set_random_seed as jax_set_random_seed
from climate2weather_tpu_torch import experiment
from climate2weather_tpu_torch.exp import downscaling, fidelity
from climate2weather_tpu_torch.utils.seeding import set_random_seed

REPO = pathlib.Path(__file__).resolve().parents[1]
HOURS, HW, C, WINDOW = 49, 32, 4, 5
VARS = ["psl", "tas", "uas", "vas"]


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("sweep")
    cfg_net = tiny_config(channels=C * WINDOW, window=WINDOW)
    _, params = jax_net_and_params(cfg_net, hw=HW)
    snap = write_snapshot(tmp, cfg_net, params)
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


@pytest.fixture
def fp32_jax_net(monkeypatch):
    """The JAX ``run`` with its network in fp32 and the jnp attention."""
    from climate2weather_tpu.models.score_net import build_score_unet

    monkeypatch.setattr(jax_downscaling, "build_score_unet", lambda kw, dtype=None: build_score_unet(
        kw, dtype=jnp.float32, use_pallas_attention=False))


def _jax_noise(cfg: dict) -> np.ndarray:
    """JAX ``_run_impl``'s initial noise of each sample of ``cfg``."""
    L = int(cfg["num_hours"])
    return np.stack([np.asarray(jax.random.normal(
        jax.random.split(jax.random.PRNGKey(derive_seed(int(cfg["seed"]), "sample", sid)))[0],
        (L, HW, HW, C), jnp.float32)) for sid in range(int(cfg["num_samples"]))])


@pytest.fixture
def port_run_with_jax_noise(monkeypatch):
    """The port's ``run`` on the CPU in fp32 with JAX's initial noise of the
    frozen config injected (the PC sampler with no corrector draws nothing
    else); records each run's directory."""
    real, dirs = downscaling.run, []

    def run(save_path, config_path, device="cuda", **kwargs):
        def impl(save_dir, cfg, dev, **kw):
            return real_impl(save_dir, cfg, "cpu", **{**kw, "compute_dtype": torch.float32,
                                                      "noise": _jax_noise(cfg)})

        real_impl = downscaling._run_impl
        monkeypatch.setattr(downscaling, "_run_impl", impl)
        try:
            out = real(save_path, config_path, "cpu", **kwargs)
        finally:
            monkeypatch.setattr(downscaling, "_run_impl", real_impl)
        dirs.append(out)
        return out

    monkeypatch.setattr(downscaling, "run", run)
    return dirs


def _config(tmp, snap, paths, name, **overrides) -> pathlib.Path:
    cfg = yaml.safe_load((REPO / "exp" / "configs" / "000_on-model-eval" / "s16_t6.yml").read_text())
    cfg.update(model_path=snap, data_path=paths["data"], quantile_path=paths["quantiles"],
               observation_path=paths["data"], batch_size=16, ensemble_batch=5, num_sampling_steps=2)
    cfg.update(overrides)
    path = tmp / f"{name}.yml"
    path.write_text(yaml.safe_dump(cfg))
    return path


def _normed(path, quantiles) -> np.ndarray:
    return ds_to_sorted_np(normalize_ds(open_grid(str(path)), quantiles, "quant95"), VARS)


def _scaled_close(got, want):
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-4 * float(np.abs(want).max()))


def test_draw_sequence_matches_jax():
    """Trial n's (sigma, gamma) after ``set_random_seed(base_seed, n)``: the
    same points as JAX's ``_draw_likelihood_hparams``, exactly."""
    for base_seed in (99, 7):
        for trial in range(1, 6):
            jax_set_random_seed(base_seed, trial)
            want = jax_downscaling._draw_likelihood_hparams()
            set_random_seed(base_seed, trial)
            got = downscaling._draw_likelihood_hparams()
            assert got == want
            assert len(got[0]) == 4 and got[0][3] == got[0][2]


def test_sweep_trial_matches_jax_run(inputs, fp32_jax_net, port_run_with_jax_noise, tmp_path):
    """One trial: the same draw, overrides, numbered directory and frozen
    config as JAX's sweep, and samples at 2e-4 of their scale."""
    tmp, snap, paths = inputs
    config_path = _config(tmp, snap, paths, "sweep")
    want = jax_downscaling.sweep_likelihood_hparams(str(tmp_path / "jax"), str(config_path), 1, base_seed=5)
    got = downscaling.sweep_likelihood_hparams(str(tmp_path / "port"), str(config_path), 1, base_seed=5,
                                               device="cpu")
    assert [o[:3] for o in got] == [o[:3] for o in want]
    got_dir, want_dir = pathlib.Path(got[0][3]), pathlib.Path(want[0][3])
    assert got_dir.name == want_dir.name == "001_sweep"
    frozen = yaml.safe_load((got_dir / "config_freeze.yaml").read_text())
    assert frozen == yaml.safe_load((want_dir / "config_freeze.yaml").read_text())
    assert frozen["num_samples"] == 10 and frozen["num_hours"] == 49 and frozen["num_corrections"] == 0
    assert frozen["likelihood_std"] == list(got[0][1]) and frozen["seed"] == 5
    for sid in range(10):
        _scaled_close(_normed(got_dir / f"gen_sample_{sid:03d}.nc", paths["quantiles"]),
                      _normed(want_dir / f"gen_sample_{sid:03d}.nc", paths["quantiles"]))


def test_sweep_isolates_a_failing_trial(inputs, monkeypatch, tmp_path, capsys):
    tmp, snap, paths = inputs
    config_path = _config(tmp, snap, paths, "isolated")
    calls = []

    def run(save_path, config_path, device, **overrides):
        calls.append(overrides)
        if len(calls) == 1:
            raise FloatingPointError("NaN detected in sample(s) [3]")
        return pathlib.Path(save_path) / "002_isolated"

    monkeypatch.setattr(downscaling, "run", run)
    out = downscaling.sweep_likelihood_hparams(str(tmp_path), str(config_path), 2, device="cpu")
    assert out[0][3] == "FAILED: NaN detected in sample(s) [3]" and out[1][3].endswith("002_isolated")
    assert len(calls) == 2 and calls[0]["likelihood_std"] != calls[1]["likelihood_std"]
    assert "Sweep summary:" in capsys.readouterr().out


def test_experiment_cli_runs_the_sweep(inputs, tmp_path, capsys):
    """``python -m climate2weather_tpu_torch.experiment hparam-sweep`` on the
    CPU: two trials, two numbered directories of finite samples."""
    tmp, snap, paths = inputs
    config_path = _config(tmp, snap, paths, "cli", num_sampling_steps=1)
    assert experiment.main(["hparam-sweep", "--save-path", str(tmp_path / "out"), "--config-path",
                            str(config_path), "--trials", "2", "--base-seed", "3", "--device", "cpu"]) == 0
    printed = capsys.readouterr().out
    assert "Trial 1: sigma = " in printed and "Trial 2: sigma = " in printed and "FAILED" not in printed
    for d in ("001_cli", "002_cli"):
        sample = open_grid(str(tmp_path / "out" / d / "gen_sample_009.nc"))
        assert all(np.isfinite(v).all() for v in sample.data_vars.values())


FIDELITY_KW = dict(num_hours=13, num_samples=2, uncond_samples=2, num_sampling_steps=3, ensemble_batch=2,
                   batch_size=4, skip_figures=True)


def test_fidelity_matches_jax(inputs, fp32_jax_net, port_run_with_jax_noise, tmp_path):
    """The guided run and the unconditional control (their frozen configs
    and samples), the metrics of both, and FIDELITY.md: the same rows, with
    scores at rtol 2e-4."""
    _, snap, paths = inputs
    args = (snap, paths["data"], paths["quantiles"])
    want = jax_fidelity.run(*args, str(tmp_path / "jax"), "2014-04-07-04", **FIDELITY_KW)
    got = fidelity.run(*args, str(tmp_path / "port"), "2014-04-07-04", device="cpu", **FIDELITY_KW)
    for key in ("guided_dir", "uncond_dir"):
        g, w = pathlib.Path(got[key]), pathlib.Path(want[key])
        assert g.name == w.name
        assert yaml.safe_load((g / "config_freeze.yaml").read_text()) == \
            yaml.safe_load((w / "config_freeze.yaml").read_text())
        assert sorted(p.name for p in g.iterdir()) == sorted(p.name for p in w.iterdir())
        for sid in range(2):
            _scaled_close(_normed(g / f"gen_sample_{sid:03d}.nc", paths["quantiles"]),
                          _normed(w / f"gen_sample_{sid:03d}.nc", paths["quantiles"]))
    for side in ("guided", "uncond"):
        assert sorted(got[side]) == sorted(want[side])
        for kind, by_var in want[side].items():
            if kind == "protocol":
                assert got[side][kind] == by_var
                continue
            for var, entries in by_var.items():
                assert sorted(got[side][kind][var]) == sorted(entries)
                for name, value in entries.items():
                    np.testing.assert_allclose(got[side][kind][var][name], value, rtol=2e-4, atol=1e-6)
    got_md = (tmp_path / "port" / "FIDELITY.md").read_text().splitlines()
    want_md = (tmp_path / "jax" / "FIDELITY.md").read_text().splitlines()
    assert len(got_md) == len(want_md)
    for g, w in zip(got_md, want_md):
        if g.startswith("| ") and not g.startswith("| metric"):
            assert g.split("|")[1:3] == w.split("|")[1:3]  # the metric and variable of each row
        elif "snapshot" not in g and "Figures" not in g:
            assert g == w


def test_fidelity_refuses_figures_before_sampling(inputs, tmp_path, monkeypatch, capsys):
    """Kept under its first name, from when the port refused to draw before
    sampling: the figures now come after both runs' metrics, one kind at a
    time, and a figure that fails is printed while the numbers and
    ``FIDELITY.md`` stand, as in JAX."""
    _, snap, paths = inputs
    events, real_metrics = [], fidelity.metrics.run

    def metrics_run(exp_dir, **kw):
        events.append(("metrics", pathlib.Path(exp_dir).parent.name))
        return real_metrics(exp_dir, **kw)

    def make(kind, exp_dir, *args, **kw):
        events.append(("figure", kind))
        if kind == "rapsd":
            raise RuntimeError("no spectrum today")
        return str(pathlib.Path(exp_dir) / "figures" / f"{kind}.png")

    monkeypatch.setattr(fidelity.metrics, "run", metrics_run)
    monkeypatch.setattr(fidelity.figures, "make", make)
    out = fidelity.run(snap, paths["data"], paths["quantiles"], str(tmp_path / "out"), "2014-04-07-04",
                       num_hours=13, num_samples=2, uncond_samples=2, num_sampling_steps=2, device="cpu")
    assert events == [("metrics", "guided"), ("metrics", "uncond")] + [
        ("figure", k) for k in ("kde_and_pmf", "rapsd", "timeseries", "storm_grid", "windpower_dist",
                                "climate_grid", "calibration")]
    assert "figure rapsd failed: RuntimeError: no spectrum today" in capsys.readouterr().out
    assert (tmp_path / "out" / "FIDELITY.md").exists()
    assert np.isfinite(out["guided"]["wasserstein"]["tas"]["global"]).all()
    assert tuple(fidelity.FIGURE_KINDS) == tuple(k for kind, k in events[2:])


def test_fidelity_command_line(monkeypatch):
    seen = {}
    monkeypatch.setattr(fidelity, "run", lambda **kw: seen.update(kw))
    base = ["--snapshot", "S", "--data-nc", "D", "--quantiles", "Q", "--out", "O", "--start-time", "T",
            "--skip-figures", "--device", "cpu"]
    assert fidelity.main(base + ["--likelihood-gamma", "0.5", "--sampler-kind", "dpmpp3m"]) == 0
    assert seen["likelihood_gamma"] == 0.5 and seen["likelihood_std"] is None
    assert seen["sampler_kind"] == "dpmpp3m" and seen["skip_figures"] and seen["device"] == "cpu"
    fidelity.main(base + ["--likelihood-std", "1", "--likelihood-std", "2", "--likelihood-gamma", "1",
                          "--likelihood-gamma", "2"])
    assert seen["likelihood_std"] == [1.0, 2.0] and seen["likelihood_gamma"] == [1.0, 2.0]
    fidelity.main(base)
    assert seen["likelihood_gamma"] == fidelity.DEFAULT_GAMMA == jax_fidelity.DEFAULT_GAMMA
    assert fidelity.DEFAULT_STD == jax_fidelity.DEFAULT_STD
