"""The predict entry point from files: the port's ``exp.downscaling.run``
against the JAX package's ``run`` on inputs written by the JAX writers (through
h5py), with JAX's initial noise and per-step draws injected into the port.

Both sides run the tiny network in fp32 (the JAX ``run`` builds it in bf16;
the test builds it in fp32 instead, as the port runs it here). The samples
are compared in normalized space at 2e-4 of their largest magnitude: an
untrained net's x0 = (x - sigma eps) / mu with mu(1) = 1e-3 grows them to
~1e5, and fp32 round-off is relative to that (ROADMAP caveat 4: JAX under
jit evaluates sigma(0) differently). That limit cannot tell which
observation a run conditioned on, so where the config projects, A(x) = y
is held in normalized space against the observation the run wrote, and
the coarsened ground truth, 3 K off it in tas for the external
observation, must fail that limit. Observations and ground truths agree
exactly; ``config_freeze.yaml`` and the numbered directories match.
"""

import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from _torch_parity import jax_net_and_params, jax_split_normals, tiny_config, write_snapshot
from climate2weather_tpu.data.grid import GridDataset, open_grid
from climate2weather_tpu.data.pipeline import ds_to_sorted_np, nchw_to_nhwc, normalize_ds
from climate2weather_tpu.data.processing import compute_quantiles, merged_to_normed_h5
from climate2weather_tpu.exp import downscaling as jax_downscaling
from climate2weather_tpu.utils.seeding import derive_seed
from climate2weather_tpu_torch import experiment
from climate2weather_tpu_torch.diffusion.guidance import SpatioTemporalCoarsening
from climate2weather_tpu_torch.exp import downscaling

REPO = pathlib.Path(__file__).resolve().parents[1]
CONFIGS = REPO / "exp" / "configs" / "000_on-model-eval"
L, HW, C, WINDOW = 13, 32, 4, 5
VARS = ["psl", "tas", "uas", "vas"]


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("predict")
    cfg_net = tiny_config(channels=C * WINDOW, window=WINDOW)
    _, params = jax_net_and_params(cfg_net, hw=HW)
    snap = write_snapshot(tmp, cfg_net, params)
    rng = np.random.RandomState(0)
    time = np.datetime64("2014-04-07T04", "ns") + np.arange(L + 3) * np.timedelta64(1, "h")
    coords = {"time": time, "rlat": np.linspace(-2, 2, HW), "rlon": np.linspace(0, 4, HW)}
    offsets = {"psl": 101000.0, "tas": 285.0, "uas": 0.0, "vas": 0.0}
    walk = np.cumsum(rng.randn(L + 3, HW, HW, C), axis=0) / 3
    ds = GridDataset({v: (walk[..., i] * 4 + offsets[v]).astype(np.float32) for i, v in enumerate(VARS)},
                     coords, {})
    paths = {k: str(tmp / f) for k, f in (("data", "merged.nc"), ("quantiles", "q.nc"),
                                         ("train", "train_normed.h5"), ("obs", "obs.nc"))}
    ds.to_file(paths["data"])
    compute_quantiles(ds).to_file(paths["quantiles"])
    merged_to_normed_h5(paths["data"], paths["quantiles"], paths["train"])
    obs = ds.coarsen_mean(16).isel_time(np.arange(0, L, 6))
    # an external observation: tas biased by 3 K, as a climate model's may be
    obs.map(lambda k, v: v + np.float32(3.0 if k == "tas" else 0.0)).to_file(paths["obs"])
    return tmp, snap, paths


def _config(tmp, snap, paths, name, base, **overrides):
    """A copy of an experiment config with its paths replaced, cut to a tiny
    run; a None override removes the key."""
    cfg = yaml.safe_load((CONFIGS / base).read_text())
    cfg.update(model_path=snap, data_path=paths["data"], quantile_path=paths["quantiles"],
               observation_path=paths["data"], num_hours=L, batch_size=4,
               # gamma 1e-2 as in tests/test_torch_downscaling.py: the COSMO
               # gamma's 5.4x observed-subspace gain amplifies fp32 round-off
               # of an untrained net until two correct implementations drift
               likelihood_gamma=1e-2)
    if cfg.get("spectral_calibrate"):
        cfg["spectral_calibrate"] = paths["train"]
    for k, v in overrides.items():
        if v is None:
            cfg.pop(k, None)
        else:
            cfg[k] = v
    path = tmp / f"{name}.yml"
    path.write_text(yaml.safe_dump(cfg))
    return path, cfg


def _jax_draws(cfg):
    """JAX ``_run_impl``'s initial noise per sample and the per-step draws its
    sampler takes from the sample's second key."""
    kind = cfg.get("sampler_kind", "pc")
    steps = int(cfg["num_sampling_steps"])
    n_draws = steps * int(cfg.get("num_corrections", 2)) if kind == "pc" else (
        steps if cfg.get("sde_eta", 0) else 0)
    if cfg.get("host_streaming"):  # the host tier's numpy draws are the same numbers on both sides
        n_draws = 0
    noises, zs = [], []
    for sid in range(int(cfg["num_samples"])):
        nk, sk = jax.random.split(jax.random.PRNGKey(derive_seed(int(cfg["seed"]), "sample", sid)))
        if L > int(cfg.get("long_trajectory_threshold", 512)) and not cfg.get("host_streaming"):
            # the long path: NCHW noise, and each step's z drawn per frame
            # chunk with fold_in (one chunk of 256 frames covers L)
            noises.append(np.moveaxis(np.asarray(jax.random.normal(nk, (L, C, HW, HW), jnp.float32)), 1, 3))
            z = []
            for _ in range(n_draws):
                sk, zkey = jax.random.split(sk)
                z.append(np.moveaxis(np.asarray(jax.random.normal(jax.random.fold_in(zkey, 0), (L, C, HW, HW))),
                                     1, 3))
            zs.append(np.stack(z) if z else np.zeros((0, L, HW, HW, C), np.float32))
            continue
        noises.append(np.asarray(jax.random.normal(nk, (L, HW, HW, C), jnp.float32)))
        zs.append(jax_split_normals(sk, n_draws, (L, HW, HW, C)) if n_draws else
                  np.zeros((0, L, HW, HW, C), np.float32))
    return np.stack(noises), np.stack(zs)


@pytest.fixture
def fp32_jax_net(monkeypatch):
    """The JAX ``run`` with its network in fp32 and the jnp attention."""
    from climate2weather_tpu.models.score_net import build_score_unet

    monkeypatch.setattr(jax_downscaling, "build_score_unet", lambda kw, dtype=None: build_score_unet(
        kw, dtype=jnp.float32, use_pallas_attention=False))


def _normed_samples(out_dir, cfg, quantiles):
    files = sorted(pathlib.Path(out_dir).glob("gen_sample_*.nc"))
    assert len(files) == int(cfg["num_samples"])
    return np.stack([ds_to_sorted_np(normalize_ds(open_grid(str(f)), quantiles, cfg["data_norm_mode"]), VARS)
                     for f in files])


# The DPM-Solver++(2M) cases take 16 steps, as tests/test_torch_downscaling.py
# does: with fewer, the last step's share of the final denoise grows, and the
# sigma(0) that JAX evaluates under jit (caveat 4) moves the output by more
# than 2e-4 of its scale (4 steps: ~1e-3; the PC case has no final denoise).
CASES = {
    # dpmpp2m SDE + final denoise + calibration from the h5 path + projection
    "dpmpp2m": ("s16_t6_spectral.yml", dict(num_samples=2, ensemble_batch=2, num_sampling_steps=16)),
    # PC with one corrector step per step: delta = tau / mean(eps^2) per member
    "pc": ("s16_t6.yml", dict(num_samples=2, ensemble_batch=2, num_sampling_steps=4, num_corrections=1)),
    "external_observation": ("s16_t6_spectral.yml", dict(num_samples=1, ensemble_batch=1,
                                                         num_sampling_steps=16, observation_path="obs")),
    "no_observation": ("s16_t6_spectral.yml", dict(num_samples=1, ensemble_batch=1, num_sampling_steps=16,
                                                   observation_path=None)),
    "guidance_off": ("s16_t6_spectral.yml", dict(num_samples=1, ensemble_batch=1, num_sampling_steps=16,
                                                 guidance_off=True)),
    # the year path above a lowered threshold: one sample at a time whatever
    # ensemble_batch says, a resume file written and removed, calibration and
    # projection in time chunks
    "long": ("s16_t6_spectral.yml", dict(num_samples=2, ensemble_batch=2, num_sampling_steps=16,
                                         long_trajectory_threshold=8, sample_resume_every=1)),
    # the bilinear prolongation of the residual, and DPM-Solver++(3M) with
    # exact-gradient guidance (24 steps: the third-order steps carry the
    # round-off of caveat 4 further), on the short and the long path
    "bilinear": ("s16_t6_spectral.yml", dict(num_samples=2, ensemble_batch=2, num_sampling_steps=16,
                                             guidance_prolong="bilinear")),
    "exact_dpmpp3m": ("s16_t6_spectral.yml", dict(num_samples=2, ensemble_batch=2, num_sampling_steps=24,
                                                  sampler_kind="dpmpp3m", sde_eta=0.0, use_exact_grad=True)),
    "long_bilinear": ("s16_t6_spectral.yml", dict(num_samples=1, ensemble_batch=1, num_sampling_steps=16,
                                                  long_trajectory_threshold=8, guidance_prolong="bilinear")),
    "long_exact_dpmpp3m": ("s16_t6_spectral.yml", dict(num_samples=1, ensemble_batch=1, num_sampling_steps=24,
                                                       long_trajectory_threshold=8, sampler_kind="dpmpp3m",
                                                       sde_eta=0.0, use_exact_grad=True)),
    # the host-streaming tier, one sample at a time whatever ensemble_batch
    # says, the per-step draws numpy's on both sides: DPM-Solver++(2M) SDE
    # with the final denoise (no calibration or projection, which the tier
    # refuses), and PC with a corrector step
    "stream_dpmpp2m": ("s16_t6_spectral.yml", dict(num_samples=2, ensemble_batch=2, num_sampling_steps=16,
                                                   host_streaming=True, t0_project="", spectral_calibrate="")),
    "stream_pc": ("s16_t6.yml", dict(num_samples=2, ensemble_batch=2, num_sampling_steps=4, num_corrections=1,
                                     host_streaming=True)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_run_matches_jax_run(inputs, fp32_jax_net, case, tmp_path):
    tmp, snap, paths = inputs
    base, overrides = CASES[case]
    overrides = {k: paths[v] if k == "observation_path" and v else v for k, v in overrides.items()}
    config_path, cfg = _config(tmp_path, snap, paths, case, base, **overrides)
    noise, z = _jax_draws(cfg)
    # a directory already in each save path: both number the next one 002
    for side in ("jax", "port"):
        (tmp_path / side / "001_earlier").mkdir(parents=True)
    want_dir = jax_downscaling.run(str(tmp_path / "jax"), str(config_path))
    got_dir = downscaling.run(str(tmp_path / "port"), str(config_path), device="cpu",
                              compute_dtype=torch.float32, noise=noise, z=z)
    assert got_dir.name == want_dir.name == f"002_{case}"
    assert (got_dir / "config_freeze.yaml").read_text() == (want_dir / "config_freeze.yaml").read_text()
    want_files = sorted(p.name for p in want_dir.iterdir())
    assert sorted(p.name for p in got_dir.iterdir()) == want_files
    assert ("observation.nc" in want_files) == (cfg.get("observation_path") is not None)
    for name in ("ground_truth.nc", "observation.nc"):
        if name in want_files:
            g, w = open_grid(str(got_dir / name)), open_grid(str(want_dir / name))
            np.testing.assert_array_equal(g.time, w.time)
            for k in VARS:
                np.testing.assert_allclose(g.data_vars[k], w.data_vars[k], rtol=1e-6)
    got = _normed_samples(got_dir, cfg, paths["quantiles"])
    want = _normed_samples(want_dir, cfg, paths["quantiles"])
    assert np.isfinite(got).all() and np.isfinite(want).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-4 * float(np.abs(want).max()))
    if cfg.get("t0_project") and cfg.get("observation_path"):
        _assert_projected_on_the_observation(got, got_dir, want_dir, cfg, paths)


def _assert_projected_on_the_observation(samples, got_dir, want_dir, cfg, paths):
    """A(x) = y in normalized space for every sample, y being the
    observation the run wrote; the coarsened ground truth, which differs
    from an external observation, must fail the same limit."""
    A = SpatioTemporalCoarsening(int(cfg["s_step"]), int(cfg["t_step"]))

    def normed(ds):
        return torch.from_numpy(nchw_to_nhwc(ds_to_sorted_np(
            normalize_ds(ds, paths["quantiles"], cfg["data_norm_mode"]), VARS)))

    y = normed(open_grid(str(got_dir / "observation.nc")))
    truth = A(normed(open_grid(str(want_dir / "ground_truth.nc"))))
    ax = [A(torch.from_numpy(nchw_to_nhwc(x))) for x in samples]
    # y's round trip through physical units and .nc files, plus the fp32
    # round-off of projecting samples of the untrained net's ~1e5 scale
    tol = 1e-4 * max(1.0, float(y.abs().max())) + 4 * np.finfo(np.float32).eps * float(np.abs(samples).max())
    errs = [float((a - y).abs().max()) for a in ax]
    wrong = [float((a - truth).abs().max()) for a in ax]
    assert max(errs) <= tol
    if cfg["observation_path"] != cfg["data_path"]:
        assert min(wrong) > tol


def test_experiment_cli_runs_predict(inputs, tmp_path):
    """``python -m climate2weather_tpu_torch.experiment predict`` with
    overrides, on the CPU: the numbered directory, the frozen config with
    the overrides, and finite samples."""
    tmp, snap, paths = inputs
    config_path, _ = _config(tmp_path, snap, paths, "cli", "s16_t6_spectral.yml", ensemble_batch=1)
    assert experiment.main(["predict", "--save-path", str(tmp_path / "out"), "--config-path",
                            str(config_path), "--num-samples", "1", "--num-sampling-steps", "2",
                            "--seed", "3", "--device", "cpu"]) == 0
    out = tmp_path / "out" / "001_cli"
    frozen = yaml.safe_load((out / "config_freeze.yaml").read_text())
    assert frozen["num_samples"] == 1 and frozen["num_sampling_steps"] == 2 and frozen["seed"] == 3
    sample = open_grid(str(out / "gen_sample_000.nc"))
    assert all(np.isfinite(v).all() for v in sample.data_vars.values())


def test_run_refuses_unported_settings_before_sampling(inputs, tmp_path):
    tmp, snap, paths = inputs
    # what the JAX package refuses too (the host-streaming tier's refusals
    # are the cases of the test below)
    for name, over, error in (
            ("dpmpp3m", {"sampler_kind": "dpmpp3m", "sde_eta": 0.3}, ValueError),
            ("exact", {"use_exact_grad": True, "guidance_prolong": "bilinear"}, ValueError),
            ("long", {"long_trajectory_threshold": 4, "use_exact_grad": True, "guidance_prolong": True},
             ValueError)):
        config_path, _ = _config(tmp_path, snap, paths, name, "s16_t6_spectral.yml", **over)
        with pytest.raises(error):
            downscaling.run(str(tmp_path / name), str(config_path), device="cpu")
        assert not list((tmp_path / name).glob("*/gen_sample_*.nc"))


# What the host-streaming tier refuses, one setting at a time on a config it
# otherwise runs: the samplers other than pc and dpmpp2m, the calibration,
# the projection and guidance_off as JAX does before sampling, and exact,
# prolonged and annealed guidance, which JAX asserts against inside its
# sample loop (ROADMAP reference caveat 7)
STREAM_REFUSALS = {
    "sampler_kind": {"sampler_kind": "dpmpp3m", "sde_eta": 0.0},
    "t0_project": {"t0_project": "spectral"},
    "guidance_off": {"guidance_off": True},
    "spectral_calibrate": {"spectral_calibrate": "train"},
    "use_exact_grad": {"use_exact_grad": True},
    "guidance_prolong": {"guidance_prolong": "bilinear"},
    "guidance_anneal": {"guidance_anneal": 0.5},
}


@pytest.mark.parametrize("key", sorted(STREAM_REFUSALS))
def test_run_refuses_host_streaming_settings_before_any_output(inputs, tmp_path, key):
    tmp, snap, paths = inputs
    over = {"host_streaming": True, "t0_project": "", "spectral_calibrate": "", "num_sampling_steps": 2,
            **STREAM_REFUSALS[key]}
    if over["spectral_calibrate"]:
        over["spectral_calibrate"] = paths["train"]
    config_path, _ = _config(tmp_path, snap, paths, key, "s16_t6_spectral.yml", **over)
    with pytest.raises(ValueError, match="host_streaming implements" if key == "sampler_kind" else key):
        downscaling.run(str(tmp_path / key), str(config_path), device="cpu")
    assert not list((tmp_path / key).glob("*/*.nc"))
