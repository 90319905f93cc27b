"""The slice end to end: ``run_arrays`` on a tiny snapshot against the same
computation through the JAX package (the ``_sample_impl`` of
climate2weather_tpu/exp/downscaling.py, vmapped over the ensemble), with
the JAX noise and per-step z injected."""

import pathlib

import h5py
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import close, jax_net_and_params, jax_split_normals, tiny_config, write_snapshot
from climate2weather_tpu_torch.exp.downscaling import run_arrays
from climate2weather_tpu_torch.io.snapshot import yaml_load_file

REPO = pathlib.Path(__file__).resolve().parents[1]
CONFIG = REPO / "exp" / "configs" / "000_on-model-eval" / "s16_t6_spectral.yml"
SNAPSHOT_72M = REPO / "artifacts" / "network-snapshot-0009437-0.999900"
L, H, W, C, WINDOW = 13, 32, 32, 4, 5


def _config(L=L, **overrides):
    cfg = yaml_load_file(CONFIG)
    # cut to a tiny run: 2 samples in one ensemble group, 16 steps, and
    # chunks of 4 of the windows (9 here), so the last chunk shifts back
    cfg.update(num_hours=L, num_samples=2, ensemble_batch=2, num_sampling_steps=16, batch_size=4)
    cfg.update(overrides)
    return cfg


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("slice")
    cfg_net = tiny_config(channels=C * WINDOW, window=WINDOW)
    _, params = jax_net_and_params(cfg_net, hw=H)
    snap = write_snapshot(tmp, cfg_net, params)
    rng = np.random.RandomState(0)
    gt = np.cumsum(rng.randn(L, H, W, C), axis=0).astype(np.float32) / 3
    frames = rng.randn(16, C, H, W).astype(np.float32)
    h5 = tmp / "train_normed.h5"
    with h5py.File(h5, "w") as f:
        f.create_dataset("x", data=frames)
    return snap, gt, frames, str(h5)


def _jax_slice(snap, cfg, gt, h5):
    from climate2weather_tpu.diffusion.calibrate import (
        calibrate_trajectory,
        climatological_annulus_psd,
    )
    from climate2weather_tpu.diffusion.guidance import (
        GaussianGuidance,
        SpatioTemporalCoarsening,
        per_channel,
    )
    from climate2weather_tpu.diffusion.process import VPCosineProcess
    from climate2weather_tpu.diffusion.sampler import sample_dpmpp2m
    from climate2weather_tpu.diffusion.window import WindowScoreFn, make_batched_eps_fn
    from climate2weather_tpu.models.score_net import build_score_unet
    from climate2weather_tpu.training.checkpoint import load_snapshot
    from climate2weather_tpu.utils.seeding import derive_seed

    params, snap_cfg = load_snapshot(snap)
    window = int(snap_cfg["dataset_kwargs"]["train"]["window"])
    L, H, W, C = gt.shape
    net = build_score_unet(snap_cfg["network_kwargs"], dtype=jnp.float32, use_pallas_attention=False)
    process = VPCosineProcess()
    s, ts = cfg["s_step"], cfg["t_step"]
    A = SpatioTemporalCoarsening(s_step=s, t_step=ts)
    observation = A(jnp.asarray(gt))
    sigma = per_channel(cfg["likelihood_std"], C)
    gamma = per_channel(cfg["likelihood_gamma"], C)
    eps_fn = make_batched_eps_fn(net.apply)
    calib_target = jnp.asarray(climatological_annulus_psd(h5, s_step=s))

    def _sample_impl(params, observation, noise, rng):
        score = WindowScoreFn(eps_fn, params, window // 2, chunk_size=cfg["batch_size"])
        guidance = GaussianGuidance(A=A, y=observation, std=sigma, gamma=gamma)
        out, nan_flag = sample_dpmpp2m(
            process, lambda x, t: guidance.guided_eps(score, process, x, t), noise,
            steps=cfg["num_sampling_steps"], rng=rng, sde_eta=cfg["sde_eta"],
            denoise_final=cfg["denoise_final"],
        )
        out = calibrate_trajectory(out, calib_target, s)
        out = A.project(out, observation, iters=cfg["t0_project_iters"], method=cfg["t0_project"])
        return out, nan_flag

    keys = [jax.random.split(jax.random.PRNGKey(derive_seed(cfg["seed"], "sample", sid)))
            for sid in range(cfg["num_samples"])]
    noises = np.stack([np.asarray(jax.random.normal(nk, (L, H, W, C), jnp.float32)) for nk, _ in keys])
    zs = np.stack([jax_split_normals(k, cfg["num_sampling_steps"], (L, H, W, C)) for _, k in keys])
    sample = jax.jit(jax.vmap(_sample_impl, in_axes=(None, None, 0, 0)))
    out, nan = sample(params, observation, jnp.asarray(noises), jnp.stack([k for _, k in keys]))
    return np.asarray(out), np.asarray(nan), noises, zs


def test_run_arrays_matches_jax_slice(setup):
    snap, gt, frames, h5 = setup
    # The config's COSMO gamma (7.2e-4) makes the guided update overshoot in
    # the observed subspace by 1/(s_step^2 gamma) = 5.4x; with an untrained
    # net that amplifies fp32 round-off ~100x per early step, so two correct
    # implementations drift apart. gamma = 1e-2 (the package's default) keeps
    # that gain below 1; every other setting is the config's.
    cfg = _config(likelihood_gamma=1e-2)
    assert cfg["sde_eta"] == 0.3 and cfg["t0_project"] == "spectral" and cfg["denoise_final"]
    want, want_nan, noises, zs = _jax_slice(snap, cfg, gt, h5)
    got, got_nan = run_arrays(snap, cfg, gt, calib_frames=frames, device="cpu",
                              compute_dtype=torch.float32, noise=noises, z=zs)
    assert got.shape == (2, L, H, W, C) and got.dtype == np.float32
    assert not want_nan.any() and not got_nan.any()
    # an untrained net's x0 = (x - sigma eps) / mu, mu(1) = 1e-3, grows the
    # samples to ~1e5; fp32 round-off is relative to that scale
    close(got, want, atol=2e-4 * float(np.abs(want).max()))


@pytest.mark.slow
def test_run_arrays_matches_jax_on_the_72m_snapshot_at_the_config_gamma(tmp_path):
    """The slice on the trained 72.1M snapshot at 32 x 32 with every guidance
    setting the config's own, COSMO gamma 7.2e-4 included: 17 frames give 5
    windows of 13, in chunks of 4 with the last shifted back."""
    L72 = 17
    cfg = _config(L=L72)
    assert abs(cfg["likelihood_gamma"] - 7.2e-4) < 1e-6
    rng = np.random.RandomState(1)
    gt = (np.cumsum(rng.randn(L72, H, W, C), axis=0) / np.sqrt(np.arange(1, L72 + 1))[:, None, None, None])
    gt = gt.astype(np.float32)
    frames = rng.randn(16, C, H, W).astype(np.float32)
    h5 = tmp_path / "train_normed.h5"
    with h5py.File(h5, "w") as f:
        f.create_dataset("x", data=frames)
    want, want_nan, noises, zs = _jax_slice(str(SNAPSHOT_72M), cfg, gt, str(h5))
    got, got_nan = run_arrays(str(SNAPSHOT_72M), cfg, gt, calib_frames=frames, device="cpu",
                              compute_dtype=torch.float32, noise=noises, z=zs)
    assert not want_nan.any() and not got_nan.any()
    # Under jit, XLA evaluates the JAX sigma(t) = sqrt(1 - alpha^2 + eta^2)
    # as (1 + eta^2) - alpha^2, which cancels near t = 0: sigma(0) is 2^-10
    # there, 1e-3 in the port and in JAX run eagerly, and the step
    # coefficients of the last steps differ from eager JAX by up to 3 %.
    # Through the final denoise and the calibration that is 1.6e-4 of the
    # output's scale (9.8e-5 at gamma 1e-2, so not a gamma effect), while a
    # one-ulp change of the initial noise moves either side by 6e-7 of it.
    close(got, want, atol=2e-4 * float(np.abs(want).max()))


def test_run_arrays_draws_its_own_noise_reproducibly(setup):
    snap, gt, frames, _ = setup
    cfg = _config(num_sampling_steps=3, num_samples=3, ensemble_batch=2)
    a, nan_a = run_arrays(snap, cfg, gt, calib_frames=frames, device="cpu",
                          compute_dtype=torch.float32)
    b, _ = run_arrays(snap, cfg, gt, calib_frames=frames, device="cpu", compute_dtype=torch.float32)
    assert np.isfinite(a).all() and not nan_a.any()
    np.testing.assert_array_equal(a, b)
    assert not np.allclose(a[0], a[1])  # members draw from their own generators
    # sample 2 ran alone in the second group, yet draws the same stream as
    # when it shares a group
    c, _ = run_arrays(snap, {**cfg, "ensemble_batch": 3}, gt, calib_frames=frames, device="cpu",
                      compute_dtype=torch.float32)
    close(c, a, rtol=1e-5, atol=1e-5)


def _jax_long_branch(snap, cfg, gt, h5):
    """The long branch of JAX ``_run_impl`` for each sample: its noise and
    key, ``sample_dpmpp2m_long`` in calls of 8 steps, ``postprocess_long_nchw``.
    Returns the samples [S, L, H, W, C], the noise NHWC and the SDE draws of
    each step (one frame chunk: 256 frames cover L), for the port."""
    from climate2weather_tpu.diffusion.calibrate import climatological_annulus_psd, postprocess_long_nchw
    from climate2weather_tpu.diffusion.guidance import GaussianGuidance, SpatioTemporalCoarsening, per_channel
    from climate2weather_tpu.diffusion.long_sampler import sample_dpmpp2m_long
    from climate2weather_tpu.diffusion.process import VPCosineProcess
    from climate2weather_tpu.diffusion.window import make_batched_eps_fn
    from climate2weather_tpu.models.score_net import build_score_unet
    from climate2weather_tpu.training.checkpoint import load_snapshot
    from climate2weather_tpu.utils.seeding import derive_seed

    params, snap_cfg = load_snapshot(snap)
    net = build_score_unet(snap_cfg["network_kwargs"], dtype=jnp.float32, use_pallas_attention=False)
    L, H, W, C = gt.shape
    A = SpatioTemporalCoarsening(s_step=cfg["s_step"], t_step=cfg["t_step"])
    observation = A(jnp.asarray(gt))
    guidance = GaussianGuidance(A=A, y=observation, std=per_channel(cfg["likelihood_std"], C),
                                gamma=per_channel(cfg["likelihood_gamma"], C))
    target = jnp.asarray(climatological_annulus_psd(h5, s_step=cfg["s_step"]))
    steps = cfg["num_sampling_steps"]
    outs, noises, zs = [], [], []
    for sid in range(cfg["num_samples"]):
        nk, key = jax.random.split(jax.random.PRNGKey(derive_seed(cfg["seed"], "sample", sid)))
        noise = jax.random.normal(nk, (L, C, H, W), jnp.float32)
        # noise and key before the sampler donates them with its carry
        noises.append(np.moveaxis(np.asarray(noise), 1, 3))
        z, zkey_seq = [], key
        for _ in range(steps):
            zkey_seq, zkey = jax.random.split(zkey_seq)
            z.append(np.moveaxis(np.asarray(jax.random.normal(jax.random.fold_in(zkey, 0), (L, C, H, W))), 1, 3))
        zs.append(np.stack(z))
        out, nan = sample_dpmpp2m_long(
            VPCosineProcess(), make_batched_eps_fn(net.apply), params, noise,
            markov_order=int(snap_cfg["dataset_kwargs"]["train"]["window"]) // 2,
            chunk_size=cfg["batch_size"], guidance=guidance, steps=steps, rng=key, steps_per_call=8,
            denoise_final=cfg["denoise_final"], sde_eta=cfg["sde_eta"])
        assert not bool(nan)
        out = postprocess_long_nchw(out, calib_target=target, s_step=cfg["s_step"], observation=observation,
                                    t_step=cfg["t_step"], method=cfg["t0_project"],
                                    iters=cfg["t0_project_iters"])
        outs.append(np.moveaxis(np.asarray(out), 1, 3))
    return np.stack(outs), np.stack(noises), np.stack(zs)


def test_run_arrays_long_path_matches_jax(setup):
    """Above ``long_trajectory_threshold`` (lowered to 8 for 13 frames) the
    long path, against JAX's long branch with its noise injected: 2e-4 of
    the output's scale, as the short slice."""
    snap, gt, frames, h5 = setup
    cfg = _config(likelihood_gamma=1e-2, long_trajectory_threshold=8, ensemble_batch=1)
    want, noises, zs = _jax_long_branch(snap, cfg, gt, h5)
    stats = {}
    got, got_nan = run_arrays(snap, cfg, gt, calib_frames=frames, device="cpu",
                              compute_dtype=torch.float32, noise=noises, z=zs, stats=stats)
    assert stats == {"long_path": True, "traj_dtype": "torch.float32"}
    assert got.shape == (2, L, H, W, C) and not got_nan.any()
    close(got, want, atol=2e-4 * float(np.abs(want).max()))


def test_long_path_ignores_ensemble_batch(setup):
    """The long path samples one trajectory at a time, as in JAX: each
    sample draws its own noise, whatever ``ensemble_batch`` says."""
    snap, gt, frames, _ = setup
    cfg = _config(num_sampling_steps=3, num_samples=3, long_trajectory_threshold=8)
    one, _ = run_arrays(snap, {**cfg, "ensemble_batch": 1}, gt, calib_frames=frames, device="cpu",
                        compute_dtype=torch.float32)
    three, nan = run_arrays(snap, {**cfg, "ensemble_batch": 3}, gt, calib_frames=frames, device="cpu",
                            compute_dtype=torch.float32)
    assert np.isfinite(three).all() and not nan.any()
    np.testing.assert_array_equal(one, three)
    assert not np.allclose(three[0], three[1])


@pytest.mark.parametrize("override,error", [
    ({"sampler_kind": "dpmpp3m"}, NotImplementedError),
    ({"use_exact_grad": True}, NotImplementedError),
    ({"host_streaming": True}, NotImplementedError),
    ({"long_trajectory_threshold": 4, "use_exact_grad": True}, NotImplementedError),
    ({"observation_path": "/elsewhere.nc"}, NotImplementedError),
    ({"t0_project": "bilinear"}, ValueError),
    ({"spectral_calibrate": ""}, ValueError),
])
def test_run_arrays_rejects_unported_settings_before_sampling(setup, override, error):
    snap, gt, frames, _ = setup
    with pytest.raises(error):
        run_arrays(snap, _config(**override), gt, calib_frames=frames, device="cpu")


def test_run_arrays_needs_a_card_unless_asked_for_the_cpu(setup, monkeypatch):
    snap, gt, frames, _ = setup
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        run_arrays(snap, _config(), gt, calib_frames=frames)
