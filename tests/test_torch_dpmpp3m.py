"""DPM-Solver++(3M) against the JAX package: the step rule's coefficients,
the short sampler ``sample_dpmpp3m`` (alone, members batched, through the
tiny net), the long sampler at ``order=3`` (its resume included), and
``run_arrays`` with ``sampler_kind: dpmpp3m`` on the short and the long path.

The samplers are compared at 2e-4 of the output's largest magnitude: JAX's
scan is compiled (ROADMAP caveat 4), and the third-order extrapolation
carries the round-off of the largest values into the smallest (elementwise,
12 steps of a closed-form score differ by up to 7e-4 relative, 7e-6 of the
largest value). Through the tiny net DPM-Solver++(3M) runs 24 steps, so that
the last steps' share of the output stays below that limit.
"""

import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import close, jax_net_and_params, t, tiny_config, torch_net, write_snapshot
from climate2weather_tpu.diffusion import long_sampler as jlong
from climate2weather_tpu.diffusion import sampler as jsampler
from climate2weather_tpu.diffusion import steprules as jrules
from climate2weather_tpu.diffusion.guidance import GaussianGuidance as JaxGuidance
from climate2weather_tpu.diffusion.guidance import SpatioTemporalCoarsening as JaxCoarsening
from climate2weather_tpu.diffusion.process import VPCosineProcess as JaxProcess
from climate2weather_tpu.diffusion.window import WindowScoreFn as JaxWindowScoreFn
from climate2weather_tpu.diffusion.window import make_batched_eps_fn
from climate2weather_tpu_torch.diffusion import long_sampler, sampler, steprules
from climate2weather_tpu_torch.diffusion.guidance import GaussianGuidance, SpatioTemporalCoarsening
from climate2weather_tpu_torch.diffusion.process import VPCosineProcess
from climate2weather_tpu_torch.diffusion.window import WindowScoreFn
from climate2weather_tpu_torch.exp.downscaling import run_arrays
from climate2weather_tpu_torch.io.snapshot import yaml_load_file

CONFIG = pathlib.Path(__file__).resolve().parents[1] / "exp" / "configs" / "000_on-model-eval" / "s16_t6_spectral.yml"
L, HW, C, WINDOW, CHUNK, F = 13, 16, 2, 5, 4, 5
STD, GAMMA = np.array([0.2, 0.3], np.float32), 1e-2


@pytest.mark.parametrize("i", range(2, 8))
@pytest.mark.parametrize("prev_h,prev2_h", [(0.37, 0.41), (0.2, 0.9)])
def test_dpm3_coefficients(i, prev_h, prev2_h):
    grid = np.asarray(jsampler.logsnr_time_grid(JaxProcess(), 9))
    tp, tc = grid[i], grid[i + 1]
    got = steprules.dpm3_scalar_coeffs(VPCosineProcess(), float(tp), float(tc), np.float32(prev_h),
                                       np.float32(prev2_h))
    want = jrules.dpm3_scalar_coeffs(JaxProcess(), jnp.float32(tp), jnp.float32(tc), jnp.float32(prev_h),
                                     jnp.float32(prev2_h))
    for gv, wv in zip(got, want):
        close(gv, wv, rtol=1e-5, atol=1e-6)
    # D = w0 x0 + w1 prev + w2 prev2 reproduces a quadratic in lambda exactly
    # when the three weights sum to one
    assert abs(float(got[3] + got[4] + got[5]) - 1.0) < 1e-5
    rng = np.random.RandomState(i)
    x0, p1, p2 = (rng.randn(3, 4).astype(np.float32) for _ in range(3))
    close(steprules.dpm3_data_estimate(t(x0), t(p1), t(p2), float(got[3]), float(got[4]), float(got[5])),
          jrules.dpm3_data_estimate(jnp.asarray(x0), jnp.asarray(p1), jnp.asarray(p2), *want[3:]))


def _linear_score(W):
    def jax_fn(x, tt):
        return jnp.tanh(x @ jnp.asarray(W)) * (0.5 + tt)

    def torch_fn(x, tt):
        return torch.tanh(x @ t(W)) * (0.5 + float(tt))

    return jax_fn, torch_fn


@pytest.mark.parametrize("denoise_final", [False, True])
@pytest.mark.parametrize("lambda_spacing", [True, False])
@pytest.mark.parametrize("steps", [1, 2, 12])
def test_sample_dpmpp3m_matches_jax(denoise_final, lambda_spacing, steps):
    """1 and 2 steps stop inside the warm-up (first, then second order)."""
    rng = np.random.RandomState(7)
    shape = (5, 3, 3, 4)
    W = (rng.randn(4, 4) / 2).astype(np.float32)
    noise = rng.randn(*shape).astype(np.float32)
    jax_fn, torch_fn = _linear_score(W)
    want, want_nan = jsampler.sample_dpmpp3m(JaxProcess(), jax_fn, jnp.asarray(noise), steps=steps,
                                             denoise_final=denoise_final, lambda_spacing=lambda_spacing)
    got, got_nan = sampler.sample_dpmpp3m(VPCosineProcess(), torch_fn, t(noise), steps=steps,
                                          denoise_final=denoise_final, lambda_spacing=lambda_spacing)
    _scaled_close(got, np.asarray(want))
    assert bool(got_nan) == bool(want_nan) is False
    assert sampler.SAMPLERS["dpmpp3m"] is sampler.sample_dpmpp3m
    assert sorted(sampler.SAMPLERS) == sorted(jsampler.SAMPLERS)


def test_sample_dpmpp3m_members_match_one_by_one_and_flag_nan_per_member():
    rng = np.random.RandomState(8)
    W = (rng.randn(4, 4) / 2).astype(np.float32)
    noise = rng.randn(2, 5, 3, 3, 4).astype(np.float32)
    _, torch_fn = _linear_score(W)
    both, flags = sampler.sample_dpmpp3m(VPCosineProcess(), torch_fn, t(noise), steps=6, batch_dims=1)
    assert flags.shape == (2,) and not flags.any()
    for m in range(2):
        one, _ = sampler.sample_dpmpp3m(VPCosineProcess(), torch_fn, t(noise[m]), steps=6)
        close(both[m], one, rtol=1e-6, atol=1e-6)
    noise[1, 0, 0, 0, 0] = np.nan
    _, flags = sampler.sample_dpmpp3m(VPCosineProcess(), torch_fn, t(noise), steps=2, batch_dims=1)
    assert flags.tolist() == [False, True]


@pytest.fixture(scope="module")
def setup():
    """The tiny net, guidance with A (s = 4, t = 3) and noise, as in
    tests/test_torch_long_sampler.py (gamma 1e-2)."""
    cfg = tiny_config(channels=C * WINDOW, window=WINDOW)
    net, params = jax_net_and_params(cfg, hw=HW)
    rng = np.random.RandomState(0)
    noise = rng.randn(L, HW, HW, C).astype(np.float32)
    gt = rng.randn(L, HW, HW, C).astype(np.float32)
    y = np.array(JaxCoarsening(4, 3)(jnp.asarray(gt)))
    jguide = JaxGuidance(A=JaxCoarsening(4, 3), y=jnp.asarray(y), std=jnp.asarray(STD).reshape(1, 1, 1, C),
                         gamma=GAMMA)
    guide = GaussianGuidance(A=SpatioTemporalCoarsening(4, 3), y=torch.from_numpy(y), std=torch.from_numpy(STD),
                             gamma=GAMMA)
    return net, params, torch_net(cfg, params).requires_grad_(False), jguide, guide, noise


def _score(port_net, calls=None):
    def eps_fn(w, tt):
        if calls is not None:
            calls.append(tt)
        return port_net(w, tt)
    return WindowScoreFn(eps_fn, WINDOW // 2, chunk_size=CHUNK)


def _scaled_close(got, want):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-4 * float(np.abs(want).max()))


@pytest.mark.parametrize("guided", [False, True])
def test_short_dpmpp3m_through_the_net_matches_jax(setup, guided):
    """``sample_dpmpp3m`` over the window score (detached guidance or none)
    with the final denoise, against JAX's, 24 steps."""
    net, params, port_net, jguide, guide, noise = setup
    jscore = JaxWindowScoreFn(make_batched_eps_fn(net.apply), params, WINDOW // 2, chunk_size=CHUNK)
    jfn = (lambda x, tt: jguide.guided_eps(jscore, JaxProcess(), x, tt)) if guided else jscore
    want, _ = jsampler.sample_dpmpp3m(JaxProcess(), jfn, jnp.asarray(noise), steps=24, denoise_final=True)
    score = _score(port_net)
    fn = (lambda x, tt: guide.guided_eps(score, VPCosineProcess(), x, tt)) if guided else score
    got, nan = sampler.sample_dpmpp3m(VPCosineProcess(), fn, t(noise), steps=24, denoise_final=True)
    assert not bool(nan)
    _scaled_close(got, np.asarray(want))


@pytest.mark.parametrize("guided", [False, True])
def test_long_order3_matches_jax(setup, guided):
    """``sample_dpmpp2m_long(order=3)`` against JAX's (NCHW), frame chunks of
    5 so that the last shifts back, 24 steps and the final denoise."""
    net, params, port_net, jguide, guide, noise = setup
    out, nan = jlong.sample_dpmpp2m_long(
        JaxProcess(), make_batched_eps_fn(net.apply), params, jnp.moveaxis(jnp.asarray(noise), 3, 1),
        markov_order=WINDOW // 2, chunk_size=CHUNK, guidance=jguide if guided else None, frame_chunk=F,
        steps=24, order=3, denoise_final=True)
    want = np.moveaxis(np.asarray(out), 1, 3)
    got, got_nan = long_sampler.sample_dpmpp2m_long(
        VPCosineProcess(), _score(port_net), t(noise), guidance=guide if guided else None, frame_chunk=F,
        steps=24, order=3, denoise_final=True)
    assert not bool(nan) and not bool(got_nan)
    _scaled_close(got, want)
    # the long order-3 sampler equals the short one on the same trajectory
    score = _score(port_net)
    fn = (lambda x, tt: guide.guided_eps(score, VPCosineProcess(), x, tt)) if guided else score
    short, _ = sampler.sample_dpmpp3m(VPCosineProcess(), fn, t(noise), steps=24, denoise_final=True)
    _scaled_close(got, short.numpy())


class Crash(Exception):
    pass


def _order3_run(setup, score, path):
    """Order 3, 8 steps in calls of 2 with a resume file after every call."""
    *_, guide, noise = setup
    return long_sampler.sample_dpmpp2m_long(VPCosineProcess(), score, t(noise), guidance=guide, steps=8,
                                            order=3, frame_chunk=F, steps_per_call=2, denoise_final=True,
                                            resume_path=path, resume_every=1)


def test_order3_resume_equals_the_uninterrupted_run(setup, tmp_path):
    """Crashed in its third call (step 5, past the warm-up) and resumed from
    the file: the same bits as the uninterrupted run, the file holding the
    second-previous x0 and h, and a digest that tells order 3 from order 2."""
    port_net = setup[2]
    want, _ = _order3_run(setup, _score(port_net), None)
    path = str(tmp_path / ".sample_resume_000.npz")
    calls = []

    def eps_fn(w, tt):
        if len(calls) == 5 * 3:  # step 5's first window chunk
            raise Crash
        calls.append(tt)
        return port_net(w, tt)

    with pytest.raises(Crash):
        _order3_run(setup, WindowScoreFn(eps_fn, WINDOW // 2, chunk_size=CHUNK), path)
    with np.load(path) as f:
        assert int(f["step"]) == 4
        assert {"prev2_x0", "prev2_h"} <= {str(n_) for n_ in f["names"]}
    resumed = []
    got, nan = _order3_run(setup, _score(port_net, resumed), path)
    assert torch.equal(got, want) and not bool(nan)
    assert len(resumed) == (4 + 1) * 3  # steps 4-7 and the final denoise, 3 window chunks each
    # an order-2 run does not take an order-3 file
    with pytest.raises(Crash):
        calls.clear()
        _order3_run(setup, WindowScoreFn(eps_fn, WINDOW // 2, chunk_size=CHUNK), path)
    fresh = []
    *_, guide, noise = setup
    long_sampler.sample_dpmpp2m_long(VPCosineProcess(), _score(port_net, fresh), t(noise), guidance=guide,
                                     steps=8, order=2, frame_chunk=F, steps_per_call=2, resume_path=path,
                                     resume_every=1)
    assert len(fresh) == 8 * 3


def test_long_order3_refuses_sde_and_other_orders(setup):
    port_net, noise = setup[2], setup[-1]
    with pytest.raises(ValueError, match="order=2"):
        long_sampler.sample_dpmpp2m_long(VPCosineProcess(), _score(port_net), t(noise), order=3, sde_eta=0.3,
                                         rng=torch.Generator())
    with pytest.raises(ValueError, match="order"):
        long_sampler.sample_dpmpp2m_long(VPCosineProcess(), _score(port_net), t(noise), order=4)


@pytest.fixture(scope="module")
def snapshot(tmp_path_factory):
    cfg = tiny_config(channels=4 * WINDOW, window=WINDOW)
    _, params = jax_net_and_params(cfg, hw=32)
    return write_snapshot(tmp_path_factory.mktemp("snap3m"), cfg, params), params, cfg


def _jax_branch(snap, cfg, gt, long):
    """JAX ``_run_impl``'s sampling of each sample, without post-processing:
    its noise from the sample's key, ``sample_dpmpp3m`` vmapped over the
    ensemble (short) or ``sample_dpmpp2m_long(order=3)`` (long)."""
    from climate2weather_tpu.diffusion.guidance import per_channel
    from climate2weather_tpu.models.score_net import build_score_unet
    from climate2weather_tpu.training.checkpoint import load_snapshot
    from climate2weather_tpu.utils.seeding import derive_seed

    params, snap_cfg = load_snapshot(snap)
    net = build_score_unet(snap_cfg["network_kwargs"], dtype=jnp.float32, use_pallas_attention=False)
    Lg, H, W, Cg = gt.shape
    A = JaxCoarsening(s_step=cfg["s_step"], t_step=cfg["t_step"])
    guidance = JaxGuidance(A=A, y=A(jnp.asarray(gt)), std=per_channel(cfg["likelihood_std"], Cg),
                           gamma=per_channel(cfg["likelihood_gamma"], Cg),
                           exact_grad=cfg["use_exact_grad"])
    process, eps_fn = JaxProcess(), make_batched_eps_fn(net.apply)
    keys = [jax.random.split(jax.random.PRNGKey(derive_seed(cfg["seed"], "sample", sid)))[0]
            for sid in range(cfg["num_samples"])]
    if long:
        outs = []
        for nk in keys:
            out, _ = jlong.sample_dpmpp2m_long(
                process, eps_fn, params, jax.random.normal(nk, (Lg, Cg, H, W), jnp.float32),
                markov_order=WINDOW // 2, chunk_size=cfg["batch_size"], guidance=guidance,
                steps=cfg["num_sampling_steps"], steps_per_call=8, order=3, denoise_final=True)
            outs.append(np.moveaxis(np.asarray(out), 1, 3))
        return np.stack(outs), np.stack([np.moveaxis(np.asarray(
            jax.random.normal(nk, (Lg, Cg, H, W), jnp.float32)), 1, 3) for nk in keys])
    noises = jnp.stack([jax.random.normal(nk, (Lg, H, W, Cg), jnp.float32) for nk in keys])

    def one(noise):
        score = JaxWindowScoreFn(eps_fn, params, WINDOW // 2, chunk_size=cfg["batch_size"])
        return jsampler.sample_dpmpp3m(process, lambda x, tt: guidance.guided_eps(score, process, x, tt), noise,
                                       steps=cfg["num_sampling_steps"], denoise_final=True)[0]

    return np.asarray(jax.jit(jax.vmap(one))(noises)), np.asarray(noises)


@pytest.mark.parametrize("path", ["short", "long"])
@pytest.mark.parametrize("exact", [False, True])
def test_run_arrays_dpmpp3m_matches_jax(snapshot, path, exact):
    """``run_arrays`` with ``sampler_kind: dpmpp3m`` (and with
    ``use_exact_grad``) against the JAX package's sampling, the JAX noise
    injected, on the short path (2 samples in one group) and on the long one
    (threshold lowered to 8 for 13 frames, one sample), 24 steps and the
    final denoise, no post-processing: 2e-4 of the output's scale."""
    snap, _, _ = snapshot
    cfg = yaml_load_file(CONFIG)
    cfg.update(num_hours=13, num_samples=2 if path == "short" else 1, ensemble_batch=2, batch_size=4,
               num_sampling_steps=24, sampler_kind="dpmpp3m", sde_eta=0.0, likelihood_gamma=1e-2,
               use_exact_grad=exact, t0_project="", spectral_calibrate="", denoise_final=True)
    if path == "long":
        cfg["long_trajectory_threshold"] = 8
    rng = np.random.RandomState(0)
    gt = (np.cumsum(rng.randn(13, 32, 32, 4), axis=0) / 3).astype(np.float32)
    want, noises = _jax_branch(snap, cfg, gt, path == "long")
    stats = {}
    got, nan = run_arrays(snap, cfg, gt, device="cpu", compute_dtype=torch.float32, noise=noises, stats=stats)
    assert stats["long_path"] == (path == "long") and not nan.any()
    _scaled_close(got, want)

