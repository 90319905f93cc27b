"""The host-streaming tier (climate2weather_tpu_torch/diffusion/host_stream.py)
against the JAX package's (climate2weather_tpu/diffusion/host_stream.py) on
the CPU: the numpy coarsening bit for bit, eps over the chunked windows of a
tiny net, and both samplers, with an analytic numpy score (the same numbers
drawn on both sides from ``np.random.RandomState(seed)``) and with the tiny
net."""

import numpy as np
import pytest
import torch

from _torch_parity import jax_net_and_params, tiny_config, torch_net
from climate2weather_tpu.diffusion import host_stream as jhost
from climate2weather_tpu.diffusion import steprules as jsteprules
from climate2weather_tpu.diffusion.process import VPCosineProcess as JaxProcess
from climate2weather_tpu_torch.diffusion import host_stream, steprules
from climate2weather_tpu_torch.diffusion.process import VPCosineProcess
from climate2weather_tpu_torch.diffusion.window import WindowScoreFn

C, WINDOW, HW = 2, 5, 16
K = WINDOW // 2


@pytest.mark.parametrize("L,t_step,s_step", [(11, 3, 4), (13, 6, 8), (7, 7, 16), (9, 2, 2)])
def test_numpy_coarsening_bit_equal_to_jax(L, t_step, s_step):
    """A and its adjoint, with L not a multiple of t_step where it can be."""
    rng = np.random.RandomState(L)
    x = rng.randn(L, 16, 16, 3).astype(np.float32)
    got_a, want_a = host_stream.NumpyCoarsening(s_step, t_step), jhost.NumpyCoarsening(s_step, t_step)
    np.testing.assert_array_equal(got_a(x), want_a(x))
    v = rng.randn(-(-L // t_step), 16 // s_step, 16 // s_step, 3).astype(np.float32)
    got, want = got_a.adjoint(v, L), want_a.adjoint(v, L)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)


@pytest.fixture(scope="module")
def tiny():
    cfg = tiny_config(channels=C * WINDOW, window=WINDOW)
    jnet, params = jax_net_and_params(cfg, hw=HW)
    net = torch_net(cfg, params)
    return jnet, params, net


def _port_score(net, batch_size, calls=None):
    def eps_fn(windows, t):
        if calls is not None:
            calls.append(tuple(windows.shape))
        with torch.no_grad():
            return net(windows, t)

    return host_stream.HostStreamingScoreFn(eps_fn, K, batch_size=batch_size, device="cpu")


# L = 11: 7 windows, in chunks of 3 (the last shifted back to [4, 7)), 4, or
# all at once (batch_size >= n)
@pytest.mark.parametrize("batch_size", [3, 4, 7, 20])
def test_host_score_matches_jax_and_window_score(tiny, batch_size):
    jnet, params, net = tiny
    x = np.random.RandomState(batch_size).randn(11, HW, HW, C).astype(np.float32)
    calls = []
    score = _port_score(net, batch_size, calls)
    got = score(x, 0.4)
    n = 11 - WINDOW + 1
    B = min(batch_size, n)
    assert calls == [(B, HW, HW, WINDOW * C)] * (-(-n // B))  # the device path's batches
    assert score.timings["evals"] == 1 and score.timings["eval_s"] >= score.timings["copy_s"] > 0
    want = jhost.HostStreamingScoreFn(jnet.apply, params, K, batch_size=batch_size)(x, 0.4)
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)
    with torch.no_grad():
        dev = WindowScoreFn(lambda w, t: net(w, t), K, chunk_size=batch_size)(torch.from_numpy(x), 0.4)
    np.testing.assert_allclose(got, dev.numpy(), rtol=1e-6, atol=1e-6)


def test_host_score_keeps_every_frame_of_its_chunk():
    """With a window model that returns its input, eps is the trajectory
    itself: each frame comes back from the chunk that owns it, the outer
    frames of the first and last chunk included, at k = 0 too."""
    x = np.random.RandomState(3).randn(17, 4, 4, 3).astype(np.float32)
    for k, batch_size in ((2, 5), (1, 4), (0, 6), (3, 64)):
        score = host_stream.HostStreamingScoreFn(lambda w, t: w, k, batch_size=batch_size, device="cpu")
        np.testing.assert_array_equal(score(x, 0.5), x)


@pytest.mark.parametrize("batch_size", [3, 20])
def test_host_score_one_staging_slot_gives_the_same_bits(tiny, batch_size):
    """One staging buffer a direction (copies wait for each chunk's
    forward) gives the bits of two."""
    _, _, net = tiny
    x = np.random.RandomState(5).randn(11, HW, HW, C).astype(np.float32)
    two, one = _port_score(net, batch_size), _port_score(net, batch_size)
    one.slots = 1
    np.testing.assert_array_equal(one(x, 0.4), two(x, 0.4))
    assert [len(v) for v in one._staging.values()] == [2] and [len(v) for v in two._staging.values()] == [4]


def test_host_score_runs_on_the_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        host_stream.HostStreamingScoreFn(lambda w, t: w, K)


def test_inplace_step_rules_equal_jax():
    rng = np.random.RandomState(0)
    x, eps, z = (rng.randn(5, 4, 4, 2).astype(np.float32) for _ in range(3))
    for proc_x0 in (None, lambda a: np.clip(a, -1.0, 1.0)):
        got = steprules.ddim_step_inplace(x.copy(), eps.copy(), 0.7, 0.4, 0.8, 0.3, proc_x0=proc_x0)
        want = jsteprules.ddim_step_inplace(x.copy(), eps.copy(), 0.7, 0.4, 0.8, 0.3, proc_x0=proc_x0)
        np.testing.assert_array_equal(got, want)
    for scale in (None, 0.25):
        got = steprules.langevin_step_inplace(x.copy(), eps.copy(), z.copy(), 0.05, 0.3, noise_scale=scale)
        want = jsteprules.langevin_step_inplace(x.copy(), eps.copy(), z.copy(), 0.05, 0.3, noise_scale=scale)
        np.testing.assert_array_equal(got, want)


# -- the samplers with an analytic score ------------------------------------

L_A, HW_A = 11, 8
MEAN, VAR = 0.3, 0.5


def _f32_schedule(t, eta=1e-3):
    """mu, sigma of the cosine schedule in numpy float32, the same on both
    sides, so that the score itself cannot differ."""
    a = np.float32(np.cos(np.float32(np.arccos(np.sqrt(eta))) * np.float32(t))) ** 2
    return a, np.float32(np.sqrt(np.float32(1.0) - a * a + np.float32(eta * eta)))


def analytic_score(x, t):
    """eps of Gaussian data N(MEAN, VAR): sigma (x - mu m) / (mu^2 v + sigma^2)."""
    mu, sigma = _f32_schedule(t)
    return (sigma * (x - mu * np.float32(MEAN)) / (mu * mu * np.float32(VAR) + sigma * sigma)).astype(np.float32)


def _guided_inputs(seed=0):
    rng = np.random.RandomState(seed)
    noise = rng.randn(L_A, HW_A, HW_A, C).astype(np.float32)
    gt = (MEAN + np.sqrt(VAR) * rng.randn(L_A, HW_A, HW_A, C)).astype(np.float32)
    A = host_stream.NumpyCoarsening(s_step=4, t_step=3)
    std = np.asarray([0.2, 0.3], np.float32)
    return noise, dict(guidance_y=A(gt), guidance_std=std, guidance_gamma=7e-4)


def _both(kind, guided=True, **kw):
    noise, g = _guided_inputs()
    if not guided:
        g = {}
    got_fn = host_stream.sample_host if kind == "pc" else host_stream.sample_host_dpm
    want_fn = jhost.sample_host if kind == "pc" else jhost.sample_host_dpm
    got = got_fn(VPCosineProcess(), analytic_score, noise, seed=11,
                 guidance_A=host_stream.NumpyCoarsening(4, 3) if guided else None, **g, **kw)
    want = want_fn(JaxProcess(), analytic_score, noise, seed=11,
                   guidance_A=jhost.NumpyCoarsening(4, 3) if guided else None, **g, **kw)
    return got, want


# The two processes' schedules are fp32 from torch's and XLA's cos, sqrt,
# log and expm1, which may round differently by an ulp; the draws are the
# same numbers. 1e-6 of the output's largest magnitude covers an ulp's
# relative error (6e-8) carried through the steps.
def _close(got, want):
    assert np.isfinite(got).all() and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6 * float(np.abs(want).max()))


@pytest.mark.parametrize("variance_exact", [False, True])
def test_sample_host_pc_matches_jax(variance_exact):
    got, want = _both("pc", steps=8, corrections=2, tau=0.5, corrector_variance_exact=variance_exact)
    _close(got, want)


@pytest.mark.parametrize("sde_eta", [0.0, 0.3])
def test_sample_host_dpm_matches_jax(sde_eta, monkeypatch):
    """Bit for bit against JAX's sampler given the port's fp32 step
    coefficients; against JAX's own coefficients within 1e-4 of the output's
    scale. There growth = -expm1(-h) mu(t_cur) comes out one ulp apart at two
    of the eight steps (XLA's expm1 against torch's), and the guided reverse
    dynamics (x0 = (x - sigma eps) / mu with mu(1) = 1e-3, the guidance's
    gain 1 / (s_step^2 gamma) = 89 in the observed subspace) carry that ulp
    to 3.9e-5 of the scale at eta = 0."""
    kw = dict(steps=8, sde_eta=sde_eta, frame_slab=4, denoise_final=True)
    got, want = _both("dpm", **kw)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * float(np.abs(want).max()))
    port = VPCosineProcess()
    monkeypatch.setattr(jsteprules, "dpm_scalar_coeffs", lambda p, a, b, h: tuple(
        float(v) for v in steprules.dpm_scalar_coeffs(port, a, b, h)))
    monkeypatch.setattr(jsteprules, "dpm_sde_scalar_coeffs", lambda p, a, b, h, eta: tuple(
        float(v) for v in steprules.dpm_sde_scalar_coeffs(port, a, b, h, eta)))
    got, want = _both("dpm", **kw)
    assert np.isfinite(got).all()
    np.testing.assert_array_equal(got, want)


def test_sample_host_unguided_matches_jax():
    got, want = _both("pc", guided=False, steps=6, corrections=1, tau=0.3)
    _close(got, want)
    got, want = _both("dpm", guided=False, steps=6, sde_eta=1.0, frame_slab=3)
    _close(got, want)


def test_seeded_sde_is_reproducible_and_differs_from_the_ode():
    noise, g = _guided_inputs()
    run = lambda eta, seed: host_stream.sample_host_dpm(VPCosineProcess(), analytic_score, noise, steps=6,  # noqa: E731
                                                       sde_eta=eta, seed=seed, frame_slab=4)
    np.testing.assert_array_equal(run(0.3, 5), run(0.3, 5))
    assert not np.allclose(run(0.3, 5), run(0.3, 6)) and not np.allclose(run(0.3, 5), run(0.0, 5))


@pytest.mark.parametrize("kind", ["pc", "dpm"])
def test_denoise_final_returns_the_point_mass(kind):
    """An exact point-mass score: the default keeps the sigma(0) = eta
    residual, denoise_final returns the point."""
    proc, c = VPCosineProcess(), -0.42

    def score_fn(x, t):
        return ((x - float(proc.mu(t)) * c) / float(proc.sigma(t))).astype(np.float32)

    sample = host_stream.sample_host if kind == "pc" else host_stream.sample_host_dpm
    noise = np.random.RandomState(0).randn(3, 4, 4, 2).astype(np.float32)
    plain = sample(proc, score_fn, noise, steps=16)
    den = sample(proc, score_fn, noise, steps=16, denoise_final=True)
    assert np.abs(den - c).max() < 1e-5
    assert np.abs(den - c).max() < 1e-2 * np.abs(plain - c).max()


@pytest.mark.parametrize("kind", ["pc", "dpm"])
def test_non_finite_step_raises(kind):
    def score_fn(x, t):
        return np.full_like(x, np.nan if t < 0.5 else 0.0)

    sample = host_stream.sample_host if kind == "pc" else host_stream.sample_host_dpm
    with pytest.raises(FloatingPointError, match="NaN detected in sample at step"):
        sample(VPCosineProcess(), score_fn, np.zeros((3, 4, 4, 2), np.float32), steps=4)


@pytest.mark.parametrize("kind", ["pc", "dpm"])
def test_observation_with_the_wrong_row_count_raises(kind):
    noise, g = _guided_inputs()
    g["guidance_y"] = g["guidance_y"][:-1]  # 3 rows where 11 frames at t_step 3 give 4
    sample = host_stream.sample_host if kind == "pc" else host_stream.sample_host_dpm
    with pytest.raises(ValueError, match="requires exactly 4"):
        sample(VPCosineProcess(), analytic_score, noise, steps=2,
               guidance_A=host_stream.NumpyCoarsening(4, 3), **g)


# -- the samplers with the tiny net, at tests/test_host_stream.py's bars -----

def _tiny_inputs():
    rng = np.random.RandomState(7)
    noise = rng.randn(9, HW, HW, C).astype(np.float32)
    gt = rng.randn(9, HW, HW, C).astype(np.float32)
    y = host_stream.NumpyCoarsening(4, 3)(gt)
    return noise, dict(guidance_y=y, guidance_std=np.asarray([0.2, 0.3], np.float32), guidance_gamma=7e-4)


def test_sample_host_with_the_tiny_net_matches_jax(tiny):
    jnet, params, net = tiny
    noise, g = _tiny_inputs()
    got = host_stream.sample_host(VPCosineProcess(), _port_score(net, 4), noise, steps=4, corrections=1, tau=0.5,
                                  guidance_A=host_stream.NumpyCoarsening(4, 3), seed=3, **g)
    want = jhost.sample_host(JaxProcess(), jhost.HostStreamingScoreFn(jnet.apply, params, K, batch_size=4), noise,
                             steps=4, corrections=1, tau=0.5, guidance_A=jhost.NumpyCoarsening(4, 3), seed=3, **g)
    np.testing.assert_allclose(got, want, rtol=5e-2, atol=5e-2)


@pytest.mark.parametrize("sde_eta", [0.0, 0.3])
def test_sample_host_dpm_with_the_tiny_net_matches_jax(tiny, sde_eta):
    jnet, params, net = tiny
    noise, g = _tiny_inputs()
    got = host_stream.sample_host_dpm(VPCosineProcess(), _port_score(net, 4), noise, steps=6, sde_eta=sde_eta,
                                      frame_slab=4, guidance_A=host_stream.NumpyCoarsening(4, 3), seed=3,
                                      denoise_final=True, **g)
    want = jhost.sample_host_dpm(JaxProcess(), jhost.HostStreamingScoreFn(jnet.apply, params, K, batch_size=4),
                                 noise, steps=6, sde_eta=sde_eta, frame_slab=4,
                                 guidance_A=jhost.NumpyCoarsening(4, 3), seed=3, denoise_final=True, **g)
    scale = float(np.std(want))
    np.testing.assert_allclose(got, want, rtol=5e-2, atol=5e-3 * scale)
