"""Noise process, DPM-Solver++(2M) step rules, the lambda time grid and the
sampler against the JAX package, with the JAX per-step noise injected."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import close, jax_split_normals, n, t
from climate2weather_tpu.diffusion import sampler as jsampler
from climate2weather_tpu.diffusion import steprules as jrules
from climate2weather_tpu.diffusion.process import VPCosineProcess as JaxProcess
from climate2weather_tpu_torch.diffusion import sampler, steprules
from climate2weather_tpu_torch.diffusion.process import VPCosineProcess, construct_process

TIMES = np.array([0.0, 1e-4, 0.013, 0.25, 0.5, 0.77, 0.999, 1.0], np.float32)


@pytest.mark.parametrize("fn", ["alpha", "mu", "sigma"])
def test_schedule(fn):
    close(getattr(VPCosineProcess(), fn)(t(TIMES)), getattr(JaxProcess(), fn)(jnp.asarray(TIMES)))


def test_denoise_renoise():
    rng = np.random.RandomState(0)
    x, eps = rng.randn(2, 4, 4, 3).astype(np.float32), rng.randn(2, 4, 4, 3).astype(np.float32)
    p, jp = VPCosineProcess(), JaxProcess()
    for tt in (0.0, 0.3, 0.9):
        close(p.denoise(t(x), tt, t(eps)), jp.denoise(jnp.asarray(x), tt, jnp.asarray(eps)))
        close(p.renoise(t(x), tt, t(eps)), jp.renoise(jnp.asarray(x), tt, jnp.asarray(eps)))


def test_perturb_and_loss_statistics():
    p = VPCosineProcess()
    x = torch.ones(4096, 2)
    g = torch.Generator().manual_seed(0)
    xt, eps = p.perturb(x, 0.5, g)
    close(xt - p.sigma(0.5) * eps, p.mu(0.5) * x, atol=1e-5)
    loss = p.loss(lambda xt, tt, f: torch.zeros_like(xt), x, generator=g)
    assert abs(float(loss) - 1.0) < 0.05  # E[eps^2] = 1


def test_construct_process_by_snapshot_name():
    assert construct_process("vp_cosine") == VPCosineProcess()
    assert construct_process("sda_pipeline", eta=1e-2).eta == 1e-2
    with pytest.raises(ValueError):
        construct_process("edm")


@pytest.mark.parametrize("i", range(1, 7))
def test_dpm_coefficients(i):
    grid = np.asarray(jsampler.logsnr_time_grid(JaxProcess(), 8))
    tp, tc, prev_h = grid[i], grid[i + 1], np.float32(0.37)
    got = steprules.dpm_scalar_coeffs(VPCosineProcess(), float(tp), float(tc), prev_h)
    want = jrules.dpm_scalar_coeffs(JaxProcess(), jnp.float32(tp), jnp.float32(tc), jnp.float32(prev_h))
    for g, w in zip(got, want):
        close(g, w, rtol=1e-5, atol=1e-6)
    got = steprules.dpm_sde_scalar_coeffs(VPCosineProcess(), float(tp), float(tc), prev_h, 0.3)
    want = jrules.dpm_sde_scalar_coeffs(JaxProcess(), jnp.float32(tp), jnp.float32(tc),
                                        jnp.float32(prev_h), 0.3)
    for g, w in zip(got, want):
        close(g, w, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("use_multi", [False, True])
def test_step_functions(use_multi):
    rng = np.random.RandomState(3)
    x, x0, px0, z = (rng.randn(3, 5).astype(np.float32) for _ in range(4))
    J = jnp.asarray
    close(steprules.dpm_data_estimate(t(x0), t(px0), 1.3, 0.3, use_multi),
          jrules.dpm_data_estimate(J(x0), J(px0), 1.3, 0.3, use_multi))
    close(steprules.dpm_step(t(x), t(x0), 0.9, 0.2), jrules.dpm_step(J(x), J(x0), 0.9, 0.2))
    close(steprules.dpm_sde_step(t(x), t(x0), t(px0), t(z), 0.8, 0.3, 0.1, 0.05, use_multi),
          jrules.dpm_sde_step(J(x), J(x0), J(px0), J(z), 0.8, 0.3, 0.1, 0.05, use_multi))


@pytest.mark.parametrize("steps", [4, 64])
def test_logsnr_time_grid(steps):
    got = sampler.logsnr_time_grid(VPCosineProcess(), steps)
    want = np.asarray(jsampler.logsnr_time_grid(JaxProcess(), steps))
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def _linear_score(W):
    """A cheap deterministic eps model, the same on both sides."""
    def jax_fn(x, tt):
        return jnp.tanh(x @ jnp.asarray(W)) * (0.5 + tt)

    def torch_fn(x, tt):
        return torch.tanh(x @ t(W)) * (0.5 + float(tt))

    return jax_fn, torch_fn


@pytest.mark.parametrize("sde_eta", [0.0, 0.3])
@pytest.mark.parametrize("denoise_final", [False, True])
@pytest.mark.parametrize("lambda_spacing", [True, False])
def test_sample_dpmpp2m_matches_jax(sde_eta, denoise_final, lambda_spacing):
    rng = np.random.RandomState(7)
    steps, shape = 12, (5, 3, 3, 4)
    W = (rng.randn(4, 4) / 2).astype(np.float32)
    noise = rng.randn(*shape).astype(np.float32)
    jax_fn, torch_fn = _linear_score(W)
    key = jax.random.PRNGKey(11)
    want, want_nan = jsampler.sample_dpmpp2m(
        JaxProcess(), jax_fn, jnp.asarray(noise), steps=steps, rng=key, sde_eta=sde_eta,
        denoise_final=denoise_final, lambda_spacing=lambda_spacing,
    )
    z = [t(zi) for zi in jax_split_normals(key, steps, shape)] if sde_eta else None
    got, got_nan = sampler.sample_dpmpp2m(
        VPCosineProcess(), torch_fn, t(noise), steps=steps, z=z, sde_eta=sde_eta,
        denoise_final=denoise_final, lambda_spacing=lambda_spacing,
    )
    close(got, want)
    assert bool(got_nan) == bool(want_nan) is False


def test_batched_members_match_one_by_one_and_flag_nan_per_member():
    rng = np.random.RandomState(8)
    steps, shape = 6, (2, 5, 3, 3, 4)
    W = (rng.randn(4, 4) / 2).astype(np.float32)
    noise = rng.randn(*shape).astype(np.float32)
    _, torch_fn = _linear_score(W)
    z = [t(rng.randn(*shape)) for _ in range(steps)]
    both, flags = sampler.sample_dpmpp2m(VPCosineProcess(), torch_fn, t(noise), steps=steps,
                                         z=z, sde_eta=0.3, batch_dims=1)
    for m in range(2):
        one, _ = sampler.sample_dpmpp2m(VPCosineProcess(), torch_fn, t(noise[m]), steps=steps,
                                        z=[zi[m] for zi in z], sde_eta=0.3)
        close(both[m], one, rtol=1e-6, atol=1e-6)
    assert flags.tolist() == [False, False]
    noise[1, 0, 0, 0, 0] = np.nan
    _, flags = sampler.sample_dpmpp2m(VPCosineProcess(), torch_fn, t(noise), steps=2,
                                      batch_dims=1)
    assert flags.tolist() == [False, True]


def test_generators_give_per_member_streams():
    shape = (2, 3, 4)
    gens = [torch.Generator().manual_seed(s) for s in (5, 6)]
    z = sampler.draw_normal(shape, gens, "cpu", batch_dims=1)
    np.testing.assert_array_equal(n(z[1]), n(torch.randn(3, 4, generator=torch.Generator().manual_seed(6))))
    with pytest.raises(ValueError):
        sampler.draw_normal(shape, gens[:1], "cpu", batch_dims=1)


def test_sde_requires_noise_source():
    with pytest.raises(ValueError):
        sampler.sample_dpmpp2m(VPCosineProcess(), lambda x, tt: x, torch.zeros(3), steps=2, sde_eta=0.3)
    with pytest.raises(ValueError):
        sampler.sample_dpmpp2m(VPCosineProcess(), lambda x, tt: x, torch.zeros(3), steps=2, sde_eta=-1)
