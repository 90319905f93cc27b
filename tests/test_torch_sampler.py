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


@pytest.mark.parametrize("corrections,exact", [(0, False), (1, False), (2, True)])
@pytest.mark.parametrize("denoise_final", [False, True])
def test_pc_sample_matches_jax(corrections, exact, denoise_final):
    """The predictor-corrector sampler of the training loop's validation
    against JAX's ``sample``, the corrector noise JAX draws (one ``split``
    per corrector step) injected; rtol/atol 2e-4."""
    rng = np.random.RandomState(9)
    steps, shape = 10, (5, 3, 3, 4)
    W = (rng.randn(4, 4) / 2).astype(np.float32)
    noise = rng.randn(*shape).astype(np.float32)
    jax_fn, torch_fn = _linear_score(W)
    key = jax.random.PRNGKey(3)
    kw = dict(steps=steps, corrections=corrections, tau=0.1, corrector_variance_exact=exact,
              denoise_final=denoise_final)
    want, want_nan = jsampler.sample(JaxProcess(), jax_fn, jnp.asarray(noise), rng=key, **kw)
    z = [t(zi) for zi in jax_split_normals(key, steps * corrections, shape)] if corrections else None
    got, got_nan = sampler.sample(VPCosineProcess(), torch_fn, t(noise), z=z, **kw)
    close(got, want)
    assert bool(got_nan) == bool(want_nan) is False


def test_pc_sample_validation_path_matches_jax():
    """The loop's validation sampling: the PC sampler over a window-scored
    tiny net (one window of 5 frames) against JAX's, 8 steps; rtol/atol
    2e-4 of the output's scale, which the untrained net's 1/mu(1) ~ 1e3
    denoising gain makes large."""
    from _torch_parity import jax_net_and_params, tiny_config, torch_net
    from climate2weather_tpu.diffusion.window import WindowScoreFn as JaxWindowScoreFn
    from climate2weather_tpu.diffusion.window import make_batched_eps_fn
    from climate2weather_tpu_torch.diffusion.window import WindowScoreFn

    cfg = tiny_config(channels=10, window=5)
    net, params = jax_net_and_params(cfg)
    noise = np.random.RandomState(4).randn(5, 16, 16, 2).astype(np.float32)
    sf = JaxWindowScoreFn(make_batched_eps_fn(net.apply), params, 2)
    want, _ = jax.jit(lambda x: jsampler.sample(JaxProcess(), sf, x, steps=8))(jnp.asarray(noise))
    port_net = torch_net(cfg, params)
    got, nan = sampler.sample(VPCosineProcess(), WindowScoreFn(lambda w, tt: port_net(w, tt), 2),
                              t(noise), steps=8)
    scale = float(np.abs(np.asarray(want)).max())
    close(got, want, rtol=2e-4, atol=2e-4 * scale)
    assert not bool(nan)


def test_pc_sample_requires_a_corrector_noise_source():
    with pytest.raises(ValueError):
        sampler.sample(VPCosineProcess(), lambda x, tt: x, torch.zeros(3), steps=2, corrections=1)
    with pytest.raises(ValueError):
        sampler.sample(VPCosineProcess(), lambda x, tt: x, torch.zeros(3), steps=2, corrections=1,
                       z=[torch.zeros(3)])


@pytest.mark.parametrize("exact", [False, True])
def test_pc_sample_batched_equals_each_member_alone(exact):
    """With an ensemble as a leading batch dimension, the corrector's
    delta = tau / mean(eps^2) and the NaN flag are per member, as JAX's vmap
    over samples makes them: the batched run equals each member run alone
    (its own draws injected); rtol/atol 2e-4."""
    rng = np.random.RandomState(11)
    steps, corrections, shape = 6, 2, (4, 3, 3, 4)
    W = (rng.randn(4, 4) / 2).astype(np.float32)
    _, torch_fn = _linear_score(W)
    noise = rng.randn(2, *shape).astype(np.float32)
    noise[1] *= 3.0  # members whose mean(eps^2) differ
    z = rng.randn(steps * corrections, 2, *shape).astype(np.float32)
    kw = dict(steps=steps, corrections=corrections, tau=0.2, corrector_variance_exact=exact)
    got, nan = sampler.sample(VPCosineProcess(), torch_fn, t(noise), z=[t(zi) for zi in z],
                              batch_dims=1, **kw)
    assert nan.shape == (2,) and not nan.any()
    for m in range(2):
        alone, _ = sampler.sample(VPCosineProcess(), torch_fn, t(noise[m]), z=[t(zi[m]) for zi in z], **kw)
        close(got[m], alone)
