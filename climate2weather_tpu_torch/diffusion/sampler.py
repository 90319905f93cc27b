"""Samplers (port of climate2weather_tpu/diffusion/sampler.py ``sample``,
``logsnr_time_grid``, ``sample_dpmpp2m``, ``sample_dpmpp3m`` and
``SAMPLERS``): the predictor-corrector sampler that the training loop's
validation runs, DPM-Solver++(2M) and DPM-Solver++(3M).

The JAX ``lax.scan`` becomes a Python loop. The state may carry leading
batch dimensions in front of the trajectory's ``[L, H, W, C]`` (an ensemble
written out as a batch, where JAX ``vmap``s); every per-sample reduction, the
corrector's step size and the NaN flag, is then one per leading index.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Sequence, Union

import numpy as np
import torch

from climate2weather_tpu_torch.diffusion import steprules
from climate2weather_tpu_torch.utils import trace

Generators = Union[torch.Generator, Sequence[torch.Generator]]


@torch.no_grad()
def sample(
    process,
    score_fn: Callable,
    noise: torch.Tensor,
    *,
    steps: int = 64,
    corrections: int = 0,
    tau: float = 1.0,
    corrector_variance_exact: bool = False,
    rng: Optional[Generators] = None,
    z: Optional[Sequence[torch.Tensor]] = None,
    proc_x0: Optional[Callable] = None,
    denoise_final: bool = False,
    batch_dims: int = 0,
):
    """Predictor-corrector reverse diffusion from ``noise``
    [*batch, L, H, W, C]: at each of ``steps`` uniform times t, a DDIM
    predictor (denoise at t, re-noise at t - 1/steps), then ``corrections``
    Langevin corrector steps with delta = tau / mean(eps^2), the mean taken
    per leading index as the JAX ``vmap`` over an ensemble takes it. The
    corrector noise comes from ``rng`` (one generator, or one per leading
    index) or, for tests, from ``z`` (``steps * corrections`` tensors shaped
    like ``noise``, in order). Returns ``(x, nan_detected)``; the flag has
    shape ``noise.shape[:batch_dims]``."""
    if corrections > 0 and rng is None and z is None:
        raise ValueError("corrections > 0 requires an rng generator or injected z")
    if z is not None and len(z) != steps * corrections:
        raise ValueError(f"{len(z)} injected draws for {steps} x {corrections} corrections")
    dt = 1.0 / steps
    # the JAX grid is fp32, and t - dt is an fp32 subtraction there
    times = [float(t) for t in np.linspace(1.0, 0.0, steps + 1, dtype=np.float32)[:-1]]
    x = noise
    lead = noise.shape[:batch_dims]
    per_member = (-1,) + (1,) * (noise.dim() - batch_dims)  # [*batch] -> broadcast over x
    nan_flag = torch.zeros(lead, dtype=torch.bool, device=noise.device)
    draw = 0
    for i, t in enumerate(times):
        t2 = float(np.float32(t) - np.float32(dt))
        with trace.span("c2w.sample.eval", step=i):
            eps = score_fn(x, t)
            with trace.span("c2w.sample.update"):
                x = steprules.ddim_step(
                    x, eps, float(process.mu(t)), float(process.sigma(t)),
                    float(process.mu(t2)), float(process.sigma(t2)), proc_x0=proc_x0,
                )
        for c in range(corrections):
            with trace.span("c2w.sample.eval", step=i, correction=c):
                eps_c = score_fn(x, t2)
                with trace.span("c2w.sample.update"):
                    if z is not None:
                        zc = z[draw].to(device=x.device, dtype=x.dtype)
                    else:
                        zc = draw_normal(x.shape, rng, x.device, batch_dims).to(x.dtype)
                    draw += 1
                    mean_sq = (eps_c.float() ** 2).reshape(*lead, -1).mean(dim=-1)
                    delta = steprules.langevin_delta(tau, mean_sq)
                    noise_scale = steprules.langevin_noise_scale(tau, delta, corrector_variance_exact)
                    if batch_dims:
                        delta, noise_scale = delta.reshape(per_member), noise_scale.reshape(per_member)
                    x = steprules.langevin_step(
                        x, eps_c, zc, delta.to(x.dtype), float(process.sigma(t2)),
                        sqrt2delta=noise_scale.to(x.dtype),
                    )
        nan_flag |= _nan_flag(x, batch_dims)
    if denoise_final:
        x, nan_flag = _denoise_final(process, score_fn, x, proc_x0, nan_flag, batch_dims, len(times))
    return x, nan_flag


def logsnr_time_grid(process, steps: int, grid_points: int = 20001) -> np.ndarray:
    """float32 times t_0 = 1 .. t_steps = 0, uniform in lambda = log(mu/sigma)."""
    tg = np.linspace(0.0, 1.0, grid_points)
    eta = process.eta
    alpha = np.cos(math.acos(math.sqrt(eta)) * tg) ** 2
    sigma = np.sqrt(1.0 - alpha**2 + eta**2)
    lam = np.log(alpha) - np.log(sigma)
    lgrid = np.linspace(lam[-1], lam[0], steps + 1)
    t = np.interp(lgrid, lam[::-1], tg[::-1])
    t[0], t[-1] = 1.0, 0.0
    return t.astype(np.float32)


def _nan_flag(x: torch.Tensor, batch_dims: int) -> torch.Tensor:
    return ~torch.isfinite(x).reshape(*x.shape[:batch_dims], -1).all(dim=-1)


def _denoise_final(process, score_fn: Callable, x: torch.Tensor, proc_x0, nan_flag: torch.Tensor,
                   batch_dims: int, step: int):
    """The posterior mean at t = 0, one more evaluation: ``(x0, nan_flag)``."""
    with trace.span("c2w.sample.eval", step=step):
        eps = score_fn(x, 0.0)
        with trace.span("c2w.sample.update"):
            x = process.denoise(x, 0.0, eps)
            if proc_x0 is not None:
                x = proc_x0(x)
            return x, nan_flag | _nan_flag(x, batch_dims)


def draw_normal(shape, generators: Generators, device, batch_dims: int) -> torch.Tensor:
    """Standard normal fp32 draws; with a sequence of generators, one draw of
    ``shape[batch_dims:]`` per leading index, each from its own generator."""
    if isinstance(generators, torch.Generator):
        return torch.randn(shape, generator=generators, device=device)
    gens = list(generators)
    lead = int(np.prod(shape[:batch_dims], dtype=np.int64))
    if batch_dims == 0 or len(gens) != lead:
        raise ValueError(f"{len(gens)} generators for leading shape {tuple(shape[:batch_dims])}")
    z = [torch.randn(tuple(shape[batch_dims:]), generator=g, device=device) for g in gens]
    return torch.stack(z).reshape(shape)


@torch.no_grad()
def sample_dpmpp2m(
    process,
    score_fn: Callable,
    noise: torch.Tensor,
    *,
    steps: int = 64,
    rng: Optional[Generators] = None,
    z: Optional[Sequence[torch.Tensor]] = None,
    proc_x0: Optional[Callable] = None,
    lambda_spacing: bool = True,
    denoise_final: bool = False,
    sde_eta: float = 0.0,
    batch_dims: int = 0,
):
    """DPM-Solver++(2M) from ``noise`` [*batch, L, H, W, C] (fp32).

    ``sde_eta > 0`` selects the SDE variant, whose per-step noise ``z`` comes
    from ``rng`` (one generator, or one per leading index) or, for tests,
    from the sequence ``z`` (one tensor shaped like ``noise`` per step).
    Returns ``(x, nan_detected)``; the flag has shape ``noise.shape[:batch_dims]``.
    """
    if sde_eta < 0:
        raise ValueError(f"sde_eta must be >= 0, got {sde_eta}")
    if sde_eta > 0 and rng is None and z is None:
        raise ValueError("sde_eta > 0 requires an rng generator or injected z")
    if z is not None and len(z) != steps:
        raise ValueError(f"{len(z)} injected noise draws for {steps} steps")
    if lambda_spacing:
        grid = logsnr_time_grid(process, steps)
    else:
        grid = np.linspace(1.0, 0.0, steps + 1, dtype=np.float32)
    times = [float(t) for t in grid]  # fp32 values, exact as Python floats

    x = noise
    prev_x0 = torch.zeros_like(noise)
    prev_h = torch.ones((), dtype=torch.float32)
    nan_flag = torch.zeros(noise.shape[:batch_dims], dtype=torch.bool, device=noise.device)
    for i in range(steps):
        t_prev, t_cur = times[i], times[i + 1]
        with trace.span("c2w.sample.eval", step=i):
            eps = score_fn(x, t_prev)
            with trace.span("c2w.sample.update"):
                x0 = process.denoise(x, t_prev, eps)
                if proc_x0 is not None:
                    x0 = proc_x0(x0)
                if sde_eta > 0:
                    zi = z[i] if z is not None else draw_normal(x.shape, rng, x.device, batch_dims)
                    h, decay, growth, corr, nscale = steprules.dpm_sde_scalar_coeffs(
                        process, t_prev, t_cur, prev_h, sde_eta
                    )
                    x = steprules.dpm_sde_step(
                        x, x0, prev_x0, zi.to(x.dtype), float(decay), float(growth),
                        float(corr), float(nscale), i > 0,
                    )
                else:
                    h, sigma_ratio, growth, c_cur, c_prev = steprules.dpm_scalar_coeffs(
                        process, t_prev, t_cur, prev_h
                    )
                    d = steprules.dpm_data_estimate(x0, prev_x0, float(c_cur), float(c_prev), i > 0)
                    x = steprules.dpm_step(x, d, float(sigma_ratio), float(growth))
                nan_flag |= _nan_flag(x, batch_dims)
        prev_x0, prev_h = x0, h
    if denoise_final:
        x, nan_flag = _denoise_final(process, score_fn, x, proc_x0, nan_flag, batch_dims, steps)
    return x, nan_flag


@torch.no_grad()
def sample_dpmpp3m(
    process,
    score_fn: Callable,
    noise: torch.Tensor,
    *,
    steps: int = 32,
    rng: Optional[Generators] = None,
    proc_x0: Optional[Callable] = None,
    lambda_spacing: bool = True,
    denoise_final: bool = False,
    batch_dims: int = 0,
):
    """DPM-Solver++(3M) from ``noise`` [*batch, L, H, W, C]: the step
    spacing of :func:`sample_dpmpp2m` with a quadratic extrapolant over the
    last three x0 predictions (``steprules.dpm3_scalar_coeffs``). Step 0 is
    first order (D = x0), step 1 second order (the 2M estimate), the rest
    third order. Deterministic: ``rng`` is accepted, as in JAX, and unused.
    Returns ``(x, nan_detected)``; the flag has shape ``noise.shape[:batch_dims]``."""
    del rng
    if lambda_spacing:
        grid = logsnr_time_grid(process, steps)
    else:
        grid = np.linspace(1.0, 0.0, steps + 1, dtype=np.float32)
    times = [float(t) for t in grid]

    x = noise
    prev_x0 = prev2_x0 = torch.zeros_like(noise)
    prev_h = prev2_h = torch.ones((), dtype=torch.float32)
    nan_flag = torch.zeros(noise.shape[:batch_dims], dtype=torch.bool, device=noise.device)
    for i in range(steps):
        t_prev, t_cur = times[i], times[i + 1]
        with trace.span("c2w.sample.eval", step=i):
            eps = score_fn(x, t_prev)
            with trace.span("c2w.sample.update"):
                x0 = process.denoise(x, t_prev, eps)
                if proc_x0 is not None:
                    x0 = proc_x0(x0)
                h, sigma_ratio, growth, c_cur, c_prev = steprules.dpm_scalar_coeffs(process, t_prev, t_cur, prev_h)
                if i >= 2:
                    _, _, _, w0, w1, w2 = steprules.dpm3_scalar_coeffs(process, t_prev, t_cur, prev_h, prev2_h)
                    d = steprules.dpm3_data_estimate(x0, prev_x0, prev2_x0, float(w0), float(w1), float(w2))
                else:
                    d = steprules.dpm_data_estimate(x0, prev_x0, float(c_cur), float(c_prev), i >= 1)
                x = steprules.dpm_step(x, d, float(sigma_ratio), float(growth))
                nan_flag |= _nan_flag(x, batch_dims)
        prev2_x0, prev_x0, prev2_h, prev_h = prev_x0, x0, prev_h, h
    if denoise_final:
        x, nan_flag = _denoise_final(process, score_fn, x, proc_x0, nan_flag, batch_dims, steps)
    return x, nan_flag


SAMPLERS = {"pc": sample, "dpmpp2m": sample_dpmpp2m, "dpmpp3m": sample_dpmpp3m}
