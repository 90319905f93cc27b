"""DPM-Solver++(2M) update formulas, deterministic and SDE (port of
climate2weather_tpu/diffusion/steprules.py).

The coefficient functions compute fp32 scalars from the schedule (host
tensors); the step functions are plain arithmetic on the state with those
coefficients given as Python floats or tensors of the state's dtype.
"""

from __future__ import annotations

import torch

__all__ = [
    "dpm_scalar_coeffs",
    "dpm_data_estimate",
    "dpm_step",
    "dpm_sde_scalar_coeffs",
    "dpm_sde_step",
]


def _lambda(process, t) -> torch.Tensor:
    return torch.log(process.mu(t)) - torch.log(process.sigma(t))


def dpm_scalar_coeffs(process, t_prev, t_cur, prev_h):
    """fp32 ``(h, sigma_ratio, growth, c_cur, c_prev)`` of one DPM++(2M) step:
    h = lambda(t_cur) - lambda(t_prev), growth = -expm1(-h) mu(t_cur),
    c_cur = 1 + 1/(2r), c_prev = 1/(2r), r = prev_h / h."""
    h = _lambda(process, t_cur) - _lambda(process, t_prev)
    r = torch.as_tensor(prev_h, dtype=torch.float32) / h
    sigma_ratio = process.sigma(t_cur) / process.sigma(t_prev)
    growth = -torch.expm1(-h) * process.mu(t_cur)
    c_cur = 1.0 + 1.0 / (2.0 * r)
    c_prev = 1.0 / (2.0 * r)
    return h, sigma_ratio, growth, c_cur, c_prev


def dpm_data_estimate(x0, prev_x0, c_cur, c_prev, use_multi: bool):
    """The second-order data estimate, or x0 on the first step."""
    return c_cur * x0 - c_prev * prev_x0 if use_multi else x0


def dpm_step(x, d, sigma_ratio, growth):
    """x <- sigma_ratio x + growth D."""
    return sigma_ratio * x + growth * d


def dpm_sde_scalar_coeffs(process, t_prev, t_cur, prev_h, eta: float):
    """fp32 ``(h, decay, growth, corr, nscale)`` of one SDE-DPM-Solver++(2M)
    step (midpoint form):

        decay  = (sigma(t_cur)/sigma(t_prev)) exp(-eta h)
        growth = mu(t_cur) (1 - exp(-(1 + eta) h))
        corr   = growth (h / prev_h) / 2
        nscale = sigma(t_cur) sqrt(1 - exp(-2 eta h))
    """
    h = _lambda(process, t_cur) - _lambda(process, t_prev)
    decay = (process.sigma(t_cur) / process.sigma(t_prev)) * torch.exp(-eta * h)
    growth = -torch.expm1(-(1.0 + eta) * h) * process.mu(t_cur)
    corr = 0.5 * growth * (h / torch.as_tensor(prev_h, dtype=torch.float32))
    nscale = process.sigma(t_cur) * torch.sqrt(-torch.expm1(-2.0 * eta * h))
    return h, decay, growth, corr, nscale


def dpm_sde_step(x, x0, prev_x0, z, decay, growth, corr, nscale, use_multi: bool):
    """x <- decay x + growth x0 + nscale z [+ corr (x0 - prev_x0)]; the
    multistep term is off on the first step, where prev_x0 is undefined."""
    x = decay * x + growth * x0 + nscale * z
    return x + corr * (x0 - prev_x0) if use_multi else x
