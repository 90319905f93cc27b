"""Variance-preserving cosine noise process (port of
climate2weather_tpu/diffusion/process.py).

    alpha(t) = cos(acos(sqrt(eta)) t)^2,  mu = alpha,
    sigma(t) = sqrt(1 - alpha^2 + eta^2)

Schedule math runs in float32 on the host (``t`` is a float or a CPU
tensor); the samplers turn the results into Python floats, which enter the
device arithmetic as fp32 scalars without a host-device transfer.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Optional

import torch

from climate2weather_tpu_torch.utils.registry import register


def _f32(t) -> torch.Tensor:
    return torch.as_tensor(t, dtype=torch.float32)


@register("vp_cosine")
@register("sda_pipeline")  # the reference's name (thor.pipelines.SDAPipeline)
@dataclass(frozen=True)
class VPCosineProcess:
    """Cosine VP diffusion process with stability floor ``eta``."""

    eta: float = 1e-3

    def alpha(self, t) -> torch.Tensor:
        return torch.cos(math.acos(math.sqrt(self.eta)) * _f32(t)) ** 2

    def mu(self, t) -> torch.Tensor:
        return self.alpha(t)

    def sigma(self, t) -> torch.Tensor:
        a = self.alpha(t)
        return torch.sqrt(1.0 - a**2 + self.eta**2)

    def perturb(self, x: torch.Tensor, t, generator: Optional[torch.Generator] = None,
                eps: Optional[torch.Tensor] = None):
        """x_t ~ N(mu(t) x, sigma(t)^2 I); returns (x_t, eps). ``eps`` is
        drawn from ``generator`` unless given."""
        if eps is None:
            eps = torch.randn(x.shape, generator=generator, device=x.device, dtype=x.dtype)
        else:
            eps = eps.to(device=x.device, dtype=x.dtype)
        mu = self.mu(t).to(device=x.device, dtype=x.dtype)
        sigma = self.sigma(t).to(device=x.device, dtype=x.dtype)
        return mu * x + sigma * eps, eps

    def loss(self, eps_model: Callable, x: torch.Tensor, forcing=None,
             generator: Optional[torch.Generator] = None, t: Optional[torch.Tensor] = None,
             eps: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Denoising score-matching loss, mean over batch and elements, with
        per-sample t ~ U(0, 1) shaped [B, 1, ..., 1]. ``t`` and then ``eps``
        are drawn from ``generator`` unless given (the tests give the JAX
        package's draws)."""
        b = x.shape[0]
        if t is None:
            t = torch.rand((b,) + (1,) * (x.dim() - 1), generator=generator, device=x.device)
        xt, eps = self.perturb(x, t, generator, eps)
        err = eps_model(xt, t, forcing).float() - eps.float()
        return torch.mean(err**2)

    def denoise(self, x: torch.Tensor, t, eps: torch.Tensor) -> torch.Tensor:
        """Predicted x0 from x_t and the predicted noise."""
        return (x - float(self.sigma(t)) * eps) / float(self.mu(t))

    def renoise(self, x0: torch.Tensor, t, eps: torch.Tensor) -> torch.Tensor:
        return float(self.mu(t)) * x0 + float(self.sigma(t)) * eps


PROCESSES = {"vp_cosine": VPCosineProcess, "sda_pipeline": VPCosineProcess}


def construct_process(class_name: str, **kwargs) -> VPCosineProcess:
    """The process a snapshot's ``pipeline_kwargs`` name."""
    if class_name not in PROCESSES:
        raise ValueError(f"unknown noise process {class_name!r}; the port has {sorted(PROCESSES)}")
    return PROCESSES[class_name](**kwargs)
