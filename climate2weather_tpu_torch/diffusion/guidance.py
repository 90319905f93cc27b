"""Gaussian likelihood guidance through a coarse-graining observation
operator (port of climate2weather_tpu/diffusion/guidance.py, detached mode).

    p(y | x) = N(y | A(x_hat0), var),  var = std^2 + gamma (sigma/mu)^2
    guided_eps = eps - sigma * (1/mu) A^T((y - A(x_hat0)) / var)

Trajectories are NHWC ``[*batch, L, H, W, C]``; the observation ``y`` is
``[lo, h, w, C]`` and is shared by every leading index. Fourier work runs in
complex64 through ``torch.fft``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Union

import numpy as np
import torch


def _fft2_shifted(x: torch.Tensor) -> torch.Tensor:
    """fftshift(fft2) over the two spatial axes of [..., H, W, C]."""
    return torch.fft.fftshift(torch.fft.fft2(x, dim=(-3, -2)), dim=(-3, -2))


def _ifft2_unshifted(spec: torch.Tensor) -> torch.Tensor:
    return torch.fft.ifft2(torch.fft.ifftshift(spec, dim=(-3, -2)), dim=(-3, -2)).real


@dataclass(frozen=True)
class SpatioTemporalCoarsening:
    """A = spatial ``s_step`` x ``s_step`` average pooling after temporal
    ``::t_step`` subsampling; ``adjoint`` is its exact transpose."""

    s_step: int = 16
    t_step: int = 6

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        x = x[..., :: self.t_step, :, :, :]
        *lead, lo, H, W, C = x.shape
        s = self.s_step
        return x.reshape(*lead, lo, H // s, s, W // s, s, C).mean(dim=(-4, -2))

    def out_times(self, length: int) -> int:
        return -(-length // self.t_step)

    def _scatter_times(self, u: torch.Tensor, out_len: int) -> torch.Tensor:
        """[..., lo, H, W, C] -> [..., out_len, H, W, C], rows at ::t_step,
        zeros elsewhere."""
        out = u.new_zeros((*u.shape[:-4], out_len, *u.shape[-3:]))
        out[..., :: self.t_step, :, :, :] = u[..., : self.out_times(out_len), :, :, :]
        return out

    def adjoint_spatial(self, v: torch.Tensor) -> torch.Tensor:
        """The spatial part of :meth:`adjoint`: [..., h, w, C] -> [..., H, W, C]."""
        s = self.s_step
        return v.repeat_interleave(s, dim=-3).repeat_interleave(s, dim=-2) / (s * s)

    def adjoint(self, v: torch.Tensor, out_len: int) -> torch.Tensor:
        return self._scatter_times(self.adjoint_spatial(v), out_len)

    def prolong_spatial(self, v: torch.Tensor, method: str = "spectral") -> torch.Tensor:
        """The spatial part of :meth:`prolong`, in fp32: [..., h, w, C] ->
        [..., H, W, C]."""
        if method != "spectral":
            raise NotImplementedError(f"prolong method {method!r} is not ported (spectral only)")
        *_, h, w, C = v.shape
        s = self.s_step
        spec = _fft2_shifted(v.float())
        pad = spec.new_zeros((*v.shape[:-3], h * s, w * s, C))
        y0, x0 = (h * s - h) // 2, (w * s - w) // 2
        pad[..., y0 : y0 + h, x0 : x0 + w, :] = spec
        return _ifft2_unshifted(pad)

    def prolong(self, v: torch.Tensor, out_len: int, method: str = "spectral") -> torch.Tensor:
        """Band-limited prolongation of the coarse residual with the adjoint's
        1/s^2 gain: the residual's spectrum zero-padded onto the fine grid.
        Only ``spectral`` is ported; ``bilinear`` raises."""
        return self._scatter_times(self.prolong_spatial(v, method), out_len).to(v.dtype)

    def project(self, x: torch.Tensor, y: torch.Tensor, iters: int = 3,
                method: str = "spectral") -> torch.Tensor:
        """x' with A(x') = y at the observed frames, other frames untouched.

        ``block`` adds the piecewise-constant right-inverse s^2 A^T(y - A x)
        (exact in one pass); ``spectral`` adds the minimum-norm band-limited
        correction (residual spectrum divided by the Dirichlet gains of block
        averaging, zero-padded), polished by ``iters`` Richardson passes.
        """
        if method == "block":
            r = y.float() - self(x).float()
            return (x.float() + float(self.s_step**2) * self.adjoint(r, x.shape[-4])).to(x.dtype)
        if method != "spectral":
            raise ValueError(f"project supports 'spectral' | 'block' (got {method!r})")
        lo, h, w, C = y.shape
        L = x.shape[-4]
        s = self.s_step
        Hf, Wf = h * s, w * s

        def gain(n_coarse, n_fine):
            k = np.fft.fftfreq(n_coarse) * n_coarse
            with np.errstate(invalid="ignore", divide="ignore"):
                d = np.sin(np.pi * k * s / n_fine) / (s * np.sin(np.pi * k / n_fine))
            d[k == 0] = 1.0
            return d * np.exp(1j * np.pi * k * (s - 1) / n_fine)

        D = np.fft.fftshift(np.outer(gain(h, Hf), gain(w, Wf))).astype(np.complex64)
        D = torch.from_numpy(D).to(x.device)[:, :, None]
        y0, x0 = (Hf - h) // 2, (Wf - w) // 2
        for _ in range(int(iters)):
            r = y.float() - self(x).float()
            spec = _fft2_shifted(r) / D
            pad = spec.new_zeros((*r.shape[:-3], Hf, Wf, C))
            pad[..., y0 : y0 + h, x0 : x0 + w, :] = spec
            up = _ifft2_unshifted(pad) * float(s * s)
            x = (x.float() + self._scatter_times(up, L)).to(x.dtype)
        return x


def per_channel(values, num_channels: int, device=None) -> torch.Tensor:
    """fp32 scalar, or a [C] vector that broadcasts over [..., H, W, C]."""
    v = torch.as_tensor(np.asarray(values, np.float32), device=device)
    if v.dim() == 0:
        return v
    if tuple(v.shape) != (num_channels,):
        raise ValueError(f"expected a scalar or {num_channels} values, got shape {tuple(v.shape)}")
    return v


@dataclass
class GaussianGuidance:
    """Likelihood-guided eps prediction in the detached (production) mode.

    ``exact_grad`` (autodiff through the network) is not ported and raises. ``prolong``
    spreads the residual with :meth:`SpatioTemporalCoarsening.prolong`;
    ``anneal`` scales the correction by ``min(t / anneal, 1)``.
    """

    A: SpatioTemporalCoarsening
    y: torch.Tensor
    std: Union[float, torch.Tensor] = 1e-2
    gamma: Union[float, torch.Tensor] = 1e-2
    exact_grad: bool = False
    prolong: Union[bool, str] = False
    anneal: float = 0.0

    def __post_init__(self):
        if self.exact_grad:
            raise NotImplementedError(
                "exact-gradient guidance (use_exact_grad) is not ported; the detached "
                "guidance is"
            )

    def anneal_weight(self, t) -> float:
        if not self.anneal:
            return 1.0
        w = torch.clamp(torch.as_tensor(t, dtype=torch.float32) / float(self.anneal), 0.0, 1.0)
        return float(w)

    def guided_eps(self, score_fn: Callable, process, x: torch.Tensor, t) -> torch.Tensor:
        """eps - sigma grad log p(y | x_t) on [*batch, L, H, W, C]."""
        check_observation_shape(self, x.shape[-4:])
        mu, sigma = process.mu(t), process.sigma(t)
        ratio2 = float((sigma / mu) ** 2)
        std = torch.as_tensor(self.std, dtype=torch.float32, device=x.device)
        gamma = torch.as_tensor(self.gamma, dtype=torch.float32, device=x.device)
        var = std**2 + gamma * ratio2
        L = x.shape[-4]
        eps = score_fn(x, t)
        x0 = process.denoise(x, t, eps)
        err = (self.y.float() - self.A(x0).float()) / var
        if self.prolong:
            method = self.prolong if isinstance(self.prolong, str) else "spectral"
            spread = self.A.prolong(err.to(x.dtype), L, method=method)
        else:
            spread = self.A.adjoint(err.to(x.dtype), L)
        grad = spread / float(mu)
        return eps - (self.anneal_weight(t) * float(sigma)) * grad


def check_observation_shape(guidance, trajectory_shape_nhwc) -> None:
    """Raise unless ``guidance.y`` is A's output for an [L, H, W, C] trajectory."""
    if guidance is None:
        return
    L, H, W, C = trajectory_shape_nhwc
    expected = (guidance.A.out_times(L), H // guidance.A.s_step, W // guidance.A.s_step, C)
    if tuple(guidance.y.shape) != expected:
        raise ValueError(
            f"observation shape {tuple(guidance.y.shape)} does not match the "
            f"trajectory: A(x) for L={L} frames of [{H},{W},{C}] gives "
            f"{expected} (t_step={guidance.A.t_step}, s_step={guidance.A.s_step})"
        )
