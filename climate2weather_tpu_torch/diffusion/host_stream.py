"""Host-streaming sampling (port of climate2weather_tpu/diffusion/host_stream.py):
the trajectory lives in host memory, and only window chunks visit the card.

This is the tier for trajectories whose sampler buffers would not fit the
card: the long path (``diffusion/long_sampler.py``) holds several
trajectory-sized buffers in device memory, this one holds none there. Its
bound is host RAM (about three trajectory buffers, fp32 at any length,
plus one adjoint-sized temporary under guidance).

- :class:`HostStreamingScoreFn` evaluates eps over a numpy ``[L, H, W, C]``
  trajectory chunk by chunk, with the chunking of
  :class:`~climate2weather_tpu_torch.diffusion.window.WindowScoreFn` (the
  last chunk shifted back to end at the final window), so the card sees the
  batches of the device path. Each chunk's frames ``[start, start + B + 2k)``
  go to the card through a pinned staging buffer (not its 13x larger
  windows), the windows are formed there by the device path's gather, and
  only the frames the trajectory keeps come back: the owned centres, and the
  outer frames of the first and last chunk. Two staging buffers a direction
  (``slots``) let the host stage chunk i + 1 and store chunk i - 1 while
  the card runs chunk i; with one, each chunk's copies wait for its forward.
- :func:`sample_host` (PC) and :func:`sample_host_dpm` (DPM-Solver++(2M),
  deterministic or SDE) keep JAX's signatures and order of operations: the
  updates run in numpy on the host, in place (the ``*_inplace`` step rules,
  and slabs of ``frame_slab`` frames for DPM-Solver++), under detached
  guidance in its analytic numpy form (:class:`NumpyCoarsening`). The
  per-step noise comes from ``np.random.RandomState(seed)`` in JAX's order
  and shapes, so the port and JAX draw the same numbers.
"""

from __future__ import annotations

import time
from typing import Callable, Optional

import numpy as np
import torch

from climate2weather_tpu_torch.diffusion import steprules
from climate2weather_tpu_torch.diffusion.sampler import logsnr_time_grid
from climate2weather_tpu_torch.diffusion.window import WindowScoreFn, member_pieces, owned_windows
from climate2weather_tpu_torch.utils.device import resolve_device


class NumpyCoarsening:
    """numpy twin of guidance.SpatioTemporalCoarsening (same math)."""

    def __init__(self, s_step: int = 16, t_step: int = 6):
        self.s_step = s_step
        self.t_step = t_step

    def __call__(self, x: np.ndarray) -> np.ndarray:
        x = x[:: self.t_step]
        lo, H, W, C = x.shape
        s = self.s_step
        return x.reshape(lo, H // s, s, W // s, s, C).mean(axis=(2, 4))

    def adjoint(self, v: np.ndarray, out_len: int) -> np.ndarray:
        lo, h, w, C = v.shape
        s = self.s_step
        u = np.broadcast_to(v[:, :, None, :, None, :] / (s * s), (lo, h, s, w, s, C)).reshape(lo, h * s, w * s, C)
        out = np.zeros((out_len, h * s, w * s, C), v.dtype)
        out[:: self.t_step] = u[: -(-out_len // self.t_step)]
        return out


class HostStreamingScoreFn:
    """eps over a host-resident float32 ``[L, H, W, C]`` numpy trajectory.

    ``eps_fn(windows, t)`` maps ``[B, H, W, w*C]`` windows on ``device`` to
    eps of the same shape (the ScoreUNet). Chunks of ``batch_size`` windows
    run on ``device``, the card unless the caller asks for the CPU.
    ``timings`` accumulates ``evals``, ``eval_s`` (host seconds in
    ``__call__``) and ``copy_s`` (of them, the host's copies into and out of
    the staging buffers). ``slots`` is the number of staging buffers a
    direction: 2 overlaps the host's copies with the card's forwards, 1
    copies synchronously (``exp/profile_host_stream.py`` times both).
    """

    slots = 2

    def __init__(self, eps_fn: Callable, markov_order: int, batch_size: int = 128, device="cuda"):
        self.eps_fn = eps_fn
        self.markov_order = int(markov_order)
        self.batch_size = int(batch_size)
        self.device = resolve_device(device)
        self._windows = WindowScoreFn(eps_fn, self.markov_order, chunk_size=self.batch_size)
        self._staging = {}
        self.timings = {"evals": 0, "eval_s": 0.0, "copy_s": 0.0}

    @property
    def window(self) -> int:
        return 2 * self.markov_order + 1

    def _buffers(self, shape) -> list:
        """``slots`` input, then ``slots`` output staging buffers of
        ``shape`` [F, H, W, C] (pinned for the card), kept while calls ask
        for that shape."""
        key = (shape, self.slots)
        if key not in self._staging:
            pin = self.device.type == "cuda"
            self._staging = {key: [torch.empty(shape, dtype=torch.float32, pin_memory=pin)
                                   for _ in range(2 * self.slots)]}
        return self._staging[key]

    def __call__(self, x: np.ndarray, t) -> np.ndarray:
        t_call = time.perf_counter()
        k, w = self.markov_order, self.window
        x = np.ascontiguousarray(x, np.float32)
        L, H, W, C = x.shape
        n, B, n_chunks = self._windows._chunks(L)
        staging = self._buffers((B + w - 1, H, W, C))
        out = np.empty((L, H, W, C), np.float32)
        copy_s, pending = 0.0, None
        for ci in range(n_chunks):
            slot = ci % self.slots
            start = min(ci * B, n - B)
            t_copy = time.perf_counter()
            frames = self._upload(x, start, staging[slot])
            copy_s += time.perf_counter() - t_copy
            xw = self._windows._gather(frames[None], 0, member_pieces(0, B, B))
            o = self.eps_fn(xw, t).to(torch.float32).reshape(B, H, W, w, C)
            # the frames this chunk gives the trajectory, one contiguous range
            parts = [o[: owned_windows(ci, n_chunks, B, n), :, :, k]]
            if k > 0 and ci == 0:
                parts.insert(0, o[0, :, :, :k].permute(2, 0, 1, 3))
            if k > 0 and ci == n_chunks - 1:
                parts.append(o[B - 1, :, :, w - k :].permute(2, 0, 1, 3))
            back = torch.cat(parts) if len(parts) > 1 else parts[0]
            lo = 0 if ci == 0 else k + start
            dst = staging[self.slots + slot][: back.shape[0]]
            dst.copy_(back, non_blocking=True)
            done = None
            if self.device.type == "cuda":
                done = torch.cuda.Event()
                done.record()
            # the chunk's device tensors go before the next chunk's forward,
            # so that any number of chunks peaks as one does
            del frames, o, parts, back
            if pending is not None:
                copy_s += self._store(out, *pending)
            pending = (done, dst, lo)
            if self.slots == 1:  # the slot is free again for the next chunk
                copy_s += self._store(out, *pending)
                pending = None
        if pending is not None:
            copy_s += self._store(out, *pending)
        self.timings["evals"] += 1
        self.timings["copy_s"] += copy_s
        self.timings["eval_s"] += time.perf_counter() - t_call
        return out

    def _upload(self, x: np.ndarray, start: int, stage: torch.Tensor) -> torch.Tensor:
        """The frames [start, start + F) of ``x`` on the device, through the
        staging buffer ``stage`` [F, H, W, C]. A slot's buffers are free
        again when it comes round: the chunk ``slots`` before was stored
        before this one is staged."""
        np.copyto(stage.numpy(), x[start : start + stage.shape[0]])
        return stage.to(self.device, non_blocking=True)

    @staticmethod
    def _store(out: np.ndarray, done, dst: torch.Tensor, lo: int) -> float:
        """Wait for a chunk's copy to the host, then put its frames in place;
        returns the host seconds of the copy."""
        if done is not None:
            done.synchronize()
        t_copy = time.perf_counter()
        out[lo : lo + dst.shape[0]] = dst.numpy()
        return time.perf_counter() - t_copy


def _check_rows(guidance_A, guidance_y, L: int) -> None:
    if guidance_A is not None:
        expected_lo = -(-L // guidance_A.t_step)
        if guidance_y.shape[0] != expected_lo:
            raise ValueError(
                f"observation has {guidance_y.shape[0]} time rows; the {L}-frame trajectory with "
                f"t_step={guidance_A.t_step} requires exactly {expected_lo}"
            )


def _guided(process, score_fn, guidance_A, guidance_y, guidance_std, guidance_gamma, L: int):
    """eps(x, t) with the detached guidance term subtracted in numpy. A is
    linear, so A(x0) = (A(x) - sigma A(eps)) / mu: the full-trajectory x0 is
    never formed; the only trajectory-sized temporary is the adjoint's
    output, consumed in place."""
    std = np.asarray(guidance_std, np.float32)
    gamma = np.asarray(guidance_gamma, np.float32)

    def guided_eps(x, t):
        eps = score_fn(x, float(t))
        if guidance_A is None:
            return eps
        mu = float(process.mu(t))
        sigma = float(process.sigma(t))
        a_x0 = (guidance_A(x) - sigma * guidance_A(eps)) / mu
        err = (guidance_y - a_x0) / (std**2 + gamma * (sigma / mu) ** 2)
        adj = guidance_A.adjoint(err.astype(np.float32), L)
        adj *= sigma / mu
        eps -= adj
        return eps

    return guided_eps


def _denoise_final(process, guided_eps, x: np.ndarray, proc_x0) -> np.ndarray:
    """The guided posterior mean at t = 0, in place: x -= sigma0 eps, x /= mu0."""
    mu0 = float(process.mu(0.0))
    sigma0 = float(process.sigma(0.0))
    eps = guided_eps(x, 0.0)
    eps *= sigma0
    x -= eps
    x /= mu0
    if proc_x0 is not None:
        x = proc_x0(x)
    if not np.isfinite(x).all():
        raise FloatingPointError("NaN detected in final denoise")
    return x


def sample_host(
    process,
    score_fn: Callable,
    noise: np.ndarray,
    *,
    steps: int = 64,
    corrections: int = 0,
    tau: float = 1.0,
    corrector_variance_exact: bool = False,
    guidance_A: Optional[NumpyCoarsening] = None,
    guidance_y: Optional[np.ndarray] = None,
    guidance_std=1e-2,
    guidance_gamma=1e-2,
    seed: int = 0,
    verbose: bool = False,
    proc_x0=None,
    denoise_final: bool = False,
) -> np.ndarray:
    """Predictor-corrector sampling of the numpy trajectory ``noise``
    [L, H, W, C] on the host: ``steps`` uniform DDIM steps, each followed by
    ``corrections`` Langevin steps with delta = tau / mean(eps^2), whose
    noise is drawn from ``np.random.RandomState(seed)``; guidance is the
    detached analytic form. ``proc_x0`` post-processes the denoised
    estimate each predictor step. Raises ``FloatingPointError`` on a
    non-finite step."""
    x = np.asarray(noise, np.float32).copy()
    L = x.shape[0]
    _check_rows(guidance_A, guidance_y, L)
    rng = np.random.RandomState(seed)
    time_steps = np.linspace(1.0, 0.0, steps + 1, dtype=np.float64)
    dt = 1.0 / steps
    guided_eps = _guided(process, score_fn, guidance_A, guidance_y, guidance_std, guidance_gamma, L)

    for i, t in enumerate(time_steps[:-1]):
        mu, sigma = float(process.mu(t)), float(process.sigma(t))
        mu2, sigma2 = float(process.mu(t - dt)), float(process.sigma(t - dt))
        # in place: the peak stays at x + eps (+ the adjoint temporary)
        eps = guided_eps(x, t)
        x = steprules.ddim_step_inplace(x, eps, mu, sigma, mu2, sigma2, proc_x0=proc_x0)
        for _ in range(corrections):
            eps = guided_eps(x, t - dt)
            delta = steprules.langevin_delta(tau, float(np.mean(np.square(eps), dtype=np.float64)))
            z = rng.standard_normal(x.shape).astype(np.float32)
            x = steprules.langevin_step_inplace(
                x, eps, z, delta, sigma2,
                noise_scale=steprules.langevin_noise_scale(tau, delta, corrector_variance_exact))
        if not np.isfinite(x).all():
            raise FloatingPointError(f"NaN detected in sample at step {i}")
        if verbose and (i % 16 == 0 or i == steps - 1):
            print(f"host-stream sampling: step {i + 1}/{steps}", flush=True)
    if denoise_final:
        x = _denoise_final(process, guided_eps, x, proc_x0)
    return x


def sample_host_dpm(
    process,
    score_fn: Callable,
    noise: np.ndarray,
    *,
    steps: int = 64,
    sde_eta: float = 0.0,
    guidance_A: Optional[NumpyCoarsening] = None,
    guidance_y: Optional[np.ndarray] = None,
    guidance_std=1e-2,
    guidance_gamma=1e-2,
    seed: int = 0,
    verbose: bool = False,
    proc_x0=None,
    denoise_final: bool = False,
    frame_slab: int = 256,
) -> np.ndarray:
    """DPM-Solver++(2M) on log-SNR-spaced steps over the numpy trajectory
    ``noise`` [L, H, W, C], with the SDE form for ``sde_eta > 0`` (its noise
    drawn per slab from ``np.random.RandomState(seed)``). One buffer more
    than :func:`sample_host`, the previous x0 prediction: the peak is ~3
    trajectory buffers plus the guidance adjoint's temporary, every update
    running over ``frame_slab``-frame slabs so that numpy forms no
    trajectory-sized expression temporary."""
    if sde_eta < 0:
        raise ValueError(f"sde_eta must be >= 0, got {sde_eta}")
    x = np.asarray(noise, np.float32).copy()
    L = x.shape[0]
    _check_rows(guidance_A, guidance_y, L)
    rng = np.random.RandomState(seed)
    time_steps = np.asarray(logsnr_time_grid(process, steps), np.float64)
    guided_eps = _guided(process, score_fn, guidance_A, guidance_y, guidance_std, guidance_gamma, L)

    slabs = [slice(s, min(s + frame_slab, L)) for s in range(0, L, frame_slab)]
    prev_x0: Optional[np.ndarray] = None
    prev_h = 1.0
    for i, (t_prev, t_cur) in enumerate(zip(time_steps[:-1], time_steps[1:])):
        mu = float(process.mu(t_prev))
        sigma = float(process.sigma(t_prev))
        x0 = guided_eps(x, t_prev)  # consumed: becomes the x0 buffer
        for sl in slabs:  # x0 = (x - sigma eps) / mu, slab by slab in place
            np.multiply(x0[sl], -sigma / mu, out=x0[sl])
            x0[sl] += x[sl] / mu
        if proc_x0 is not None:
            p = proc_x0(x0)
            if p is not x0:
                x0[...] = p
        if sde_eta > 0:
            h, decay, growth, corr, nscale = (
                float(v) for v in steprules.dpm_sde_scalar_coeffs(process, t_prev, t_cur, prev_h, sde_eta))
            for sl in slabs:
                x[sl] *= decay
                if prev_x0 is None:
                    x[sl] += growth * x0[sl]
                else:
                    x[sl] += (growth + corr) * x0[sl]
                    x[sl] -= corr * prev_x0[sl]
                x[sl] += (nscale * rng.standard_normal(x[sl].shape)).astype(np.float32)
        else:
            h, sigma_ratio, growth, c_cur, c_prev = (
                float(v) for v in steprules.dpm_scalar_coeffs(process, t_prev, t_cur, prev_h))
            for sl in slabs:
                x[sl] *= sigma_ratio
                if prev_x0 is None:  # first step: D = x0
                    x[sl] += growth * x0[sl]
                else:
                    x[sl] += (growth * c_cur) * x0[sl]
                    x[sl] -= (growth * c_prev) * prev_x0[sl]
        prev_x0 = x0  # the old previous x0 is released
        prev_h = h
        if not np.isfinite(x).all():
            raise FloatingPointError(f"NaN detected in sample at step {i}")
        if verbose and (i % 16 == 0 or i == steps - 1):
            print(f"host-stream dpm sampling: step {i + 1}/{steps}", flush=True)
    if denoise_final:
        x = _denoise_final(process, guided_eps, x, proc_x0)
    return x
