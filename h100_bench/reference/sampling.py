"""Guided posterior sampling of one trajectory, in plain float32 PyTorch.

What it computes, for a trajectory x [L, H, W, C] and a score network over
windows of w = 2k + 1 frames (channel index frame * C + c):

- noise process (VP cosine, eta = 1e-3): mu(t) = cos(acos(sqrt(eta)) t)^2,
  sigma(t) = sqrt(1 - mu^2 + eta^2), lambda = log mu - log sigma;
- the trajectory's score: every window [i, i + w) of x through the
  network; window i gives frame i + k, the first window also frames
  0..k-1, the last also the last k frames;
- observation A(x): frames ::t_step, then s x s block means; its adjoint
  spreads each coarse value over its block / s^2 at those frames;
- detached Gaussian guidance: with x0 = (x - sigma eps) / mu and
  var = std^2 + gamma (sigma / mu)^2, eps' = eps - sigma A^T((y - A x0) /
  var) / mu;
- DPM-Solver++(2M), SDE form with eta_sde, on a grid uniform in lambda
  (20,001 points interpolated, end points 1 and 0): with h = lambda(t_i+1)
  - lambda(t_i), x <- sigma_i+1 / sigma_i exp(-eta_sde h) x + mu_i+1 (1 -
  exp(-(1 + eta_sde) h)) x0 + sigma_i+1 sqrt(1 - exp(-2 eta_sde h)) z, plus
  (from the second step) that x0 weight times h / (2 h_prev) times
  (x0 - x0_prev); then, with ``denoise_final``, x <- (x - sigma(0) eps') /
  mu(0);
- calibration: per frame and channel, the Fourier amplitudes outside the
  centred (h + 1) x (w + 1) square are scaled per radial annulus to the
  training frames' annulus power (gain at most 10);
- projection (spectral): three passes of x += s^2 up(r / D) at the
  observed frames, r = y - A x, up = zero-padding of r's spectrum to the
  fine grid, D the Dirichlet gains of block averaging.

The noise is what the program draws for sample ``sid``: a generator on the
device seeded with blake2b(repr((seed, "sample", sid))) mod 2^31 gives the
initial [L, H, W, C] normal draw, then one draw of that shape a step.
"""

from __future__ import annotations

import hashlib
import math

import numpy as np
import torch

ETA = 1e-3


def derive_seed(*parts) -> int:
    h = hashlib.blake2b(repr(tuple(parts)).encode(), digest_size=8)
    return int.from_bytes(h.digest(), "little") % (1 << 31)


def _f32(t) -> torch.Tensor:
    return torch.as_tensor(t, dtype=torch.float32)


def mu(t) -> torch.Tensor:
    return torch.cos(math.acos(math.sqrt(ETA)) * _f32(t)) ** 2


def sigma(t) -> torch.Tensor:
    return torch.sqrt(1.0 - mu(t) ** 2 + ETA**2)


def lam(t) -> torch.Tensor:
    return torch.log(mu(t)) - torch.log(sigma(t))


def logsnr_grid(steps: int) -> list:
    tg = np.linspace(0.0, 1.0, 20001)
    alpha = np.cos(math.acos(math.sqrt(ETA)) * tg) ** 2
    lg = np.log(alpha) - np.log(np.sqrt(1.0 - alpha**2 + ETA**2))
    t = np.interp(np.linspace(lg[-1], lg[0], steps + 1), lg[::-1], tg[::-1])
    t[0], t[-1] = 1.0, 0.0
    return [float(v) for v in t.astype(np.float32)]


def coarsen(x: torch.Tensor, s: int, t_step: int) -> torch.Tensor:
    x = x[::t_step]
    lo, H, W, C = x.shape
    return x.reshape(lo, H // s, s, W // s, s, C).mean(dim=(2, 4))


def spread(v: torch.Tensor, s: int, t_step: int, L: int) -> torch.Tensor:
    fine = v.repeat_interleave(s, dim=1).repeat_interleave(s, dim=2) / (s * s)
    out = fine.new_zeros((L,) + fine.shape[1:])
    out[::t_step] = fine[: -(-L // t_step)]
    return out


def window_score(net, x: torch.Tensor, t: float, k: int, block: int = 64) -> torch.Tensor:
    L, H, W, C = x.shape
    w = 2 * k + 1
    n = L - w + 1
    outs = []
    for a in range(0, n, block):
        idx = torch.arange(a, min(a + block, n), device=x.device)[:, None] + torch.arange(w, device=x.device)
        win = x[idx].permute(0, 2, 3, 1, 4).reshape(len(idx), H, W, w * C)
        outs.append(net(win, t).float().reshape(len(idx), H, W, w, C))
    o = torch.cat(outs)
    centre = o[:, :, :, k]
    return torch.cat([o[0, :, :, :k].permute(2, 0, 1, 3), centre, o[-1, :, :, k + 1:].permute(2, 0, 1, 3)])


def annulus_index(H: int, W: int):
    yy, xx = np.indices((H, W))
    r = np.sqrt((yy - H // 2) ** 2 + (xx - W // 2) ** 2)
    n_bins = H // 2
    return np.minimum(np.round(r).astype(np.int64), n_bins - 1), n_bins


def outside_square(H: int, W: int, s: int) -> np.ndarray:
    h, w = H // s, W // s
    y0, x0 = (H - h) // 2, (W - w) // 2
    m = np.ones((H, W), bool)
    m[y0:y0 + h + 1, x0:x0 + w + 1] = False
    return m


def annulus_psd(frames: np.ndarray, s: int, n_frames: int = 256) -> np.ndarray:
    """[C, n_bins] mean annulus power outside the square of training frames
    [T, C, H, W], over at most ``n_frames`` evenly strided frames."""
    T = frames.shape[0]
    take = np.unique(np.linspace(0, T - 1, min(n_frames, T)).round().astype(int))
    frames = np.asarray(frames)[take].astype(np.float64)
    _, C, H, W = frames.shape
    idx, n_bins = annulus_index(H, W)
    out_m = outside_square(H, W, s)
    counts = np.bincount(idx[out_m], minlength=n_bins).astype(np.float64)
    psd = np.zeros((C, n_bins))
    for c in range(C):
        F = np.fft.fftshift(np.fft.fft2(frames[:, c]), axes=(1, 2))
        p = (np.abs(F) ** 2 / (H * W)).mean(axis=0)[out_m]
        sums = np.bincount(idx[out_m], weights=p, minlength=n_bins)
        psd[c] = np.divide(sums, counts, out=np.zeros(n_bins), where=counts > 0)
    return psd.astype(np.float32)


def calibrate(x: torch.Tensor, target: torch.Tensor, s: int, max_gain: float = 10.0) -> torch.Tensor:
    L, H, W, C = x.shape
    idx_np, n_bins = annulus_index(H, W)
    out_np = outside_square(H, W, s)
    idx = torch.from_numpy(idx_np).to(x.device)
    outside = torch.from_numpy(out_np).to(x.device)
    F = torch.fft.fftshift(torch.fft.fft2(x, dim=(1, 2)), dim=(1, 2))  # [L, H, W, C]
    p2 = F.abs() ** 2 / float(H * W)
    sel = idx[outside]
    sums = torch.zeros((L, n_bins, C), device=x.device).index_add_(1, sel, p2[:, outside])
    counts = torch.zeros(n_bins, device=x.device).index_add_(0, sel, torch.ones_like(sel, dtype=torch.float32))
    p_a = sums / counts.clamp(min=1.0)[None, :, None]  # [L, n_bins, C]
    scale = torch.clamp(torch.sqrt(target.T[None] / torch.clamp(p_a, min=1e-20)), max=max_gain)
    gain = torch.where(outside[None, :, :, None], scale[:, idx], torch.ones((), device=x.device))
    return torch.fft.ifft2(torch.fft.ifftshift(F * gain, dim=(1, 2)), dim=(1, 2)).real


def project(x: torch.Tensor, y: torch.Tensor, s: int, t_step: int, iters: int = 3) -> torch.Tensor:
    lo, h, w, C = y.shape
    Hf, Wf = h * s, w * s

    def gain(n, nf):
        k = np.fft.fftfreq(n) * n
        with np.errstate(invalid="ignore", divide="ignore"):
            d = np.sin(np.pi * k * s / nf) / (s * np.sin(np.pi * k / nf))
        d[k == 0] = 1.0
        return d * np.exp(1j * np.pi * k * (s - 1) / nf)

    D = torch.from_numpy(np.fft.fftshift(np.outer(gain(h, Hf), gain(w, Wf))).astype(np.complex64))
    D = D.to(x.device)[:, :, None]
    y0, x0 = (Hf - h) // 2, (Wf - w) // 2
    for _ in range(iters):
        r = y - coarsen(x, s, t_step)
        spec = torch.fft.fftshift(torch.fft.fft2(r, dim=(1, 2)), dim=(1, 2)) / D
        pad = spec.new_zeros((lo, Hf, Wf, C))
        pad[:, y0:y0 + h, x0:x0 + w] = spec
        up = torch.fft.ifft2(torch.fft.ifftshift(pad, dim=(1, 2)), dim=(1, 2)).real * float(s * s)
        x = x.clone()
        x[::t_step] = x[::t_step] + up[: x[::t_step].shape[0]]
    return x


@torch.no_grad()
def sample_member(net, k: int, traffic: dict, gt: torch.Tensor, target: torch.Tensor, seed: int,
                  sid: int) -> torch.Tensor:
    """Sample ``sid`` of the ensemble over ground truth ``gt`` [L, H, W, C]
    (float32 on the device) with the sampler settings of ``traffic``;
    ``target`` is :func:`annulus_psd` of the training frames. Returns the
    calibrated, projected sample [L, H, W, C]."""
    s, ts = int(traffic["s_step"]), int(traffic["t_step"])
    steps, eta = int(traffic["num_sampling_steps"]), float(traffic["sde_eta"])
    dev = gt.device
    L = gt.shape[0]
    y = coarsen(gt, s, ts)
    C = gt.shape[-1]
    std = torch.as_tensor(np.broadcast_to(np.asarray(traffic["likelihood_std"], np.float32), (C,)).copy(),
                          device=dev)
    gamma = float(traffic["likelihood_gamma"])
    gen = torch.Generator(device=dev).manual_seed(derive_seed(seed, "sample", sid))
    x = torch.randn(tuple(gt.shape), generator=gen, device=dev)

    def guided(x, t):
        m, sg = float(mu(t)), float(sigma(t))
        var = std**2 + gamma * float((sigma(t) / mu(t)) ** 2)
        eps = window_score(net, x, t, k)
        x0 = (x - sg * eps) / m
        return eps - sg * spread((y - coarsen(x0, s, ts)) / var, s, ts, L) / m

    times = logsnr_grid(steps)
    prev_x0, prev_h = None, torch.ones((), dtype=torch.float32)
    for i in range(steps):
        tp, tc = times[i], times[i + 1]
        eps = guided(x, tp)
        x0 = (x - float(sigma(tp)) * eps) / float(mu(tp))
        z = torch.randn(tuple(gt.shape), generator=gen, device=dev)
        h = lam(tc) - lam(tp)
        decay = float(sigma(tc) / sigma(tp) * torch.exp(-eta * h))
        growth = -torch.expm1(-(1.0 + eta) * h) * mu(tc)
        corr = float(0.5 * growth * (h / prev_h))
        nscale = float(sigma(tc) * torch.sqrt(-torch.expm1(-2.0 * eta * h)))
        x = decay * x + float(growth) * x0 + nscale * z
        if i > 0:
            x = x + corr * (x0 - prev_x0)
        prev_x0, prev_h = x0, h
    if traffic.get("denoise_final", False):
        x = (x - float(sigma(0.0)) * guided(x, 0.0)) / float(mu(0.0))
    x = calibrate(x, target, s)
    return project(x, y, s, ts, int(traffic.get("t0_project_iters", 3)))
