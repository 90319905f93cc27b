"""Climatological spectral calibration (port of
climate2weather_tpu/diffusion/calibrate.py).

Each sample's radial-annulus Fourier amplitudes outside the observation
square are rescaled to the training climatology's annulus power; phases and
the observed band are untouched. The climatology comes from training frames
given as an array (the HDF5 reader is not ported).
"""

from __future__ import annotations

import numpy as np
import torch


def annulus_index_map(H: int, W: int):
    """([H, W] int32 annulus ids on the fftshift'd grid, n_bins); radii are
    rounded, and corner bins clamp into the outermost annulus."""
    yc, xc = H // 2, W // 2
    yy, xx = np.indices((H, W))
    r = np.sqrt((yy - yc) ** 2 + (xx - xc) ** 2)
    n_bins = H // 2
    return np.minimum(np.round(r).astype(np.int32), n_bins - 1), n_bins


def obs_square_mask(H: int, W: int, s_step: int) -> np.ndarray:
    """[H, W] bool, True on the centred (h+1) x (w+1) observation square."""
    h, w = H // s_step, W // s_step
    y0, x0 = (H - h) // 2, (W - w) // 2
    m = np.zeros((H, W), bool)
    m[y0 : y0 + h + 1, x0 : x0 + w + 1] = True
    return m


def climatological_annulus_psd(frames: np.ndarray, s_step: int = 16, n_frames: int = 256) -> np.ndarray:
    """[C, n_bins] float32 annulus-mean PSD of training ``frames`` [T, C, H, W]
    (the layout of the training HDF5's ``x``), outside-square bins only, over
    a deterministic stride of at most ``n_frames`` frames."""
    frames = np.asarray(frames)
    T, C, H, W = frames.shape
    take = np.unique(np.linspace(0, T - 1, min(n_frames, T)).round().astype(int))
    frames = frames[take]
    idx, n_bins = annulus_index_map(H, W)
    outside = ~obs_square_mask(H, W, s_step)
    sel = idx[outside]
    counts = np.bincount(sel, minlength=n_bins).astype(np.float64)
    out = np.zeros((C, n_bins), np.float64)
    for c in range(C):
        F = np.fft.fftshift(np.fft.fft2(frames[:, c].astype(np.float64)), axes=(1, 2))
        p2 = (np.abs(F) ** 2 / (H * W))[:, outside]
        sums = np.zeros(n_bins, np.float64)
        np.add.at(sums, sel, p2.mean(axis=0))
        out[c] = np.divide(sums, counts, out=np.zeros(n_bins), where=counts > 0)
    return out.astype(np.float32)


def calibrate_trajectory(x: torch.Tensor, target, s_step: int, max_gain: float = 10.0) -> torch.Tensor:
    """Rescale the per-annulus power of ``x`` [*batch, L, H, W, C] outside the
    observation square to ``target`` [C, n_bins], gains capped at ``max_gain``."""
    H, W = x.shape[-3], x.shape[-2]
    idx_np, n_bins = annulus_index_map(H, W)
    outside_np = ~obs_square_mask(H, W, s_step)
    onehot = np.zeros((n_bins, H * W), np.float32)
    onehot[idx_np.ravel(), np.arange(H * W)] = outside_np.ravel()
    counts = onehot.sum(axis=1)
    M = torch.from_numpy(onehot / np.maximum(counts, 1.0)[:, None]).to(x.device)
    M = M.reshape(n_bins, H, W)
    outside = torch.from_numpy(outside_np).to(x.device)
    idx = torch.from_numpy(idx_np.astype(np.int64)).to(x.device)
    target = torch.as_tensor(target, dtype=torch.float32).to(x.device)

    Fs = torch.fft.fftshift(torch.fft.fft2(x.float(), dim=(-3, -2)), dim=(-3, -2))
    p2 = Fs.abs() ** 2 / float(H * W)
    p_a = torch.einsum("bhw,...lhwc->...lcb", M, p2)  # [..., L, C, n_bins]
    scale_a = torch.clamp(torch.sqrt(target / torch.clamp(p_a, min=1e-20)), max=max_gain)
    per_bin = scale_a[..., idx]  # [..., L, C, H, W]
    gain = torch.where(outside[:, :, None], per_bin.movedim(-3, -1), 1.0)
    out = torch.fft.ifft2(torch.fft.ifftshift(Fs * gain, dim=(-3, -2)), dim=(-3, -2)).real
    return out.to(x.dtype)
