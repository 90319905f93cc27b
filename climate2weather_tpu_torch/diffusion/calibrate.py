"""Climatological spectral calibration (port of
climate2weather_tpu/diffusion/calibrate.py).

Each sample's radial-annulus Fourier amplitudes outside the observation
square are rescaled to the training climatology's annulus power; phases and
the observed band are untouched. The climatology comes from training frames
given as an array or as the path of a training HDF5 file (read through
``io/hdf5.py``). :func:`postprocess_long` runs the calibration and the t = 0
projection over a long trajectory in time chunks (the year path).
"""

from __future__ import annotations

import os

import numpy as np
import torch

from climate2weather_tpu_torch.diffusion.guidance import SpatioTemporalCoarsening
from climate2weather_tpu_torch.io import hdf5


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


def _frame_stride(T: int, n_frames: int) -> np.ndarray:
    return np.unique(np.linspace(0, T - 1, min(n_frames, T)).round().astype(int))


def climatological_annulus_psd(frames, s_step: int = 16, n_frames: int = 256) -> np.ndarray:
    """[C, n_bins] float32 annulus-mean PSD of training frames [T, C, H, W],
    outside-square bins only, over a deterministic stride of at most
    ``n_frames`` frames. ``frames`` is an array or the path of a training
    HDF5 file, whose dataset ``x`` is read (only the frames taken)."""
    if isinstance(frames, (str, os.PathLike)):
        with hdf5.open_file(frames) as f:
            x = f["x"]
            take = _frame_stride(x.shape[0], n_frames)
            frames = x[take]
    else:
        frames = np.asarray(frames)
        frames = frames[_frame_stride(frames.shape[0], n_frames)]
    _, C, H, W = frames.shape
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


def postprocess_long(x: torch.Tensor, calib_target=None, s_step: int = 16, observation=None,
                     t_step: int = 6, method: str = "spectral", iters: int = 3,
                     chunk: int = 512) -> torch.Tensor:
    """The t = 0 post-processing of a long trajectory ``x`` [L, H, W, C], in
    the short path's order: calibration, then the projection onto
    A(x) = ``observation`` [Lo, h, w, C] (skipped when None). Both act per
    frame, so they run in time chunks of ``chunk`` frames: the calibration
    on every frame, the projection only on the observed frames ``::t_step``
    with a ``t_step = 1`` operator, which equals projecting the whole
    trajectory. Each chunk is computed in fp32 and cast back to ``x``'s
    dtype; ``x`` is overwritten and returned."""
    L = x.shape[0]
    if calib_target is not None:
        for i in range(0, L, chunk):
            x[i : i + chunk] = calibrate_trajectory(x[i : i + chunk], calib_target, s_step)
    if observation is not None and method:
        A1 = SpatioTemporalCoarsening(s_step=s_step, t_step=1)
        idx = torch.arange(0, L, t_step, device=x.device)
        if len(idx) != observation.shape[0]:
            raise ValueError(f"observation has {observation.shape[0]} frames but the trajectory "
                             f"observes {len(idx)} (L={L}, t_step={t_step})")
        for j in range(0, len(idx), chunk):
            sel = idx[j : j + chunk]
            x[sel] = A1.project(x[sel], observation[j : j + chunk], iters=iters, method=method)
    return x
