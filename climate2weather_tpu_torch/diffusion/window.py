"""Markov-blanket window scoring (port of climate2weather_tpu/diffusion/window.py).

A trajectory ``[L, H, W, C]`` is scored by evaluating a window-local network
on its ``L - w + 1`` sliding windows of ``w = 2k + 1`` frames, flattened to
``[N, H, W, w*C]`` with channel index ``frame * C + c``, and folding the
outputs back: every window gives its centre frame, the first and last
windows also their outer ``k`` frames.

The port takes any leading batch dimensions in front of ``[L, H, W, C]``
(an ensemble): the windows of all members go through the network in one
batch, ``members x chunk`` windows per call.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch


def unfold_windows(x: torch.Tensor, markov_order: int) -> torch.Tensor:
    """[L, H, W, C] -> [L-w+1, H, W, w*C] sliding windows."""
    w = 2 * markov_order + 1
    L, H, W, C = x.shape
    n = L - w + 1
    idx = torch.arange(n, device=x.device)[:, None] + torch.arange(w, device=x.device)[None, :]
    return x[idx].permute(0, 2, 3, 1, 4).reshape(n, H, W, w * C)


def fold_windows(win_out: torch.Tensor, markov_order: int) -> torch.Tensor:
    """[N, H, W, w*C] window outputs -> [L, H, W, C] trajectory."""
    k = markov_order
    w = 2 * k + 1
    n, H, W, wc = win_out.shape
    wo = win_out.reshape(n, H, W, w, wc // w)
    center = wo[:, :, :, k]
    if k == 0:
        return center
    first = wo[0, :, :, :k].permute(2, 0, 1, 3)
    last = wo[-1, :, :, w - k :].permute(2, 0, 1, 3)
    return torch.cat([first, center, last], dim=0)


class WindowScoreFn:
    """Trajectory eps-model from a window-local network, evaluated in chunks.

    ``eps_fn(windows, t)`` maps ``[B, H, W, w*C]`` windows at scalar time
    ``t`` to noise predictions of the same shape. ``__call__(x, t)`` maps
    ``[*batch, L, H, W, C]`` to its composed prediction, in ``x.dtype``.
    ``chunk_size=None`` evaluates all windows at once; an integer bounds the
    windows per member in one call, the last chunk shifted back to end at the
    final window (duplicate evaluations instead of padding).
    """

    def __init__(self, eps_fn: Callable, markov_order: int, chunk_size: Optional[int] = None):
        self.eps_fn = eps_fn
        self.markov_order = int(markov_order)
        self.chunk_size = chunk_size

    @property
    def window(self) -> int:
        return 2 * self.markov_order + 1

    def __call__(self, x: torch.Tensor, t) -> torch.Tensor:
        k, w = self.markov_order, self.window
        *batch, L, H, W, C = x.shape
        n = L - w + 1
        if n < 1:
            raise ValueError(f"trajectory length {L} shorter than window {w}")
        xb = x.reshape(-1, L, H, W, C)
        m = xb.shape[0]
        B = n if self.chunk_size is None or n <= self.chunk_size else int(self.chunk_size)
        n_chunks = -(-n // B)
        out = torch.empty_like(xb)
        frames = torch.arange(w, device=x.device)
        for ci in range(n_chunks):
            start = min(ci * B, n - B)
            idx = start + torch.arange(B, device=x.device)[:, None] + frames[None, :]  # [B, w]
            xw = xb[:, idx].permute(0, 1, 3, 4, 2, 5).reshape(m * B, H, W, w * C)
            o = self.eps_fn(xw, t).to(x.dtype).reshape(m, B, H, W, w, C)
            out[:, k + start : k + start + B] = o[:, :, :, :, k]
            if k > 0 and ci == 0:
                out[:, :k] = o[:, 0, :, :, :k].permute(0, 3, 1, 2, 4)
            if k > 0 and ci == n_chunks - 1:
                out[:, k + n :] = o[:, B - 1, :, :, w - k :].permute(0, 3, 1, 2, 4)
        return out.reshape(*batch, L, H, W, C)
