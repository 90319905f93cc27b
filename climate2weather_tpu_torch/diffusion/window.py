"""Markov-blanket window scoring (port of climate2weather_tpu/diffusion/window.py).

A trajectory ``[L, H, W, C]`` is scored by evaluating a window-local network
on its ``L - w + 1`` sliding windows of ``w = 2k + 1`` frames, flattened to
``[N, H, W, w*C]`` with channel index ``frame * C + c``, and folding the
outputs back: every window gives its centre frame, the first and last
windows also their outer ``k`` frames.

The port takes any leading batch dimensions in front of ``[L, H, W, C]``
(an ensemble): the windows of all members go through the network in one
batch, ``members x chunk`` windows per call.

:meth:`WindowScoreFn.vjp` is the vector-Jacobian product of the chunked
pass, for exact-gradient guidance. JAX differentiates through its scan over
chunks (rematerialized per chunk on the long path); the port does the same
chunk by chunk: each chunk is recomputed under grad and its cotangent
back-propagated at once, so only one chunk's activations are ever held.

With a ``group`` (the ranks of one sample group,
:class:`~climate2weather_tpu_torch.parallel.mesh.SampleGroups`) each rank
evaluates a share of every evaluation's windows, as JAX shards a chunk's
window batch over its devices: whole chunks dealt round-robin where there
are at least as many chunks as ranks (every forward then has the
one-process batch), else every chunk's ``members x B`` windows cut into one
contiguous range a rank. Each rank writes what it evaluated into a zeroed
output (the centres its windows own, the edge frames where it holds the
first or last window) and one sum over the group assembles the whole: every
entry has one writer, so the sum is the one-process result. The VJP sums
the ranks' frame gradients the same way.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from climate2weather_tpu_torch.utils import trace

# Windows through the network in one backward of :meth:`WindowScoreFn.vjp`.
# The 72.1M net at 128 x 128 in bf16 holds 0.30 GB per window under grad
# (38.4 GB at 128 windows on an NVIDIA H100 80GB HBM3: exp/profile_vjp.py,
# PERF.md), so the short path's 3 members x 32 windows and the year path's
# chunks of 128 go at once. Windows are independent through the net, so a
# chunk that holds more runs in equal sub-batches, each exact.
VJP_WINDOWS = 128


def owned_windows(ci: int, n_chunks: int, B: int, n: int) -> int:
    """How many leading windows of chunk ``ci`` (of ``n_chunks`` chunks of
    ``B`` of the ``n`` windows) keep their centre output in the folded
    trajectory: all of the last chunk's, and of an earlier chunk's those
    before the last chunk's start (the last chunk is shifted back to end at
    the final window, and overwrites the centres it shares)."""
    if ci == n_chunks - 1:
        return B
    return min(B, n - B - ci * B)


def member_pieces(a: int, b: int, B: int):
    """``(member, first, end, offset)`` for each member's part of the flat
    windows [a, b) of a chunk of ``B`` windows a member (flat index
    ``member * B + window``): its windows [first, end) of the chunk, at
    ``offset`` in the range."""
    pieces, f = [], a
    while f < b:
        mi, lo = divmod(f, B)
        hi = min(B, lo + b - f)
        pieces.append((mi, lo, hi, f - a))
        f += hi - lo
    return pieces


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
    final window (duplicate evaluations instead of padding). ``group``
    splits the windows over the group's ranks (module docstring); every rank
    of it must make the same calls on the same ``x``.
    """

    def __init__(self, eps_fn: Callable, markov_order: int, chunk_size: Optional[int] = None,
                 noise_process=None, group=None):
        self.eps_fn = eps_fn
        self.markov_order = int(markov_order)
        self.chunk_size = chunk_size
        self.noise_process = noise_process
        self.group = group

    @property
    def window(self) -> int:
        return 2 * self.markov_order + 1

    def condition_on(self, *, A, y, std, gamma=1e-2, exact_grad: bool = False):
        """A guided score function for p(y | A(x0)) (the reference's
        ``condition_on``); needs ``noise_process``."""
        from climate2weather_tpu_torch.diffusion.guidance import GaussianGuidance

        if self.noise_process is None:
            raise ValueError("condition_on requires WindowScoreFn(..., noise_process=...)")
        guidance = GaussianGuidance(A=A, y=y, std=std, gamma=gamma, exact_grad=exact_grad)
        return ConditionedScoreFn(guidance, self, self.noise_process)

    def _chunks(self, L: int):
        """``(n windows, windows per chunk, chunks)`` of a trajectory of L frames."""
        n = L - self.window + 1
        if n < 1:
            raise ValueError(f"trajectory length {L} shorter than window {self.window}")
        B = n if self.chunk_size is None or n <= self.chunk_size else int(self.chunk_size)
        return n, B, -(-n // B)

    def _work(self, n_chunks: int, N: int):
        """``(chunk, first, end)`` for each range of flat windows [first, end)
        of a chunk's ``N`` (members x windows, member-major) that this rank
        evaluates: every chunk whole without a group; with one, whole chunks
        dealt round-robin when there are at least as many chunks as ranks,
        else one contiguous range of every chunk a rank (empty where ``N`` is
        smaller than the group)."""
        if self.group is None:
            return [(ci, 0, N) for ci in range(n_chunks)]
        size, r = self.group.size, self.group.rank
        if n_chunks >= size:
            return [(ci, 0, N) for ci in range(r, n_chunks, size)]
        return [(ci, r * N // size, (r + 1) * N // size) for ci in range(n_chunks)]

    def _gather(self, xb: torch.Tensor, start: int, pieces) -> torch.Tensor:
        """The windows of ``pieces`` (:func:`member_pieces` of a chunk that
        starts at window ``start``) of ``xb`` [m, L, H, W, C], in order, as
        [N, H, W, w * C]."""
        w = self.window
        _, _, H, W, C = xb.shape
        dev = xb.device
        members = torch.cat([torch.full((hi - lo,), mi, device=dev) for mi, lo, hi, _ in pieces])
        first = torch.cat([torch.arange(start + lo, start + hi, device=dev) for _, lo, hi, _ in pieces])
        frames = first[:, None] + torch.arange(w, device=dev)[None, :]
        return xb[members[:, None], frames].permute(0, 2, 3, 1, 4).reshape(-1, H, W, w * C)

    def __call__(self, x: torch.Tensor, t) -> torch.Tensor:
        k, w = self.markov_order, self.window
        *batch, L, H, W, C = x.shape
        n, B, n_chunks = self._chunks(L)
        xb = x.reshape(-1, L, H, W, C)
        m = xb.shape[0]
        # each entry is written once, by the chunk that owns it; split, the
        # other ranks' entries stay zero for the sum
        with trace.span("c2w.window.pass"):
            out = torch.empty_like(xb) if self.group is None else torch.zeros_like(xb)
            for ci, a, b in self._work(n_chunks, m * B):
                if a == b:
                    continue
                start = min(ci * B, n - B)
                owned = owned_windows(ci, n_chunks, B, n)
                pieces = member_pieces(a, b, B)
                xw = self._gather(xb, start, pieces)
                with trace.span("c2w.model.forward", windows=b - a):
                    o = self.eps_fn(xw, t)
                _count_forward(b - a)
                o = o.to(x.dtype).reshape(b - a, H, W, w, C)
                for mi, lo, hi, off in pieces:
                    if lo < owned:
                        end = min(hi, owned)
                        out[mi, k + start + lo : k + start + end] = o[off : off + end - lo, :, :, k]
                    if k > 0 and ci == 0 and lo == 0:
                        out[mi, :k] = o[off, :, :, :k].permute(2, 0, 1, 3)
                    if k > 0 and ci == n_chunks - 1 and hi == B:
                        out[mi, k + n :] = o[off + B - 1 - lo, :, :, w - k :].permute(2, 0, 1, 3)
            if self.group is not None:
                self.group.all_reduce(out)
        return out.reshape(*batch, L, H, W, C)

    def vjp(self, x: torch.Tensor, t, cotangent: torch.Tensor) -> torch.Tensor:
        """J^T ``cotangent`` for J the Jacobian of x -> self(x, t) at ``x``
        [*batch, L, H, W, C]; the result has x's shape and dtype.

        Chunk by chunk, as the forward goes: the chunk's windows are
        recomputed under grad (in sub-batches of at most ``VJP_WINDOWS``)
        and the cotangent of what the chunk wrote into the folded output is
        back-propagated to them at once, with the network's parameters left
        out of the backward. Centre outputs that the shifted last chunk
        overwrites get zero cotangent in the chunk before it
        (:func:`owned_windows`), as the overwrite gives them in JAX. With a
        group each rank does its share of the windows and the frame
        gradients are summed over the group."""
        k, w = self.markov_order, self.window
        *batch, L, H, W, C = x.shape
        n, B, n_chunks = self._chunks(L)
        xb = x.reshape(-1, L, H, W, C)
        gb = cotangent.reshape(xb.shape).to(x.dtype)
        m = xb.shape[0]
        grad = torch.zeros_like(xb)
        for ci, a, b in self._work(n_chunks, m * B):
            if a == b:
                continue
            start = min(ci * B, n - B)
            owned = owned_windows(ci, n_chunks, B, n)
            pieces = member_pieces(a, b, B)
            N = b - a
            co = xb.new_zeros((N, H, W, w, C))
            for mi, lo, hi, off in pieces:
                if lo < owned:
                    end = min(hi, owned)
                    co[off : off + end - lo, :, :, k] = gb[mi, k + start + lo : k + start + end]
                if k > 0 and ci == 0 and lo == 0:
                    co[off, :, :, :k] = gb[mi, :k].permute(1, 2, 0, 3)
                if k > 0 and ci == n_chunks - 1 and hi == B:
                    co[off + B - 1 - lo, :, :, w - k :] = gb[mi, k + n :].permute(1, 2, 0, 3)
            xw = self._gather(xb, start, pieces)
            co = co.reshape(N, H, W, w * C)
            parts = -(-N // VJP_WINDOWS)
            size = -(-N // parts)
            gw = torch.cat([self._windows_vjp(xw[s : s + size], t, co[s : s + size]) for s in range(0, N, size)])
            gw = gw.reshape(N, H, W, w, C)
            for mi, lo, hi, off in pieces:
                for j in range(w):  # window frame j of windows [start + lo, start + hi) is frame start + lo + j + b
                    grad[mi, start + lo + j : start + hi + j] += gw[off : off + hi - lo, :, :, j]
        if self.group is not None:
            self.group.all_reduce(grad)
        return grad.reshape(*batch, L, H, W, C)

    def _windows_vjp(self, xw: torch.Tensor, t, co: torch.Tensor) -> torch.Tensor:
        """The windows' input gradient for the output cotangent ``co``: one
        forward under grad and one backward to the windows alone (no
        parameter gradient is formed)."""
        with torch.enable_grad():
            leaf = xw.detach().requires_grad_(True)
            with trace.span("c2w.model.forward", windows=len(xw)):
                out = self.eps_fn(leaf, t)
            _count_forward(len(xw))
            (g,) = torch.autograd.grad(out.to(xw.dtype), leaf, grad_outputs=co)
        return g


def _count_forward(windows: int) -> None:
    """Count one launch of the network over ``windows`` windows: completed
    work once the device has caught up."""
    trace.count("window_evals", windows)
    trace.count("forwards")


class ConditionedScoreFn:
    """``guidance.guided_eps`` over a window score function: the guided
    score that :meth:`WindowScoreFn.condition_on` returns."""

    is_conditioned = True

    def __init__(self, guidance, score: WindowScoreFn, process):
        self.guidance, self.score, self.process = guidance, score, process

    def __call__(self, x: torch.Tensor, t) -> torch.Tensor:
        return self.guidance.guided_eps(self.score, self.process, x, t)
