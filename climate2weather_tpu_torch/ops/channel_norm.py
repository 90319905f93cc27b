"""The UNet's channel norm: its plain composition, the fused CUDA kernels
(forward and backward) and the autograd Function that joins them.

``fused_channel_norm(x, shift)`` computes ``channel_norm(x + shift)``: the
add rounded to x's dtype, the mean and the variance (``correction=ddof``)
over the channel axis in fp32, ``(h - mean) * rsqrt(var + eps)`` in x's
dtype. The JAX package has no kernel here (its ``channel_norm`` is plain
``jnp``, fused by XLA); on the card the composition ran as seven passes, so
``csrc/channel_norm.cu`` does it in one, for rows whose channel axis is
innermost (the UNet's channels-last activations, and the attention's
``[B, T, C]`` tokens).

On CUDA tensors :func:`channel_norm_fwd` and :func:`channel_norm_bwd` launch
the kernels, and raise on a layout they do not take; on CPU tensors
:func:`fused_channel_norm` runs :func:`channel_norm_reference`, the plain
composition, which the tests hold the kernels against together with the
closed-form gradient :func:`channel_norm_bwd_reference`.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from climate2weather_tpu_torch.utils import trace

# Launches of each CUDA kernel, counted by its wrapper where it launches
# (entries of the counter registry in utils/trace.py).
launch_counts = trace.CounterView("channel_norm_fwd", "channel_norm_bwd")

_SOURCE = "channel_norm.cu"
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_P, _LL, _I, _F = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_float
_ARGTYPES = {
    # x, shift, rows_per_batch, y, mean, rstd, rows, ch, ddof, eps, dtype, stream
    "c2w_channel_norm_fwd": [_P, _P, _LL, _P, _P, _P, _LL, _I, _I, _F, _I, _P],
    # dy, x, shift, rows_per_batch, mean, rstd, dh, rows, ch, ddof, dtype, stream
    "c2w_channel_norm_bwd": [_P, _P, _P, _LL, _P, _P, _P, _LL, _I, _I, _I, _P],
}


def channel_norm(x: torch.Tensor, eps: float = 1e-5, ddof: int = 0, dim: int = 1) -> torch.Tensor:
    """Standardize over the channel axis without learnable parameters;
    statistics in fp32, result in ``x.dtype``. ``ddof=1`` is the reference's
    unbiased variance for imported torch snapshots."""
    x32 = x.float()
    mean = x32.mean(dim=dim, keepdim=True)
    var = x32.var(dim=dim, keepdim=True, correction=ddof)
    return ((x32 - mean) * torch.rsqrt(var + eps)).to(x.dtype)


def _broadcast(shift: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """The [B, C] shift as [B, C, 1, ...] against x's [B, C, *spatial]."""
    return shift.reshape(*shift.shape, *(1,) * (x.dim() - 2))


def channel_norm_reference(x: torch.Tensor, shift: Optional[torch.Tensor] = None, ddof: int = 0,
                           eps: float = 1e-5, dim: int = 1) -> torch.Tensor:
    """Plain PyTorch version: ``x + shift`` in x's dtype (shift [B, C],
    broadcast over x's spatial axes), then :func:`channel_norm`."""
    if shift is not None:
        x = x + _broadcast(shift, x)
    return channel_norm(x, eps, ddof, dim)


def channel_norm_bwd_reference(dy: torch.Tensor, x: torch.Tensor, shift: Optional[torch.Tensor] = None,
                               ddof: int = 0, eps: float = 1e-5, dim: int = 1) -> torch.Tensor:
    """Plain PyTorch version of the backward, the closed form the kernel
    computes: with h = x + shift, xhat = (h - mean) * rstd and n = C - ddof,
    ``dh = rstd * (dy - mean(dy) - xhat * sum(dy * xhat) / n)``, in fp32 (or
    x's dtype, if wider), returned in x's dtype. The shift's gradient is dh
    summed over the spatial axes."""
    h = x if shift is None else x + _broadcast(shift, x)
    acc = torch.promote_types(x.dtype, torch.float32)
    h = h.to(acc)
    mean = h.mean(dim=dim, keepdim=True)
    rstd = torch.rsqrt(h.var(dim=dim, keepdim=True, correction=ddof) + eps)
    xhat = (h - mean) * rstd
    g = dy.to(acc)
    n = h.shape[dim] - ddof
    dh = rstd * (g - g.mean(dim=dim, keepdim=True) - xhat * (g * xhat).sum(dim=dim, keepdim=True) / n)
    return dh.to(x.dtype)


def _function(name: str):
    from climate2weather_tpu_torch.ops import build

    fn = getattr(build.load(_SOURCE), name)
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES[name]
        fn.restype = ctypes.c_int
    return fn


def _rows(x: torch.Tensor, dim: int) -> torch.Tensor:
    """x with its channel axis ``dim`` moved last, where that view is
    contiguous (the kernels' [rows, C]); raises otherwise."""
    xl = x.movedim(dim, -1)
    if not xl.is_contiguous():
        raise ValueError(
            f"the channel_norm kernels take rows with the channel axis innermost and dense: x "
            f"{tuple(x.shape)} has strides {x.stride()} (channel axis {dim})")
    return xl


def _check(x: torch.Tensor, shift: Optional[torch.Tensor], dim: int) -> Optional[torch.Tensor]:
    """Raise on what the kernels do not take; the shift, contiguous."""
    if x.device.type != "cuda":
        raise ValueError(f"channel_norm runs on cpu or cuda, got {x.device}")
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"the channel_norm kernels take float32 or bfloat16, got {x.dtype}")
    if x.dim() < 2:
        raise ValueError(f"expected a batch and a channel axis, got {tuple(x.shape)}")
    if shift is None:
        return None
    if dim % x.dim() != 1 or tuple(shift.shape) != tuple(x.shape[:2]):
        raise ValueError(
            f"shift {tuple(shift.shape)} must be [B, C] of x {tuple(x.shape)} with channels at dim 1")
    if shift.dtype != x.dtype or shift.device != x.device:
        raise ValueError(f"shift {shift.dtype} {shift.device} does not match x {x.dtype} {x.device}")
    return shift.contiguous()


def _stream(x: torch.Tensor):
    return torch.cuda.current_stream(x.device).cuda_stream


def channel_norm_fwd(x: torch.Tensor, shift: Optional[torch.Tensor] = None, ddof: int = 0, eps: float = 1e-5,
                     dim: int = 1, stats: bool = False):
    """``(y, mean, rstd)`` of the forward kernel on a CUDA x (fp32 or bf16,
    its channel axis ``dim`` innermost and its rows dense; shift [B, C] with
    channels at dim 1): y in x's dtype and layout, and, with ``stats``, the
    fp32 mean and rstd of each row (else None)."""
    shift = _check(x, shift, dim)
    xl = _rows(x, dim)
    c = xl.shape[-1]
    rows = xl.numel() // c if c else 0
    y = torch.empty_like(xl)
    mean = rstd = None
    if stats:
        mean, rstd = torch.empty((2, rows), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        err = _function("c2w_channel_norm_fwd")(
            xl.data_ptr(), None if shift is None else shift.data_ptr(), rows // max(1, x.shape[0]),
            y.data_ptr(), None if mean is None else mean.data_ptr(), None if rstd is None else rstd.data_ptr(),
            rows, c, ddof, eps, _DTYPE_CODES[x.dtype], _stream(x))
    if err != 0:
        raise RuntimeError(f"channel_norm_fwd launch failed: cudaError {err}")
    trace.count("channel_norm_fwd")
    return y.movedim(-1, dim), mean, rstd


def channel_norm_bwd(dy: torch.Tensor, x: torch.Tensor, shift: Optional[torch.Tensor], mean: torch.Tensor,
                     rstd: torch.Tensor, ddof: int = 0, dim: int = 1) -> torch.Tensor:
    """dh of the forward at x (+ shift) for the upstream ``dy``, from the
    forward's fp32 ``mean`` and ``rstd``, in x's dtype and layout. x and
    shift as for :func:`channel_norm_fwd`; dy is cast to x's dtype and laid
    out as x."""
    shift = _check(x, shift, dim)
    xl = _rows(x, dim)
    dyl = dy.to(x.dtype).movedim(dim, -1).contiguous()
    c = xl.shape[-1]
    rows = xl.numel() // c if c else 0
    dh = torch.empty_like(xl)
    with torch.cuda.device(x.device):
        err = _function("c2w_channel_norm_bwd")(
            dyl.data_ptr(), xl.data_ptr(), None if shift is None else shift.data_ptr(),
            rows // max(1, x.shape[0]), mean.data_ptr(), rstd.data_ptr(), dh.data_ptr(),
            rows, c, ddof, _DTYPE_CODES[x.dtype], _stream(x))
    if err != 0:
        raise RuntimeError(f"channel_norm_bwd launch failed: cudaError {err}")
    trace.count("channel_norm_bwd")
    return dh.movedim(-1, dim)


class FusedChannelNorm(torch.autograd.Function):
    """The fused norm with the kernel's backward. Saves x, the shift and the
    fp32 mean and rstd of each row (no fp32 copy of x)."""

    @staticmethod
    def forward(ctx, x, shift, ddof, eps, dim):
        y, mean, rstd = channel_norm_fwd(x, shift, ddof, eps, dim, stats=True)
        ctx.save_for_backward(x, shift, mean, rstd)
        ctx.ddof, ctx.dim = ddof, dim
        return y

    @staticmethod
    def backward(ctx, dy):
        x, shift, mean, rstd = ctx.saved_tensors
        dh = channel_norm_bwd(dy, x, shift, mean, rstd, ctx.ddof, ctx.dim)
        dshift = None
        if ctx.needs_input_grad[1]:
            dshift = dh.sum(dim=tuple(range(2, dh.dim())))
        return dh, dshift, None, None, None


def fused_channel_norm(x: torch.Tensor, shift: Optional[torch.Tensor] = None, ddof: int = 0,
                       eps: float = 1e-5, dim: int = 1) -> torch.Tensor:
    """``channel_norm(x + shift)`` over the channel axis ``dim`` (shift
    [B, C], optional, with channels at dim 1).

    CPU tensors take :func:`channel_norm_reference` (autograd through the
    composition). CUDA tensors take the kernels: :class:`FusedChannelNorm`
    where a gradient is wanted, the forward alone otherwise, as in sampling;
    a layout they do not take raises.
    """
    if x.device.type == "cpu":
        return channel_norm_reference(x, shift, ddof, eps, dim)
    if torch.is_grad_enabled() and (x.requires_grad or (shift is not None and shift.requires_grad)):
        return FusedChannelNorm.apply(x, shift, ddof, eps, dim)
    return channel_norm_fwd(x, shift, ddof, eps, dim)[0]
