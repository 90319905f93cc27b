"""Fused Winograd F(2x2, 3x3) convolution: the CUDA kernel, its plain
versions and the autograd Function that joins them.

``winograd_conv3x3(x, kernel, bias, vec, residual, pre, ddof)`` computes
``residual + conv3x3_same(pre(x + vec), kernel) + bias`` in NHWC with an HWIO
kernel, the function of the Pallas kernel ``climate2weather_tpu/ops/winograd.py``
``_wino_kernel``: ``pre`` is None, ``"norm"`` (channel norm, fp32 statistics,
eps 1e-5, ``ddof``) or ``"silu"`` (fp32); the conv's zero padding applies to
``pre(x + vec)``; the conv runs in the Winograd domain with the rounding of
the Pallas kernel (V in x's type, the plane products and the inverse
transform in fp32, then bias and residual in x's type).

On CUDA tensors :func:`winograd_fwd` launches ``csrc/winograd_conv3x3.cu``;
on CPU tensors it runs :func:`winograd_reference`, the plain version that
follows ``_wino_kernel`` step by step, which the tests and the chip smoke
hold the kernel against. :func:`conv3x3_reference` is the direct
composition (JAX ``_apply_pre`` + ``_conv_ref``). :class:`WinogradConv3x3`
is the autograd Function: its backward differentiates the direct
composition through torch, as the JAX VJP ``_wino_bwd`` goes through XLA.

The port's activations are NCHW in channels_last memory, so
``x.permute(0, 2, 3, 1)`` is a free NHWC view of them, and
``convert.conv_weight_hwio`` gives a ``_Conv``'s weight as the HWIO kernel.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from climate2weather_tpu_torch.models.unet import channel_norm

# Launches of the CUDA kernel, counted by its wrapper where it launches.
launch_counts = {"winograd_conv3x3": 0}

_SOURCE = "winograd_conv3x3.cu"
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_PRE_CODES = {None: 0, "norm": 1, "silu": 2}
_P, _I = ctypes.c_void_p, ctypes.c_int
# x, U, bias, vec, residual, out, n, h, w, c, o, pre, ddof, dtype, stream
_ARGTYPES = [_P] * 6 + [_I] * 8 + [_P]
EPS = 1e-5

# F(2x2, 3x3) transform matrices (Lavin & Gray, 2016)
_G = np.array([[1, 0, 0], [0.5, 0.5, 0.5], [0.5, -0.5, 0.5], [0, 0, 1]], np.float32)
# G (x) G as [16, 9] (its entries 0, +-1/4, +-1/2, 1 are exact), on each
# device it was asked on: a copy from host memory on every call would wait
# for the card's queue to drain
_GG = np.einsum("ia,jb->ijab", _G, _G).reshape(16, 9)
_GG_ON: dict = {}


def transform_weights(kernel: torch.Tensor) -> torch.Tensor:
    """[3, 3, C, O] kernel -> [16, C, O] Winograd-domain weights
    U[4i+j] = sum_ab G[i,a] G[j,b] K[a,b], in fp32, as one matrix product."""
    gg = _GG_ON.get(kernel.device)
    if gg is None:
        gg = _GG_ON[kernel.device] = torch.from_numpy(_GG).to(kernel.device)
    c, o = kernel.shape[2:]
    return (gg @ kernel.float().reshape(9, c * o)).reshape(16, c, o)


def winograd_eligible(x_shape, kernel_size, strides, spatial) -> bool:
    """The kernel covers stride-1 SAME 3x3 2-D convs with even H and W."""
    if spatial != 2 or kernel_size not in (3, (3, 3)):
        return False
    if strides is not None:
        s = (strides, strides) if isinstance(strides, int) else tuple(strides)
        if s != (1, 1):
            return False
    _, h, w, _ = x_shape
    return h % 2 == 0 and w % 2 == 0


def _kernel_pre(x, vec, pre, ddof):
    """pre(x + vec) as ``_wino_kernel`` computes it: the add in x's type, the
    norm with fp32 statistics, SiLU in fp32, each cast back to x's type."""
    if vec is not None:
        x = x + vec[:, None, None, :].to(x.dtype)
    if pre == "norm":
        return channel_norm(x, EPS, ddof, dim=-1)
    if pre == "silu":
        x32 = x.float()
        return (x32 * torch.sigmoid(x32)).to(x.dtype)
    return x


def winograd_from_padded(xp: torch.Tensor, u: torch.Tensor, bias: torch.Tensor,
                         residual: Optional[torch.Tensor]) -> torch.Tensor:
    """The Winograd conv of an already padded [N, H+2, W+2, C] input with
    weights ``u`` [16, C, O] in x's type, step by step as ``_wino_kernel``."""
    n, hp, wp, c = xp.shape
    h, w = hp - 2, wp - 2

    def d(p, q):  # window position (p, q) of every 2x2 output tile: [N, H/2, W/2, C]
        return xp[:, p:p + h:2, q:q + w:2, :]

    t = {}
    for q in range(4):  # B^T d: rows, in x's type
        d0, d1, d2, d3 = d(0, q), d(1, q), d(2, q), d(3, q)
        t[0, q], t[1, q], t[2, q], t[3, q] = d0 - d2, d1 + d2, d2 - d1, d1 - d3
    uf = u.float()
    m = {}
    for i in range(4):  # (B^T d) B: columns, in x's type; then the planes in fp32
        cols = (t[i, 0] - t[i, 2], t[i, 1] + t[i, 2], t[i, 2] - t[i, 1], t[i, 1] - t[i, 3])
        for j, v in enumerate(cols):
            m[i, j] = torch.einsum("nyxc,co->nyxo", v.float(), uf[4 * i + j])
    s0 = [m[0, j] + m[1, j] + m[2, j] for j in range(4)]  # A^T M, fp32
    s1 = [m[1, j] - m[2, j] - m[3, j] for j in range(4)]
    rows = []
    for s in (s0, s1):  # (A^T M) A, cast to x's type; interleave the columns
        y0, y1 = (s[0] + s[1] + s[2]).to(xp.dtype), (s[1] - s[2] - s[3]).to(xp.dtype)
        rows.append(torch.stack([y0, y1], dim=3).reshape(n, h // 2, w, -1))
    y = torch.stack(rows, dim=2).reshape(n, h, w, -1)
    y = y + bias.to(xp.dtype)
    if residual is not None:
        y = y + residual.to(y.dtype)
    return y


def winograd_reference(x, kernel, bias, vec=None, residual=None, pre=None, ddof=0):
    """Plain PyTorch version of the kernel on NHWC ``x`` [N, H, W, C] with an
    HWIO ``kernel`` [3, 3, C, O] and ``bias`` [O]."""
    h = _kernel_pre(x, vec, pre, ddof)
    return winograd_from_padded(F.pad(h, (0, 0, 1, 1, 1, 1)), transform_weights(kernel).to(x.dtype),
                                bias, residual)


def apply_pre(x, vec, pre, ddof):
    """JAX ``_apply_pre``: x + vec, then the channel norm or SiLU, in x's type."""
    if vec is not None:
        x = x + vec[:, None, None, :].to(x.dtype)
    if pre == "norm":
        return channel_norm(x, EPS, ddof, dim=-1)
    if pre == "silu":
        return F.silu(x)
    return x


def conv3x3_reference(x, kernel, bias, vec=None, residual=None, pre=None, ddof=0):
    """The direct composition (JAX ``_conv_ref`` on ``_apply_pre``): a
    stride-1 SAME conv of x's type with fp32 accumulation, cast to x's type,
    plus the bias, plus the residual; NHWC in and out, differentiable."""
    hx = apply_pre(x, vec, pre, ddof)
    y = F.conv2d(hx.permute(0, 3, 1, 2), kernel.permute(3, 2, 0, 1).to(x.dtype), padding=1)
    y = y.permute(0, 2, 3, 1) + bias.to(x.dtype)
    if residual is not None:
        y = y + residual.to(y.dtype)
    return y


def build_kernel() -> None:
    """Compile the kernel now and load it (it is otherwise built at first use)."""
    _library()


def _library() -> ctypes.CDLL:
    from climate2weather_tpu_torch.ops import build

    lib = build.load(_SOURCE)
    if lib.c2w_winograd_conv3x3.argtypes is None:
        lib.c2w_winograd_conv3x3.argtypes = _ARGTYPES
        lib.c2w_winograd_conv3x3.restype = ctypes.c_int
    return lib


def winograd_fwd(x, kernel, bias, vec=None, residual=None, pre=None, ddof=0) -> torch.Tensor:
    """The forward: :func:`winograd_reference` for CPU tensors, the kernel for
    CUDA tensors (anything it does not take raises). x [N, H, W, C] and the
    residual [N, H, W, O] must be contiguous; H and W even."""
    if x.device.type == "cpu":
        return winograd_reference(x, kernel, bias, vec, residual, pre, ddof)
    if x.device.type != "cuda":
        raise ValueError(f"winograd_conv3x3 runs on cpu or cuda, got {x.device}")
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"winograd_conv3x3 takes float32 or bfloat16, got {x.dtype}")
    if pre not in _PRE_CODES:
        raise ValueError(f"pre must be None, 'norm' or 'silu', got {pre!r}")
    if x.dim() != 4 or not x.is_contiguous():
        raise ValueError(f"x must be a contiguous [N, H, W, C], got {tuple(x.shape)} {x.stride()}")
    n, h, w, c = x.shape
    if tuple(kernel.shape[:3]) != (3, 3, c):
        raise ValueError(f"kernel {tuple(kernel.shape)} is not [3, 3, {c}, O]")
    o = kernel.shape[3]
    if not winograd_eligible(x.shape, 3, 1, 2):
        raise ValueError(f"H and W must be even, got {h} x {w}")
    if pre == "norm" and c <= ddof:
        raise ValueError(f"ddof {ddof} with {c} channels")
    if not 1 <= n <= 65535:
        raise ValueError(f"batch {n} outside 1..65535")
    u = transform_weights(kernel.to(x.device)).to(x.dtype).contiguous()
    bias32 = bias.to(device=x.device, dtype=torch.float32).contiguous()
    if bias32.shape != (o,):
        raise ValueError(f"bias {tuple(bias.shape)} is not [{o}]")
    vec_c = None
    if vec is not None:
        if tuple(vec.shape) != (n, c):
            raise ValueError(f"vec {tuple(vec.shape)} is not [{n}, {c}]")
        vec_c = vec.to(device=x.device, dtype=x.dtype).contiguous()
    if residual is not None:
        if tuple(residual.shape) != (n, h, w, o) or residual.device != x.device:
            raise ValueError(f"residual {tuple(residual.shape)} is not [{n}, {h}, {w}, {o}] on {x.device}")
        residual = residual.to(x.dtype).contiguous()
    out = torch.empty((n, h, w, o), dtype=x.dtype, device=x.device)
    lib = _library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.c2w_winograd_conv3x3(
            x.data_ptr(), u.data_ptr(), bias32.data_ptr(),
            None if vec_c is None else vec_c.data_ptr(),
            None if residual is None else residual.data_ptr(), out.data_ptr(),
            n, h, w, c, o, _PRE_CODES[pre], ddof, _DTYPE_CODES[x.dtype], stream,
        )
    if err != 0:
        raise RuntimeError(f"winograd_conv3x3 launch failed: cudaError {err}")
    launch_counts["winograd_conv3x3"] += 1
    return out


class WinogradConv3x3(torch.autograd.Function):
    """The fused conv with the gradient of the direct composition: the
    backward recomputes ``apply_pre`` + conv under autograd (as the JAX
    ``_wino_bwd`` does through XLA); the residual's gradient is g."""

    @staticmethod
    def forward(ctx, x, kernel, bias, vec, residual, pre, ddof):
        ctx.save_for_backward(x, kernel, bias, vec)
        ctx.pre, ctx.ddof, ctx.has_res = pre, ddof, residual is not None
        return winograd_fwd(x, kernel, bias, vec, residual, pre, ddof)

    @staticmethod
    def backward(ctx, g):
        x, kernel, bias, vec = ctx.saved_tensors
        inputs = [t.detach().requires_grad_(True) for t in (x, kernel, bias)]
        vec_in = None if vec is None else vec.detach().requires_grad_(True)
        with torch.enable_grad():
            y = conv3x3_reference(*inputs, vec_in, None, ctx.pre, ctx.ddof)
            wrt = inputs + ([vec_in] if vec_in is not None else [])
            grads = torch.autograd.grad(y, wrt, g.to(y.dtype))
        dx, dk, db = grads[:3]
        dvec = grads[3] if vec_in is not None else None
        return dx, dk, db, dvec, (g if ctx.has_res else None), None, None


def winograd_conv3x3(x, kernel, bias, vec=None, residual=None, pre=None, ddof=0) -> torch.Tensor:
    """``residual + conv3x3_same(pre(x + vec), kernel) + bias``, fused.

    x: [N, H, W, C] (H, W even); kernel: [3, 3, C, O] (HWIO); bias: [O];
    vec: optional [N, C] added before ``pre``; residual: optional
    [N, H, W, O]; pre in {None, 'norm', 'silu'}. Returns x's dtype. Where a
    gradient is wanted this is :class:`WinogradConv3x3`; otherwise the
    forward alone runs.
    """
    tensors = [t for t in (x, kernel, bias, vec, residual) if t is not None]
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        return WinogradConv3x3.apply(x, kernel, bias, vec, residual, pre, ddof)
    return winograd_fwd(x, kernel, bias, vec, residual, pre, ddof)
