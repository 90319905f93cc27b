"""Fused single-head self-attention: CUDA kernels, their plain versions and
the autograd Function that joins them.

``fused_attention(q, k, v)`` computes ``softmax((q s)(k s)^T) v`` with
``s = C^-1/4``, QK^T, softmax and PV in fp32, and the output in q's dtype:
the function of the Pallas kernel ``climate2weather_tpu/ops/attention.py``
``_attn_fwd_kernel``. Its gradient is that of ``_attn_bwd_kernel``, which
recomputes P from q and k (the Pallas custom VJP saves q, k, v, not P).

On CUDA tensors :func:`attention_fwd` and :func:`attention_bwd` launch the
hand-written kernels ``csrc/attention_fwd.cu`` and ``csrc/attention_bwd.cu``;
on CPU tensors they run :func:`attention_reference` and
:func:`attention_bwd_reference`, the plain PyTorch versions, which the tests
and the chip smoke hold the kernels against. :class:`FusedAttention` is the
``torch.autograd.Function`` over the two; it is used on both devices
whenever a gradient is wanted.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from climate2weather_tpu_torch.utils import trace

# Launches of each CUDA kernel, counted by its wrapper where it launches
# (entries of the counter registry in utils/trace.py).
launch_counts = trace.CounterView("attention_fwd", "attention_bwd")

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_SOURCES = {"attention_fwd": "attention_fwd.cu", "attention_bwd": "attention_bwd.cu"}
_POINTER, _LL, _INT = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
_ARGTYPES = {
    # q, k, v, o, batch, seq, ch, stride_b, stride_t, dtype, stream
    "attention_fwd": [_POINTER] * 4 + [_LL, _INT, _INT, _LL, _LL, _INT, _POINTER],
    # q, k, v, dO, dQ, dK, dV, scratch, batch, seq, ch, stride_b, stride_t,
    # dtype, stream
    "attention_bwd": [_POINTER] * 8 + [_LL, _INT, _INT, _LL, _LL, _INT, _POINTER],
}
# each kernel's (max_seq, max_ch), asked of its library once
_limits: dict = {}


def _softmax_probs(q32: torch.Tensor, k32: torch.Tensor) -> torch.Tensor:
    scale = q32.shape[-1] ** (-0.25)
    logits = torch.matmul(q32 * scale, (k32 * scale).transpose(-1, -2))
    logits = logits - logits.amax(dim=-1, keepdim=True)
    e = torch.exp(logits)
    return e / e.sum(dim=-1, keepdim=True)


def attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version, step by step as the Pallas kernel body:
    scale q and k in fp32, fp32 logits, row-max-subtracted softmax, fp32 PV,
    cast to q's dtype. q, k, v: [B, T, C]."""
    p = _softmax_probs(q.float(), k.float())
    return torch.matmul(p, v.float()).to(q.dtype)


def attention_bwd_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                            do: torch.Tensor):
    """Plain PyTorch version of ``_attn_bwd_kernel``, step by step: recompute
    P in fp32; dV = P^T dO; dP = dO V^T; dS = P o (dP - rowsum(dP o P));
    dQ = dS K s^2; dK = dS^T Q s^2 with K, Q unscaled. Returns
    ``(dq, dk, dv)`` in q's dtype."""
    q32, k32, v32, do32 = q.float(), k.float(), v.float(), do.float()
    s2 = q.shape[-1] ** (-0.25) * q.shape[-1] ** (-0.25)
    p = _softmax_probs(q32, k32)
    dv = torch.matmul(p.transpose(-1, -2), do32)
    dp = torch.matmul(do32, v32.transpose(-1, -2))
    ds = p * (dp - (dp * p).sum(dim=-1, keepdim=True))
    dq = torch.matmul(ds, k32) * s2
    dk = torch.matmul(ds.transpose(-1, -2), q32) * s2
    return dq.to(q.dtype), dk.to(q.dtype), dv.to(q.dtype)


def _library(name: str) -> ctypes.CDLL:
    from climate2weather_tpu_torch.ops import build

    lib = build.load(_SOURCES[name])
    fn = getattr(lib, f"c2w_{name}")
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES[name]
        fn.restype = ctypes.c_int
        for limit in ("max_seq", "max_ch"):
            fn_limit = getattr(lib, f"c2w_{name}_{limit}")
            fn_limit.argtypes = []
            fn_limit.restype = ctypes.c_int
        _limits[name] = (getattr(lib, f"c2w_{name}_max_seq")(), getattr(lib, f"c2w_{name}_max_ch")())
        if name == "attention_bwd":
            lib.c2w_attention_bwd_scratch_bytes.argtypes = [_LL, _INT, _INT]
            lib.c2w_attention_bwd_scratch_bytes.restype = _LL
    return lib


def build_kernel() -> None:
    """Compile both kernels now, in parallel, and load them (they are
    otherwise built at first use)."""
    from climate2weather_tpu_torch.ops import build

    build.build_all(_SOURCES.values())
    for name in _SOURCES:
        _library(name)


def _check_inputs(name: str, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> ctypes.CDLL:
    """Raise on what the kernel ``name`` does not take; return its library."""
    if q.device.type != "cuda":
        raise ValueError(f"{name} runs on cpu or cuda, got {q.device}")
    for label, x in (("k", k), ("v", v)):
        if x.device != q.device or x.dtype != q.dtype or x.shape != q.shape:
            raise ValueError(
                f"{label} {tuple(x.shape)} {x.dtype} {x.device} does not match "
                f"q {tuple(q.shape)} {q.dtype} {q.device}"
            )
        if x.stride() != q.stride():
            raise ValueError(f"{label} strides {x.stride()} differ from q's {q.stride()}")
    if q.dtype not in _DTYPE_CODES:
        raise TypeError(f"{name} takes float32 or bfloat16, got {q.dtype}")
    if q.dim() != 3:
        raise ValueError(f"expected [B, T, C], got {tuple(q.shape)}")
    b, t, c = q.shape
    if q.stride(2) != 1:
        raise ValueError(f"channels must be contiguous, strides {q.stride()}")
    if c % 8:
        raise ValueError(f"C must be a multiple of 8, got {c}")
    lib = _library(name)
    max_t, max_c = _limits[name]
    if not 1 <= t <= max_t:
        raise ValueError(f"T={t} outside the {name} kernel's supported range 1..{max_t}")
    if c > max_c:
        raise ValueError(f"C={c} above the {name} kernel's supported {max_c} (shared memory)")
    if b < 1:
        raise ValueError("empty batch")
    return lib


def _check_rows16(q: torch.Tensor, *others: torch.Tensor) -> None:
    """Raise where the bf16 kernels' 16-byte row copies cannot go: every
    tensor must start on 16 bytes, q's strides (which k and v share) must be
    multiples of 8 elements."""
    if q.dtype == torch.bfloat16 and (
            any(x.data_ptr() % 16 for x in (q, *others)) or q.stride(0) % 8 or q.stride(1) % 8):
        raise ValueError(
            f"the bf16 kernels copy 16-byte rows: q, k, v (and dO) must start on 16 bytes and "
            f"q's strides {q.stride()} be multiples of 8")


@functools.lru_cache(maxsize=64)
def _bwd_scratch_bytes(b: int, t: int, code: int) -> int:
    """Bytes of fp32 scratch the backward's route needs: the fp32 route's P
    and dS ([2, B, T, T]), the bf16 route's row statistics ([3, B, T], where
    T > 64)."""
    return _library("attention_bwd").c2w_attention_bwd_scratch_bytes(b, t, code)


def attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """The forward on [B, T, C] inputs: :func:`attention_reference` for CPU
    tensors, the kernel for CUDA tensors (anything it does not take raises).
    q, k and v must share shape, dtype (fp32 or bf16), device and strides,
    with contiguous channels; they may be views into one [B, T, 3C]
    projection."""
    if q.device.type == "cpu":
        return attention_reference(q, k, v)
    lib = _check_inputs("attention_fwd", q, k, v)
    _check_rows16(q, k, v)
    b, t, c = q.shape
    out = torch.empty((b, t, c), dtype=q.dtype, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.c2w_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            b, t, c, q.stride(0), q.stride(1), _DTYPE_CODES[q.dtype], stream,
        )
    if err != 0:
        raise RuntimeError(f"attention_fwd launch failed: cudaError {err}")
    trace.count("attention_fwd")
    return out


def attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, do: torch.Tensor):
    """``(dq, dk, dv)`` of the forward at (q, k, v) for the output gradient
    ``do``: :func:`attention_bwd_reference` for CPU tensors, the kernel for
    CUDA tensors. q, k, v as for :func:`attention_fwd`; ``do`` is cast to
    q's dtype and made contiguous. The gradients are three contiguous
    [B, T, C] tensors in q's dtype (autograd's ``chunk`` backward then joins
    them into the qkv projection's gradient)."""
    if q.device.type == "cpu":
        return attention_bwd_reference(q, k, v, do)
    lib = _check_inputs("attention_bwd", q, k, v)
    if do.shape != q.shape or do.device != q.device:
        raise ValueError(f"dO {tuple(do.shape)} {do.device} does not match q {tuple(q.shape)}")
    do = do.to(q.dtype).contiguous()
    _check_rows16(q, k, v, do)
    b, t, c = q.shape
    code = _DTYPE_CODES[q.dtype]
    dq, dk, dv = (torch.empty((b, t, c), dtype=q.dtype, device=q.device) for _ in range(3))
    nbytes = _bwd_scratch_bytes(b, t, code)
    scratch = torch.empty((nbytes // 4,), dtype=torch.float32, device=q.device) if nbytes else None
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.c2w_attention_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            None if scratch is None else scratch.data_ptr(),
            b, t, c, q.stride(0), q.stride(1), code, stream,
        )
    if err != 0:
        raise RuntimeError(f"attention_bwd launch failed: cudaError {err}")
    trace.count("attention_bwd")
    return dq, dk, dv


class FusedAttention(torch.autograd.Function):
    """The attention with the backward of ``_attn_bwd_kernel``. Saves the
    views q, k, v (not P) and recomputes P in the backward."""

    @staticmethod
    def forward(ctx, q, k, v):
        ctx.save_for_backward(q, k, v)
        return attention_fwd(q, k, v)

    @staticmethod
    def backward(ctx, do):
        q, k, v = ctx.saved_tensors
        return attention_bwd(q, k, v, do)


def fused_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """softmax((q s)(k s)^T) v, s = C^-1/4, for single-head [B, T, C] inputs.

    Where a gradient is wanted (grad mode on and an input that requires it)
    this is :class:`FusedAttention`, on the CPU and on the card alike;
    otherwise, as in sampling, the forward alone runs and nothing is saved.
    """
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return FusedAttention.apply(q, k, v)
    return attention_fwd(q, k, v)
