"""Fused single-head self-attention: a CUDA kernel and its plain version.

``fused_attention(q, k, v)`` computes ``softmax((q s)(k s)^T) v`` with
``s = C^-1/4``, QK^T, softmax and PV in fp32, and the output in q's dtype:
the function of the Pallas kernel ``climate2weather_tpu/ops/attention.py``
``_attn_fwd_kernel``. On a CUDA tensor it launches the hand-written kernel
``csrc/attention_fwd.cu``; on a CPU tensor it runs
:func:`attention_reference`, the plain PyTorch version, which the tests and
the chip smoke hold the kernel against.
"""

from __future__ import annotations

import ctypes

import torch

# Launches of each CUDA kernel, counted by its wrapper where it launches.
launch_counts = {"attention_fwd": 0}

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_SOURCE = "attention_fwd.cu"


def attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version, step by step as the Pallas kernel body:
    scale q and k in fp32, fp32 logits, row-max-subtracted softmax, fp32 PV,
    cast to q's dtype. q, k, v: [B, T, C]."""
    q32, k32, v32 = q.float(), k.float(), v.float()
    scale = q.shape[-1] ** (-0.25)
    logits = torch.matmul(q32 * scale, (k32 * scale).transpose(-1, -2))
    logits = logits - logits.amax(dim=-1, keepdim=True)
    e = torch.exp(logits)
    p = e / e.sum(dim=-1, keepdim=True)
    return torch.matmul(p, v32).to(q.dtype)


def _library() -> ctypes.CDLL:
    from climate2weather_tpu_torch.ops import build

    lib = build.load(_SOURCE)
    fn = lib.c2w_attention_fwd
    if fn.argtypes is None:
        fn.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
            ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
        lib.c2w_attention_fwd_max_seq.argtypes = []
        lib.c2w_attention_fwd_max_seq.restype = ctypes.c_int
    return lib


def build_kernel() -> None:
    """Compile and load the kernel now (it is otherwise built at first use)."""
    _library()


def fused_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """softmax((q s)(k s)^T) v, s = C^-1/4, for single-head [B, T, C] inputs.

    CPU tensors take :func:`attention_reference`; CUDA tensors launch the
    kernel, and anything it does not take raises. q, k and v must share
    shape, dtype (fp32 or bf16), device and strides, with contiguous
    channels; they may be views into one [B, T, 3C] projection.
    """
    if q.device.type == "cpu":
        return attention_reference(q, k, v)
    if q.device.type != "cuda":
        raise ValueError(f"fused_attention runs on cpu or cuda, got {q.device}")
    for name, x in (("k", k), ("v", v)):
        if x.device != q.device or x.dtype != q.dtype or x.shape != q.shape:
            raise ValueError(
                f"{name} {tuple(x.shape)} {x.dtype} {x.device} does not match "
                f"q {tuple(q.shape)} {q.dtype} {q.device}"
            )
        if x.stride() != q.stride():
            raise ValueError(f"{name} strides {x.stride()} differ from q's {q.stride()}")
    if q.dtype not in _DTYPE_CODES:
        raise TypeError(f"fused_attention takes float32 or bfloat16, got {q.dtype}")
    if q.dim() != 3:
        raise ValueError(f"expected [B, T, C], got {tuple(q.shape)}")
    b, t, c = q.shape
    if q.stride(2) != 1:
        raise ValueError(f"channels must be contiguous, strides {q.stride()}")
    if c % 8:
        raise ValueError(f"C must be a multiple of 8, got {c}")
    lib = _library()
    max_t = lib.c2w_attention_fwd_max_seq()
    if not 1 <= t <= max_t:
        raise ValueError(f"T={t} outside the kernel's 1..{max_t} (shared memory bound)")
    if b < 1:
        raise ValueError("empty batch")
    out = torch.empty((b, t, c), dtype=q.dtype, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.c2w_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            b, t, c, q.stride(0), q.stride(1), _DTYPE_CODES[q.dtype], stream,
        )
    if err != 0:
        raise RuntimeError(f"attention_fwd launch failed: cudaError {err}")
    launch_counts["attention_fwd"] += 1
    return out
