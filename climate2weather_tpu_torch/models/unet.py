"""Modulated UNet backbone (port of climate2weather_tpu/models/unet.py, 2-D).

Parameters are fp32; compute runs in ``dtype`` (bf16 in production), with
the channel-norm statistics and the attention softmax in fp32. Tensors are
NCHW inside the network; the caller (``ScoreUNet``) hands in an NHWC tensor
permuted to NCHW, i.e. ``channels_last`` memory, which cuDNN's bf16
convolutions take directly. Module names follow the flax module names, so
the snapshot's parameter tree maps one to one (``convert.py``).
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from climate2weather_tpu_torch.ops.attention import fused_attention


def channel_norm(x: torch.Tensor, eps: float = 1e-5, ddof: int = 0, dim: int = 1) -> torch.Tensor:
    """Standardize over the channel axis without learnable parameters;
    statistics in fp32, result in ``x.dtype``. ``ddof=1`` is the reference's
    unbiased variance for imported torch snapshots."""
    x32 = x.float()
    mean = x32.mean(dim=dim, keepdim=True)
    var = x32.var(dim=dim, keepdim=True, correction=ddof)
    return ((x32 - mean) * torch.rsqrt(var + eps)).to(x.dtype)


class _Conv(nn.Conv2d):
    """3x3 (k x k) conv with fp32 parameters, run in the compute dtype."""

    def __init__(self, cin: int, cout: int, k: int, stride: int, dtype: torch.dtype):
        super().__init__(cin, cout, k, stride=stride, padding=k // 2)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        d = self.compute_dtype
        return F.conv2d(
            x.to(d), self.weight.to(d), self.bias.to(d),
            stride=self.stride, padding=self.padding,
        )


class _Dense(nn.Linear):
    """Linear with fp32 parameters, run in the compute dtype."""

    def __init__(self, fin: int, fout: int, dtype: torch.dtype):
        super().__init__(fin, fout)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        d = self.compute_dtype
        return F.linear(x.to(d), self.weight.to(d), self.bias.to(d))


class ModResidualBlock(nn.Module):
    """``x + residue(x + project(emb))``; residue = norm -> conv -> SiLU -> conv."""

    def __init__(self, channels: int, mod_features: int, kernel_size: int = 3,
                 dtype: torch.dtype = torch.bfloat16, norm_ddof: int = 0):
        super().__init__()
        self.norm_ddof = norm_ddof
        self.project = _Dense(mod_features, channels, dtype)
        self.conv0 = _Conv(channels, channels, kernel_size, 1, dtype)
        self.conv1 = _Conv(channels, channels, kernel_size, 1, dtype)

    def forward(self, x: torch.Tensor, emb: torch.Tensor) -> torch.Tensor:
        proj = self.project(emb)
        h = x + proj[:, :, None, None]
        h = channel_norm(h, ddof=self.norm_ddof)
        h = self.conv1(F.silu(self.conv0(h)))
        return x + h


class AttentionBlock(nn.Module):
    """Full self-attention over the flattened spatial positions.

    With one head it runs :func:`fused_attention` (the CUDA kernel on the
    card, its plain version on the CPU); with several heads, the einsum
    composition of the JAX block (``unet.py:113-124``).
    """

    def __init__(self, channels: int, num_heads: int = 1, dtype: torch.dtype = torch.bfloat16,
                 norm_ddof: int = 0):
        super().__init__()
        self.num_heads = num_heads
        self.norm_ddof = norm_ddof
        self.qkv = _Dense(channels, 3 * channels, dtype)
        self.proj_out = _Dense(channels, channels, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, hh, ww = x.shape
        t = hh * ww
        h = x.permute(0, 2, 3, 1).reshape(b, t, c)  # [B, T, C]
        qkv = self.qkv(channel_norm(h, ddof=self.norm_ddof, dim=-1))
        if self.num_heads == 1:
            q, k, v = qkv.chunk(3, dim=-1)
            out = fused_attention(q, k, v)
        else:
            nh = self.num_heads
            qkv = qkv.reshape(b, t, 3, nh, c // nh)
            q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]  # [B, T, heads, ch]
            scale = (c // nh) ** (-0.25)
            logits = torch.einsum("bthc,bshc->bhts", (q * scale).float(), (k * scale).float())
            weights = torch.softmax(logits, dim=-1)
            out = torch.einsum("bhts,bshc->bthc", weights.to(v.dtype), v).reshape(b, t, c)
        out = self.proj_out(out)
        return (h + out).reshape(b, hh, ww, c).permute(0, 3, 1, 2)


def nearest_upsample(x: torch.Tensor, s: int) -> torch.Tensor:
    """Nearest-neighbour upsample of [B, C, H, W] by ``s`` in both dims."""
    return F.interpolate(x, scale_factor=s, mode="nearest")  # keeps channels_last


class UNet(nn.Module):
    """Modulated N-level UNet on [B, C, H, W] (the flax UNet, 2-D)."""

    def __init__(self, in_channels: int, out_channels: int, mod_features: int,
                 hidden_channels: Sequence[int] = (32, 64, 128),
                 hidden_blocks: Sequence[int] = (2, 3, 5),
                 attention_levels: Sequence[int] = (), kernel_size: int = 3,
                 stride: int = 2, dtype: torch.dtype = torch.bfloat16,
                 norm_ddof: int = 0):
        super().__init__()
        self.hidden_blocks = tuple(hidden_blocks)
        self.attention_levels = tuple(attention_levels)
        self.dtype = dtype
        self.norm_ddof = norm_ddof
        self.stride = stride
        k = kernel_size
        hc = tuple(hidden_channels)
        for i in range(len(hc)):
            cin = in_channels if i == 0 else hc[i - 1]
            self.add_module(f"head{i}", _Conv(cin, hc[i], k, 1 if i == 0 else stride, dtype))
        for stage in ("down", "up"):
            for i in range(len(hc)):
                for bi in range(self.hidden_blocks[i]):
                    self.add_module(
                        f"{stage}{i}_block{bi}",
                        ModResidualBlock(hc[i], mod_features, k, dtype, norm_ddof),
                    )
                    if i in self.attention_levels:
                        self.add_module(
                            f"{stage}{i}_attn{bi}",
                            AttentionBlock(hc[i], dtype=dtype, norm_ddof=norm_ddof),
                        )
        for i in range(len(hc)):
            cout = out_channels if i == 0 else hc[i - 1]
            self.add_module(f"tail{i}", _Conv(hc[i], cout, k, 1, dtype))

    def _level(self, x: torch.Tensor, emb: torch.Tensor, i: int, stage: str) -> torch.Tensor:
        for bi in range(self.hidden_blocks[i]):
            x = getattr(self, f"{stage}{i}_block{bi}")(x, emb)
            if i in self.attention_levels:
                x = getattr(self, f"{stage}{i}_attn{bi}")(x)
        return x

    def forward(self, x: torch.Tensor, emb: torch.Tensor) -> torch.Tensor:
        nlev = len(self.hidden_blocks)
        emb = emb.to(self.dtype)
        x = x.to(self.dtype)
        memory = []
        for i in range(nlev):
            x = getattr(self, f"head{i}")(x)
            x = self._level(x, emb, i, "down")
            memory.append(x)
        memory.pop()
        for i in reversed(range(nlev)):
            x = self._level(x, emb, i, "up")
            if i > 0:
                x = channel_norm(x, ddof=self.norm_ddof)
                x = nearest_upsample(x, self.stride)
                x = getattr(self, f"tail{i}")(x) + memory.pop()
            else:
                x = self.tail0(x)
        return x
