"""Modulated UNet backbone (port of climate2weather_tpu/models/unet.py).

Parameters are fp32; compute runs in ``dtype`` (bf16 in production), with
the channel-norm statistics and the attention softmax in fp32. The spatial
rank is 1, 2 or 3 (``spatial``), as in JAX. Tensors are channels-first
``[B, C, *spatial]`` inside the network; the caller (``ScoreUNet``) hands in
a channels-last tensor with its channel axis moved to dim 1, i.e.
``channels_last`` (``channels_last_3d`` for 3-D) memory, which cuDNN's bf16
convolutions take directly, and in which every channel norm's rows are
contiguous: :func:`fused_channel_norm` runs them as one CUDA kernel on the
card (forward and backward), the plain :func:`channel_norm` on the CPU.
Module names follow the flax module names, so the snapshot's parameter tree
maps one to one (``convert.py``).
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from climate2weather_tpu_torch.ops.attention import fused_attention
from climate2weather_tpu_torch.ops.channel_norm import channel_norm, fused_channel_norm  # noqa: F401


class _ComputeDtypeConv:
    """A torch conv with fp32 parameters, run in the compute dtype."""

    conv_fn = None  # F.conv1d, F.conv2d or F.conv3d

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        d = self.compute_dtype
        return self.conv_fn(x.to(d), self.weight.to(d), self.bias.to(d), stride=self.stride, padding=self.padding)


class _Conv1d(_ComputeDtypeConv, nn.Conv1d):
    conv_fn = staticmethod(F.conv1d)


class _Conv2d(_ComputeDtypeConv, nn.Conv2d):
    conv_fn = staticmethod(F.conv2d)


class _Conv3d(_ComputeDtypeConv, nn.Conv3d):
    conv_fn = staticmethod(F.conv3d)


_CONVS = {1: _Conv1d, 2: _Conv2d, 3: _Conv3d}


def _channels_innermost(x: torch.Tensor) -> torch.Tensor:
    """x of [B, C, *spatial] laid out with C innermost on the card, as the
    norm kernel takes its rows: a copy only where x is not (the input of a
    caller other than ScoreUNet; cuDNN's 1-D convs return channels-first)."""
    if x.is_cuda and not x.movedim(1, -1).is_contiguous():
        return x.movedim(1, -1).contiguous().movedim(-1, 1)
    return x


def _Conv(cin: int, cout: int, k: int, stride: int, dtype: torch.dtype, spatial: int = 2) -> nn.Module:
    """k x k (x k) conv of rank ``spatial``, padded to keep the size."""
    conv = _CONVS[spatial](cin, cout, k, stride=stride, padding=k // 2)
    conv.compute_dtype = dtype
    return conv


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
                 dtype: torch.dtype = torch.bfloat16, norm_ddof: int = 0, spatial: int = 2):
        super().__init__()
        self.norm_ddof = norm_ddof
        self.project = _Dense(mod_features, channels, dtype)
        self.conv0 = _Conv(channels, channels, kernel_size, 1, dtype, spatial)
        self.conv1 = _Conv(channels, channels, kernel_size, 1, dtype, spatial)

    def forward(self, x: torch.Tensor, emb: torch.Tensor) -> torch.Tensor:
        h = fused_channel_norm(_channels_innermost(x), self.project(emb), self.norm_ddof)
        h = self.conv1(F.silu(self.conv0(h)))
        return x + h


class AttentionBlock(nn.Module):
    """Full self-attention over the flattened spatial positions, of any rank.

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
        b, c, *spatial_shape = x.shape
        hl = _channels_innermost(x).movedim(1, -1)  # [B, *spatial, C]
        h = hl.reshape(b, -1, c)  # [B, T, C]
        t = h.shape[1]
        qkv = self.qkv(fused_channel_norm(h, ddof=self.norm_ddof, dim=-1))
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
        return (h + out).reshape(hl.shape).movedim(-1, 1)


class NearestUpConv2x(nn.Conv2d):
    """Fused nearest-upsample(2x) -> 3x3 conv, decomposed by output parity
    (JAX ``unet.py:130-199``).

    Each output parity (a, b) reads a 2x2 neighbourhood of the low-resolution
    input, with taps that are sums of the 3x3 taps (rows, a=0: {i-1: K[0],
    i: K[1]+K[2]}; a=1: {i: K[0]+K[1], i+1: K[2]}; columns the same), so the
    op is four quarter-size 2x2 convs and an interleave. The tap sums run in
    the compute dtype, each quarter conv is rounded to it, and the bias is
    added after the interleave, as JAX does. The parameters are the plain
    tail conv's (``weight`` [O, C, 3, 3], ``bias`` [O]), so a snapshot loads
    with the option on or off.
    """

    def __init__(self, cin: int, cout: int, dtype: torch.dtype = torch.bfloat16):
        super().__init__(cin, cout, 3, padding=1)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        d = self.compute_dtype
        w = self.weight.to(d)
        x = x.to(d)
        r0 = torch.stack([w[:, :, 0], w[:, :, 1] + w[:, :, 2]], dim=2)  # row offsets {-1, 0}
        r1 = torch.stack([w[:, :, 0] + w[:, :, 1], w[:, :, 2]], dim=2)  # row offsets {0, +1}

        def cols(kr):
            c0 = torch.stack([kr[..., 0], kr[..., 1] + kr[..., 2]], dim=3)
            c1 = torch.stack([kr[..., 0] + kr[..., 1], kr[..., 2]], dim=3)
            return c0, c1

        kernels = (cols(r0), cols(r1))
        # pad once; parity 0 reads rows (columns) [i-1, i], parity 1 [i, i+1]
        xp = F.pad(x, (1, 1, 1, 1))
        h, w_ = x.shape[-2:]
        quarters = [[F.conv2d(xp[:, :, a:a + h + 1, b:b + w_ + 1], kernels[a][b]).movedim(1, -1)
                     for b in (0, 1)] for a in (0, 1)]  # each [B, h, w, O]
        y = torch.stack([torch.stack(row, dim=3) for row in quarters], dim=2)  # [B, h, 2(a), w, 2(b), O]
        y = y.reshape(y.shape[0], 2 * h, 2 * w_, y.shape[-1]) + self.bias.to(d)
        return y.movedim(-1, 1)


def nearest_upsample(x: torch.Tensor, s: int) -> torch.Tensor:
    """Nearest-neighbour upsample of [B, C, *spatial] by ``s`` along every
    spatial axis."""
    return F.interpolate(x, scale_factor=s, mode="nearest")  # keeps channels_last


class UNet(nn.Module):
    """Modulated N-level UNet on [B, C, *spatial] of rank ``spatial`` (the
    flax UNet). ``fused_upsample`` takes :class:`NearestUpConv2x` for the
    tails where JAX does (2-D, stride 2, kernel 3), the materialized
    upsample elsewhere."""

    def __init__(self, in_channels: int, out_channels: int, mod_features: int,
                 hidden_channels: Sequence[int] = (32, 64, 128),
                 hidden_blocks: Sequence[int] = (2, 3, 5),
                 attention_levels: Sequence[int] = (), kernel_size: int = 3,
                 stride: int = 2, dtype: torch.dtype = torch.bfloat16,
                 norm_ddof: int = 0, spatial: int = 2, fused_upsample: bool = False):
        super().__init__()
        self.hidden_blocks = tuple(hidden_blocks)
        self.attention_levels = tuple(attention_levels)
        self.dtype = dtype
        self.norm_ddof = norm_ddof
        self.stride = stride
        self.spatial = spatial
        k = kernel_size
        hc = tuple(hidden_channels)
        self.fused_upsample = fused_upsample and spatial == 2 and stride == 2 and k == 3
        for i in range(len(hc)):
            cin = in_channels if i == 0 else hc[i - 1]
            self.add_module(f"head{i}", _Conv(cin, hc[i], k, 1 if i == 0 else stride, dtype, spatial))
        for stage in ("down", "up"):
            for i in range(len(hc)):
                for bi in range(self.hidden_blocks[i]):
                    self.add_module(
                        f"{stage}{i}_block{bi}",
                        ModResidualBlock(hc[i], mod_features, k, dtype, norm_ddof, spatial),
                    )
                    if i in self.attention_levels:
                        self.add_module(
                            f"{stage}{i}_attn{bi}",
                            AttentionBlock(hc[i], dtype=dtype, norm_ddof=norm_ddof),
                        )
        for i in range(len(hc)):
            cout = out_channels if i == 0 else hc[i - 1]
            if i > 0 and self.fused_upsample:
                self.add_module(f"tail{i}", NearestUpConv2x(hc[i], cout, dtype))
            else:
                self.add_module(f"tail{i}", _Conv(hc[i], cout, k, 1, dtype, spatial))

    def _level(self, x: torch.Tensor, emb: torch.Tensor, i: int, stage: str) -> torch.Tensor:
        for bi in range(self.hidden_blocks[i]):
            x = getattr(self, f"{stage}{i}_block{bi}")(x, emb)
            if i in self.attention_levels:
                x = getattr(self, f"{stage}{i}_attn{bi}")(x)
        return x

    def forward(self, x: torch.Tensor, emb: torch.Tensor) -> torch.Tensor:
        if x.dim() != self.spatial + 2:
            raise ValueError(f"a {self.spatial}-D UNet takes [B, C, *spatial], not {tuple(x.shape)}")
        nlev = len(self.hidden_blocks)
        emb = emb.to(self.dtype)
        x = _channels_innermost(x.to(self.dtype))
        memory = []
        for i in range(nlev):
            x = getattr(self, f"head{i}")(x)
            x = self._level(x, emb, i, "down")
            memory.append(x)
        memory.pop()
        for i in reversed(range(nlev)):
            x = self._level(x, emb, i, "up")
            if i > 0:
                x = fused_channel_norm(_channels_innermost(x), ddof=self.norm_ddof)
                if not self.fused_upsample:
                    x = nearest_upsample(x, self.stride)
                x = getattr(self, f"tail{i}")(x) + memory.pop()
            else:
                x = self.tail0(x)
        return x
