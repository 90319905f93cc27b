"""Score network (port of climate2weather_tpu/models/score_net.py).

Sinusoidal noise features -> Linear -> SiLU -> Linear -> SiLU, in fp32,
modulating the UNet. Inputs and outputs are channels-last
``[B, *spatial, channels]`` (NHWC for the 2-D net) as in the JAX package,
with ``channels = num_features * window``.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from climate2weather_tpu_torch.models.unet import UNet


def timestep_embedding(t: torch.Tensor, dim: int, max_period: float = 10_000.0) -> torch.Tensor:
    """[N] diffusion times (any shape, flattened) -> [N, dim] fp32 embeddings."""
    t = torch.as_tensor(t).reshape(-1).float()
    half = dim // 2
    freqs = torch.exp(
        -math.log(max_period) * torch.arange(half, dtype=torch.float32, device=t.device) / half
    )
    args = t[:, None] * freqs[None, :]
    emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    if dim % 2:
        emb = torch.cat([emb, torch.zeros_like(emb[:, :1])], dim=-1)
    return emb


class ScoreUNet(nn.Module):
    """Eps-predicting UNet conditioned on diffusion time (optionally forcing)."""

    def __init__(self, channels: int, embedding_dim: int = 512, noise_features: int = 32,
                 forcing_dim: int = 0, hidden_channels: Sequence[int] = (32, 64, 128),
                 hidden_blocks: Sequence[int] = (2, 3, 5),
                 attention_levels: Sequence[int] = (), kernel_size: int = 3,
                 stride: int = 2, dtype: torch.dtype = torch.bfloat16, norm_ddof: int = 0,
                 spatial: int = 2, fused_upsample: bool = False):
        super().__init__()
        self.noise_features = noise_features
        self.forcing_dim = forcing_dim
        self.map_layer0 = nn.Linear(noise_features, embedding_dim)
        self.map_layer1 = nn.Linear(embedding_dim, embedding_dim)
        if forcing_dim > 0:
            self.map_forcing = nn.Linear(forcing_dim, embedding_dim)
        self.unet = UNet(
            channels, channels, embedding_dim, hidden_channels, hidden_blocks,
            attention_levels, kernel_size, stride, dtype, norm_ddof, spatial, fused_upsample,
        )

    def forward(self, x: torch.Tensor, t: torch.Tensor,
                forcing: Optional[torch.Tensor] = None) -> torch.Tensor:
        """x: [B, *spatial, C] channels-last; t: a float, or a tensor of 1 or
        B times; returns [B, *spatial, C] in the compute dtype."""
        if forcing is not None and self.forcing_dim == 0:
            raise ValueError("forcing given to a net built without forcing_dim")
        if isinstance(t, torch.Tensor):
            t = t.to(device=x.device, dtype=torch.float32)
        else:  # a fill kernel, not a host-to-device copy that would sync
            t = torch.full((1,), float(t), dtype=torch.float32, device=x.device)
        emb = timestep_embedding(t, self.noise_features)
        emb = self.map_layer1(F.silu(self.map_layer0(emb)))
        if forcing is not None:
            emb = emb + self.map_forcing(forcing.float())
        emb = F.silu(emb)
        if emb.shape[0] == 1 and x.shape[0] != 1:
            emb = emb.expand(x.shape[0], -1)
        out = self.unet(x.movedim(-1, 1), emb)  # a channels_last(_3d) view
        return out.movedim(1, -1)


def build_score_unet(model_cfg: dict, dtype: torch.dtype = torch.bfloat16) -> ScoreUNet:
    """A ScoreUNet from a config dict (the sda_unet.yml / snapshot surface).
    Keys as in the JAX ``build_score_unet``, ``spatial`` (1, 2 or 3) and
    ``fused_upsample`` among them."""
    cfg = dict(model_cfg)
    spatial = int(cfg.get("spatial", 2))
    if spatial not in (1, 2, 3):
        raise NotImplementedError(f"the port builds 1-, 2- and 3-D UNets, not spatial={spatial}")
    return ScoreUNet(
        channels=int(cfg["channels"]),
        embedding_dim=int(cfg.get("embedding_dim", 512)),
        noise_features=int(cfg.get("noise_features", 32)),
        forcing_dim=int(cfg.get("forcing_dim", 0)),
        hidden_channels=tuple(cfg.get("hidden_channels", (32, 64, 128))),
        hidden_blocks=tuple(cfg.get("hidden_blocks", (2, 3, 5))),
        attention_levels=tuple(cfg.get("attention_levels", ())),
        kernel_size=int(cfg.get("kernel_size", 3)),
        stride=int(cfg.get("stride", 2)),
        dtype=dtype,
        norm_ddof=int(cfg.get("norm_ddof", 0)),
        spatial=spatial,
        fused_upsample=bool(cfg.get("fused_upsample", False)),
    )
