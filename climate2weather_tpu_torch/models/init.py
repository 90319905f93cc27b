"""Flax-style parameter initialization for the port's networks.

flax's ``nn.Conv`` and ``nn.Dense`` default to ``lecun_normal`` kernels and
zero biases (climate2weather_tpu/models/unet.py:160-162 names the same pair
for its fused conv): a normal truncated at two standard deviations, rescaled
so that the truncated draw has variance ``1 / fan_in``. torch's default
(kaiming-uniform weights, uniform biases) is not the reference's, so a
network trained from scratch starts here.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

# std of a standard normal truncated to [-2, 2] (jax.nn.initializers)
_TRUNCATED_STD = 0.87962566103423978


@torch.no_grad()
def init_params(net: nn.Module, generator: Optional[torch.Generator] = None) -> nn.Module:
    """Re-draw every conv and linear weight of ``net`` as flax's
    ``lecun_normal`` (fan-in = in-features x kernel size, C k^d for a
    rank-d conv) and zero every
    bias, in module order, from ``generator``. Returns ``net``."""
    for module in net.modules():
        if isinstance(module, (nn.Conv1d, nn.Conv2d, nn.Conv3d, nn.Linear)):
            w = module.weight
            fan_in = w[0].numel()  # OI(D)(H)W / [out, in]: everything but the output axis
            std = math.sqrt(1.0 / fan_in) / _TRUNCATED_STD
            nn.init.trunc_normal_(w, mean=0.0, std=std, a=-2.0 * std, b=2.0 * std,
                                  generator=generator)
            if module.bias is not None:
                module.bias.zero_()
    return net
