"""Exponential moving averages of the parameters (port of
climate2weather_tpu/training/ema.py).

An EMA is a dict ``name -> fp32 tensor`` keyed like the network's
``state_dict``; one per rate, keyed by :func:`rate_key`. The update runs in
place on those tensors (the JAX package builds new arrays each step).
"""

from __future__ import annotations

from typing import Dict, Mapping, Sequence

import torch


def rate_key(rate: float) -> str:
    """Stable key of an EMA rate, as in snapshot names (``-{rate:.6f}``)."""
    return f"{rate:.6f}"


def ema_init(params: Mapping[str, torch.Tensor],
             rates: Sequence[float] = (0.9999,)) -> Dict[str, Dict[str, torch.Tensor]]:
    """One real fp32 copy of ``params`` per rate."""
    return {
        rate_key(r): {k: p.detach().to(torch.float32, copy=True) for k, p in params.items()}
        for r in rates
    }


@torch.no_grad()
def ema_update(emas: Dict[str, Dict[str, torch.Tensor]], params: Mapping[str, torch.Tensor],
               rates: Sequence[float]) -> Dict[str, Dict[str, torch.Tensor]]:
    """p_ema <- r p_ema + (1 - r) p for every tracked rate; returns ``emas``."""
    for r in rates:
        ema = emas[rate_key(r)]
        keys = list(ema)
        targets = [ema[k] for k in keys]
        sources = [params[k].detach().to(torch.float32) for k in keys]
        torch._foreach_mul_(targets, r)
        torch._foreach_add_(targets, sources, alpha=1.0 - r)
    return emas
