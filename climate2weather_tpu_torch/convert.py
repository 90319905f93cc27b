"""Carry the JAX package's parameter tree across to the port's modules.

The flax tree (as numpy arrays, from :func:`io.snapshot.load_snapshot`) and
the port's ``state_dict`` use the same names, those of the snapshot:
``map_layer0``/``map_layer1``, ``unet/head{i}``,
``unet/{down,up}{i}_block{b}/{project,conv0,conv1}``,
``unet/{down,up}{i}_attn{b}/{qkv,proj_out}`` and ``unet/tail{i}``. Layouts
differ: a flax conv kernel is HWIO and becomes torch's OIHW; a flax Dense
kernel is ``[in, out]`` and becomes a Linear weight ``[out, in]``.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch


def _flatten(tree: Mapping, prefix: str = ""):
    for key, val in tree.items():
        path = f"{prefix}/{key}" if prefix else str(key)
        if isinstance(val, Mapping):
            yield from _flatten(val, path)
        else:
            yield path, np.asarray(val)


def to_state_dict(params: Mapping) -> dict[str, torch.Tensor]:
    """flax ``{'params': {...}}`` (or the inner dict) -> torch state_dict."""
    if set(params) == {"params"}:
        params = params["params"]
    out = {}
    for path, arr in _flatten(params):
        module, _, leaf = path.rpartition("/")
        name = module.replace("/", ".")
        if leaf == "bias":
            out[f"{name}.bias"] = torch.tensor(arr, dtype=torch.float32)
        elif leaf == "kernel" and arr.ndim == 4:  # HWIO -> OIHW
            w = np.transpose(arr, (3, 2, 0, 1))
            out[f"{name}.weight"] = torch.tensor(w, dtype=torch.float32)
        elif leaf == "kernel" and arr.ndim == 2:  # [in, out] -> [out, in]
            out[f"{name}.weight"] = torch.tensor(arr.T, dtype=torch.float32)
        else:
            raise ValueError(f"no torch counterpart for leaf {path} of shape {arr.shape}")
    return out


def load_params(model: torch.nn.Module, params: Mapping) -> torch.nn.Module:
    """Convert ``params`` and load them into ``model``; raises on a missing
    leaf, an extra leaf or a shape that differs."""
    sd = to_state_dict(params)
    want = model.state_dict()
    missing = sorted(set(want) - set(sd))
    extra = sorted(set(sd) - set(want))
    if missing or extra:
        raise ValueError(f"parameter tree does not fit the model: missing {missing}, extra {extra}")
    bad = [(k, tuple(sd[k].shape), tuple(v.shape)) for k, v in want.items() if sd[k].shape != v.shape]
    if bad:
        raise ValueError(f"shape mismatch (name, given, wanted): {bad}")
    model.load_state_dict(sd, strict=True)
    return model
