"""Carry the JAX package's parameter tree across to the port's modules.

The flax tree (as numpy arrays, from :func:`io.snapshot.load_snapshot`) and
the port's ``state_dict`` use the same names, those of the snapshot:
``map_layer0``/``map_layer1``, ``unet/head{i}``,
``unet/{down,up}{i}_block{b}/{project,conv0,conv1}``,
``unet/{down,up}{i}_attn{b}/{qkv,proj_out}`` and ``unet/tail{i}``. Layouts
differ: a flax conv kernel is WIO, HWIO or DHWIO (1-, 2- or 3-D) and
becomes torch's OIW, OIHW or OIDHW; a flax Dense kernel is ``[in, out]`` and
becomes a Linear weight ``[out, in]``.
:func:`to_flax_params` is the inverse of :func:`to_state_dict`, exact both
ways, for writing checkpoints and snapshots in the JAX package's layout.
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
        elif leaf == "kernel" and arr.ndim in (3, 4, 5):  # (D)(H)WIO -> OI(D)(H)W
            w = np.transpose(arr, (arr.ndim - 1, arr.ndim - 2, *range(arr.ndim - 2)))
            out[f"{name}.weight"] = torch.tensor(w, dtype=torch.float32)
        elif leaf == "kernel" and arr.ndim == 2:  # [in, out] -> [out, in]
            out[f"{name}.weight"] = torch.tensor(arr.T, dtype=torch.float32)
        else:
            raise ValueError(f"no torch counterpart for leaf {path} of shape {arr.shape}")
    return out


def to_flax_params(state_dict: Mapping[str, torch.Tensor]) -> dict:
    """torch state_dict (or any dict of tensors keyed like one) -> flax
    ``{'params': {...}}`` tree of numpy arrays in the tensors' dtype; the
    inverse of :func:`to_state_dict`."""
    tree: dict = {}
    for name, tensor in state_dict.items():
        arr = tensor.detach().cpu().numpy()
        *modules, key = flax_path(name, arr.shape)
        if key == "kernel" and arr.ndim in (3, 4, 5):  # OI(D)(H)W -> (D)(H)WIO
            arr = np.ascontiguousarray(np.transpose(arr, (*range(2, arr.ndim), 1, 0)))
        elif key == "kernel":  # [out, in] -> [in, out]
            arr = np.ascontiguousarray(arr.T)
        node = tree
        for part in modules:
            node = node.setdefault(part, {})
        node[key] = arr
    return {"params": tree}


def flax_path(name: str, shape) -> tuple:
    """The flax path of the port's parameter ``name`` of ``shape``, below
    ``params``: ``unet.head0.weight`` -> ``("unet", "head0", "kernel")``."""
    module, _, leaf = name.rpartition(".")
    if leaf == "bias":
        key = "bias"
    elif leaf == "weight" and len(shape) in (2, 3, 4, 5):
        key = "kernel"
    else:
        raise ValueError(f"no flax counterpart for {name} of shape {tuple(shape)}")
    return (*module.split("."), key)


def fit_state_dict(params: Mapping, like: Mapping[str, torch.Tensor],
                   what: str = "parameter tree") -> dict[str, torch.Tensor]:
    """``to_state_dict(params)``, checked against the names and shapes of
    ``like``; raises on a missing leaf, an extra leaf or a shape that
    differs."""
    sd = to_state_dict(params)
    missing = sorted(set(like) - set(sd))
    extra = sorted(set(sd) - set(like))
    if missing or extra:
        raise ValueError(f"{what} does not fit the model: missing {missing}, extra {extra}")
    bad = [(k, tuple(sd[k].shape), tuple(v.shape)) for k, v in like.items() if sd[k].shape != v.shape]
    if bad:
        raise ValueError(f"{what}: shape mismatch (name, given, wanted): {bad}")
    return sd


def load_params(model: torch.nn.Module, params: Mapping) -> torch.nn.Module:
    """Convert ``params`` and load them into ``model``; raises on a missing
    leaf, an extra leaf or a shape that differs."""
    model.load_state_dict(fit_state_dict(params, model.state_dict()), strict=True)
    return model


def conv_weight_hwio(weight: torch.Tensor) -> torch.Tensor:
    """A port conv weight (OIHW) as the flax/JAX HWIO kernel, the layout
    ``ops.winograd.winograd_conv3x3`` takes (a view, not a copy)."""
    return weight.permute(2, 3, 1, 0)
