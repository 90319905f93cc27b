"""Write a network snapshot in the reference's released pickle format.

The reference pickles ``util.EasyDict(dataset_kwargs=EasyDict(...),
pipeline=thor.pipelines.SDAPipeline(eta), ema=<fp16 model.score.ScoreUNet>)``
with ``pickle.dump``, so each tensor is a ``torch.storage._load_from_bytes``
payload. :func:`write_reference_pickle` builds that object from a state dict
of the port's names, with torch's own ``Conv*d``, ``Linear``, ``Sequential``,
``ModuleList``, ``Upsample``, ``Unflatten`` and ``SiLU`` modules and
stand-ins for the reference's classes under the reference's module paths
(``model.score.ScoreUNet``, ``model.nn.UNet``, ``model.nn.ModResidualBlock``,
``model.nn.AttentionBlock``, ``model.nn.QKVAttention``,
``zuko.nn.LayerNorm``, ``util.EasyDict``, ``thor.pipelines.SDAPipeline``),
registered in ``sys.modules`` only while the pickle is written. The tree
has the reference's names and order: ``unet.heads.{i}[.0]``, the tails and
the ascent in reverse level order, ``project.0``, ``residue.1``/``.3``,
``qkv`` and ``proj_out`` as ``Conv1d``.

Test scaffolding for the importer's tests and ``chip_smoke.py`` phase 12;
imports only torch and numpy.
"""

from __future__ import annotations

import contextlib
import pickle
import sys
import types

import numpy as np
import torch
from torch import nn
from torch.nn.utils import skip_init

REFERENCE_CLASSES = (
    ("util", "EasyDict"),
    ("thor.pipelines", "SDAPipeline"),
    ("model.score", "ScoreUNet"),
    ("model.nn", "UNet"),
    ("model.nn", "ModResidualBlock"),
    ("model.nn", "AttentionBlock"),
    ("model.nn", "QKVAttention"),
    ("zuko.nn", "LayerNorm"),
)


def _module_class(module: str, name: str) -> type:
    return type(name, (nn.Module,), {"__module__": module, "__qualname__": name})


class _EasyDict(dict):
    def __getattr__(self, name):
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e


_EasyDict.__module__, _EasyDict.__name__, _EasyDict.__qualname__ = "util", "EasyDict", "EasyDict"
_SDAPipeline = type("SDAPipeline", (), {"__module__": "thor.pipelines", "__qualname__": "SDAPipeline"})
_CLASSES = {
    ("util", "EasyDict"): _EasyDict,
    ("thor.pipelines", "SDAPipeline"): _SDAPipeline,
    **{key: _module_class(*key) for key in REFERENCE_CLASSES[2:]},
}


@contextlib.contextmanager
def _reference_modules():
    """The reference's module paths in ``sys.modules`` for the pickler's
    class lookups, removed again afterwards."""
    mods = {}
    for module, name in _CLASSES:
        parts = module.split(".")
        for n in range(1, len(parts) + 1):
            mods.setdefault(".".join(parts[:n]), types.ModuleType(".".join(parts[:n])))
        setattr(mods[module], name, _CLASSES[(module, name)])
    saved = {k: sys.modules.get(k) for k in mods}
    sys.modules.update(mods)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                del sys.modules[k]
            else:
                sys.modules[k] = v


def _new(key, **attrs) -> nn.Module:
    m = _CLASSES[key]()
    for k, v in attrs.items():
        setattr(m, k, v)
    return m


def _param(t, shape=None) -> nn.Parameter:
    t = torch.as_tensor(np.asarray(t) if not isinstance(t, torch.Tensor) else t).detach().cpu()
    t = t.reshape(shape) if shape is not None else t
    return nn.Parameter(t.to(torch.float16).contiguous(), requires_grad=False)


def _load(module: nn.Module, sd, name: str, pointwise=False) -> nn.Module:
    w = sd[name + ".weight"]
    module.weight = _param(w, tuple(w.shape) + (1,) if pointwise else None)
    module.bias = _param(sd[name + ".bias"])
    return module


def _conv(sd, name, cin, cout, k, stride, spatial) -> nn.Module:
    cls = (nn.Conv1d, nn.Conv2d, nn.Conv3d)[spatial - 1]
    return _load(skip_init(cls, cin, cout, k, stride=stride, padding=k // 2), sd, name)


def _linear(sd, name) -> nn.Module:
    w = sd[name + ".weight"]
    return _load(skip_init(nn.Linear, w.shape[1], w.shape[0]), sd, name)


def _layer_norm(dim: int) -> nn.Module:
    return _new(("zuko.nn", "LayerNorm"), dim=dim, eps=1e-5)


def reference_network(sd, arch: dict) -> nn.Module:
    """The reference's fp16 ``ScoreUNet`` module tree (eval mode, no
    gradients) holding the weights of ``sd``, a state dict of the port's
    names (tensors or arrays), for the architecture ``arch`` (the keys of a
    snapshot's ``network_kwargs``; ``spatial`` defaults to 2)."""
    spatial = int(arch.get("spatial", 2))
    hc, blocks = list(arch["hidden_channels"]), list(arch["hidden_blocks"])
    levels, k, channels = list(arch["attention_levels"]), int(arch.get("kernel_size", 3)), int(arch["channels"])
    stride = int(arch.get("stride", 2))
    n = len(hc)

    def block(stage, i, bi):
        b = f"unet.{stage}{i}_block{bi}"
        res = _new(("model.nn", "ModResidualBlock"))
        res.project = nn.Sequential(_linear(sd, f"{b}.project"), nn.Unflatten(-1, (-1,) + (1,) * spatial))
        res.residue = nn.Sequential(_layer_norm(-(spatial + 1)),
                                    _conv(sd, f"{b}.conv0", hc[i], hc[i], k, 1, spatial), nn.SiLU(),
                                    _conv(sd, f"{b}.conv1", hc[i], hc[i], k, 1, spatial))
        mods = [res]
        if i in levels:
            a = f"unet.{stage}{i}_attn{bi}"
            attn = _new(("model.nn", "AttentionBlock"), channels=hc[i], num_heads=1)
            attn.norm = _layer_norm(1)
            attn.qkv = _load(skip_init(nn.Conv1d, hc[i], 3 * hc[i], 1), sd, f"{a}.qkv", pointwise=True)
            attn.attention = _new(("model.nn", "QKVAttention"))
            attn.proj_out = _load(skip_init(nn.Conv1d, hc[i], hc[i], 1), sd, f"{a}.proj_out", pointwise=True)
            mods.append(attn)
        return mods

    unet = _new(("model.nn", "UNet"), in_channels=channels, out_channels=channels, spatial=spatial)
    unet.heads = nn.ModuleList(
        [_conv(sd, "unet.head0", channels, hc[0], k, 1, spatial)]
        + [nn.Sequential(_conv(sd, f"unet.head{i}", hc[i - 1], hc[i], k, stride, spatial)) for i in range(1, n)])
    unet.tails = nn.ModuleList(
        [nn.Sequential(_layer_norm(-(spatial + 1)), nn.Upsample(scale_factor=(float(stride),) * spatial),
                       _conv(sd, f"unet.tail{i}", hc[i], hc[i - 1], k, 1, spatial)) for i in reversed(range(1, n))]
        + [_conv(sd, "unet.tail0", hc[0], channels, k, 1, spatial)])
    unet.descent = nn.ModuleList(
        [nn.ModuleList([m for bi in range(blocks[i]) for m in block("down", i, bi)]) for i in range(n)])
    unet.ascent = nn.ModuleList(
        [nn.ModuleList([m for bi in range(blocks[i]) for m in block("up", i, bi)]) for i in reversed(range(n))])

    net = _new(("model.score", "ScoreUNet"))
    net.unet = unet
    net.map_layer0 = _linear(sd, "map_layer0")
    net.map_layer1 = _linear(sd, "map_layer1")
    if int(arch.get("forcing_dim", 0)):
        net.map_forcing = _linear(sd, "map_forcing")
    else:
        net.map_forcing = None
    net.embedding_dim = int(arch.get("embedding_dim", 512))
    net.noise_features = int(arch.get("noise_features", 32))
    return net.eval()


def write_reference_pickle(path, sd, arch: dict, dataset_kwargs: dict, eta: float = 1e-3) -> int:
    """Pickle ``EasyDict(dataset_kwargs, pipeline, ema)`` as the reference's
    training loop writes its snapshots (:func:`reference_network` for
    ``ema``). Returns the bytes written."""
    pipeline = _SDAPipeline()
    pipeline.eta = eta
    snap = _EasyDict(dataset_kwargs=_EasyDict(dataset_kwargs), pipeline=pipeline,
                     ema=reference_network(sd, arch))
    with _reference_modules(), open(path, "wb") as f:
        pickle.dump(snap, f)
        return f.tell()


def module_tree(obj) -> list:
    """The structure of a (stub-)unpickled reference network: for every
    module in order, its path, class path, public attributes, child names,
    and each parameter's name, shape, dtype and ``requires_grad``."""
    out = []

    def walk(mod, path):
        d = mod.__dict__
        cls = type(mod)
        attrs = {k: v for k, v in d.items() if not k.startswith("_")}
        params = [(k, tuple(p.shape), str(p.dtype), bool(p.requires_grad))
                  for k, p in (d.get("_parameters") or {}).items() if p is not None]
        children = d.get("_modules") or {}
        out.append((path, f"{cls.__module__}.{cls.__name__}", attrs, list(children), params))
        for k, c in children.items():
            if c is not None:
                walk(c, f"{path}.{k}")

    walk(obj, "ema")
    return out
