"""Import a reference torch network snapshot into the port's snapshot format
(port of the repository's ``scripts/import_reference_snapshot.py``).

    python -m climate2weather_tpu_torch.import_reference_snapshot \\
        --snapshot network-snapshot-0186646-0.999900.pkl \\
        --out runs/imported/network-snapshot-0186646-0.999900

The reference releases trained weights as pickled
``network-snapshot-{kdata}{-rate}.pkl`` files holding
``EasyDict(dataset_kwargs, pipeline, ema=<fp16 torch ScoreUNet>)``. Every
published experiment config starts from
``network-snapshot-0186646-0.999900.pkl``, so running the paper's weights
needs this converter.

The unpickler needs torch but not the reference package: a class of
``torch``, ``collections``, ``numpy`` or ``builtins`` is loaded as itself,
any other (the reference's modules, zuko's ``LayerNorm``, ``EasyDict``) as
a stub that records its attributes and runs nothing. The module tree is
walked through its ``_parameters`` / ``_buffers`` / ``_modules`` dicts, as
``state_dict()`` would, and every tensor is widened from fp16 to fp32.

The port is PyTorch, so the reference's tensors keep their layout: a
``Conv{1,2,3}d`` weight is the port's, a ``Linear`` weight too; the
``Conv1d(kernel_size=1)`` of the attention's ``qkv`` and ``proj_out`` loses
its last axis to become the port's ``Linear``. Only the names change
(:func:`convert_state_dict`). The architecture is inferred from the state
dict alone (:func:`infer_architecture`), with ``norm_ddof: 1``: zuko's
``LayerNorm`` standardizes with the unbiased variance, and the net was
trained with it. Like the reference importer, it does not infer
``spatial``: a 1-D or 3-D pickle needs ``spatial`` set in the written
config by hand.

The output directory (``params.msgpack`` in the flax layout and
``config.yaml``) is written by the port's ``training.checkpoint.save_snapshot``
and is read by ``experiment predict`` of either package.
"""

from __future__ import annotations

import argparse
import os
import pickle
import re
from typing import Dict

import numpy as np
import torch

# the packages whose classes the unpickler loads as themselves
ALLOWED = ("torch", "collections", "numpy", "builtins")


# ---------------------------------------------------------------------------
# stub-tolerant unpickling


class _Stub:
    """Stands in for any reference-package class in the pickle stream."""

    def __init__(self, *args, **kwargs):
        pass

    def __setstate__(self, state):
        if isinstance(state, dict):
            self.__dict__.update(state)
        else:
            self.__dict__["_state"] = state


class _StubDict(dict):
    """Stub for dict subclasses (the reference's util.EasyDict)."""

    def __getattr__(self, name):
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e


class _SnapshotUnpickler(pickle.Unpickler):
    def find_class(self, module, name):
        if module.split(".")[0] in ALLOWED:
            return super().find_class(module, name)
        if "EasyDict" in name:
            return _StubDict
        return type(name, (_Stub,), {"__module__": module})


def load_reference_snapshot(path: str):
    """Unpickle a reference snapshot without the reference package.

    Returns ``(state_dict, meta)``: flat {dotted torch name: fp32 ndarray}
    of the EMA network, and the snapshot's ``dataset_kwargs`` (its scalar
    entries) and the pipeline's ``eta`` (1e-3 if absent).
    """
    with open(path, "rb") as f:
        snap = _SnapshotUnpickler(f).load()
    data = snap if isinstance(snap, dict) else snap.__dict__
    ema = data.get("ema")
    if ema is None:
        raise ValueError(f"{path}: no 'ema' network in snapshot (keys: {list(data)})")

    sd: Dict[str, np.ndarray] = {}

    def walk(mod, prefix=""):
        d = getattr(mod, "__dict__", {})
        for name, p in (d.get("_parameters") or {}).items():
            if p is not None:
                sd[prefix + name] = p.detach().cpu().float().numpy()
        for name, b in (d.get("_buffers") or {}).items():
            if b is not None:
                sd[prefix + name] = b.detach().cpu().float().numpy()
        for name, m in (d.get("_modules") or {}).items():
            if m is not None:
                walk(m, prefix + name + ".")

    walk(ema)

    meta = {}
    dk = data.get("dataset_kwargs")
    if isinstance(dk, dict):
        meta["dataset_kwargs"] = {k: v for k, v in dk.items() if isinstance(v, (int, float, str, bool))}
    pipe = data.get("pipeline")
    eta = getattr(pipe, "eta", None)
    if eta is None and isinstance(getattr(pipe, "__dict__", None), dict):
        eta = pipe.__dict__.get("eta")
    meta["eta"] = float(eta) if eta is not None else 1e-3
    return sd, meta


# ---------------------------------------------------------------------------
# architecture inference + renaming


def infer_architecture(sd: Dict[str, np.ndarray]) -> dict:
    """Reconstruct the constructor arguments from the state dict alone."""
    heads = sorted(
        int(m.group(1)) for k in sd if (m := re.fullmatch(r"unet\.heads\.(\d+)(?:\.0)?\.weight", k))
    )
    n_levels = len(heads)
    hidden_channels = []
    for i in range(n_levels):
        key = f"unet.heads.{i}.weight" if i == 0 else f"unet.heads.{i}.0.weight"
        hidden_channels.append(int(sd[key].shape[0]))
    in_channels = int(sd["unet.heads.0.weight"].shape[1])
    kernel_size = int(sd["unet.heads.0.weight"].shape[-1])
    hidden_blocks, attention_levels = [], []
    for i in range(n_levels):
        hidden_blocks.append(sum(1 for k in sd if re.fullmatch(rf"unet\.descent\.{i}\.\d+\.project\.0\.weight", k)))
        if any(re.fullmatch(rf"unet\.descent\.{i}\.\d+\.qkv\.weight", k) for k in sd):
            attention_levels.append(i)
    return dict(
        channels=in_channels,
        embedding_dim=int(sd["map_layer1.weight"].shape[0]),
        noise_features=int(sd["map_layer0.weight"].shape[1]),
        hidden_channels=hidden_channels,
        hidden_blocks=hidden_blocks,
        attention_levels=attention_levels,
        kernel_size=kernel_size,
        forcing_dim=int(sd["map_forcing.weight"].shape[1]) if "map_forcing.weight" in sd else 0,
        norm_ddof=1,  # zuko LayerNorm semantics (unbiased variance)
    )


def _dense(w: np.ndarray) -> np.ndarray:
    if w.ndim == 3:  # Conv1d(kernel_size=1) used as a position-wise Linear
        assert w.shape[-1] == 1, w.shape
        w = w[..., 0]
    return w


def _reference_names(arch: dict) -> Dict[str, tuple]:
    """{port module name: (reference module name, is a position-wise
    Conv1d)} for every weight-bearing module of the network."""
    names = {"map_layer0": ("map_layer0", False), "map_layer1": ("map_layer1", False)}
    if arch.get("forcing_dim", 0):
        names["map_forcing"] = ("map_forcing", False)
    n_levels = len(arch["hidden_blocks"])
    for i in range(n_levels):
        names[f"unet.head{i}"] = (f"unet.heads.{i}" if i == 0 else f"unet.heads.{i}.0", False)
        # the reference's tails hold the levels in reverse; level 0 is a
        # bare conv, the others Sequential(LayerNorm, Upsample, conv)[2]
        j = n_levels - 1 - i
        names[f"unet.tail{i}"] = (f"unet.tails.{j}" if i == 0 else f"unet.tails.{j}.2", False)
        has_attn = i in arch["attention_levels"]
        for stage, ref_stage, ref_level in (("down", "descent", i), ("up", "ascent", j)):  # ascent reversed
            for bi in range(arch["hidden_blocks"][i]):
                m = bi * 2 if has_attn else bi
                base = f"unet.{ref_stage}.{ref_level}.{m}"
                blk = f"unet.{stage}{i}_block{bi}"
                names[f"{blk}.project"] = (f"{base}.project.0", False)
                names[f"{blk}.conv0"] = (f"{base}.residue.1", False)
                names[f"{blk}.conv1"] = (f"{base}.residue.3", False)
                if has_attn:
                    abase = f"unet.{ref_stage}.{ref_level}.{m + 1}"
                    names[f"unet.{stage}{i}_attn{bi}.qkv"] = (f"{abase}.qkv", True)
                    names[f"unet.{stage}{i}_attn{bi}.proj_out"] = (f"{abase}.proj_out", True)
    return names


def convert_state_dict(sd: Dict[str, np.ndarray], arch: dict) -> Dict[str, torch.Tensor]:
    """Flat reference state dict -> the port's ``state_dict`` (fp32)."""
    out = {}
    for name, (ref, pointwise) in _reference_names(arch).items():
        w = sd[ref + ".weight"]
        out[name + ".weight"] = torch.tensor(_dense(w) if pointwise else w, dtype=torch.float32)
        out[name + ".bias"] = torch.tensor(sd[ref + ".bias"], dtype=torch.float32)
    return out


def import_snapshot(snapshot_path: str, out_dir: str, window: int = None,
                    num_features: int = None, spatial_res: int = None) -> str:
    """Full conversion: reference .pkl -> a snapshot directory ``out_dir``."""
    from climate2weather_tpu_torch.training.checkpoint import save_snapshot

    sd, meta = load_reference_snapshot(snapshot_path)
    arch = infer_architecture(sd)
    state_dict = convert_state_dict(sd, arch)
    n_params = sum(v.numel() for v in state_dict.values())
    print(f"Inferred architecture: {arch}")
    print(f"Converted {n_params / 1e6:.1f}M parameters")

    dk = meta.get("dataset_kwargs", {})
    window = window or int(dk.get("window", 13))
    num_features = num_features or int(dk.get("num_features", arch["channels"] // window))
    spatial_res = spatial_res or int(dk.get("spatial_res", 128))
    assert arch["channels"] == num_features * window, (
        f"channels {arch['channels']} != num_features*window "
        f"{num_features}*{window} — pass --window/--num-features explicitly"
    )
    config = {
        "network_kwargs": arch,
        "pipeline_kwargs": {"class_name": "sda_pipeline", "eta": meta["eta"]},
        "dataset_kwargs": {
            "train": {
                "class_name": "cosmo_dataset",
                "window": window,
                "num_features": num_features,
                "spatial_res": spatial_res,
            }
        },
        "imported_from": os.path.basename(snapshot_path),
    }
    run_dir, name = os.path.split(out_dir.rstrip("/"))
    m = re.search(r"(\d{7})(?:-(.*))?$", name)
    kdata = int(m.group(1)) if m else 0
    rate = m.group(2) if m and m.group(2) else "imported"
    path = save_snapshot(run_dir or ".", kdata, rate, state_dict, config)
    want = os.path.join(run_dir or ".", name)
    if path != want:
        os.replace(path, want)
        path = want
    print(f"Wrote {path}")
    return path


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--snapshot", required=True, help="reference .pkl snapshot")
    ap.add_argument("--out", required=True, help="output snapshot directory")
    ap.add_argument("--window", type=int, default=None)
    ap.add_argument("--num-features", type=int, default=None)
    ap.add_argument("--spatial-res", type=int, default=None)
    args = ap.parse_args(argv)
    import_snapshot(args.snapshot, args.out, window=args.window, num_features=args.num_features,
                    spatial_res=args.spatial_res)


if __name__ == "__main__":
    main()
