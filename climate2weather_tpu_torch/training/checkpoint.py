"""Checkpoints and inference snapshots in the JAX package's formats (port of
climate2weather_tpu/training/checkpoint.py).

1. **Training state** ``training-state-{kdata:07d}.ckpt``: an 8-byte header
   length, a JSON header of blob sizes, then one msgpack blob per named
   object in key order, written to a temporary file and moved into place.
   The ``state`` blob is the flax state dict of the JAX ``TrainState``:
   ``step`` (0-d int32), ``params``, ``opt_state`` as optax's ``adamw``
   chain lays it out (``"0"``: ``count``/``mu``/``nu`` of ``scale_by_adam``,
   ``"1"``: ``{}`` for the weight decay, ``"2"``: ``count`` of the
   schedule) and ``emas``. A JAX checkpoint resumes here and a checkpoint of
   this package resumes in JAX. The two counts may differ: Adam's is its
   bias correction's (AdamW's per-parameter ``"step"``, 0 for fresh
   moments), the schedule's is ``step``, as a state fabricated from a
   snapshot (``climate2weather_tpu_torch.scripts.fabricate_resume_state``)
   holds them.
2. **Inference snapshot** ``network-snapshot-{kdata:07d}-{rate}/``:
   ``params.msgpack`` (flax layout) and ``config.yaml``.

Everything is written with the package's own msgpack and YAML writers
(``io/snapshot.py``).
"""

from __future__ import annotations

import json
import os
import queue
import re
import threading
from typing import Any, Callable, Optional

import numpy as np
import torch

from climate2weather_tpu_torch.convert import fit_state_dict, to_flax_params
from climate2weather_tpu_torch.io.snapshot import (  # noqa: F401 (re-exported)
    load_snapshot,
    msgpack_dump_parts,
    msgpack_loads,
    yaml_dump_file,
)
from climate2weather_tpu_torch.training.state import TrainState

SNAPSHOT_PREFIX = "network-snapshot-"
CKPT_PATTERN = r"training-state-(\d+)\.ckpt"


def _moments(state: TrainState):
    """Per parameter name: (exp_avg, exp_avg_sq); zeros before the first
    update, when the optimizer holds no state yet."""
    out = {}
    for name, p in state.net.named_parameters():
        st = state.optimizer.state.get(p, {})
        if "exp_avg" in st:
            out[name] = (st["exp_avg"], st["exp_avg_sq"])
        else:
            out[name] = (torch.zeros_like(p), torch.zeros_like(p))
    return out


def adam_count(optimizer: torch.optim.Optimizer) -> int:
    """AdamW's bias-correction count: its parameters' common ``"step"``, 0
    before the first update."""
    counts = {int(st["step"]) for st in optimizer.state.values() if "step" in st}
    if len(counts) > 1:
        raise ValueError(f"AdamW's parameters hold different counts {sorted(counts)}")
    return counts.pop() if counts else 0


def state_to_flax(state: TrainState) -> dict:
    """Host copy of ``state`` as the flax state dict of the JAX TrainState
    (numpy arrays; the device-to-host copies happen here)."""
    count = np.asarray(state.step, np.int32)
    moments = _moments(state)
    return {
        "step": count,
        "params": to_flax_params(state.net.state_dict()),
        "opt_state": {
            "0": {
                "count": np.asarray(adam_count(state.optimizer), np.int32),
                "mu": to_flax_params({k: m[0] for k, m in moments.items()}),
                "nu": to_flax_params({k: m[1] for k, m in moments.items()}),
            },
            "1": {},
            "2": {"count": count.copy()},
        },
        "emas": {rk: to_flax_params(ema) for rk, ema in state.emas.items()},
    }


@torch.no_grad()
def load_flax_state(state: TrainState, tree: dict) -> TrainState:
    """Restore ``state`` in place from the flax state dict of a JAX
    TrainState (as :func:`state_to_flax` writes it). The schedule's count
    must equal ``step``; Adam's count becomes AdamW's ``"step"``, and where
    it is 0 the optimizer keeps no state (fresh moments)."""
    params = dict(state.net.named_parameters())
    step = int(np.asarray(tree["step"]))
    adam = tree["opt_state"]["0"]
    if set(tree["opt_state"]) != {"0", "1", "2"} or tree["opt_state"]["1"] != {}:
        raise ValueError(f"not optax's adamw state: keys {sorted(tree['opt_state'])}")
    count = int(np.asarray(adam["count"]))
    schedule_count = int(np.asarray(tree["opt_state"]["2"]["count"]))
    if schedule_count != step:
        raise ValueError(f"the schedule's count {schedule_count} differs from step {step}")
    if count < 0:
        raise ValueError(f"Adam's count {count} is negative")
    state.net.load_state_dict(fit_state_dict(tree["params"], params, "params"), strict=True)
    mu = fit_state_dict(adam["mu"], params, "opt_state mu")
    nu = fit_state_dict(adam["nu"], params, "opt_state nu")
    state.optimizer.state.clear()
    if count > 0:
        for name, p in params.items():
            state.optimizer.state[p] = {
                "step": torch.tensor(float(count), dtype=torch.float32),
                "exp_avg": mu[name].to(p.device),
                "exp_avg_sq": nu[name].to(p.device),
            }
    for rk in list(state.emas):
        if rk not in tree["emas"]:
            raise ValueError(f"checkpoint has no EMA {rk}; it has {sorted(tree['emas'])}")
    state.emas = {
        rk: {k: v.to(params[k].device) for k, v in fit_state_dict(ema, params, f"ema {rk}").items()}
        for rk, ema in tree["emas"].items()
    }
    state.step = step
    return state


def _to_host(obj: Any) -> Any:
    """A TrainState as its flax state dict; tensors and Python scalars as
    numpy arrays, as ``jax.tree.map(np.asarray, ...)`` leaves them."""
    if isinstance(obj, TrainState):
        return state_to_flax(obj)
    if isinstance(obj, dict):
        return {k: _to_host(v) for k, v in obj.items()}
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu().numpy()
    if isinstance(obj, np.ndarray):
        return obj
    return np.asarray(obj)


class CheckpointIO:
    """Save and restore named state objects in one file. A ``TrainState``
    is written as (and restored in place from) the JAX TrainState layout;
    other objects are host trees, restored as read."""

    def __init__(self, **state_objs: Any):
        self.state_objs = state_objs

    def save(self, path: str, verbose: bool = True) -> None:
        if verbose:
            print(f"Saving {path} ... ", end="", flush=True)
        payload = {
            name: msgpack_dump_parts(_to_host(obj))
            for name, obj in self.state_objs.items()
            if obj is not None
        }
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            header = json.dumps({k: sum(len(p) for p in v) for k, v in payload.items()}).encode()
            f.write(len(header).to_bytes(8, "little"))
            f.write(header)
            for k in sorted(payload):
                for part in payload[k]:
                    f.write(part)
        os.replace(tmp, path)
        if verbose:
            print("done.")

    def load(self, path: str, verbose: bool = True) -> dict:
        if verbose:
            print(f"Loading {path} ... ", end="", flush=True)
        with open(path, "rb") as f:
            hlen = int.from_bytes(f.read(8), "little")
            sizes = json.loads(f.read(hlen).decode())
            blobs = {k: f.read(sizes[k]) for k in sorted(sizes)}
        restored = {}
        for name, obj in self.state_objs.items():
            if obj is None or name not in blobs:
                continue
            tree = msgpack_loads(blobs[name])
            if isinstance(obj, TrainState):
                load_flax_state(obj, tree)
                restored[name] = obj
            else:
                restored[name] = tree
                self.state_objs[name] = tree
        if verbose:
            print("done.")
        return restored

    def load_latest(self, run_dir: str, pattern: str = CKPT_PATTERN,
                    verbose: bool = True) -> Optional[str]:
        """Restore the highest-numbered checkpoint in ``run_dir``; returns
        its path, or None where there is none."""
        try:
            entries = os.scandir(run_dir)
        except FileNotFoundError:
            return None
        fnames = [e.name for e in entries if e.is_file() and re.fullmatch(pattern, e.name)]
        if not fnames:
            return None
        latest = max(fnames, key=lambda x: int(re.fullmatch(pattern, x).group(1)))
        path = os.path.join(run_dir, latest)
        self.load(path, verbose=verbose)
        return path


class AsyncWriter:
    """One background thread for checkpoint and snapshot writes. At most one
    job is in flight (``submit`` waits for the previous one), and an error
    in a job is raised on the next ``submit``, ``flush`` or ``close``."""

    def __init__(self):
        self._q: queue.Queue = queue.Queue(maxsize=1)
        self._err: Optional[BaseException] = None
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self):
        while True:
            fn = self._q.get()
            if fn is None:
                self._q.task_done()
                return
            try:
                fn()
            except BaseException as e:  # noqa: BLE001 - raised again on submit/flush
                self._err = e
            finally:
                self._q.task_done()

    def _check(self):
        if self._err is not None:
            err, self._err = self._err, None
            raise RuntimeError("async checkpoint write failed") from err

    def submit(self, fn: Callable[[], None]):
        self._q.join()  # the previous write has finished, not only been taken
        self._check()
        self._q.put(fn)

    def flush(self):
        self._q.join()
        self._check()

    def close(self):
        self._q.put(None)
        self._q.join()
        self._check()


def prune_checkpoints(run_dir: str, keep_last: int, pattern: str = CKPT_PATTERN) -> None:
    """Delete all but the ``keep_last`` highest-numbered training states."""
    try:
        entries = os.scandir(run_dir)
    except FileNotFoundError:
        return
    fnames = [e.name for e in entries if e.is_file() and re.fullmatch(pattern, e.name)]
    fnames.sort(key=lambda x: int(re.fullmatch(pattern, x).group(1)))
    for name in fnames[: max(0, len(fnames) - keep_last)]:
        os.remove(os.path.join(run_dir, name))


def save_snapshot(run_dir: str, kdata: int, rate_suffix: str, params, config: dict,
                  half_precision: bool = False) -> str:
    """Write ``network-snapshot-{kdata:07d}-{rate}/`` with ``params.msgpack``
    and ``config.yaml``. ``params`` is a flax tree of numpy arrays or a
    state dict of tensors; ``half_precision`` stores it as float16."""
    if any(isinstance(v, torch.Tensor) for v in params.values()):
        params = to_flax_params(params)

    def cast(node):
        if isinstance(node, dict):
            return {k: cast(v) for k, v in node.items()}
        return np.asarray(node, np.float16 if half_precision else None)

    snap_dir = os.path.join(run_dir, f"{SNAPSHOT_PREFIX}{kdata:07d}-{rate_suffix}")
    os.makedirs(snap_dir, exist_ok=True)
    with open(os.path.join(snap_dir, "params.msgpack"), "wb") as f:
        for part in msgpack_dump_parts(cast(params)):
            f.write(part)
    yaml_dump_file(config, os.path.join(snap_dir, "config.yaml"))
    return snap_dir
