"""Fabricate a trainer checkpoint from an archived inference snapshot (port
of the JAX repository's ``scripts/fabricate_resume_state.py``).

When a run's training states are lost but an inference snapshot survives,
this rebuilds a checkpoint that ``train`` resumes from, in the JAX
package's layout (``training/checkpoint.py``), so either package's trainer
takes it:

- ``params`` = the snapshot's params, cast to fp32;
- ``emas`` (one per rate) = copies of the same params;
- ``opt_state`` = fresh AdamW moments (Adam's count 0: standard bias
  correction) with the LR schedule's count set to ``step``, so the linear
  schedule continues at the absolute ndata position;
- ``step`` = ndata // batch, so ndata accounting, snapshot names and the
  sampler's stream position resume at the snapshot's place.

Usage::

    python -m climate2weather_tpu_torch.scripts.fabricate_resume_state \\
        --snapshot artifacts/network-snapshot-0009437-0.999900 \\
        --out-dir runs/meso128 --ndata 9437184 --batch 256 \\
        --lr 3e-4 --total-ndata 13631488 --ema-rates 0.9999,0.999

Everything runs on the host (numpy and the package's msgpack writer).
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from climate2weather_tpu_torch.training.checkpoint import CheckpointIO, load_snapshot
from climate2weather_tpu_torch.training.ema import rate_key
from climate2weather_tpu_torch.training.lr import make_schedule


def _leaves(tree) -> list:
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in _leaves(v)]
    return [tree]


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


def fresh_opt_state(params) -> dict:
    """optax ``adamw``'s initial state of ``params`` in its flax state-dict
    layout: ``"0"`` Adam's count and zero moments, ``"1"`` the weight decay's
    empty state, ``"2"`` the schedule's count."""
    zero = lambda p: np.zeros_like(p, np.float32)  # noqa: E731
    return {"0": {"count": np.asarray(0, np.int32), "mu": _map(zero, params), "nu": _map(zero, params)},
            "1": {}, "2": {"count": np.asarray(0, np.int32)}}


def set_schedule_count(opt_state: dict, count: int) -> dict:
    """``opt_state`` with the schedule's count set to ``count`` (the LR
    position), Adam's bias-correction count left alone."""
    if set(opt_state) != {"0", "1", "2"} or "count" not in opt_state["2"]:
        raise ValueError(f"not optax's adamw state: keys {sorted(opt_state)}")
    return {**opt_state, "2": {**opt_state["2"], "count": np.asarray(count, np.int32)}}


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m climate2weather_tpu_torch.scripts.fabricate_resume_state")
    ap.add_argument("--snapshot", required=True, help="inference snapshot dir")
    ap.add_argument("--out-dir", required=True, help="training run dir")
    ap.add_argument("--ndata", type=int, required=True,
                    help="absolute ndata of the snapshot (e.g. 9437184)")
    ap.add_argument("--batch", type=int, required=True)
    ap.add_argument("--lr", type=float, required=True,
                    help="ref_lr of the NEW schedule (H3: 3e-4)")
    ap.add_argument("--total-ndata", type=int, required=True,
                    help="total_ndata of the NEW schedule (H3: 13631488)")
    ap.add_argument("--ema-rates", default="0.9999,0.999")
    args = ap.parse_args(argv)

    assert args.ndata % args.batch == 0
    step = args.ndata // args.batch
    rates = tuple(float(r) for r in args.ema_rates.split(","))

    print(f"Loading snapshot {args.snapshot} ...")
    params, _cfg = load_snapshot(args.snapshot)
    n_params = sum(p.size for p in _leaves(params))
    print(f"  {n_params / 1e6:.2f}M params")

    schedule = make_schedule(
        {"func_name": "lr/linear", "ref_lr": args.lr, "total_ndata": args.total_ndata},
        args.batch,
    )
    state = {
        "step": np.asarray(step, np.int32),
        "params": params,
        "opt_state": set_schedule_count(fresh_opt_state(params), step),
        "emas": {rate_key(r): _map(np.copy, params) for r in rates},
    }

    os.makedirs(args.out_dir, exist_ok=True)
    kdata = args.ndata // 1000
    path = os.path.join(args.out_dir, f"training-state-{kdata:07d}.ckpt")
    CheckpointIO(state=state, meta={"batch_size": args.batch}).save(path)
    lr_now = float(schedule(step))
    print(f"Fabricated {path}: step={step} (ndata={args.ndata}), "
          f"lr(step)={lr_now:.3e}, ema rates={rates}, fresh Adam moments.")


if __name__ == "__main__":
    main()
