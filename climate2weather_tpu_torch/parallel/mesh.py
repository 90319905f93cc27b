"""Process group and rank helpers (port of climate2weather_tpu/parallel/mesh.py).

The JAX package spans processes with ``jax.distributed`` and lays its
devices out on a mesh. The port runs one process per card, as ``torchrun``
launches it: each JAX (process, local device) pair is one rank here.

- :func:`maybe_init_distributed` starts the process group from torchrun's
  environment (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``,
  ``MASTER_PORT``), as the JAX function does from
  ``JAX_COORDINATOR_ADDRESS``, and returns the rank's device
  (``cuda:LOCAL_RANK``). Without that environment nothing starts and every
  caller runs single-process.
- :func:`rank`, :func:`world_size`, :func:`is_main`, :func:`distributed`,
  :func:`barrier`, :func:`broadcast_int` and :func:`shutdown`.
- :func:`all_reduce_grads`: the sum over ranks of every gradient and one
  more value (the step's loss) in one flat bucket, one collective a step.

The backend is NCCL on the card and gloo on the CPU unless the caller names
one: NCCL refuses two ranks on one card, so several ranks sharing a card
take gloo. Every collective here is an ``all_reduce`` or a ``broadcast``,
the two that gloo runs on CUDA tensors. Nothing falls back: a
``LOCAL_RANK`` without a card raises, and a backend that fails to start
raises.
"""

from __future__ import annotations

import datetime
import os
from typing import Iterable, Optional

import torch
import torch.distributed as dist

LAUNCH_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")
# how long a collective waits for the other ranks before it raises
TIMEOUT = datetime.timedelta(minutes=30)


def launched() -> bool:
    """Whether torchrun's environment is present (``RANK`` and
    ``WORLD_SIZE`` set); raises when it is only partly there."""
    if "RANK" not in os.environ or "WORLD_SIZE" not in os.environ:
        return False
    missing = [k for k in LAUNCH_ENV if k not in os.environ]
    if missing:
        raise RuntimeError(f"RANK and WORLD_SIZE are set but {missing} are not: launch with torchrun")
    return True


def rank_device(device="cuda") -> torch.device:
    """The device this rank runs on: ``device`` itself single-process; under
    torchrun ``cuda`` becomes ``cuda:LOCAL_RANK``, which must exist."""
    dev = torch.device(device)
    if dev.type != "cuda" or not launched():
        return dev
    local = int(os.environ["LOCAL_RANK"])
    if dev.index is not None and dev.index != local:
        raise ValueError(f"device {dev} asked for on the rank with LOCAL_RANK={local}")
    count = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if not 0 <= local < count:
        raise RuntimeError(f"LOCAL_RANK={local} but this process sees {count} CUDA device(s)")
    return torch.device("cuda", local)


def maybe_init_distributed(device="cuda", backend: Optional[str] = None) -> torch.device:
    """Start the process group when launched by torchrun and return the
    rank's device (the card is made current before anything is allocated
    on it). ``backend`` defaults to ``nccl`` on the card, ``gloo`` on the
    CPU. Without torchrun's environment: no group, ``device`` returned; with
    a group already running, that group is kept."""
    dev = rank_device(device)
    if not launched() or distributed():
        return dev
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    kwargs = {"device_id": dev} if backend == "nccl" and dev.type == "cuda" else {}
    dist.init_process_group(backend, init_method="env://", rank=int(os.environ["RANK"]),
                            world_size=int(os.environ["WORLD_SIZE"]), timeout=TIMEOUT, **kwargs)
    return dev


def distributed() -> bool:
    """Whether a process group is running (a world of one included)."""
    return dist.is_available() and dist.is_initialized()


def rank() -> int:
    return dist.get_rank() if distributed() else 0


def world_size() -> int:
    return dist.get_world_size() if distributed() else 1


def is_main() -> bool:
    return rank() == 0


def barrier(device) -> None:
    """Wait on the host until every rank got here (an all-reduce of one
    value on ``device``, read back)."""
    if distributed():
        flag = torch.ones(1, device=device)
        dist.all_reduce(flag)
        flag.item()


def broadcast_int(value: int, device) -> int:
    """Rank 0's ``value`` on every rank."""
    if not distributed():
        return value
    buf = torch.tensor([value], dtype=torch.int64, device=device)
    dist.broadcast(buf, src=0)
    return int(buf.item())


def all_reduce_grads(params: Iterable[torch.nn.Parameter], extra: torch.Tensor) -> torch.Tensor:
    """Sum every parameter's ``.grad`` and the scalar ``extra`` over the ranks
    in place, through one flat fp32 bucket; returns the summed ``extra``.
    Every rank passes the same parameters, each with a gradient."""
    grads = [p.grad for p in params]
    if any(g is None for g in grads):
        raise RuntimeError("a parameter has no gradient: the ranks' buckets would not line up")
    bucket = torch.cat([g.reshape(-1) for g in grads] + [extra.reshape(1).to(grads[0].dtype)])
    dist.all_reduce(bucket)
    pieces = bucket.split([g.numel() for g in grads] + [1])
    torch._foreach_copy_(grads, [piece.view_as(g) for piece, g in zip(pieces, grads)])
    return pieces[-1][0]


def shutdown() -> None:
    """Tear the process group down, where one runs."""
    if distributed():
        dist.destroy_process_group()
