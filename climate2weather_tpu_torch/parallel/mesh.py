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
- :func:`sample_groups`: the ranks of a predict run in G = gcd(num_samples,
  world) groups of world / G consecutive ranks (:class:`SampleGroups`).
  Samples are striped over the groups; inside a group the ranks split each
  sample's window evaluations, as one JAX process splits them over its
  devices. A group of one rank runs whole samples: no process group of its
  own, nothing split.

The backend is NCCL on the card and gloo on the CPU unless the caller names
one: NCCL refuses two ranks on one card, so several ranks sharing a card
take gloo. Every collective here is an ``all_reduce`` or a ``broadcast``,
the two that gloo runs on CUDA tensors. Nothing falls back: a
``LOCAL_RANK`` without a card raises, and a backend that fails to start
raises.
"""

from __future__ import annotations

import datetime
import math
import os
from dataclasses import dataclass
from typing import Any, Iterable, Optional

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


@dataclass(frozen=True)
class SampleGroups:
    """This rank's place among the sample groups of :func:`sample_groups`:
    ``count`` groups of ``size`` consecutive ranks, this rank the ``rank``-th
    of group ``index``. The defaults are a single process. The collectives
    run over the group's ranks only (``process_group``, None for a group of
    one, which needs none); ``device`` holds their small buffers."""

    count: int = 1
    index: int = 0
    rank: int = 0
    size: int = 1
    process_group: Any = None
    device: Any = "cpu"

    @property
    def leader(self) -> bool:
        """Whether this rank writes the group's files (its first rank)."""
        return self.rank == 0

    def all_reduce(self, tensor: torch.Tensor) -> None:
        """Sum ``tensor`` over the group's ranks, in place."""
        if self.size > 1:
            dist.all_reduce(tensor, group=self.process_group)

    def broadcast(self, tensor: torch.Tensor) -> None:
        """The group leader's ``tensor`` on every rank of the group, in place."""
        if self.size > 1:
            dist.broadcast(tensor, src=self.index * self.size, group=self.process_group)

    def barrier(self) -> None:
        """Wait on the host until every rank of the group got here."""
        if self.size > 1:
            flag = torch.ones(1, device=self.device)
            self.all_reduce(flag)
            flag.item()

    def check_agree(self, what: str, *tensors: torch.Tensor) -> None:
        """Raise on every rank of the group unless all its ranks hold the
        same values: the float64 sum of each tensor, compared through one
        all-reduce of the largest and the negated smallest. The ranks of a
        group compute one trajectory on identical inputs, so any difference
        is a fault; every rank sees the same reduced values and raises
        together, and none goes on alone."""
        if self.size <= 1:
            return
        sums = torch.stack([t.sum(dtype=torch.float64).to(self.device) for t in tensors])
        sums = torch.nan_to_num(sums, nan=1.0e308)  # NaN on every rank agrees
        both = torch.cat([sums, -sums])
        dist.all_reduce(both, op=dist.ReduceOp.MAX, group=self.process_group)
        hi, lo = both[: len(tensors)], -both[len(tensors):]
        if not torch.equal(hi, lo):
            raise RuntimeError(f"the {self.size} ranks of sample group {self.index} disagree on {what}: "
                               f"sums from {lo.tolist()} to {hi.tolist()}")


def sample_groups(num_samples: int, device="cpu") -> SampleGroups:
    """This rank's sample group: G = gcd(``num_samples``, world) groups of
    world / G consecutive ranks. Where groups hold more than one rank, every
    rank makes every group's process group, in the same order (as
    ``dist.new_group`` requires), and keeps its own."""
    world, r = world_size(), rank()
    count = math.gcd(int(num_samples), world)
    size = world // count
    own = None
    if size > 1:
        for g in range(count):
            group = dist.new_group(list(range(g * size, (g + 1) * size)))
            if g == r // size:
                own = group
    return SampleGroups(count=count, index=r // size, rank=r % size, size=size, process_group=own,
                        device=torch.device(device))


def shutdown() -> None:
    """Tear the process group down, where one runs."""
    if distributed():
        dist.destroy_process_group()
