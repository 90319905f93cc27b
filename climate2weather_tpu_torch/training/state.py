"""Training state and train steps (port of climate2weather_tpu/training/state.py).

A train step is: gradient accumulation over ``rounds`` microbatches (the
gradient of each microbatch's mean loss, summed, then divided by
``rounds``), the AdamW update at the step's learning rate, and the EMA
update. The JAX package compiles that into one ``jit`` region; here it runs
eagerly and updates the state in place.

Random draws: each step's (t, eps) come from one ``torch.Generator`` seeded
by ``derive_seed(seed, "global-train-stream", step)`` (:func:`step_generator`),
t then eps for each microbatch in turn, so a resumed run replays the draws
of an uninterrupted one, as the JAX loop does with ``fold_in``. For parity
tests a step also takes injected ``(t, eps)`` per microbatch.

Several ranks (``parallel.mesh``): each rank's microbatch is its rows of the
round's global microbatch, the ranks' microbatches in rank order, as JAX
assembles it (``make_array_from_process_local_data``). Every rank draws the
global microbatch's (t, eps) from the shared generator and keeps its rows,
and injected draws are the global ones too. After the last round the
gradients and the loss are summed over the ranks in one bucketed
all-reduce (:func:`~climate2weather_tpu_torch.parallel.mesh.all_reduce_grads`)
and divided by rounds x world: JAX's one mean over the global batch. The
all-reduce runs whenever a process group does, a world of one included.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Optional, Sequence

import numpy as np
import torch
import torch.utils.checkpoint
from torch import nn

from climate2weather_tpu_torch.parallel import mesh
from climate2weather_tpu_torch.training.ema import ema_init, ema_update
from climate2weather_tpu_torch.utils import trace
from climate2weather_tpu_torch.utils.seeding import derive_seed

Draws = Optional[Sequence[tuple]]  # per microbatch: (t [B,1,1,1], eps like x)


@dataclass
class TrainState:
    """What a checkpoint holds: the update count (``cur_ndata = step *
    batch_size``, the LR schedule's position), the network with its fp32
    parameters, the optimizer with its moments and its own bias-correction
    count (AdamW's per-parameter ``"step"``, which a state fabricated from a
    snapshot starts at 0 whatever ``step`` is), and one fp32 EMA per rate."""

    step: int
    net: nn.Module
    optimizer: torch.optim.Optimizer
    emas: Dict[str, Dict[str, torch.Tensor]]


def make_optimizer(params, optimizer_kwargs: dict) -> torch.optim.AdamW:
    """``torch.optim.AdamW`` with the semantics of the JAX package's
    ``optax.adamw``: betas, ``eps`` added to sqrt(v_hat), weight decay
    decoupled and scaled by the LR (``p (1 - lr wd)``). The LR is set on the
    param group by the train step before each update."""
    kwargs = dict(optimizer_kwargs)
    kwargs.pop("class_name", None)
    kwargs.pop("lr", None)
    betas = tuple(kwargs.pop("betas", (0.9, 0.999)))
    weight_decay = kwargs.pop("weight_decay", 1e-3)
    eps = kwargs.pop("eps", 1e-8)
    if kwargs:
        raise ValueError(f"unknown optimizer options {sorted(kwargs)}")
    return torch.optim.AdamW(params, lr=0.0, betas=betas, eps=eps, weight_decay=weight_decay)


def init_train_state(net: nn.Module, optimizer: torch.optim.Optimizer,
                     ema_rates: Sequence[float] = (0.9999,)) -> TrainState:
    return TrainState(step=0, net=net, optimizer=optimizer,
                      emas=ema_init(dict(net.named_parameters()), ema_rates))


def step_generator(seed: int, step: int, device) -> torch.Generator:
    """The generator of one step's (t, eps) draws."""
    gen = torch.Generator(device=torch.device(device))
    gen.manual_seed(derive_seed(seed, "global-train-stream", int(step)))
    return gen


def apply_update(state: TrainState, schedule: Callable, ema_rates, rounds: int = 1,
                 world: int = 1) -> None:
    """The update after the gradients of ``rounds`` microbatches on each of
    ``world`` ranks were summed into ``.grad``: their mean, AdamW at
    ``schedule(step)``, the EMAs, and ``step + 1``."""
    params = list(state.net.parameters())
    if rounds * world > 1:
        torch._foreach_div_([p.grad for p in params if p.grad is not None], float(rounds * world))
    for group in state.optimizer.param_groups:
        group["lr"] = schedule(state.step)  # optax's schedule sees the update count
    state.optimizer.step()
    with trace.span("c2w.train.ema"):
        ema_update(state.emas, dict(state.net.named_parameters()), ema_rates)
    state.step += 1


def _rank_rows(x: torch.Tensor, generator, t, eps, rank: int, world: int):
    """This rank's rows of the round's global (t, eps): the injected ones, or
    those drawn from ``generator`` for the global microbatch of
    ``world x len(x)`` rows, t then eps, as ``VPCosineProcess.loss`` draws."""
    b = x.shape[0]
    if t is None:
        t = torch.rand((b * world,) + (1,) * (x.dim() - 1), generator=generator, device=x.device)
        eps = torch.randn((b * world,) + tuple(x.shape[1:]), generator=generator, device=x.device,
                          dtype=x.dtype)
    if len(t) != b * world or len(eps) != b * world:
        raise ValueError(f"draws of {len(t)} rows for a global microbatch of {world} x {b}")
    return t[rank * b:(rank + 1) * b], eps[rank * b:(rank + 1) * b]


def _make_step(microbatch: Callable, process, schedule: Callable, ema_rates,
               loss_scaling: float, remat: bool) -> Callable:
    def net_apply(net, xt, t):
        if remat:
            return torch.utils.checkpoint.checkpoint(net, xt, t, use_reentrant=False)
        return net(xt, t)

    def train_step(state: TrainState, inputs, rounds: int,
                   generator: Optional[torch.Generator] = None, draws: Draws = None):
        if draws is not None and len(draws) != rounds:
            raise ValueError(f"{len(draws)} injected draws for {rounds} rounds")
        with trace.span("c2w.train.step", step=state.step):
            world = mesh.world_size()
            state.optimizer.zero_grad(set_to_none=True)
            loss_sum = None
            for r in range(rounds):
                with trace.span("c2w.train.gather", round=r):
                    x = microbatch(inputs, r)
                with trace.span("c2w.train.forward", round=r):
                    t, eps = draws[r] if draws is not None else (None, None)
                    if world > 1:
                        t, eps = _rank_rows(x, generator, t, eps, mesh.rank(), world)
                    loss = process.loss(lambda xt, tt, forcing: net_apply(state.net, xt, tt), x,
                                        generator=generator, t=t, eps=eps) * loss_scaling
                with trace.span("c2w.train.backward", round=r):
                    loss.backward()
                    loss_sum = loss.detach() if loss_sum is None else loss_sum + loss.detach()
            if mesh.distributed():
                params = [p for p in state.net.parameters() if p.requires_grad]
                loss_sum = mesh.all_reduce_grads(params, loss_sum) / world
            apply_update(state, schedule, ema_rates, rounds, world)
            return state, loss_sum / rounds

    return train_step


def make_train_step(process, schedule: Callable, ema_rates: Sequence[float] = (0.9999,),
                    loss_scaling: float = 1.0, channels_first: bool = False,
                    remat: bool = False) -> Callable:
    """``train_step(state, batch, generator=None, draws=None) -> (state,
    loss)`` for ``batch`` [rounds, B, H, W, C] (or [rounds, B, C, H, W] with
    ``channels_first``) on the state's device. ``loss`` is the mean of the
    microbatch losses, a device scalar."""

    def microbatch(batch, r):
        x = batch[r]
        return x.permute(0, 2, 3, 1) if channels_first else x

    step = _make_step(microbatch, process, schedule, ema_rates, loss_scaling, remat)

    def train_step(state, batch, generator=None, draws=None):
        return step(state, batch, batch.shape[0], generator, draws)

    return train_step


def gather_windows(data: torch.Tensor, idx: torch.Tensor, window: int) -> torch.Tensor:
    """Windows starting at frames ``idx`` [B] of ``data`` [T, C, H, W] as
    frame-major NHWC fp32 ``[B, H, W, window * C]``."""
    frames = idx[:, None] + torch.arange(window, device=idx.device)[None, :]
    xw = data[frames]  # [B, w, C, H, W]
    b, w, c, h, wd = xw.shape
    return xw.permute(0, 3, 4, 1, 2).reshape(b, h, wd, w * c).float()


def make_device_data_train_step(process, schedule: Callable, window: int,
                                ema_rates: Sequence[float] = (0.9999,),
                                loss_scaling: float = 1.0, remat: bool = False) -> Callable:
    """``train_step(state, data, idx, generator=None, draws=None)`` over a
    device-resident ``data`` [T, C, H, W] (fp32 or bf16): ``idx`` [rounds, B]
    holds window-start frames, gathered on the device, so only indices
    cross from the host per step. ``remat`` recomputes the network forward
    in the backward pass (``torch.utils.checkpoint``), trading compute for
    activation memory."""

    def microbatch(inputs, r):
        data, idx = inputs
        return gather_windows(data, idx[r], window)

    step = _make_step(microbatch, process, schedule, ema_rates, loss_scaling, remat)

    def train_step(state, data, idx, generator=None, draws=None):
        return step(state, (data, idx), idx.shape[0], generator, draws)

    return train_step


def upload_dataset(data_source, total_frames: int, dtype=torch.float32, device="cuda",
                   chunk_frames: int = 256) -> torch.Tensor:
    """Copy a [T, C, H, W] dataset to the device in chunks of frames.
    ``data_source[i:j]`` yields float32 numpy blocks (an h5 dataset or an
    array)."""
    shape = (total_frames,) + tuple(data_source.shape[1:])
    buf = torch.empty(shape, dtype=dtype, device=device)
    for t0 in range(0, total_frames, chunk_frames):
        t1 = min(t0 + chunk_frames, total_frames)
        chunk = torch.from_numpy(np.ascontiguousarray(data_source[t0:t1], dtype=np.float32))
        buf[t0:t1].copy_(chunk.to(device=device, dtype=dtype))
    return buf
