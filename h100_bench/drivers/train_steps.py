"""Training steps through the program's device-data train step.

Set-up: the program's imports and kernels; the configuration's network
built on the card with the benchmark's own flax-style initialisation from
the seed (one truncated-normal draw for every weight, each scaled to
sqrt(1 / fan_in) / 0.8796, biases zero); AdamW and one EMA
(``training/state``); a training file of ``frames`` [T, C, H, W] float32
fields made on the card from the seed and kept there, as ``training_loop``
keeps it on its device-data path. Each step takes every window start once
in an order drawn from the seed (so the rows of a step all differ), split
into ``batch / microbatch`` rounds, and its (t, eps) draws from a generator
seeded for the step. The first ``check_steps`` steps are the warm-up and
the checked steps: the same state object then runs the window.

Window: steps back to back, with no synchronisation between them, while the
mean step time still fits; the rate is the samples of every step over the
time from a synchronised start to the synchronised end of the last. The
traced run synchronises after every step (the step times' percentile) and
then records ``trace_steps`` more steps with the profiler.

Check: ``reference.training`` runs the checked steps in float32 from the
same initial parameters, rows and draws. The numbers: the largest relative
gap of a step's loss; by the worst leaf, the gap between the program's and
the reference's norms of the first gradient (the program's read from
AdamW's first moment after one step) and of the change of the parameters
and of the EMA over the checked steps, each against the larger of the
reference's norm of that leaf and of the median leaf. Leaves whose
reference gradient is under a thousandth of the median leaf's are left out
of the changes. Those that the cell's limits name are compared; a number
with no limit there is not, as one that separates no fault from sound runs.
"""

from __future__ import annotations

import math
import time

import torch

from h100_bench import counts, harness
from h100_bench.reference import net as ref_net
from h100_bench.reference import training as ref_training

TRUNCATED_STD = 0.87962566103423978  # std of a standard normal cut at +-2


def init_params(model: dict, seed: int, dev) -> dict:
    """Every parameter of ``model``, flax-style, from one draw on ``dev``."""
    shapes = ref_net.param_shapes(model)
    weights = [k for k, s in shapes.items() if k.endswith(".weight")]
    total = sum(math.prod(shapes[k]) for k in weights)
    gen = torch.Generator(device=dev).manual_seed(harness.seed_for(seed, "init"))
    flat = torch.empty(total, device=dev)
    torch.nn.init.trunc_normal_(flat, 0.0, 1.0, -2.0, 2.0, generator=gen)
    out, at = {}, 0
    for k, shape in shapes.items():
        if k.endswith(".weight"):
            n = math.prod(shape)
            fan_in = n // shape[0]
            out[k] = flat[at:at + n].view(shape) * (math.sqrt(1.0 / fan_in) / TRUNCATED_STD)
            at += n
        else:
            out[k] = torch.zeros(shape, device=dev)
    return out


def make_data(frames: int, channels: int, res: int, seed: int, dev, chunk_bytes: int = 1 << 27) -> torch.Tensor:
    """[frames, channels, res, res] float32 fields with a power-law
    spectrum and unit variance per channel, made on ``dev`` in chunks of
    about ``chunk_bytes``."""
    gen = torch.Generator(device=dev).manual_seed(harness.seed_for(seed, "data"))
    k = torch.fft.fftfreq(res, device=dev)
    amp = (torch.sqrt(k[:, None] ** 2 + k[None, :] ** 2) + 1.0 / res) ** (-1.5)
    out = torch.empty((frames, channels, res, res), device=dev)
    step = max(1, chunk_bytes // (4 * channels * res * res))
    s1 = torch.zeros(channels, dtype=torch.float64, device=dev)
    s2 = torch.zeros(channels, dtype=torch.float64, device=dev)
    for a in range(0, frames, step):
        shape = (min(step, frames - a), channels, res, res)
        spec = torch.complex(torch.randn(shape, generator=gen, device=dev), torch.randn(shape, generator=gen, device=dev))
        f = torch.fft.ifft2(spec * amp).real.double()
        s1 += f.sum(dim=(0, 2, 3))
        s2 += (f * f).sum(dim=(0, 2, 3))
        out[a:a + shape[0]] = f
    n = frames * res * res
    std = ((s2 - s1 * s1 / n) / (n - 1)).sqrt().float()  # over frames and pixels, as torch.std
    return out.div_(std.view(1, -1, 1, 1))


def rows(seed: int, step: int, batch: int, windows: int, rounds: int, dev) -> torch.Tensor:
    """Window starts of step ``step``, [rounds, batch / rounds], all different."""
    if batch > windows:
        raise ValueError(f"a step of {batch} rows from {windows} windows would repeat rows")
    gen = torch.Generator().manual_seed(harness.seed_for(seed, "rows", step))
    return torch.randperm(windows, generator=gen)[:batch].reshape(rounds, -1).to(dev)


def draws(seed: int, step: int, dev) -> torch.Generator:
    return torch.Generator(device=dev).manual_seed(harness.seed_for(seed, "draws", step))


def leaf_norms(tensors) -> dict:
    return {k: float(v.detach().double().norm()) for k, v in tensors}


def gaps(prog: dict, ref: dict) -> dict:
    """The check's numbers (module docstring) of the program's readings
    ``prog`` against the reference's ``ref``."""
    med = sorted(ref["grad1"].values())[len(ref["grad1"]) // 2]
    keep = [k for k, g in ref["grad1"].items() if g >= 1e-3 * med]
    out = {"loss_gap": max(abs(a - b) / abs(b) for a, b in zip(prog["losses"], ref["losses"]))}
    for name in ("grad1", "change", "ema_change"):
        out[f"{name}_gap"] = harness.worst_leaf_gap(prog[name], ref[name],
                                                    ref["grad1"] if name == "grad1" else keep)[0]
    return out


def compare(prog: dict, ref: dict, limits: dict) -> harness.Compared:
    """The non-finite window losses, and each of :func:`gaps` that the
    cell's ``limits`` name, against its limit."""
    compared = harness.Compared()
    compared.add("nonfinite", sum(not math.isfinite(x) for x in prog["window_losses"]), 0)
    for name, value in gaps(prog, ref).items():
        if name in limits:
            compared.add(name, value, limits[name])
    return compared


class Program:
    """The program's training state and step over the benchmark's inputs."""

    def __init__(self, config: dict, traffic: dict, dev, seed: int, stages=lambda name: None):
        from climate2weather_tpu_torch.diffusion.process import construct_process
        from climate2weather_tpu_torch.models.score_net import build_score_unet
        from climate2weather_tpu_torch.training.state import (
            init_train_state,
            make_device_data_train_step,
            make_optimizer,
        )

        self.dev, self.seed, self.traffic = dev, seed, traffic
        self.model = config["model"]
        self.window = int(config["window"])
        res = int(config["resolution"])
        torch.empty(1, device=dev)
        stages("device context")
        self.data = make_data(int(traffic["frames"]), int(config["variables"]), res, seed, dev)
        self.windows = int(traffic["frames"]) - self.window + 1
        self.batch, self.rounds = int(traffic["batch"]), int(traffic["batch"]) // int(traffic["microbatch"])
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        stages("training file")
        with torch.device(dev):
            self.net = build_score_unet(self.model, dtype=getattr(torch, config["compute_dtype"]))
        self.p0 = init_params(self.model, seed, dev)
        self.net.load_state_dict(self.p0)
        stages("network")
        opt = traffic["optimizer"]
        self.opt = make_optimizer(self.net.parameters(), {"lr": opt["lr"], "weight_decay": opt["weight_decay"],
                                                          "betas": opt["betas"]})
        self.state = init_train_state(self.net, self.opt, (float(opt["ema"]),))
        lr = float(opt["lr"])
        self.train_step = make_device_data_train_step(construct_process("vp_cosine"), lambda step: lr, self.window,
                                                      (float(opt["ema"]),))
        self.steps = 0
        stages("optimizer, EMA and step")

    def step(self):
        s = self.steps
        _, loss = self.train_step(self.state, self.data, rows(self.seed, s, self.batch, self.windows, self.rounds,
                                                              self.dev), draws(self.seed, s, self.dev))
        self.steps += 1
        return loss

    def checked_steps(self, n: int) -> dict:
        """Run the first ``n`` steps and read what the check compares."""
        beta1 = float(self.traffic["optimizer"]["betas"][0])
        named = list(self.net.named_parameters())
        losses, times = [], []
        for i in range(n):
            t = time.perf_counter()
            losses.append(self.step())
            if self.dev.type == "cuda":
                torch.cuda.synchronize()
            times.append(time.perf_counter() - t)
            if i == 0:
                # a leaf the optimizer holds no moment of got no gradient
                grad1 = leaf_norms((k, self.opt.state[p].get("exp_avg", torch.zeros(())) / (1.0 - beta1))
                                   for k, p in named)
        ema = next(iter(self.state.emas.values()))
        out = {"losses": [float(x) for x in losses], "grad1": grad1, "step_s": times,
               "change": leaf_norms((k, p - self.p0[k]) for k, p in named),
               "ema_change": leaf_norms((k, ema[k] - self.p0[k]) for k, _ in named)}
        self.p0 = None
        return out


def reference_run(config: dict, traffic: dict, dev, seed: int, n: int, cast: str = "fp32", fault: str = "") -> dict:
    """``reference.training`` over the same inputs as :class:`Program`."""
    model, window = config["model"], int(config["window"])
    data = make_data(int(traffic["frames"]), int(config["variables"]), int(config["resolution"]), seed, dev)
    batch, rounds = int(traffic["batch"]), int(traffic["batch"]) // int(traffic["microbatch"])
    windows = int(traffic["frames"]) - window + 1
    with harness.reference_numerics():
        return ref_training.train(model, init_params(model, seed, dev), data,
                                  [rows(seed, s, batch, windows, rounds, dev) for s in range(n)],
                                  [draws(seed, s, dev) for s in range(n)], traffic["optimizer"], window=window,
                                  cast=ref_net.CASTS[cast], block=int(traffic["reference_block"]), fault=fault)


def run(ctx: dict) -> harness.Outcome:
    config, traffic, dev, seed = ctx["config"], ctx["traffic"], ctx["device"], ctx["seed"]
    cuda = dev.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    n_check = int(traffic["check_steps"])
    stages = ctx["stages"]
    import climate2weather_tpu_torch.training.state  # noqa: F401

    stages("imports")
    prog = Program(config, traffic, dev, seed, stages)
    checked = prog.checked_steps(n_check)
    stages(f"{n_check} checked steps " + " / ".join(f"{s:.2f}" for s in checked["step_s"]))
    est = checked["step_s"][-1]  # a warm step's time: the first builds and tunes
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    setup_s = time.time() - ctx["t_start"]
    stages.log()
    losses, times = [], []
    t0 = time.perf_counter()
    while True:
        ts = time.perf_counter()
        losses.append(prog.step())
        if ctx["trace"]:
            sync()
            times.append(time.perf_counter() - ts)
        if time.perf_counter() - t0 + est > ctx["seconds"]:
            break
    sync()
    window_s = time.perf_counter() - t0
    steps = len(losses)
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    layer = {}
    if ctx["trace"]:
        n_trace = int(traffic["trace_steps"])
        acts = [torch.profiler.ProfilerActivity.CPU] + ([torch.profiler.ProfilerActivity.CUDA] if cuda else [])
        with torch.profiler.profile(activities=acts) as prof:
            ts = time.perf_counter()
            for _ in range(n_trace):
                prog.step()
            sync()
            slice_s = time.perf_counter() - ts
        trace = harness.DeviceTrace(prof, slice_s)
        res, mb = int(config["resolution"]), int(traffic["microbatch"])
        calls = counts.attention_calls(prog.model, res, res)
        per_step = prog.rounds * n_trace
        layer = {"trace": trace, "slice_steps": n_trace, "step_s": times,
                 "attn_fwd_bound_s": per_step * sum(counts.bound_s(*counts.attention_fwd_work(mb, t, c))
                                                    for t, c in calls),
                 "attn_bwd_bound_s": per_step * sum(counts.bound_s(*counts.attention_bwd_work(mb, t, c))
                                                    for t, c in calls),
                 "work_flops": steps * prog.batch * counts.train_sample_flops(prog.model, res, res),
                 "window_s": window_s, "peak_bytes": peak}
    window_losses = [float(x) for x in torch.stack(losses).cpu()]
    del prog
    if cuda:
        torch.cuda.empty_cache()
    ref = reference_run(config, traffic, dev, seed, n_check)
    compared = compare({**checked, "window_losses": window_losses}, ref, ctx["limits"])
    return harness.Outcome(
        e2e={"setup_s": setup_s, "train_samples_per_s": steps * int(traffic["batch"]) / window_s},
        attempted=steps, failed=sum(not math.isfinite(x) for x in window_losses), peak_bytes=peak,
        compared=compared, layer=layer)
