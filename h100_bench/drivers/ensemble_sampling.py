"""Guided ensemble sampling through the program's ``exp/downscaling``.

Set-up: the program's imports and kernels, ``load_net`` of the
configuration's snapshot, a synthetic normalized trajectory [L, H, W, C]
and training frames [n_train, C, H, W] from the seed (power-law spectra,
smooth in time), and one warm run of ``iter_samples`` at one step (every
shape of the window: the chunked forwards, guidance, calibration,
projection). Window: ``iter_samples`` over ``num_samples`` large enough
that ensemble groups run back to back; a group starts only while the
mean group time so far still fits in the window. The rate counts the
window evaluations of every completed group (members x evaluations x
chunks x windows a chunk, the shifted last chunk's repeats included) over
the time from the generator's first call to the host copy of the last
group.

Check: one member of one completed group, both drawn from the seed, is
sampled again by ``reference.sampling`` in float32 from the same inputs and
the snapshot's weights as the reference reads them; the number compared is
the member's relative RMS distance from the reference. Every completed
sample must be finite and unflagged.

Traced run: the forwards are timed with CUDA events in pre- and post-hooks
on the network, and the profiler records ``trace_evals`` whole evaluations
starting at evaluation ``trace_from`` of the first group.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from h100_bench import counts, harness
from h100_bench.reference import net as ref_net
from h100_bench.reference import sampling as ref_sampling
from h100_bench.reference import snapshot as ref_snapshot


def synthetic_inputs(L, H, W, C, n_train, seed, dev="cpu"):
    """A trajectory [L, H, W, C] with a power-law spectrum, smooth in time,
    and training frames [n_train, C, H, W] of that spectrum, unit variance
    per channel: made on ``dev`` from ``seed``, returned as numpy arrays."""
    gen = torch.Generator(device=dev).manual_seed(int(seed))
    ky = torch.fft.fftfreq(H, device=dev)[:, None]
    kx = torch.fft.fftfreq(W, device=dev)[None, :]
    amp = (torch.sqrt(ky**2 + kx**2) + 1.0 / H) ** (-1.5)

    def fields(n):
        shape = (n, C, H, W)
        spec = torch.complex(torch.randn(shape, generator=gen, device=dev, dtype=torch.float64),
                             torch.randn(shape, generator=gen, device=dev, dtype=torch.float64)) * amp
        f = torch.fft.ifft2(spec).real
        return f / f.std(dim=(0, 2, 3), keepdim=True)

    base = fields(L)
    gt = torch.cumsum(base, dim=0) / torch.arange(1, L + 1, device=dev, dtype=torch.float64).sqrt()[:, None, None, None]
    return (gt.permute(0, 2, 3, 1).float().cpu().numpy(), fields(n_train).float().cpu().numpy())


def sampler_config(traffic: dict, seed: int, num_samples: int) -> dict:
    """The downscaling config the program runs: the traffic's sampler
    settings, guided by the coarsened ground truth, calibrated."""
    cfg = dict(traffic["sampler"])
    cfg.update(seed=seed, num_samples=num_samples, observation_path="ground_truth",
               data_path="ground_truth", spectral_calibrate="training_frames")
    return cfg


def evals_per_group(cfg: dict, L: int, window: int) -> tuple:
    """``(network evaluations, forwards, window evaluations)`` of one
    ensemble group."""
    n_win, chunk = L - window + 1, int(cfg["batch_size"])
    per_call = min(n_win, chunk)
    n_chunks = -(-n_win // per_call)
    evals = int(cfg["num_sampling_steps"]) + int(bool(cfg.get("denoise_final", False)))
    members = int(cfg["ensemble_batch"])
    return evals, evals * n_chunks, members * evals * n_chunks * per_call


class ForwardTimer:
    """CUDA-event times of the network's forwards, and a profiler slice of
    whole evaluations (``forwards`` a slice, starting at forward ``first``)."""

    RANGE = "h100_bench.unet_forward"

    def __init__(self, net, device, first: int, forwards: int):
        self.cuda = device.type == "cuda"
        self.count = 0
        self.events = []
        self.first, self.last = first, first + forwards
        self.prof = None
        self.range = None
        self.slice = [None, None]
        self.overhead_s = 0.0  # host seconds the profiler's start and stop took
        self.handles = [net.register_forward_pre_hook(self.pre), net.register_forward_hook(self.post)]

    def sync(self):
        if self.cuda:
            torch.cuda.synchronize()

    def pre(self, module, inputs):
        if self.count == self.first:
            acts = [torch.profiler.ProfilerActivity.CPU]
            if self.cuda:
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            t = time.perf_counter()
            self.prof = torch.profiler.profile(activities=acts)
            self.sync()
            self.prof.start()
            self.slice[0] = time.perf_counter()
            self.overhead_s += self.slice[0] - t
        elif self.count == self.last:
            self.stop()
        if self.first <= self.count < self.last:
            self.range = torch.profiler.record_function(self.RANGE)
            self.range.__enter__()
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.events.append([ev, None])

    def post(self, module, inputs, output):
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.events[-1][1] = ev
        if self.range is not None:
            self.range.__exit__(None, None, None)
            self.range = None
        self.count += 1

    def stop(self):
        if self.prof is not None and self.slice[1] is None:
            self.sync()
            self.slice[1] = time.perf_counter()
            self.prof.stop()
            self.overhead_s += time.perf_counter() - self.slice[1]

    def close(self):
        self.stop()
        for h in self.handles:
            h.remove()

    def forward_ms(self) -> list:
        self.sync()
        return [a.elapsed_time(b) for a, b in self.events if b is not None]


def reference_member(config: dict, traffic: dict, dev, gt, train, program_seed: int, sid: int,
                     cast: str = "fp32") -> torch.Tensor:
    """Sample ``sid`` as ``reference.sampling`` computes it from the same
    inputs, with the snapshot's weights read by the reference's reader and
    the network's tensors held as ``cast`` says."""
    params = ref_snapshot.read_params(harness.ROOT / config["weights"]["snapshot"] / "params.msgpack", dev)
    net = ref_net.ReferenceUNet(config["model"], params, ref_net.CASTS[cast])
    s_step = int(traffic["sampler"]["s_step"])
    target = torch.from_numpy(ref_sampling.annulus_psd(train, s_step)).to(dev)
    with harness.reference_numerics():
        return ref_sampling.sample_member(net, int(config["window"]) // 2, traffic["sampler"],
                                          torch.from_numpy(gt).to(dev), target, program_seed, sid)


def rel_rms(got, want: torch.Tensor) -> float:
    """|got - want| / |want| over every element."""
    got = torch.as_tensor(got).to(want.device, torch.float32)
    return float((got - want).norm() / want.norm())


def compare(member, groups, ref: torch.Tensor, limits: dict) -> harness.Compared:
    """The check's numbers, each against its limit: the non-finite values
    and NaN flags of every ``(samples, flags)`` group, and ``member``'s
    relative RMS distance from the reference's ``ref``."""
    compared = harness.Compared()
    compared.add("nonfinite", sum(int((~np.isfinite(s)).sum()) + int(np.asarray(f).sum()) for s, f in groups), 0)
    compared.add("sample_rel_rms", rel_rms(member, ref), limits["sample_rel_rms"])
    return compared


def run(ctx: dict) -> harness.Outcome:
    from climate2weather_tpu_torch.exp.downscaling import iter_samples, load_net

    config, traffic, dev = ctx["config"], ctx["traffic"], ctx["device"]
    cuda = dev.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    model = config["model"]
    L, res, C = int(traffic["hours"]), int(config["resolution"]), int(config["variables"])
    window = int(config["window"])
    seed = ctx["seed"]
    stages = ctx["stages"]
    stages("imports")
    if cuda:
        torch.empty(1, device=dev)
        stages("device context")
    gt, train = synthetic_inputs(L, res, res, C, int(traffic["calibration_frames"]), harness.seed_for(seed, "inputs"),
                                 dev)
    snapshot = harness.ROOT / config["weights"]["snapshot"]
    stages("inputs")
    net, snap_cfg = load_net(str(snapshot), dev)
    stages("load_net")
    members = int(traffic["sampler"]["ensemble_batch"])
    program_seed = harness.seed_for(seed, "sampler")
    warm = sampler_config(traffic, program_seed, members)
    warm["num_sampling_steps"] = 1
    for _ in iter_samples(net, snap_cfg, warm, gt, train, dev):
        pass
    stages("warm group at one step")
    cfg = sampler_config(traffic, program_seed, members * int(traffic["max_groups"]))
    evals, forwards, window_evals = evals_per_group(cfg, L, window)
    timer = None
    if ctx["trace"]:
        per_eval = forwards // evals
        timer = ForwardTimer(net, dev, per_eval * int(traffic["trace_from"]), per_eval * int(traffic["trace_evals"]))
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    sync()
    setup_s = time.time() - ctx["t_start"]
    stages.log()
    groups = []
    gen = iter_samples(net, snap_cfg, cfg, gt, train, dev)
    t0 = time.perf_counter()
    for group in gen:  # each ends in the group's host copy
        groups.append(group)
        elapsed = time.perf_counter() - t0
        if elapsed * (len(groups) + 1) / len(groups) > ctx["seconds"]:
            break
    gen.close()
    window_s = elapsed
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    layer = {}
    if timer is not None:
        timer.close()
        fwd = timer.forward_ms()
        fwd = fwd[:timer.first] + fwd[timer.last:]  # the profiled forwards left out
        trace = harness.DeviceTrace(timer.prof, timer.slice[1] - timer.slice[0])
        b = members * min(L - window + 1, int(cfg["batch_size"]))
        bound = sum(counts.bound_s(*counts.attention_fwd_work(b, t, c))
                    for t, c in counts.attention_calls(model, res, res)) * (timer.last - timer.first)
        # the profiler's own start and stop are no work of the window
        layer = {"trace": trace, "forward_ms": fwd, "forward_range": timer.RANGE,
                 "slice_evals": int(traffic["trace_evals"]), "attn_fwd_bound_s": bound,
                 "work_flops": len(groups) * window_evals * counts.forward_flops(model, res, res),
                 "window_s": window_s - timer.overhead_s, "peak_bytes": peak}
    del gen, net
    if cuda:
        torch.cuda.empty_cache()

    # -- the check: one member of one completed group against the reference
    pick = np.random.default_rng(harness.seed_for(seed, "check"))
    gi, mi = int(pick.integers(len(groups))), int(pick.integers(members))
    sids, samples, _ = groups[gi]
    ref = reference_member(config, traffic, dev, gt, train, program_seed, sids[mi])
    compared = compare(samples[mi], [(s, f) for _, s, f in groups], ref, ctx["limits"])
    return harness.Outcome(
        e2e={"setup_s": setup_s, "window_evals_per_s": len(groups) * window_evals / window_s},
        attempted=len(groups) * members, failed=sum(int(np.asarray(f).sum()) for _, _, f in groups),
        peak_bytes=peak, compared=compared, layer=layer)
