"""Drive climate2weather_tpu_torch on one NVIDIA card and check it.

    python3 chip_smoke.py [--seed N]

Numbered phases, each printing one JSON line with its seconds:

0. the card (``nvidia-smi`` name and power limit) and the toolchain;
1. build of every CUDA kernel from ``climate2weather_tpu_torch/csrc``, one
   ``nvcc`` per source, all started together;
2. each kernel against its plain PyTorch version, with times of the kernel,
   the plain version and one PyTorch library call (``library_ms``) beside
   the least time the card could take (``bound_ms``): the attention forward
   and backward at the main paths' shapes (the forward also at the year
   path's [128, 64, 512], with an attention that drops a key as the fault
   its check must catch) and at T = 200, 256 and 1024
   (fp32 and bf16; both at C = 768; the forward timed at the training shape
   too, with its device time from a CUDA graph and its host time per call
   beside the back-to-back time; the backward also at T = 1 and 65, called
   twice for the same bits, with a planted fault, dS without its row-sum
   term, that the check must catch, gradients reaching q, k and v, and its
   timed rows with their graph and host times and SDPA's backward from a
   graph); the
   Winograd conv at the 72.1M UNet's level-0 and level-4 block shapes in
   bf16 with each ``pre``, ``vec`` and a residual, at a ragged bf16 shape
   (C = 40, O = 20) and one fp32 shape (each with a planted fault, the top
   halo row not zeroed, and gradients reaching x, the kernel, the bias, vec
   and the residual), timed at level 0's conv1 and conv0 and level 4's
   conv1 (``timing_winograd``), each with its device time from a CUDA graph
   of the launch alone and the wrapper's host time per call;
3. the 72.1M-parameter snapshot in ``artifacts/`` loaded through the port's
   own readers, one forward at [96, 128, 128, 52] with the kernel: each of its
   6 attention launches held against the plain version on the same inputs
   within one bf16 ulp (an attention that drops a key must fail that), and
   the forward against one with the plain attention, within what moving
   every attention output by one bf16 ulp does to it (beside, not gated:
   what one moved output, and either product summed in float64, do);
3b. one ModResidualBlock of the snapshot at level 0 and one at level 4 as
   two Winograd calls each (conv0 with the norm and the embedding's
   projection, conv1 with SiLU and the residual), against the port's cuDNN
   block in bf16, within what moving every conv output by one bf16 ulp does;
4. the main path: ``run_arrays`` at the settings of
   ``exp/configs/000_on-model-eval/s16_t6_spectral.yml`` (``num_samples``
   cut to 3, one ensemble group) on a synthetic 49-hour 128 x 128 trajectory,
   as its two steps ``load_net`` and ``sample_arrays`` timed apart, checked
   for finite samples, A(x) = y at the observed frames, and a kernel launch
   count of 6 per UNet forward;
5. training: ``training_loop`` on the 72.1M network of ``configs/sda_unet.yml``
   (flax-style init from the seed, bf16 compute, fp32 parameters) at
   128 x 128 from a [140, 4, 128, 128] training file written by the port's
   HDF5 writer and read through ``WindowDataset``, batch 64 in two
   microbatches of 32, to 1024 ndata with a checkpoint and a snapshot, then
   resumed to 2048: finite and falling losses, the checkpoint restored
   exactly, the first resumed step's draws and loss against an
   uninterrupted run's, 6 forward and 6 backward attention launches per
   microbatch, each backward launch of one step against the plain version,
   the fp16 snapshot loaded by ``load_net``, step time and peak memory;
6. ``predict`` from files with h5py made unimportable: the phase writes a
   49-hour 128 x 128 grid, its quantiles, a training file and a coarse
   observation grid with the port's writers, then runs
   ``exp/downscaling.run`` on copies of ``s16_t6_spectral.yml`` and
   ``s16_t6.yml`` (3 samples each) and on the external-observation and
   ``guidance_off`` modes (8 steps), reading every ``.nc`` back: finite,
   A(x) = y where the config projects, 6 attention launches per forward;
7. the canonical training drive, ``python -m climate2weather_tpu_torch.train``
   with ``configs/tiny_unet.yml`` at 32 x 32 (attention over 256 tokens,
   forward and backward) from a file the port wrote, 4 steps: finite losses
   and one step's attention launches against the plain versions;
8. the year path, h5py unimportable: (8a) ``exp/downscaling.run`` on
   ``exp/configs/001_clim-downscaling/year2014_meso128_winning.yml`` cut to
   523 hours (above the long path's 512) and one sample, from files the port
   wrote: the long path taken, a finite sample, A(x) = y, the resume file
   written every 2 calls of 8 steps and removed, 6 attention launches per
   UNet forward, with sampling, I/O and peak memory; (8b) the long
   DPM-Solver++(2M) at 523 frames for 16 steps, crashed in its second call
   and resumed from its file, against two uninterrupted runs; (8c)
   ``sample_arrays`` on 4003 frames for 2 steps and the final denoise: a
   bf16 trajectory, A(x) = y within bf16 rounding, peak memory and the
   peak reckoned for 8737 frames; (8d) ``metrics run`` on 8a's directory:
   finite scores.

Then one ``{"kernels": [...]}`` line and, last, the device line
``{"ok": true, "device": {...}}``. Any failure raises and exits non-zero.
There is no CPU mode: without a card the script exits non-zero at once.
``--winograd-only`` stops after phase 2's Winograd part, and
``--attention-bwd-only`` after phase 2's attention backward part (no device
line in either).
"""

from __future__ import annotations

import argparse
import json
import os
import pathlib
import subprocess
import sys
import time

import numpy as np
import torch

from climate2weather_tpu_torch.diffusion.process import VPCosineProcess

REPO = pathlib.Path(__file__).resolve().parent
SNAPSHOT = REPO / "artifacts" / "network-snapshot-0009437-0.999900"
CONFIG = REPO / "exp" / "configs" / "000_on-model-eval" / "s16_t6_spectral.yml"
MODEL_CONFIG = REPO / "configs" / "sda_unet.yml"

# H100 SXM peaks (NVIDIA data sheet, dense): bytes/s of HBM3, bf16 tensor FLOP/s
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12
MAIN_SHAPE = (96, 64, 512)  # windows per call x tokens x channels at level 4
TRAIN_SHAPE = (32, 64, 512)  # microbatch x tokens x channels at level 4
YEAR_SHAPE = (128, 64, 512)  # the year path's windows per call (batch_size 128) at level 4
# T = 200 ragged, 128 (the old kernels' limit), 256 (tiny_unet at 32 x 32;
# sda_unet_large's level 4 at 256 x 256), 1024 (a 32 x 32 attention level),
# and a small ragged shape
LONG_SHAPES = ((4, 200, 64), (2, 128, 64), (8, 256, 32), (4, 256, 512), (2, 1024, 64), (3, 16, 40))
LONG_TIMED = (32, 256, 512)  # timed beside the main shapes: a training microbatch at T = 256
# sda_unet_large's level 5 (768 channels) at 256 x 256 (8 x 8 tokens) and
# 512 x 512 (16 x 16: three channel slices of the forward's tensor-core
# kernel, six of the backward's)
WIDE_SHAPES = ((4, 64, 768), (4, 256, 768))
# the backward's route edges beside T = 64 (TRAIN_SHAPE) and 16: the first T
# of the three-kernel route, and one token
BWD_EDGE_SHAPES = ((4, 65, 128), (6, 1, 64))
WINO_SHAPES = ((32, 128, 128, 128), (32, 8, 8, 512))  # the 72.1M blocks at levels 0 and 4
# C not a multiple of 16, O not a multiple of 8, ragged tile rows and columns
WINO_RAGGED = ((3, 10, 14, 40), 20)
# the timed Winograd calls: name, [N, H, W, C], O, pre, vec, residual. The
# first is the kernels line's row (level 0's conv1 as earlier versions
# timed it, vec included); then level 0's conv0 and level 4's conv1 as the
# ModResidualBlock calls them
WINO_TIMED = (("level0_conv1", WINO_SHAPES[0], 128, "silu", True, True),
              ("level0_conv0", WINO_SHAPES[0], 128, "norm", True, False),
              ("level4_conv1", WINO_SHAPES[1], 512, "silu", False, True))


def emit(phase, t0, **fields):
    print(json.dumps({"phase": phase, "seconds": round(time.time() - t0, 3), **fields}), flush=True)


def timing_row(name, source, replaces, err, ms, plain_ms, library_ms, nbytes, flops, shape) -> dict:
    """One row of the kernels line; ``bound_ms`` is the larger of the bytes
    over the HBM rate and the operations over the bf16 tensor-core peak."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS
    return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": None, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": 1e3 * max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": library_ms, "shape": list(shape)}


def cuda_time_ms(fn, reps=50, warmup=5) -> float:
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def graph_time_ms(fn, reps=50, warmup=3) -> float:
    """Device time of one call: ``reps`` calls captured in one CUDA graph and
    replayed once between CUDA events. Where a call's host work (the Python
    wrapper, ctypes) outlasts its kernels, back-to-back calls time the host;
    the replay times the device alone. The capture is relaxed, so that a
    launcher that sets a kernel attribute on every call can be captured."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm up off the capture, as torch asks
        for _ in range(warmup):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        for _ in range(reps):
            fn()
    return _replay_ms(graph, reps)


def _replay_ms(graph, reps) -> float:
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def sdpa_bwd_graph_ms(inputs, do, reps=50, warmup=3) -> float:
    """Device time of SDPA's backward alone: fresh leaves and the forward on
    a side stream (autograd runs a backward on its forward's streams), then
    ``reps`` calls of ``torch.autograd.grad`` captured in one CUDA graph on
    that stream."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        leaves = [x.detach().clone().requires_grad_(True) for x in inputs]
        out = torch.nn.functional.scaled_dot_product_attention(*leaves, scale=1.0)
        for _ in range(warmup):
            torch.autograd.grad(out, leaves, do, retain_graph=True)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        for _ in range(reps):
            torch.autograd.grad(out, leaves, do, retain_graph=True)
    return _replay_ms(graph, reps)


def host_time_ms(fn, reps=50, warmup=5) -> float:
    """Host time of one call: ``reps`` calls timed on the host's clock before
    the card is waited for (while the queue is not full, the host's work)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return 1e3 * (t1 - t0) / reps


def bf16_ulp(x: float) -> float:
    return float(2.0 ** (np.floor(np.log2(x)) - 7))


def phase0_card() -> dict:
    t0 = time.time()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    from climate2weather_tpu_torch.ops.build import find_nvcc

    nvcc = subprocess.run([find_nvcc(), "--version"], capture_output=True, text=True,
                          check=True, timeout=60).stdout.strip().splitlines()[-1]
    info = {"nvidia_smi": smi, "torch": torch.__version__, "cuda": torch.version.cuda,
            "nvcc": nvcc, "python": sys.version.split()[0]}
    emit(0, t0, **info)
    return info


def phase1_build() -> None:
    t0 = time.time()
    from climate2weather_tpu_torch.ops import attention, build, winograd

    build.build_all(build.SOURCES)  # one nvcc per source, all started together
    attention.build_kernel()
    winograd.build_kernel()
    ptxas = {src: [ln.strip() for ln in log.splitlines()
                   if "registers" in ln or "smem" in ln or "spill" in ln]
             for src, log in build.build_logs.items()}
    emit(1, t0, built=sorted({**attention.launch_counts, **winograd.launch_counts}), ptxas=ptxas)


def _rowsum_dropped(q, k, v, do):
    """A faulty backward: dS = P o dP, without the row-sum term."""
    q32, k32, v32, do32 = q.float(), k.float(), v.float(), do.float()
    s = q.shape[-1] ** (-0.25)
    p = torch.softmax((q32 * s) @ (k32 * s).transpose(-1, -2), dim=-1)
    ds = p * (do32 @ v32.transpose(-1, -2))
    return ((ds @ k32) * s * s).to(q.dtype), ((ds.transpose(-1, -2) @ q32) * s * s).to(q.dtype), \
        (p.transpose(-1, -2) @ do32).to(q.dtype)


def _grads_err(got, want):
    """Largest error over (dq, dk, dv) and each output's scale."""
    errs = [float((g.float() - w.float()).abs().max()) for g, w in zip(got, want)]
    scales = [float(w.float().abs().max()) for w in want]
    return errs, scales


def _bwd_tols(scales, dtype):
    # fp32: sums in another order, ~1e-5 of each output's scale; bf16: both
    # sides round one fp32 value, so they differ by at most one ulp
    return [1e-5 * sc if dtype == torch.float32 else bf16_ulp(sc) for sc in scales]


def phase2_backward(device: torch.device, g: torch.Generator) -> tuple:
    """The backward kernel against ``attention_bwd_reference`` at the
    training shape, the route's edges (T = 1, 16, 64, 65), ragged shapes,
    768 channels and the longest T, fp32 and bf16, with a planted fault that
    must fail and a second call that must give the same bits; gradients
    through ``fused_attention``. The training shape and ``LONG_TIMED`` are
    timed back to back (``ms``), from a CUDA graph (``graph_ms``, and SDPA's
    backward so as ``library_graph_ms``) and on the host (``host_ms``).
    Returns (checks, the kernels line's row, the ``LONG_TIMED`` row)."""
    from climate2weather_tpu_torch.ops import attention

    checks, row = [], None
    timed = {}
    for shape in (TRAIN_SHAPE, *LONG_SHAPES, *BWD_EDGE_SHAPES, *WIDE_SHAPES, LONG_TIMED):
        for dtype in ((torch.bfloat16,) if shape == LONG_TIMED else (torch.float32, torch.bfloat16)):
            b, t, c = shape
            qkv = torch.randn((b, t, 3 * c), generator=g, device=device).to(dtype)
            q, k, v = qkv.chunk(3, dim=-1)
            do = torch.randn((b, t, c), generator=g, device=device).to(dtype)
            got = attention.attention_bwd(q, k, v, do)
            again = attention.attention_bwd(q, k, v, do)
            want = attention.attention_bwd_reference(q, k, v, do)
            torch.cuda.synchronize()
            errs, scales = _grads_err(got, want)
            tols = _bwd_tols(scales, dtype)
            fault, _ = _grads_err(_rowsum_dropped(q, k, v, do), want)
            same = all(torch.equal(a, b_) for a, b_ in zip(got, again))
            rec = {"shape": list(shape), "dtype": str(dtype), "max_abs_err": errs, "tol": tols,
                   "rowsum_dropped_err": fault, "same_bits_twice": same}
            checks.append(rec)
            if any(e > tl for e, tl in zip(errs, tols)):
                raise AssertionError(f"attention backward kernel disagrees: {rec}")
            if not same:
                raise AssertionError(f"attention backward gives other bits on a second call: {rec}")
            if fault[0] <= tols[0] or fault[1] <= tols[1]:
                raise AssertionError(f"the backward check cannot see a dropped row sum: {rec}")
            if shape in (TRAIN_SHAPE, LONG_TIMED) and dtype == torch.bfloat16:
                s = c ** (-0.25)
                lib_in = [x.detach().clone().requires_grad_(True)
                          for x in ((q * s).contiguous(), (k * s).contiguous(), v.contiguous())]
                lib_out = torch.nn.functional.scaled_dot_product_attention(*lib_in, scale=1.0)
                ms = cuda_time_ms(lambda: attention.attention_bwd(q, k, v, do))
                plain_ms = cuda_time_ms(lambda: attention.attention_bwd_reference(q, k, v, do))
                library_ms = cuda_time_ms(lambda: torch.autograd.grad(
                    lib_out, lib_in, do, retain_graph=True))
                # q, k, v, dO read once, dQ, dK, dV written once; the fp32
                # scratch is the kernel's own traffic, not the function's
                nbytes = 7 * b * t * c * q.element_size()
                flops = 10 * b * t * t * c  # QK^T, dO V^T, P^T dO, dS K, dS^T Q
                timed[shape] = timing_row(
                    "attention_bwd", "climate2weather_tpu_torch/csrc/attention_bwd.cu",
                    "climate2weather_tpu/ops/attention.py:89", max(errs), ms, plain_ms, library_ms,
                    nbytes, flops, shape)
                # beside the back-to-back times, the device time alone (the
                # wrapper and its launches from a CUDA graph; SDPA's backward
                # alone) and the wrapper's host time per call
                timed[shape].update(graph_ms=graph_time_ms(lambda: attention.attention_bwd(q, k, v, do)),
                                    library_graph_ms=sdpa_bwd_graph_ms(lib_in, do),
                                    host_ms=host_time_ms(lambda: attention.attention_bwd(q, k, v, do)))
    row = timed[TRAIN_SHAPE]
    # the repair: gradients reach q, k and v through fused_attention
    qkv = torch.randn((4, 64, 3 * 64), generator=g, device=device, requires_grad=True)
    do = torch.randn((4, 64, 64), generator=g, device=device)
    before = attention.launch_counts["attention_bwd"]
    attention.fused_attention(*qkv.chunk(3, dim=-1)).backward(do)
    torch.cuda.synchronize()
    want = torch.cat(attention.attention_bwd_reference(*qkv.detach().chunk(3, dim=-1), do), dim=-1)
    grad_err = float((qkv.grad - want).abs().max()) if qkv.grad is not None else None
    grad_check = {"launched": attention.launch_counts["attention_bwd"] - before,
                  "qkv_grad_err": grad_err, "tol": 1e-5 * float(want.abs().max())}
    if grad_err is None or grad_check["launched"] != 1 or grad_err > grad_check["tol"]:
        raise AssertionError(f"gradients do not reach q, k, v through the kernel: {grad_check}")
    checks.append({"fused_attention_grad": grad_check})
    return checks, row, timed[LONG_TIMED]


def phase2_kernels(device: torch.device, seed: int) -> tuple:
    """Each kernel against its plain version; returns the timing rows by
    kernel name, and the forward's row at the year path's shape."""
    from climate2weather_tpu_torch.ops.attention import attention_reference, fused_attention

    t0 = time.time()
    g = torch.Generator(device=device).manual_seed(seed)
    checks, timed = [], {}
    for shape in (MAIN_SHAPE, *LONG_SHAPES, *WIDE_SHAPES, TRAIN_SHAPE, LONG_TIMED, YEAR_SHAPE):
        for dtype in ((torch.bfloat16,) if shape in (TRAIN_SHAPE, LONG_TIMED, YEAR_SHAPE)
                      else (torch.float32, torch.bfloat16)):
            b, t, c = shape
            qkv = torch.randn((b, t, 3 * c), generator=g, device=device).to(dtype)
            q, k, v = qkv.chunk(3, dim=-1)  # strided thirds, as the UNet passes them
            got = fused_attention(q, k, v)
            want = attention_reference(q, k, v)
            torch.cuda.synchronize()
            err = float((got.float() - want.float()).abs().max())
            scale = float(want.float().abs().max())
            # fp32: sums in another order, ~1e-5 relative; bf16: both sides
            # round one fp32 value, so they differ by at most one ulp
            tol = 1e-5 * max(scale, 1.0) if dtype == torch.float32 else bf16_ulp(scale)
            ok = bool(err <= tol)
            checks.append({"shape": list(shape), "dtype": str(dtype), "max_abs_err": err,
                           "tol": tol, "ok": ok})
            if not ok:
                raise AssertionError(f"attention kernel disagrees: {checks[-1]}")
            if shape == YEAR_SHAPE:  # the limit must see an attention that drops a key
                fault = float((_key_dropped(q, k, v).float() - want.float()).abs().max())
                checks[-1]["key_dropped_err"] = fault
                if fault <= tol:
                    raise AssertionError(f"the forward check cannot see a dropped key: {checks[-1]}")
            if shape in (MAIN_SHAPE, TRAIN_SHAPE, LONG_TIMED, YEAR_SHAPE) and dtype == torch.bfloat16:
                s = c ** (-0.25)
                qs, ks = (q * s).contiguous(), (k * s).contiguous()
                vc = v.contiguous()
                sdpa = lambda: torch.nn.functional.scaled_dot_product_attention(qs, ks, vc, scale=1.0)
                ms = cuda_time_ms(lambda: fused_attention(q, k, v))
                plain_ms = cuda_time_ms(lambda: attention_reference(q, k, v))
                library_ms = cuda_time_ms(sdpa)
                nbytes = 4 * b * t * c * q.element_size()  # q, k, v read, o written
                flops = 4 * b * t * t * c  # QK^T and PV
                timed[shape] = timing_row(
                    "attention_fwd", "climate2weather_tpu_torch/csrc/attention_fwd.cu",
                    "climate2weather_tpu/ops/attention.py:71", err, ms, plain_ms, library_ms,
                    nbytes, flops, shape)
                # beside the back-to-back times (the method of every row), the
                # device time alone and the wrapper's host time per call
                timed[shape].update(graph_ms=graph_time_ms(lambda: fused_attention(q, k, v)),
                                    library_graph_ms=graph_time_ms(sdpa),
                                    host_ms=host_time_ms(lambda: fused_attention(q, k, v)))
    bwd_checks, bwd_row, bwd_long = phase2_backward(device, g)
    wino_checks, wino_rows = phase2_winograd(device, g)
    rows = {"attention_fwd": timed[MAIN_SHAPE], "attention_bwd": bwd_row, "winograd_conv3x3": wino_rows[0]}
    emit(2, t0, checks=checks + bwd_checks + wino_checks, timing=list(rows.values()),
         timing_train_fwd=timed[TRAIN_SHAPE], timing_year_fwd=timed[YEAR_SHAPE],
         timing_t256=[timed[LONG_TIMED], bwd_long], timing_winograd=wino_rows[1:])
    return rows, timed[YEAR_SHAPE]


def _halo_unmasked(x, kernel, bias, vec, residual, pre, ddof=0):
    """A faulty Winograd conv: the top halo row at the image edge holds
    pre(x + vec) of row 0 (the row the Pallas kernel's clamped index map
    fetches) instead of the conv's zero padding."""
    from climate2weather_tpu_torch.ops import winograd

    h = winograd._kernel_pre(x, vec, pre, ddof)
    hp = torch.nn.functional.pad(h, (0, 0, 1, 1, 1, 1))
    hp[:, 0, 1:-1] = h[:, 0]
    u = winograd.transform_weights(kernel).to(x.dtype)
    return winograd.winograd_from_padded(hp, u, bias, residual)


def _winograd_launch(winograd, x, kernel, bias, vec, residual, pre, ddof=0):
    """The kernel's launch alone through its C entry point, U transformed
    beforehand: a CUDA graph of it replays the kernel's device time. The
    entry point and the wrapper's codes are those of every version of
    ``ops/winograd.py`` since the kernel came in, so this times an older
    checkout too."""
    n, h, w, c = x.shape
    o = kernel.shape[3]
    u = winograd.transform_weights(kernel).to(x.dtype).contiguous()
    b32 = bias.float().contiguous()
    out = torch.empty((n, h, w, o), dtype=x.dtype, device=x.device)
    lib = winograd._library()
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731

    def launch():
        err = lib.c2w_winograd_conv3x3(
            x.data_ptr(), u.data_ptr(), b32.data_ptr(), ptr(vec), ptr(residual), out.data_ptr(),
            n, h, w, c, o, winograd._PRE_CODES[pre], ddof, winograd._DTYPE_CODES[x.dtype],
            torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"winograd_conv3x3 launch failed: cudaError {err}")
    return launch


def _winograd_inputs(g, device, shape, o, dtype, vec=True, residual=True):
    n, h, w, c = shape
    x = torch.randn((n, h, w, c), generator=g, device=device).to(dtype)
    kernel = torch.randn((3, 3, c, o), generator=g, device=device) / (3 * c ** 0.5)
    bias = 0.1 * torch.randn((o,), generator=g, device=device)
    v = torch.randn((n, c), generator=g, device=device).to(dtype) if vec else None
    res = torch.randn((n, h, w, o), generator=g, device=device).to(dtype) if residual else None
    return x, kernel, bias, v, res


def _winograd_check(winograd, args, rec):
    """The kernel against ``winograd_reference`` and the planted fault (the
    top halo row not zeroed), into ``rec``; raises on a disagreement or a
    fault the limit cannot see."""
    x = args[0]
    got = winograd.winograd_fwd(*args)
    want = winograd.winograd_reference(*args).float()
    torch.cuda.synchronize()
    err, scale = float((got.float() - want).abs().max()), float(want.abs().max())
    # fp32: sums in another order, ~1e-5 of the scale; bf16: both sides
    # round one fp32 value, so they differ by at most one ulp
    tol = 1e-5 * scale if x.dtype == torch.float32 else bf16_ulp(scale)
    fault = float((_halo_unmasked(*args).float() - want).abs().max())
    rec.update(max_abs_err=err, tol=tol, halo_unmasked_err=fault)
    if err > tol:
        raise AssertionError(f"Winograd kernel disagrees: {rec}")
    if fault <= tol:
        raise AssertionError(f"the Winograd check cannot see an unmasked halo row: {rec}")
    return err


def phase2_winograd(device: torch.device, g: torch.Generator) -> tuple:
    """The Winograd kernel against ``winograd_reference`` at the 72.1M
    block shapes in bf16 with each ``pre``, ``vec`` and a residual, at a
    ragged bf16 shape and at one fp32 shape, each with a planted fault (the
    top halo row not zeroed) that must fail; the gradient through
    ``WinogradConv3x3``; then the three calls of ``WINO_TIMED``, each checked
    the same way and timed: back to back through the wrapper (``ms``, U's
    transform included, as earlier versions timed it), the kernel's launch alone from a
    CUDA graph (``graph_ms``), the wrapper's host time per call
    (``host_ms``), the plain version and cuDNN's conv with the plain
    epilogue. Returns (checks, timing rows in ``WINO_TIMED``'s order)."""
    from climate2weather_tpu_torch.ops import winograd

    checks = []
    cases = [(shape, shape[3], torch.bfloat16, pre) for shape in WINO_SHAPES for pre in (None, "norm", "silu")]
    cases.append((WINO_RAGGED[0], WINO_RAGGED[1], torch.bfloat16, "norm"))
    cases.append(((4, 32, 32, 64), 64, torch.float32, "norm"))
    for shape, o, dtype, pre in cases:
        x, kernel, bias, vec, res = _winograd_inputs(g, device, shape, o, dtype)
        rec = {"shape": list(shape), "o": o, "dtype": str(dtype), "pre": pre}
        checks.append(rec)
        _winograd_check(winograd, (x, kernel, bias, vec, res, pre), rec)
    # the gradient reaches x, the kernel, the bias, vec and the residual
    n, h, w, c = 2, 16, 16, 32
    leaves = [torch.randn(s, generator=g, device=device).requires_grad_(True)
              for s in ((n, h, w, c), (3, 3, c, c), (c,), (n, c), (n, h, w, c))]
    gout = torch.randn((n, h, w, c), generator=g, device=device)
    before = winograd.launch_counts["winograd_conv3x3"]
    winograd.winograd_conv3x3(*leaves, "norm", 0).backward(gout)
    launched = winograd.launch_counts["winograd_conv3x3"] - before
    ref = [t.detach().clone().requires_grad_(True) for t in leaves]
    winograd.conv3x3_reference(*ref, "norm", 0).backward(gout)
    grad_errs = [None if a.grad is None else float((a.grad - b.grad).abs().max()) for a, b in zip(leaves, ref)]
    grad_tols = [1e-5 * float(b.grad.abs().max()) for b in ref]
    grad_check = {"launched": launched, "grad_errs": grad_errs, "tols": grad_tols}
    checks.append({"winograd_grad": grad_check})
    if launched != 1 or any(e is None or e > tl for e, tl in zip(grad_errs, grad_tols)):
        raise AssertionError(f"gradients do not reach every input through the Winograd conv: {grad_check}")

    rows = []
    for name, shape, o, pre, has_vec, has_res in WINO_TIMED:
        x, kernel, bias, vec, res = _winograd_inputs(g, device, shape, o, torch.bfloat16, has_vec, has_res)
        args = (x, kernel, bias, vec, res, pre)
        rec = {"shape": list(shape), "o": o, "dtype": str(x.dtype), "pre": pre, "timed": name}
        checks.append(rec)
        err = _winograd_check(winograd, args, rec)
        ms = cuda_time_ms(lambda: winograd.winograd_fwd(*args))
        plain_ms = cuda_time_ms(lambda: winograd.winograd_reference(*args))
        # the yardstick: cuDNN's conv on the channels-last bf16 tensor, plus
        # the plain SiLU or norm, bias and residual (never called by the port)
        library_ms = cuda_time_ms(lambda: winograd.conv3x3_reference(*args))
        n, h, w, c = shape
        el = x.element_size()
        # x read, the output written, the residual read, U, vec and the bias
        nbytes = (n * h * w * c + n * h * w * o * (2 if has_res else 1) + 16 * c * o
                  + (n * c if has_vec else 0)) * el + 4 * o
        flops = 2 * 16 * n * (h // 2) * (w // 2) * c * o  # the 16 plane products
        row = timing_row("winograd_conv3x3", "climate2weather_tpu_torch/csrc/winograd_conv3x3.cu",
                         "climate2weather_tpu/ops/winograd.py:230", err, ms, plain_ms, library_ms,
                         nbytes, flops, shape)
        row.update(call=name, o=o, pre=pre, vec=has_vec, residual=has_res,
                   graph_ms=graph_time_ms(_winograd_launch(winograd, *args)),
                   host_ms=host_time_ms(lambda: winograd.winograd_fwd(*args)))
        rows.append(row)
    return checks, rows


def phase3b_winograd_blocks(snapshot_dir, device, batch=32, seed=0) -> dict:
    """One ModResidualBlock of the snapshot at level 0 and one at its last
    level as two Winograd calls each (conv0 with pre="norm" and vec =
    project(emb); conv1 with pre="silu" and the block input as residual),
    against the port's cuDNN block on the same input in bf16. The limit is
    what moving every conv output of the cuDNN block by one bf16 ulp does
    to its output; a first conv whose top halo row is not zeroed must
    exceed it. Returns the phase's record with the kernel's launches."""
    from climate2weather_tpu_torch.convert import conv_weight_hwio
    from climate2weather_tpu_torch.exp.downscaling import load_net
    from climate2weather_tpu_torch.ops import winograd

    t0 = time.time()
    net, cfg = load_net(str(snapshot_dir), device)
    nk = cfg["network_kwargs"]
    nlev = len(nk["hidden_channels"])
    g = torch.Generator(device=device).manual_seed(seed)
    res = 128
    cases = []
    for level in (0, nlev - 1):
        block = getattr(net.unet, f"down{level}_block0")
        c, side = int(nk["hidden_channels"][level]), res // 2 ** level
        xn = torch.randn((batch, side, side, c), generator=g, device=device).to(torch.bfloat16)
        emb = torch.randn((batch, block.project.in_features), generator=g, device=device)
        cases.append((level, block, xn, emb.to(torch.bfloat16)))

    def fused(block, xn, emb, first=winograd.winograd_conv3x3):
        proj = block.project(emb)
        k0, k1 = conv_weight_hwio(block.conv0.weight), conv_weight_hwio(block.conv1.weight)
        h = first(xn, k0, block.conv0.bias, proj, None, "norm", block.norm_ddof)
        return winograd.winograd_conv3x3(h, k1, block.conv1.bias, None, xn, "silu", 0).float()

    def moved(module, inputs, out):  # every conv output one bf16 ulp up or down
        step = torch.randint(0, 2, out.shape, generator=g, device=out.device, dtype=torch.int16) * 2 - 1
        return (out.view(torch.int16) + step * (out != 0)).view(out.dtype)

    with torch.no_grad():
        # the path: the two fused calls of each block, counted alone
        if device.type == "cuda":
            torch.cuda.synchronize()
        winograd.launch_counts["winograd_conv3x3"] = 0
        outs = [fused(block, xn, emb) for _, block, xn, emb in cases]
        if device.type == "cuda":
            torch.cuda.synchronize()
        launches = winograd.launch_counts["winograd_conv3x3"]
        records = []
        for (level, block, xn, emb), got in zip(cases, outs):
            x = xn.permute(0, 3, 1, 2)  # the port's NCHW view of channels-last memory
            want = block(x, emb).permute(0, 2, 3, 1).float()
            hooks = [m.register_forward_hook(moved) for m in (block.conv0, block.conv1)]
            try:
                ulp_off = block(x, emb).permute(0, 2, 3, 1).float()
            finally:
                for hk in hooks:
                    hk.remove()
            fault = fused(block, xn, emb, first=_halo_unmasked)
            d, u, f = (got - want).abs(), (ulp_off - want).abs(), (fault - want).abs()
            records.append({"level": level, "shape": list(xn.shape),
                            "max_abs_err": float(d.max()), "mean_abs_err": float(d.mean()),
                            "tol": float(u.max()), "one_ulp_mean": float(u.mean()),
                            "halo_unmasked_max": float(f.max()), "out_scale": float(want.abs().max()),
                            "finite": bool(torch.isfinite(got).all())})
    emit("3b", t0, blocks=records, launches=launches)
    for rec in records:
        if not rec["finite"]:
            raise AssertionError(f"non-finite Winograd block output: {rec}")
        if rec["max_abs_err"] > rec["tol"]:
            raise AssertionError(f"the Winograd block disagrees with the cuDNN block: {rec}")
        if rec["halo_unmasked_max"] <= rec["tol"]:
            raise AssertionError(f"the block check cannot see an unmasked halo row: {rec}")
    expect = 2 * len(records) if device.type == "cuda" else 0
    if launches != expect:
        raise AssertionError(f"Winograd kernel launched {launches} times, want {expect}")
    return {"launches": launches, "blocks": records}


def _one_ulp_off(q, k, v, g):
    """The plain attention with every nonzero output moved one bf16 ulp up or
    down at random: the most the kernel may differ by in one call."""
    from climate2weather_tpu_torch.ops.attention import attention_reference

    out = attention_reference(q, k, v)
    step = torch.randint(0, 2, out.shape, generator=g, device=out.device, dtype=torch.int16) * 2 - 1
    return (out.view(torch.int16) + step * (out != 0)).view(out.dtype)


def _key_dropped(q, k, v):
    """A faulty attention that ignores the last key."""
    from climate2weather_tpu_torch.ops.attention import attention_reference

    return attention_reference(q, k[:, :-1], v[:, :-1])


def _one_output_moved(q, k, v, g):
    """The plain attention with one output, drawn at random, moved one bf16
    ulp: the least a kernel that is not the plain version can differ by."""
    from climate2weather_tpu_torch.ops.attention import attention_reference

    out = attention_reference(q, k, v).contiguous()
    flat = out.view(-1)
    i = int(torch.randint(0, flat.numel(), (1,), generator=g, device=out.device))
    flat.view(torch.int16)[i] += 1
    return out


def _logits_exact(q, k, v):
    """The plain attention with QK^T summed in float64 and rounded once to
    fp32: the logits that any summation order but the plain version's own
    comes near (tensor cores sum exact bf16 products in fp32 partial sums)."""
    s = q.shape[-1] ** (-0.25)
    logits = torch.matmul(q.double() * s, (k.double() * s).transpose(-1, -2)).float()
    e = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    return torch.matmul(e / e.sum(dim=-1, keepdim=True), v.float()).to(q.dtype)


def _pv_exact(q, k, v):
    """The plain attention with P V summed in float64 and rounded once to
    q's dtype."""
    from climate2weather_tpu_torch.ops.attention import _softmax_probs

    p = _softmax_probs(q.float(), k.float())
    return torch.matmul(p.double(), v.double()).to(q.dtype)


def phase3_network(snapshot_dir, device, batch=96, res=128, seed=0, compare_plain=True) -> dict:
    """Load the snapshot through the port's readers and run one forward;
    with ``compare_plain``, hold every attention launch of that forward
    against the plain version on its own inputs, and the forward against
    forwards with the plain attention, exact and moved by one ulp; a faulty
    attention's readings are reported beside both."""
    from climate2weather_tpu_torch.exp.downscaling import load_net
    from climate2weather_tpu_torch.models import unet
    from climate2weather_tpu_torch.models.unet import AttentionBlock
    from climate2weather_tpu_torch.ops.attention import (
        attention_reference,
        fused_attention,
        launch_counts,
    )

    t0 = time.time()
    net, cfg = load_net(str(snapshot_dir), device)
    n_params = sum(p.numel() for p in net.parameters())
    channels = int(cfg["network_kwargs"]["channels"])
    g = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn((batch, res, res, channels), generator=g, device=device)
    t = torch.rand((batch,), generator=g, device=device)
    n_attn = sum(isinstance(m, AttentionBlock) for m in net.modules())
    expect = n_attn if device.type == "cuda" else 0
    calls = []

    def recorded(q, k, v):
        out = fused_attention(q, k, v)
        if compare_plain:
            calls.append((q, k, v, out))
        return out

    def forward(attend):
        unet.fused_attention = attend
        try:
            return net(x, t).float()
        finally:
            unet.fused_attention = fused_attention

    with torch.no_grad():
        before = launch_counts["attention_fwd"]
        out = forward(recorded)
        rose = launch_counts["attention_fwd"] - before
        if device.type == "cuda":
            torch.cuda.synchronize()
        if rose != expect:
            raise AssertionError(f"attention kernel launched {rose} times in one forward, want {expect}")
        if not bool(torch.isfinite(out).all()):
            raise AssertionError("non-finite network output")
        result = {"params": n_params, "shape": list(out.shape), "attention_blocks": n_attn,
                  "launches": rose}
        if compare_plain:
            # each launch against the plain version on its inputs, at the
            # phase-2 tolerance: one bf16 ulp of that call's output scale,
            # which an attention that drops a key must exceed
            per_call = []
            for q, k, v, got in calls:
                want = attention_reference(q, k, v).float()
                err, tol = float((got.float() - want).abs().max()), bf16_ulp(float(want.abs().max()))
                fault = float((_key_dropped(q, k, v).float() - want).abs().max())
                per_call.append({"max_abs_err": err, "tol": tol, "key_dropped_err": fault,
                                 "outputs_differ": int((got.float() != want).sum())})
                if err > tol:
                    raise AssertionError(f"attention launch in the network disagrees: {per_call}")
                if fault <= tol:
                    raise AssertionError(f"the per-launch check cannot see a dropped key: {per_call}")
            plain = forward(attention_reference)

            def diff(y):
                d = (y - plain).abs()
                return float(d.max()), float(d.mean())

            err, err_mean = diff(out)
            ulp_max, ulp_mean = diff(forward(lambda q, k, v: _one_ulp_off(q, k, v, g)))
            fault_max, fault_mean = diff(forward(_key_dropped))
            # other attentions, read against the same limits and not gated:
            # how far the forward goes when one output moves, or when either
            # product is summed in another order than the plain version's
            controls = {
                "one_output_moved": diff(forward(lambda q, k, v: _one_output_moved(q, k, v, g))),
                "logits_exact": diff(forward(_logits_exact)),
                "pv_exact": diff(forward(_pv_exact)),
            }
            # each launch is within one ulp of the plain version (above), so
            # the forward may differ from the plain one by at most what moving
            # every attention output one ulp does, in max and in mean. A
            # dropped key moves the bf16 output about as much, so the
            # per-launch check above is the one that sees such a fault.
            tol, tol_mean = ulp_max, ulp_mean
            result.update(per_call=per_call, max_abs_err=err, mean_abs_err=err_mean,
                          out_scale=float(plain.abs().max()), tol=tol, tol_mean=tol_mean,
                          one_ulp_max=ulp_max, one_ulp_mean=ulp_mean,
                          key_dropped_max=fault_max, key_dropped_mean=fault_mean,
                          controls=controls)
            if err > tol or err_mean > tol_mean:
                raise AssertionError(f"kernel forward disagrees with plain forward: {result}")
            if device.type == "cuda":  # one forward each way, warm, CUDA events
                result["forward_plain_ms"] = cuda_time_ms(lambda: forward(attention_reference),
                                                          reps=3, warmup=1)
                result["forward_ms"] = cuda_time_ms(lambda: forward(fused_attention), reps=3, warmup=1)
    emit(3, t0, **result)
    return result


def synthetic_inputs(L, H, W, C, n_train, seed):
    """A ground-truth trajectory with a power-law spectrum, smooth in time,
    and a stack of training frames [T, C, H, W] for the calibration target."""
    rng = np.random.default_rng(seed)
    ky = np.fft.fftfreq(H)[:, None]
    kx = np.fft.fftfreq(W)[None, :]
    amp = (np.sqrt(ky**2 + kx**2) + 1.0 / H) ** (-1.5)

    def fields(n):
        spec = (rng.standard_normal((n, C, H, W)) + 1j * rng.standard_normal((n, C, H, W))) * amp
        f = np.fft.ifft2(spec, axes=(-2, -1)).real
        return (f / f.std(axis=(0, 2, 3), keepdims=True)).astype(np.float32)

    base = fields(L)
    gt = np.cumsum(base, axis=0) / np.sqrt(np.arange(1, L + 1))[:, None, None, None]
    return gt.transpose(0, 2, 3, 1).astype(np.float32), fields(n_train)


def phase4_slice(snapshot_dir, config_path, device, L=49, res=128, n_train=64, seed=0,
                 overrides=None) -> dict:
    """The main path: ``run_arrays`` at the config's settings, as its two
    steps ``load_net`` and ``sample_arrays``, timed apart."""
    from climate2weather_tpu_torch.diffusion.calibrate import climatological_annulus_psd
    from climate2weather_tpu_torch.diffusion.guidance import SpatioTemporalCoarsening
    from climate2weather_tpu_torch.exp.downscaling import load_net, sample_arrays
    from climate2weather_tpu_torch.io.snapshot import yaml_load_file
    from climate2weather_tpu_torch.ops.attention import launch_counts

    t0 = time.time()
    cfg = yaml_load_file(config_path)
    cfg.update({"num_samples": 3, **(overrides or {})})
    snap_cfg = yaml_load_file(pathlib.Path(snapshot_dir) / "config.yaml")
    C = int(snap_cfg["dataset_kwargs"]["train"]["num_features"])
    gt, train = synthetic_inputs(L, res, res, C, n_train, seed)
    if device.type == "cuda":
        torch.cuda.synchronize()
    for k in launch_counts:
        launch_counts[k] = 0
    t_load = time.time()
    net, snap_cfg = load_net(str(snapshot_dir), device)
    if device.type == "cuda":
        torch.cuda.synchronize()
    t_sample = time.time()
    samples, nan_flags = sample_arrays(net, snap_cfg, cfg, gt, calib_frames=train, device=device)
    t_end = time.time()  # sample_arrays ends in a copy to the host
    launches = dict(launch_counts)
    t_psd = time.time()  # the host-side calibration target, which sample_arrays computes once
    climatological_annulus_psd(train, s_step=int(cfg["s_step"]))
    psd_s = time.time() - t_psd

    window = int(snap_cfg["dataset_kwargs"]["train"]["window"])
    n_win, chunk = L - window + 1, int(cfg["batch_size"])
    per_call = n_win if n_win <= chunk else chunk  # windows per member per forward
    n_chunks = -(-n_win // per_call)
    evals = int(cfg["num_sampling_steps"]) + int(bool(cfg.get("denoise_final", False)))
    n_samples = int(cfg["num_samples"])
    forwards = -(-n_samples // int(cfg.get("ensemble_batch", 1))) * evals * n_chunks
    nk = snap_cfg["network_kwargs"]
    n_attn = 2 * sum(int(b) for i, b in enumerate(nk["hidden_blocks"])
                     if i in nk.get("attention_levels", ()))
    expect = n_attn * forwards if device.type == "cuda" else 0
    window_evals = n_samples * evals * n_chunks * per_call
    A = SpatioTemporalCoarsening(int(cfg["s_step"]), int(cfg["t_step"]))
    consistency, tol = _consistency(A, [torch.from_numpy(samples)], A(torch.from_numpy(gt)))
    x_max = float(np.abs(samples).max())
    result = {
        "samples_shape": list(samples.shape), "finite": bool(np.isfinite(samples).all()),
        "nan_flags": nan_flags.tolist(), "sample_abs_max": x_max,
        "A_x_minus_y_max": consistency, "A_tol": tol,
        "unet_forwards": forwards, "attention_launches": launches.get("attention_fwd", 0),
        "expected_launches": expect, "load_s": t_sample - t_load, "sampling_s": t_end - t_sample,
        "calib_target_s": psd_s, "wall_s": t_end - t_load, "window_evals": window_evals,
        "window_evals_per_s": window_evals / (t_end - t_sample),
    }
    emit(4, t0, **result)
    if not result["finite"] or nan_flags.any():
        raise AssertionError(f"non-finite samples or NaN flags: {result}")
    if consistency > tol:
        raise AssertionError(f"A(x) != y after the projection: {consistency} > {tol}")
    if launches.get("attention_fwd", 0) != expect:
        raise AssertionError(f"attention launches {launches} != 6 x forwards = {expect}")
    return {"launches": launches, **result}


def write_training_h5(path, lhwc: np.ndarray) -> None:
    """A training file of the layout ``merged_to_normed_h5`` writes: ``x``
    [T, C, H, W] float32 in chunks of 24 frames, with the ``vars`` and
    ``norm_mode`` attributes, through the port's own HDF5 writer."""
    from climate2weather_tpu_torch.io import hdf5

    x = np.ascontiguousarray(lhwc.transpose(0, 3, 1, 2), np.float32)
    with hdf5.Writer(path) as w:
        w.create_dataset("x", data=x, chunks=(min(24, x.shape[0]),) + x.shape[1:])
        w.attrs["vars"] = ["psl", "tas", "uas", "vas"][: x.shape[1]]
        w.attrs["norm_mode"] = "quant95"


class RecordingProcess(VPCosineProcess):
    """The training noise process, recording for phase 5 each microbatch's
    loss, its t and a fingerprint of its eps, and the synchronised start
    time of each step (the first microbatch's loss call)."""

    records: list = []
    rounds: int = 1

    def perturb(self, x, t, generator=None, eps=None):
        xt, eps = super().perturb(x, t, generator, eps)
        RecordingProcess.records.append({
            "t": t.detach().flatten().float().clone(),
            "eps_sum": eps.sum(dtype=torch.float64), "eps_head": eps.flatten()[:8].float(),
        })
        return xt, eps

    def loss(self, eps_model, x, forcing=None, generator=None, t=None, eps=None):
        if x.device.type == "cuda" and len(RecordingProcess.records) % RecordingProcess.rounds == 0:
            torch.cuda.synchronize()
        start = time.perf_counter()
        out = super().loss(eps_model, x, forcing, generator, t, eps)
        RecordingProcess.records[-1].update(loss=out.detach(), start=start)
        return out


def phase5_training(device, seed=0, model_config=MODEL_CONFIG, res=128, frames=140,
                    batch=64, batch_gpu=32, ndata=1024, compute_dtype=torch.bfloat16,
                    check_launches=True) -> dict:
    """Train with ``training_loop`` to ``ndata``, checkpoint and snapshot
    there, and resume to ``2 * ndata``; see the module docstring."""
    import shutil
    import tempfile

    from climate2weather_tpu_torch.data.dataset import InfiniteSampler, WindowDataset
    from climate2weather_tpu_torch.exp.downscaling import load_net
    from climate2weather_tpu_torch.io.snapshot import yaml_load_file
    from climate2weather_tpu_torch.models.score_net import build_score_unet
    from climate2weather_tpu_torch.ops import attention
    from climate2weather_tpu_torch.training.checkpoint import CheckpointIO
    from climate2weather_tpu_torch.training.loop import training_loop
    from climate2weather_tpu_torch.training.state import (
        gather_windows,
        init_train_state,
        make_optimizer,
        step_generator,
        upload_dataset,
    )

    t0 = time.time()
    window, n_features = 13, 4  # the 72.1M snapshot's: 4 variables x 13 frames
    net_kwargs = {"class_name": "score_unet", "channels": n_features * window,
                  **yaml_load_file(model_config)}
    run_dir = tempfile.mkdtemp(prefix="c2w-train-")
    data_path = os.path.join(run_dir, "train.h5")
    write_training_h5(data_path, synthetic_inputs(frames, res, res, n_features, 1, seed)[0])
    data_kwargs = {"class_name": "cosmo_dataset", "data_path": data_path,
                   "num_features": n_features, "spatial_res": res, "window": window}
    rounds = batch // batch_gpu
    n_attn = 2 * sum(int(b) for i, b in enumerate(net_kwargs["hidden_blocks"])
                     if i in net_kwargs.get("attention_levels", ()))
    kwargs = dict(
        dataset_kwargs={"train": data_kwargs}, network_kwargs=net_kwargs,
        pipeline_kwargs={"class_name": "chip_smoke.RecordingProcess"},
        optimizer_kwargs={"class_name": "adamw", "lr": 2e-4, "weight_decay": 1e-3,
                          "betas": [0.9, 0.999]},
        lr_kwargs={"func_name": "lr/linear", "ref_lr": 2e-4, "total_ndata": 2 * ndata},
        batch_size=batch, batch_gpu=batch_gpu, log_ndata=None, status_ndata=ndata // 2,
        snapshot_ndata=ndata, checkpoint_ndata=ndata, valid_ndata=None,
        ema_kwargs={"rates": [0.9999]}, seed=seed, device=device, compute_dtype=compute_dtype,
        loader_threads=1,
    )
    RecordingProcess.rounds = rounds
    cuda = device.type == "cuda"
    try:
        # -- run 1: 0 -> ndata, checkpoint and snapshot at ndata ------------
        RecordingProcess.records = []
        for name in attention.launch_counts:
            attention.launch_counts[name] = 0
        if cuda:
            # torch keeps a cuBLAS workspace for every stream that ran cuBLAS
            # (phase 2's graph timings) allocated until cleared: not training's
            torch._C._cuda_clearCublasWorkspaces()
            torch.cuda.reset_peak_memory_stats(device)
        state1 = training_loop(run_dir, total_ndata=ndata, **kwargs)
        launches1 = dict(attention.launch_counts)
        records = list(RecordingProcess.records)
        peak = torch.cuda.max_memory_allocated(device) if cuda else None

        # -- the checkpoint restores the state exactly ----------------------
        ckpt = os.path.join(run_dir, f"training-state-{ndata // 1000:07d}.ckpt")
        fresh_net = build_score_unet(net_kwargs, dtype=compute_dtype).to(device)
        fresh = init_train_state(fresh_net, make_optimizer(fresh_net.parameters(),
                                                           kwargs["optimizer_kwargs"]), [0.9999])
        CheckpointIO(state=fresh, meta={"batch_size": batch}).load(ckpt, verbose=False)
        mismatched = [k for k, v in state1.net.state_dict().items()
                      if not torch.equal(v, fresh_net.state_dict()[k])]
        p1, p2 = dict(state1.net.named_parameters()), dict(fresh_net.named_parameters())
        for k in p1:
            s1, s2 = state1.optimizer.state[p1[k]], fresh.optimizer.state[p2[k]]
            if not (torch.equal(s1["exp_avg"], s2["exp_avg"])
                    and torch.equal(s1["exp_avg_sq"], s2["exp_avg_sq"])
                    and float(s1["step"]) == float(s2["step"])):
                mismatched.append(f"opt:{k}")
        for rk, ema in state1.emas.items():
            mismatched += [f"ema{rk}:{k}" for k, v in ema.items() if not torch.equal(v, fresh.emas[rk][k])]
        restored_exact = not mismatched and fresh.step == state1.step
        del fresh, fresh_net

        # -- what an uninterrupted run draws and computes at the next step -
        ds = WindowDataset(**{k: v for k, v in data_kwargs.items() if k != "class_name"})
        it = iter(InfiniteSampler(len(ds), seed=seed, start_idx=ndata))
        idx = torch.tensor([next(it) for _ in range(batch_gpu)], device=device)
        data = upload_dataset(ds._reader(), ds.raw_data_shape[0], device=device)
        RecordingProcess.records = []
        with torch.no_grad():
            RecordingProcess().loss(lambda xt, t, f: state1.net(xt, t),
                                    gather_windows(data, idx, window),
                                    generator=step_generator(seed, ndata // batch, device))
        uninterrupted = RecordingProcess.records[0]
        del state1, data

        # -- run 2: resume ndata -> 2 ndata; record the backward launches of
        # its first step
        bwd_calls = []
        plain_bwd = attention.attention_bwd

        def recorded_bwd(q, k, v, do):
            out = plain_bwd(q, k, v, do)
            if len(bwd_calls) < n_attn * rounds:  # the launches of one step
                bwd_calls.append((q, k, v, do.detach(), out))
            return out

        RecordingProcess.records = []
        for name in attention.launch_counts:
            attention.launch_counts[name] = 0
        attention.attention_bwd = recorded_bwd
        try:
            training_loop(run_dir, total_ndata=2 * ndata, **kwargs)
        finally:
            attention.attention_bwd = plain_bwd
        launches2 = dict(attention.launch_counts)
        records += RecordingProcess.records
        resumed = RecordingProcess.records[0]
        if cuda:
            peak = max(peak, torch.cuda.max_memory_allocated(device))

        # -- checks ----------------------------------------------------------
        steps = len(records) // rounds
        losses = [float(sum(float(r["loss"]) for r in records[i * rounds:(i + 1) * rounds]) / rounds)
                  for i in range(steps)]
        draws_equal = bool(torch.equal(resumed["t"], uninterrupted["t"])
                           and float(resumed["eps_sum"]) == float(uninterrupted["eps_sum"])
                           and torch.equal(resumed["eps_head"], uninterrupted["eps_head"]))
        resume_loss_diff = abs(float(resumed["loss"]) - float(uninterrupted["loss"]))
        # the two forwards run the same kernels on the same bits
        resume_tol = 1e-6 * abs(float(uninterrupted["loss"]))
        per_run = n_attn * rounds * (ndata // batch) if cuda else 0
        want_fwd = per_run * (2 if os.environ.get("C2W_REMAT", "0") == "1" else 1)
        per_launch = []
        with torch.no_grad():
            for q, k, v, do, got in bwd_calls:
                want = attention.attention_bwd_reference(q, k, v, do)
                errs, scales = _grads_err(got, want)
                tols = _bwd_tols(scales, q.dtype)
                fault, _ = _grads_err(_rowsum_dropped(q, k, v, do), want)
                per_launch.append({"max_abs_err": errs, "tol": tols,
                                   "rowsum_dropped_err": fault[:2]})
        starts = [records[i * rounds]["start"] for i in range(steps)]
        half = ndata // batch
        warm = [b - a for run in (starts[:half], starts[half:]) for a, b in zip(run[2:], run[3:])]
        snap = os.path.join(run_dir, f"network-snapshot-{ndata // 1000:07d}-0.999900")
        snap_net, _ = load_net(snap, device)
        with torch.no_grad():
            y = snap_net(torch.randn((2, res, res, n_features * window), generator=torch.Generator(
                device=device).manual_seed(seed), device=device), 0.5)
        result = {
            "params": sum(p.numel() for p in snap_net.parameters()), "steps": steps,
            "losses": losses, "first4_mean": float(np.mean(losses[:4])),
            "last4_mean": float(np.mean(losses[-4:])), "restored_exact": restored_exact,
            "restore_mismatches": mismatched[:5], "resume_draws_equal": draws_equal,
            "resume_loss": float(resumed["loss"]), "uninterrupted_loss": float(uninterrupted["loss"]),
            "resume_loss_diff": resume_loss_diff, "resume_tol": resume_tol,
            "launches_run1": launches1, "launches_run2": launches2,
            "expected_fwd": want_fwd, "expected_bwd": per_run,
            "bwd_per_launch": per_launch,
            "snapshot_forward_finite": bool(torch.isfinite(y.float()).all()),
            "step_ms_warm": [1e3 * w for w in warm],
            "step_ms_mean": 1e3 * float(np.mean(warm)) if warm else None,
            "samples_per_s": batch / float(np.mean(warm)) if warm else None,
            "max_memory_allocated": peak,
        }
        del snap_net
    finally:
        shutil.rmtree(run_dir, ignore_errors=True)
    emit(5, t0, **result)
    if not all(np.isfinite(losses)) or not result["last4_mean"] < result["first4_mean"]:
        raise AssertionError(f"losses not finite or not falling: {losses}")
    if not restored_exact:
        raise AssertionError(f"checkpoint restore differs: {mismatched[:10]}")
    if not draws_equal or resume_loss_diff > resume_tol:
        raise AssertionError("the resumed step differs from the uninterrupted one: "
                             f"draws equal {draws_equal}, loss diff {resume_loss_diff}")
    if check_launches:
        for name, got in (("run 1", launches1), ("run 2", launches2)):
            if got["attention_fwd"] != want_fwd or got["attention_bwd"] != per_run:
                raise AssertionError(f"{name}: launches {got}, want fwd {want_fwd} bwd {per_run}")
    if len(bwd_calls) != n_attn * rounds or any(
            any(e > tl for e, tl in zip(c["max_abs_err"], c["tol"])) for c in per_launch):
        raise AssertionError(f"a backward launch in training disagrees: {per_launch}")
    if any(min(c["rowsum_dropped_err"]) <= max(c["tol"][:2]) for c in per_launch):
        raise AssertionError(f"the per-launch check cannot see a dropped row sum: {per_launch}")
    if not result["snapshot_forward_finite"]:
        raise AssertionError("the snapshot's forward is not finite")
    return {"launches": {k: launches1[k] + launches2[k] for k in launches1}, **result}


PREDICT_CONFIGS = REPO / "exp" / "configs" / "000_on-model-eval"
# (name of the run, config it copies, overrides): the confirmed dpmpp2m
# setting, PC at 256 steps, the external observation and guidance off
PREDICT_RUNS = (
    ("s16_t6_spectral", "s16_t6_spectral.yml", {"num_samples": 3}),
    ("s16_t6", "s16_t6.yml", {"num_samples": 3}),
    ("external_observation", "s16_t6_spectral.yml",
     {"num_samples": 3, "num_sampling_steps": 8, "observation_path": "obs"}),
    ("guidance_off", "s16_t6_spectral.yml",
     {"num_samples": 3, "num_sampling_steps": 8, "guidance_off": True}),
)
# offset and scale of each variable in physical units (Pa, K, m/s)
PHYSICAL = {"psl": (101000.0, 800.0), "tas": (285.0, 5.0), "uas": (0.0, 4.0), "vas": (0.0, 4.0)}


def write_predict_inputs(root: pathlib.Path, res=128, hours=49, seed=0, start="2014-04-07T04") -> dict:
    """Phase 6's files, through the port's writers: a synthetic ``hours``-hour
    grid of psl, tas, uas, vas from ``start``, its quantile file, a
    training file normalized with them, and a coarse observation grid (the
    16x block means every 6 hours, tas biased by 1 K, as a climate model's
    would be)."""
    from climate2weather_tpu_torch.data.grid import GridDataset
    from climate2weather_tpu_torch.data.pipeline import compute_quantiles, merged_to_normed_h5

    gt, _ = synthetic_inputs(hours, res, res, len(PHYSICAL), 1, seed)
    time_axis = np.datetime64(start, "ns") + np.arange(hours) * np.timedelta64(1, "h")
    coords = {"time": time_axis, "rlat": np.linspace(-5.0, 5.0, res), "rlon": np.linspace(-5.0, 5.0, res)}
    ds = GridDataset({v: (gt[..., i] * sc + off).astype(np.float32)
                      for i, (v, (off, sc)) in enumerate(sorted(PHYSICAL.items()))},
                     coords, {"source": "chip_smoke synthetic"})
    paths = {k: str(root / f) for k, f in (("data", "merged-allvars.nc"), ("quantiles", "quantiles.nc"),
                                          ("train", "train_normed.h5"), ("obs", "observation-coarse.nc"))}
    ds.to_file(paths["data"])
    compute_quantiles(ds).to_file(paths["quantiles"])
    merged_to_normed_h5(paths["data"], paths["quantiles"], paths["train"])
    obs = ds.coarsen_mean(16).isel_time(np.arange(0, hours, 6))
    obs.map(lambda k, v: v + np.float32(1.0 if k == "tas" else 0.0)).to_file(paths["obs"])
    return paths


def _attention_blocks(network_kwargs: dict) -> int:
    """Attention launches per UNet forward: one per attention block, two
    blocks (down and up) per residual block of an attention level."""
    return 2 * sum(int(b) for i, b in enumerate(network_kwargs["hidden_blocks"])
                   if i in network_kwargs.get("attention_levels", ()))


def _expected_forwards(cfg: dict, L: int, window: int) -> int:
    """UNet forwards of one run: groups x network evaluations x window chunks."""
    n_win, chunk = L - window + 1, int(cfg.get("batch_size", 16))
    n_chunks = -(-n_win // min(n_win, chunk))
    steps = int(cfg.get("num_sampling_steps", 256))
    if cfg.get("sampler_kind", "pc") == "pc":
        steps *= 1 + int(cfg.get("num_corrections", 2))
    evals = steps + int(bool(cfg.get("denoise_final", False)))
    groups = -(-int(cfg.get("num_samples", 1)) // max(1, int(cfg.get("ensemble_batch", 1))))
    return groups * evals * n_chunks


def _normed(ds, cfg: dict, quantiles) -> np.ndarray:
    """A grid read back from a run, normalized as the run normalized it:
    [L, H, W, C] float32."""
    from climate2weather_tpu_torch.data import pipeline

    x = pipeline.normalize_ds(ds, quantiles, cfg["data_norm_mode"])
    return pipeline.nchw_to_nhwc(pipeline.ds_to_sorted_np(x, sorted(cfg["data_vars"])))


def _written_consistency(out_dir, samples, cfg: dict, quantiles) -> tuple:
    """:func:`_consistency` of the written samples in normalized space, y
    being the observation the run wrote."""
    from climate2weather_tpu_torch.data.grid import open_grid
    from climate2weather_tpu_torch.diffusion.guidance import SpatioTemporalCoarsening

    A = SpatioTemporalCoarsening(int(cfg["s_step"]), int(cfg["t_step"]))
    y = torch.from_numpy(_normed(open_grid(str(out_dir / "observation.nc")), cfg, quantiles))
    xs = [torch.from_numpy(_normed(smp, cfg, quantiles)) for smp in samples]
    return _consistency(A, xs, y)


def _consistency(A, xs, y, bf16=False) -> tuple:
    """max |A(x) - y| over the samples ``xs`` and its limit: phase 4's (the
    fp32 round-off of the FFT passes relative to both fields' magnitudes),
    plus half a bf16 ulp of the largest value where the trajectory is bf16
    (the last projection pass rounds every value)."""
    err = max(float((A(x) - y).abs().max()) for x in xs)
    x_max = max(float(x.abs().max()) for x in xs)
    tol = 1e-4 * max(1.0, float(y.abs().max())) + 1e-6 * x_max
    return err, tol + (bf16_ulp(x_max) / 2 if bf16 else 0.0)


def phase6_predict(snapshot_dir, device, res=128, hours=49, seed=0, steps_override=None) -> dict:
    """``exp/downscaling.run`` (the ``predict`` entry point) from files the
    phase writes with the port's writers, with h5py made unimportable: the
    runs of ``PREDICT_RUNS``. Each output ``.nc`` is read back with the
    port's reader and checked finite; where the config projects, A(x) = y
    holds in normalized space under phase 4's tolerance; the attention
    launches are 6 per UNet forward on the card."""
    import shutil
    import tempfile

    from climate2weather_tpu_torch.data.grid import open_grid
    from climate2weather_tpu_torch.exp import downscaling
    from climate2weather_tpu_torch.io.snapshot import yaml_dump_file, yaml_load_file
    from climate2weather_tpu_torch.ops.attention import launch_counts

    t0 = time.time()
    sys.modules["h5py"] = None  # the port reads and writes HDF5 without it
    root = pathlib.Path(tempfile.mkdtemp(prefix="c2w-predict-"))
    records = []
    try:
        paths = write_predict_inputs(root, res, hours, seed)
        snap_cfg = yaml_load_file(pathlib.Path(snapshot_dir) / "config.yaml")
        window = int(snap_cfg["dataset_kwargs"]["train"]["window"])
        n_attn = _attention_blocks(snap_cfg["network_kwargs"])
        for name, base, overrides in PREDICT_RUNS:
            cfg = yaml_load_file(PREDICT_CONFIGS / base)
            cfg.update(model_path=str(snapshot_dir), data_path=paths["data"],
                       quantile_path=paths["quantiles"], observation_path=paths["data"])
            if cfg.get("spectral_calibrate"):
                cfg["spectral_calibrate"] = paths["train"]
            cfg.update({k: paths[v] if k == "observation_path" else v for k, v in overrides.items()})
            if steps_override:
                cfg["num_sampling_steps"] = min(int(cfg["num_sampling_steps"]), steps_override)
            config_path = root / f"{name}.yml"
            yaml_dump_file(cfg, config_path)
            for k in launch_counts:
                launch_counts[k] = 0
            t_run = time.time()
            out_dir = downscaling.run(str(root / "out"), str(config_path), device=device)
            if device.type == "cuda":
                torch.cuda.synchronize()
            seconds = time.time() - t_run
            launches = launch_counts["attention_fwd"]
            expect = n_attn * _expected_forwards(cfg, hours, window) if device.type == "cuda" else 0
            samples = [open_grid(str(out_dir / f"gen_sample_{i:03d}.nc")) for i in range(int(cfg["num_samples"]))]
            finite = all(bool(np.isfinite(v).all()) for smp in samples for v in smp.data_vars.values())
            rec = {"run": name, "seconds": seconds, "attention_launches": launches,
                   "expected_launches": expect, "finite": finite,
                   "outputs": sorted(p.name for p in out_dir.iterdir())}
            if cfg.get("t0_project"):
                consistency, tol = _written_consistency(out_dir, samples, cfg, paths["quantiles"])
                rec.update(A_x_minus_y_max=consistency, A_tol=tol)
            records.append(rec)
            if not finite:
                raise AssertionError(f"predict wrote non-finite samples: {rec}")
            if "A_tol" in rec and rec["A_x_minus_y_max"] > rec["A_tol"]:
                raise AssertionError(f"A(x) != y in the written samples: {rec}")
            if launches != expect:
                raise AssertionError(f"attention launches {launches} != 6 per UNet forward = {expect}: {rec}")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    emit(6, t0, runs=records)
    return {"runs": records}


def phase7_tiny_training(device, seed=0, steps=4) -> dict:
    """The canonical training drive through the command line: ``python -m
    climate2weather_tpu_torch.train`` with ``configs/tiny_unet.yml`` at
    32 x 32 (attention over 16 x 16 = 256 tokens, forward and backward), from a
    ``train.h5`` the port's writer made, for ``steps`` steps of 64 in two
    microbatches, after the command's step-0 validation sampling. Every
    logged loss must be finite, and each attention launch of the first
    training step must agree with the plain version (one bf16 ulp)."""
    import shutil
    import tempfile

    from climate2weather_tpu_torch import train
    from climate2weather_tpu_torch.ops import attention

    t0 = time.time()
    root = pathlib.Path(tempfile.mkdtemp(prefix="c2w-tiny-"))
    calls = {"fwd": [], "bwd": []}
    real_fwd, real_bwd = attention.attention_fwd, attention.attention_bwd
    batch_gpu, per_step = 32, 2 * 2  # two attention blocks x two microbatches
    # the step-0 validation: the PC sampler, 100 steps on one window, through
    # both attention blocks (forward only)
    valid_fwd = 2 * 100

    def rec_fwd(q, k, v):
        out = real_fwd(q, k, v)
        if q.shape[0] == batch_gpu and len(calls["fwd"]) < per_step:  # a training microbatch
            calls["fwd"].append((q.detach(), k.detach(), v.detach(), out))
        return out

    def rec_bwd(q, k, v, do):
        out = real_bwd(q, k, v, do)
        if len(calls["bwd"]) < per_step:
            calls["bwd"].append((q.detach(), k.detach(), v.detach(), do.detach(), out))
        return out

    try:
        write_training_h5(root / "train.h5", synthetic_inputs(64, 32, 32, 4, 1, seed)[0])
        ndata = str(64 * steps)
        argv = ["--run-dir", str(root / "runs"), "--run-id", "tiny", "--train-data", str(root / "train.h5"),
                "--spatial-res", "32", "--num-features", "4", "--markov-order", "2",
                "--model-config", str(REPO / "configs" / "tiny_unet.yml"), "--lr", "1e-3",
                "--total-ndata", ndata, "--batch", "64", "--batch-gpu", str(batch_gpu), "--status", "64",
                "--snapshot", "1024", "--checkpoint", "1024", "--logging", "64", "--seed", str(seed),
                "--device", device.type]
        for k in attention.launch_counts:
            attention.launch_counts[k] = 0
        attention.attention_fwd, attention.attention_bwd = rec_fwd, rec_bwd
        try:
            train.main(argv)
        finally:
            attention.attention_fwd, attention.attention_bwd = real_fwd, real_bwd
        launches = dict(attention.launch_counts)
        lines = (root / "runs" / "tiny" / "metrics.jsonl").read_text().splitlines()
        losses = [json.loads(ln)["train/loss"] for ln in lines if "train/loss" in json.loads(ln)]
        per_launch = []
        with torch.no_grad():
            for q, k, v, out in calls["fwd"]:
                want = attention.attention_reference(q, k, v).float()
                per_launch.append({"kernel": "fwd", "tokens": q.shape[1], "max_abs_err": [
                    float((out.float() - want).abs().max())], "tol": [bf16_ulp(float(want.abs().max()))]})
            for q, k, v, do, out in calls["bwd"]:
                errs, scales = _grads_err(out, attention.attention_bwd_reference(q, k, v, do))
                per_launch.append({"kernel": "bwd", "tokens": q.shape[1], "max_abs_err": errs,
                                   "tol": _bwd_tols(scales, q.dtype)})
    finally:
        shutil.rmtree(root, ignore_errors=True)
    cuda = device.type == "cuda"
    result = {"steps": steps, "losses": losses, "launches": launches, "per_launch": per_launch}
    emit(7, t0, **result)
    if len(losses) != steps or not all(x is not None and np.isfinite(x) for x in losses):
        raise AssertionError(f"the tiny drive's losses are missing or not finite: {losses}")
    want_bwd = per_step * steps if cuda else 0
    want_fwd = want_bwd + valid_fwd if cuda else 0
    if launches.get("attention_fwd") != want_fwd or launches.get("attention_bwd") != want_bwd:
        raise AssertionError(f"tiny drive launches {launches}, want fwd {want_fwd} bwd {want_bwd}")
    if len(per_launch) != 2 * per_step or any(q_tok != 256 for q_tok in (c["tokens"] for c in per_launch)) or any(
            any(e > tl for e, tl in zip(c["max_abs_err"], c["tol"])) for c in per_launch):
        raise AssertionError(f"an attention launch of the tiny drive disagrees: {per_launch}")
    return result


YEAR_CONFIG = REPO / "exp" / "configs" / "001_clim-downscaling" / "year2014_meso128_winning.yml"
YEAR_HOURS = 523  # 6 * 87 + 1: above the long path's threshold of 512 frames
BF16_HOURS = 4003  # above the 4000 frames where DPM-Solver++(2M)'s trajectory goes bf16
FULL_YEAR_HOURS = 8737
# trajectory-sized buffers live at the peak of a DPM-Solver++(2M) step on the
# long path, counted from the code: the initial noise and the zero previous
# x0 (held by the sampler's initial state), the state's x and previous x0,
# and the step's eps and two outputs
TRAJECTORY_BUFFERS = 7


class Crash(Exception):
    """Raised by phase 8b's scorer to stop a run as a killed process stops."""


def _year_config(snapshot_dir, paths, hours, overrides=None) -> dict:
    """``year2014_meso128_winning.yml`` on the phase's files, cut to
    ``hours`` hours and one sample; ``overrides`` cut it further."""
    from climate2weather_tpu_torch.io.snapshot import yaml_load_file

    cfg = yaml_load_file(YEAR_CONFIG)
    cfg.update(model_path=str(snapshot_dir), data_path=paths["data"], quantile_path=paths["quantiles"],
               observation_path=paths["data"], spectral_calibrate=paths["train"], num_hours=hours,
               num_samples=1, **(overrides or {}))
    return cfg


def _peak_reset(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()


def _peak(device):
    if device.type != "cuda":
        return None
    torch.cuda.synchronize()
    return torch.cuda.max_memory_allocated()


def phase8a_predict(root, snapshot_dir, device, res, hours, seed, overrides) -> dict:
    """``exp/downscaling.run`` on the year config cut to ``hours`` hours and
    one sample, from files the port wrote, h5py unimportable: the long path
    taken, a finite sample, A(x) = y at the observed frames, the resume file
    written every ``sample_resume_every`` calls of 8 steps and removed, the
    attention launches 6 per UNet forward; sampling, I/O and peak memory."""
    from climate2weather_tpu_torch.data.grid import open_grid
    from climate2weather_tpu_torch.diffusion import long_sampler
    from climate2weather_tpu_torch.exp import downscaling
    from climate2weather_tpu_torch.io.snapshot import yaml_dump_file, yaml_load_file
    from climate2weather_tpu_torch.ops.attention import launch_counts

    t0 = time.time()
    paths = write_predict_inputs(root, res, hours, seed, start="2014-01-01T00")
    inputs_written_s = time.time() - t0
    cfg = _year_config(snapshot_dir, paths, hours, overrides)
    config_path = root / "year.yml"
    yaml_dump_file(cfg, config_path)
    snap_cfg = yaml_load_file(pathlib.Path(snapshot_dir) / "config.yaml")
    window = int(snap_cfg["dataset_kwargs"]["train"]["window"])
    saves, real_save = [], long_sampler._save_carry

    def counted_save(*args):
        saves.append(args[2])  # the step index written
        real_save(*args)

    stats = {}
    long_sampler._save_carry = counted_save
    try:
        _peak_reset(device)
        for k in launch_counts:
            launch_counts[k] = 0
        t_run = time.time()
        out_dir = downscaling.run(str(root / "out"), str(config_path), device=device, stats=stats)
        peak = _peak(device)
        run_s = time.time() - t_run
        launches = launch_counts["attention_fwd"]
    finally:
        long_sampler._save_carry = real_save
    forwards = _expected_forwards({**cfg, "ensemble_batch": 1}, hours, window)
    per_call = min(hours - window + 1, int(cfg["batch_size"]))
    steps, every = int(cfg["num_sampling_steps"]), int(cfg["sample_resume_every"])
    calls = -(-steps // 8)
    sample = open_grid(str(out_dir / "gen_sample_000.nc"))
    consistency, tol = _written_consistency(out_dir, [sample], cfg, paths["quantiles"])
    rec = {
        "hours": hours, "res": res, "steps": steps, "long_path": stats["long_path"],
        "traj_dtype": stats["traj_dtype"], "finite": all(bool(np.isfinite(v).all()) for v in sample.data_vars.values()),
        "A_x_minus_y_max": consistency, "A_tol": tol,
        "resume_saves_at_step": saves, "expected_saves": [8 * c for c in range(1, calls) if c % every == 0],
        "left_in_dir": sorted(p.name for p in out_dir.iterdir()),
        "attention_launches": launches, "unet_forwards": forwards,
        "expected_launches": _attention_blocks(snap_cfg["network_kwargs"]) * forwards if device.type == "cuda" else 0,
        "window_evals": forwards * per_call, "sampling_s": stats["sampling_s"],
        "window_evals_per_s": forwards * per_call / stats["sampling_s"],
        "input_s": stats["input_s"], "write_s": stats["write_s"], "io_s": stats["input_s"] + stats["write_s"],
        "load_net_s": stats["load_net_s"], "run_s": run_s, "inputs_written_s": inputs_written_s,
        "max_memory_allocated": peak,
    }
    emit("8a", t0, **rec)
    if not rec["long_path"] or not rec["finite"]:
        raise AssertionError(f"the year run did not take the long path or wrote non-finite values: {rec}")
    if consistency > tol:
        raise AssertionError(f"A(x) != y in the year sample: {rec}")
    if saves != rec["expected_saves"] or any(n.startswith(".sample_resume") for n in rec["left_in_dir"]):
        raise AssertionError(f"resume files not written as configured or left behind: {rec}")
    if launches != rec["expected_launches"]:
        raise AssertionError(f"attention launches {launches} != 6 per UNet forward: {rec}")
    return {**rec, "out_dir": out_dir, "paths": paths, "cfg": cfg}


def phase8b_resume(root, net, snap_cfg, cfg, gt, device, steps=16, seed=0) -> dict:
    """``sample_dpmpp2m_long`` at the config's guidance and SDE eta on
    ``gt``'s length for ``steps`` steps in calls of 8, a resume file after
    every call: twice uninterrupted, then crashed in its second call and
    resumed from the file. The resumed run must equal the uninterrupted one
    bit for bit, or, where two uninterrupted runs already differ, lie within
    their spread; the resumed run makes only the remaining calls."""
    from climate2weather_tpu_torch.diffusion import long_sampler
    from climate2weather_tpu_torch.diffusion.guidance import (
        GaussianGuidance,
        SpatioTemporalCoarsening,
        per_channel,
    )
    from climate2weather_tpu_torch.diffusion.process import construct_process
    from climate2weather_tpu_torch.diffusion.window import WindowScoreFn

    t0 = time.time()
    L, H, W, C = gt.shape
    A = SpatioTemporalCoarsening(int(cfg["s_step"]), int(cfg["t_step"]))
    guidance = GaussianGuidance(A=A, y=A(torch.from_numpy(gt).to(device)),
                                std=per_channel(cfg["likelihood_std"], C, device),
                                gamma=per_channel(cfg["likelihood_gamma"], C, device))
    forwards, crash = [], {"at": None}

    def eps_fn(windows, t):
        if len(forwards) == crash["at"]:
            raise Crash
        forwards.append(t)
        return net(windows, t)

    window = int(snap_cfg["dataset_kwargs"]["train"]["window"])
    score = WindowScoreFn(eps_fn, window // 2, chunk_size=int(cfg["batch_size"]))
    chunks = -(-(L - window + 1) // min(L - window + 1, int(cfg["batch_size"])))
    path = str(root / ".sample_resume_000.npz")

    def sample(resume_path):
        forwards.clear()
        gen = torch.Generator(device=device).manual_seed(seed)
        x = torch.randn((L, H, W, C), generator=gen, device=device)
        out, nan = long_sampler.sample_dpmpp2m_long(
            construct_process(**snap_cfg["pipeline_kwargs"]), score, x, guidance=guidance, steps=steps,
            rng=gen, sde_eta=float(cfg["sde_eta"]), steps_per_call=8, resume_path=resume_path, resume_every=1)
        return out, bool(nan)

    first, nan1 = sample(None)
    second, nan2 = sample(None)
    crash["at"] = 8 * chunks  # the first network call of the second call
    try:
        sample(path)
        raise AssertionError("the crashing run did not crash")
    except Crash:
        pass
    with np.load(path) as f:
        saved_step = int(f["step"])
    crash["at"] = None
    resumed, nan3 = sample(path)
    resumed_forwards = len(forwards)
    spread = float((first.float() - second.float()).abs().max())
    err = float((resumed.float() - first.float()).abs().max())
    rec = {"L": L, "steps": steps, "window_chunks": chunks, "saved_step": saved_step,
           "resumed_forwards": resumed_forwards, "expected_forwards": (steps - 8) * chunks,
           "uninterrupted_equal": bool(torch.equal(first, second)), "uninterrupted_max_abs_diff": spread,
           "resumed_equal": bool(torch.equal(resumed, first)), "resumed_max_abs_diff": err,
           "finite": not (nan1 or nan2 or nan3), "file_left": os.path.exists(path)}
    emit("8b", t0, **rec)
    if not rec["finite"] or saved_step != 8 or rec["file_left"]:
        raise AssertionError(f"the resume file was not written after the first call or not removed: {rec}")
    if resumed_forwards != rec["expected_forwards"]:
        raise AssertionError(f"the resumed run did not make only the remaining calls: {rec}")
    if not rec["resumed_equal"] and (rec["uninterrupted_equal"] or err > spread):
        raise AssertionError(f"the resumed run differs from the uninterrupted one: {rec}")
    return rec


def phase8c_bf16(net, snap_cfg, cfg, gt, calib, device) -> dict:
    """``sample_arrays`` on a trajectory above 4000 frames at the config's
    settings for 2 steps and the final denoise: the trajectory in bf16, a
    finite sample, A(x) = y within bf16 rounding after the chunked
    calibration and projection; peak memory, and the peak reckoned for a
    year from it."""
    from climate2weather_tpu_torch.diffusion.guidance import SpatioTemporalCoarsening
    from climate2weather_tpu_torch.exp.downscaling import sample_arrays
    from climate2weather_tpu_torch.ops.attention import launch_counts

    t0 = time.time()
    L, H, W, C = gt.shape
    cfg = {**cfg, "num_sampling_steps": 2, "num_hours": L}
    stats = {}
    _peak_reset(device)
    for k in launch_counts:
        launch_counts[k] = 0
    t_sample = time.time()
    samples, nan = sample_arrays(net, snap_cfg, cfg, gt, calib_frames=calib, device=device, stats=stats)
    peak = _peak(device)
    sampling_s = time.time() - t_sample
    window = int(snap_cfg["dataset_kwargs"]["train"]["window"])
    forwards = _expected_forwards({**cfg, "ensemble_batch": 1}, L, window)
    A = SpatioTemporalCoarsening(int(cfg["s_step"]), int(cfg["t_step"]))
    consistency, tol = _consistency(A, [torch.from_numpy(samples[0])], A(torch.from_numpy(gt)), bf16=True)
    frame_bytes = 2 * H * W * C
    rec = {"L": L, "long_path": stats["long_path"], "traj_dtype": stats["traj_dtype"],
           "finite": bool(np.isfinite(samples).all()) and not nan.any(),
           "A_x_minus_y_max": consistency, "A_tol": tol, "sampling_s": sampling_s,
           "attention_launches": launch_counts["attention_fwd"],
           "expected_launches": _attention_blocks(snap_cfg["network_kwargs"]) * forwards
           if device.type == "cuda" else 0,
           "max_memory_allocated": peak,
           "reckoned_peak_full_year": None if peak is None else
           peak + TRAJECTORY_BUFFERS * frame_bytes * (FULL_YEAR_HOURS - L)}
    emit("8c", t0, **rec)
    if rec["traj_dtype"] != "torch.bfloat16" or not rec["long_path"] or not rec["finite"]:
        raise AssertionError(f"the trajectory above 4000 frames is not a finite bf16 long-path run: {rec}")
    if consistency > tol:
        raise AssertionError(f"A(x) != y beyond bf16 rounding: {rec}")
    if rec["attention_launches"] != rec["expected_launches"]:
        raise AssertionError(f"attention launches {rec['attention_launches']} != 6 per UNet forward: {rec}")
    return rec


def phase8d_metrics(out_dir) -> dict:
    """``metrics run`` on 8a's directory (h5py unimportable): every score
    finite."""
    from climate2weather_tpu_torch.exp import metrics

    t0 = time.time()
    scores = metrics.run(str(out_dir))
    values = [np.asarray(v) for kind, by_var in scores.items() if kind != "protocol"
              for entries in by_var.values() for v in entries.values()]
    rec = {"scores": len(values), "finite": all(bool(np.isfinite(v).all()) for v in values),
           "protocol": scores["protocol"], "metrics_s": time.time() - t0}
    emit("8d", t0, **rec)
    if not values or not rec["finite"]:
        raise AssertionError(f"metrics of the year run missing or not finite: {rec}")
    return rec


def phase8_year(snapshot_dir, device, res=128, hours=YEAR_HOURS, bf16_hours=BF16_HOURS, seed=0,
                overrides=None, resume_steps=16) -> dict:
    """The year path, 8a-8d (see the module docstring), in one scratch
    directory; ``overrides`` cut the year config further. Returns the
    attention launches of 8a's run and each part's record."""
    import shutil
    import tempfile

    from climate2weather_tpu_torch.data.grid import open_grid
    from climate2weather_tpu_torch.exp.downscaling import load_net

    sys.modules["h5py"] = None  # the port reads and writes HDF5 without it
    root = pathlib.Path(tempfile.mkdtemp(prefix="c2w-year-"))
    try:
        a = phase8a_predict(root, snapshot_dir, device, res, hours, seed, overrides)
        gt = _normed(open_grid(str(a["out_dir"] / "ground_truth.nc")), a["cfg"], a["paths"]["quantiles"])
        net, snap_cfg = load_net(str(snapshot_dir), device)
        b = phase8b_resume(root, net, snap_cfg, a["cfg"], gt, device, steps=resume_steps, seed=seed)
        # a longer trajectory: the year's hours there and back again
        reps = -(-bf16_hours // hours)
        long_gt = np.concatenate([gt if i % 2 == 0 else gt[::-1] for i in range(reps)])[:bf16_hours]
        c = phase8c_bf16(net, snap_cfg, a["cfg"], np.ascontiguousarray(long_gt), a["paths"]["train"], device)
        del net
        d = phase8d_metrics(a["out_dir"])
    finally:
        shutil.rmtree(root, ignore_errors=True)
    a = {k: v for k, v in a.items() if k not in ("out_dir", "paths", "cfg")}
    return {"launches": a["attention_launches"], "8a": a, "8b": b, "8c": c, "8d": d}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--winograd-only", action="store_true",
                    help="phases 0 and 1, then phase 2's Winograd checks and timings, and stop "
                         "(a copy of this file run from another checkout's root times that "
                         "checkout's kernel by this method)")
    ap.add_argument("--attention-bwd-only", action="store_true",
                    help="phases 0 and 1, then phase 2's attention backward checks and timings, "
                         "and stop (likewise for another checkout's backward)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script runs on the card only",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    from climate2weather_tpu_torch.utils.device import set_reference_numerics

    set_reference_numerics()
    device = torch.device("cuda", 0)
    # the training phase names this script's classes by their dotted path
    sys.modules.setdefault("chip_smoke", sys.modules[__name__])
    t_all = time.time()
    phase0_card()
    phase1_build()
    if args.winograd_only or args.attention_bwd_only:
        t0 = time.time()
        g = torch.Generator(device=device).manual_seed(args.seed)
        if args.winograd_only:
            checks, wino_rows = phase2_winograd(device, g)
            emit(2, t0, checks=checks, timing_winograd=wino_rows)
        else:
            checks, bwd_row, bwd_long = phase2_backward(device, g)
            emit(2, t0, checks=checks, timing=[bwd_row], timing_t256=[bwd_long])
        print(json.dumps({"total_seconds": round(time.time() - t_all, 3)}), flush=True)
        return 0
    rows, year_fwd = phase2_kernels(device, args.seed)
    phase3_network(SNAPSHOT, device, seed=args.seed)
    blocks = phase3b_winograd_blocks(SNAPSHOT, device, seed=args.seed)
    main_path = phase4_slice(SNAPSHOT, CONFIG, device, seed=args.seed)
    training = phase5_training(device, seed=args.seed)
    phase6_predict(SNAPSHOT, device, seed=args.seed)
    phase7_tiny_training(device, seed=args.seed)
    t8 = time.time()
    year = phase8_year(SNAPSHOT, device, seed=args.seed)
    emit(8, t8, launches=year["launches"])
    # each kernel's launches on its own path: sampling for the forward (and
    # the year path's, at its own shape), training for the backward, the
    # ModResidualBlock composition for the Winograd conv
    rows["attention_fwd"]["launches"] = main_path["launches"]["attention_fwd"]
    rows["attention_fwd"]["year_path"] = {"launches": year["launches"], **{
        k: year_fwd[k] for k in ("shape", "max_abs_err", "ms", "graph_ms", "host_ms", "plain_ms", "bound_ms",
                                 "library_ms", "library_graph_ms")}}
    rows["attention_bwd"]["launches"] = training["launches"]["attention_bwd"]
    rows["winograd_conv3x3"]["launches"] = blocks["launches"]
    print(json.dumps({"total_seconds": round(time.time() - t_all, 3)}), flush=True)
    print(json.dumps({"kernels": list(rows.values())}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
