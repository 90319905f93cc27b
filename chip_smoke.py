"""Drive climate2weather_tpu_torch on one NVIDIA card and check it.

    python3 chip_smoke.py [--seed N]

Numbered phases, each printing one JSON line with its seconds:

0. the card (``nvidia-smi`` name and power limit) and the toolchain;
1. build of every CUDA kernel from ``climate2weather_tpu_torch/csrc``;
2. each kernel against its plain PyTorch version at the main path's shapes,
   a small ragged one and the longest sequence it takes, with times of the kernel, the plain version and
   one PyTorch library call (``library_ms``), beside the least time the card
   could take (``bound_ms``);
3. the 72.1M-parameter snapshot in ``artifacts/`` loaded through the port's
   own readers, one forward at [96, 128, 128, 52] with the kernel: each of its
   6 attention launches held against the plain version on the same inputs
   within one bf16 ulp (an attention that drops a key must fail that), and
   the forward against one with the plain attention, within what moving
   every attention output by one bf16 ulp does to it;
4. the main path: ``run_arrays`` at the settings of
   ``exp/configs/000_on-model-eval/s16_t6_spectral.yml`` (``num_samples``
   cut to 3, one ensemble group) on a synthetic 49-hour 128 x 128 trajectory,
   as its two steps ``load_net`` and ``sample_arrays`` timed apart, checked
   for finite samples, A(x) = y at the observed frames, and a kernel launch
   count of 6 per UNet forward.

Then one ``{"kernels": [...]}`` line and, last, the device line
``{"ok": true, "device": {...}}``. Any failure raises and exits non-zero.
There is no CPU mode: without a card the script exits non-zero at once.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys
import time

import numpy as np
import torch

REPO = pathlib.Path(__file__).resolve().parent
SNAPSHOT = REPO / "artifacts" / "network-snapshot-0009437-0.999900"
CONFIG = REPO / "exp" / "configs" / "000_on-model-eval" / "s16_t6_spectral.yml"

# H100 SXM peaks (NVIDIA data sheet, dense): bytes/s of HBM3, bf16 tensor FLOP/s
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12
MAIN_SHAPE = (96, 64, 512)  # windows per call x tokens x channels at level 4


def emit(phase, t0, **fields):
    print(json.dumps({"phase": phase, "seconds": round(time.time() - t0, 3), **fields}), flush=True)


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
    from climate2weather_tpu_torch.ops import attention, build

    attention.build_kernel()
    ptxas = [ln.strip() for ln in build.build_logs.get("attention_fwd.cu", "").splitlines()
             if "registers" in ln or "smem" in ln]
    emit(1, t0, built=["attention_fwd"], ptxas=ptxas)


def phase2_kernels(device: torch.device, seed: int) -> dict:
    """The kernel against its plain version; returns the main-shape row."""
    from climate2weather_tpu_torch.ops.attention import attention_reference, fused_attention

    t0 = time.time()
    g = torch.Generator(device=device).manual_seed(seed)
    checks = []
    row = None
    for shape in (MAIN_SHAPE, (3, 16, 40), (2, 128, 64)):  # main, ragged, longest T
        for dtype in (torch.float32, torch.bfloat16):
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
            if shape == MAIN_SHAPE and dtype == torch.bfloat16:
                s = c ** (-0.25)
                qs, ks = (q * s).contiguous(), (k * s).contiguous()
                vc = v.contiguous()
                ms = cuda_time_ms(lambda: fused_attention(q, k, v))
                plain_ms = cuda_time_ms(lambda: attention_reference(q, k, v))
                library_ms = cuda_time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
                    qs, ks, vc, scale=1.0))
                nbytes = 4 * b * t * c * q.element_size()  # q, k, v read, o written
                flops = 4 * b * t * t * c  # QK^T and PV
                t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS
                row = {
                    "name": "attention_fwd", "route": "cuda",
                    "source": "climate2weather_tpu_torch/csrc/attention_fwd.cu",
                    "replaces": "climate2weather_tpu/ops/attention.py:71",
                    "launches": None, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                    "bound_ms": 1e3 * max(t_bytes, t_ops),
                    "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                    "library_ms": library_ms,
                }
    emit(2, t0, checks=checks, timing=row)
    return row


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
                per_call.append({"max_abs_err": err, "tol": tol, "key_dropped_err": fault})
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
            # each launch is within one ulp of the plain version (above), so
            # the forward may differ from the plain one by at most what moving
            # every attention output one ulp does, in max and in mean. A
            # dropped key moves the bf16 output about as much, so the
            # per-launch check above is the one that sees such a fault.
            tol, tol_mean = ulp_max, ulp_mean
            result.update(per_call=per_call, max_abs_err=err, mean_abs_err=err_mean,
                          out_scale=float(plain.abs().max()), tol=tol, tol_mean=tol_mean,
                          one_ulp_max=ulp_max, one_ulp_mean=ulp_mean,
                          key_dropped_max=fault_max, key_dropped_mean=fault_mean)
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
    y = A(torch.from_numpy(gt))
    consistency = float((A(torch.from_numpy(samples)) - y).abs().max())
    x_max = float(np.abs(samples).max())
    # fp32 round-off of the FFT passes, relative to both fields' magnitudes
    tol = 1e-4 * max(1.0, float(y.abs().max())) + 1e-6 * x_max
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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script runs on the card only",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    from climate2weather_tpu_torch.utils.device import set_reference_numerics

    set_reference_numerics()
    device = torch.device("cuda", 0)
    t_all = time.time()
    phase0_card()
    phase1_build()
    row = phase2_kernels(device, args.seed)
    phase3_network(SNAPSHOT, device, seed=args.seed)
    main_path = phase4_slice(SNAPSHOT, CONFIG, device, seed=args.seed)
    row["launches"] = main_path["launches"]["attention_fwd"]
    print(json.dumps({"total_seconds": round(time.time() - t_all, 3)}), flush=True)
    print(json.dumps({"kernels": [row]}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
