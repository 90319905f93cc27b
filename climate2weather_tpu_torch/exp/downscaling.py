"""Guided short-window downscaling on arrays (port of the short-trajectory
branch of climate2weather_tpu/exp/downscaling.py ``_run_impl``).

:func:`run_arrays` is the array core of ``_run_impl`` for a config whose
``observation_path`` equals its ``data_path``: the observation is the
coarsened ground truth ``A(gt)``. It is :func:`load_net` (snapshot to
ScoreUNet on the device) followed by :func:`sample_arrays`, which samples
``num_samples`` trajectories in groups of ``ensemble_batch`` (the JAX
``vmap`` written out as a batch dimension), each with DPM-Solver++(2M) under
detached Gaussian guidance, then applies the climatological calibration and
the t=0 projection. A caller downscaling several trajectories loads the net
once and calls :func:`sample_arrays` for each. The ``.nc``/``.h5`` readers
and writers and the long-trajectory samplers are not ported.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from climate2weather_tpu_torch.convert import load_params
from climate2weather_tpu_torch.diffusion.calibrate import (
    calibrate_trajectory,
    climatological_annulus_psd,
)
from climate2weather_tpu_torch.diffusion.guidance import (
    GaussianGuidance,
    SpatioTemporalCoarsening,
    per_channel,
)
from climate2weather_tpu_torch.diffusion.process import construct_process
from climate2weather_tpu_torch.diffusion.sampler import sample_dpmpp2m
from climate2weather_tpu_torch.diffusion.window import WindowScoreFn
from climate2weather_tpu_torch.io.snapshot import load_snapshot
from climate2weather_tpu_torch.models.score_net import build_score_unet
from climate2weather_tpu_torch.utils.device import resolve_device, set_reference_numerics
from climate2weather_tpu_torch.utils.seeding import derive_seed

_T0_METHODS = ("", "spectral", "block")


def _check_config(cfg: dict, L: int, calib_frames) -> None:
    """Reject, before any sampling, settings this slice does not run."""
    if cfg.get("observation_path") != cfg.get("data_path") or cfg.get("observation_path") is None:
        raise NotImplementedError(
            "run_arrays conditions on the coarsened ground truth "
            "(observation_path == data_path); other modes are not ported"
        )
    kind = cfg.get("sampler_kind", "pc")
    if kind != "dpmpp2m":
        raise NotImplementedError(f"sampler_kind {kind!r} is not ported (dpmpp2m only)")
    if cfg.get("use_exact_grad", False):
        raise NotImplementedError("use_exact_grad is not ported")
    if cfg.get("host_streaming", False) or L > int(cfg.get("long_trajectory_threshold", 512)):
        raise NotImplementedError("the long-trajectory and host-streaming samplers are not ported")
    if cfg.get("guidance_off", False):
        raise NotImplementedError("guidance_off is not ported")
    if str(cfg.get("t0_project", "") or "") not in _T0_METHODS:
        raise ValueError(f"t0_project must be one of {_T0_METHODS}, got {cfg['t0_project']!r}")
    if bool(cfg.get("spectral_calibrate")) != (calib_frames is not None):
        raise ValueError(
            "calib_frames (training frames [T, C, H, W]) must be given exactly "
            "when the config sets spectral_calibrate"
        )


def load_net(snapshot_dir: str, device="cuda", compute_dtype: torch.dtype = torch.bfloat16):
    """The snapshot's ScoreUNet on the device, in eval mode, and the
    snapshot's config dict: ``(net, snapshot_config)``."""
    dev = resolve_device(device)
    params, snap_config = load_snapshot(snapshot_dir)
    net = build_score_unet(snap_config["network_kwargs"], dtype=compute_dtype)
    load_params(net, params)
    return net.to(dev).eval(), snap_config


def run_arrays(
    snapshot_dir: str,
    cfg: dict,
    ground_truth_lhwc,
    calib_frames=None,
    device="cuda",
    *,
    compute_dtype: torch.dtype = torch.bfloat16,
    noise: Optional[np.ndarray] = None,
    z: Optional[np.ndarray] = None,
):
    """Downscale one trajectory: returns ``(samples, nan_flags)``, float32
    ``[num_samples, L, H, W, C]`` and bool ``[num_samples]`` numpy arrays.

    ``ground_truth_lhwc`` is the normalized trajectory ``[L, H, W, C]``;
    ``cfg`` the dict of a downscaling YAML (``io.snapshot.yaml_load_file``).
    Sample ``sid`` draws its initial noise and its per-step SDE noise from a
    generator seeded with ``derive_seed(seed, "sample", sid)``; tests inject
    both instead through ``noise`` ``[num_samples, L, H, W, C]`` and ``z``
    ``[num_samples, steps, L, H, W, C]``. The run is on the card unless
    ``device="cpu"``; ``compute_dtype`` is the network's (bf16 as in JAX).
    """
    _check_config(cfg, len(ground_truth_lhwc), calib_frames)  # before the snapshot load
    net, snap_config = load_net(snapshot_dir, device, compute_dtype)
    return sample_arrays(net, snap_config, cfg, ground_truth_lhwc, calib_frames, device,
                         noise=noise, z=z)


@torch.no_grad()
def sample_arrays(
    net: torch.nn.Module,
    snap_config: dict,
    cfg: dict,
    ground_truth_lhwc,
    calib_frames=None,
    device="cuda",
    *,
    noise: Optional[np.ndarray] = None,
    z: Optional[np.ndarray] = None,
):
    """:func:`run_arrays` with the net already loaded by :func:`load_net`."""
    dev = resolve_device(device)
    set_reference_numerics()
    gt = torch.as_tensor(np.asarray(ground_truth_lhwc, np.float32), device=dev)
    L, H, W, C = gt.shape
    _check_config(cfg, L, calib_frames)
    num_samples = int(cfg.get("num_samples", 1))
    steps = int(cfg.get("num_sampling_steps", 256))
    sde_eta = float(cfg.get("sde_eta", 0.0))
    s_step, t_step = int(cfg.get("s_step", 16)), int(cfg.get("t_step", 6))
    t0_project = str(cfg.get("t0_project", "") or "")
    seed = int(cfg.get("seed", 0))
    markov_order = int(snap_config["dataset_kwargs"]["train"]["window"]) // 2
    process = construct_process(**snap_config["pipeline_kwargs"])

    A = SpatioTemporalCoarsening(s_step=s_step, t_step=t_step)
    observation = A(gt)
    guidance = GaussianGuidance(
        A=A, y=observation,
        std=per_channel(cfg.get("likelihood_std", 1e-2), C, dev),
        gamma=per_channel(cfg.get("likelihood_gamma", 1e-2), C, dev),
        prolong=cfg.get("guidance_prolong", False),
        anneal=float(cfg.get("guidance_anneal", 0.0)),
    )
    calib_target = None
    if calib_frames is not None:
        calib_target = torch.as_tensor(climatological_annulus_psd(calib_frames, s_step=s_step), device=dev)

    score = WindowScoreFn(net, markov_order, chunk_size=int(cfg.get("batch_size", 16)))

    def score_fn(x, t):
        return guidance.guided_eps(score, process, x, t)

    eb = max(1, int(cfg.get("ensemble_batch", 1)))
    samples = np.empty((num_samples, L, H, W, C), np.float32)
    nan_flags = np.empty((num_samples,), bool)
    for start in range(0, num_samples, eb):
        sids = list(range(start, min(start + eb, num_samples)))
        if noise is not None:
            x_init = torch.as_tensor(np.asarray(noise[sids], np.float32), device=dev)
            gens = None
        else:
            gens = [
                torch.Generator(device=dev).manual_seed(derive_seed(seed, "sample", sid))
                for sid in sids
            ]
            x_init = torch.stack([torch.randn((L, H, W, C), generator=g, device=dev) for g in gens])
        zs = None
        if z is not None:
            zg = np.asarray(z[sids], np.float32)  # [members, steps, L, H, W, C]
            zs = [torch.as_tensor(zg[:, i], device=dev) for i in range(steps)]
        out, nan_flag = sample_dpmpp2m(
            process, score_fn, x_init, steps=steps, rng=gens, z=zs,
            denoise_final=bool(cfg.get("denoise_final", False)), sde_eta=sde_eta,
            batch_dims=1,
        )
        if calib_target is not None:
            out = calibrate_trajectory(out, calib_target, s_step)
        if t0_project:
            out = A.project(out, observation, iters=int(cfg.get("t0_project_iters", 3)),
                            method=t0_project)
        samples[sids] = out.float().cpu().numpy()
        nan_flags[sids] = nan_flag.cpu().numpy()
    return samples, nan_flags
