"""Guided downscaling (port of climate2weather_tpu/exp/downscaling.py ``run``
and ``_run_impl``, short and long trajectories).

:func:`run` is the ``predict`` entry point: it reads a YAML config, applies
overrides, makes the numbered save directory with ``config_freeze.yaml``,
loads the ground truth from ``data_path`` (normalized with the quantiles of
``quantile_path``), and writes ``ground_truth.nc``, ``observation.nc`` and
one ``gen_sample_NNN.nc`` per sample, de-normalized, as the JAX
``_run_impl`` writes them. It conditions in one of three modes: no
observation (``observation_path`` unset), the coarsened ground truth
(``observation_path == data_path``), or an external observation file.

:func:`run_arrays` and :func:`sample_arrays` are its array core:
:func:`load_net` (snapshot to ScoreUNet on the device) and the sampling of
``num_samples`` trajectories in groups of ``ensemble_batch`` (the JAX
``vmap`` written out as a batch dimension), with the PC sampler or
DPM-Solver++(2M) under detached Gaussian guidance (or none, with
``guidance_off``), then the climatological calibration and the t=0
projection. A caller downscaling several trajectories loads the net once and
calls :func:`sample_arrays` for each; :func:`iter_samples` yields the groups
one by one, and :func:`run` writes each sample as soon as it is done.

Trajectories longer than ``long_trajectory_threshold`` (512 frames) take the
long path, as in JAX: one sample at a time through
``diffusion/long_sampler.py`` (``ensemble_batch`` is ignored there), in
calls of 8 steps with a resume file ``.sample_resume_NNN.npz`` in the save
directory every ``sample_resume_every`` calls, DPM-Solver++(2M)'s trajectory
in bf16 above 4000 frames, and the calibration and projection run in time
chunks on the card (``calibrate.postprocess_long``) before the host copy.

Not ported, and refused before any sampling: the host-streaming sampler,
exact-gradient guidance and DPM-Solver++(3M).
"""

from __future__ import annotations

import os
import pathlib
import time
from datetime import datetime
from typing import Optional

import numpy as np
import torch

from climate2weather_tpu_torch.convert import load_params
from climate2weather_tpu_torch.data import pipeline as data_pipeline
from climate2weather_tpu_torch.diffusion.calibrate import (
    calibrate_trajectory,
    climatological_annulus_psd,
    postprocess_long,
)
from climate2weather_tpu_torch.diffusion.guidance import (
    GaussianGuidance,
    SpatioTemporalCoarsening,
    per_channel,
)
from climate2weather_tpu_torch.diffusion.long_sampler import sample_dpmpp2m_long, sample_guided_long
from climate2weather_tpu_torch.diffusion.process import construct_process
from climate2weather_tpu_torch.diffusion.sampler import sample, sample_dpmpp2m
from climate2weather_tpu_torch.diffusion.window import WindowScoreFn
from climate2weather_tpu_torch.io.snapshot import load_snapshot, yaml_dump_file, yaml_load_file
from climate2weather_tpu_torch.models.score_net import build_score_unet
from climate2weather_tpu_torch.utils.device import resolve_device, set_reference_numerics
from climate2weather_tpu_torch.utils.seeding import derive_seed

_T0_METHODS = ("", "spectral", "block")
_SAMPLERS = ("pc", "dpmpp2m")
# the long path: steps per sampler call, and the length above which
# DPM-Solver++(2M) keeps its trajectory buffers in bf16 (JAX _run_impl)
_STEPS_PER_CALL = 8
_BF16_TRAJECTORY_ABOVE = 4000


def _check_config(cfg: dict, L: int, calib_frames, observation_given: bool = False) -> None:
    """Reject, before any sampling, settings this port does not run."""
    obs_path = cfg.get("observation_path")
    if obs_path is not None and obs_path != cfg.get("data_path") and not observation_given:
        raise NotImplementedError(
            "an external observation file is read by exp.downscaling.run; the array "
            "entry points take it as the normalized `observation` array"
        )
    kind = cfg.get("sampler_kind", "pc")
    if kind not in _SAMPLERS:
        raise NotImplementedError(f"sampler_kind {kind!r} is not ported ({', '.join(_SAMPLERS)})")
    if cfg.get("sde_eta", 0.0) and kind != "dpmpp2m":
        raise ValueError(f"sde_eta applies to sampler_kind dpmpp2m only (got {kind!r})")
    if cfg.get("use_exact_grad", False):
        raise NotImplementedError("use_exact_grad is not ported")
    if cfg.get("host_streaming", False):
        raise NotImplementedError("the host-streaming sampler is not ported (the long-trajectory one is)")
    if str(cfg.get("t0_project", "") or "") not in _T0_METHODS:
        raise ValueError(f"t0_project must be one of {_T0_METHODS}, got {cfg['t0_project']!r}")
    if bool(cfg.get("spectral_calibrate")) != (calib_frames is not None):
        raise ValueError(
            "calib_frames (training frames [T, C, H, W], or the training h5's path) must be "
            "given exactly when the config sets spectral_calibrate"
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
    observation=None,
    noise: Optional[np.ndarray] = None,
    z: Optional[np.ndarray] = None,
    stats: Optional[dict] = None,
):
    """Downscale one trajectory: returns ``(samples, nan_flags)``, float32
    ``[num_samples, L, H, W, C]`` and bool ``[num_samples]`` numpy arrays.

    ``ground_truth_lhwc`` is the normalized trajectory ``[L, H, W, C]``;
    ``cfg`` the dict of a downscaling YAML (``io.snapshot.yaml_load_file``).
    ``observation`` is the normalized external observation ``[Lo, h, w, C]``
    when the config's ``observation_path`` names another file than its
    ``data_path``. Sample ``sid`` draws its initial noise and its per-step
    noise from a generator seeded with ``derive_seed(seed, "sample", sid)``;
    tests inject both instead through ``noise`` ``[num_samples, L, H, W, C]``
    and ``z`` ``[num_samples, draws, L, H, W, C]`` (one draw per step for
    DPM-Solver++(2M) with ``sde_eta > 0``, one per corrector step for PC;
    on the long path each frame chunk takes its frames of the draw).
    The run is on the card unless ``device="cpu"``; ``compute_dtype`` is the
    network's (bf16 as in JAX). ``stats`` as for :func:`iter_samples`.
    """
    # before the snapshot load
    _check_config(cfg, len(ground_truth_lhwc), calib_frames, observation is not None)
    net, snap_config = load_net(snapshot_dir, device, compute_dtype)
    return sample_arrays(net, snap_config, cfg, ground_truth_lhwc, calib_frames, device,
                         observation=observation, noise=noise, z=z, stats=stats)


def sample_arrays(
    net: torch.nn.Module,
    snap_config: dict,
    cfg: dict,
    ground_truth_lhwc,
    calib_frames=None,
    device="cuda",
    *,
    observation=None,
    noise: Optional[np.ndarray] = None,
    z: Optional[np.ndarray] = None,
    resume_dir: Optional[str] = None,
    stats: Optional[dict] = None,
):
    """:func:`run_arrays` with the net already loaded by :func:`load_net`;
    ``resume_dir`` and ``stats`` as for :func:`iter_samples`."""
    L, H, W, C = np.shape(ground_truth_lhwc)
    num_samples = int(cfg.get("num_samples", 1))
    samples = np.empty((num_samples, L, H, W, C), np.float32)
    nan_flags = np.empty((num_samples,), bool)
    for sids, out, flags in iter_samples(net, snap_config, cfg, ground_truth_lhwc, calib_frames, device,
                                         observation=observation, noise=noise, z=z,
                                         resume_dir=resume_dir, stats=stats):
        samples[sids], nan_flags[sids] = out, flags
    return samples, nan_flags


@torch.no_grad()
def iter_samples(
    net: torch.nn.Module,
    snap_config: dict,
    cfg: dict,
    ground_truth_lhwc,
    calib_frames=None,
    device="cuda",
    *,
    observation=None,
    noise: Optional[np.ndarray] = None,
    z: Optional[np.ndarray] = None,
    resume_dir: Optional[str] = None,
    stats: Optional[dict] = None,
):
    """Yield ``(sample ids, samples, nan_flags)`` for each group as it is
    done: float32 ``[n, L, H, W, C]`` and bool ``[n]`` numpy arrays,
    post-processed. On the long path a group is one sample, and with
    ``sample_resume_every > 0`` in ``cfg`` its resume file lives in
    ``resume_dir``. ``stats``, a dict, gets ``long_path`` and
    ``traj_dtype``."""
    dev = resolve_device(device)
    set_reference_numerics()
    gt = torch.as_tensor(np.asarray(ground_truth_lhwc, np.float32), device=dev)
    L, H, W, C = gt.shape
    _check_config(cfg, L, calib_frames, observation is not None)
    num_samples = int(cfg.get("num_samples", 1))
    steps = int(cfg.get("num_sampling_steps", 256))
    s_step, t_step = int(cfg.get("s_step", 16)), int(cfg.get("t_step", 6))
    t0_project = str(cfg.get("t0_project", "") or "")
    seed = int(cfg.get("seed", 0))
    markov_order = int(snap_config["dataset_kwargs"]["train"]["window"]) // 2
    process = construct_process(**snap_config["pipeline_kwargs"])
    use_long = L > int(cfg.get("long_trajectory_threshold", 512))
    kind = cfg.get("sampler_kind", "pc")
    traj_dtype = torch.bfloat16 if use_long and kind == "dpmpp2m" and L > _BF16_TRAJECTORY_ABOVE else None
    if stats is not None:
        stats.update(long_path=use_long, traj_dtype=str(traj_dtype or torch.float32))

    A = SpatioTemporalCoarsening(s_step=s_step, t_step=t_step)
    obs_path = cfg.get("observation_path")
    if obs_path is None:
        y = None
    elif obs_path == cfg.get("data_path"):
        y = A(gt)
    else:
        y = torch.as_tensor(np.asarray(observation, np.float32), device=dev)
    calib_target = None
    if calib_frames is not None:
        calib_target = torch.as_tensor(climatological_annulus_psd(calib_frames, s_step=s_step),
                                       device=dev)

    score = WindowScoreFn(net, markov_order, chunk_size=int(cfg.get("batch_size", 16)))
    guidance = None
    if y is not None and not cfg.get("guidance_off", False):
        guidance = GaussianGuidance(
            A=A, y=y,
            std=per_channel(cfg.get("likelihood_std", 1e-2), C, dev),
            gamma=per_channel(cfg.get("likelihood_gamma", 1e-2), C, dev),
            prolong=cfg.get("guidance_prolong", False),
            anneal=float(cfg.get("guidance_anneal", 0.0)),
        )

    def score_fn(x, t):
        return score(x, t) if guidance is None else guidance.guided_eps(score, process, x, t)

    denoise_final = bool(cfg.get("denoise_final", False))
    resume_every = int(cfg.get("sample_resume_every", 0))
    if kind == "pc":
        corrections = int(cfg.get("num_corrections", 2))
        n_draws = steps * corrections
        pc = dict(steps=steps, corrections=corrections, tau=float(cfg.get("correction_tau", 0.5)),
                  corrector_variance_exact=bool(cfg.get("corrector_variance_exact", False)),
                  denoise_final=denoise_final)

        def run_sampler(x_init, gens, zs, sid):
            if use_long:
                return sample_guided_long(process, score, x_init, guidance=guidance, rng=gens, z=zs,
                                          **pc, **long_kw(sid))
            return sample(process, score_fn, x_init, rng=gens, z=zs, batch_dims=1, **pc)
    else:
        sde_eta = float(cfg.get("sde_eta", 0.0))
        n_draws = steps if sde_eta > 0 else 0

        def run_sampler(x_init, gens, zs, sid):
            if use_long:
                return sample_dpmpp2m_long(process, score, x_init, guidance=guidance, steps=steps,
                                           rng=gens, z=zs, traj_dtype=traj_dtype,
                                           denoise_final=denoise_final, sde_eta=sde_eta, **long_kw(sid))
            return sample_dpmpp2m(process, score_fn, x_init, steps=steps, rng=gens, z=zs,
                                  denoise_final=denoise_final, sde_eta=sde_eta, batch_dims=1)

    def long_kw(sid):
        kw = dict(steps_per_call=_STEPS_PER_CALL, verbose=True)
        if resume_dir is not None and resume_every > 0:
            kw.update(resume_path=os.path.join(resume_dir, f".sample_resume_{sid:03d}.npz"),
                      resume_every=resume_every)
        return kw

    def postprocess(out):
        if use_long:
            return postprocess_long(out, calib_target, s_step, y if t0_project else None, t_step,
                                    t0_project, int(cfg.get("t0_project_iters", 3)))
        if calib_target is not None:
            out = calibrate_trajectory(out, calib_target, s_step)
        if y is not None and t0_project:
            out = A.project(out, y, iters=int(cfg.get("t0_project_iters", 3)), method=t0_project)
        return out

    # the long path runs one sample at a time, as in JAX
    eb = 1 if use_long else max(1, int(cfg.get("ensemble_batch", 1)))
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
        if z is not None and n_draws:
            zg = np.asarray(z[sids], np.float32)  # [members, draws, L, H, W, C]
            zs = [torch.as_tensor(zg[:, i], device=dev) for i in range(n_draws)]
        if use_long:  # one sample, without the group dimension
            x_init = x_init[0].to(traj_dtype or x_init.dtype)  # a bf16 run keeps no fp32 draw
            out, nan_flag = run_sampler(x_init, gens[0] if gens else None,
                                        [zi[0] for zi in zs] if zs else None, sids[0])
            out, nan_flag = postprocess(out)[None], nan_flag[None]
        else:
            out, nan_flag = run_sampler(x_init, gens, zs, sids[0])
            out = postprocess(out)
        yield sids, out.float().cpu().numpy(), nan_flag.cpu().numpy()


# ---------------------------------------------------------------------------
# the predict entry point, from files


def run(save_path: str, config_path: str, device="cuda", *, compute_dtype: torch.dtype = torch.bfloat16,
        noise: Optional[np.ndarray] = None, z: Optional[np.ndarray] = None,
        stats: Optional[dict] = None, **kwargs) -> pathlib.Path:
    """Load a YAML experiment config, apply the overrides ``kwargs`` (None
    values are ignored), create the numbered save directory
    ``<save_path>/NNN_<config stem>`` with ``config_freeze.yaml``, and run;
    returns the directory. ``device``, ``compute_dtype``, ``noise`` and
    ``z`` as for :func:`run_arrays`. ``stats``, a dict, gets the seconds of
    the run's parts on the host clock (``input_s``: reading the inputs and
    writing ``ground_truth.nc`` and ``observation.nc``; ``load_net_s``;
    ``sampling_s``, to each group's host copy; ``write_s``: the samples'
    files) and :func:`iter_samples`' keys."""
    config_path = pathlib.Path(config_path)
    save_path = pathlib.Path(save_path)
    subdir_i = len([s for s in save_path.iterdir() if s.is_dir()]) + 1 if save_path.exists() else 1
    save_path = save_path / f"{subdir_i:03d}_{config_path.stem}"
    if not (config_path.exists() and config_path.suffix.lower() in (".yaml", ".yml")):
        raise FileNotFoundError(f"Config file not found: {config_path}")
    config = yaml_load_file(config_path)
    for k, v in kwargs.items():
        if v is None:
            continue
        if k in config:
            print(f">>> CONFIG: Overwriting value for {k}: {config[k]} -> {v}")
        else:
            print(f">>> CONFIG: Setting {k} = {v}")
        config[k] = v
    save_path.mkdir(parents=True, exist_ok=False)
    yaml_dump_file(config, save_path / "config_freeze.yaml")
    _run_impl(save_path, config, device, compute_dtype=compute_dtype, noise=noise, z=z,
              stats={} if stats is None else stats)
    print("Done. \n")
    return save_path


_REQUIRED = ("model_path", "data_path", "quantile_path", "start_time", "num_hours", "data_norm_mode")


def _run_impl(save_path: pathlib.Path, cfg: dict, device, *, compute_dtype, noise, z, stats) -> pathlib.Path:
    missing = [k for k in _REQUIRED if k not in cfg]
    if missing:
        raise TypeError(f"config lacks {missing}")
    data_vars = sorted(cfg.get("data_vars", ("psl", "tas", "uas", "vas")))
    data_path, quantile_path = cfg["data_path"], cfg["quantile_path"]
    norm_mode, obs_path = cfg["data_norm_mode"], cfg.get("observation_path")
    start_time, num_hours = str(cfg["start_time"]), int(cfg["num_hours"])
    s_step, t_step = int(cfg.get("s_step", 16)), int(cfg.get("t_step", 6))
    calib = cfg.get("spectral_calibrate") or None
    print(f"STARTING DOWNSCALING AT {datetime.now().strftime('%Y-%m-%d_%H%M%S')} >>>")
    print(f"Saving results to {save_path}")

    t_input = time.time()
    unnormed = data_pipeline.load_processed(data_path, data_vars, start_time, num_hours)
    L = len(unnormed.time)
    # every refusal before any output beyond config_freeze.yaml, and before sampling
    _check_config(cfg, L, calib, observation_given=True)
    dev = resolve_device(device)
    unnormed.to_file(os.path.join(save_path, "ground_truth.nc"))
    cosmo = data_pipeline.normalize_ds(unnormed, quantile_path, norm_mode)
    gt = data_pipeline.nchw_to_nhwc(data_pipeline.ds_to_sorted_np(cosmo, data_vars))  # [L, H, W, C]

    observation, observation_ds = None, None
    if obs_path is None:
        print("No observation provided. Sampling without conditioning.")
    elif obs_path == data_path:
        print(f"Conditioning on observations of the ground truth at {obs_path}")
        observation_ds = cosmo.coarsen_mean(s_step).isel_time(np.arange(0, min(num_hours, L), t_step))
    else:
        print(f"Conditioning on provided observation at {obs_path}")
        observation_ds = data_pipeline.normalize_ds(
            data_pipeline.load_processed(obs_path, data_vars, start_time, num_hours),
            quantile_path, norm_mode)
        observation = data_pipeline.nchw_to_nhwc(data_pipeline.ds_to_sorted_np(observation_ds, data_vars))
    if observation_ds is not None:
        data_pipeline.unnormalize_ds(observation_ds, quantile_path, norm_mode).to_file(
            os.path.join(save_path, "observation.nc"))
    if obs_path is not None and cfg.get("guidance_off", False):
        print("Likelihood guidance OFF (observation kept for the t=0 projection).")

    t_net = time.time()
    net, snap_config = load_net(cfg["model_path"], dev, compute_dtype)
    window = int(snap_config["dataset_kwargs"]["train"]["window"])
    print(f"Loaded score network from {cfg['model_path']} (window {window}, order {window // 2})")
    print("Starting sampling...")
    t_group = time.time()
    stats.update(input_s=t_net - t_input, load_net_s=t_group - t_net, sampling_s=0.0, write_s=0.0)
    for sids, gens, nan_flags in iter_samples(net, snap_config, cfg, gt, calib, dev, observation=observation,
                                              noise=noise, z=z, resume_dir=str(save_path), stats=stats):
        t_write = time.time()
        stats["sampling_s"] += t_write - t_group
        total = t_write - t_group
        print(f"Total sampling time: {total:.2f} s = {total / 60:.3f} min = {total / 3600:.4f} h")
        for sid, g, is_nan in zip(sids, gens, nan_flags):
            if is_nan:  # write the group's finite samples first, then fail loudly
                continue
            sample_ds = data_pipeline.np_to_ds(data_pipeline.nhwc_to_nchw(g), reference_ds=cosmo,
                                               data_vars=data_vars)
            sample_ds = data_pipeline.unnormalize_ds(sample_ds, quantile_path, norm_mode)
            sample_ds.to_file(str(save_path / f"gen_sample_{sid:03d}.nc"))
        t_group = time.time()
        stats["write_s"] += t_group - t_write
        if nan_flags.any():
            raise FloatingPointError(f"NaN detected in sample(s) {[s for s, n in zip(sids, nan_flags) if n]}")
    print(f"Saved results to {save_path}")
    return save_path
