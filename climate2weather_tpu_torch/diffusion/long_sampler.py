"""Guided sampling of long trajectories (port of
climate2weather_tpu/diffusion/long_sampler.py): the year path.

A year of hourly fields is [8737, 128, 128, 4], 2.3 GB in fp32. The samplers
here keep a few trajectory-sized buffers on the device whatever the length,
and follow the JAX long samplers' arithmetic:

- **window pass**: eps over the Markov windows through the chunked
  :class:`~climate2weather_tpu_torch.diffusion.window.WindowScoreFn`, into
  one buffer in the trajectory's dtype;
- **guidance in observation space**: the observation operator A (block mean
  after ``::t_step``) is linear, so the likelihood error uses
  A(x0) = (A(x) - sigma A(eps)) / mu, computed in fp32 on the observed
  frames only;
- **frame-chunked updates**: guided eps, the x0 prediction and the step
  rule applied in chunks of ``frame_chunk`` frames, the last chunk shifted
  back to end at the last frame, into fresh output buffers; the Langevin
  corrector's step size sums its squares chunk by chunk.

Unlike the TPU package the trajectory stays NHWC ``[L, H, W, C]``: the card
does not pad a minor dimension of 4 channels, so the NCHW layout that JAX
took for that reason buys nothing here. With ``traj_dtype=torch.bfloat16``
every trajectory buffer is bf16 while the schedule and the guidance stay
fp32.

The schedule runs in Python loops of ``steps_per_call`` steps. Between two
such calls the NaN flag is read (a poisoned run stops early) and, with
``resume_path``, the sampler's state is written there every ``resume_every``
calls: the trajectory buffers, the step index, the multistep carry and the
noise generator's state, so that a resumed run equals an uninterrupted one.
The file is removed when the run ends.

Not ported: exact-gradient guidance and DPM-Solver++(3M) (``order=3``), which
no shipped config uses (ROADMAP queue A 5), and ``proc_x0``, which no caller
of the JAX long samplers passes.
"""

from __future__ import annotations

import hashlib
import os
import zipfile
from typing import Optional, Sequence

import numpy as np
import torch

from climate2weather_tpu_torch.diffusion import steprules
from climate2weather_tpu_torch.diffusion.guidance import GaussianGuidance, check_observation_shape
from climate2weather_tpu_torch.diffusion.sampler import logsnr_time_grid
from climate2weather_tpu_torch.diffusion.window import WindowScoreFn


def _in_dtype(value, dtype: torch.dtype) -> float:
    """An fp32 schedule scalar rounded to the trajectory's dtype, as JAX's
    ``.astype(x.dtype)`` rounds it before the step arithmetic."""
    return float(torch.as_tensor(value, dtype=torch.float32).to(dtype))


def coarsen(A, x: torch.Tensor) -> torch.Tensor:
    """A(x) of a trajectory [L, H, W, C] as fp32 [Lo, h, w, C]: the observed
    frames gathered first, their block mean rounded to ``x``'s dtype (as
    ``jnp.mean`` of a bf16 array rounds it), then widened."""
    obs = x[:: A.t_step].float()
    lo, H, W, C = obs.shape
    s = A.s_step
    return obs.reshape(lo, H // s, s, W // s, s, C).mean(dim=(2, 4)).to(x.dtype).float()


def obs_error(guidance: GaussianGuidance, process, x: torch.Tensor, eps: torch.Tensor, t) -> torch.Tensor:
    """(y - A(x0)) / var in observation space, fp32 [Lo, h, w, C], with
    A(x0) = (A(x) - sigma A(eps)) / mu by linearity."""
    mu, sigma = process.mu(t), process.sigma(t)
    a_x0 = (coarsen(guidance.A, x) - float(sigma) * coarsen(guidance.A, eps)) / float(mu)
    std = torch.as_tensor(guidance.std, dtype=torch.float32, device=x.device)
    gamma = torch.as_tensor(guidance.gamma, dtype=torch.float32, device=x.device)
    var = std**2 + gamma * float((sigma / mu) ** 2)
    return (guidance.y.float() - a_x0) / var


def guided_eps_chunk(guidance: Optional[GaussianGuidance], process, eps_chunk: torch.Tensor,
                     err: Optional[torch.Tensor], f0: int, t) -> torch.Tensor:
    """eps - w sigma A^T(err) / mu on the frames [f0, f0 + F) of the
    trajectory: the adjoint (or, with ``guidance.prolong``, the spectral
    prolongation) of the observation-space error, nonzero at observed frames
    only, computed in fp32 and cast to eps's dtype. ``eps_chunk`` is left
    as it is."""
    if guidance is None or err is None:
        return eps_chunk
    A = guidance.A
    ts = A.t_step
    first = (-f0) % ts  # the chunk's first observed frame
    rows = torch.arange(first, eps_chunk.shape[0], ts, device=eps_chunk.device)
    if rows.numel() == 0:
        return eps_chunk
    err_rows = err[torch.clamp((f0 + rows) // ts, max=err.shape[0] - 1)]
    if guidance.prolong:
        method = guidance.prolong if isinstance(guidance.prolong, str) else "spectral"
        up = A.prolong_spatial(err_rows, method)
    else:
        up = A.adjoint_spatial(err_rows)
    weight = guidance.anneal_weight(t) * float(process.sigma(t))
    out = eps_chunk.clone()
    out[rows] -= (weight * (up / float(process.mu(t)))).to(out.dtype)
    return out


def _frame_chunks(L: int, F: int):
    """(chunk index, first frame) of each frame chunk; the last shifted back."""
    return [(ci, min(ci * F, L - F)) for ci in range(-(-L // F))]


def _nan(x: torch.Tensor) -> torch.Tensor:
    return ~torch.isfinite(x).all()


def _resume(resume_path, resume_every, kind: tuple, score: WindowScoreFn, guidance, noise: torch.Tensor,
            F: int):
    """``(path, every, digest)`` for :func:`_stepwise_drive`, or None without
    a path. The digest keys the file to the sampler's settings, the
    trajectory's shape and dtype, and fingerprints of the initial noise and
    the observation, so that a file of another run is never resumed."""
    if not resume_path:
        return None
    parts = kind + (tuple(noise.shape), str(noise.dtype), F, score.markov_order, score.chunk_size,
                    float(noise.sum(dtype=torch.float64)))
    if guidance is not None:
        parts += (guidance.A.s_step, guidance.A.t_step, str(guidance.prolong), float(guidance.anneal),
                  tuple(guidance.y.shape), float(guidance.y.sum(dtype=torch.float64)),
                  repr(np.asarray(torch.as_tensor(guidance.std).cpu()).tolist()),
                  repr(np.asarray(torch.as_tensor(guidance.gamma).cpu()).tolist()))
    return resume_path, int(resume_every), hashlib.sha256(repr(parts).encode()).hexdigest()


def _save_carry(path: str, state: dict, step: int, digest: str, rng: Optional[torch.Generator]) -> None:
    """Write the sampler's state atomically (a temporary file, then
    ``os.replace``): each tensor of ``state`` (bf16 as a uint16 view; .npy has
    no bf16) with its dtype, the step index, the digest and the generator's
    state."""
    payload = {"step": np.int64(step), "digest": np.str_(digest),
               "names": np.asarray(sorted(state)),
               "dtypes": np.asarray([str(state[k].dtype) for k in sorted(state)])}
    for j, name in enumerate(sorted(state)):
        v = state[name].detach()
        if v.dtype == torch.bfloat16:
            v = v.view(torch.int16)
        payload[f"a{j}"] = v.cpu().numpy()
    if rng is not None:
        payload["rng_state"] = rng.get_state().numpy()
    tmp = path + ".tmp.npz"
    np.savez(tmp, **payload)
    os.replace(tmp, path)


def _load_carry(path: str, init: dict, digest: str, rng: Optional[torch.Generator]):
    """``(state, step)`` from a file of :func:`_save_carry`, or ``(init, 0)``
    when there is none or it does not fit (another digest, names, shapes or
    dtypes, or a file that cannot be read): a resume is never less safe than
    a fresh start."""
    if not os.path.exists(path):
        return init, 0
    try:
        with np.load(path, allow_pickle=False) as z:
            names = [str(n) for n in z["names"]]
            if str(z["digest"]) != digest or names != sorted(init) or ("rng_state" in z) != (rng is not None):
                return init, 0
            state = {}
            for j, (name, dt) in enumerate(zip(names, (str(d) for d in z["dtypes"]))):
                ref = init[name]
                raw = torch.from_numpy(np.array(z[f"a{j}"]))
                if dt == "torch.bfloat16":
                    raw = raw.view(torch.bfloat16)
                if raw.dtype != ref.dtype or raw.shape != ref.shape:
                    return init, 0
                state[name] = raw.to(ref.device)
            if rng is not None:
                rng.set_state(torch.from_numpy(np.array(z["rng_state"])))
            return state, int(z["step"])
    except (OSError, ValueError, KeyError, RuntimeError, zipfile.BadZipFile) as e:
        print(f"sampling: ignoring unreadable resume file {path} ({e})", flush=True)
        return init, 0


def _stepwise_drive(step, state: dict, n_steps: int, steps_per_call: Optional[int], verbose: bool,
                    ckpt=None, rng: Optional[torch.Generator] = None) -> dict:
    """Run ``state = step(state, i)`` for i < ``n_steps`` in calls of
    ``steps_per_call`` steps (all at once when None). Between calls the NaN
    flag is read and a flagged run stops; with ``ckpt = (path, every,
    digest)`` the state is resumed from ``path`` when the file fits, written
    there every ``every`` calls but after the last, and removed at the end."""
    i = calls = 0
    if ckpt is not None:
        path, every, digest = ckpt
        state, i = _load_carry(path, state, digest, rng)
        if i and verbose:
            print(f"sampling: resumed at step {i}/{n_steps}", flush=True)
    k = steps_per_call or n_steps
    while i < n_steps:
        j = min(i + k, n_steps)
        for s in range(i, j):
            state = step(state, s)
        i, calls = j, calls + 1
        if verbose:
            print(f"sampling: step {i}/{n_steps}", flush=True)
        if bool(state["nan"]):
            break
        if ckpt is not None and i < n_steps and calls % every == 0:
            _save_carry(path, state, i, digest, rng)
    if ckpt is not None and os.path.exists(ckpt[0]):
        os.remove(ckpt[0])
    return state


def _guided_eps_and_err(score: WindowScoreFn, guidance, process, x: torch.Tensor, t):
    """eps over the windows and, under guidance, the observation-space error."""
    eps = score(x, t)
    return eps, (obs_error(guidance, process, x, eps, t) if guidance is not None else None)


def _final_denoise(score, guidance, process, x: torch.Tensor, F: int) -> torch.Tensor:
    """The guided posterior mean at t = 0, chunked over frames."""
    eps, err = _guided_eps_and_err(score, guidance, process, x, 0.0)
    mu, sigma = _in_dtype(process.mu(0.0), x.dtype), _in_dtype(process.sigma(0.0), x.dtype)
    out = torch.empty_like(x)
    for _, f0 in _frame_chunks(x.shape[0], F):
        sl = slice(f0, f0 + F)
        eg = guided_eps_chunk(guidance, process, eps[sl], err, f0, 0.0)
        out[sl] = steprules.predict_x0(x[sl], eg, mu, sigma)
    return out


def _draw(z, draw: int, sl: slice, shape, rng, x: torch.Tensor) -> torch.Tensor:
    """The standard normal of one frame chunk: injected (``z[draw]``, a
    whole trajectory) or drawn from ``rng``, in the trajectory's dtype."""
    if z is not None:
        return torch.as_tensor(z[draw][sl]).to(device=x.device, dtype=x.dtype)
    return torch.randn(shape, generator=rng, device=x.device).to(x.dtype)


@torch.no_grad()
def sample_guided_long(
    process,
    score: WindowScoreFn,
    noise: torch.Tensor,
    *,
    guidance: Optional[GaussianGuidance] = None,
    steps: int = 64,
    corrections: int = 0,
    tau: float = 1.0,
    corrector_variance_exact: bool = False,
    rng: Optional[torch.Generator] = None,
    z: Optional[Sequence] = None,
    frame_chunk: int = 256,
    steps_per_call: Optional[int] = None,
    verbose: bool = False,
    denoise_final: bool = False,
    resume_path: Optional[str] = None,
    resume_every: int = 8,
):
    """Guided predictor-corrector sampling of ``noise`` [L, H, W, C]: at
    each of ``steps`` uniform times a DDIM predictor, then ``corrections``
    Langevin steps with delta = tau / mean(guided eps^2). The corrector
    noise of each frame chunk comes from ``rng``, or, for tests, from ``z``
    (``steps * corrections`` trajectories, in order; a frame takes the
    values of the last chunk that covers it). Returns ``(x, nan_flag)``."""
    check_observation_shape(guidance, noise.shape)
    if corrections > 0 and rng is None and z is None:
        raise ValueError("corrections > 0 requires an rng generator or injected z")
    if z is not None and len(z) != steps * corrections:
        raise ValueError(f"{len(z)} injected draws for {steps} x {corrections} corrections")
    L = noise.shape[0]
    F = min(int(frame_chunk), L)
    chunks = _frame_chunks(L, F)
    dt = np.float32(1.0 / steps)
    times = [float(t) for t in np.linspace(1.0, 0.0, steps + 1, dtype=np.float32)[:-1]]

    def frame_pass(x, eps, err, t, t2, delta=None, draw=None):
        d = x.dtype
        mu, sigma = _in_dtype(process.mu(t), d), _in_dtype(process.sigma(t), d)
        mu2, sigma2 = _in_dtype(process.mu(t2), d), _in_dtype(process.sigma(t2), d)
        if delta is not None:
            scale = steprules.langevin_noise_scale(tau, delta, corrector_variance_exact).to(d)
            delta = delta.to(d)
        out = torch.empty_like(x)
        for _, f0 in chunks:
            sl = slice(f0, f0 + F)
            eg = guided_eps_chunk(guidance, process, eps[sl], err, f0, t)
            if delta is None:
                out[sl] = steprules.ddim_step(x[sl], eg, mu, sigma, mu2, sigma2)
            else:
                zc = _draw(z, draw, sl, (F,) + tuple(x.shape[1:]), rng, x)
                out[sl] = steprules.langevin_step(x[sl], eg, zc, delta, sigma2, sqrt2delta=scale)
        return out

    def guided_sumsq(eps, err, t):
        acc = torch.zeros((), dtype=torch.float32, device=eps.device)
        for ci, f0 in chunks:
            eg = guided_eps_chunk(guidance, process, eps[f0 : f0 + F], err, f0, t)
            acc += (eg[ci * F - f0 :].float() ** 2).sum()  # each frame once
        return acc

    def step(state, i):
        t = times[i]
        t2 = float(np.float32(t) - dt)
        eps, err = _guided_eps_and_err(score, guidance, process, state["x"], t)
        x = frame_pass(state["x"], eps, err, t, t2)
        for c in range(corrections):
            eps, err = _guided_eps_and_err(score, guidance, process, x, t2)
            delta = steprules.langevin_delta(tau, guided_sumsq(eps, err, t2) / eps.numel())
            x = frame_pass(x, eps, err, t2, t2, delta=delta, draw=i * corrections + c)
        return {"x": x, "nan": state["nan"] | _nan(x)}

    init = {"x": noise, "nan": torch.zeros((), dtype=torch.bool, device=noise.device)}
    kind = ("pc", steps, corrections, float(tau), bool(corrector_variance_exact))
    ckpt = _resume(resume_path, resume_every, kind, score, guidance, noise, F)
    state = _stepwise_drive(step, init, steps, steps_per_call, verbose, ckpt, rng if z is None else None)
    x, nan_flag = state["x"], state["nan"]
    if denoise_final:
        x = _final_denoise(score, guidance, process, x, F)
        nan_flag = nan_flag | _nan(x)
    return x, nan_flag


@torch.no_grad()
def sample_dpmpp2m_long(
    process,
    score: WindowScoreFn,
    noise: torch.Tensor,
    *,
    guidance: Optional[GaussianGuidance] = None,
    steps: int = 64,
    rng: Optional[torch.Generator] = None,
    z: Optional[Sequence] = None,
    frame_chunk: int = 256,
    traj_dtype: Optional[torch.dtype] = None,
    steps_per_call: Optional[int] = None,
    verbose: bool = False,
    denoise_final: bool = False,
    order: int = 2,
    sde_eta: float = 0.0,
    resume_path: Optional[str] = None,
    resume_every: int = 8,
):
    """DPM-Solver++(2M) on log-SNR-spaced steps from ``noise`` [L, H, W, C],
    with one more trajectory buffer for the previous x0 prediction.
    ``sde_eta > 0`` selects the SDE form, whose noise of each frame chunk
    comes from ``rng``, or, for tests, from ``z`` (one trajectory per step).
    ``traj_dtype`` sets the dtype of every trajectory buffer (bf16 for a
    year). Returns ``(x, nan_flag)``, ``x`` in that dtype."""
    if order != 2:
        raise NotImplementedError("DPM-Solver++(3M) (order=3) is not ported; order=2 is")
    check_observation_shape(guidance, noise.shape)
    if sde_eta < 0:
        raise ValueError(f"sde_eta must be >= 0, got {sde_eta}")
    if sde_eta > 0 and rng is None and z is None:
        raise ValueError("sde_eta > 0 requires an rng generator or injected z")
    if z is not None and len(z) != steps:
        raise ValueError(f"{len(z)} injected noise draws for {steps} steps")
    use_sde = sde_eta > 0
    if traj_dtype is not None:
        noise = noise.to(traj_dtype)
    L = noise.shape[0]
    F = min(int(frame_chunk), L)
    chunks = _frame_chunks(L, F)
    times = [float(t) for t in logsnr_time_grid(process, steps)]

    def step(state, i):
        x, prev_x0 = state["x"], state["prev_x0"]
        d = x.dtype
        t_prev, t_cur = times[i], times[i + 1]
        multi = not bool(state["is_first"])
        eps, err = _guided_eps_and_err(score, guidance, process, x, t_prev)
        mu, sigma = _in_dtype(process.mu(t_prev), d), _in_dtype(process.sigma(t_prev), d)
        if use_sde:
            h, *coeffs = steprules.dpm_sde_scalar_coeffs(process, t_prev, t_cur, state["prev_h"], sde_eta)
        else:
            h, *coeffs = steprules.dpm_scalar_coeffs(process, t_prev, t_cur, state["prev_h"])
        coeffs = [_in_dtype(c, d) for c in coeffs]
        out, x0_buf = torch.empty_like(x), torch.empty_like(x)
        for _, f0 in chunks:
            sl = slice(f0, f0 + F)
            eg = guided_eps_chunk(guidance, process, eps[sl], err, f0, t_prev)
            x0 = steprules.predict_x0(x[sl], eg, mu, sigma)
            if use_sde:
                decay, growth, corr, nscale = coeffs
                zc = _draw(z, i, sl, (F,) + tuple(x.shape[1:]), rng, x)
                out[sl] = steprules.dpm_sde_step(x[sl], x0, prev_x0[sl], zc, decay, growth, corr, nscale,
                                                 multi)
            else:
                sigma_ratio, growth, c_cur, c_prev = coeffs
                dd = steprules.dpm_data_estimate(x0, prev_x0[sl], c_cur, c_prev, multi)
                out[sl] = steprules.dpm_step(x[sl], dd, sigma_ratio, growth)
            x0_buf[sl] = x0
        return {"x": out, "prev_x0": x0_buf, "prev_h": h.reshape(()).float(),
                "is_first": torch.zeros((), dtype=torch.bool), "nan": state["nan"] | _nan(out)}

    init = {"x": noise, "prev_x0": torch.zeros_like(noise), "prev_h": torch.ones((), dtype=torch.float32),
            "is_first": torch.ones((), dtype=torch.bool),
            "nan": torch.zeros((), dtype=torch.bool, device=noise.device)}
    kind = ("dpm", order, float(sde_eta), steps)
    ckpt = _resume(resume_path, resume_every, kind, score, guidance, noise, F)
    state = _stepwise_drive(step, init, steps, steps_per_call, verbose, ckpt,
                            rng if use_sde and z is None else None)
    x, nan_flag = state["x"], state["nan"]
    if denoise_final:
        x = _final_denoise(score, guidance, process, x, F)
        nan_flag = nan_flag | _nan(x)
    return x, nan_flag
