"""The year path's samplers (``diffusion/long_sampler.py``) against the JAX
long samplers on the CPU, and their resume files.

The setup is that of tests/test_long_sampler.py: the tiny net, L = 13 frames
of 16 x 16 x 2, windows of 5 in chunks of 4, A with s = 4 and t = 3, frame
chunks of 5 (so the last chunk shifts back). The JAX noise of each frame
chunk (``fold_in(zkey, ci)``) is drawn here and injected into the port as
the trajectory it makes: a frame takes the values of the last chunk that
covers it. Both sides run in fp32 and agree at 2e-4 of the output's largest
magnitude (ROADMAP caveat 4: under jit, JAX evaluates sigma(0) as 2^-10,
the port as 1e-3; DPM-Solver++(2M) takes 12 steps so that its last step's
share stays below that limit). The bf16 trajectory agrees at 1e-2 of it,
about 2.5 bf16 ulps.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import jax_net_and_params, n, tiny_config, torch_net
from climate2weather_tpu.diffusion import long_sampler as jlong
from climate2weather_tpu.diffusion.guidance import GaussianGuidance as JaxGuidance
from climate2weather_tpu.diffusion.guidance import SpatioTemporalCoarsening as JaxCoarsening
from climate2weather_tpu.diffusion.process import VPCosineProcess as JaxProcess
from climate2weather_tpu.diffusion.window import make_batched_eps_fn
from climate2weather_tpu_torch.diffusion import long_sampler
from climate2weather_tpu_torch.diffusion.guidance import GaussianGuidance, SpatioTemporalCoarsening
from climate2weather_tpu_torch.diffusion.process import VPCosineProcess
from climate2weather_tpu_torch.diffusion.window import WindowScoreFn

L, HW, C, WINDOW, CHUNK, F = 13, 16, 2, 5, 4, 5
STD, GAMMA = np.array([0.2, 0.3], np.float32), 7e-4


@pytest.fixture(scope="module")
def setup():
    cfg = tiny_config(channels=C * WINDOW, window=WINDOW)
    net, params = jax_net_and_params(cfg, hw=HW)
    rng = np.random.RandomState(0)
    noise = rng.randn(L, HW, HW, C).astype(np.float32)
    gt = rng.randn(L, HW, HW, C).astype(np.float32)
    y = np.array(JaxCoarsening(4, 3)(jnp.asarray(gt)))
    jax_side = dict(eps_apply=make_batched_eps_fn(net.apply), params=params,
                    guidance=JaxGuidance(A=JaxCoarsening(4, 3), y=jnp.asarray(y),
                                         std=jnp.asarray(STD).reshape(1, 1, 1, C), gamma=GAMMA))
    port_net = torch_net(cfg, params)
    port_guidance = GaussianGuidance(A=SpatioTemporalCoarsening(4, 3), y=torch.from_numpy(y),
                                     std=torch.from_numpy(STD), gamma=GAMMA)
    return jax_side, port_net, port_guidance, noise


def _score(port_net, calls=None):
    def eps_fn(w, tt):
        if calls is not None:
            calls.append(tt)
        return port_net(w, tt)
    return WindowScoreFn(eps_fn, WINDOW // 2, chunk_size=CHUNK)


def _jax_run(setup, fn, guided, **kw):
    jax_side, *_, noise = setup
    out, nan = fn(JaxProcess(), jax_side["eps_apply"], jax_side["params"],
                  jnp.moveaxis(jnp.asarray(noise), 3, 1), markov_order=WINDOW // 2, chunk_size=CHUNK,
                  guidance=jax_side["guidance"] if guided else None, frame_chunk=F, **kw)
    assert not bool(nan)
    return np.moveaxis(np.asarray(out.astype(jnp.float32)), 1, 3)


def _chunk_normals(key, draws, dtype=jnp.float32):
    """The z of ``draws`` successive ``key, zkey = split(key)`` draws, each
    as the trajectory [L, H, W, C] its frame chunks make (the last chunk,
    shifted back, wins on the frames it shares)."""
    zs = []
    for _ in range(draws):
        key, zkey = jax.random.split(key)
        z = np.zeros((L, HW, HW, C), np.float32)
        for ci in range(-(-L // F)):
            f0 = min(ci * F, L - F)
            zc = jax.random.normal(jax.random.fold_in(zkey, ci), (F, C, HW, HW), dtype)
            z[f0 : f0 + F] = np.moveaxis(np.asarray(zc.astype(jnp.float32)), 1, 3)
        zs.append(torch.from_numpy(z))
    return zs


def _close(got, want, rel=2e-4):
    got = n(got.float()) if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * float(np.abs(want).max()))


@pytest.mark.parametrize("corrections", [0, 1])
def test_pc_guided_matches_jax(setup, corrections):
    _, port_net, guidance, noise = setup
    steps, key = 4, jax.random.PRNGKey(5)
    want = _jax_run(setup, jlong.sample_guided_long, True, steps=steps, corrections=corrections,
                    tau=0.5, rng=key)
    z = _chunk_normals(key, steps * corrections) if corrections else None
    got, nan = long_sampler.sample_guided_long(VPCosineProcess(), _score(port_net), torch.from_numpy(noise),
                                               guidance=guidance, steps=steps, corrections=corrections,
                                               tau=0.5, z=z, frame_chunk=F)
    assert not bool(nan)
    _close(got, want)


@pytest.mark.parametrize("mode", ["unguided", "guided", "sde"])
def test_dpm_matches_jax(setup, mode):
    _, port_net, guidance, noise = setup
    steps, key, eta = 12, jax.random.PRNGKey(7), (0.3 if mode == "sde" else 0.0)
    guided = mode != "unguided"
    want = _jax_run(setup, jlong.sample_dpmpp2m_long, guided, steps=steps, sde_eta=eta, rng=key)
    z = _chunk_normals(key, steps) if eta else None
    got, nan = long_sampler.sample_dpmpp2m_long(VPCosineProcess(), _score(port_net), torch.from_numpy(noise),
                                                guidance=guidance if guided else None, steps=steps,
                                                sde_eta=eta, z=z, frame_chunk=F)
    assert not bool(nan)
    _close(got, want)


@pytest.mark.parametrize("sampler", ["pc", "dpm"])
def test_denoise_final_matches_jax(setup, sampler):
    _, port_net, guidance, noise = setup
    kw = dict(steps=4) if sampler == "pc" else dict(steps=12)
    jfn = jlong.sample_guided_long if sampler == "pc" else jlong.sample_dpmpp2m_long
    fn = long_sampler.sample_guided_long if sampler == "pc" else long_sampler.sample_dpmpp2m_long
    want = _jax_run(setup, jfn, True, denoise_final=True, **kw)
    got, _ = fn(VPCosineProcess(), _score(port_net), torch.from_numpy(noise), guidance=guidance,
                denoise_final=True, frame_chunk=F, **kw)
    _close(got, want)


def test_bf16_trajectory_matches_jax(setup):
    """The trajectory in bf16 (every buffer rounds at each step, schedule and
    guidance in fp32), SDE noise drawn in bf16 as JAX draws it, final
    denoise: 1e-2 of the output's scale. 4 steps: the untrained net's
    gain of 1/mu ~ 1e3 a step makes bf16 runs chaotic (JAX's own bf16 run is
    2.2 % of the scale off its fp32 run at 4 steps, 3.6 % at 12)."""
    _, port_net, guidance, noise = setup
    steps, key = 4, jax.random.PRNGKey(9)
    want = _jax_run(setup, jlong.sample_dpmpp2m_long, True, steps=steps, sde_eta=0.3, rng=key,
                    traj_dtype=jnp.bfloat16, denoise_final=True)
    got, nan = long_sampler.sample_dpmpp2m_long(
        VPCosineProcess(), _score(port_net), torch.from_numpy(noise), guidance=guidance, steps=steps,
        sde_eta=0.3, z=_chunk_normals(key, steps, jnp.bfloat16), frame_chunk=F,
        traj_dtype=torch.bfloat16, denoise_final=True)
    assert got.dtype == torch.bfloat16 and not bool(nan)
    _close(got, want, rel=1e-2)


@pytest.mark.parametrize("sampler", ["pc", "dpm"])
def test_frame_chunk_and_steps_per_call_do_not_change_the_result(setup, sampler):
    """Frame chunks of 5 and one chunk of all 13 frames give the same bits,
    and so do calls of 3 steps against one call of all."""
    _, port_net, guidance, noise = setup
    fn = long_sampler.sample_guided_long if sampler == "pc" else long_sampler.sample_dpmpp2m_long
    kw = dict(guidance=guidance, steps=7, denoise_final=True)
    one, _ = fn(VPCosineProcess(), _score(port_net), torch.from_numpy(noise), frame_chunk=L, **kw)
    chunked, _ = fn(VPCosineProcess(), _score(port_net), torch.from_numpy(noise), frame_chunk=F, **kw)
    stepwise, _ = fn(VPCosineProcess(), _score(port_net), torch.from_numpy(noise), frame_chunk=F,
                     steps_per_call=3, **kw)
    assert torch.equal(one, chunked) and torch.equal(chunked, stepwise)


def test_stepwise_stops_at_a_nan(setup):
    _, port_net, guidance, noise = setup
    calls = []
    bad = noise.copy()
    bad[3, 2, 2, 0] = np.nan
    _, nan = long_sampler.sample_dpmpp2m_long(VPCosineProcess(), _score(port_net, calls), torch.from_numpy(bad),
                                              steps=6, steps_per_call=2, frame_chunk=F)
    assert bool(nan) and len(calls) == 2 * 3  # the first call's 2 steps x 3 window chunks


class Crash(Exception):
    pass


def _crashing_score(port_net, after):
    """A window scorer that raises at its ``after``-th network call, as a
    run killed mid-call would stop."""
    calls = []

    def eps_fn(w, tt):
        if len(calls) == after:
            raise Crash
        calls.append(tt)
        return port_net(w, tt)
    return WindowScoreFn(eps_fn, WINDOW // 2, chunk_size=CHUNK), calls


def _sde_run(setup, score, path, seed=3, eta=0.3, every=1):
    """DPM SDE, 6 steps in calls of 2, noise and z from one generator."""
    _, _, guidance, noise = setup
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn((L, HW, HW, C), generator=gen)
    return long_sampler.sample_dpmpp2m_long(VPCosineProcess(), score, x, guidance=guidance, steps=6,
                                            sde_eta=eta, rng=gen, frame_chunk=F, steps_per_call=2,
                                            denoise_final=True, resume_path=path, resume_every=every)


def test_resume_after_a_crash_equals_the_uninterrupted_run(setup, tmp_path):
    _, port_net, *_ = setup
    want, _ = _sde_run(setup, _score(port_net), None)
    path = str(tmp_path / ".sample_resume_000.npz")
    score, calls = _crashing_score(port_net, after=5 * 3)  # in step 5, the third call
    with pytest.raises(Crash):
        _sde_run(setup, score, path)
    with np.load(path) as f:  # written after the second call
        assert int(f["step"]) == 4
    resumed_calls = []
    got, nan = _sde_run(setup, _score(port_net, resumed_calls), path)
    assert torch.equal(got, want) and not bool(nan)
    assert len(resumed_calls) == (2 + 1) * 3  # the last call's 2 steps and the final denoise
    assert not (tmp_path / ".sample_resume_000.npz").exists()


def test_resume_file_of_another_run_restarts_from_scratch(setup, tmp_path):
    _, port_net, *_ = setup
    path = str(tmp_path / "resume.npz")
    score, _ = _crashing_score(port_net, after=3 * 3)
    with pytest.raises(Crash):
        _sde_run(setup, score, path, eta=0.5)
    assert (tmp_path / "resume.npz").exists()
    calls = []
    got, _ = _sde_run(setup, _score(port_net, calls), path)  # another eta: another digest
    want, _ = _sde_run(setup, _score(port_net), None)
    assert torch.equal(got, want) and len(calls) == (6 + 1) * 3
    assert not (tmp_path / "resume.npz").exists()
    # another seed gives other noise: a fresh start too
    score, _ = _crashing_score(port_net, after=3 * 3)
    with pytest.raises(Crash):
        _sde_run(setup, score, path, seed=4)
    calls.clear()
    _sde_run(setup, _score(port_net, calls), path, seed=3)
    assert len(calls) == (6 + 1) * 3


def test_resume_file_is_removed_after_an_uninterrupted_run(setup, tmp_path, monkeypatch):
    _, port_net, *_ = setup
    saved = []
    real = long_sampler._save_carry
    monkeypatch.setattr(long_sampler, "_save_carry", lambda *a: (saved.append(a[2]), real(*a)))
    path = tmp_path / "resume.npz"
    _sde_run(setup, _score(port_net), str(path))
    assert saved == [2, 4] and not path.exists()


def test_carry_round_trip_keeps_bf16_bits_and_the_generator_state(tmp_path):
    rng = np.random.RandomState(2)
    state = {"x": torch.from_numpy(rng.randn(5, 4, 4, 2).astype(np.float32)).to(torch.bfloat16),
             "prev_h": torch.tensor(0.37), "is_first": torch.zeros((), dtype=torch.bool),
             "nan": torch.zeros((), dtype=torch.bool)}
    gen = torch.Generator().manual_seed(11)
    torch.randn(7, generator=gen)
    path = str(tmp_path / "carry.npz")
    long_sampler._save_carry(path, state, 3, "digest", gen)
    want_next = torch.randn(4, generator=gen)
    init = {k: torch.zeros_like(v) for k, v in state.items()}
    fresh = torch.Generator().manual_seed(0)
    got, step = long_sampler._load_carry(path, init, "digest", fresh)
    assert step == 3 and got["x"].dtype == torch.bfloat16
    assert all(torch.equal(got[k], state[k]) for k in state)
    assert torch.equal(torch.randn(4, generator=fresh), want_next)
    # another digest, dtype or shape, or a damaged file: the fresh start
    for other, digest in ((init, "other"), ({**init, "x": torch.zeros(5, 4, 4, 2)}, "digest"),
                          ({**init, "x": torch.zeros(5, 4, 4, 3, dtype=torch.bfloat16)}, "digest")):
        got, step = long_sampler._load_carry(path, other, digest, fresh)
        assert got is other and step == 0
    (tmp_path / "carry.npz").write_bytes(b"not a file of ours")
    got, step = long_sampler._load_carry(path, init, "digest", fresh)
    assert got is init and step == 0


def test_unported_options_raise(setup):
    _, port_net, guidance, noise = setup
    with pytest.raises(NotImplementedError):
        long_sampler.sample_dpmpp2m_long(VPCosineProcess(), _score(port_net), torch.from_numpy(noise), order=3)
    with pytest.raises(ValueError):
        long_sampler.sample_dpmpp2m_long(VPCosineProcess(), _score(port_net), torch.from_numpy(noise),
                                         sde_eta=0.3)
    with pytest.raises(ValueError):
        long_sampler.sample_guided_long(VPCosineProcess(), _score(port_net), torch.from_numpy(noise),
                                        corrections=1)
