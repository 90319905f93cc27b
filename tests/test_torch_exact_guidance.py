"""Exact-gradient guidance and the bilinear prolongation against the JAX
package: ``GaussianGuidance(exact_grad=True).guided_eps`` over a chunked
window score whose last chunk shifts back, the chunked vector-Jacobian
product of ``WindowScoreFn`` (the overwritten windows' zero cotangent),
``condition_on``, the short DPM-Solver++(2M) and PC samplers and the long
samplers with exact guidance, ``run_arrays`` with ``use_exact_grad``, and the
bilinear ``prolong`` on the short and long paths, borders included.

The tiny net runs in fp32 on both sides. Where JAX runs eagerly the
tolerance is the repository's rtol/atol 2e-4; where it runs jitted (the
samplers' scans and the vmapped slice) it is 2e-4 of the output's largest
magnitude (ROADMAP caveat 4: XLA evaluates sigma near t = 0 differently).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import close, jax_net_and_params, jax_split_normals, n, t, tiny_config, torch_net
from climate2weather_tpu.diffusion import guidance as jg
from climate2weather_tpu.diffusion import long_sampler as jlong
from climate2weather_tpu.diffusion import sampler as jsampler
from climate2weather_tpu.diffusion import window as jwindow
from climate2weather_tpu.diffusion.process import VPCosineProcess as JaxProcess
from climate2weather_tpu_torch.diffusion import guidance as g
from climate2weather_tpu_torch.diffusion import long_sampler, sampler, window
from climate2weather_tpu_torch.diffusion.process import VPCosineProcess

# 13 frames of 16 x 16 x 2, windows of 5 in chunks of 4: 9 windows in chunks
# [0, 4), [4, 8) and [5, 9), the last shifted back over windows 5-7; A with
# s = 4 and t = 3 observes frames 0, 3, ..., 12, so centres 7 and 9 (windows 5
# and 7) carry cotangent in both chunks that write them
L, HW, C, WINDOW, CHUNK, S, TS = 13, 16, 2, 5, 4, 4, 3
STD, GAMMA = [0.2, 0.3], 7e-4


@pytest.fixture(scope="module")
def nets():
    cfg = tiny_config(channels=C * WINDOW, window=WINDOW)
    net, params = jax_net_and_params(cfg, hw=HW)
    # as exp/downscaling.load_net gives it to the samplers
    return net, params, torch_net(cfg, params).requires_grad_(False)


def _scores(nets, chunk=CHUNK):
    net, params, port_net = nets
    jscore = jwindow.WindowScoreFn(jwindow.make_batched_eps_fn(net.apply), params, WINDOW // 2,
                                   chunk_size=chunk, noise_process=JaxProcess())
    score = window.WindowScoreFn(port_net, WINDOW // 2, chunk_size=chunk, noise_process=VPCosineProcess())
    return jscore, score


def _inputs(seed, members=None):
    rng = np.random.RandomState(seed)
    shape = (L, HW, HW, C) if members is None else (members, L, HW, HW, C)
    x = rng.randn(*shape).astype(np.float32)
    y = rng.randn(-(-L // TS), HW // S, HW // S, C).astype(np.float32)
    return x, y


def _guides(y, per_ch, anneal=0.0, exact=True, prolong=False, gamma=GAMMA):
    std = STD if per_ch else 0.25
    jguide = jg.GaussianGuidance(A=jg.SpatioTemporalCoarsening(S, TS), y=jnp.asarray(y),
                                 std=jg.per_channel(std, C), gamma=jg.per_channel(gamma, C),
                                 exact_grad=exact, prolong=prolong, anneal=anneal)
    guide = g.GaussianGuidance(A=g.SpatioTemporalCoarsening(S, TS), y=t(y), std=g.per_channel(std, C),
                               gamma=g.per_channel(gamma, C), exact_grad=exact, prolong=prolong,
                               anneal=anneal)
    return jguide, guide


@pytest.mark.parametrize("per_ch,anneal,members,tt", [
    (True, 0.0, 1, 0.6), (False, 0.0, 1, 0.6), (True, 0.8, 1, 0.6), (False, 0.8, 1, 0.3),
    (True, 0.0, 3, 0.6), (False, 0.8, 3, 0.3), (True, 0.0, 1, 0.05),
])
def test_exact_guided_eps_matches_jax(nets, per_ch, anneal, members, tt):
    """Per-channel and scalar std, anneal on and off, one member and three
    (JAX vmaps the gradient per member; the port sums log p over members and
    takes one gradient): rtol/atol 2e-4 against eager JAX."""
    jscore, score = _scores(nets)
    x, y = _inputs(1, None if members == 1 else members)
    jguide, guide = _guides(y, per_ch, anneal)
    tt = np.float32(tt)

    def one(xx):
        return jguide.guided_eps(jscore, JaxProcess(), xx, tt)

    want = one(jnp.asarray(x)) if members == 1 else jax.vmap(one)(jnp.asarray(x))
    with torch.no_grad():  # as the samplers call it
        got = guide.guided_eps(score, VPCosineProcess(), t(x), float(tt))
    close(got, want)
    # the exact term is really there: the detached guidance differs
    detached = g.GaussianGuidance(A=guide.A, y=guide.y, std=guide.std, gamma=guide.gamma, anneal=anneal)
    got_detached = detached.guided_eps(score, VPCosineProcess(), t(x), float(tt))
    assert not got.requires_grad
    assert float((got_detached - got).abs().max()) > 1e-2 * float(got.abs().max())


def test_chunked_vjp_matches_jax_and_zeroes_overwritten_windows(nets, monkeypatch):
    """``WindowScoreFn.vjp`` against ``jax.vjp`` of the JAX chunked score
    (its scan's dynamic_update_slice gives the overwritten centres zero
    cotangent), with three members, whole and in sub-batches of 5 windows;
    the double count (every centre of the chunk before the shifted last one
    back-propagated) must exceed the tolerance by far."""
    jscore, score = _scores(nets)
    rng = np.random.RandomState(2)
    x = rng.randn(3, L, HW, HW, C).astype(np.float32)
    u = rng.randn(3, L, HW, HW, C).astype(np.float32)
    _, pullback = jax.vjp(jax.vmap(lambda xx: jscore(xx, 0.4)), jnp.asarray(x))
    (want,) = pullback(jnp.asarray(u))
    got = score.vjp(t(x), 0.4, t(u))
    close(got, want)
    monkeypatch.setattr(window, "VJP_WINDOWS", 5)  # 12 windows a chunk in sub-batches of 4
    # windows are independent through the net; only the convolutions'
    # summation order may change with the batch
    close(score.vjp(t(x), 0.4, t(u)), got, rtol=1e-5, atol=1e-5)
    monkeypatch.setattr(window, "VJP_WINDOWS", 96)
    monkeypatch.setattr(window, "owned_windows", lambda ci, n_chunks, B, nw: B)
    fault = score.vjp(t(x), 0.4, t(u))
    tol = 2e-4 * (1.0 + float(np.abs(np.asarray(want)).max()))
    assert float((fault - t(np.asarray(want))).abs().max()) > 100 * tol
    # the fault sits in the frames of the doubly counted windows 5-7
    # (frames 5-11) and nowhere else
    diff = (fault - got).abs().amax(dim=(0, 2, 3, 4))
    assert float(diff[:5].max()) == 0.0 and float(diff[12:].max()) == 0.0


@pytest.mark.parametrize("exact", [True, False])
def test_condition_on_matches_jax(nets, exact):
    jscore, score = _scores(nets)
    x, y = _inputs(3)
    want = jscore.condition_on(A=jg.SpatioTemporalCoarsening(S, TS), y=jnp.asarray(y),
                               std=jg.per_channel(STD, C), gamma=GAMMA, exact_grad=exact)(
        jnp.asarray(x), np.float32(0.5))
    cond = score.condition_on(A=g.SpatioTemporalCoarsening(S, TS), y=t(y), std=g.per_channel(STD, C),
                              gamma=GAMMA, exact_grad=exact)
    assert cond.is_conditioned and cond.guidance.exact_grad == exact
    close(cond(t(x), 0.5), want)
    with pytest.raises(ValueError, match="noise_process"):
        window.WindowScoreFn(lambda w, tt: w, 2).condition_on(A=g.SpatioTemporalCoarsening(S, TS),
                                                               y=t(y), std=0.1)


def test_eps_vjp_of_a_plain_score_function_is_autograd():
    """A score function without ``vjp`` is differentiated in one graded call."""
    rng = np.random.RandomState(4)
    M = t(rng.randn(C, C) / 2)
    x, u = t(rng.randn(L, HW, HW, C)), t(rng.randn(L, HW, HW, C))
    got = g.eps_vjp(lambda xx, tt: torch.tanh(xx @ M) * tt, x, 0.5, u)
    want = (u * 0.5 * (1 - torch.tanh(x @ M) ** 2)) @ M.T
    close(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("kind", ["dpmpp2m", "pc"])
def test_short_samplers_with_exact_guidance_match_jax(nets, kind):
    """DPM-Solver++(2M) (SDE, 12 steps) and PC (one corrector, 3 steps) with
    exact guidance, two members batched against JAX's vmapped scans, with
    JAX's draws injected: 2e-4 of the output's scale. gamma 1e-2, as in
    tests/test_torch_downscaling.py: a smaller gamma's gain in the observed
    subspace amplifies an untrained net's fp32 round-off from step to step
    until two correct implementations drift apart."""
    jscore, score = _scores(nets)
    x, y = _inputs(5, 2)
    jguide, guide = _guides(y, True, gamma=1e-2)
    key = jax.random.PRNGKey(3)
    keys = jax.random.split(key, 2)
    process = JaxProcess()

    def jax_one(noise, k):
        score_fn = lambda xx, tt: jguide.guided_eps(jscore, process, xx, tt)  # noqa: E731
        if kind == "dpmpp2m":
            return jsampler.sample_dpmpp2m(process, score_fn, noise, steps=12, rng=k, sde_eta=0.3)[0]
        return jsampler.sample(process, score_fn, noise, steps=3, corrections=1, tau=0.5, rng=k)[0]

    want = np.asarray(jax.jit(jax.vmap(jax_one))(jnp.asarray(x), keys))
    score_fn = lambda xx, tt: guide.guided_eps(score, VPCosineProcess(), xx, tt)  # noqa: E731
    draws = [jax_split_normals(k, 12 if kind == "dpmpp2m" else 3, (L, HW, HW, C)) for k in keys]
    z = [t(np.stack([d[i] for d in draws])) for i in range(len(draws[0]))]
    if kind == "dpmpp2m":
        got, nan = sampler.sample_dpmpp2m(VPCosineProcess(), score_fn, t(x), steps=12, z=z, sde_eta=0.3,
                                          batch_dims=1)
    else:
        got, nan = sampler.sample(VPCosineProcess(), score_fn, t(x), steps=3, corrections=1, tau=0.5,
                                  z=z, batch_dims=1)
    assert not nan.any()
    close(got, want, rtol=0, atol=2e-4 * float(np.abs(want).max()))


LONG_F = 5  # frame chunks of 5: the last shifts back


@pytest.mark.parametrize("kind", ["pc", "dpm", "dpm3"])
def test_long_samplers_exact_branch_matches_jax(nets, kind):
    """The long samplers' exact branch (observation-space form, the chunked
    VJP) with the final denoise: against JAX's long samplers (NCHW, remat'd
    scan), 2e-4 of the output's scale; gamma 1e-2 as for the short samplers.
    DPM-Solver++ takes 12 steps at order 2 and 24 at order 3, so that the
    last steps' share, where jitted JAX evaluates sigma(0) otherwise
    (caveat 4), stays below that limit (6 steps: ~8e-4 of the scale, as
    with detached guidance)."""
    net, params, port_net = nets
    x, y = _inputs(6)
    jguide, guide = _guides(y, True, gamma=1e-2)
    common = dict(guidance=None, denoise_final=True, frame_chunk=LONG_F)
    jkw = dict(markov_order=WINDOW // 2, chunk_size=CHUNK)
    if kind == "pc":
        jfn, fn, kw = jlong.sample_guided_long, long_sampler.sample_guided_long, dict(steps=3)
    else:
        jfn, fn = jlong.sample_dpmpp2m_long, long_sampler.sample_dpmpp2m_long
        kw = dict(steps=24, order=3) if kind == "dpm3" else dict(steps=12, order=2)
    jout, jnan = jfn(JaxProcess(), jwindow.make_batched_eps_fn(net.apply), params,
                     jnp.moveaxis(jnp.asarray(x), 3, 1), **{**common, "guidance": jguide}, **jkw, **kw)
    want = np.moveaxis(np.asarray(jout), 1, 3)
    score = window.WindowScoreFn(port_net, WINDOW // 2, chunk_size=CHUNK)
    got, nan = fn(VPCosineProcess(), score, t(x), **{**common, "guidance": guide}, **kw)
    assert not bool(jnan) and not bool(nan)
    close(got, want, rtol=0, atol=2e-4 * float(np.abs(want).max()))


def test_exact_grad_with_prolong_raises_as_in_jax(nets):
    _, score = _scores(nets)
    x, y = _inputs(7)
    _, guide = _guides(y, True, prolong="bilinear")
    with pytest.raises(ValueError, match="prolong"):
        guide.guided_eps(score, VPCosineProcess(), t(x), 0.5)
    for fn in (long_sampler.sample_guided_long, long_sampler.sample_dpmpp2m_long):
        with pytest.raises(ValueError, match="prolong"):
            fn(VPCosineProcess(), score, t(x), guidance=guide, steps=2)


# ---------------------------------------------------------------------------
# the bilinear prolongation

PROLONG_CASES = [(13, 32, 32, 4, 16, 6), (13, 32, 32, 4, 8, 6), (10, 16, 24, 2, 4, 3), (7, 8, 8, 1, 2, 1),
                 (5, 6, 9, 1, 3, 2)]


@pytest.mark.parametrize("Lp,H,W,Cp,s,ts", PROLONG_CASES)
def test_bilinear_prolong_matches_jax_resize(Lp, H, W, Cp, s, ts):
    """``prolong(method="bilinear")`` against ``jax.image.resize`` / s^2 at
    every pixel, borders included, rtol/atol 2e-4; and the tent weights
    against the rows of the resize of unit vectors at 1e-6."""
    A, JA = g.SpatioTemporalCoarsening(s, ts), jg.SpatioTemporalCoarsening(s, ts)
    v = np.random.RandomState(Lp + s).randn(A.out_times(Lp), H // s, W // s, Cp).astype(np.float32)
    got = A.prolong(t(v), Lp, method="bilinear")
    close(got, JA.prolong(jnp.asarray(v), Lp, method="bilinear"))
    for nin in (H // s, W // s):
        eye = jnp.eye(nin, dtype=jnp.float32)
        want = np.asarray(jax.image.resize(eye, (nin, nin * s), method="bilinear"))
        np.testing.assert_allclose(g.tent_weights(nin, nin * s), want, rtol=1e-6, atol=1e-6)
    # a border pixel takes its nearest coarse value alone, as JAX's renormalised tent does
    up = n(A.prolong_spatial(t(v), "bilinear")) * s * s
    np.testing.assert_allclose(up[:, 0, 0], v[:, 0, 0], rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(up[:, -1, -1], v[:, -1, -1], rtol=1e-6, atol=1e-6)
    with pytest.raises(ValueError):
        A.project(t(np.zeros((Lp, H, W, Cp), np.float32)), t(v), method="bilinear")


@pytest.mark.parametrize("anneal", [0.0, 0.5])
def test_bilinear_guided_eps_matches_jax(anneal):
    """Detached guidance with ``prolong="bilinear"`` on one member and two
    (JAX vmapped): rtol/atol 2e-4."""
    Lp, H, W, Cp, s, ts = 13, 32, 32, 4, 16, 6
    rng = np.random.RandomState(6)
    x = rng.randn(2, Lp, H, W, Cp).astype(np.float32)
    M = (rng.randn(Cp, Cp) / 2).astype(np.float32)
    y = rng.randn(-(-Lp // ts), H // s, W // s, Cp).astype(np.float32)
    std = [0.17, 0.04, 0.33, 0.33]
    jguide = jg.GaussianGuidance(A=jg.SpatioTemporalCoarsening(s, ts), y=jnp.asarray(y),
                                 std=jg.per_channel(std, Cp), gamma=7.2e-4, prolong="bilinear", anneal=anneal)
    want = jax.vmap(lambda xx: jguide.guided_eps(lambda a, _t: jnp.tanh(a @ jnp.asarray(M)), JaxProcess(),
                                                 xx, jnp.float32(0.3)))(jnp.asarray(x))
    guide = g.GaussianGuidance(A=g.SpatioTemporalCoarsening(s, ts), y=t(y), std=g.per_channel(std, Cp),
                               gamma=7.2e-4, prolong="bilinear", anneal=anneal)
    got = guide.guided_eps(lambda a, _t: torch.tanh(a @ t(M)), VPCosineProcess(), t(x), float(np.float32(0.3)))
    close(got, want)


def test_long_bilinear_guidance_matches_jax():
    """The long path's frame chunk with ``prolong="bilinear"`` against JAX's
    ``_guided_eps_chunk_nchw`` on frames [4, 9) (a chunk that starts between
    observed frames): rtol/atol 2e-4."""
    rng = np.random.RandomState(8)
    Lo = -(-L // TS)
    err = rng.randn(Lo, HW // S, HW // S, C).astype(np.float32)
    eps = rng.randn(5, HW, HW, C).astype(np.float32)
    _, guide = _guides(np.zeros((Lo, HW // S, HW // S, C), np.float32), True, exact=False, prolong="bilinear")
    jguide, _ = _guides(np.zeros((Lo, HW // S, HW // S, C), np.float32), True, exact=False, prolong="bilinear")
    want = jlong._guided_eps_chunk_nchw(jguide, JaxProcess(), jnp.moveaxis(jnp.asarray(eps), 3, 1),
                                        jnp.moveaxis(jnp.asarray(err), 3, 1), 4, jnp.float32(0.4))
    got = long_sampler.guided_eps_chunk(guide, VPCosineProcess(), t(eps), t(err), 4, float(np.float32(0.4)))
    close(got, np.moveaxis(np.asarray(want), 1, 3))
