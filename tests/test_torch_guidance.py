"""Observation operator, adjoint, prolongation, t=0 projection and detached
guidance against climate2weather_tpu/diffusion/guidance.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import close, t
from climate2weather_tpu.diffusion import guidance as jg
from climate2weather_tpu.diffusion.process import VPCosineProcess as JaxProcess
from climate2weather_tpu_torch.diffusion import guidance as g
from climate2weather_tpu_torch.diffusion.process import VPCosineProcess

CASES = [(13, 32, 32, 4, 16, 6), (13, 32, 32, 4, 8, 6), (10, 16, 24, 2, 4, 3), (7, 8, 8, 1, 2, 1)]


def _ops(s, ts):
    return g.SpatioTemporalCoarsening(s, ts), jg.SpatioTemporalCoarsening(s, ts)


@pytest.mark.parametrize("L,H,W,C,s,ts", CASES)
def test_coarsening_and_adjoint(L, H, W, C, s, ts):
    A, JA = _ops(s, ts)
    rng = np.random.RandomState(L + s)
    x = rng.randn(L, H, W, C).astype(np.float32)
    close(A(t(x)), JA(jnp.asarray(x)))
    v = rng.randn(A.out_times(L), H // s, W // s, C).astype(np.float32)
    close(A.adjoint(t(v), L), JA.adjoint(jnp.asarray(v), L))
    # <A x, v> = <x, A^T v>
    lhs = float((A(t(x)) * t(v)).sum())
    rhs = float((t(x) * A.adjoint(t(v), L)).sum())
    assert abs(lhs - rhs) <= 1e-4 * max(1.0, abs(lhs))


@pytest.mark.parametrize("L,H,W,C,s,ts", CASES)
def test_spectral_prolong(L, H, W, C, s, ts):
    A, JA = _ops(s, ts)
    v = np.random.RandomState(3).randn(A.out_times(L), H // s, W // s, C).astype(np.float32)
    close(A.prolong(t(v), L), JA.prolong(jnp.asarray(v), L, method="spectral"))
    with pytest.raises(ValueError):
        A.prolong(t(v), L, method="cubic")


@pytest.mark.parametrize("method,iters", [("spectral", 1), ("spectral", 3), ("block", 1)])
@pytest.mark.parametrize("L,H,W,C,s,ts", CASES)
def test_project(method, iters, L, H, W, C, s, ts):
    A, JA = _ops(s, ts)
    rng = np.random.RandomState(4)
    x = rng.randn(L, H, W, C).astype(np.float32)
    y = rng.randn(A.out_times(L), H // s, W // s, C).astype(np.float32)
    got = A.project(t(x), t(y), iters=iters, method=method)
    close(got, JA.project(jnp.asarray(x), jnp.asarray(y), iters=iters, method=method))
    if iters == 3 or method == "block":
        assert float((A(got) - t(y)).abs().max()) < 1e-4


def test_project_members_share_the_observation():
    A = g.SpatioTemporalCoarsening(8, 6)
    rng = np.random.RandomState(5)
    x = t(rng.randn(2, 13, 32, 32, 4))
    y = t(rng.randn(3, 4, 4, 4))
    both = A.project(x, y)
    for m in range(2):
        close(both[m], A.project(x[m], y), rtol=1e-6, atol=1e-6)
    with pytest.raises(ValueError):
        A.project(x, y, method="bilinear")


@pytest.mark.parametrize("prolong", [False, True])
@pytest.mark.parametrize("anneal", [0.0, 0.5])
@pytest.mark.parametrize("tt", [0.9, 0.3, 0.01])
@pytest.mark.parametrize("per_ch", [True, False])
def test_guided_eps(prolong, anneal, tt, per_ch):
    L, H, W, C, s, ts = 13, 32, 32, 4, 16, 6
    rng = np.random.RandomState(6)
    x = rng.randn(L, H, W, C).astype(np.float32)
    M = (rng.randn(C, C) / 2).astype(np.float32)
    A, JA = _ops(s, ts)
    y = rng.randn(A.out_times(L), H // s, W // s, C).astype(np.float32)
    std = [0.17, 0.04, 0.33, 0.33] if per_ch else 0.1
    gamma = 7.2e-4
    jguide = jg.GaussianGuidance(A=JA, y=jnp.asarray(y), std=jg.per_channel(std, C),
                                 gamma=jg.per_channel(gamma, C), prolong=prolong, anneal=anneal)
    want = jguide.guided_eps(lambda xx, _t: jnp.tanh(xx @ jnp.asarray(M)), JaxProcess(),
                             jnp.asarray(x), jnp.float32(tt))
    guide = g.GaussianGuidance(A=A, y=t(y), std=g.per_channel(std, C), gamma=g.per_channel(gamma, C),
                               prolong=prolong, anneal=anneal)
    got = guide.guided_eps(lambda xx, _t: torch.tanh(xx @ t(M)), VPCosineProcess(), t(x), float(np.float32(tt)))
    close(got, want)


def test_guided_eps_checks_observation_shape_and_exact_grad():
    A = g.SpatioTemporalCoarsening(16, 6)
    guide = g.GaussianGuidance(A=A, y=torch.zeros(2, 2, 2, 4))
    with pytest.raises(ValueError, match="observation shape"):
        guide.guided_eps(lambda xx, _t: xx, VPCosineProcess(), torch.zeros(13, 32, 32, 4), 0.5)
    # exact-gradient guidance has no prolonged counterpart, as in JAX
    exact = g.GaussianGuidance(A=A, y=torch.zeros(3, 2, 2, 4), exact_grad=True, prolong=True)
    with pytest.raises(ValueError, match="prolong"):
        exact.guided_eps(lambda xx, _t: xx, VPCosineProcess(), torch.zeros(13, 32, 32, 4), 0.5)


def test_per_channel():
    assert g.per_channel(0.5, 4).shape == ()
    np.testing.assert_array_equal(g.per_channel([1, 2], 2).numpy(), np.float32([1, 2]))
    close(g.per_channel([1, 2, 3], 3), np.asarray(jg.per_channel([1, 2, 3], 3)).ravel())
    with pytest.raises(ValueError):
        g.per_channel([1, 2], 3)
