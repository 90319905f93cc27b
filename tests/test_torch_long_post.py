"""The year path's post-processing (``calibrate.postprocess_long``) against
JAX ``postprocess_long_nchw``, and its chunking against the one-shot
calibration and projection; the setup of tests/test_long_post.py (13 frames
of 32 x 32 x 2, s = 8, t = 3, observations of another field)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import close, n, t
from climate2weather_tpu.diffusion.calibrate import postprocess_long_nchw
from climate2weather_tpu.diffusion.guidance import SpatioTemporalCoarsening as JaxCoarsening
from climate2weather_tpu_torch.diffusion.calibrate import calibrate_trajectory, postprocess_long
from climate2weather_tpu_torch.diffusion.guidance import SpatioTemporalCoarsening

L, H, W, C = 13, 32, 32, 2
S_STEP, T_STEP = 8, 3


@pytest.fixture(scope="module")
def data():
    rng = np.random.RandomState(0)
    traj = rng.randn(L, H, W, C).astype(np.float32)
    other = rng.randn(L, H, W, C).astype(np.float32)
    obs = np.array(JaxCoarsening(S_STEP, T_STEP)(jnp.asarray(other)))
    target = (0.5 + rng.rand(C, H // 2)).astype(np.float32)
    return traj, obs, target


def _jax(traj, **kw):
    out = postprocess_long_nchw(jnp.transpose(jnp.asarray(traj), (0, 3, 1, 2)), s_step=S_STEP,
                                t_step=T_STEP, **kw)
    return np.transpose(np.asarray(out), (0, 2, 3, 1))


@pytest.mark.parametrize("method", ["spectral", "block"])
@pytest.mark.parametrize("parts", ["calibrate", "project", "both"])
def test_postprocess_long_matches_jax(data, method, parts):
    traj, obs, target = data
    target = target if parts != "project" else None
    obs = obs if parts != "calibrate" else None
    want = _jax(traj, calib_target=target, observation=None if obs is None else jnp.asarray(obs),
                method=method, iters=3, chunk=4)
    got = postprocess_long(t(traj), target, S_STEP, None if obs is None else t(obs), T_STEP, method, 3,
                           chunk=4)
    close(got, want, rtol=2e-4, atol=2e-4)


def test_chunked_calibration_equals_one_shot(data):
    traj, _, target = data
    want = calibrate_trajectory(t(traj), target, S_STEP)
    got = postprocess_long(t(traj), target, S_STEP, chunk=4)
    close(got, want, rtol=0, atol=1e-5)


def test_subset_projection_equals_full_projection(data):
    traj, obs, _ = data
    want = SpatioTemporalCoarsening(S_STEP, T_STEP).project(t(traj), t(obs), iters=3, method="spectral")
    got = postprocess_long(t(traj), None, S_STEP, t(obs), T_STEP, "spectral", 3, chunk=2)
    close(got, want, rtol=0, atol=1e-5)
    unobserved = [f for f in range(L) if f % T_STEP]
    np.testing.assert_array_equal(n(got)[unobserved], traj[unobserved])


def test_bf16_keeps_its_dtype_and_the_observation_to_its_rounding(data):
    traj, obs, target = data
    got = postprocess_long(t(traj).to(torch.bfloat16), target, S_STEP, t(obs), T_STEP, chunk=4)
    assert got.dtype == torch.bfloat16
    A = SpatioTemporalCoarsening(S_STEP, T_STEP)
    err = float((A(got.float()) - t(obs)).abs().max())
    # the last pass rounds each value to bf16: half an ulp of the largest
    half_ulp = 2.0 ** (np.floor(np.log2(float(got.float().abs().max()))) - 8)
    assert err <= half_ulp + 1e-4


def test_observation_length_mismatch_raises(data):
    traj, obs, _ = data
    with pytest.raises(ValueError, match="observation has"):
        postprocess_long(t(traj)[:7], None, S_STEP, t(obs), T_STEP)
