"""Climatological spectral calibration against
climate2weather_tpu/diffusion/calibrate.py (the PSD from an array here, from
an HDF5 file there)."""

import h5py
import jax.numpy as jnp
import numpy as np
import pytest

from _torch_parity import close, t
from climate2weather_tpu.diffusion import calibrate as jcal
from climate2weather_tpu_torch.diffusion import calibrate as cal


@pytest.mark.parametrize("H,W,s", [(32, 32, 16), (64, 64, 16), (16, 24, 4)])
def test_index_map_and_mask(H, W, s):
    idx, nb = cal.annulus_index_map(H, W)
    jidx, jnb = jcal.annulus_index_map(H, W)
    assert nb == jnb
    np.testing.assert_array_equal(idx, jidx)
    np.testing.assert_array_equal(cal.obs_square_mask(H, W, s), jcal.obs_square_mask(H, W, s))


@pytest.mark.parametrize("T,n_frames", [(40, 256), (40, 7)])
def test_psd_from_frames_matches_h5_reader(tmp_path, T, n_frames):
    frames = np.random.RandomState(T + n_frames).randn(T, 3, 32, 32).astype(np.float32)
    path = tmp_path / "train_normed.h5"
    with h5py.File(path, "w") as f:
        f.create_dataset("x", data=frames)
    want = jcal.climatological_annulus_psd(str(path), s_step=8, n_frames=n_frames)
    got = cal.climatological_annulus_psd(frames, s_step=8, n_frames=n_frames)
    assert got.dtype == np.float32 and got.shape == want.shape == (3, 16)
    close(got, want, rtol=1e-6, atol=0)


@pytest.mark.parametrize("lead", [(), (2,)])
@pytest.mark.parametrize("max_gain", [10.0, 1.5])
def test_calibrate_trajectory(lead, max_gain):
    rng = np.random.RandomState(len(lead))
    x = rng.randn(*lead, 5, 32, 32, 4).astype(np.float32)
    target = (rng.rand(4, 16) * 0.5).astype(np.float32)
    got = cal.calibrate_trajectory(t(x), t(target), 16, max_gain=max_gain)
    if lead:
        want = np.stack([np.asarray(jcal.calibrate_trajectory(jnp.asarray(m), jnp.asarray(target), 16,
                                                               max_gain=max_gain)) for m in x])
    else:
        want = jcal.calibrate_trajectory(jnp.asarray(x), jnp.asarray(target), 16, max_gain=max_gain)
    close(got, want)


@pytest.mark.parametrize("T,n_frames", [(53, 256), (53, 9)])
def test_psd_from_h5_path_matches_jax(tmp_path, T, n_frames):
    """``climatological_annulus_psd`` given the training file's path, read
    through the port's HDF5 reader (a chunked file as ``merged_to_normed_h5``
    writes it), against the JAX function on the same path."""
    frames = np.random.RandomState(T).randn(T, 2, 32, 32).astype(np.float32)
    path = tmp_path / "train_normed.h5"
    with h5py.File(path, "w") as f:
        f.create_dataset("x", data=frames, chunks=(24, 2, 32, 32), maxshape=(None, 2, 32, 32))
    want = jcal.climatological_annulus_psd(str(path), s_step=8, n_frames=n_frames)
    got = cal.climatological_annulus_psd(str(path), s_step=8, n_frames=n_frames)
    close(got, want, rtol=1e-6, atol=0)
    close(cal.climatological_annulus_psd(path, s_step=8, n_frames=n_frames), want, rtol=1e-6, atol=0)
