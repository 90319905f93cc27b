"""Markov-blanket window scoring against the JAX WindowScoreFn: chunked,
unchunked, k = 0, the shifted last chunk, and members batched together."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import close, jax_net_and_params, t, tiny_config, torch_net
from climate2weather_tpu.diffusion import window as jwindow
from climate2weather_tpu_torch.diffusion import window


def _frame_score(W):
    """A window model that mixes frames and channels (so misplaced frames
    show), identical on both sides."""
    def jax_fn(params, xw, tt):
        return jnp.tanh(xw @ jnp.asarray(W)) + tt

    def torch_fn(xw, tt):
        return torch.tanh(xw @ t(W)) + float(tt)

    return jax_fn, torch_fn


@pytest.mark.parametrize("markov_order", [0, 1, 2])
def test_unfold_fold(markov_order):
    x = np.random.RandomState(0).randn(9, 3, 4, 2).astype(np.float32)
    got = window.unfold_windows(t(x), markov_order)
    want = jwindow.unfold_windows(jnp.asarray(x), markov_order)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(window.fold_windows(got, markov_order).numpy(),
                                  np.asarray(jwindow.fold_windows(want, markov_order)))


@pytest.mark.parametrize("markov_order,L,chunk", [
    (2, 13, None),   # unchunked
    (2, 13, 4),      # 9 windows in chunks of 4: the last chunk shifts back
    (2, 13, 3),      # chunks that tile exactly
    (2, 13, 9),      # one chunk of all windows
    (2, 13, 20),     # chunk larger than the window count
    (0, 7, 3),       # k = 0: every frame is a centre
    (1, 6, 5),
])
def test_window_score_matches_jax(markov_order, L, chunk):
    w = 2 * markov_order + 1
    C = 2
    rng = np.random.RandomState(L + (chunk or 0))
    W = (rng.randn(w * C, w * C) / 3).astype(np.float32)
    x = rng.randn(L, 4, 4, C).astype(np.float32)
    jax_fn, torch_fn = _frame_score(W)
    want = jwindow.WindowScoreFn(jax_fn, None, markov_order, chunk_size=chunk)(jnp.asarray(x), 0.25)
    got = window.WindowScoreFn(torch_fn, markov_order, chunk_size=chunk)(t(x), 0.25)
    close(got, want, rtol=1e-6, atol=1e-6)


def test_members_batched_equal_one_by_one():
    rng = np.random.RandomState(1)
    W = (rng.randn(10, 10) / 3).astype(np.float32)
    x = rng.randn(3, 13, 4, 4, 2).astype(np.float32)
    calls = []

    def torch_fn(xw, tt):
        calls.append(xw.shape[0])
        return torch.tanh(xw @ t(W)) + float(tt)

    score = window.WindowScoreFn(torch_fn, 2, chunk_size=4)
    both = score(t(x), 0.5)
    assert calls == [12, 12, 12]  # 3 members x 4 windows per call, 3 chunks
    for m in range(3):
        close(both[m], score(t(x[m]), 0.5), rtol=0, atol=0)


def test_window_score_with_network_matches_jax():
    cfg = tiny_config(channels=10, window=5)
    jnet, params = jax_net_and_params(cfg)
    x = np.random.RandomState(2).randn(11, 16, 16, 2).astype(np.float32)
    eps_fn = jwindow.make_batched_eps_fn(jnet.apply)
    want = jwindow.WindowScoreFn(eps_fn, params, 2, chunk_size=3)(jnp.asarray(x), jnp.float32(0.4))
    net = torch_net(cfg, params)
    with torch.no_grad():
        got = window.WindowScoreFn(lambda w, tt: net(w, tt), 2, chunk_size=3)(t(x), 0.4)
    close(got, want)


def test_short_trajectory_raises():
    with pytest.raises(ValueError):
        window.WindowScoreFn(lambda w, tt: w, 2)(torch.zeros(4, 2, 2, 1), 0.0)
