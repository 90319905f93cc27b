"""Shared helpers of the tests that hold climate2weather_tpu_torch against
the JAX package: inputs made with numpy, passed to both sides as arrays."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

# the repository's bar for fp32 parity (tests/test_import_snapshot.py)
RTOL = ATOL = 2e-4


def t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def n(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(n(got), n(want), rtol=rtol, atol=atol)


def tiny_config(channels: int, window: int, attention=True) -> dict:
    """Snapshot config of a tiny 2-level ScoreUNet."""
    return {
        "dataset_kwargs": {"train": {"window": window, "num_features": channels // window}},
        "network_kwargs": {
            "channels": channels, "embedding_dim": 32, "noise_features": 8,
            "hidden_channels": [8, 16], "hidden_blocks": [1, 1],
            "attention_levels": [1] if attention else [], "kernel_size": 3,
        },
        "pipeline_kwargs": {"class_name": "vp_cosine"},
    }


def jax_net_and_params(config: dict, hw: int = 16, seed: int = 1):
    """The JAX ScoreUNet (fp32) of ``config`` with freshly initialized params
    as numpy arrays."""
    from climate2weather_tpu.models.score_net import build_score_unet

    net = build_score_unet(config["network_kwargs"], dtype=jnp.float32, use_pallas_attention=False)
    c = config["network_kwargs"]["channels"]
    params = net.init(jax.random.PRNGKey(seed), jnp.zeros((1, hw, hw, c)), jnp.ones((1,)))
    return net, jax.tree.map(np.asarray, params)


def write_snapshot(tmp_path, config: dict, params) -> str:
    """A snapshot directory written by the JAX package's own writer."""
    from climate2weather_tpu.training.checkpoint import save_snapshot

    return save_snapshot(str(tmp_path), 1, "0.999900", params, config)


def torch_net(config: dict, params, dtype=torch.float32):
    from climate2weather_tpu_torch.convert import load_params
    from climate2weather_tpu_torch.models.score_net import build_score_unet

    net = build_score_unet(config["network_kwargs"], dtype=dtype)
    return load_params(net, params).eval()


def jax_split_normals(key, steps: int, shape):
    """The per-step z of the JAX SDE sampler: ``key, sub = split(key)``,
    ``normal(sub)`` at every step (sampler.py:210-211)."""
    zs = []
    for _ in range(steps):
        key, sub = jax.random.split(key)
        zs.append(np.asarray(jax.random.normal(sub, shape, jnp.float32)))
    return np.stack(zs)


@pytest.fixture
def cuda_device():
    """The card, or a skip where there is none (decided at run time)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels do not run on the CPU")
    return torch.device("cuda", 0)
