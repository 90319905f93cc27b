"""The port's UNet and ScoreUNet against the flax modules, on converted
params: the tiny conftest-style net, unit pieces, and the 72.1M snapshot."""

import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import close, jax_net_and_params, t, tiny_config, torch_net

REPO = pathlib.Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("ddof", [0, 1])
def test_channel_norm(ddof):
    from climate2weather_tpu.models.unet import channel_norm as jax_norm
    from climate2weather_tpu_torch.models.unet import channel_norm

    x = np.random.RandomState(ddof).randn(2, 5, 5, 12).astype(np.float32) * 3 + 1
    close(channel_norm(t(x), ddof=ddof, dim=-1), jax_norm(jnp.asarray(x), ddof=ddof))


@pytest.mark.parametrize("dim", [8, 9, 32])
def test_timestep_embedding(dim):
    from climate2weather_tpu.models.score_net import timestep_embedding as jax_emb
    from climate2weather_tpu_torch.models.score_net import timestep_embedding

    ts = np.linspace(0, 1, 7).astype(np.float32)
    close(timestep_embedding(t(ts), dim), jax_emb(jnp.asarray(ts), dim))


def test_nearest_upsample():
    from climate2weather_tpu.models.unet import nearest_upsample as jax_up
    from climate2weather_tpu_torch.models.unet import nearest_upsample

    x = np.random.RandomState(0).randn(2, 3, 4, 5).astype(np.float32)  # NHWC
    got = nearest_upsample(t(x).permute(0, 3, 1, 2), 2).permute(0, 2, 3, 1)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jax_up(jnp.asarray(x), 2, 2)))


@pytest.mark.parametrize("attention", [True, False])
@pytest.mark.parametrize("batch_t", [1, 3])
def test_tiny_score_unet_matches_flax(attention, batch_t):
    cfg = tiny_config(channels=10, window=5, attention=attention)
    net, params = jax_net_and_params(cfg)
    rng = np.random.RandomState(batch_t)
    x = rng.randn(3, 16, 16, 10).astype(np.float32)
    ts = rng.rand(batch_t).astype(np.float32)
    want = net.apply(params, jnp.asarray(x), jnp.asarray(ts))
    with torch.no_grad():
        got = torch_net(cfg, params)(t(x), t(ts))
    close(got, want)


def test_forcing_path_matches_flax():
    cfg = tiny_config(channels=10, window=5)
    cfg["network_kwargs"]["forcing_dim"] = 3
    from climate2weather_tpu.models.score_net import build_score_unet as jax_build

    net = jax_build(cfg["network_kwargs"], dtype=jnp.float32, use_pallas_attention=False)
    rng = np.random.RandomState(4)
    x = rng.randn(2, 16, 16, 10).astype(np.float32)
    ts = rng.rand(2).astype(np.float32)
    f = rng.randn(2, 3).astype(np.float32)
    params = jax.tree.map(np.asarray, net.init(jax.random.PRNGKey(2), jnp.asarray(x), jnp.asarray(ts),
                                               jnp.asarray(f)))
    want = net.apply(params, jnp.asarray(x), jnp.asarray(ts), jnp.asarray(f))
    with torch.no_grad():
        got = torch_net(cfg, params)(t(x), t(ts), t(f))
    close(got, want)


def test_conftest_tiny_net_converts(tiny_net):
    """The conftest ``tiny_net`` (its own module layout) through convert.py."""
    from climate2weather_tpu_torch.convert import load_params
    from climate2weather_tpu_torch.models.score_net import ScoreUNet

    net, params, C, window = tiny_net
    port = ScoreUNet(channels=C * window, embedding_dim=32, noise_features=8, hidden_channels=(8, 16),
                     hidden_blocks=(1, 1), attention_levels=(1,), dtype=torch.float32)
    load_params(port, jax.tree.map(np.asarray, params))
    x = np.random.RandomState(5).randn(2, 16, 16, C * window).astype(np.float32)
    want = net.apply(params, jnp.asarray(x), jnp.ones((1,)) * 0.3)
    with torch.no_grad():
        got = port.eval()(t(x), 0.3)
    close(got, want)


def test_bf16_compute_keeps_fp32_params_and_bf16_output():
    cfg = tiny_config(channels=10, window=5)
    _, params = jax_net_and_params(cfg)
    net = torch_net(cfg, params, dtype=torch.bfloat16)
    assert all(p.dtype == torch.float32 for p in net.parameters())
    with torch.no_grad():
        out = net(torch.zeros(2, 16, 16, 10), 0.5)
    assert out.dtype == torch.bfloat16 and out.shape == (2, 16, 16, 10)


def test_build_score_unet_rejects_unported_options():
    """Only a spatial rank outside 1-3 is refused (torch has no Conv4d);
    ``fused_upsample`` and the 1-D and 3-D nets are built."""
    from climate2weather_tpu_torch.models.score_net import build_score_unet
    from climate2weather_tpu_torch.models.unet import NearestUpConv2x

    for spatial in (0, 4):
        with pytest.raises(NotImplementedError):
            build_score_unet({"channels": 4, "spatial": spatial})
    net = build_score_unet({"channels": 4, "fused_upsample": True})
    assert net.unet.fused_upsample and isinstance(net.unet.tail1, NearestUpConv2x)
    for spatial in (1, 3):
        net = build_score_unet({"channels": 4, "spatial": spatial})
        assert net.unet.head0.weight.dim() == spatial + 2


def test_artifact_72m_matches_flax_at_32x32():
    """The converted 72.1M snapshot against flax ``apply`` (fp32, no jit)."""
    from climate2weather_tpu.models.score_net import build_score_unet as jax_build
    from climate2weather_tpu.training.checkpoint import load_snapshot as jax_load
    from climate2weather_tpu_torch.io.snapshot import load_snapshot

    snap = str(REPO / "artifacts" / "network-snapshot-0009437-0.999900")
    params, cfg = load_snapshot(snap)
    port = torch_net(cfg, params)
    assert sum(p.numel() for p in port.parameters()) == 72_102_964
    jparams, jcfg = jax_load(snap)
    jnet = jax_build(jcfg["network_kwargs"], dtype=jnp.float32, use_pallas_attention=False)
    rng = np.random.RandomState(0)
    x = rng.randn(2, 32, 32, 52).astype(np.float32)
    ts = np.array([0.9, 0.05], np.float32)
    want = jnet.apply(jparams, jnp.asarray(x), jnp.asarray(ts))
    with torch.no_grad():
        got = port(t(x), t(ts))
    close(got, want)
