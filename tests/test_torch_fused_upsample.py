"""The port's fused nearest-upsample tail (``NearestUpConv2x``) against JAX's
(climate2weather_tpu/models/unet.py:130-199) on the same parameters, and the
fused and plain port UNets against each other and against JAX's. fp32
limits: 1e-5 for one tail (the JAX test's own, tests/test_fused_upsample.py),
rtol/atol 2e-4 for whole nets (tests/test_import_snapshot.py); bf16 limits
stated where used."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import close, n, t


def _jax_tail(shape, out=12, dtype=jnp.float32):
    from climate2weather_tpu.models.unet import NearestUpConv2x as JaxFused

    x = jax.random.normal(jax.random.PRNGKey(0), shape)
    fused = JaxFused(out, dtype=dtype)
    params = jax.tree.map(np.asarray, fused.init(jax.random.PRNGKey(1), x))
    return fused, params, np.asarray(x)


def _port_tail(params, cin, out, dtype=torch.float32):
    """The port's tail holding the JAX tail's parameters (HWIO -> OIHW)."""
    from climate2weather_tpu_torch.convert import to_state_dict
    from climate2weather_tpu_torch.models.unet import NearestUpConv2x

    tail = NearestUpConv2x(cin, out, dtype)
    sd = to_state_dict({"tail": params["params"]})
    tail.load_state_dict({"weight": sd["tail.weight"], "bias": sd["tail.bias"]})
    return tail


@pytest.mark.parametrize("shape", [(2, 8, 8, 16), (1, 5, 7, 8), (3, 16, 16, 4)])
def test_fused_tail_matches_jax(shape):
    fused, params, x = _jax_tail(shape)
    port = _port_tail(params, shape[-1], 12)
    with torch.no_grad():
        got = port(t(x).movedim(-1, 1)).movedim(1, -1)
    want = np.asarray(fused.apply(params, jnp.asarray(x)))
    assert got.shape == want.shape == (shape[0], 2 * shape[1], 2 * shape[2], 12)
    np.testing.assert_allclose(n(got), want, atol=1e-5)


@pytest.mark.parametrize("shape", [(2, 8, 8, 16), (1, 5, 7, 8)])
def test_fused_tail_equals_upsample_then_conv(shape):
    """The same parameters through the plain tail (upsample, then the 3x3
    conv), in the port: the rewrite is exact up to fp32 summation order."""
    from climate2weather_tpu_torch.models.unet import _Conv, nearest_upsample

    _, params, x = _jax_tail(shape)
    port = _port_tail(params, shape[-1], 12)
    plain = _Conv(shape[-1], 12, 3, 1, torch.float32)
    plain.load_state_dict(port.state_dict())
    with torch.no_grad():
        xc = t(x).movedim(-1, 1)
        np.testing.assert_allclose(n(port(xc)), n(plain(nearest_upsample(xc, 2))), atol=1e-5)


def test_fused_tail_bf16_matches_jax_fused():
    """In bf16 both round each quarter conv to bf16 and then add the bf16
    bias; the port's CPU conv and XLA's may round an fp32 sum that lies
    near a tie differently, so the limit is two bf16 ulps of the output's
    largest magnitude; the plain tail is further off (reported, not gated)."""
    shape = (2, 8, 8, 32)
    fused, params, x = _jax_tail(shape, out=16, dtype=jnp.bfloat16)
    port = _port_tail(params, 32, 16, torch.bfloat16)
    with torch.no_grad():
        got = n(port(t(x).movedim(-1, 1)).movedim(1, -1).float())
    want = np.asarray(fused.apply(params, jnp.asarray(x)).astype(jnp.float32))
    ulp = 2.0 ** (np.floor(np.log2(np.abs(want).max())) - 7)
    assert np.abs(got - want).max() <= 2 * ulp


def _unet_kw(**kw):
    return dict(out_channels=6, mod_features=16, hidden_channels=(8, 16, 24), hidden_blocks=(1, 1, 1),
                attention_levels=(2,), **kw)


def _port_unet(params, **kw):
    from climate2weather_tpu_torch.convert import load_params
    from climate2weather_tpu_torch.models.unet import UNet

    kw = _unet_kw(**kw)
    net = UNet(6, kw.pop("out_channels"), kw.pop("mod_features"), dtype=torch.float32, **kw)
    return load_params(net, params).eval()


@pytest.mark.parametrize("stride", [2, 3])
def test_unet_fused_matches_jax_and_unfused(stride):
    """UNet(fused_upsample=True) against JAX's on the same tree, and
    against the port's unfused UNet on the same parameters. At stride 3
    both fall back to the materialized upsample (no NearestUpConv2x)."""
    from climate2weather_tpu.models.unet import UNet as JaxUNet
    from climate2weather_tpu_torch.models.unet import NearestUpConv2x

    size = 16 if stride == 2 else 18
    x = jax.random.normal(jax.random.PRNGKey(0), (2, size, size, 6))
    emb = jax.random.normal(jax.random.PRNGKey(1), (2, 16))
    jnet = JaxUNet(fused_upsample=True, stride=stride, dtype=jnp.float32, **_unet_kw())
    params = jax.tree.map(np.asarray, jnet.init(jax.random.PRNGKey(2), x, emb))
    want = np.asarray(jnet.apply(params, x, emb))
    fused = _port_unet(params, fused_upsample=True, stride=stride)
    plain = _port_unet(params, fused_upsample=False, stride=stride)
    assert fused.state_dict().keys() == plain.state_dict().keys()
    tails = [type(getattr(fused, f"tail{i}")) for i in (1, 2)]
    assert all((c is NearestUpConv2x) == (stride == 2) for c in tails)
    with torch.no_grad():
        xc, e = t(np.asarray(x)).movedim(-1, 1), t(np.asarray(emb))
        got_f = fused(xc, e).movedim(1, -1)
        got_u = plain(xc, e).movedim(1, -1)
    close(got_f, want)
    np.testing.assert_allclose(n(got_f), n(got_u), atol=2e-5, rtol=1e-5)


@pytest.mark.parametrize("spatial", [1, 3])
def test_fused_option_falls_back_off_2d(spatial):
    """fused_upsample on a 1-D or 3-D net builds the plain tails, as JAX does."""
    from climate2weather_tpu_torch.models.score_net import build_score_unet
    from climate2weather_tpu_torch.models.unet import NearestUpConv2x

    net = build_score_unet({"channels": 4, "hidden_channels": [8, 8], "hidden_blocks": [1, 1],
                            "spatial": spatial, "fused_upsample": True}, dtype=torch.float32)
    assert not net.unet.fused_upsample
    assert not any(isinstance(m, NearestUpConv2x) for m in net.modules())


def test_score_unet_fused_matches_flax_and_gradients_flow():
    """build_score_unet(fused_upsample=True) against JAX's ScoreUNet on the
    same tree, and a gradient reaching the fused tail's kernel and bias."""
    from climate2weather_tpu.models.score_net import build_score_unet as jax_build
    from climate2weather_tpu_torch.convert import load_params
    from climate2weather_tpu_torch.models.score_net import build_score_unet

    cfg = {"channels": 6, "embedding_dim": 16, "noise_features": 8, "hidden_channels": [8, 16],
           "hidden_blocks": [1, 1], "attention_levels": [1], "fused_upsample": True}
    jnet = jax_build(cfg, dtype=jnp.float32, use_pallas_attention=False)
    rng = np.random.RandomState(3)
    x, ts = rng.randn(2, 16, 16, 6).astype(np.float32), rng.rand(2).astype(np.float32)
    params = jax.tree.map(np.asarray, jnet.init(jax.random.PRNGKey(4), jnp.asarray(x), jnp.asarray(ts)))
    port = load_params(build_score_unet(cfg, dtype=torch.float32), params)
    out = port(t(x), t(ts))
    close(out.detach(), jnet.apply(params, jnp.asarray(x), jnp.asarray(ts)))
    (out**2).sum().backward()
    g = port.unet.tail1.weight.grad
    assert g.shape == (8, 16, 3, 3) and float(g.abs().sum()) > 0 and float(port.unet.tail1.bias.grad.abs().sum()) > 0
