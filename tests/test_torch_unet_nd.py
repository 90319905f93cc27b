"""The port's 1-, 2- and 3-D UNet and ScoreUNet against the flax modules
(climate2weather_tpu/models/unet.py, score_net.py) on the same parameters
carried through ``convert``, fp32, at rtol/atol 2e-4 (the repository's
parity bar, tests/test_import_snapshot.py); gradients of the 3-D net; the
N-d layouts of ``convert`` and ``init_params``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import close, n, t

# a spatial size per rank: 32 positions in 1-D, 16 x 16, 8 x 8 x 8
SIZES = {1: (32,), 2: (16, 16), 3: (8, 8, 8)}


def _cfg(spatial, attention=True, **extra):
    return {"channels": 6, "embedding_dim": 16, "noise_features": 8, "hidden_channels": [8, 16],
            "hidden_blocks": [1, 1], "attention_levels": [1] if attention else [], "kernel_size": 3,
            "spatial": spatial, **extra}


def _jax_net(cfg, seed=1):
    from climate2weather_tpu.models.score_net import build_score_unet

    net = build_score_unet(cfg, dtype=jnp.float32, use_pallas_attention=False)
    x = jnp.zeros((1, *SIZES[cfg["spatial"]], cfg["channels"]))
    params = net.init(jax.random.PRNGKey(seed), x, jnp.ones((1,)))
    return net, jax.tree.map(np.asarray, params)


def _port_net(cfg, params):
    from climate2weather_tpu_torch.convert import load_params
    from climate2weather_tpu_torch.models.score_net import build_score_unet

    return load_params(build_score_unet(cfg, dtype=torch.float32), params).eval()


def _inputs(spatial, batch=2, seed=0):
    rng = np.random.RandomState(seed + spatial)
    return rng.randn(batch, *SIZES[spatial], 6).astype(np.float32), rng.rand(batch).astype(np.float32)


@pytest.mark.parametrize("attention", [True, False])
@pytest.mark.parametrize("spatial", [1, 2, 3])
def test_score_unet_matches_flax(spatial, attention):
    cfg = _cfg(spatial, attention)
    net, params = _jax_net(cfg)
    x, ts = _inputs(spatial)
    want = net.apply(params, jnp.asarray(x), jnp.asarray(ts))
    with torch.no_grad():
        got = _port_net(cfg, params)(t(x), t(ts))
    assert got.shape == x.shape
    close(got, want)


@pytest.mark.parametrize("spatial", [1, 3])
def test_norm_ddof_1_matches_flax(spatial):
    """The imported snapshots' unbiased channel norm through every norm of
    a 1-D and a 3-D net (blocks, attention, tails)."""
    cfg = _cfg(spatial, norm_ddof=1)
    net, params = _jax_net(cfg, seed=3)
    x, ts = _inputs(spatial, seed=5)
    want = net.apply(params, jnp.asarray(x), jnp.asarray(ts))
    with torch.no_grad():
        got = _port_net(cfg, params)(t(x), t(ts))
    close(got, want)


def test_3d_gradients_match_flax():
    """d(sum(w * net(x, t))) by the input and by every parameter, the port's
    autograd (the attention's custom Function on the CPU) against jax.grad;
    limit 2e-4 of each gradient's largest magnitude (atol) and rtol 2e-4."""
    from climate2weather_tpu_torch.convert import to_flax_params

    cfg = _cfg(3)
    net, params = _jax_net(cfg, seed=2)
    x, ts = _inputs(3, seed=7)
    w = np.random.RandomState(9).randn(*x.shape).astype(np.float32)

    def loss(p, xx):
        return jnp.sum(net.apply(p, xx, jnp.asarray(ts)) * w)

    gp, gx = jax.grad(loss, argnums=(0, 1))(params, jnp.asarray(x))
    port = _port_net(cfg, params)
    tx = t(x).requires_grad_(True)
    (port(tx, t(ts)) * t(w)).sum().backward()
    want_x = np.asarray(gx)
    close(tx.grad, want_x, atol=2e-4 * np.abs(want_x).max())
    got_p = to_flax_params({k: p.grad for k, p in port.named_parameters()})["params"]
    flat_want = jax.tree_util.tree_flatten_with_path(gp["params"])[0]
    assert len(flat_want) == len(list(port.parameters()))
    for path, want in flat_want:
        node = got_p
        for key in path:
            node = node[key.key]
        want = np.asarray(want)
        close(node, want, atol=2e-4 * max(np.abs(want).max(), 1e-6))


@pytest.mark.parametrize("spatial", [1, 3])
def test_blocks_match_flax(spatial):
    """ModResidualBlock and AttentionBlock alone at rank 1 and 3."""
    from climate2weather_tpu.models.unet import AttentionBlock as JaxAttn
    from climate2weather_tpu.models.unet import ModResidualBlock as JaxBlock
    from climate2weather_tpu_torch.convert import load_params
    from climate2weather_tpu_torch.models.unet import AttentionBlock, ModResidualBlock

    rng = np.random.RandomState(spatial)
    x = rng.randn(2, *SIZES[spatial], 8).astype(np.float32)
    emb = rng.randn(2, 16).astype(np.float32)
    jblk = JaxBlock(8, spatial=spatial, dtype=jnp.float32, norm_ddof=1)
    bp = jax.tree.map(np.asarray, jblk.init(jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(emb)))
    blk = load_params(ModResidualBlock(8, 16, dtype=torch.float32, norm_ddof=1, spatial=spatial), bp)
    jattn = JaxAttn(8, dtype=jnp.float32)
    ap = jax.tree.map(np.asarray, jattn.init(jax.random.PRNGKey(1), jnp.asarray(x)))
    attn = load_params(AttentionBlock(8, dtype=torch.float32), ap)
    with torch.no_grad():
        got_b = blk(t(x).movedim(-1, 1), t(emb)).movedim(1, -1)
        got_a = attn(t(x).movedim(-1, 1)).movedim(1, -1)
    close(got_b, jblk.apply(bp, jnp.asarray(x), jnp.asarray(emb)))
    close(got_a, jattn.apply(ap, jnp.asarray(x)))


@pytest.mark.parametrize("spatial", [1, 3])
def test_nearest_upsample_nd(spatial):
    from climate2weather_tpu.models.unet import nearest_upsample as jax_up
    from climate2weather_tpu_torch.models.unet import nearest_upsample

    x = np.random.RandomState(0).randn(2, *(s // 2 for s in SIZES[spatial]), 5).astype(np.float32)
    got = nearest_upsample(t(x).movedim(-1, 1), 2).movedim(1, -1)
    np.testing.assert_array_equal(n(got), np.asarray(jax_up(jnp.asarray(x), 2, spatial)))


@pytest.mark.parametrize("spatial", [1, 2, 3])
def test_convert_round_trip_exact(spatial):
    """to_state_dict and to_flax_params are inverse, bit for bit, with the
    conv kernels in (D)(H)WIO <-> OI(D)(H)W."""
    from climate2weather_tpu_torch.convert import to_flax_params, to_state_dict

    _, params = _jax_net(_cfg(spatial))
    sd = to_state_dict(params)
    w = sd["unet.head0.weight"]
    assert tuple(w.shape) == (8, 6) + (3,) * spatial
    k = params["params"]["unet"]["head0"]["kernel"]
    assert np.array_equal(n(w), np.transpose(k, (spatial + 1, spatial, *range(spatial))))
    back = to_flax_params(sd)

    def flat(tree):
        return {jax.tree_util.keystr(p): np.asarray(a) for p, a in jax.tree_util.tree_flatten_with_path(tree)[0]}

    fb, fp = flat(back), flat(params)
    assert fb.keys() == fp.keys()
    assert all(fb[k].shape == fp[k].shape and np.array_equal(fb[k], fp[k]) for k in fp)


@pytest.mark.parametrize("spatial", [1, 3])
def test_init_params_lecun_fan_in(spatial):
    """init_params draws a rank-d conv's kernel with flax's lecun-normal
    fan-in, C k^d: the drawn std of a conv with fan-in 64 * 3^d is within
    3 % of 1/sqrt(fan_in), and the biases are zero."""
    from climate2weather_tpu_torch.models.init import init_params
    from climate2weather_tpu_torch.models.unet import _Conv

    conv = _Conv(64, 256, 3, 1, torch.float32, spatial)
    init_params(conv, torch.Generator().manual_seed(0))
    fan_in = 64 * 3**spatial
    w = conv.weight.detach()
    assert abs(float(w.std()) * np.sqrt(fan_in) - 1.0) < 0.03
    assert float(w.abs().max()) <= 2.0 / np.sqrt(fan_in) / 0.87962566103423978 + 1e-6
    assert not conv.bias.any()


def test_channels_last_views():
    """The 3-D net takes a channels-last input as a channels_last_3d view,
    and the 1-D net its [B, C, L] view; the output comes back channels-last
    with the input's shape."""
    from climate2weather_tpu_torch.models.score_net import build_score_unet

    seen = {}
    for spatial, fmt in ((3, torch.channels_last_3d), (1, None)):
        net = build_score_unet(_cfg(spatial), dtype=torch.float32).eval()
        net.unet.head0.register_forward_pre_hook(lambda m, a, s=spatial: seen.__setitem__(s, a[0]))
        x = torch.randn(2, *SIZES[spatial], 6)
        with torch.no_grad():
            out = net(x, 0.5)
        assert out.shape == x.shape
        if fmt is not None:
            assert seen[spatial].is_contiguous(memory_format=fmt)
        else:
            assert seen[spatial].stride() == (SIZES[1][0] * 6, 1, 6)
