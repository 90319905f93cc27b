"""climate2weather_tpu_torch.ops.attention against the Pallas kernel (run in
interpret mode) and the port's AttentionBlock against the flax block."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import close, cuda_device, t  # noqa: F401 (fixture)
from climate2weather_tpu.ops.attention import fused_attention as jax_fused_attention
from climate2weather_tpu_torch.ops import attention as port


@pytest.mark.parametrize("shape", [(4, 64, 128), (2, 64, 512), (3, 16, 40)])
def test_reference_matches_pallas_kernel(shape):
    rng = np.random.RandomState(sum(shape))
    q, k, v = (rng.randn(*shape).astype(np.float32) for _ in range(3))
    want = jax_fused_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), True)
    got = port.attention_reference(t(q), t(k), t(v))
    close(got, want)


def test_wrapper_takes_plain_version_on_cpu_without_counting():
    rng = np.random.RandomState(0)
    qkv = t(rng.randn(2, 16, 3 * 24))
    q, k, v = qkv.chunk(3, dim=-1)
    before = dict(port.launch_counts)
    got = port.fused_attention(q, k, v)
    assert port.launch_counts == before
    assert torch.equal(got, port.attention_reference(q, k, v))


def test_reference_keeps_input_dtype():
    rng = np.random.RandomState(1)
    q = t(rng.randn(2, 8, 16)).to(torch.bfloat16)
    out = port.attention_reference(q, q, q)
    assert out.dtype == torch.bfloat16 and out.shape == q.shape


@pytest.mark.parametrize("num_heads", [1, 2])
def test_attention_block_matches_flax(num_heads):
    from climate2weather_tpu.models.unet import AttentionBlock as JaxBlock
    from climate2weather_tpu_torch.convert import load_params
    from climate2weather_tpu_torch.models.unet import AttentionBlock

    rng = np.random.RandomState(2)
    x = rng.randn(3, 8, 8, 32).astype(np.float32)
    blk = JaxBlock(32, num_heads=num_heads, dtype=jnp.float32, use_pallas=num_heads == 1)
    init_blk = JaxBlock(32, num_heads=num_heads, dtype=jnp.float32, use_pallas=False)
    params = jax.tree.map(np.asarray, init_blk.init(jax.random.PRNGKey(1), jnp.asarray(x)))
    import climate2weather_tpu.ops.attention as attn_mod

    orig = attn_mod.fused_attention
    attn_mod.fused_attention = lambda q, k, v, interpret=False: orig(q, k, v, True)
    try:
        want = blk.apply(params, jnp.asarray(x))
    finally:
        attn_mod.fused_attention = orig
    port_blk = AttentionBlock(32, num_heads=num_heads, dtype=torch.float32)
    load_params(port_blk, params)
    with torch.no_grad():
        got = port_blk(t(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    close(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(96, 64, 512), (3, 16, 40), (2, 128, 64)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_matches_plain_version_on_card(cuda_device, shape, dtype):
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device=cuda_device).manual_seed(0)
    b, s, c = shape
    qkv = torch.randn((b, s, 3 * c), generator=g, device=cuda_device).to(dtype)
    q, k, v = qkv.chunk(3, dim=-1)
    before = port.launch_counts["attention_fwd"]
    got = port.fused_attention(q, k, v)
    assert port.launch_counts["attention_fwd"] == before + 1
    want = port.attention_reference(q, k, v)
    scale = float(want.float().abs().max())
    tol = 1e-5 * max(scale, 1.0) if dtype == torch.float32 else 2.0 ** (np.floor(np.log2(scale)) - 7)
    assert float((got.float() - want.float()).abs().max()) <= tol


@pytest.mark.cuda
def test_kernel_wrapper_rejects_what_it_does_not_take(cuda_device):
    x = torch.zeros((2, 16, 12), device=cuda_device)
    with pytest.raises(ValueError):
        port.fused_attention(x, x, x)  # C not a multiple of 8
    y = torch.zeros((2, 256, 16), device=cuda_device)
    with pytest.raises(ValueError):
        port.fused_attention(y, y, y)  # T beyond shared memory
    z = torch.zeros((2, 16, 16), device=cuda_device, dtype=torch.float16)
    with pytest.raises(TypeError):
        port.fused_attention(z, z, z)
