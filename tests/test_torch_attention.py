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


@pytest.mark.parametrize("shape", [(4, 64, 128), (2, 64, 512), (3, 16, 40), (2, 256, 32)])
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
@pytest.mark.parametrize("shape", [(96, 64, 512), (3, 16, 40), (2, 128, 64), (8, 256, 32),
                                   (4, 256, 512), (4, 200, 64), (2, 1024, 64), (4, 64, 768),
                                   (4, 256, 768)])
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
@pytest.mark.parametrize("shape", [(96, 64, 512), (32, 64, 512), (3, 16, 40), (4, 64, 768),
                                   (5, 49, 64)])
def test_bf16_kernel_equals_plain_version_where_keys_fit_one_tile(cuda_device, shape):
    """At T <= 64 the bf16 route runs the plain version's fp32 arithmetic in
    its own order: every output equals the plain version's."""
    torch.backends.cuda.matmul.allow_tf32 = False
    b, tt, c = shape
    g = torch.Generator(device=cuda_device).manual_seed(sum(shape))
    qkv = torch.randn((b, tt, 3 * c), generator=g, device=cuda_device).to(torch.bfloat16)
    q, k, v = qkv.chunk(3, dim=-1)
    assert torch.equal(port.fused_attention(q, k, v), port.attention_reference(q, k, v))


@pytest.mark.cuda
def test_kernel_wrapper_rejects_what_it_does_not_take(cuda_device):
    x = torch.zeros((2, 16, 12), device=cuda_device)
    with pytest.raises(ValueError):
        port.fused_attention(x, x, x)  # C not a multiple of 8
    y = torch.zeros((2, 16, 4096), device=cuda_device)
    with pytest.raises(ValueError, match="supported"):
        port.fused_attention(y, y, y)  # C beyond the forward's shared memory
    long = torch.zeros((1, 8193, 8), device=cuda_device)
    with pytest.raises(ValueError, match="supported range"):
        port.attention_bwd(long, long, long, long)  # T beyond the backward's range
    z = torch.zeros((2, 16, 16), device=cuda_device, dtype=torch.float16)
    with pytest.raises(TypeError):
        port.fused_attention(z, z, z)
    rows = torch.zeros((2, 16, 50), device=cuda_device, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="16-byte"):
        port.fused_attention(*rows[..., :48].chunk(3, dim=-1))  # rows of 100 bytes
    do = torch.zeros((2, 16, 16), device=cuda_device, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="16-byte"):
        port.attention_bwd(*rows[..., :48].chunk(3, dim=-1), do)  # the backward's too


@pytest.mark.parametrize("shape", [(2, 64, 32), (3, 16, 40), (2, 256, 32)])
def test_gradients_match_jax_vjp_of_pallas_kernel(shape):
    """``fused_attention``'s gradients on the CPU (the Function with
    ``attention_bwd_reference``) against ``jax.vjp`` of the Pallas kernel in
    interpret mode; rtol/atol 2e-4."""
    rng = np.random.RandomState(sum(shape) + 7)
    q, k, v, do = (rng.randn(*shape).astype(np.float32) for _ in range(4))
    _, vjp = jax.vjp(lambda a, b, c: jax_fused_attention(a, b, c, True),
                     jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = vjp(jnp.asarray(do))
    tq, tk, tv = (t(x).requires_grad_(True) for x in (q, k, v))
    port.fused_attention(tq, tk, tv).backward(t(do))
    for got, w in zip((tq.grad, tk.grad, tv.grad), want):
        close(got, w)


def test_bwd_reference_is_autograd_of_the_forward():
    """The step-by-step backward equals autograd through the plain forward
    (fp32, rtol/atol 2e-4), and keeps bf16 inputs' dtype."""
    rng = np.random.RandomState(3)
    q, k, v, do = (t(rng.randn(2, 24, 16)) for _ in range(4))
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    want = torch.autograd.grad(port.attention_reference(*leaves), leaves, do)
    for got, w in zip(port.attention_bwd_reference(q, k, v, do), want):
        close(got, w)
    half = [x.to(torch.bfloat16) for x in (q, k, v, do)]
    assert all(g.dtype == torch.bfloat16 for g in port.attention_bwd_reference(*half))


def test_function_runs_only_where_a_gradient_is_wanted(monkeypatch):
    """With grad mode on and an input that requires grad, the CPU path goes
    through ``FusedAttention`` (forward and backward wrappers); under
    ``no_grad``, as in sampling, the forward runs alone and nothing is saved
    for a backward."""
    calls = []
    real_fwd, real_bwd = port.attention_fwd, port.attention_bwd
    monkeypatch.setattr(port, "attention_fwd", lambda *a: calls.append("fwd") or real_fwd(*a))
    monkeypatch.setattr(port, "attention_bwd", lambda *a: calls.append("bwd") or real_bwd(*a))
    rng = np.random.RandomState(4)
    qkv = t(rng.randn(2, 16, 3 * 24)).requires_grad_(True)
    out = port.fused_attention(*qkv.chunk(3, dim=-1))
    assert out.grad_fn is not None and type(out.grad_fn).__name__ == "FusedAttentionBackward"
    out.sum().backward()
    assert calls == ["fwd", "bwd"] and qkv.grad is not None
    with torch.no_grad():
        out = port.fused_attention(*qkv.chunk(3, dim=-1))
    assert out.grad_fn is None and calls == ["fwd", "bwd", "fwd"]


def test_attention_block_gradients_match_flax():
    """Gradients of the AttentionBlock's parameters and input through the
    strided q/k/v thirds of its projection, against the flax block with the
    Pallas kernel in interpret mode (rtol/atol 2e-4)."""
    from climate2weather_tpu.models.unet import AttentionBlock as JaxBlock
    from climate2weather_tpu_torch.convert import load_params, to_state_dict
    from climate2weather_tpu_torch.models.unet import AttentionBlock

    rng = np.random.RandomState(5)
    x = rng.randn(2, 8, 8, 32).astype(np.float32)
    w = rng.randn(2, 8, 8, 32).astype(np.float32)
    init_blk = JaxBlock(32, dtype=jnp.float32, use_pallas=False)
    params = jax.tree.map(np.asarray, init_blk.init(jax.random.PRNGKey(2), jnp.asarray(x)))
    import climate2weather_tpu.ops.attention as attn_mod

    orig = attn_mod.fused_attention
    attn_mod.fused_attention = lambda q, k, v, interpret=False: orig(q, k, v, True)
    try:
        blk = JaxBlock(32, dtype=jnp.float32, use_pallas=True)
        want_p, want_x = jax.grad(lambda p, xx: jnp.sum(blk.apply(p, xx) * w), argnums=(0, 1))(
            params, jnp.asarray(x))
    finally:
        attn_mod.fused_attention = orig
    port_blk = AttentionBlock(32, dtype=torch.float32)
    load_params(port_blk, params)
    tx = t(x).requires_grad_(True)
    (port_blk(tx.permute(0, 3, 1, 2)).permute(0, 2, 3, 1) * t(w)).sum().backward()
    close(tx.grad, want_x)
    want_sd = to_state_dict(jax.tree.map(np.asarray, want_p))
    for name, p in port_blk.named_parameters():
        close(p.grad, want_sd[name])


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(32, 64, 512), (3, 16, 40), (2, 128, 64), (8, 256, 32),
                                   (4, 256, 512), (4, 200, 64), (2, 1024, 64)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bwd_kernel_matches_plain_version_on_card(cuda_device, shape, dtype):
    """fp32: 1e-5 of each output's scale; bf16: one ulp of it."""
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device=cuda_device).manual_seed(1)
    b, s, c = shape
    qkv = torch.randn((b, s, 3 * c), generator=g, device=cuda_device).to(dtype)
    q, k, v = qkv.chunk(3, dim=-1)
    do = torch.randn((b, s, c), generator=g, device=cuda_device).to(dtype)
    before = port.launch_counts["attention_bwd"]
    got = port.attention_bwd(q, k, v, do)
    assert port.launch_counts["attention_bwd"] == before + 1
    for gt, want in zip(got, port.attention_bwd_reference(q, k, v, do)):
        scale = float(want.float().abs().max())
        tol = 1e-5 * scale if dtype == torch.float32 else 2.0 ** (np.floor(np.log2(scale)) - 7)
        assert gt.dtype == dtype and gt.is_contiguous()
        assert float((gt.float() - want.float()).abs().max()) <= tol


@pytest.mark.cuda
def test_gradients_reach_qkv_through_the_kernels_on_card(cuda_device):
    """The repair: on CUDA tensors the kernels' output carries a grad_fn, and
    the qkv projection's gradient is the plain backward's (1e-5 of scale)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device=cuda_device).manual_seed(2)
    qkv = torch.randn((4, 64, 3 * 64), generator=g, device=cuda_device, requires_grad=True)
    do = torch.randn((4, 64, 64), generator=g, device=cuda_device)
    before = dict(port.launch_counts)
    out = port.fused_attention(*qkv.chunk(3, dim=-1))
    assert out.grad_fn is not None
    out.backward(do)
    assert port.launch_counts["attention_fwd"] == before["attention_fwd"] + 1
    assert port.launch_counts["attention_bwd"] == before["attention_bwd"] + 1
    want = torch.cat(port.attention_bwd_reference(*qkv.detach().chunk(3, dim=-1), do), dim=-1)
    assert float((qkv.grad - want).abs().max()) <= 1e-5 * float(want.abs().max())


@pytest.mark.parametrize("control", ["one_output_moved", "logits_exact", "pv_exact"])
def test_smoke_network_controls_move_the_attention_by_at_most_one_ulp(control):
    """chip_smoke.py phase 3 reads, beside the kernel, the forward with the
    plain attention changed in one output, or with either product summed in
    float64: each stays within one bf16 ulp of the plain version, and one
    moved output is exactly one output one ulp away."""
    import chip_smoke

    rng = np.random.RandomState(5)
    qkv = t(rng.randn(4, 64, 3 * 32)).to(torch.bfloat16)
    q, k, v = qkv.chunk(3, dim=-1)
    want = port.attention_reference(q, k, v)
    if control == "one_output_moved":
        got = chip_smoke._one_output_moved(q, k, v, torch.Generator().manual_seed(0))
    else:
        got = getattr(chip_smoke, f"_{control}")(q, k, v)
    assert got.dtype == want.dtype and got.shape == want.shape
    ulp = 2.0 ** (np.floor(np.log2(float(want.float().abs().max()))) - 7)
    assert float((got.float() - want.float()).abs().max()) <= ulp
    if control == "one_output_moved":
        moved = (got.view(torch.int16).int() - want.view(torch.int16).int()).abs()
        assert int((moved != 0).sum()) == 1 and int(moved.max()) == 1


def _bwd_inputs(device, b, tt, c, seed):
    """q, k, v as the strided thirds of one bf16 [B, T, 3C] projection, and dO."""
    g = torch.Generator(device=device).manual_seed(seed)
    qkv = torch.randn((b, tt, 3 * c), generator=g, device=device).to(torch.bfloat16)
    do = torch.randn((b, tt, c), generator=g, device=device).to(torch.bfloat16)
    return (*qkv.chunk(3, dim=-1), do)


@pytest.mark.cuda
@pytest.mark.parametrize("tt", [1, 16, 63, 64, 65, 200, 256, 1024])
@pytest.mark.parametrize("c", [32, 40, 512, 768])
def test_bf16_bwd_kernel_matches_plain_version_across_its_routes(cuda_device, tt, c):
    """The bf16 backward (one kernel where T <= 64, three past it; one to six
    channel slices) within one bf16 ulp of each output's scale of its plain
    version."""
    torch.backends.cuda.matmul.allow_tf32 = False
    q, k, v, do = _bwd_inputs(cuda_device, 2, tt, c, 1000 * tt + c)
    got = port.attention_bwd(q, k, v, do)
    for gt, want in zip(got, port.attention_bwd_reference(q, k, v, do)):
        scale = float(want.float().abs().max())
        tol = 2.0 ** (np.floor(np.log2(scale)) - 7) if scale > 0 else 0.0
        assert gt.dtype == torch.bfloat16 and gt.is_contiguous()
        assert float((gt.float() - want.float()).abs().max()) <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(32, 64, 512), (4, 65, 768), (3, 200, 40), (2, 1024, 64)])
def test_bf16_bwd_kernel_gives_the_same_bits_twice(cuda_device, shape):
    """No atomics: two calls on the same inputs give the same bits."""
    q, k, v, do = _bwd_inputs(cuda_device, *shape, sum(shape))
    first = port.attention_bwd(q, k, v, do)
    second = port.attention_bwd(q, k, v, do)
    assert all(torch.equal(a, b) for a, b in zip(first, second))
