"""climate2weather_tpu_torch.ops.winograd against the Pallas kernel of
climate2weather_tpu/ops/winograd.py run in interpret mode, case by case as
tests/test_winograd.py holds the Pallas kernel: fp32 at rtol/atol 2e-4; in
bf16 the JAX test's bound (at most 4x the direct bf16 conv's error against
fp32). A ``cuda`` test holds the CUDA kernel against its plain version."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import close, cuda_device, n, t  # noqa: F401 (fixture)
from climate2weather_tpu.ops import winograd as W
from climate2weather_tpu_torch.ops import winograd as port


def _mk(n_=2, h=16, w=8, c=8, o=12, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(n_, h, w, c).astype(np.float32)
    k = (rng.randn(3, 3, c, o) * 0.1).astype(np.float32)
    b = rng.randn(o).astype(np.float32)
    return x, k, b, rng


def _jax(x, k, b, vec=None, res=None, pre=None, ddof=0, dtype=jnp.float32):
    J = lambda a: None if a is None else jnp.asarray(a)  # noqa: E731
    xj = jnp.asarray(x).astype(dtype)
    rj = None if res is None else jnp.asarray(res).astype(dtype)
    return W.winograd_conv3x3(xj, J(k), J(b), J(vec), rj, pre, ddof, True)


@pytest.mark.parametrize("h,w", [(16, 8), (32, 16), (8, 32), (4, 6)])
def test_matches_pallas_kernel_fp32(h, w):
    x, k, b, _ = _mk(h=h, w=w)
    want = _jax(x, k, b)
    close(port.winograd_reference(t(x), t(k), t(b)), want)
    close(port.winograd_conv3x3(t(x), t(k), t(b)), want)


@pytest.mark.parametrize("pre", [None, "norm", "silu"])
@pytest.mark.parametrize("ddof", [0, 1])
def test_fused_pre_vec_residual(pre, ddof):
    x, k, b, rng = _mk(h=32, w=16)
    vec = rng.randn(2, 8).astype(np.float32)
    res = rng.randn(2, 32, 16, 12).astype(np.float32)
    want = _jax(x, k, b, vec, res, pre, ddof)
    got = port.winograd_conv3x3(t(x), t(k), t(b), t(vec), t(res), pre, ddof)
    close(got, want)
    # and the direct composition, as JAX's _conv_ref on _apply_pre
    direct = res + W._conv_ref(W._apply_pre(jnp.asarray(x), jnp.asarray(vec), pre, ddof),
                               jnp.asarray(k), jnp.asarray(b))
    close(port.conv3x3_reference(t(x), t(k), t(b), t(vec), t(res), pre, ddof), direct)


def test_mod_residual_block_composition():
    """conv0(norm(x + proj)) -> silu -> conv1 + x as two fused calls equals
    the port's ModResidualBlock with the same weights, and the JAX
    composition of two Pallas calls."""
    from climate2weather_tpu.models.unet import ModResidualBlock as JaxBlock
    from climate2weather_tpu_torch.convert import conv_weight_hwio, load_params
    from climate2weather_tpu_torch.models.unet import ModResidualBlock

    rng = np.random.RandomState(6)
    x = rng.randn(2, 16, 16, 8).astype(np.float32)
    emb = rng.randn(2, 5).astype(np.float32)
    jblk = JaxBlock(8, dtype=jnp.float32)
    params = jax.tree.map(np.asarray, jblk.init(jax.random.PRNGKey(3), jnp.asarray(x), jnp.asarray(emb)))
    blk = ModResidualBlock(8, 5, dtype=torch.float32)
    load_params(blk, params)
    p = params["params"]
    proj = jnp.asarray(emb) @ p["project"]["kernel"] + p["project"]["bias"]
    h = W.winograd_conv3x3(jnp.asarray(x), p["conv0"]["kernel"], p["conv0"]["bias"], proj, None, "norm", 0, True)
    want = W.winograd_conv3x3(h, p["conv1"]["kernel"], p["conv1"]["bias"], None, jnp.asarray(x), "silu", 0, True)
    with torch.no_grad():
        tx = t(x)
        tproj = blk.project(t(emb))
        k0, k1 = conv_weight_hwio(blk.conv0.weight), conv_weight_hwio(blk.conv1.weight)
        th = port.winograd_conv3x3(tx, k0, blk.conv0.bias, tproj, None, "norm", 0)
        got = port.winograd_conv3x3(th, k1, blk.conv1.bias, None, tx, "silu", 0)
        block = blk(tx.permute(0, 3, 1, 2), t(emb)).permute(0, 2, 3, 1)
    close(k0, p["conv0"]["kernel"], rtol=0, atol=0)  # the HWIO view is the flax kernel
    close(got, want)
    close(got, block)
    close(block, jblk.apply(params, jnp.asarray(x), jnp.asarray(emb)))


def test_weight_transform_and_delta():
    """U = G g G^T matches the JAX transform; the conv of a centred delta
    returns the flipped kernel, Winograd included."""
    c, o = 4, 4
    rng = np.random.RandomState(1)
    k = rng.randn(3, 3, c, o).astype(np.float32)
    close(port.transform_weights(t(k)), W.transform_weights(jnp.asarray(k)))
    x = np.zeros((1, 8, 8, c), np.float32)
    x[0, 3, 3, :] = 1.0
    got = port.winograd_conv3x3(t(x), t(k), torch.zeros(o))
    close(got, _jax(x, k, np.zeros(o, np.float32)))
    close(got, W._conv_ref(jnp.asarray(x), jnp.asarray(k), jnp.zeros(o)))


def test_gradients_match_jax_vjp():
    x, k, b, rng = _mk(h=16, w=8)
    vec = rng.randn(2, 8).astype(np.float32)
    res = rng.randn(2, 16, 8, 12).astype(np.float32)

    def loss(x_, k_, b_, v_, r_):
        return jnp.sum(W.winograd_conv3x3(x_, k_, b_, v_, r_, "norm", 0, True) ** 2)

    want = jax.grad(loss, argnums=(0, 1, 2, 3, 4))(*(jnp.asarray(a) for a in (x, k, b, vec, res)))
    leaves = [t(a).requires_grad_(True) for a in (x, k, b, vec, res)]
    out = port.winograd_conv3x3(*leaves, "norm", 0)
    assert type(out.grad_fn).__name__ == "WinogradConv3x3Backward"
    (out ** 2).sum().backward()
    for got, w in zip(leaves, want):
        # the JAX test's tolerance for the VJP (tests/test_winograd.py)
        close(got.grad, w, rtol=1e-4, atol=2e-3)


def test_bf16_error_bound():
    """bf16: the Winograd conv's error against the fp32 conv is at most 4x
    the direct bf16 conv's, as tests/test_winograd.py holds the Pallas kernel;
    the port's bf16 output is the Pallas kernel's within a few bf16 ulps."""
    x, k, b, _ = _mk(n_=2, h=32, w=16, c=32, o=32, seed=3)
    out = port.winograd_conv3x3(t(x).to(torch.bfloat16), t(k), t(b))
    assert out.dtype == torch.bfloat16
    exact = n(port.conv3x3_reference(t(x), t(k), t(b)))
    direct = n(port.conv3x3_reference(t(x).to(torch.bfloat16), t(k), t(b)).float())
    wino_err = float(np.abs(n(out.float()) - exact).max())
    conv_err = float(np.abs(direct - exact).max())
    assert wino_err <= 4.0 * conv_err + 1e-6, (wino_err, conv_err)
    jax_out = np.asarray(_jax(x, k, b, dtype=jnp.bfloat16).astype(jnp.float32))
    ulp = 2.0 ** (np.floor(np.log2(np.abs(jax_out).max())) - 7)
    assert float(np.abs(n(out.float()) - jax_out).max()) <= 2 * ulp


def test_eligibility():
    assert port.winograd_eligible((2, 16, 8, 4), 3, (1, 1), 2)
    assert port.winograd_eligible((2, 16, 8, 4), (3, 3), [1, 1], 2)
    assert port.winograd_eligible((2, 16, 8, 4), 3, None, 2)
    assert port.winograd_eligible((2, 16, 8, 4), 3, 1, 2)
    assert not port.winograd_eligible((2, 15, 8, 4), 3, (1, 1), 2)
    assert not port.winograd_eligible((2, 16, 8, 4), 3, (2, 2), 2)
    assert not port.winograd_eligible((2, 16, 8, 4), 3, 2, 2)
    assert not port.winograd_eligible((2, 16, 8, 4), 5, (1, 1), 2)
    assert not port.winograd_eligible((2, 16, 8, 4), 3, (1, 1), 3)


def test_cpu_path_takes_plain_version_without_counting():
    x, k, b, _ = _mk()
    before = dict(port.launch_counts)
    got = port.winograd_conv3x3(t(x), t(k), t(b), pre="silu")
    assert port.launch_counts == before
    assert torch.equal(got, port.winograd_reference(t(x), t(k), t(b), pre="silu"))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 16, 8, 8, 12), (3, 10, 14, 40, 20), (4, 8, 8, 512, 512)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("pre", [None, "norm", "silu"])
def test_kernel_matches_plain_version_on_card(cuda_device, shape, dtype, pre):
    """fp32: 1e-5 of the output's scale; bf16: one ulp of it."""
    g = torch.Generator(device=cuda_device).manual_seed(4)
    nb, h, w, c, o = shape
    x = torch.randn((nb, h, w, c), generator=g, device=cuda_device).to(dtype)
    k = torch.randn((3, 3, c, o), generator=g, device=cuda_device) / (3 * c ** 0.5)
    b = torch.randn((o,), generator=g, device=cuda_device)
    vec = torch.randn((nb, c), generator=g, device=cuda_device).to(dtype)
    res = torch.randn((nb, h, w, o), generator=g, device=cuda_device).to(dtype)
    before = port.launch_counts["winograd_conv3x3"]
    got = port.winograd_conv3x3(x, k, b, vec, res, pre, 1 if pre == "norm" else 0)
    assert port.launch_counts["winograd_conv3x3"] == before + 1
    want = port.winograd_reference(x, k, b, vec, res, pre, 1 if pre == "norm" else 0).float()
    scale = float(want.abs().max())
    tol = 1e-5 * scale if dtype == torch.float32 else 2.0 ** (np.floor(np.log2(scale)) - 7)
    assert got.dtype == dtype and float((got.float() - want).abs().max()) <= tol


@pytest.mark.cuda
def test_kernel_wrapper_rejects_what_it_does_not_take(cuda_device):
    k = torch.zeros((3, 3, 8, 8), device=cuda_device)
    b = torch.zeros((8,), device=cuda_device)
    with pytest.raises(ValueError):
        port.winograd_conv3x3(torch.zeros((1, 5, 8, 8), device=cuda_device), k, b)  # odd H
    with pytest.raises(ValueError):
        port.winograd_conv3x3(torch.zeros((1, 8, 8, 8), device=cuda_device).permute(0, 2, 1, 3)
                              .contiguous().transpose(1, 2), k, b)  # not contiguous
    with pytest.raises(TypeError):
        port.winograd_conv3x3(torch.zeros((1, 8, 8, 8), device=cuda_device, dtype=torch.float16), k, b)


def _on_card_case(device, shape, pre, seed=5, misaligned=False):
    """bf16 inputs for the kernel on the card, with vec and a residual; x
    one element past a 16-byte boundary where ``misaligned``."""
    g = torch.Generator(device=device).manual_seed(seed)
    nb, h, w, c, o = shape
    x = torch.randn((nb, h, w, c), generator=g, device=device).to(torch.bfloat16)
    if misaligned:
        x = torch.empty(x.numel() + 1, dtype=x.dtype, device=device)[1:].view(x.shape).copy_(x)
    k = torch.randn((3, 3, c, o), generator=g, device=device) / (3 * c ** 0.5)
    b = torch.randn((o,), generator=g, device=device)
    vec = torch.randn((nb, c), generator=g, device=device).to(torch.bfloat16)
    res = torch.randn((nb, h, w, o), generator=g, device=device).to(torch.bfloat16)
    return x, k, b, vec, res, pre, 1 if pre == "norm" else 0


def _within_one_ulp(got, want):
    scale = float(want.abs().max())
    return float((got.float() - want).abs().max()) <= 2.0 ** (np.floor(np.log2(scale)) - 7)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [
    (2, 18, 22, 32, 32),    # 9 x 11 tiles an image: no multiple of the block's 64
    (2, 16, 16, 24, 40),    # C not a multiple of 16
    (3, 10, 14, 40, 20),    # O not a multiple of 8
    (2, 16, 16, 64, 384),   # O above the block's 128-channel slice
    (4, 8, 8, 512, 512),    # level 4: the slice narrowed to 32 channels
    (2, 6, 4, 3, 5),        # C and O below 8: element-wise copies
    (70, 2, 2, 16, 16),     # one tile an image: many images a block
])
@pytest.mark.parametrize("pre", [None, "norm", "silu"])
def test_tensor_core_route_edges_on_card(cuda_device, shape, pre):
    """The bf16 route against its plain version where its tiles, channel
    chunks and output slices run ragged: one bf16 ulp of the output's scale."""
    args = _on_card_case(cuda_device, shape, pre)
    before = port.launch_counts["winograd_conv3x3"]
    got = port.winograd_conv3x3(*args)
    assert port.launch_counts["winograd_conv3x3"] == before + 1
    assert _within_one_ulp(got, port.winograd_reference(*args).float())


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 16, 16, 32, 32), (3, 10, 14, 40, 20)])
def test_tensor_core_route_misaligned_input_on_card(cuda_device, shape):
    """x not on a 16-byte boundary: the patch is copied element by element."""
    args = _on_card_case(cuda_device, shape, "norm", misaligned=True)
    assert args[0].data_ptr() % 16 != 0
    assert _within_one_ulp(port.winograd_conv3x3(*args), port.winograd_reference(*args).float())


@pytest.mark.cuda
def test_silu_reciprocal_is_correctly_rounded_on_card(cuda_device):
    """The SiLU's branch-free reciprocal equals __frcp_rn on every float in
    [1, 2^126), the range of 1 + exp(-v) it takes (above it, or NaN, the
    kernel calls __frcp_rn): the prologue's SiLU rounds as torch's does."""
    import ctypes

    bad = torch.zeros(1, dtype=torch.int64, device=cuda_device)
    fn = port._library().c2w_winograd_rcp_mismatches
    fn.argtypes, fn.restype = [ctypes.c_uint, ctypes.c_uint, ctypes.c_void_p, ctypes.c_void_p], ctypes.c_int
    assert fn(0x3F800000, 0x7E800000, bad.data_ptr(), torch.cuda.current_stream(cuda_device).cuda_stream) == 0
    assert int(bad.item()) == 0
