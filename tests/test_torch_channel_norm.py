"""climate2weather_tpu_torch.ops.channel_norm: the plain composition against
the JAX package's ``channel_norm``, the closed-form backward against autograd
in float64, the UNet's calls of the fused norm, and, on the card, the CUDA
kernels against float64.

The card's cases import no JAX (the JAX comparison imports it inside its
test), so they run on a machine without it:
``python -m pytest --noconftest -m cuda tests/test_torch_channel_norm.py``.
"""

import json
import pathlib

import numpy as np
import pytest
import torch

from climate2weather_tpu_torch.models import unet
from climate2weather_tpu_torch.ops import channel_norm as cn

REPO = pathlib.Path(__file__).resolve().parents[1]
RTOL = ATOL = 2e-4  # the repository's bar for fp32 parity (tests/_torch_parity.py)
FORWARD_SLACK = 1.5  # chip_smoke.py's: a kernel's distance from float64 over the plain version's
EPS = 1e-5


def _layout(kind: str, c: int, rng: np.random.RandomState, scale: float = 3.0):
    """``(x, dim)``: a float64 x of channels ``c`` in the layout ``kind``, its
    channel axis innermost in memory ('2d': channels_last [B, C, H, W], '3d':
    channels_last_3d [B, C, D, H, W], '1d': [B, C, L] over [B, L, C], 'btc':
    [B, T, C] with the channel axis last)."""
    spatial = {"2d": (3, 4), "3d": (2, 3, 2), "1d": (5,), "btc": (6,)}[kind]
    rows = torch.from_numpy(rng.randn(2, *spatial, c) * scale + 1.0)
    if kind == "btc":
        return rows, -1
    return rows.movedim(-1, 1), 1


def _norm64(x, shift, ddof, dim):
    """The composition in x's dtype (float64): x + shift, then the norm."""
    if shift is not None:
        x = x + shift.reshape(*shift.shape, *(1,) * (x.dim() - 2))
    mean = x.mean(dim=dim, keepdim=True)
    return (x - mean) * torch.rsqrt(x.var(dim=dim, keepdim=True, correction=ddof) + EPS)


# ---------------------------------------------------------------------------
# CPU
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shift", [False, True])
@pytest.mark.parametrize("ddof", [0, 1])
def test_reference_matches_jax_channel_norm(ddof, shift):
    import jax.numpy as jnp

    from climate2weather_tpu.models.unet import channel_norm as jax_norm

    rng = np.random.RandomState(3 + ddof)
    x = (rng.randn(2, 5, 6, 24) * 3 + 1).astype(np.float32)  # NHWC
    s = rng.randn(2, 24).astype(np.float32) if shift else None
    want = jax_norm(jnp.asarray(x) + (0 if s is None else jnp.asarray(s)[:, None, None, :]), ddof=ddof)
    got = cn.channel_norm_reference(torch.from_numpy(x).permute(0, 3, 1, 2),
                                    None if s is None else torch.from_numpy(s), ddof)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)


_BWD_CASES = [(kind, c, ddof, shift) for kind in ("2d", "3d", "1d", "btc") for c in (32, 128, 384, 768)
              for ddof in (0, 1) for shift in (False, True) if not (kind == "btc" and shift)]


@pytest.mark.parametrize("kind,c,ddof,shift", _BWD_CASES)
def test_bwd_reference_matches_autograd_in_float64(kind, c, ddof, shift):
    rng = np.random.RandomState(c + ddof + 7 * shift)
    x, dim = _layout(kind, c, rng)
    s = torch.from_numpy(rng.randn(x.shape[0], c)) if shift else None
    dy = torch.from_numpy(rng.randn(*x.shape))
    xg = x.clone().requires_grad_(True)
    sg = None if s is None else s.clone().requires_grad_(True)
    _norm64(xg, sg, ddof, dim).backward(dy)
    dh = cn.channel_norm_bwd_reference(dy, x, s, ddof, EPS, dim)
    assert dh.dtype == torch.float64
    np.testing.assert_allclose(dh.numpy(), xg.grad.numpy(), rtol=1e-9, atol=1e-11)
    if shift:  # the Function's shift gradient: dh summed over the spatial axes
        np.testing.assert_allclose(dh.sum(dim=tuple(range(2, dh.dim()))).numpy(), sg.grad.numpy(),
                                   rtol=1e-9, atol=1e-10)


@pytest.mark.parametrize("kind,shift", [("2d", False), ("2d", True), ("3d", True), ("1d", True), ("btc", False)])
def test_wrapper_takes_plain_version_on_cpu_without_counting(kind, shift):
    rng = np.random.RandomState(11)
    x, dim = _layout(kind, 16, rng)
    x = x.float().requires_grad_(True)
    s = torch.from_numpy(rng.randn(x.shape[0], 16)).float().requires_grad_(True) if shift else None
    before = dict(cn.launch_counts)
    got = cn.fused_channel_norm(x, s, 1, dim=dim)
    want = cn.channel_norm_reference(x, s, 1, dim=dim)
    assert torch.equal(got, want) and got.stride() == want.stride()
    got.sum().backward()
    assert x.grad is not None and (s is None or s.grad is not None)
    assert dict(cn.launch_counts) == before


def test_rows_refuse_a_channel_axis_that_is_not_innermost():
    x = torch.zeros((2, 8, 3, 3))  # NCHW: the channel axis is not innermost
    with pytest.raises(ValueError, match="innermost"):
        cn._rows(x, 1)
    assert cn._rows(x.contiguous(memory_format=torch.channels_last), 1).is_contiguous()
    assert cn._rows(torch.zeros((2, 5, 8)), -1).is_contiguous()
    with pytest.raises(ValueError, match="innermost"):
        cn._rows(torch.zeros((2, 8, 10))[:, :, ::2], -1)  # rows not dense


def _shaped_unet(config: str, device="cpu", dtype=torch.float32, width: int = 8):
    """A UNet with the levels, blocks and attention of ``h100_bench/configs/
    <config>.json`` at a tiny width, and the smallest input that reaches its
    deepest level."""
    model = json.loads((REPO / "h100_bench" / "configs" / f"{config}.json").read_text())["model"]
    levels = len(model["hidden_channels"])
    torch.manual_seed(0)
    with torch.device(device):
        net = unet.UNet(6, 6, 16, hidden_channels=[width] * levels, hidden_blocks=model["hidden_blocks"],
                        attention_levels=model["attention_levels"], dtype=dtype)
        res = 2 ** (levels - 1)
        x = torch.randn(2, res, res, 6).movedim(-1, 1)  # channels_last, as ScoreUNet hands it in
        emb = torch.randn(2, 16)
    return net, x, emb


def _spy(monkeypatch):
    calls = []
    real = unet.fused_channel_norm

    def counted(x, shift=None, *args, **kwargs):
        calls.append(shift is not None)
        return real(x, shift, *args, **kwargs)

    monkeypatch.setattr(unet, "fused_channel_norm", counted)
    return calls


@pytest.mark.parametrize("config,norms,shifted", [("sda_unet", 40, 30), ("sda_unet_large", 53, 36)])
def test_unet_calls_the_fused_norm_at_every_site(monkeypatch, config, norms, shifted):
    net, x, emb = _shaped_unet(config)
    calls = _spy(monkeypatch)
    with torch.no_grad():
        net(x, emb)
    assert len(calls) == norms and sum(calls) == shifted


# ---------------------------------------------------------------------------
# the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    """The card, or a skip where there is none (decided at run time)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels do not run on the CPU")
    return torch.device("cuda", 0)


def _card_inputs(shape, dtype, shift, device, seed):
    g = torch.Generator(device=device).manual_seed(seed)
    b, c, *spatial = shape
    x = (torch.randn((b, *spatial, c), generator=g, device=device) * 2 + 0.5).to(dtype).movedim(-1, 1)
    s = torch.randn((b, c), generator=g, device=device).to(dtype) if shift else None
    return x, s


def _h64(x, s):
    """h = x + shift rounded to x's dtype, as float64."""
    h = x if s is None else x + s.reshape(*s.shape, *(1,) * (x.dim() - 2))
    return h.double()


def _max_err(a, b) -> float:
    return float((a.double() - b).abs().max())


# the main path's norms: levels 0, 2, 3 and 4 of a sampling forward of the
# 72.1M net at 480 windows, the large net's level 5 at a microbatch of 32,
# and ragged shapes that take the scalar route or narrow groups
CARD_SHAPES = [(480, 128, 128, 128), (480, 256, 32, 32), (480, 384, 16, 16), (480, 512, 8, 8),
               (32, 768, 8, 8), (3, 40, 5, 7), (2, 24, 4, 4), (4, 20, 3, 3)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", CARD_SHAPES)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_kernel_forward_against_float64(cuda_device, shape, dtype):
    if dtype == torch.float32 and shape[0] * shape[1] * shape[2] * shape[3] > 2 ** 28:
        shape = (96, *shape[1:])  # float64 room on the card
    x, s = _card_inputs(shape, dtype, True, cuda_device, seed=sum(shape))
    for shift in (s, None):
        for ddof in (0, 1):
            h = _h64(x, shift)
            mean = h.mean(dim=1, keepdim=True)
            rstd = torch.rsqrt(h.var(dim=1, keepdim=True, correction=ddof) + EPS)
            want = (h - mean) * rstd
            before = cn.launch_counts["channel_norm_fwd"]
            y, m, r = cn.channel_norm_fwd(x, shift, ddof, EPS, stats=True)
            assert cn.launch_counts["channel_norm_fwd"] == before + 1
            assert y.dtype == dtype and y.shape == x.shape and y.stride() == x.stride()
            plain = cn.channel_norm_reference(x, shift, ddof, EPS)
            err, err_plain = _max_err(y, want), _max_err(plain, want)
            assert err <= FORWARD_SLACK * err_plain, (err, err_plain)
            rows = mean.movedim(1, -1).reshape(-1)
            assert _max_err(m, rows) <= 1e-5 * (1 + float(rows.abs().max()))
            assert _max_err(r, rstd.movedim(1, -1).reshape(-1)) <= 1e-5 * float(rstd.max())
            del h, mean, rstd, want, y, plain


@pytest.mark.cuda
@pytest.mark.parametrize("shape", CARD_SHAPES)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_kernel_backward_against_float64(cuda_device, shape, dtype):
    if shape[0] * shape[1] * shape[2] * shape[3] > 2 ** 29:
        shape = (96, *shape[1:])  # float64 room on the card
    x, s = _card_inputs(shape, dtype, True, cuda_device, seed=sum(shape) + 1)
    g = torch.Generator(device=cuda_device).manual_seed(5)
    dy = torch.randn(x.movedim(1, -1).shape, generator=g, device=cuda_device).to(dtype).movedim(-1, 1)
    for shift in (s, None):
        ddof = 1
        want = cn.channel_norm_bwd_reference(dy.double(), _h64(x, shift), None, ddof, EPS)
        xg = x.clone().requires_grad_(True)
        sg = None if shift is None else shift.clone().requires_grad_(True)
        cn.channel_norm_reference(xg, sg, ddof, EPS).backward(dy)
        _, m, r = cn.channel_norm_fwd(x, shift, ddof, EPS, stats=True)
        before = cn.launch_counts["channel_norm_bwd"]
        dh = cn.channel_norm_bwd(dy, x, shift, m, r, ddof)
        assert cn.launch_counts["channel_norm_bwd"] == before + 1
        assert dh.dtype == dtype and dh.stride() == x.stride()
        err, err_plain = _max_err(dh, want), _max_err(xg.grad, want)
        assert err <= FORWARD_SLACK * err_plain, (err, err_plain)
        assert torch.equal(dh, cn.channel_norm_bwd(dy, x, shift, m, r, ddof))  # no atomics: the same bits
        if shift is not None:
            xs = x.clone().requires_grad_(True)
            ss = shift.clone().requires_grad_(True)
            cn.fused_channel_norm(xs, ss, ddof).backward(dy)
            assert torch.equal(xs.grad, dh)
            dshift = want.sum(dim=(2, 3))
            assert _max_err(ss.grad, dshift) <= FORWARD_SLACK * _max_err(sg.grad, dshift)


@pytest.mark.cuda
def test_kernel_wrapper_raises_on_what_it_does_not_take(cuda_device):
    x = torch.zeros((2, 16, 4, 4), device=cuda_device, dtype=torch.bfloat16)  # NCHW
    with pytest.raises(ValueError, match="innermost"):
        cn.fused_channel_norm(x)
    xl = x.contiguous(memory_format=torch.channels_last)
    with pytest.raises(ValueError, match="shift"):
        cn.fused_channel_norm(xl, torch.zeros((2, 8), device=cuda_device, dtype=torch.bfloat16))
    with pytest.raises(ValueError, match="does not match"):
        cn.fused_channel_norm(xl, torch.zeros((2, 16), device=cuda_device))
    with pytest.raises(TypeError):
        cn.fused_channel_norm(xl.half())


@pytest.mark.cuda
@pytest.mark.parametrize("config,norms", [("sda_unet", 40), ("sda_unet_large", 53)])
def test_launch_counts_per_forward_and_backward(cuda_device, monkeypatch, config, norms):
    net, x, emb = _shaped_unet(config, cuda_device, torch.bfloat16, width=16)
    plain = []
    real = cn.channel_norm
    monkeypatch.setattr(cn, "channel_norm", lambda *a, **k: plain.append(1) or real(*a, **k))
    before = dict(cn.launch_counts)
    with torch.no_grad():
        net(x, emb)
    assert cn.launch_counts["channel_norm_fwd"] - before["channel_norm_fwd"] == norms
    out = net(x, emb)
    out.float().square().mean().backward()
    assert cn.launch_counts["channel_norm_fwd"] - before["channel_norm_fwd"] == 2 * norms
    assert cn.launch_counts["channel_norm_bwd"] - before["channel_norm_bwd"] == norms
    assert plain == []  # no CUDA forward takes the plain norm


@pytest.mark.cuda
@pytest.mark.parametrize("spatial", [1, 2, 3])
def test_unets_of_every_rank_run_the_kernels_like_the_plain_norm(cuda_device, monkeypatch, spatial):
    torch.manual_seed(spatial)
    with torch.device(cuda_device):
        net = unet.UNet(5, 5, 16, hidden_channels=(16, 32), hidden_blocks=(1, 2), attention_levels=(1,),
                        dtype=torch.bfloat16, norm_ddof=spatial % 2, spatial=spatial)
        x = torch.randn(2, *(8,) * spatial, 5).movedim(-1, 1)
        emb = torch.randn(2, 16)
    before = dict(cn.launch_counts)
    out = net(x, emb)
    out.float().square().mean().backward()
    grads = [p.grad.clone() for p in net.parameters()]
    # 6 blocks, 4 attention blocks, 1 tail
    assert cn.launch_counts["channel_norm_fwd"] - before["channel_norm_fwd"] == 11
    assert cn.launch_counts["channel_norm_bwd"] - before["channel_norm_bwd"] == 11
    net.zero_grad()
    monkeypatch.setattr(unet, "fused_channel_norm", cn.channel_norm_reference)
    ref = net(x, emb)
    ref.float().square().mean().backward()
    scale = float(ref.float().abs().max())
    assert float((out.float() - ref.float()).abs().max()) <= 0.05 * scale
    for p, g in zip(net.parameters(), grads):
        assert float((g - p.grad).abs().max()) <= 0.05 * float(p.grad.abs().max()) + 1e-6
