"""The float64 yardsticks and limits of ``chip_smoke.py`` phases 2, 3 and
3b, on the CPU, where every kernel wrapper runs its plain version.

The yardsticks against the JAX package's references (fp32 at 2e-4) and
against numpy in float64; the limit helpers on bf16 inputs: the plain
versions and the other summation orders pass, and every planted fault
fails; phase 2's channel-norm checks with the plain version in the
kernels' place; the norm count its launch gates take; phase 3 on the
72.1M snapshot and phase 3b on its blocks, at a small batch."""

import pathlib
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from _torch_parity import close, n, t
from climate2weather_tpu.ops import attention as JA
from climate2weather_tpu.ops import winograd as JW
from climate2weather_tpu_torch.ops import channel_norm as cn
from climate2weather_tpu_torch.ops import winograd as port
from climate2weather_tpu_torch.ops.attention import attention_reference

SNAPSHOT = pathlib.Path(__file__).resolve().parents[1] / "artifacts" / "network-snapshot-0009437-0.999900"
CPU = torch.device("cpu")


def _qkv(shape, seed, dtype=torch.float32):
    b, tt, c = shape
    g = torch.Generator().manual_seed(seed)
    return torch.randn((b, tt, 3 * c), generator=g).to(dtype).chunk(3, dim=-1)


@pytest.mark.parametrize("shape", [(4, 64, 32), (3, 16, 40)])
def test_attention_f64_matches_jax_reference_and_numpy(shape):
    q, k, v = _qkv(shape, 0)
    got = chip_smoke._attention_f64(q, k, v)
    assert got.dtype == torch.float64 and got.shape == q.shape
    close(got, JA.reference_attention(*(jnp.asarray(n(a)) for a in (q, k, v))), rtol=2e-4, atol=2e-4)
    qd, kd, vd = (n(a).astype(np.float64) for a in (q, k, v))
    s = shape[-1] ** (-0.25)
    logits = np.einsum("btc,bsc->bts", qd * s, kd * s)
    p = np.exp(logits - logits.max(axis=-1, keepdims=True))
    want = np.einsum("bts,bsc->btc", p / p.sum(axis=-1, keepdims=True), vd)
    np.testing.assert_allclose(n(got), want, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("pre,ddof", [(None, 0), ("norm", 0), ("norm", 1), ("silu", 0)])
def test_winograd_f64_matches_jax_direct_composition(pre, ddof):
    rng = np.random.RandomState(3)
    x = rng.randn(2, 12, 10, 16).astype(np.float32)
    k = (rng.randn(3, 3, 16, 8) / 12).astype(np.float32)
    b, vec = rng.randn(8).astype(np.float32), rng.randn(2, 16).astype(np.float32)
    res = rng.randn(2, 12, 10, 8).astype(np.float32)
    got = chip_smoke._winograd_f64(t(x), t(k), t(b), t(vec), t(res), pre, ddof)
    assert got.dtype == torch.float64
    want = res + JW._conv_ref(JW._apply_pre(jnp.asarray(x), jnp.asarray(vec), pre, ddof), jnp.asarray(k),
                              jnp.asarray(b))
    close(got, want, rtol=2e-4, atol=2e-4)


def test_one_ulp_biased_moves_every_nonzero_output_one_ulp_away_from_zero():
    y = torch.tensor([0.0, -0.0, 1.0, -1.0, 3.0e-3, -7.5, 255.0, 1.0e-30]).to(torch.bfloat16)
    got = chip_smoke._one_ulp_biased(y)
    steps = got.view(torch.int16).int() - y.view(torch.int16).int()
    assert steps.tolist() == [0, 0, 1, 1, 1, 1, 1, 1]
    assert bool((got.float().abs() >= y.float().abs()).all())
    nz = y != 0
    assert bool((got[nz].float().abs() > y[nz].float().abs()).all())


@pytest.mark.parametrize("shape", [(4, 64, 512), (3, 16, 40), (2, 200, 64)])
def test_attention_launch_limits_on_bf16(shape):
    """The plain version passes both limits; the other summation orders sit
    inside LAUNCH_SLACK; the one-ulp-biased output passes the unchanged max
    limit and fails the float64 one; a dropped key fails the max limit."""
    q, k, v = _qkv(shape, 1, torch.bfloat16)
    plain = attention_reference(q, k, v)
    rec = chip_smoke._attention_launch(q, k, v, plain)
    assert rec["failed"] == [] and rec["f64_ratio"] == 1.0 and rec["max_abs_err"] == 0.0
    assert all(r <= chip_smoke.LAUNCH_SLACK for r in rec["controls"].values()), rec
    assert rec["biased_passes_max"] and rec["biased_ratio"] > chip_smoke.LAUNCH_SLACK, rec
    assert rec["key_dropped_err"] > rec["tol"]

    biased = chip_smoke._attention_launch(q, k, v, chip_smoke._one_ulp_biased(plain))
    assert biased["max_abs_err"] <= biased["tol"]
    assert biased["failed"] == ["the kernel is farther from float64 than LAUNCH_SLACK allows"]
    dropped = chip_smoke._attention_launch(q, k, v, chip_smoke._key_dropped(q, k, v), key_dropped=False)
    assert "the kernel is off the plain version by more than one ulp" in dropped["failed"]


def test_attention_launch_limit_in_fp32_is_unchanged():
    q, k, v = _qkv((2, 64, 32), 2)
    rec = chip_smoke._attention_launch(q, k, v, attention_reference(q, k, v))
    assert rec["failed"] == [] and "f64_ratio" not in rec
    assert rec["tol"] == 1e-5 * max(float(attention_reference(q, k, v).abs().max()), 1.0)


WINO_CASES = [((2, 16, 16, 128), 128, "norm", True, False), ((4, 8, 8, 512), 512, "norm", True, True),
              ((3, 10, 14, 40), 20, "norm", True, True), ((2, 16, 16, 128), 128, "silu", True, True),
              ((2, 16, 16, 128), 128, None, False, True)]


def _wino_args(shape, o, pre, has_vec, has_res, seed=0):
    g = torch.Generator().manual_seed(seed)
    return (*chip_smoke._winograd_inputs(g, CPU, shape, o, torch.bfloat16, has_vec, has_res), pre)


def _with_fwd(fwd):
    """The winograd module with ``winograd_fwd`` replaced: a faulty kernel."""
    return types.SimpleNamespace(**{**vars(port), "winograd_fwd": fwd})


@pytest.mark.parametrize("case", WINO_CASES, ids=lambda c: f"{c[0]}-{c[2]}-res{int(c[4])}")
def test_winograd_limits_on_bf16(case):
    """The plain version passes both float64 limits; each planted fault
    (halo, ddof flipped where the norm runs, one-ulp-biased) reads over
    WINO_SLACK, and, put in the kernel's place, fails the mean limit."""
    args = _wino_args(*case)
    rec = {}
    chip_smoke._winograd_check(port, args, rec)
    assert rec["failed"] == [] and rec["f64_ratios"][0] == 1.0 and rec["max_abs_err"] == 0.0
    assert rec["f64_ratios"][1] <= chip_smoke.WINO_MAX_SLACK
    want = {"halo_unmasked", "one_ulp_biased"} | ({"ddof_flipped"} if case[2] == "norm" else set())
    assert set(rec["faults"]) == want
    assert all(r[0] > chip_smoke.WINO_SLACK for r in rec["faults"].values()), rec
    faulty = {"halo_unmasked": chip_smoke._halo_unmasked,
              "one_ulp_biased": lambda *a: chip_smoke._one_ulp_biased(port.winograd_reference(*a)),
              "ddof_flipped": lambda *a: port.winograd_reference(*a[:6], 1)}
    for name in want:
        bad = {}
        chip_smoke._winograd_check(_with_fwd(faulty[name]), args, bad)
        assert "the kernel's mean distance from float64 is over WINO_SLACK" in bad["failed"], (name, bad)


def test_winograd_limit_in_fp32_is_unchanged():
    g = torch.Generator().manual_seed(0)
    args = (*chip_smoke._winograd_inputs(g, CPU, (2, 16, 16, 32), 32, torch.float32), "norm")
    rec = {}
    chip_smoke._winograd_check(port, args, rec)
    assert rec["failed"] == [] and rec["halo_unmasked_err"] > rec["tol"] and "f64_ratios" not in rec
    bad = {}
    chip_smoke._winograd_check(_with_fwd(chip_smoke._halo_unmasked), args, bad)
    assert bad["failed"] == ["the kernel is off the plain version by more than 1e-5 of the scale"]


def _norm_stand_ins(monkeypatch, fault=None):
    """The channel-norm wrappers replaced by their plain versions (the
    kernels do not run on the CPU), ``fault`` applied to their outputs, and
    the timings stubbed; small shapes of each width class, several float64
    chunks a shape."""
    def fwd(x, shift=None, ddof=0, eps=1e-5, dim=1, stats=False):
        h = (x if shift is None else x + shift[:, :, None, None]).float()
        rstd = torch.rsqrt(h.var(dim=1, correction=ddof) + eps).reshape(-1)
        y = cn.channel_norm_reference(x, shift, ddof, eps, dim)
        return (y if fault is None else fault(y)), h.mean(dim=1).reshape(-1), rstd

    def bwd(dy, x, shift, mean, rstd, ddof=0, dim=1):
        dh = cn.channel_norm_bwd_reference(dy, x, shift, ddof, 1e-5, dim)
        return dh if fault is None else fault(dh)

    monkeypatch.setattr(cn, "channel_norm_fwd", fwd)
    monkeypatch.setattr(cn, "channel_norm_bwd", bwd)
    monkeypatch.setattr(chip_smoke, "NORM_SHAPES", ((6, 128, 8, 8), (5, 384, 4, 4), (4, 768, 2, 2)))
    monkeypatch.setattr(chip_smoke, "NORM_CHUNK", 2 ** 12)
    monkeypatch.setattr(chip_smoke, "cuda_time_ms", lambda fn, **_: (fn(), 0.0)[1])


def test_channel_norm_limits_on_bf16(monkeypatch):
    """Phase 2's channel-norm checks with the plain version in the kernels'
    place: every limit passes at ratios of exactly 1.0, the one-ulp-biased
    output reads over FORWARD_SLACK, and each timed row is bound by bytes."""
    _norm_stand_ins(monkeypatch)
    checks, fwd_rows, bwd_rows = chip_smoke.phase2_channel_norm(CPU, torch.Generator().manual_seed(0))
    assert [(c["kernel"], c["shift"], c["ddof"]) for c in checks[:4]] == [
        ("channel_norm_fwd", True, 0), ("channel_norm_bwd", True, 0),
        ("channel_norm_fwd", False, 1), ("channel_norm_bwd", False, 1)]
    assert len(checks) == 4 * len(chip_smoke.NORM_SHAPES)
    for c in checks:
        assert c["failed"] == [] and c["max_abs_err"] == 0.0 and c["f64_ratios"] == [1.0, 1.0], c
        assert min(c["faults"]["one_ulp_biased"]) > chip_smoke.FORWARD_SLACK, c
        assert c["kernel"] == "channel_norm_fwd" or c["same_bits_twice"]
    for rows, name in ((fwd_rows, "channel_norm_fwd"), (bwd_rows, "channel_norm_bwd")):
        assert [r["shape"] for r in rows] == [list(s) for s in chip_smoke.NORM_SHAPES]
        assert all(r["name"] == name and r["bound_by"] == "bytes" and r["max_abs_err"] == 0.0 for r in rows)


def test_channel_norm_limits_see_a_one_ulp_fault(monkeypatch):
    """The kernels' outputs moved one ulp away from zero stay within the
    one-ulp limit against the plain version and fail the float64 one."""
    _norm_stand_ins(monkeypatch, fault=chip_smoke._one_ulp_biased)
    checks, _, _ = chip_smoke.phase2_channel_norm(CPU, torch.Generator().manual_seed(1))
    for c in checks:
        assert c["max_abs_err"] <= c["one_ulp"], c
        assert "the kernel is farther from float64 than FORWARD_SLACK times the plain version" in c["failed"], c


@pytest.mark.parametrize("config,norms", [("sda_unet", 40), ("sda_unet_large", 53), ("tiny_unet", None)])
def test_norms_per_forward_counts_the_unets_norm_calls(monkeypatch, config, norms):
    """The launch count phases 4, 5 and 9a gate is the UNet's count of
    ``fused_channel_norm`` calls in a forward (nets at a width of 8)."""
    from climate2weather_tpu_torch.io.snapshot import yaml_load_file
    from climate2weather_tpu_torch.models import unet

    model = yaml_load_file(chip_smoke.REPO / "configs" / f"{config}.yml")
    levels = len(model["hidden_channels"])
    torch.manual_seed(0)
    net = unet.UNet(6, 6, 16, hidden_channels=[8] * levels, hidden_blocks=model["hidden_blocks"],
                    attention_levels=model.get("attention_levels", ()), dtype=torch.float32)
    calls = []
    real = unet.fused_channel_norm
    monkeypatch.setattr(unet, "fused_channel_norm", lambda *a, **k: calls.append(1) or real(*a, **k))
    with torch.no_grad():
        net(torch.randn(2, 6, 2 ** (levels - 1), 2 ** (levels - 1)), torch.randn(2, 16))
    assert len(calls) == chip_smoke._norms_per_forward(model) == (norms or len(calls))


def test_phase3_network_holds_the_72m_forward_to_float64():
    """On the CPU the kernel is the plain version: every ratio is exactly 1.0
    and the new fields are recorded."""
    rec = chip_smoke.phase3_network(SNAPSHOT, CPU, batch=2, res=32, compare_plain=True)
    assert rec["failed"] == [] and rec["launches"] == 0 and rec["f64_ratios"] == [1.0, 1.0]
    assert rec["slack"] == chip_smoke.FORWARD_SLACK and rec["vs_plain"] == [0.0, 0.0]
    assert set(rec["controls"]) == {"one_output_moved", "logits_exact", "pv_exact"}
    assert set(rec["faults"]) == set(rec["faults_fail_forward_gate"]) == {"one_ulp_biased", "key_dropped"}
    assert len(rec["per_call"]) == rec["attention_blocks"] == 6
    for call in rec["per_call"]:
        assert call["failed"] == [] and call["f64_ratio"] == 1.0 and call["outputs_differ"] == 0
        assert call["biased_passes_max"] and call["biased_ratio"] > chip_smoke.LAUNCH_SLACK
        assert call["key_dropped_err"] > call["tol"]


def test_phase3b_holds_the_winograd_blocks_to_float64():
    rec = chip_smoke.phase3b_winograd_blocks(SNAPSHOT, CPU, batch=2)
    assert rec["launches"] == 0 and [b["level"] for b in rec["blocks"]] == [0, 4]
    for block in rec["blocks"]:
        assert block["failed"] == [] and block["finite"] and block["f64_ratios"][0] == 1.0
        assert block["f64_ratios"][1] <= chip_smoke.WINO_MAX_SLACK
        assert set(block["faults"]) == {"halo_unmasked", "ddof_flipped"}
        assert all(r[0] > chip_smoke.WINO_SLACK for r in block["faults"].values()), block
