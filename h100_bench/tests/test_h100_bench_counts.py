"""counts.py against counts made by hand."""

from __future__ import annotations

import pytest

from h100_bench import counts

# one level: 4 input channels, 8 hidden, one block a side, at 4 x 4, an
# embedding of 16 from 8 noise features
ONE_LEVEL = {"channels": 4, "embedding_dim": 16, "noise_features": 8, "hidden_channels": [8],
             "hidden_blocks": [1], "kernel_size": 3, "attention_levels": []}


def test_one_conv_block_by_hand():
    emb = 2 * 8 * 16 + 2 * 16 * 16  # the noise embedding's two layers
    head = tail = 2 * 9 * 4 * 8 * 16  # 3 x 3 convs 4 <-> 8 channels over 16 positions
    block = 2 * 16 * 8 + 2 * (2 * 9 * 8 * 8 * 16)  # projection and two 8 -> 8 convs
    assert counts.forward_flops(ONE_LEVEL, 4, 4) == emb + head + 2 * block + tail == 93440


def test_one_attention_call_by_hand():
    model = dict(ONE_LEVEL, attention_levels=[0])
    t, c = 16, 8
    call = 2 * c * 3 * c * t + 2 * c * c * t + 4 * t * t * c  # qkv, projection, QK^T and PV
    assert counts.attention_calls(model, 4, 4) == [(16, 8), (16, 8)]
    assert counts.forward_flops(model, 4, 4) == 93440 + 2 * call == 126208


def test_attention_bound_at_the_sampling_shape():
    flops, nbytes = counts.attention_fwd_work(96, 64, 512)
    assert (flops, nbytes) == (4 * 96 * 64 * 64 * 512, 4 * 96 * 64 * 512 * 2)
    assert counts.bound_s(flops, nbytes) * 1e3 == pytest.approx(0.0075, abs=5e-5)  # bytes bound it
    flops, nbytes = counts.attention_bwd_work(32, 256, 512)
    assert (flops, nbytes) == (10 * 32 * 256 * 256 * 512, 7 * 32 * 256 * 512 * 2)


def test_training_counts_three_forwards_and_strided_levels():
    model = {"channels": 52, "embedding_dim": 512, "hidden_channels": [128, 128, 256, 384, 512],
             "hidden_blocks": [3] * 5, "kernel_size": 3, "attention_levels": [4]}
    assert counts.forward_flops(model, 128, 128) == 115_998_490_624
    assert counts.train_sample_flops(model, 128, 128) == 3 * 115_998_490_624
    assert counts.attention_calls(model, 128, 128) == [(64, 512)] * 6


def test_device_trace_reduces_a_profile():
    """Busy time is the union of device operations; a range's device time is
    that of the operations inside its device-side span; gaps are named by the
    innermost host operation at their middle."""
    from types import SimpleNamespace

    from torch.autograd import DeviceType

    from h100_bench import harness

    def ev(name, a, b, device=True, annotation=False):
        return SimpleNamespace(name=name, time_range=SimpleNamespace(start=a, end=b),
                               device_type=DeviceType.CUDA if device else DeviceType.CPU,
                               is_user_annotation=annotation)

    events = [ev("k1", 0, 100), ev("k2", 50, 150), ev("k3", 400, 500), ev("attention_fwd_bf16_kernel", 500, 600),
              ev("fwd", 0, 150, annotation=True), ev("fwd", 400, 600, annotation=True),
              ev("host_outer", 100, 450, device=False), ev("aten::copy_", 200, 300, device=False)]
    trace = harness.DeviceTrace(SimpleNamespace(events=lambda: events), window_s=1e-3)
    assert trace.busy_s == 350e-6
    assert trace.kernel_s(lambda n: "attention_fwd" in n) == (100e-6, 1)
    assert trace.range_device_s("fwd") == (400e-6, 2)
    assert trace.breakdown()["idle_gaps"] == [["aten::copy_", 250e-6]]
    assert harness.idle_share_pct({"trace": trace}) == 65.0
