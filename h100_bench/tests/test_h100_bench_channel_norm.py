"""The channel-norm kernels' readers on fabricated slices: nothing where the
slice holds no launch of them (a program without the kernels), device ms a
forward or a step where it does."""

from __future__ import annotations

import pytest
from test_h100_bench_spans import ev, read, trace_of

FWD = "void (anonymous namespace)::channel_norm_fwd_kernel<__nv_bfloat16, 1>(...)"
BWD = "void (anonymous namespace)::channel_norm_bwd_kernel<__nv_bfloat16, 3>(...)"
RANGE = "h100_bench.unet_forward"


def sampling_slice(norms: bool):
    """Two forwards in the harness's ranges, each a conv (50 us) and, with
    ``norms``, two norm launches (3 and 5 us); a fold outside them."""
    evs, t = [], 0
    for _ in range(2):
        kernels = [("conv", 50)] + ([(FWD, 3), (FWD, 5)] if norms else [("elementwise_kernel", 8)])
        start = t
        for name, us in kernels:
            evs.append(ev(name, t, t + us))
            t += us + 1
        evs.append(ev(RANGE, start, t - 1, annotation=True))
        evs.append(ev("fold", t, t + 4))
        t += 5
    return {"trace": trace_of(evs, t), "forward_range": RANGE, "slice_evals": 1}


def training_slice(norms: bool):
    """Two steps: a conv (40 us), and with ``norms`` a forward (2 us) and a
    backward (6 us) norm launch a step."""
    evs, t = [], 0
    for _ in range(2):
        for name, us in [("conv", 40)] + ([(FWD, 2), (BWD, 6)] if norms else []):
            evs.append(ev(name, t, t + us))
            t += us + 1
    return {"trace": trace_of(evs, t), "slice_steps": 2}


@pytest.mark.parametrize("name,slice_of,per", [("channel_norm_ms.sample", sampling_slice, 8e-3),
                                               ("channel_norm_ms.train", training_slice, 8e-3)])
def test_reader_reads_the_kernels_a_forward_or_step(name, slice_of, per):
    assert read(name, slice_of(True)) == pytest.approx(per)


@pytest.mark.parametrize("name,slice_of", [("channel_norm_ms.sample", sampling_slice),
                                           ("channel_norm_ms.train", training_slice)])
def test_reader_reads_nothing_without_a_launch(name, slice_of):
    assert read(name, slice_of(False)) is None
    assert read(name, {}) is None
