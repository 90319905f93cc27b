"""The readers of the program's spans (``spans.py`` and its metrics): by
hand on a slice laid out as the card lays one out, and on the tiny cells'
traced runs with their host operations standing in for kernels.

On the card the profiler ties a kernel to the innermost range open where
it was launched, and autograd's backward kernels, launched from another
thread, to none; a range open at the profiler's start is missing, one open
at its stop keeps its device-side interval and loses its host range.
:func:`on_card` lays a CPU profile out so, but for that loss."""

from __future__ import annotations

import math
from types import SimpleNamespace

import pytest
from torch.autograd import DeviceType

import tiny_cells as tc
from h100_bench import harness, spans

SAMPLING = ("window_fold_ms_per_eval.sample", "guidance_ms_per_eval.sample", "update_ms_per_eval.sample",
            "eval_idle_ms.sample")
TRAINING = ("fwd_loss_ms.train", "bwd_ms.train", "ema_ms.train", "gather_ms.train", "step_idle_ms.train")
RANGES = ("c2w.", "h100_bench.", "Optimizer.")


def ev(name, a, b, device=True, annotation=False):
    return SimpleNamespace(name=name, time_range=SimpleNamespace(start=a, end=b),
                           device_type=DeviceType.CUDA if device else DeviceType.CPU,
                           is_user_annotation=annotation)


def trace_of(events, window_us):
    return harness.DeviceTrace(SimpleNamespace(events=lambda: events), window_s=window_us / 1e6)


def read(name, layer):
    return harness.read_layer_metric(name, layer)


def sampling_slice():
    """Evaluation 4 from its first forward (its pass and span began before
    the profiler), evaluation 5 whole, evaluation 6 up to its first forward:
    each pass a gather (10 us), a forward in the harness's range (100 us),
    a fold (5 us); guidance 20 us, update 30 us; 2 us idle before each
    guidance and update, 1 us elsewhere between kernels."""
    evs = []

    def k(name, a, b, ann=None):
        evs.append(ev(name, a, b))
        if ann:
            evs.append(ev(ann, a, b, annotation=True))

    # evaluation 4: its forward (pass opened before the start), fold, guidance, update
    k("unet", 0, 100, "h100_bench.unet_forward")
    k("fold", 101, 106)
    k("guid", 108, 128, "c2w.sample.guidance")
    k("upd", 130, 160, "c2w.sample.update")
    evs += [ev("c2w.sample.guidance", 1000, 1010, device=False), ev("c2w.sample.update", 1011, 1020, device=False)]
    # evaluation 5, whole
    k("gather", 161, 171)
    k("unet", 172, 272, "h100_bench.unet_forward")
    k("fold", 273, 278)
    evs.append(ev("c2w.window.pass", 161, 278, annotation=True))
    k("guid", 280, 300, "c2w.sample.guidance")
    k("upd", 302, 332, "c2w.sample.update")
    evs += [ev("c2w.sample.eval", 1021, 1060, device=False), ev("c2w.window.pass", 1022, 1040, device=False),
            ev("c2w.model.forward", 1025, 1035, device=False), ev("c2w.sample.guidance", 1041, 1050, device=False),
            ev("c2w.sample.update", 1051, 1059, device=False)]
    # evaluation 6 up to the stop: its gather, whose host ranges the card drops
    k("gather", 333, 343, "c2w.window.pass")
    return {"trace": trace_of(evs, 343), "slice_evals": 2}


def training_slice():
    """Two steps of one microbatch: gather 10 us, forward 100 (its draws
    and net in the span), backward 200 (its seed kernel in the span, the
    rest from autograd's thread in none), AdamW 20, EMA 10, the loss's
    division 1 (the step's own); 5 us idle at the start of each backward, 1
    us elsewhere, 50 us between the steps."""
    evs = []
    t = 0.0
    for s in range(2):
        h = 2000.0 * (s + 1)
        for name, dur, ann, gap in (("gather", 10, "c2w.train.gather", 1), ("fwd", 100, "c2w.train.forward", 5),
                                    ("seed", 1, "c2w.train.backward", 1), ("bwd", 199, None, 1),
                                    ("adamw", 20, "Optimizer.step#AdamW.step", 1), ("ema", 10, "c2w.train.ema", 1),
                                    ("div", 1, "c2w.train.step", 50 if s == 0 else 0)):
            evs.append(ev(name, t, t + dur))
            if ann:
                evs.append(ev(ann, t, t + dur, annotation=True))
            t += dur + gap
        evs += [ev("c2w.train.step", h, h + 100, device=False), ev("c2w.train.gather", h + 1, h + 10, device=False),
                ev("c2w.train.forward", h + 11, h + 40, device=False),
                ev("c2w.train.backward", h + 41, h + 60, device=False),
                ev("Optimizer.step#AdamW.step", h + 61, h + 80, device=False),
                ev("c2w.train.ema", h + 81, h + 90, device=False)]
    return {"trace": trace_of(evs, t), "slice_steps": 2}


def test_sampling_readers_by_hand():
    layer = sampling_slice()
    assert read("guidance_ms_per_eval.sample", layer) == pytest.approx(20e-3)
    assert read("update_ms_per_eval.sample", layer) == pytest.approx(30e-3)
    assert read("window_fold_ms_per_eval.sample", layer) == pytest.approx(15e-3)  # evaluation 5's alone
    assert read("eval_idle_ms.sample", layer) == pytest.approx(6e-3)  # 1 + 1 + 2 + 2 us


def test_training_readers_by_hand():
    layer = training_slice()
    assert read("gather_ms.train", layer) == pytest.approx(10e-3)
    assert read("fwd_loss_ms.train", layer) == pytest.approx(100e-3)
    assert read("bwd_ms.train", layer) == pytest.approx(200e-3)  # the seed and autograd's kernels
    assert read("ema_ms.train", layer) == pytest.approx(10e-3)
    assert read("step_idle_ms.train", layer) == pytest.approx(10e-3)  # 5 + 5 x 1 us; not the 50 between
    assert read("optimizer_ms.train", layer) == pytest.approx(20e-3)  # the accepted reader, beside them


def test_ranges_that_do_not_pair_read_nothing():
    layer = sampling_slice()
    layer["trace"].device_ranges += [("c2w.window.pass", 400, 410), ("c2w.window.pass", 420, 430)]
    assert spans.paired(layer["trace"], "c2w.window.pass") is None
    assert read("window_fold_ms_per_eval.sample", layer) is None and read("eval_idle_ms.sample", layer) is None


def on_card(trace):
    """``trace``, a CPU profile, with each innermost host operation standing
    in for a kernel and each program or library range given the
    device-side interval of the operations it holds innermost."""
    ranges = [op for op in trace.host_ops if op[0].startswith(RANGES)]
    ops = sorted((op for op in trace.host_ops if not op[0].startswith(RANGES)), key=lambda op: (op[1], -op[2]))
    kernels = [op for op, nxt in zip(ops, ops[1:] + [(None, math.inf, math.inf)]) if nxt[1] >= op[2]]
    tied = {}
    for k in kernels:
        holding = [r for r in ranges if r[1] <= k[1] and k[2] <= r[2]]
        if holding:
            r = max(holding, key=lambda r: r[1])
            a, b = tied.get(r, (k[1], k[2]))
            tied[r] = (min(a, k[1]), max(b, k[2]))
    trace.device_ops = sorted(kernels, key=lambda op: op[1])
    trace.starts = [op[1] for op in trace.device_ops]
    trace.device_ranges = [(r[0], a, b) for r, (a, b) in tied.items()]
    trace.intervals = trace._union()
    return trace


@pytest.fixture(scope="module")
def snapshot(tmp_path_factory):
    return tc.write_snapshot(tmp_path_factory.mktemp("snapshot"))


@pytest.mark.parametrize("kind", ["sample", "train"])
def test_traced_tiny_runs_read_every_span_metric(snapshot, kind):
    config = tc.tiny_config(snapshot) if kind == "sample" else tc.tiny_config()
    traffic = tc.sampling_traffic() if kind == "sample" else tc.training_traffic()
    limits = tc.SAMPLING_LIMITS if kind == "sample" else tc.TRAINING_LIMITS
    names = SAMPLING if kind == "sample" else TRAINING
    ctx = tc.context(kind, config, traffic, limits, trace=True)
    outcome = ctx["driver"].run(ctx)
    assert outcome.compared.correct(), outcome.compared.items
    layer = {**outcome.layer, "trace": on_card(outcome.layer["trace"])}
    for name in names:
        value = read(name, layer)
        assert value is not None and math.isfinite(value) and value >= 0, (name, value)
    untraced = tc.context(kind, config, traffic, limits)
    layer = untraced["driver"].run(untraced).layer
    assert all(read(name, layer) is None for name in names)
