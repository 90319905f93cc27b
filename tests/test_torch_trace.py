"""The port's spans and counters (``utils/trace.py``) on the CPU: off they
cost no profiler range and leave no record; on, they nest as the sampler
and the train step run; the window counters count the work; a record lies
inside its profiler event; the kernels' launch counters read and reset as
``chip_smoke.py`` reads and resets them."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from climate2weather_tpu_torch.diffusion.process import construct_process
from climate2weather_tpu_torch.exp.downscaling import iter_samples
from climate2weather_tpu_torch.models.score_net import build_score_unet
from climate2weather_tpu_torch.training.state import (
    init_train_state,
    make_device_data_train_step,
    make_optimizer,
    step_generator,
)
from climate2weather_tpu_torch.utils import trace

L, HW, C, WINDOW, CHUNK = 13, 32, 2, 5, 4
NET = {"channels": C * WINDOW, "embedding_dim": 32, "noise_features": 8, "hidden_channels": [8, 16],
       "hidden_blocks": [1, 1], "attention_levels": [1], "kernel_size": 3}
SNAP = {"dataset_kwargs": {"train": {"window": WINDOW, "num_features": C}},
        "network_kwargs": NET, "pipeline_kwargs": {"class_name": "vp_cosine"}}
SAMPLING = {"sampler_kind": "dpmpp2m", "sde_eta": 0.3, "denoise_final": True, "t0_project": "spectral",
            "num_sampling_steps": 2, "likelihood_std": [0.2, 0.3], "likelihood_gamma": 7e-4, "t_step": 6,
            "s_step": 16, "batch_size": CHUNK, "ensemble_batch": 2, "num_samples": 2, "seed": 3,
            "observation_path": "gt", "data_path": "gt", "spectral_calibrate": "frames"}
SAMPLE_SPANS = {"c2w.sample.group", "c2w.sample.eval", "c2w.window.pass", "c2w.model.forward",
                "c2w.sample.guidance", "c2w.sample.update", "c2w.sample.postprocess"}
TRAIN_SPANS = {"c2w.train.step", "c2w.train.gather", "c2w.train.forward", "c2w.train.backward", "c2w.train.ema"}


@pytest.fixture(scope="module")
def net():
    torch.manual_seed(0)
    return build_score_unet(NET, dtype=torch.float32).eval().requires_grad_(False)


@pytest.fixture
def clean():
    trace.disable()
    trace.reset()
    yield
    trace.disable()
    trace.reset()


def inputs(seed=0):
    g = np.random.default_rng(seed)
    return g.standard_normal((L, HW, HW, C)).astype(np.float32), g.standard_normal((8, C, HW, HW)).astype(np.float32)


def sample(net, **overrides):
    gt, frames = inputs()
    return list(iter_samples(net, SNAP, {**SAMPLING, **overrides}, gt, frames, "cpu"))


def train(rounds=2, steps=1):
    torch.manual_seed(1)
    model = build_score_unet(NET, dtype=torch.float32)
    state = init_train_state(model, make_optimizer(model.parameters(), {}), (0.999,))
    step = make_device_data_train_step(construct_process("vp_cosine"), lambda s: 1e-3, WINDOW, (0.999,))
    data = torch.randn((12, C, HW, HW), generator=torch.Generator().manual_seed(2))
    for s in range(steps):
        idx = torch.arange(2 * rounds).reshape(rounds, 2) + s
        step(state, data, idx, step_generator(0, s, "cpu"))


def by_id(records) -> dict:
    return {r.id: r for r in records}


def ancestors(rec, index) -> list:
    names = []
    while rec.parent is not None:
        rec = index[rec.parent]
        names.append(rec.name)
    return names


def test_off_makes_no_record_and_enters_no_profiler_range(net, clean, monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("record_function entered with tracing off")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    sample(net)
    train()
    assert trace.records() == []
    assert trace.span("c2w.sample.eval", step=0) is trace.span("c2w.train.step")  # the one shared no-op


def test_sampling_spans_nest(net, clean):
    trace.enable()
    sample(net)
    recs = trace.records()
    index = by_id(recs)
    assert {r.name for r in recs} == SAMPLE_SPANS
    groups = [r for r in recs if r.name == "c2w.sample.group"]
    assert len(groups) == 1 and groups[0].attrs == {"samples": [0, 1]} and groups[0].parent is None
    evals = [r for r in recs if r.name == "c2w.sample.eval"]
    assert [r.attrs["step"] for r in evals] == [0, 1, 2]  # two steps and the final denoise
    for r in recs:
        up = ancestors(r, index)
        if r.name == "c2w.sample.eval":
            assert up == ["c2w.sample.group"]
        elif r.name == "c2w.model.forward":
            assert up[:2] == ["c2w.window.pass", "c2w.sample.eval"]
        elif r.name in ("c2w.window.pass", "c2w.sample.guidance", "c2w.sample.update"):
            assert up == ["c2w.sample.eval", "c2w.sample.group"]
        elif r.name == "c2w.sample.postprocess":
            assert up == ["c2w.sample.group"]
        assert r.start_ns <= r.end_ns and r.device_ms is None  # no card here
        if r.parent is not None:
            p = index[r.parent]
            assert p.start_ns <= r.start_ns and r.end_ns <= p.end_ns


def test_long_path_spans_and_resume_counters(net, clean, tmp_path):
    gt, _ = inputs()
    cfg = {**SAMPLING, "num_samples": 1, "long_trajectory_threshold": 8, "num_sampling_steps": 17,
           "sample_resume_every": 1, "t0_project": ""}
    cfg.pop("spectral_calibrate")
    trace.enable()
    list(iter_samples(net, SNAP, cfg, gt, None, "cpu"))  # no resume directory: nothing saved
    assert {r.name for r in trace.records()} == SAMPLE_SPANS
    assert trace.counters().get("resume_saves", 0) == 0
    trace.reset()
    list(iter_samples(net, SNAP, cfg, gt, None, "cpu", resume_dir=str(tmp_path)))
    saves = [r for r in trace.records() if r.name == "c2w.sample.resume_save"]
    assert [r.attrs["step"] for r in saves] == [8, 16]  # calls of 8 steps, a file after each but the last
    counted = trace.counters()
    assert counted["resume_saves"] == 2 and counted["resume_bytes"] > 2 * 2 * L * HW * HW * C * 4


@pytest.mark.parametrize("path", ["device", "long"])
def test_window_counters_count_the_work(net, clean, path):
    steps, members = 2, 2
    over = {} if path == "device" else {"num_samples": 1, "long_trajectory_threshold": 8}
    trace.reset()
    sample(net, num_sampling_steps=steps, **over)
    n = L - WINDOW + 1  # 9 windows in chunks of 4: 3 chunks, the last shifted back
    chunks = -(-n // CHUNK)
    samples = members if path == "device" else 1
    evals = steps + 1  # the final denoise
    counted = trace.counters()
    assert counted["window_evals"] == samples * evals * chunks * CHUNK
    assert counted["forwards"] == evals * chunks


def test_train_step_spans_nest_once_per_microbatch(clean):
    trace.enable()
    train(rounds=2, steps=2)
    recs = trace.records()
    index = by_id(recs)
    assert {r.name for r in recs} == TRAIN_SPANS
    steps = [r for r in recs if r.name == "c2w.train.step"]
    assert [r.attrs["step"] for r in steps] == [0, 1] and all(r.parent is None for r in steps)
    for st in steps:
        kids = [r for r in recs if r.parent == st.id]
        assert [(r.name, r.attrs.get("round")) for r in kids] == [
            ("c2w.train.gather", 0), ("c2w.train.forward", 0), ("c2w.train.backward", 0),
            ("c2w.train.gather", 1), ("c2w.train.forward", 1), ("c2w.train.backward", 1),
            ("c2w.train.ema", None)]
    assert all(ancestors(r, index) == ["c2w.train.step"] for r in recs if r.name != "c2w.train.step")


def test_records_lie_inside_their_profiler_events(net, clean):
    trace.enable()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        sample(net, num_sampling_steps=1)
        train(rounds=1)
    events = {}
    for e in prof.events():
        if e.name.startswith("c2w."):
            events.setdefault(e.name, []).append(e.time_range)
    recs = trace.records()
    assert {r.name for r in recs} == SAMPLE_SPANS | TRAIN_SPANS
    for name in events:
        mine = sorted((r for r in recs if r.name == name), key=lambda r: r.start_ns)
        theirs = sorted(events[name], key=lambda tr: tr.start)
        assert len(mine) == len(theirs), name
        for r, tr in zip(mine, theirs):
            a, b = trace.profile_us(prof, r.start_ns), trace.profile_us(prof, r.end_ns)
            assert tr.start - 100 <= a <= b <= tr.end + 100, (name, tr.start, a, b, tr.end)


def test_a_profiler_alone_marks_spans_and_records_nothing(net, clean):
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        train(rounds=1)
    assert {e.name for e in prof.events() if e.name.startswith("c2w.")} == TRAIN_SPANS
    assert trace.records() == []


def test_launch_counts_read_and_reset_as_the_smoke_does(clean):
    from climate2weather_tpu_torch.ops import attention, winograd

    for k in attention.launch_counts:
        attention.launch_counts[k] = 0
    trace.count("attention_fwd")
    trace.count("attention_fwd")
    trace.count("winograd_conv3x3")
    before = dict(attention.launch_counts)
    assert before == {"attention_fwd": 2, "attention_bwd": 0} and attention.launch_counts == before
    assert sorted({**attention.launch_counts, **winograd.launch_counts}) == [
        "attention_bwd", "attention_fwd", "winograd_conv3x3"]
    assert attention.launch_counts["attention_fwd"] - before["attention_fwd"] == 0
    assert trace.counters()["attention_fwd"] == 2 and winograd.launch_counts["winograd_conv3x3"] == 1
    for k in attention.launch_counts:
        attention.launch_counts[k] = 0
    assert dict(attention.launch_counts) == {"attention_fwd": 0, "attention_bwd": 0}
    assert trace.counters()["attention_fwd"] == 0
    with pytest.raises(KeyError):
        attention.launch_counts["winograd_conv3x3"]
