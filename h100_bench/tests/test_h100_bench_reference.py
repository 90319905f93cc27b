"""The plain reference against the program at the tiny cells' sizes, and
the control: the reference in float8 put in the program's place reads far
outside what the program reads."""

from __future__ import annotations

import numpy as np
import pytest
import torch

import tiny_cells as tc
from h100_bench import harness
from h100_bench.reference import net as ref_net
from h100_bench.reference import snapshot as ref_snapshot


@pytest.fixture(scope="module")
def snapshot(tmp_path_factory):
    return tc.write_snapshot(tmp_path_factory.mktemp("snapshot"))


@pytest.fixture(scope="module")
def sampling_driver():
    return harness.load_module(harness.BENCH_DIR / "drivers" / "ensemble_sampling.py", "ref_test_sampling")


@pytest.fixture(scope="module")
def training_driver():
    return harness.load_module(harness.BENCH_DIR / "drivers" / "train_steps.py", "ref_test_training")


def test_reference_net_matches_the_program_net(snapshot):
    from climate2weather_tpu_torch.exp.downscaling import load_net

    net, _ = load_net(snapshot, "cpu", compute_dtype=torch.float32)
    reference = ref_net.ReferenceUNet(tc.TINY_MODEL, ref_snapshot.read_params(f"{snapshot}/params.msgpack", "cpu"))
    x = torch.randn((3, 32, 32, 10), generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        want = net(x, 0.4)
    got = reference(x, 0.4)
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())
    assert set(ref_net.param_shapes(tc.TINY_MODEL)) == set(dict(net.named_parameters()))


@pytest.mark.parametrize("seed", [5, 3_000_000_017])
def test_reference_sample_matches_the_program_in_float32(snapshot, sampling_driver, seed):
    from climate2weather_tpu_torch.exp.downscaling import iter_samples, load_net

    config, traffic = tc.tiny_config(snapshot), tc.sampling_traffic()
    gt, train = sampling_driver.synthetic_inputs(13, 32, 32, 2, 8, harness.seed_for(seed, "inputs"))
    program_seed = harness.seed_for(seed, "sampler")
    net, snap_cfg = load_net(snapshot, "cpu", compute_dtype=torch.float32)
    cfg = sampling_driver.sampler_config(traffic, program_seed, 2)
    sids, samples, _ = next(iter_samples(net, snap_cfg, cfg, gt, train, "cpu"))
    for mi in range(2):
        want = sampling_driver.reference_member(config, traffic, torch.device("cpu"), gt, train, program_seed, sids[mi])
        assert sampling_driver.rel_rms(samples[mi], want) < 1e-5


def test_reference_training_matches_the_program_in_float32(training_driver):
    config, traffic = tc.tiny_config(), tc.training_traffic()
    dev = torch.device("cpu")
    got = training_driver.Program(config, traffic, dev, 7).checked_steps(3)
    ref = training_driver.reference_run(config, traffic, dev, 7, 3)
    gaps = training_driver.gaps(got, ref)
    assert gaps["loss_gap"] < 1e-6 and gaps["grad1_gap"] < 1e-5
    assert gaps["change_gap"] < 1e-3 and gaps["ema_change_gap"] < 1e-3


def test_sampling_control_reads_far_above_the_program(snapshot, sampling_driver):
    """The program in bf16 and the float8 control, each against the float32
    reference, on three seeds."""
    config, traffic = tc.tiny_config(snapshot), tc.sampling_traffic()
    dev = torch.device("cpu")
    from climate2weather_tpu_torch.exp.downscaling import iter_samples, load_net

    net, snap_cfg = load_net(snapshot, "cpu")
    for seed in (11, 12, 13):
        gt, train = sampling_driver.synthetic_inputs(13, 32, 32, 2, 8, harness.seed_for(seed, "inputs"))
        program_seed = harness.seed_for(seed, "sampler")
        sids, samples, _ = next(iter_samples(net, snap_cfg, sampling_driver.sampler_config(traffic, program_seed, 2),
                                             gt, train, "cpu"))
        ref = sampling_driver.reference_member(config, traffic, dev, gt, train, program_seed, sids[0])
        ctl = sampling_driver.reference_member(config, traffic, dev, gt, train, program_seed, sids[0], cast="fp8")
        program, control = sampling_driver.rel_rms(samples[0], ref), sampling_driver.rel_rms(ctl, ref)
        assert control > 3 * program, (program, control)
        # through the check a run makes, against the tiny cell's limits
        assert sampling_driver.compare(samples[0], [(samples, np.zeros(2, bool))], ref, tc.SAMPLING_LIMITS).correct()
        assert not sampling_driver.compare(ctl, [(ctl.numpy(), np.zeros(1, bool))], ref, tc.SAMPLING_LIMITS).correct()


def test_training_control_reads_far_above_the_program(training_driver):
    config, traffic = dict(tc.tiny_config(), compute_dtype="bfloat16"), tc.training_traffic()
    dev = torch.device("cpu")
    for seed in (21, 22, 23):
        ref = training_driver.reference_run(config, traffic, dev, seed, 3)
        prog = {**training_driver.Program(config, traffic, dev, seed).checked_steps(3), "window_losses": []}
        ctl = {**training_driver.reference_run(config, traffic, dev, seed, 3, cast="fp8"), "window_losses": []}
        pg, cg = training_driver.gaps(prog, ref), training_driver.gaps(ctl, ref)
        assert max(cg[k] / pg[k] for k in ("loss_gap", "grad1_gap")) > 3, (pg, cg)
        # through the check a run makes, against the tiny cell's limits
        assert not training_driver.compare(ctl, ref, tc.TRAINING_LIMITS).correct(), cg


def test_fp8_round_holds_e4m3():
    x = torch.linspace(-3.0, 3.0, 101)
    held = ref_net.fp8_round(x)
    scale = 3.0 / 448.0
    assert torch.equal(held, (x / scale).to(torch.float8_e4m3fn).float() * scale)
    assert len(np.unique(held.numpy())) < 101
