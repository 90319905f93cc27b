"""A run with the timed path broken underneath comes out not correct.

Each test drives the rest of a run (``run.execute``: the driver's set-up,
window, check and result line) on the CPU at the tiny cells' sizes, the
look for a card skipped, once sound and once for each fault the cell can
have: a step that returns its state unchanged; half of the batch left out;
an answer altered where it is produced. (No cell spans cards, so none can
leave out an exchange between them.) The limits are the tiny cells' own:
several times what sound tiny runs read, far under what the faults read.
"""

from __future__ import annotations

import pytest
import torch

import tiny_cells as tc

SAMPLING_LIMITS, TRAINING_LIMITS = tc.SAMPLING_LIMITS, tc.TRAINING_LIMITS


@pytest.fixture(scope="module")
def snapshot(tmp_path_factory):
    return tc.write_snapshot(tmp_path_factory.mktemp("snapshot"))


def sampling_run(snapshot):
    return tc.execute(tc.context("sample", tc.tiny_config(snapshot), tc.sampling_traffic(), SAMPLING_LIMITS))


def training_run():
    return tc.execute(tc.context("train", tc.tiny_config(), tc.training_traffic(), TRAINING_LIMITS))


def _step_unchanged(monkeypatch):
    from climate2weather_tpu_torch.diffusion import steprules

    monkeypatch.setattr(steprules, "dpm_sde_step", lambda x, *a, **k: x)


def _half_the_windows(monkeypatch):
    from climate2weather_tpu_torch.models.score_net import ScoreUNet

    forward = ScoreUNet.forward

    def half(self, x, t, forcing=None):
        out = forward(self, x, t, forcing)
        return torch.cat([out[: len(out) // 2], torch.zeros_like(out[len(out) // 2:])])

    monkeypatch.setattr(ScoreUNet, "forward", half)


def _sample_altered(monkeypatch):
    from climate2weather_tpu_torch.exp import downscaling

    calibrate = downscaling.calibrate_trajectory
    monkeypatch.setattr(downscaling, "calibrate_trajectory", lambda x, *a, **k: 1.05 * calibrate(x, *a, **k))


def test_sound_sampling_run_is_correct(snapshot):
    result = sampling_run(snapshot)
    assert result["correct"] and list(result["compared"])[-1] == "sample_rel_rms"
    assert result["metrics"]["window_evals_per_s"]["value"] > 0 and "setup_s" in result["metrics"]


@pytest.mark.parametrize("fault", [_step_unchanged, _half_the_windows, _sample_altered],
                         ids=["step_unchanged", "half_the_windows", "sample_altered"])
def test_faulty_sampling_run_is_not_correct(snapshot, monkeypatch, fault):
    fault(monkeypatch)
    result = sampling_run(snapshot)
    assert not result["correct"], result["compared"]


def _state_unchanged(monkeypatch):
    from climate2weather_tpu_torch.training import state

    def unchanged(st, *args, **kwargs):
        st.step += 1

    monkeypatch.setattr(state, "apply_update", unchanged)


def _half_the_batch(monkeypatch):
    from climate2weather_tpu_torch.diffusion.process import VPCosineProcess

    loss = VPCosineProcess.loss

    def half(self, eps_model, x, forcing=None, generator=None, t=None, eps=None):
        b = x.shape[0]
        t = torch.rand((b,) + (1,) * (x.dim() - 1), generator=generator, device=x.device)
        eps = torch.randn(x.shape, generator=generator, device=x.device, dtype=x.dtype)
        return loss(self, eps_model, x[: b // 2], forcing, None, t[: b // 2], eps[: b // 2])

    monkeypatch.setattr(VPCosineProcess, "loss", half)


def _gradient_altered(monkeypatch):
    from climate2weather_tpu_torch.training import state

    update = state.apply_update

    def altered(st, *args, **kwargs):
        next(iter(st.net.parameters())).grad.mul_(1.5)
        update(st, *args, **kwargs)

    monkeypatch.setattr(state, "apply_update", altered)


def test_sound_training_run_is_correct():
    result = training_run()
    assert result["correct"] and list(result)[-1] == "compared"
    assert result["metrics"]["train_samples_per_s"]["value"] > 0


@pytest.mark.parametrize("fault", [_state_unchanged, _half_the_batch, _gradient_altered],
                         ids=["state_unchanged", "half_the_batch", "gradient_altered"])
def test_faulty_training_run_is_not_correct(monkeypatch, fault):
    fault(monkeypatch)
    result = training_run()
    assert not result["correct"], result["compared"]


def test_traced_tiny_runs_read_their_per_layer_metrics(snapshot):
    sample = tc.execute(tc.context("sample", tc.tiny_config(snapshot), tc.sampling_traffic(), SAMPLING_LIMITS,
                                   trace=True))
    train = tc.execute(tc.context("train", tc.tiny_config(), tc.training_traffic(), TRAINING_LIMITS, trace=True))
    for result, names in ((sample, ("mfu.sample", "idle_share.sample")),
                          (train, ("mfu.train", "step_p90_ms.train", "idle_share.train"))):
        assert result["correct"] and set(names) <= set(result["metrics"])
        assert {"busy_s", "window_s"} <= set(result["device"]) and "breakdown" in result
