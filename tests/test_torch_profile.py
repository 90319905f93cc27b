"""The profiling entry point runs end to end (rehearsed on the CPU at a small
size; on the card it traces the CUDA kernels too)."""

import json

from climate2weather_tpu_torch.exp import profile_forward


def test_profile_forward_rehearsal_on_cpu(tmp_path, capsys):
    profile_forward.main(["--device", "cpu", "--members", "1", "--res", "32", "--out", str(tmp_path)])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["device"] == "cpu" and out["windows_per_forward"] == 32
    assert out["wall_ms"] > 0 and out["kernel_launches"] == 0  # no CUDA activity on the CPU
    assert (tmp_path / "guided_evaluation.json").exists()
    # one guided evaluation: two chunked forwards in one window pass, the
    # guidance's gradient and its combination with the score
    spans = out["spans"]
    assert {n: s["count"] for n, s in spans.items()} == {
        "c2w.window.pass": 1, "c2w.model.forward": 2, "c2w.sample.guidance": 2}
    assert all(s["host_ms"] > 0 and s["device_ms"] is None for s in spans.values())


def test_kernel_groups():
    assert profile_forward.group_of("void attention_fwd_kernel<float>") == "attention kernel"
    assert profile_forward.group_of("sm90_xmma_fprop_implicit_gemm_bf16") == "convolution"
    assert profile_forward.group_of("at::native::reduce_kernel<512>") == "reduction"
    assert profile_forward.group_of("mystery") == "other"
    # cuDNN's layout transposes are not convolutions, though their names say cudnn
    for name in ("void cudnn::engines_precompiled::nchwToNhwcKernel<__nv_bfloat16, __nv_bfloat16, float>",
                 "void cudnn::engines_precompiled::nhwcToNchwKernel<__nv_bfloat16, __nv_bfloat16, float>"):
        assert profile_forward.group_of(name) == "layout transpose"


def test_profile_train_step_rehearsal_on_cpu(tmp_path, capsys):
    from climate2weather_tpu_torch.exp import profile_train_step

    profile_train_step.main(["--device", "cpu", "--res", "16", "--frames", "20", "--batch", "4",
                             "--batch-gpu", "2", "--model-config", "configs/tiny_unet.yml",
                             "--out", str(tmp_path)])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["device"] == "cpu" and out["traced_steps"] == 2 and out["batch_gpu"] == 2
    assert out["wall_ms_per_step"] > 0 and out["kernel_launches_per_step"] == 0
    assert (tmp_path / "train_step.json").exists()
    per_step = {n: s["count"] for n, s in out["spans_per_step"].items()}
    assert per_step == {"c2w.train.step": 1, "c2w.train.gather": 2, "c2w.train.forward": 2,
                        "c2w.train.backward": 2, "c2w.train.ema": 1}  # 4 / 2 microbatches a step
    assert profile_forward.group_of("void attention_bwd_grads_kernel<__nv_bfloat16>") == \
        "attention backward kernel"


def test_profile_vjp_rehearsal_on_cpu(capsys):
    from climate2weather_tpu_torch.exp import profile_vjp

    profile_vjp.main(["--device", "cpu", "--res", "32", "--windows", "1", "2"])
    lines = [json.loads(ln) for ln in capsys.readouterr().out.strip().splitlines()[-2:]]
    assert [ln["windows"] for ln in lines] == [1, 2]
    for ln in lines:
        assert ln["device"] == "cpu" and ln["forward_s"] > 0 and ln["vjp_s"] > 0
        assert ln["vjp_peak_bytes_over_base"] is None  # a device number, not measured on the CPU


def test_profile_host_stream_rehearsal_on_cpu(capsys):
    from climate2weather_tpu_torch.exp import profile_host_stream

    profile_host_stream.main(["--device", "cpu", "--res", "32", "--hours", "16", "--batch", "2", "--reps", "1"])
    lines = [json.loads(ln) for ln in capsys.readouterr().out.strip().splitlines()[-3:]]
    assert [ln.get("slots") for ln in lines] == [2, 1, None]
    for ln in lines[:2]:
        assert ln["device"] == "cpu" and ln["chunks"] == 2 and len(ln["eval_s"]) == 1 and ln["eval_s_mean"] > 0
    assert lines[2]["bits_equal"] and lines[2]["spread_s"] >= 0
