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


def test_kernel_groups():
    assert profile_forward.group_of("void attention_fwd_kernel<float>") == "attention kernel"
    assert profile_forward.group_of("sm90_xmma_fprop_implicit_gemm_bf16") == "convolution"
    assert profile_forward.group_of("at::native::reduce_kernel<512>") == "reduction"
    assert profile_forward.group_of("mystery") == "other"
