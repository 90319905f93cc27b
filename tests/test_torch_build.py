"""The nvcc build of the port's CUDA sources, as far as it runs without a
compiler: where nvcc is looked for, the source-hash key, and failures that
carry the compiler's output."""

import os
import stat

import pytest

from climate2weather_tpu_torch.ops import build


def _fake_nvcc(tmp_path, body: str) -> str:
    path = tmp_path / "nvcc"
    path.write_text("#!/bin/sh\n" + body)
    path.chmod(path.stat().st_mode | stat.S_IEXEC)
    return str(path)


def test_find_nvcc_prefers_cuda_home(tmp_path, monkeypatch):
    (tmp_path / "bin").mkdir()
    fake = _fake_nvcc(tmp_path / "bin", "exit 0\n")
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    assert build.find_nvcc() == fake


def test_find_nvcc_raises_when_absent(tmp_path, monkeypatch):
    if os.path.exists("/usr/local/cuda/bin/nvcc"):
        pytest.skip("this machine has /usr/local/cuda/bin/nvcc")
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.find_nvcc()


def test_library_is_keyed_on_the_source(tmp_path, monkeypatch):
    monkeypatch.setattr(build, "CSRC_DIR", tmp_path)
    src = tmp_path / "k.cu"
    src.write_text("// one\n")
    first = build.library_path("k.cu")
    src.write_text("// two\n")
    assert build.library_path("k.cu") != first
    assert first.name.startswith("k-") and first.suffix == ".so"


def test_real_source_is_keyed_and_in_the_build_dir():
    lib = build.library_path("attention_fwd.cu")
    assert lib.parent == build.BUILD_DIR and lib.name.startswith("attention_fwd-")


def test_compiler_failure_raises_with_its_output(tmp_path, monkeypatch):
    monkeypatch.setattr(build, "CSRC_DIR", tmp_path)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    (tmp_path / "k.cu").write_text("// k\n")
    fake = _fake_nvcc(tmp_path, "echo 'error: boom' >&2\nexit 2\n")
    monkeypatch.setattr(build, "find_nvcc", lambda: fake)
    with pytest.raises(RuntimeError, match="boom"):
        build.build("k.cu")
    assert list((tmp_path / "build").iterdir()) == []  # no half-written library


def test_successful_build_is_reused(tmp_path, monkeypatch):
    monkeypatch.setattr(build, "CSRC_DIR", tmp_path)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    (tmp_path / "k.cu").write_text("// k\n")
    log = tmp_path / "calls"
    # the fake compiler writes its -o target and counts its calls
    fake = _fake_nvcc(tmp_path, f'echo x >> {log}\nwhile [ "$1" != "-o" ]; do shift; done\necho lib > "$2"\n')
    monkeypatch.setattr(build, "find_nvcc", lambda: fake)
    lib = build.build("k.cu")
    assert lib.exists() and build.build("k.cu") == lib
    assert log.read_text().count("x") == 1
