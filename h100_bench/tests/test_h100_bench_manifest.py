"""BENCHMARK.json against the benchmark's contract, and every name in it
resolving to its file; the import guard."""

from __future__ import annotations

import ast
import json
import os
import re
import subprocess
import sys

import pytest

from h100_bench import harness, run

BENCH = harness.read_json(harness.ROOT / "BENCHMARK.json")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
WIDTH_KEYS = re.compile(r"(_dim|_rank)$|hidden|intermediate|latent|state|projection|head|expansion|channels")


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "h100_bench/run.py"] and BENCH["paths"] == ["h100_bench"]
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51
    # a full check of 24 cells fits the driver's 43,200 seconds
    assert (2 + 14 * 24) * (BENCH["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200
    assert len(json.dumps(BENCH)) <= 64 * 1024


@pytest.mark.parametrize("config", BENCH["configs"], ids=lambda c: c["name"])
def test_config_resolves(config):
    assert set(config) == {"name", "source", "file", "reduced", "why"}
    assert NAME.match(config["name"]) and config["file"].startswith("h100_bench/configs/")
    data = harness.read_json(harness.ROOT / config["file"])
    assert data["name"] == config["name"] and data["reduced"] == config["reduced"]
    assert not any(WIDTH_KEYS.search(k) for k in config["reduced"])
    assert any(w["config"] == config["name"] for w in BENCH["workloads"])
    assert 1 <= len(config["why"]) <= 200 and 1 <= len(config["source"]) <= 200


@pytest.mark.parametrize("cell", BENCH["workloads"], ids=lambda w: w["name"])
def test_cell_resolves(cell):
    assert set(cell) == {"name", "config", "traffic", "chips", "why"}
    assert NAME.match(cell["name"]) and NAME.match(cell["traffic"]) and cell["chips"] == 1
    assert 1 <= len(cell["why"]) <= 200
    loaded = run.load_cell(cell["name"])
    assert loaded["config"]["name"] == cell["config"]
    assert hasattr(loaded["driver"], "run")
    e2e = run.cell_metrics(BENCH, cell["name"], trace=False)
    assert "setup_s" in e2e and len(e2e) >= 2
    assert run.cell_metrics(BENCH, cell["name"], trace=True)


@pytest.mark.parametrize("metric", BENCH["end_to_end"] + BENCH["per_layer"], ids=lambda m: m["name"])
def test_metric_resolves(metric):
    assert NAME.match(metric["name"]) and UNIT.match(metric["unit"]) and metric["better"] in ("lower", "higher")
    assert metric["source"] in SOURCES
    cells = {w["name"] for w in BENCH["workloads"]}
    assert set(metric.get("workloads", cells)) <= cells
    if metric in BENCH["end_to_end"]:
        assert set(metric) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0.01 <= metric["bound"] <= 0.25
    else:
        assert set(metric) == {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        reader = harness.BENCH_DIR / "layer_metrics" / f"{metric['name']}.py"
        assert hasattr(harness.load_module(reader, "reader_under_test"), "read")
        for cell in metric.get("workloads", cells):  # each cell reports what it moves
            assert metric["moves"] in run.cell_metrics(BENCH, cell, trace=False)


@pytest.mark.parametrize("cell", BENCH["workloads"], ids=lambda w: w["name"])
def test_limits_name_every_compared_number(cell):
    limits = harness.read_json(harness.BENCH_DIR / "limits" / f"{cell['name']}.json")
    driver = harness.read_json(harness.BENCH_DIR / "traffic" / f"{cell['traffic']}.json")["driver"]
    known, needed = {"ensemble_sampling": ({"sample_rel_rms"}, {"sample_rel_rms"}),
                     "train_steps": ({"loss_gap", "grad1_gap", "change_gap", "ema_change_gap"},
                                     {"grad1_gap", "change_gap"})}[driver]
    assert needed <= set(limits) <= known and all(v > 0 for v in limits.values())


def test_guard_names_whole_top_level_modules():
    found = harness.forbidden_modules({"jax": 0, "jax.numpy": 0, "jaxlib": 0, "flax.linen": 0,
                                       "climate2weather_tpu.ops": 0, "climate2weather_tpu_torch": 0,
                                       "climate2weather_tpu_torch.ops": 0, "jaxtyping": 0, "numpy": 0})
    assert found == ["climate2weather_tpu.ops", "flax.linen", "jax", "jax.numpy", "jaxlib"]


def _guard_in_subprocess(tmp_path, planted: str):
    (tmp_path / "jax.py").write_text("")  # a stand-in that imports as jax
    code = (f"import sys; sys.path[:0] = [{str(tmp_path)!r}, {str(harness.ROOT)!r}]; {planted}; "
            "from h100_bench import run; run.guard_imports('test'); print('clean')")
    return subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120)


def test_guard_catches_a_planted_import_jax(tmp_path):
    proc = _guard_in_subprocess(tmp_path, "import jax")
    assert proc.returncode == 3 and "jax" in proc.stderr and "clean" not in proc.stdout


def test_guard_passes_the_program(tmp_path):
    proc = _guard_in_subprocess(tmp_path, "import climate2weather_tpu_torch.ops.attention")
    assert proc.returncode == 0 and "clean" in proc.stdout, proc.stderr


def test_no_file_of_the_benchmark_imports_jax_and_the_reference_none_of_the_program():
    for path in harness.BENCH_DIR.rglob("*.py"):
        tree = ast.parse(path.read_text())
        names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names]
        names += [n.module or "" for n in ast.walk(tree) if isinstance(n, ast.ImportFrom)]
        tops = {n.split(".")[0] for n in names}
        assert not tops & harness.FORBIDDEN, path
        if "reference" in path.parts:
            assert harness.PROGRAM not in tops, path


def test_a_run_without_a_card_exits_without_a_result():
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    proc = subprocess.run([sys.executable, str(harness.BENCH_DIR / "run.py"), "--workload",
                           BENCH["workloads"][0]["name"], "--seed", "3000000001", "--seconds", "1", "--trace", "0"],
                          capture_output=True, text=True, timeout=300, cwd=harness.ROOT,
                          env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert proc.returncode != 0 and proc.stdout == ""
