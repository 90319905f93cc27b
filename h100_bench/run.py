"""One run of one cell of the port's benchmark.

    python3 h100_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell is an entry of ``BENCHMARK.json``'s ``workloads``; its
configuration is ``configs/<config>.json``, its traffic mix
``traffic/<traffic>.json``, which names the driver in ``drivers/`` that runs
it, and the limits of its check ``limits/<cell>.json``. The driver sets up
(imports, the program's kernels from their build directory in the
checkout, weights and inputs from the seed, a warm-up of the cell's own
shapes), runs the window, and checks the window's output against the plain
reference in ``reference/``. With ``--trace 0`` the result line holds the
cell's end-to-end metrics, with ``--trace 1`` its per-layer metrics, each
read by ``layer_metrics/<metric>.py``. The last line of standard output is
the result; the numbers compared, each with its limit, are the last lines
of standard error and the last key of the result.

It runs on the card only: without CUDA, with fewer cards than the cell
asks for, without the program beside it, or with JAX or the JAX package
loaded, it exits non-zero and prints no result.
"""

from __future__ import annotations

import time

T_START = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from h100_bench import harness  # noqa: E402


def cell_entry(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise SystemExit(f"no workload {name!r} in BENCHMARK.json")


def cell_metrics(bench: dict, name: str, trace: bool) -> list:
    """The names of the metrics this cell reports: its end-to-end metrics
    (those without a ``workloads`` key are every cell's), or with ``trace``
    the per-layer metrics whose ``workloads`` name it."""
    if trace:
        return [m["name"] for m in bench["per_layer"] if name in m["workloads"]]
    return [m["name"] for m in bench["end_to_end"] if name in m.get("workloads", [name])]


def load_cell(name: str) -> dict:
    """Everything a driver needs to know of cell ``name``."""
    bench = harness.read_json(ROOT / "BENCHMARK.json")
    entry = cell_entry(bench, name)
    config = next(c for c in bench["configs"] if c["name"] == entry["config"])
    traffic = harness.read_json(harness.BENCH_DIR / "traffic" / f"{entry['traffic']}.json")
    return {
        "bench": bench, "entry": entry, "config": harness.read_json(ROOT / config["file"]),
        "traffic": traffic, "limits": harness.read_json(harness.BENCH_DIR / "limits" / f"{name}.json"),
        "driver": harness.load_module(harness.BENCH_DIR / "drivers" / f"{traffic['driver']}.py",
                                      f"h100_bench_driver_{traffic['driver']}"),
    }


def fail(msg: str, code: int = 2):
    harness.log(f"h100_bench: {msg}")
    sys.exit(code)


def guard_imports(when: str) -> None:
    found = harness.forbidden_modules()
    if found:
        fail(f"{when}: JAX or the JAX package is loaded: {', '.join(found)}", 3)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description="one run of one cell of the port's benchmark")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    guard_imports("at start")
    if not (ROOT / harness.PROGRAM / "__init__.py").is_file():
        fail(f"the program {harness.PROGRAM} is not beside the benchmark in {ROOT}")
    cell = load_cell(args.workload)
    import torch

    chips = int(cell["entry"]["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        fail(f"the cell needs {chips} CUDA device(s); this machine has "
             f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
    stages = harness.Stages(T_START)
    stages("python and torch")
    ctx = {**cell, "seed": args.seed, "seconds": args.seconds, "trace": bool(args.trace),
           "device": torch.device("cuda", 0), "t_start": T_START, "stages": stages, "name": args.workload}
    result = execute(ctx)
    guard_imports("when the window had closed")
    for name, item in result["compared"].items():
        harness.log(f"compared {name}: {item['value']!r} limit {item['limit']!r}")
    print(json.dumps(result), flush=True)


def execute(ctx: dict) -> dict:
    """Run the cell ``ctx`` describes on ``ctx["device"]`` and return its
    result line as a dict."""
    outcome = ctx["driver"].run(ctx)
    trace = ctx["trace"]
    names = cell_metrics(ctx["bench"], ctx["name"], trace)
    units = {m["name"]: m["unit"] for m in ctx["bench"]["end_to_end"] + ctx["bench"]["per_layer"]}
    metrics = {}
    for name in names:
        value = harness.read_layer_metric(name, outcome.layer) if trace else outcome.e2e.get(name)
        if value is not None:
            metrics[name] = {"value": value, "unit": units[name]}
    missing = [n for n in names if n not in metrics and not trace]
    if missing:
        fail(f"the driver gave no {', '.join(missing)}", 4)
    dev = ctx["device"]
    device = {"platform": "gpu" if dev.type == "cuda" else dev.type,
              "kind": torch_device_name(dev), "count": int(ctx["entry"]["chips"]),
              "memory_peak_bytes": int(outcome.peak_bytes)}
    result = {"correct": outcome.compared.correct(), "attempted": outcome.attempted,
              "failed": outcome.failed, "metrics": metrics, "device": device}
    if trace and "trace" in outcome.layer:
        device.update(busy_s=outcome.layer["trace"].busy_s, window_s=outcome.layer["trace"].window_s)
        result["breakdown"] = outcome.layer["trace"].breakdown()
    result["compared"] = outcome.compared.items
    return result


def torch_device_name(dev) -> str:
    import torch

    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"


if __name__ == "__main__":
    main()
