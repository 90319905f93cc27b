"""What every cell's run shares: the import guard, seeds, the check's
comparisons, the reading of a profiler trace, the per-layer readers'
helpers, and the reference's numerics.

A traced slice is the stretch of a ``--trace 1`` run between two device
synchronisations in which ``torch.profiler`` records CPU and CUDA activity.
:class:`DeviceTrace` keeps its device operations (kernels, copies, sets),
the device-side spans of host ranges, and the host operations, and answers
the readers' questions: busy seconds (the union of the device operations'
intervals), device seconds of kernels by name and inside a range, and the
breakdown of the result line.
"""

from __future__ import annotations

import bisect
import contextlib
import hashlib
import importlib.util
import json
import math
import pathlib
import statistics
import sys
import time
from dataclasses import dataclass, field

ROOT = pathlib.Path(__file__).resolve().parents[1]
BENCH_DIR = ROOT / "h100_bench"
PROGRAM = "climate2weather_tpu_torch"
# top-level module names no run may hold: JAX and the JAX package, whose
# name the program's name begins with
FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "climate2weather_tpu"})


def forbidden_modules(modules=None) -> list:
    """Names of loaded modules whose top-level name (before the first dot)
    is one of :data:`FORBIDDEN`."""
    modules = sys.modules if modules is None else modules
    return sorted(name for name in list(modules) if name.split(".", 1)[0] in FORBIDDEN)


def seed_for(seed: int, *parts) -> int:
    """A 31-bit seed from the run's seed and names, the same on every host."""
    h = hashlib.blake2b(repr((int(seed),) + parts).encode(), digest_size=8)
    return int.from_bytes(h.digest(), "little") % (1 << 31)


def log(*args) -> None:
    print(*args, file=sys.stderr, flush=True)


def quantile(values, q: float) -> float:
    """The q-quantile of ``values`` by linear interpolation between order
    statistics."""
    xs = sorted(values)
    if not xs:
        return math.nan
    pos = q * (len(xs) - 1)
    lo = int(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def worst_leaf_gap(program: dict, reference: dict, keys=None) -> tuple:
    """``(gap, leaf)``: the largest | |a| - |b| | / max(|b|, median |b|)
    over the leaves ``keys`` (all by default), a and b the program's and the
    reference's norms of a leaf."""
    keys = list(reference) if keys is None else list(keys)
    med = statistics.median(reference[k] for k in reference)
    worst = (0.0, None)
    for k in keys:
        gap = abs(program[k] - reference[k]) / max(reference[k], med, 1e-30)
        if gap > worst[0]:
            worst = (gap, k)
    return worst


@dataclass
class Compared:
    """The numbers that decide ``correct``, each with its limit; a value
    above its limit, or not finite, fails."""

    items: dict = field(default_factory=dict)

    def add(self, name: str, value: float, limit: float) -> None:
        self.items[name] = {"value": float(value), "limit": float(limit)}

    def correct(self) -> bool:
        return bool(self.items) and all(math.isfinite(v["value"]) and v["value"] <= v["limit"]
                                        for v in self.items.values())


@dataclass
class Outcome:
    """What a traffic driver hands back to :mod:`run`."""

    e2e: dict
    attempted: int
    failed: int
    peak_bytes: int
    compared: Compared
    layer: dict  # what the per-layer readers read; a traced run's slice under "trace"


class DeviceTrace:
    """The device and host operations of one traced slice of ``window_s``
    host seconds."""

    def __init__(self, prof, window_s: float):
        from torch.autograd import DeviceType

        self.window_s = float(window_s)
        self.device_ops = []  # (name, start_us, end_us)
        self.device_ranges = []  # host ranges' spans on the device timeline
        self.host_ops = []  # (name, start_us, end_us)
        for e in prof.events():
            tr = e.time_range
            if e.device_type != DeviceType.CUDA:
                self.host_ops.append((e.name, tr.start, tr.end))
            elif getattr(e, "is_user_annotation", False):
                self.device_ranges.append((e.name, tr.start, tr.end))
            else:
                self.device_ops.append((e.name, tr.start, tr.end))
        self.device_ops.sort(key=lambda op: op[1])
        self.starts = [op[1] for op in self.device_ops]
        self.intervals = self._union()

    def _union(self) -> list:
        merged = []
        for _, a, b in self.device_ops:
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b])
        return merged

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.intervals) / 1e6

    def kernel_s(self, match) -> tuple:
        """``(seconds, launches)`` of the device operations whose name
        ``match`` accepts."""
        ops = [op for op in self.device_ops if match(op[0])]
        return sum(b - a for _, a, b in ops) / 1e6, len(ops)

    def range_device_s(self, name: str) -> tuple:
        """``(seconds, count)``: the device time of the operations inside the
        device-side spans of the host ranges named ``name`` (one stream: a
        range's span holds its own kernels alone)."""
        total, count = 0.0, 0
        for rname, a, b in self.device_ranges:
            if rname != name:
                continue
            count += 1
            for _, s, e in self.device_ops[max(0, bisect.bisect_left(self.starts, a) - 1):]:
                if s >= b:
                    break
                total += max(0.0, min(e, b) - max(s, a))
        return total / 1e6, count

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time, and the longest idle
        gaps, each named by the innermost host operation running at its
        middle."""
        by_name = {}
        for name, a, b in self.device_ops:
            by_name[name] = by_name.get(name, 0.0) + (b - a) / 1e6
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        gaps = sorted(((b0, a1) for (_, b0), (a1, _) in zip(self.intervals, self.intervals[1:])),
                      key=lambda g: g[0] - g[1])[:top]
        named = []
        for a, b in gaps:
            mid = (a + b) / 2
            covering = [op for op in self.host_ops if op[1] <= mid <= op[2]]
            host = max(covering, key=lambda op: op[1])[0] if covering else "no host operation"
            named.append([host, (b - a) / 1e6])
        return {"device_ops": [[n[:120], s] for n, s in ops], "idle_gaps": named}


# kernel-name fragment of each hand-written kernel family (csrc/*.cu)
KERNELS = {"attn_fwd": "attention_fwd", "attn_bwd": "attention_bwd"}


def roofline_pct(layer: dict, kernel: str):
    """100 x the bound time of the slice's calls of ``kernel`` over the
    device time of its launches; None where the slice has no launch."""
    if "trace" not in layer or f"{kernel}_bound_s" not in layer:
        return None
    seconds, launches = layer["trace"].kernel_s(lambda name: KERNELS[kernel] in name)
    return 100.0 * layer[f"{kernel}_bound_s"] / seconds if launches else None


def idle_share_pct(layer: dict):
    trace = layer.get("trace")
    return 100.0 * (1.0 - trace.busy_s / trace.window_s) if trace is not None else None


def mfu_pct(layer: dict):
    """100 x the counted FLOPs of the window's work per second over the bf16
    dense peak."""
    if "work_flops" not in layer:
        return None
    from h100_bench import counts

    return 100.0 * layer["work_flops"] / layer["window_s"] / counts.PEAK_BF16_FLOPS


@contextlib.contextmanager
def reference_numerics():
    """float32 as written, TF32 off, cuDNN free to time its algorithms
    (which changes no result's precision); the settings restored after."""
    import torch

    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
             torch.backends.cudnn.benchmark)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.benchmark = True
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
         torch.backends.cudnn.benchmark) = saved


class Stages:
    """Host seconds of the named stages of a run's set-up, logged on
    standard error."""

    def __init__(self, t_start: float):
        self.t = t_start
        self.stages = []

    def __call__(self, name: str) -> None:
        now = time.time()
        self.stages.append((name, now - self.t))
        self.t = now

    def log(self) -> None:
        log("set-up: " + ", ".join(f"{name} {s:.2f} s" for name, s in self.stages))


def read_json(path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: pathlib.Path, name: str):
    """Import the file ``path`` as a module named ``name``."""
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def read_layer_metric(name: str, layer: dict):
    """The value of per-layer metric ``name`` from its reader
    ``layer_metrics/<name>.py`` (``read(layer) -> float | None``)."""
    reader = load_module(BENCH_DIR / "layer_metrics" / f"{name}.py", f"h100_bench_metric_{name}")
    return reader.read(layer)
