"""90th percentile of the synchronised step times of the traced run's
window (host clock)."""
from h100_bench import harness


def read(layer: dict):
    return harness.quantile(layer["step_s"], 0.9) * 1e3 if layer.get("step_s") else None
