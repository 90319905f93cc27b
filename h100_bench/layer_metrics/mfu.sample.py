"""Model FLOPs of the work completed in the window (counts.py), over the
window's seconds, over the bf16 dense peak of one H100 (989 TFLOP/s)."""
from h100_bench import harness


def read(layer: dict):
    return harness.mfu_pct(layer)
