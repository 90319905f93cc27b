"""The attention backward kernels' share of their roofline: the bound time
of the slice's attention backwards (counts.py) over the device time of
the kernels' launches."""
from h100_bench import harness


def read(layer: dict):
    return harness.roofline_pct(layer, "attn_bwd")
