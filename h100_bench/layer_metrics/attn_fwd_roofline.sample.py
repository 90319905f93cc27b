"""The attention forward kernel's share of its roofline: the bound time of
the slice's attention calls (counts.py) over the device time of the
kernel's launches."""
from h100_bench import harness


def read(layer: dict):
    return harness.roofline_pct(layer, "attn_fwd")
