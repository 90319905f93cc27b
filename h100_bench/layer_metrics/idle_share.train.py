"""Share of the traced slice in which no operation runs on the device."""
from h100_bench import harness


def read(layer: dict):
    return harness.idle_share_pct(layer)
