"""Device milliseconds a step spends in the EMA of the parameters (the
program's ``c2w.train.ema`` span), over the traced slice's steps."""
from h100_bench import spans


def read(layer: dict):
    if "trace" not in layer:
        return None
    return spans.per(layer, "slice_steps", *layer["trace"].range_device_s("c2w.train.ema"))
