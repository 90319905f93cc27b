"""Device milliseconds a step spends gathering its windows from the
training file on the card (the program's ``c2w.train.gather`` spans, the
device-data path's loader), over the traced slice's steps."""
from h100_bench import spans


def read(layer: dict):
    if "trace" not in layer:
        return None
    return spans.per(layer, "slice_steps", *layer["trace"].range_device_s("c2w.train.gather"))
