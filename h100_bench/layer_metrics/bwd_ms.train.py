"""Device milliseconds a step spends in its backwards (the program's
``c2w.train.backward`` spans, with the kernels autograd launches for them
from its own thread: ``spans.until_next_s``), over the traced slice's
steps."""
from h100_bench import spans


def read(layer: dict):
    if "trace" not in layer:
        return None
    return spans.per(layer, "slice_steps", *spans.until_next_s(layer["trace"], "c2w.train.backward"))
