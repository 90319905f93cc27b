"""Device milliseconds an evaluation spends in the guidance (the program's
``c2w.sample.guidance`` spans: A, the likelihood's error, the adjoint), over
the traced slice's evaluations."""
from h100_bench import spans


def read(layer: dict):
    if "trace" not in layer:
        return None
    return spans.per(layer, "slice_evals", *layer["trace"].range_device_s("c2w.sample.guidance"))
