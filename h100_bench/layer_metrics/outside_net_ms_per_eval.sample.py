"""Device milliseconds an evaluation spends outside the ScoreUNet forwards
(window gather and fold, guidance, the sampler update): the traced slice's
device time less that of the kernels launched inside the forwards (the
harness's ranges around them), over the slice's evaluations."""


def read(layer: dict):
    if "forward_range" not in layer:
        return None
    trace = layer["trace"]
    total, _ = trace.kernel_s(lambda name: True)
    inside, count = trace.range_device_s(layer["forward_range"])
    return (total - inside) * 1e3 / layer["slice_evals"] if count else None
