"""Device milliseconds a step of the kernels launched inside torch.optim's
own Optimizer.step#AdamW.step range, over the traced slice's steps."""


def read(layer: dict):
    if "trace" not in layer:
        return None
    seconds, count = layer["trace"].range_device_s("Optimizer.step#AdamW.step")
    return seconds * 1e3 / layer["slice_steps"] if count else None
