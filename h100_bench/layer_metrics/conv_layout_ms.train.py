"""Device milliseconds a step of cuDNN's NCHW <-> NHWC layout kernels,
by kernel name, over the traced slice's steps."""

NAMES = ("nchwToNhwc", "nhwcToNchw")


def read(layer: dict):
    if "trace" not in layer:
        return None
    seconds, _ = layer["trace"].kernel_s(lambda name: any(n in name for n in NAMES))
    return seconds * 1e3 / layer["slice_steps"]
