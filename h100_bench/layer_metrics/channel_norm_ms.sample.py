"""Device milliseconds a forward of the fused channel-norm kernels
(``csrc/channel_norm.cu``), by kernel name, over the traced slice's forwards
(the harness's ranges around them); None where the slice launched none of
them."""

NAME = "channel_norm_"  # fragment of both kernels' names (forward and backward)


def read(layer: dict):
    if "forward_range" not in layer:
        return None
    trace = layer["trace"]
    seconds, launches = trace.kernel_s(lambda name: NAME in name)
    _, forwards = trace.range_device_s(layer["forward_range"])
    return seconds * 1e3 / forwards if launches and forwards else None
