"""Device milliseconds a step of the fused channel-norm kernels
(``csrc/channel_norm.cu``), forward and backward together, by kernel name,
over the traced slice's steps; None where the slice launched none of
them."""

NAME = "channel_norm_"  # fragment of both kernels' names (forward and backward)


def read(layer: dict):
    if "trace" not in layer:
        return None
    seconds, launches = layer["trace"].kernel_s(lambda name: NAME in name)
    return seconds * 1e3 / layer["slice_steps"] if launches else None
