"""max_memory_allocated() over the window, reset at its start, in GiB."""


def read(layer: dict):
    return layer["peak_bytes"] / 2**30 if layer.get("peak_bytes") else None
