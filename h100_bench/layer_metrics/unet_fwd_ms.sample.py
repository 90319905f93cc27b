"""Mean device time of one ScoreUNet forward at the cell's window batch (CUDA
events in the network's forward pre- and post-hooks, every forward of the
traced run's window)."""


def read(layer: dict):
    fwd = layer.get("forward_ms")
    return sum(fwd) / len(fwd) if fwd else None
