"""Device-idle milliseconds inside the program's train steps (each
``c2w.train.step`` span, on the device from the first kernel of its first
gather to its last kernel), over the traced slice's steps: idle that the
step causes; gaps between steps are the driver's."""
from h100_bench import spans


def read(layer: dict):
    if "trace" not in layer:
        return None
    trace = layer["trace"]
    steps = spans.steps(trace)
    idle = sum(spans.idle_s(trace, spans.hull([dev for pairs in held.values() for _, dev in pairs]))
               for _, held in steps)
    return spans.per(layer, "slice_steps", idle, len(steps))
