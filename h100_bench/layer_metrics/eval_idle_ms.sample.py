"""Device-idle milliseconds inside an evaluation (the program's
``c2w.sample.eval`` span, on the device from the first kernel of its window
pass to the last of its update), averaged over the evaluations the traced
slice holds whole."""
from h100_bench import spans


def read(layer: dict):
    if "trace" not in layer:
        return None
    trace = layer["trace"]
    evals = spans.evaluations(trace)
    idle = [spans.idle_s(trace, spans.hull([dev for pairs in held.values() for _, dev in pairs]))
            for _, held in evals]
    return sum(idle) * 1e3 / len(idle) if idle else None
