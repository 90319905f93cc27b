"""Device milliseconds an evaluation's window pass spends outside the
network (the program's ``c2w.window.pass`` span less the forwards inside
it: the windows' gather, the casts, the fold into the trajectory), per
evaluation the traced slice holds whole (``spans.evaluations``)."""
from h100_bench import spans


def read(layer: dict):
    if "trace" not in layer:
        return None
    trace = layer["trace"]
    evals = spans.evaluations(trace)
    own = [sum(spans.own_device_s(trace, dev) for _, dev in held["c2w.window.pass"]) for _, held in evals]
    return sum(own) * 1e3 / len(own) if own else None
