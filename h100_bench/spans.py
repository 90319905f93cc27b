"""What the readers of the program's spans share: device time and idle time
inside intervals of a traced slice (:class:`harness.DeviceTrace`), and the
device-side intervals of the program's spans.

The program marks its layers with ``torch.profiler.record_function`` ranges
(``climate2weather_tpu_torch/utils/trace.py``), which a traced slice holds
twice: as host ranges, and as device-side intervals (``device_ranges``).
The profiler ties each kernel to the innermost range open where the host
launched it, and a range's device-side interval runs from the first to
the last kernel tied to it. So a range with ranges inside it has an
interval only where it launches kernels of its own, and a kernel launched
from another thread (autograd's backward) belongs to no range. The readers
therefore take a stretch of the program from its innermost spans: an outer
span's device-side interval is the hull of those of the spans inside it on
the host, each host span paired in order with the device-side interval of
its name. A range open when the profiler started is in neither list; of
one open when it stopped, the card keeps the device-side interval of the
kernels it had launched and drops the host range.
"""

from __future__ import annotations

import bisect


def device_ranges(trace, name: str) -> list:
    """The device-side intervals ``(start_us, end_us)`` of the ranges
    ``name``, in order."""
    return sorted((a, b) for n, a, b in trace.device_ranges if n == name)


def host_spans(trace, name: str) -> list:
    """The host intervals of the ranges ``name``, in order."""
    return sorted((a, b) for n, a, b in trace.host_ops if n == name)


def paired(trace, name: str):
    """``[(host interval, device interval)]`` of the ranges ``name`` that
    launched kernels, paired in order from the slice's start; the one open
    at the profiler's stop, which keeps only one of the two (the card keeps
    its device-side interval, the CPU its host range), is left unpaired.
    None where the counts differ by more than that one."""
    host, dev = host_spans(trace, name), device_ranges(trace, name)
    return list(zip(host, dev)) if abs(len(host) - len(dev)) <= 1 else None


def within(outer, interval) -> bool:
    """Whether ``interval`` lies within ``outer``."""
    return outer[0] <= interval[0] and interval[1] <= outer[1]


def hull(intervals):
    """The smallest interval that holds all of ``intervals``; None for none."""
    return (min(a for a, _ in intervals), max(b for _, b in intervals)) if intervals else None


def _union(intervals) -> list:
    merged = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


def device_s(trace, intervals) -> float:
    """Seconds of device operations inside the union of ``intervals``."""
    total = 0.0
    for a, b in _union(intervals):
        for _, s, e in trace.device_ops[max(0, bisect.bisect_left(trace.starts, a) - 1):]:
            if s >= b:
                break
            total += max(0.0, min(e, b) - max(s, a))
    return total / 1e6


def own_device_s(trace, interval) -> float:
    """Seconds of device operations inside ``interval`` less those inside
    the device-side intervals of other ranges that lie within it: the
    kernels of the range whose interval it is, not of the ranges it
    holds."""
    nested = [(a, b) for _, a, b in trace.device_ranges if within(interval, (a, b)) and (a, b) != tuple(interval)]
    return device_s(trace, [interval]) - device_s(trace, nested)


def idle_s(trace, interval) -> float:
    """Seconds of ``interval`` in which no operation runs on the device."""
    a, b = interval
    busy = sum(max(0.0, min(e, b) - max(s, a)) for s, e in trace.intervals if s < b and e > a)
    return (b - a - busy) / 1e6


def stretches(trace, outer: str, leaves, last: str) -> list:
    """For each host span ``outer`` that holds a span ``last`` (one the
    slice holds whole), ``(host interval, {leaf: [(host, device)]})``: the
    leaves ``leaves`` inside it on the host, with their device-side
    intervals. Empty where a leaf's ranges do not pair."""
    pairs = {name: paired(trace, name) for name in leaves}
    if any(p is None for p in pairs.values()):
        return []
    out = []
    for span in host_spans(trace, outer):
        held = {name: [p for p in pairs[name] if within(span, p[0])] for name in leaves}
        if held.get(last):
            out.append((span, held))
    return out


def evaluations(trace) -> list:
    """:func:`stretches` of the sampler's evaluations the slice holds whole:
    each ``c2w.sample.eval`` span with its window pass, guidance and update."""
    return stretches(trace, "c2w.sample.eval", ("c2w.window.pass", "c2w.sample.guidance", "c2w.sample.update"),
                     "c2w.sample.update")


def steps(trace) -> list:
    """:func:`stretches` of the train steps the slice holds whole: each
    ``c2w.train.step`` span with its gathers, forwards, backwards, EMA and
    the kernels it launches itself."""
    return stretches(trace, "c2w.train.step", ("c2w.train.gather", "c2w.train.forward", "c2w.train.backward",
                                               "c2w.train.ema", "c2w.train.step"), "c2w.train.ema")


def until_next_s(trace, name: str) -> tuple:
    """``(seconds, count)``: for each device-side interval of the ranges
    ``name``, the device time from its start to the start of the next
    range's interval of any name (or to its own end, if later): the range's
    own kernels and those launched for it from other threads."""
    starts = sorted(a for _, a, _ in trace.device_ranges)
    spans = []
    for a, b in device_ranges(trace, name):
        k = bisect.bisect_right(starts, a)
        spans.append((a, max(b, starts[k]) if k < len(starts) else b))
    return device_s(trace, spans), len(spans)


def per(layer: dict, key: str, seconds: float, count: int):
    """Milliseconds ``seconds`` per ``layer[key]``; None without a traced
    slice or where no range was found."""
    if "trace" not in layer or not count or not layer.get(key):
        return None
    return seconds * 1e3 / layer[key]
