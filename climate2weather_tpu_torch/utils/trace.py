"""Spans and counters at the port's layer boundaries, on the profiler's clock.

``span(name, **attrs)`` marks a stretch of the program: the sampler's
groups and evaluations, the window pass and its forwards, the guidance, the
update and the post-processing, and the train step's gather, forward,
backward and EMA (the names are the ``c2w.*`` strings at the call sites).
``count(name, n)`` adds to one registry of counters: kernel launches,
window evaluations and forwards, resume saves and their bytes.

A span costs one module-global check while nothing asks for it. Under a
running ``torch.profiler`` it enters ``torch.profiler.record_function``, so
its range lands in the profile: on the card as a host range and as the
device-side interval of the kernels launched inside it, innermost range
first, which is how the benchmark's traced runs read it. After
:func:`enable` it also appends a record ``(name, id, parent id, start_ns,
end_ns, attrs)`` stamped with ``time.time_ns()`` inside the range (so the
record lies within its profiler event; :func:`profile_us` maps it onto the
profile's clock), and on CUDA a pair of timing events whose elapsed time
:func:`records` reads, never the span itself, so a span causes no host sync.

Counters are always on: an int add per call. A module keeps its own
counters readable and resettable under its own names through a
:class:`CounterView` of the registry (``ops.attention.launch_counts``).
"""

from __future__ import annotations

import itertools
import time
from collections.abc import MutableMapping
from typing import NamedTuple, Optional

import torch
import torch.autograd.profiler as _autograd_profiler

_on = False
_records: list = []
_open: list = []  # ids of the recording spans entered and not yet left
_ids = itertools.count(1)
_counters: dict = {}


class Record(NamedTuple):
    name: str
    id: int
    parent: Optional[int]
    start_ns: int
    end_ns: int
    attrs: dict
    device_ms: Optional[float]  # elapsed time of the span's CUDA event pair


class _Off:
    """The span while nothing asks for one."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _Span:
    __slots__ = ("name", "attrs", "range", "id", "parent", "start_ns", "events")

    def __init__(self, name: str, attrs: dict):
        self.name, self.attrs = name, attrs
        self.id = None

    def __enter__(self):
        self.range = torch.profiler.record_function(self.name)
        self.range.__enter__()
        if _on:
            self.id = next(_ids)
            self.parent = _open[-1] if _open else None
            _open.append(self.id)
            self.events = None
            if torch.cuda.is_initialized():
                self.events = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
                self.events[0].record()
            self.start_ns = time.time_ns()
        return self

    def __exit__(self, *exc):
        if self.id is not None:
            end_ns = time.time_ns()
            if self.events is not None:
                self.events[1].record()
            _open.remove(self.id)
            _records.append((self.name, self.id, self.parent, self.start_ns, end_ns, self.attrs, self.events))
        self.range.__exit__(*exc)
        return False


def span(name: str, **attrs):
    """A context manager around one stretch of the program (module
    docstring): a no-op unless a profiler runs or :func:`enable` was called."""
    if not (_on or _autograd_profiler._is_profiler_enabled):
        return _OFF
    return _Span(name, attrs)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name``."""
    _counters[name] = _counters.get(name, 0) + n


def enable() -> None:
    """Record every span from now on (and mark it in any profile)."""
    global _on
    _on = True


def disable() -> None:
    """Stop recording spans; those recorded so far are kept."""
    global _on
    _on = False


def reset() -> None:
    """Drop the records and set every counter to zero."""
    _records.clear()
    for name in _counters:
        _counters[name] = 0


def records() -> list:
    """The spans recorded so far, in the order they ended, as
    :class:`Record`; ``device_ms`` waits for the span's end event on CUDA
    and is None elsewhere."""
    out = []
    for name, sid, parent, start, end, attrs, events in _records:
        device_ms = None
        if events is not None:
            events[1].synchronize()
            device_ms = events[0].elapsed_time(events[1])
        out.append(Record(name, sid, parent, start, end, attrs, device_ms))
    return out


def counters() -> dict:
    """A copy of every counter."""
    return dict(_counters)


def profile_us(prof, ns: int) -> float:
    """``time.time_ns()`` reading ``ns`` on the clock of ``prof``'s events
    (``FunctionEvent.time_range``: microseconds since the trace's start)."""
    return (ns - prof.profiler.kineto_results.trace_start_ns()) / 1e3


class CounterView(MutableMapping):
    """The counters ``names`` of the registry as a dict of their own: read,
    set and reset through it."""

    def __init__(self, *names: str):
        self._names = names
        for name in names:
            _counters.setdefault(name, 0)

    def __getitem__(self, name: str) -> int:
        if name not in self._names:
            raise KeyError(name)
        return _counters[name]

    def __setitem__(self, name: str, value: int) -> None:
        if name not in self._names:
            raise KeyError(name)
        _counters[name] = value

    def __delitem__(self, name: str) -> None:
        raise TypeError("counters are reset, not deleted")

    def __iter__(self):
        return iter(self._names)

    def __len__(self) -> int:
        return len(self._names)

    def __repr__(self) -> str:
        return repr(dict(self))
