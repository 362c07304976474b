"""Logging and tracing utilities.

Replaces the reference's verbosity-gated ``Infos.println``
(``/root/reference/src/etc/Infos.java``): verbosity -1 silences
everything, 0 prints progress, 1 prints debug detail.

Tracing: :func:`span` marks a step of the program by a fixed name and
:func:`count` adds to a named counter.  Spans cost one check of a
module global while tracing is off (the default); :func:`tracing` turns
them on, and each then enters ``torch.profiler.record_function`` (so a
profiled run shows it on the card's clock) and adds its duration to the
in-memory totals of its name: count, total seconds and self seconds
(the duration less the spans opened inside it on the same thread).
Counters are always on, save those that cost work of their own, which
are counted only under :func:`tracing_on`; the kernel launches count
as ``kernel.launch.<name>`` and the native key probe's sweeps as
``native.probe_rows``.  :func:`counter` reads one counter,
:func:`trace_totals` everything at once; :func:`trace_reset` zeroes it.
"""

from __future__ import annotations

import contextlib
import sys
import threading
import time

VERBOSITY = 0

_ON = False
#: the context every span returns while tracing is off
_OFF = contextlib.nullcontext()
_record_function = None
_LOCK = threading.Lock()
#: name -> [count, total seconds, self seconds]
_SPANS: dict = {}
_COUNTERS: dict = {}
_STACK = threading.local()


def set_verbosity(v: int) -> None:
    global VERBOSITY
    VERBOSITY = v


def log(msg: str, level: int = 0) -> None:
    if VERBOSITY >= level:
        print(msg, file=sys.stderr if level > 0 else sys.stdout)


def tracing(on: bool) -> None:
    """Turn spans on or off (counters are always on)."""
    global _ON, _record_function
    if on and _record_function is None:
        from torch.profiler import record_function
        _record_function = record_function
    _ON = bool(on)


def tracing_on() -> bool:
    """Whether spans are on: a count that costs work of its own is made
    only then."""
    return _ON


class _Span:
    __slots__ = ("name", "rf", "t0", "children")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.rf = _record_function(self.name)
        self.rf.__enter__()
        stack = getattr(_STACK, "s", None)
        if stack is None:
            stack = _STACK.s = []
        stack.append(self)
        self.children = 0.0
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter() - self.t0
        stack = _STACK.s
        stack.pop()
        if stack:
            stack[-1].children += dt
        with _LOCK:
            tot = _SPANS.get(self.name)
            if tot is None:
                tot = _SPANS[self.name] = [0, 0.0, 0.0]
            tot[0] += 1
            tot[1] += dt
            tot[2] += dt - self.children
        self.rf.__exit__(*exc)
        return False


def span(name: str):
    """A context manager that marks the step ``name`` (a fixed string)."""
    if not _ON:
        return _OFF
    return _Span(name)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name``."""
    with _LOCK:
        _COUNTERS[name] = _COUNTERS.get(name, 0) + n


def counter(name: str) -> int:
    """The counter ``name`` since the last :func:`trace_reset`."""
    with _LOCK:
        return _COUNTERS.get(name, 0)


def trace_totals() -> dict:
    """``{"spans": {name: {"count", "total_s", "self_s"}}, "counters":
    {name: n}}`` since the last :func:`trace_reset`."""
    with _LOCK:
        spans = {n: {"count": c, "total_s": t, "self_s": s}
                 for n, (c, t, s) in _SPANS.items()}
        return {"spans": spans, "counters": dict(_COUNTERS)}


def trace_reset() -> None:
    """Zero every span total and counter."""
    with _LOCK:
        _SPANS.clear()
        _COUNTERS.clear()
