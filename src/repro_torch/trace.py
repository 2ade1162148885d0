"""Spans and counters of the port, on the profiler's clock.

The recorder is on exactly while ``torch.profiler`` records: run the
calls under ``torch.profiler.profile()`` (or between its ``start()`` and
``stop()``), then read the chrome trace, where every span is a
``record_function`` range beside the ops it issued, or :func:`snapshot`.
There is no other switch.

  * :func:`span` — a per-call or per-sweep range.  Off, it returns one
    shared no-op context (one flag read); on, it enters
    ``record_function(name)`` and adds its ``time.perf_counter`` seconds
    and one use to the window table.
  * :func:`device_span` — a range of work on the card (the mesh's
    collectives): on, its seconds are the card's, between two CUDA
    events on the current stream around it, so they hold the work it
    enqueued and what that work waited for; they are read when the
    table is.  Off the card it is a :func:`span`.
  * :func:`count` — adds to a window counter, only when on.
  * :func:`setup_span`, :func:`gauge` — once-per-graph set-up work
    (loading, preparing, building an operand) and the bytes it holds,
    always kept in the set-up table, since set-up usually runs before a
    profiler is started.  On, the span is also a ``record_function``.

Names start with ``dawn.``.  The tables are per process; :func:`reset`
clears both.
"""
from __future__ import annotations

import contextlib
import threading
import time
from typing import Dict

import torch
from torch.autograd import profiler as _profiler

_NULL = contextlib.nullcontext()
_lock = threading.Lock()
_window_spans: Dict[str, list] = {}     # name -> [seconds, uses]
_window_counts: Dict[str, int] = {}
_setup_spans: Dict[str, list] = {}
_gauges: Dict[str, float] = {}
_pending: list = []                     # (name, start, end) CUDA events


def enabled() -> bool:
    """True while ``torch.profiler`` records (its own module flag)."""
    return _profiler._is_profiler_enabled


class _Span:
    __slots__ = ("name", "table", "_range", "_t0")

    def __init__(self, name: str, table: Dict[str, list], traced: bool):
        self.name = name
        self.table = table
        self._range = torch.profiler.record_function(name) if traced \
            else None

    def __enter__(self):
        if self._range is not None:
            self._range.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter() - self._t0
        if self._range is not None:
            self._range.__exit__(*exc)
        with _lock:
            acc = self.table.setdefault(self.name, [0.0, 0])
            acc[0] += dt
            acc[1] += 1
        return False


def span(name: str):
    """A range of the window: free while the profiler is off."""
    if not _profiler._is_profiler_enabled:
        return _NULL
    return _Span(name, _window_spans, True)


class _DeviceSpan:
    __slots__ = ("name", "_range", "_stream", "_start", "_end")

    def __init__(self, name: str, device: torch.device):
        self.name = name
        self._range = torch.profiler.record_function(name)
        self._stream = torch.cuda.current_stream(device)
        self._start = torch.cuda.Event(enable_timing=True)
        self._end = torch.cuda.Event(enable_timing=True)

    def __enter__(self):
        self._range.__enter__()
        self._start.record(self._stream)
        return self

    def __exit__(self, *exc):
        self._end.record(self._stream)
        self._range.__exit__(*exc)
        with _lock:
            _pending.append((self.name, self._start, self._end))
        return False


def device_span(name: str, device: torch.device):
    """A range of the window timed on ``device``'s clock where it is a
    card (host seconds elsewhere): free while the profiler is off."""
    if not _profiler._is_profiler_enabled:
        return _NULL
    if device.type != "cuda":
        return _Span(name, _window_spans, True)
    return _DeviceSpan(name, device)


def _settle() -> None:
    """Add the finished device spans' seconds to the window table (waits
    for their end events).  Holds the lock."""
    for name, start, end in _pending:
        end.synchronize()
        acc = _window_spans.setdefault(name, [0.0, 0])
        acc[0] += start.elapsed_time(end) / 1e3
        acc[1] += 1
    _pending.clear()


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to a window counter while the profiler records."""
    if not _profiler._is_profiler_enabled:
        return
    with _lock:
        _window_counts[name] = _window_counts.get(name, 0) + int(n)


def setup_span(name: str):
    """A range of set-up work, always timed into the set-up table."""
    return _Span(name, _setup_spans, _profiler._is_profiler_enabled)


def gauge(name: str, value: float) -> None:
    """Set a set-up gauge to its newest value."""
    with _lock:
        _gauges[name] = value


def snapshot() -> dict:
    """Both tables as plain dicts: ``{"window": {"spans": {name: {"s",
    "n"}}, "counters": {name: n}}, "setup": {"spans": ..., "gauges":
    {name: value}}}``."""
    def spans(table):
        return {k: {"s": v[0], "n": v[1]} for k, v in table.items()}
    with _lock:
        _settle()
        return {"window": {"spans": spans(_window_spans),
                           "counters": dict(_window_counts)},
                "setup": {"spans": spans(_setup_spans),
                          "gauges": dict(_gauges)}}


def reset() -> None:
    """Clear the window and the set-up tables."""
    with _lock:
        for table in (_window_spans, _window_counts, _setup_spans, _gauges,
                      _pending):
            table.clear()
