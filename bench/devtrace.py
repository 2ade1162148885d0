"""The device trace of a traced run: ``torch.profiler`` over the calls of
a sub-window, reduced to what the per-layer readers and the result's
``breakdown`` take.

Each call is a span of the benchmark's own (``SPAN``).  The traced
window is the traced calls' spans, end to end.  Device time is the union
of the intervals of the kernels, copies and sets on the card inside
them; an idle gap is named by the host operation that covers most of it
on the thread that issued the calls.
"""
from __future__ import annotations

import bisect
import dataclasses
import json
import os
import tempfile
from typing import Dict, List, Optional, Tuple

SPAN = "bench.call"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver", "user_annotation")
NO_OP = "host code between traced ops"
NAME_CHARS = 160                 # a kernel's name is cut after this many


@dataclasses.dataclass
class Summary:
    busy_s: float
    window_s: float
    n_device_ops: int
    device_ops: List[Tuple[str, float]]     # the most device time, by name
    idle_gaps: List[Tuple[str, float]]      # idle seconds by host op


class Capture:
    """A profiler over CPU and CUDA activity, started before the window
    (its start-up cost lands in set-up) and stopped after the last traced
    call."""

    def __init__(self):
        import torch
        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self._prof = torch.profiler.profile(activities=acts)
        self._record = torch.profiler.record_function
        self.active = False
        self.summary: Optional[Summary] = None

    def start(self) -> None:
        self._prof.start()
        self.active = True

    def span(self):
        return self._record(SPAN)

    def stop(self) -> Optional[Summary]:
        """Stop, export the trace to a file of its own under the temporary
        directory, reduce it and delete the file."""
        self._prof.stop()
        self.active = False
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self._prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        finally:
            os.unlink(path)
        return reduce(events)


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def _host_segments(host: List[dict]) -> Tuple[List[float], List[float],
                                              List[str]]:
    """Cut the issuing thread's time into pieces, each named by the
    innermost host operation open over it (host events of one thread
    nest)."""
    bounds = []
    for e in host:
        bounds.append((e["ts"], 1, -e["dur"], e["name"]))
        bounds.append((e["ts"] + e["dur"], 0, 0.0, e["name"]))
    bounds.sort()
    starts, ends, names = [], [], []
    stack: List[str] = []
    prev = None
    for t, opening, _, name in bounds:
        if prev is not None and t > prev:
            starts.append(prev)
            ends.append(t)
            names.append(stack[-1] if stack else NO_OP)
        if opening:
            stack.append(name)
        else:                          # the innermost open one of the name
            for j in range(len(stack) - 1, -1, -1):
                if stack[j] == name:
                    del stack[j]
                    break
        prev = t
    return starts, ends, names


def _clip(merged: List[Tuple[float, float]], starts: List[float],
          a: float, b: float) -> List[Tuple[float, float]]:
    """The parts of the sorted, disjoint ``merged`` intervals inside
    ``[a, b]``."""
    out = []
    i = max(bisect.bisect_right(starts, a) - 1, 0)
    while i < len(merged) and merged[i][0] < b:
        lo, hi = max(merged[i][0], a), min(merged[i][1], b)
        if hi > lo:
            out.append((lo, hi))
        i += 1
    return out


def reduce(events: List[dict], top: int = 10) -> Optional[Summary]:
    """The summary of a chrome trace's events, or None when it holds no
    traced call.  The window is the traced calls' spans: the time between
    two calls, the harness's own, is left out."""
    # the host's spans: the profiler mirrors each on the device's
    # timeline as a "gpu_user_annotation", which is left out
    host_spans = [e for e in events if e.get("ph") == "X"
                  and e.get("name") == SPAN
                  and e.get("cat") == "user_annotation"]
    if not host_spans:
        return None
    spans = sorted((e["ts"], e["ts"] + e["dur"]) for e in host_spans)
    tid = host_spans[0]["tid"]

    span_starts = [a for a, _ in spans]

    def inside(e):            # overlaps a span (the spans are disjoint)
        i = bisect.bisect_left(span_starts, e["ts"] + e["dur"]) - 1
        return i >= 0 and e["ts"] < spans[i][1]

    dev = [e for e in events if e.get("ph") == "X"
           and e.get("cat") in DEVICE_CATS and inside(e)]
    by_name: Dict[str, float] = {}
    for e in dev:
        name = e["name"][:NAME_CHARS]
        by_name[name] = by_name.get(name, 0.0) + e["dur"]
    merged = _union([(e["ts"], e["ts"] + e["dur"]) for e in dev])
    mstarts = [a for a, _ in merged]

    busy_us, gaps = 0.0, []
    for a, b in spans:
        t = a
        for lo, hi in _clip(merged, mstarts, a, b):
            busy_us += hi - lo
            if lo > t:
                gaps.append((t, lo))
            t = hi
        if b > t:
            gaps.append((t, b))

    host = [e for e in events if e.get("ph") == "X"
            and e.get("cat") in HOST_CATS and e.get("tid") == tid
            and e.get("name") != SPAN and inside(e)]
    starts, ends, names = _host_segments(host)
    idle: Dict[str, float] = {}
    for a, b in gaps:
        cover: Dict[str, float] = {}
        i = max(bisect.bisect_right(starts, a) - 1, 0)
        while i < len(starts) and starts[i] < b:
            o = min(ends[i], b) - max(starts[i], a)
            if o > 0:
                cover[names[i]] = cover.get(names[i], 0.0) + o
            i += 1
        name = max(cover, key=cover.get) if cover else NO_OP
        idle[name] = idle.get(name, 0.0) + (b - a)

    def ranked(d: Dict[str, float]) -> List[Tuple[str, float]]:
        return [(k, v / 1e6) for k, v in
                sorted(d.items(), key=lambda kv: -kv[1])[:top]]

    return Summary(busy_s=busy_us / 1e6,
                   window_s=sum(b - a for a, b in spans) / 1e6,
                   n_device_ops=len(dev), device_ops=ranked(by_name),
                   idle_gaps=ranked(idle))
