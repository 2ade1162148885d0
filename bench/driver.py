"""The closed-loop traffic generator of the ``apsp`` and ``sssp`` mixes.

A query that runs open loop has a module of its own under
``bench/queries/`` (:mod:`bench.queries`), which ``bench/run.py`` hands
its cells to; this module draws its search keys (:func:`search_keys`,
:func:`key_pool`) and nothing else of it.

A closed-loop mix (``bench/traffic/<mix>.json``) names the query
(``apsp`` or ``sssp``), the sources per call, the pool of search keys the
calls cycle through and the rows of each call the check compares; a key
it does not know is refused.  The pool is drawn uniformly from the
vertices of degree 1 or more (Graph500's rule for search keys); the
run's seed orders it (:class:`Plan`) and draws the compared rows.  Such a
mix runs closed loop: each call is issued when the last one has returned,
so its issue time is its due time; its latency runs from issue to
completion (:func:`timer`).  The window takes every call started inside
``seconds`` and closes when the last one completes.  The compared rows
are copied to the host, so the card holds only what the system holds:
into one buffer made in set-up (:class:`Kept`), a uniform sample drawn
from the seed of every row the calls' draws name, so the window copies
into memory it already holds.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Callable, List, Optional

import numpy as np
import torch

QUERIES = ("apsp", "sssp")
MIX_KEYS = {"query", "sources_per_call", "key_pool", "check_rows_per_call",
            "why"}


KEPT_BYTES = 512 * 2**20      # the host buffer of compared rows
KEPT_ROWS = 1024              # and its most rows, however short a row


@dataclasses.dataclass
class Call:
    sources: np.ndarray          # (k,) int64
    wall_s: float
    counters: dict
    rows: np.ndarray             # indices of the rows drawn for the check
    traced: bool
    error: Optional[str] = None


@dataclasses.dataclass
class Window:
    calls: List[Call]
    elapsed_s: float


class Kept:
    """The rows the check compares, on the host: a uniform sample of every
    row the calls' draws name (Algorithm R, its draws from the run's
    seed), at most ``KEPT_ROWS`` rows of ``KEPT_BYTES`` in all, in one
    buffer made when this is made (pinned where the rows come from the
    card).  The window copies into it, never into memory it has to get:
    host memory the window would get for a row costs more than the copy
    and more in some runs than in others.  ``where[s]`` is slot ``s``'s
    (call index, row of the call)."""

    def __init__(self, n: int, seed: int, device: torch.device):
        self.cap = max(1, min(KEPT_ROWS, KEPT_BYTES // (4 * n)))
        self.rows = torch.empty((self.cap, n), dtype=torch.int32,
                                pin_memory=device.type == "cuda")
        self.where: List[tuple] = []
        self.seen = 0
        self.rng = np.random.default_rng([seed, 3])

    def keep(self, call: int, out: torch.Tensor, rows: np.ndarray) -> None:
        """Offer ``out[rows]`` (call ``call``'s drawn rows) to the
        sample."""
        for r in rows.tolist():
            i, self.seen = self.seen, self.seen + 1
            if i < self.cap:
                self.where.append(None)
                slot = i
            else:
                slot = int(self.rng.integers(0, i + 1))
                if slot >= self.cap:
                    continue
            self.rows[slot].copy_(out[r])
            self.where[slot] = (call, r)


def search_keys(degree: torch.Tensor) -> np.ndarray:
    """The vertices of degree 1 or more (Graph500's search keys), in
    order."""
    return torch.nonzero(degree >= 1).reshape(-1).cpu().numpy()


def key_pool(keys: np.ndarray, size: int, pool_seed: int) -> np.ndarray:
    """``size`` distinct search keys, drawn uniformly once per graph (from
    ``pool_seed``)."""
    return np.random.default_rng([pool_seed, 7]).choice(keys, size=size,
                                                        replace=False)


class Plan:
    """The calls of one run.  The mix's ``key_pool`` search keys are drawn
    once per graph (from ``pool_seed``); each run's ``seed`` deals them
    out in an order of its own, a fresh permutation of the whole pool each
    round, so every seed asks for the same work in another order."""

    def __init__(self, mix: dict, degree: torch.Tensor, seed: int,
                 pool_seed: int):
        unknown = set(mix) - MIX_KEYS
        if unknown:
            raise ValueError(f"unknown mix keys {sorted(unknown)}: "
                             f"{sorted(MIX_KEYS)}")
        if mix["query"] not in QUERIES:
            raise ValueError(f"unknown query {mix['query']!r}: {QUERIES}")
        self.query = mix["query"]
        self.k = 1 if self.query == "sssp" else mix["sources_per_call"]
        self.check = min(self.k, mix["check_rows_per_call"])
        self.n = degree.numel()
        keys = search_keys(degree)
        size = mix["key_pool"]
        if size % self.k or size > keys.size:
            raise ValueError(f"key_pool {size} must be a multiple of "
                             f"{self.k} and at most {keys.size}")
        self.pool = key_pool(keys, size, pool_seed)
        self.rng = np.random.default_rng([seed, 1])
        self.check_rng = np.random.default_rng([seed, 2])
        self._dealt = np.empty(0, np.int64)

    def sources(self) -> np.ndarray:
        if self._dealt.size == 0:
            self._dealt = self.rng.permutation(self.pool)
        out, self._dealt = self._dealt[: self.k], self._dealt[self.k:]
        return out

    def rows(self) -> np.ndarray:
        return np.sort(self.check_rng.choice(self.k, size=self.check,
                                             replace=False))


def issue(system, query: str, sources: np.ndarray):
    if query == "sssp":
        return system.sssp(int(sources[0]))
    return system.apsp(sources)


def timer(device: torch.device) -> Callable[[Callable], tuple]:
    """``timed(fn) -> (fn(), seconds)``: from issue to completion, by the
    host clock around the call and, on the card, a device synchronize
    after it."""
    if device.type == "cuda":
        def done():
            torch.cuda.synchronize(device)
    else:
        def done():
            pass

    def timed(fn):
        t0 = time.perf_counter()
        out = fn()
        done()
        return out, time.perf_counter() - t0
    return timed


def run(system, plan: Plan, seconds: float, device: torch.device,
        kept: Kept, capture=None, trace_seconds: float = 0.0) -> Window:
    """The measured window; each call's drawn rows are offered to
    ``kept``.  With ``capture`` (a started
    :class:`bench.devtrace.Capture`) the calls that start within its
    first ``trace_seconds`` are traced; the capture is stopped after the
    last of them and its summary set on ``capture.summary``.  Each call's
    tracing is settled before ``plan.sources()`` is asked for its
    sources, so a plan sees whether the call is traced by
    ``capture.active``."""
    timed = timer(device)
    calls: List[Call] = []
    t_start = time.perf_counter()
    t_end = t_start
    while True:
        t0 = time.perf_counter()
        if t0 - t_start >= seconds:
            break
        traced = capture is not None and capture.active and \
            t0 - t_start < trace_seconds
        if capture is not None and capture.active and not traced:
            capture.summary = capture.stop()
        srcs = plan.sources()
        error, out, counters = None, None, {}
        try:
            with capture.span() if traced else contextlib.nullcontext():
                (out, counters), wall = timed(
                    lambda: issue(system, plan.query, srcs))
        except Exception as exc:       # a failed call is counted, not fatal
            error = f"{type(exc).__name__}: {exc}"
            wall = time.perf_counter() - t0
        t_end = time.perf_counter()
        rows = plan.rows()
        if out is not None:
            if tuple(out.shape) == (len(srcs), plan.n):
                kept.keep(len(calls), out, rows)
            else:
                error = f"rows {tuple(out.shape)} for {len(srcs)} sources"
        calls.append(Call(srcs, wall, counters, rows, traced, error))
        del out
    if capture is not None and capture.active:
        capture.summary = capture.stop()
    return Window(calls, t_end - t_start)
