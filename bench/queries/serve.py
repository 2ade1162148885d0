"""The ``serve`` query: hop queries between two vertices (LDBC SNB
Interactive Complex Read 13, the length of the shortest path between two
persons) answered by the port's serving tier, ``repro_torch.GraphService``,
offered open loop.

A ``serve`` mix (``bench/traffic/<mix>.json``) gives

- ``arrival`` ``"poisson"`` at ``rate_per_s``: the due times, a Poisson
  process drawn from the run's seed (:class:`Schedule`);
- the sources: ``key_pool`` search keys (vertices of degree 1 or more,
  drawn once per graph from its ``graph_seed`` as the closed-loop mixes
  draw theirs: :func:`bench.driver.key_pool`), ranked by a permutation
  drawn from the same seed; each query's source is drawn Zipf
  (exponent ``source_zipf_s``) over the ranks from the run's seed, so
  every seed asks for the same hot keys in an order of its own;
- ``targets`` ``"uniform"``: each query's target drawn uniformly over
  the vertices of degree 1 or more, from the run's seed;
- the service's options ``max_batch``, ``max_wait_ms`` and
  ``row_cache_size`` (its others keep their defaults);
- ``check_sources``: the most distinct sources the check samples;

and a ``why``.  A key it does not read is refused.

The loop (:func:`open_loop`) is single-threaded: it submits every query
whose due time has passed, calls ``tick()`` once, and waits until the
next due time or the oldest waiting query's ``max_wait`` ripeness (not
while a full batch waits), spinning on the clock rather than sleeping.
The service's clock is the harness's ``time.perf_counter``, so a query's
``t_done`` (after its flush's copy to the host, or at submit for a cache
hit) and its due time share a clock: its latency runs from its due time,
and a query due while a flush runs is charged that wait.  The window
takes every query due inside ``seconds``, then drains with ``flush()``,
waiting up to ``DRAIN_S`` for the last; a query that never completes, or
comes back expired, has failed.  With ``--trace 1`` each turn of the loop
(its submits and its tick, not its wait) in the window's first
``TRACE_SECONDS`` is a traced span, and the service's counters are read
at both ends of them.

The check (:func:`finish`), once the window has closed, the peak memory
has been read and the service is freed: a sample, drawn from the seed, of
at most ``check_sources`` distinct sources of the completed queries, and
every completed query from each: its ``hops`` against the reference's
breadth-first row of its source, at its target.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import gc
import sys
import time
from typing import Callable, Optional

import numpy as np
import torch

from bench import devtrace, driver, manifest, reference, systems

MIX_KEYS = {"query", "arrival", "rate_per_s", "key_pool", "source_zipf_s",
            "targets", "max_batch", "max_wait_ms", "row_cache_size",
            "check_sources", "why"}
ARRIVALS = ("poisson",)
TARGETS = ("uniform",)
DRAIN_S = 60.0          # the drain waits this long for the last query
LANDMARKS = 16          # the control's landmarks
UNANSWERED = -2         # a completed query that holds no hops


def check_mix(mix: dict) -> None:
    unknown = set(mix) - MIX_KEYS
    if unknown:
        raise ValueError(f"unknown mix keys {sorted(unknown)}: "
                         f"{sorted(MIX_KEYS)}")
    missing = MIX_KEYS - {"why"} - set(mix)
    if missing:
        raise ValueError(f"mix keys missing: {sorted(missing)}")
    if mix["arrival"] not in ARRIVALS or mix["targets"] not in TARGETS:
        raise ValueError(f"arrival {mix['arrival']!r} not in {ARRIVALS} or "
                         f"targets {mix['targets']!r} not in {TARGETS}")
    if not mix["rate_per_s"] > 0 or mix["max_batch"] < 1:
        raise ValueError("rate_per_s must be > 0 and max_batch >= 1")


class Schedule:
    """The queries of one run: ``due`` (seconds from the window's start,
    rising), ``sources`` and ``targets``, drawn from the run's seed; and
    ``warm``, the set-up's flush: ``max_batch`` search keys outside the
    pool, so the warm rows the row cache keeps are never asked for."""

    def __init__(self, mix: dict, degree: torch.Tensor, seconds: float,
                 seed: int, pool_seed: int):
        check_mix(mix)
        keys = driver.search_keys(degree)
        size = mix["key_pool"]
        if not 1 <= size <= keys.size:
            raise ValueError(f"key_pool {size} must be in [1, {keys.size}]")
        pool = driver.key_pool(keys, size, pool_seed)
        ranked = np.random.default_rng([pool_seed, 11]).permutation(pool)
        rate = float(mix["rate_per_s"])
        rng = np.random.default_rng([seed, 4])
        chunk = int(rate * seconds) + 64
        parts, t = [], 0.0
        while t < seconds:
            part = t + np.cumsum(rng.exponential(1.0 / rate, chunk))
            parts.append(part)
            t = float(part[-1])
        due = np.concatenate(parts)
        self.due = due[due < seconds]
        count = self.due.size
        weight = np.arange(1, size + 1, dtype=np.float64) ** \
            -float(mix["source_zipf_s"])
        cdf = np.cumsum(weight)
        cdf /= cdf[-1]
        rank = np.searchsorted(
            cdf, np.random.default_rng([seed, 5]).random(count),
            side="right")
        self.sources = ranked[np.minimum(rank, size - 1)].astype(np.int64)
        self.targets = keys[np.random.default_rng([seed, 6]).integers(
            0, keys.size, count)].astype(np.int64)
        spare = np.setdiff1d(keys, pool)
        self.warm = (spare if spare.size >= mix["max_batch"]
                     else keys)[: mix["max_batch"]].astype(np.int64)


@dataclasses.dataclass
class Answer:
    """The control's answer: the fields of the port's ``GraphQuery`` that
    the harness reads."""
    qid: int
    source: int
    target: int
    hops: Optional[int] = None
    served_by: Optional[str] = None
    expired: bool = False
    t_submit: float = 0.0
    t_done: float = 0.0


class Service:
    """The port's serving tier over the cell's graph, on ``device``:
    ``GraphService(CSRGraph.from_edges(...), max_batch=,
    row_cache_size=, max_wait=, n_landmarks=0, clock=time.perf_counter)``;
    its other options keep their defaults.  The loader gets both
    directions of every generated tuple, as
    :class:`bench.systems.Program`'s does."""

    def __init__(self, src: torch.Tensor, dst: torch.Tensor, n: int,
                 device: torch.device, mix: dict):
        import repro_torch
        s = torch.cat([src, dst]).cpu().numpy()
        d = torch.cat([dst, src]).cpu().numpy()
        graph = repro_torch.CSRGraph.from_edges(s, d, n, device=device)
        self._query = repro_torch.GraphQuery
        self.svc = repro_torch.GraphService(
            graph, max_batch=mix["max_batch"],
            row_cache_size=mix["row_cache_size"],
            max_wait=mix["max_wait_ms"] / 1e3, n_landmarks=0,
            clock=time.perf_counter, device=device)

    def submit(self, qid: int, source: int, target: int):
        q = self._query(qid=qid, source=source, target=target)
        self.svc.submit(q)
        return q

    def tick(self) -> None:
        self.svc.tick()

    def flush(self) -> None:
        self.svc.flush()

    def pending(self) -> int:
        return self.svc.pending()

    def counters(self) -> dict:
        return {"cache_hits": self.svc.cache_hits,
                "submitted": self.svc.n_submitted}

    def close(self) -> None:
        self.svc = None


class Control:
    """The reference in the service's place with one guarantee broken:
    each query is answered at once by the landmark bound, the least
    d(source, l) + d(l, target) over the ``LANDMARKS`` vertices of highest
    degree (the reference's rows from each; -1 where none reaches both),
    which is exact only where a landmark lies on a shortest path: an
    approximate answer where the guarantee asks for the exact one."""

    def __init__(self, src: torch.Tensor, dst: torch.Tensor, n: int,
                 device: torch.device, mix: dict):
        g = reference.Graph(src.to(device), dst.to(device), n)
        marks = torch.topk(g.degree, min(LANDMARKS, n)).indices
        rows = reference.bfs_rows(g, marks).to(torch.int64).cpu().numpy()
        far = 4 * n
        self.rows = np.ascontiguousarray(np.where(rows < 0, far, rows).T)
        self.far = far

    def submit(self, qid: int, source: int, target: int) -> Answer:
        now = time.perf_counter()
        d = int((self.rows[source] + self.rows[target]).min())
        return Answer(qid, source, target, hops=d if d < self.far else -1,
                      served_by="control", t_submit=now, t_done=now)

    def tick(self) -> None:
        pass

    def flush(self) -> None:
        pass

    def pending(self) -> int:
        return 0

    def counters(self) -> dict:
        return {}

    def close(self) -> None:
        self.rows = None


# what a cell's ``system`` (as bench/run.py and bench/control.py name it)
# drives under this query; any other is an adapter of its own, built as
# ``(src, dst, n, device, mix)``
ADAPTERS = {None: Service, systems.Program: Service,
            systems.Control: Control}


DONE, EXPIRED = 1, 2        # a query's status; 0: never completed


class Window:
    """A closed window, as numbers a due query (in due order): its
    ``source`` and ``target``, ``due``, ``submitted`` and ``done`` times
    on the loop's clock (``done`` NaN if it never completed), ``hops``
    (``UNANSWERED`` if none), ``status`` and who served it; the close and
    the drain's end; the service's counters over the traced turns."""

    def __init__(self, sched: Schedule, t0: float):
        n = sched.due.size
        self.source, self.target = sched.sources, sched.targets
        self.due = t0 + sched.due
        self.submitted = np.full(n, np.nan)
        self.done = np.full(n, np.nan)
        self.hops = np.full(n, UNANSWERED, np.int64)
        self.status = np.zeros(n, np.int8)
        self.served_by: dict = {}
        self.t0 = t0
        self.closed = self.drained = t0
        self.traced: Optional[dict] = None

    @property
    def elapsed_s(self) -> float:
        return self.closed - self.t0

    def record(self, i: int, q) -> None:
        """Query ``i``'s answer object, once completed."""
        self.submitted[i], self.done[i] = q.t_submit, q.t_done
        self.served_by[q.served_by] = self.served_by.get(q.served_by, 0) + 1
        if q.expired:
            self.status[i] = EXPIRED
            return
        self.status[i] = DONE
        if q.hops is not None:
            self.hops[i] = q.hops


def _delta(before: dict, after: dict) -> dict:
    return {k: after[k] - before[k] for k in after if k in before}


def open_loop(svc, sched: Schedule, seconds: float, *, max_batch: int,
              max_wait: float, capture=None, trace_seconds: float = 0.0,
              drain_s: float = DRAIN_S,
              clock: Callable[[], float] = time.perf_counter) -> Window:
    """The measured window (see the module's docstring).  Answers are
    taken into the :class:`Window`'s arrays from the oldest on, as soon
    as it has completed, and their objects let go, so the harness holds
    only the queries in flight, not one object a query (the collector's
    pauses would grow with them), and pays O(1) a query however long the
    queue.  With ``capture`` (a started :class:`bench.devtrace.Capture`)
    the turns of the loop that start within its first ``trace_seconds``
    are traced; the capture is stopped at the first turn after them and
    its summary set on ``capture.summary``."""
    t0 = clock()
    win = Window(sched, t0)
    due, n = win.due, win.due.size
    i = 0                           # the next query due
    flight = collections.deque()    # (index, answer) from the oldest open
    before = svc.counters() if capture is not None else None
    while True:
        now = clock()
        if capture is not None and capture.active and \
                now - t0 >= trace_seconds:
            win.traced = _delta(before, svc.counters())
            capture.summary = capture.stop()
        if i == n and now - t0 >= seconds:
            break
        with capture.span() if capture is not None and capture.active \
                else contextlib.nullcontext():
            while i < n and due[i] <= now:
                flight.append((i, svc.submit(i, int(sched.sources[i]),
                                             int(sched.targets[i]))))
                i += 1
            svc.tick()
        while flight and flight[0][1].served_by is not None:
            win.record(*flight.popleft())
        if svc.pending() >= max_batch:
            continue
        wake = due[i] if i < n else t0 + seconds
        if flight:
            wake = min(wake, flight[0][1].t_submit + max_wait)
        while clock() < wake:       # a spin: a sleep would wake on a cold
            pass                    # core, and its wake-up would be timed
    win.closed = clock()
    if capture is not None and capture.active:
        win.traced = _delta(before, svc.counters())
        capture.summary = capture.stop()
    while svc.pending() and clock() - win.closed < drain_s:
        svc.flush()
    for i, q in flight:
        if q.served_by is not None:
            win.record(i, q)
    win.drained = clock()
    return win


def run_cell(cfg: dict, mix: dict, e2e: list, layer: list, *, seed: int,
             seconds: float, trace: bool, device: str = "cuda",
             t0: float, system=None, log=None):
    """Run one ``serve`` cell; -> (result dict, checks), as
    :func:`bench.run.run_cell`."""
    result, checks, _ = measure(cfg, mix, e2e, layer, seed=seed,
                                seconds=seconds, trace=trace, device=device,
                                t0=t0, system=system, log=log)
    return result, checks


def measure(cfg: dict, mix: dict, e2e: list, layer: list, *, seed: int,
            seconds: float, trace: bool, device: str = "cuda", t0: float,
            system=None, log=None, drain_s: float = DRAIN_S):
    """:func:`run_cell`, with the closed :class:`Window` as well."""
    from bench import run

    log = log or (lambda msg: print(msg, file=sys.stderr, flush=True))
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    sync = (lambda: torch.cuda.synchronize(dev)) if cuda else (lambda: None)
    seed = seed % (1 << 63)
    check_mix(mix)

    src, dst, n = manifest.generator(cfg["generator"]).generate(
        cfg, cfg["graph_seed"], dev)
    loop = src == dst
    degree = torch.bincount(torch.cat([src[~loop], dst[~loop]]),
                            minlength=n).cpu()
    src, dst = src.cpu(), dst.cpu()
    del loop
    if cuda:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    sched = Schedule(mix, degree, seconds, seed, cfg["graph_seed"])
    del degree
    sut = ADAPTERS.get(system, system)(src, dst, n, dev, mix)
    for i, s in enumerate(sched.warm.tolist()):       # one full flush
        sut.submit(-1 - i, s, s)
    while sut.pending():
        sut.flush()
    sync()
    capture = None
    if trace:
        capture = devtrace.Capture()
        capture.start()
    # the set-up's objects leave the collector's scans, so a collection in
    # the window walks only what the window makes
    gc.collect()
    gc.freeze()
    try:
        setup_s = time.perf_counter() - t0
        log(f"set-up {setup_s:.3f} s: n {n}, tuples {src.numel()}, "
            f"{sched.due.size} queries due at {mix['rate_per_s']} q/s")
        win = open_loop(sut, sched, seconds, max_batch=mix["max_batch"],
                        max_wait=mix["max_wait_ms"] / 1e3, capture=capture,
                        trace_seconds=run.TRACE_SECONDS, drain_s=drain_s)
    finally:
        gc.unfreeze()
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    sut.close()
    del sut
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    result, checks = finish(src, dst, n, win, capture, e2e, layer,
                            check_sources=mix["check_sources"], seed=seed,
                            setup_s=setup_s, peak=peak, trace=trace,
                            dev=dev, log=log)
    return result, checks, win


def latencies_ms(win: Window) -> np.ndarray:
    """Each due query's latency from its due time: to its ``done``, or,
    for one that never completed, to the drain's end."""
    done = np.where(np.isnan(win.done), win.drained, win.done)
    return (done - win.due) * 1e3


def finish(src, dst, n, win: Window, capture, e2e: list, layer: list, *,
           check_sources: int, seed: int, setup_s: float, peak: int,
           trace: bool, dev, log):
    """The check and the result of a closed window, once the service is
    freed -> (result dict, checks)."""
    from bench import run

    cuda = dev.type == "cuda"
    t_check = time.perf_counter()
    g = reference.Graph(src.to(dev), dst.to(dev), n)
    del src, dst
    done = np.nonzero(win.status == DONE)[0]
    failed = int(win.due.size - done.size)
    sources = win.source[done]
    distinct = np.unique(sources)
    k = min(distinct.size, check_sources, driver.KEPT_ROWS)
    pick = np.sort(np.random.default_rng([seed, 8]).choice(
        distinct, size=k, replace=False))
    chosen = done[np.isin(sources, pick)]
    wrong = 0
    if k:
        ref = reference.bfs_rows(g, pick)
        row = torch.as_tensor(np.searchsorted(pick, win.source[chosen]),
                              device=ref.device)
        tgt = torch.as_tensor(win.target[chosen], device=ref.device)
        want = ref[row, tgt].cpu().numpy()
        wrong = int((win.hops[chosen] != want).sum())
        del ref
    log(f"check: {chosen.size} queries from {k} sources (of "
        f"{distinct.size}), {done.size} completed, against the reference "
        f"in {time.perf_counter() - t_check:.3f} s")

    kind = torch.cuda.get_device_name(dev) if cuda else "cpu"
    lat = latencies_ms(win)
    lag = (win.submitted - win.due)[~np.isnan(win.submitted)]
    if lag.size:
        late = int((win.done > win.closed + 1.0).sum())
        log(f"queries {len(win.due)} due, served by {win.served_by}; latency "
            f"median {float(np.median(lat))} ms, p95 "
            f"{float(np.percentile(lat, 95))} ms, p99 "
            f"{float(np.percentile(lat, 99))} ms, max {float(lat.max())} "
            f"ms; submit after due: median {1e3 * float(np.median(lag))} "
            f"ms, p99 {1e3 * float(np.percentile(lag, 99))} ms, max "
            f"{1e3 * float(lag.max())} ms; {late} completed later than 1 s "
            f"after the close; window {win.elapsed_s} s, drain "
            f"{win.drained - win.closed} s")
    metrics = {}
    if not trace:
        values = {"setup_s": setup_s, "peak_mem_gib": peak / 2**30,
                  "open_loop_p95_ms": float(np.percentile(lat, 95))
                  if len(lat) else None}
        metrics = run.measured(e2e, lambda m: values.get(m["name"]))
    summary = capture.summary if capture is not None else None
    device_info = {"platform": "gpu" if cuda else "cpu", "kind": kind,
                   "count": 1, "memory_peak_bytes": int(peak)}
    if trace:
        ctx = run.Context([], {}, summary, g, kind)
        ctx.service = win.traced
        metrics = run.measured(
            layer, lambda m: manifest.reader(m["name"]).read(ctx))
        if summary is not None:
            log(f"traced: service counters {win.traced}, device busy "
                f"{summary.busy_s} s of {summary.window_s} s")
            device_info["busy_s"], device_info["window_s"] = ctx.busy_s, \
                ctx.window_s
    checks = [("wrong_entries", wrong, "<=", 0),
              ("failed_queries", failed, "<=", 0),
              ("rows_compared", k, ">=", 1),
              ("queries_compared", int(chosen.size), ">=", 1)]
    result = run.result_line(checks, attempted=len(win.due),
                             failed=failed + wrong, metrics=metrics,
                             device=device_info,
                             summary=summary if trace else None)
    return result, checks
