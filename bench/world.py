"""A cell over several cards: one process (rank) per card on the port's
SPMD mesh path.  ``bench/run.py`` takes this path when the cell's
configuration names a ``mesh``; its command line stays the same.

The launching process (:func:`launch`) writes the cell to a temporary
directory and starts one process of this file per rank: a ``file://``
store in that directory, NCCL on the card (rank r on ``cuda:r``) or gloo
on the CPU, and a group timeout of ``GROUP_TIMEOUT_S``.  It polls the
ranks: one that exits non-zero, or the whole run passing its limit,
ends every rank, and the launcher exits non-zero with no result.  Once
every rank has exited 0 it prints rank 0's result line.  Rank 0's
standard error is the launcher's; another rank's is shown only when the
run fails.

Every rank makes the same calls (the executor's contract):

- rank 0 makes the graph from the configuration's ``graph_seed`` and
  broadcasts the tuples; the ranks compare a digest of what they hold;
- each rank resets its card's peak memory, builds the system
  (:class:`bench.systems.MeshProgram`: ``prepare(CSRGraph.from_edges(
  ...))``) and makes the warm call with ``mesh=``; a barrier opens the
  window;
- rank 0 owns the plan and the clock (:func:`bench.driver.run`).  Before
  each call it broadcasts the call's sources, or "stop" (:class:`Feed`):
  one small collective, outside the call's timer and inside the window.
  ``setup_s`` runs from the launcher's first line to the window.

With ``--trace 1`` every rank profiles the same calls: ``device.busy_s``
and ``device.window_s`` are the means over the ranks, while the per-layer
readers and the ``breakdown`` read rank 0's trace, whose idle time holds
its waits on the other ranks at each collective.

After the window the ranks gather their peaks (and traced seconds), free
their systems and leave the group.  Rank 0 alone builds the reference on
its card and checks the rows of the check's sample, as a one-card run does
(:func:`bench.run.finish`); every rank checks its own ``sys.modules``.

    python3 bench/world.py <directory of the cell> <rank> <launcher's pid>
"""
from __future__ import annotations

import contextlib
import datetime
import gc
import importlib
import json
import math
import os
import shutil
import signal
import subprocess
import sys
import tempfile
import threading
import time
import warnings
from pathlib import Path

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
GROUP_TIMEOUT_S = 60          # a collective waits this long for a rank
LIMIT_S = 1140                # the ranks' whole run, a first build included
POLL_S = 0.1
STOP, CALL, TRACED = 0, 1, 2  # what rank 0 says before each call
SYSTEM = "bench.systems:MeshProgram"


def monotonic() -> float:
    """The system-wide clock that the launcher and its ranks share."""
    return time.clock_gettime(time.CLOCK_MONOTONIC)


# --------------------------------------------------------------------------
# the launcher
# --------------------------------------------------------------------------

def _term(signum, frame):
    raise SystemExit(128 + signum)


def launch(cell: dict, *, limit_s: float = LIMIT_S, err=None,
           env=None) -> tuple:
    """Run ``cell`` as one process per rank of its configuration's mesh
    -> (exit code, rank 0's standard output, empty unless every rank
    exited 0).

    ``cell`` holds what a rank reads: ``config``, ``mix``, ``e2e`` and
    ``layer`` (the cell's metrics), ``seed``, ``seconds``, ``trace``,
    ``device`` (``"cuda"`` or ``"cpu"``), ``system`` (``module:class``,
    built as ``(src, dst, n, device, mesh)``) and ``t0`` (the run's first
    line on :func:`monotonic`'s clock).  ``err`` takes rank 0's standard
    error (default: this process's)."""
    ranks = math.prod(cell["config"]["mesh"]["shape"])
    tmp = Path(tempfile.mkdtemp(prefix="bench-world-"))
    procs, files = [], []
    main_thread = threading.current_thread() is threading.main_thread()
    old = signal.signal(signal.SIGTERM, _term) if main_thread else None
    try:
        (tmp / "cell.json").write_text(json.dumps(cell))
        out = open(tmp / "rank0.out", "w+")
        logs = [err] + [open(tmp / f"rank{r}.err", "w+")
                        for r in range(1, ranks)]
        files = [out] + logs[1:]
        for r in range(ranks):
            procs.append(subprocess.Popen(
                [sys.executable, str(BENCH / "world.py"), str(tmp), str(r),
                 str(os.getpid())],
                stdout=out if r == 0 else subprocess.DEVNULL,
                stderr=logs[r], env=env))
        rc, why = _wait(procs, time.monotonic() + limit_s)
        if rc:
            for r in range(1, ranks):
                logs[r].seek(0)
                tail = logs[r].read()[-3000:]
                if tail:
                    print(f"--- rank {r}, the end of its standard error:\n"
                          f"{tail}", file=sys.stderr)
            print(f"{why}: no result", file=sys.stderr, flush=True)
            return rc, ""
        out.seek(0)
        return 0, out.read()
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        for f in files:
            f.close()
        shutil.rmtree(tmp, ignore_errors=True)
        if main_thread:
            signal.signal(signal.SIGTERM, old)


def _wait(procs, deadline: float) -> tuple:
    """Wait for every rank -> (0, "") or, once a rank has exited non-zero
    (each such rank named) or at the deadline, (a non-zero code, why)."""
    while True:
        codes = [p.poll() for p in procs]
        failed = [(r, c) for r, c in enumerate(codes) if c]
        if failed:
            c = failed[0][1]
            return (c if c > 0 else 1), ", ".join(
                f"rank {r} exited {c}" for r, c in failed)
        if all(c == 0 for c in codes):
            return 0, ""
        if time.monotonic() > deadline:
            return 1, "the ranks ran past the run's limit"
        time.sleep(POLL_S)


# --------------------------------------------------------------------------
# a rank
# --------------------------------------------------------------------------

class Feed:
    """Rank 0's message to every rank before a call: ``STOP``, ``CALL`` or
    ``TRACED``, and the call's sources, in one broadcast.  Rank 0 waits
    for it to finish, so the call's timer does not hold it."""

    def __init__(self, mix: dict, device):
        self.k = 1 if mix["query"] == "sssp" else mix["sources_per_call"]
        self.device = device
        self.sent, self.sent_s = 0, 0.0

    def send(self, what: int, sources=None) -> None:
        import torch
        import torch.distributed as dist
        t = time.perf_counter()
        msg = torch.zeros(self.k + 1, dtype=torch.int64)
        msg[0] = what
        if sources is not None:
            msg[1:] = torch.as_tensor(sources, dtype=torch.int64)
        msg = msg.to(self.device)
        dist.broadcast(msg, 0)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.sent += 1
        self.sent_s += time.perf_counter() - t

    def recv(self) -> tuple:
        import torch
        import torch.distributed as dist
        msg = torch.empty(self.k + 1, dtype=torch.int64, device=self.device)
        dist.broadcast(msg, 0)
        msg = msg.cpu().numpy()
        return int(msg[0]), msg[1:]


class Leader:
    """Rank 0's plan in the window (:class:`bench.driver.Plan` for
    :func:`bench.driver.run`): each call's sources go to every rank first,
    marked traced while ``driver.run`` keeps the capture on for it (it
    settles that before it asks for the sources), so the others trace the
    calls rank 0 traces."""

    def __init__(self, plan, feed: Feed, capture):
        self.plan, self.feed, self.capture = plan, feed, capture
        self.query, self.n = plan.query, plan.n

    def sources(self):
        srcs = self.plan.sources()
        traced = self.capture is not None and self.capture.active
        self.feed.send(TRACED if traced else CALL, srcs)
        return srcs

    def rows(self):
        return self.plan.rows()


def follow(sut, feed: Feed, query: str, capture, sync) -> None:
    """Another rank's window: the calls rank 0 sends, until "stop"."""
    from bench import driver
    while True:
        what, srcs = feed.recv()
        if capture is not None and capture.active and what != TRACED:
            capture.summary = capture.stop()
        if what == STOP:
            return
        with capture.span() if what == TRACED else contextlib.nullcontext():
            driver.issue(sut, query, srcs)
            sync()


def _gather(out, x) -> None:
    """All-gather ``x`` into ``out``, rank by rank."""
    import torch.distributed as dist
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", FutureWarning)
        dist.all_gather_into_tensor(out, x)


def _tuples(cfg: dict, lead: bool, device):
    """The configuration's tuples on every rank: made on rank 0 and
    broadcast, then compared by a digest (int64, wrapping)."""
    import torch
    import torch.distributed as dist

    from bench import manifest
    if lead:
        src, dst, n = manifest.generator(cfg["generator"]).generate(
            cfg, cfg["graph_seed"], device)
        src = src.to(torch.int64).contiguous()
        dst = dst.to(torch.int64).contiguous()
        size = torch.tensor([src.numel(), n], device=device)
    else:
        size = torch.empty(2, dtype=torch.int64, device=device)
    dist.broadcast(size, 0)
    m, n = size.tolist()
    if not lead:
        src = torch.empty(m, dtype=torch.int64, device=device)
        dst = torch.empty(m, dtype=torch.int64, device=device)
    dist.broadcast(src, 0)
    dist.broadcast(dst, 0)
    odd = torch.arange(m, device=device) * 2 + 1
    digest = ((src * 1000003 + dst) * odd).sum().reshape(1)
    every = torch.empty(dist.get_world_size(), dtype=torch.int64,
                        device=device)
    _gather(every, digest)
    every = every.tolist()
    if len(set(every)) != 1:
        raise RuntimeError(f"the ranks hold different tuples: digests "
                           f"{every}")
    return src, dst, n, every[0]


def _system(spec: str):
    module, _, name = spec.partition(":")
    return getattr(importlib.import_module(module), name)


def run_rank(cell: dict, rank: int, store: Path, log):
    """One rank's run of ``cell``; on rank 0 -> (result dict, checks),
    elsewhere None."""
    import torch
    import torch.distributed as dist

    from bench import devtrace, driver, run
    from repro_torch.launch.mesh import make_mesh

    cfg, mix, trace = cell["config"], cell["mix"], bool(cell["trace"])
    world = math.prod(cfg["mesh"]["shape"])
    lead = rank == 0
    cuda = cell["device"] == "cuda"
    if cuda:
        torch.cuda.set_device(rank)
        dev = torch.device("cuda", rank)
    else:
        dev = torch.device("cpu")
    sync = (lambda: torch.cuda.synchronize(dev)) if cuda else (lambda: None)
    dist.init_process_group(
        "nccl" if cuda else "gloo", init_method=f"file://{store}",
        rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S),
        **({"device_id": dev} if cuda else {}))
    mesh = make_mesh(cfg["mesh"]["shape"], cfg["mesh"]["axes"],
                     device=dev.type)

    src, dst, n, digest = _tuples(cfg, lead, dev)
    if lead:
        log(f"tuples {src.numel()}: the same on {world} ranks (digest "
            f"{digest})")
        loop = src == dst
        degree = torch.bincount(torch.cat([src[~loop], dst[~loop]]),
                                minlength=n).cpu()
        del loop
    src, dst = src.cpu(), dst.cpu()
    if cuda:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    feed = Feed(mix, dev)           # the warm call's
    if lead:
        seed = cell["seed"] % (1 << 63)
        plan = driver.Plan(mix, degree, seed, cfg["graph_seed"])
        warm = driver.Plan(mix, degree, seed + 1,
                           cfg["graph_seed"]).sources()
        del degree
    sut = _system(cell["system"])(src, dst, n, dev, mesh)
    if lead:
        feed.send(CALL, warm)
    else:
        _, warm = feed.recv()
    driver.issue(sut, mix["query"], warm)
    sync()
    if lead:
        kept = driver.Kept(n, seed, dev)
    dist.barrier()
    capture = None
    if trace:
        capture = devtrace.Capture()
        capture.start()
    if lead:
        setup_s = monotonic() - cell["t0"]
        log(f"set-up {setup_s:.3f} s: n {n}, tuples {src.numel()}, "
            f"mesh {cfg['mesh']['shape']} {cfg['mesh']['axes']}")
        feed = Feed(mix, dev)       # the window's, timed apart
        leader = Leader(plan, feed, capture)
        win = driver.run(sut, leader, cell["seconds"], dev, kept,
                         capture=capture, trace_seconds=run.TRACE_SECONDS)
        feed.send(STOP)
    else:
        follow(sut, feed, mix["query"], capture, sync)
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    summary = capture.summary if capture is not None else None
    mine = torch.tensor([float(peak), summary.busy_s if summary else 0.0,
                         summary.window_s if summary else 0.0],
                        dtype=torch.float64, device=dev)
    every = torch.empty(world * 3, dtype=torch.float64, device=dev)
    _gather(every, mine)
    every = every.view(world, 3).cpu()
    sut.close()
    del sut, mesh
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    dist.destroy_process_group()
    if not lead:
        return None

    peaks = [int(p) for p in every[:, 0].tolist()]
    log(f"peak memory by rank: {peaks} B")
    log(f"sources broadcast: {feed.sent} messages (each call's and the "
        f"stop) in {feed.sent_s} s, {1e6 * feed.sent_s / max(feed.sent, 1)} "
        f"us each")
    busy = None
    if trace and summary is not None:
        busy = (float(every[:, 1].mean()), float(every[:, 2].mean()))
        log(f"traced busy s by rank: {every[:, 1].tolist()}, window s: "
            f"{every[:, 2].tolist()}")
    return run.finish(src, dst, n, win, kept, capture, cell["e2e"],
                      cell["layer"], setup_s=setup_s, peak=max(peaks),
                      trace=trace, dev=dev, log=log, chips=world, busy=busy)


def _orphaned_exit(parent: int) -> None:
    """End this rank when its launcher (``parent``) is gone, killed before
    it could end the ranks itself: a daemon thread watches the parent
    process, from before this rank's first import, so a launcher killed
    while the rank starts is seen too."""
    def watch():
        while os.getppid() == parent:
            time.sleep(1.0)
        os._exit(1)
    threading.Thread(target=watch, daemon=True).start()


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    tmp, rank = Path(argv[0]), int(argv[1])
    _orphaned_exit(int(argv[2]) if len(argv) > 2 else os.getppid())
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    from bench import run

    cell = json.loads((tmp / "cell.json").read_text())

    def log(msg):
        print(msg, file=sys.stderr, flush=True)
    out = run_rank(cell, rank, tmp / "store", log)
    if out is not None:
        return run.report(*out)
    return 3 if run.foreign_loaded() else 0


if __name__ == "__main__":
    sys.exit(main())
