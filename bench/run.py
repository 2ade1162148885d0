"""Run one cell of ``BENCHMARK.json`` on the card and print its result.

    python3 bench/run.py --workload kron18.msbfs --seed 7 --seconds 10 \
        --trace 0

Set-up (timed from this file's first line to the window's start):
imports, the configuration's graph (from its own ``graph_seed``) made on
the card and kept on the host, the search keys, the system under test
(``repro_torch``'s loader and ``prepare``) and one warm call of the
cell's own shape.  The card's peak memory counts from the system's
set-up, so it is the system's own.  Then the closed loop of
:mod:`bench.driver` for ``--seconds``; with ``--trace 1`` the profiler
records the calls of the window's first ``TRACE_SECONDS``.  Once the
window has closed and the peak memory has been read, the system is
freed, the benchmark's own view of the graph (:mod:`bench.reference`) is
built on the card, and the reference searches again every row of the
check's sample (:class:`bench.driver.Kept`, drawn from the seed over all
the rows the calls' draws name); a row that differs in any entry is
wrong.

A cell whose configuration names a ``mesh`` runs as one process per card
on the port's mesh path instead (:mod:`bench.world`); a cell on one card
takes the path above, and nothing of the mesh path runs in it.  A cell
whose mix names a query with a module of its own under ``bench/queries/``
(:mod:`bench.queries`: ``serve``, open loop) is run by that module, with
the same arguments, and nothing of the closed loop runs in it.

The last line of standard output is the result (JSON); the last lines
of standard error are the numbers compared, each beside its limit.  No
CUDA device, fewer devices than the cell asks for, or a module of JAX or
of the JAX package loaded in this process: a message on standard error,
no result, exit code 2 or 3.
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

FOREIGN = ("jax", "jaxlib", "flax", "repro")
TRACE_SECONDS = 10.0


def foreign_modules(names) -> list:
    """Top-level names among ``names`` (module names) that are JAX's or
    the JAX package's, compared whole: ``repro_torch`` is not ``repro``."""
    return sorted({m.partition(".")[0] for m in names} & set(FOREIGN))


def card_power() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
    except (OSError, subprocess.TimeoutExpired) as exc:
        return f"nvidia-smi failed: {exc}"
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() \
        else f"nvidia-smi: {out.stderr.strip()}"


class Context:
    """What a per-layer reader (``bench/metrics/<name>.py``) reads: the
    traced calls, the reference's levels of their sources, the trace
    summary (rank 0's on several cards), the graph the yardstick counts
    on, the card's name, the number of cards and the device's busy and
    traced seconds, the cards' means (``device.busy_s``, ``.window_s``)."""

    def __init__(self, calls, levels, summary, graph, kind, chips=1,
                 busy=None):
        self.calls = calls
        self.levels = levels          # {(call index, row): eccentricity}
        self.summary = summary
        self.graph = graph
        self.kind = kind
        self.chips = chips            # the cards the calls ran on
        if busy is None and summary is not None:
            busy = (summary.busy_s, summary.window_s)
        self.busy_s, self.window_s = busy or (0.0, 0.0)


def run_cell(cfg: dict, mix: dict, e2e: list, layer: list, *, seed: int,
             seconds: float, trace: bool, device: str = "cuda",
             t0: float = T0, system=None, log=None):
    """Run one cell (its configuration, mix and metrics); -> (result dict,
    checks).  ``system`` builds what the window drives from the tuples on
    the host, ``(src, dst, n, device) -> object`` (default: the program;
    the control and the tests give their own)."""
    import torch

    from bench import devtrace, driver, manifest, queries, systems

    log = log or (lambda msg: print(msg, file=sys.stderr, flush=True))
    kind = queries.find(mix["query"])
    if kind is not None:
        return kind.run_cell(cfg, mix, e2e, layer, seed=seed,
                             seconds=seconds, trace=trace, device=device,
                             t0=t0, system=system, log=log)
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    sync = (lambda: torch.cuda.synchronize(dev)) if cuda else (lambda: None)
    seed = seed % (1 << 63)

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
    plan = driver.Plan(mix, degree, seed, cfg["graph_seed"])
    warm = driver.Plan(mix, degree, seed + 1, cfg["graph_seed"]).sources()
    del degree
    system = system or systems.Program
    sut = system(src, dst, n, dev)
    driver.issue(sut, plan.query, warm)
    sync()
    kept = driver.Kept(n, seed, dev)
    capture = None
    if trace:
        capture = devtrace.Capture()
        capture.start()
    setup_s = time.perf_counter() - t0
    log(f"set-up {setup_s:.3f} s: n {n}, tuples {src.numel()}")

    win = driver.run(sut, plan, seconds, dev, kept, capture=capture,
                     trace_seconds=TRACE_SECONDS)
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    sut.close()
    del sut
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    return finish(src, dst, n, win, kept, capture, e2e, layer,
                  setup_s=setup_s, peak=peak, trace=trace, dev=dev, log=log)


class Levels:
    """``(call index, row of the call) -> the reference's eccentricity of
    that row's source`` (its farthest level): known for the compared
    rows, and worked out for a row of any other call on first asking."""

    def __init__(self, g, calls):
        self.g, self.calls, self.known = g, calls, {}

    def __contains__(self, key) -> bool:
        i, row = key
        return 0 <= i < len(self.calls) and \
            0 <= row < len(self.calls[i].sources)

    def __getitem__(self, key) -> int:
        from bench import reference
        if key not in self.known:
            if key not in self:
                raise KeyError(key)
            i = key[0]
            r = reference.bfs_rows(self.g, self.calls[i].sources)
            for row, lev in enumerate(r.amax(dim=1).tolist()):
                self.known[(i, row)] = lev
        return self.known[key]


def finish(src, dst, n, win, kept, capture, e2e: list, layer: list, *,
           setup_s: float, peak: int, trace: bool, dev, log, chips: int = 1,
           busy=None):
    """The check and the result of a closed window, once the system is
    freed: every row ``kept`` holds against the reference's search ->
    (result dict, checks).  ``peak`` is the fullest card's;
    ``busy``, where given, is ``(busy_s, window_s)`` over the cards (else
    the capture's)."""
    import numpy as np
    import torch

    from bench import manifest, reference, yardstick

    cuda = dev.type == "cuda"
    # the check: every kept row against the reference's search
    t_check = time.perf_counter()
    g = reference.Graph(src.to(dev), dst.to(dev), n)
    del src, dst
    log(f"reference graph in {time.perf_counter() - t_check:.3f} s: "
        f"lanes {g.n_lanes}, edges {g.n_lanes // 2}")
    wrong, levels = {}, Levels(g, win.calls)
    compared = len(kept.where)
    if compared:
        ref = reference.bfs_rows(g, np.array(
            [win.calls[i].sources[r] for i, r in kept.where], np.int64))
        diff = (kept.rows[:compared].to(ref.device) != ref).sum(dim=1)
        for (i, r), d, lev in zip(kept.where, diff.tolist(),
                                  ref.amax(dim=1).tolist()):
            wrong[i] = wrong.get(i, 0) + d
            levels.known[(i, r)] = lev
        del ref, diff
    wrong_entries = sum(wrong.values())
    log(f"check: {compared} rows, a sample of the {kept.seen} drawn, "
        f"against the reference in {time.perf_counter() - t_check:.3f} s")
    failed = sum(1 for i, c in enumerate(win.calls)
                 if c.error is not None or wrong.get(i, 0))
    errors = [c.error for c in win.calls if c.error is not None]
    for e in errors[:3]:
        log(f"failed call: {e}")

    kind = torch.cuda.get_device_name(dev) if cuda else "cpu"
    done = [c for c in win.calls if c.error is None]
    wall_ms = np.array([c.wall_s * 1e3 for c in win.calls])
    if len(wall_ms):
        log(f"calls {len(wall_ms)}, latency median "
            f"{float(np.median(wall_ms))} ms, p95 "
            f"{float(np.percentile(wall_ms, 95))} ms, window "
            f"{win.elapsed_s} s")
    metrics = {}
    if not trace:
        values = {
            "setup_s": setup_s,
            "peak_mem_gib": peak / 2**30,
            "gteps": sum(yardstick.traversed_edges(g, c.sources)
                         for c in done) / win.elapsed_s / 1e9
            if win.elapsed_s > 0 else None,
            "latency_p95_ms": float(np.percentile(wall_ms, 95))
            if len(wall_ms) else None,
        }
        metrics = measured(e2e, lambda m: values.get(m["name"]))
    summary = capture.summary if capture is not None else None
    if trace:
        traced = [(i, c) for i, c in enumerate(win.calls) if c.traced]
        ctx = Context(traced, levels, summary, g, kind, chips, busy)
        metrics = measured(layer,
                           lambda m: manifest.reader(m["name"]).read(ctx))
        if cuda and summary is not None and traced:
            least = sum(yardstick.least_seconds(
                yardstick.call_bytes(g, c.sources), kind) for _, c in traced)
            log(f"traced {len(traced)} calls: least time {least} s, "
                f"device busy {summary.busy_s} s of {summary.window_s} s")

    device_info = {"platform": "gpu" if cuda else "cpu", "kind": kind,
                   "count": chips, "memory_peak_bytes": int(peak)}
    if trace and summary is not None:
        device_info["busy_s"], device_info["window_s"] = ctx.busy_s, \
            ctx.window_s
    checks = [("wrong_entries", wrong_entries, "<=", 0),
              ("failed_calls", failed, "<=", 0),
              ("rows_compared", compared, ">=", 1)]
    return result_line(checks, attempted=len(win.calls), failed=failed,
                       metrics=metrics, device=device_info,
                       summary=summary if trace else None), checks


def measured(metrics: list, read) -> dict:
    """The metrics (``BENCHMARK.json`` entries) that ``read(entry)`` gives
    a number for, as the result line holds them."""
    out = {}
    for m in metrics:
        v = read(m)
        if v is not None:
            out[m["name"]] = {"value": v, "unit": m["unit"]}
    return out


def result_line(checks: list, *, attempted: int, failed: int, metrics: dict,
                device: dict, summary=None) -> dict:
    """The result: ``correct`` when every check ``(name, value, op,
    limit)`` holds, the trace's ``breakdown`` where a ``summary`` was
    read, and the checks under the key that comes last."""
    result = {"correct": all(v <= lim if op == "<=" else v >= lim
                             for _, v, op, lim in checks),
              "attempted": attempted, "failed": failed, "metrics": metrics,
              "device": device}
    if summary is not None:
        result["breakdown"] = {
            "device_ops": [list(x) for x in summary.device_ops],
            "idle_gaps": [list(x) for x in summary.idle_gaps]}
    result["checks"] = {name: {"value": v, "limit": f"{op} {lim}"}
                        for name, v, op, lim in checks}
    return result


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    from bench import manifest
    m = manifest.load()
    cell = manifest.workload(m, args.workload)
    cfg = manifest.config(m, cell["config"])
    mesh = manifest.layout(cell, cfg)

    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell["chips"]:
        print(f"{args.workload} needs {cell['chips']} CUDA device(s); "
              f"found {torch.cuda.device_count()}: no result",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    e2e, layer = manifest.cell_metrics(m, args.workload)
    mix = manifest.traffic(cell["traffic"])
    if mesh is not None:
        return ranked(cfg, mix, e2e, layer, args)
    result, checks = run_cell(
        cfg, mix, e2e, layer,
        seed=args.seed, seconds=args.seconds, trace=bool(args.trace))
    return report(result, checks)


def ranked(cfg: dict, mix: dict, e2e: list, layer: list, args) -> int:
    """A cell whose configuration names a mesh: one process per card
    (:mod:`bench.world`); this process prints rank 0's result once every
    rank has exited 0."""
    from bench import world
    t0 = world.monotonic() - (time.perf_counter() - T0)
    rc, out = world.launch({
        "config": cfg, "mix": mix, "e2e": e2e, "layer": layer,
        "seed": args.seed, "seconds": args.seconds,
        "trace": bool(args.trace), "device": "cuda",
        "system": world.SYSTEM, "t0": t0})
    if rc:
        return rc
    if foreign_loaded():
        return 3
    sys.stdout.write(out)
    sys.stdout.flush()
    return 0


def foreign_loaded() -> bool:
    """Whether a module of JAX or of the JAX package is loaded in this
    process; if so, say which on standard error."""
    found = foreign_modules(list(sys.modules))
    if found:
        print(f"loaded in this process: {', '.join(found)}: no result",
              file=sys.stderr, flush=True)
    return bool(found)


def report(result: dict, checks: list) -> int:
    """Print the card, the numbers compared and the result line; or, with
    a module of JAX or of the JAX package loaded here, exit code 3 and
    no result."""
    print(f"card: {card_power()}", file=sys.stderr)
    if foreign_loaded():
        return 3
    for name, v, op, lim in checks:
        print(f"check {name} {v} {op} {lim}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
