"""The open-loop ``serve`` query (:mod:`bench.queries.serve`) on the CPU:
its schedule, its loop's clock, and whole runs of ``kron18.serve`` with
the configuration cut to SCALE 11 and the mix's shape kept (its pool cut
to what SCALE 11 holds, its rate to what the CPU serves): the program
comes out correct, and the control and each fault of the served path
come out not correct: a sweep that leaves its state unchanged, half of a
flush's tile left out, a flush that hands each row to the next query, a
row cache that answers for another source, a flush that drops a
query."""
import hashlib
import time

import numpy as np
import pytest
import torch

from bench import driver, manifest, queries, run, systems
from bench.queries import serve
from bench.tests.test_cellbench_run import (fault_half_batch,
                                            fault_state_unchanged)

M = manifest.load()
CELL = "kron18.serve"
SCALE = 11
POOL = 256
RATE = 150.0
SECONDS = 1.5


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: the open loop keeps pace with its arrivals
    while other test processes share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def serve_cell():
    w = manifest.workload(M, CELL)
    cfg = dict(manifest.config(M, w["config"]), scale=SCALE)
    mix = dict(manifest.traffic(w["traffic"]), key_pool=POOL,
               rate_per_s=RATE)
    e2e, layer = manifest.cell_metrics(M, CELL)
    return cfg, mix, e2e, layer


def run_serve(*, system=None, seed=2**31 + 17, trace=False):
    cfg, mix, e2e, layer = serve_cell()
    result, checks = run.run_cell(cfg, mix, e2e, layer, seed=seed,
                                  seconds=SECONDS, trace=trace, device="cpu",
                                  t0=time.perf_counter(), system=system,
                                  log=lambda m: None)
    return result, {name: v for name, v, _, _ in checks}


def degree_of_the_cell():
    cfg, _, _, _ = serve_cell()
    src, dst, n = manifest.generator(cfg["generator"]).generate(
        cfg, cfg["graph_seed"], torch.device("cpu"))
    loop = src == dst
    return torch.bincount(torch.cat([src[~loop], dst[~loop]]), minlength=n)


def test_the_mix_is_found_by_its_query():
    assert queries.find("serve") is serve
    for closed in ("apsp", "sssp", "../serve", "serve.py", "nothing"):
        assert queries.find(closed) is None
    w = manifest.workload(M, CELL)
    serve.check_mix(manifest.traffic(w["traffic"]))
    assert manifest.traffic(w["traffic"])["query"] == "serve"


def test_the_same_seed_gives_the_same_due_times_sources_and_targets():
    _, mix, _, _ = serve_cell()
    degree = degree_of_the_cell()
    a, b, c = (serve.Schedule(mix, degree, 4.0, s, 0)
               for s in (2**40 + 1, 2**40 + 1, 2**40 + 2))
    for x in ("due", "sources", "targets"):
        assert np.array_equal(getattr(a, x), getattr(b, x))
        assert not np.array_equal(getattr(a, x)[:50], getattr(c, x)[:50])
    assert np.all(np.diff(a.due) > 0) and 0 <= a.due[0] and a.due[-1] < 4.0
    assert abs(a.due.size - RATE * 4.0) < 5 * np.sqrt(RATE * 4.0)
    keys = set(driver.search_keys(degree).tolist())
    pool = set(driver.key_pool(driver.search_keys(degree), POOL, 0).tolist())
    assert set(a.sources.tolist()) <= pool
    assert set(a.targets.tolist()) <= keys
    assert not set(a.warm.tolist()) & pool
    assert len(set(a.warm.tolist())) == mix["max_batch"]
    # the same hot keys on every seed, Zipf(1): the hottest about 1/H(256)
    top_a = np.bincount(a.sources).argmax()
    assert top_a == np.bincount(c.sources).argmax()
    share = np.mean(a.sources == top_a)
    assert 0.12 < share < 0.22


class Stalling:
    """A stub service: answers every query at its next tick, and its
    first tick after ``at`` seconds stalls ``stall`` seconds first."""

    def __init__(self, at=0.1, stall=0.05):
        self.at, self.stall = at, stall
        self.t0 = time.perf_counter()
        self.waiting, self.stalled = [], None

    def submit(self, qid, source, target):
        q = serve.Answer(qid, source, target,
                         t_submit=time.perf_counter())
        self.waiting.append(q)
        return q

    def tick(self):
        if self.stalled is None and time.perf_counter() - self.t0 >= self.at:
            t = time.perf_counter()
            time.sleep(self.stall)
            self.stalled = (t, time.perf_counter())
        now = time.perf_counter()
        for q in self.waiting:
            q.hops, q.served_by, q.t_done = 0, "stub", now
        self.waiting = []

    def flush(self):
        self.tick()

    def pending(self):
        return len(self.waiting)

    def counters(self):
        return {}


def test_a_stall_charges_the_queries_due_during_it_from_their_due_times():
    class Every2ms:
        due = np.arange(0.0, 0.3, 0.002)
        sources = np.zeros(due.size, np.int64)
        targets = np.zeros(due.size, np.int64)
    stub = Stalling()
    win = serve.open_loop(stub, Every2ms, 0.3, max_batch=32, max_wait=0.001)
    assert win.served_by == {"stub": Every2ms.due.size}
    assert (win.status == serve.DONE).all()
    start, end = stub.stalled
    lat = serve.latencies_ms(win)
    during = (win.due >= start) & (win.due < end)
    assert during.sum() >= 15
    # charged from the due time: at least the rest of the stall each
    assert np.all(lat[during] >= (end - win.due[during]) * 1e3 - 1e-6)
    assert lat[during].max() >= 40.0
    # and queries due long after the stall are not
    assert np.median(lat[win.due > end + 0.05]) < 10.0


def test_the_program_is_correct():
    result, checks = run_serve()
    assert result["correct"], result
    assert result["failed"] == 0 and result["attempted"] >= 150
    assert checks["wrong_entries"] == 0
    assert checks["queries_compared"] >= 100 and checks["rows_compared"] >= 1
    e2e, _ = manifest.cell_metrics(M, CELL)
    assert set(result["metrics"]) == {m["name"] for m in e2e} == \
        {"open_loop_p95_ms", "peak_mem_gib", "setup_s"}
    assert list(result)[-1] == "checks"


def test_the_traced_run_reads_the_service():
    result, _ = run_serve(trace=True)
    assert result["correct"]
    got = {k: v["value"] for k, v in result["metrics"].items()}
    assert {"cache_hit_pct.serve", "tile_fill_pct.serve",
            "sweep_span_us.serve"} <= set(got)
    assert 0 < got["cache_hit_pct.serve"] < 100
    assert 0 < got["tile_fill_pct.serve"] <= 100
    assert got["sweep_span_us.serve"] > 0
    # no device on the CPU: the idle share finds nothing to read
    assert "device_idle_pct.serve" not in got


def test_the_control_is_not_correct():
    result, checks = run_serve(system=systems.Control)
    assert not result["correct"]
    assert checks["wrong_entries"] > 0 and checks["failed_queries"] == 0


def fault_flush_shifts_rows(monkeypatch):
    """A flush that hands each row to the next query."""
    from repro_torch.serve import engine
    orig = engine.apsp_engine_blocks

    def shifted(*args, **kw):
        for block, dist, st in orig(*args, **kw):
            yield block, torch.roll(dist, 1, dims=0), st
    monkeypatch.setattr(engine, "apsp_engine_blocks", shifted)


def fault_cache_wrong_source(monkeypatch):
    """A row cache that answers for the wrong source: each row kept
    under the key of the source cached after it."""
    from repro_torch.serve.engine import GraphService
    orig = GraphService._cache_row

    def cache(self, kind, source, row):
        prev = getattr(self, "_fault_prev", row)
        self._fault_prev = row
        orig(self, kind, source, prev)
    monkeypatch.setattr(GraphService, "_cache_row", cache)


def fault_flush_drops_query(monkeypatch):
    """A flush that drops the last query of its batch."""
    from repro_torch.serve.engine import GraphService
    orig = GraphService._serve

    def serve_(self, batch):
        return orig(self, batch[:-1])
    monkeypatch.setattr(GraphService, "_serve", serve_)


@pytest.mark.parametrize("fault", [fault_state_unchanged, fault_half_batch,
                                   fault_flush_shifts_rows,
                                   fault_cache_wrong_source,
                                   fault_flush_drops_query],
                         ids=lambda f: f.__name__)
def test_a_fault_of_the_served_path_is_not_correct(fault, monkeypatch):
    fault(monkeypatch)
    result, checks = run_serve()
    assert not result["correct"]
    if fault is fault_flush_drops_query:
        assert checks["failed_queries"] > 0
    else:
        assert checks["wrong_entries"] > 0


@pytest.mark.parametrize("change", [{"sources_per_call": 8},
                                    {"loop": "open"}, {"arrival": "bursty"},
                                    {"targets": "zipf"}])
def test_a_mix_key_or_value_the_query_does_not_read_is_refused(change):
    _, mix, _, _ = serve_cell()
    with pytest.raises(ValueError):
        serve.Schedule(dict(mix, **change), degree_of_the_cell(), 1.0, 1, 0)
    missing = dict(mix)
    del missing["max_wait_ms"]
    with pytest.raises(ValueError, match="missing"):
        serve.check_mix(missing)


# sha256 of the first 12 calls' sources and checked rows that Plan dealt
# for seed 2**40 + 5 over a pool drawn from 8,192 vertices with every
# seventh of degree 0, before the serve query was added
PARENT_PLANS = {"msbfs1024": "f243a3cd26cd9ca56dbb26317c179002",
                "msbfs128": "36ea3ff007ba9f2d94d7a0d9fc0489b0",
                "sssp": "b544915e04d65dc0ad717e765f41f73a"}


@pytest.mark.parametrize("mix", sorted(PARENT_PLANS))
def test_plan_deals_what_it_dealt_before_the_open_loop(mix):
    degree = torch.ones(8192, dtype=torch.int64)
    degree[::7] = 0
    plan = driver.Plan(manifest.traffic(mix), degree, 2**40 + 5, pool_seed=0)
    h = hashlib.sha256()
    for _ in range(12):
        h.update(np.asarray(plan.sources(), np.int64).tobytes())
        h.update(np.asarray(plan.rows(), np.int64).tobytes())
    assert h.hexdigest()[:32] == PARENT_PLANS[mix]


def test_a_serve_run_loads_neither_jax_nor_the_jax_package():
    import subprocess
    import sys
    code = (
        "import sys\n"
        f"sys.path[:0] = [{str(run.ROOT)!r}, {str(run.ROOT / 'src')!r}]\n"
        "from bench import run\n"
        "from bench.tests.test_cellbench_run import run_tiny\n"
        f"r, _ = run_tiny({CELL!r}, trace=True)\n"
        "assert r['correct']\n"
        "print(run.foreign_modules(list(sys.modules)))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=str(run.ROOT))
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"
