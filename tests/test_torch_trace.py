"""The port's recorder (``repro_torch.trace``): off while the profiler is
off (nothing kept, ``record_function`` never entered), on under
``torch.profiler`` (the ``dawn.*`` ranges in the profiler's events, the
counters equal to the results' own), and the set-up table kept always."""
import time

import numpy as np
import pytest
import torch
from torch.autograd import profiler as autograd_profiler

import repro_torch as dawn
from repro_torch import trace
from repro_torch.core import sweep as S
from repro_torch.graph import generators as gen
from repro_torch.graph.csr import CSRGraph

SWEEP_SPANS = {"dawn.apsp", "dawn.engine.tile", "dawn.sweep",
               "dawn.sweep.choose", "dawn.sweep.form",
               "dawn.sweep.converged"}


@pytest.fixture(autouse=True)
def fresh_tables():
    trace.reset()
    yield
    trace.reset()


def _graph(n=256):
    return gen.watts_strogatz(n, 6, 0.05, seed=3, device="cpu")


def _profiled(fn):
    """``fn()`` under a CPU profiler -> (its result, the event names)."""
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, {e.name for e in prof.events()}


def _refuse(*args, **kw):
    raise AssertionError("record_function entered with the profiler off")


def test_the_gate_follows_the_profiler_start_and_stop():
    """The flag the recorder reads is torch's own: a torch whose profiler
    stops setting it fails here."""
    assert autograd_profiler._is_profiler_enabled is False
    assert not trace.enabled()
    prof = torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU])
    prof.start()
    try:
        assert autograd_profiler._is_profiler_enabled is True
        assert trace.enabled()
        assert trace.span("dawn.x") is not trace.span("dawn.x")
    finally:
        prof.stop()
    assert autograd_profiler._is_profiler_enabled is False
    assert not trace.enabled()


def test_off_the_span_is_one_shared_no_op():
    assert trace.span("dawn.a") is trace.span("dawn.b")
    with trace.span("dawn.a"):
        trace.count("dawn.n", 3)
    assert trace.snapshot()["window"] == {"spans": {}, "counters": {}}


def test_off_nothing_is_recorded_and_record_function_never_entered(
        monkeypatch):
    monkeypatch.setattr(torch.profiler, "record_function", _refuse)
    monkeypatch.setattr(autograd_profiler, "record_function", _refuse)
    g = _graph()
    h = dawn.prepare(g, device="cpu", dynamic=True, source_batch=32)
    r = h.apsp(range(40))
    h.sssp(5)
    assert int(r.direction_counts.sum()) > 0
    assert trace.snapshot()["window"] == {"spans": {}, "counters": {}}


def test_a_device_span_off_the_card_is_a_span():
    """Off, the shared no-op; on, with a CPU tensor's device, a host-timed
    range in the window table and the profiler's events (on a card its
    seconds are the card's: ``tests/test_torch_cuda.py``)."""
    cpu = torch.device("cpu")
    assert trace.device_span("dawn.mesh.gather", cpu) is trace.span("dawn.a")

    def ranges():
        for _ in range(2):
            with trace.device_span("dawn.mesh.gather", cpu):
                time.sleep(0.005)
    _, names = _profiled(ranges)
    assert "dawn.mesh.gather" in names
    got = trace.snapshot()["window"]["spans"]["dawn.mesh.gather"]
    assert got["n"] == 2 and got["s"] >= 0.01


def test_on_the_spans_land_in_the_profiler_events():
    h = dawn.prepare(_graph(), device="cpu", dynamic=True, source_batch=32)
    h.apsp([0])                                  # set-up out of the window
    trace.reset()
    r, names = _profiled(lambda: h.apsp(range(40)))
    assert SWEEP_SPANS <= names
    w = trace.snapshot()["window"]
    swept = int(r.direction_counts.sum())
    assert w["counters"]["dawn.sweeps"] == swept
    assert w["spans"]["dawn.sweep"]["n"] == swept
    assert w["spans"]["dawn.sweep.choose"]["n"] == swept
    assert w["spans"]["dawn.engine.tile"]["n"] == 2
    assert w["spans"]["dawn.apsp"]["n"] == 1
    assert w["spans"]["dawn.apsp"]["s"] >= w["spans"]["dawn.sweep"]["s"] > 0


@pytest.mark.parametrize("batch", [8, 32, 128])
def test_tile_fill_of_one_source_is_one_over_the_batch(batch):
    h = dawn.prepare(_graph(), device="cpu", mode="sparse",
                     source_batch=batch)
    row, _ = _profiled(lambda: h.sssp(7))
    c = trace.snapshot()["window"]["counters"]
    assert c["dawn.tile_rows_real"] * batch == c["dawn.tile_rows"] > 0
    assert c["dawn.tile_rows_real"] == c["dawn.sweeps"] == \
        int(row.max()) + 1


@pytest.mark.parametrize("semiring", ["boolean", "counting", "tropical"])
def test_every_engine_counts_its_sweeps(semiring):
    g = _graph()
    w = np.random.default_rng(0).uniform(0.5, 4.0, g.m_pad) \
        .astype(np.float32)
    h = dawn.prepare(g, weights=w, device="cpu", mode="sparse",
                     source_batch=16)
    r, names = _profiled(lambda: h.apsp(range(20), semiring=semiring))
    assert {"dawn.apsp", "dawn.sweep", "dawn.sweep.form"} <= names
    assert trace.snapshot()["window"]["counters"]["dawn.sweeps"] == \
        int(r.direction_counts.sum())


def test_fused_blocks_count_the_sweeps_they_ran():
    """A fused block of up to 3 sweeps on a search whose 6th sweep finds
    nothing: two blocks, 6 sweeps counted, as ``dir_counts`` has them."""
    last = 5

    def fused(f, d, step, n_run):
        prod = max(0, min(n_run, last - step))
        stopped = step + n_run > last
        return f, d, torch.tensor(prod), torch.tensor(stopped)

    f0 = torch.zeros((2, 128), dtype=torch.int8)
    st0 = S.make_state(f0, torch.zeros((2, 128), dtype=torch.int32))
    st, _ = _profiled(lambda: S.sweep_loop(
        (), st0, max_steps=50, fused=fused, fused_steps=3))
    w = trace.snapshot()["window"]
    assert st.step == sum(st.dir_counts) == last + 1
    assert w["counters"]["dawn.sweeps"] == last + 1
    assert w["spans"]["dawn.sweep"]["n"] == 2
    assert w["spans"]["dawn.sweep.fused"]["n"] == 2
    assert "dawn.sweep.choose" not in w["spans"]


@pytest.mark.parametrize("indexed", [True, False])
def test_a_settled_tile_chooses_once_and_counts_its_sweeps(indexed):
    """Two tiles on the kernel path: given the packed operand's live-word
    index (as on the card; the plain versions read it here) each settles
    its form once, in one ``dawn.sweep.choose``; given none each chooses
    at every sweep.  ``dawn.sweeps`` counts every sweep either way."""
    from repro_torch.core import engine as E
    g = _graph()
    pg = E.prepare_graph(g, device="cpu")
    s = 32
    cfg = E.EngineConfig(use_kernel=True)

    def tiles():
        out = []
        for lo in (0, s):
            rows = torch.arange(lo, lo + s, dtype=torch.int64)
            out.append(E._run_batch(
                None, pg.adj_pull, g.src, g.dst, pg.deg, rows, s, cfg=cfg,
                n_real=g.n_nodes, n_pad=pg.n_pad, max_steps=g.n_nodes,
                use_kernel=True, forced_dir=None,
                index=pg.adj_pull_index if indexed else None))
        return out

    out, names = _profiled(tiles)
    assert "dawn.sweep.choose" in names
    w = trace.snapshot()["window"]
    swept = sum(st.step for st in out)
    assert swept > 2
    assert w["counters"]["dawn.sweeps"] == swept
    assert "dawn.sweep.choice_pinned" not in w["counters"]
    assert w["spans"]["dawn.sweep.choose"]["n"] == (2 if indexed else swept)


def _held_bytes(pg):
    tensors = [getattr(pg.graph, k) for k in CSRGraph.ARRAYS]
    tensors += [pg.deg, pg.adj, pg.adj_pull]
    for ix in (pg.adj_index, pg.adj_pull_index):
        tensors += [ix.offsets, ix.words]
        if ix.values is not None:
            tensors.append(ix.values)
    return sum(t.numel() * t.element_size() for t in tensors)


def test_setup_spans_and_the_gauge_are_kept_with_the_profiler_off(
        monkeypatch):
    monkeypatch.setattr(torch.profiler, "record_function", _refuse)
    monkeypatch.setattr(torch.cuda, "reset_peak_memory_stats", _refuse)
    src, dst = np.array([0, 1, 2, 3, 3]), np.array([1, 2, 3, 0, 1])
    g = CSRGraph.from_edges(src, dst, 200, device="cpu")
    pg = dawn.prepare(g, device="cpu").prepared()
    gauges = trace.snapshot()["setup"]["gauges"]
    csr = sum(getattr(g, k).numel() * 4 for k in CSRGraph.ARRAYS)
    assert gauges["dawn.operand_bytes"] == csr + pg.n_pad * 4
    held = _held_bytes(pg)            # builds every lazy operand
    setup = trace.snapshot()["setup"]
    assert set(setup["spans"]) == {
        "dawn.from_edges", "dawn.prepare", "dawn.operand.dense",
        "dawn.operand.dense_index", "dawn.operand.pull_packed",
        "dawn.operand.pull_index"}
    assert all(v["n"] == 1 and v["s"] >= 0 for v in setup["spans"].values())
    assert setup["gauges"]["dawn.operand_bytes"] == held
    pg.adj_pull                       # built once: no second span
    assert trace.snapshot()["setup"]["spans"][
        "dawn.operand.pull_packed"]["n"] == 1


def test_from_edges_of_weighted_edges_is_one_load():
    src, dst = np.array([0, 1, 1]), np.array([1, 2, 2])
    CSRGraph.from_weighted_edges(src, dst, np.ones(3), 3, device="cpu")
    assert trace.snapshot()["setup"]["spans"]["dawn.from_edges"]["n"] == 1


def test_reset_clears_both_tables():
    _profiled(lambda: dawn.prepare(_graph(64), device="cpu",
                                   mode="sparse").apsp([1]))
    snap = trace.snapshot()
    assert snap["window"]["counters"] and snap["setup"]["spans"]
    trace.reset()
    assert trace.snapshot() == {
        "window": {"spans": {}, "counters": {}},
        "setup": {"spans": {}, "gauges": {}}}
