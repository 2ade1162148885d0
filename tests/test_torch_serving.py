"""The port's serving tier against the JAX package: landmark selection
(``graph/landmarks.py``), the label tables and every oracle answer
(``serve/oracle.py``), and ``GraphService`` driven by one query list in
both packages under one stepping clock, query for query and field for
field (``serve/engine.py``); then the hard fields of ``bench_serving
--quick`` through the port, and the port's own refusals.

Every comparison is exact except two analytics: ``harmonic`` and
``betweenness`` are float32 sums whose order differs between the
packages, held at the centrality tests' rtol 1e-6 / atol 1e-9.
"""
import json
import pathlib
import zlib

import numpy as np
import pytest
import torch

from benchmarks.bench_serving import (K_NEAREST, MAX_BATCH, N_LANDMARKS,
                                      POOL, _make_stream, _replay_certified)
from repro.core.centrality import CentralityConfig as JCentralityConfig
from repro.core.engine import EngineConfig as JEngineConfig
from repro.core.engine import prepare_graph as jprepare_graph
from repro.core.weighted import WeightedConfig as JWeightedConfig
from repro.graph import generators as jgen
from repro.graph import landmarks as jland
from repro.graph.csr import CSRGraph as JCSRGraph
from repro.graph.dynamic import DynamicCSRGraph as JDynamic
from repro.serve import DistanceOracle as JOracle
from repro.serve import build_landmark_labels as jbuild
from repro.serve import GraphQuery as JQuery
from repro.serve import GraphService as JService
from repro.serve import select_top_k as jselect_top_k
import repro_torch
from repro_torch.convert import csr_from_arrays
from repro_torch.core.centrality import CentralityConfig
from repro_torch.core.distributed import ShardedConfig
from repro_torch.core.engine import EngineConfig, prepare_graph
from repro_torch.core.weighted import WeightedConfig
from repro_torch.graph import landmarks as tland
from repro_torch.graph.dynamic import DynamicCSRGraph
from repro_torch.serve import (DistanceOracle, GraphQuery, GraphService,
                               build_landmark_labels, select_top_k)

from oracles import bfs_dist, bfs_dists

ROOT = pathlib.Path(__file__).resolve().parent.parent
ARRAYS = ("indptr", "indices", "src", "dst", "indptr_t", "indices_t")
ATTRS = ("served_by", "certified", "expired", "hops", "cost", "nearest",
         "t_submit", "t_done")
COUNTERS = ("cache_hits", "oracle_hits", "sweep_served", "expired_count",
            "epoch_invalidations", "n_submitted", "n_completed_total")
RTOL, ATOL = 1e-6, 1e-9


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _port(jg):
    return csr_from_arrays({k: np.asarray(getattr(jg, k)) for k in ARRAYS},
                           n_nodes=jg.n_nodes, n_edges=jg.n_edges,
                           m_pad=jg.m_pad, device="cpu")


GRAPHS = {
    "undirected": lambda: jgen.watts_strogatz(96, 6, 0.1, seed=5),
    "directed": lambda: jgen.rmat(7, 6, directed=True, seed=2),
    "disconnected": lambda: jgen.disconnected(3, 30, 3.0, seed=4),
}


@pytest.fixture(scope="module", params=sorted(GRAPHS))
def pair(request):
    jg = GRAPHS[request.param]()
    return request.param, jg, _port(jg)


class StepClock:
    """A clock that moves by a fixed step at every reading, so ripeness
    and the flush-time EWMA are the same in both packages."""

    def __init__(self, step=1e-3):
        self.now, self.step = 0.0, step

    def __call__(self):
        self.now += self.step
        return self.now


# -- landmark selection -------------------------------------------------------

@pytest.mark.parametrize("strategy", ["degree", "farthest", "mixed"])
@pytest.mark.parametrize("k", [1, 5, 12])
def test_select_landmarks_matches_jax(pair, strategy, k):
    _, jg, tg = pair
    rows = {}

    def dist_fn(v):
        rows.setdefault(v, bfs_dist(jg, v))
        return rows[v]

    want = jland.select_landmarks(jg, k, strategy=strategy, dist_fn=dist_fn)
    got = tland.select_landmarks(
        tg, k, strategy=strategy,
        dist_fn=lambda v: torch.from_numpy(dist_fn(v)))
    np.testing.assert_array_equal(got, want)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(tland.degree_landmarks(tg, k),
                                  jland.degree_landmarks(jg, k))
    np.testing.assert_array_equal(
        tland.farthest_point_fill(tg, np.zeros(0, np.int32), k, dist_fn),
        jland.farthest_point_fill(jg, np.zeros(0, np.int32), k, dist_fn))


def test_select_landmarks_refusals(pair):
    _, _, tg = pair
    with pytest.raises(ValueError, match="unknown landmark strategy"):
        tland.select_landmarks(tg, 4, strategy="random")
    with pytest.raises(ValueError, match="dist_fn"):
        tland.select_landmarks(tg, 4, strategy="mixed")
    assert tland.select_landmarks(tg, 0).shape == (0,)


# -- label tables and the oracle ----------------------------------------------

@pytest.mark.parametrize("n_landmarks,strategy", [(6, "mixed"),
                                                  (4, "farthest"),
                                                  (16, "degree")])
def test_oracle_matches_jax_on_all_pairs(pair, n_landmarks, strategy):
    name, jg, tg = pair
    jo = JOracle(jg, n_landmarks=n_landmarks, strategy=strategy)
    to = DistanceOracle(tg, n_landmarks=n_landmarks, strategy=strategy)
    np.testing.assert_array_equal(to.landmarks, jo.landmarks)
    jpg, tpg = jo.prepared, to.prepared
    for field in ("landmark_dist", "landmark_dist_rev"):
        want, got = np.asarray(getattr(jpg, field)), getattr(tpg, field)
        assert isinstance(got, np.ndarray) and got.dtype == np.int32
        np.testing.assert_array_equal(got, want)
    assert (tpg.landmark_dist_rev is tpg.landmark_dist) == \
        (jpg.landmark_dist_rev is jpg.landmark_dist)
    assert (tpg.landmark_dist_rev is tpg.landmark_dist) == \
        (name != "directed")
    assert tpg.landmark_key == jpg.landmark_key
    assert to.labels_checksum() == jo.labels_checksum()
    n = tg.n_nodes
    for s in range(n):
        assert to.predicted_sweeps(s) == jo.predicted_sweeps(s)
        lo_t, up_t = to.bounds(s)
        lo_j, up_j = jo.bounds(s)
        np.testing.assert_array_equal(lo_t, lo_j)
        np.testing.assert_array_equal(up_t, up_j)
        for k in (1, 3, 8):
            assert to.top_k(s, k) == jo.top_k(s, k)
        row_t, row_j = to.landmark_row(s), jo.landmark_row(s)
        assert (row_t is None) == (row_j is None)
        if row_t is not None:
            np.testing.assert_array_equal(row_t, np.asarray(row_j))
        for t in range(n):
            a, b = to.query(s, t), jo.query(s, t)
            assert (a.source, a.target, a.lower, a.upper, a.exact, a.hops,
                    a.certificate) == (b.source, b.target, b.lower,
                                       b.upper, b.exact, b.hops,
                                       b.certificate)
    assert (to.n_queries, to.n_certified) == (jo.n_queries, jo.n_certified)


def test_labels_cached_on_prepared_graph_and_rebuilt_on_new_key(pair):
    _, jg, tg = pair
    pg = prepare_graph(tg, device="cpu")
    marks = build_landmark_labels(pg, n_landmarks=4)
    table = pg.landmark_dist
    assert build_landmark_labels(pg, n_landmarks=4) is marks
    assert pg.landmark_dist is table                  # reused
    jpg = jprepare_graph(jg)
    for k, strategy in ((5, "degree"), (3, "mixed")):
        build_landmark_labels(pg, n_landmarks=k, strategy=strategy)
        jbuild(jpg, n_landmarks=k, strategy=strategy)
        assert pg.landmark_key == (k, strategy)
        np.testing.assert_array_equal(pg.landmarks, jpg.landmarks)
        np.testing.assert_array_equal(pg.landmark_dist,
                                      np.asarray(jpg.landmark_dist))
    with pytest.raises(ValueError, match="n_landmarks"):
        build_landmark_labels(pg, n_landmarks=0)
    with pytest.raises(ValueError, match="strategy"):
        build_landmark_labels(pg, n_landmarks=2, strategy="nope")


@pytest.mark.parametrize("k", [1, 4, 50])
def test_select_top_k_matches_jax(pair, k):
    _, jg, _ = pair
    rng = np.random.default_rng(k)
    for s in rng.integers(0, jg.n_nodes, 6):
        row = bfs_dist(jg, int(s))
        assert select_top_k(row, int(s), k) == jselect_top_k(row, int(s), k)
        frow = np.where(row < 0, np.inf, row * 0.5).astype(np.float32)
        assert select_top_k(frow, int(s), k) == \
            jselect_top_k(frow, int(s), k)


# -- GraphService: one query list through both packages -----------------------

def _lanes(m_pad, seed):
    return (np.random.default_rng(seed).integers(4, 33, m_pad) / 8) \
        .astype(np.float32)


def _stream(n, seed, *, weighted, analytics, deadlines):
    """One op list: submits of every kind, ticks, flushes and clock jumps
    (which expire the deadline queries still queued)."""
    rng = np.random.default_rng(seed)
    hot = rng.choice(n, size=min(12, n), replace=False)
    ops = []
    for i in range(90):
        s = int(rng.choice(hot)) if rng.random() < 0.7 else \
            int(rng.integers(0, n))
        kind = int(rng.integers(0, 6))
        q = dict(qid=i, source=s)
        if kind == 0:
            q["target"] = int(rng.integers(0, n))
        elif kind == 1:
            q["k_nearest"] = int(rng.integers(1, 6))
        elif kind == 3 and weighted:
            q["weighted"] = True
            if rng.random() < 0.5:
                q["target"] = int(rng.integers(0, n))
        elif kind == 4 and analytics:
            q["analytics"] = ("closeness", "harmonic", "eccentricity")[
                : int(rng.integers(1, 4))]
            if rng.random() < 0.3:
                q["analytics"] = q["analytics"] + ("betweenness",)
        if deadlines and rng.random() < 0.15:
            q["deadline"] = float(rng.choice([0.002, 0.05, 5.0]))
        ops.append(("submit", q))
        r = rng.random()
        if r < 0.4:
            ops.append(("tick",))
        elif r < 0.5:
            ops.append(("flush",))
        elif r < 0.55:
            ops.append(("jump", 0.1))
    if deadlines:
        # analytics queries always queue: their deadlines trip in the jump
        for i in range(3):
            ops.append(("submit", dict(qid=100 + i, source=i,
                                       analytics=("closeness",),
                                       deadline=0.01)))
        ops += [("jump", 1.0), ("flush",)]
    ops.append(("drain",))
    return ops


def _apply(svc, query_cls, ops, clock, mutate=None):
    done = []
    for op in ops:
        if op[0] == "submit":
            svc.submit(query_cls(**op[1]))
        elif op[0] == "tick":
            svc.tick()
        elif op[0] == "flush":
            svc.flush()
        elif op[0] == "jump":
            clock.now += op[1]
        elif op[0] == "mutate":
            mutate(svc, op[1])
        elif op[0] == "drain":
            while svc.pending():
                svc.flush()
        done += svc.drain_completed()
    return done


def _assert_same(done_t, done_j, svc_t, svc_j):
    assert [q.qid for q in done_t] == [q.qid for q in done_j]
    for qt, qj in zip(done_t, done_j):
        for a in ATTRS:
            assert getattr(qt, a) == getattr(qj, a), (qt.qid, a)
        if qj.dist is None:
            assert qt.dist is None
        else:
            assert isinstance(qt.dist, np.ndarray)
            assert qt.dist.dtype == np.asarray(qj.dist).dtype
            np.testing.assert_array_equal(qt.dist, np.asarray(qj.dist))
        if qj.analytics_result is None:
            assert qt.analytics_result is None
        else:
            assert list(qt.analytics_result) == list(qj.analytics_result)
            for m, want in qj.analytics_result.items():
                got = qt.analytics_result[m]
                if m in ("closeness", "eccentricity"):
                    assert got == want, (qt.qid, m)
                else:
                    np.testing.assert_allclose(got, want, rtol=RTOL,
                                               atol=ATOL)
    for c in COUNTERS:
        assert getattr(svc_t, c) == getattr(svc_j, c), c
    assert svc_t._flush_est == svc_j._flush_est


SERVICE_CASES = {
    # the default engines (calibrated on the CPU), oracle and cache
    "default": dict(n_landmarks=6, row_cache_size=8, max_batch=8),
    # pinned forms, no oracle, a tiny cache and a short retention
    "pinned": dict(n_landmarks=0, row_cache_size=2, max_batch=5,
                   completed_retention=7, max_wait=0.01,
                   pinned=True),
    # deadline policy: wide batches, ripeness from deadlines alone
    "deadlines": dict(n_landmarks=4, landmark_strategy="degree",
                      row_cache_size=0, max_batch=16,
                      deadline_safety=1.0),
}


@pytest.mark.parametrize("case", sorted(SERVICE_CASES))
def test_graph_service_matches_jax(pair, case):
    name, jg, tg = pair
    kw = dict(SERVICE_CASES[case])
    pinned = kw.pop("pinned", False)
    w = _lanes(jg.m_pad, 3)
    jkw, tkw = dict(kw), dict(kw)
    if pinned:
        jkw.update(config=JEngineConfig(source_batch=8, mode="sparse"),
                   weighted_config=JWeightedConfig(source_batch=8,
                                                   mode="sparse"),
                   centrality_config=JCentralityConfig(source_batch=8,
                                                       mode="sparse"))
        tkw.update(config=EngineConfig(source_batch=8, mode="sparse"),
                   weighted_config=WeightedConfig(source_batch=8,
                                                  mode="sparse"),
                   centrality_config=CentralityConfig(source_batch=8,
                                                      mode="sparse"))
    cj, ct = StepClock(), StepClock()
    svc_j = JService(jg, weights=w, clock=cj, **jkw)
    svc_t = GraphService(tg, weights=w, clock=ct, device="cpu", **tkw)
    ops = _stream(tg.n_nodes, zlib.crc32(f"{name}/{case}".encode()),
                  weighted=True, analytics=True,
                  deadlines=case == "deadlines")
    done_j = _apply(svc_j, JQuery, ops, cj)
    done_t = _apply(svc_t, GraphQuery, ops, ct)
    _assert_same(done_t, done_j, svc_t, svc_j)
    assert len(done_t) == sum(op[0] == "submit" for op in ops)
    served = {q.served_by for q in done_t}
    assert "sweep" in served
    if case == "deadlines":
        assert svc_t.expired_count > 0
    # every answer is exact
    for q in done_t:
        if q.expired or q.analytics is not None or q.weighted:
            continue
        row = bfs_dist(jg, q.source)
        if q.target is not None:
            assert q.hops == row[q.target]
        elif q.k_nearest is not None:
            assert q.nearest == jselect_top_k(row, q.source, q.k_nearest)
        else:
            np.testing.assert_array_equal(q.dist, row)


def test_graph_service_matches_jax_on_mutated_dynamic_graph():
    jg = jgen.watts_strogatz(80, 4, 0.1, seed=7)
    src, dst = (np.asarray(a[: jg.n_edges], np.int64)
                for a in (jg.src, jg.dst))
    jd = JDynamic.from_edges(src, dst, jg.n_nodes)
    td = DynamicCSRGraph.from_edges(src, dst, jg.n_nodes, device="cpu")
    rng = np.random.default_rng(0)
    ops = _stream(jg.n_nodes, 5, weighted=False, analytics=True,
                  deadlines=False)
    out = []
    for i, op in enumerate(ops):
        out.append(op)
        if i in (30, 70, 120):
            u = rng.integers(0, jg.n_nodes, 4)
            v = rng.integers(0, jg.n_nodes, 4)
            out.append(("mutate", (u, v, i == 70)))

    def mutate(svc, arg):
        u, v, delete = arg
        g = svc.graph_source
        if delete:
            s, d = g.edges()[:2]
            g.delete_edges(s[:3], d[:3])
        else:
            g.insert_edges(u, v)

    cj, ct = StepClock(), StepClock()
    kw = dict(n_landmarks=4, row_cache_size=6, max_batch=8)
    svc_j = JService(jd, clock=cj, **kw)
    svc_t = GraphService(td, clock=ct, device="cpu", **kw)
    done_j = _apply(svc_j, JQuery, out, cj, mutate)
    done_t = _apply(svc_t, GraphQuery, out, ct, mutate)
    _assert_same(done_t, done_j, svc_t, svc_j)
    assert svc_t.epoch_invalidations == 3 == td.epoch
    assert svc_t.prepared.epoch == td.epoch
    # the answers after the last mutation are on the new graph
    view = td.view()
    jv = JCSRGraph.from_edges(view.src[: view.n_edges].numpy(),
                              view.dst[: view.n_edges].numpy(), view.n_nodes)
    last = [q for q in done_t if q.qid > 85 and q.target is not None
            and not q.expired]
    assert last
    for q in last:
        assert q.hops == bfs_dist(jv, q.source)[q.target]


# -- the hard fields of bench_serving --quick ---------------------------------

class _Virtual:
    def __init__(self):
        self.now = 0.0

    def __call__(self):
        return self.now


def _drive(svc, stream, arrivals, clock):
    """bench_serving's open loop: submit at the scheduled instants, tick
    after each arrival (size-threshold flushing only), drain with
    flush()."""
    for i, ((kind, s, t), at) in enumerate(zip(stream, arrivals)):
        clock.now = max(clock.now, float(at))
        if kind == 0:
            q = GraphQuery(qid=i, source=s, target=t)
        elif kind == 1:
            q = GraphQuery(qid=i, source=s, k_nearest=K_NEAREST)
        else:
            q = GraphQuery(qid=i, source=s)
        svc.submit(q)
        while svc.tick():
            pass
    while svc.pending():
        svc.flush()
    return svc.drain_completed()


@pytest.mark.parametrize("fi,family", [(0, "grid_road"),
                                       (1, "ws_citation")])
def test_bench_serving_quick_hard_fields(fi, family):
    base = json.loads((ROOT / "benchmarks" / "BENCH_BASELINE.json")
                      .read_text())["bench_serving"]["families"][family]
    jg = {"grid_road": lambda: jgen.grid2d(32, 32),
          "ws_citation": lambda: jgen.watts_strogatz(1024, 8, 0.05,
                                                     seed=3)}[family]()
    tg = _port(jg)
    nq = base["n_queries"]
    pool, stream, arrivals = _make_stream(nq, tg.n_nodes, seed=11 + fi)
    clock = _Virtual()
    svc = GraphService(tg, max_batch=MAX_BATCH, n_landmarks=N_LANDMARKS,
                       row_cache_size=POOL, completed_retention=None,
                       clock=clock, device="cpu")
    done = _drive(svc, stream, arrivals, clock)
    assert len(done) == nq
    rows = dict(zip(np.unique(pool).tolist(), bfs_dists(jg, np.unique(pool))))
    for q in done:
        row = rows[q.source]
        if q.target is not None:
            assert q.hops == row[q.target]
        elif q.k_nearest is not None:
            assert q.nearest == select_top_k(row, q.source, K_NEAREST)
        else:
            np.testing.assert_array_equal(q.dist, row)
    certified = _replay_certified(
        DistanceOracle(svc.prepared, n_landmarks=N_LANDMARKS), stream)
    hits = svc.cache_hits + svc.oracle_hits
    got = {"labels_checksum": svc.oracle.labels_checksum(),
           "certified_count": int(certified),
           "certified_fraction": round(certified / nq, 6),
           "hit_rate": round(hits / nq, 6),
           "cache_hits": svc.cache_hits, "oracle_hits": svc.oracle_hits,
           "sweep_served": svc.sweep_served,
           "n_landmarks": svc.oracle.n_landmarks}
    assert got == {k: base[k] for k in got}


def test_deadline_minirun_surfaces_expired_queries():
    """bench_serving's deadline mini-run: every query's deadline trips
    before the flush, and all are surfaced."""
    tg = _port(jgen.grid2d(32, 32))
    clock = _Virtual()
    svc = GraphService(tg, max_batch=8, clock=clock, device="cpu")
    for i in range(4):
        svc.submit(GraphQuery(qid=i, source=i, target=tg.n_nodes - 1,
                              deadline=0.01))
    clock.now = 1.0
    svc.flush()
    done = svc.drain_completed()
    assert len(done) == 4 and svc.expired_count == 4
    assert all(q.expired and q.served_by == "expired" and q.hops is None
               for q in done)


# -- the port's own rules ----------------------------------------------------

def test_service_rules_and_refusals():
    jg = jgen.grid2d(6, 6)
    tg = _port(jg)
    # a CPU mesh serves in tests/test_torch_distributed.py; a foreign mesh
    # object raises
    with pytest.raises(ValueError, match="DeviceMesh"):
        GraphService(tg, mesh=object(), device="cpu")
    with pytest.raises(ValueError, match="DeviceMesh"):
        repro_torch.prepare(tg, device="cpu").serve(mesh=object())
    # sharded_threshold and sharded_config are inert without a mesh, as in
    # the JAX package
    svc = GraphService(tg, max_batch=8, sharded_threshold=1, device="cpu",
                       sharded_config=ShardedConfig(mode="sparse"))
    for i in range(3):
        svc.submit(GraphQuery(qid=i, source=i))
    assert all(q.served_by == "sweep" for q in svc.flush())
    assert svc.sharded_flushes == 0
    with pytest.raises(ValueError, match="unknown analytics"):
        svc.submit(GraphQuery(qid=0, source=0, analytics=("pagerank",)))
    with pytest.raises(ValueError, match="unweighted"):
        svc.submit(GraphQuery(qid=1, source=0, weighted=True,
                              analytics=("closeness",)))
    with pytest.raises(ValueError, match="k_nearest"):
        svc.submit(GraphQuery(qid=2, source=0, k_nearest=0))
    with pytest.raises(ValueError, match="without weights"):
        svc.submit(GraphQuery(qid=3, source=0, weighted=True))
    with pytest.raises(ValueError, match="not in"):
        svc.submit(GraphQuery(qid=4, source=36))
    dg = DynamicCSRGraph(tg)
    with pytest.raises(ValueError, match="ambiguous"):
        GraphService(dg, weights=_lanes(tg.m_pad, 0), device="cpu")
    with pytest.raises(ValueError, match="lies on cpu"):
        GraphService(dg, device="meta")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            GraphService(tg)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            repro_torch.prepare(tg, device=None)


def test_facade_serve_takes_the_handle_options_weights_and_device():
    jg = jgen.watts_strogatz(64, 4, 0.1, seed=1)
    tg = _port(jg)
    w = _lanes(tg.m_pad, 1)
    h = repro_torch.prepare(tg, weights=w, device="cpu", mode="sparse",
                            source_batch=16)
    svc = h.serve(max_batch=4, n_landmarks=3)
    assert svc.device == torch.device("cpu")
    assert svc.config.mode == "sparse" and svc.config.source_batch == 16
    assert svc.max_batch == 4 and svc._base_weights is w
    q = GraphQuery(qid=0, source=5, target=40, weighted=True)
    u = GraphQuery(qid=1, source=5, target=40)
    svc.submit(q)
    svc.submit(u)
    svc.flush()
    from oracles import dijkstra_dist
    assert q.cost == float(dijkstra_dist(jg, w, 5)[40])
    assert u.hops == bfs_dist(jg, 5)[40]
    assert isinstance(q.cost, float) and isinstance(u.hops, int)


def test_row_cache_lru_and_retention():
    tg = _port(jgen.watts_strogatz(64, 4, 0.1, seed=2))
    svc = GraphService(tg, max_batch=8, row_cache_size=2,
                       completed_retention=3, device="cpu")
    svc.submit(GraphQuery(qid=0, source=5))
    svc.flush()
    q = GraphQuery(qid=1, source=5, target=40)
    svc.submit(q)
    assert q.served_by == "cache" and q.certified and svc.pending() == 0
    for i, s in enumerate((7, 9)):
        svc.submit(GraphQuery(qid=10 + i, source=s))
    svc.flush()
    assert list(svc._row_cache) == [("unweighted", 7), ("unweighted", 9)]
    miss = GraphQuery(qid=20, source=5)
    svc.submit(miss)
    assert miss.served_by is None and svc.pending() == 1
    assert len(svc.completed) == 3 and svc.n_completed_total == 4
