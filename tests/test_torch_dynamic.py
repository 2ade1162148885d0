"""The port's mutable graphs and incremental repair against the JAX
package: ``DynamicCSRGraph`` under the same operation sequence as
``repro.graph.dynamic``, ``repair`` / ``sssp_state`` / ``IncrementalSSSP``
bit-identical to ``repro.core.incremental`` on one input state (carried
across by ``convert.incremental_state_from``), the ``bench_dynamic
--quick`` stream through the port, and the facade on a dynamic graph.

Every comparison is exact: the repairs relax unit or dyadic weights, so
the float32 distances of both packages are the same bits.
"""
import zlib

import numpy as np
import pytest
import torch

import repro
from benchmarks.bench_dynamic import (_QUERIES_PER_ROUND, _SOURCES,
                                      _record_stream)
from repro.core import incremental as jinc
from repro.core.engine import EngineConfig as JEngineConfig
from repro.core.weighted import WeightedConfig as JWeightedConfig
from repro.graph import generators as jgen
from repro.graph.dynamic import DynamicCSRGraph as JDynamic
import repro_torch
from repro_torch.convert import csr_from_arrays, incremental_state_from
from repro_torch.core import incremental as tinc
from repro_torch.core.engine import EngineConfig
from repro_torch.core.weighted import WeightedConfig
from repro_torch.graph.csr import CSRGraph
from repro_torch.graph.dynamic import DynamicCSRGraph

from oracles import adversarial_families

ARRAYS = ("indptr", "indices", "src", "dst", "indptr_t", "indices_t")
# the calibrated direction choice of the default CPU regime times every
# form at each new epoch; a pinned form gives the same dist and sweeps
SPARSE = EngineConfig(mode="sparse")
J_SPARSE = JEngineConfig(mode="sparse")


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _port_graph(jg) -> CSRGraph:
    return csr_from_arrays({k: np.asarray(getattr(jg, k)) for k in ARRAYS},
                           n_nodes=jg.n_nodes, n_edges=jg.n_edges,
                           m_pad=jg.m_pad, device="cpu")


def _pair(src, dst, n, weights=None, **kw):
    """The same dynamic graph in both packages, from one JAX base."""
    jd = JDynamic.from_edges(np.asarray(src, np.int64),
                             np.asarray(dst, np.int64), n_nodes=n,
                             weights=weights, **kw)
    base = jd.view()
    w = None if weights is None else jd.view_weights()
    td = DynamicCSRGraph(_port_graph(base), weights=w, **kw)
    return jd, td


def _assert_same_graph(jd, td):
    for a, b in zip(jd.edges(), td.edges()):
        np.testing.assert_array_equal(a, b)
    jv, tv = jd.view(), td.view()
    for k in ARRAYS:
        np.testing.assert_array_equal(np.asarray(getattr(jv, k)),
                                      getattr(tv, k).numpy(), err_msg=k)
    assert (jv.n_nodes, jv.n_edges, jv.m_pad) == \
        (tv.n_nodes, tv.n_edges, tv.m_pad)
    if jd.weighted:
        np.testing.assert_array_equal(jd.view_weights(), td.view_weights())
    else:
        assert td.view_weights() is None
    assert (jd.epoch, jd.layout_version, jd.compactions, jd.n_edges,
            jd.m_pad) == (td.epoch, td.layout_version, td.compactions,
                          td.n_edges, td.m_pad)


def _assert_same_delta(jd, td, since):
    a, b = jd.delta_since(since), td.delta_since(since)
    if a is None:
        assert b is None
        return
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
        assert x.dtype == y.dtype


# --------------------------------------------------------------------------
# DynamicCSRGraph parity
# --------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["unweighted", "weighted", "grow",
                                  "auto_compact"])
def test_dynamic_graph_parity(case):
    rng = np.random.default_rng(zlib.crc32(case.encode()))
    n = 41
    e = rng.integers(0, n, (90, 2))
    weighted = case == "weighted"
    w = rng.integers(1, 17, 90).astype(np.float32) / 4 if weighted else None
    kw = {"grow": dict(slack=0.0),
          "auto_compact": dict(compact_threshold=0.05)}.get(case, {})
    jd, td = _pair(e[:, 0], e[:, 1], n, weights=w, **kw)
    _assert_same_graph(jd, td)
    epochs = [0]
    for it in range(14):
        k = int(rng.integers(20, 40)) if case == "grow" \
            else int(rng.integers(1, 12))
        ins = rng.integers(0, n, (k, 2))
        wi = rng.integers(1, 17, k).astype(np.float32) / 4 \
            if weighted else None
        assert jd.insert_edges(ins[:, 0], ins[:, 1], wi) == \
            td.insert_edges(ins[:, 0], ins[:, 1], wi)
        live = jd.edges()
        pick = rng.choice(len(live[0]), min(4, len(live[0])), replace=False)
        dels = (live[0][pick], live[1][pick])
        assert jd.delete_edges(*dels) == td.delete_edges(*dels)
        if it % 3 == 1:       # delete then re-insert a pre-existing edge
            u, v = int(dels[0][0]), int(dels[1][0])
            wr = np.array([9.0], np.float32) if weighted else None
            jd.insert_edges([u], [v], wr)
            td.insert_edges([u], [v], wr)
        if it == 6:
            jd.compact()
            td.compact()
        epochs.append(jd.epoch)
        _assert_same_graph(jd, td)
        for since in epochs[-4:]:
            _assert_same_delta(jd, td, since)
    assert td.epoch > 0 and td.layout_version > 0
    if case == "grow":
        assert td.m_pad > 128 and td.m_pad % 128 == 0


def test_dynamic_graph_journal_trim_and_repr():
    jd, td = _pair([0], [1], 8)
    rng = np.random.default_rng(5)
    for _ in range(300):           # past the journal limit of 256 batches
        u, v = rng.integers(0, 8, 2)
        jd.insert_edges([u], [v])
        td.insert_edges([u], [v])
        jd.delete_edges([u], [v])
        td.delete_edges([u], [v])
    _assert_same_delta(jd, td, 0)
    assert td.delta_since(0) is None
    _assert_same_delta(jd, td, td.epoch - 3)
    _assert_same_graph(jd, td)
    assert repr(td) == repr(jd)


def test_view_is_cached_per_epoch_and_layout():
    _, td = _pair([0, 1, 2], [1, 2, 3], 6)
    v = td.view()
    assert td.view() is v
    td.compact()
    v2 = td.view()
    assert v2 is not v and td.epoch == 0
    td.insert_edges([3], [4])
    assert td.view() is not v2
    assert td.view().device == torch.device("cpu")


# --------------------------------------------------------------------------
# repair / sssp_state against repro.core.incremental
# --------------------------------------------------------------------------

def _assert_same_state(js, ts, what):
    np.testing.assert_array_equal(np.asarray(js.dist), ts.dist.numpy(),
                                  err_msg=f"{what}: dist")
    np.testing.assert_array_equal(np.asarray(js.parent), ts.parent.numpy(),
                                  err_msg=f"{what}: parent")
    np.testing.assert_array_equal(js.dist_int(), ts.dist_int().numpy())
    np.testing.assert_array_equal(js.sources, ts.sources)
    assert (js.weighted, js.epoch) == (ts.weighted, ts.epoch), what


def _assert_same_repair(jr, tr, what):
    _assert_same_state(jr.state, tr.state, what)
    assert (jr.sweeps, jr.tainted, jr.seeded, jr.rebuilt) == \
        (tr.sweeps, tr.tainted, tr.seeded, tr.rebuilt), what


def _repair_both(jd, td, js, **kw):
    """The reference's and the port's repair of one input state (``js``
    carried across)."""
    jr = jinc.repair(jd, js, **kw)
    tr = tinc.repair(td, incremental_state_from(js, device="cpu"), **kw)
    _assert_same_repair(jr, tr, str(kw))
    return jr.state


def _families():
    return list(adversarial_families(seed=7))


@pytest.mark.parametrize("name,src,dst,n", _families(),
                         ids=[f[0] for f in _families()])
def test_repair_matches_reference_adversarial(name, src, dst, n):
    rng = np.random.default_rng(zlib.crc32(name.encode()))
    if len(src) == 0:
        src, dst = np.array([0]), np.array([min(1, n - 1)])
    jd, td = _pair(src, dst, n)
    sources = np.unique(rng.integers(0, n, min(4, n))).astype(np.int32)
    js, jsw = jinc.sssp_state(jd, sources, config=J_SPARSE)
    ts, tsw = tinc.sssp_state(td, sources, config=SPARSE)
    _assert_same_state(js, ts, f"{name}: scratch")
    assert jsw == tsw
    for it in range(4):
        ins = rng.integers(0, n, (rng.integers(1, 4), 2))
        ins = ins[ins[:, 0] != ins[:, 1]]
        jd.insert_edges(ins[:, 0], ins[:, 1])
        td.insert_edges(ins[:, 0], ins[:, 1])
        js = _repair_both(jd, td, js, inserts=(ins[:, 0], ins[:, 1]))
        live = jd.edges()
        if live[0].size and it % 2 == 1:
            i = rng.integers(0, live[0].size)
            u, v = live[0][i: i + 1], live[1][i: i + 1]
            jd.delete_edges(u, v)
            td.delete_edges(u, v)
            js = _repair_both(jd, td, js, deletes=(u, v))
    ts, _ = tinc.sssp_state(td, sources, config=SPARSE)
    _assert_same_state(js, ts, f"{name}: final scratch")


@pytest.mark.parametrize("case", ["disconnect", "reconnect", "tie"])
def test_repair_matches_reference_cut_and_join(case):
    if case == "disconnect":        # the tainted subtree is unreachable
        src, dst, ins, dels = [0, 1, 2, 3], [1, 2, 3, 4], None, ([1], [2])
    elif case == "reconnect":
        src, dst, ins, dels = [0, 2, 3], [1, 3, 4], ([1], [2]), None
    else:                           # an insert that only ties: inert
        src, dst, ins, dels = [0, 0, 1, 2], [1, 2, 3, 4], ([2], [3]), None
    jd, td = _pair(src, dst, 5)
    js, _ = jinc.sssp_state(jd, [0], config=J_SPARSE)
    for d in (ins, dels):
        if d is not None:
            (jd.insert_edges if d is ins else jd.delete_edges)(*d)
            (td.insert_edges if d is ins else td.delete_edges)(*d)
    kw = {"inserts": ins} if ins else {"deletes": dels}
    jr = jinc.repair(jd, js, **kw)
    tr = tinc.repair(td, incremental_state_from(js, device="cpu"), **kw)
    _assert_same_repair(jr, tr, case)
    assert (tr.sweeps > 0) == (case == "reconnect")


def test_weighted_repair_matches_reference():
    rng = np.random.default_rng(11)
    n = 24
    e = rng.integers(0, n, (60, 2))
    w = rng.integers(2, 17, 60).astype(np.float32) / 4
    jd, td = _pair(e[:, 0], e[:, 1], n, weights=w)
    sources = np.array([0, 5, 17], np.int32)
    js, jsw = jinc.sssp_state(jd, sources,
                              config=JWeightedConfig(mode="sparse"))
    ts, tsw = tinc.sssp_state(td, sources,
                              config=WeightedConfig(mode="sparse"))
    _assert_same_state(js, ts, "weighted scratch")
    assert jsw == tsw
    for it in range(5):
        u, v = (int(x) for x in rng.integers(0, n, 2))
        wt = np.array([rng.integers(1, 9) / 8], np.float32)
        if jd.insert_edges([u], [v], weights=wt):
            assert td.insert_edges([u], [v], weights=wt)
            js = _repair_both(jd, td, js, inserts=([u], [v], wt))
        live = jd.edges()
        i = rng.integers(0, live[0].size)
        du, dv = live[0][i: i + 1], live[1][i: i + 1]
        jd.delete_edges(du, dv)
        td.delete_edges(du, dv)
        js = _repair_both(jd, td, js, deletes=(du, dv))
    ts, _ = tinc.sssp_state(td, sources, config=WeightedConfig(mode="sparse"))
    _assert_same_state(js, ts, "weighted final scratch")


def test_weighted_repair_needs_positive_weights():
    _, td = _pair([0, 1], [1, 2], 3, weights=np.array([0.0, 1.0],
                                                      np.float32))
    ts, _ = tinc.sssp_state(td, [0], config=WeightedConfig(mode="sparse"))
    td.insert_edges([2], [0], weights=np.array([1.0], np.float32))
    with pytest.raises(AssertionError, match="strictly positive"):
        tinc.repair(td, ts, inserts=([2], [0], np.array([1.0], np.float32)))


def test_static_graph_repair_matches_reference():
    """A static CSRGraph with caller-held lane weights: the epoch stays
    the state's."""
    jg = jgen.erdos_renyi(60, 3.0, seed=2)
    tg = _port_graph(jg)
    w = (np.random.default_rng(1).integers(1, 9, jg.m_pad) / 4) \
        .astype(np.float32)
    js, _ = jinc.sssp_state(jg, [0, 7], weights=w,
                            config=JWeightedConfig(mode="sparse"))
    ts, _ = tinc.sssp_state(tg, [0, 7], weights=w,
                            config=WeightedConfig(mode="sparse"))
    _assert_same_state(js, ts, "static scratch")
    jr = jinc.repair(jg, js, weights=w)
    tr = tinc.repair(tg, incremental_state_from(js, device="cpu"),
                     weights=torch.from_numpy(w))
    _assert_same_repair(jr, tr, "static, empty batch")


@pytest.mark.parametrize("weighted", [False, True])
def test_incremental_sssp_matches_reference(weighted):
    rng = np.random.default_rng(3)
    n = 64
    e = rng.integers(0, n, (220, 2))
    w = rng.integers(2, 17, 220).astype(np.float32) / 4 if weighted \
        else None
    jd, td = _pair(e[:, 0], e[:, 1], n, weights=w)
    cfg = WeightedConfig(mode="sparse") if weighted else SPARSE
    jcfg = JWeightedConfig(mode="sparse") if weighted else J_SPARSE
    ji = repro.IncrementalSSSP(jd, [0, 1, 2], config=jcfg)
    ti = repro_torch.IncrementalSSSP(td, [0, 1, 2], config=cfg)
    assert ti.lane_index() is None          # no index on the CPU
    for it in range(6):
        ins = rng.integers(0, n, (3, 2))
        wi = rng.integers(1, 9, 3).astype(np.float32) / 4 if weighted \
            else None
        for d in (jd, td):
            d.insert_edges(ins[:, 0], ins[:, 1], wi)
        live = jd.edges()
        i = rng.integers(0, live[0].size)
        for d in (jd, td):
            d.delete_edges(live[0][i: i + 1], live[1][i: i + 1])
        if it == 3:
            jd.compact()
            td.compact()
        jr, tr = ji.update(), ti.update()
        _assert_same_repair(jr, tr, f"round {it}")
        assert ti.update() is None
    assert (ji.repair_sweeps, ji.scratch_sweeps, ji.repairs) == \
        (ti.repair_sweeps, ti.scratch_sweeps, ti.repairs)
    # trim the journal past the sync point: update() must full-rebuild
    ji2 = repro.IncrementalSSSP(jd, [0], config=jcfg)
    ti2 = repro_torch.IncrementalSSSP(td, [0], config=cfg)
    for _ in range(300):
        u, v = (int(x) for x in rng.integers(0, n, 2))
        wi = np.array([2.0], np.float32) if weighted else None
        for d in (jd, td):
            d.insert_edges([u], [v], wi)
    jr, tr = ji2.update(), ti2.update()
    assert tr.rebuilt and ti2.rebuilds == 1
    _assert_same_repair(jr, tr, "rebuild")
    assert ti2.scratch_sweeps == ji2.scratch_sweeps


def test_incremental_sssp_needs_a_dynamic_graph():
    g = _port_graph(jgen.erdos_renyi(30, 2.0, seed=0))
    with pytest.raises(TypeError, match="DynamicCSRGraph"):
        repro_torch.IncrementalSSSP(g, [0])


def test_incremental_state_crosses_over():
    jd, _ = _pair([0, 1, 2], [1, 2, 0], 4)
    js, _ = jinc.sssp_state(jd, [0, 3], config=J_SPARSE)
    ts = incremental_state_from(js, device="cpu")
    _assert_same_state(js, ts, "convert")
    assert ts.dist.dtype == torch.float32 and ts.parent.dtype == torch.int32
    with pytest.raises(ValueError, match="one"):
        js.parent = js.parent[:1]
        incremental_state_from(js, device="cpu")


# --------------------------------------------------------------------------
# the bench_dynamic --quick stream through the port
# --------------------------------------------------------------------------

# benchmarks/BENCH_BASELINE.json, bench_dynamic --quick
BASELINE = {
    "ws_locality": dict(repair_sweeps=20, scratch_sweeps=77,
                        query_checksum=157, n_epochs=10, n_compactions=0),
    "grid_locality": dict(repair_sweeps=209, scratch_sweeps=374,
                          query_checksum=637, n_epochs=10, n_compactions=4),
}


@pytest.mark.parametrize("family", sorted(BASELINE))
def test_bench_dynamic_quick_stream(family):
    jg = jgen.watts_strogatz(2048, 8, 0.05, seed=3) \
        if family == "ws_locality" else jgen.grid2d(40, 40)
    stream = _record_stream(jg, 6, per_round=6, seed=11)
    rng = np.random.default_rng(11 + 1)
    dg = DynamicCSRGraph(_port_graph(jg), compact_threshold=0.001)
    inc = repro_torch.IncrementalSSSP(dg, _SOURCES, config=SPARSE)
    scratch_sweeps = inc.scratch_sweeps
    checksum = 0
    for ins_src, ins_dst, del_src, del_dst in stream:
        dg.insert_edges(ins_src, ins_dst)
        if del_src.size:
            dg.delete_edges(del_src, del_dst)
        inc.update()
        shadow, sweeps = repro_torch.sssp_state(dg, _SOURCES, config=SPARSE)
        scratch_sweeps += sweeps
        assert torch.equal(inc.dist_int(), shadow.dist_int())
        assert torch.equal(inc.parent, shadow.parent)
        targets = rng.integers(0, jg.n_nodes, size=_QUERIES_PER_ROUND)
        checksum += int(inc.dist_int()[0, targets].sum())
    got = dict(repair_sweeps=inc.repair_sweeps,
               scratch_sweeps=scratch_sweeps, query_checksum=checksum,
               n_epochs=dg.epoch, n_compactions=dg.compactions)
    assert got == BASELINE[family]


# --------------------------------------------------------------------------
# the facade on a dynamic graph
# --------------------------------------------------------------------------

def test_facade_reprepares_per_epoch():
    jg = jgen.barabasi_albert(90, 2, seed=6)
    jd = JDynamic(jg)
    td = DynamicCSRGraph(_port_graph(jg))
    hj = repro.prepare(jd, mode="sparse")
    ht = repro_torch.prepare(td, device="cpu", mode="sparse")
    assert ht.mutable and ht.epoch == 0
    pg = ht.prepared()
    assert ht.prepared() is pg and pg.epoch == 0
    for h in (hj, ht):
        h.insert_edges([3, 80], [80, 3])
        h.delete_edges([0], [1])
    pg2 = ht.prepared()
    assert pg2 is not pg and pg2.epoch == td.epoch == jd.epoch > 0
    rj, rt = hj.apsp([0, 3, 50]), ht.apsp([0, 3, 50])
    np.testing.assert_array_equal(np.asarray(rj.dist), rt.dist.numpy())
    np.testing.assert_array_equal(hj.sssp(80), ht.sssp(80).numpy())
    ht.compact()
    assert td.layout_version == 1 and ht.prepared() is pg2
    ij, it = hj.incremental([0, 3]), ht.incremental([0, 3])
    for h in (hj, ht):
        h.insert_edges([10], [60])
    _assert_same_repair(ij.update(), it.update(), "facade")


def test_facade_weighted_dynamic():
    jg = jgen.erdos_renyi(70, 3.0, seed=9)
    lanes = (np.random.default_rng(2).integers(1, 9, jg.m_pad) / 4) \
        .astype(np.float32)
    jd = JDynamic(jg, weights=lanes)
    td = DynamicCSRGraph(_port_graph(jg), weights=lanes)
    hj = repro.prepare(jd, mode="sparse")
    ht = repro_torch.prepare(td, device="cpu", mode="sparse")
    pw = ht.prepared_weighted()
    assert ht.prepared_weighted() is pw
    for h in (hj, ht):
        h.insert_edges([1, 2], [40, 41], weights=np.array([0.25, 0.5],
                                                          np.float32))
    assert ht.prepared_weighted() is not pw
    assert ht.prepared_weighted().epoch == td.epoch
    rj = hj.apsp([0, 1, 2], semiring="tropical")
    rt = ht.apsp([0, 1, 2], semiring="tropical")
    np.testing.assert_array_equal(np.asarray(rj.dist), rt.dist.numpy())
    inc = ht.incremental([0, 1])
    assert isinstance(inc.config, WeightedConfig) and inc.state.weighted


def test_facade_dynamic_rules():
    tg = _port_graph(jgen.erdos_renyi(30, 2.0, seed=0))
    td = DynamicCSRGraph(tg)
    with pytest.raises(ValueError, match="ambiguous"):
        repro_torch.prepare(td, weights=np.ones(tg.m_pad, np.float32),
                            device="cpu")
    h = repro_torch.prepare(tg, device="cpu")
    assert not h.mutable and h.epoch == 0
    for call in (lambda: h.insert_edges([0], [1]),
                 lambda: h.delete_edges([0], [1]), h.compact,
                 lambda: h.incremental([0])):
        with pytest.raises(TypeError, match="static CSRGraph"):
            call()
    with pytest.raises(ValueError, match="weighted DynamicCSRGraph"):
        repro_torch.prepare(td, device="cpu").apsp([0], semiring="tropical")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            repro_torch.prepare(td)
    # one handle, one device: a dynamic graph elsewhere is refused, as its
    # views and incremental()'s state would lie off the handle's device
    with pytest.raises(ValueError, match="handle's device"):
        repro_torch.prepare(td, device="meta")
