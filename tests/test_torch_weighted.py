"""The port's tropical (weighted) engine against the JAX package on the
CPU: ``from_weighted_edges``, ``weighted_apsp``'s ``dist``, ``sweeps``,
``direction_counts`` and ``edges_touched`` bit-identical to
``repro.core.weighted`` in every pinned mode, under the dynamic switch and
on the kernel path with and without fused blocks; the single-source and
bucketed drivers against JAX and scipy's Dijkstra; the facade; and
``bench_weighted --quick``'s sweep counts.  Weights are numpy-seeded
``uniform(0.5, 4.0)``; the wall-clock calibration regime is run only to
check which indexes it builds, never compared (it is not
deterministic)."""
import importlib

import numpy as np
import pytest
import torch

import repro
from oracles import adversarial_families
from repro.graph import generators as jgen
from repro.graph.csr import CSRGraph as JCSR
from repro_torch.convert import csr_from_arrays, lane_weights_from_array
from repro_torch.graph.csr import CSRGraph as TCSR
from repro_torch.graph.dynamic import DynamicCSRGraph
from repro_torch.kernels import tropical as tkern
import repro_torch

jw = importlib.import_module("repro.core.weighted")
tw = importlib.import_module("repro_torch.core.weighted")

ARRAYS = ("indptr", "indices", "src", "dst", "indptr_t", "indices_t")
FAMILIES = {name: (src, dst, n) for name, src, dst, n in
            adversarial_families()}

CONFIGS = {
    "dense": dict(mode="dense", use_kernel=False),
    "sparse": dict(mode="sparse", use_kernel=False),
    "dynamic": dict(use_kernel=True, dynamic=True),
    "kernel_dense": dict(mode="dense", use_kernel=True),
    "fused3": dict(use_kernel=True, fused_steps=3),
    "fused_all": dict(use_kernel=True, fused_steps=-1),
}


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def carry(jg):
    return csr_from_arrays({k: np.asarray(getattr(jg, k)) for k in ARRAYS},
                           n_nodes=jg.n_nodes, n_edges=jg.n_edges,
                           m_pad=jg.m_pad, device="cpu")


def weighted_family(family, seed=0):
    src, dst, n = FAMILIES[family]
    jg = JCSR.from_edges(src, dst, n)
    w = np.random.default_rng(seed).uniform(0.5, 4.0, jg.m_pad) \
        .astype(np.float32)
    return jg, w


def assert_same(rj, rt):
    np.testing.assert_array_equal(np.asarray(rj.dist), rt.dist.numpy())
    assert int(rj.sweeps) == rt.sweeps
    np.testing.assert_array_equal(np.asarray(rj.direction_counts),
                                  rt.direction_counts.numpy())
    assert float(rj.edges_touched) == float(rt.edges_touched)


# --------------------------------------------------------------------------
# the weighted graph container
# --------------------------------------------------------------------------

def test_from_weighted_edges_matches_jax():
    """Duplicates min-reduced, self-loops dropped: the same lanes and the
    same lane weights as the JAX container."""
    rng = np.random.default_rng(5)
    n, m = 60, 400
    src = rng.integers(0, n, m)
    dst = rng.integers(0, n, m)
    src[:20], dst[:20] = 3, 7                 # a bundle of parallel edges
    src[20:30] = dst[20:30]                   # self-loops
    w = rng.uniform(0.5, 4.0, m)
    jg, jl = JCSR.from_weighted_edges(src, dst, w, n)
    tg, tl = TCSR.from_weighted_edges(src, dst, w, n, device="cpu")
    for name in ARRAYS:
        np.testing.assert_array_equal(np.asarray(getattr(jg, name)),
                                      getattr(tg, name).numpy())
    assert (jg.n_edges, jg.m_pad) == (tg.n_edges, tg.m_pad)
    assert tl.dtype == torch.float32 and tl.device.type == "cpu"
    np.testing.assert_array_equal(jl, tl.numpy())
    assert np.isposinf(tl.numpy()[tg.n_edges:]).all()
    lane = int(np.flatnonzero((tg.src.numpy() == 3)
                              & (tg.dst.numpy() == 7))[0])
    assert tl[lane] == np.float32(w[:20].min())
    with pytest.raises(ValueError, match="shapes differ"):
        TCSR.from_weighted_edges(src, dst, w[:-1], n, device="cpu")


def test_lane_weights_carry_across():
    jg, w = weighted_family("random_ragged")
    pw = jw.prepare_weighted(jg, w)
    lanes = lane_weights_from_array(np.asarray(pw.w_edges),
                                    n_edges=jg.n_edges, m_pad=jg.m_pad,
                                    device="cpu")
    np.testing.assert_array_equal(np.asarray(pw.w_edges), lanes.numpy())
    with pytest.raises(ValueError, match="shape"):
        lane_weights_from_array(w[:-1], n_edges=jg.n_edges, m_pad=jg.m_pad,
                                device="cpu")
    with pytest.raises(ValueError, match=r"\+inf"):
        lane_weights_from_array(w, n_edges=jg.n_edges, m_pad=jg.m_pad,
                                device="cpu")


def test_prepare_weighted_matches_jax():
    jg, w = weighted_family("duplicate_edges", seed=2)
    pj = jw.prepare_weighted(jg, w)
    pt = tw.prepare_weighted(carry(jg), w, device="cpu")
    assert pj.n_pad == pt.n_pad
    np.testing.assert_array_equal(np.asarray(pj.w_edges), pt.w_edges.numpy())
    np.testing.assert_array_equal(np.asarray(pj.deg), pt.deg.numpy())
    np.testing.assert_array_equal(np.asarray(pj.wdense), pt.wdense.numpy())
    assert pt.wdense is pt.wdense                   # built once
    with pytest.raises(ValueError, match="non-negative"):
        tw.prepare_weighted(carry(jg), -w, device="cpu")
    with pytest.raises(ValueError, match="needs edge weights"):
        tw.prepare_weighted(carry(jg), device="cpu")
    with pytest.raises(ValueError, match="weights"):
        tw.prepare_weighted(carry(jg), w[:3], device="cpu")

    # a weighted dynamic graph brings its own lanes and content epoch
    dg = DynamicCSRGraph(carry(jg), weights=pt.w_edges)
    assert dg.insert_edges([9], [0], np.array([0.25], np.float32)) == 1
    pd = tw.prepare_weighted(dg, device="cpu")
    assert pd.epoch == dg.epoch == 1
    assert torch.equal(pd.graph.src, dg.view().src)
    np.testing.assert_array_equal(pd.w_edges.numpy(), dg.view_weights())


# --------------------------------------------------------------------------
# the batched engine against repro
# --------------------------------------------------------------------------

def run_both(jg, w, sources, **kw):
    rj = jw.weighted_apsp(jg, w, sources, config=jw.WeightedConfig(**kw))
    rt = tw.weighted_apsp(carry(jg), w, sources,
                          config=tw.WeightedConfig(**kw))
    return rj, rt


CASES = [(fam, cfg) for fam in sorted(FAMILIES) for cfg in CONFIGS]


@pytest.mark.parametrize("family,config", CASES)
def test_weighted_apsp_matches_jax(family, config):
    jg, w = weighted_family(family, seed=len(family))
    sources = np.arange(jg.n_nodes, dtype=np.int32)[::-1][
        : min(jg.n_nodes, 16)]
    rj, rt = run_both(jg, w, sources, source_batch=8, **CONFIGS[config])
    assert_same(rj, rt)
    for row, s in zip(rt.dist.numpy(), sources[:2]):
        np.testing.assert_allclose(row, jw.dijkstra_oracle(jg, w, int(s)),
                                   rtol=1e-5)


@pytest.mark.parametrize("s", [32, 128])
def test_frontier_stats_unreached_matches_jax(s):
    """The tropical switch's occupancy signal: ``unreached=isinf(dist)``
    in place of the boolean ``dist < 0``."""
    import jax.numpy as jnp
    jeng = importlib.import_module("repro.core.engine")
    teng = importlib.import_module("repro_torch.core.engine")
    rng = np.random.default_rng(s)
    n_pad, bs = 384, min(s, 128)
    for density in (0.0005, 0.01, 0.2):
        f = (rng.random((s, n_pad)) < density).astype(np.int8)
        d = np.where(rng.random((s, n_pad)) < 0.99, 1.5, np.inf) \
            .astype(np.float32)
        sj = jeng.frontier_stats(jnp.asarray(f), jnp.asarray(d), bs=bs,
                                 bn=128, bk=128,
                                 unreached=jnp.isinf(jnp.asarray(d)))
        dt = torch.from_numpy(d)
        st = teng.frontier_stats(torch.from_numpy(f), dt, bs=bs, bn=128,
                                 bk=128, unreached=torch.isinf(dt))
        for a, b in zip(sj, st):
            assert float(a) == float(b)


def test_dynamic_switch_takes_both_forms():
    """A graph and batch on which the tropical cost model picks both forms
    — the per-sweep choice (a strict >, ties to dense) must agree."""
    jg = jgen.mycielskian(9)
    w = np.random.default_rng(1).uniform(0.5, 4.0, jg.m_pad) \
        .astype(np.float32)
    rj, rt = run_both(jg, w, np.arange(16), source_batch=16,
                      use_kernel=True, dynamic=True)
    assert_same(rj, rt)
    assert (rt.direction_counts > 0).sum() == 2


def test_weighted_apsp_validates_sources_and_caches_operands():
    jg, w = weighted_family("random_ragged")
    pw = tw.prepare_weighted(carry(jg), w, device="cpu")
    cfg = tw.WeightedConfig(mode="sparse", source_batch=8)
    res = tw.weighted_apsp(pw, sources=[0, 5], config=cfg)
    assert res.dist.shape == (2, jg.n_nodes) and pw._wdense is None
    tw.weighted_apsp(pw, sources=[0], config=tw.WeightedConfig(
        mode="dense", source_batch=8))
    assert pw._wdense is not None
    with pytest.raises(ValueError, match="empty"):
        tw.weighted_apsp(pw, sources=[], config=cfg)
    with pytest.raises(ValueError, match="sources must be in"):
        tw.weighted_apsp(pw, sources=[jg.n_nodes], config=cfg)
    assert tw.WeightedConfig(max_steps=5).max_sweeps == 5
    assert tw.WeightedConfig(max_sweeps=7).max_steps == 7


@pytest.mark.parametrize("config", ["kernel_dense", "dynamic", "fused3",
                                    "fused_all"])
def test_cpu_prepared_weighted_graph_builds_no_index(config):
    """Whatever dense kernel can dispatch (K7 per sweep, the fused K8), a
    prepared weighted graph on the CPU never builds ``wdense_index``: the
    plain versions read none.  The results stay the JAX engine's."""
    jg, w = weighted_family("random_ragged", seed=2)
    sources = np.arange(min(jg.n_nodes, 16), dtype=np.int32)
    pw = tw.prepare_weighted(carry(jg), w, device="cpu")
    cfg = CONFIGS[config]
    rt = tw.weighted_apsp(pw, sources=sources,
                          config=tw.WeightedConfig(source_batch=8, **cfg))
    rj = jw.weighted_apsp(jg, w, sources,
                          config=jw.WeightedConfig(source_batch=8, **cfg))
    assert pw._wdense is not None and pw._wdense_index is None
    assert pw._relax_index is None
    assert_same(rj, rt)


@pytest.mark.parametrize("config", ["kernel_sparse", "dynamic",
                                    "calibrated"])
def test_cpu_prepared_weighted_graph_builds_no_relax_index(config):
    """Wherever the sparse relax kernel can dispatch (pinned, under the
    dynamic switch, or picked by calibration), a prepared weighted graph
    on the CPU never builds ``relax_index``: the plain version reads
    none.  The results stay the JAX engine's."""
    jg, w = weighted_family("random_ragged", seed=3)
    sources = np.arange(min(jg.n_nodes, 16), dtype=np.int32)
    pw = tw.prepare_weighted(carry(jg), w, device="cpu")
    cfg = {"kernel_sparse": dict(mode="sparse", use_kernel=True),
           "dynamic": CONFIGS["dynamic"],
           "calibrated": dict(use_kernel=True, dynamic=False)}[config]
    rt = tw.weighted_apsp(pw, sources=sources,
                          config=tw.WeightedConfig(source_batch=8, **cfg))
    assert pw._relax_index is None
    if config == "kernel_sparse":     # the sparse-only run: no dense operand
        assert pw._wdense is None
    if config != "calibrated":        # calibration times the CPU's clock
        rj = jw.weighted_apsp(jg, w, sources,
                              config=jw.WeightedConfig(source_batch=8, **cfg))
        assert_same(rj, rt)


def test_relax_index_built_once_from_the_lanes():
    """``relax_index`` is the in-lane index of the prepared lanes, built
    on first use and kept; it never builds the dense operand."""
    jg, w = weighted_family("duplicate_edges", seed=4)
    pw = tw.prepare_weighted(carry(jg), w, device="cpu")
    idx = pw.relax_index
    assert pw.relax_index is idx and pw._wdense is None
    want = tkern.in_lanes_ref(pw.graph.src, pw.graph.dst, pw.w_edges,
                              pw.n_pad, tkern.kernel.HUB_LANES)
    for a, b in zip(want, idx):
        assert torch.equal(a, b)
    assert int(idx.offsets[-1]) == jg.n_edges


# --------------------------------------------------------------------------
# single-source and bucketed drivers
# --------------------------------------------------------------------------

@pytest.mark.parametrize("family", ["path", "cycle", "random_ragged",
                                    "two_components"])
def test_minplus_sssp_matches_jax_and_dijkstra(family):
    jg, w = weighted_family(family, seed=7)
    tg = carry(jg)
    for s in (0, jg.n_nodes - 1):
        rj = jw.minplus_sssp(jg, w, s)
        rt = tw.minplus_sssp(tg, w, s)
        np.testing.assert_array_equal(np.asarray(rj.dist), rt.dist.numpy())
        assert int(rj.sweeps) == rt.sweeps
        np.testing.assert_allclose(rt.dist.numpy(),
                                   tw.dijkstra_oracle(tg, w, s), rtol=1e-5)


@pytest.mark.parametrize("family", ["path", "random_ragged", "clique"])
def test_bucketed_sssp_matches_jax_and_dijkstra(family):
    jg, _ = weighted_family(family)
    tg = carry(jg)
    wi = np.random.default_rng(3).integers(1, 5, jg.m_pad)
    eg_j = jw.expand_integer_weights(jg, wi)
    eg_t = tw.expand_integer_weights(tg, wi)
    for name in ARRAYS:
        np.testing.assert_array_equal(np.asarray(getattr(eg_j, name)),
                                      getattr(eg_t, name).numpy())
    rj = jw.bucketed_sssp(jg, wi, 0)
    rt = tw.bucketed_sssp(tg, wi, 0)
    np.testing.assert_array_equal(np.asarray(rj.dist), rt.dist.numpy())
    assert int(rj.sweeps) == rt.sweeps
    np.testing.assert_array_equal(rt.dist.numpy(),
                                  tw.dijkstra_oracle(tg, wi, 0))
    with pytest.raises(ValueError, match=">= 1"):
        tw.expand_integer_weights(tg, np.zeros(jg.m_pad, np.int64))


# --------------------------------------------------------------------------
# the facade
# --------------------------------------------------------------------------

@pytest.mark.parametrize("opts", [
    dict(mode="sparse", use_kernel=False),
    dict(use_kernel=True, dynamic=True, source_batch=32),
    dict(use_kernel=True, fused_steps=-1),
])
def test_facade_tropical_matches_repro(opts):
    jg = jgen.barabasi_albert(150, 3, seed=4)
    w = np.random.default_rng(4).uniform(0.5, 4.0, jg.m_pad) \
        .astype(np.float32)
    hj = repro.prepare(jg, weights=w, **opts)
    ht = repro_torch.prepare(carry(jg), weights=w, device="cpu", **opts)
    sources = [5, 0, 149, 77]
    rj = hj.apsp(sources, semiring="tropical")
    rt = ht.apsp(sources, semiring="tropical")
    assert_same(rj, rt)
    row = ht.sssp(42, semiring="tropical")
    assert row.dtype == torch.float32
    np.testing.assert_array_equal(hj.sssp(42, semiring="tropical"),
                                  row.numpy())
    assert ht.prepared_weighted() is ht.prepared_weighted()


def test_facade_tropical_needs_weights():
    tg = carry(jgen.barabasi_albert(50, 3, seed=1))
    h = repro_torch.prepare(tg, device="cpu", mode="sparse")
    with pytest.raises(ValueError, match="needs weights"):
        h.apsp([0], semiring="tropical")
    with pytest.raises(ValueError, match="needs weights"):
        h.prepared_weighted()


# --------------------------------------------------------------------------
# bench_weighted --quick: the hard field at pinned sparse
# --------------------------------------------------------------------------

def test_bench_weighted_quick_sweeps():
    """``benchmarks/bench_weighted.py --quick`` draws one
    ``default_rng(0)`` weight vector per family in its family order and
    runs 32 sources in one tile; BENCH_BASELINE.json records 64 sweeps on
    grid_road and 7 on mycielskian.  Pinned sparse here (the baseline's
    auto run chose sparse for every sweep)."""
    rng = np.random.default_rng(0)
    want = {"grid_road": (jgen.grid2d(32, 32), 64),
            "mycielskian": (jgen.mycielskian(9), 7)}
    for name, (jg, sweeps) in want.items():
        w = rng.uniform(0.5, 4.0, jg.m_pad).astype(np.float32)
        sources = np.arange(min(32, jg.n_nodes), dtype=np.int32)
        res = tw.weighted_apsp(carry(jg), w, sources,
                               config=tw.WeightedConfig(mode="sparse",
                                                        source_batch=32))
        assert res.sweeps == sweeps, name
        assert res.direction_counts.tolist() == [0, sweeps], name
