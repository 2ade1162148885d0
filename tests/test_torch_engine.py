"""The port's boolean engine against the JAX engine on the same graph:
``dist``, ``sweeps``, ``direction_counts`` and ``edges_touched``
bit-identical on the CPU, in every pinned mode, under the dynamic switch
and on the kernel path with and without fused blocks (the JAX kernels
in interpret mode, the port's wrappers on their plain versions)."""
import json
import pathlib

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from oracles import adversarial_families, bfs_dists
from repro.core import engine as jeng
from repro.core import sweep as jsweep
from repro.graph import generators as jgen
from repro.graph.csr import CSRGraph as JCSR
from repro_torch.convert import csr_from_arrays
from repro_torch.core import engine as teng
from repro_torch.core import sweep as tsweep
from repro_torch.graph import generators as tgen

ROOT = pathlib.Path(__file__).resolve().parent.parent
ARRAYS = ("indptr", "indices", "src", "dst", "indptr_t", "indices_t")
FAMILIES = {name: (src, dst, n) for name, src, dst, n in
            adversarial_families()}

CONFIGS = {
    "push": dict(mode="push", use_kernel=False),
    "pull": dict(mode="pull", use_kernel=False),
    "sparse": dict(mode="sparse", use_kernel=False),
    "dynamic": dict(use_kernel=True),
    "kernel_pull": dict(mode="pull", use_kernel=True),
    "fused0": dict(mode="push", use_kernel=True, fused_steps=0),
    "fused3": dict(mode="push", use_kernel=True, fused_steps=3),
    "fused_all": dict(use_kernel=True, fused_steps=-1),
}
# the kernel-path configs that run the Pallas kernels in interpret mode
# on every family; the rest run on a ragged subset to bound the time
EVERY_FAMILY = ("push", "pull", "sparse", "dynamic", "fused_all")
SUBSET = ("random_ragged", "path", "two_components", "clique")


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def carry(jg):
    """The JAX graph's lanes, carried across to the port (CPU)."""
    return csr_from_arrays({k: np.asarray(getattr(jg, k)) for k in ARRAYS},
                           n_nodes=jg.n_nodes, n_edges=jg.n_edges,
                           m_pad=jg.m_pad, device="cpu")


def run_both(jg, sources, **kw):
    rj = jeng.apsp_engine(jg, sources, config=jeng.EngineConfig(**kw))
    rt = teng.apsp_engine(teng.prepare_graph(carry(jg), device="cpu"),
                          sources, config=teng.EngineConfig(**kw))
    return rj, rt


def assert_same(rj, rt):
    np.testing.assert_array_equal(np.asarray(rj.dist), rt.dist.numpy())
    assert int(rj.sweeps) == rt.sweeps
    np.testing.assert_array_equal(np.asarray(rj.direction_counts),
                                  rt.direction_counts.numpy())
    # f32 running sums of integer degrees: exact below 2^24 on both sides
    assert np.float32(rj.edges_touched).tobytes() == \
        rt.edges_touched.numpy().astype(np.float32).tobytes()


CASES = [(fam, cfg) for fam in sorted(FAMILIES) for cfg in CONFIGS
         if cfg in EVERY_FAMILY or fam in SUBSET]


@pytest.mark.parametrize("family,config", CASES)
def test_engine_matches_jax(family, config):
    src, dst, n = FAMILIES[family]
    jg = JCSR.from_edges(src, dst, n)
    sources = np.arange(n, dtype=np.int32)[::-1][: min(n, 40)]
    rj, rt = run_both(jg, sources, source_batch=32, **CONFIGS[config])
    assert_same(rj, rt)
    np.testing.assert_array_equal(rt.dist.numpy(),
                                  bfs_dists(jg, sources))


def test_dynamic_switch_visits_every_form():
    """A graph and batch on which the cost model picks more than one form
    — the per-sweep choice itself is what must agree."""
    jg = jgen.watts_strogatz(200, 6, 0.1, seed=3)
    rj, rt = run_both(jg, np.arange(0, 200, 7), source_batch=32,
                      use_kernel=True)
    assert_same(rj, rt)
    assert (rt.direction_counts > 0).sum() >= 2


@pytest.mark.parametrize("s", [8, 32, 128])
def test_cost_model_matches_jax(s):
    rng = np.random.default_rng(s)
    n_pad, bs = 256, min(s, 128)
    cfg_j, cfg_t = jeng.EngineConfig(), teng.EngineConfig()
    for density in (0.0005, 0.01, 0.2):
        f = (rng.random((s, n_pad)) < density).astype(np.int8)
        d = np.where(rng.random((s, n_pad)) < 0.5, 1, -1).astype(np.int32)
        sj = jeng.frontier_stats(jnp.asarray(f), jnp.asarray(d), bs=bs,
                                 bn=128, bk=128)
        st = teng.frontier_stats(torch.from_numpy(f), torch.from_numpy(d),
                                 bs=bs, bn=128, bk=128)
        cj = jeng.sweep_costs(sj, n_pad=n_pad, s=s, m_pad=1024, cfg=cfg_j)
        ct = teng.sweep_costs(st, n_pad=n_pad, s=s, m_pad=1024, cfg=cfg_t)
        np.testing.assert_array_equal(np.asarray(cj), ct.numpy())
        assert int(jeng.choose_direction(sj, n_pad=n_pad, s=s, m_pad=1024,
                                         cfg=cfg_j)) == \
            teng.choose_direction(st, n_pad=n_pad, s=s, m_pad=1024,
                                  cfg=cfg_t)


SETTLE_GRAPHS = {
    "ws": lambda: tgen.watts_strogatz(200, 6, 0.1, seed=3, device="cpu"),
    "grid": lambda: tgen.grid2d(12, 12, device="cpu"),
}


def index_batch(g, s):
    """The prepared graph and ``run(cfg, indexed, forced_dir)``: a call of
    ``_run_batch`` on ``s`` source rows of ``g``, given the packed
    operand's live-word index as the card's kernel path is (the plain
    versions read it here) or given none."""
    pg = teng.prepare_graph(g, device="cpu")
    valid = min(s, g.n_nodes)
    padded = torch.zeros(s, dtype=torch.int64)
    padded[:valid] = torch.arange(valid) * (g.n_nodes // valid)

    def run(cfg, indexed=True, forced_dir=None):
        return teng._run_batch(
            None, pg.adj_pull, g.src, g.dst, pg.deg, padded, valid,
            cfg=cfg, n_real=g.n_nodes, n_pad=pg.n_pad, max_steps=g.n_nodes,
            use_kernel=True, forced_dir=forced_dir,
            index=pg.adj_pull_index if indexed else None)
    return pg, run


def counting_stats(monkeypatch):
    """Patch ``frontier_stats`` to keep every statistic it returns."""
    seen = []
    stats_of = teng.frontier_stats
    monkeypatch.setattr(teng, "frontier_stats",
                        lambda *a, **k: seen.append(stats_of(*a, **k))
                        or seen[-1])
    return seen


def assert_same_run(a, b):
    assert torch.equal(a.dist, b.dist)
    assert (a.step, a.sweeps) == (b.step, b.sweeps)
    assert list(a.dir_counts) == list(b.dir_counts)
    assert a.edges_touched.numpy().tobytes() == \
        b.edges_touched.numpy().tobytes()


def assert_settled(monkeypatch, g, s, cfg):
    """The batch given the index runs no per-sweep statistics and pushes
    every sweep: the rows, sweeps, forms and ``edges_touched`` of the same
    tile pinned to push without the index."""
    _, run = index_batch(g, s)
    seen = counting_stats(monkeypatch)
    indexed = run(cfg)
    assert seen == []
    assert_same_run(indexed, run(cfg, indexed=False, forced_dir=tsweep.PUSH))
    assert indexed.step > 1
    assert list(indexed.dir_counts) == [indexed.step, 0, 0]


@pytest.mark.parametrize("s", [1, 32, 128])
@pytest.mark.parametrize("family", sorted(SETTLE_GRAPHS))
def test_index_priced_batch_settles_push_once(family, s, monkeypatch):
    """With the index and the default constants the tile's form is
    settled to push before its first sweep."""
    assert_settled(monkeypatch, SETTLE_GRAPHS[family](), s,
                   teng.EngineConfig(use_kernel=True))


@pytest.mark.parametrize("constants", ["default", "exact_tie",
                                       "costly_index"])
def test_the_indexed_tile_pushes_whatever_the_constants(constants,
                                                        monkeypatch):
    """The cost constants price no form where the forms read the index:
    the default ones, ones whose float32 push and sparse prices of an
    index entry tie, and a ``c_pull`` that prices an entry above the
    sparse form (a tuned plan's constants may) all push every sweep."""
    g = SETTLE_GRAPHS["ws"]()
    s = 32
    live = teng.prepare_graph(g, device="cpu").adj_pull_index.words.numel()
    cfg = teng.EngineConfig(use_kernel=True, **{
        "default": {},
        "exact_tie": dict(c_pull=float(s * g.m_pad),
                          c_sparse=float(-(-s // 32) * live)),
        "costly_index": dict(c_pull=2 * 8.0 * s * g.m_pad
                             / (-(-s // 32) * live)),
    }[constants])
    assert_settled(monkeypatch, g, s, cfg)


@pytest.mark.parametrize("family", ["random_ragged", "duplicate_edges",
                                    "star_in"])
def test_derive_parents_matches_jax(family):
    src, dst, n = FAMILIES[family]
    jg = JCSR.from_edges(src, dst, n)
    sources = np.arange(n, dtype=np.int32)
    dist = np.array(jeng.apsp_engine(
        jg, sources, config=jeng.EngineConfig(mode="sparse")).dist)
    want = np.asarray(jsweep.derive_parents(jg, jnp.asarray(dist)))
    got = tsweep.derive_parents(carry(jg), torch.from_numpy(dist))
    np.testing.assert_array_equal(want, got.numpy())
    # one row, 1-D
    np.testing.assert_array_equal(
        want[1], tsweep.derive_parents(carry(jg),
                                       torch.from_numpy(dist[1])).numpy())


def test_sparse_parent_tracking_matches_jax():
    src, dst, n = FAMILIES["random_ragged"]
    jg = JCSR.from_edges(src, dst, n)
    tg = carry(jg)
    n_pad = jg.n_padded()
    rng = np.random.default_rng(1)
    f, d = ((rng.random((16, n_pad)) < 0.1).astype(np.int8),
            np.where(rng.random((16, n_pad)) < 0.3, 1, -1).astype(np.int32))
    p = np.full((16, n_pad), -1, np.int32)
    sj = jsweep.boolean_forms(None, None, jg.src, jg.dst, n_pad=n_pad,
                              s=16, track_parent=True)[2]
    st = tsweep.boolean_forms(None, None, tg.src, tg.dst, n_pad=n_pad,
                              s=16, track_parent=True)[2]
    want = sj(jnp.asarray(f), jnp.asarray(d), jnp.asarray(p), 2)
    got = st(torch.from_numpy(f), torch.from_numpy(d), torch.from_numpy(p),
             2)
    for a, b in zip(want, got):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


QUICK = {
    "grid_road": lambda gen, dev: gen.grid2d(32, 32, **dev),
    "ws_citation": lambda gen, dev: gen.watts_strogatz(1024, 8, 0.05,
                                                       seed=3, **dev),
    "mycielskian": lambda gen, dev: gen.mycielskian(9, **dev),
}


@pytest.mark.parametrize("family", sorted(QUICK))
def test_bench_apsp_quick_sweeps(family):
    """The hard fields of ``bench_apsp --quick`` at 64 sources: the port
    takes the recorded sweep counts (63, 11, 5), per sweep and fused."""
    base = json.loads((ROOT / "benchmarks" / "BENCH_BASELINE.json")
                      .read_text())["bench_apsp"]["families"][family]
    g = QUICK[family](tgen, {"device": "cpu"})
    assert (g.n_nodes, g.n_edges) == (base["n_nodes"], base["n_edges"])
    pg = teng.prepare_graph(g, device="cpu")
    sources = np.arange(64, dtype=np.int32)
    per_sweep = teng.apsp_engine(pg, sources, config=teng.EngineConfig(
        mode="sparse", source_batch=64))
    fused = teng.apsp_engine(pg, sources, config=teng.EngineConfig(
        mode="push", source_batch=64, use_kernel=True, fused_steps=-1))
    assert per_sweep.sweeps == base["sweeps"]
    assert fused.sweeps == base["sweeps_fused"] == base["sweeps"]
    assert torch.equal(per_sweep.dist, fused.dist)


def test_adj_pull_index_built_once_and_reused(monkeypatch):
    """The packed operand's live-word index is built once per prepared
    graph and then reused.  On the CPU the engine never builds it, on any
    path (the plain K1 / K2 versions take none), and its results stay
    those of the JAX engine."""
    from repro_torch.kernels.bovm import ref as bref
    calls = []
    build = bref.packed_live_words_ref
    monkeypatch.setattr(bref, "packed_live_words_ref",
                        lambda at: calls.append(1) or build(at))
    src, dst, n = FAMILIES["random_ragged"]
    jg = JCSR.from_edges(src, dst, n)
    pg = teng.prepare_graph(carry(jg), device="cpu")
    sources = np.arange(n, dtype=np.int32)[:40]
    for kw in (dict(mode="sparse"), dict(mode="push", fused_steps=-1),
               dict(mode="auto", dynamic=False)):
        teng.apsp_engine(pg, sources, config=teng.EngineConfig(
            use_kernel=True, source_batch=32, **kw))
    for mode in ("push", "pull"):
        kw = dict(mode=mode, use_kernel=True, source_batch=32)
        rt = teng.apsp_engine(pg, sources, config=teng.EngineConfig(**kw))
        rj = jeng.apsp_engine(jg, sources, config=jeng.EngineConfig(**kw))
        assert_same(rj, rt)
    assert calls == [] and pg._adj_pull_index is None
    assert pg.adj_pull_index is pg.adj_pull_index
    assert calls == [1]
    assert torch.equal(pg.adj_pull_index.values,
                       build(pg.adj_pull).values)


def test_engine_blocks_stream_and_validate():
    g = tgen.grid2d(6, 6, device="cpu")
    blocks = list(teng.apsp_engine_blocks(g, range(20),
                                          config=teng.EngineConfig(
                                              source_batch=8)))
    assert [len(b) for b, _, _ in blocks] == [8, 8, 4]
    assert all(d.shape == (len(b), 36) for b, d, _ in blocks)
    with pytest.raises(ValueError, match="empty"):
        teng.apsp_engine(g, [])
    with pytest.raises(ValueError, match="sources must be in"):
        teng.apsp_engine(g, [36])
