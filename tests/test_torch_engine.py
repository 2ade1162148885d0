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


@pytest.mark.parametrize("s", [32, 128])
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
