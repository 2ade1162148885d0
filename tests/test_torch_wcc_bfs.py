"""The port's low-level boolean paths against the JAX package: weakly
connected components (``core/wcc.py`` over ``minlabel_form``), the BFS
baselines (``core/bfs.py``), the full-BFS kernel drivers
(``kernels/bovm/ops.py``: K4 and K2 in the loop, their plain versions on
the CPU against the JAX kernels in interpret mode, at n <= 256 and batch
<= 8), ``CSRGraph.memory_bytes`` and the semiring tables.  Every
comparison is exact (int32 labels and hop counts)."""
import importlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from repro.core import bfs as jbfs
from repro.core import sweep as jsweep
from repro.core.centrality import COUNTING_FORM_NAMES as J_COUNTING_NAMES
from repro.graph import generators as jgen
from repro.graph.csr import CSRGraph as JCSRGraph
from repro.kernels.bovm import ops as jops
import repro_torch.core as tcore
from repro_torch.convert import csr_from_arrays
from repro_torch.core import bfs as tbfs
from repro_torch.core import sweep as tsweep
from repro_torch.kernels.bovm import ops as tops

from oracles import adversarial_families

# the packages' ``core`` exports a function ``wcc`` that shadows the module
jwcc = importlib.import_module("repro.core.wcc")
twcc = importlib.import_module("repro_torch.core.wcc")

ARRAYS = ("indptr", "indices", "src", "dst", "indptr_t", "indices_t")


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


def _graphs():
    out = [(name, JCSRGraph.from_edges(src, dst, n))
           for name, src, dst, n in adversarial_families(seed=3)]
    out += [("rmat", jgen.rmat(7, 4, seed=2)),
            ("grid", jgen.grid2d(9, 11)),
            ("ws", jgen.watts_strogatz(150, 4, 0.1, seed=1))]
    return out


GRAPHS = _graphs()
IDS = [name for name, _ in GRAPHS]


@pytest.mark.parametrize("name,jg", GRAPHS, ids=IDS)
def test_wcc_matches_reference(name, jg):
    tg = _port(jg)
    jr, tr = jwcc.wcc(jg), twcc.wcc(tg)
    np.testing.assert_array_equal(np.asarray(jr.labels), tr.labels.numpy())
    assert int(jr.iters) == tr.iters
    assert tr.labels.dtype == torch.int32
    # a hop bound stops the loop early, identically
    jr, tr = jwcc.wcc(jg, max_iters=1), twcc.wcc(tg, max_iters=1)
    np.testing.assert_array_equal(np.asarray(jr.labels), tr.labels.numpy())
    assert int(jr.iters) == tr.iters == 1


@pytest.mark.parametrize("name,jg", GRAPHS[-4:], ids=IDS[-4:])
def test_wcc_stats_matches_reference(name, jg):
    js, ts = jwcc.wcc_stats(jg), twcc.wcc_stats(_port(jg))
    np.testing.assert_array_equal(js["labels"], ts["labels"])
    for key in ("S_wcc", "E_wcc", "n_components"):
        assert js[key] == ts[key], key
    for i in (0, jg.n_nodes // 2, jg.n_nodes - 1):
        assert js["S_wcc_of"](i) == ts["S_wcc_of"](i)
        assert js["E_wcc_of"](i) == ts["E_wcc_of"](i)


@pytest.mark.parametrize("name,jg", GRAPHS, ids=IDS)
def test_bfs_baselines_match_reference(name, jg):
    tg = _port(jg)
    for source in sorted({0, jg.n_nodes // 3, jg.n_nodes - 1}):
        want = jbfs.bfs_queue_numpy(jg, source)
        np.testing.assert_array_equal(tbfs.bfs_queue_numpy(tg, source), want)
        np.testing.assert_array_equal(tbfs.bfs_scipy(tg, source),
                                      jbfs.bfs_scipy(jg, source))
        js = jbfs.bfs_level_sync_jax(jg, source)
        ts = tbfs.bfs_level_sync_torch(tg, source)
        np.testing.assert_array_equal(np.asarray(js.dist), ts.dist.numpy())
        np.testing.assert_array_equal(ts.dist.numpy(), want)
        assert (int(js.step), bool(js.done)) == (ts.step, ts.done)
    js = jbfs.bfs_level_sync_jax(jg, 0, max_steps=2)
    ts = tbfs.bfs_level_sync_torch(tg, 0, max_steps=2)
    np.testing.assert_array_equal(np.asarray(js.dist), ts.dist.numpy())
    assert (int(js.step), bool(js.done)) == (ts.step, ts.done)


@pytest.mark.parametrize("name,jg", [
    ("ws", jgen.watts_strogatz(255, 6, 0.1, seed=5)),
    ("grid", jgen.grid2d(15, 17)),
    ("two_components", GRAPHS[5][1]),
], ids=["ws", "grid", "two_components"])
def test_msbfs_drivers_match_reference(name, jg):
    n = 256
    sources = np.array([0, 3, 7, 11, 17, 19, 23, 29]) % jg.n_nodes
    jadj = jg.to_dense_padded(n)
    tadj = _port(jg).to_dense_padded(n)
    np.testing.assert_array_equal(np.asarray(jadj), tadj.numpy())
    jsrc, tsrc = jnp.asarray(sources, jnp.int32), torch.from_numpy(sources)
    jr = jops.msbfs_kernel(jadj, jsrc, max_steps=n, interpret=True, bs=8,
                           bn=128, bk=128)
    tr = tops.msbfs_kernel(tadj, tsrc, max_steps=n, interpret=True, bs=8,
                           bn=128, bk=128)
    np.testing.assert_array_equal(np.asarray(jr.dist), tr.dist.numpy())
    assert int(jr.sweeps) == tr.sweeps
    jp, tp = jops.pack_adjacency_pull(jadj), tops.pack_adjacency_pull(tadj)
    np.testing.assert_array_equal(np.asarray(jp).view(np.int32), tp.numpy())
    jr = jops.msbfs_packed(jp, jsrc, n, max_steps=n, interpret=True, bs=8,
                           bn=128, wk=8)
    tr2 = tops.msbfs_packed(tp, tsrc, n, max_steps=n, interpret=True, bs=8,
                            bn=128, wk=8)
    np.testing.assert_array_equal(np.asarray(jr.dist), tr2.dist.numpy())
    assert int(jr.sweeps) == tr2.sweeps == tr.sweeps
    # a hop bound stops both drivers early
    tr3 = tops.msbfs_packed(tp, tsrc, n, max_steps=2, bs=8, wk=8)
    assert tr3.sweeps == min(2, tr.sweeps)


def test_single_sweep_matches_reference():
    jg = jgen.erdos_renyi(255, 4.0, seed=8)
    n = 256
    jadj, tadj = jg.to_dense_padded(n), _port(jg).to_dense_padded(n)
    rng = np.random.default_rng(0)
    f = (rng.random((8, n)) < 0.1).astype(np.int8)
    d = np.where(rng.random((8, n)) < 0.3, 1, -1).astype(np.int32)
    for tiles in (dict(bs=8, bn=128, bk=128), dict(bs=16)):
        jr = jops.sweep(jnp.asarray(f), jadj, jnp.asarray(d), 2,
                        interpret=True, **tiles)
        tr = tops.sweep(torch.from_numpy(f), tadj, torch.from_numpy(d), 2,
                        **tiles)
        for a, b in zip(jr, tr):
            np.testing.assert_array_equal(np.asarray(a), b.numpy())


def test_minlabel_form_matches_reference():
    jg = jgen.rmat(6, 3, seed=4)
    tg = _port(jg)
    labels = np.random.default_rng(1).permutation(jg.n_nodes + 1) \
        .astype(np.int32)
    jf = jsweep.minlabel_form(jg.src, jg.dst)
    tf = tsweep.minlabel_form(tg.src, tg.dst)
    jn, jl, _ = jf(None, jnp.asarray(labels), None, 1)
    tn, tl, _ = tf(None, torch.from_numpy(labels), None, 1)
    np.testing.assert_array_equal(np.asarray(jl), tl.numpy())
    np.testing.assert_array_equal(np.asarray(jn), tn.numpy())
    assert tn.dtype == torch.int8


@pytest.mark.parametrize("name,jg", GRAPHS[-3:], ids=IDS[-3:])
def test_memory_bytes_matches_reference(name, jg):
    tg = _port(jg)
    for flag in (True, False):
        assert tg.memory_bytes(boolean_frontier=flag) == \
            jg.memory_bytes(boolean_frontier=flag)


def test_semiring_tables_match_reference():
    assert tcore.COUNTING_FORM_NAMES == J_COUNTING_NAMES
    assert tuple(tcore.SEMIRINGS) == tuple(jsweep.SEMIRINGS)
    for name, js in jsweep.SEMIRINGS.items():
        ts = tcore.SEMIRINGS[name]
        assert (ts.name, ts.unreached, ts.source_dist) == \
            (js.name, js.unreached, js.source_dist), name
    assert tcore.MIN_LABEL is tcore.SEMIRINGS["min_label"]
    for name in ("wcc", "wcc_stats", "WccResult", "minlabel_form",
                 "bfs_queue_numpy", "bfs_scipy", "bfs_level_sync_torch",
                 "IncrementalSSSP", "repair", "sssp_state"):
        assert hasattr(tcore, name), name
