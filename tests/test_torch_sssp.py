"""The port's single- and multi-source drivers against ``repro`` on the
CPU: ``sssp``, ``multi_source``, ``apsp`` and ``apsp_dense`` for each
method (auto, bovm, sovm), and the low-level ``bovm_msbfs``,
``sovm_msbfs`` and ``reconstruct_path`` — ``dist``, ``parent``,
``eccentricity`` and ``edges_touched`` bit-identical."""
import importlib

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from oracles import adversarial_families, bfs_dists
from repro.core import bovm as jbovm
from repro.core import sovm as jsovm
from repro.graph import generators as jgen
from repro.graph.csr import CSRGraph as JCSR
from repro_torch.convert import csr_from_arrays
from repro_torch.core import bovm as tbovm
from repro_torch.core import sovm as tsovm

# the packages re-export the ``sssp`` function over the module's name
jsssp = importlib.import_module("repro.core.sssp")
tsssp = importlib.import_module("repro_torch.core.sssp")

ARRAYS = ("indptr", "indices", "src", "dst", "indptr_t", "indices_t")
FAMILIES = {name: (src, dst, n) for name, src, dst, n in
            adversarial_families()}
METHODS = ("auto", "bovm", "sovm")


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


def assert_same(rj, rt):
    np.testing.assert_array_equal(np.asarray(rj.dist), rt.dist.numpy())
    assert int(rj.eccentricity) == int(rt.eccentricity)
    assert np.float32(rj.edges_touched) == \
        np.float32(rt.edges_touched.numpy())
    if rj.parent is None:
        assert rt.parent is None
    else:
        np.testing.assert_array_equal(np.asarray(rj.parent),
                                      rt.parent.numpy())


@pytest.mark.parametrize("family", ["random_ragged", "path",
                                    "two_components"])
@pytest.mark.parametrize("method", METHODS)
def test_sssp_matches_jax(family, method):
    src, dst, n = FAMILIES[family]
    jg = JCSR.from_edges(src, dst, n)
    tg = carry(jg)
    for source in (0, n - 1):
        assert_same(jsssp.sssp(jg, source, method=method),
                    tsssp.sssp(tg, source, method=method))


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("parents", [True, False])
def test_multi_source_matches_jax(method, parents):
    jg = jgen.watts_strogatz(90, 4, 0.1, seed=2)
    tg = carry(jg)
    sources = [3, 0, 89, 41, 41]
    rj = jsssp.multi_source(jg, sources, method=method, parents=parents)
    rt = tsssp.multi_source(tg, sources, method=method, parents=parents)
    assert_same(rj, rt)
    np.testing.assert_array_equal(rt.dist.numpy(), bfs_dists(jg, sources))


@pytest.mark.parametrize("method", METHODS)
def test_apsp_blocks_and_dense_match_jax(method):
    jg = jgen.grid2d(6, 7)
    tg = carry(jg)
    want = jsssp.apsp_dense(jg, block=16, method=method)
    got = tsssp.apsp_dense(tg, block=16, method=method)
    np.testing.assert_array_equal(want, got)
    blocks = list(tsssp.apsp(tg, block=16, method=method))
    assert [len(s) for s, _ in blocks] == [16, 16, 10]
    np.testing.assert_array_equal(blocks[2][0], np.arange(32, 42))


def test_bovm_msbfs_matches_jax():
    jg = jgen.erdos_renyi(70, 3.0, seed=5)
    tg = carry(jg)
    sources = np.array([0, 5, 69], np.int32)
    sj = jbovm.bovm_msbfs(jg.to_dense(), jnp.asarray(sources))
    st = tbovm.bovm_msbfs(tg.to_dense(), sources)
    np.testing.assert_array_equal(np.asarray(sj.dist), st.dist.numpy())
    np.testing.assert_array_equal(np.asarray(sj.frontier),
                                  st.frontier.numpy())
    assert (int(sj.step), bool(sj.done)) == (st.step, st.done)
    assert np.float32(sj.edges_touched) == np.float32(st.edges_touched)
    one = tbovm.bovm_sssp(tg.to_dense(), 5)
    np.testing.assert_array_equal(one.dist.numpy(), st.dist[1].numpy())
    visited = st.dist >= 0
    new = tbovm.bovm_sweep(tg.to_dense(), st.frontier != 0, visited)
    np.testing.assert_array_equal(
        new.numpy(), np.asarray(jbovm.bovm_sweep(
            jg.to_dense(), jnp.asarray(st.frontier.numpy() != 0),
            jnp.asarray(visited.numpy()))))


def test_sovm_msbfs_matches_jax_per_source():
    src, dst, n = FAMILIES["random_ragged"]
    jg = JCSR.from_edges(src, dst, n)
    tg = carry(jg)
    sources = np.array([0, 7, 136, 7], np.int32)
    sj = jsovm.sovm_msbfs(jg, jnp.asarray(sources))
    st = tsovm.sovm_msbfs(tg, sources)
    for name in ("frontier", "dist", "parent", "step", "done",
                 "edges_touched", "sweeps"):
        np.testing.assert_array_equal(np.asarray(getattr(sj, name)),
                                      getattr(st, name).numpy(),
                                      err_msg=name)
    f = torch.zeros(n + 1, dtype=torch.int8)
    f[0] = 1
    d = torch.full((n + 1,), -1, dtype=torch.int32)
    d[0] = 0
    d[n] = 0
    new_j, p_j = jsovm.sovm_sweep(jg, jnp.asarray(f.numpy()),
                                  jnp.asarray(d.numpy()))
    new_t, p_t = tsovm.sovm_sweep(tg, f, d)
    np.testing.assert_array_equal(np.asarray(new_j), new_t.numpy())
    np.testing.assert_array_equal(np.asarray(p_j), p_t.numpy())


def test_reconstruct_path_matches_jax():
    jg = jgen.grid2d(5, 5)
    tg = carry(jg)
    r = tsssp.sssp(tg, 0, method="sovm")
    for target in (24, 12, 0):
        want = jsovm.reconstruct_path(
            np.asarray(jsssp.sssp(jg, 0, method="sovm").parent), 0,
            target, 25)
        got = tsovm.reconstruct_path(r.parent, 0, target, 25)
        assert got == want
        assert got[0] == 0 and got[-1] == target
        assert len(got) == int(r.dist[target]) + 1
    # a target outside the source's tree
    dj = JCSR.from_edges(np.array([0, 2]), np.array([1, 3]), 4)
    par = tsssp.sssp(carry(dj), 0, method="sovm").parent
    assert tsovm.reconstruct_path(par, 0, 3, 4) is None
    assert jsovm.reconstruct_path(np.asarray(
        jsssp.sssp(dj, 0, method="sovm").parent), 0, 3, 4) is None


def test_unknown_method_raises():
    tg = carry(jgen.grid2d(3, 3))
    with pytest.raises(ValueError, match="unknown method"):
        tsssp.sssp(tg, 0, method="dijkstra")
    with pytest.raises(ValueError, match="unknown method"):
        tsssp.multi_source(tg, [0], method="dijkstra")
