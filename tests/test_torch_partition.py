"""``repro_torch.graph.partition`` against ``repro.graph.partition``:
every array of ``block_dense``, ``edge_partition`` and
``edge_partition_global`` equal, with the same sentinel and padding rules
(``e_pad`` a multiple of 128 and at least 128, global ids with sentinel
n, +inf weights on padded lanes)."""
import numpy as np
import pytest
import torch

from repro.graph import generators as jgen
from repro.graph import partition as jpart
from repro_torch.convert import csr_from_arrays
from repro_torch.graph import partition as tpart

ARRAYS = ("indptr", "indices", "src", "dst", "indptr_t", "indices_t")

GRAPHS = {
    "rmat": lambda: jgen.rmat(7, 4, directed=False, seed=3),
    "er237": lambda: jgen.erdos_renyi(237, 3.0, seed=9),
    "grid": lambda: jgen.grid2d(9, 7),
}


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _pair(name):
    jg = GRAPHS[name]()
    tg = csr_from_arrays({k: np.asarray(getattr(jg, k)) for k in ARRAYS},
                         n_nodes=jg.n_nodes, n_edges=jg.n_edges,
                         m_pad=jg.m_pad, device="cpu")
    return jg, tg


@pytest.mark.parametrize("name", GRAPHS)
@pytest.mark.parametrize("blocks", [(1, 1), (2, 2), (1, 4), (4, 2)])
def test_block_dense_matches_jax(name, blocks):
    jg, tg = _pair(name)
    jt, jnb = jpart.block_dense(jg, *blocks)
    tt, tnb = tpart.block_dense(tg, *blocks)
    assert tnb == jnb and tt.dtype == torch.int8
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))


@pytest.mark.parametrize("name", GRAPHS)
@pytest.mark.parametrize("parts", [1, 2, 3, 8])
def test_edge_partitions_match_jax(name, parts):
    jg, tg = _pair(name)
    w = np.random.default_rng(parts).uniform(0.5, 4.0, jg.m_pad).astype(
        np.float32)
    j = jpart.edge_partition_global(jg, parts, weights=w)
    t = tpart.edge_partition_global(tg, parts, weights=torch.from_numpy(w))
    for k in ("e_pad", "n_parts", "n_nodes"):
        assert t[k] == j[k]
    assert t["e_pad"] % 128 == 0 and t["e_pad"] >= 128
    for k in ("src", "dst", "w"):
        assert t[k].device.type == "cpu"
        np.testing.assert_array_equal(t[k].numpy(), np.asarray(j[k]))
    # every real edge lands in exactly one part; padding is the sentinel
    real = t["src"] < tg.n_nodes
    assert int(real.sum()) == tg.n_edges
    assert torch.equal(t["dst"][~real],
                       torch.full_like(t["dst"][~real], tg.n_nodes))
    assert torch.isinf(t["w"][~real]).all()
    assert "w" not in tpart.edge_partition_global(tg, parts)
    jl = jpart.edge_partition(jg, parts)
    tl = tpart.edge_partition(tg, parts)
    assert (tl["n_local"], tl["n_parts"], tl["n_nodes"]) == \
        (jl["n_local"], jl["n_parts"], jl["n_nodes"])
    for k in ("src", "dst"):
        np.testing.assert_array_equal(tl[k].numpy(), np.asarray(jl[k]))
