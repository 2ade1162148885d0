"""The port's graph container, generators and frontier packing against the
JAX package: every array bit-identical on the CPU."""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from oracles import adversarial_families
from repro.core import frontier as jfr
from repro.graph import generators as jgen
from repro.graph.csr import CSRGraph as JCSR
from repro_torch.convert import csr_from_arrays
from repro_torch.core import frontier as tfr
from repro_torch.graph import generators as tgen
from repro_torch.graph.csr import CSRGraph as TCSR

ARRAYS = ("indptr", "indices", "src", "dst", "indptr_t", "indices_t")
FAMILIES = {name: (src, dst, n) for name, src, dst, n in
            adversarial_families()}


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _same_graph(jg, tg):
    for name in ARRAYS:
        np.testing.assert_array_equal(np.asarray(getattr(jg, name)),
                                      getattr(tg, name).numpy(), name)
    assert (jg.n_nodes, jg.n_edges, jg.m_pad) == \
        (tg.n_nodes, tg.n_edges, tg.m_pad)


def _u32(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint32)


@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_csr_matches_jax_on_adversarial_families(name):
    src, dst, n = FAMILIES[name]
    jg = JCSR.from_edges(src, dst, n)
    tg = TCSR.from_edges(src, dst, n, device="cpu")
    _same_graph(jg, tg)
    n_pad = jg.n_padded()
    assert tg.n_padded() == n_pad and n_pad >= n + 1
    np.testing.assert_array_equal(np.asarray(jg.to_dense_padded(n_pad)),
                                  tg.to_dense_padded(n_pad).numpy())
    np.testing.assert_array_equal(np.asarray(jg.to_dense()),
                                  tg.to_dense().numpy())
    np.testing.assert_array_equal(np.asarray(jg.to_pull_packed(n_pad)),
                                  _u32(tg.to_pull_packed(n_pad)))
    _same_graph(jg.reverse(), tg.reverse())
    np.testing.assert_array_equal(np.asarray(jg.out_degrees()),
                                  tg.out_degrees().numpy())
    np.testing.assert_array_equal(np.asarray(jg.in_degrees()),
                                  tg.in_degrees().numpy())
    assert jg.degree_stats() == tg.degree_stats()
    for a, b in zip(jg.edge_arrays_np(), tg.edge_arrays_np()):
        np.testing.assert_array_equal(a, b)
    assert (jg.to_scipy() != tg.to_scipy()).nnz == 0


@pytest.mark.parametrize("dedup", [True, False])
def test_pull_packed_from_lanes_equals_dense_pack(dedup):
    """The port packs the pull operand straight from the CSR lanes; with
    parallel edges kept (dedup=False) every bit must still be set once."""
    src, dst, n = FAMILIES["duplicate_edges"]
    tg = TCSR.from_edges(src, dst, n, dedup=dedup, device="cpu")
    for n_pad in (tg.n_padded(), 256):
        dense = tg.to_dense_padded(n_pad)
        torch.testing.assert_close(tg.to_pull_packed(n_pad),
                                   tfr.pack_bits(dense.t() != 0),
                                   rtol=0, atol=0)


@pytest.mark.parametrize("make", [
    lambda gen, dev: gen.grid2d(7, 9, **dev),
    lambda gen, dev: gen.rmat(8, 4, directed=False, seed=1, **dev),
    lambda gen, dev: gen.rmat(7, 8, seed=2, **dev),
    lambda gen, dev: gen.watts_strogatz(150, 6, 0.1, seed=3, **dev),
    lambda gen, dev: gen.erdos_renyi(120, 3.0, directed=False, seed=5,
                                     **dev),
    lambda gen, dev: gen.barabasi_albert(90, 3, seed=6, **dev),
    lambda gen, dev: gen.disconnected(5, 20, 3.0, seed=7, **dev),
    lambda gen, dev: gen.mycielskian(6, **dev),
    lambda gen, dev: gen.bipartite_sessions(30, 40, 3, seed=8, **dev),
])
def test_generators_match_jax(make):
    _same_graph(make(jgen, {}), make(tgen, {"device": "cpu"}))


def test_generators_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("CUDA present: the default device resolves")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tgen.grid2d(4, 4)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TCSR.from_edges([0], [1], 2)


@pytest.mark.parametrize("shape", [(3, 70), (5, 64), (2, 33), (1, 1)])
def test_pack_unpack_popcount_match_jax(shape):
    rng = np.random.default_rng(sum(shape))
    x = rng.random(shape) < 0.4
    x[..., 31 % shape[-1]] = True             # bit 31 of word 0
    if shape[-1] > 63:
        x[..., 63] = True                     # bit 31 of word 1
    jp = np.asarray(jfr.pack_bits(jnp.asarray(x)))
    tp = tfr.pack_bits(torch.from_numpy(x))
    assert tp.dtype == torch.int32
    np.testing.assert_array_equal(jp, _u32(tp))
    np.testing.assert_array_equal(
        np.asarray(jfr.unpack_bits(jnp.asarray(jp), shape[-1])),
        tfr.unpack_bits(tp, shape[-1]).numpy())
    np.testing.assert_array_equal(np.asarray(jfr.popcount(jnp.asarray(jp))),
                                  tfr.popcount(tp).numpy())


def test_popcount_all_ones_word():
    words = torch.tensor([[-1, 0, -2147483648, 1]], dtype=torch.int32)
    assert tfr.popcount(words).tolist() == [32 + 1 + 1]
    j = np.asarray(jfr.popcount(jnp.asarray(
        words.numpy().view(np.uint32))))
    assert j.tolist() == [34]


def test_one_hot_frontier_matches_jax():
    srcs = np.array([3, 0, 9, 3])
    np.testing.assert_array_equal(
        np.asarray(jfr.one_hot_frontier(jnp.asarray(srcs), 11)),
        tfr.one_hot_frontier(torch.from_numpy(srcs), 11).numpy())
    assert tfr.UNREACHED == int(jfr.UNREACHED)


@pytest.mark.parametrize("name", ["random_ragged", "two_components"])
def test_csr_from_arrays_round_trip(name):
    src, dst, n = FAMILIES[name]
    jg = JCSR.from_edges(src, dst, n)
    tg = csr_from_arrays({k: np.asarray(getattr(jg, k)) for k in ARRAYS},
                         n_nodes=jg.n_nodes, n_edges=jg.n_edges,
                         m_pad=jg.m_pad, device="cpu")
    _same_graph(jg, tg)
    assert tg.device == torch.device("cpu")
    with pytest.raises(ValueError, match="missing"):
        csr_from_arrays({"indptr": np.asarray(jg.indptr)},
                        n_nodes=jg.n_nodes, n_edges=jg.n_edges,
                        m_pad=jg.m_pad, device="cpu")
    with pytest.raises(ValueError, match="shape"):
        csr_from_arrays({k: np.asarray(getattr(jg, k)) for k in ARRAYS},
                        n_nodes=jg.n_nodes, n_edges=jg.n_edges,
                        m_pad=jg.m_pad + 128, device="cpu")
