"""The port's sampler, ``SUITE`` / ``configs.dawn`` and data builders
against the JAX package's.

  * ``_hop_from_draws`` fed JAX's own draws (``jax.random.randint`` of
    the key JAX's ``sample_hop`` takes, and the keys ``sample_subgraph``
    splits hop by hop) gives JAX's ids exactly, zero-degree nodes and the
    last node included.
  * Generator-driven samples (``torch.Generator``): every id of hop h+1 is
    an out-neighbour of its parent, or the parent itself where its degree
    is 0; the same seed gives the same sample.
  * ``SUITE`` and ``configs.dawn`` equal JAX's, graph by graph (the six CSR
    arrays exact).
  * ``full_graph_batch``, ``molecule_batch``, ``demo_graph``,
    ``sampled_batch`` (through ``_batch_from_layers`` on JAX's layers) and
    ``lm_batch`` / ``lm_iterator`` are byte-identical to JAX's.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import dawn as jdawn
from repro.data import graphs as jgraphs
from repro.data import tokens as jtokens
from repro.graph import generators as jgen
from repro.graph import sampler as jsampler
from repro_torch.configs import dawn as tdawn
from repro_torch.data import graphs as tgraphs
from repro_torch.data import tokens as ttokens
from repro_torch.graph import generators as tgen
from repro_torch.graph import sampler as tsampler

ARRAYS = ("indptr", "indices", "src", "dst", "indptr_t", "indices_t")
INT32_MAX = jnp.iinfo(jnp.int32).max


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def assert_same_graph(jg, tg):
    assert (tg.n_nodes, tg.n_edges, tg.m_pad) == \
        (jg.n_nodes, jg.n_edges, jg.m_pad)
    assert tg.device == torch.device("cpu")
    for k in ARRAYS:
        np.testing.assert_array_equal(np.asarray(getattr(jg, k)),
                                      getattr(tg, k).numpy(), err_msg=k)


def assert_same_bytes(a: dict, b: dict):
    assert sorted(a) == sorted(b)
    for k in a:
        x, y = np.asarray(a[k]), np.asarray(b[k])
        assert (x.dtype, x.shape) == (y.dtype, y.shape), k
        assert x.tobytes() == y.tobytes(), k


def _graphs():
    """A directed RMAT graph (zero out-degree nodes) and a disconnected
    one (isolated nodes), in both packages."""
    return {
        "rmat": (jgen.rmat(8, 4, directed=True, seed=9),
                 tgen.rmat(8, 4, directed=True, seed=9, device="cpu")),
        "disconnected": (jgen.disconnected(5, 30, 3.0, seed=2),
                         tgen.disconnected(5, 30, 3.0, seed=2,
                                           device="cpu")),
    }


@pytest.fixture(scope="module")
def graphs():
    return _graphs()


def _check_neighbors(tg, parents, children):
    """Each child an out-neighbour of its parent, or the parent itself
    where the parent has no out-edge."""
    indptr = tg.indptr.numpy()
    indices = tg.indices.numpy()
    parents = np.asarray(parents)
    children = np.asarray(children).reshape(len(parents), -1)
    for p, row in zip(parents, children):
        nbrs = indices[indptr[p]:indptr[p + 1]]
        if len(nbrs):
            assert np.isin(row, nbrs).all(), (p, row)
        else:
            assert (row == p).all(), (p, row)


@pytest.mark.parametrize("kind", ["rmat", "disconnected"])
@pytest.mark.parametrize("fanout", [1, 4, 25])
def test_hop_from_jax_draws_equals_sample_hop(graphs, kind, fanout):
    jg, tg = graphs[kind]
    rng = np.random.default_rng(fanout)
    nodes = np.concatenate([rng.integers(0, jg.n_nodes, 40),
                            [0, jg.n_nodes - 1, jg.n_nodes - 1]]) \
        .astype(np.int32)
    key = jax.random.PRNGKey(fanout + 100)
    want = np.asarray(jsampler.sample_hop(jg, jnp.asarray(nodes), key,
                                          fanout))
    r = np.array(jax.random.randint(key, (len(nodes), fanout), 0,
                                    INT32_MAX))
    got = tsampler._hop_from_draws(tg, torch.from_numpy(nodes),
                                   torch.from_numpy(r))
    assert got.dtype == torch.int32 and got.shape == (len(nodes), fanout)
    np.testing.assert_array_equal(got.numpy(), want)
    _check_neighbors(tg, nodes, got.numpy())


@pytest.mark.parametrize("fanouts", [(3,), (5, 2), (4, 3, 2)])
def test_subgraph_from_jax_keys_equals_sample_subgraph(graphs, fanouts):
    jg, tg = graphs["rmat"]
    seeds = np.arange(0, 240, 12, dtype=np.int32)
    key = jax.random.PRNGKey(7)
    want = jsampler.sample_subgraph(jg, jnp.asarray(seeds), key, fanouts)
    cur = torch.from_numpy(seeds)
    for h, f in enumerate(fanouts):
        key, sub = jax.random.split(key)
        r = np.array(jax.random.randint(sub, (cur.shape[0], f), 0,
                                        INT32_MAX))
        cur = tsampler._hop_from_draws(tg, cur, torch.from_numpy(r)) \
            .reshape(-1)
        np.testing.assert_array_equal(cur.numpy(), np.asarray(want[h + 1]))


@pytest.mark.parametrize("kind", ["rmat", "disconnected"])
def test_generator_samples_are_true_neighbors(graphs, kind):
    _, tg = graphs[kind]
    seeds = np.arange(0, tg.n_nodes, 7, dtype=np.int32)
    fanouts = (5, 3)
    layers = tsampler.sample_subgraph(
        tg, seeds, torch.Generator().manual_seed(3), fanouts)
    assert [l.shape[0] for l in layers] == [len(seeds), len(seeds) * 5,
                                            len(seeds) * 15]
    assert all(l.dtype == torch.int32 for l in layers)
    np.testing.assert_array_equal(layers[0].numpy(), seeds)
    for h in range(len(fanouts)):
        _check_neighbors(tg, layers[h].numpy(), layers[h + 1].numpy())
    again = tsampler.sample_subgraph(
        tg, seeds, torch.Generator().manual_seed(3), fanouts)
    for a, b in zip(layers, again):
        assert torch.equal(a, b)
    other = tsampler.sample_subgraph(
        tg, seeds, torch.Generator().manual_seed(4), fanouts)
    assert not torch.equal(layers[1], other[1])


def test_zero_degree_nodes_self_loop(graphs):
    _, tg = graphs["disconnected"]
    deg = tg.out_degrees().numpy()
    lonely = np.flatnonzero(deg == 0).astype(np.int32)
    assert len(lonely) >= 8                      # the isolated tail
    got = tsampler.sample_hop(tg, torch.from_numpy(lonely),
                              torch.Generator().manual_seed(0), 6)
    np.testing.assert_array_equal(got.numpy(),
                                  np.repeat(lonely[:, None], 6, axis=1))


@pytest.mark.parametrize("name", sorted(jdawn.GRAPH_SUITE))
def test_suite_matches_jax(name):
    assert sorted(tdawn.GRAPH_SUITE) == sorted(jdawn.GRAPH_SUITE)
    assert tdawn.GRAPH_SUITE is tgen.SUITE
    assert_same_graph(jdawn.GRAPH_SUITE[name](),
                      tdawn.GRAPH_SUITE[name](device="cpu"))


def test_configs_constants_match_jax():
    assert (tdawn.SOURCE_SET_SIZE, tdawn.REPEATS) == \
        (jdawn.SOURCE_SET_SIZE, jdawn.REPEATS) == (500, 64)


@pytest.mark.parametrize("geometry", [True, False])
def test_full_graph_batch_is_byte_identical(graphs, geometry):
    jg, tg = graphs["rmat"]
    assert_same_bytes(
        jgraphs.full_graph_batch(jg, d_feat=16, seed=3,
                                 with_geometry=geometry),
        tgraphs.full_graph_batch(tg, d_feat=16, seed=3,
                                 with_geometry=geometry))


def test_molecule_batch_is_byte_identical():
    assert_same_bytes(jgraphs.molecule_batch(batch=6, seed=4),
                      tgraphs.molecule_batch(batch=6, seed=4))


@pytest.mark.parametrize("kind", ["small", "reddit"])
def test_demo_graph_matches_jax(kind):
    assert_same_graph(jgraphs.demo_graph(kind, seed=1),
                      tgraphs.demo_graph(kind, seed=1, device="cpu"))
    with pytest.raises(ValueError):
        tgraphs.demo_graph("huge", device="cpu")


@pytest.mark.parametrize("fanouts", [(4,), (5, 2)])
def test_sampled_batch_from_jax_layers_is_byte_identical(graphs, fanouts):
    jg, tg = graphs["rmat"]
    seeds = np.array([3, 17, 40, 99, 200, 255], np.int32)
    want = jgraphs.sampled_batch(jg, seeds, fanouts, d_feat=8, seed=5)
    layers = jsampler.sample_subgraph(jg, jnp.asarray(seeds, jnp.int32),
                                      jax.random.PRNGKey(5), fanouts)
    got = tgraphs._batch_from_layers([np.asarray(l) for l in layers], seeds,
                                     fanouts, d_feat=8, n_classes=41, seed=5)
    assert_same_bytes(want, got)
    # the port's own draws: the same fields, shapes and dtypes; edges from
    # each child to its parent, the children true neighbours
    mine = tgraphs.sampled_batch(tg, seeds, fanouts, d_feat=8, seed=5)
    assert sorted(mine) == sorted(want)
    for k in want:
        assert (mine[k].dtype, mine[k].shape) == (want[k].dtype,
                                                  want[k].shape), k
    for k in ("src", "dst", "node_mask", "graph_id"):
        np.testing.assert_array_equal(mine[k], want[k])
    again = tgraphs.sampled_batch(tg, seeds, fanouts, d_feat=8, seed=5)
    assert_same_bytes(mine, again)


@pytest.mark.parametrize("step", [0, 1, 17])
@pytest.mark.parametrize("shape", [(4, 16, 97), (3, 1, 50)])
def test_lm_batch_is_byte_identical(step, shape):
    b, s, v = shape
    assert_same_bytes(
        jtokens.lm_batch(step, global_batch=b, seq_len=s, vocab=v, seed=2),
        ttokens.lm_batch(step, global_batch=b, seq_len=s, vocab=v, seed=2))


def test_lm_iterator_is_byte_identical():
    kw = dict(global_batch=2, seq_len=8, vocab=64, seed=1, start_step=5)
    j, t = jtokens.lm_iterator(**kw), ttokens.lm_iterator(**kw)
    for _ in range(4):
        assert_same_bytes(next(j), next(t))
