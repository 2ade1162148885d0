"""The port's counting semiring against the JAX package on the CPU: the two
counting kernels' plain versions (through the port's wrappers, on CPU
tensors) against the Pallas kernels in interpret mode, the push form
against the sparse form, and the counting engine's ``dist``, ``sigma``,
``sweeps`` and ``direction_counts`` bit-identical to ``repro`` in every
pinned mode, under the dynamic switch and on the kernel path with and
without fused blocks.  Path counts are integer-valued f32 below 2^24 on
every graph here, so any summation order gives the same bits."""
import importlib

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from oracles import adversarial_families, bfs_dists, bfs_sigmas
from repro.graph import generators as jgen
from repro.graph.csr import CSRGraph as JCSR
from repro.kernels.counting import kernel as jkern
from repro.core import sweep as jsweep
from repro_torch.convert import csr_from_arrays
from repro_torch.core import sweep as tsweep
from repro_torch.kernels import counting as tkern
from repro_torch.kernels import registry

jcent = importlib.import_module("repro.core.centrality")
tcent = importlib.import_module("repro_torch.core.centrality")

ARRAYS = ("indptr", "indices", "src", "dst", "indptr_t", "indices_t")
FAMILIES = {name: (src, dst, n) for name, src, dst, n in
            adversarial_families()}

CONFIGS = {
    "push": dict(mode="push", use_kernel=False),
    "sparse": dict(mode="sparse", use_kernel=False),
    "dynamic": dict(use_kernel=True, dynamic=True),
    "kernel_push": dict(mode="push", use_kernel=True, fused_steps=0),
    "fused3": dict(mode="push", use_kernel=True, fused_steps=3),
    "fused_all": dict(use_kernel=True, fused_steps=-1),
}
# configs that run the Pallas kernels in interpret mode on every family;
# the rest run on a ragged subset to bound the time
EVERY_FAMILY = ("push", "sparse", "dynamic", "fused_all")
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


def _state(seed, s, n, *, density=0.1, visited=0.3):
    """A consistent mid-run counting state: sigma > 0 exactly where
    visited, a frontier inside the visited set."""
    rng = np.random.default_rng(seed)
    d = np.where(rng.random((s, n)) < visited, 1, -1).astype(np.int32)
    sg = np.where(d >= 0, rng.integers(1, 6, (s, n)), 0).astype(np.float32)
    f = ((rng.random((s, n)) < density) & (d >= 0)).astype(np.int8)
    return f, d, sg


def _same(want, got):
    for a, b in zip(want, got):
        if isinstance(a, tuple):
            _same(a, b)
        else:
            np.testing.assert_array_equal(np.asarray(a), b.numpy())


# --------------------------------------------------------------------------
# K5 / K6: plain versions against the Pallas kernels (interpret mode)
# --------------------------------------------------------------------------

@pytest.mark.parametrize("s,n,bs,bk,skip", [
    (16, 256, 8, 128, "none"),
    (32, 256, 16, 128, "k_block"),      # a frontier k-block is empty
    (16, 384, 16, 128, "settled"),      # an output tile is all settled
])
def test_counting_sweep_matches_pallas(s, n, bs, bk, skip):
    rng = np.random.default_rng(n + s)
    adj = (rng.random((n, n)) < 0.05).astype(np.int8)
    f, d, sg = _state(s, s, n)
    if skip == "k_block":
        f[:, 128:256] = 0
    if skip == "settled":
        d[:bs, 128:256] = 2
        sg[:bs, 128:256] = 3.0
    fs = np.where(f != 0, sg, 0).astype(np.float32)
    want = jkern.fused_counting_sweep(
        jnp.asarray(fs), jnp.asarray(adj), jnp.asarray(d), jnp.asarray(sg),
        5, bs=bs, bn=128, bk=bk, interpret=True)
    got = tkern.fused_counting_sweep(
        torch.from_numpy(fs), torch.from_numpy(adj), torch.from_numpy(d),
        torch.from_numpy(sg), 5, bs=bs, bn=128, bk=bk)
    _same(want, got)
    assert tkern.fused_counting_sweep.launches == 0     # CPU: no launch


@pytest.mark.parametrize("s,n,bs,bk,skip", [
    (16, 256, 8, 128, "none"),
    (32, 256, 16, 128, "k_block"),
    (16, 384, 16, 128, "settled"),
])
def test_counting_sweep_with_index_matches_pallas(s, n, bs, bk, skip):
    """K5 handed the live-word index (built by its plain builder) on the
    states of the test above: the same bits as without it and as the
    Pallas kernel.  On the CPU the plain version reads no index."""
    rng = np.random.default_rng(n + s)
    adj = (rng.random((n, n)) < 0.05).astype(np.int8)
    f, d, sg = _state(s, s, n)
    if skip == "k_block":
        f[:, 128:256] = 0
    if skip == "settled":
        d[:bs, 128:256] = 2
        sg[:bs, 128:256] = 3.0
    fs = np.where(f != 0, sg, 0).astype(np.float32)
    want = jkern.fused_counting_sweep(
        jnp.asarray(fs), jnp.asarray(adj), jnp.asarray(d), jnp.asarray(sg),
        5, bs=bs, bn=128, bk=bk, interpret=True)
    args = (torch.from_numpy(fs), torch.from_numpy(adj),
            torch.from_numpy(d), torch.from_numpy(sg), 5)
    plain = tkern.fused_counting_sweep(*args, bs=bs, bn=128, bk=bk)
    got = tkern.fused_counting_sweep(
        *args, bs=bs, bn=128, bk=bk,
        index=tkern.nonzero_words_ref(args[1]))
    _same(want, got)
    _same(tuple(x.numpy() for x in plain), got)


def test_counting_sweep_k_rows_with_index():
    """A (k, n) K-row block with k < n, the sharded executor's operand:
    K5 with the block's own index equals the Pallas kernel."""
    rng = np.random.default_rng(5)
    s, k, n = 16, 128, 384
    adj = (rng.random((k, n)) < 0.05).astype(np.int8)
    f, d, sg = _state(9, s, n)
    fs = np.where(f[:, :k] != 0, sg[:, :k], 0).astype(np.float32)
    want = jkern.fused_counting_sweep(
        jnp.asarray(fs), jnp.asarray(adj), jnp.asarray(d), jnp.asarray(sg),
        2, bs=16, bn=128, bk=128, interpret=True)
    at = torch.from_numpy(adj)
    index = tkern.nonzero_words(at)
    assert index.offsets.shape == (k + 1,)
    got = tkern.fused_counting_sweep(
        torch.from_numpy(fs), at, torch.from_numpy(d), torch.from_numpy(sg),
        2, bs=16, index=index)
    _same(want, got)


@pytest.mark.parametrize("n_run", [0, 1, 2, 40])
def test_counting_multisweep_matches_pallas(n_run):
    """n_run = 0 (inert), 1 and 2 (not converging), 40 (converges
    mid-block): the same new / (dist, sigma) / prod / stopped."""
    jg = jgen.watts_strogatz(120, 4, 0.1, seed=7)
    n = jg.n_padded()
    adj = np.array(jg.to_dense_padded(n))
    s = 16
    f = np.zeros((s, n), np.int8)
    f[np.arange(s), np.arange(s) * 7] = 1
    d = np.where(f != 0, 0, -1).astype(np.int32)
    d[:, jg.n_nodes:] = 0
    sg = (f != 0).astype(np.float32)
    kw = dict(bs=8, max_sweeps=max(n_run, 1))
    want = jkern.fused_counting_multisweep(
        jnp.asarray(f), jnp.asarray(adj), (jnp.asarray(d), jnp.asarray(sg)),
        0, n_run, interpret=True, **kw)
    got = tkern.fused_counting_multisweep(
        torch.from_numpy(f), torch.from_numpy(adj),
        (torch.from_numpy(d), torch.from_numpy(sg)), 0, n_run, **kw)
    _same(want[:2], got[:2])
    assert int(want[2]) == int(got[2])
    assert bool(want[3]) == bool(got[3])
    if n_run == 0:
        assert int(got[2]) == 0 and not bool(got[3])
        assert not got[0].any()
    if n_run == 40:
        assert bool(got[3]) and 0 < int(got[2]) < n_run


# --------------------------------------------------------------------------
# the live-word index K6 reads
# --------------------------------------------------------------------------

def _index_families():
    """The adversarial families, plus a hub row beside isolated nodes: node
    0 points at every fourth node and nothing else has an edge."""
    fams = dict(FAMILIES)
    n = 300
    spokes = np.arange(4, n, 4, dtype=np.int32)
    fams["hub_isolated"] = (np.zeros(spokes.size, np.int32), spokes, n)
    return fams


INDEX_FAMILIES = _index_families()


def lane_words(jg, per_word, n_pad):
    """Per operand row, the 16-byte words that hold one of its edges,
    straight from the JAX graph's CSR lanes: (offsets, words, rows)."""
    src = np.asarray(jg.src)[: jg.n_edges].astype(np.int64)
    dst = np.asarray(jg.dst)[: jg.n_edges].astype(np.int64)
    per_row = n_pad // per_word
    rows, words = np.divmod(np.unique(src * per_row + dst // per_word),
                            per_row)
    counts = np.bincount(rows, minlength=n_pad)
    return np.r_[0, np.cumsum(counts)], words, int((counts > 0).sum())


@pytest.mark.parametrize("family", sorted(INDEX_FAMILIES))
def test_index_marks_exactly_the_nonzero_words(family):
    """The plain index build marks exactly the 16-byte words of each
    operand row that hold a non-zero byte (one of the row's edges), in
    ascending order; isolated rows list none, a hub row lists every word
    it touches.  ``work_items`` bounds the chunks of every row."""
    src, dst, n = INDEX_FAMILIES[family]
    jg = JCSR.from_edges(src, dst, n)
    n_pad = jg.n_padded()
    adj = torch.from_numpy(np.array(jg.to_dense_padded(n_pad)))
    idx = tkern.nonzero_words(adj)
    offsets, words, rows_live = lane_words(jg, 16, n_pad)
    np.testing.assert_array_equal(idx.offsets.numpy(), offsets)
    np.testing.assert_array_equal(idx.words.numpy(), words)
    assert idx.offsets.dtype == idx.words.dtype == torch.int32
    assert idx.rows_live == rows_live
    assert tkern.nonzero_words.launches == 0               # CPU: no launch
    lens = np.diff(offsets)
    for chunk in (1, 3, 32):
        assert int(((lens + chunk - 1) // chunk).sum()) <= \
            idx.work_items(chunk)


def test_fused_multisweep_same_with_and_without_index():
    """On the CPU the K6 wrapper takes its plain version, which reads no
    index: passing the live-word index changes nothing, and the engine's
    fused path, which hands the prepared graph's index on only on the
    card, neither builds it nor changes a result."""
    jg = jgen.watts_strogatz(120, 4, 0.1, seed=7)
    n = jg.n_padded()
    adj = torch.from_numpy(np.array(jg.to_dense_padded(n)))
    s = 16
    f = torch.zeros((s, n), dtype=torch.int8)
    f[torch.arange(s), torch.arange(s) * 7] = 1
    d = torch.where(f != 0, 0, -1).to(torch.int32)
    d[:, jg.n_nodes:] = 0
    sg = (f != 0).to(torch.float32)
    for n_run in (0, 2, 40):
        kw = dict(bs=8, max_sweeps=max(n_run, 1))
        want = tkern.fused_counting_multisweep(f, adj, (d, sg), 0, n_run,
                                               **kw)
        got = tkern.fused_counting_multisweep(
            f, adj, (d, sg), 0, n_run, index=tkern.nonzero_words(adj), **kw)
        _same(tuple(x.numpy() for x in (want[0],) + want[1]),
              (got[0],) + got[1])
        assert int(want[2]) == int(got[2])
        assert bool(want[3]) == bool(got[3])
    pg = tcent.prepare_graph(carry(jg), device="cpu")
    res = tcent.counting_apsp(pg, np.arange(0, 120, 7), config=tcent
                              .CentralityConfig(use_kernel=True,
                                                fused_steps=-1,
                                                source_batch=8))
    assert pg._adj_index is None
    np.testing.assert_array_equal(tkern.nonzero_words(adj).words.numpy(),
                                  lane_words(jg, 16, n)[1])
    np.testing.assert_array_equal(res.dist.numpy(),
                                  bfs_dists(jg, np.arange(0, 120, 7)))


@pytest.mark.parametrize("config", ["kernel_push", "dynamic", "fused3"])
def test_cpu_prepared_graph_builds_no_index(config):
    """Whatever push kernel can dispatch, a prepared graph on the CPU
    never builds ``adj_index`` (the plain versions read none), and the
    results stay the oracle's."""
    jg = jgen.watts_strogatz(120, 4, 0.1, seed=7)
    sources = np.arange(0, 120, 7)
    pg = tcent.prepare_graph(carry(jg), device="cpu")
    res = tcent.counting_apsp(pg, sources, config=tcent.CentralityConfig(
        source_batch=8, **CONFIGS[config]))
    assert pg._adj_index is None
    np.testing.assert_array_equal(res.dist.numpy(), bfs_dists(jg, sources))
    np.testing.assert_array_equal(res.sigma.numpy(), bfs_sigmas(jg, sources))


def test_wrappers_validate_shapes_and_tiles():
    z8 = torch.zeros((8, 128), dtype=torch.int8)
    zf = torch.zeros((8, 128), dtype=torch.float32)
    zi = torch.zeros((8, 128), dtype=torch.int32)
    a = torch.zeros((128, 128), dtype=torch.int8)
    with pytest.raises(ValueError, match="shapes"):
        tkern.fused_counting_sweep(zf, a[:64], zi, zf, 1, bs=8)
    with pytest.raises(ValueError, match="tiles do not divide"):
        tkern.fused_counting_sweep(zf, a, zi, zf, 1, bs=16)
    with pytest.raises(ValueError, match="tiles do not divide"):
        tkern.fused_counting_multisweep(z8, a, (zi, zf), 0, 1, bs=16)
    with pytest.raises(ValueError, match="n_run"):
        tkern.fused_counting_multisweep(z8, a, (zi, zf), 0, 3, bs=8,
                                        max_sweeps=2)


def test_counting_registry_and_fused_gate():
    ks = registry.get("counting")
    assert ks.forms["push"] is tkern.fused_counting_sweep
    assert ks.fused_forms["push"] is tkern.fused_counting_multisweep
    # one K6 block holds nothing in shared memory (its state, candidate
    # sums and work list live in global memory): the gate admits the
    # full-width n_pad the JAX VMEM gate refuses, at any budget
    assert ks.smem_bytes(form="fused", n=65_664) == 0
    assert ks.smem_bytes(form="fused", n=1 << 22) == 0
    assert ks.operand_index is tkern.nonzero_words
    assert tsweep.resolve_fused_steps(
        "counting", "push", fused_steps=-1, max_steps=9, use_kernel=True,
        n_pad=65_664, bs=128) == 9
    assert tsweep.resolve_fused_steps(
        "counting", "push", fused_steps=4, max_steps=9, use_kernel=True,
        n_pad=65_664, bs=128, budget=0) == 4
    assert tsweep.resolve_fused_steps(
        "counting", "push", fused_steps=4, max_steps=9, use_kernel=False,
        n_pad=65_664, bs=128) is None
    with pytest.raises(ValueError, match="only the fused form"):
        ks.smem_bytes(form="push", n=256)


# --------------------------------------------------------------------------
# the counting forms
# --------------------------------------------------------------------------

@pytest.mark.parametrize("family", ["random_ragged", "duplicate_edges",
                                    "star_in"])
def test_counting_push_matches_sparse_and_jax(family):
    src, dst, n = FAMILIES[family]
    jg = JCSR.from_edges(src, dst, n)
    tg = carry(jg)
    n_pad = jg.n_padded()
    adj = np.asarray(jg.to_dense_padded(n_pad))
    f, d, sg = _state(n, 16, n_pad, density=0.3)
    d[:, n:] = 0
    sg[:, n:] = 0
    f[:, n:] = 0
    jforms = jsweep.counting_forms(jnp.asarray(adj), jg.src, jg.dst,
                                   n_pad=n_pad, s=16)
    tforms = tsweep.counting_forms(torch.from_numpy(adj), tg.src, tg.dst,
                                   n_pad=n_pad, s=16)
    p = torch.zeros(1, dtype=torch.int32)
    outs = []
    for jf, tf in zip(jforms, tforms):
        want = jf(jnp.asarray(f), (jnp.asarray(d), jnp.asarray(sg)),
                  jnp.zeros(1, jnp.int32), 3)
        got = tf(torch.from_numpy(f), (torch.from_numpy(d),
                                       torch.from_numpy(sg)), p, 3)
        _same(want[:2], got[:2])
        outs.append(got)
    _same(tuple(o.numpy() for o in (outs[0][0],) + outs[0][1]),
          (outs[1][0],) + outs[1][1])


@pytest.mark.parametrize("family", ["random_ragged", "duplicate_edges",
                                    "star_in"])
def test_counting_kernel_push_with_index_matches_jax(family):
    """The kernel push form handed the operand's live-word index runs its
    plain version on the CPU: the same bits as JAX's kernel push form in
    interpret mode, and as the form without the index."""
    src, dst, n = FAMILIES[family]
    jg = JCSR.from_edges(src, dst, n)
    tg = carry(jg)
    n_pad = jg.n_padded()
    adj = np.asarray(jg.to_dense_padded(n_pad))
    f, d, sg = _state(n + 1, 16, n_pad, density=0.3)
    d[:, n:] = 0
    sg[:, n:] = 0
    f[:, n:] = 0
    at = torch.from_numpy(adj)
    jpush = jsweep.counting_forms(jnp.asarray(adj), jg.src, jg.dst,
                                  n_pad=n_pad, s=16, use_kernel=True,
                                  interpret=True)[0]
    want = jpush(jnp.asarray(f), (jnp.asarray(d), jnp.asarray(sg)),
                 jnp.zeros(1, jnp.int32), 3)
    p = torch.zeros(1, dtype=torch.int32)
    state = (torch.from_numpy(f), (torch.from_numpy(d),
                                   torch.from_numpy(sg)), p, 3)
    for index in (None, tkern.nonzero_words(at)):
        push = tsweep.counting_forms(at, tg.src, tg.dst, n_pad=n_pad, s=16,
                                     use_kernel=True, index=index)[0]
        _same(want[:2], push(*state)[:2])


# --------------------------------------------------------------------------
# the counting engine against repro
# --------------------------------------------------------------------------

def run_both(jg, sources, **kw):
    rj = jcent.counting_apsp(jg, sources,
                             config=jcent.CentralityConfig(**kw))
    rt = tcent.counting_apsp(carry(jg), sources,
                             config=tcent.CentralityConfig(**kw))
    return rj, rt


def assert_same(rj, rt):
    np.testing.assert_array_equal(np.asarray(rj.dist), rt.dist.numpy())
    np.testing.assert_array_equal(np.asarray(rj.sigma), rt.sigma.numpy())
    assert int(rj.sweeps) == rt.sweeps
    np.testing.assert_array_equal(np.asarray(rj.direction_counts),
                                  rt.direction_counts.numpy())


CASES = [(fam, cfg) for fam in sorted(FAMILIES) for cfg in CONFIGS
         if cfg in EVERY_FAMILY or fam in SUBSET]


@pytest.mark.parametrize("family,config", CASES)
def test_counting_apsp_matches_jax(family, config):
    src, dst, n = FAMILIES[family]
    jg = JCSR.from_edges(src, dst, n)
    sources = np.arange(n, dtype=np.int32)[::-1][: min(n, 24)]
    rj, rt = run_both(jg, sources, source_batch=8, **CONFIGS[config])
    assert_same(rj, rt)
    np.testing.assert_array_equal(rt.dist.numpy(), bfs_dists(jg, sources))
    np.testing.assert_array_equal(rt.sigma.numpy(), bfs_sigmas(jg, sources))


def test_dynamic_switch_takes_both_forms():
    """A graph and batch on which the counting cost model picks both
    forms — the per-sweep choice itself (a strict >, ties to push) is
    what must agree."""
    jg = jgen.watts_strogatz(200, 6, 0.1, seed=3)
    rj, rt = run_both(jg, np.arange(0, 200, 7), source_batch=32,
                      use_kernel=True)
    assert_same(rj, rt)
    assert (rt.direction_counts > 0).sum() == 2


def test_calibrated_path_and_blocks():
    """The calibrated regime times the counting forms over the (dist,
    sigma) pair; whatever form it pins, dist and sigma are the oracle's.
    The block stream tiles and validates like the boolean engine's."""
    jg = jgen.rmat(7, 4, directed=False, seed=2)
    tg = carry(jg)
    sources = np.arange(20, dtype=np.int32)
    cfg = tcent.CentralityConfig(source_batch=8, use_kernel=False)
    pg = tcent.prepare_graph(tg, device="cpu")
    res = tcent.counting_apsp(pg, sources, config=cfg)
    np.testing.assert_array_equal(res.dist.numpy(), bfs_dists(jg, sources))
    np.testing.assert_array_equal(res.sigma.numpy(),
                                  bfs_sigmas(jg, sources))
    assert ("counting", 8, 128, 128, False) in pg.cost_cache
    blocks = list(tcent.counting_apsp_blocks(pg, sources, config=cfg))
    assert [len(b) for b, _, _, _ in blocks] == [8, 8, 4]
    with pytest.raises(ValueError, match="empty"):
        tcent.counting_apsp(pg, [], config=cfg)
    with pytest.raises(ValueError, match="sources must be in"):
        tcent.counting_apsp(pg, [jg.n_nodes], config=cfg)
