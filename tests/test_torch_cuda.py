"""The port's CUDA kernels on the card against their plain versions (the
frontier packer against ``pack_bits`` too), and
the boolean, counting and tropical engines' kernel paths and incremental
repair (K9 resuming each repair), the serving tier (K1 and K9 flushes)
and a checkpointed job killed and resumed, on the card against the CPU;
the sharded executor on NCCL at world size 1, and the kernels on the
K-row blocks that ranks of a vertex-sharded mesh run; the reference
dense push's ``accum_dtype`` on the card.
Needs an NVIDIA GPU and nvcc; without CUDA every test here skips.

    PYTHONPATH=src python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

import repro_torch
from repro_torch.core import pack_bits
from repro_torch.core.centrality import CentralityConfig, counting_apsp
from repro_torch.core.engine import EngineConfig, apsp_engine, prepare_graph
from repro_torch.core.weighted import (WeightedConfig, prepare_weighted,
                                       weighted_apsp)
from repro_torch.graph import generators as gen
from repro_torch.graph.csr import CSRGraph
from repro_torch.graph.dynamic import DynamicCSRGraph
from repro_torch.kernels import bovm, counting, tropical
from repro_torch.kernels.bovm import ref as R

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs CUDA: the kernels run only on the card")
    return torch.device("cuda")


def _state(seed, s, n, density=0.05, visited=0.2):
    rng = np.random.default_rng(seed)
    f = torch.from_numpy((rng.random((s, n)) < density).astype(np.int8))
    d = torch.from_numpy(np.where(rng.random((s, n)) < visited, 1, -1)
                         .astype(np.int32))
    return f, d


def _same(a, b):
    for x, y in zip(a, b):
        assert torch.equal(x.cpu(), y.cpu())


@pytest.mark.parametrize("s,n,bs,wk", [(128, 512, 128, 4), (64, 384, 64, 4),
                                       (8, 256, 8, 8), (40, 1152, 40, 4)])
def test_packed_kernels_match_plain(cuda, s, n, bs, wk):
    g = gen.erdos_renyi(n - 1, 6.0, seed=n, device="cpu")
    at = g.to_pull_packed(n)
    f, d = _state(s + n, s, n)
    fp = pack_bits(f)
    before = bovm.packed_push_sweep.launches
    want = bovm.packed_push_sweep(fp, at, d, 4, bs=bs, bn=128, wk=wk)
    got = bovm.packed_push_sweep(fp.to(cuda), at.to(cuda), d.to(cuda), 4,
                                 bs=bs, bn=128, wk=wk)
    torch.cuda.synchronize()
    _same(want, got)
    assert bovm.packed_push_sweep.launches == before + 1
    got = bovm.packed_pull_sweep(fp.to(cuda), at.to(cuda), d.to(cuda), 4,
                                 bs=min(bs, 8), bn=128, wk=wk)
    _same(want, got)


def _packed_graph(kind):
    """Graphs for the packed kernels' index walk: a hub column with 1,000
    in-neighbours over 32 words (more than one work item), isolated and
    padded columns, in-neighbours that straddle word boundaries (node j
    hears from j - 1 and j + 1 and from 31 / 32 / 33 past it), a grid, an
    RMAT graph and an edgeless one."""
    if kind == "hub":
        src = np.arange(1, 1001)
        return CSRGraph.from_edges(src, np.zeros_like(src), 1100,
                                   device="cpu")
    if kind == "straddle":
        j = np.arange(40, 1000)
        src = np.concatenate([j - 1, j + 1, j - 31, j - 32, j - 33])
        dst = np.concatenate([j] * 5)
        return CSRGraph.from_edges(src, dst, 1024, device="cpu")
    if kind == "grid":
        return gen.grid2d(30, 30, device="cpu")
    if kind == "rmat":
        return gen.rmat(10, 8, directed=True, seed=4, device="cpu")
    if kind == "empty":
        return CSRGraph.from_edges(np.zeros(0, np.int64),
                                   np.zeros(0, np.int64), 300, device="cpu")
    return gen.erdos_renyi(1500, 6.0, seed=7, device="cpu")


@pytest.mark.parametrize("kind", ["hub", "straddle", "grid", "rmat",
                                  "empty", "er"])
def test_packed_index_kernel_matches_plain(cuda, kind):
    """The packed operand's live-word index built on the card equals its
    plain version: offsets, positions, values and live rows."""
    g = _packed_graph(kind)
    at = g.to_pull_packed(g.n_padded())
    want = bovm.packed_live_words(at)
    before = bovm.packed_live_words.launches
    got = bovm.packed_live_words(at.to(cuda))
    torch.cuda.synchronize()
    assert bovm.packed_live_words.launches == before + 1
    assert torch.equal(want.offsets, got.offsets.cpu())
    assert torch.equal(want.words, got.words.cpu())
    assert torch.equal(want.values, got.values.cpu())
    assert want.rows_live == got.rows_live


@pytest.mark.parametrize("kind,s,short,item", [
    ("hub", 40, 16, 64), ("hub", 128, 0, 8), ("straddle", 8, 16, 64),
    ("straddle", 72, 0, 3), ("grid", 128, 16, 64), ("grid", 40, 0, 1),
    ("rmat", 40, 4, 64), ("rmat", 256, 0, 5), ("empty", 16, 16, 64),
    ("er", 96, 2, 1)])
def test_packed_kernels_with_index_match_plain(cuda, monkeypatch, kind, s,
                                               short, item):
    """K1 and K2 walking the index (columns of at most ``short`` entries a
    thread each, longer ones in items of ``item`` entries a warp each;
    with a prepared index and building their own) from the sources sweep
    by sweep: bit-identical to the plain versions.  S = 8, 40, 72 and 96
    leave rows past S in the last 32-row group."""
    monkeypatch.setattr(bovm.kernel, "SHORT_WORDS", short)
    monkeypatch.setattr(bovm.kernel, "ITEM_WORDS", item)
    g = _packed_graph(kind)
    n = g.n_padded()
    at = g.to_pull_packed(n)
    index = bovm.packed_live_words(at.to(cuda))
    rng = np.random.default_rng(s + n)
    src = torch.from_numpy(rng.choice(g.n_nodes, s, replace=s > g.n_nodes))
    f = torch.zeros((s, n), dtype=torch.int8)
    f[torch.arange(s), src] = 1
    d = torch.where(f != 0, 0, -1).to(torch.int32)
    d[:, g.n_nodes:] = 0
    bs = 8 if s % 16 else 16
    before = (bovm.packed_push_sweep.launches,
              bovm.packed_pull_sweep.launches)
    for step in range(1, 5):
        fp = pack_bits(f)
        want = bovm.packed_push_sweep(fp, at, d, step, bs=bs, bn=128, wk=4)
        kw = dict(index=index if step % 2 else None)
        got = bovm.packed_push_sweep(fp.to(cuda), at.to(cuda), d.to(cuda),
                                     step, bs=bs, bn=128, wk=4, **kw)
        torch.cuda.synchronize()
        _same(want, got)
        got = bovm.packed_pull_sweep(fp.to(cuda), at.to(cuda), d.to(cuda),
                                     step, bs=8, bn=128, wk=4, **kw)
        torch.cuda.synchronize()
        _same(want, got)
        f, d = want
    assert bovm.packed_push_sweep.launches == before[0] + 4
    assert bovm.packed_pull_sweep.launches == before[1] + 4
    with pytest.raises(ValueError, match="index"):
        bovm.packed_pull_sweep(fp.to(cuda), at.to(cuda), d.to(cuda), 5,
                               bs=8, bn=128, wk=4,
                               index=index._replace(values=None))


def _fused_graph(kind):
    if kind == "ws":                       # n_pad 512: 16 words
        return gen.watts_strogatz(500, 6, 0.05, seed=3, device="cpu")
    if kind == "er":                       # 36 words: the cluster leaves 4
        return gen.erdos_renyi(1100, 4.0, seed=5, device="cpu")
    if kind == "grid":                     # deep: diameter 30, 12 words
        return gen.grid2d(16, 16, device="cpu")
    return gen.grid2d(96, 96, device="cpu")  # 292 words: > 1 list pass


@pytest.mark.parametrize("kind,s,n_run", [
    ("ws", 16, 0), ("ws", 16, 1), ("ws", 16, 3), ("ws", 16, 9),
    ("ws", 8, 1), ("ws", 40, 4), ("ws", 128, 6), ("er", 40, 5),
    ("er", 128, 0), ("grid", 16, 60), ("grid", 40, 1),
    ("grid96", 128, 400)])
def test_fused_kernel_matches_plain(cuda, kind, s, n_run):
    """K3 (32-row tiles, one cluster per tile) against its plain version:
    ragged last tiles (S = 8, 40), word counts the cluster does not divide,
    deep grids run past convergence, n_run 0 and 1."""
    g = _fused_graph(kind)
    n = g.n_padded()
    at = g.to_pull_packed(n)
    rng = np.random.default_rng(s + n)
    src = torch.from_numpy(rng.choice(g.n_nodes, s, replace=False))
    f = torch.zeros((s, n), dtype=torch.int8)
    f[torch.arange(s), src] = 1
    d = torch.where(f != 0, 0, -1).to(torch.int32)
    d[:, g.n_nodes:] = 0
    kw = dict(bs=8 if s % 16 else 16, max_sweeps=max(n_run, 1))
    want = R.fused_boolean_multisweep_ref(f.to(cuda), at.to(cuda),
                                          d.to(cuda), 0, n_run)
    before = bovm.fused_boolean_multisweep.launches
    got = bovm.fused_boolean_multisweep(f.to(cuda), at.to(cuda), d.to(cuda),
                                        0, n_run, **kw)
    torch.cuda.synchronize()
    assert bovm.fused_boolean_multisweep.launches == before + 1
    _same(want[:2], got[:2])
    assert int(want[2]) == int(got[2])
    assert bool(want[3]) == bool(got[3])


def _int8_state(kind, s, n, bs, bk, seed):
    """A dense state (every occupancy tile live) or a sparse one: the
    frontier in two k-blocks and the unreached targets in two 128-column
    tiles, so f_occ and o_occ skip most tiles."""
    if kind == "dense":
        return _state(seed, s, n)
    rng = np.random.default_rng(seed)
    f = np.zeros((s, n), np.int8)
    for kb in rng.choice(n // bk, 2, replace=False):
        rows = rng.choice(s, max(1, s // 4), replace=False)
        f[np.ix_(rows, np.arange(kb * bk, kb * bk + bk))] = \
            (rng.random((len(rows), bk)) < 0.1)
    d = np.ones((s, n), np.int32)
    for tj in rng.choice(n // 128, 2, replace=False):
        d[:, tj * 128: tj * 128 + 128] = np.where(
            rng.random((s, 128)) < 0.5, -1, 1)
    return torch.from_numpy(f), torch.from_numpy(d)


@pytest.mark.parametrize("s,n,bs,bn,bk,kind", [
    (128, 512, 128, 128, 128, "dense"), (16, 256, 16, 128, 256, "dense"),
    (8, 1024, 8, 128, 128, "dense"), (256, 1024, 128, 128, 512, "dense"),
    (40, 448, 8, 64, 32, "dense"), (128, 1024, 32, 128, 512, "sparse"),
    (16, 2048, 8, 128, 128, "sparse"), (256, 768, 64, 128, 128, "sparse")])
def test_int8_kernel_matches_plain(cuda, s, n, bs, bn, bk, kind):
    """K4 (int8 tensor-core product) against its plain version: S from 8
    to 256, bk 32 to 512, a ragged last column block (n = 448), and
    states whose occupancy tables skip most tiles or none."""
    adj = (torch.rand((n, n), generator=torch.Generator().manual_seed(n))
           < 0.02).to(torch.int8)
    f, d = _int8_state(kind, s, n, bs, bk, n + s)
    want = bovm.fused_sweep(f, adj, d, 6, bs=bs, bn=bn, bk=bk)
    before = bovm.fused_sweep.launches
    got = bovm.fused_sweep(f.to(cuda), adj.to(cuda), d.to(cuda), 6, bs=bs,
                           bn=bn, bk=bk)
    torch.cuda.synchronize()
    assert bovm.fused_sweep.launches == before + 1
    _same(want, got)
    with pytest.raises(ValueError, match="bs % 8"):
        bovm.fused_sweep(f.to(cuda), adj.to(cuda), d.to(cuda), 6, bs=4,
                         bn=bn, bk=bk)


@pytest.mark.parametrize("accum", ["float32", "float16", "bfloat16",
                                   "int32"])
def test_bovm_msbfs_accum_dtype_on_card_matches_cpu(cuda, accum):
    """The reference dense push on the card in each accumulator (int32
    counts in float32 there: the card has no integer matmul)."""
    from repro_torch.core import bovm_msbfs
    g = gen.rmat(9, 8, directed=False, seed=2, device="cpu")
    adj = g.to_dense()
    want = bovm_msbfs(adj, [0, 7, 300], accum_dtype=accum)
    got = bovm_msbfs(adj.to(cuda), [0, 7, 300], accum_dtype=accum)
    assert torch.equal(want.dist, got.dist.cpu())
    assert (want.step, float(want.edges_touched)) == \
        (got.step, float(got.edges_touched))


@pytest.mark.parametrize("opts", [dict(), dict(mode="push"),
                                  dict(mode="pull"), dict(fused_steps=-1),
                                  dict(fused_steps=4)])
def test_engine_on_card_matches_cpu(cuda, opts):
    """The card's rows and sweeps are the CPU's.  Pinned and fused runs
    take the same forms on both; under the dynamic regime the card's
    forms read the packed operand's live-word index, so every sweep of
    every tile pushes, each one K1 launch and none K2."""
    g = gen.rmat(10, 8, directed=False, seed=2, device="cpu")
    sources = np.arange(0, 1024, 5)
    cfg = EngineConfig(use_kernel=True, **opts)
    want = apsp_engine(prepare_graph(g, device="cpu"), sources, config=cfg)
    pg = prepare_graph(g, device=cuda)
    k1, k2 = bovm.packed_push_sweep.launches, bovm.packed_pull_sweep.launches
    got = apsp_engine(pg, sources, config=cfg)
    assert torch.equal(want.dist, got.dist.cpu())
    assert want.sweeps == got.sweeps
    if opts:
        assert torch.equal(want.direction_counts, got.direction_counts)
        return
    swept = int(want.direction_counts.sum())
    assert swept > 0
    assert got.direction_counts.tolist() == [swept, 0, 0]
    assert bovm.packed_push_sweep.launches - k1 == swept
    assert bovm.packed_pull_sweep.launches - k2 == 0


# --------------------------------------------------------------------------
# the frontier packer (pack_frontier)
# --------------------------------------------------------------------------

def _frontier(cuda, rows, n, seed, dtype=torch.int8):
    """A (rows, n) frontier on the card, about 5 % set, its first row all
    set (every word -1, bit 31 the sign)."""
    gen_ = torch.Generator(device=cuda).manual_seed(seed)
    x = (torch.rand((rows, n), generator=gen_, device=cuda) < 0.05)
    x[0] = True
    return x.to(dtype)


@pytest.mark.parametrize("rows,n", [(128, 262_272), (64, 1_049_088),
                                    (3, 1), (5, 31), (5, 32), (5, 33),
                                    (7, 4097), (9, 262_145)])
def test_pack_frontier_kernel_matches_plain(cuda, rows, n):
    """The kernel's words are ``pack_bits``' on the cells' shapes (128 x
    262,272 on one card; a K-row rank's 1,049,088 columns at fewer rows)
    and on ragged widths; one launch a call."""
    x = _frontier(cuda, rows, n, n)
    before = bovm.pack_frontier.launches
    got = bovm.pack_frontier(x)
    torch.cuda.synchronize()
    assert bovm.pack_frontier.launches == before + 1
    assert got.shape == (rows, -(-n // 32)) and got.dtype == torch.int32
    assert torch.equal(got, pack_bits(x))


@pytest.mark.parametrize("k0", [0, 262_272, 262_272 + 5, 786_816 - 3])
def test_pack_frontier_kernel_on_a_k_block_slice(cuda, k0):
    """A K-row block's frontier, a column slice of the (S, n_pad) state,
    packs in place through its row stride: at an offset that keeps the
    rows 16-byte aligned (a rank's k0 on the mesh) and at ones that do
    not; so does a state whose row stride is not a multiple of 16."""
    nk = 262_272
    x = _frontier(cuda, 32, 1_049_088, k0)
    view = x[:, k0: k0 + nk]
    assert view.stride(0) == 1_049_088
    got = bovm.pack_frontier(view)
    assert torch.equal(got, pack_bits(view.contiguous()))
    odd = _frontier(cuda, 16, 1000, k0)[:, 3: 3 + 777]
    assert torch.equal(bovm.pack_frontier(odd), pack_bits(odd.contiguous()))


@pytest.mark.parametrize("dtype", [torch.bool, torch.int8, torch.uint8,
                                   torch.int32, torch.float32])
def test_pack_frontier_kernel_reads_any_dtype(cuda, dtype):
    """bool, int8 and uint8 are read as bytes, any non-zero byte a set
    bit; other dtypes are reduced to ``x != 0`` first."""
    gen_ = torch.Generator(device=cuda).manual_seed(3)
    x = torch.randint(-2, 3, (40, 5000), generator=gen_, device=cuda)
    x = x.to(dtype) if dtype != torch.uint8 else (x + 2).to(dtype)
    before = bovm.pack_frontier.launches
    got = bovm.pack_frontier(x)
    assert bovm.pack_frontier.launches == before + 1
    assert torch.equal(got, pack_bits(x))


def test_pack_frontier_refuses_what_it_cannot_read(cuda):
    x = _frontier(cuda, 64, 96, 1)
    with pytest.raises(ValueError, match="contiguous last dim"):
        bovm.pack_frontier(x.t())
    with pytest.raises(ValueError, match="2-d"):
        bovm.pack_frontier(x.reshape(2, 32, 96))


@pytest.mark.parametrize("opts", [dict(), dict(mode="pull")])
def test_traced_engine_packs_once_a_sweep(cuda, opts):
    """On the card's kernel path every sweep packs its frontier once, in
    one launch: ``dawn.frontier.packs`` equals ``dawn.sweeps``, and so
    does the rise of ``pack_frontier.launches``."""
    from repro_torch import trace
    g = gen.rmat(10, 8, directed=False, seed=2, device="cpu")
    pg = prepare_graph(g, device=cuda)
    cfg = EngineConfig(use_kernel=True, **opts)
    apsp_engine(pg, np.arange(8), config=cfg)          # index, warm-up
    trace.reset()
    before = bovm.pack_frontier.launches
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        res = apsp_engine(pg, np.arange(0, 1024, 5), config=cfg)
    counters = trace.snapshot()["window"]["counters"]
    trace.reset()
    swept = int(res.direction_counts.sum())
    assert swept > 0 and counters["dawn.sweeps"] == swept
    assert counters["dawn.frontier.packs"] == swept
    assert bovm.pack_frontier.launches - before == swept


@pytest.mark.parametrize("mode", ["push", "pull"])
def test_engine_reads_pull_index_on_card_only(cuda, mode):
    """The per-sweep kernel path builds the packed operand's live-word
    index for the card's K1 / K2, and never for the plain versions."""
    g = gen.rmat(10, 8, directed=False, seed=2, device="cpu")
    sources = np.arange(0, 1024, 5)
    cfg = EngineConfig(use_kernel=True, mode=mode)
    cpu_pg, card_pg = prepare_graph(g, device="cpu"), prepare_graph(
        g, device=cuda)
    want = apsp_engine(cpu_pg, sources, config=cfg)
    got = apsp_engine(card_pg, sources, config=cfg)
    assert cpu_pg._adj_pull_index is None
    assert card_pg._adj_pull_index is not None
    assert torch.equal(want.dist, got.dist.cpu())


# --------------------------------------------------------------------------
# the counting kernels (K5, K6) and the counting engine
# --------------------------------------------------------------------------

def _counting_start(g, s, n, seed):
    rng = np.random.default_rng(seed)
    src = torch.from_numpy(np.sort(rng.choice(g.n_nodes, s, replace=False)))
    f = torch.zeros((s, n), dtype=torch.int8)
    f[torch.arange(s), src] = 1
    d = torch.where(f != 0, 0, -1).to(torch.int32)
    d[:, g.n_nodes:] = 0
    return f, d, (f != 0).to(torch.float32)


@pytest.mark.parametrize("s,nodes,bs,chunk", [(128, 500, 128, 32),
                                              (16, 300, 16, 8),
                                              (40, 900, 8, 1),
                                              (256, 700, 128, 5)])
def test_counting_kernels_match_plain(cuda, monkeypatch, s, nodes, bs,
                                      chunk):
    """K5 sweep by sweep from the sources, then K6 from the mid-run state
    (n_run 0, 1, 3 and to a fixpoint it stops early at; both with
    ``chunk`` live words per work item, with and without a prepared
    live-word index): bit-identical to the plain versions on the CPU.
    S = 40 leaves 24 lanes of the last row group past S; n_pad 384, 512,
    768, 1,024."""
    monkeypatch.setattr(counting.kernel, "CHUNK_WORDS", chunk)
    g = gen.erdos_renyi(nodes, 5.0, seed=nodes, directed=False,
                        device="cpu")
    n = g.n_padded()
    adj = g.to_dense_padded(n)
    index = counting.nonzero_words(adj.to(cuda))
    f, d, sg = _counting_start(g, s, n, nodes)
    before = counting.fused_counting_sweep.launches
    for step in (1, 2):
        fs = torch.where(f != 0, sg, 0.0)
        want = counting.fused_counting_sweep(fs, adj, d, sg, step, bs=bs)
        got = counting.fused_counting_sweep(fs.to(cuda), adj.to(cuda),
                                            d.to(cuda), sg.to(cuda), step,
                                            bs=bs,
                                            index=index if step % 2 else None)
        torch.cuda.synchronize()
        _same(want, got)
        f, d, sg = want
    assert counting.fused_counting_sweep.launches == before + 2
    before = counting.fused_counting_multisweep.launches
    for n_run in (0, 1, 3, 50):
        kw = dict(bs=bs, max_sweeps=max(n_run, 1))
        want = counting.fused_counting_multisweep(f, adj, (d, sg), 2, n_run,
                                                  **kw)
        got = counting.fused_counting_multisweep(
            f.to(cuda), adj.to(cuda), (d.to(cuda), sg.to(cuda)), 2, n_run,
            index=index if n_run % 2 else None, **kw)
        torch.cuda.synchronize()
        _same((want[0],) + want[1], (got[0],) + got[1])
        assert int(want[2]) == int(got[2])
        assert bool(want[3]) == bool(got[3])
    assert bool(got[3]) and int(got[2]) < 50        # stopped early
    assert counting.fused_counting_multisweep.launches == before + 4


@pytest.mark.parametrize("s", [16, 40, 128, 256])
@pytest.mark.parametrize("chunk", [1, 5, 16])
def test_counting_sweep_kernel_over_index_matches_plain(cuda, monkeypatch, s,
                                                        chunk):
    """K5 over the live-word index (``chunk`` words per work item), with a
    prepared index and building its own, sweep by sweep from the sources
    to the fixpoint on an RMAT graph (hub rows of many chunks):
    bit-identical to the plain version.  S = 16 and 40 leave dead lanes in
    the last 32-row group."""
    monkeypatch.setattr(counting.kernel, "CHUNK_WORDS", chunk)
    g = gen.rmat(9, 8, directed=False, seed=s, device="cpu")
    n = g.n_padded()
    adj = g.to_dense_padded(n)
    index = counting.nonzero_words(adj.to(cuda))
    f, d, sg = _counting_start(g, s, n, s + chunk)
    bs = 8 if s % 16 else 16
    for step in range(1, 40):
        fs = torch.where(f != 0, sg, 0.0)
        want = counting.fused_counting_sweep(fs, adj, d, sg, step, bs=bs)
        for idx in (index, None):
            got = counting.fused_counting_sweep(
                fs.to(cuda), adj.to(cuda), d.to(cuda), sg.to(cuda), step,
                bs=bs, index=idx)
            torch.cuda.synchronize()
            _same(want, got)
        f, d, sg = want
        if not f.any():
            break
    assert step > 2 and not f.any()                 # reached the fixpoint


def test_counting_sweep_kernel_on_k_row_block(cuda):
    """K5 on a (k, n) K-row block with k < n (the sharded executor's
    operand) and that block's own index: bit-identical to the plain
    version."""
    g = gen.erdos_renyi(700, 5.0, seed=11, directed=False, device="cpu")
    n = g.n_padded()
    s, k0, k = 40, 256, 384
    block = g.to_dense_padded(n)[k0: k0 + k].contiguous()
    f, d, sg = _counting_start(g, s, n, 11)
    for _ in range(2):                              # a wide frontier
        fs = torch.where(f != 0, sg, 0.0)
        f, d, sg = counting.fused_counting_sweep(fs, g.to_dense_padded(n),
                                                 d, sg, 1, bs=8)
    fs = torch.where(f != 0, sg, 0.0)[:, k0: k0 + k].contiguous()
    want = counting.fused_counting_sweep(fs, block, d, sg, 3, bs=8)
    assert want[0].any()
    index = counting.nonzero_words(block.to(cuda))
    assert index.offsets.shape == (k + 1,)
    got = counting.fused_counting_sweep(fs.to(cuda), block.to(cuda),
                                        d.to(cuda), sg.to(cuda), 3, bs=8,
                                        index=index)
    torch.cuda.synchronize()
    _same(want, got)
    with pytest.raises(ValueError, match="offsets"):
        counting.fused_counting_sweep(
            fs.to(cuda), block.to(cuda), d.to(cuda), sg.to(cuda), 3, bs=8,
            index=counting.nonzero_words(g.to_dense_padded(n).to(cuda)))


def _hub_isolated(n=1000):
    """Node 0 points at every fourth node; the rest have no out-edge and
    most no edge at all."""
    spokes = np.arange(4, n, 4)
    return CSRGraph.from_edges(np.zeros(spokes.size, np.int64), spokes, n,
                               device="cpu")


@pytest.mark.parametrize("kind", ["er", "hub", "grid"])
def test_live_word_index_kernels_match_plain(cuda, kind):
    """Both index builders (int8 non-zero words, f32 finite words) on the
    card against their plain versions: offsets, words and live rows."""
    g = {"er": lambda: gen.erdos_renyi(900, 5.0, seed=9, device="cpu"),
         "hub": _hub_isolated,
         "grid": lambda: gen.grid2d(20, 20, device="cpu")}[kind]()
    n = g.n_padded()
    w = (np.random.default_rng(n).integers(4, 33, g.m_pad) / 8) \
        .astype(np.float32)
    builders = ((counting.nonzero_words, g.to_dense_padded(n)),
                (tropical.finite_words,
                 prepare_weighted(g, w, device="cpu").wdense))
    for build, op in builders:
        want = build(op)
        before = build.launches
        got = build(op.to(cuda))
        torch.cuda.synchronize()
        assert build.launches == before + 1
        assert torch.equal(want.offsets, got.offsets.cpu())
        assert torch.equal(want.words, got.words.cpu())
        assert want.rows_live == got.rows_live


@pytest.mark.parametrize("opts", [dict(), dict(mode="push"),
                                  dict(mode="sparse"), dict(fused_steps=-1),
                                  dict(fused_steps=2)])
def test_counting_engine_on_card_matches_cpu(cuda, opts):
    g = gen.rmat(10, 8, directed=False, seed=2, device="cpu")
    sources = np.arange(0, 1024, 5)
    cfg = CentralityConfig(use_kernel=True, **opts)
    want = counting_apsp(prepare_graph(g, device="cpu"), sources, config=cfg)
    got = counting_apsp(prepare_graph(g, device=cuda), sources, config=cfg)
    assert torch.equal(want.dist, got.dist.cpu())
    assert torch.equal(want.sigma, got.sigma.cpu())
    assert want.sweeps == got.sweeps
    assert torch.equal(want.direction_counts, got.direction_counts)


# --------------------------------------------------------------------------
# the tropical kernels (K7, K8, K9) and the tropical engine
# --------------------------------------------------------------------------

def _tropical_start(nodes, s, seed):
    """A weighted graph, its dense operand and a start state after one
    sweep, so both the frontier and the distances are non-trivial."""
    g = gen.erdos_renyi(nodes, 5.0, seed=seed, directed=False, device="cpu")
    rng = np.random.default_rng(seed)
    w = (rng.integers(4, 33, g.m_pad) / 8).astype(np.float32)
    pw = prepare_weighted(g, w, device="cpu")
    n = pw.n_pad
    src = torch.from_numpy(np.sort(rng.choice(nodes, s, replace=False)))
    f = torch.zeros((s, n), dtype=torch.int8)
    f[torch.arange(s), src] = 1
    d = torch.where(f != 0, 0.0, float("inf")).to(torch.float32)
    f, d = tropical.sparse_relax_sweep(f, d, g.src, g.dst, pw.w_edges)
    return pw, f, d


@pytest.mark.parametrize("s,nodes,bs,chunk", [(128, 500, 128, 32),
                                              (16, 300, 16, 8),
                                              (40, 900, 8, 3)])
def test_tropical_kernels_match_plain(cuda, monkeypatch, s, nodes, bs,
                                      chunk):
    """K7 (``chunk`` live words per work item; with a prepared live-word
    index, then building its own) and K9 (with a prepared in-lane index,
    then building its own from lanes in random order) sweep by sweep,
    then K8 from the mid-run state (n_run 0, 1, 3 and to the fixpoint,
    ``chunk`` words per item, with and without the prepared index):
    bit-identical to the plain versions on the CPU.  S = 40 leaves 24
    lanes of the last row group past S; n_pad 384."""
    monkeypatch.setattr(tropical.kernel, "CHUNK_WORDS", chunk)
    pw, f, d = _tropical_start(nodes, s, nodes)
    g, w, wd = pw.graph, pw.w_edges, pw.wdense
    index = tropical.finite_words(wd.to(cuda))
    lanes = tropical.in_lanes(g.src.to(cuda), g.dst.to(cuda), w.to(cuda),
                              pw.n_pad)
    inf = torch.tensor(float("inf"))
    before = (tropical.fused_minplus_sweep.launches,
              tropical.sparse_relax_sweep.launches)
    for sweep in range(2):
        fd = torch.where(f != 0, d, inf)
        want = tropical.fused_minplus_sweep(fd, wd, d, w.min(), bs=bs)
        got = tropical.fused_minplus_sweep(fd.to(cuda), wd.to(cuda),
                                           d.to(cuda), w.min().to(cuda),
                                           bs=bs,
                                           index=None if sweep else index)
        torch.cuda.synchronize()
        _same(want, got)
        got = tropical.sparse_relax_sweep(
            f.to(cuda), d.to(cuda), g.src.to(cuda), g.dst.to(cuda),
            w.to(cuda), index=lanes)
        _same(want, got)
        # without an index the wrapper builds its own, from lanes in any
        # order
        perm = torch.randperm(g.m_pad, generator=torch.Generator()
                              .manual_seed(s))
        got = tropical.sparse_relax_sweep(
            f.to(cuda), d.to(cuda), g.src[perm].to(cuda),
            g.dst[perm].to(cuda), w[perm].to(cuda))
        _same(want, got)
        f, d = want
    assert tropical.fused_minplus_sweep.launches == before[0] + 2
    assert tropical.sparse_relax_sweep.launches == before[1] + 4
    before = tropical.fused_minplus_multisweep.launches
    for n_run in (0, 1, 3, 60):
        kw = dict(bs=bs, max_sweeps=max(n_run, 1))
        want = tropical.fused_minplus_multisweep(f, wd, d, 0, n_run, **kw)
        got = tropical.fused_minplus_multisweep(
            f.to(cuda), wd.to(cuda), d.to(cuda), 0, n_run,
            index=index if n_run % 2 else None, **kw)
        torch.cuda.synchronize()
        _same(want[:2], got[:2])
        assert int(want[2]) == int(got[2])
        assert bool(want[3]) == bool(got[3])
    assert bool(got[3]) and int(got[2]) < 60        # stopped early
    assert tropical.fused_minplus_multisweep.launches == before + 4


def _relax_lanes(case, n=1000, m=5000, seed=0):
    """CSR-like lanes (int32 src / dst, float32 weights, +inf padded to a
    multiple of 128 with the sentinel id n) for K9's cases: dyadic weights
    with many ties, a quarter of them zero in ``zero_weights``, a fan-in
    hub of 3,000 lanes into node 7 in ``hub``, the lanes in random order
    in ``shuffled``."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n, m)
    dst = rng.integers(0, n, m)
    w = rng.integers(1, 9, m) / 4
    if case == "zero_weights":
        w[rng.random(m) < 0.25] = 0.0
    if case == "hub":
        src = np.r_[src, rng.integers(0, n, 3000)]
        dst = np.r_[dst, np.full(3000, 7)]
        w = np.r_[w, rng.integers(1, 9, 3000) / 4]
    if case != "shuffled":
        order = np.argsort(src, kind="stable")     # CSR order
        src, dst, w = src[order], dst[order], w[order]
    m_pad = -(-src.size // 128) * 128
    pad = m_pad - src.size
    src, dst = np.r_[src, np.full(pad, n)], np.r_[dst, np.full(pad, n)]
    w = np.r_[w, np.full(pad, np.inf)]
    if case == "shuffled":
        perm = rng.permutation(m_pad)
        src, dst, w = src[perm], dst[perm], w[perm]
    return (torch.from_numpy(src.astype(np.int32)),
            torch.from_numpy(dst.astype(np.int32)),
            torch.from_numpy(w.astype(np.float32)))


def _relax_state(case, s, n_pad, seed=1):
    """A (frontier, dist) pair: distances on a quarter grid (ties with
    the candidates), 40% finite; a frontier of 30%, empty in ``empty``,
    and in ``inf_frontier`` also set on every unreached entry."""
    rng = np.random.default_rng(seed)
    d = np.where(rng.random((s, n_pad)) < 0.4,
                 rng.integers(0, 40, (s, n_pad)) / 4, np.inf)
    f = rng.random((s, n_pad)) < 0.3
    if case == "inf_frontier":
        f |= np.isinf(d)
    if case == "empty":
        f[:] = False
    return (torch.from_numpy(f.astype(np.int8)),
            torch.from_numpy(d.astype(np.float32)))


@pytest.mark.parametrize("hub", [1, 32, 256])
@pytest.mark.parametrize("case", ["ties", "zero_weights", "inf_frontier",
                                  "s40", "s160", "empty", "hub",
                                  "shuffled"])
def test_sparse_relax_gather_matches_plain(cuda, monkeypatch, case, hub):
    """K9's gather on the card against its plain version, bit for bit:
    ties between candidates and with dist, zero weights, frontier entries
    at +inf, S = 40 (a part row group), S = 160 (five groups: two gather
    blocks per tile, the second with one group), an empty frontier, a hub
    of 3,000
    in-lanes (above every split threshold tried), lanes in random order;
    each target of more than ``hub`` in-lanes cut into pieces of ``hub``
    lanes (1: every target of two or more), with the prepared in-lane
    index and building its own."""
    monkeypatch.setattr(tropical.kernel, "HUB_LANES", hub)
    src, dst, w = _relax_lanes(case)
    n_pad = 1024
    f, d = _relax_state(case, {"s40": 40, "s160": 160}.get(case, 96), n_pad)
    want = tropical.sparse_relax_sweep(f, d, src, dst, w)
    if case != "empty":
        assert want[0].any()
    lanes = tropical.in_lanes(src.to(cuda), dst.to(cuda), w.to(cuda), n_pad)
    before = (tropical.sparse_relax_sweep.launches,
              tropical.in_lanes.launches)
    for idx in (lanes, None):
        got = tropical.sparse_relax_sweep(
            f.to(cuda), d.to(cuda), src.to(cuda), dst.to(cuda), w.to(cuda),
            index=idx)
        torch.cuda.synchronize()
        _same(want, got)
    assert tropical.sparse_relax_sweep.launches == before[0] + 2
    assert tropical.in_lanes.launches == before[1] + 1


@pytest.mark.parametrize("kind", ["er", "hub", "grid", "shuffled"])
def test_in_lanes_kernel_matches_plain(cuda, kind):
    """K9's in-lane index built on the card against its plain version:
    the same offsets, and each target's lanes the same up to their order;
    a lane id outside the state raises."""
    if kind in ("hub", "shuffled"):
        src, dst, w = _relax_lanes(kind, seed=5)
        n_pad = 1024
    else:
        g = {"er": lambda: gen.erdos_renyi(900, 5.0, seed=9, device="cpu"),
             "grid": lambda: gen.grid2d(20, 20, device="cpu")}[kind]()
        w = (np.random.default_rng(3).integers(0, 33, g.m_pad) / 8) \
            .astype(np.float32)
        pw = prepare_weighted(g, w, device="cpu")
        src, dst, w, n_pad = g.src, g.dst, pw.w_edges, pw.n_pad
    want = tropical.in_lanes(src, dst, w, n_pad)
    before = tropical.in_lanes.launches
    got = tropical.in_lanes(src.to(cuda), dst.to(cuda), w.to(cuda), n_pad)
    torch.cuda.synchronize()
    assert tropical.in_lanes.launches == before + 1
    assert torch.equal(want.offsets, got.offsets.cpu())
    for a, b in zip(tropical.in_lanes_sorted(want),
                    tropical.in_lanes_sorted(got)):
        assert torch.equal(a, b.cpu())
    if kind == "hub":
        assert want.pieces.shape[0] > 0
    with pytest.raises(ValueError, match="outside"):
        tropical.in_lanes(src.to(cuda), dst.to(cuda), w.to(cuda),
                          int(dst[w < float("inf")].max()))


@pytest.mark.parametrize("s", [16, 40, 128, 256])
@pytest.mark.parametrize("chunk", [1, 5, 16])
def test_fused_minplus_kernel_over_index_matches_plain(cuda, monkeypatch, s,
                                                       chunk):
    """K8 on one cooperative grid over the live-word index (``chunk``
    words per work item), from the sources of an RMAT graph (hub rows of
    many chunks), with a prepared index and building its own: n_run 0, 1,
    3 and to a fixpoint it stops early at, bit-identical to the plain
    version.  S = 16 and 40 leave dead lanes in the last 32-row group."""
    monkeypatch.setattr(tropical.kernel, "CHUNK_WORDS", chunk)
    g = gen.rmat(9, 8, directed=False, seed=s, device="cpu")
    w = (np.random.default_rng(s).integers(4, 33, g.m_pad) / 8) \
        .astype(np.float32)
    pw = prepare_weighted(g, w, device="cpu")
    n, wd = pw.n_pad, pw.wdense
    rng = np.random.default_rng(s + chunk)
    src = torch.from_numpy(rng.choice(g.n_nodes, s, replace=False))
    f = torch.zeros((s, n), dtype=torch.int8)
    f[torch.arange(s), src] = 1
    d = torch.where(f != 0, 0.0, float("inf")).to(torch.float32)
    index = tropical.finite_words(wd.to(cuda))
    bs = 8 if s % 16 else 16
    for n_run in (0, 1, 3, 200):
        kw = dict(bs=bs, max_sweeps=max(n_run, 1))
        want = tropical.fused_minplus_multisweep(f, wd, d, 0, n_run, **kw)
        for idx in (index, None):
            got = tropical.fused_minplus_multisweep(
                f.to(cuda), wd.to(cuda), d.to(cuda), 0, n_run, index=idx,
                **kw)
            torch.cuda.synchronize()
            _same(want[:2], got[:2])
            assert int(want[2]) == int(got[2])
            assert bool(want[3]) == bool(got[3])
    assert bool(got[3]) and int(got[2]) < 200       # stopped early


def test_minplus_kernel_on_hub_and_isolated_rows(cuda):
    """K7 where one operand row (the hub) holds most live words and most
    rows hold none, from every source at once: bit-identical to the plain
    version, with the settled-bound skip live; then K8 from that
    state."""
    g = _hub_isolated()
    w = (np.random.default_rng(3).integers(4, 33, g.m_pad) / 8) \
        .astype(np.float32)
    pw = prepare_weighted(g, w, device="cpu")
    n, s = pw.n_pad, 64
    d = torch.full((s, n), float("inf"))
    d[:, 0] = torch.arange(s, dtype=torch.float32) / 4
    d[:32, 128:256] = 0.25                   # one settled output tile
    fd = torch.where(torch.arange(n)[None, :] < 2, d,
                     torch.tensor(float("inf")))
    want = tropical.fused_minplus_sweep(fd, pw.wdense, d, pw.w_edges.min(),
                                        bs=32)
    got = tropical.fused_minplus_sweep(
        fd.to(cuda), pw.wdense.to(cuda), d.to(cuda),
        pw.w_edges.min().to(cuda), bs=32,
        index=tropical.finite_words(pw.wdense.to(cuda)))
    torch.cuda.synchronize()
    _same(want, got)
    assert want[0].any()
    # K8 from the same state: the hub row's chunks spread over warps
    f = (fd != float("inf")).to(torch.int8)
    for n_run in (1, 3):
        kw = dict(bs=32, max_sweeps=n_run)
        want = tropical.fused_minplus_multisweep(f, pw.wdense, d, 0, n_run,
                                                 **kw)
        got = tropical.fused_minplus_multisweep(
            f.to(cuda), pw.wdense.to(cuda), d.to(cuda), 0, n_run,
            index=tropical.finite_words(pw.wdense.to(cuda)), **kw)
        torch.cuda.synchronize()
        _same(want[:2], got[:2])
        assert int(want[2]) == int(got[2])
        assert bool(want[3]) == bool(got[3])


@pytest.mark.parametrize("opts", [dict(), dict(mode="dense"),
                                  dict(mode="sparse"), dict(fused_steps=-1),
                                  dict(fused_steps=2)])
def test_weighted_engine_on_card_matches_cpu(cuda, opts):
    g = gen.rmat(10, 8, directed=False, seed=2, device="cpu")
    w = (np.random.default_rng(2).integers(4, 33, g.m_pad) / 8) \
        .astype(np.float32)
    sources = np.arange(0, 1024, 5)
    cfg = WeightedConfig(use_kernel=True, **opts)
    want = weighted_apsp(prepare_weighted(g, w, device="cpu"), sources=sources,
                         config=cfg)
    got = weighted_apsp(prepare_weighted(g, w, device=cuda), sources=sources,
                        config=cfg)
    assert torch.equal(want.dist, got.dist.cpu())
    assert want.sweeps == got.sweeps
    assert torch.equal(want.direction_counts, got.direction_counts)
    assert float(want.edges_touched) == float(got.edges_touched)


def test_operand_indexes_built_once_and_on_card_only(cuda):
    """The pinned counting push, the fused weighted run and the pinned
    sparse weighted run over several source batches build their operand's
    index once per prepared graph on the card (one builder launch, none
    per batch or sweep), never on the CPU, and equal the CPU runs."""
    g = gen.rmat(10, 8, directed=False, seed=2, device="cpu")
    sources = np.arange(0, 1024, 5)                 # 205 sources: 4 batches
    cfg = CentralityConfig(use_kernel=True, mode="push", source_batch=64)
    cpu_pg, card_pg = prepare_graph(g, device="cpu"), prepare_graph(
        g, device=cuda)
    before = (counting.nonzero_words.launches,
              counting.fused_counting_sweep.launches)
    want = counting_apsp(cpu_pg, sources, config=cfg)
    got = counting_apsp(card_pg, sources, config=cfg)
    assert counting.nonzero_words.launches == before[0] + 1
    assert counting.fused_counting_sweep.launches > before[1] + 4
    assert cpu_pg._adj_index is None and card_pg._adj_index is not None
    assert torch.equal(want.dist, got.dist.cpu())
    assert torch.equal(want.sigma, got.sigma.cpu())
    w = (np.random.default_rng(2).integers(4, 33, g.m_pad) / 8) \
        .astype(np.float32)
    wcfg = WeightedConfig(use_kernel=True, fused_steps=-1, source_batch=64)
    cpu_pw, card_pw = prepare_weighted(g, w, device="cpu"), \
        prepare_weighted(g, w, device=cuda)
    before = (tropical.finite_words.launches,
              tropical.fused_minplus_multisweep.launches)
    want = weighted_apsp(cpu_pw, sources=sources, config=wcfg)
    got = weighted_apsp(card_pw, sources=sources, config=wcfg)
    assert tropical.finite_words.launches == before[0] + 1
    assert tropical.fused_minplus_multisweep.launches >= before[1] + 4
    assert cpu_pw._wdense_index is None and card_pw._wdense_index is not None
    assert torch.equal(want.dist, got.dist.cpu())
    assert want.sweeps == got.sweeps
    # the pinned sparse run: K9's in-lane index, once, and no dense operand
    scfg = WeightedConfig(use_kernel=True, mode="sparse", source_batch=64)
    cpu_pw, card_pw = prepare_weighted(g, w, device="cpu"), \
        prepare_weighted(g, w, device=cuda)
    before = (tropical.in_lanes.launches,
              tropical.sparse_relax_sweep.launches)
    want = weighted_apsp(cpu_pw, sources=sources, config=scfg)
    got = weighted_apsp(card_pw, sources=sources, config=scfg)
    assert tropical.in_lanes.launches == before[0] + 1
    assert tropical.sparse_relax_sweep.launches > before[1] + 4
    assert cpu_pw._relax_index is None and card_pw._relax_index is not None
    assert card_pw._wdense is None
    assert torch.equal(want.dist, got.dist.cpu())
    assert want.sweeps == got.sweeps


# --------------------------------------------------------------------------
# incremental repair on the card: K9 resumes each repair
# --------------------------------------------------------------------------

def _mutations(seed, n, rounds=5):
    """Insert / delete batches near one node each round, as the
    bench_dynamic stream makes them."""
    rng = np.random.default_rng(seed)
    out, history = [], []
    for _ in range(rounds):
        lo = int(rng.integers(0, n - 16))
        u, v = rng.integers(lo, lo + 16, (2, 6))
        keep = u != v
        ins = (np.r_[u[keep], v[keep]], np.r_[v[keep], u[keep]])
        dels = history.pop(0) if len(history) >= 2 else None
        history.append(ins)
        out.append((ins, rng.integers(4, 33, 2 * int(keep.sum())) / 8,
                    dels))
    return out


@pytest.mark.parametrize("weighted", [False, True])
def test_repair_on_card_matches_cpu(cuda, weighted):
    g = gen.watts_strogatz(700, 6, 0.05, seed=4, device="cpu")
    lanes = (np.random.default_rng(1).integers(4, 33, g.m_pad) / 8) \
        .astype(np.float32) if weighted else None
    dgs = [DynamicCSRGraph(g.to(dev), weights=lanes, compact_threshold=0.001)
           for dev in ("cpu", cuda)]
    cfg = WeightedConfig(mode="sparse") if weighted \
        else EngineConfig(mode="sparse")
    incs = [repro_torch.IncrementalSSSP(d, [0, 5, 99, 350, 699], config=cfg)
            for d in dgs]
    relaxed = 0
    for it, (ins, w, dels) in enumerate(_mutations(7, g.n_nodes)):
        for d in dgs:
            d.insert_edges(*ins, w.astype(np.float32) if weighted else None)
            if dels is not None:
                d.delete_edges(*dels)
            if it == 2:
                d.compact()
        want = incs[0].update()
        before = tropical.sparse_relax_sweep.launches
        got = incs[1].update()
        assert (want.sweeps, want.tainted, want.seeded) == \
            (got.sweeps, got.tainted, got.seeded)
        assert torch.equal(want.state.dist, got.state.dist.cpu())
        assert torch.equal(want.state.parent, got.state.parent.cpu())
        assert got.state.dist.is_cuda
        # one K9 launch per resumed sweep, the last (empty) one included
        launched = tropical.sparse_relax_sweep.launches - before
        assert launched == (got.sweeps + 1 if got.seeded else 0)
        relaxed += launched
    assert relaxed > 0
    scratch, _ = repro_torch.sssp_state(dgs[1], [0, 5, 99, 350, 699],
                                        config=cfg)
    assert torch.equal(scratch.dist, incs[1].dist)
    assert torch.equal(scratch.parent, incs[1].parent)


def test_handle_indexes_are_new_after_a_mutation(cuda):
    g = gen.rmat(9, 6, seed=3, device="cpu")
    lanes = (np.random.default_rng(2).integers(4, 33, g.m_pad) / 8) \
        .astype(np.float32)
    dg = DynamicCSRGraph(g.to(cuda), weights=lanes)
    h = repro_torch.prepare(dg, device=cuda)
    pg, pw = h.prepared(), h.prepared_weighted()
    old = (pg.adj_pull_index, pg.adj_index, pw.wdense_index, pw.relax_index)
    builders = (bovm.packed_live_words, counting.nonzero_words,
                tropical.finite_words, tropical.in_lanes)
    before = [b.launches for b in builders]
    h.compact()                          # content kept: nothing rebuilt
    assert h.prepared() is pg and h.prepared_weighted() is pw
    h.insert_edges([1, 2], [300, 301], np.array([0.5, 0.5], np.float32))
    pg2, pw2 = h.prepared(), h.prepared_weighted()
    assert pg2 is not pg and pw2 is not pw
    assert pg2.epoch == pw2.epoch == dg.epoch
    new = (pg2.adj_pull_index, pg2.adj_index, pw2.wdense_index,
           pw2.relax_index)
    for a, b in zip(old, new):
        assert a is not b
    assert [b.launches for b in builders] == [x + 1 for x in before]
    res = h.apsp([0, 1, 2], semiring="tropical")
    want = repro_torch.prepare(dg.view().to("cpu"),
                               weights=dg.view_weights(),
                               device="cpu").apsp([0, 1, 2],
                                                  semiring="tropical")
    assert torch.equal(res.dist.cpu(), want.dist)


def test_unit_lane_index_follows_a_compaction(cuda):
    g = gen.grid2d(20, 20, device="cpu")
    dg = DynamicCSRGraph(g.to(cuda), compact_threshold=10.0)
    inc = repro_torch.IncrementalSSSP(dg, [0, 399],
                                      config=EngineConfig(mode="sparse"))
    before = tropical.in_lanes.launches
    i1 = inc.lane_index()
    assert inc.lane_index() is i1
    dg.delete_edges([0, 1], [1, 2])
    dg.insert_edges([0], [21])
    i2 = inc.lane_index()
    dg.compact()                         # lanes re-laid out, same epoch
    i3 = inc.lane_index()
    assert i2 is not i1 and i3 is not i2
    assert tropical.in_lanes.launches == before + 3
    view = dg.view()
    w = torch.where(view.src < view.n_nodes, 1.0, float("inf")) \
        .to(torch.float32)
    want = tropical.in_lanes_ref(view.src.cpu(), view.dst.cpu(), w.cpu(),
                                 view.n_padded(128),
                                 tropical.kernel.HUB_LANES)
    for a, b in zip(tropical.in_lanes_sorted(want),
                    tropical.in_lanes_sorted(i3)):
        assert torch.equal(a, b.cpu())
    res = inc.update()
    assert res.tainted > 0
    scratch, _ = repro_torch.sssp_state(dg, [0, 399],
                                        config=EngineConfig(mode="sparse"))
    assert torch.equal(scratch.dist, inc.dist)
    assert torch.equal(scratch.parent, inc.parent)


def test_msbfs_drivers_on_card_match_cpu(cuda):
    g = gen.watts_strogatz(511, 6, 0.05, seed=9, device="cpu")
    n = 512
    adj = g.to_dense_padded(n)
    sources = torch.arange(0, 256, 2)
    want = bovm.msbfs_kernel(adj, sources, max_steps=n, bk=128)
    before = (bovm.fused_sweep.launches, bovm.packed_pull_sweep.launches,
              bovm.packed_live_words.launches)
    got = bovm.msbfs_kernel(adj.to(cuda), sources.to(cuda), max_steps=n,
                            bk=128)
    assert torch.equal(want.dist, got.dist.cpu())
    assert want.sweeps == got.sweeps
    assert bovm.fused_sweep.launches == before[0] + got.sweeps
    packed = bovm.pack_adjacency_pull(adj.to(cuda))
    got = bovm.msbfs_packed(packed, sources.to(cuda), n, max_steps=n, wk=4)
    assert torch.equal(want.dist, got.dist.cpu())
    assert bovm.packed_pull_sweep.launches == before[1] + got.sweeps
    assert bovm.packed_live_words.launches == before[2] + 1


def test_single_sweep_on_card_launches_k4_or_raises(cuda):
    g = gen.erdos_renyi(255, 4.0, seed=8, device="cpu")
    n = 256
    adj = g.to_dense_padded(n)
    rng = np.random.default_rng(0)
    f = torch.from_numpy((rng.random((8, n)) < 0.1).astype(np.int8))
    d = torch.from_numpy(np.where(rng.random((8, n)) < 0.3, 1, -1)
                         .astype(np.int32))
    want = bovm.sweep(f, adj, d, 2, bs=8, bn=128, bk=128)
    before = bovm.fused_sweep.launches
    got = bovm.sweep(f.to(cuda), adj.to(cuda), d.to(cuda), 2, bs=8,
                     bn=128, bk=128)
    _same(want, got)
    assert bovm.fused_sweep.launches == before + 1
    # tiles that do not divide the shapes: the plain version on the CPU,
    # a refused launch on the card, never a plain run there
    _same(want, bovm.sweep(f, adj, d, 2, bs=16))
    with pytest.raises(ValueError, match="tiles do not divide"):
        bovm.sweep(f.to(cuda), adj.to(cuda), d.to(cuda), 2, bs=16)
    assert bovm.fused_sweep.launches == before + 1


def test_dynamic_graph_on_another_device_is_refused(cuda):
    g = gen.grid2d(8, 8, device="cpu")
    with pytest.raises(ValueError, match="handle's device"):
        repro_torch.prepare(DynamicCSRGraph(g), device=cuda)
    with pytest.raises(ValueError, match="handle's device"):
        repro_torch.prepare(DynamicCSRGraph(g.to(cuda)), device="cpu")
    h = repro_torch.prepare(DynamicCSRGraph(g.to("cuda:0")), device=cuda)
    inc = h.incremental([0, 9])
    assert inc.dist.is_cuda and h.prepared().adj_pull.is_cuda


def _serve_stream(n, seed, weighted):
    """Point-to-point, k-nearest and full-row queries from a hot pool
    (weighted: point-to-point and full rows)."""
    from repro_torch.serve import GraphQuery
    rng = np.random.default_rng(seed)
    pool = rng.choice(n, 24, replace=False)
    out = []
    for i in range(160):
        s, kind = int(rng.choice(pool)), int(rng.integers(0, 3))
        if kind == 0:
            out.append(GraphQuery(qid=i, source=s, weighted=weighted,
                                  target=int(rng.integers(0, n))))
        elif kind == 1 and not weighted:
            out.append(GraphQuery(qid=i, source=s, k_nearest=5))
        else:
            out.append(GraphQuery(qid=i, source=s, weighted=weighted))
    return out


def _serve_all(svc, queries):
    for q in queries:
        svc.submit(q)
        while svc.tick():
            pass
    while svc.pending():
        svc.flush()
    return svc.drain_completed()


def _same_answers(got, want):
    assert [q.qid for q in got] == [q.qid for q in want]
    for a, b in zip(got, want):
        assert (a.served_by, a.hops, a.cost, a.nearest) == \
            (b.served_by, b.hops, b.cost, b.nearest)
        assert (a.dist is None) == (b.dist is None)
        if a.dist is not None:
            assert a.dist.dtype == b.dist.dtype
            np.testing.assert_array_equal(a.dist, b.dist)


def test_pinned_push_service_on_card_matches_cpu_and_launches_k1(cuda):
    """A service over a pinned-push handle answers every query as the CPU
    port does; each of its flushes is a K1 run on the card."""
    g = gen.rmat(11, 8, directed=False, seed=3, device="cpu")
    queries = {dev: _serve_stream(g.n_nodes, 7, False)
               for dev in ("cpu", "cuda")}
    done = {}
    for dev in ("cpu", "cuda"):
        h = repro_torch.prepare(g.to(dev), mode="push", use_kernel=True,
                                device=dev)
        svc = h.serve(max_batch=16, n_landmarks=4, row_cache_size=8)
        before = bovm.packed_push_sweep.launches
        done[dev] = _serve_all(svc, queries[dev])
        launched = bovm.packed_push_sweep.launches - before
        if dev == "cuda":
            assert launched > 0 and svc.prepared.device.type == "cuda"
        else:
            assert launched == 0
    _same_answers(done["cuda"], done["cpu"])
    assert any(q.served_by == "sweep" for q in done["cuda"])


def test_weighted_service_flush_on_card_launches_k9(cuda):
    g = gen.rmat(11, 8, directed=False, seed=4, device="cpu")
    w = (np.random.default_rng(4).integers(4, 33, g.m_pad) / 8) \
        .astype(np.float32)
    done = {}
    for dev in ("cpu", "cuda"):
        h = repro_torch.prepare(g.to(dev), weights=w, device=dev,
                                mode="sparse", use_kernel=True)
        svc = h.serve(max_batch=16, row_cache_size=4)
        before = tropical.sparse_relax_sweep.launches
        done[dev] = _serve_all(svc, _serve_stream(g.n_nodes, 9, True))
        if dev == "cuda":
            assert tropical.sparse_relax_sweep.launches > before
    _same_answers(done["cuda"], done["cpu"])
    assert done["cuda"][0].dist is None or \
        done["cuda"][0].dist.dtype == np.float32


def test_checkpointed_tropical_job_resumes_on_card(cuda, tmp_path):
    """A tropical job (K9 in every chunk) killed after its second chunk
    and resumed on the card equals the uninterrupted run and the CPU run
    bit for bit; a CUDA leaf saved with blocking=False and overwritten at
    once restores at its submitted bytes."""
    from repro_torch.core.jobs import run_sweep_job
    from repro_torch.core.options import SweepOptions
    from repro_torch.train import checkpoint as C

    g = gen.rmat(11, 8, directed=False, seed=5, device="cpu")
    w = (np.random.default_rng(5).integers(4, 33, g.m_pad) / 8) \
        .astype(np.float32)
    srcs = np.arange(0, 2048, 16)
    opts = SweepOptions(source_batch=32, mode="sparse", use_kernel=True)
    kw = dict(workload="tropical", weights=w, options=opts, chunk_size=32)

    class Kill(RuntimeError):
        pass

    def kill(k):
        if k == 1:
            raise Kill

    before = tropical.sparse_relax_sweep.launches
    full = run_sweep_job(g.to(cuda), srcs, device=cuda, **kw)
    assert tropical.sparse_relax_sweep.launches > before
    with pytest.raises(Kill):
        run_sweep_job(g, srcs, device=cuda, checkpoint_dir=str(tmp_path),
                      on_chunk=kill, **kw)
    res = run_sweep_job(g, srcs, device=cuda, checkpoint_dir=str(tmp_path),
                        **kw)
    cpu = run_sweep_job(g, srcs, device="cpu", **kw)
    assert (res.chunks_restored, res.chunks_computed, res.restored_step) \
        == (2, 2, 2)
    for r in (res, cpu):
        np.testing.assert_array_equal(r.dist, full.dist)
        assert (r.sweeps, r.edges_touched) == (full.sweeps, full.edges_touched)
        np.testing.assert_array_equal(r.direction_counts,
                                      full.direction_counts)
    leaf = torch.arange(1 << 20, dtype=torch.float32, device=cuda)
    want = leaf.cpu().numpy().copy()
    t = C.save(str(tmp_path / "torn"), 1, {"x": leaf}, blocking=False)
    leaf.fill_(-1.0)
    t.join()
    got, _ = C.restore(str(tmp_path / "torn"), 1, {"x": leaf})
    np.testing.assert_array_equal(got["x"], want)


def test_tune_on_card_counts_ops_and_keeps_results(cuda, tmp_path):
    """``tune()`` on the card builds an op-count plan (the same unit costs
    as on the CPU: the plain forms dispatch the same ops on both) whose
    fused gate is open; the tuned default runs launch K3, K6 and K8 and
    equal the untuned ones bit for bit."""
    from repro_torch.core import autotune

    g = gen.rmat(10, 8, directed=False, seed=7, device="cpu")
    w = (np.random.default_rng(7).integers(4, 33, g.m_pad) / 8) \
        .astype(np.float32)
    h = repro_torch.prepare(g.to(cuda), weights=w)
    path = tmp_path / "plan.json"
    plan = h.tune(save=path)
    assert plan.source == "ops" and plan.fused_steps == -1
    assert plan.backend == autotune.device_fingerprint(cuda)
    assert all(plan.covers(sr) for sr in autotune.FORM_VOCAB)
    prof = autotune.backend_profile(plan.backend)
    cpu_plan = autotune.build_plan(
        repro_torch.prepare(g, weights=w, device="cpu").prepared(),
        weights=w, profile=prof)
    assert cpu_plan.unit_costs == plan.unit_costs
    assert autotune.TuningPlan.load(path) == plan
    srcs = np.arange(0, g.n_nodes, 9)
    base = repro_torch.prepare(g.to(cuda), weights=w)
    tuned = repro_torch.prepare(g.to(cuda), weights=w, tuning=str(path))
    for semiring, kern in (("boolean", bovm.fused_boolean_multisweep),
                           ("counting", counting.fused_counting_multisweep),
                           ("tropical", tropical.fused_minplus_multisweep)):
        want = base.apsp(srcs, semiring=semiring)
        before = kern.launches
        got = tuned.apsp(srcs, semiring=semiring)
        assert kern.launches > before, semiring
        assert torch.equal(got.dist, want.dist) and \
            got.sweeps == want.sweeps, semiring
        if semiring == "counting":
            assert torch.equal(got.sigma, want.sigma)


@pytest.fixture
def nccl_mesh(cuda, tmp_path):
    """A (1, 1) ``(data, model)`` mesh on NCCL at world size 1; the
    process group is destroyed after the test."""
    import datetime
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_mesh
    dist.init_process_group(
        "nccl", init_method=f"file://{tmp_path}/store", rank=0,
        world_size=1, timeout=datetime.timedelta(seconds=120))
    try:
        yield make_mesh((1, 1), ("data", "model"))
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("semiring,mode,kernel", [
    ("boolean", "dense", "packed_push_sweep"),
    ("boolean", "sparse", None),
    ("counting", "dense", "fused_counting_sweep"),
    ("counting", "sparse", None),
    ("tropical", "dense", "fused_minplus_sweep"),
    ("tropical", "sparse", "sparse_relax_sweep"),
])
def test_sharded_executor_on_card_equals_the_engines(nccl_mesh, semiring,
                                                     mode, kernel):
    """``sharded_apsp`` at world size 1 on NCCL equals the engine's pinned
    run on the card and on the CPU bit for bit, and launches its kernel
    (K1, K5, K7, K9) without building an index after ``prepare_sharded``;
    the boolean dense form with ``fused_steps=-1`` launches K3."""
    from repro_torch.core.distributed import (ShardedConfig,
                                              prepare_sharded, sharded_apsp)
    g = gen.rmat(9, 6, directed=False, seed=5, device="cpu")
    w = (np.random.default_rng(0).integers(4, 33, g.m_pad) / 8) \
        .astype(np.float32)
    srcs = np.arange(0, 512, 3)
    single_mode = {"dense": "push" if semiring != "tropical" else "dense",
                   "sparse": "sparse"}[mode]
    weights = w if semiring == "tropical" else None
    wants = [repro_torch.prepare(g.to(dev), weights=weights, mode=single_mode,
                                 source_batch=64, device=dev)
             .apsp(srcs, semiring=semiring) for dev in ("cpu", "cuda")]
    all_k = {k.__name__: k for k in (
        bovm.packed_push_sweep, bovm.fused_boolean_multisweep,
        bovm.packed_live_words, counting.fused_counting_sweep,
        counting.nonzero_words, tropical.fused_minplus_sweep,
        tropical.sparse_relax_sweep, tropical.finite_words,
        tropical.in_lanes)}
    configs = [ShardedConfig(semiring=semiring, mode=mode)]
    if semiring == "boolean" and mode == "dense":
        configs.append(ShardedConfig(mode="dense", fused_steps=-1))
    for cfg in configs:
        ops = prepare_sharded(g, nccl_mesh, weights=weights, config=cfg)
        assert ops.use_kernel and ops.device.type == "cuda"
        before = {n: k.launches for n, k in all_k.items()}
        res = sharded_apsp(ops, srcs)
        got = {n: k.launches - before[n] for n, k in all_k.items()}
        want_kernel = "fused_boolean_multisweep" if cfg.fused_steps \
            else kernel
        if want_kernel is not None:
            assert got[want_kernel] > 0, (cfg, got)
        assert not any(got[n] for n in ("packed_live_words", "nonzero_words",
                                        "finite_words", "in_lanes")), got
        for want in wants:
            assert torch.equal(res.dist.cpu(), want.dist.cpu())
            assert res.sweeps == want.sweeps
            if semiring == "counting":
                assert torch.equal(res.sigma.cpu(), want.sigma.cpu())
        pinned = [res.sweeps, 0] if mode == "dense" else [0, res.sweeps]
        assert res.direction_counts.tolist() == pinned


def test_kernels_on_k_row_blocks_match_plain(cuda):
    """What ranks of a C = 2 mesh launch: K1, K5 and K7 on each K-row
    block and K9 on each part of the lanes equal their plain versions on
    the CPU, and the blocks' OR / SUM of gated partials / MIN equals the
    full operand's call."""
    from repro_torch.core import distributed as D
    from repro_torch.graph.partition import edge_partition_global
    g = gen.rmat(9, 6, directed=False, seed=5, device="cuda")
    w = torch.from_numpy((np.random.default_rng(1).integers(4, 33, g.m_pad)
                          / 8).astype(np.float32)).to(cuda)
    C = 2
    n_pad = g.n_padded(128 * C)
    nk = n_pad // C
    s, step = 32, 3
    f, d = _state(7, s, n_pad, density=0.05, visited=0.3)
    f, d = f.to(cuda), d.to(cuda)
    d[:, g.n_nodes:] = 0

    def cpu(t):
        return t.cpu() if isinstance(t, torch.Tensor) else t

    def block(semiring, c, packed=False):
        return D._dense_block(g, n_pad, c * nk, nk, semiring,
                              w if semiring == "tropical" else None, packed)

    def both(fn, *args, **kw):
        got = fn(*args, **kw)
        want = fn(*[cpu(a) for a in args], **kw)
        _same(want, got)
        return got

    # K1: OR of the new bits
    full = D._dense_block(g, n_pad, 0, n_pad, "boolean", None, True)
    new_full, d_full = bovm.packed_push_sweep(pack_bits(f), full, d, step,
                                              bs=s, wk=4)
    acc = torch.zeros_like(new_full)
    for c in range(C):
        new_c, _ = both(bovm.packed_push_sweep,
                        pack_bits(f[:, c * nk: (c + 1) * nk]),
                        block("boolean", c, True), d, step, bs=s, wk=4)
        acc |= new_c
    assert torch.equal(acc, new_full)
    assert torch.equal(torch.where(acc != 0, step, d), d_full)
    # K5: the SUM of the gated partials
    sg = torch.where(d >= 0, 1.0, 0.0).to(cuda)
    fs = torch.where(f != 0, sg, 0.0)
    full = D._dense_block(g, n_pad, 0, n_pad, "counting", None, False)
    want = counting.fused_counting_sweep(fs, full, d, sg, step, bs=s)
    cand = torch.zeros_like(sg)
    for c in range(C):
        new_c, _, sg_c = both(counting.fused_counting_sweep,
                              fs[:, c * nk: (c + 1) * nk].contiguous(),
                              block("counting", c), d, sg, step, bs=s)
        cand += torch.where(new_c != 0, sg_c, 0.0)
    new = (cand > 0) & (d < 0)
    _same(want, (new.to(torch.int8), torch.where(new, step, d),
                 torch.where(new, cand, sg)))
    # K7 and K9: MIN
    df = torch.where(d >= 0, d.to(torch.float32), float("inf"))
    fd = torch.where(f != 0, df, float("inf"))
    w_min = w.min()
    full = D._dense_block(g, n_pad, 0, n_pad, "tropical", w, False)
    want = tropical.fused_minplus_sweep(fd, full, df, w_min, bs=s)
    nd = torch.full_like(df, float("inf"))
    for c in range(C):
        _, nd_c = both(tropical.fused_minplus_sweep,
                       fd[:, c * nk: (c + 1) * nk].contiguous(),
                       block("tropical", c), df, w_min, bs=s)
        nd = torch.minimum(nd, nd_c)
    _same(want, ((nd < df).to(torch.int8), nd))
    want = tropical.sparse_relax_sweep(f, df, g.src, g.dst, w)
    parts = edge_partition_global(g, C, weights=w)
    nd = torch.full_like(df, float("inf"))
    for c in range(C):
        ps, pd, pw = (parts[k][c].contiguous() for k in ("src", "dst", "w"))
        _, nd_c = both(tropical.sparse_relax_sweep, f, df, ps, pd, pw)
        nd = torch.minimum(nd, nd_c)
    _same(want, ((nd < df).to(torch.int8), nd))


def _kronecker_graph(scale: int, device) -> CSRGraph:
    """Graph500's Kronecker graph at ``scale`` from the benchmark's
    generator (``bench/gen/kronecker.py``, graph seed 0), loaded with both
    directions of every tuple as the benchmark loads it."""
    from bench.gen import kronecker
    cfg = {"scale": scale, "edgefactor": 16, "a": 0.57, "b": 0.19,
           "c": 0.19}
    src, dst, n = kronecker.generate(cfg, 0, device)
    s = torch.cat([src, dst]).cpu().numpy()
    d = torch.cat([dst, src]).cpu().numpy()
    return CSRGraph.from_edges(s, d, n, device=device)


def test_kron20_block_builds_in_little_more_than_itself(cuda):
    """One rank's K-row block of Graph500 SCALE 20 on a (1, 4) mesh (k0 =
    0, nk = 262,272): 32 GiB of packed words, built with under 2 GiB on
    the card beside the graph and the block itself; at SCALE 16 each of
    the four blocks equals the int64 build it replaced."""
    from test_torch_mesh_block import int64_build
    g = _kronecker_graph(16, cuda)
    n_pad = g.n_padded(128 * 4)
    nk = n_pad // 4
    for c in range(4):
        assert torch.equal(g.to_pull_packed_block(n_pad, c * nk, nk),
                           int64_build(g, n_pad, c * nk, nk))
    del g
    g = _kronecker_graph(20, cuda)
    n_pad = g.n_padded(128 * 4)
    nk = n_pad // 4
    assert (n_pad, nk) == (1_049_088, 262_272)
    torch.cuda.synchronize(cuda)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(cuda)
    base = torch.cuda.memory_allocated(cuda)
    block = g.to_pull_packed_block(n_pad, 0, nk)
    torch.cuda.synchronize(cuda)
    held = block.numel() * block.element_size()
    over = torch.cuda.max_memory_allocated(cuda) - base - held
    print(f"kron20 block: lanes {g.n_edges}, block {held} B, peak above "
          f"the graph and the block {over} B")
    assert block.shape == (1_049_088, 8_196)
    assert held == 34_393_300_992
    assert over < 2 * 2**30
    assert bool((block != 0).any())


def test_a_device_span_reads_the_cards_clock(cuda):
    """Under the profiler ``trace.device_span`` times the work it enqueued
    on the card: a sleep kernel's tens of milliseconds, where the host
    returns from the launch at once."""
    import time

    from repro_torch import trace
    trace.reset()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]):
        # the profiler's first launch on the card sets up its device
        # tracing on the host (most of a second): not the span's work
        torch.cuda._sleep(1000)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with trace.device_span("dawn.mesh.gather", cuda):
            torch.cuda._sleep(50_000_000)
        host = time.perf_counter() - t0
    got = trace.snapshot()["window"]["spans"]["dawn.mesh.gather"]
    trace.reset()
    print(f"device span {got['s']} s, host {host} s")
    assert got["n"] == 1
    assert got["s"] > 0.01 and got["s"] > 5 * host


def test_loaders_default_to_the_card_and_equal_the_cpu_load(cuda, tmp_path):
    """``load_mtx`` / ``load_edgelist`` with no ``device`` put the graph
    and its lane weights on the card, equal to the CPU load; the loaded
    graph runs K1 (pinned push) and K9 (tropical sparse) there."""
    from repro_torch.graph import io as gio
    g = gen.rmat(9, 6, directed=False, seed=3, device="cpu")
    w = torch.from_numpy((np.random.default_rng(3).integers(
        4, 33, g.m_pad) / 8).astype(np.float32))
    mtx, txt = str(tmp_path / "g.mtx"), str(tmp_path / "g.txt")
    gio.save_mtx(g, mtx, weights=w)
    gio.save_edgelist(g, txt, weights=w)
    # the .mtx last: its graph keeps rmat's node count for the runs (an
    # edge list holds the nodes up to the largest id with an edge)
    for load in (lambda **kw: gio.load_edgelist(txt, weighted=True, **kw),
                 lambda **kw: gio.load_mtx(mtx, return_weights=True, **kw)):
        (gc, wc), (gh, wh) = load(), load(device="cpu")
        assert gc.device.type == "cuda" and wc.device.type == "cuda"
        for k in CSRGraph.ARRAYS:
            assert torch.equal(getattr(gc, k).cpu(), getattr(gh, k))
        assert torch.equal(wc.cpu(), wh)
    srcs = [0, 7, 100, 511]
    before = bovm.packed_push_sweep.launches
    got = repro_torch.prepare(gc, mode="push", use_kernel=True).apsp(srcs)
    assert bovm.packed_push_sweep.launches > before
    want = repro_torch.prepare(gh, device="cpu", mode="push").apsp(srcs)
    assert torch.equal(got.dist.cpu(), want.dist)
    before = tropical.sparse_relax_sweep.launches
    got = repro_torch.prepare(gc, weights=wc, mode="sparse",
                              use_kernel=True).apsp(srcs, semiring="tropical")
    assert tropical.sparse_relax_sweep.launches > before
    want = repro_torch.prepare(gh, weights=wh, device="cpu",
                               mode="sparse").apsp(srcs, semiring="tropical")
    assert torch.equal(got.dist.cpu(), want.dist)


def test_sampler_on_card_takes_a_cuda_generator(cuda):
    """Samples on the card come from a CUDA generator (a CPU one is
    refused), are true out-neighbours, and map draws as on the CPU."""
    from repro_torch.graph import sampler as S
    g = gen.rmat(9, 4, directed=True, seed=5, device="cpu")
    gc = g.to(cuda)
    seeds = torch.arange(0, 512, 5, dtype=torch.int32)
    layers = S.sample_subgraph(gc, seeds, torch.Generator(
        device=cuda).manual_seed(0), (6, 3))
    assert all(l.device.type == "cuda" for l in layers)
    indptr, indices = g.indptr.numpy(), g.indices.numpy()
    for h in range(2):
        par = layers[h].cpu().numpy()
        kids = layers[h + 1].cpu().numpy().reshape(len(par), -1)
        for p, row in zip(par, kids):
            nbrs = indices[indptr[p]:indptr[p + 1]]
            assert (np.isin(row, nbrs) if len(nbrs) else row == p).all()
    with pytest.raises(RuntimeError):
        S.sample_hop(gc, seeds, torch.Generator(), 4)
    r = torch.randint(0, 2 ** 31 - 1, (len(seeds), 4), dtype=torch.int32)
    assert torch.equal(S._hop_from_draws(gc, seeds.to(cuda), r.to(cuda))
                       .cpu(), S._hop_from_draws(g, seeds, r))
