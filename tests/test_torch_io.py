"""The port's graph IO (``repro_torch/graph/io.py``) against the JAX
package's (``repro/graph/io.py``) on the same files.

  * The loaders read MatrixMarket files (pattern / real / integer,
    general / symmetric, a header in any case, comments, a rectangular
    size, duplicates with different weights) and edge lists (0- and
    1-indexed, comments, extra columns, undirected, weighted, empty),
    and give the same six CSR arrays, sizes and lane weights, bit for
    bit; ``_loadtxt_chunked`` with chunks smaller than the file gives the
    same rows as one chunk, in both packages.
  * The writers give byte-identical files, and lane weights written and
    read back are the same float32 bits.
  * ``prepare(loaded, device="cpu").apsp`` equals ``repro.prepare`` on the
    same file (boolean pinned push, pull, sparse and fused push, tropical
    pinned dense and sparse): ``dist``, ``sweeps`` and
    ``direction_counts`` exact.
"""
import filecmp

import numpy as np
import pytest
import torch

import repro
import repro_torch
from repro.graph import generators as jgen
from repro.graph import io as jio
from repro_torch.graph import generators as tgen
from repro_torch.graph import io as tio

ARRAYS = ("indptr", "indices", "src", "dst", "indptr_t", "indices_t")


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
        got = getattr(tg, k)
        assert got.dtype == torch.int32, k
        np.testing.assert_array_equal(np.asarray(getattr(jg, k)),
                                      got.numpy(), err_msg=k)


def assert_same_lanes(jw, tw):
    assert tw.dtype == torch.float32 and tw.device == torch.device("cpu")
    jw = np.asarray(jw)
    assert jw.dtype == np.float32
    np.testing.assert_array_equal(jw.view(np.int32), tw.numpy().view(
        np.int32))


MTX = {
    "pattern_general": "%%MatrixMarket matrix coordinate pattern general\n"
                       "% a comment\n%\n5 5 6\n1 2\n2 3\n3 1\n4 5\n5 4\n"
                       "1 2\n",
    "real_general_dups": "%%MatrixMarket matrix coordinate real general\n"
                         "4 4 6\n1 2 2.5\n1 2 0.75\n2 3 1e-3\n3 4 7\n"
                         "4 1 0.1\n2 2 9\n",
    "integer_symmetric": "%%MatrixMarket matrix coordinate integer "
                         "symmetric\n6 6 5\n2 1 3\n3 2 4\n5 4 1\n6 5 8\n"
                         "4 1 2\n",
    "pattern_symmetric": "%%MatrixMarket matrix coordinate pattern "
                         "symmetric\n5 5 4\n2 1\n3 1\n4 3\n5 2\n",
    "real_symmetric_upper": "%%MATRIXMARKET MATRIX COORDINATE REAL "
                            "SYMMETRIC\n%% comment\n4 4 3\n2 1 0.5\n"
                            "3 2 1.25\n4 1 3.0000001\n",
    "rectangular": "%%MatrixMarket matrix coordinate real general\n"
                   "3 7 3\n1 7 1.5\n2 6 2.5\n3 1 0.5\n",
    "empty_body": "%%MatrixMarket matrix coordinate pattern general\n"
                  "3 3 0\n",
}

EDGES = {
    "zero_indexed": ("# nodes=5\n0 1\n1 2\n2 0\n3 4\n% mid comment\n4 3\n"
                     "0 1\n", dict()),
    "one_indexed": ("1 2\n2 3\n3 1\n5 4\n", dict(zero_indexed=False)),
    "undirected": ("0 1\n1 2\n2 3\n3 3\n", dict(undirected=True)),
    "extra_columns": ("0 1 7 x\n1 2 8 y\n", dict()),
    "weighted_dups": ("0 1 2.5\n0 1 0.5\n1 2 3\n2 0 1e-2\n1 1 4\n",
                      dict(weighted=True)),
    "weighted_undirected_1idx": ("1 2 0.25\n2 3 4\n3 4 1.5\n",
                                 dict(weighted=True, undirected=True,
                                      zero_indexed=False)),
    "empty": ("# nothing here\n", dict()),
    "empty_weighted": ("", dict(weighted=True)),
}


def _write(tmp_path, name, text):
    p = tmp_path / name
    p.write_text(text)
    return str(p)


@pytest.mark.parametrize("name", sorted(MTX))
@pytest.mark.parametrize("return_weights", [False, True])
def test_load_mtx_matches_jax(tmp_path, name, return_weights):
    path = _write(tmp_path, name + ".mtx", MTX[name])
    j = jio.load_mtx(path, return_weights=return_weights)
    t = tio.load_mtx(path, return_weights=return_weights, device="cpu")
    if return_weights:
        assert_same_graph(j[0], t[0])
        assert_same_lanes(j[1], t[1])
    else:
        assert_same_graph(j, t)


@pytest.mark.parametrize("name", sorted(EDGES))
def test_load_edgelist_matches_jax(tmp_path, name):
    text, kw = EDGES[name]
    path = _write(tmp_path, name + ".txt", text)
    j = jio.load_edgelist(path, **kw)
    t = tio.load_edgelist(path, device="cpu", **kw)
    if kw.get("weighted"):
        assert_same_graph(j[0], t[0])
        assert_same_lanes(j[1], t[1])
    else:
        assert_same_graph(j, t)


def test_known_answers(tmp_path):
    """The places to get right, read off the port's loaders directly."""
    def path(text):
        return _write(tmp_path, f"f{len(list(tmp_path.iterdir()))}", text)

    # an empty file is one node
    g = tio.load_edgelist(path(""), device="cpu")
    assert (g.n_nodes, g.n_edges) == (1, 0)
    # n = max(rows, cols); symmetric doubles edges and weights
    g, w = tio.load_mtx(path(MTX["rectangular"]), return_weights=True,
                        device="cpu")
    assert g.n_nodes == 7
    g, w = tio.load_mtx(path(MTX["real_symmetric_upper"]),
                        return_weights=True, device="cpu")
    assert g.n_edges == 6
    np.testing.assert_array_equal(
        np.sort(w[:6].numpy()),
        np.float32([0.5, 0.5, 1.25, 1.25, 3.0000001, 3.0000001]))
    # pattern with weights: all ones, +inf on padded lanes
    g, w = tio.load_mtx(path(MTX["pattern_general"]), return_weights=True,
                        device="cpu")
    assert g.n_edges == 5 and torch.all(w[:5] == 1)
    assert torch.all(torch.isinf(w[5:]))
    # duplicates min-reduce, self-loops go
    g, w = tio.load_edgelist(path(EDGES["weighted_dups"][0]), weighted=True,
                             device="cpu")
    assert g.n_edges == 3 and float(w[0]) == 0.5
    # 1-indexed lists subtract one
    g = tio.load_edgelist(path("1 2\n"), zero_indexed=False, device="cpu")
    assert (g.n_nodes, int(g.src[0]), int(g.dst[0])) == (2, 0, 1)


@pytest.mark.parametrize("chunk", [1, 3, 7, 1 << 20])
def test_loadtxt_chunks_smaller_than_the_file(tmp_path, chunk):
    rng = np.random.default_rng(chunk)
    rows = ["# header"] + [f"{a} {b} {c:.9g}" for a, b, c in zip(
        rng.integers(0, 40, 50), rng.integers(0, 40, 50),
        rng.uniform(0.1, 5.0, 50).astype(np.float32))]
    rows.insert(20, "% a comment between chunks")
    path = _write(tmp_path, "chunks.txt", "\n".join(rows) + "\n")
    for usecols in ((0, 1), (0, 1, 2)):
        with open(path) as f:
            want = jio._loadtxt_chunked(f, usecols=usecols, chunk_lines=chunk)
        with open(path) as f:
            got = tio._loadtxt_chunked(f, usecols=usecols, chunk_lines=chunk)
        with open(path) as f:
            whole = tio._loadtxt_chunked(f, usecols=usecols)
        assert got.shape == (50, len(usecols)) and got.dtype == np.float64
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, whole)


def _graph_pair(kind):
    if kind == "rmat":
        return (jgen.rmat(7, 6, directed=True, seed=3),
                tgen.rmat(7, 6, directed=True, seed=3, device="cpu"))
    return (jgen.grid2d(9, 11), tgen.grid2d(9, 11, device="cpu"))


@pytest.mark.parametrize("kind", ["rmat", "grid"])
@pytest.mark.parametrize("weighted", [False, True])
def test_writers_are_byte_identical(tmp_path, kind, weighted):
    jg, tg = _graph_pair(kind)
    assert_same_graph(jg, tg)
    w = None
    if weighted:
        w = np.random.default_rng(7).uniform(0.05, 9.0, jg.m_pad).astype(
            np.float32)
    tw = None if w is None else torch.from_numpy(w)
    for writer in ("save_mtx", "save_edgelist"):
        pj, pt = tmp_path / f"j.{writer}", tmp_path / f"t.{writer}"
        getattr(jio, writer)(jg, str(pj), weights=w)
        getattr(tio, writer)(tg, str(pt), weights=tw)
        assert filecmp.cmp(pj, pt, shallow=False), writer


@pytest.mark.parametrize("kind", ["rmat", "grid"])
def test_weights_round_trip_bit_for_bit(tmp_path, kind):
    _, tg = _graph_pair(kind)
    w = torch.from_numpy(np.random.default_rng(11).uniform(
        1e-3, 1e3, tg.m_pad).astype(np.float32))
    w[tg.n_edges:] = float("inf")
    pm, pe = str(tmp_path / "w.mtx"), str(tmp_path / "w.txt")
    tio.save_mtx(tg, pm, weights=w)
    tio.save_edgelist(tg, pe, weights=w)
    for g2, w2 in (tio.load_mtx(pm, return_weights=True, device="cpu"),
                   tio.load_edgelist(pe, weighted=True, device="cpu")):
        for k in ARRAYS:
            assert torch.equal(getattr(g2, k), getattr(tg, k)), k
        assert torch.equal(w2.view(torch.int32), w.view(torch.int32))
    # the unweighted forms and the 1-indexed edge list read back the same
    tio.save_mtx(tg, pm)
    assert_same_graph(tg, tio.load_mtx(pm, device="cpu"))
    src, dst = tg.edge_arrays_np()
    np.savetxt(pe, np.stack([src + 1, dst + 1], axis=1), fmt="%d")
    assert_same_graph(tg, tio.load_edgelist(pe, zero_indexed=False,
                                            device="cpu"))


# pinned modes: the CPU's default regime picks directions by wall clock
@pytest.mark.parametrize("opts", [dict(mode="push", use_kernel=True),
                                  dict(mode="pull", use_kernel=False),
                                  dict(mode="sparse", use_kernel=False),
                                  dict(mode="push", use_kernel=True,
                                       fused_steps=-1)])
def test_apsp_of_a_loaded_file_matches_jax(tmp_path, opts):
    jg = jgen.rmat(8, 6, directed=False, seed=2)
    path = str(tmp_path / "g.mtx")
    jio.save_mtx(jg, path)
    tg = tio.load_mtx(path, device="cpu")
    assert_same_graph(jio.load_mtx(path), tg)
    sources = [0, 5, 17, 200, 255]
    rj = repro.prepare(jio.load_mtx(path), **opts).apsp(sources)
    rt = repro_torch.prepare(tg, device="cpu", **opts).apsp(sources)
    np.testing.assert_array_equal(np.asarray(rj.dist), rt.dist.numpy())
    assert int(rj.sweeps) == rt.sweeps
    np.testing.assert_array_equal(np.asarray(rj.direction_counts),
                                  rt.direction_counts.numpy())


@pytest.mark.parametrize("mode", ["dense", "sparse"])
def test_tropical_apsp_of_a_loaded_file_matches_jax(tmp_path, mode):
    jg = jgen.barabasi_albert(180, 3, seed=5)
    w = (np.random.default_rng(5).integers(4, 33, jg.m_pad) / 8).astype(
        np.float32)
    path = str(tmp_path / "w.mtx")
    jio.save_mtx(jg, path, weights=w)
    jg2, jw = jio.load_mtx(path, return_weights=True)
    tg, tw = tio.load_mtx(path, return_weights=True, device="cpu")
    assert_same_graph(jg2, tg)
    assert_same_lanes(jw, tw)
    sources = [3, 0, 179, 64]
    rj = repro.prepare(jg2, weights=np.asarray(jw), mode=mode).apsp(
        sources, semiring="tropical")
    rt = repro_torch.prepare(tg, weights=tw, device="cpu", mode=mode).apsp(
        sources, semiring="tropical")
    np.testing.assert_array_equal(np.asarray(rj.dist), rt.dist.numpy())
    assert int(rj.sweeps) == rt.sweeps
    np.testing.assert_array_equal(np.asarray(rj.direction_counts),
                                  rt.direction_counts.numpy())


def test_loaders_default_to_the_card(tmp_path):
    """``device=None`` is the card: without CUDA the loaders raise, as
    every entry point of the port does."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: tests/test_torch_cuda.py holds "
                    "the loaders there")
    path = _write(tmp_path, "g.txt", "0 1\n1 2\n")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tio.load_edgelist(path)
    mtx = _write(tmp_path, "g.mtx", MTX["real_general_dups"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tio.load_mtx(mtx, return_weights=True)
