"""The sharded executor's K-row block of packed in-neighbour words
(``CSRGraph.to_pull_packed_block``, which ``core.distributed._dense_block``
builds on the boolean kernel path): bit for bit the int64 build it
replaced and the matching column slice of ``to_pull_packed``, for every
rank of meshes with 1, 2 and 4 model shards, with no int64 temporary of
the block's size."""
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.core import distributed as D
from repro_torch.graph.csr import CSRGraph

N = 700
CASES = ("random", "duplicates_and_self_loops", "bit_31",
         "sources_in_the_first_rows", "no_edges")


def int64_build(g: CSRGraph, n_pad: int, k0: int, nk: int) -> torch.Tensor:
    """The block as the executor built it before: shifted ones summed into
    an int64 buffer of ``n_pad * nk / 32`` entries, then cast to int32."""
    keep = (g.src < g.n_nodes) & (g.src >= k0) & (g.src < k0 + nk)
    src, dst = g.src[keep].long() - k0, g.dst[keep].long()
    words = nk // 32
    key = torch.unique(dst * nk + src)
    dst, src = key // nk, key % nk
    out = torch.zeros(n_pad * words, dtype=torch.int64, device=g.device)
    out.index_add_(0, dst * words + (src >> 5),
                   torch.ones_like(src) << (src & 31))
    return out.to(torch.int32).view(n_pad, words)


def graph(case: str) -> CSRGraph:
    rng = np.random.default_rng(CASES.index(case))
    if case == "random":
        src, dst = rng.integers(0, N, 4000), rng.integers(0, N, 4000)
        return CSRGraph.from_edges(src, dst, N, device="cpu")
    if case == "duplicates_and_self_loops":
        src, dst = rng.integers(0, N, 1500), rng.integers(0, N, 1500)
        loops = rng.integers(0, N, 200)
        src = np.concatenate([src, src[:500], loops])
        dst = np.concatenate([dst, dst[:500], loops])
        return CSRGraph.from_edges(src, dst, N, dedup=False,
                                   remove_self_loops=False, device="cpu")
    if case == "bit_31":
        # every source is 31 mod 32: each live word has its sign bit set
        src = rng.choice(np.arange(31, N, 32), 1500)
        return CSRGraph.from_edges(src, rng.integers(0, N, 1500), N,
                                   device="cpu")
    if case == "sources_in_the_first_rows":
        # the blocks of columns 128 and up hold no lanes
        src = rng.integers(0, 100, 800)
        return CSRGraph.from_edges(src, rng.integers(0, N, 800), N,
                                   device="cpu")
    assert case == "no_edges"
    return CSRGraph.from_edges(np.zeros(0, np.int64), np.zeros(0, np.int64),
                               N, device="cpu")


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("C", [1, 2, 4])
def test_block_equals_the_int64_build_and_the_slice(C, case):
    g = graph(case)
    n_pad = g.n_padded(128 * C)
    nk = n_pad // C
    full = g.to_pull_packed(n_pad)
    lanes = []
    for c in range(C):
        k0 = c * nk
        block = g.to_pull_packed_block(n_pad, k0, nk)
        assert block.dtype == torch.int32
        assert block.shape == (n_pad, nk // 32)
        assert torch.equal(block, int64_build(g, n_pad, k0, nk))
        assert torch.equal(block, full[:, k0 // 32: (k0 + nk) // 32])
        assert torch.equal(block, D._dense_block(g, n_pad, k0, nk, "boolean",
                                                 None, True))
        lanes.append(int(block.ne(0).sum()))
    if case == "bit_31":
        assert bool((full < 0).any())
    if case == "sources_in_the_first_rows" and C > 1:
        assert lanes[0] > 0 and lanes[1:] == [0] * (C - 1)
    if case == "no_edges":
        assert lanes == [0] * C


class _Int64Outputs(TorchDispatchMode):
    """The element counts of every int64 tensor an aten op returns."""

    def __init__(self):
        super().__init__()
        self.sizes = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in out if isinstance(out, (tuple, list)) else (out,):
            if isinstance(t, torch.Tensor) and t.dtype == torch.int64:
                self.sizes.append(t.numel())
        return out


@pytest.mark.parametrize("C", [1, 2, 4])
def test_no_int64_temporary_of_the_block_size(C):
    """Every int64 temporary grows with the block's lanes; the int64
    build made one of the block's size (seen by the same probe)."""
    rng = np.random.default_rng(C)
    n = 3000
    g = CSRGraph.from_edges(rng.integers(0, n, 300), rng.integers(0, n, 300),
                            n, device="cpu")
    n_pad = g.n_padded(128 * C)
    nk = n_pad // C
    entries = n_pad * nk // 32
    for c in range(C):
        with _Int64Outputs() as new:
            block = g.to_pull_packed_block(n_pad, c * nk, nk)
        with _Int64Outputs() as old:
            want = int64_build(g, n_pad, c * nk, nk)
        assert torch.equal(block, want)
        assert max(new.sizes) <= g.m_pad < entries
        assert max(old.sizes) == entries


@pytest.mark.parametrize("k0,nk", [(-32, 64), (0, 2080), (1024, 64)])
def test_columns_outside_the_operand_are_refused(k0, nk):
    g = graph("random")
    with pytest.raises(ValueError, match="outside n_pad"):
        g.to_pull_packed_block(g.n_padded(), k0, nk)
