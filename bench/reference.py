"""The plain reference: the benchmark's own view of a graph and a
breadth-first search over it, in plain PyTorch.

It works from the generator's tuples alone and imports nothing of the
system under test.  :class:`Graph` drops self-loops and duplicates,
symmetrizes, and holds the CSR the search walks, the degrees, the
connected components and, per component, the counts the yardstick reads
(undirected edges, CSR lanes, non-zero words of a packed bitmap).
:func:`bfs_rows` is a top-down, level-synchronous search over a list of
(row, vertex) pairs: a different algorithm from the system's sweeps.
"""
from __future__ import annotations

import torch

UNREACHED = -1
# (row, vertex) pairs one level of bfs_rows may hold at once, about
# 1 GiB of int64 keys: sets how many rows a block searches together
PAIR_BUDGET = 1 << 27


class Graph:
    """An undirected graph on ``n`` vertices from ``(src, dst)`` tuples
    (any device, any integer dtype), with everything the reference and
    the yardstick read."""

    def __init__(self, src: torch.Tensor, dst: torch.Tensor, n: int):
        src, dst = src.to(torch.int64), dst.to(torch.int64)
        keep = src != dst
        s = torch.cat([src[keep], dst[keep]])
        d = torch.cat([dst[keep], src[keep]])
        key = torch.unique(s * n + d)                      # sorted, distinct
        self.n = n
        self.src = key // n                                # lanes by source
        self.dst = key % n
        self.degree = torch.bincount(self.src, minlength=n)
        self.indptr = torch.zeros(n + 1, dtype=torch.int64,
                                  device=key.device)
        self.indptr[1:] = torch.cumsum(self.degree, 0)
        self.labels = components(self.src, self.dst, n)
        lab = self.labels[self.src]
        self.comp_lanes = torch.bincount(lab, minlength=n)
        self.comp_edges = self.comp_lanes // 2             # undirected
        # non-zero 32-bit words of the packed in-neighbour bitmap: row j
        # holds bit u % 32 of word u // 32 for every lane u -> j
        words = (n + 31) // 32
        wkey = torch.unique(self.dst * words + (self.src >> 5))
        self.comp_words = torch.bincount(self.labels[wkey // words],
                                         minlength=n)

    @property
    def device(self) -> torch.device:
        return self.src.device

    @property
    def n_lanes(self) -> int:
        return int(self.src.numel())


def components(src: torch.Tensor, dst: torch.Tensor, n: int) -> torch.Tensor:
    """Connected-component label of every vertex: the least vertex id of
    its component (min-label propagation with pointer jumping)."""
    lab = torch.arange(n, device=src.device)
    while True:
        new = lab.clone()
        new.scatter_reduce_(0, dst, lab[src], "amin")
        while True:                        # labels are ids of the component
            jumped = new[new]
            if torch.equal(jumped, new):
                break
            new = jumped
        if torch.equal(new, lab):
            return lab
        lab = new


def bfs_rows(g: Graph, sources, *, levels_short: int = 0) -> torch.Tensor:
    """(k, n) int32 hop distances from each source, ``-1`` unreached.

    ``levels_short`` > 0 is the control: each row reports its last
    ``levels_short`` levels unreached, as a search that stops early
    would."""
    srcs = torch.as_tensor(sources, dtype=torch.int64).reshape(-1)
    block = max(1, min(srcs.numel(), PAIR_BUDGET // max(1, g.n_lanes)))
    rows = [_bfs_block(g, srcs[i: i + block].to(g.device), levels_short)
            for i in range(0, srcs.numel(), block)]
    return torch.cat(rows)


def _bfs_block(g: Graph, srcs: torch.Tensor, levels_short: int):
    n, k = g.n, srcs.numel()
    dev = g.device
    dist = torch.full((k * n,), UNREACHED, dtype=torch.int32, device=dev)
    frontier = torch.arange(k, device=dev) * n + srcs      # row * n + vertex
    dist[frontier] = 0
    level = 0
    while frontier.numel():
        level += 1
        row, v = frontier // n, frontier % n
        first = g.indptr[v]
        deg = g.indptr[v + 1] - first
        total = int(deg.sum())
        if total == 0:
            break
        owner = torch.repeat_interleave(
            torch.arange(v.numel(), device=dev), deg, output_size=total)
        lane = torch.arange(total, device=dev) \
            - (torch.cumsum(deg, 0) - deg)[owner] + first[owner]
        key = row[owner] * n + g.dst[lane]
        key = key[dist[key] == UNREACHED]
        dist[key] = level                  # duplicate keys write one value
        frontier = torch.nonzero(dist == level).reshape(-1)
    dist = dist.view(k, n)
    if levels_short:
        far = dist.amax(dim=1, keepdim=True)
        cut = (dist > far - levels_short) & (dist > 0)
        dist = torch.where(cut, torch.full_like(dist, UNREACHED), dist)
    return dist
