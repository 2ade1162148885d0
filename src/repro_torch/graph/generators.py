"""Synthetic graph families matched to the paper's evaluation suite
(the port's own copy of the numpy generators).

SuiteSparse / Gunrock datasets are not available offline, so the benchmark
suite reproduces the paper's graph *families* instead:

  - ``grid2d``        road-network-like: high diameter, degree ≤ 4
  - ``rmat``          scale-free / social-network-like (Graph500 RMAT)
  - ``watts_strogatz``small-world: low diameter, high clustering
                      (the paper's citation/collaboration regime, §4.3)
  - ``erdos_renyi``   uniform random
  - ``ba``            preferential attachment (web-like)
  - ``disconnected``  many WCCs — exercises the O(E_wcc) claims
  - ``mycielskian``   dense low-diameter (paper's mycielskian16 case)

All generators are deterministic in ``seed``, draw their edges on the
host with numpy, and return the port's :class:`CSRGraph` on ``device``
(``None`` means the card; pass ``device="cpu"`` to stay on the host).
"""
from __future__ import annotations

import numpy as np

from .csr import CSRGraph, symmetrize


def erdos_renyi(n: int, avg_degree: float, *, seed: int = 0,
                directed: bool = True, device=None) -> CSRGraph:
    rng = np.random.default_rng(seed)
    m = int(n * avg_degree)
    src = rng.integers(0, n, size=m)
    dst = rng.integers(0, n, size=m)
    if not directed:
        src, dst = symmetrize(src, dst)
    return CSRGraph.from_edges(src, dst, n, device=device)


def grid2d(rows: int, cols: int, *, seed: int = 0, device=None) -> CSRGraph:
    """4-connected grid — road-network stand-in (diameter rows+cols)."""
    del seed
    r, c = np.meshgrid(np.arange(rows), np.arange(cols), indexing="ij")
    vid = (r * cols + c).ravel()
    src, dst = [], []
    right = vid.reshape(rows, cols)[:, :-1].ravel()
    src.append(right); dst.append(right + 1)
    down = vid.reshape(rows, cols)[:-1, :].ravel()
    src.append(down); dst.append(down + cols)
    src = np.concatenate(src); dst = np.concatenate(dst)
    src, dst = symmetrize(src, dst)
    return CSRGraph.from_edges(src, dst, rows * cols, device=device)


def rmat(scale: int, edge_factor: int = 16, *, seed: int = 0,
         a: float = 0.57, b: float = 0.19, c: float = 0.19,
         directed: bool = True, device=None) -> CSRGraph:
    """Graph500-style RMAT: scale-free, power-law degrees."""
    rng = np.random.default_rng(seed)
    n = 1 << scale
    m = n * edge_factor
    src = np.zeros(m, dtype=np.int64)
    dst = np.zeros(m, dtype=np.int64)
    for bit in range(scale):
        u = rng.random(m)
        v = rng.random(m)
        src_bit = u > (a + b)
        dst_bit = np.where(src_bit, v > (c / (c + (1 - a - b - c))),
                           v > (a / (a + b)))
        src |= src_bit.astype(np.int64) << bit
        dst |= dst_bit.astype(np.int64) << bit
    if not directed:
        src, dst = symmetrize(src, dst)
    return CSRGraph.from_edges(src, dst, n, device=device)


def watts_strogatz(n: int, k: int = 6, p: float = 0.1, *,
                   seed: int = 0, device=None) -> CSRGraph:
    """Small-world ring lattice with rewiring — paper's low-ε regime."""
    rng = np.random.default_rng(seed)
    base = np.arange(n)
    src, dst = [], []
    for off in range(1, k // 2 + 1):
        s = base
        d = (base + off) % n
        rewire = rng.random(n) < p
        d = np.where(rewire, rng.integers(0, n, size=n), d)
        src.append(s); dst.append(d)
    src = np.concatenate(src); dst = np.concatenate(dst)
    src, dst = symmetrize(src, dst)
    return CSRGraph.from_edges(src, dst, n, device=device)


def barabasi_albert(n: int, m_attach: int = 4, *, seed: int = 0,
                    device=None) -> CSRGraph:
    rng = np.random.default_rng(seed)
    targets = list(range(m_attach))
    repeated: list[int] = list(range(m_attach))
    src, dst = [], []
    for v in range(m_attach, n):
        picks = rng.choice(repeated, size=m_attach, replace=False) \
            if len(set(repeated)) >= m_attach else list(targets)[:m_attach]
        for t in np.atleast_1d(picks):
            src.append(v); dst.append(int(t))
            repeated.extend([v, int(t)])
    src = np.asarray(src); dst = np.asarray(dst)
    src, dst = symmetrize(src, dst)
    return CSRGraph.from_edges(src, dst, n, device=device)


def disconnected(n_components: int, comp_size: int, avg_degree: float = 4.0,
                 *, seed: int = 0, device=None) -> CSRGraph:
    """Union of ER components + isolated nodes — non-connected-graph regime
    where DAWN's O(E_wcc(i)) beats global-m bounds (paper §3.3)."""
    rng = np.random.default_rng(seed)
    src, dst = [], []
    for ci in range(n_components):
        base = ci * comp_size
        size = max(2, comp_size - (ci % 3))  # slightly ragged components
        mi = int(size * avg_degree)
        s = rng.integers(0, size, size=mi) + base
        d = rng.integers(0, size, size=mi) + base
        src.append(s); dst.append(d)
    n = n_components * comp_size + 8  # + isolated nodes
    src = np.concatenate(src); dst = np.concatenate(dst)
    src, dst = symmetrize(src, dst)
    return CSRGraph.from_edges(src, dst, n, device=device)


def mycielskian(k: int, *, device=None) -> CSRGraph:
    """Mycielskian iteration from K2 — dense, diameter 2 at high k.
    Node count 3·2^(k-2) - 1; we cap k ≤ 12 for test budgets."""
    src = np.array([0]); dst = np.array([1])
    n = 2
    for _ in range(max(0, k - 2)):
        # nodes: originals [0,n), shadows [n,2n), apex 2n
        s2 = np.concatenate([src, src, dst + n])
        d2 = np.concatenate([dst, dst + n, src])
        apex_s = np.arange(n, 2 * n)
        s2 = np.concatenate([s2, apex_s])
        d2 = np.concatenate([d2, np.full(n, 2 * n)])
        src, dst, n = s2, d2, 2 * n + 1
    src, dst = symmetrize(src, dst)
    return CSRGraph.from_edges(src, dst, n, device=device)


def bipartite_sessions(n_users: int, n_items: int, clicks_per_user: int, *,
                       seed: int = 0, device=None) -> CSRGraph:
    """User→item click graph (recsys candidate-expansion example)."""
    rng = np.random.default_rng(seed)
    users = np.repeat(np.arange(n_users), clicks_per_user)
    # zipf-ish item popularity
    items = (rng.zipf(1.3, size=len(users)) % n_items) + n_users
    src, dst = symmetrize(users, items)
    return CSRGraph.from_edges(src, dst, n_users + n_items, device=device)


# the paper's experiment families; each entry takes the device (``None``:
# the card)
SUITE = {
    "grid_road_sm": lambda device=None: grid2d(64, 64, device=device),
    "grid_road_md": lambda device=None: grid2d(180, 180, device=device),
    "rmat_social_sm": lambda device=None: rmat(10, 8, directed=False, seed=1,
                                               device=device),
    "rmat_social_md": lambda device=None: rmat(13, 12, directed=False,
                                               seed=2, device=device),
    "ws_citation_sm": lambda device=None: watts_strogatz(
        4096, 8, 0.05, seed=3, device=device),
    "ws_citation_md": lambda device=None: watts_strogatz(
        20000, 10, 0.08, seed=4, device=device),
    "er_uniform_sm": lambda device=None: erdos_renyi(
        4096, 6.0, directed=False, seed=5, device=device),
    "ba_web_sm": lambda device=None: barabasi_albert(4096, 4, seed=6,
                                                     device=device),
    "disconnected_sm": lambda device=None: disconnected(24, 160, 4.0, seed=7,
                                                        device=device),
    "mycielskian10": lambda device=None: mycielskian(10, device=device),
}
