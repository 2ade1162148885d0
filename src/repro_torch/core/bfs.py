"""Baseline BFS implementations (the paper's comparison targets).

The port of ``repro/core/bfs.py``:

  * ``bfs_queue_numpy``      — textbook queue BFS (paper Alg. 3) in
                               Python/numpy on the host; the oracle.
  * ``bfs_scipy``            — scipy.sparse.csgraph's compiled BFS on the
                               host (the GAP stand-in).
  * ``bfs_level_sync_torch`` — level-synchronous BFS on the port's own
                               sweep layer, WITHOUT the Thm 3.2 skip:
                               every sweep relaxes every edge.  The
                               tropical sparse form with unit weights and
                               ``use_frontier=False``, which has no kernel
                               path, so it runs as torch ops on the
                               graph's device.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..graph.csr import CSRGraph
from . import sweep as S
from .frontier import UNREACHED


def bfs_queue_numpy(g: CSRGraph, source: int) -> np.ndarray:
    """Paper Alg. 3 — the oracle for all correctness tests."""
    indptr = g.indptr.cpu().numpy()
    indices = g.indices.cpu().numpy()
    n = g.n_nodes
    dist = np.full(n, -1, dtype=np.int32)
    dist[source] = 0
    queue = [source]
    for u in queue:                 # the FIFO: appended nodes are visited
        for e in range(indptr[u], indptr[u + 1]):
            v = indices[e]
            if v < n and dist[v] < 0:
                dist[v] = dist[u] + 1
                queue.append(v)
    return dist


def bfs_scipy(g: CSRGraph, source: int) -> np.ndarray:
    """Compiled-C BFS via scipy.sparse.csgraph (GAP stand-in)."""
    import scipy.sparse.csgraph as csgraph
    d = csgraph.shortest_path(g.to_scipy(), method="D", unweighted=True,
                              indices=source, directed=True)
    return np.where(np.isinf(d), -1, d).astype(np.int32)


class BfsState(NamedTuple):
    dist: torch.Tensor   # (n,) int32, -1 unreachable
    step: int            # sweeps executed
    done: bool           # Fact 1 fired


def bfs_level_sync_torch(g: CSRGraph, source, *,
                         max_steps: Optional[int] = None) -> BfsState:
    """Level-synchronous BFS without DAWN's skip: each sweep relaxes every
    edge (dist[dst] = min(dist[dst], dist[src] + 1)) — the matrix-substrate
    baseline DAWN is measured against.  Tropical semiring, unit weights,
    frontier gating off."""
    n = g.n_nodes
    dev = g.device
    max_steps = n if max_steps is None else max_steps
    dist0 = torch.full((n + 1,), float("inf"), dtype=torch.float32,
                       device=dev)
    dist0[int(source)] = 0.0
    w = torch.where(g.src < n, 1.0, float("inf")).to(torch.float32)

    _, sparse = S.tropical_forms(None, g.src, g.dst, w, use_frontier=False)
    st = S.sweep_loop((sparse,),
                      S.make_state(torch.ones(n + 1, dtype=torch.int8,
                                              device=dev), dist0,
                                   n_forms=1),
                      max_steps=max_steps)
    finite = torch.isfinite(st.dist)
    dist = torch.where(finite, st.dist, 0.0).to(torch.int32)
    dist = torch.where(finite, dist, UNREACHED)[:n]
    return BfsState(dist, st.step, st.done)
