"""SOVM — Sparse Optimized boolean Vector-Matrix operation (paper Alg. 2).

The port of ``repro/core/sovm.py``.  The paper merges the CSR rows of
the frontier nodes (Eq. 9: the sweep result is the union of the frontier
rows), skipping targets already reached.  The fixed-shape equivalent is
edge-parallel masked propagation with a scatter-max:

    active[e] = frontier[src[e]]                       # gather
    hits      = scatter_or(active -> dst)              # Eq. 9 union
    new       = hits & (dist == UNREACHED)             # Thm 3.2 skip
    dist      = where(new, step, dist)

Padded edges carry src = dst = n (sentinel): ``frontier[n]`` stays 0 and
``dist[n]`` is pinned 0 (visited), so padding is inert without masks.

``sovm_sssp`` pins the sparse form — with in-loop parent tracking — into
the one ``sweep_loop`` driver.  Work accounting: the true SOVM work per
sweep is sum(out_degree[frontier]) (Eq. 10), tracked in
``edges_touched``.
"""
from __future__ import annotations

from typing import List, NamedTuple, Optional

import numpy as np
import torch

from ..graph.csr import CSRGraph
from . import sweep as S
from .frontier import UNREACHED


class SovmState(NamedTuple):
    """One source: tensors over real nodes, Python counters.  Stacked by
    :func:`sovm_msbfs`: one row per source and (S,) counter tensors."""
    frontier: torch.Tensor       # (n,) int8
    dist: torch.Tensor           # (n,) int32
    parent: torch.Tensor         # (n,) int32 — path reconstruction
    step: object                 # sweeps executed
    done: object                 # Fact 1 fired
    edges_touched: torch.Tensor  # float32 — Eq. 10 counter
    sweeps: object               # equals eccentricity at exit


def sovm_sweep(g: CSRGraph, frontier: torch.Tensor, dist: torch.Tensor):
    """One frontier expansion over (n+1,) sentinel-padded state.  Returns
    (new_frontier bool, parent_candidates int32)."""
    n = g.n_nodes
    src, dst = g.src.long(), g.dst.long()
    active = frontier[src] != 0                          # (m_pad,)
    hits = torch.zeros(n + 1, dtype=torch.int8, device=frontier.device)
    hits.index_reduce_(0, dst, active.to(torch.int8), "amax")   # scatter-OR
    new = (hits != 0) & (dist == UNREACHED)
    # parent: any active in-neighbour (max src id wins — deterministic)
    pcand = torch.full((n + 1,), -1, dtype=torch.int32,
                       device=frontier.device)
    pcand.index_reduce_(0, dst, torch.where(
        active, g.src, torch.tensor(-1, dtype=torch.int32,
                                    device=frontier.device)), "amax")
    return new, pcand


def sovm_sssp(g: CSRGraph, source, *,
              max_steps: Optional[int] = None) -> SovmState:
    """DAWN-SOVM single-source shortest paths.  O(E_wcc(i)) useful work."""
    n = g.n_nodes
    dev = g.device
    max_steps = n if max_steps is None else max_steps
    src = int(source)

    frontier0 = torch.zeros(n + 1, dtype=torch.int8, device=dev)
    frontier0[src] = 1
    dist0 = torch.full((n + 1,), UNREACHED, dtype=torch.int32, device=dev)
    dist0[src] = 0
    dist0[n] = 0
    parent0 = torch.full((n + 1,), -1, dtype=torch.int32, device=dev)
    deg = torch.cat([g.out_degrees().to(torch.float32),
                     torch.zeros(1, dtype=torch.float32, device=dev)])

    _, _, sparse = S.boolean_forms(None, None, g.src, g.dst, n_pad=n + 1,
                                   s=1, track_parent=True)
    st = S.sweep_loop((sparse,), S.make_state(frontier0, dist0, parent0,
                                              n_forms=1),
                      max_steps=max_steps, deg=deg, forced_dir=0)
    # drop the sentinel entry
    return SovmState(st.frontier[:n], st.dist[:n], st.parent[:n], st.step,
                     st.done, st.edges_touched, st.sweeps)


def sovm_msbfs(g: CSRGraph, sources, *,
               max_steps: Optional[int] = None) -> SovmState:
    """Multi-source SOVM: one independent :func:`sovm_sssp` per source,
    stacked (the JAX package vmaps the same loop).  For large S on dense
    graphs prefer the BOVM product path."""
    runs: List[SovmState] = [sovm_sssp(g, int(s), max_steps=max_steps)
                             for s in np.asarray(sources).reshape(-1)]
    dev = g.device

    def counter(name, dtype):
        return torch.tensor([getattr(r, name) for r in runs], dtype=dtype,
                            device=dev)

    return SovmState(
        frontier=torch.stack([r.frontier for r in runs]),
        dist=torch.stack([r.dist for r in runs]),
        parent=torch.stack([r.parent for r in runs]),
        step=counter("step", torch.int32),
        done=counter("done", torch.bool),
        edges_touched=torch.stack([r.edges_touched for r in runs]),
        sweeps=counter("sweeps", torch.int32))


def reconstruct_path(parent, source: int, target: int, max_len: int):
    """Host-side path reconstruction from the parent array: the node list
    from ``source`` to ``target``, ``None`` when the walk leaves the tree
    (or the walk as far as ``max_len`` steps took it)."""
    if isinstance(parent, torch.Tensor):
        parent = parent.cpu().numpy()
    parent = np.asarray(parent)
    path = [target]
    cur = target
    for _ in range(max_len):
        if cur == source:
            break
        cur = int(parent[cur])
        if cur < 0:
            return None
        path.append(cur)
    return path[::-1]
