"""The yardstick: the work a call asks for, counted by the benchmark from
its own graph (:class:`bench.reference.Graph`), never read from the
system under test, and the card's peaks it is held against.

Traversed edges follow Graph500's TEPS rule: a search from ``s``
traverses the undirected edges of ``s``'s connected component (here
without self-loops and duplicates).  The least bytes of a call read each
input byte once and write each output byte once, whatever form runs:

- the distance rows it returns: 4 B per returned source per vertex;
- the source ids: 4 B each;
- the adjacency of the vertices the call reaches, in the cheaper of the
  two layouts the port holds: 4 B per CSR lane, or 4 B per non-zero
  32-bit word of the packed in-neighbour bitmap.
"""
from __future__ import annotations

import torch

# HBM bandwidth by the name torch.cuda.get_device_name() gives (NVIDIA
# H100 SXM data sheet)
HBM_BYTES_PER_S = {"NVIDIA H100 80GB HBM3": 3.35e12}


def hbm_bytes_per_s(kind: str) -> float:
    if kind not in HBM_BYTES_PER_S:
        raise ValueError(f"no HBM peak for {kind!r}: "
                         f"{sorted(HBM_BYTES_PER_S)}")
    return HBM_BYTES_PER_S[kind]


def traversed_edges(g, sources) -> int:
    """Σ over ``sources`` of the undirected edges of each one's
    component."""
    s = torch.as_tensor(sources, dtype=torch.int64, device=g.device)
    return int(g.comp_edges[g.labels[s]].sum())


def call_bytes(g, sources) -> int:
    """The least bytes a call from ``sources`` reads and writes."""
    s = torch.as_tensor(sources, dtype=torch.int64,
                        device=g.device).reshape(-1)
    comps = torch.unique(g.labels[s])
    adjacency = min(int(g.comp_lanes[comps].sum()),
                    int(g.comp_words[comps].sum()))
    return 4 * s.numel() * g.n + 4 * s.numel() + 4 * adjacency


def least_seconds(n_bytes: int, kind: str) -> float:
    return n_bytes / hbm_bytes_per_s(kind)
