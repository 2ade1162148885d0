"""Weakly connected components via min-label propagation.

The port of ``repro/core/wcc.py``: S_wcc / E_wcc(i) — the quantities in
DAWN's complexity bounds (Eqs. 10-12) — as the min-label semiring
instantiation of the shared sweep layer: one
:func:`repro_torch.core.sweep.minlabel_form` sweep over the symmetrized
edge lanes per iteration, Fact-1 ("no label lowered") termination through
the same ``sweep_loop`` driver as every other path, on the graph's
device.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..graph.csr import CSRGraph
from . import sweep as S


class WccResult(NamedTuple):
    labels: torch.Tensor   # (n,) int32 — component id = min node id in comp
    iters: int             # sweeps executed (the last one lowers nothing)


def wcc(g: CSRGraph, *, max_iters: Optional[int] = None) -> WccResult:
    n = g.n_nodes
    dev = g.device
    max_iters = n if max_iters is None else max_iters
    labels0 = torch.arange(n + 1, dtype=torch.int32, device=dev)
    # undirected propagation: min label flows along both edge directions
    src_sym = torch.cat([g.src, g.dst])
    dst_sym = torch.cat([g.dst, g.src])

    form = S.minlabel_form(src_sym, dst_sym)
    st = S.sweep_loop((form,),
                      S.make_state(torch.ones(n + 1, dtype=torch.int8,
                                              device=dev), labels0,
                                   n_forms=1),
                      max_steps=max_iters)
    return WccResult(st.dist[:n], st.step)


def wcc_stats(g: CSRGraph):
    """Host-side S_wcc, E_wcc and per-node component sizes (numpy)."""
    labels = wcc(g).labels.cpu().numpy()
    src, dst = g.edge_arrays_np()
    comp_ids, counts = np.unique(labels, return_counts=True)
    edge_comp = labels[src]
    edge_counts = {int(c): int((edge_comp == c).sum()) for c in comp_ids}
    node_counts = {int(c): int(k) for c, k in zip(comp_ids, counts)}
    largest = max(node_counts, key=lambda c: node_counts[c])
    return {
        "labels": labels,
        "S_wcc": node_counts[largest],
        "E_wcc": edge_counts.get(largest, 0),
        "S_wcc_of": lambda i: node_counts[int(labels[i])],
        "E_wcc_of": lambda i: edge_counts.get(int(labels[i]), 0),
        "n_components": len(comp_ids),
    }
