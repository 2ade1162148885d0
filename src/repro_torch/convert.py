"""Carry a graph across from the JAX package.

The graph is the state both packages share: a test builds it once with
the JAX package, hands its six CSR arrays over as numpy arrays, and runs
both engines on the same lanes.
"""
from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from .graph.csr import CSRGraph, resolve_device


def csr_from_arrays(arrays: Mapping[str, np.ndarray], *, n_nodes: int,
                    n_edges: int, m_pad: int, device=None) -> CSRGraph:
    """The port's CSRGraph from the six arrays of a JAX ``CSRGraph``
    (``indptr``, ``indices``, ``src``, ``dst``, ``indptr_t``,
    ``indices_t``), given as numpy arrays, on ``device`` (``None``: the
    card)."""
    dev = resolve_device(device)
    missing = set(CSRGraph.ARRAYS) - set(arrays)
    if missing:
        raise ValueError(f"missing CSR arrays: {sorted(missing)}")
    tensors = {}
    for name in CSRGraph.ARRAYS:
        a = np.asarray(arrays[name])
        want = n_nodes + 1 if name.startswith("indptr") else m_pad
        if a.shape != (want,):
            raise ValueError(f"{name}: shape {a.shape}, expected ({want},)")
        tensors[name] = torch.from_numpy(
            np.array(a, dtype=np.int32, copy=True)).to(dev)
    return CSRGraph(**tensors, n_nodes=int(n_nodes), n_edges=int(n_edges),
                    m_pad=int(m_pad))
