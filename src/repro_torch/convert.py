"""Carry a graph, or a repair state, across from the JAX package.

The graph is the state both packages share: a test builds it once with
the JAX package, hands its six CSR arrays over as numpy arrays, and runs
both engines on the same lanes.  An incremental repair state crosses the
same way, so that the port's ``repair`` can be held against the
reference's on one input state.
"""
from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from .core.incremental import IncrementalState
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


def lane_weights_from_array(lanes: np.ndarray, *, n_edges: int, m_pad: int,
                            device=None) -> torch.Tensor:
    """The port's (m_pad,) float32 lane weights from the JAX side's
    (``CSRGraph.from_weighted_edges`` or ``PreparedWeightedGraph.w_edges``),
    given as a numpy array, on ``device`` (``None``: the card).  The
    padded lanes ``[n_edges:]`` must hold +inf."""
    dev = resolve_device(device)
    a = np.asarray(lanes)
    if a.shape != (m_pad,):
        raise ValueError(f"lanes: shape {a.shape}, expected ({m_pad},)")
    a = np.array(a, dtype=np.float32, copy=True)
    if not np.all(np.isposinf(a[n_edges:])):
        raise ValueError("lanes: the padded lanes must hold +inf")
    return torch.from_numpy(a).to(dev)


def incremental_state_from(state, *, device=None) -> IncrementalState:
    """The port's :class:`IncrementalState` from the JAX side's (its
    ``sources``, ``dist``, ``parent``, ``weighted`` and ``epoch``, the
    arrays as numpy arrays), with ``dist`` and ``parent`` on ``device``
    (``None``: the card)."""
    dev = resolve_device(device)
    dist = np.array(state.dist, dtype=np.float32, copy=True)
    parent = np.array(state.parent, dtype=np.int32, copy=True)
    if dist.shape != parent.shape or dist.ndim != 2:
        raise ValueError(f"dist {dist.shape} and parent {parent.shape}: "
                         f"expected one (S, n) shape")
    return IncrementalState(
        sources=np.array(state.sources, dtype=np.int32, copy=True),
        dist=torch.from_numpy(dist).to(dev),
        parent=torch.from_numpy(parent).to(dev),
        weighted=bool(state.weighted), epoch=int(state.epoch))
