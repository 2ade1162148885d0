"""Vectorized graph IO: whitespace edge lists and MatrixMarket files (the
port's counterpart of ``repro/graph/io.py``, on the same file formats).

Loaders parse in chunks of ~1M lines through ``np.loadtxt`` (C tokenizer,
no per-line Python ``int()`` loop) so multi-GB edge lists stream without
holding a Python object per edge.  Weighted formats map straight onto the
tropical engine's lane layout: ``load_edgelist(..., weighted=True)`` and
MatrixMarket ``real``/``integer`` coordinate files return
``(CSRGraph, lane_weights)`` where ``lane_weights`` is an (m_pad,)
float32 tensor (+inf padded slots) on the graph's device — exactly what
``prepare(g, weights=...)`` consumes (duplicate edges min-reduce,
matching the dense operand).  The loaders put the graph on ``device``
(``None`` means the card; ``"cpu"`` to stay on the host).

The writers produce the same bytes as the JAX package's for the same
graph and weights (``%.9g`` round-trips float32 exactly, so lane weights
written and read back are the same bits).
"""
from __future__ import annotations

import itertools
from typing import Tuple, Union

import numpy as np
import torch

from .csr import CSRGraph, symmetrize

_CHUNK_LINES = 1 << 20


def _loadtxt_chunked(f, *, usecols, chunk_lines: int = _CHUNK_LINES
                     ) -> np.ndarray:
    """np.loadtxt over an open text file in bounded-size line chunks
    (comment lines beginning '#'/'%' are skipped by the C tokenizer)."""
    blocks = []
    while True:
        lines = list(itertools.islice(f, chunk_lines))
        if not lines:
            break
        arr = np.loadtxt(lines, comments=("#", "%"), usecols=usecols,
                         dtype=np.float64, ndmin=2)
        if arr.size:
            blocks.append(arr)
    if not blocks:
        return np.zeros((0, len(usecols)), np.float64)
    return np.concatenate(blocks, axis=0)


def _host_weights(weights, n_edges: int) -> np.ndarray:
    """The first ``n_edges`` weights as float64 on the host (a tensor on
    any device, or an array)."""
    if isinstance(weights, torch.Tensor):
        weights = weights.detach().cpu().numpy()
    return np.asarray(weights, np.float64)[:n_edges]


def load_edgelist(path: str, *, undirected: bool = False,
                  zero_indexed: bool = True, weighted: bool = False,
                  device=None
                  ) -> Union[CSRGraph, Tuple[CSRGraph, torch.Tensor]]:
    """Whitespace edge list -> CSRGraph (or (CSRGraph, lane_weights)
    with ``weighted=True``, reading the third column) on ``device``.
    Lines starting with '#' or '%' are comments; extra columns are
    ignored."""
    usecols = (0, 1, 2) if weighted else (0, 1)
    with open(path) as f:
        data = _loadtxt_chunked(f, usecols=usecols)
    src = data[:, 0].astype(np.int64)
    dst = data[:, 1].astype(np.int64)
    w = data[:, 2] if weighted else None
    if not zero_indexed:
        src -= 1
        dst -= 1
    n = int(max(src.max(), dst.max())) + 1 if len(src) else 1
    if undirected:
        src, dst = symmetrize(src, dst)
        if weighted:
            w = np.concatenate([w, w])
    if weighted:
        return CSRGraph.from_weighted_edges(src, dst, w, n, device=device)
    return CSRGraph.from_edges(src, dst, n, device=device)


def load_mtx(path: str, *, return_weights: bool = False, device=None
             ) -> Union[CSRGraph, Tuple[CSRGraph, torch.Tensor]]:
    """MatrixMarket coordinate pattern/real/integer square matrices as
    graphs on ``device``.  ``return_weights=True`` additionally returns
    the (m_pad,) float32 lane weights — the matrix values for
    ``real``/``integer`` fields, all-ones for ``pattern`` — aligned with
    the graph's padded CSR lanes."""
    with open(path) as f:
        header = f.readline().lower()
        symmetric = "symmetric" in header
        has_values = ("real" in header) or ("integer" in header)
        line = f.readline()
        while line.startswith("%"):
            line = f.readline()
        n_rows, n_cols, _ = (int(x) for x in line.split()[:3])
        usecols = (0, 1, 2) if (has_values and return_weights) else (0, 1)
        data = _loadtxt_chunked(f, usecols=usecols)
    src = data[:, 0].astype(np.int64) - 1
    dst = data[:, 1].astype(np.int64) - 1
    n = max(n_rows, n_cols)
    if return_weights:
        w = data[:, 2] if has_values else np.ones(len(src), np.float64)
        if symmetric:
            src, dst = symmetrize(src, dst)
            w = np.concatenate([w, w])
        return CSRGraph.from_weighted_edges(src, dst, w, n, device=device)
    if symmetric:
        src, dst = symmetrize(src, dst)
    return CSRGraph.from_edges(src, dst, n, device=device)


def save_edgelist(g: CSRGraph, path: str, *, weights=None) -> None:
    """Vectorized writer (np.savetxt).  ``weights`` (a tensor on any
    device, or an array) may cover the padded lanes (only the first
    ``n_edges`` are written, as a third column)."""
    src, dst = g.edge_arrays_np()
    header = f"nodes={g.n_nodes} edges={g.n_edges}"
    if weights is None:
        np.savetxt(path, np.stack([src, dst], axis=1), fmt="%d",
                   header=header)
    else:
        w = _host_weights(weights, g.n_edges)
        np.savetxt(path, np.stack([src, dst, w], axis=1),
                   fmt=("%d", "%d", "%.9g"), header=header)


def save_mtx(g: CSRGraph, path: str, *, weights=None) -> None:
    """MatrixMarket coordinate writer (general symmetry; ``weights``
    switches the field from ``pattern`` to ``real``)."""
    src, dst = g.edge_arrays_np()
    field = "pattern" if weights is None else "real"
    with open(path, "w") as f:
        f.write(f"%%MatrixMarket matrix coordinate {field} general\n")
        f.write(f"{g.n_nodes} {g.n_nodes} {g.n_edges}\n")
        if weights is None:
            np.savetxt(f, np.stack([src + 1, dst + 1], axis=1), fmt="%d")
        else:
            w = _host_weights(weights, g.n_edges)
            np.savetxt(f, np.stack([src + 1, dst + 1, w], axis=1),
                       fmt=("%d", "%d", "%.9g"))

