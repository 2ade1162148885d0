"""Fixed-shape CSR/CSC graph container on torch tensors.

The port's counterpart of ``repro/graph/csr.py``: the same six padded
int32 arrays, built on the host with numpy exactly as the JAX container
builds them (dedup, lexsort, ``m_pad`` rounded up to 128), then moved to
an explicit ``device``.

Padding convention: edge arrays are padded to ``m_pad`` entries; padded
slots hold ``src = dst = n_nodes`` (a sentinel row).  Frontier / distance
buffers are sized ``n_padded() >= n_nodes + 1`` so the sentinel indexes a
dead column.  Unlike JAX, which clamps an out-of-range gather, torch
raises on one, so the dead column is what keeps the sentinel lanes legal.
"""
from __future__ import annotations

import dataclasses
import typing
from typing import Optional, Tuple

import numpy as np
import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means the card.  A CUDA device without CUDA raises: the
    port never falls back to the CPU unless the caller asks for it."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the port on "
            "the CPU")
    return dev


def _round_up(x: int, mult: int) -> int:
    return ((x + mult - 1) // mult) * mult


class DegreeStats(typing.NamedTuple):
    """Static graph statistics feeding the engine's sweep cost model."""
    n_nodes: int
    n_edges: int
    avg_degree: float
    max_out_degree: int
    max_in_degree: int
    density: float


@dataclasses.dataclass(frozen=True)
class CSRGraph:
    """Padded CSR (+ COO + transpose/CSC) adjacency.

    Attributes
    ----------
    indptr    : (n+1,) int32       row pointers (CSR, out-edges)
    indices   : (m_pad,) int32     column ids (dst), padded with ``n_nodes``
    src       : (m_pad,) int32     COO source per edge, padded with ``n_nodes``
    dst       : (m_pad,) int32     alias of indices (explicit for scatters)
    indptr_t  : (n+1,) int32       CSC column pointers (in-edges)
    indices_t : (m_pad,) int32     CSC row ids, padded with ``n_nodes``
    n_nodes   : int
    n_edges   : int                true edge count (directed)
    m_pad     : int                padded edge-array length
    """

    indptr: torch.Tensor
    indices: torch.Tensor
    src: torch.Tensor
    dst: torch.Tensor
    indptr_t: torch.Tensor
    indices_t: torch.Tensor
    n_nodes: int
    n_edges: int
    m_pad: int

    ARRAYS = ("indptr", "indices", "src", "dst", "indptr_t", "indices_t")

    # -- constructors ------------------------------------------------------

    @staticmethod
    def from_edges(src: np.ndarray, dst: np.ndarray, n_nodes: int,
                   *, dedup: bool = True, remove_self_loops: bool = True,
                   pad_to: Optional[int] = None,
                   device=None) -> "CSRGraph":
        """Build from host-side COO edge arrays (numpy)."""
        dev = resolve_device(device)
        src = np.asarray(src, dtype=np.int64)
        dst = np.asarray(dst, dtype=np.int64)
        if remove_self_loops:
            keep = src != dst
            src, dst = src[keep], dst[keep]
        if dedup and len(src):
            key = src * n_nodes + dst
            _, uniq = np.unique(key, return_index=True)
            src, dst = src[uniq], dst[uniq]
        order = np.lexsort((dst, src))
        src, dst = src[order], dst[order]
        m = len(src)
        m_pad = pad_to if pad_to is not None else \
            max(_round_up(max(m, 1), 128), 128)
        if m_pad < m:
            raise ValueError(f"pad_to={m_pad} < m={m}")

        indptr = np.zeros(n_nodes + 1, dtype=np.int32)
        np.add.at(indptr, src + 1, 1)
        indptr = np.cumsum(indptr).astype(np.int32)

        # transpose (CSC) — in-edges sorted by dst
        order_t = np.lexsort((src, dst))
        src_t, dst_t = src[order_t], dst[order_t]
        indptr_t = np.zeros(n_nodes + 1, dtype=np.int32)
        np.add.at(indptr_t, dst_t + 1, 1)
        indptr_t = np.cumsum(indptr_t).astype(np.int32)

        def pad(a):
            out = np.full(m_pad, n_nodes, dtype=np.int32)
            out[:m] = a
            return out

        def put(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

        return CSRGraph(
            indptr=put(indptr), indices=put(pad(dst)), src=put(pad(src)),
            dst=put(pad(dst)), indptr_t=put(indptr_t),
            indices_t=put(pad(src_t)),
            n_nodes=int(n_nodes), n_edges=int(m), m_pad=int(m_pad))

    @staticmethod
    def from_scipy(mat, **kw) -> "CSRGraph":
        coo = mat.tocoo()
        return CSRGraph.from_edges(coo.row, coo.col, mat.shape[0], **kw)

    @property
    def device(self) -> torch.device:
        return self.src.device

    def to(self, device) -> "CSRGraph":
        """The same graph with every array on ``device``."""
        dev = resolve_device(device)
        return dataclasses.replace(
            self, **{k: getattr(self, k).to(dev) for k in self.ARRAYS})

    # -- views -------------------------------------------------------------

    def to_dense(self, dtype=torch.int8) -> torch.Tensor:
        """Dense (n, n) adjacency.  Padded edges drop out through the
        sentinel row/column, which is sliced off."""
        n = self.n_nodes
        a = torch.zeros((n + 1, n + 1), dtype=dtype, device=self.device)
        a[self.src.long(), self.dst.long()] = 1
        return a[:n, :n]

    def to_dense_padded(self, n_pad: int, dtype=torch.int8) -> torch.Tensor:
        """Dense adjacency zero-padded to (n_pad, n_pad) (tile-aligned)."""
        n = self.n_nodes
        if n_pad < n:
            raise ValueError(f"n_pad={n_pad} < n_nodes={n}")
        size = max(n_pad, n + 1)
        a = torch.zeros((size, size), dtype=dtype, device=self.device)
        a[self.src.long(), self.dst.long()] = (self.src < n).to(dtype)
        return a[:n_pad, :n_pad]

    def out_degrees(self) -> torch.Tensor:
        return self.indptr[1:] - self.indptr[:-1]

    def in_degrees(self) -> torch.Tensor:
        return self.indptr_t[1:] - self.indptr_t[:-1]

    def n_padded(self, align: int = 128) -> int:
        """Tile-aligned node count with room for the sentinel row
        (``>= n_nodes + 1``, so padded lanes index a dead column)."""
        return _round_up(self.n_nodes + 1, align)

    def degree_stats(self) -> DegreeStats:
        """Host-side degree/density summary — the static half of the
        direction-switch signal."""
        out_deg = self.out_degrees().cpu().numpy()
        in_deg = self.in_degrees().cpu().numpy()
        n = max(self.n_nodes, 1)
        return DegreeStats(
            n_nodes=self.n_nodes,
            n_edges=self.n_edges,
            avg_degree=self.n_edges / n,
            max_out_degree=int(out_deg.max(initial=0)),
            max_in_degree=int(in_deg.max(initial=0)),
            density=self.n_edges / (n * n),
        )

    def to_pull_packed(self, n_pad: Optional[int] = None) -> torch.Tensor:
        """(n_pad, n_pad/32) bit-packed in-neighbour rows — the operand of
        the packed push/pull sweeps — as int32 carrying the uint32 bit
        pattern.  Row ``j`` holds bit ``u % 32`` of word ``u // 32`` for
        every edge ``u -> j``: bit-identical to ``pack_bits(
        to_dense_padded(n_pad).T != 0)``, but built straight from the CSR
        lanes, so no (n_pad, n_pad) temporary is ever materialized."""
        n = self.n_nodes
        n_pad = self.n_padded() if n_pad is None else n_pad
        if n_pad < n:
            raise ValueError(f"n_pad={n_pad} < n_nodes={n}")
        words = (n_pad + 31) // 32
        real = self.src < n
        src = self.src[real].long()
        dst = self.dst[real].long()
        # duplicate lanes (dedup=False) would add a bit twice: keep one
        key = torch.unique(dst * n_pad + src)
        dst, src = key // n_pad, key % n_pad
        packed = torch.zeros(n_pad * words, dtype=torch.int64,
                             device=self.device)
        # distinct bits of one word: their sum is their OR
        packed.index_add_(0, dst * words + (src >> 5),
                          torch.ones_like(src) << (src & 31))
        return packed.to(torch.int32).view(n_pad, words)

    def reverse(self) -> "CSRGraph":
        """Transpose view as a first-class CSRGraph (shares buffers)."""
        return CSRGraph(
            indptr=self.indptr_t, indices=self.indices_t,
            src=self.dst, dst=self.src,
            indptr_t=self.indptr, indices_t=self.indices,
            n_nodes=self.n_nodes, n_edges=self.n_edges, m_pad=self.m_pad)

    # -- host helpers ------------------------------------------------------

    def edge_arrays_np(self) -> Tuple[np.ndarray, np.ndarray]:
        src = self.src[: self.n_edges].cpu().numpy()
        dst = self.dst[: self.n_edges].cpu().numpy()
        return src, dst

    def to_scipy(self):
        import scipy.sparse as sp
        src, dst = self.edge_arrays_np()
        return sp.csr_matrix(
            (np.ones(len(src), dtype=np.int8), (src, dst)),
            shape=(self.n_nodes, self.n_nodes))


def symmetrize(src: np.ndarray, dst: np.ndarray):
    return (np.concatenate([src, dst]), np.concatenate([dst, src]))
