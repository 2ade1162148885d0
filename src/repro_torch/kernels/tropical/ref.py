"""Plain PyTorch versions of the three tropical (min,+) sweep kernels, of
the dense operand's live-word index and of the sparse relax's in-lane
index.

Each function computes exactly what its CUDA kernel in
``csrc/tropical.cu`` computes.  The wrappers in ``kernel.py`` call them
for tensors on the CPU; on the card they are the reference each kernel
is held against.

Exactness: a candidate is ONE f32 add (``fdist[s, k] + W[k, j]``) and
the reduction is a min, which is exact and order-free, so any k order
and any chunking give the same bits.  The product skips the k columns
in which no row holds a finite ``fdist`` (their candidates are all
+inf) and broadcasts a few operand rows at a time, so it also runs at
full width on the card (a whole (S, k, n) broadcast at n_pad = 65,664
would be 2.2 TB).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..common import LaneIndex, WordIndex, expand_table, word_index_ref

# bound on one chunk's (S, kc, n) broadcast, in elements
_CHUNK_ELEMS = 1 << 26

_INF = float("inf")


def minplus_product(fdist: torch.Tensor, wdense: torch.Tensor
                    ) -> torch.Tensor:
    """cand[s, j] = min_k fdist[s, k] + W[k, j] in f32, over the k where
    any row of ``fdist`` is finite, a few operand rows at a time."""
    s, _ = fdist.shape
    n = wdense.shape[1]
    cand = torch.full((s, n), _INF, dtype=torch.float32,
                      device=fdist.device)
    act = torch.isfinite(fdist).any(dim=0).nonzero().flatten()
    kc = max(1, _CHUNK_ELEMS // max(s * n, 1))
    for i in range(0, act.numel(), kc):
        ks = act[i: i + kc]
        part = (fdist[:, ks, None] + wdense[ks][None]).amin(dim=1)
        cand = torch.minimum(cand, part)
    return cand


def finite_words_ref(wdense: torch.Tensor) -> WordIndex:
    """The live-word index of a (k, n) float32 operand: per row, the
    16-byte words (4 columns) that hold a finite weight, ascending."""
    return word_index_ref(wdense, 4, torch.isfinite)


def hub_pieces(offsets: torch.Tensor, hub: int):
    """The pieces of ``hub`` lanes that the targets with more than ``hub``
    in-lanes are cut into, from the in-lane offsets: ((n + 1,) int32 first
    piece of each target, (P, 2) int32 lane ranges), target by target."""
    if hub < 1:
        raise ValueError(f"hub={hub}: a piece holds at least one lane")
    off = offsets.long()
    deg = off[1:] - off[:-1]
    cuts = torch.where(deg > hub, (deg + hub - 1) // hub, 0)
    first = torch.zeros_like(off)
    first[1:] = torch.cumsum(cuts, 0)
    tgt = torch.repeat_interleave(
        torch.arange(deg.numel(), device=off.device), cuts)
    start = off[tgt] + (torch.arange(tgt.numel(), device=off.device)
                        - first[tgt]) * hub
    end = torch.minimum(start + hub, off[tgt + 1])
    return first.to(torch.int32), \
        torch.stack([start, end], dim=1).to(torch.int32)


def in_lanes_ref(src_idx: torch.Tensor, dst_idx: torch.Tensor,
                 w_edges: torch.Tensor, n_pad: int, hub: int) -> LaneIndex:
    """The in-lane index (``common.LaneIndex``) of the CSR lanes: per
    target, the sources and weights of the lanes into it, in lane order,
    without the lanes weighted +inf; the targets with more than ``hub``
    in-lanes cut into pieces of ``hub`` lanes."""
    keep = w_edges < _INF
    src, dst, w = src_idx[keep], dst_idx[keep].long(), w_edges[keep]
    if dst.numel() and not (0 <= int(torch.minimum(src.min(), dst.min()))
                            and int(torch.maximum(src.max(), dst.max()))
                            < n_pad):
        raise ValueError(f"lane ids outside [0, {n_pad})")
    order = torch.argsort(dst, stable=True)
    offsets = torch.zeros(n_pad + 1, dtype=torch.int64, device=dst.device)
    offsets[1:] = torch.cumsum(torch.bincount(dst, minlength=n_pad), 0)
    offsets = offsets.to(torch.int32)
    return LaneIndex(offsets, src[order].to(torch.int32), w[order],
                     *hub_pieces(offsets, hub))


def in_lanes_sorted(index: LaneIndex) -> LaneIndex:
    """``index`` with each target's lanes sorted by (source, weight): two
    builds of one graph's index are equal exactly when their sorted forms
    are (the card's build fills a target's lanes in any order)."""
    counts = (index.offsets[1:] - index.offsets[:-1]).long()
    col = torch.repeat_interleave(
        torch.arange(counts.numel(), device=counts.device), counts)
    order = torch.argsort(index.w.view(torch.int32), stable=True)
    key = col[order] * (1 << 31) + index.src[order].long()
    order = order[torch.argsort(key, stable=True)]
    return index._replace(src=index.src[order], w=index.w[order])


def minplus_sweep_ref(fdist: torch.Tensor, wdense: torch.Tensor,
                      dist: torch.Tensor,
                      f_occ: Optional[torch.Tensor] = None,
                      o_occ: Optional[torch.Tensor] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One dense min-plus sweep (K7).

    fdist  : (S, k) f32 — frontier-masked distances (+inf off-frontier)
    wdense : (k, n) f32 — weight matrix, +inf non-edges
    dist   : (S, n) f32 — current distances, +inf unreached

    cand[s, j] = min_k fdist[s, k] + W[k, j]; returns (new int8 — the
    entries that improved, dist f32 — where(new, cand, dist)).  The
    occupancy tables, when given, gate the inputs the way the kernel's
    tile skips do (a skipped k-block contributes +inf, a skipped output
    tile improves nothing); both skips are inert.
    """
    if f_occ is not None:
        fdist = torch.where(expand_table(f_occ, *fdist.shape), fdist,
                            torch.full((), _INF, device=fdist.device))
    cand = minplus_product(fdist, wdense)
    new = cand < dist
    if o_occ is not None:
        new &= expand_table(o_occ, *dist.shape)
    return new.to(torch.int8), torch.where(new, cand, dist)


def sparse_relax_ref(frontier: torch.Tensor, dist: torch.Tensor,
                     src_idx: torch.Tensor, dst_idx: torch.Tensor,
                     w_edges: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One edge-parallel relax sweep (K9): gather ``dist[:, src] + w``
    over the CSR lanes, gated by the frontier, scatter-min into the
    ``dst`` columns — one 1-D ``index_reduce_`` along the node axis of
    the (n_pad, S) transposed state."""
    src_l, dst_l = src_idx.long(), dst_idx.long()
    d_t = dist.t()
    cand = torch.where(frontier.t()[src_l] != 0,
                       d_t[src_l] + w_edges[:, None],
                       torch.full((), _INF, device=dist.device))
    nd = d_t.clone(memory_format=torch.contiguous_format)
    nd.index_reduce_(0, dst_l, cand, "amin")
    nd = nd.t().contiguous()
    new = nd < dist
    return new.to(torch.int8), nd


def fused_minplus_multisweep_ref(frontier: torch.Tensor,
                                 wdense: torch.Tensor, dist: torch.Tensor,
                                 n_run):
    """Up to ``n_run`` min-plus sweeps with the Fact-1 check after each
    (K8), the per-sweep plain form iterated over the whole batch as one
    tile.

    Rows evolve independently (the operand is read-only) and a row's
    productive sweeps form a prefix, so the kernel's per-tile accounting
    reduces to whole-batch terms: ``prod`` is the number of productive
    sweeps, ``stopped`` whether a sweep found nothing within ``n_run``.
    Returns (new int8, dist f32, prod int32 scalar, stopped bool scalar).
    """
    d = dist
    f8 = frontier
    new8 = torch.zeros(dist.shape, dtype=torch.int8, device=dist.device)
    done, prod = False, 0
    for _ in range(int(n_run)):
        fd = torch.where(f8 != 0, d, torch.full((), _INF, device=d.device))
        new8, d = minplus_sweep_ref(fd, wdense, d)
        f8 = new8
        if not bool(new8.any()):
            done = True
            break
        prod += 1
    return (new8, d, torch.tensor(prod, dtype=torch.int32),
            torch.tensor(done))
