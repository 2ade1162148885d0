"""Plain PyTorch versions of the four boolean sweep kernels.

Each function computes exactly what its CUDA kernel in ``csrc/bovm.cu``
computes.  The wrappers in ``kernel.py`` call them for tensors on the
CPU; on the card they are the reference each kernel is held against.
Both products are chunked over destination columns, so the broadcast
intermediate stays bounded and the functions also run at full width on
the card.

The occupancy tables are optional.  When given, they gate the inputs the
way the kernels' tile skips do (a skipped frontier block contributes
nothing, a skipped output tile discovers nothing); the tile sizes are
read off the tables' shapes.  The gates are inert on consistent tables,
so a wrong table shows up as a wrong result.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..common import WordIndex, expand_table, word_index_ref

# bound on one chunk's broadcast intermediate, in elements
_CHUNK_ELEMS = 1 << 25


def _epilogue(hits: torch.Tensor, dist: torch.Tensor, step: int,
              o_occ: Optional[torch.Tensor]):
    new = hits & (dist < 0)
    if o_occ is not None:
        new &= expand_table(o_occ, *dist.shape)
    return new.to(torch.int8), torch.where(new, torch.tensor(
        int(step), dtype=dist.dtype, device=dist.device), dist)


def packed_live_words_ref(adj_in_packed: torch.Tensor) -> WordIndex:
    """The live-word index of an (n, W) packed operand: per row j, the
    ascending positions of its non-zero words and, in ``values``, the
    words themselves (a packed CSC)."""
    index = word_index_ref(adj_in_packed, 1, lambda blk: blk != 0)
    n, w = adj_in_packed.shape
    rows = torch.repeat_interleave(
        torch.arange(n, device=adj_in_packed.device),
        index.offsets.diff().long())
    values = adj_in_packed.reshape(-1)[rows * w + index.words.long()]
    return index._replace(values=values)


def word_hits(frontier_packed: torch.Tensor,
              adj_in_packed: torch.Tensor) -> torch.Tensor:
    """hits[s, j] = any_w(frontier_packed[s, w] & adj_in_packed[j, w]),
    chunked over targets j -> (S, n) bool."""
    s, w = frontier_packed.shape
    n = adj_in_packed.shape[0]
    chunk = max(1, _CHUNK_ELEMS // max(s * w, 1))
    out = []
    for j0 in range(0, n, chunk):
        block = adj_in_packed[j0: j0 + chunk]                # (C, W)
        out.append(((frontier_packed[:, None, :] & block[None]) != 0)
                   .any(dim=-1))
    return torch.cat(out, dim=1) if out else \
        torch.zeros((s, 0), dtype=torch.bool, device=frontier_packed.device)


def packed_pull_ref(frontier_packed: torch.Tensor,
                    adj_in_packed: torch.Tensor, dist: torch.Tensor,
                    step) -> Tuple[torch.Tensor, torch.Tensor]:
    """Bit-packed pull sweep (K2).

    frontier_packed : (S, W) int32 words — packed frontier rows
    adj_in_packed   : (n, W) int32 words — row j = packed in-neighbours of j
    dist            : (S, n) int32, -1 = unreached
    returns (new int8 (S, n), dist int32 (S, n))
    """
    return _epilogue(word_hits(frontier_packed, adj_in_packed), dist, step,
                     None)


def packed_push_ref(frontier_packed: torch.Tensor,
                    adj_in_packed: torch.Tensor, dist: torch.Tensor, step,
                    f_occ: Optional[torch.Tensor] = None,
                    o_occ: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Bit-packed push sweep (K1): the pull product, gated by the push
    kernel's occupancy tables f_occ (gi, gk) and o_occ (gi, gj)."""
    if f_occ is not None:
        frontier_packed = frontier_packed * expand_table(
            f_occ, *frontier_packed.shape)
    return _epilogue(word_hits(frontier_packed, adj_in_packed), dist, step,
                     o_occ)


def sweep_ref(frontier: torch.Tensor, adj: torch.Tensor, dist: torch.Tensor,
              step, f_occ: Optional[torch.Tensor] = None,
              o_occ: Optional[torch.Tensor] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Masked-GEMM push sweep (K4, the ``push_f32`` control).

    frontier : (S, k) int8, adj : (k, n) int8, dist : (S, n) int32.
    The product is taken in f32 (exact: a sum of 0/1 products below
    2^24), chunked over destination columns.
    """
    if f_occ is not None:
        frontier = frontier * expand_table(f_occ, *frontier.shape)
    f = frontier.to(torch.float32)
    k, n = adj.shape
    chunk = max(1, _CHUNK_ELEMS // max(k, 1))
    counts = torch.cat([f @ adj[:, j0: j0 + chunk].to(torch.float32)
                        for j0 in range(0, n, chunk)], dim=1)
    return _epilogue(counts > 0, dist, step, o_occ)


def fused_boolean_multisweep_ref(frontier: torch.Tensor,
                                 adj_in_packed: torch.Tensor,
                                 dist: torch.Tensor, step, n_run):
    """Up to ``n_run`` packed sweeps with the Fact-1 check after each (K3).

    Rows evolve independently (the operand is read-only) and a row's
    productive sweeps form a prefix, so the per-tile accounting of the
    kernel reduces to whole-batch terms: ``prod`` is the number of
    productive sweeps, ``stopped`` whether a sweep found nothing within
    ``n_run``.  ``new`` is the last sweep's discoveries (zeros when it
    found nothing or ``n_run == 0``).  Returns (new int8, dist int32,
    prod int32 scalar, stopped bool scalar).
    """
    from ...core.frontier import pack_bits
    new = torch.zeros(dist.shape, dtype=torch.int8, device=dist.device)
    fp = pack_bits(frontier != 0)
    prod, stopped = 0, False
    for t in range(int(n_run)):
        new, dist = packed_pull_ref(fp, adj_in_packed, dist,
                                    int(step) + 1 + t)
        if not bool(new.any()):
            stopped = True
            break
        prod += 1
        fp = pack_bits(new != 0)
    return (new, dist, torch.tensor(prod, dtype=torch.int32),
            torch.tensor(stopped))
