"""Shared tiling / occupancy / budget machinery for the port's kernels.

The counterpart of ``repro/kernels/common.py``.  What carries over from
the JAX package is what the semirings share: the blockwise ``any``
reduction behind both occupancy tables (``f_occ`` input sparsity,
``o_occ`` output sparsity — Thm 3.2 at tile rank), the tile divisibility
contract, and the on-chip budget a kernel's tile plan must fit.

On Hopper that budget is the shared memory one block may use: 227 KB
(232,448 bytes) of the SM's 256 KB, reachable above 48 KB only as
dynamic shared memory.  It replaces the JAX package's per-core VMEM
budget.
"""
from __future__ import annotations

from typing import Optional

import torch

ALIGN = 128                        # node padding and default tile edge
SMEM_BUDGET_BYTES = 232_448        # Hopper: max shared memory per block

# tile-edge candidates, largest first (128 always divides a padded n)
TILE_CANDIDATES = (512, 256, 128)


def smem_limit(budget: Optional[int] = None) -> int:
    """The per-block shared-memory budget tile plans must fit."""
    return SMEM_BUDGET_BYTES if budget is None else int(budget)


def tile_candidates(n_pad: int) -> tuple:
    """Aligned tile edges that divide ``n_pad``, largest first."""
    cands = tuple(c for c in TILE_CANDIDATES
                  if c <= n_pad and n_pad % c == 0)
    return cands or (ALIGN,)


def block_any(mask: torch.Tensor, gi: int, bi: int, gj: int, bj: int
              ) -> torch.Tensor:
    """(gi*bi, gj*bj) bool -> (gi, gj) bool: does block (i, j) contain any
    True?  This one reduction is both occupancy tables:

      f_occ = block_any(frontier-active mask, gi, bs, gk, bk)
      o_occ = block_any(dist == UNREACHED, gi, bs, gj, bn)
    """
    return mask.reshape(gi, bi, gj, bj).any(dim=3).any(dim=1)


def check_push_tiles(s: int, n: int, bs: int, bn: int, bk: int,
                     k: Optional[int] = None) -> None:
    """Tile divisibility contract shared by the push-style kernels.
    ``k`` is the contraction dim (``n`` for the square operand)."""
    k = n if k is None else k
    if s % bs or n % bn or k % bk:
        raise ValueError(f"tiles do not divide the shapes: "
                         f"{(s, n, k)} vs {(bs, bn, bk)}")
