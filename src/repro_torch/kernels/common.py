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

import ctypes
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


def expand_table(table: torch.Tensor, rows: int, cols: int) -> torch.Tensor:
    """(gi, gj) tile table -> (rows, cols) elementwise mask: how the plain
    versions apply a kernel's occupancy gate."""
    gi, gj = table.shape
    return table.repeat_interleave(rows // gi, 0) \
                .repeat_interleave(cols // gj, 1)


def lane_offsets(src_idx: torch.Tensor, n_pad: int) -> torch.Tensor:
    """(n_pad + 1,) int32 offsets of each node's lanes in ``src_idx``,
    which must be sorted (CSR order: the padded lanes carry the largest
    id, the sentinel)."""
    nodes = torch.arange(n_pad + 1, dtype=src_idx.dtype,
                         device=src_idx.device)
    return torch.searchsorted(src_idx, nodes, out_int32=True)


def check_push_tiles(s: int, n: int, bs: int, bn: int, bk: int,
                     k: Optional[int] = None) -> None:
    """Tile divisibility contract shared by the push-style kernels.
    ``k`` is the contraction dim (``n`` for the square operand)."""
    k = n if k is None else k
    if s % bs or n % bn or k % bk:
        raise ValueError(f"tiles do not divide the shapes: "
                         f"{(s, n, k)} vs {(bs, bn, bk)}")


# --------------------------------------------------------------------------
# launch helpers shared by the kernel wrappers
# --------------------------------------------------------------------------

def check_cuda(**tensors) -> None:
    """dtype / device / contiguity / 16-byte alignment contract of a
    kernel launch: ``name=(tensor, dtype)``."""
    dev = None
    for name, (t, dtype) in tensors.items():
        if t.dtype != dtype:
            raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
        if not t.is_cuda:
            raise ValueError(f"{name}: expected a CUDA tensor")
        if not t.is_contiguous():
            raise ValueError(f"{name}: expected a contiguous tensor")
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: expected a 16-byte aligned tensor")
        if dev is not None and t.device != dev:
            raise ValueError(f"{name}: on {t.device}, expected {dev}")
        dev = t.device


def tile_rows(bs: int, limit: int) -> int:
    """Largest power-of-two row group <= ``limit`` that divides ``bs``."""
    for r in (32, 16, 8, 4, 2, 1):
        if r <= limit and bs % r == 0:
            return r
    return 1


def launch(lib: ctypes.CDLL, name: str, device: torch.device, *args) -> None:
    """Call C entry point ``name`` of ``lib`` with ``args`` and
    ``device``'s current stream; raise on a non-zero launch status."""
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        status = getattr(lib, name)(*args, stream)
    if status != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {status}")
