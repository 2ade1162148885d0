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
from typing import NamedTuple, Optional

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


class WordIndex(NamedTuple):
    """Per-row compacted list of an operand's live words.

    Row k's live words are ``words[offsets[k]:offsets[k + 1]]``, in
    ascending order.  A word is a fixed run of a row's bytes, live when
    it holds a non-zero entry:

      * 16 bytes of a dense operand (16 int8 or 4 float32 columns; word
        ``w`` covers bytes ``16 w .. 16 w + 15``), live where it holds a
        non-zero byte (counting, K5 / K6) or a finite weight (tropical,
        K7 / K8);
      * 4 bytes of the bit-packed operand (one uint32, 32 source nodes of
        target column k), live where it is non-zero (boolean, K1 / K2).
        There ``values`` carries each listed word's bits beside its
        position, so the index is a packed CSC of the operand and the
        kernels that read it never touch the operand itself.

    The index is derived from the operand alone; it changes which words a
    kernel reads, never what it computes."""
    offsets: torch.Tensor    # (k + 1,) int32
    words: torch.Tensor      # (offsets[-1],) int32 positions
    rows_live: int           # rows holding at least one live word
    values: Optional[torch.Tensor] = None  # (offsets[-1],) int32, or None

    def work_items(self, chunk: int) -> int:
        """Upper bound on sum_k ceil(len_k / chunk), the work items one
        group of source rows can list (each a chunk of one row)."""
        return self.words.numel() // chunk + self.rows_live

    def work_list(self, rows: int, chunk: int) -> torch.Tensor:
        """Room for the work items the K5–K8 kernels list for ``rows``
        source rows: one int4 (k, first word, group << 8 | words, row
        mask) per chunk of ``chunk`` live words of an operand row, for
        each group of 32 rows (one per lane)."""
        groups = -(-rows // 32)
        return torch.empty((max(groups * self.work_items(chunk), 1), 4),
                           dtype=torch.int32, device=self.words.device)


class LaneIndex(NamedTuple):
    """The in-lane index of a graph's weighted CSR lanes: their CSC.

    Target j's in-lanes are ``src[offsets[j]:offsets[j + 1]]`` with
    weights ``w`` at the same positions, in no particular order (the
    sparse relax takes a min over them, which is order-free).  Lanes
    weighted +inf (the padded ones) relax nothing and are left out.

    A target with more in-lanes than a threshold (a hub) is also cut into
    pieces of that many lanes, so that a kernel can spread one hub over
    many warps: target j's pieces are
    ``pieces[hub_first[j]:hub_first[j + 1]]``, each a (start, end) range
    of positions in ``src``."""
    offsets: torch.Tensor    # (n_pad + 1,) int32
    src: torch.Tensor        # (offsets[-1],) int32 source ids
    w: torch.Tensor          # (offsets[-1],) float32 weights
    hub_first: torch.Tensor  # (n_pad + 1,) int32 first piece of each target
    pieces: torch.Tensor     # (hub_first[-1], 2) int32 lane ranges


# bound on the operand bytes one chunk of the plain index build reads
_INDEX_CHUNK_BYTES = 1 << 28


def index_from_counts(counts: torch.Tensor):
    """(k,) live words per row -> ((k + 1,) int32 offsets, total,
    rows_live).  One device-to-host copy of the two totals."""
    offsets = torch.zeros(counts.numel() + 1, dtype=torch.int64,
                          device=counts.device)
    offsets[1:] = torch.cumsum(counts.to(torch.int64), dim=0)
    total, rows_live = torch.stack(
        [offsets[-1], (counts > 0).sum()]).tolist()
    if total >= 2 ** 31:
        raise ValueError(f"{total} live words: the index holds int32 "
                         f"offsets")
    return offsets.to(torch.int32), total, rows_live


def word_index_ref(operand: torch.Tensor, per_word: int,
                   live) -> WordIndex:
    """The plain build of a :class:`WordIndex`: ``live`` maps a
    (rows, words, per_word) block of the operand to a bool block; a word
    is live where any of its ``per_word`` elements is.  A few rows at a
    time, so it also runs at full width on the card."""
    k, n = operand.shape
    if n % per_word:
        raise ValueError(f"row length {n} is not a multiple of the "
                         f"{per_word} elements of a word")
    rows = max(1, _INDEX_CHUNK_BYTES // max(n * operand.element_size(), 1))
    counts, words = [], []
    for r0 in range(0, k, rows):
        blk = operand[r0: r0 + rows].reshape(-1, n // per_word, per_word)
        hit = live(blk).any(dim=2)
        counts.append(hit.sum(dim=1))
        words.append(hit.nonzero()[:, 1].to(torch.int32))
    counts = torch.cat(counts) if counts else \
        torch.zeros(0, dtype=torch.int64, device=operand.device)
    offsets, _, rows_live = index_from_counts(counts)
    words = torch.cat(words) if words else \
        torch.zeros(0, dtype=torch.int32, device=operand.device)
    return WordIndex(offsets, words, rows_live)


def build_word_index(lib: ctypes.CDLL, name: str, operand: torch.Tensor,
                     *, with_values: bool = False) -> WordIndex:
    """Build the live-word index of a (k, n) operand on the card with C
    entry point ``name`` of ``lib``, ``(operand, offsets, out[, values],
    k, n)``: a count pass (offsets null: out = words per row), the prefix
    sum of the counts, then a fill pass (out = the word list, and with
    ``with_values`` the words' values)."""
    k, n = operand.shape
    dev = operand.device
    counts = torch.empty(k, dtype=torch.int32, device=dev)
    launch(lib, name, dev, operand.data_ptr(), None, counts.data_ptr(),
           *((None,) if with_values else ()), k, n)
    offsets, total, rows_live = index_from_counts(counts)
    words = torch.empty(max(total, 1), dtype=torch.int32, device=dev)
    values = torch.empty_like(words) if with_values else None
    launch(lib, name, dev, operand.data_ptr(), offsets.data_ptr(),
           words.data_ptr(), *((values.data_ptr(),) if with_values else ()),
           k, n)
    return WordIndex(offsets, words[:total], rows_live,
                     values[:total] if with_values else None)


def check_index(index: WordIndex, rows: int, device, *,
                values: bool = False) -> None:
    """The index a kernel wrapper was handed fits its operand's rows and
    device: int32 offsets of shape (rows + 1,), int32 words and, where
    ``values`` is asked for, int32 values beside them.  On the card the
    tensors must also meet :func:`check_cuda`'s contract."""
    if index.offsets.shape != (rows + 1,):
        raise ValueError(f"index: offsets of shape "
                         f"{tuple(index.offsets.shape)}, expected "
                         f"({rows + 1},)")
    parts = {"offsets": index.offsets, "words": index.words}
    if values:
        if index.values is None or index.values.shape != index.words.shape:
            raise ValueError("index: expected a value beside each listed "
                             "word")
        parts["values"] = index.values
    for name, t in parts.items():
        if t.dtype != torch.int32 or t.dim() != 1:
            raise ValueError(f"index: {name} must be 1-d int32, got "
                             f"{t.dtype} of shape {tuple(t.shape)}")
        if t.device != torch.device(device):
            raise ValueError(f"index: {name} on {t.device}, expected "
                             f"{device}")
    if torch.device(device).type == "cuda":
        check_cuda(**{k: (t, torch.int32) for k, t in parts.items()})


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


def launch(lib: ctypes.CDLL, name: str, device: torch.device, *args) -> None:
    """Call C entry point ``name`` of ``lib`` with ``args`` and
    ``device``'s current stream; raise on a non-zero launch status."""
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        status = getattr(lib, name)(*args, stream)
    if status != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {status}")
