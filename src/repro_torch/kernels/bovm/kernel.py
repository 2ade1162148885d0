"""Wrappers of the boolean sweep kernels (``csrc/bovm.cu``).

The port's counterpart of ``repro/kernels/bovm/kernel.py``: the same four
entry points with the JAX signatures, tile keywords and divisibility
checks, returning ``(new int8, dist int32[, prod, stopped])``.

  packed_push_sweep         K1 — bit-packed push, gated by f_occ / o_occ
  packed_pull_sweep         K2 — bit-packed pull, no gating
  fused_boolean_multisweep  K3 — up to ``n_run`` sweeps per launch
  fused_sweep               K4 — masked int8 GEMM push (``push_f32``)

the builder of the packed operand's live-word index that K1 and K2
read, and the frontier's packer that K1, K2 and K3 read from:

  packed_live_words         (n, W) packed operand -> common.WordIndex of
                            its non-zero words, positions and values
  pack_frontier             (R, n) byte frontier -> (R, ceil(n / 32))
                            int32 words: ``core.frontier.pack_bits`` in
                            one launch

For tensors on the CPU each wrapper computes its plain version
(``ref.py``).  For tensors on the card it checks dtype, shape and
contiguity, allocates the outputs, launches its kernel on the current
stream and raises on a non-zero launch status; it never falls back.  The
library is built from source on first launch (``kernels/_build.py``).

Each wrapper counts its launches in its ``launches`` attribute (one per
kernel launch, nothing on the CPU path); :func:`reset_launches` zeroes
them all.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path
from typing import Optional

import torch

from ... import trace
from ...core.frontier import pack_bits, packed_width
from .. import _build, common
from . import ref

SOURCE = Path(__file__).resolve().parent / "csrc" / "bovm.cu"

FUSED_ROWS = 32         # source rows per K3 tile (16 or 32)
FUSED_CLUSTER = 16      # CTAs per K3 tile: a thread block cluster
FUSED_LIST_CHUNK = 256  # K3 active words staged per pass (kListChunk)
FUSED_MASK_PITCH = 33   # K3 row-mask words per staged word (kMaskPitch)
FUSED_ROW_MULTIPLE = 8  # S the K3 wrapper takes; ragged tiles are masked
SHORT_WORDS = 32        # K1/K2: columns of at most this many index entries
                        # are walked by one thread, longer ones by warps
ITEM_WORDS = 64         # K1/K2: index entries of one column per work item

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "dawn_pack_frontier": [_P, _P, _I, _I, ctypes.c_longlong, _P],
    "dawn_packed_sweep": [_P] * 12 + [_I] * 6 + [_P],
    "dawn_packed_live_words": [_P] * 4 + [_I] * 2 + [_P],
    "dawn_fused_boolean_multisweep": [_P] * 9 + [_I] * 8 + [_P],
    "dawn_fused_active_clusters": [_I] * 4 + [_P],
    "dawn_fused_sweep": [_P] * 7 + [_I] * 7 + [_P],
}


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load(SOURCE)
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def _launch(name: str, device: torch.device, *args) -> None:
    common.launch(_lib(), name, device, *args)


def _ptr(t: torch.Tensor) -> int:
    return t.data_ptr()


def reset_launches() -> None:
    for fn in (packed_push_sweep, packed_pull_sweep,
               fused_boolean_multisweep, fused_sweep, packed_live_words,
               pack_frontier):
        fn.launches = 0


# --------------------------------------------------------------------------
# the frontier's packed words
# --------------------------------------------------------------------------

_BYTES = (torch.int8, torch.uint8, torch.bool)


def pack_frontier(x: torch.Tensor) -> torch.Tensor:
    """(R, n) frontier -> (R, ceil(n / 32)) int32 words, bit for bit
    ``core.frontier.pack_bits(x)``: node ``32 w + b`` is bit ``b`` of word
    ``w``, a non-zero entry is a set bit, the tail bits are zero.  On the
    CPU it is ``pack_bits``.  On the card one launch reads an int8, uint8
    or bool tensor as bytes (any other dtype is first reduced to
    ``x != 0``) through its row stride, so a column slice of a wider state
    packs without a copy; the last dim must be contiguous.  Each launch
    adds one to the counter ``dawn.frontier.packs``."""
    if not x.is_cuda:
        return pack_bits(x)
    if x.dtype not in _BYTES:
        x = x != 0
    if x.dim() != 2 or (x.shape[1] > 1 and x.stride(1) != 1):
        raise ValueError(f"pack_frontier: expected a 2-d tensor with a "
                         f"contiguous last dim, got shape "
                         f"{tuple(x.shape)} and strides {x.stride()}")
    rows, n = x.shape
    out = torch.empty((rows, packed_width(n)), dtype=torch.int32,
                      device=x.device)
    if out.numel():
        _launch("dawn_pack_frontier", x.device, _ptr(x), _ptr(out), rows, n,
                x.stride(0))
        pack_frontier.launches += 1
        trace.count("dawn.frontier.packs")
    return out


# --------------------------------------------------------------------------
# the live-word index of the packed operand
# --------------------------------------------------------------------------

def packed_live_words(adj_in_packed: torch.Tensor) -> common.WordIndex:
    """The live-word index of an (n, W) packed operand: per row (target
    column) j, the positions and values of its non-zero words, a packed
    CSC (``common.WordIndex`` with ``values``).  Built once per prepared
    graph (``PreparedGraph.adj_pull_index``); on the card two passes of
    one kernel (count, then fill at the prefix-summed offsets) read the
    operand twice."""
    if not adj_in_packed.is_cuda:
        return ref.packed_live_words_ref(adj_in_packed)
    common.check_cuda(adj_in_packed=(adj_in_packed, torch.int32))
    index = common.build_word_index(_lib(), "dawn_packed_live_words",
                                    adj_in_packed, with_values=True)
    packed_live_words.launches += 1
    return index


# --------------------------------------------------------------------------
# K1 / K2: bit-packed sweeps
# --------------------------------------------------------------------------

def _check_packed(frontier_packed, adj_in_packed, dist, bs, bn, wk, index):
    s, w = frontier_packed.shape
    n = adj_in_packed.shape[0]
    if adj_in_packed.shape != (n, w) or dist.shape != (s, n):
        raise ValueError(f"shapes: {tuple(frontier_packed.shape)}, "
                         f"{tuple(adj_in_packed.shape)}, {tuple(dist.shape)}")
    if s % bs or n % bn or w % wk:
        raise ValueError(f"tiles do not divide the shapes: {(s, n, w)} vs "
                         f"{(bs, bn, wk)}")
    if index is not None:
        common.check_index(index, n, dist.device, values=True)
    return s, n, w


def _packed_launch(frontier_packed, adj_in_packed, dist, step, index):
    """K1 or K2 on the card (one kernel sequence for both): stage the
    frontier as row masks, then read the state once, walking the pending
    columns through the operand's live-word index (built here when not
    given): the short lists a thread each, the long ones in work items a
    warp each."""
    common.check_cuda(frontier_packed=(frontier_packed, torch.int32),
                      adj_in_packed=(adj_in_packed, torch.int32),
                      dist=(dist, torch.int32))
    if index is None:
        index = packed_live_words(adj_in_packed)
    s, w = frontier_packed.shape
    n = adj_in_packed.shape[0]
    dev = dist.device
    groups = -(-s // 32)
    # one scratch buffer, 16-byte aligned parts: the frontier's row masks,
    # the pending and hit masks, the work items (int4 each), their count
    sizes = (groups * w * 32, groups * n, groups * n,
             4 * groups * index.work_items(ITEM_WORDS), 1)
    starts = [0]
    for size in sizes:
        starts.append(starts[-1] + -(-size // 4) * 4)
    scratch = torch.empty(starts[-1], dtype=torch.int32, device=dev)
    parts = [scratch.data_ptr() + 4 * o for o in starts[:-1]]
    new = torch.empty(dist.shape, dtype=torch.int8, device=dev)
    dist_out = torch.empty_like(dist)
    _launch("dawn_packed_sweep", dev, _ptr(frontier_packed),
            _ptr(index.offsets), _ptr(index.words), _ptr(index.values),
            _ptr(dist), _ptr(new), _ptr(dist_out), *parts, s, n, w,
            SHORT_WORDS, ITEM_WORDS, int(step))
    return new, dist_out


def packed_push_sweep(frontier_packed: torch.Tensor,
                      adj_in_packed: torch.Tensor, dist: torch.Tensor, step,
                      *, bs: int = 128, bn: int = 128, wk: int = 128,
                      index: Optional[common.WordIndex] = None):
    """Bit-packed push sweep (K1).  frontier_packed (S, W) int32 words,
    adj_in_packed (n, W) int32 words (row j = packed in-neighbours of j),
    dist (S, n) int32.  S % bs == 0, n % bn == 0, W % wk == 0.  Tiles
    whose frontier word block (f_occ) or unreached set (o_occ) is empty
    are skipped: the plain version applies the (bs, wk) and (bs, bn)
    tables; the kernel skips each column with no unreached row and needs
    no f_occ (an all-zero frontier block sets no bit, so it hits nothing).
    ``index`` is ``adj_in_packed``'s live-word index
    (:func:`packed_live_words`), which the kernel reads instead of the
    operand; without it the wrapper builds it, on the card only (the
    plain version takes none)."""
    s, n, w = _check_packed(frontier_packed, adj_in_packed, dist, bs, bn, wk,
                            index)
    if not dist.is_cuda:
        gi, gj, gk = s // bs, n // bn, w // wk
        return ref.packed_push_ref(
            frontier_packed, adj_in_packed, dist, step,
            f_occ=common.block_any(frontier_packed != 0, gi, bs, gk, wk),
            o_occ=common.block_any(dist < 0, gi, bs, gj, bn))
    out = _packed_launch(frontier_packed, adj_in_packed, dist, step, index)
    packed_push_sweep.launches += 1
    return out


def packed_pull_sweep(frontier_packed: torch.Tensor,
                      adj_in_packed: torch.Tensor, dist: torch.Tensor, step,
                      *, bs: int = 8, bn: int = 128, wk: int = 128,
                      index: Optional[common.WordIndex] = None):
    """Bit-packed pull sweep (K2).  Same operands, word math and
    ``index`` as :func:`packed_push_sweep`, no occupancy gating.
    S % bs == 0, n % bn == 0, W % wk == 0."""
    s, n, w = _check_packed(frontier_packed, adj_in_packed, dist, bs, bn, wk,
                            index)
    if not dist.is_cuda:
        return ref.packed_pull_ref(frontier_packed, adj_in_packed, dist, step)
    out = _packed_launch(frontier_packed, adj_in_packed, dist, step, index)
    packed_pull_sweep.launches += 1
    return out


# --------------------------------------------------------------------------
# K3: fused multi-sweep
# --------------------------------------------------------------------------

def fused_smem_bytes(n: int, rows: int = FUSED_ROWS,
                     cluster: int = FUSED_CLUSTER) -> int:
    """Shared memory of one K3 CTA at padded node count ``n``: the visited
    bits (``rows`` words) and per-column hit masks (32 words) of its slice
    of ceil(W / cluster) packed words, the row masks of one active-list
    pass (one word per bit of each staged word), and the tile's
    active-word list (word, row-OR).  The launch passes this size to the
    kernel."""
    words = max(n // 32, 1)
    slice_words = -(-words // cluster)
    return 4 * ((rows + 32) * slice_words
                + FUSED_MASK_PITCH * FUSED_LIST_CHUNK + 2 * words)


def fused_active_clusters(s: int, n: int, rows: int = FUSED_ROWS,
                          cluster: int = FUSED_CLUSTER) -> int:
    """How many K3 clusters of this shape the card runs at once (the
    occupancy query of the CUDA runtime); the card only."""
    out = ctypes.c_int(0)
    status = _lib().dawn_fused_active_clusters(
        s, rows, cluster, fused_smem_bytes(n, rows, cluster),
        ctypes.byref(out))
    if status != 0:
        raise RuntimeError(f"dawn_fused_active_clusters: error {status}")
    return out.value


def fused_boolean_multisweep(frontier: torch.Tensor,
                             adj_in_packed: torch.Tensor, dist: torch.Tensor,
                             step, n_run, *, bs: int = 128,
                             max_sweeps: int = 1):
    """Run up to ``n_run`` boolean sweeps (``n_run <= max_sweeps``) in ONE
    kernel launch (K3).  frontier (S, n) int8 (packed on entry),
    adj_in_packed (n, W) int32 words, dist (S, n) int32, ``step`` the
    sweeps already executed (sweep t writes distance step + 1 + t).

    Returns (new int8, dist int32, prod int32 scalar, stopped bool
    scalar): ``prod`` is the most productive sweeps of any row tile and
    ``stopped`` whether every tile converged, so the loop driver's
    accounting is ``executed = stopped ? prod + 1 : n_run``.  The kernel
    runs FUSED_ROWS source rows per cluster of FUSED_CLUSTER CTAs whatever
    ``bs`` is, masking the rows past S in the last tile; rows evolve
    independently, so no result depends on the tile."""
    s, n = frontier.shape
    w = adj_in_packed.shape[1]
    if adj_in_packed.shape != (n, w) or dist.shape != (s, n) or w * 32 != n:
        raise ValueError(f"shapes: {tuple(frontier.shape)}, "
                         f"{tuple(adj_in_packed.shape)}, {tuple(dist.shape)}")
    if s % bs or n % 128 or s % FUSED_ROW_MULTIPLE:
        raise ValueError(f"tiles do not divide the shapes: {(s, n)} vs "
                         f"bs={bs}")
    n_run = int(n_run)
    if not 0 <= n_run <= max_sweeps:
        raise ValueError(f"n_run={n_run} outside [0, {max_sweeps}]")
    if not dist.is_cuda:
        return ref.fused_boolean_multisweep_ref(frontier, adj_in_packed,
                                                dist, step, n_run)
    common.check_cuda(frontier=(frontier, torch.int8),
                      adj_in_packed=(adj_in_packed, torch.int32),
                      dist=(dist, torch.int32))
    fp = pack_frontier(frontier)
    smem = fused_smem_bytes(n, FUSED_ROWS, FUSED_CLUSTER)
    if smem > common.SMEM_BUDGET_BYTES:
        raise ValueError(f"n={n}: the fused kernel's shared memory "
                         f"({smem} B) exceeds the budget")
    tiles = -(-s // FUSED_ROWS)
    dev = dist.device
    new = torch.empty((s, n), dtype=torch.int8, device=dev)
    dist_out = torch.empty_like(dist)
    prod = torch.empty(tiles, dtype=torch.int32, device=dev)
    stop = torch.empty(tiles, dtype=torch.int32, device=dev)
    # next-frontier words and their row-OR, double-buffered by sweep parity
    fbuf = torch.empty((2, s, w), dtype=torch.int32, device=dev)
    ubuf = torch.empty((2, tiles, w), dtype=torch.int32, device=dev)
    _launch("dawn_fused_boolean_multisweep", dev, _ptr(fp),
            _ptr(adj_in_packed), _ptr(dist), _ptr(new), _ptr(dist_out),
            _ptr(prod), _ptr(stop), _ptr(fbuf), _ptr(ubuf), s, n, w,
            FUSED_ROWS, FUSED_CLUSTER, smem, int(step), n_run)
    fused_boolean_multisweep.launches += 1
    return new, dist_out, prod.max(), stop.min() > 0


# --------------------------------------------------------------------------
# K4: masked int8 GEMM push (push_f32)
# --------------------------------------------------------------------------

def fused_sweep(frontier: torch.Tensor, adj: torch.Tensor, dist: torch.Tensor,
                step, *, bs: int = 128, bn: int = 128, bk: int = 512):
    """One masked-GEMM DAWN sweep (K4).  frontier (S, k) int8, adj (k, n)
    int8, dist (S, n) int32; S % bs == 0, n % bn == 0, k % bk == 0.  The
    kernel accumulates in int32 on the tensor cores (exact); its plain
    version in f32 (exact below 2^24), so both give the same ``new`` and
    ``dist``.  On the card ``bs`` must be a multiple of 8, and the
    kernel's launch refuses a ``bn`` that is not a multiple of 64 or a
    ``bk`` that is not a multiple of 32."""
    s, k = frontier.shape
    ka, n = adj.shape
    if ka != k or dist.shape != (s, n):
        raise ValueError(f"shapes: {tuple(frontier.shape)}, "
                         f"{tuple(adj.shape)}, {tuple(dist.shape)}")
    common.check_push_tiles(s, n, bs, bn, bk, k=k)
    gi, gj, gk = s // bs, n // bn, k // bk
    f_occ = common.block_any(frontier != 0, gi, bs, gk, bk)
    o_occ = common.block_any(dist < 0, gi, bs, gj, bn)
    if not dist.is_cuda:
        return ref.sweep_ref(frontier, adj, dist, step, f_occ=f_occ,
                             o_occ=o_occ)
    common.check_cuda(frontier=(frontier, torch.int8),
                      adj=(adj, torch.int8), dist=(dist, torch.int32))
    if bs % 8:
        raise ValueError(f"the kernel needs bs % 8 == 0, got bs={bs}")
    new = torch.empty((s, n), dtype=torch.int8, device=dist.device)
    dist_out = torch.empty_like(dist)
    _launch("dawn_fused_sweep", dist.device, _ptr(frontier), _ptr(adj),
            _ptr(dist), _ptr(new), _ptr(dist_out), _ptr(f_occ.contiguous()),
            _ptr(o_occ.contiguous()), s, n, k, bs, bn, bk, int(step))
    fused_sweep.launches += 1
    return new, dist_out


reset_launches()
