"""Wrappers of the tropical (min,+) sweep kernels (``csrc/tropical.cu``).

The port's counterpart of ``repro/kernels/tropical/kernel.py``: the same
three entry points with the JAX signatures, tile keywords and
divisibility checks.

  fused_minplus_sweep       K7 — dense min-plus push, gated by f_occ and
                            the settled-bound o_occ -> (new, dist)
  fused_minplus_multisweep  K8 — up to ``n_run`` min-plus sweeps per
                            launch -> (new, dist, prod, stopped)
  sparse_relax_sweep        K9 — the relax over the CSR lanes of the
                            frontier, a gather over each target's
                            in-lanes -> (new, dist)

and the builders of the indexes they read:

  finite_words              (k, n) f32 operand -> common.WordIndex of its
                            16-byte words holding a finite weight (K7, K8)
  in_lanes                  the CSR lanes -> common.LaneIndex, their CSC
                            (K9)

For tensors on the CPU each wrapper computes its plain version
(``ref.py``).  For tensors on the card it checks dtype, shape, contiguity
and alignment, allocates the outputs and scratch, launches its kernel on
the current stream and raises on a non-zero launch status; it never falls
back.  The library is built from source on first launch
(``kernels/_build.py``).

Each wrapper counts its launches in its ``launches`` attribute (one per
wrapper call on the card, nothing on the CPU path); :func:`reset_launches`
zeroes them.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path
from typing import Optional

import torch

from .. import _build, common
from . import ref

SOURCE = Path(__file__).resolve().parent / "csrc" / "tropical.cu"

CHUNK_WORDS = 16        # K7 / K8: live operand words per work item (<= 32)
PUSH_BLOCKS_PER_SM = 8  # K7: push blocks of 256 threads per SM
FUSED_BLOCKS_PER_SM = 8  # K8: cooperative blocks of 256 threads per SM,
                         # capped at what the SM holds
FUSED_TILE_BYTES = 4 * (32 * 33 + 32)   # K8: one block's transpose tile
HUB_LANES = 64          # K9: a target with more in-lanes is cut into
                        # pieces of this many, each walked by its own warp

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "dawn_minplus_sweep": [_P] * 13 + [_I] * 8 + [_P],
    "dawn_tropical_live_words": [_P] * 3 + [_I] * 2 + [_P],
    "dawn_fused_minplus_multisweep": [_P] * 15 + [_I] * 5 + [_P],
    "dawn_tropical_in_lanes": [_P] * 6 + [_I] * 3 + [_P],
    "dawn_sparse_relax": [_P] * 12 + [_I] * 3 + [_P],
}


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load(SOURCE)
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def reset_launches() -> None:
    for fn in (fused_minplus_sweep, fused_minplus_multisweep,
               sparse_relax_sweep, finite_words, in_lanes):
        fn.launches = 0


# --------------------------------------------------------------------------
# the live-word index of the dense operand
# --------------------------------------------------------------------------

def finite_words(wdense: torch.Tensor) -> common.WordIndex:
    """The live-word index of a (k, n) float32 operand: per row, the
    16-byte words that hold a finite weight (``common.WordIndex``).  Built
    once per prepared graph (``PreparedWeightedGraph.wdense_index``); on
    the card two passes of one kernel (count, then fill at the
    prefix-summed offsets) read the operand twice."""
    n = wdense.shape[1]
    if n % 4:
        raise ValueError(f"n={n} is not a multiple of 4")
    if not wdense.is_cuda:
        return ref.finite_words_ref(wdense)
    common.check_cuda(wdense=(wdense, torch.float32))
    index = common.build_word_index(_lib(), "dawn_tropical_live_words",
                                    wdense)
    finite_words.launches += 1
    return index


# --------------------------------------------------------------------------
# K7: the dense min-plus push
# --------------------------------------------------------------------------

def fused_minplus_sweep(fdist: torch.Tensor, wdense: torch.Tensor,
                        dist: torch.Tensor, w_min, *, bs: int = 128,
                        bn: int = 128, bk: int = 128,
                        index: Optional[common.WordIndex] = None):
    """One fused (min,+) sweep (K7).  fdist (S, k) f32 — the
    frontier-masked distances (``where(frontier, dist, +inf)``), wdense
    (k, n) f32 with +inf non-edges, dist (S, n) f32; ``w_min`` the
    minimum edge weight (a 0-d tensor or a number, +inf for no edges).
    S % bs == 0, n % bn == 0, k % bk == 0; on the card also
    bn % 128 == 0 and bk % 8 == 0.  ``index`` is ``wdense``'s live-word
    index (:func:`finite_words`); without it the wrapper builds it, on the
    card only (the plain version takes none).  Returns (new int8, dist
    f32).

    k-blocks with no finite fdist (f_occ) and output tiles whose every
    distance already sits at or below ``min_k fdist[s, k] + w_min``
    (o_occ, the settled bound) are skipped; f32 rounding is monotone, so
    no candidate could improve such a tile and both skips are inert."""
    s, k = fdist.shape
    ka, n = wdense.shape
    if ka != k or dist.shape != (s, n):
        raise ValueError(f"shapes: {tuple(fdist.shape)}, "
                         f"{tuple(wdense.shape)}, {tuple(dist.shape)}")
    common.check_push_tiles(s, n, bs, bn, bk, k=k)
    gi, gj, gk = s // bs, n // bn, k // bk
    w_min = torch.as_tensor(w_min, dtype=torch.float32, device=fdist.device)
    f_occ = common.block_any(torch.isfinite(fdist), gi, bs, gk, bk)
    bound = fdist.amin(dim=1, keepdim=True) + w_min          # (S, 1) f32
    o_occ = common.block_any(dist > bound, gi, bs, gj, bn)
    if not dist.is_cuda:
        return ref.minplus_sweep_ref(fdist, wdense, dist, f_occ=f_occ,
                                     o_occ=o_occ)
    common.check_cuda(fdist=(fdist, torch.float32),
                      wdense=(wdense, torch.float32),
                      dist=(dist, torch.float32))
    if bn % 128 or bk % 8:
        raise ValueError(f"the kernel needs bn % 128 == 0 and bk % 8 == 0, "
                         f"got bn={bn}, bk={bk}")
    dev = dist.device
    if index is None:
        index = finite_words(wdense)
    common.check_index(index, k, dev)
    new = torch.empty((s, n), dtype=torch.int8, device=dev)
    dist_out = torch.empty_like(dist)
    items = index.work_list(s, CHUNK_WORDS)
    nitems = torch.zeros(1, dtype=torch.int32, device=dev)
    # the push compares and scatters node-major: (n, S)
    dist_t = dist.t().contiguous()
    cand_t = torch.full((n, s), float("inf"), dtype=torch.float32,
                        device=dev)
    common.launch(_lib(), "dawn_minplus_sweep", dev, fdist.data_ptr(),
                  wdense.data_ptr(), index.offsets.data_ptr(),
                  index.words.data_ptr(), dist.data_ptr(), dist_t.data_ptr(),
                  new.data_ptr(), dist_out.data_ptr(),
                  f_occ.contiguous().data_ptr(),
                  o_occ.contiguous().data_ptr(), items.data_ptr(),
                  nitems.data_ptr(), cand_t.data_ptr(), s, n, k, bs, bn, bk,
                  CHUNK_WORDS, PUSH_BLOCKS_PER_SM)
    fused_minplus_sweep.launches += 1
    return new, dist_out


# --------------------------------------------------------------------------
# K8: fused multi-sweep
# --------------------------------------------------------------------------

def fused_smem_bytes(n: int) -> int:
    """Shared memory of one K8 block: the 32 x 32 tile that transposes the
    state on entry and exit.  The node-major state, the candidates, the
    frontier's row masks and the work list live in global memory (L2), so
    the size does not grow with the padded node count ``n``."""
    del n
    return FUSED_TILE_BYTES


def fused_minplus_multisweep(frontier: torch.Tensor, wdense: torch.Tensor,
                             dist: torch.Tensor, step, n_run, *,
                             bs: int = 128, max_sweeps: int = 1,
                             index: Optional[common.WordIndex] = None):
    """Run up to ``n_run`` (min,+) sweeps (``n_run <= max_sweeps``) in ONE
    launch (K8).  frontier (S, n) int8 improved-mask, wdense (n, n) f32,
    dist (S, n) f32; ``step`` is accepted for signature uniformity and
    unused (tropical distances are the candidates themselves).
    ``index`` is ``wdense``'s live-word index (:func:`finite_words`);
    without it the wrapper builds it, on the card only (the plain version
    takes none).

    Returns (new int8, dist f32, prod int32 scalar, stopped bool scalar):
    ``prod`` is the most productive sweeps of any row tile and ``stopped``
    whether every tile converged, so the loop driver's accounting is
    ``executed = stopped ? prod + 1 : n_run``.  The kernel runs all S rows
    as one tile on a cooperative grid whatever ``bs`` is; rows evolve
    independently, so no result depends on the tile."""
    del step
    s, n = frontier.shape
    if wdense.shape != (n, n) or dist.shape != (s, n):
        raise ValueError(f"shapes: {tuple(frontier.shape)}, "
                         f"{tuple(wdense.shape)}, {tuple(dist.shape)}")
    if s % bs or n % 128:
        raise ValueError(f"tiles do not divide the shapes: {(s, n)} vs "
                         f"bs={bs}")
    n_run = int(n_run)
    if not 0 <= n_run <= max_sweeps:
        raise ValueError(f"n_run={n_run} outside [0, {max_sweeps}]")
    if not dist.is_cuda:
        return ref.fused_minplus_multisweep_ref(frontier, wdense, dist,
                                                n_run)
    common.check_cuda(frontier=(frontier, torch.int8),
                      wdense=(wdense, torch.float32),
                      dist=(dist, torch.float32))
    dev = dist.device
    if index is None:
        index = finite_words(wdense)
    common.check_index(index, n, dev)
    sp = 32 * -(-s // 32)                    # node-major rows, 32 a group
    new = torch.empty((s, n), dtype=torch.int8, device=dev)
    dist_out = torch.empty_like(dist)
    dist_t = torch.empty((n, sp), dtype=torch.float32, device=dev)
    cand_t = torch.empty((n, sp), dtype=torch.int32, device=dev)
    fmask = torch.empty((sp // 32, n), dtype=torch.int32, device=dev)
    items = index.work_list(s, CHUNK_WORDS)
    counts = torch.zeros(2 * max(n_run, 1), dtype=torch.int32, device=dev)
    bar = torch.zeros(2, dtype=torch.int32, device=dev)
    prod = torch.empty(1, dtype=torch.int32, device=dev)
    stop = torch.empty(1, dtype=torch.int32, device=dev)
    common.launch(_lib(), "dawn_fused_minplus_multisweep", dev,
                  frontier.data_ptr(), wdense.data_ptr(),
                  index.offsets.data_ptr(), index.words.data_ptr(),
                  dist.data_ptr(), new.data_ptr(), dist_out.data_ptr(),
                  dist_t.data_ptr(), cand_t.data_ptr(), fmask.data_ptr(),
                  items.data_ptr(), counts.data_ptr(), bar.data_ptr(),
                  prod.data_ptr(), stop.data_ptr(), s, n, CHUNK_WORDS,
                  FUSED_BLOCKS_PER_SM, n_run)
    fused_minplus_multisweep.launches += 1
    return new, dist_out, prod[0], stop[0] > 0


# --------------------------------------------------------------------------
# K9: the sparse relax, a gather over the in-lane index
# --------------------------------------------------------------------------

def in_lanes(src_idx: torch.Tensor, dst_idx: torch.Tensor,
             w_edges: torch.Tensor, n_pad: int) -> common.LaneIndex:
    """The in-lane index of the CSR lanes (``common.LaneIndex``): per
    target, its in-lanes' sources and weights, the lanes weighted +inf
    left out, and the targets with more than :data:`HUB_LANES` in-lanes
    cut into pieces of that many lanes.  Built once per prepared weighted
    graph (``PreparedWeightedGraph.relax_index``), from the lanes alone;
    on the card a count pass and a fill pass at the prefix-summed
    offsets, which leave each target's lanes in no particular order
    (``ref.in_lanes_sorted`` compares two builds).  Raises on a lane id
    outside [0, n_pad)."""
    m = src_idx.shape[0]
    if dst_idx.shape != (m,) or w_edges.shape != (m,):
        raise ValueError(f"lanes: shapes {tuple(src_idx.shape)}, "
                         f"{tuple(dst_idx.shape)}, {tuple(w_edges.shape)}")
    if not w_edges.is_cuda:
        return ref.in_lanes_ref(src_idx, dst_idx, w_edges, n_pad,
                                HUB_LANES)
    common.check_cuda(src_idx=(src_idx, torch.int32),
                      dst_idx=(dst_idx, torch.int32),
                      w_edges=(w_edges, torch.float32))
    dev = w_edges.device
    counts = torch.zeros(n_pad + 1, dtype=torch.int32, device=dev)
    common.launch(_lib(), "dawn_tropical_in_lanes", dev, src_idx.data_ptr(),
                  dst_idx.data_ptr(), w_edges.data_ptr(), counts.data_ptr(),
                  None, None, m, n_pad, 0)
    offsets = torch.zeros(n_pad + 1, dtype=torch.int64, device=dev)
    offsets[1:] = torch.cumsum(counts[:n_pad], 0)
    total, bad = torch.stack([offsets[-1], counts[n_pad].long()]).tolist()
    if bad:
        raise ValueError(f"lane ids outside [0, {n_pad})")
    offsets = offsets.to(torch.int32)
    cur = offsets[:n_pad].clone()
    src = torch.empty(max(total, 1), dtype=torch.int32, device=dev)
    w = torch.empty(max(total, 1), dtype=torch.float32, device=dev)
    common.launch(_lib(), "dawn_tropical_in_lanes", dev, src_idx.data_ptr(),
                  dst_idx.data_ptr(), w_edges.data_ptr(), cur.data_ptr(),
                  src.data_ptr(), w.data_ptr(), m, n_pad, 1)
    in_lanes.launches += 1
    return common.LaneIndex(offsets, src[:total], w[:total],
                            *ref.hub_pieces(offsets, HUB_LANES))


def _lane_parts(index: common.LaneIndex, n_pad: int) -> dict:
    """The in-lane index a K9 call was handed fits the state's shape:
    offsets and first pieces of shape (n_pad + 1,), sources and weights
    of one length, (P, 2) pieces.  Returns its tensors with the dtype each
    must have (``common.check_cuda``'s arguments)."""
    for name in ("offsets", "hub_first"):
        if getattr(index, name).shape != (n_pad + 1,):
            raise ValueError(f"index: {name} of shape "
                             f"{tuple(getattr(index, name).shape)}, "
                             f"expected ({n_pad + 1},)")
    if index.src.shape != index.w.shape or index.src.dim() != 1:
        raise ValueError("index: expected a weight beside each source")
    if index.pieces.dim() != 2 or index.pieces.shape[1] != 2:
        raise ValueError(f"index: pieces of shape "
                         f"{tuple(index.pieces.shape)}, expected (P, 2)")
    return {"offsets": (index.offsets, torch.int32),
            "src": (index.src, torch.int32), "w": (index.w, torch.float32),
            "hub_first": (index.hub_first, torch.int32),
            "pieces": (index.pieces, torch.int32)}


def sparse_relax_sweep(frontier: torch.Tensor, dist: torch.Tensor,
                       src_idx: torch.Tensor, dst_idx: torch.Tensor,
                       w_edges: torch.Tensor, *, eb: int = 128,
                       index: Optional[common.LaneIndex] = None):
    """One (min,+) relax sweep over the CSR lanes (K9).  frontier (S, n_pad)
    int8, dist (S, n_pad) f32, src/dst (m_pad,) int32 lanes (sentinel-
    padded, indices < n_pad), w_edges (m_pad,) f32 (+inf padded lanes,
    weights >= 0).  m_pad % eb == 0 (``eb`` is kept for the JAX
    signature); on the card also n_pad % 32 == 0 and n_pad < 2^27.
    Returns (new int8, dist f32).

    ``index`` is the lanes' in-lane index (:func:`in_lanes`); without it
    the wrapper builds it, on the card only (the plain version takes
    none).  On the card an entry kernel turns the frontier-masked state
    node-major, a hub kernel walks the index's pieces of the targets with
    the most in-lanes, and a gather kernel takes, per target and group of
    32 rows, the min over the target's in-lanes (or its pieces' partial
    mins) whose source is in some row's frontier; min is order-free, so
    the lanes' order changes no bit."""
    s, n_pad = frontier.shape
    m_pad = src_idx.shape[0]
    if dist.shape != (s, n_pad) or dst_idx.shape != (m_pad,) or \
            w_edges.shape != (m_pad,):
        raise ValueError(f"shapes: {tuple(frontier.shape)}, "
                         f"{tuple(dist.shape)}, {tuple(src_idx.shape)}, "
                         f"{tuple(dst_idx.shape)}, {tuple(w_edges.shape)}")
    if m_pad % eb:
        raise ValueError(f"m_pad={m_pad} is not a multiple of eb={eb}")
    parts = {} if index is None else _lane_parts(index, n_pad)
    if not dist.is_cuda:
        for name, (t, dtype) in parts.items():
            if t.dtype != dtype or t.device != dist.device:
                raise ValueError(f"index: {name} must be {dtype} on "
                                 f"{dist.device}, got {t.dtype} on "
                                 f"{t.device}")
        return ref.sparse_relax_ref(frontier, dist, src_idx, dst_idx,
                                    w_edges)
    if n_pad % 32 or n_pad >= 1 << 27:
        raise ValueError(f"the kernel needs n_pad % 32 == 0 and n_pad < "
                         f"2^27, got {n_pad}")
    dev = dist.device
    if index is None:
        index = in_lanes(src_idx, dst_idx, w_edges, n_pad)
        parts = _lane_parts(index, n_pad)
    # dtypes, one device, contiguity and alignment, index and state at once
    common.check_cuda(frontier=(frontier, torch.int8),
                      dist=(dist, torch.float32), **parts)
    sp = 32 * -(-s // 32)                    # node-major rows, 32 a group
    npieces = index.pieces.shape[0]
    # one scratch buffer (an allocation costs the host more than the card
    # takes for a thin sweep): fd_t (n_pad, sp) f32, hpart (P, sp) f32,
    # fbits (sp / 32, n_pad / 32) uint32, each 128-byte aligned
    fd_words, hp_words = n_pad * sp, max(npieces, 1) * sp
    scratch = torch.empty(fd_words + hp_words + sp * n_pad // 1024,
                          dtype=torch.float32, device=dev)
    fd_t = scratch.data_ptr()
    hpart = fd_t + 4 * fd_words
    fbits = hpart + 4 * hp_words
    new = torch.empty((s, n_pad), dtype=torch.int8, device=dev)
    dist_out = torch.empty_like(dist)
    common.launch(_lib(), "dawn_sparse_relax", dev, frontier.data_ptr(),
                  dist.data_ptr(), index.offsets.data_ptr(),
                  index.src.data_ptr(), index.w.data_ptr(),
                  index.hub_first.data_ptr(), index.pieces.data_ptr(),
                  fd_t, fbits, hpart, new.data_ptr(), dist_out.data_ptr(), s,
                  n_pad, npieces)
    sparse_relax_sweep.launches += 1
    return new, dist_out


reset_launches()
