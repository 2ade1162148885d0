"""Wrappers of the counting sweep kernels (``csrc/counting.cu``).

The port's counterpart of ``repro/kernels/counting/kernel.py``: the same
two entry points with the JAX signatures, tile keywords and divisibility
checks.

  fused_counting_sweep       K5 — masked f32 counting push, gated by
                             f_occ / o_occ -> (new, dist, sigma)
  fused_counting_multisweep  K6 — up to ``n_run`` counting sweeps per
                             launch -> (new, (dist, sigma), prod, stopped)

and the builder of the operand's live-word index that both read:

  nonzero_words              (k, n) int8 operand -> common.WordIndex of
                             its 16-byte words holding a non-zero byte

For tensors on the CPU each wrapper computes its plain version
(``ref.py``).  For tensors on the card it checks dtype, shape, contiguity
and alignment, allocates the outputs and scratch, launches its kernel on
the current stream and raises on a non-zero launch status; it never falls
back.  The library is built from source on first launch
(``kernels/_build.py``).

Each wrapper counts its launches in its ``launches`` attribute (one per
kernel launch, nothing on the CPU path); :func:`reset_launches` zeroes
them.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path
from typing import Optional

import torch

from .. import _build, common
from . import ref

SOURCE = Path(__file__).resolve().parent / "csrc" / "counting.cu"

CHUNK_WORDS = 16        # K5 / K6: live operand words per work item (<= 32)
PUSH_BLOCKS_PER_SM = 8  # K5: push blocks of 256 threads per SM
BLOCKS_PER_SM = 2       # K6: cooperative blocks per SM (at most 2 fit)

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "dawn_counting_sweep": [_P] * 13 + [_I] * 6 + [_P],
    "dawn_fused_counting_multisweep": [_P] * 18 + [_I] * 6 + [_P],
    "dawn_counting_live_words": [_P] * 3 + [_I] * 2 + [_P],
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
    for fn in (fused_counting_sweep, fused_counting_multisweep, nonzero_words):
        fn.launches = 0


# --------------------------------------------------------------------------
# the live-word index of the operand
# --------------------------------------------------------------------------

def nonzero_words(adj: torch.Tensor) -> common.WordIndex:
    """The live-word index of a (k, n) int8 operand: per row, the 16-byte
    words that hold a non-zero byte (``common.WordIndex``).  Built once
    per prepared graph (``PreparedGraph.adj_index``); on the card two
    passes of one kernel (count, then fill at the prefix-summed offsets)
    read the operand twice."""
    n = adj.shape[1]
    if n % 16:
        raise ValueError(f"n={n} is not a multiple of 16")
    if not adj.is_cuda:
        return ref.nonzero_words_ref(adj)
    common.check_cuda(adj=(adj, torch.int8))
    index = common.build_word_index(_lib(), "dawn_counting_live_words", adj)
    nonzero_words.launches += 1
    return index


# --------------------------------------------------------------------------
# K5: the counting push
# --------------------------------------------------------------------------

def fused_counting_sweep(fsigma: torch.Tensor, adj: torch.Tensor,
                         dist: torch.Tensor, sigma: torch.Tensor, step, *,
                         bs: int = 128, bn: int = 128, bk: int = 128,
                         index: Optional[common.WordIndex] = None):
    """One fused counting sweep (K5).  fsigma (S, k) f32 — the
    frontier-masked path counts (``where(frontier, sigma, 0)``, so
    >= 0), adj (k, n) int8, dist (S, n) int32, sigma (S, n) f32.
    S % bs == 0, n % bn == 0, k % bk == 0; on the card also n % 32 == 0.
    ``index`` is ``adj``'s live-word index (:func:`nonzero_words`, of the
    k rows); without it the wrapper builds it, on the card only (the plain
    version takes none).  Returns (new int8, dist int32, sigma f32).

    k-blocks with no positive fsigma (f_occ) and output tiles with no
    unreached target (o_occ) are skipped; both skips are inert.  The
    plain version applies the two tables; the card's kernel tests each
    row's fsigma > 0 and each target's dist < 0 itself, which gives the
    same result, so the wrapper builds the tables only on the CPU."""
    s, k = fsigma.shape
    ka, n = adj.shape
    if ka != k or dist.shape != (s, n) or sigma.shape != (s, n):
        raise ValueError(f"shapes: {tuple(fsigma.shape)}, {tuple(adj.shape)}"
                         f", {tuple(dist.shape)}, {tuple(sigma.shape)}")
    common.check_push_tiles(s, n, bs, bn, bk, k=k)
    if not dist.is_cuda:
        gi, gj, gk = s // bs, n // bn, k // bk
        f_occ = common.block_any(fsigma > 0, gi, bs, gk, bk)
        o_occ = common.block_any(dist < 0, gi, bs, gj, bn)
        return ref.counting_sweep_ref(fsigma, adj, dist, sigma, step,
                                      f_occ=f_occ, o_occ=o_occ)
    common.check_cuda(fsigma=(fsigma, torch.float32), adj=(adj, torch.int8),
                      dist=(dist, torch.int32), sigma=(sigma, torch.float32))
    if n % 32:
        raise ValueError(f"the kernel needs n % 32 == 0, got n={n}")
    dev = dist.device
    if index is None:
        index = nonzero_words(adj)
    common.check_index(index, k, dev)
    sp = 32 * -(-s // 32)                    # node-major rows, 32 a group
    new = torch.empty((s, n), dtype=torch.int8, device=dev)
    dist_out = torch.empty_like(dist)
    sig_out = torch.empty_like(sigma)
    unr = torch.empty((n // 32, sp), dtype=torch.int32, device=dev)
    items = index.work_list(s, CHUNK_WORDS)
    nitems = torch.zeros(1, dtype=torch.int32, device=dev)
    cand_t = torch.zeros((n, sp), dtype=torch.float32, device=dev)
    common.launch(_lib(), "dawn_counting_sweep", dev, fsigma.data_ptr(),
                  adj.data_ptr(), index.offsets.data_ptr(),
                  index.words.data_ptr(), dist.data_ptr(), sigma.data_ptr(),
                  new.data_ptr(), dist_out.data_ptr(), sig_out.data_ptr(),
                  unr.data_ptr(), items.data_ptr(), nitems.data_ptr(),
                  cand_t.data_ptr(), s, n, k, CHUNK_WORDS,
                  PUSH_BLOCKS_PER_SM, int(step))
    fused_counting_sweep.launches += 1
    return new, dist_out, sig_out


# --------------------------------------------------------------------------
# K6: fused multi-sweep
# --------------------------------------------------------------------------

def fused_smem_bytes(n: int) -> int:
    """Shared memory of one K6 block at padded node count ``n``: none.
    The (dist, sigma) state, the candidate sums, the packed unreached set
    and the work list live in global memory (L2), so the size does not
    grow with ``n``."""
    del n
    return 0


def fused_counting_multisweep(frontier: torch.Tensor, adj: torch.Tensor,
                              state, step, n_run, *, bs: int = 128,
                              max_sweeps: int = 1,
                              index: Optional[common.WordIndex] = None):
    """Run up to ``n_run`` counting sweeps (``n_run <= max_sweeps``) in ONE
    kernel launch (K6).  frontier (S, n) int8, adj (n, n) int8, ``state``
    the (dist int32, sigma f32) pair, ``step`` the sweeps already executed
    (sweep t writes distance step + 1 + t).  ``index`` is ``adj``'s
    live-word index (:func:`nonzero_words`); without it the wrapper builds
    it, on the card only (the plain version takes none).

    Returns (new int8, (dist, sigma), prod int32 scalar, stopped bool
    scalar): ``prod`` is the most productive sweeps of any row tile and
    ``stopped`` whether every tile converged, so the loop driver's
    accounting is ``executed = stopped ? prod + 1 : n_run``.  The kernel
    runs all S rows as one tile on a cooperative grid whatever ``bs`` is;
    rows evolve independently, so no result depends on the tile."""
    dist, sigma = state
    s, n = frontier.shape
    if adj.shape != (n, n) or dist.shape != (s, n) or sigma.shape != (s, n):
        raise ValueError(f"shapes: {tuple(frontier.shape)}, "
                         f"{tuple(adj.shape)}, {tuple(dist.shape)}, "
                         f"{tuple(sigma.shape)}")
    if s % bs or n % 128:
        raise ValueError(f"tiles do not divide the shapes: {(s, n)} vs "
                         f"bs={bs}")
    n_run = int(n_run)
    if not 0 <= n_run <= max_sweeps:
        raise ValueError(f"n_run={n_run} outside [0, {max_sweeps}]")
    if not dist.is_cuda:
        return ref.fused_counting_multisweep_ref(frontier, adj, dist, sigma,
                                                 step, n_run)
    common.check_cuda(frontier=(frontier, torch.int8), adj=(adj, torch.int8),
                      dist=(dist, torch.int32), sigma=(sigma, torch.float32))
    dev = dist.device
    if index is None:
        index = nonzero_words(adj)
    common.check_index(index, n, dev)
    new = torch.empty((s, n), dtype=torch.int8, device=dev)
    dist_out = torch.empty_like(dist)
    sig_out = torch.empty_like(sigma)
    fa = torch.empty((s, n), dtype=torch.int8, device=dev)
    fb = torch.empty((s, n), dtype=torch.int8, device=dev)
    cand = torch.zeros((s, n), dtype=torch.float32, device=dev)
    unr = torch.empty((s, n // 32), dtype=torch.int32, device=dev)
    items = index.work_list(s, CHUNK_WORDS)
    counts = torch.zeros(2 * max(n_run, 1), dtype=torch.int32, device=dev)
    bar = torch.zeros(2, dtype=torch.int32, device=dev)
    prod = torch.empty(1, dtype=torch.int32, device=dev)
    stop = torch.empty(1, dtype=torch.int32, device=dev)
    common.launch(_lib(), "dawn_fused_counting_multisweep", dev,
                  frontier.data_ptr(), adj.data_ptr(),
                  index.offsets.data_ptr(), index.words.data_ptr(),
                  dist.data_ptr(), sigma.data_ptr(), new.data_ptr(),
                  dist_out.data_ptr(), sig_out.data_ptr(), fa.data_ptr(),
                  fb.data_ptr(), cand.data_ptr(), unr.data_ptr(),
                  items.data_ptr(), counts.data_ptr(), bar.data_ptr(),
                  prod.data_ptr(), stop.data_ptr(), s, n, CHUNK_WORDS,
                  BLOCKS_PER_SM, int(step), n_run)
    fused_counting_multisweep.launches += 1
    return new, (dist_out, sig_out), prod[0], stop[0] > 0


reset_launches()
