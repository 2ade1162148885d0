"""Wrappers of the boolean sweep kernels (``csrc/bovm.cu``).

The port's counterpart of ``repro/kernels/bovm/kernel.py``: the same four
entry points with the JAX signatures, tile keywords and divisibility
checks, returning ``(new int8, dist int32[, prod, stopped])``.

  packed_push_sweep         K1 — bit-packed push, gated by f_occ / o_occ
  packed_pull_sweep         K2 — bit-packed pull, no gating
  fused_boolean_multisweep  K3 — up to ``n_run`` sweeps per launch
  fused_sweep               K4 — masked int8 GEMM push (``push_f32``)

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

import torch

from ...core.frontier import pack_bits
from .. import _build, common
from . import ref

SOURCE = Path(__file__).resolve().parent / "csrc" / "bovm.cu"

FUSED_ROWS = 8          # source rows per K3 block, passed to the kernel

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "dawn_packed_push_sweep": [_P] * 7 + [_I] * 8 + [_P],
    "dawn_packed_pull_sweep": [_P] * 5 + [_I] * 7 + [_P],
    "dawn_fused_boolean_multisweep": [_P] * 7 + [_I] * 7 + [_P],
    "dawn_fused_sweep": [_P] * 7 + [_I] * 8 + [_P],
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
    """Launch on ``device``'s current stream; raise on a launch error."""
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        status = getattr(_lib(), name)(*args, stream)
    if status != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {status}")


def _ptr(t: torch.Tensor) -> int:
    return t.data_ptr()


def _check_cuda(**tensors) -> None:
    """dtype / device / contiguity contract of a kernel launch."""
    dev = None
    for name, (t, dtype) in tensors.items():
        if t.dtype != dtype:
            raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
        if not t.is_cuda:
            raise ValueError(f"{name}: expected a CUDA tensor")
        if not t.is_contiguous():
            raise ValueError(f"{name}: expected a contiguous tensor")
        if dev is not None and t.device != dev:
            raise ValueError(f"{name}: on {t.device}, expected {dev}")
        dev = t.device


def _tile_rows(bs: int, limit: int) -> int:
    """Largest power-of-two row group <= ``limit`` that divides ``bs``."""
    for r in (32, 16, 8, 4, 2, 1):
        if r <= limit and bs % r == 0:
            return r
    return 1


def reset_launches() -> None:
    for fn in (packed_push_sweep, packed_pull_sweep,
               fused_boolean_multisweep, fused_sweep):
        fn.launches = 0


# --------------------------------------------------------------------------
# K1 / K2: bit-packed sweeps
# --------------------------------------------------------------------------

def _check_packed(frontier_packed, adj_in_packed, dist, bs, bn, wk):
    s, w = frontier_packed.shape
    n = adj_in_packed.shape[0]
    if adj_in_packed.shape != (n, w) or dist.shape != (s, n):
        raise ValueError(f"shapes: {tuple(frontier_packed.shape)}, "
                         f"{tuple(adj_in_packed.shape)}, {tuple(dist.shape)}")
    if s % bs or n % bn or w % wk:
        raise ValueError(f"tiles do not divide the shapes: {(s, n, w)} vs "
                         f"{(bs, bn, wk)}")
    return s, n, w


def _packed_outputs(frontier_packed, adj_in_packed, dist):
    _check_cuda(frontier_packed=(frontier_packed, torch.int32),
                adj_in_packed=(adj_in_packed, torch.int32),
                dist=(dist, torch.int32))
    return torch.empty(dist.shape, dtype=torch.int8, device=dist.device), \
        torch.empty_like(dist)


def packed_push_sweep(frontier_packed: torch.Tensor,
                      adj_in_packed: torch.Tensor, dist: torch.Tensor, step,
                      *, bs: int = 128, bn: int = 128, wk: int = 128):
    """Bit-packed push sweep (K1).  frontier_packed (S, W) int32 words,
    adj_in_packed (n, W) int32 words (row j = packed in-neighbours of j),
    dist (S, n) int32.  S % bs == 0, n % bn == 0, W % wk == 0.  Tiles
    whose frontier word block (f_occ) or unreached set (o_occ) is empty
    are skipped."""
    s, n, w = _check_packed(frontier_packed, adj_in_packed, dist, bs, bn, wk)
    gi, gj, gk = s // bs, n // bn, w // wk
    f_occ = common.block_any(frontier_packed != 0, gi, bs, gk, wk)
    o_occ = common.block_any(dist < 0, gi, bs, gj, bn)
    if not dist.is_cuda:
        return ref.packed_push_ref(frontier_packed, adj_in_packed, dist,
                                   step, f_occ=f_occ, o_occ=o_occ)
    new, dist_out = _packed_outputs(frontier_packed, adj_in_packed, dist)
    rows = _tile_rows(bs, 32)
    _launch("dawn_packed_push_sweep", dist.device, _ptr(frontier_packed),
            _ptr(adj_in_packed), _ptr(dist), _ptr(new), _ptr(dist_out),
            _ptr(f_occ.contiguous()), _ptr(o_occ.contiguous()),
            s, n, w, rows, bs, bn, wk, int(step))
    packed_push_sweep.launches += 1
    return new, dist_out


def packed_pull_sweep(frontier_packed: torch.Tensor,
                      adj_in_packed: torch.Tensor, dist: torch.Tensor, step,
                      *, bs: int = 8, bn: int = 128, wk: int = 128):
    """Bit-packed pull sweep (K2).  Same operands and word math as
    :func:`packed_push_sweep`, no occupancy gating.  S % bs == 0,
    n % bn == 0, W % wk == 0."""
    s, n, w = _check_packed(frontier_packed, adj_in_packed, dist, bs, bn, wk)
    if not dist.is_cuda:
        return ref.packed_pull_ref(frontier_packed, adj_in_packed, dist, step)
    new, dist_out = _packed_outputs(frontier_packed, adj_in_packed, dist)
    rows = _tile_rows(bs, 32)
    _launch("dawn_packed_pull_sweep", dist.device, _ptr(frontier_packed),
            _ptr(adj_in_packed), _ptr(dist), _ptr(new), _ptr(dist_out),
            s, n, w, rows, bs, bn, int(step))
    packed_pull_sweep.launches += 1
    return new, dist_out


# --------------------------------------------------------------------------
# K3: fused multi-sweep
# --------------------------------------------------------------------------

def fused_smem_bytes(n: int, rows: int = FUSED_ROWS) -> int:
    """Shared memory of one K3 block of ``rows`` source rows at padded
    node count ``n``: current, next and visited packed rows plus the
    active-word list.  The launch passes this size to the kernel."""
    words = max(n // 32, 1)
    return 4 * words * (3 * rows + 2)


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
    runs FUSED_ROWS source rows per block whatever ``bs`` is; rows evolve
    independently, so no result depends on the tile."""
    s, n = frontier.shape
    w = adj_in_packed.shape[1]
    if adj_in_packed.shape != (n, w) or dist.shape != (s, n) or w * 32 != n:
        raise ValueError(f"shapes: {tuple(frontier.shape)}, "
                         f"{tuple(adj_in_packed.shape)}, {tuple(dist.shape)}")
    if s % bs or n % 128 or s % FUSED_ROWS:
        raise ValueError(f"tiles do not divide the shapes: {(s, n)} vs "
                         f"bs={bs}")
    n_run = int(n_run)
    if not 0 <= n_run <= max_sweeps:
        raise ValueError(f"n_run={n_run} outside [0, {max_sweeps}]")
    if not dist.is_cuda:
        return ref.fused_boolean_multisweep_ref(frontier, adj_in_packed,
                                                dist, step, n_run)
    _check_cuda(frontier=(frontier, torch.int8),
                adj_in_packed=(adj_in_packed, torch.int32),
                dist=(dist, torch.int32))
    fp = pack_bits(frontier != 0)
    smem = fused_smem_bytes(n)
    if smem > common.SMEM_BUDGET_BYTES:
        raise ValueError(f"n={n}: the fused kernel's shared memory "
                         f"({smem} B) exceeds the budget")
    tiles = s // FUSED_ROWS
    new = torch.empty((s, n), dtype=torch.int8, device=dist.device)
    dist_out = torch.empty_like(dist)
    prod = torch.empty(tiles, dtype=torch.int32, device=dist.device)
    stop = torch.empty(tiles, dtype=torch.int32, device=dist.device)
    _launch("dawn_fused_boolean_multisweep", dist.device, _ptr(fp),
            _ptr(adj_in_packed), _ptr(dist), _ptr(new), _ptr(dist_out),
            _ptr(prod), _ptr(stop), s, n, w, FUSED_ROWS, smem, int(step),
            n_run)
    fused_boolean_multisweep.launches += 1
    return new, dist_out, prod.max(), stop.min() > 0


# --------------------------------------------------------------------------
# K4: masked int8 GEMM push (push_f32)
# --------------------------------------------------------------------------

def fused_sweep(frontier: torch.Tensor, adj: torch.Tensor, dist: torch.Tensor,
                step, *, bs: int = 128, bn: int = 128, bk: int = 512):
    """One masked-GEMM DAWN sweep (K4).  frontier (S, k) int8, adj (k, n)
    int8, dist (S, n) int32; S % bs == 0, n % bn == 0, k % bk == 0.  The
    kernel accumulates in int32 (exact); its plain version in f32 (exact
    below 2^24), so both give the same ``new`` and ``dist``.  On the card
    ``bs`` must be a multiple of 8, and the kernel's launch refuses a
    ``bn`` or ``bk`` its column and contraction stages do not divide."""
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
    _check_cuda(frontier=(frontier, torch.int8), adj=(adj, torch.int8),
                dist=(dist, torch.int32))
    tm = _tile_rows(bs, 32)
    if tm < 8:
        raise ValueError(f"the kernel needs bs % 8 == 0, got bs={bs}")
    new = torch.empty((s, n), dtype=torch.int8, device=dist.device)
    dist_out = torch.empty_like(dist)
    _launch("dawn_fused_sweep", dist.device, _ptr(frontier), _ptr(adj),
            _ptr(dist), _ptr(new), _ptr(dist_out), _ptr(f_occ.contiguous()),
            _ptr(o_occ.contiguous()), s, n, k, tm, bs, bn, bk, int(step))
    fused_sweep.launches += 1
    return new, dist_out


reset_launches()
