"""Plain PyTorch versions of the two counting sweep kernels and of the
operand's live-word index.

Each function computes exactly what its CUDA kernel in
``csrc/counting.cu`` computes.  The wrappers in ``kernel.py`` call them
for tensors on the CPU; on the card they are the reference each kernel
is held against.  The product is taken in f32 and chunked over
destination columns: the int8 operand goes to f32 one column chunk at a
time, never whole, so the functions also run at full width on the card
(at n_pad = 65,664 a whole f32 copy would be 17 GB).  On the card the
chunk products run in full f32 only while
``torch.backends.cuda.matmul.allow_tf32`` is False, its default.

Path counts are integer-valued f32: exact below 2^24, where any
summation order gives the same bits.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..common import WordIndex, expand_table, word_index_ref

# bound on one chunk's f32 operand copy, in elements
_CHUNK_ELEMS = 1 << 25


def counting_product(fsigma: torch.Tensor, adj: torch.Tensor) -> torch.Tensor:
    """cand[s, j] = sum_k fsigma[s, k] * adj[k, j] in f32, chunked over
    destination columns j."""
    k, n = adj.shape
    chunk = max(1, _CHUNK_ELEMS // max(k, 1))
    return torch.cat([fsigma @ adj[:, j0: j0 + chunk].to(torch.float32)
                      for j0 in range(0, n, chunk)], dim=1)


def nonzero_words_ref(adj: torch.Tensor) -> WordIndex:
    """The live-word index of a (k, n) int8 operand: per row, the 16-byte
    words (16 columns) that hold a non-zero byte, ascending."""
    return word_index_ref(adj, 16, lambda blk: blk != 0)


def counting_sweep_ref(fsigma: torch.Tensor, adj: torch.Tensor,
                       dist: torch.Tensor, sigma: torch.Tensor, step,
                       f_occ: Optional[torch.Tensor] = None,
                       o_occ: Optional[torch.Tensor] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One counting push sweep (K5).

    fsigma : (S, k) f32 — frontier-masked path counts
             (``where(frontier, sigma, 0)``)
    adj    : (k, n) int8 adjacency
    dist   : (S, n) int32 levels, -1 unreached
    sigma  : (S, n) f32 path counts

    cand[s, j] = sum_k fsigma[s, k] * A[k, j]; new = (cand > 0) &
    unreached; dist' = new ? step : dist; sigma' = new ? cand : sigma.
    The occupancy tables, when given, gate the inputs the way the
    kernel's tile skips do: a skipped k-block contributes nothing, a
    skipped output tile discovers nothing.
    """
    if f_occ is not None:
        fsigma = fsigma * expand_table(f_occ, *fsigma.shape)
    cand = counting_product(fsigma, adj)
    new = (cand > 0) & (dist < 0)
    if o_occ is not None:
        new &= expand_table(o_occ, *dist.shape)
    step_t = torch.tensor(int(step), dtype=dist.dtype, device=dist.device)
    return (new.to(torch.int8), torch.where(new, step_t, dist),
            torch.where(new, cand, sigma))


def fused_counting_multisweep_ref(frontier: torch.Tensor, adj: torch.Tensor,
                                  dist: torch.Tensor, sigma: torch.Tensor,
                                  step, n_run):
    """Up to ``n_run`` counting sweeps with the Fact-1 check after each
    (K6), following the JAX kernel body sweep by sweep over the whole
    batch as one tile.

    Rows evolve independently (the operand is read-only) and a row's
    productive sweeps form a prefix, so the per-tile accounting of the
    kernel reduces to whole-batch terms: ``prod`` is the number of
    productive sweeps, ``stopped`` whether a sweep found nothing within
    ``n_run``.  Once a sweep finds nothing every later sweep is inert, so
    the loop ends there.  Returns (new int8, (dist int32, sigma f32), prod
    int32 scalar, stopped bool scalar).
    """
    step0 = int(step)
    d, sg = dist, sigma
    f8 = frontier
    new8 = torch.zeros(dist.shape, dtype=torch.int8, device=dist.device)
    done, prod = False, 0
    for t in range(int(n_run)):
        fs = torch.where(f8 != 0, sg, torch.zeros((), dtype=sg.dtype,
                                                  device=sg.device))
        cand = counting_product(fs, adj)
        new = (cand > 0) & (d < 0)
        any_new = bool(new.any())
        d = torch.where(new, torch.tensor(step0 + 1 + t, dtype=d.dtype,
                                          device=d.device), d)
        sg = torch.where(new, cand, sg)
        new8 = new.to(torch.int8)
        f8 = new8
        if not any_new:
            done = True
            break
        prod += 1
    return (new8, (d, sg), torch.tensor(prod, dtype=torch.int32),
            torch.tensor(done))
