"""Full multi-source DAWN drivers over the boolean sweep kernels.

The port of ``repro/kernels/bovm/ops.py``: the same entry points and
signatures, a host loop where the JAX package runs ``lax.while_loop``.

  sweep                one sweep: K4 on the card, its plain version on
                       the CPU
  msbfs_kernel         multi-source BFS, K4 (``fused_sweep``) each sweep
  msbfs_packed         multi-source pull BFS over the bit-packed
                       in-neighbour matrix, K2 (``packed_pull_sweep``)
                       each sweep
  pack_adjacency_pull  dense adjacency -> packed in-neighbour rows

On CPU tensors the wrappers compute their plain versions, so both
drivers run there through the same calls.  ``interpret=`` is accepted
and ignored, to keep the JAX signatures.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ...core.frontier import UNREACHED, one_hot_frontier, pack_bits
from . import kernel as K
from . import ref as R


class KernelDawnResult(NamedTuple):
    dist: torch.Tensor   # (S, n) int32, -1 unreachable
    sweeps: int          # sweeps executed, the last (empty) one included


def sweep(frontier, adj, dist, step, *, use_kernel: bool = True,
          interpret: Optional[bool] = None, **tiles):
    """Single fused sweep: K4 on the card, where the tiles must divide
    the shapes (K4's wrapper raises otherwise; the JAX package falls back
    to its oracle there, the port never runs a plain version on the
    card).  The plain version on CPU tensors, at any shape, or when
    ``use_kernel=False``."""
    del interpret
    if not use_kernel or not frontier.is_cuda:
        return R.sweep_ref(frontier, adj, dist, step)
    return K.fused_sweep(frontier, adj, dist, step, **tiles)


def msbfs_kernel(adj: torch.Tensor, sources: torch.Tensor, *,
                 max_steps: int, interpret: bool = True, bs: int = 128,
                 bn: int = 128, bk: int = 512) -> KernelDawnResult:
    """Full multi-source DAWN with K4 (the masked int8 GEMM push) in the
    loop body.  adj (n, n) int8 dense adjacency, sources (S,) on the same
    device; S % bs == 0, n % bn == 0, n % bk == 0."""
    del interpret
    n = adj.shape[0]
    f = one_hot_frontier(sources, n, dtype=torch.int8)
    dist = torch.where(f > 0, 0, UNREACHED).to(torch.int32)
    step, done = 0, False
    while not done and step < max_steps:
        f, dist = K.fused_sweep(f, adj, dist, step + 1, bs=bs, bn=bn, bk=bk)
        step += 1
        done = not bool(f.any())
    return KernelDawnResult(dist, step)


def msbfs_packed(adj_in_packed: torch.Tensor, sources: torch.Tensor,
                 n: int, *, max_steps: int, interpret: bool = True,
                 bs: int = 8, bn: int = 128, wk: int = 128
                 ) -> KernelDawnResult:
    """Pull-direction DAWN over the bit-packed in-neighbour matrix, K2 in
    the loop body.  adj_in_packed (n, ceil(n / 32)) int32 words (row j =
    packed in-neighbours of j, as :func:`pack_adjacency_pull` gives);
    S % bs == 0, n % bn == 0, W % wk == 0.  On the card the operand's
    live-word index, which K2 reads, is built once before the loop."""
    del interpret
    f0 = one_hot_frontier(sources, n, dtype=torch.bool)
    dist = torch.where(f0, 0, UNREACHED).to(torch.int32)
    fp = K.pack_frontier(f0)
    index = K.packed_live_words(adj_in_packed) if adj_in_packed.is_cuda \
        else None
    step, done = 0, False
    while not done and step < max_steps:
        new, dist = K.packed_pull_sweep(fp, adj_in_packed, dist, step + 1,
                                        bs=bs, bn=bn, wk=wk, index=index)
        fp = K.pack_frontier(new)
        step += 1
        done = not bool(new.any())
    return KernelDawnResult(dist, step)


def pack_adjacency_pull(adj: torch.Tensor) -> torch.Tensor:
    """(n, n) dense adjacency -> (n, W) int32 packed in-neighbour rows."""
    return pack_bits(adj.t() != 0)
