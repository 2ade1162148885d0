"""BOVM — Boolean Vector/Matrix Operation (paper Alg. 1), dense form.

The port of ``repro/core/bovm.py``.  The paper walks CSC columns with a
per-element early exit; the matrix form is a {0,1}-valued product.  A
sweep computes

    counts = F @ A        (S sources batched)
    hits   = counts > 0
    new    = hits & ~visited          # Theorem 3.2 skip
    dist   = where(new, step, dist)   # first hit IS the shortest path

Values are exact: counts <= n < 2^24, so the f32 product is lossless;
``accum_dtype`` picks another accumulator (float16, bfloat16, int32: the
same booleans; narrower integers wrap and are refused).

``bovm_msbfs`` pins the dense PUSH form of
:func:`repro_torch.core.sweep.boolean_forms` into
:func:`repro_torch.core.sweep.sweep_loop` (Fact-1 convergence, Eq. 5
work counter and all).  The batched, direction-optimizing production
path is ``core/engine.py``.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from . import sweep as S
from .frontier import UNREACHED, one_hot_frontier


class DawnState(NamedTuple):
    frontier: torch.Tensor       # (S, n) int8 — discovered by the last sweep
    dist: torch.Tensor           # (S, n) int32, UNREACHED = -1
    step: int                    # sweeps executed
    done: bool                   # Fact 1 fired
    edges_touched: torch.Tensor  # 0-d float32 — work counter (Eq. 5)


def bovm_sweep(adj: torch.Tensor, frontier: torch.Tensor,
               visited: torch.Tensor, *, accum_dtype=torch.float32,
               matmul_fn: Optional[Callable] = None) -> torch.Tensor:
    """One boolean sweep: new = (frontier @ adj > 0) & ~visited.

    adj      : (n, n) int8/bool dense adjacency (row = src, col = dst)
    frontier : (S, n) bool
    visited  : (S, n) bool
    accum_dtype: the product's accumulator (``sweep.resolve_accum_dtype``)
    matmul_fn: optional override ``(frontier, adj) -> counts``.
    """
    if matmul_fn is None:
        counts = S.count_hits(frontier, adj,
                              S.resolve_accum_dtype(accum_dtype))
    else:
        counts = matmul_fn(frontier, adj)
    return (counts > 0) & ~visited


def bovm_msbfs(adj: torch.Tensor, sources, *,
               max_steps: Optional[int] = None,
               accum_dtype=torch.float32) -> DawnState:
    """Multi-source DAWN over a dense adjacency.

    adj     : (n, n) int8 dense adjacency
    sources : (S,) source ids
    returns : DawnState with dist (S, n); dist[s, sources[s]] = 0.
    """
    n = adj.shape[0]
    dev = adj.device
    src = torch.as_tensor(sources, dtype=torch.int64, device=dev).reshape(-1)
    s = src.shape[0]
    max_steps = n if max_steps is None else max_steps

    f0 = one_hot_frontier(src, n, dtype=torch.int8)
    dist0 = torch.where(f0 != 0, 0, UNREACHED).to(torch.int32)
    deg = adj.to(torch.float32).sum(dim=1)               # out-degrees

    # dense boolean PUSH only: the pull/sparse operands are never read
    dummy = torch.zeros(1, dtype=torch.int32, device=dev)
    push, _, _ = S.boolean_forms(adj, None, dummy, dummy, n_pad=n, s=s,
                                 use_kernel=False, accum_dtype=accum_dtype)
    st = S.sweep_loop((push,), S.make_state(f0, dist0, n_forms=1),
                      max_steps=max_steps, deg=deg)
    return DawnState(frontier=st.frontier, dist=st.dist, step=st.step,
                     done=st.done, edges_touched=st.edges_touched)


def bovm_sssp(adj: torch.Tensor, source, **kw) -> DawnState:
    """Single-source convenience wrapper (S = 1)."""
    st = bovm_msbfs(adj, [int(source)], **kw)
    return DawnState(frontier=st.frontier[0], dist=st.dist[0],
                     step=st.step, done=st.done,
                     edges_touched=st.edges_touched)
