"""Graph partitioning for the sharded executor (the port of
``repro/graph/partition.py``).

Two layouts, matched to the two execution paths:

1. ``block_dense``  — (R, C) grid of dense adjacency tiles for the dense
   forms: tile (r, c) holds the edges src ∈ row-block r, dst ∈ col-block c.

2. ``edge_partition`` / ``edge_partition_global`` — per-shard padded
   COO, partitioned by *destination* block, so that each shard's scatter
   lands in one contiguous range of targets.

Both produce fixed shapes (every shard padded to the largest), built on
the host with numpy exactly as the JAX package builds them, then put on
the graph's device.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from .csr import CSRGraph, _round_up


def block_dense(g: CSRGraph, r_blocks: int, c_blocks: int,
                dtype=torch.int8) -> Tuple[torch.Tensor, int]:
    """Dense (R, C, nb_r, nb_c) tile grid.  Returns (tiles, nb_r)."""
    n = g.n_nodes
    nb = _round_up((n + max(r_blocks, c_blocks) - 1)
                   // max(r_blocks, c_blocks), 128)
    n_pad = nb * max(r_blocks, c_blocks)
    nb_r = n_pad // r_blocks
    nb_c = n_pad // c_blocks
    dense = np.zeros((n_pad, n_pad), dtype=np.int8)
    src, dst = g.edge_arrays_np()
    dense[src, dst] = 1
    tiles = dense.reshape(r_blocks, nb_r, c_blocks, nb_c).transpose(0, 2, 1, 3)
    return torch.from_numpy(np.ascontiguousarray(tiles)).to(
        device=g.device, dtype=dtype), nb_r


def _dst_block_partition(g: CSRGraph, n_parts: int):
    """Shared dst-block bucketing: (src, dst, per-part selection masks,
    n_local, common multiple-of-128 lane count).  Both partitioners below
    derive from this, so the padding and sentinel rules cannot diverge."""
    n = g.n_nodes
    n_local = (n + n_parts - 1) // n_parts
    src, dst = g.edge_arrays_np()
    part = dst // n_local
    sels = [part == p for p in range(n_parts)]
    e_pad = max(_round_up(int(max((int(s.sum()) for s in sels),
                                  default=0)), 128), 128)
    return src, dst, sels, n_local, e_pad


def edge_partition_global(g: CSRGraph, n_parts: int, weights=None):
    """Per-shard padded COO with GLOBAL ids — the sharded executor's
    sparse operand (``core/distributed.py``).  Edges are partitioned by
    destination block, every part padded to a common multiple-of-128 lane
    count with the CSR sentinel (src = dst = n, w = +inf).  Returns:

      src  (P, e_pad) int32    global source ids (sentinel n)
      dst  (P, e_pad) int32    global destination ids (sentinel n)
      w    (P, e_pad) float32  lane weights, +inf padding (when
                               ``weights`` — per real edge — is given)
      e_pad, n_parts, n_nodes
    """
    n = g.n_nodes
    src, dst, sels, _, e_pad = _dst_block_partition(g, n_parts)
    src_out = np.full((n_parts, e_pad), n, dtype=np.int32)
    dst_out = np.full((n_parts, e_pad), n, dtype=np.int32)
    w_out = np.full((n_parts, e_pad), np.inf, dtype=np.float32)
    if isinstance(weights, torch.Tensor):
        weights = weights.detach().cpu().numpy()
    w = None if weights is None else \
        np.asarray(weights, np.float32)[: g.n_edges]
    for p, sel in enumerate(sels):
        k = int(sel.sum())
        src_out[p, :k] = src[sel]
        dst_out[p, :k] = dst[sel]
        if w is not None:
            w_out[p, :k] = w[sel]
    out = {
        "src": torch.from_numpy(src_out).to(g.device),
        "dst": torch.from_numpy(dst_out).to(g.device),
        "e_pad": e_pad,
        "n_parts": n_parts,
        "n_nodes": n,
    }
    if w is not None:
        out["w"] = torch.from_numpy(w_out).to(g.device)
    return out


def edge_partition(g: CSRGraph, n_parts: int):
    """Partition the COO edges by dst block.  Returns a dict of stacked
    padded arrays:

      src  (P, e_pad) int32   global source ids (sentinel n)
      dst  (P, e_pad) int32   *local* destination ids within the part
      n_local (int)           nodes per part (last part padded)
    """
    n = g.n_nodes
    src, dst, sels, n_local, e_pad = _dst_block_partition(g, n_parts)
    src_out = np.full((n_parts, e_pad), n, dtype=np.int32)
    dst_out = np.full((n_parts, e_pad), n_local, dtype=np.int32)
    for p, sel in enumerate(sels):
        k = int(sel.sum())
        src_out[p, :k] = src[sel]
        dst_out[p, :k] = dst[sel] - p * n_local
    return {
        "src": torch.from_numpy(src_out).to(g.device),
        "dst": torch.from_numpy(dst_out).to(g.device),
        "n_local": n_local,
        "n_parts": n_parts,
        "n_nodes": n,
    }
