"""Fanout neighbor sampler (GraphSAGE) built on DAWN frontier machinery
(the port's counterpart of ``repro/graph/sampler.py``).

A fanout sample IS a randomized sub-frontier expansion: hop ``h`` draws
``fanout[h]`` neighbors per frontier node from the CSR row — exactly the
SOVM row-gather (paper Alg. 2 line 4-5) with a random subset instead of the
full row.  Fixed shapes throughout: each hop yields (batch · prod(fanouts))
node ids with repeats allowed (standard GraphSAGE semantics); zero-degree
nodes self-loop.

Randomness comes from an explicit ``torch.Generator`` on the graph's
device, where the JAX package takes a key; ``sample_subgraph`` draws hop
after hop from that one generator.  ``_hop_from_draws`` maps the integer
draws to neighbors the way the JAX sampler does, so the same draws give
the same ids in both packages.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch

from .csr import CSRGraph

_INT32_MAX = 2 ** 31 - 1


def _hop_from_draws(g: CSRGraph, nodes: torch.Tensor,
                    r: torch.Tensor) -> torch.Tensor:
    """Neighbors picked by non-negative integer draws ``r`` (B, fanout):
    draw ``r`` of node ``u`` takes lane ``r % deg(u)`` of its CSR row; a
    node of degree 0 (or the sentinel ``n_nodes``) returns itself."""
    row = torch.clamp(nodes, max=g.n_nodes - 1).long()
    start = g.indptr[row]
    deg = g.indptr[row + 1] - start
    # r mod deg, guarding deg==0 → self-loop
    offs = r % torch.clamp(deg, min=1)[:, None]
    eidx = start[:, None] + offs
    nbrs = g.indices[torch.clamp(eidx, 0, g.m_pad - 1).long()]
    return torch.where(deg[:, None] > 0, nbrs, nodes[:, None])


def sample_hop(g: CSRGraph, nodes: torch.Tensor,
               generator: torch.Generator, fanout: int) -> torch.Tensor:
    """Sample ``fanout`` neighbors for each node. (B,) -> (B, fanout),
    int32 on the graph's device; ``generator`` lies on that device."""
    nodes = torch.as_tensor(nodes, dtype=torch.int32, device=g.device)
    r = torch.randint(0, _INT32_MAX, (nodes.shape[0], fanout),
                      generator=generator, device=g.device,
                      dtype=torch.int32)
    return _hop_from_draws(g, nodes, r)


def sample_subgraph(g: CSRGraph, seeds, generator: torch.Generator,
                    fanouts: Sequence[int]) -> Tuple[torch.Tensor, ...]:
    """Multi-hop fanout sample. Returns tuple of per-hop node-id tensors:
    layer 0 = seeds (B,), layer h = (B * prod(fanouts[:h]),)."""
    seeds = torch.as_tensor(seeds, dtype=torch.int32, device=g.device)
    layers = [seeds]
    cur = seeds
    for f in fanouts:
        cur = sample_hop(g, cur, generator, int(f)).reshape(-1)
        layers.append(cur)
    return tuple(layers)
