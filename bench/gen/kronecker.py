"""The Graph500 Kronecker generator (specification 3.0, graph500.org).

A copy of the specification's reference generator
(``kronecker_generator.m``) on the device with torch: ``edgefactor *
2**scale`` tuples, each of ``scale`` bits drawn by the initiator
``A, B, C`` (``D = 1 - A - B - C``), then the vertex labels permuted and
the tuples shuffled.  Self-loops and duplicate tuples stay in, as the
specification makes them; the loader of the system under test drops them.
"""
from __future__ import annotations

import torch


def tuples(scale: int, edgefactor: int, a: float, b: float, c: float,
           gen: torch.Generator, device, permute: bool = True):
    """(src, dst) int64 tuples of the Kronecker graph.  ``permute=False``
    leaves out the relabelling and the shuffle, so that each bit position
    keeps the initiator's quadrant frequencies (the tests read them)."""
    n = 1 << scale
    m = edgefactor * n
    ab = a + b
    c_norm = c / (1.0 - ab)
    a_norm = a / ab
    ij = torch.zeros((2, m), dtype=torch.int64, device=device)
    for bit in range(scale):
        r = torch.rand((2, m), generator=gen, device=device,
                       dtype=torch.float64)
        ii = r[0] > ab
        jj = r[1] > torch.where(ii, c_norm, a_norm)
        ij[0] += ii.to(torch.int64) << bit
        ij[1] += jj.to(torch.int64) << bit
    if permute:
        ij = torch.randperm(n, generator=gen, device=device)[ij]
        ij = ij[:, torch.randperm(m, generator=gen, device=device)]
    return ij[0], ij[1]


def generate(cfg: dict, seed: int, device):
    gen = torch.Generator(device=device).manual_seed(seed)
    src, dst = tuples(cfg["scale"], cfg["edgefactor"], cfg["a"],
                      cfg["b"], cfg["c"], gen, device)
    return src, dst, 1 << cfg["scale"]
