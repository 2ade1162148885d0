"""Random geometric graph, the family of DIMACS10's ``rgg_n_2_*_s0``.

``n`` points uniform in the unit square and an undirected edge between
every pair closer than ``radius_coef * sqrt(ln n / n)``.  Vertex ids are
the points' draw order (no spatial sort).  The pairs are found on the
device through a grid of cells no narrower than the radius: each point
is held against the points of its own and the eight neighbouring cells.
"""
from __future__ import annotations

import math

import torch


def radius(n: int, coef: float) -> float:
    return coef * math.sqrt(math.log(n) / n)


def pairs(pts: torch.Tensor, r: float):
    """(src, dst) int64 with src < dst for every pair of rows of ``pts``
    ((n, 2) float64) at a distance below ``r``, sorted by (src, dst)."""
    n = pts.shape[0]
    dev = pts.device
    side = max(1, int(1.0 / r))                 # cells per side, >= r wide
    cell = (pts * side).to(torch.int64).clamp_(0, side - 1)
    cid = cell[:, 0] * side + cell[:, 1]
    order = torch.argsort(cid, stable=True)
    counts = torch.bincount(cid, minlength=side * side)
    start = torch.cumsum(counts, 0) - counts
    width = int(counts.max())
    lane = torch.arange(width, device=dev)
    ids = torch.arange(n, device=dev)
    keys = []
    for dx in (-1, 0, 1):
        for dy in (-1, 0, 1):
            nx, ny = cell[:, 0] + dx, cell[:, 1] + dy
            inside = (nx >= 0) & (nx < side) & (ny >= 0) & (ny < side)
            ncid = nx.clamp(0, side - 1) * side + ny.clamp(0, side - 1)
            cnt = torch.where(inside, counts[ncid], 0)
            slot = (start[ncid][:, None] + lane).clamp_(max=n - 1)
            j = order[slot]                                   # (n, width)
            d = pts[j] - pts[:, None, :]
            d2 = d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]
            keep = (lane < cnt[:, None]) & (ids[:, None] < j) & (d2 < r * r)
            i = ids[:, None].expand(n, width)
            keys.append(i[keep] * n + j[keep])
    key = torch.sort(torch.cat(keys)).values
    return key // n, key % n


def generate(cfg: dict, seed: int, device):
    n = cfg["n"]
    gen = torch.Generator(device=device).manual_seed(seed)
    pts = torch.rand((n, 2), generator=gen, device=device,
                     dtype=torch.float64)
    src, dst = pairs(pts, radius(n, cfg["radius_coef"]))
    return src, dst, n
