"""Landmark selection for the distance-oracle serving tier (the port of
``repro/graph/landmarks.py``).

A landmark set is the offline half of a triangle-inequality distance
oracle (``serve/oracle.py``): the serving tier computes one BFS distance
row per landmark with the batched APSP engine and answers point-to-point
queries from the ``(n_landmarks, n)`` tables in O(|landmarks|).

The default ``mixed`` strategy seeds the set with the top ``k // 2``
hubs by total degree and fills the rest by greedy farthest-point
(2-approximate k-center; unreached vertices count as infinitely far, so
new components are covered first).

The selection runs on host numpy after one ``.cpu()`` of the degrees and
of each BFS row: ``np.argsort(kind="stable")`` and ``np.argmax`` break
ties on the lowest vertex id, as the JAX package does, while
``torch.argsort`` is stable only on request and ``torch.argmax`` on
CUDA gives no guarantee on ties.  Any other landmark set changes the
oracle's ``labels_checksum``.  The distance rows the greedy needs are
injected through ``dist_fn``, so this module stays engine-agnostic.
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np

from .csr import CSRGraph

STRATEGIES = ("degree", "farthest", "mixed")


def _host(x) -> np.ndarray:
    return x.cpu().numpy() if hasattr(x, "cpu") else np.asarray(x)


def degree_landmarks(g: CSRGraph, k: int) -> np.ndarray:
    """Top-k vertices by total (out + in) degree, ties on vertex id."""
    deg = _host(g.out_degrees() + g.in_degrees())
    # stable sort on (-degree, id): argsort of -deg is id-stable
    order = np.argsort(-deg, kind="stable")
    return order[:k].astype(np.int32)


def farthest_point_fill(g: CSRGraph, chosen: np.ndarray, k: int,
                        dist_fn: Callable[[int], np.ndarray]) -> np.ndarray:
    """Grow ``chosen`` to ``k`` landmarks by greedy farthest-point.

    ``dist_fn(v)`` returns the (n,) int32 BFS row from ``v`` (-1 =
    unreachable; numpy or a tensor).  Starts from the highest-degree
    vertex when ``chosen`` is empty."""
    n = g.n_nodes
    chosen = list(np.asarray(chosen, np.int64))
    if not chosen:
        chosen.append(int(degree_landmarks(g, 1)[0]))
    mindist = np.full(n, np.inf)
    for c in chosen:
        row = np.asarray(_host(dist_fn(int(c))), np.float64)
        row[row < 0] = np.inf
        np.minimum(mindist, row, out=mindist)
    taken = np.zeros(n, bool)
    taken[np.asarray(chosen, np.int64)] = True
    while len(chosen) < min(k, n):
        cand = np.where(taken, -np.inf, mindist)
        # argmax breaks ties on the lowest vertex id (deterministic)
        v = int(np.argmax(cand))
        chosen.append(v)
        taken[v] = True
        row = np.asarray(_host(dist_fn(v)), np.float64)
        row[row < 0] = np.inf
        np.minimum(mindist, row, out=mindist)
    return np.asarray(chosen, np.int32)


def select_landmarks(g: CSRGraph, k: int, *, strategy: str = "mixed",
                     dist_fn: Optional[Callable[[int], np.ndarray]] = None
                     ) -> np.ndarray:
    """Pick ``min(k, n)`` landmark vertex ids (sorted, unique, int32).

    ``dist_fn`` (BFS row provider) is required for the ``farthest`` and
    ``mixed`` strategies; ``degree`` needs none."""
    if strategy not in STRATEGIES:
        raise ValueError(f"unknown landmark strategy {strategy!r}; "
                         f"available: {STRATEGIES}")
    k = min(k, g.n_nodes)
    if k <= 0:
        return np.zeros(0, np.int32)
    if strategy == "degree":
        marks = degree_landmarks(g, k)
    else:
        if dist_fn is None:
            raise ValueError(f"strategy {strategy!r} needs dist_fn= "
                             f"(a BFS-row provider)")
        seed = degree_landmarks(g, k // 2) if strategy == "mixed" else \
            np.zeros(0, np.int32)
        marks = farthest_point_fill(g, seed, k, dist_fn)
    return np.sort(np.unique(marks)).astype(np.int32)
