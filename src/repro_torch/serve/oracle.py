"""Landmark distance oracle: O(|landmarks|) point-to-point answers with
an exactness certificate, backed by label tables the batched APSP engine
builds offline (the port of ``repro/serve/oracle.py``).

  * **offline** — :func:`build_landmark_labels` selects landmarks
    (``graph/landmarks.py``) and computes one BFS row per landmark with
    :func:`repro_torch.core.engine.apsp_engine` on the prepared graph's
    device.  Directed graphs get a second table from the reversed graph;
    symmetric graphs share one.  The tables come to the host once, as
    int32 ``(L, n)`` arrays, and live on the :class:`PreparedGraph`, so
    every oracle over the same prepared graph reuses one build.

  * **online** — for a query (s, t) the triangle inequality gives, per
    landmark L with forward rows F[L, v] = d(L, v) and reverse rows
    R[L, v] = d(v, L):

        upper:  d(s,t) <= R[L, s] + F[L, t]            (route via L)
        lower:  d(s,t) >= F[L, t] - F[L, s]            (F[L, s] finite)
        lower:  d(s,t) >= R[L, s] - R[L, t]            (R[L, t] finite)

    The answer is **certified exact** when s or t is a landmark (its BFS
    row is the answer) or when upper == lower; +inf bounds certify
    unreachability.  Everything else is a miss the serving tier answers
    with an exact batched sweep, so oracle answers are bit-identical to
    the engine by construction.

All online math is host numpy over the (L, n) tables, as in the JAX
package: queries are O(L), full-row bounds O(L * n).
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple, Union

import numpy as np
import torch

from ..core.engine import (EngineConfig, PreparedGraph, apsp_engine,
                           prepare_graph)
from ..graph.csr import CSRGraph
from ..graph.landmarks import STRATEGIES, select_landmarks

_INF = np.inf


def _is_symmetric(g: CSRGraph) -> bool:
    """Edge-set symmetry: for a symmetric graph the CSC arrays equal the
    CSR arrays (same lexsorted layout), so the reverse label table would
    be identical and need not be built.  Compared on the graph's
    device."""
    return bool(torch.equal(g.indptr, g.indptr_t)
                and torch.equal(g.indices, g.indices_t))


def _label_config(n_landmarks: int,
                  config: Optional[EngineConfig]) -> EngineConfig:
    if config is not None:
        return config
    batch = max(8, ((n_landmarks + 7) // 8) * 8)
    if batch > 128:
        batch = ((batch + 127) // 128) * 128
    return EngineConfig(source_batch=min(batch, 128))


def build_landmark_labels(pg: PreparedGraph, *, n_landmarks: int = 16,
                          strategy: str = "mixed",
                          config: Optional[EngineConfig] = None
                          ) -> np.ndarray:
    """Select landmarks and attach the host (L, n) int32 label tables to
    ``pg``.  Idempotent per (n_landmarks, strategy): a matching
    ``landmark_key`` reuses the cached tables, anything else rebuilds.
    Returns the landmark id array."""
    key = (int(n_landmarks), strategy)
    if pg.landmark_key == key and pg.landmark_dist is not None:
        return pg.landmarks
    if strategy not in STRATEGIES:
        raise ValueError(f"unknown landmark strategy {strategy!r}; "
                         f"available: {STRATEGIES}")
    if n_landmarks < 1:
        raise ValueError(f"n_landmarks must be >= 1, got {n_landmarks}")
    cfg = _label_config(n_landmarks, config)

    def bfs_row(v: int) -> np.ndarray:
        return apsp_engine(pg, np.asarray([v], np.int32),
                           config=cfg).dist[0].cpu().numpy()

    marks = select_landmarks(pg.graph, n_landmarks, strategy=strategy,
                             dist_fn=bfs_row)
    fwd = apsp_engine(pg, marks, config=cfg).dist.cpu().numpy()
    if _is_symmetric(pg.graph):
        rev = fwd
    else:
        rev_pg = prepare_graph(pg.graph.reverse(), device=pg.device)
        rev = apsp_engine(rev_pg, marks, config=cfg).dist.cpu().numpy()
    pg.landmarks = marks
    pg.landmark_dist = fwd
    pg.landmark_dist_rev = rev
    pg.landmark_key = key
    return marks


def select_top_k(dist_row: np.ndarray, source: int, k: int
                 ) -> List[Tuple[int, int]]:
    """Deterministic top-k-nearest from an exact distance row: reachable
    targets (excluding the source itself) sorted by (distance, vertex
    id), first ``k``.  The oracle's certified top-k answer and the exact
    sweep fallback both use this rule, so they are bit-identical."""
    dist = np.asarray(dist_row)
    nodes = np.arange(len(dist))
    mask = (dist >= 0) & np.isfinite(dist.astype(np.float64)) & \
        (nodes != source)
    nodes = nodes[mask]
    d = dist[mask]
    order = np.lexsort((nodes, d))[:k]
    return [(int(nodes[i]), int(d[i])) for i in order]


@dataclasses.dataclass
class OracleAnswer:
    """One point-to-point oracle result.  ``exact`` means the bounds (or
    a landmark hit) *prove* ``hops``; uncertified answers carry only the
    bound interval, ``hops`` is None and the caller must fall back."""
    source: int
    target: int
    lower: float              # sound lower bound (may be +inf: proof of
    upper: float              # unreachability); upper may be +inf too
    exact: bool
    hops: Optional[int] = None        # set iff exact; -1 = unreachable
    certificate: str = ""     # "trivial" | "landmark-source" |
    #                           "landmark-target" | "bounds" | ""


class DistanceOracle:
    """Query-time wrapper over the landmark label tables.

    Construct from a :class:`CSRGraph` (prepared on the device it lies
    on, as ``apsp_engine`` does) or an already-shared
    :class:`PreparedGraph`; the label build goes through
    :func:`build_landmark_labels` (cached on the prepared graph)."""

    def __init__(self, g: Union[CSRGraph, PreparedGraph], *,
                 n_landmarks: int = 16, strategy: str = "mixed",
                 config: Optional[EngineConfig] = None):
        pg = g if isinstance(g, PreparedGraph) else \
            prepare_graph(g, device=g.device)
        self.prepared = pg
        build_landmark_labels(pg, n_landmarks=n_landmarks,
                              strategy=strategy, config=config)
        self.landmarks: np.ndarray = pg.landmarks
        self._pos = {int(v): i for i, v in enumerate(self.landmarks)}
        # float views with +inf for unreachable: the bound arithmetic's
        # native encoding (int -1 sentinels do not min/max soundly)
        self._F = np.where(pg.landmark_dist < 0, _INF,
                           pg.landmark_dist.astype(np.float64))
        self._R = self._F if pg.landmark_dist_rev is pg.landmark_dist \
            else np.where(pg.landmark_dist_rev < 0, _INF,
                          pg.landmark_dist_rev.astype(np.float64))
        # per-landmark forward eccentricity over reachable targets: feeds
        # the serving tier's predicted-sweep-count buckets
        finite = np.where(np.isfinite(self._F), self._F, 0.0)
        self._ecc_fwd = finite.max(axis=1)
        self.n_queries = 0
        self.n_certified = 0

    @property
    def n_landmarks(self) -> int:
        return len(self.landmarks)

    def landmark_row(self, source: int) -> Optional[np.ndarray]:
        """The exact (n,) int32 forward row when ``source`` is a
        landmark (its BFS row is the label), else None."""
        i = self._pos.get(int(source))
        if i is None:
            return None
        return self.prepared.landmark_dist[i]

    # -- point-to-point ----------------------------------------------------

    def query(self, source: int, target: int) -> OracleAnswer:
        """O(L) bounds + certificate for one (source, target) pair."""
        self.n_queries += 1
        s, t = int(source), int(target)
        if s == t:
            self.n_certified += 1
            return OracleAnswer(s, t, 0.0, 0.0, True, hops=0,
                                certificate="trivial")
        i = self._pos.get(s)
        if i is not None:
            d = float(self._F[i, t])
            self.n_certified += 1
            return OracleAnswer(s, t, d, d, True,
                                hops=-1 if np.isinf(d) else int(d),
                                certificate="landmark-source")
        j = self._pos.get(t)
        if j is not None:
            d = float(self._R[j, s])
            self.n_certified += 1
            return OracleAnswer(s, t, d, d, True,
                                hops=-1 if np.isinf(d) else int(d),
                                certificate="landmark-target")
        Fs, Ft = self._F[:, s], self._F[:, t]
        Rs, Rt = self._R[:, s], self._R[:, t]
        upper = float(np.min(Rs + Ft, initial=_INF))
        with np.errstate(invalid="ignore"):   # inf-inf in masked branches
            lb_f = np.where(np.isfinite(Fs), Ft - Fs, -_INF)
            lb_r = np.where(np.isfinite(Rt), Rs - Rt, -_INF)
        lower = max(float(np.max(lb_f, initial=1.0)),
                    float(np.max(lb_r, initial=1.0)), 1.0)
        if upper == lower:
            self.n_certified += 1
            return OracleAnswer(s, t, lower, upper, True,
                                hops=-1 if np.isinf(upper) else int(upper),
                                certificate="bounds")
        return OracleAnswer(s, t, lower, upper, False)

    # -- full-row bounds / top-k ------------------------------------------

    def bounds(self, source: int) -> Tuple[np.ndarray, np.ndarray]:
        """(lower, upper) float64 rows over ALL targets — O(L * n)."""
        s = int(source)
        i = self._pos.get(s)
        if i is not None:
            row = self._F[i]
            return row.copy(), row.copy()
        Fs = self._F[:, s][:, None]
        Rs = self._R[:, s][:, None]
        upper = np.min(Rs + self._F, axis=0, initial=_INF)
        with np.errstate(invalid="ignore"):   # inf-inf in masked branches
            lb_f = np.max(np.where(np.isfinite(Fs), self._F - Fs, -_INF),
                          axis=0, initial=1.0)
            lb_r = np.max(np.where(np.isfinite(self._R), Rs - self._R,
                                   -_INF), axis=0, initial=1.0)
        lower = np.maximum(np.maximum(lb_f, lb_r), 1.0)
        lower[s] = 0.0
        upper[s] = 0.0
        return lower, upper

    def top_k(self, source: int, k: int
              ) -> Optional[List[Tuple[int, int]]]:
        """Certified top-k-nearest, or None when the bounds cannot prove
        the full answer: the k (distance, id)-smallest certified-reachable
        targets, certified only if every uncertified target's lower bound
        is strictly larger than the k-th selected distance."""
        self.n_queries += 1
        lower, upper = self.bounds(source)
        s = int(source)
        nodes = np.arange(len(lower))
        certified = (lower == upper) & (nodes != s)
        reach = certified & np.isfinite(upper)
        cand_nodes = nodes[reach]
        cand_d = upper[reach]
        order = np.lexsort((cand_nodes, cand_d))[:k]
        sel = [(int(cand_nodes[i]), int(cand_d[i])) for i in order]
        d_k = sel[-1][1] if len(sel) == k else _INF
        uncert = ~certified & (nodes != s)
        if np.any(lower[uncert] <= d_k):
            return None
        self.n_certified += 1
        return sel

    # -- serving-tier helpers ---------------------------------------------

    def predicted_sweeps(self, source: int) -> int:
        """Upper estimate of the sweep count a fresh BFS from ``source``
        would run: ecc(s) <= min_L d(s, L) + ecc_fwd(L); n when s reaches
        no landmark.  Drives the serving tier's buckets — an estimate
        only, never correctness-relevant."""
        s = int(source)
        i = self._pos.get(s)
        if i is not None:
            return int(self._ecc_fwd[i])
        bound = float(np.min(self._R[:, s] + self._ecc_fwd, initial=_INF))
        if np.isinf(bound):
            return self.prepared.graph.n_nodes
        return int(bound)

    def labels_checksum(self) -> int:
        """Deterministic fingerprint of (landmarks, tables): any drift
        means selection or the label build did different work."""
        return int(self.landmarks.astype(np.int64).sum()
                   + np.int64(7) * self.prepared.landmark_dist.astype(
                       np.int64).sum()
                   + np.int64(13) * self.prepared.landmark_dist_rev.astype(
                       np.int64).sum())
