"""Batched graph-query serving: tiered admission + bucketed micro-batching
(the port of ``repro/serve/engine.py``).

A :class:`GraphService` answers :class:`GraphQuery` requests through a
three-level serving tier —

  1. **row cache** — an LRU of distance rows earlier sweeps already
     computed: repeated queries from a hot source cost one O(n) lookup;
  2. **landmark oracle** (``serve/oracle.py``) — O(|landmarks|)
     triangle-inequality bounds with an exactness certificate; only
     *certified* answers are served (bit-identical to a sweep);
  3. **exact sweep fallback** — uncertified misses are bucketed by
     predicted sweep count and micro-batched into one multi-source engine
     run on the device per flush (``core/engine.py``,
     ``core/weighted.py``, ``core/centrality.py``), with per-query
     deadlines driving a deadline-aware flush policy (``tick``).

Each flush's rows come to the host with one device-to-host copy per
engine run, never one per query: the answers, the row cache and the
oracle's label tables are host numpy, as in the JAX package.

Over a :class:`repro_torch.graph.dynamic.DynamicCSRGraph` every entry
point (``submit`` / ``flush`` / ``tick``) first compares the graph's
content ``epoch`` with the epoch the operands were prepared at; on a
mismatch the operands are rebuilt from the merged view and every derived
cache (row cache, betweenness vector, landmark label tables) is dropped,
so no admission can read a stale cache (the sharded operands are
dropped with them).

With ``mesh=``, flushes of at least ``sharded_threshold`` queries run
through the sharded executor (``core/distributed.py``); every rank of
the mesh drives its own service with the same queries (the executor's
SPMD contract).
"""
from __future__ import annotations

import dataclasses
import math
import time
from collections import OrderedDict, deque
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from ..core.centrality import (MEASURES, CentralityConfig, betweenness,
                               centrality)
from ..core.distributed import (ShardedConfig, ShardedOperands,
                                prepare_sharded, sharded_apsp)
from ..core.engine import (EngineConfig, PreparedGraph, apsp_engine_blocks,
                           prepare_graph)
from ..core.weighted import (PreparedWeightedGraph, WeightedConfig,
                             prepare_weighted, weighted_apsp)
from ..graph.csr import resolve_device, same_device
from ..launch.mesh import MODEL_AXIS, check_mesh_device, mesh_extent
from .oracle import DistanceOracle, select_top_k


@dataclasses.dataclass
class GraphQuery:
    """A ``shortest_path`` request served by the batching loop.

    ``target=None`` returns the full distance row from ``source`` in
    ``dist`` (numpy int32 hops, -1 unreachable); otherwise ``hops`` is the
    shortest unweighted path length (-1 when unreachable).
    ``weighted=True`` routes through the tropical engine: ``dist`` is
    float32 (+inf unreachable) and a target query fills ``cost``.

    ``analytics`` turns the query into a centrality request: a tuple of
    names from :data:`repro_torch.core.centrality.MEASURES`.  The
    per-source measures of a flush batch into one multi-source run;
    betweenness is computed once per service, cached and answered from
    the cache.  Results land in ``analytics_result``.

    ``k_nearest=k`` fills ``nearest`` with the k nearest reachable
    (node, hops) pairs sorted by (distance, node id).

    ``deadline`` is a latency budget in seconds from submit; a query
    whose deadline passed when its batch forms is surfaced as
    ``expired=True`` (``served_by="expired"``, no result).

    ``served_by`` records the tier ("cache" / "oracle" / "sweep" /
    "sharded" / "expired"); ``certified`` is True when the answer was
    proven exact without a sweep.
    """
    qid: int
    source: int
    target: Optional[int] = None
    weighted: bool = False
    analytics: Optional[tuple] = None
    k_nearest: Optional[int] = None
    deadline: Optional[float] = None
    dist: Optional[np.ndarray] = None
    hops: Optional[int] = None
    cost: Optional[float] = None
    analytics_result: Optional[Dict[str, float]] = None
    nearest: Optional[List[Tuple[int, int]]] = None
    certified: bool = False
    served_by: Optional[str] = None
    expired: bool = False
    t_submit: float = 0.0
    t_done: float = 0.0
    t_deadline: float = math.inf
    _seq: int = dataclasses.field(default=0, repr=False)


class GraphService:
    """Tiered serving of shortest-path queries over one prepared graph.

    **Admission (at submit):** queries answerable exactly without a sweep
    complete at once — from the LRU **row cache** (``row_cache_size``
    rows per kind) or, with ``n_landmarks > 0``, from the **landmark
    oracle** when its bounds certify the answer.

    **Bucketed batching (the fallback):** uncertified misses queue in
    FIFO buckets keyed by (query kind, predicted-sweep-count bin).
    :meth:`flush` drains up to ``max_batch`` queries in global FIFO
    order; :meth:`tick` serves one ripe bucket: full, or its earliest
    deadline minus ``deadline_safety`` x the EWMA flush time leaves no
    headroom, or its head has waited ``max_wait``.

    Each flush runs at most one boolean, one tropical and one centrality
    micro-batch on ``device`` (``None``: the card, as ``prepare`` does);
    a dynamic graph must lie on that device.  Completed queries land in
    ``completed`` (the most recent ``completed_retention``); consume them
    with :meth:`drain_completed`.  ``clock`` injects the time source.

    Pass ``mesh`` (on the service's device) to scale flushes past one
    device: micro-batches of at least ``sharded_threshold`` queries run
    through the sharded executor (``sharded_config`` /
    ``sharded_weighted_config``, dense by default), bit-identical to the
    single-device engines; smaller flushes stay on the single-device
    path.  The whole-graph betweenness runs on the mesh too when the graph
    has at least ``sharded_threshold`` nodes.
    """

    def __init__(self, graph, *,
                 config: Optional[EngineConfig] = None,
                 weights=None,
                 weighted_config: Optional[WeightedConfig] = None,
                 max_batch: int = 32,
                 mesh=None,
                 sharded_threshold: int = 16,
                 sharded_config: Optional[ShardedConfig] = None,
                 sharded_weighted_config: Optional[ShardedConfig] = None,
                 centrality_config: Optional[CentralityConfig] = None,
                 n_landmarks: int = 0,
                 landmark_strategy: str = "mixed",
                 oracle: Optional[DistanceOracle] = None,
                 row_cache_size: int = 128,
                 completed_retention: Optional[int] = 4096,
                 max_wait: Optional[float] = None,
                 deadline_safety: float = 2.0,
                 clock: Callable[[], float] = time.monotonic,
                 device=None):
        batch = max(8, ((max_batch + 7) // 8) * 8)
        if batch > 128:  # EngineConfig: above one push tile, multiple of 128
            batch = ((batch + 127) // 128) * 128
        self.config = config or EngineConfig(source_batch=batch)
        # per-flush latency cap: honored even with an explicit config (the
        # source tile stays config.source_batch wide; short flushes pad)
        self.max_batch = min(max_batch, self.config.source_batch)
        if hasattr(graph, "view") and weights is not None:
            raise ValueError(
                "weights= with a DynamicCSRGraph is ambiguous — a static "
                "weight array cannot track mutations; build the dynamic "
                "graph with weights instead")
        self.device = resolve_device(device)
        if hasattr(graph, "view") and not same_device(graph.device,
                                                      self.device):
            raise ValueError(
                f"the DynamicCSRGraph lies on {graph.device}, the service "
                f"on {self.device}: build it from a graph on the service's "
                f"device")
        if mesh is not None:
            check_mesh_device(mesh, self.device)
        self.graph_source = graph
        self._base_weights = weights
        self._sharded_ops: Dict[str, ShardedOperands] = {}
        self._build_operands()
        self.weighted_config = weighted_config or \
            WeightedConfig(source_batch=min(self.config.source_batch, 128),
                           use_kernel=self.config.use_kernel)
        self.mesh = mesh
        self.sharded_threshold = max(1, sharded_threshold)
        self.sharded_flushes = 0
        self._sharded_cfg = {
            "boolean": sharded_config or
            ShardedConfig(semiring="boolean", mode="dense",
                          use_kernel=self.config.use_kernel),
            "tropical": sharded_weighted_config or
            ShardedConfig(semiring="tropical", mode="dense",
                          use_kernel=self.config.use_kernel),
        }
        self.centrality_config = centrality_config or CentralityConfig(
            source_batch=min(self.config.source_batch, 128),
            use_kernel=self.config.use_kernel)
        # betweenness is a whole-graph analytic: computed once (on the
        # mesh when there is one), then served from this cache
        self._betweenness: Optional[np.ndarray] = None
        # --- serving tier ----------------------------------------------
        self._clock = clock
        # the oracle is (re)built lazily by the `oracle` property, so an
        # epoch invalidation drops it without paying the label sweeps
        # until the next query that would consult it
        self._landmark_strategy = landmark_strategy
        if oracle is not None:
            self._oracle: Optional[DistanceOracle] = oracle
            self._oracle_n_landmarks = oracle.n_landmarks
        else:
            self._oracle = None
            self._oracle_n_landmarks = n_landmarks
        # LRU of exact host distance rows keyed (kind, source)
        self.row_cache_size = max(0, row_cache_size)
        self._row_cache: "OrderedDict[Tuple[str, int], np.ndarray]" = \
            OrderedDict()
        # FIFO buckets keyed (kind, predicted-sweep bin); _seq preserves
        # global submit order for the flush() drain
        self.buckets: "OrderedDict[Tuple[str, int], deque]" = OrderedDict()
        self._seq = 0
        self.max_wait = max_wait
        self.deadline_safety = deadline_safety
        self._flush_est = 0.02   # EWMA of sweep-flush seconds
        self.completed_retention = completed_retention
        self.completed: List[GraphQuery] = []
        # serving counters (totals since construction)
        self.cache_hits = 0
        self.oracle_hits = 0
        self.sweep_served = 0
        self.expired_count = 0
        self.n_submitted = 0
        self.n_completed_total = 0
        self.epoch_invalidations = 0

    # -- epoch freshness ---------------------------------------------------

    def _build_operands(self) -> None:
        """(Re)prepare the engine operands on the device from the current
        graph content (a dynamic graph prepares its merged view; a
        weighted one brings its own lane weights)."""
        g = self.graph_source
        self.prepared: Optional[PreparedGraph] = None   # drop stale first
        self.prepared_weighted: Optional[PreparedWeightedGraph] = None
        self._sharded_ops.clear()
        self.prepared = prepare_graph(g, device=self.device)
        if self._base_weights is not None or getattr(g, "weighted", False):
            self.prepared_weighted = prepare_weighted(
                g, self._base_weights, device=self.device)

    @property
    def oracle(self) -> Optional[DistanceOracle]:
        """Landmark oracle for the *current* epoch, built on demand."""
        if self._oracle is None and self._oracle_n_landmarks > 0:
            self._oracle = DistanceOracle(
                self.prepared, n_landmarks=self._oracle_n_landmarks,
                strategy=self._landmark_strategy, config=self.config)
        return self._oracle

    def _ensure_fresh(self) -> None:
        """Invalidate every cached artifact when the graph has mutated:
        re-prepare the operands (the sharded ones too), clear the row
        cache and the betweenness vector, and drop the oracle (its label
        tables rebuild lazily on next touch).  A no-op for static graphs
        (always epoch 0)."""
        if int(getattr(self.graph_source, "epoch", 0)) == \
                self.prepared.epoch:
            return
        self._build_operands()
        self._row_cache.clear()
        self._betweenness = None
        self._oracle = None
        self.epoch_invalidations += 1

    def _sharded_operands(self, semiring: str) -> ShardedOperands:
        """This rank's per-semiring operands, built once and reused by
        every sharded flush.  On a mesh without vertex sharding the padded
        size is the single-device one, so the prepared dense operand is
        handed over instead of a second copy."""
        if semiring not in self._sharded_ops:
            cfg = self._sharded_cfg[semiring]
            dense_op = None
            if cfg.need_dense and mesh_extent(self.mesh, MODEL_AXIS) == 1:
                dense_op = self.prepared_weighted if semiring == "tropical" \
                    else self.prepared
            self._sharded_ops[semiring] = prepare_sharded(
                self.prepared.graph, self.mesh,
                weights=self.prepared_weighted.w_edges
                if semiring == "tropical" else None,
                config=cfg, dense_op=dense_op)
        return self._sharded_ops[semiring]

    def _route_sharded(self, n_queries: int) -> bool:
        return self.mesh is not None and \
            n_queries >= self.sharded_threshold

    # -- admission ---------------------------------------------------------

    def submit(self, query: GraphQuery):
        """Validate, then answer from the cache/oracle tier or enqueue."""
        self._ensure_fresh()
        n = self.prepared.graph.n_nodes
        if not 0 <= query.source < n:
            raise ValueError(f"source {query.source} not in [0, {n})")
        if query.target is not None and not 0 <= query.target < n:
            raise ValueError(f"target {query.target} not in [0, {n})")
        if query.analytics is not None:
            if query.weighted:
                raise ValueError("analytics queries are unweighted "
                                 "(counting/boolean semiring)")
            unknown = set(query.analytics) - set(MEASURES)
            if unknown:
                raise ValueError(f"unknown analytics {sorted(unknown)}; "
                                 f"available: {MEASURES}")
        if query.k_nearest is not None:
            if query.k_nearest < 1:
                raise ValueError(f"k_nearest must be >= 1, "
                                 f"got {query.k_nearest}")
            if query.target is not None or query.analytics is not None \
                    or query.weighted:
                raise ValueError("k_nearest queries are unweighted and "
                                 "exclusive of target=/analytics=")
        if query.weighted and self.prepared_weighted is None:
            raise ValueError(
                "weighted query on a GraphService built without weights=")
        now = self._clock()
        query.t_submit = now
        query.t_deadline = now + query.deadline \
            if query.deadline is not None else math.inf
        query._seq = self._seq
        self._seq += 1
        self.n_submitted += 1
        if self._try_serve_cached(query, now):
            return
        self.buckets.setdefault(self._bucket_key(query),
                                deque()).append(query)

    def _try_serve_cached(self, q: GraphQuery, now: float) -> bool:
        """Row-cache then landmark-oracle admission; True == completed."""
        if q.analytics is not None:
            return False
        kind = "weighted" if q.weighted else "unweighted"
        row = self._row_cache.get((kind, q.source))
        if row is not None:
            self._row_cache.move_to_end((kind, q.source))
            self._fill_from_row(q, row)
            self.cache_hits += 1
            q.certified = True
            self._complete(q, "cache", now)
            return True
        if self.oracle is None or q.weighted:
            return False
        if q.target is not None:
            ans = self.oracle.query(q.source, q.target)
            if not ans.exact:
                return False
            q.hops = ans.hops
        elif q.k_nearest is not None:
            nearest = self.oracle.top_k(q.source, q.k_nearest)
            if nearest is None:
                return False
            q.nearest = nearest
        else:
            lrow = self.oracle.landmark_row(q.source)
            if lrow is None:
                return False
            q.dist = np.array(lrow)
        self.oracle_hits += 1
        q.certified = True
        self._complete(q, "oracle", now)
        return True

    def _fill_from_row(self, q: GraphQuery, row: np.ndarray) -> None:
        """Answer any non-analytics query kind from an exact host row."""
        if q.target is not None:
            if q.weighted:
                q.cost = float(row[q.target])
            else:
                q.hops = int(row[q.target])
        elif q.k_nearest is not None:
            q.nearest = select_top_k(row, q.source, q.k_nearest)
        else:
            q.dist = np.array(row)

    def _cache_row(self, kind: str, source: int, row: np.ndarray) -> None:
        if self.row_cache_size <= 0:
            return
        self._row_cache[(kind, int(source))] = np.asarray(row)
        self._row_cache.move_to_end((kind, int(source)))
        while len(self._row_cache) > self.row_cache_size:
            self._row_cache.popitem(last=False)

    def _bucket_key(self, q: GraphQuery) -> Tuple[str, int]:
        """(kind, predicted-sweep bin): queries expected to converge in a
        similar sweep count batch together, so a deep-BFS straggler does
        not stretch the sweep loop of a shallow batch."""
        if q.analytics is not None:
            return ("analytics", 0)
        if q.weighted:
            return ("weighted", 0)
        bin_ = self.oracle.predicted_sweeps(q.source).bit_length() \
            if self.oracle is not None else 0
        return ("unweighted", bin_)

    def _complete(self, q: GraphQuery, served_by: str, now: float) -> None:
        q.served_by = served_by
        q.t_done = now
        self.completed.append(q)
        self.n_completed_total += 1
        if self.completed_retention is not None and \
                len(self.completed) > self.completed_retention:
            del self.completed[: len(self.completed)
                               - self.completed_retention]

    def drain_completed(self) -> List[GraphQuery]:
        """Return all retained completed queries and clear the buffer."""
        out = self.completed
        self.completed = []
        return out

    def pending(self) -> int:
        return sum(len(b) for b in self.buckets.values())

    # -- flush policy ------------------------------------------------------

    def flush(self) -> List[GraphQuery]:
        """Serve up to ``max_batch`` pending queries in global FIFO order
        regardless of buckets or deadlines; returns them."""
        self._ensure_fresh()
        batch = self._take_global(self.max_batch)
        return self._serve(batch)

    def tick(self) -> List[GraphQuery]:
        """Deadline-aware flush: serve ONE ripe bucket (FIFO within it),
        or nothing if no bucket is ripe.  Ripest = earliest deadline,
        then oldest."""
        self._ensure_fresh()
        now = self._clock()
        headroom = self.deadline_safety * self._flush_est
        best_key, best_rank = None, None
        for key, bucket in self.buckets.items():
            if not bucket:
                continue
            dl = min(q.t_deadline for q in bucket)
            ripe = (len(bucket) >= self.max_batch
                    or dl - now <= headroom
                    or (self.max_wait is not None
                        and now - bucket[0].t_submit >= self.max_wait))
            if not ripe:
                continue
            rank = (dl, bucket[0]._seq)
            if best_rank is None or rank < best_rank:
                best_key, best_rank = key, rank
        if best_key is None:
            return []
        bucket = self.buckets[best_key]
        batch = [bucket.popleft()
                 for _ in range(min(len(bucket), self.max_batch))]
        return self._serve(batch)

    def _take_global(self, limit: int) -> List[GraphQuery]:
        """Pop up to ``limit`` queries in global submit order (merge the
        per-bucket FIFOs by sequence number)."""
        batch: List[GraphQuery] = []
        while len(batch) < limit:
            best = None
            for key, bucket in self.buckets.items():
                if bucket and (best is None
                               or bucket[0]._seq < self.buckets[best][0]._seq):
                    best = key
            if best is None:
                break
            batch.append(self.buckets[best].popleft())
        return batch

    # -- batch execution ---------------------------------------------------

    def _serve(self, batch: List[GraphQuery]) -> List[GraphQuery]:
        if not batch:
            return []
        now = self._clock()
        live: List[GraphQuery] = []
        for q in batch:
            if q.t_deadline < now:
                # deadline already blown: surface, don't compute
                q.expired = True
                self.expired_count += 1
                self._complete(q, "expired", now)
            else:
                live.append(q)
        if not live:
            return batch
        # measured with the injected clock so the EWMA shares a time
        # scale with deadlines and ripeness under a virtual clock
        t0 = self._clock()
        analytics = [q for q in live if q.analytics is not None]
        unweighted = [q for q in live
                      if not q.weighted and q.analytics is None]
        weighted = [q for q in live if q.weighted]
        if unweighted:
            sources = np.asarray([q.source for q in unweighted], np.int32)
            if self._route_sharded(len(unweighted)):
                dist = sharded_apsp(self._sharded_operands("boolean"),
                                    sources).dist
                self.sharded_flushes += 1
                served_by = "sharded"
            else:
                (_, dist, _), = apsp_engine_blocks(self.prepared, sources,
                                                   config=self.config)
                served_by = "sweep"
            dist = dist.cpu().numpy()          # one copy per flush
            for row, q in zip(dist, unweighted):
                self._fill_from_row(q, row)
                self._cache_row("unweighted", q.source, row)
                q.served_by = served_by
        if weighted:
            sources = np.asarray([q.source for q in weighted], np.int32)
            if self._route_sharded(len(weighted)):
                res = sharded_apsp(self._sharded_operands("tropical"),
                                   sources)
                self.sharded_flushes += 1
                served_by = "sharded"
            else:
                res = weighted_apsp(self.prepared_weighted, sources=sources,
                                    config=self.weighted_config)
                served_by = "sweep"
            dist = res.dist.cpu().numpy()      # one copy per flush
            for row, q in zip(dist, weighted):
                self._fill_from_row(q, row)
                self._cache_row("weighted", q.source, row)
                q.served_by = served_by
        if analytics:
            self._flush_analytics(analytics)
            for q in analytics:
                q.served_by = "sweep"
        self.sweep_served += len(live)
        # EWMA of the cost of one sweep flush: feeds tick()'s headroom
        self._flush_est = 0.5 * self._flush_est + \
            0.5 * (self._clock() - t0)
        now = self._clock()
        for q in live:
            q.t_done = now
            self.completed.append(q)
            self.n_completed_total += 1
        if self.completed_retention is not None and \
                len(self.completed) > self.completed_retention:
            del self.completed[: len(self.completed)
                               - self.completed_retention]
        return batch

    def _flush_analytics(self, queries: List[GraphQuery]) -> None:
        """Serve one micro-batch of centrality queries: every per-source
        measure rides ONE batched multi-source run; betweenness comes
        from the per-service cache, built on first demand — through the
        sharded executor when the service has a mesh and the graph has at
        least ``sharded_threshold`` nodes."""
        per_source = set()
        want_bc = False
        for q in queries:
            for m in q.analytics:
                if m == "betweenness":
                    want_bc = True
                else:
                    per_source.add(m)
        results: Dict[int, Dict[str, float]] = {
            id(q): {} for q in queries}
        ps_queries = [q for q in queries
                      if set(q.analytics) - {"betweenness"}]
        if ps_queries:
            sources = np.asarray([q.source for q in ps_queries], np.int32)
            res = centrality(self.prepared, sources,
                             measures=tuple(sorted(per_source)),
                             config=self.centrality_config)
            if res.closeness is not None:
                for i, q in enumerate(ps_queries):
                    results[id(q)]["closeness"] = float(res.closeness[i])
            if res.harmonic is not None:
                for i, q in enumerate(ps_queries):
                    results[id(q)]["harmonic"] = float(res.harmonic[i])
            if res.eccentricity is not None:
                for i, q in enumerate(ps_queries):
                    results[id(q)]["eccentricity"] = \
                        int(res.eccentricity[i])
        if want_bc:
            if self._betweenness is None:
                on_mesh = self._route_sharded(self.prepared.graph.n_nodes)
                self._betweenness = betweenness(
                    self.prepared, config=self.centrality_config,
                    mesh=self.mesh if on_mesh else None)
                if on_mesh:
                    self.sharded_flushes += 1
            for q in queries:
                if "betweenness" in q.analytics:
                    results[id(q)]["betweenness"] = \
                        float(self._betweenness[q.source])
        for q in queries:
            q.analytics_result = {m: results[id(q)][m]
                                  for m in q.analytics}
