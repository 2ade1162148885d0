"""Incremental BFS/SSSP repair — resume the sweep from the affected
frontier instead of re-running from scratch.

The port of ``repro/core/incremental.py``.  An edge mutation whose
affected region is small should cost a correspondingly small resumed
sweep.  This module classifies a batch of edge updates against a stored
``(dist, parent)`` state and re-converges it through the one loop driver
(:func:`repro_torch.core.sweep.sweep_loop`) — no new loop, no new sweep
semantics.  The state and the classification live on the graph's device
as torch ops; only the mutation log stays on the host.

Classification (Yamane & Kobayashi, arXiv:1908.06806):

  * **Inserts can only lower distances.**  For each inserted (or
    weight-decreased) edge (u, v, w), in the order given, if
    ``d[u] + w < d[v]`` the head v improves immediately and seeds the
    resume frontier; otherwise the insert is provably inert.  A later
    insert reads the distances an earlier one lowered.
  * **Deletes taint the shortest-path subtree.**  v is tainted iff its
    parent edge was deleted or its parent chain passes through a tainted
    vertex.  Tainted distances reset to +inf (their parents to -1);
    untainted distances are still achievable (deletes never shorten
    paths), hence still optimal.  The closure over the parent forest is
    taken by pointer doubling: ``log2(depth)`` gathers, not one per level.

Seeding: the resume frontier F0 is the set of insert-improved heads plus
every *untainted* vertex with an out-edge into the tainted set (the taint
boundary).  If F0 is empty the tainted set is unreachable and +inf is
already correct (the resume is skipped — 0 sweeps).

The resume always runs the **tropical** sparse form (unit lane weights
for unweighted graphs): value-based (min,+) relaxation is the one sweep
algebra that is resumable from any partial state.  On the card that form
is the sparse relax kernel (K9), which reads the in-lane index of the
view's lanes.  Unit-weight f32 distances are integer-exact far past any
reachable hop count, so the repaired state is **bit-identical** to a
from-scratch boolean sweep (dist and the ``derive_parents`` max-id
tie-break both depend only on the dist fixpoint).  Weighted repair
requires strictly positive weights: a zero-weight cycle can make the
recorded parent forest cyclic, which breaks the subtree-taint argument.

Counting-semiring state (sigma) is NOT incrementally repaired — path
counts have no local taint bound.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Union

import numpy as np
import torch

from ..graph.csr import CSRGraph
from ..graph.dynamic import DynamicCSRGraph
from ..kernels import common as kernel_common
from ..kernels import registry as kernel_registry
from . import sweep as S
from .engine import EngineConfig, apsp_engine, prepare_graph
from .frontier import UNREACHED
from .weighted import WeightedConfig, prepare_weighted, weighted_apsp

__all__ = ["IncrementalState", "RepairResult", "IncrementalSSSP",
           "sssp_state", "repair"]

_INF = float("inf")


@dataclasses.dataclass
class IncrementalState:
    """Resumable multi-source shortest-path state.

    ``dist`` is stored in the tropical domain for both algebras:
    (S, n) float32 on the graph's device, +inf = unreached
    (integer-valued for unweighted graphs).  ``parent`` is the
    ``derive_parents`` forest ((S, n) int32, max-id tie-break, -1 =
    root/unreached) — the taint classifier walks it.
    """
    sources: np.ndarray          # (S,) int32
    dist: torch.Tensor           # (S, n) float32, +inf unreached
    parent: torch.Tensor         # (S, n) int32, -1 none
    weighted: bool
    epoch: int = 0               # graph epoch this state reflects

    def dist_int(self) -> torch.Tensor:
        """Boolean-engine view: (S, n) int32 hops, -1 unreachable."""
        return _hops(self.dist)


class RepairResult(NamedTuple):
    state: IncrementalState
    sweeps: int                  # productive resumed sweeps (0 if inert)
    tainted: int                 # vertices whose subtree a delete cut
    seeded: int                  # |F0| — resume frontier size
    rebuilt: bool                # True when repair fell back to scratch


def _hops(dist: torch.Tensor) -> torch.Tensor:
    finite = torch.isfinite(dist)
    return torch.where(finite, torch.where(finite, dist, 0.0)
                       .to(torch.int32), UNREACHED)


def _unwrap(graph, weights):
    """-> (CSRGraph view, lane weights or None, content epoch)."""
    if isinstance(graph, DynamicCSRGraph):
        return graph.view(), graph.view_weights(), graph.epoch
    return graph, weights, 0


def _lanes(w, view: CSRGraph) -> torch.Tensor:
    """Lane weights (numpy or a tensor) as float32 on the view's device."""
    if isinstance(w, torch.Tensor):
        return w.to(device=view.device, dtype=torch.float32)
    return torch.from_numpy(np.asarray(w, np.float32)).to(view.device)


def _unit_lanes(view: CSRGraph) -> torch.Tensor:
    """The (m_pad,) unit lane weights an unweighted repair relaxes over
    (+inf on the sentinel lanes)."""
    return torch.where(view.src < view.n_nodes, 1.0, _INF).to(torch.float32)


def _lane_index(view: CSRGraph,
                w_lanes: torch.Tensor) -> kernel_common.LaneIndex:
    """The in-lane index of a view's lanes, which K9 reads (built by the
    tropical kernel set's builder; the card only)."""
    return kernel_registry.get("tropical").lane_index(
        view.src, view.dst, w_lanes, view.n_padded(128))


def sssp_state(graph: Union[CSRGraph, DynamicCSRGraph], sources, *,
               weights=None, config=None):
    """From-scratch state build through the batched engines, on a graph
    prepared at the current epoch on the graph's device; returns
    ``(state, sweeps)`` so callers can compare repair-vs-scratch cost."""
    view, w, epoch = _unwrap(graph, weights)
    sources = np.asarray(sources, np.int32).ravel()
    if w is not None:
        cfg = config if isinstance(config, WeightedConfig) \
            else WeightedConfig()
        pw = prepare_weighted(graph, device=view.device) \
            if isinstance(graph, DynamicCSRGraph) \
            else prepare_weighted(view, w, device=view.device)
        res = weighted_apsp(pw, sources=sources, config=cfg)
        dist = res.dist
        parent = S.derive_parents(view, res.dist, weights=pw.w_edges)
    else:
        cfg = config if isinstance(config, EngineConfig) else EngineConfig()
        res = apsp_engine(prepare_graph(graph, device=view.device), sources,
                          config=cfg)
        dist = torch.where(res.dist == UNREACHED, _INF,
                           res.dist.to(torch.float32))
        parent = S.derive_parents(view, res.dist)
    state = IncrementalState(sources=sources, dist=dist,
                             parent=parent.to(torch.int32),
                             weighted=w is not None, epoch=epoch)
    return state, int(res.sweeps)


def _normalize_pairs(edges, n_cols):
    if edges is None:
        return tuple(np.zeros(0, np.int64) for _ in range(n_cols))
    out = tuple(np.asarray(e).ravel() for e in edges)
    assert len(out) == n_cols, \
        f"expected {n_cols} arrays, got {len(out)}"
    return out


def _taint(parent: torch.Tensor, del_src, del_dst) -> torch.Tensor:
    """(S, n) bool: the vertices whose recorded shortest path uses a
    deleted edge — the parent edge itself, or any edge up the parent
    chain.  The closure over the forest by pointer doubling: after k
    rounds ``tainted`` covers the ancestors less than 2^k up and ``anc``
    points 2^k up (a root points to itself), so once ``anc`` stops moving
    every ancestor has been seen."""
    s, n = parent.shape
    dev = parent.device
    tainted = torch.zeros((s, n), dtype=torch.bool, device=dev)
    if not del_src.size:
        return tainted
    dd = torch.from_numpy(del_dst.astype(np.int64)).to(dev)
    ds = torch.from_numpy(del_src.astype(np.int32)).to(dev)
    cut = torch.zeros((s, n), dtype=torch.int32, device=dev)
    cut.index_add_(1, dd, (parent[:, dd] == ds[None, :]).to(torch.int32))
    tainted = cut > 0
    if not bool(tainted.any()):
        return tainted
    anc = torch.where(parent >= 0, parent.long(),
                      torch.arange(n, device=dev)[None, :])
    for _ in range(n.bit_length() + 1):  # 2^k > n: every chain covered
        tainted = tainted | torch.gather(tainted, 1, anc)
        nxt = torch.gather(anc, 1, anc)
        if torch.equal(nxt, anc):
            break
        anc = nxt
    return tainted


def repair(graph: Union[CSRGraph, DynamicCSRGraph],
           state: IncrementalState, *,
           inserts=None, deletes=None, weights=None,
           max_steps: Optional[int] = None,
           index: Optional[kernel_common.LaneIndex] = None
           ) -> RepairResult:
    """Repair ``state`` against ``graph`` (which must already contain
    the mutations): taint delete subtrees, apply insert improvements,
    resume the sweep from the affected frontier.

    ``inserts`` is ``(src, dst)`` or ``(src, dst, w)`` (w required for
    weighted states — the *current* weight of each inserted/decreased
    edge); ``deletes`` is ``(src, dst)``.  ``index`` is the in-lane index
    of the graph's current view under the lane weights the repair relaxes
    (``IncrementalSSSP.lane_index()`` keeps one); on the card it is built
    here when not given, on the CPU it is not used.  The result is
    bit-identical to a from-scratch run on the mutated graph.
    """
    view, w, epoch = _unwrap(graph, weights)
    n = view.n_nodes
    n_src, n_cols = state.dist.shape
    assert n_cols == n, (n_cols, n)
    assert state.dist.device == view.device, (state.dist.device,
                                              view.device)
    dev = view.device

    if state.weighted:
        assert w is not None, "weighted state needs the mutated weights"
        ins_src, ins_dst, ins_w = _normalize_pairs(
            inserts, 3) if (inserts is not None and len(inserts) == 3) \
            else (*_normalize_pairs(inserts, 2), None)
        assert ins_w is not None or ins_src.size == 0, \
            "weighted repair needs (src, dst, w) inserts"
        if ins_w is None:
            ins_w = np.zeros(0, np.float32)
        ins_w = np.asarray(ins_w, np.float32)
        w_lanes = _lanes(w, view)
        live_w = w_lanes[view.src < n]
        assert live_w.numel() == 0 or bool(live_w.min() > 0), \
            "weighted repair requires strictly positive weights " \
            "(zero-weight cycles break the parent-subtree taint bound)"
    else:
        ins_src, ins_dst = _normalize_pairs(inserts, 2)[:2]
        ins_w = np.ones(ins_src.size, np.float32)
        w_lanes = _unit_lanes(view)
    del_src, del_dst = _normalize_pairs(deletes, 2)

    # -- delete classification: taint the cut shortest-path subtrees ----
    tainted = _taint(state.parent, del_src, del_dst)
    dist = torch.where(tainted, _INF, state.dist)
    parent = torch.where(tainted, UNREACHED, state.parent).to(torch.int32)
    n_tainted = int(tainted.sum())

    # -- insert classification: apply immediate improvements, in order --
    f0 = torch.zeros((n_src, n), dtype=torch.bool, device=dev)
    for u, v, wt in zip(ins_src, ins_dst, ins_w):
        u, v = int(u), int(v)
        cand = dist[:, u] + (float(wt) if state.weighted else 1.0)
        imp = cand < dist[:, v]
        dist[:, v] = torch.where(imp, cand, dist[:, v])
        parent[:, v] = torch.where(imp, u, parent[:, v])
        f0[:, v] |= imp

    # -- boundary seeds: untainted tails of edges into the tainted set --
    if n_tainted:
        live = view.src < n
        us, vs = view.src[live].long(), view.dst[live].long()
        t_t = tainted.t()                                  # (n, S)
        contrib = (~t_t[us]) & t_t[vs]                     # (m_live, S)
        seeds = torch.zeros((n, n_src), dtype=torch.int8, device=dev)
        seeds.index_reduce_(0, us, contrib.to(torch.int8), "amax")
        f0 |= seeds.t() != 0
        # (no ~tainted mask on f0: an insert-improved vertex inside the
        # tainted set holds a finite dist that must propagate; tainted
        # seeds still at +inf are inert in the relaxation anyway)

    n_seeded = int(f0.sum())
    new_epoch = epoch if isinstance(graph, DynamicCSRGraph) \
        else state.epoch

    def _parents(d):
        # parents re-derive from the dist fixpoint — same max-id
        # tie-break as scratch, so equal dist => bit-equal parents
        if state.weighted:
            return S.derive_parents(view, d, weights=w_lanes) \
                .to(torch.int32)
        return S.derive_parents(view, _hops(d)).to(torch.int32)

    if n_seeded == 0:
        # inert batch: non-improving inserts and/or a tainted region
        # with no untainted in-boundary (provably unreachable -> +inf).
        # Parents still re-derive when the edge set changed: an insert
        # that only TIES an existing distance adds a valid predecessor,
        # which can move the canonical (max-id) parent without moving
        # any distance.
        if ins_src.size or del_src.size:
            parent = _parents(dist)
        out = IncrementalState(sources=state.sources, dist=dist,
                               parent=parent, weighted=state.weighted,
                               epoch=new_epoch)
        return RepairResult(out, 0, n_tainted, 0, False)

    # -- resume through THE driver on the merged operand -----------------
    n_pad = view.n_padded(128)
    d0 = torch.full((n_src, n_pad), _INF, dtype=torch.float32, device=dev)
    d0[:, :n] = dist
    f0p = torch.zeros((n_src, n_pad), dtype=torch.int8, device=dev)
    f0p[:, :n] = f0.to(torch.int8)
    on_card = dev.type == "cuda"
    if on_card and index is None:
        index = _lane_index(view, w_lanes)
    _, sparse = S.tropical_forms(None, view.src, view.dst, w_lanes,
                                 use_kernel=on_card,
                                 rindex=index if on_card else None)
    st = S.sweep_loop((sparse, sparse), S.make_state(f0p, d0, n_forms=2),
                      max_steps=max_steps or n, forced_dir=1)
    newd = st.dist[:, :n].contiguous()

    out = IncrementalState(sources=state.sources, dist=newd,
                           parent=_parents(newd),
                           weighted=state.weighted, epoch=new_epoch)
    return RepairResult(out, int(st.sweeps), n_tainted, n_seeded, False)


class IncrementalSSSP:
    """Streaming repair driver bound to a :class:`DynamicCSRGraph`.

    Holds the resumable state for a fixed source set and pulls the
    graph's journalled net deltas on :meth:`update` — repairing
    incrementally when the journal reaches back to the last sync and
    rebuilding from scratch when it doesn't.  ``scratch_sweeps`` /
    ``repair_sweeps`` accumulate the cost of each path for
    repair-vs-scratch accounting.

    On the card it also keeps the in-lane index that each repair's K9
    sweeps read (:meth:`lane_index`): one, for the view it was built
    from, dropped when the view changes — a mutation or a compaction.
    """

    def __init__(self, graph: DynamicCSRGraph, sources, *, config=None):
        if not isinstance(graph, DynamicCSRGraph):
            raise TypeError(f"IncrementalSSSP needs a DynamicCSRGraph, got "
                            f"{type(graph).__name__}")
        self.graph = graph
        self.config = config
        self.state, sweeps = sssp_state(graph, sources, config=config)
        self.scratch_sweeps = sweeps
        self.repair_sweeps = 0
        self.rebuilds = 0
        self.repairs = 0
        self._index = None
        self._index_key = None

    @property
    def dist(self) -> torch.Tensor:
        return self.state.dist

    @property
    def parent(self) -> torch.Tensor:
        return self.state.parent

    def dist_int(self) -> torch.Tensor:
        return self.state.dist_int()

    def lane_index(self) -> Optional[kernel_common.LaneIndex]:
        """K9's in-lane index of the graph's current view, keyed on
        ``(epoch, layout_version)``: a compaction re-lays the lanes out
        without bumping the epoch.  Built over the lanes the repair
        relaxes: the view's weights, or unit weights for an unweighted
        graph.  ``None`` off the card, where the plain version reads
        none."""
        g = self.graph
        key = (g.epoch, g.layout_version)
        if key != self._index_key:
            self._index = self._index_key = None    # drop the stale one
            view = g.view()
            if view.device.type == "cuda":
                self._index = _lane_index(
                    view, _lanes(g.view_weights(), view) if g.weighted
                    else _unit_lanes(view))
            self._index_key = key
        return self._index

    def update(self) -> Optional[RepairResult]:
        """Sync with the graph's current epoch.  Returns the
        :class:`RepairResult` (``None`` when already in sync)."""
        if self.graph.epoch == self.state.epoch:
            return None
        delta = self.graph.delta_since(self.state.epoch)
        if delta is None:                 # journal trimmed: full rebuild
            self.state, sweeps = sssp_state(self.graph,
                                            self.state.sources,
                                            config=self.config)
            self.scratch_sweeps += sweeps
            self.rebuilds += 1
            return RepairResult(self.state, sweeps, 0, 0, True)
        ins_src, ins_dst, ins_w, del_src, del_dst = delta
        res = repair(self.graph, self.state,
                     inserts=(ins_src, ins_dst, ins_w)
                     if self.state.weighted else (ins_src, ins_dst),
                     deletes=(del_src, del_dst), index=self.lane_index())
        self.state = res.state
        self.repair_sweeps += res.sweeps
        self.repairs += 1
        return res
