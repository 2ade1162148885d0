"""Streaming edge mutation over the fixed-shape CSR container.

The port of ``repro/graph/dynamic.py``.  Production graphs mutate.
:class:`CSRGraph` is deliberately frozen — fixed-shape device tensors the
sweeps treat as immutable — so this module adds the write path *around*
it instead of inside it.  The write path stays on the host in numpy, as
in the JAX package; only ``view()`` puts a snapshot on the device:

  * :class:`DynamicCSRGraph` owns host-side COO lane buffers with free
    headroom (a "COO side-buffer" over the packed CSR lanes).
    ``insert_edges`` fills free slots, ``delete_edges`` tombstones live
    slots to the CSR sentinel ``n_nodes`` — the exact inert-lane
    convention every sweep form already honours, which is what makes the
    merged operand cheap: a tombstoned lane *is* a padded lane.
  * ``view()`` materializes the merged (base + delta) operand as a
    plain :class:`CSRGraph` whose ``m_pad`` equals the buffer capacity.
    Capacity only changes when the buffer is grown (it stays a multiple
    of 128, the sparse relax kernel's lane block), so the sweep shapes
    survive arbitrarily many mutations.  Views are immutable snapshots:
    a reader holding one is never invalidated by later writes or by
    compaction.
  * ``compact()`` re-packs the lanes (dropping tombstones, restoring
    CSR sort order) when the tombstone fraction passes a threshold or
    the buffer runs out of slots.  Compaction changes layout, never
    content: the ``epoch`` counter is untouched.

Staleness is tracked by two counters:

  ``epoch``    — bumps once per mutation batch that changed the edge
                 *content*.  Everything downstream (``PreparedGraph``,
                 the serving tier's row cache / betweenness vector /
                 landmark tables, ``repro_torch.api`` handles) keys its
                 cached artifacts on this.
  ``layout_version`` — bumps on compaction too; the cached ``view()``
                 and the indexes built from its lanes key on it.

A bounded journal of net content deltas (``delta_since``) lets callers
patch O(n^2) dense operands in O(Δ) instead of rebuilding them; when the
journal has been trimmed past the requested epoch it returns ``None``
and the caller falls back to a rebuild.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from .csr import CSRGraph, _round_up

__all__ = ["DynamicCSRGraph"]

# keep at most this many mutation batches of journal; older deltas fall
# back to a full operand rebuild
_JOURNAL_LIMIT = 256


class DynamicCSRGraph:
    """A mutable graph: packed CSR lanes + free headroom + tombstones.

    ``weights=None`` builds an unweighted (boolean/counting) graph;
    passing lane weights (any array covering the first ``n_edges``
    lanes, e.g. the ``from_weighted_edges`` lane vector) makes it a
    tropical graph whose ``view_weights()`` stays aligned with
    ``view()``'s lanes.  Views are built on the base graph's device.
    """

    def __init__(self, base: CSRGraph, *,
                 weights: Optional[np.ndarray] = None,
                 slack: float = 0.5,
                 compact_threshold: float = 0.25):
        assert slack >= 0.0 and compact_threshold > 0.0
        self.n_nodes = int(base.n_nodes)
        self.device = base.device
        self._slack = float(slack)
        self._compact_threshold = float(compact_threshold)

        src, dst = base.edge_arrays_np()
        m = len(src)
        w = None
        if weights is not None:
            if isinstance(weights, torch.Tensor):
                weights = weights.detach().cpu().numpy()
            w = np.asarray(weights, np.float32).ravel()
            assert w.size >= m, f"need >= {m} weights, got {w.size}"
            assert (w[:m] >= 0).all(), "weights must be non-negative"
            w = w[:m]

        cap = max(_round_up(int((m + 1) * (1.0 + self._slack)), 128),
                  int(base.m_pad), 128)
        self._cap = cap
        self._src = np.full(cap, self.n_nodes, np.int64)
        self._dst = np.full(cap, self.n_nodes, np.int64)
        self._src[:m] = src
        self._dst[:m] = dst
        self._w = None
        if w is not None:
            self._w = np.full(cap, np.inf, np.float32)
            self._w[:m] = w
        self._slots = {(int(u), int(v)): i
                       for i, (u, v) in enumerate(zip(src, dst))}
        assert len(self._slots) == m, "base graph has duplicate edges"
        self._free = list(range(cap - 1, m - 1, -1))  # pop() -> low slots
        self._dead_slots = set()      # tombstoned (once-live) free slots
        self._n_live = m

        self.epoch = 0
        self.layout_version = 0
        self.compactions = 0
        self._journal = []   # [(epoch, kind, [(u, v, w, created), ...])]
        self._journal_floor = 0       # deltas valid for since >= floor
        self._view = None
        self._view_w = None
        self._view_key = None

    # -- constructors ------------------------------------------------------

    @classmethod
    def from_edges(cls, src, dst, n_nodes: int, *,
                   weights: Optional[np.ndarray] = None, device=None,
                   **kw) -> "DynamicCSRGraph":
        """Build from host COO edges; views go to ``device`` (``None``:
        the card)."""
        if weights is None:
            return cls(CSRGraph.from_edges(src, dst, n_nodes,
                                           device=device), **kw)
        g, lanes = CSRGraph.from_weighted_edges(src, dst, weights, n_nodes,
                                                device=device)
        return cls(g, weights=lanes, **kw)

    # -- introspection -----------------------------------------------------

    @property
    def n_edges(self) -> int:
        return self._n_live

    @property
    def m_pad(self) -> int:
        """Merged-operand lane capacity (the ``view()``'s ``m_pad``)."""
        return self._cap

    @property
    def weighted(self) -> bool:
        return self._w is not None

    def edges(self) -> Tuple[np.ndarray, ...]:
        """Live edges in CSR (src, dst) order — (src, dst[, w])."""
        live = self._src < self.n_nodes
        s, d = self._src[live], self._dst[live]
        order = np.lexsort((d, s))
        out = (s[order].astype(np.int64), d[order].astype(np.int64))
        if self._w is not None:
            out = out + (self._w[live][order].copy(),)
        return out

    def has_edge(self, u: int, v: int) -> bool:
        return (int(u), int(v)) in self._slots

    # -- mutation ----------------------------------------------------------

    def _normalize(self, src, dst, weights):
        src = np.asarray(src, np.int64).ravel()
        dst = np.asarray(dst, np.int64).ravel()
        assert src.shape == dst.shape, (src.shape, dst.shape)
        if src.size:
            assert src.min() >= 0 and dst.min() >= 0 and \
                src.max() < self.n_nodes and dst.max() < self.n_nodes, \
                "edge endpoints out of range"
        if weights is None:
            w = np.ones(src.size, np.float32)
        else:
            w = np.asarray(weights, np.float32).ravel()
            assert w.shape == src.shape, (w.shape, src.shape)
            assert (w >= 0).all(), "weights must be non-negative"
        return src, dst, w

    def insert_edges(self, src, dst, weights=None) -> int:
        """Insert a batch of edges; returns the number of *effective*
        changes.  Self-loops, in-batch duplicates (weighted: min-reduced,
        matching ``from_weighted_edges``) and edges already live at an
        equal-or-lower weight are no-ops.  On a weighted graph an insert
        of a live edge with a strictly lower weight is a weight decrease
        — journalled, epoch-bumped."""
        src, dst, w = self._normalize(src, dst, weights)
        effective = []
        for u, v, wt in zip(src, dst, w):
            u, v, wt = int(u), int(v), float(wt)
            if u == v:
                continue
            slot = self._slots.get((u, v))
            if slot is not None:
                if self._w is not None and wt < float(self._w[slot]):
                    self._w[slot] = wt
                    effective.append((u, v, wt, False))  # decrease-key
                continue
            if not self._free:
                self._compact(grow=True)
            slot = self._free.pop()
            self._dead_slots.discard(slot)
            self._src[slot] = u
            self._dst[slot] = v
            if self._w is not None:
                self._w[slot] = wt
            self._slots[(u, v)] = slot
            self._n_live += 1
            effective.append((u, v, wt, True))   # created (was absent)
        self._commit("insert", effective)
        return len(effective)

    def delete_edges(self, src, dst) -> int:
        """Delete a batch of edges; absent edges are no-ops.  Returns the
        number of effective deletions.  Deleted slots tombstone to the
        CSR sentinel (an inert padded lane) and are reusable."""
        src, dst, _ = self._normalize(src, dst, None)
        effective = []
        for u, v in zip(src, dst):
            u, v = int(u), int(v)
            slot = self._slots.pop((u, v), None)
            if slot is None:
                continue
            self._src[slot] = self.n_nodes
            self._dst[slot] = self.n_nodes
            if self._w is not None:
                self._w[slot] = np.inf
            self._free.append(slot)
            self._dead_slots.add(slot)
            self._n_live -= 1
            effective.append((u, v, np.inf, False))
        self._commit("delete", effective)
        if len(self._dead_slots) > \
                self._compact_threshold * max(self._n_live, 1):
            self._compact()
        return len(effective)

    def _commit(self, kind: str, effective) -> None:
        if not effective:
            return
        self.epoch += 1
        self._journal.append((self.epoch, kind, effective))
        if len(self._journal) > _JOURNAL_LIMIT:
            dropped = self._journal.pop(0)
            self._journal_floor = dropped[0]

    # -- compaction --------------------------------------------------------

    def compact(self) -> None:
        """Re-pack live lanes into CSR (src, dst) order, dropping
        tombstones.  Content (and ``epoch``) unchanged; layout version
        bumps.  Capacity is preserved so downstream jitted shapes — and
        any outstanding ``view()`` snapshot — stay valid."""
        self._compact(grow=False)

    def _compact(self, grow: bool = False) -> None:
        live = self._src < self.n_nodes
        s, d = self._src[live], self._dst[live]
        w = self._w[live] if self._w is not None else None
        order = np.lexsort((d, s))
        s, d = s[order], d[order]
        m = len(s)
        cap = self._cap
        if grow:
            cap = max(_round_up(int((m + 1) * (1.0 + self._slack)) + 128,
                                128), cap + 128)
        self._cap = cap
        self._src = np.full(cap, self.n_nodes, np.int64)
        self._dst = np.full(cap, self.n_nodes, np.int64)
        self._src[:m] = s
        self._dst[:m] = d
        if self._w is not None:
            ww = np.full(cap, np.inf, np.float32)
            ww[:m] = w[order]
            self._w = ww
        self._slots = {(int(u), int(v)): i
                       for i, (u, v) in enumerate(zip(s, d))}
        self._free = list(range(cap - 1, m - 1, -1))
        self._dead_slots = set()
        self._n_live = m
        self.layout_version += 1
        self.compactions += 1

    # -- merged read view --------------------------------------------------

    def view(self) -> CSRGraph:
        """The merged (base + delta) operand as an immutable
        :class:`CSRGraph` snapshot on the base graph's device, ``m_pad`` =
        buffer capacity.  Cached per (epoch, layout); safe to hold across
        later mutations."""
        key = (self.epoch, self.layout_version)
        if self._view_key != key:
            live = self._src < self.n_nodes
            s, d = self._src[live], self._dst[live]
            g = CSRGraph.from_edges(s, d, self.n_nodes, dedup=False,
                                    remove_self_loops=False,
                                    pad_to=self._cap, device=self.device)
            if self._w is not None:
                # from_edges lexsorts by (src, dst); mirror it so lane
                # weights line up with the view's padded CSR lanes
                order = np.lexsort((d, s))
                lanes = np.full(self._cap, np.inf, np.float32)
                lanes[:len(s)] = self._w[live][order]
                self._view_w = lanes
            self._view = g
            self._view_key = key
        return self._view

    def view_weights(self) -> Optional[np.ndarray]:
        """(m_pad,) f32 numpy lane weights aligned with ``view()`` (+inf
        pad); ``None`` for unweighted graphs."""
        if self._w is None:
            return None
        self.view()
        return self._view_w

    # -- delta journal -----------------------------------------------------

    def delta_since(self, since_epoch: int):
        """Net content delta from ``since_epoch`` to now, or ``None`` if
        the journal no longer reaches back that far (caller rebuilds).

        Returns ``(ins_src, ins_dst, ins_w, del_src, del_dst)`` numpy
        arrays: the edges now live that were inserted/updated after
        ``since_epoch``, and the edges deleted after it.  An edge
        *created* after ``since_epoch`` and deleted again cancels out
        entirely (its first journal entry records whether the insert
        created the edge or merely decreased a live weight).  An edge
        that existed at ``since_epoch`` and was deleted at any point
        appears in the delete list even when a later insert revived it
        (then also in the insert list, at its current weight): the
        revived weight may exceed the old one, so consumers must taint
        the state built on the old edge before applying the insert —
        netting the round-trip to a bare insert would leave distances
        that relied on the cheaper edge stale."""
        if since_epoch < self._journal_floor:
            return None
        # (u, v) -> [first_op_created_edge, last_kind, last_w, saw_delete]
        net = {}
        for ep, kind, edges in self._journal:
            if ep <= since_epoch:
                continue
            for (u, v, w, created) in edges:
                cur = net.get((u, v))
                if cur is None:
                    net[(u, v)] = [kind == "insert" and created, kind, w,
                                   kind == "delete"]
                else:
                    cur[1], cur[2] = kind, w
                    cur[3] = cur[3] or kind == "delete"
        ins = [(u, v, w) for (u, v), (_, k, w, _) in net.items()
               if k == "insert"]
        dels = [(u, v) for (u, v), (fc, _, _, sd) in net.items()
                if sd and not fc]
        ins_src = np.array([e[0] for e in ins], np.int64)
        ins_dst = np.array([e[1] for e in ins], np.int64)
        ins_w = np.array([e[2] for e in ins], np.float32)
        del_src = np.array([e[0] for e in dels], np.int64)
        del_dst = np.array([e[1] for e in dels], np.int64)
        return ins_src, ins_dst, ins_w, del_src, del_dst

    def __repr__(self) -> str:
        return (f"DynamicCSRGraph(n={self.n_nodes}, live={self._n_live}, "
                f"dead={len(self._dead_slots)}, cap={self._cap}, "
                f"epoch={self.epoch}, layout={self.layout_version}, "
                f"weighted={self._w is not None})")
