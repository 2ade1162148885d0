"""The semiring sweep-operator layer — one loop under the engines.

The port of the boolean, counting, tropical and min-label parts of
``repro/core/sweep.py``.  A *sweep* extends all known shortest paths by
one relaxation, skips settled targets (Thm 3.2) and the loop stops at the
first sweep that settles nothing (Fact 1).  This module owns:

  * :class:`Semiring`    — the algebra spec (boolean, counting, tropical,
    min-label; :data:`SEMIRINGS` by name);
  * the three boolean sweep *forms* over identical padded state — dense
    push, bit-packed pull, edge-parallel sparse scatter
    (:func:`boolean_forms`);
  * the two counting forms — f32 push product and sparse scatter-add
    over the (dist, sigma) pair (:func:`counting_forms`);
  * the two tropical (min,+) forms — dense min-plus product and sparse
    scatter-min relax over f32 distances (:func:`tropical_forms`);
  * the min-label form — one min-scatter of int32 labels over the lanes
    (:func:`minlabel_form`, connected components);
  * :class:`SweepState`  — the loop state (``frontier``, ``dist``,
    ``parent``, ``step``, ``sweeps``, ``edges_touched``, ``dir_counts``);
  * :func:`sweep_loop`   — the ONE loop driver of ``repro_torch/core``;
  * :func:`derive_parents` — the shortest-path-tree post-pass;
  * :func:`time_sweep_forms` — the wall-clock calibration primitive.

A *form* is a callable ``(frontier, dist, parent, step) -> (new_frontier,
dist, parent)``; ``new_frontier`` is the int8 set of entries the sweep
discovered.  ``dist`` is the semiring's state: a tensor, or for the
counting semiring the ``(dist, sigma)`` pair.  Where the JAX package
runs ``lax.while_loop``, the port runs a host loop that reads the Fact-1
flag (and the chosen direction) back once per sweep.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, NamedTuple, Optional, Sequence, Tuple

import torch

from .. import trace
from ..kernels import common as kernel_common
from ..kernels import registry as kernel_registry
from .frontier import UNREACHED, pack_bits

PUSH, PULL, SPARSE = 0, 1, 2
DIRECTION_NAMES = ("push", "pull", "sparse")


# --------------------------------------------------------------------------
# semiring specs
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Semiring:
    """Algebra spec for a sweep: which (⊕, ⊗) the forms implement.

    ``unreached`` is the ⊕-identity stored for "no path yet";
    ``source_dist`` the ⊗-identity stored at the sources; ``unit`` names
    what one modelled cost count means for this semiring.
    """
    name: str
    dist_dtype: Any
    unreached: Any
    source_dist: Any
    unit: str

    def unreached_mask(self, dist: torch.Tensor) -> torch.Tensor:
        """Boolean mask of not-yet-settled entries (the Thm 3.2 skip set
        and the pull/push occupancy signal)."""
        if self.name == "tropical":
            return torch.isinf(dist)
        return dist == self.unreached


BOOLEAN = Semiring("boolean", torch.int32, UNREACHED, 0,
                   unit="dense MAC / packed word / CSR lane")
# Path counting: the state is the PAIR (dist int32, sigma f32) and ⊕ is
# elementwise ADD of path counts, gated on dist ties — non-idempotent, so
# every partial is summed exactly once before the gate.
COUNTING = Semiring("counting", torch.int32, UNREACHED, 0,
                    unit="f32 MAC / CSR add lane")
# Weighted shortest paths: (min, +) over f32 distances, +inf unreached.
TROPICAL = Semiring("tropical", torch.float32, float("inf"), 0.0,
                    unit="f32 add+min lane / CSR relax lane")
# Connected components: labels flow along the lanes under min; no
# distance, so neither identity applies.
MIN_LABEL = Semiring("min_label", torch.int32, None, None,
                     unit="CSR min-scatter lane")

SEMIRINGS = {s.name: s for s in (BOOLEAN, TROPICAL, MIN_LABEL, COUNTING)}

INF = float("inf")


# --------------------------------------------------------------------------
# loop state + the single loop driver
# --------------------------------------------------------------------------

class SweepState(NamedTuple):
    """Loop state.  The tensors live on the state's device; the counters
    the host loop branches on are Python values."""
    frontier: torch.Tensor       # entries discovered by the last sweep (int8)
    dist: Any                    # distances (int32, -1 unreached), or the
                                 # counting (dist, sigma) pair
    parent: torch.Tensor         # shortest-path tree (int32; (1,) dummy: off)
    step: int                    # sweeps executed
    done: bool                   # Fact 1 fired
    sweeps: int                  # last *productive* step (= eccentricity)
    edges_touched: torch.Tensor  # 0-d float32 — Eq. 10 useful-work counter
    dir_counts: Tuple[int, ...]  # sweeps run per form


SweepForm = Callable[[torch.Tensor, torch.Tensor, torch.Tensor, int],
                     Tuple[torch.Tensor, torch.Tensor, torch.Tensor]]


def make_state(frontier: torch.Tensor, dist,
               parent: Optional[torch.Tensor] = None, *,
               n_forms: int = 3) -> SweepState:
    """Initial SweepState around caller-built frontier/dist buffers
    (``dist`` a tensor or the counting (dist, sigma) pair)."""
    dev = frontier.device
    if parent is None:
        parent = torch.zeros((1,), dtype=torch.int32, device=dev)
    return SweepState(frontier=frontier, dist=dist, parent=parent, step=0,
                      done=False, sweeps=0,
                      edges_touched=torch.zeros((), dtype=torch.float32,
                                                device=dev),
                      dir_counts=(0,) * n_forms)


def _bump(counts: Tuple[int, ...], idx: int, by: int) -> Tuple[int, ...]:
    return counts[:idx] + (counts[idx] + by,) + counts[idx + 1:]


def sweep_loop(forms: Sequence[SweepForm], state: SweepState, *,
               max_steps: int, deg: Optional[torch.Tensor] = None,
               choose: Optional[Callable[[SweepState], int]] = None,
               forced_dir: int = 0,
               converged: Optional[Callable[[torch.Tensor], bool]] = None,
               fused: Optional[Callable] = None, fused_steps: int = 0,
               fused_combine: Optional[Callable] = None) -> SweepState:
    """THE sweep driver — the only loop over sweeps in repro_torch/core.

    forms      : candidate sweep forms; one runs per iteration.
    max_steps  : sweep bound (diameter / hop bound).
    deg        : optional out-degree vector; when given, each sweep adds
                 sum(deg[frontier]) to ``edges_touched`` (Eq. 10), as an
                 f32 running sum (exact below 2^24).
    choose     : ``SweepState -> int`` form index (the per-sweep
                 direction optimizer); ``None`` pins ``forms[forced_dir]``.
    converged  : Fact-1 test over the new frontier -> bool; default
                 ``not new.any()``.  The sharded executor passes a
                 reduction over every rank of its mesh, so that all ranks
                 stop at the same sweep.
    fused      : optional fused multi-sweep block ``(frontier, dist, step,
                 n_run) -> (new, dist, prod, stopped)`` (``dist`` the
                 loop state's dist slot: a tensor or a pair) built by
                 :func:`fused_form`.  Each iteration then runs up to
                 ``fused_steps`` sweeps in ONE kernel launch and the loop
                 rebuilds the per-sweep accounting from the block's
                 (productive-count, converged) pair: a block executed
                 ``prod + 1`` sweeps if it converged and ``n_run``
                 otherwise.  ``step``, ``sweeps``, ``done``,
                 ``dir_counts`` and the final frontier/dist equal the
                 per-sweep loop's; ``edges_touched`` is not updated.
                 ``choose`` must be None (fusion pins one direction).
    fused_combine : optional reduction of the block's ``(prod, stopped)``
                 pair over the sharded executor's ranks (max / all), so
                 that every rank takes the same accounting — the fused
                 counterpart of ``converged``.
    """
    forms = tuple(forms)
    st = state
    if fused is not None and choose is not None:
        raise ValueError("fused blocks pin one direction")
    while not st.done and st.step < max_steps:
        with trace.span("dawn.sweep"):
            if fused is not None:
                n_run = min(fused_steps, max_steps - st.step)
                with trace.span("dawn.sweep.fused"):
                    new, dist, prod, stopped = fused(st.frontier, st.dist,
                                                     st.step, n_run)
                    if fused_combine is not None:
                        prod, stopped = fused_combine(prod, stopped)
                    prod, stopped = int(prod), bool(stopped)
                executed = prod + 1 if stopped else n_run
                trace.count("dawn.sweeps", executed)
                st = st._replace(
                    frontier=new, dist=dist, step=st.step + executed,
                    done=stopped,
                    sweeps=st.step + prod if prod > 0 else st.sweeps,
                    dir_counts=_bump(st.dir_counts, forced_dir, executed))
                continue
            step = st.step + 1
            if choose is None:
                idx = forced_dir
            else:
                with trace.span("dawn.sweep.choose"):
                    idx = int(choose(st))
            with trace.span("dawn.sweep.form"):
                new, dist, parent = forms[idx](st.frontier, st.dist,
                                               st.parent, step)
            with trace.span("dawn.sweep.converged"):
                stop = not bool(new.any()) if converged is None \
                    else bool(converged(new))
            touched = st.edges_touched
            if deg is not None:
                touched = touched + torch.sum(
                    (st.frontier != 0).to(torch.float32) * deg)
            trace.count("dawn.sweeps")
            st = SweepState(frontier=new, dist=dist, parent=parent,
                            step=step, done=stop,
                            sweeps=st.sweeps if stop else step,
                            edges_touched=touched,
                            dir_counts=_bump(st.dir_counts, idx, 1))
    return st


# --------------------------------------------------------------------------
# fused multi-sweep dispatch (the persistent-kernel capability seam)
# --------------------------------------------------------------------------

def resolve_fused_steps(semiring, form: str, *, fused_steps: int,
                        max_steps: int, use_kernel: bool, n_pad: int,
                        bs: int, budget: Optional[int] = None
                        ) -> Optional[int]:
    """Fused-block length for an engine run, or ``None`` for the
    per-sweep path.  ``fused_steps`` is the config's request: 0 = off,
    -1 = whole fixpoint per launch, K > 0 = K-sweep blocks.

    Fusion engages only on the kernel path, only when the semiring
    registers a fused form for ``form``, and only when one block of the
    fused kernel fits the per-block shared-memory budget
    (``smem_bytes(form="fused")``, Hopper's 232,448 bytes unless
    ``budget`` overrides it).  The port's boolean fused kernel streams
    the operand and spreads its row tile's state over a cluster of CTAs,
    so this gate admits n_pad up to 264,704 (each CTA holds its slice of
    the state plus the tile's active-word list), where the JAX package's
    whole-operand VMEM gate stops near 7.8 k.  Between the two the JAX engine runs per-sweep and
    the port fuses; results agree, except ``edges_touched``, which the
    fused loop does not update."""
    if not fused_steps or not use_kernel or not kernel_registry.has(semiring):
        return None
    ks = kernel_registry.get(semiring)
    if form not in ks.fused_forms:
        return None
    if ks.smem_bytes(form="fused", bs=bs, n=n_pad) > \
            kernel_common.smem_limit(budget):
        return None
    return max_steps if fused_steps < 0 else min(fused_steps, max_steps)


def fused_form(semiring, operand, form: str, *, bs: int,
               max_sweeps: int, index=None) -> Callable:
    """Close a registered fused multi-sweep kernel over its operand, with
    the ``sweep_loop(fused=...)`` contract: ``(frontier, dist, step,
    n_run) -> (new, dist, prod, stopped)``.  ``index``, the operand's
    live-word index, is passed on to kernels that read one."""
    kern = kernel_registry.get(semiring).fused_forms[form]
    kw = {} if index is None else {"index": index}

    def fused(f, state, step, n_run):
        return kern(f, operand, state, step, n_run, bs=bs,
                    max_sweeps=max_sweeps, **kw)

    return fused


# --------------------------------------------------------------------------
# boolean semiring forms (unweighted BFS — paper Algs. 1/2)
# --------------------------------------------------------------------------

def _pull_chunk_size(n_pad: int, preferred: int) -> int:
    for c in (preferred, 512, 256, 128):
        if c <= n_pad and n_pad % c == 0:
            return c
    return n_pad


def _pull_kernel_wk(words: int) -> int:
    for wk in (128, 64, 32, 16, 8, 4):
        if words % wk == 0:
            return wk
    return words


# the accumulators the reference dense push may count in: its terms are
# 0 or 1, so each gives the same booleans (a float16 or bfloat16 count
# that saturates at inf is still > 0)
_ACCUM_DTYPES = {"float32": torch.float32, "float16": torch.float16,
                 "bfloat16": torch.bfloat16, "int32": torch.int32}


def resolve_accum_dtype(accum_dtype) -> torch.dtype:
    """The dtype the reference dense push counts frontier in-neighbours
    in: a torch dtype or its name (``"bfloat16"``, the JAX spelling).

    Integer types narrower than 32 bits are refused: their sums wrap, so
    a node whose count reaches 128 (int8) sums to 0 or below and is
    missed, which the JAX package's push does silently."""
    name = accum_dtype if isinstance(accum_dtype, str) \
        else str(accum_dtype).rpartition(".")[2]
    if name in ("int8", "uint8", "int16"):
        raise ValueError(
            f"accum_dtype {name} wraps: a count of frontier in-neighbours "
            f"past its range sums to 0 or below (in int8, 128 to -128 and "
            f"256 to 0) and the node is missed; count in "
            f"{', '.join(_ACCUM_DTYPES)}")
    if name not in _ACCUM_DTYPES:
        raise ValueError(f"accum_dtype must be one of "
                         f"{', '.join(_ACCUM_DTYPES)}, not {accum_dtype!r}")
    return _ACCUM_DTYPES[name]


def count_hits(f: torch.Tensor, adj: torch.Tensor,
               acc: torch.dtype) -> torch.Tensor:
    """``f @ adj`` counted in ``acc``.  The card has no integer matmul, so
    int32 counts in float32 there: the booleans ``> 0`` are the same."""
    if acc == torch.int32 and f.is_cuda:
        acc = torch.float32
    return f.to(acc) @ adj.to(acc)


def _discover(hits: torch.Tensor, d: torch.Tensor, step: int):
    new = hits & (d == UNREACHED)
    return new.to(torch.int8), torch.where(
        new, torch.tensor(step, dtype=d.dtype, device=d.device), d)


def boolean_forms(adj, adj_pull, src_idx, dst_idx, *, n_pad: int, s: int,
                  bn: int = 128, bk: int = 128, pull_chunk: int = 512,
                  use_kernel: bool = False, track_parent: bool = False,
                  index=None, accum_dtype=torch.float32
                  ) -> Tuple[SweepForm, ...]:
    """(push, pull, sparse) boolean sweep forms over identical state.

    ``adj``/``adj_pull`` may be ``None`` when the caller has resolved a
    form that never dispatches them.  ``track_parent`` maintains the
    shortest-path tree in-loop on the sparse form (any active
    in-neighbour, max src id wins — the tie-break :func:`derive_parents`
    applies).

    ``use_kernel`` swaps the push/pull closures for the boolean kernels
    looked up in :mod:`repro_torch.kernels.registry`; both kernel
    directions read the bit-packed ``adj_pull`` operand through
    ``index``, its live-word index (``PreparedGraph.adj_pull_index``;
    ``None``: each launch on the card builds it).  The reference
    push is a product with the dense ``adj`` in ``accum_dtype`` (see
    :func:`resolve_accum_dtype`; float32 is exact while counts stay below
    2^24), chunked over destination columns like the pull.  The kernels
    read packed words and ignore it.
    """
    acc = resolve_accum_dtype(accum_dtype)
    bs = min(s, 128)
    chunk = _pull_chunk_size(n_pad, pull_chunk)
    wk = _pull_kernel_wk(max(n_pad // 32, 1))

    if use_kernel:
        ks = kernel_registry.get(BOOLEAN)
        K, pack = ks.forms, ks.pack

        def push(f, d, p, step):
            # the operand's word width sets the push word tile
            new, dist = K["push"](pack(f), adj_pull, d, step,
                                  bs=bs, bn=bn,
                                  wk=_pull_kernel_wk(adj_pull.shape[1]),
                                  index=index)
            return new, dist, p

        def pull(f, d, p, step):
            new, dist = K["pull"](pack(f), adj_pull, d, step,
                                  bs=min(s, 8), bn=bn, wk=wk, index=index)
            return new, dist, p
    else:
        def push(f, d, p, step):
            ff = f.to(acc)                   # once, not once per chunk
            counts = torch.cat(
                [count_hits(ff, adj[:, j0: j0 + chunk], acc)
                 for j0 in range(0, n_pad, chunk)], dim=-1)
            new, dist = _discover(counts > 0, d, step)
            return new, dist, p

        def pull(f, d, p, step):
            # chunked oracle for the packed pull sweep — bounds the
            # (S, C, W) broadcast intermediate to chunk * S * W words
            fp = pack_bits(f != 0)                       # (S, W)
            hits = torch.cat(
                [((fp[..., None, :] & adj_pull[j0: j0 + chunk]) != 0)
                 .any(dim=-1) for j0 in range(0, n_pad, chunk)], dim=-1)
            new, dist = _discover(hits, d, step)
            return new, dist, p

    src_l = src_idx.long()
    dst_l = dst_idx.long()

    def sparse(f, d, p, step):
        # batched SOVM sweep (paper Alg. 2 / Eq. 9 union as scatter-OR):
        # one 1-D scatter along the node axis of the (n, S) transposed state
        shape = d.shape
        f_t = f.reshape(-1, shape[-1]).t()
        active = f_t[src_l] != 0                         # (m_pad, S')
        hits = torch.zeros(f_t.shape, dtype=torch.int8, device=f.device)
        hits.index_reduce_(0, dst_l, active.to(torch.int8), "amax")
        hits = hits.t().contiguous().reshape(shape) != 0
        new, dist = _discover(hits, d, step)
        if track_parent:
            cand = torch.where(active, src_idx[:, None].to(torch.int32),
                               torch.tensor(-1, dtype=torch.int32,
                                            device=f.device))
            pcand = torch.full(f_t.shape, -1, dtype=torch.int32,
                               device=f.device)
            pcand.index_reduce_(0, dst_l, cand, "amax")
            p = torch.where(new != 0, pcand.t().contiguous().reshape(shape), p)
        return new, dist, p

    return push, pull, sparse


# --------------------------------------------------------------------------
# min-label semiring form (connected components)
# --------------------------------------------------------------------------

def minlabel_form(src_idx, dst_idx) -> SweepForm:
    """Min-label propagation sweep: ``labels[dst] ⊕= labels[src]`` with
    ⊕ = min, one ``index_reduce_`` over the lanes.  Pass symmetrized edge
    arrays for *weakly* connected components.  The frontier is the
    changed-label set; Fact 1 is "no label lowered"."""
    src_l, dst_l = src_idx.long(), dst_idx.long()

    def sweep(f, labels, p, step):
        nl = labels.clone()
        nl.index_reduce_(labels.dim() - 1, dst_l, labels[..., src_l], "amin")
        changed = nl < labels
        return changed.to(torch.int8), nl, p
    return sweep


# --------------------------------------------------------------------------
# counting semiring forms (shortest-path counting — Brandes stage 1)
# --------------------------------------------------------------------------

def counting_forms(adj, src_idx, dst_idx, *, n_pad: int = 0, s: int = 0,
                   bn: int = 128, bk: int = 128, use_kernel: bool = False,
                   index=None) -> Tuple[SweepForm, SweepForm]:
    """(push, sparse) counting sweep forms.

    The loop state's ``dist`` slot is the PAIR ``(dist int32, sigma
    f32)``: ``dist`` is the boolean semiring's level array and
    ``sigma[s, v]`` counts shortest s->v paths.  Every shortest path to a
    node first reached at this sweep enters through the current frontier,
    so one f32 product of frontier-masked sigma with the adjacency gives
    the complete count:

        cand[s, j] = sum_k (frontier ? sigma : 0)[s, k] * A[k, j]
        new        = (cand > 0) & (dist == UNREACHED)
        dist'      = new ? step : dist
        sigma'     = new ? cand : sigma

    Counts are f32: exact up to 2^24 paths per (source, node) pair.

    ``adj`` is the dense int8 operand (``None`` when only sparse
    dispatches).  The reference push converts it to f32 one column chunk
    at a time (never whole); ``use_kernel`` swaps the push for the
    counting kernel looked up in :mod:`repro_torch.kernels.registry`,
    given ``index``, the live-word index of ``adj``
    (``PreparedGraph.adj_index``; ``None``: each launch on the card builds
    it).
    The sparse form is a scatter-ADD: one 1-D ``index_add_`` along the
    node axis of the (n, S) transposed state.
    """
    if use_kernel:
        K = kernel_registry.get(COUNTING).forms
        bs = min(s, 128) if s else 128

        def push(f, ds, p, step):
            d, sg = ds
            fs = torch.where(f != 0, sg, torch.zeros((), dtype=sg.dtype,
                                                     device=sg.device))
            new, nd, nsg = K["push"](fs, adj, d, sg, step, bs=bs, bn=bn,
                                     bk=bk, index=index)
            return new, (nd, nsg), p
    else:
        def push(f, ds, p, step):
            d, sg = ds
            fs = torch.where(f != 0, sg, torch.zeros((), dtype=sg.dtype,
                                                     device=sg.device))
            chunk = _pull_chunk_size(adj.shape[1], 512)
            cand = torch.cat(
                [fs @ adj[:, j0: j0 + chunk].to(torch.float32)
                 for j0 in range(0, adj.shape[1], chunk)], dim=-1)
            new = (cand > 0) & (d == UNREACHED)
            return (new.to(torch.int8),
                    (torch.where(new, torch.tensor(step, dtype=d.dtype,
                                                   device=d.device), d),
                     torch.where(new, cand, sg)), p)

    src_l = src_idx.long()
    dst_l = dst_idx.long()

    def sparse(f, ds, p, step):
        # edge-parallel scatter-ADD: each CSR lane contributes its source's
        # sigma once (lanes are deduped), so the sum over in-lanes is the
        # exact path count
        d, sg = ds
        shape = d.shape
        f_t = f.reshape(-1, shape[-1]).t()
        sg_t = sg.reshape(-1, shape[-1]).t()
        contrib = torch.where(f_t[src_l] != 0, sg_t[src_l],
                              torch.zeros((), dtype=sg.dtype,
                                          device=sg.device))  # (m_pad, S')
        cand = torch.zeros(sg_t.shape, dtype=sg.dtype, device=sg.device)
        cand.index_add_(0, dst_l, contrib)
        cand = cand.t().contiguous().reshape(shape)
        new = (cand > 0) & (d == UNREACHED)
        return (new.to(torch.int8),
                (torch.where(new, torch.tensor(step, dtype=d.dtype,
                                               device=d.device), d),
                 torch.where(new, cand, sg)), p)

    return push, sparse


# --------------------------------------------------------------------------
# tropical semiring forms (weighted shortest paths)
# --------------------------------------------------------------------------

def tropical_forms(wdense, src_idx, dst_idx, w_edges, *, n_pad: int = 0,
                   chunk: int = 128, use_frontier: bool = True,
                   use_kernel: bool = False, bn: int = 128, bk: int = 128,
                   eb: int = 128, windex=None, rindex=None
                   ) -> Tuple[Optional[SweepForm], SweepForm]:
    """(dense, sparse) (min,+) sweep forms.

    dense  — the f32 min-plus analogue of the boolean push:
             ``cand[s, j] = min_k (dist[s, k] + W[k, j])`` over frontier
             rows.  ``wdense`` is (n_pad, n_pad) f32 with +inf non-edges
             (``None`` when only the sparse form runs; the dense form is
             then ``None``).  Reference path: :func:`minplus_candidates`,
             ``chunk`` destination columns at a time.  Kernel path: the
             dense min-plus kernel (K7) with settled-bound tile skipping,
             looked up in :mod:`repro_torch.kernels.registry`, given
             ``windex``, the live-word index of ``wdense`` (built by
             the kernel when ``None``).
    sparse — edge-parallel relaxation: ``cand = dist[src] + w``
             scattered with min into ``dst`` — Bellman-Ford restricted to
             the improved frontier (sound for non-negative weights).
             ``use_frontier=False`` relaxes every edge every sweep
             (reference path only).  Kernel path (batched 2-D state on
             the card): the sparse relax kernel (K9), a gather over each
             target's in-lanes, given ``rindex``, the lanes' in-lane
             index (built by the kernel when ``None``).  Unlike the JAX
             package, whose compiled path takes the XLA scatter here, the
             port dispatches the kernel: min is order-free, so the bits
             are the same.

    Fact 1 generalizes: the new frontier is the improved set, and a
    sweep that improves nothing terminates.
    """
    src_l, dst_l = src_idx.long(), dst_idx.long()

    def sparse_ref(f, d, p, step):
        # one 1-D scatter-min along the node axis of the (n, S') state
        shape = d.shape
        d_t = d.reshape(-1, shape[-1]).t()
        cand = d_t[src_l] + w_edges[:, None]               # (m_pad, S')
        if use_frontier:
            f_t = f.reshape(-1, shape[-1]).t()
            cand = torch.where(f_t[src_l] != 0, cand,
                               torch.full((), INF, device=d.device))
        nd = d_t.clone(memory_format=torch.contiguous_format)
        nd.index_reduce_(0, dst_l, cand, "amin")
        nd = nd.t().contiguous().reshape(shape)
        new = nd < d
        return new.to(torch.int8), nd, p

    def masked(f, d):
        return torch.where(f != 0, d, torch.full((), INF, device=d.device))

    if use_kernel:
        if not use_frontier:
            raise ValueError("the kernel path is frontier-gated by "
                             "construction")
        K = kernel_registry.get(TROPICAL).forms
        # min edge weight — drives the K7 settled-skip table (padded
        # lanes are +inf and fall out of the min)
        w_min = torch.min(w_edges)

        dense = None
        if wdense is not None:
            def dense(f, d, p, step):
                new, nd = K["dense"](masked(f, d), wdense, d, w_min,
                                     bs=min(f.shape[0], 128), bn=bn, bk=bk,
                                     index=windex)
                return new, nd, p

        def sparse(f, d, p, step):
            new, nd = K["sparse"](f, d, src_idx, dst_idx, w_edges, eb=eb,
                                  index=rindex)
            return new, nd, p

        return dense, sparse

    dense = None
    if wdense is not None:
        def dense(f, d, p, step):
            cand = minplus_candidates(masked(f, d), wdense, chunk=chunk)
            nd = torch.minimum(d, cand)
            new = nd < d
            return new.to(torch.int8), nd, p

    return dense, sparse_ref


def minplus_candidates(fd: torch.Tensor, wdense: torch.Tensor, *,
                       chunk: int = 128) -> torch.Tensor:
    """The (min,+) matrix product ``cand[s, j] = min_k fd[s, k] + W[k, j]``
    behind the dense tropical form, on a (K, N) operand.  ``chunk``
    destination columns at a time bound the (S, chunk, K) broadcast."""
    kdim, ndim = wdense.shape
    c = _pull_chunk_size(ndim, chunk)
    return torch.cat(
        [(fd[..., None, :] + wdense[:, j0: j0 + c].t()).amin(dim=-1)
         for j0 in range(0, ndim, c)], dim=-1)


# --------------------------------------------------------------------------
# shortest-path tree post-pass
# --------------------------------------------------------------------------

def derive_parents(g, dist: torch.Tensor, *, weights=None) -> torch.Tensor:
    """Parent of v = any in-neighbour u on a shortest path (max u id wins
    — the same deterministic tie-break as the in-loop sparse tracking).

    Unweighted: ``dist[u] + 1 == dist[v]``.  Weighted (pass the (m_pad,)
    lane ``weights``): ``dist[u] + w(u, v) == dist[v]`` — exact because
    the sweeps computed dist[v] as that very f32 sum for at least one
    in-neighbour.  dist is (..., n) over real nodes; one sparse pass over
    the padded CSR lanes, with a dead sentinel column."""
    n = g.n_nodes
    shape = dist.shape
    d = torch.cat([dist.reshape(-1, n),
                   torch.zeros((dist.reshape(-1, n).shape[0], 1),
                               dtype=dist.dtype, device=dist.device)],
                  dim=1).t()                             # (n + 1, S')
    src, dst = g.src.long(), g.dst.long()
    du, dv = d[src], d[dst]                              # (m_pad, S')
    if weights is None:
        ok = (du != UNREACHED) & (dv == du + 1)
    else:
        w = torch.as_tensor(weights, dtype=torch.float32,
                            device=dist.device)
        w = torch.where(g.src < n, w, torch.full((), INF,
                                                 device=dist.device))
        ok = torch.isfinite(du) & (dv == du + w[:, None])
    cand = torch.where(ok, g.src[:, None], torch.tensor(
        -1, dtype=torch.int32, device=dist.device))
    par = torch.full(d.shape, -1, dtype=torch.int32, device=dist.device)
    par.index_reduce_(0, dst, cand, "amax")
    return par[:n].t().contiguous().reshape(shape)


# --------------------------------------------------------------------------
# wall-clock form calibration (the reference-path direction signal)
# --------------------------------------------------------------------------

_CALIBRATION_SWEEPS = 8
_CALIBRATION_REPS = 5


def _sync(state) -> None:
    """Wait for the card; ``state`` is a tensor or a tuple of tensors
    (the counting (dist, sigma) pair)."""
    t = state[0] if isinstance(state, tuple) else state
    if t.is_cuda:
        torch.cuda.synchronize(t.device)


def time_sweep_forms(forms: Sequence[SweepForm], frontier, dist,
                     parent: Optional[torch.Tensor] = None, *,
                     n_sweeps: int = _CALIBRATION_SWEEPS,
                     reps: int = _CALIBRATION_REPS) -> Tuple[float, ...]:
    """Median wall-clock seconds per sweep for each form on the given
    mid-BFS state: ``n_sweeps`` chained sweeps per sample, ``dist`` (a
    tensor or the counting (dist, sigma) pair) refreshed every other
    sweep to keep the frontier alive."""
    if parent is None:
        parent = torch.zeros((1,), dtype=torch.int32,
                             device=frontier.device)

    def chained(form):
        fr, d, p = frontier, dist, parent
        for i in range(n_sweeps):
            fr, dd, p = form(fr, d, p, i + 1)
            d = dist if i % 2 == 1 else dd
        _sync(d)

    costs = []
    for form in forms:
        chained(form)                                    # warm
        samples = []
        for _ in range(reps):
            t0 = time.perf_counter()
            chained(form)
            samples.append(time.perf_counter() - t0)
        costs.append(sorted(samples)[reps // 2] / n_sweeps)
    return tuple(costs)
