"""The semiring sweep-operator layer — one loop under the boolean engine.

The port of the boolean half of ``repro/core/sweep.py``.  A *sweep*
extends all known shortest paths by one relaxation, skips settled
targets (Thm 3.2) and the loop stops at the first sweep that settles
nothing (Fact 1).  This module owns:

  * :class:`Semiring`    — the algebra spec (boolean in this slice);
  * the three boolean sweep *forms* over identical padded state — dense
    push, bit-packed pull, edge-parallel sparse scatter
    (:func:`boolean_forms`);
  * :class:`SweepState`  — the loop state (``frontier``, ``dist``,
    ``parent``, ``step``, ``sweeps``, ``edges_touched``, ``dir_counts``);
  * :func:`sweep_loop`   — the ONE loop driver of ``repro_torch/core``;
  * :func:`derive_parents` — the shortest-path-tree post-pass;
  * :func:`time_sweep_forms` — the wall-clock calibration primitive.

A *form* is a callable ``(frontier, dist, parent, step) -> (new_frontier,
dist, parent)``; ``new_frontier`` is the int8 set of entries the sweep
discovered.  Where the JAX package runs ``lax.while_loop``, the port runs
a host loop that reads the Fact-1 flag (and the chosen direction) back
once per sweep.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, NamedTuple, Optional, Sequence, Tuple

import torch

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


BOOLEAN = Semiring("boolean", torch.int32, UNREACHED, 0,
                   unit="dense MAC / packed word / CSR lane")


# --------------------------------------------------------------------------
# loop state + the single loop driver
# --------------------------------------------------------------------------

class SweepState(NamedTuple):
    """Loop state.  The tensors live on the state's device; the counters
    the host loop branches on are Python values."""
    frontier: torch.Tensor       # entries discovered by the last sweep (int8)
    dist: torch.Tensor           # distances (int32, -1 unreached)
    parent: torch.Tensor         # shortest-path tree (int32; (1,) dummy: off)
    step: int                    # sweeps executed
    done: bool                   # Fact 1 fired
    sweeps: int                  # last *productive* step (= eccentricity)
    edges_touched: torch.Tensor  # 0-d float32 — Eq. 10 useful-work counter
    dir_counts: Tuple[int, ...]  # sweeps run per form


SweepForm = Callable[[torch.Tensor, torch.Tensor, torch.Tensor, int],
                     Tuple[torch.Tensor, torch.Tensor, torch.Tensor]]


def make_state(frontier: torch.Tensor, dist: torch.Tensor,
               parent: Optional[torch.Tensor] = None, *,
               n_forms: int = 3) -> SweepState:
    """Initial SweepState around caller-built frontier/dist buffers."""
    if parent is None:
        parent = torch.zeros((1,), dtype=torch.int32, device=dist.device)
    return SweepState(frontier=frontier, dist=dist, parent=parent, step=0,
                      done=False, sweeps=0,
                      edges_touched=torch.zeros((), dtype=torch.float32,
                                                device=dist.device),
                      dir_counts=(0,) * n_forms)


def _bump(counts: Tuple[int, ...], idx: int, by: int) -> Tuple[int, ...]:
    return counts[:idx] + (counts[idx] + by,) + counts[idx + 1:]


def sweep_loop(forms: Sequence[SweepForm], state: SweepState, *,
               max_steps: int, deg: Optional[torch.Tensor] = None,
               choose: Optional[Callable[[SweepState], int]] = None,
               forced_dir: int = 0, fused: Optional[Callable] = None,
               fused_steps: int = 0) -> SweepState:
    """THE sweep driver — the only loop over sweeps in repro_torch/core.

    forms      : candidate sweep forms; one runs per iteration.
    max_steps  : sweep bound (diameter / hop bound).
    deg        : optional out-degree vector; when given, each sweep adds
                 sum(deg[frontier]) to ``edges_touched`` (Eq. 10), as an
                 f32 running sum (exact below 2^24).
    choose     : ``SweepState -> int`` form index (the per-sweep
                 direction optimizer); ``None`` pins ``forms[forced_dir]``.
    fused      : optional fused multi-sweep block ``(frontier, dist, step,
                 n_run) -> (new, dist, prod, stopped)`` built by
                 :func:`fused_form`.  Each iteration then runs up to
                 ``fused_steps`` sweeps in ONE kernel launch and the loop
                 rebuilds the per-sweep accounting from the block's
                 (productive-count, converged) pair: a block executed
                 ``prod + 1`` sweeps if it converged and ``n_run``
                 otherwise.  ``step``, ``sweeps``, ``done``,
                 ``dir_counts`` and the final frontier/dist equal the
                 per-sweep loop's; ``edges_touched`` is not updated.
                 ``choose`` must be None (fusion pins one direction).
    """
    forms = tuple(forms)
    st = state
    if fused is not None and choose is not None:
        raise ValueError("fused blocks pin one direction")
    while not st.done and st.step < max_steps:
        if fused is not None:
            n_run = min(fused_steps, max_steps - st.step)
            new, dist, prod, stopped = fused(st.frontier, st.dist, st.step,
                                             n_run)
            prod, stopped = int(prod), bool(stopped)
            executed = prod + 1 if stopped else n_run
            st = st._replace(
                frontier=new, dist=dist, step=st.step + executed,
                done=stopped,
                sweeps=st.step + prod if prod > 0 else st.sweeps,
                dir_counts=_bump(st.dir_counts, forced_dir, executed))
            continue
        step = st.step + 1
        idx = forced_dir if choose is None else int(choose(st))
        new, dist, parent = forms[idx](st.frontier, st.dist, st.parent, step)
        stop = not bool(new.any())
        touched = st.edges_touched
        if deg is not None:
            touched = touched + torch.sum(
                (st.frontier != 0).to(torch.float32) * deg)
        st = SweepState(frontier=new, dist=dist, parent=parent, step=step,
                        done=stop, sweeps=st.sweeps if stop else step,
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
    ``budget`` overrides it).  The port's fused kernel streams the operand
    and keeps only its row tile's state on chip, so this gate admits n_pad
    up to about 71.5 k, where the JAX package's whole-operand VMEM gate
    stops near 7.8 k.  Between the two the JAX engine runs per-sweep and
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
               max_sweeps: int) -> Callable:
    """Close a registered fused multi-sweep kernel over its operand, with
    the ``sweep_loop(fused=...)`` contract: ``(frontier, dist, step,
    n_run) -> (new, dist, prod, stopped)``."""
    kern = kernel_registry.get(semiring).fused_forms[form]

    def fused(f, state, step, n_run):
        return kern(f, operand, state, step, n_run, bs=bs,
                    max_sweeps=max_sweeps)

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


def _discover(hits: torch.Tensor, d: torch.Tensor, step: int):
    new = hits & (d == UNREACHED)
    return new.to(torch.int8), torch.where(
        new, torch.tensor(step, dtype=d.dtype, device=d.device), d)


def boolean_forms(adj, adj_pull, src_idx, dst_idx, *, n_pad: int, s: int,
                  bn: int = 128, bk: int = 128, pull_chunk: int = 512,
                  use_kernel: bool = False,
                  track_parent: bool = False) -> Tuple[SweepForm, ...]:
    """(push, pull, sparse) boolean sweep forms over identical state.

    ``adj``/``adj_pull`` may be ``None`` when the caller has resolved a
    form that never dispatches them.  ``track_parent`` maintains the
    shortest-path tree in-loop on the sparse form (any active
    in-neighbour, max src id wins — the tie-break :func:`derive_parents`
    applies).

    ``use_kernel`` swaps the push/pull closures for the boolean kernels
    looked up in :mod:`repro_torch.kernels.registry`; both kernel
    directions read the bit-packed ``adj_pull`` operand.  The reference
    push is an f32 product with the dense ``adj`` (exact: counts stay
    below 2^24), chunked over destination columns like the pull.
    """
    bs = min(s, 128)
    chunk = _pull_chunk_size(n_pad, pull_chunk)
    wk = _pull_kernel_wk(max(n_pad // 32, 1))

    if use_kernel:
        K = kernel_registry.get(BOOLEAN).forms

        def push(f, d, p, step):
            # the operand's word width sets the push word tile
            new, dist = K["push"](pack_bits(f != 0), adj_pull, d, step,
                                  bs=bs, bn=bn,
                                  wk=_pull_kernel_wk(adj_pull.shape[1]))
            return new, dist, p

        def pull(f, d, p, step):
            new, dist = K["pull"](pack_bits(f != 0), adj_pull, d, step,
                                  bs=min(s, 8), bn=bn, wk=wk)
            return new, dist, p
    else:
        def push(f, d, p, step):
            ff = f.to(torch.float32)
            counts = torch.cat(
                [ff @ adj[:, j0: j0 + chunk].to(torch.float32)
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
# shortest-path tree post-pass
# --------------------------------------------------------------------------

def derive_parents(g, dist: torch.Tensor, *, weights=None) -> torch.Tensor:
    """Parent of v = any in-neighbour u on a shortest path (max u id wins
    — the same deterministic tie-break as the in-loop sparse tracking):
    ``dist[u] + 1 == dist[v]``.  dist is (..., n) over real nodes; one
    sparse pass over the padded CSR lanes, with a dead sentinel column."""
    if weights is not None:
        raise NotImplementedError(
            "weighted parents need the tropical slice (ROADMAP Queue 1 "
            "item 7)")
    n = g.n_nodes
    shape = dist.shape
    d = torch.cat([dist.reshape(-1, n),
                   torch.zeros((dist.reshape(-1, n).shape[0], 1),
                               dtype=dist.dtype, device=dist.device)],
                  dim=1).t()                             # (n + 1, S')
    src, dst = g.src.long(), g.dst.long()
    du, dv = d[src], d[dst]                              # (m_pad, S')
    ok = (du != UNREACHED) & (dv == du + 1)
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


def _sync(t: torch.Tensor) -> None:
    if t.is_cuda:
        torch.cuda.synchronize(t.device)


def time_sweep_forms(forms: Sequence[SweepForm], frontier, dist,
                     parent: Optional[torch.Tensor] = None, *,
                     n_sweeps: int = _CALIBRATION_SWEEPS,
                     reps: int = _CALIBRATION_REPS) -> Tuple[float, ...]:
    """Median wall-clock seconds per sweep for each form on the given
    mid-BFS state: ``n_sweeps`` chained sweeps per sample, ``dist``
    refreshed every other sweep to keep the frontier alive."""
    if parent is None:
        parent = torch.zeros((1,), dtype=torch.int32, device=dist.device)

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
