"""Semiring-generic sharded sweep executor — DAWN's multi-device path (the
port of ``repro/core/distributed.py``, on ``torch.distributed``).

The paper's APSP regime O(S_wcc · E_wcc) is parallel over sources, and
the per-sweep relaxation itself shards over vertices.  This module
scales both axes of a mesh (:mod:`repro_torch.launch.mesh`), for every
semiring the sweep layer knows:

  * **sources** shard over the mesh's data-parallel axes (every axis not
    named ``model``): each rank runs the one loop driver
    (:func:`repro_torch.core.sweep.sweep_loop`) on its ``(S/D, n_pad)``
    rows, with no communication in a sweep but the Fact-1 predicate,
    reduced over the whole mesh so that every rank stops at the same
    sweep.
  * **vertices** (optional, mesh axis ``model`` of extent C) shard the
    sweep operand: each rank holds the K-row block of the dense operand
    whose sources lie in its ``n_pad / C`` rows, and the CSR lanes of its
    destination block (:func:`repro_torch.graph.partition.
    edge_partition_global`).  Each sweep computes a *partial* candidate
    set from the local block and combines it across the ``model`` group
    with the semiring's ⊕: OR (an all-gather of packed words, folded in
    group order: NCCL has no bitwise reduction) for boolean, MIN for
    tropical, and for counting a SUM of *gated partials* (never of
    epilogue outputs, which would count a path twice).  All are exact
    (f32 min does not round; f32 sums of path counts are exact below
    2^24), so results are bit-identical to the single-device engines.

**The SPMD contract.**  The JAX package runs one controller over every
device; the port runs one process per device.  Every rank of the mesh
calls :func:`prepare_sharded` and :func:`sharded_apsp` with the same
arguments, as a ``torchrun`` program does.  Each rank computes its own
source rows and its own K-row block; every rank gets the whole ``(S,
n)`` result back (an all-gather over the data axes), on its own device,
as JAX returns a global array.  A rank outside the mesh (a smaller mesh
from :func:`repro_torch.launch.mesh.mesh_from_plan`) must not call.

A ``"cuda"`` mesh (NCCL) runs the kernels, a ``"cpu"`` mesh (gloo) their
plain versions: ``use_kernel=None`` means kernels iff the mesh is on the
card.  Forms dispatch through :mod:`repro_torch.kernels.registry` as in
the engines, and this module keeps no loop of its own.
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import NamedTuple, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from .. import trace
from ..graph.csr import CSRGraph, _round_up, same_device
from ..graph.partition import edge_partition_global
from ..kernels import common as kernel_common
from ..kernels import registry as kernel_registry
from ..launch.mesh import (MODEL_AXIS, check_mesh, dp_axes, dp_size,
                           mesh_device, mesh_extent)
from . import autotune
from . import sweep as S
from .engine import PreparedGraph, card_index, frontier_stats
from .frontier import UNREACHED, one_hot_frontier, unpack_bits
from .options import SweepOptions
from .weighted import PreparedWeightedGraph

INF = float("inf")

DENSE, SPARSE = 0, 1
SHARDED_FORM_NAMES = ("dense", "sparse")


@dataclasses.dataclass(frozen=True)
class ShardedConfig(SweepOptions):
    """Static sharded-executor parameters (a :class:`SweepOptions`
    subclass).

    ``semiring`` picks the algebra ("boolean" unweighted BFS, "tropical"
    (min,+) APSP — weights required, "counting" shortest-path counting
    with (dist, sigma) state).  ``mode`` pins the sweep form — dense (the
    product form) or sparse (the scatter over the lanes) — or lets
    ``auto`` switch per sweep on the engines' occupancy cost model, its
    statistic averaged over the data axes so that every rank picks the
    same form.  ``use_kernel=None`` resolves to "kernels iff the mesh is
    on the card".  ``fused_steps`` fuses sweeps only for the boolean
    dense form on the kernel path at C == 1: vertex sharding needs a
    cross-shard ⊕ between sweeps.
    """
    mode: str = "dense"                # dense | sparse | auto
    semiring: str = "boolean"          # boolean | tropical | counting
    max_sweeps: Optional[int] = None   # alias of max_steps (hop bound)
    # kernel / reference tiling knobs (those of the single-device configs)
    eb: int = 128
    chunk: int = 128
    # auto-mode cost constants (the single-device engines' units)
    c_dense: float = 1.0
    c_sparse: float = 8.0

    _mode_names = SHARDED_FORM_NAMES   # dense | sparse

    def __post_init__(self):
        if self.semiring not in ("boolean", "tropical", "counting"):
            raise ValueError(f"unknown semiring {self.semiring!r}")
        bound = self.max_sweeps if self.max_sweeps is not None \
            else self.max_steps
        object.__setattr__(self, "max_sweeps", bound)
        object.__setattr__(self, "max_steps", bound)
        super().__post_init__()

    @property
    def tropical(self) -> bool:
        return self.semiring == "tropical"

    @property
    def counting(self) -> bool:
        return self.semiring == "counting"

    @property
    def need_dense(self) -> bool:
        return self.mode in ("dense", "auto")

    @property
    def need_sparse(self) -> bool:
        return self.mode in ("sparse", "auto")


class ShardedApspResult(NamedTuple):
    dist: torch.Tensor              # (S, n) int32 boolean / f32 tropical
    sweeps: int                     # equals the single-device count
    direction_counts: torch.Tensor  # (2,) int32 — dense/sparse sweeps run
    # (S, n) f32 shortest-path counts — counting semiring only, else None
    sigma: Optional[torch.Tensor] = None
    # 0-d f32 Eq. 10 work counter summed over the data shards (exact
    # integer partials, so the total does not depend on the mesh shape);
    # the fused loop does not update it
    edges_touched: Optional[torch.Tensor] = None


@dataclasses.dataclass
class ShardedOperands:
    """This rank's operands, built once per (graph, mesh, config) and
    reused across calls (the serving path and the facade cache one)."""
    graph: CSRGraph           # on this rank's device
    mesh: object              # the DeviceMesh
    config: ShardedConfig     # the plan applied
    n_pad: int
    n_shards: int             # model-axis extent C (1 = no vertex sharding)
    m_local: int              # padded CSR lanes of this rank (cost model)
    # this rank's K-row block of the dense operand (None: never dispatched):
    # boolean (n_pad, n_pad / C / 32) packed in-neighbour words on the
    # kernel path, (n_pad / C, n_pad) int8 off it; counting int8 and
    # tropical f32 (+inf non-edges) (n_pad / C, n_pad)
    dense_op: Optional[torch.Tensor]
    src_l: Optional[torch.Tensor]   # this rank's lanes, global ids with
    dst_l: Optional[torch.Tensor]   #   the sentinel n; None: no sparse form
    w_l: Optional[torch.Tensor]     # tropical lane weights (+inf pad)
    w_min: float              # min finite edge weight (tropical; else 0)
    deg: torch.Tensor         # (n_pad,) f32 out-degrees (0 on pad)
    use_kernel: bool = False  # resolved: kernels iff the mesh is on the card
    # the kernels' indexes of dense_op and of the lanes (built once, on the
    # card only; the plain versions take none)
    dense_index: Optional[kernel_common.WordIndex] = dataclasses.field(
        default=None, repr=False)
    lane_index: Optional[kernel_common.LaneIndex] = dataclasses.field(
        default=None, repr=False)

    @property
    def device(self) -> torch.device:
        return self.deg.device


def dp_extent(mesh) -> int:
    """D, the number of source shards: the product of the data axes."""
    return dp_size(mesh)


def _resolve_kernel(mesh, config: ShardedConfig) -> bool:
    """``use_kernel=None`` means kernels iff the mesh is on the card."""
    return mesh.device_type == "cuda" if config.use_kernel is None \
        else bool(config.use_kernel)


# --------------------------------------------------------------------------
# this rank's operands
# --------------------------------------------------------------------------

def _dense_block(g: CSRGraph, n_pad: int, k0: int, nk: int, semiring: str,
                 lanes: Optional[torch.Tensor], packed: bool
                 ) -> torch.Tensor:
    """This rank's K-row block, built on its device from the CSR lanes (a
    rank never builds the whole n_pad^2 operand)."""
    if packed:
        return g.to_pull_packed_block(n_pad, k0, nk)
    # the real lanes whose source lies in rows [k0, k0 + nk)
    keep = (g.src < g.n_nodes) & (g.src >= k0) & (g.src < k0 + nk)
    src, dst = g.src[keep].long() - k0, g.dst[keep].long()
    dev = g.device
    if semiring == "tropical":
        flat = torch.full((nk * n_pad,), INF, dtype=torch.float32,
                          device=dev)
        flat.index_reduce_(0, src * n_pad + dst, lanes[keep], "amin")
        return flat.view(nk, n_pad)
    out = torch.zeros((nk, n_pad), dtype=torch.int8, device=dev)
    out[src, dst] = 1
    return out


def prepare_sharded(g: CSRGraph, mesh, *, weights=None,
                    config: ShardedConfig = ShardedConfig(),
                    dense_op=None) -> ShardedOperands:
    """Pad, partition and place this rank's operands for what ``config``
    can dispatch, on this rank's device of ``mesh``.  ``n_pad`` rounds to
    a multiple of 128·C so the K-row blocks stay tileable; sources and
    node counts that do not divide are padded, as in the engines.  The
    kernels' indexes of the block and of the lanes are built here, once.

    ``dense_op`` hands over an existing operand at C == 1, so that no
    second dense copy is held: the :class:`PreparedGraph` /
    :class:`PreparedWeightedGraph` whose operand this config dispatches
    (``adj_pull`` on the boolean kernel path, ``adj`` off it and for
    counting, ``wdense``) is used with its live-word index on the card."""
    check_mesh(mesh)
    C = mesh_extent(mesh, MODEL_AXIS)
    n_pad = g.n_padded(128 * C)
    # the plan is applied here, where the config is baked into the
    # operands (sharded_apsp refuses config= with prepared operands)
    config = autotune.apply(config, semiring=config.semiring, n_pad=n_pad)
    semiring, tropical = config.semiring, config.tropical
    dev = mesh_device(mesh)
    g = g.to(dev)
    use_kernel = _resolve_kernel(mesh, config)
    on_card = use_kernel and dev.type == "cuda"
    nk = n_pad // C
    c = mesh.get_local_rank(MODEL_AXIS) if C > 1 else 0

    lanes = None
    w_min = 0.0
    if tropical:
        if weights is None:
            raise ValueError("tropical sharding needs edge weights")
        if isinstance(weights, torch.Tensor):
            weights = weights.detach().cpu().numpy()
        w = np.asarray(weights, np.float32)
        if w.ndim != 1 or w.size < g.n_edges:
            raise ValueError(f"need >= {g.n_edges} weights, got shape "
                             f"{w.shape}")
        if not (w[: g.n_edges] >= 0).all():
            raise ValueError("weights must be non-negative (and not NaN)")
        host = np.full(g.m_pad, np.inf, np.float32)
        host[: g.n_edges] = w[: g.n_edges]
        w_min = float(host[: g.n_edges].min()) if g.n_edges else INF
        lanes = torch.from_numpy(host).to(dev)

    # the boolean kernels read packed in-neighbour words
    packed = semiring == "boolean" and use_kernel
    dense_index = None
    if not config.need_dense:
        if dense_op is not None:
            raise ValueError(
                f"prepare_sharded: dense_op= passed but config.mode="
                f"{config.mode!r} never dispatches the dense form — it "
                f"would be silently dropped")
    else:
        if dense_op is None:
            with trace.setup_span("dawn.mesh.block"):
                dense_op = _dense_block(g, n_pad, c * nk, nk, semiring,
                                        lanes, packed)
                if dev.type == "cuda":      # the span holds the build
                    torch.cuda.synchronize(dev)
            trace.gauge("dawn.mesh.block_bytes",
                        dense_op.numel() * dense_op.element_size())
        else:
            want = PreparedWeightedGraph if tropical else PreparedGraph
            if not isinstance(dense_op, want):
                raise TypeError(f"dense_op: a {want.__name__} hands over "
                                f"its operand, got {type(dense_op).__name__}")
            if C > 1:
                raise ValueError("dense_op= hands over a whole operand: "
                                 "meshes without vertex sharding only")
            if not same_device(dense_op.device, dev):
                raise ValueError(f"dense_op: prepared on {dense_op.device}, "
                                 f"the mesh lies on {dev}")
            if dense_op.n_pad != n_pad:
                raise ValueError(f"dense_op: prepared at n_pad "
                                 f"{dense_op.n_pad}, the mesh needs {n_pad}")
            name = "wdense" if tropical else \
                "adj_pull" if packed else "adj"
            dense_index = card_index(dense_op, f"{name}_index", use_kernel)
            dense_op = getattr(dense_op, name)
        if on_card and dense_index is None:
            dense_index = kernel_registry.get(semiring).operand_index(
                dense_op)

    src_l = dst_l = w_l = None
    lane_index = None
    m_local = g.m_pad
    if config.need_sparse:
        if C > 1:
            parts = edge_partition_global(g, C, weights=lanes)
            src_l = parts["src"][c].contiguous()
            dst_l = parts["dst"][c].contiguous()
            if tropical:
                w_l = parts["w"][c].contiguous()
            m_local = parts["e_pad"]
        else:
            src_l, dst_l, w_l = g.src, g.dst, lanes
        if tropical and on_card:
            lane_index = kernel_registry.get(semiring).lane_index(
                src_l, dst_l, w_l, n_pad)

    deg = torch.zeros(n_pad, dtype=torch.float32, device=dev)
    deg[: g.n_nodes] = g.out_degrees().to(torch.float32)
    return ShardedOperands(graph=g, mesh=mesh, config=config, n_pad=n_pad,
                           n_shards=C, m_local=m_local, dense_op=dense_op,
                           src_l=src_l, dst_l=dst_l, w_l=w_l, w_min=w_min,
                           deg=deg, use_kernel=use_kernel,
                           dense_index=dense_index, lane_index=lane_index)


# --------------------------------------------------------------------------
# collectives over the mesh's axes
# --------------------------------------------------------------------------

class _Mesh:
    """The collectives of one mesh over its axes' groups (a DeviceMesh
    has one process group per axis), staged axis by axis.  Every call is
    made on every rank of the mesh, including over axes of extent 1."""

    def __init__(self, mesh):
        import torch.distributed as dist
        self.dist = dist
        names = mesh.mesh_dim_names
        self.groups = {a: mesh.get_group(a) for a in names}
        self.dp = dp_axes(mesh)
        self.local = {a: mesh.get_local_rank(a) for a in names}
        self.extent = {a: mesh_extent(mesh, a) for a in names}

    def dp_index(self) -> int:
        """This rank's source shard: its data-axis coordinates, row-major."""
        idx = 0
        for a in self.dp:
            idx = idx * self.extent[a] + self.local[a]
        return idx

    def reduce(self, x: torch.Tensor, op, axes: Sequence[str]
               ) -> torch.Tensor:
        """All-reduce ``x`` in place over ``axes`` (exact for MIN, MAX and
        integer-valued SUM in any order), each in a ``dawn.mesh.reduce``
        span on the device's clock."""
        for a in axes:
            with trace.device_span("dawn.mesh.reduce", x.device):
                self.dist.all_reduce(x, op=op, group=self.groups[a])
        return x

    def gather(self, x: torch.Tensor, axes: Sequence[str]) -> torch.Tensor:
        """All-gather ``x`` along its first dimension over ``axes``, in
        row-major order of their coordinates (the last axis varies
        fastest), each in a ``dawn.mesh.gather`` span on the device's
        clock; the counter ``dawn.mesh.gather_bytes`` adds the bytes this
        rank receives from the other ranks of the axis."""
        for a in reversed(tuple(axes)):
            out = torch.empty((self.extent[a] * x.shape[0],) + x.shape[1:],
                              dtype=x.dtype, device=x.device)
            with trace.device_span("dawn.mesh.gather", x.device), \
                    warnings.catch_warnings():
                warnings.simplefilter("ignore", FutureWarning)
                self.dist.all_gather_into_tensor(out, x.contiguous(),
                                                 group=self.groups[a])
            trace.count("dawn.mesh.gather_bytes",
                        (self.extent[a] - 1) * x.numel() * x.element_size())
            x = out
        return x

    def reduce_all(self, x: torch.Tensor, op) -> torch.Tensor:
        """All-reduce ``x`` in place over the whole mesh, each axis in turn
        (nobody leaves before everyone came)."""
        return self.reduce(x, op, tuple(self.groups))

    def barrier(self, device: torch.device) -> None:
        """Every rank of the mesh has arrived."""
        self.reduce_all(torch.zeros(1, dtype=torch.int32, device=device),
                        self.dist.ReduceOp.SUM)


def mesh_barrier(mesh) -> None:
    """Block until every rank of ``mesh`` has called this."""
    _Mesh(mesh).barrier(mesh_device(mesh))


def is_mesh_leader(mesh) -> bool:
    """True on the rank at the mesh's origin (coordinate 0 on every axis),
    the one that writes what the mesh shares on disk."""
    return all(c == 0 for c in mesh.get_coordinate())


# --------------------------------------------------------------------------
# the forms of one rank
# --------------------------------------------------------------------------

def _forms(ops: ShardedOperands, comm: _Mesh, s_l: int, n_real: int):
    """(forms, choose, converged, fused, fused_steps, fused_combine) of
    this rank's sweep loop: the reference's ``run_local`` form by form."""
    cfg = ops.config
    dist = comm.dist
    SUM, MIN, MAX = dist.ReduceOp.SUM, dist.ReduceOp.MIN, dist.ReduceOp.MAX
    tropical, counting = cfg.tropical, cfg.counting
    C, n_pad, use_kernel = ops.n_shards, ops.n_pad, ops.use_kernel
    vertex_sharded = C > 1
    nk = n_pad // C
    k0 = comm.local.get(MODEL_AXIS, 0) * nk
    model = (MODEL_AXIS,) if MODEL_AXIS in comm.groups else ()
    dev = ops.device
    bs = min(s_l, 128)
    dense_l = ops.dense_op
    dummy = torch.zeros(1, dtype=torch.int32, device=dev)
    fused = fused_combine = None
    fused_steps_l = 0
    pack = kernel_registry.get("boolean").pack

    def or_combine(new_p):
        """⊕ = OR, bit-packed: all-gather int32 words (n_pad / 8 bytes a
        row, 8x under an int8 MAX) and OR them in group order."""
        with trace.span("dawn.mesh.combine"):
            words = comm.gather(pack(new_p), model)
            words = words.view(C, -1, words.shape[-1])
            acc = words[0]
            for i in range(1, C):
                acc = acc | words[i]
            return unpack_bits(acc, n_pad).to(torch.int8)

    def combine(x, op):
        """⊕ = MIN or SUM: an all-reduce over the ``model`` group."""
        with trace.span("dawn.mesh.combine"):
            return comm.reduce(x, op, model)

    def step_of(d, step):
        return torch.tensor(step, dtype=d.dtype, device=d.device)

    def counting_epilogue(cand_p, d, sg, step):
        """⊕ = masked ADD, the non-idempotent combine: each shard's
        candidate counts are gated to zero where they cannot contribute,
        then SUMMED, so every shortest path is counted exactly once."""
        cand = combine(cand_p, SUM) if vertex_sharded else cand_p
        new = (cand > 0) & (d == UNREACHED)
        return (new.to(torch.int8),
                (torch.where(new, step_of(d, step), d),
                 torch.where(new, cand, sg)))

    def k_block(x):
        return x[:, k0: k0 + nk]

    # ---- dense form: the product over the local K block -----------------
    dense_form = None
    if cfg.need_dense:
        if counting:
            if use_kernel:
                K5 = kernel_registry.get("counting").forms["push"]

                def partial_cand(fs_k, d, sg, step):
                    # rebuild the gated partial from the kernel's epilogue
                    # outputs: where new_p, nsg_p IS cand_p, and the zeros
                    # it drops change no sum
                    new_p, _, nsg_p = K5(fs_k, dense_l, d, sg, step, bs=bs,
                                         bn=cfg.bn, bk=cfg.bk,
                                         index=ops.dense_index)
                    return torch.where(new_p != 0, nsg_p,
                                       torch.zeros((), device=dev))
            else:
                def partial_cand(fs_k, d, sg, step):
                    chunk = S._pull_chunk_size(n_pad, 512)
                    cand = torch.cat(
                        [fs_k @ dense_l[:, j0: j0 + chunk].to(torch.float32)
                         for j0 in range(0, n_pad, chunk)], dim=-1)
                    return torch.where(d == UNREACHED, cand,
                                       torch.zeros((), device=dev))

            if vertex_sharded:
                def dense_form(f, ds, p, step):
                    d, sg = ds
                    fs_k = torch.where(k_block(f) != 0, k_block(sg),
                                       torch.zeros((), device=dev))
                    cand_p = partial_cand(fs_k, d, sg, step)
                    new, ds2 = counting_epilogue(cand_p, d, sg, step)
                    return new, ds2, p
            else:
                dense_form = S.counting_forms(
                    dense_l, dummy, dummy, n_pad=n_pad, s=s_l, bn=cfg.bn,
                    bk=cfg.bk, use_kernel=use_kernel,
                    index=ops.dense_index)[0]
        elif tropical:
            if use_kernel:
                K7 = kernel_registry.get("tropical").forms["dense"]

                def partial_nd(fd_k, d):
                    _, nd = K7(fd_k, dense_l, d, ops.w_min, bs=bs, bn=cfg.bn,
                               bk=cfg.bk, index=ops.dense_index)
                    return nd
            else:
                def partial_nd(fd_k, d):
                    cand = S.minplus_candidates(fd_k, dense_l,
                                                chunk=cfg.chunk)
                    return torch.minimum(d, cand)

            def dense_form(f, d, p, step):
                if vertex_sharded:
                    f, dk = k_block(f), k_block(d)
                else:
                    dk = d
                fd = torch.where(f != 0, dk, torch.full((), INF, device=dev))
                nd = partial_nd(fd, d)
                if vertex_sharded:
                    # ⊕ = min: exact combine of the partials
                    nd = combine(nd, MIN)
                return (nd < d).to(torch.int8), nd, p
        else:
            push = S.boolean_forms(
                None if use_kernel else dense_l,
                dense_l if use_kernel else None, dummy, dummy, n_pad=n_pad,
                s=s_l, bn=cfg.bn, bk=cfg.bk, use_kernel=use_kernel,
                index=ops.dense_index)[S.PUSH]
            if vertex_sharded:
                def dense_form(f, d, p, step):
                    new_p, _, _ = push(k_block(f), d, p, step)
                    # ⊕ = OR: a discovery on any shard counts
                    new = or_combine(new_p)
                    return new, torch.where(new != 0, step_of(d, step), d), p
            else:
                dense_form = push
                if cfg.fused_steps and use_kernel and cfg.mode == "dense":
                    fused_steps_l = S.resolve_fused_steps(
                        "boolean", "push", fused_steps=cfg.fused_steps,
                        max_steps=cfg.max_sweeps or n_real, use_kernel=True,
                        n_pad=n_pad, bs=bs,
                        budget=autotune.fused_budget(cfg, dev)) or 0
                if fused_steps_l:
                    fused = S.fused_form("boolean", dense_l, "push", bs=bs,
                                         max_sweeps=fused_steps_l)

                    def fused_combine(prod, stopped):
                        # the block's scalars must agree on every rank, so
                        # that each takes the same accounting
                        prod = torch.as_tensor(prod, device=dev).to(
                            torch.int32).reshape(1)
                        alive = (~torch.as_tensor(stopped, device=dev)).to(
                            torch.int32).reshape(1)
                        comm.reduce_all(prod, MAX)
                        comm.reduce_all(alive, SUM)
                        return int(prod), int(alive) == 0

    # ---- sparse form: the scatter-⊕ over this rank's lanes --------------
    sparse_form = None
    if cfg.need_sparse:
        src_e, dst_e = ops.src_l, ops.dst_l
        if counting:
            if vertex_sharded:
                src_i, dst_i = src_e.long(), dst_e.long()

                def sparse_form(f, ds, p, step):
                    # each edge lies in exactly one shard's lanes, so the
                    # local scatter-adds sum to the exact path count
                    d, sg = ds
                    f_t, sg_t = f.t(), sg.t()
                    contrib = torch.where(f_t[src_i] != 0, sg_t[src_i],
                                          torch.zeros((), device=dev))
                    cand_p = torch.zeros(sg_t.shape, dtype=sg.dtype,
                                         device=dev)
                    cand_p.index_add_(0, dst_i, contrib)
                    new, ds2 = counting_epilogue(cand_p.t().contiguous(), d,
                                                 sg, step)
                    return new, ds2, p
            else:
                sparse_form = S.counting_forms(
                    None, src_e, dst_e, n_pad=n_pad, s=s_l,
                    use_kernel=False)[1]
        elif tropical:
            _, sparse_c = S.tropical_forms(
                None, src_e, dst_e, ops.w_l, n_pad=n_pad, chunk=cfg.chunk,
                use_kernel=use_kernel, eb=cfg.eb, rindex=ops.lane_index)
            if vertex_sharded:
                def sparse_form(f, d, p, step):
                    _, nd_p, _ = sparse_c(f, d, p, step)
                    nd = combine(nd_p, MIN)
                    return (nd < d).to(torch.int8), nd, p
            else:
                sparse_form = sparse_c
        else:
            sparse_c = S.boolean_forms(None, None, src_e, dst_e, n_pad=n_pad,
                                       s=s_l, use_kernel=False)[S.SPARSE]
            if vertex_sharded:
                def sparse_form(f, d, p, step):
                    new_p, _, _ = sparse_c(f, d, p, step)
                    new = or_combine(new_p)
                    return new, torch.where(new != 0, step_of(d, step), d), p
            else:
                sparse_form = sparse_c

    forms = (dense_form or sparse_form, sparse_form or dense_form)

    choose = None
    if cfg.mode == "auto":
        D = dp_extent(ops.mesh)
        dense_w = torch.tensor(cfg.c_dense * s_l * nk * n_pad,
                               dtype=torch.float32, device=dev)
        sparse_w = torch.tensor(cfg.c_sparse * s_l * ops.m_local,
                                dtype=torch.float32, device=dev)

        def choose(st: S.SweepState) -> int:
            d = st.dist[0] if counting else st.dist
            stats = frontier_stats(
                st.frontier, d, bs=bs, bn=128, bk=128,
                unreached=S.TROPICAL.unreached_mask(d) if tropical
                else None)
            # the form must agree on every rank, or the collectives inside
            # the forms deadlock: the mean over the data shards, summed in
            # float32 in shard order (the JAX executor's pmean)
            vals = comm.gather(stats.live_tile_frac.reshape(1), comm.dp)
            total = vals[0]
            for i in range(1, D):
                total = total + vals[i]
            return int(dense_w * (total / D) > sparse_w)

    def converged(new) -> bool:
        # Fact 1 must fire everywhere at once: reduce over the whole mesh
        flag = new.any().to(torch.int32).reshape(1)
        return int(comm.reduce_all(flag, SUM)) == 0

    return forms, choose, converged, fused, fused_steps_l, fused_combine


# --------------------------------------------------------------------------
# public entry point
# --------------------------------------------------------------------------

def sharded_apsp(g: Union[CSRGraph, ShardedOperands],
                 sources: Optional[Sequence[int]] = None, *,
                 mesh=None, weights=None,
                 config: Optional[ShardedConfig] = None
                 ) -> ShardedApspResult:
    """Multi-device batched APSP through the semiring sweep layer.  Every
    rank of the mesh makes the same call (the module's SPMD contract).

    Pass a :class:`ShardedOperands` (from :func:`prepare_sharded`) to
    reuse this rank's operands across calls; otherwise a
    :class:`CSRGraph` plus ``mesh`` (and ``weights`` for the tropical
    semiring).  Sources are padded up to the data-parallel extent;
    ``dist``, ``sweeps`` and ``sigma`` come back bit-identical to the
    single-device ``apsp_engine`` / ``weighted_apsp`` / ``counting_apsp``
    — the whole (S, n) result on every rank, on its device.
    """
    if isinstance(g, ShardedOperands):
        if mesh is not None or weights is not None or config is not None:
            raise ValueError(
                "sharded_apsp: mesh=/weights=/config= are baked into the "
                "prepared ShardedOperands — passing them alongside would "
                "be silently ignored; call prepare_sharded again instead")
        ops = g
        check_mesh(ops.mesh)
    else:
        if mesh is None:
            raise ValueError("sharded_apsp needs mesh= (or prepared "
                             "ShardedOperands)")
        ops = prepare_sharded(g, mesh, weights=weights,
                              config=config or ShardedConfig())
    graph, cfg = ops.graph, ops.config
    n = graph.n_nodes
    srcs = np.arange(n, dtype=np.int32) if sources is None else \
        np.asarray(sources, np.int32).reshape(-1)
    if srcs.size == 0:
        raise ValueError("sharded_apsp: empty source list")
    if srcs.min() < 0 or srcs.max() >= n:
        raise ValueError(
            f"sharded_apsp: sources must be in [0, {n}), got "
            f"[{srcs.min()}, {srcs.max()}]")
    comm = _Mesh(ops.mesh)
    D = dp_extent(ops.mesh)
    # every data shard gets the same multiple-of-8 (kernel-tileable) row
    # count; above one source tile the local rows must tile by 128
    s_pad = _round_up(len(srcs), D * 8)
    if s_pad // D > 128:
        s_pad = _round_up(s_pad, D * 128)
    s_l = s_pad // D
    lo = comm.dp_index() * s_l
    padded = np.zeros(s_pad, np.int64)
    padded[: len(srcs)] = srcs

    dev, n_pad = ops.device, ops.n_pad
    local = torch.from_numpy(padded[lo: lo + s_l]).to(dev)
    f0 = one_hot_frontier(local, n_pad, dtype=torch.int8)
    row_ok = (torch.arange(lo, lo + s_l, device=dev) < len(srcs))[:, None]
    f0 = torch.where(row_ok, f0, torch.zeros_like(f0))
    if cfg.tropical:
        # pad rows / cols stay +inf with empty frontiers: inert
        dist0 = torch.where(f0 != 0, 0.0, INF).to(torch.float32)
    else:
        dist0 = torch.where(f0 != 0, 0, UNREACHED).to(torch.int32)
        # pad rows / cols are born "visited", as in the engine
        col_ok = torch.arange(n_pad, device=dev)[None, :] < n
        dist0 = torch.where(row_ok & col_ok, dist0, 0).to(torch.int32)
    state0 = dist0
    if cfg.counting:
        state0 = (dist0, torch.where(f0 != 0, 1.0, 0.0).to(torch.float32))

    forms, choose, converged, fused, fused_steps, fused_combine = _forms(
        ops, comm, s_l, n)
    st = S.sweep_loop(forms, S.make_state(f0, state0, n_forms=2),
                      max_steps=cfg.max_sweeps or n, choose=choose,
                      deg=ops.deg,
                      forced_dir=0 if cfg.mode in ("auto", "dense") else 1,
                      converged=converged, fused=fused,
                      fused_steps=fused_steps, fused_combine=fused_combine)
    dist_out, sigma_out = st.dist if cfg.counting else (st.dist, None)
    # the rows of every data shard, in shard order, on every rank
    dist_all = comm.gather(dist_out[:, :n], comm.dp)[: len(srcs)]
    sigma_all = None if sigma_out is None else \
        comm.gather(sigma_out[:, :n], comm.dp)[: len(srcs)]
    # exact integer partials, so the sum matches any row partition; the
    # frontier rows are replicated over model, so every model shard agrees
    edges = comm.reduce(st.edges_touched.reshape(1).clone(),
                        comm.dist.ReduceOp.SUM, comm.dp)[0]
    return ShardedApspResult(dist=dist_all, sweeps=st.step,
                             direction_counts=torch.tensor(
                                 st.dir_counts, dtype=torch.int32),
                             sigma=sigma_all, edges_touched=edges)
