"""Batched centrality analytics on the counting semiring.

The port of ``repro/core/centrality.py``.  Shortest-path *counting* is
the same sweep as BFS under a different algebra: the loop state carries
the pair ``(dist, sigma)`` and ⊕ adds path counts gated on dist ties
(:func:`repro_torch.core.sweep.counting_forms`).  One batched counting
run feeds everything here:

  * **closeness / harmonic** — reduced per source tile from the dist
    rows (integer sufficient statistics in column chunks, finalized in
    float64 on the host);
  * **eccentricity / radius / diameter** — exact per-source max distance
    over reachable targets (sampled bounds in :func:`eccentricity_sample`);
  * **betweenness** — exact Brandes: ``dist`` is the per-level frontier
    record (frontier at level t = ``dist == t``), and
    :func:`brandes_dependencies` walks the levels deepest-first with one
    scatter-add per level.

The forward engine (:func:`counting_apsp`) tiles sources through the ONE
sweep driver in ``core/sweep.py``: push (the f32 counting product — the
K5 kernel on the kernel path, K6 with fused blocks) or sparse
(scatter-add), chosen per sweep by the occupancy cost model or pinned by
a roofline ``TuningPlan`` (``tuning=``) or, without one, per-graph
calibration.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..graph.csr import CSRGraph
from ..launch.mesh import MODEL_AXIS, check_mesh_device, mesh_extent
from . import autotune
from . import sweep as S
from .distributed import ShardedConfig, prepare_sharded, sharded_apsp
from .engine import PreparedGraph, _resolve_kernel, card_index, \
    frontier_stats, prepare_graph
from .frontier import UNREACHED, one_hot_frontier
from .options import SweepOptions
from .sssp import multi_source

PUSH, SPARSE = 0, 1
COUNTING_FORM_NAMES = ("push", "sparse")

MEASURES = ("closeness", "harmonic", "eccentricity", "betweenness")


@dataclasses.dataclass(frozen=True)
class CentralityConfig(SweepOptions):
    """Static counting-engine parameters (a :class:`SweepOptions`
    subclass) — the boolean engine's config with the pull form removed
    (bit-packing does not apply to f32 path counts).

    ``use_kernel=None`` resolves to "kernels iff the operands are on
    CUDA" and ``dynamic=None`` to "per-sweep switching iff on the kernel
    path", as in the boolean engine.
    """
    c_push: float = 1.0              # per f32 MAC in a live push tile
    c_sparse: float = 8.0            # per CSR gather + scatter-add lane

    _mode_names = COUNTING_FORM_NAMES  # push | sparse


class CountingResult(NamedTuple):
    dist: torch.Tensor              # (S, n) int32, -1 unreachable
    sigma: torch.Tensor             # (S, n) f32 shortest-path counts
    sweeps: int                     # max sweeps over batches
    direction_counts: torch.Tensor  # (2,) int32 — push/sparse sweeps run


class CentralityResult(NamedTuple):
    """One batched analytics run.  Per-source arrays align with
    ``sources``; ``betweenness`` is over ALL nodes (the dependency sums
    contributed by the requested sources — exact betweenness when the
    sources cover every node, a source-sampled estimate otherwise).
    ``radius``/``diameter`` are exact under the same condition.
    ``sigma_checksum`` is the sum of shortest-path counts over reachable
    pairs — a deterministic work fingerprint (0.0 when betweenness was not
    requested)."""
    sources: np.ndarray
    closeness: Optional[np.ndarray]     # (S,) float64
    harmonic: Optional[np.ndarray]      # (S,) float64
    eccentricity: Optional[np.ndarray]  # (S,) int32
    betweenness: Optional[np.ndarray]   # (n,) float64
    radius: Optional[int]
    diameter: Optional[int]
    sweeps: int
    sigma_checksum: float


# --------------------------------------------------------------------------
# the batched counting engine (forward Brandes stage)
# --------------------------------------------------------------------------

def _run_counting_batch(adj, src_idx, dst_idx, deg, sources: torch.Tensor,
                        n_valid: int, *, cfg: CentralityConfig, n_real: int,
                        n_pad: int, max_steps: int, use_kernel: bool,
                        forced_dir: Optional[int],
                        fused_steps: int = 0, index=None) -> S.SweepState:
    s = sources.shape[0]
    m_pad = src_idx.shape[0]
    bs = min(s, 128)
    dev = deg.device

    f0 = one_hot_frontier(sources, n_pad, dtype=torch.int8)
    row_ok = (torch.arange(s, device=dev) < n_valid)[:, None]
    f0 = torch.where(row_ok, f0, torch.zeros_like(f0))
    dist0 = torch.where(f0 != 0, 0, UNREACHED).to(torch.int32)
    # pad rows/cols are born "visited" with sigma 0: no sweep form ever
    # discovers them, so they stay inert in both halves of the state
    col_ok = torch.arange(n_pad, device=dev)[None, :] < n_real
    dist0 = torch.where(row_ok & col_ok, dist0, 0).to(torch.int32)
    sigma0 = (f0 != 0).to(torch.float32)

    forms = S.counting_forms(adj, src_idx, dst_idx, n_pad=n_pad, s=s,
                             bn=cfg.bn, bk=cfg.bk, use_kernel=use_kernel,
                             index=index)

    choose = None
    if forced_dir is None:
        # each constant is rounded to f32 before it scales the f32
        # statistic (JAX's weak typing); a tie goes to push (strict >)
        push_w = torch.tensor(cfg.c_push * s * n_pad * n_pad,
                              dtype=torch.float32, device=dev)
        sparse_c = torch.tensor(cfg.c_sparse * s * m_pad,
                                dtype=torch.float32, device=dev)

        def choose(st: S.SweepState) -> int:
            stats = frontier_stats(st.frontier, st.dist[0], bs=bs, bn=128,
                                   bk=128)
            return int(push_w * stats.live_tile_frac > sparse_c)

    fused = None
    if fused_steps:  # resolved upstream: kernel path, push pinned
        fused = S.fused_form("counting", adj, "push", bs=bs,
                             max_sweeps=fused_steps, index=index)

    st0 = S.make_state(f0, (dist0, sigma0), n_forms=2)
    return S.sweep_loop(forms, st0, max_steps=max_steps, deg=deg,
                        choose=choose,
                        forced_dir=0 if forced_dir is None else forced_dir,
                        fused=fused, fused_steps=fused_steps)


def measure_counting_costs(pg: PreparedGraph, s: int,
                           cfg: CentralityConfig, *,
                           use_kernel: bool = False) -> Tuple[float, float]:
    """Wall-clock one mid-run sweep of each counting form on this graph
    (the counterpart of ``engine.measure_sweep_costs``; cached on the
    prepared graph under a counting-tagged key)."""
    key = ("counting", s, cfg.bn, cfg.bk, use_kernel)
    if key in pg.cost_cache:
        return pg.cost_cache[key]
    n_pad = pg.n_pad
    f = torch.zeros((s, n_pad), dtype=torch.int8, device=pg.device)
    f[:, ::17] = 1
    dist = torch.full((s, n_pad), UNREACHED, dtype=torch.int32,
                      device=pg.device)
    dist[:, ::4] = 1
    sigma = (dist >= 0).to(torch.float32)
    forms = S.counting_forms(pg.adj, pg.graph.src, pg.graph.dst,
                             n_pad=n_pad, s=s, bn=cfg.bn, bk=cfg.bk,
                             use_kernel=use_kernel,
                             index=card_index(pg, "adj_index",
                                              use_kernel))
    result = S.time_sweep_forms(forms, f, (dist, sigma))
    pg.cost_cache[key] = result
    return result


def _resolve_counting_direction(pg: PreparedGraph, s: int,
                                cfg: CentralityConfig,
                                use_kernel: bool) -> Optional[int]:
    """None -> per-sweep dynamic switch; int -> form fixed per batch.
    An explicit ``mode=`` wins, then the dynamic switch, then a
    TuningPlan's argmin, then wall-clock calibration (see
    ``engine._resolve_direction``)."""
    if cfg.mode != "auto":
        return COUNTING_FORM_NAMES.index(cfg.mode)
    dynamic = use_kernel if cfg.dynamic is None else cfg.dynamic
    if dynamic:
        return None
    if cfg.tuning is not None:
        pinned = cfg.tuning.pinned_direction(
            "counting", s=s, n_pad=pg.n_pad, m_pad=pg.graph.m_pad)
        if pinned is not None:
            return pinned
    return int(np.argmin(measure_counting_costs(pg, s, cfg,
                                                use_kernel=use_kernel)))


def counting_apsp_blocks(g: Union[CSRGraph, PreparedGraph],
                         sources: Optional[Sequence[int]] = None, *,
                         config: CentralityConfig = CentralityConfig()):
    """Stream (source_ids, dist_rows, sigma_rows, raw_state) one source
    tile at a time through the counting engine.  A bare CSRGraph is
    prepared on the device it lives on."""
    pg = g if isinstance(g, PreparedGraph) else \
        prepare_graph(g, device=g.device)
    config = autotune.apply(config, semiring="counting", n_pad=pg.n_pad)
    graph = pg.graph
    n = graph.n_nodes
    srcs = np.arange(n, dtype=np.int32) if sources is None else \
        np.asarray(sources, np.int32).reshape(-1)
    if srcs.size == 0:
        raise ValueError("counting_apsp: empty source list")
    if srcs.min() < 0 or srcs.max() >= n:
        raise ValueError(
            f"counting_apsp: sources must be in [0, {n}), got "
            f"[{srcs.min()}, {srcs.max()}]")
    use_kernel = _resolve_kernel(pg, config)
    max_steps = config.max_steps or n
    B = config.source_batch
    forced = _resolve_counting_direction(pg, B, config, use_kernel)
    fused_steps = 0
    if config.fused_steps and forced in (None, PUSH):
        fused_steps = S.resolve_fused_steps(
            "counting", "push", fused_steps=config.fused_steps,
            max_steps=max_steps, use_kernel=use_kernel, n_pad=pg.n_pad,
            bs=min(B, 128),
            budget=autotune.fused_budget(config, pg.device)) or 0
        if fused_steps:
            forced = PUSH       # fused blocks pin the push form
    # the dense operand only materializes when push can dispatch, and its
    # live-word index when a push kernel (K5 or the fused K6) does so on
    # the card
    adj = pg.adj if forced in (None, PUSH) else None
    index = card_index(pg, "adj_index", use_kernel and adj is not None)
    for lo in range(0, len(srcs), B):
        block = srcs[lo: lo + B]
        valid = len(block)
        padded = np.zeros(B, np.int64)
        padded[:valid] = block
        st = _run_counting_batch(adj, graph.src, graph.dst, pg.deg,
                                 torch.from_numpy(padded).to(pg.device),
                                 valid, cfg=config, n_real=n, n_pad=pg.n_pad,
                                 max_steps=max_steps, use_kernel=use_kernel,
                                 forced_dir=forced, fused_steps=fused_steps,
                                 index=index)
        dist, sigma = st.dist
        yield block, dist[:valid, :n], sigma[:valid, :n], st


def counting_apsp(g: Union[CSRGraph, PreparedGraph],
                  sources: Optional[Sequence[int]] = None, *,
                  config: CentralityConfig = CentralityConfig()
                  ) -> CountingResult:
    """Materialized batched (dist, sigma) — BFS levels plus exact
    shortest-path counts for every requested source."""
    dist_rows, sig_rows = [], []
    sweeps = 0
    counts = [0, 0]
    for _, dist, sigma, st in counting_apsp_blocks(g, sources,
                                                   config=config):
        dist_rows.append(dist)
        sig_rows.append(sigma)
        sweeps = max(sweeps, st.step)
        counts = [a + b for a, b in zip(counts, st.dir_counts)]
    return CountingResult(dist=torch.cat(dist_rows, dim=0),
                          sigma=torch.cat(sig_rows, dim=0), sweeps=sweeps,
                          direction_counts=torch.tensor(counts,
                                                        dtype=torch.int32))


# --------------------------------------------------------------------------
# Brandes backward dependency accumulation
# --------------------------------------------------------------------------

def _brandes_backward(src_idx: torch.Tensor, dst_idx: torch.Tensor,
                      dist: torch.Tensor, sigma: torch.Tensor,
                      max_level: int) -> torch.Tensor:
    """Batched Brandes dependencies delta (S, n) from (dist, sigma).

    ``dist`` is the per-level frontier record, so the backward pass walks
    levels deepest-first: for every edge (u, v) with ``dist[v] == dist[u]
    + 1 == t``,

        delta[u] += sigma[u] / sigma[v] * (1 + delta[v])

    as one frontier-masked scatter-add over the padded CSR lanes per
    level: a 1-D ``index_add_`` along the node axis of the transposed
    (n + 1, S) state.  delta[v] of a level-t node is final once every
    deeper level has run."""
    s, n = dist.shape
    dev = dist.device
    # sentinel column: padded lanes carry src = dst = n; level -2 never
    # matches a real level, so their contributions are exactly zero
    d = torch.cat([dist, torch.full((s, 1), -2, dtype=torch.int32,
                                    device=dev)], dim=1).t().contiguous()
    sg = torch.cat([sigma, torch.ones((s, 1), dtype=torch.float32,
                                      device=dev)], dim=1).t().contiguous()
    delta = torch.zeros_like(sg)                         # (n + 1, S)
    src_l, dst_l = src_idx.long(), dst_idx.long()
    # loop-invariant lane gathers: levels and sigma never change during
    # the backward pass, only delta does
    du, dv = d[src_l], d[dst_l]                          # (m_pad, S)
    sg_src = sg[src_l]
    sg_floor = torch.clamp(sg, min=1.0)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    for i in range(max_level):
        t = max_level - i
        on_level = (du == t - 1) & (dv == t)
        coeff = (1.0 + delta) / sg_floor
        contrib = torch.where(on_level, sg_src * coeff[dst_l], zero)
        delta.index_add_(0, src_l, contrib)
    return delta[:n].t()


def brandes_dependencies(g: CSRGraph, dist: torch.Tensor,
                         sigma: torch.Tensor) -> torch.Tensor:
    """Dependency accumulation delta[s, v] = sum_t sigma_st(v) / sigma_st
    for a block of sources, from the counting engine's (dist, sigma)."""
    max_level = max(int(dist.max()), 0) if dist.numel() else 0
    return _brandes_backward(g.src, g.dst, dist, sigma, max_level)


# --------------------------------------------------------------------------
# per-tile reductions
# --------------------------------------------------------------------------

# column-chunked partial sums: one chunk's int32 distance total is bounded
# by CHUNK * diameter, so the int32 accumulator cannot wrap for any graph
# whose dense operand fits in memory; the (S, n/CHUNK) partials finalize
# in int64/float64 on the host
_REDUCE_CHUNK = 4096


def _reduce_block(dist: torch.Tensor):
    """Per-source sufficient statistics from one (B, n) dist tile: reach
    count r-1 (int32), column-chunked distance totals (int32 partials,
    exact) and harmonic partials (f32 over <= 4096 terms each),
    eccentricity (int32).  Totals combine on the host in int64/float64 —
    see :func:`centrality`."""
    s, n = dist.shape
    reach = dist > 0
    n_reach = reach.sum(dim=1).to(torch.int32)
    ecc = torch.where(reach, dist, 0).amax(dim=1).to(torch.int32)
    k = -(-n // _REDUCE_CHUNK)
    pad = k * _REDUCE_CHUNK - n
    dpad = torch.nn.functional.pad(dist, (0, pad))   # pad dist 0: unreached
    dch = dpad.reshape(s, k, _REDUCE_CHUNK)
    rch = dch > 0
    tot_p = torch.where(rch, dch, 0).sum(dim=2, dtype=torch.int32)
    har_p = torch.where(rch, 1.0 / torch.clamp(dch, min=1), 0.0).sum(dim=2)
    return n_reach, tot_p, har_p, ecc


def _sigma_checksum_block(dist: torch.Tensor, sigma: torch.Tensor) -> float:
    """Sum of path counts over reachable pairs (f32) — the deterministic
    work fingerprint."""
    return float(torch.where(dist >= 0, sigma, 0.0).sum())


# --------------------------------------------------------------------------
# the public analytics driver
# --------------------------------------------------------------------------

def centrality(g: Union[CSRGraph, PreparedGraph],
               sources: Optional[Sequence[int]] = None, *,
               measures: Sequence[str] = MEASURES,
               config: Optional[CentralityConfig] = None,
               mesh=None,
               method: str = "auto") -> CentralityResult:
    """One batched analytics run computing every requested measure.

    ``sources=None`` runs all nodes (exact betweenness / radius /
    diameter); a subset gives source-restricted sums (the standard
    source-sampled betweenness estimator, unscaled).  When betweenness
    is requested the forward pass runs the counting engine; otherwise the
    boolean engine serves the dist rows (``method`` picks its path, as in
    :func:`repro_torch.core.sssp.multi_source`).  ``mesh=`` runs the
    forward pass through the sharded executor instead
    (:mod:`repro_torch.core.distributed`; every rank of the mesh makes
    the same call and folds the whole result)."""
    measures = tuple(measures)
    unknown = set(measures) - set(MEASURES)
    if unknown:
        raise ValueError(f"unknown measures {sorted(unknown)}; "
                         f"available: {MEASURES}")
    pg = g if isinstance(g, PreparedGraph) else \
        prepare_graph(g, device=g.device)
    graph = pg.graph
    n = graph.n_nodes
    srcs = np.arange(n, dtype=np.int32) if sources is None else \
        np.asarray(sources, np.int32).reshape(-1)
    if srcs.size == 0:
        raise ValueError("centrality: empty source list")
    if srcs.min() < 0 or srcs.max() >= n:
        raise ValueError(
            f"centrality: sources must be in [0, {n}), got "
            f"[{srcs.min()}, {srcs.max()}]")
    config = config or CentralityConfig(
        source_batch=min(128, max(8, ((len(srcs) + 7) // 8) * 8)))
    need_sigma = "betweenness" in measures

    n_reach = np.zeros(len(srcs), np.int64)
    tot = np.zeros(len(srcs), np.int64)
    har = np.zeros(len(srcs), np.float64)
    ecc = np.zeros(len(srcs), np.int32)
    bc = np.zeros(n, np.float64) if need_sigma else None
    sweeps = 0
    checksum = 0.0

    def fold(lo, block, dist, sigma):
        nonlocal checksum
        hi = lo + len(block)
        r_b, t_p, h_p, e_b = _reduce_block(dist)
        n_reach[lo:hi] = r_b.cpu().numpy()
        # chunked partials -> exact int64 / float64 totals on the host
        tot[lo:hi] = t_p.cpu().numpy().astype(np.int64).sum(axis=1)
        har[lo:hi] = h_p.cpu().numpy().astype(np.float64).sum(axis=1)
        ecc[lo:hi] = e_b.cpu().numpy()
        if need_sigma:
            checksum += _sigma_checksum_block(dist, sigma)
            delta = brandes_dependencies(graph, dist, sigma) \
                .cpu().numpy().astype(np.float64)
            bc_local = delta.sum(axis=0)
            # Brandes never adds a source's own delta row at the source
            np.subtract.at(bc_local, block,
                           delta[np.arange(len(block)), block])
            bc[:] += bc_local

    if mesh is not None:
        check_mesh_device(mesh, pg.device)
        # honor the caller's form choice: the sharded executor names the
        # product form "dense" where the counting engine says "push";
        # "auto" keeps the per-sweep cost-model switch
        mode = {"push": "dense", "sparse": "sparse",
                "auto": "auto"}[config.mode]
        cfg = ShardedConfig(semiring="counting" if need_sigma
                            else "boolean", mode=mode,
                            use_kernel=config.use_kernel,
                            max_sweeps=config.max_steps, bn=config.bn,
                            bk=config.bk)
        # without vertex sharding the prepared graph's dense operand is
        # the block: hand it over instead of building a second copy
        hand_over = cfg.need_dense and mesh_extent(mesh, MODEL_AXIS) == 1
        res = sharded_apsp(prepare_sharded(
            graph, mesh, config=cfg, dense_op=pg if hand_over else None),
            srcs)
        sweeps = res.sweeps
        B = config.source_batch
        for lo in range(0, len(srcs), B):
            block = srcs[lo: lo + B]
            fold(lo, block, res.dist[lo: lo + len(block)],
                 res.sigma[lo: lo + len(block)] if need_sigma else None)
    elif need_sigma:
        lo = 0
        for block, dist, sigma, st in counting_apsp_blocks(
                pg, srcs, config=config):
            sweeps = max(sweeps, int(st.step))
            fold(lo, block, dist, sigma)
            lo += len(block)
    else:
        B = config.source_batch
        for lo in range(0, len(srcs), B):
            block = srcs[lo: lo + B]
            res = multi_source(pg, block, method=method, parents=False)
            sweeps = max(sweeps, int(res.eccentricity))
            fold(lo, block, res.dist, None)

    # finalize in float64 from the exact integer statistics —
    # Wasserman-Faust normalized closeness for disconnected graphs
    frac = n_reach.astype(np.float64) / max(n - 1, 1)
    clo = np.where(tot > 0,
                   frac * n_reach / np.maximum(tot, 1).astype(np.float64),
                   0.0)

    reach_any = ecc > 0
    return CentralityResult(
        sources=srcs,
        closeness=clo if "closeness" in measures else None,
        harmonic=har if "harmonic" in measures else None,
        eccentricity=ecc if "eccentricity" in measures else None,
        betweenness=bc,
        radius=int(ecc[reach_any].min()) if ("eccentricity" in measures
                                             and reach_any.any()) else
        (0 if "eccentricity" in measures else None),
        diameter=int(ecc.max()) if "eccentricity" in measures else None,
        sweeps=sweeps,
        sigma_checksum=checksum,
    )


# --------------------------------------------------------------------------
# per-measure entry points
# --------------------------------------------------------------------------

def _block_config(block: int) -> CentralityConfig:
    return CentralityConfig(source_batch=max(8, ((block + 7) // 8) * 8)
                            if block <= 128 else
                            ((block + 127) // 128) * 128)


def closeness(g: Union[CSRGraph, PreparedGraph],
              sources: Optional[np.ndarray] = None, *,
              block: int = 128, method: str = "auto") -> np.ndarray:
    """Closeness centrality C(u) = (r-1) / sum_v d(u,v) over reachable v
    (Wasserman-Faust normalized for disconnected graphs)."""
    return centrality(g, sources, measures=("closeness",),
                      config=_block_config(block), method=method).closeness


def harmonic(g: Union[CSRGraph, PreparedGraph],
             sources: Optional[np.ndarray] = None, *,
             block: int = 128, method: str = "auto") -> np.ndarray:
    """Harmonic centrality H(u) = sum_{v != u} 1/d(u,v)."""
    return centrality(g, sources, measures=("harmonic",),
                      config=_block_config(block), method=method).harmonic


def betweenness(g: Union[CSRGraph, PreparedGraph],
                sources: Optional[np.ndarray] = None, *,
                normalized: bool = False,
                config: Optional[CentralityConfig] = None,
                mesh=None) -> np.ndarray:
    """Exact betweenness centrality (Brandes, directed, endpoints
    excluded) via the counting semiring.  ``sources`` restricts the
    dependency sums (source-sampled estimate); ``normalized=True``
    divides by (n-1)(n-2)."""
    res = centrality(g, sources, measures=("betweenness",), config=config,
                     mesh=mesh)
    bc = res.betweenness
    n = bc.shape[0]
    if normalized and n > 2:
        bc = bc / float((n - 1) * (n - 2))
    return bc


def eccentricity(g: Union[CSRGraph, PreparedGraph],
                 sources: Optional[np.ndarray] = None, *,
                 config: Optional[CentralityConfig] = None,
                 mesh=None) -> dict:
    """Exact eccentricities (over reachable targets) plus radius /
    diameter — exact when ``sources`` covers every node (the default)."""
    res = centrality(g, sources, measures=("eccentricity",), config=config,
                     mesh=mesh)
    return {"ecc": res.eccentricity, "radius": res.radius,
            "diameter": res.diameter}


def eccentricity_sample(g: CSRGraph, n_samples: int = 64, *,
                        seed: int = 0, method: str = "auto") -> dict:
    """Sampled eccentricities -> (radius_upper, diameter_lower) estimates
    from a random source set.  For exact values use :func:`eccentricity`."""
    rng = np.random.default_rng(seed)
    sources = rng.integers(0, g.n_nodes, n_samples)
    res = centrality(g, sources, measures=("eccentricity",), method=method)
    ecc_arr = res.eccentricity
    return {"radius_upper": int(ecc_arr[ecc_arr > 0].min())
            if (ecc_arr > 0).any() else 0,
            "diameter_lower": int(ecc_arr.max()),
            "ecc_mean": float(ecc_arr.mean())}
