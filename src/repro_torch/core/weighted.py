"""Weighted-graph DAWN: the tropical (min,+) engine.

The port of ``repro/core/weighted.py``.  The same direction-optimizing
batch driver that picks boolean sweep forms picks between the tropical
forms (``core/sweep.py::tropical_forms``):

  DENSE  — the f32 min-plus analogue of the boolean push
           (``cand[s, j] = min_k dist[s, k] + W[k, j]`` over frontier
           rows; cost proportional to the live tile fraction); on the
           kernel path the dense min-plus kernel K7 with settled-bound
           tile skipping, or K8 with fused blocks;
  SPARSE — edge-parallel scatter-min relaxation over CSR lanes (cost
           O(S · m_pad) in the model); kernel path: the sparse relax
           kernel K9, a gather over each target's in-lanes

— chosen per sweep by the occupancy cost model (dynamic regime) or pinned
per graph by a roofline ``TuningPlan`` (``tuning=``; ``core/autotune.py``)
or, without one, by wall-clock calibration of both forms (reference
path), as in ``core/engine.py``.  Public entry points:

  * ``minplus_sssp``   — single-source (min,+) sweeps through the shared
                         driver (frontier-gated Bellman-Ford);
  * ``weighted_apsp``  — batched multi-source tropical APSP with the
                         direction optimizer;
  * ``bucketed_sssp``  — small integer weights via unit-hop expansion
                         through the unweighted sweep machinery.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..graph.csr import CSRGraph, resolve_device
from ..kernels import common as kernel_common
from ..kernels import registry as kernel_registry
from . import autotune
from . import sweep as S
from .engine import _resolve_kernel, card_index, frontier_stats
from .frontier import one_hot_frontier
from .options import SweepOptions
from .sovm import sovm_sssp

INF = float("inf")

DENSE, SPARSE = 0, 1
WEIGHTED_FORM_NAMES = ("dense", "sparse")


class WeightedResult(NamedTuple):
    dist: torch.Tensor           # (n,) float32; inf = unreachable
    sweeps: int


class WeightedApspResult(NamedTuple):
    dist: torch.Tensor              # (S, n) float32; inf = unreachable
    sweeps: int                     # max sweeps over batches
    direction_counts: torch.Tensor  # (2,) int32 — dense/sparse sweeps run
    edges_touched: torch.Tensor     # 0-d float32 — relaxed-edge counter


@dataclasses.dataclass(frozen=True)
class WeightedConfig(SweepOptions):
    """Static tropical-engine parameters (a :class:`SweepOptions`
    subclass).

    Cost-model units: ``c_dense`` per f32 add+min lane in a live dense
    tile, ``c_sparse`` per CSR relax lane — the boolean engine's model
    with the pull form removed (bit-packing does not apply to f32
    distances).

    ``use_kernel=None`` resolves to "kernels iff the operands are on
    CUDA" and ``dynamic=None`` to "per-sweep switching iff on the kernel
    path", as in the boolean engine.

    ``max_sweeps`` is this engine's spelling of the base ``max_steps``
    hop bound; setting either sets both.
    """
    source_batch: int = 64           # sources per tile (multiple of 8)
    max_sweeps: Optional[int] = None  # alias of max_steps (hop bound)
    chunk: int = 128                 # dense reference: dst cols per step
    eb: int = 128                    # sparse relax kernel lane block
    c_dense: float = 1.0
    c_sparse: float = 8.0

    _mode_names = WEIGHTED_FORM_NAMES  # dense | sparse

    def __post_init__(self):
        # fold the two spellings of the hop bound into one value
        bound = self.max_sweeps if self.max_sweeps is not None \
            else self.max_steps
        object.__setattr__(self, "max_sweeps", bound)
        object.__setattr__(self, "max_steps", bound)
        super().__post_init__()


@dataclasses.dataclass
class PreparedWeightedGraph:
    """Device-resident tropical operands (the dense O(n_pad^2) form and
    the kernels' indexes are built lazily)."""
    graph: CSRGraph
    w_edges: torch.Tensor  # (m_pad,) float32; +inf on padded lanes
    deg: torch.Tensor      # (n_pad,) float32 out-degrees (0 on pad)
    n_pad: int
    epoch: int = 0         # content epoch of the source graph (0 = static)
    cost_cache: dict = dataclasses.field(default_factory=dict, repr=False)
    _wdense: Optional[torch.Tensor] = dataclasses.field(default=None,
                                                        repr=False)
    _wdense_index: Optional[kernel_common.WordIndex] = dataclasses.field(
        default=None, repr=False)
    _relax_index: Optional[kernel_common.LaneIndex] = dataclasses.field(
        default=None, repr=False)

    @property
    def device(self) -> torch.device:
        return self.deg.device

    @property
    def wdense(self) -> torch.Tensor:
        """(n_pad, n_pad) f32 weight matrix, +inf non-edges (the dense
        operand; parallel edges resolve to the min weight), built on the
        device by one scatter-min over the flattened lane positions."""
        if self._wdense is None:
            g, n_pad = self.graph, self.n_pad
            flat = torch.full((n_pad * n_pad,), INF, dtype=torch.float32,
                              device=self.device)
            flat.index_reduce_(0, g.src.long() * n_pad + g.dst.long(),
                               self.w_edges, "amin")
            self._wdense = flat.view(n_pad, n_pad)
        return self._wdense

    @property
    def wdense_index(self) -> kernel_common.WordIndex:
        """Live-word index of ``wdense``: per row, the 16-byte words
        holding a finite weight (the dense min-plus kernel reads only
        those).  Built once, from the operand, by the tropical kernel
        set's builder; it is not rebuilt if ``wdense`` is changed in
        place."""
        if self._wdense_index is None:
            self._wdense_index = kernel_registry.get("tropical") \
                .operand_index(self.wdense)
        return self._wdense_index

    @property
    def relax_index(self) -> kernel_common.LaneIndex:
        """In-lane index of the weighted CSR lanes (their CSC: per target,
        its in-lanes' sources and weights), which the sparse relax kernel
        gathers over.  Built once, from the lanes and never from
        ``wdense`` (a sparse-only run never builds the dense operand), by
        the tropical kernel set's builder; it is not rebuilt if the lanes
        are changed in place."""
        if self._relax_index is None:
            g = self.graph
            self._relax_index = kernel_registry.get("tropical").lane_index(
                g.src, g.dst, self.w_edges, self.n_pad)
        return self._relax_index


def prepare_weighted(g, weights=None, *, align: int = 128,
                     device=None) -> PreparedWeightedGraph:
    """Normalize weights to the padded edge lanes and build the O(n)
    operands on ``device`` (``None``: the card); the dense weight matrix
    materializes lazily.  ``weights`` holds at least ``n_edges``
    non-negative values in lane order (numpy or a tensor); entries past
    ``n_edges`` are ignored.

    Accepts a :class:`CSRGraph` (``weights`` required) or a weighted
    :class:`repro_torch.graph.dynamic.DynamicCSRGraph` (lane weights come
    from its merged view; the content ``epoch`` is recorded, so that
    callers can tell a stale prepared graph from a current one)."""
    epoch = 0
    if hasattr(g, "view"):            # DynamicCSRGraph duck-type
        epoch = int(g.epoch)
        if weights is None:
            weights = g.view_weights()
        g = g.view()
    if weights is None:
        raise ValueError("prepare_weighted needs edge weights")
    if isinstance(weights, torch.Tensor):
        weights = weights.detach().cpu().numpy()
    w = np.asarray(weights, np.float32)
    if w.ndim != 1 or w.size < g.n_edges:
        raise ValueError(f"need >= {g.n_edges} weights, got shape "
                         f"{w.shape}")
    if not (w[: g.n_edges] >= 0).all():
        raise ValueError("weights must be non-negative (and not NaN)")
    g = g.to(resolve_device(device))
    lanes = np.full(g.m_pad, np.inf, np.float32)
    lanes[: g.n_edges] = w[: g.n_edges]
    n_pad = g.n_padded(align)
    deg = torch.zeros(n_pad, dtype=torch.float32, device=g.device)
    deg[: g.n_nodes] = g.out_degrees().to(torch.float32)
    return PreparedWeightedGraph(graph=g,
                                 w_edges=torch.from_numpy(lanes).to(g.device),
                                 deg=deg, n_pad=n_pad, epoch=epoch)


# --------------------------------------------------------------------------
# single-source (min,+) sweeps
# --------------------------------------------------------------------------

def minplus_sssp(g: CSRGraph, weights, source, *,
                 max_sweeps: Optional[int] = None) -> WeightedResult:
    """(min,+) sweep SSSP through the shared driver, on the graph's
    device.  weights (m_pad,) float32 >= 0 (numpy or a tensor; padded
    entries are ignored via the +inf mask)."""
    n = g.n_nodes
    dev = g.device
    max_sweeps = n if max_sweeps is None else max_sweeps
    src = int(source)
    dist0 = torch.full((n + 1,), INF, dtype=torch.float32, device=dev)
    dist0[src] = 0.0
    f0 = torch.zeros(n + 1, dtype=torch.int8, device=dev)
    f0[src] = 1
    w = torch.as_tensor(weights, dtype=torch.float32, device=dev)
    w = torch.where(g.src < n, w, torch.full((), INF, device=dev))

    _, sparse = S.tropical_forms(None, g.src, g.dst, w)
    st = S.sweep_loop((sparse,), S.make_state(f0, dist0, n_forms=1),
                      max_steps=max_sweeps)
    return WeightedResult(st.dist[:n], st.sweeps)


# --------------------------------------------------------------------------
# batched direction-optimizing tropical APSP
# --------------------------------------------------------------------------

def _run_weighted_batch(wdense, src_idx, dst_idx, w_edges, deg,
                        sources: torch.Tensor, n_valid: int, *,
                        cfg: WeightedConfig, n_pad: int, max_sweeps: int,
                        use_kernel: bool, forced_dir: Optional[int],
                        fused_steps: int = 0,
                        windex: Optional[kernel_common.WordIndex] = None,
                        rindex: Optional[kernel_common.LaneIndex] = None
                        ) -> S.SweepState:
    s = sources.shape[0]
    m_pad = src_idx.shape[0]
    bs = min(s, 128)
    dev = deg.device

    f0 = one_hot_frontier(sources, n_pad, dtype=torch.int8)
    row_ok = (torch.arange(s, device=dev) < n_valid)[:, None]
    f0 = torch.where(row_ok, f0, torch.zeros_like(f0))
    # pad rows/cols stay +inf with empty frontiers: no candidate ever
    # improves them, so they are inert without masks
    dist0 = torch.where(f0 != 0, 0.0, INF).to(torch.float32)

    forms = S.tropical_forms(wdense, src_idx, dst_idx, w_edges, n_pad=n_pad,
                             chunk=cfg.chunk, use_kernel=use_kernel,
                             bn=cfg.bn, bk=cfg.bk, eb=cfg.eb, windex=windex,
                             rindex=rindex)
    if forms[0] is None:
        forms = (forms[1], forms[1])  # sparse pinned; keep switch arity 2

    choose = None
    if forced_dir is None:
        # each constant is rounded to f32 before it scales the f32
        # statistic (JAX's weak typing); a tie goes to dense (strict >)
        dense_w = torch.tensor(cfg.c_dense * s * n_pad * n_pad,
                               dtype=torch.float32, device=dev)
        sparse_c = torch.tensor(cfg.c_sparse * s * m_pad,
                                dtype=torch.float32, device=dev)

        def choose(st: S.SweepState) -> int:
            stats = frontier_stats(
                st.frontier, st.dist, bs=bs, bn=128, bk=128,
                unreached=S.TROPICAL.unreached_mask(st.dist))
            return int(dense_w * stats.live_tile_frac > sparse_c)

    fused = None
    if fused_steps:  # resolved upstream: kernel path, dense pinned
        fused = S.fused_form("tropical", wdense, "dense", bs=bs,
                             max_sweeps=fused_steps, index=windex)

    st0 = S.make_state(f0, dist0, n_forms=2)
    return S.sweep_loop(forms, st0, max_steps=max_sweeps, deg=deg,
                        choose=choose,
                        forced_dir=0 if forced_dir is None else forced_dir,
                        fused=fused, fused_steps=fused_steps)


def measure_weighted_costs(pw: PreparedWeightedGraph, s: int,
                           cfg: WeightedConfig, *,
                           use_kernel: bool = False) -> Tuple[float, float]:
    """Wall-clock one mid-run sweep of each tropical form on this graph
    (the counterpart of ``engine.measure_sweep_costs``; cached on the
    prepared graph).  Times the closures ``_run_weighted_batch`` will
    dispatch (kernel or reference, per ``use_kernel``)."""
    key = (s, cfg.chunk, cfg.bn, cfg.bk, cfg.eb, use_kernel)
    if key in pw.cost_cache:
        return pw.cost_cache[key]
    n_pad = pw.n_pad
    f = torch.zeros((s, n_pad), dtype=torch.int8, device=pw.device)
    f[:, ::17] = 1
    dist = torch.full((s, n_pad), INF, dtype=torch.float32,
                      device=pw.device)
    dist[:, ::4] = 1.0
    forms = S.tropical_forms(pw.wdense, pw.graph.src, pw.graph.dst,
                             pw.w_edges, n_pad=n_pad, chunk=cfg.chunk,
                             use_kernel=use_kernel, bn=cfg.bn, bk=cfg.bk,
                             eb=cfg.eb,
                             windex=card_index(pw, "wdense_index",
                                               use_kernel),
                             rindex=card_index(pw, "relax_index",
                                               use_kernel))
    result = S.time_sweep_forms(forms, f, dist)
    pw.cost_cache[key] = result
    return result


def _resolve_weighted_direction(pw: PreparedWeightedGraph, s: int,
                                cfg: WeightedConfig,
                                use_kernel: bool) -> Optional[int]:
    """None -> per-sweep dynamic switch; int -> form fixed per batch.
    An explicit ``mode=`` wins, then the dynamic switch, then a
    TuningPlan's argmin, then wall-clock calibration (see
    ``engine._resolve_direction``)."""
    if cfg.mode != "auto":
        return WEIGHTED_FORM_NAMES.index(cfg.mode)
    dynamic = use_kernel if cfg.dynamic is None else cfg.dynamic
    if dynamic:
        return None
    if cfg.tuning is not None:
        pinned = cfg.tuning.pinned_direction(
            "tropical", s=s, n_pad=pw.n_pad, m_pad=pw.graph.m_pad)
        if pinned is not None:
            return pinned
    return int(np.argmin(measure_weighted_costs(pw, s, cfg,
                                                use_kernel=use_kernel)))


def weighted_apsp(g: Union[CSRGraph, PreparedWeightedGraph],
                  weights=None,
                  sources: Optional[Sequence[int]] = None, *,
                  config: WeightedConfig = WeightedConfig()
                  ) -> WeightedApspResult:
    """Batched multi-source tropical APSP with direction optimization.

    Pass a :class:`PreparedWeightedGraph` (weights=None) to reuse
    operands and the calibration cache across calls; a bare CSRGraph is
    prepared on the device it lives on.  Distances are float32 with +inf
    for unreachable targets.
    """
    pw = g if isinstance(g, PreparedWeightedGraph) else \
        prepare_weighted(g, weights, device=g.device)
    config = autotune.apply(config, semiring="tropical", n_pad=pw.n_pad)
    graph = pw.graph
    n = graph.n_nodes
    srcs = np.arange(n, dtype=np.int32) if sources is None else \
        np.asarray(sources, np.int32).reshape(-1)
    if srcs.size == 0:
        raise ValueError("weighted_apsp: empty source list")
    if srcs.min() < 0 or srcs.max() >= n:
        raise ValueError(
            f"weighted_apsp: sources must be in [0, {n}), got "
            f"[{srcs.min()}, {srcs.max()}]")
    max_sweeps = config.max_sweeps or n
    B = config.source_batch
    use_kernel = _resolve_kernel(pw, config)
    forced = _resolve_weighted_direction(pw, B, config, use_kernel)
    fused_steps = 0
    if config.fused_steps and forced in (None, DENSE):
        fused_steps = S.resolve_fused_steps(
            "tropical", "dense", fused_steps=config.fused_steps,
            max_steps=max_sweeps, use_kernel=use_kernel, n_pad=pw.n_pad,
            bs=min(B, 128),
            budget=autotune.fused_budget(config, pw.device)) or 0
        if fused_steps:
            forced = DENSE      # fused blocks pin the dense form
    # only materialize the O(n_pad^2) dense operand when it can dispatch,
    # and its live-word index when a dense kernel (K7 or the fused K8)
    # does so on the card; the in-lane index when K9 can
    wdense = pw.wdense if forced in (None, DENSE) else None
    windex = card_index(pw, "wdense_index",
                        use_kernel and wdense is not None)
    rindex = card_index(pw, "relax_index",
                        use_kernel and forced in (None, SPARSE))

    rows = []
    sweeps = 0
    counts = [0, 0]
    touched = torch.zeros((), dtype=torch.float32, device=pw.device)
    for lo in range(0, len(srcs), B):
        block = srcs[lo: lo + B]
        valid = len(block)
        padded = np.zeros(B, np.int64)
        padded[:valid] = block
        st = _run_weighted_batch(wdense, graph.src, graph.dst, pw.w_edges,
                                 pw.deg,
                                 torch.from_numpy(padded).to(pw.device),
                                 valid, cfg=config, n_pad=pw.n_pad,
                                 max_sweeps=max_sweeps,
                                 use_kernel=use_kernel, forced_dir=forced,
                                 fused_steps=fused_steps, windex=windex,
                                 rindex=rindex)
        rows.append(st.dist[:valid, :n])
        sweeps = max(sweeps, st.step)
        counts = [a + b for a, b in zip(counts, st.dir_counts)]
        touched = touched + st.edges_touched
    return WeightedApspResult(dist=torch.cat(rows, dim=0), sweeps=sweeps,
                              direction_counts=torch.tensor(
                                  counts, dtype=torch.int32),
                              edges_touched=touched)


# --------------------------------------------------------------------------
# small-integer weights through the unweighted machinery
# --------------------------------------------------------------------------

def expand_integer_weights(g: CSRGraph, weights) -> CSRGraph:
    """Unit-hop expansion: a weight-w edge (u -> v) becomes a path
    u -> x_1 -> ... -> x_{w-1} -> v of unit edges (built on the host, put
    on the graph's device)."""
    src, dst = g.edge_arrays_np()
    if isinstance(weights, torch.Tensor):
        weights = weights.detach().cpu().numpy()
    weights = np.asarray(weights[: g.n_edges], dtype=np.int64)
    if not (weights >= 1).all():
        raise ValueError("integer weights must be >= 1")
    n = g.n_nodes
    new_src, new_dst = [], []
    next_virtual = n
    for u, v, w in zip(src, dst, weights):
        if w == 1:
            new_src.append(u)
            new_dst.append(v)
            continue
        chain = [u] + list(range(next_virtual, next_virtual + w - 1)) + [v]
        next_virtual += w - 1
        for a, b in zip(chain[:-1], chain[1:]):
            new_src.append(a)
            new_dst.append(b)
    return CSRGraph.from_edges(np.asarray(new_src), np.asarray(new_dst),
                               next_virtual, dedup=False, device=g.device)


def bucketed_sssp(g: CSRGraph, weights, source: int) -> WeightedResult:
    """Small-integer-weight SSSP through the unweighted SOVM machinery."""
    eg = expand_integer_weights(g, weights)
    st = sovm_sssp(eg, source)
    d = st.dist[: g.n_nodes]
    dist = torch.where(d < 0, torch.full((), INF, device=d.device),
                       d.to(torch.float32))
    return WeightedResult(dist, st.sweeps)


def dijkstra_oracle(g: CSRGraph, weights, source: int) -> np.ndarray:
    """scipy Dijkstra reference (float64) for tests."""
    import scipy.sparse as sp
    import scipy.sparse.csgraph as csgraph
    src, dst = g.edge_arrays_np()
    if isinstance(weights, torch.Tensor):
        weights = weights.detach().cpu().numpy()
    mat = sp.csr_matrix((np.asarray(weights[: g.n_edges], np.float64),
                         (src, dst)), shape=(g.n_nodes, g.n_nodes))
    return csgraph.dijkstra(mat, indices=source, directed=True)
