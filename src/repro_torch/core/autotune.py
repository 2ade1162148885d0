"""Roofline autotuner: a deterministic plan of tiles, the fused gate and
the direction-switch costs (the port of ``repro/core/autotune.py``).

Two knobs decide what a sweep costs: the fused multi-sweep gate and the
per-sweep push/pull/sparse choice — the occupancy cost model on the
kernel path, *wall-clock calibration* (``sweep.time_sweep_forms``) on
the reference path.  The calibration is the one non-deterministic choice
in the engines: two identical ``mode="auto"`` runs may pin different
directions and report different ``direction_counts``.

:func:`build_plan` replaces both with a static roofline model:

  * a :class:`BackendProfile` supplies peak FLOP/s, HBM bandwidth and the
    per-block shared-memory budget (a table keyed on the device type; the
    card's row holds ``launch/mesh.py``'s H100 constants);
  * per-(semiring, form) *unit costs* — seconds per modelled work unit —
    come from the op counts of one plain sweep of each form
    (``launch/op_analysis.analyze_callable`` counts flops and bytes,
    ``launch/roofline.roofline_terms`` turns them into a roofline-bound
    time; deterministic, unlike a timer), or from a static fallback that
    keeps the engines' historical cost-constant ratios;
  * :func:`tune_tiles` picks the tiles and gates ``fused_steps`` on the
    fused kernels' shared memory.

The result is a frozen, hashable, JSON-serializable :class:`TuningPlan`
whose JSON the JAX package reads, and the reverse.  ``SweepOptions.tuning``
carries it into every engine config; each engine calls :func:`apply`
(tile/constant overlay, clamped to the graph's padding) and consults
:meth:`TuningPlan.pinned_direction` where it would wall-clock-calibrate,
so ``mode="auto"`` is a pure function of (plan, graph shape, batch).
Precedence: an explicit ``mode=`` beats the dynamic switch, which beats
the plan, which beats calibration.

Import discipline: this module sits below the engines (it imports
options / sweep / kernels / launch); ``engine`` / ``weighted`` /
``centrality`` import it and name their semiring.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..graph.csr import resolve_device
from ..kernels import common as kernel_common
from ..kernels import registry as kernel_registry
from ..launch.mesh import HBM_BW, PEAK_FLOPS_BF16
from ..launch.op_analysis import analyze_callable
from ..launch.roofline import roofline_terms
from . import sweep as S
from .frontier import UNREACHED
from .options import SweepOptions

__all__ = ["BackendProfile", "GraphStats", "TuningPlan", "FORM_VOCAB",
           "backend_profile", "device_fingerprint", "graph_stats",
           "form_units", "tune_tiles", "build_plan", "apply"]

PLAN_VERSION = 1

# the forms each semiring's engine dispatches, in that engine's direction
# indexing (boolean == sweep.DIRECTION_NAMES, tropical ==
# weighted.WEIGHTED_FORM_NAMES, counting == centrality.COUNTING_FORM_NAMES)
FORM_VOCAB: Dict[str, Tuple[str, ...]] = {
    "boolean": ("push", "pull", "sparse"),
    "tropical": ("dense", "sparse"),
    "counting": ("push", "sparse"),
}

# engine-config cost-constant field per form name
_COST_FIELDS = {"push": "c_push", "pull": "c_pull", "sparse": "c_sparse",
                "dense": "c_dense"}

# static fallback ratio of each form's per-unit cost to the GEMM form's
# (the engines' historical c_* defaults: dense MAC 1, word/lane 8)
_STATIC_RATIO = {"push": 1.0, "dense": 1.0, "pull": 8.0, "sparse": 8.0}


# --------------------------------------------------------------------------
# backend profiles
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class BackendProfile:
    """Roofline constants for one device class.

    ``name`` is the device fingerprint the plan is locked to;
    ``vmem_budget`` keeps the JAX package's name and holds the per-block
    shared-memory budget the fused kernels must fit on the card (the JAX
    package's per-core VMEM budget).
    """
    name: str
    peak_flops: float
    hbm_bw: float
    vmem_budget: int


# Static table keyed on the device type.  The card's row is the H100 of
# launch/mesh.py; the CPU row keeps the JAX package's CPU figures (they
# only need to rank the plain forms sanely).  Both carry the card's
# shared-memory budget, so a plan built on the CPU gates fusion as the
# card would.
STATIC_PROFILES: Dict[str, BackendProfile] = {
    "cuda": BackendProfile("cuda", PEAK_FLOPS_BF16, HBM_BW,
                           kernel_common.SMEM_BUDGET_BYTES),
    "cpu": BackendProfile("cpu", 2.0e11, 5.0e10,
                          kernel_common.SMEM_BUDGET_BYTES),
}


def device_fingerprint(device=None) -> str:
    """``type:name`` of ``device`` (``None``: the card) — the identity a
    saved plan refuses to load across: ``"cuda:" +`` the card's name, or
    ``"cpu:cpu"``, the JAX package's CPU fingerprint."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        return f"cuda:{torch.cuda.get_device_name(dev)}"
    return f"{dev.type}:{dev.type}"


def backend_profile(fingerprint: Optional[str] = None) -> BackendProfile:
    """Profile for ``fingerprint`` (default: the card's), from the static
    table keyed on its device-type prefix."""
    fp = fingerprint or device_fingerprint()
    base = STATIC_PROFILES.get(fp.split(":", 1)[0], STATIC_PROFILES["cpu"])
    return dataclasses.replace(base, name=fp)


# --------------------------------------------------------------------------
# graph statistics (the tuner's view of a graph)
# --------------------------------------------------------------------------

class GraphStats(NamedTuple):
    """Shape/occupancy summary a plan records as provenance."""
    n_nodes: int
    n_edges: int
    n_pad: int
    m_pad: int
    avg_degree: float
    max_degree: int


def _graph_of(g):
    """The CSRGraph behind a CSRGraph / DynamicCSRGraph / prepared graph."""
    graph = getattr(g, "graph", g)
    if hasattr(graph, "view"):               # DynamicCSRGraph duck-type
        graph = graph.view()
    return graph


def graph_stats(g) -> GraphStats:
    """Stats for a ``CSRGraph`` / ``DynamicCSRGraph`` / prepared graph
    (anything with ``.graph`` or the CSR surface itself)."""
    pg_n_pad = getattr(g, "n_pad", None)
    graph = _graph_of(g)
    n_pad = pg_n_pad if pg_n_pad is not None else graph.n_padded(128)
    deg = graph.out_degrees()
    return GraphStats(
        n_nodes=int(graph.n_nodes), n_edges=int(graph.n_edges),
        n_pad=int(n_pad), m_pad=int(graph.m_pad),
        avg_degree=float(graph.n_edges / max(graph.n_nodes, 1)),
        max_degree=int(deg.max()) if deg.numel() else 0)


def form_units(form: str, *, s: int, n_pad: int, m_pad: int) -> float:
    """Modelled work units of one sweep in ``form`` — the same counts the
    engines' dynamic cost model uses (engine.sweep_costs), evaluated at
    full occupancy: dense product elements for push/dense, 32-bit words
    for pull, padded CSR lanes for sparse."""
    if form in ("push", "dense"):
        return float(s) * n_pad * n_pad
    if form == "pull":
        return float(s) * n_pad * max(n_pad // 32, 1)
    if form == "sparse":
        return float(s) * m_pad
    raise ValueError(f"unknown form {form!r}")


# --------------------------------------------------------------------------
# the plan
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class TuningPlan:
    """Serializable tuner output: tile sizes, the fused-steps gate, and
    per-(semiring, form) switch costs.  Frozen and hashable — it rides
    inside the engines' configs.

    ``unit_costs`` is ``((semiring, form, seconds_per_unit), ...)``;
    :meth:`pinned_direction` turns it into the deterministic replacement
    for wall-clock calibration.  ``source`` records whether the costs
    came from op counts ("ops"; the JAX package's plans say "hlo") or the
    static fallback ("static").
    """
    backend: str                  # device fingerprint the plan is locked to
    vmem_budget: int              # bytes; per-block shared-memory budget
                                  # the fused gate was fit against
    peak_flops: float
    hbm_bw: float
    bs: int                       # source tile (informational; engines cap
                                  # at min(batch, 128) as always)
    bn: int                       # output-column tile
    bk: int                       # contraction tile
    fused_steps: int              # -1 = fuse whole fixpoint, 0 = leave off
    unit_costs: Tuple[Tuple[str, str, float], ...]
    graph: GraphStats             # provenance: the graph it was built on
    source: str = "static"        # "ops" | "hlo" | "static"
    version: int = PLAN_VERSION

    # -- cost queries ------------------------------------------------------

    def unit_cost(self, semiring: str, form: str) -> Optional[float]:
        for sr, f, c in self.unit_costs:
            if sr == semiring and f == form:
                return c
        return None

    def covers(self, semiring: str) -> bool:
        """True when every form the semiring dispatches has a cost."""
        return all(self.unit_cost(semiring, f) is not None
                   for f in FORM_VOCAB.get(semiring, ()))

    def pinned_direction(self, semiring: str, *, s: int, n_pad: int,
                         m_pad: int) -> Optional[int]:
        """argmin form index for a whole batch — the deterministic
        replacement for the calibrated (wall-clock) regime.  Index is in
        the semiring engine's own direction order (FORM_VOCAB).  Returns
        None when the plan lacks a cost for some form."""
        vocab = FORM_VOCAB.get(semiring)
        if not vocab or not self.covers(semiring):
            return None
        costs = [self.unit_cost(semiring, f)
                 * form_units(f, s=s, n_pad=n_pad, m_pad=m_pad)
                 for f in vocab]
        return int(np.argmin(costs))

    # -- budget validation -------------------------------------------------

    def validate(self, n_pad: Optional[int] = None) -> None:
        """Check what the kernel sets price: with ``fused_steps`` on, one
        block of every registered fused kernel must fit ``vmem_budget``
        at ``n_pad`` (default: the build graph's).  Raises ValueError on
        the first that does not.  The per-sweep kernels size their own
        tiles, so ``bn`` / ``bk`` carry no budget."""
        if not self.fused_steps:
            return
        n = self.graph.n_pad if n_pad is None else n_pad
        for semiring in sorted(kernel_registry.available()):
            ks = kernel_registry.get(semiring)
            for form in ks.fused_forms:
                need = ks.smem_bytes(form="fused", bs=self.bs, n=n)
                if need > self.vmem_budget:
                    raise ValueError(
                        f"TuningPlan fused_steps={self.fused_steps} blows "
                        f"the shared-memory budget for {semiring}/fused:"
                        f"{form} at n_pad={n}: {need} > "
                        f"{self.vmem_budget} bytes")

    # -- serialization -----------------------------------------------------

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["graph"] = list(self.graph)
        d["unit_costs"] = [list(uc) for uc in self.unit_costs]
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "TuningPlan":
        d = dict(d)
        version = int(d.get("version", 0))
        if version != PLAN_VERSION:
            raise ValueError(
                f"TuningPlan version {version} != {PLAN_VERSION}")
        d["graph"] = GraphStats(*d["graph"])
        d["unit_costs"] = tuple(
            (str(sr), str(f), float(c)) for sr, f, c in d["unit_costs"])
        return cls(**d)

    def checksum(self) -> str:
        """Stable content hash (the bench gate's hard field)."""
        payload = json.dumps(self.to_dict(), sort_keys=True)
        return hashlib.sha256(payload.encode()).hexdigest()[:16]

    def save(self, path) -> None:
        with open(path, "w") as f:
            json.dump(self.to_dict(), f, indent=1, sort_keys=True)

    @classmethod
    def load(cls, path, *, allow_mismatch: bool = False,
             device=None) -> "TuningPlan":
        """Load a saved plan; refuses a plan built for another device
        fingerprint than ``device``'s (``None``: the card) unless
        ``allow_mismatch=True`` (tile and threshold choices do not
        transfer across device classes)."""
        with open(path) as f:
            plan = cls.from_dict(json.load(f))
        here = device_fingerprint(device)
        if not allow_mismatch and plan.backend != here:
            raise ValueError(
                f"TuningPlan backend fingerprint {plan.backend!r} does "
                f"not match this device ({here!r}); pass "
                f"allow_mismatch=True to override")
        return plan


# --------------------------------------------------------------------------
# tile tuning and the fused gate
# --------------------------------------------------------------------------

def _fused_fits(bs: int, n_pad: int, budget: int) -> bool:
    for semiring in kernel_registry.available():
        ks = kernel_registry.get(semiring)
        if ks.fused_forms and ks.smem_bytes(
                form="fused", bs=bs, n=n_pad) > budget:
            return False
    return True


def tune_tiles(profile: BackendProfile, *, n_pad: int
               ) -> Tuple[int, int, int, int]:
    """(bs, bn, bk, fused_steps) for ``n_pad`` under the profile's budget.

    The per-sweep CUDA kernels size their own tiles, so nothing bounds
    ``bn`` / ``bk``: each is the largest candidate that divides ``n_pad``.
    They reach only the occupancy statistics of the dynamic switch
    (``engine.frontier_stats``) and the plain versions' skip tables, as
    in the JAX package.  ``fused_steps=-1`` iff one block of every fused
    kernel fits the budget (``KernelSet.smem_bytes(form="fused")``), else
    0 — the per-sweep path."""
    bs = kernel_common.ALIGN
    tile = kernel_common.tile_candidates(n_pad)[0]
    fused = -1 if _fused_fits(bs, n_pad, profile.vmem_budget) else 0
    return bs, tile, tile, fused


def fused_budget(cfg: SweepOptions, device) -> Optional[int]:
    """The shared-memory budget an engine hands ``resolve_fused_steps``:
    none without a plan, else the plan's — on the card at most the card's
    own, so a foreign plan (the JAX package's 16 MB) never admits a block
    the card cannot launch."""
    if cfg.tuning is None:
        return None
    budget = int(cfg.tuning.vmem_budget)
    if torch.device(device).type == "cuda":
        budget = min(budget, kernel_common.smem_limit())
    return budget


# --------------------------------------------------------------------------
# unit-cost extraction
# --------------------------------------------------------------------------

def _static_unit_costs(profile: BackendProfile
                       ) -> Tuple[Tuple[str, str, float], ...]:
    """Fallback costs: the engines' historical cost-constant ratios
    converted to seconds-per-unit on this profile (2 flops per MAC) —
    deterministic and rank-preserving with the old defaults."""
    mac = 2.0 / profile.peak_flops
    return tuple((sr, f, _STATIC_RATIO[f] * mac)
                 for sr in sorted(FORM_VOCAB)
                 for f in FORM_VOCAB[sr])


def _representative_state(s: int, n_pad: int, dtype, unreached,
                          visited_val, device):
    """The same mid-sweep occupancy the calibration uses: ~6% frontier,
    ~25% visited."""
    f = torch.zeros((s, n_pad), dtype=torch.int8, device=device)
    f[:, ::17] = 1
    dist = torch.full((s, n_pad), unreached, dtype=dtype, device=device)
    dist[:, ::4] = visited_val
    return f, dist


def _form_seconds(form, frontier, state, profile: BackendProfile
                  ) -> Optional[float]:
    """Roofline-bound seconds of one sweep of ``form``, from its exact op
    counts — None when the form fails to run or counts nothing (the
    caller keeps the static cost)."""
    parent = torch.zeros((1,), dtype=torch.int32, device=frontier.device)
    try:
        stats = analyze_callable(lambda fr, st, p: form(fr, st, p, 1),
                                 frontier, state, parent)
    except Exception:
        return None
    if stats.flops <= 0 and stats.bytes_accessed <= 0:
        return None
    terms = roofline_terms(stats.flops, stats.bytes_accessed,
                           peak_flops=profile.peak_flops,
                           hbm_bw=profile.hbm_bw)
    return max(terms["t_compute_s"], terms["t_memory_s"], 1e-12)


def _op_unit_costs(pg, profile: BackendProfile, *, weights, s: int
                   ) -> Dict[Tuple[str, str], float]:
    """Per-(semiring, form) seconds-per-unit from one plain sweep of each
    form at a representative state, on the prepared graph's device.
    Tropical forms are priced only when ``weights`` are given (their
    dense operand is n_pad^2 float32)."""
    g = pg.graph
    n_pad = pg.n_pad
    dev = pg.device
    units = {f: form_units(f, s=s, n_pad=n_pad, m_pad=g.m_pad)
             for forms in FORM_VOCAB.values() for f in forms}
    out: Dict[Tuple[str, str], float] = {}

    f0, dist = _representative_state(s, n_pad, torch.int32, UNREACHED, 1,
                                     dev)
    bool_forms = S.boolean_forms(pg.adj, pg.adj_pull, g.src, g.dst,
                                 n_pad=n_pad, s=s)
    for name, form in zip(FORM_VOCAB["boolean"], bool_forms):
        t = _form_seconds(form, f0, dist, profile)
        if t is not None:
            out[("boolean", name)] = t / units[name]

    sigma = (dist >= 0).to(torch.float32)
    cnt_forms = S.counting_forms(pg.adj, g.src, g.dst, n_pad=n_pad, s=s)
    for name, form in zip(FORM_VOCAB["counting"], cnt_forms):
        t = _form_seconds(form, f0, (dist, sigma), profile)
        if t is not None:
            out[("counting", name)] = t / units[name]

    if weights is not None:
        from .weighted import prepare_weighted
        pw = prepare_weighted(g, weights, device=dev)
        fw, dw = _representative_state(s, n_pad, torch.float32,
                                       float("inf"), 1.0, dev)
        trop_forms = S.tropical_forms(pw.wdense, g.src, g.dst, pw.w_edges,
                                      n_pad=n_pad)
        for name, form in zip(FORM_VOCAB["tropical"], trop_forms):
            t = _form_seconds(form, fw, dw, profile)
            if t is not None:
                out[("tropical", name)] = t / units[name]
    return out


# --------------------------------------------------------------------------
# plan construction + config overlay
# --------------------------------------------------------------------------

def build_plan(g, *, weights=None, profile: Optional[BackendProfile] = None,
               source_batch: int = 8, use_hlo: bool = True) -> TuningPlan:
    """Build a :class:`TuningPlan` for graph ``g`` (CSRGraph /
    DynamicCSRGraph / PreparedGraph).

    ``use_hlo=True`` (the JAX package's keyword) prices each plain sweep
    form from its op counts (exact flop/byte counts -> roofline time;
    deterministic) on ``g``'s device, at ``source_batch`` rows, falling
    back per form to the static table when a form fails; ``False`` skips
    that — cheapest, fully static, still deterministic.  ``weights``
    enables tropical-form pricing.  ``profile`` defaults to the profile
    of ``g``'s device.
    """
    from .engine import PreparedGraph, prepare_graph
    device = g.device if isinstance(g, PreparedGraph) else \
        _graph_of(g).device
    prof = profile or backend_profile(device_fingerprint(device))
    stats = graph_stats(g)
    bs, bn, bk, fused = tune_tiles(prof, n_pad=stats.n_pad)
    costs = {(sr, f): c for sr, f, c in _static_unit_costs(prof)}
    source = "static"
    if use_hlo:
        pg = g if isinstance(g, PreparedGraph) else \
            prepare_graph(g, device=device)
        measured = _op_unit_costs(pg, prof, weights=weights,
                                  s=source_batch)
        if measured:
            costs.update(measured)
            source = "ops"
    plan = TuningPlan(
        backend=prof.name, vmem_budget=prof.vmem_budget,
        peak_flops=prof.peak_flops, hbm_bw=prof.hbm_bw,
        bs=bs, bn=bn, bk=bk, fused_steps=fused,
        unit_costs=tuple((sr, f, costs[(sr, f)])
                         for sr in sorted(FORM_VOCAB)
                         for f in FORM_VOCAB[sr]),
        graph=stats, source=source)
    plan.validate()
    return plan


def _cost_overrides(plan: TuningPlan, semiring: str, fields) -> dict:
    """Normalized cost-constant overlays for an engine config: each
    form's per-unit cost relative to the GEMM form's (so the overlay has
    the same scale as the hand-set defaults).  A target with no
    ``c_push`` takes push as ``c_dense``."""
    vocab = FORM_VOCAB[semiring]
    base = plan.unit_cost(semiring, vocab[0])
    if not base:
        return {}
    out = {}
    for form in vocab:
        c = plan.unit_cost(semiring, form)
        if c is None:
            continue
        fld = _COST_FIELDS[form]
        if fld not in fields and form == "push" and "c_dense" in fields:
            fld = "c_dense"
        if fld in fields:
            out[fld] = float(c / base)
    return out


def apply(cfg: SweepOptions, *, semiring: str,
          n_pad: Optional[int] = None) -> SweepOptions:
    """Overlay ``cfg.tuning`` onto an engine config: tile sizes (clamped
    back to ALIGN when they don't divide this graph's ``n_pad``), the
    fused-steps gate (only when the caller left ``fused_steps`` at its 0
    default — an explicit request wins), and the dynamic cost model's
    constants.  A config with no plan passes through unchanged.
    """
    plan = cfg.tuning
    if plan is None or semiring not in FORM_VOCAB:
        return cfg
    fields = {f.name for f in dataclasses.fields(type(cfg))}
    kw = {}
    bn, bk = plan.bn, plan.bk
    if n_pad is not None:
        if n_pad % bn:
            bn = kernel_common.ALIGN
        if n_pad % bk:
            bk = kernel_common.ALIGN
    if "bn" in fields:
        kw["bn"] = bn
    if "bk" in fields:
        kw["bk"] = bk
    if "fused_steps" in fields and cfg.fused_steps == 0 and plan.fused_steps:
        kw["fused_steps"] = plan.fused_steps
    kw.update(_cost_overrides(plan, semiring, fields))
    return dataclasses.replace(cfg, **kw) if kw else cfg
