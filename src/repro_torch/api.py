"""The ``dawn`` facade of the port: one handle over a prepared graph.

    import repro_torch as dawn

    h = dawn.prepare(graph)                 # operands on the card
    d = h.sssp(0)                           # one dist row
    res = h.apsp(sources)                   # batched engine result
    h = dawn.prepare(graph, weights=w)      # lane weights: tropical
    res = h.apsp(sources, semiring="tropical")
    job = h.apsp(sources, checkpoint_dir=d) # resumable chunked job
    svc = h.serve(n_landmarks=16)           # tiered GraphService
    res = h.apsp(sources, mesh=mesh)        # the sharded executor

    h = dawn.prepare(dyn)                   # DynamicCSRGraph
    h.insert_edges([u], [v])                # mutation passthrough
    d = h.sssp(0)                           # fresh epoch, same call
    inc = h.incremental(sources)            # streaming repair driver

``prepare`` puts the graph's operands on ``device`` (``None``: the card;
pass ``device="cpu"`` for the CPU) and raises when CUDA is missing and
the CPU was not asked for.  The handle is epoch-aware: on a
:class:`DynamicCSRGraph` the prepared operands (and the kernels' indexes
built from them) are dropped and rebuilt whenever the graph's content
epoch has moved.

Every query method takes ``mesh=``: a
:class:`torch.distributed.device_mesh.DeviceMesh` from
:func:`repro_torch.launch.mesh.make_mesh` routes the call through the
sharded executor (:mod:`repro_torch.core.distributed`).  Its contract is
SPMD: every rank of the mesh makes the same call and gets the whole
result back.  The mesh's device must be the handle's.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Optional, Sequence, Union

import torch

from . import trace
from .core.autotune import TuningPlan, build_plan
from .core.centrality import MEASURES, CentralityConfig, CentralityResult
from .core.centrality import centrality as _centrality
from .core.centrality import counting_apsp as _counting_apsp
from .core.distributed import ShardedConfig, prepare_sharded
from .core.distributed import sharded_apsp as _sharded_apsp
from .core.engine import EngineConfig, PreparedGraph, prepare_graph
from .core.engine import apsp_engine as _apsp_engine
from .core.incremental import IncrementalSSSP
from .core.jobs import run_sweep_job
from .core.options import SweepOptions
from .core.weighted import (PreparedWeightedGraph, WeightedConfig,
                            prepare_weighted)
from .core.weighted import weighted_apsp as _weighted_apsp
from .graph.csr import CSRGraph, resolve_device, same_device
from .graph.dynamic import DynamicCSRGraph
from .launch.mesh import check_mesh_device
from .serve.engine import GraphService

SEMIRING_NAMES = ("boolean", "tropical", "counting")


class DawnGraph:
    """Prepared-graph handle returned by :func:`prepare`.  The operands
    are built lazily on the handle's device and, on a mutable graph,
    rebuilt when its content epoch has moved."""

    def __init__(self, graph: Union[CSRGraph, DynamicCSRGraph], *,
                 weights=None, options: Optional[SweepOptions] = None,
                 device=None):
        if isinstance(graph, DynamicCSRGraph) and weights is not None:
            raise ValueError(
                "weights= with a DynamicCSRGraph is ambiguous — build the "
                "dynamic graph with weights instead")
        self.device = resolve_device(device)
        if isinstance(graph, DynamicCSRGraph) and not same_device(
                graph.device, self.device):
            # its views, and the repair state of incremental(), lie on
            # the dynamic graph's own device
            raise ValueError(
                f"the DynamicCSRGraph lies on {graph.device}, the handle on "
                f"{self.device}: build it from a graph on the handle's "
                f"device")
        self.graph = graph
        self.options = options or SweepOptions()
        self._weights = weights
        self._pg: Optional[PreparedGraph] = None
        self._pw: Optional[PreparedWeightedGraph] = None
        self._sharded = {}       # semiring -> ShardedOperands
        self._sharded_mesh = None
        self._sharded_epoch = -1

    # -- epoch-aware operand cache ----------------------------------------

    @property
    def epoch(self) -> int:
        return int(getattr(self.graph, "epoch", 0))

    @property
    def mutable(self) -> bool:
        return isinstance(self.graph, DynamicCSRGraph)

    def _lane_weights(self):
        if self._weights is not None:
            return self._weights
        if self.mutable and self.graph.weighted:
            return self.graph.view_weights()
        return None

    def prepared(self) -> PreparedGraph:
        """The current epoch's :class:`PreparedGraph` (boolean and
        counting operands) on the device.  A compaction alone keeps it:
        the content is the same."""
        if self._pg is None or self._pg.epoch != self.epoch:
            self._pg = None             # drop the stale operands first
            self._pg = prepare_graph(self.graph, device=self.device)
        return self._pg

    def prepared_weighted(self) -> PreparedWeightedGraph:
        """The current epoch's :class:`PreparedWeightedGraph` (tropical
        operands) on the device; needs the ``weights=`` given to
        :func:`prepare` or a weighted dynamic graph."""
        w = self._lane_weights()
        if w is None:
            raise ValueError("tropical semiring needs weights: "
                             "prepare(graph, weights=...) or a weighted "
                             "DynamicCSRGraph")
        if self._pw is None or self._pw.epoch != self.epoch:
            # drop the stale operands (a dense f32 operand on rmat16 is
            # 17.2 GB) before the new ones are built
            self._pw = None
            self._pw = prepare_weighted(self.graph, w, device=self.device)
        return self._pw

    def _sharded_operands(self, semiring: str, mesh):
        """This rank's :class:`ShardedOperands` for ``semiring`` on
        ``mesh``, cached on the mesh's identity and the content epoch (a
        new mesh or epoch drops them; ``tune()`` too)."""
        if mesh is not self._sharded_mesh or \
                self._sharded_epoch != self.epoch:
            self._sharded = {}
            self._sharded_mesh = mesh
            self._sharded_epoch = self.epoch
        if semiring not in self._sharded:
            check_mesh_device(mesh, self.device)
            cfg = self.options.to(
                ShardedConfig, lenient=True, semiring=semiring, mode="dense")
            g = self.graph.view() if self.mutable else self.graph
            self._sharded[semiring] = prepare_sharded(
                g, mesh, weights=self._lane_weights()
                if semiring == "tropical" else None, config=cfg)
        return self._sharded[semiring]

    # -- mutation passthrough (DynamicCSRGraph only) -----------------------

    def _dynamic(self) -> DynamicCSRGraph:
        if not self.mutable:
            raise TypeError(
                "graph is a static CSRGraph; prepare(DynamicCSRGraph...) "
                "for mutation support")
        return self.graph

    def insert_edges(self, src, dst, weights=None) -> int:
        return self._dynamic().insert_edges(src, dst, weights)

    def delete_edges(self, src, dst) -> int:
        return self._dynamic().delete_edges(src, dst)

    def compact(self) -> None:
        self._dynamic().compact()

    # -- queries -----------------------------------------------------------

    def _check_semiring(self, semiring: str) -> None:
        if semiring not in SEMIRING_NAMES:
            raise ValueError(
                f"unknown semiring {semiring!r}; one of {SEMIRING_NAMES}")

    def apsp(self, sources: Optional[Sequence[int]] = None, *,
             semiring: str = "boolean", mesh=None,
             checkpoint_dir: Optional[str] = None,
             checkpoint_interval: int = 1,
             chunk_size: Optional[int] = None, resume: bool = True,
             on_chunk=None):
        """Batched multi-source shortest paths (default: all sources) ->
        :class:`repro_torch.core.engine.ApspResult` (boolean),
        :class:`repro_torch.core.weighted.WeightedApspResult` (tropical:
        f32 distances, +inf unreachable) or
        :class:`repro_torch.core.centrality.CountingResult` (counting:
        levels plus exact shortest-path counts), or with ``mesh=`` a
        :class:`repro_torch.core.distributed.ShardedApspResult` (every
        rank of the mesh makes the same call).

        ``checkpoint_dir=`` (or ``on_chunk=``) routes through the
        resumable-job layer (:func:`repro_torch.core.jobs.run_sweep_job`)
        on the handle's device: the run is chunked into ``chunk_size``
        source tiles, checkpointed every ``checkpoint_interval`` chunks,
        and a rerun of the same call resumes from the newest intact
        checkpoint (``resume=False`` starts over).  Returns a
        :class:`repro_torch.core.jobs.JobResult` (host arrays plus the
        resume counters)."""
        self._check_semiring(semiring)
        with trace.span("dawn.apsp"):
            if checkpoint_dir is not None or on_chunk is not None:
                return run_sweep_job(
                    self.graph, sources, workload=semiring,
                    weights=self._lane_weights()
                    if semiring == "tropical" else None,
                    mesh=mesh, options=self.options, chunk_size=chunk_size,
                    checkpoint_dir=checkpoint_dir,
                    checkpoint_interval=checkpoint_interval, resume=resume,
                    on_chunk=on_chunk, device=self.device)
            if mesh is not None:
                # the config is baked into the prepared operands
                return _sharded_apsp(self._sharded_operands(semiring, mesh),
                                     sources)
            if semiring == "tropical":
                return _weighted_apsp(
                    self.prepared_weighted(), sources=sources,
                    config=self.options.to(WeightedConfig, lenient=True))
            if semiring == "counting":
                return _counting_apsp(
                    self.prepared(), sources,
                    config=self.options.to(CentralityConfig, lenient=True))
            return _apsp_engine(
                self.prepared(), sources,
                config=self.options.to(EngineConfig, lenient=True))

    def sssp(self, source: int, *, semiring: str = "boolean",
             mesh=None) -> torch.Tensor:
        """One distance row from ``source``: int32 hops with -1 for
        unreachable (boolean, counting), float32 with +inf (tropical)."""
        return self.apsp([int(source)], semiring=semiring, mesh=mesh).dist[0]

    def centrality(self, sources: Optional[Sequence[int]] = None, *,
                   measures: Sequence[str] = MEASURES,
                   mesh=None) -> CentralityResult:
        """Batched centrality analytics over the counting semiring."""
        return _centrality(self.prepared(), sources, measures=measures,
                           config=self.options.to(CentralityConfig,
                                                  lenient=True),
                           mesh=mesh)

    def incremental(self, sources, *, config=None) -> IncrementalSSSP:
        """Streaming repair driver bound to this handle's dynamic graph
        (frontier-seeded incremental BFS/SSSP — core/incremental.py).
        Its state lies on the handle's device, which is the graph's."""
        g = self._dynamic()
        if config is None:
            config = self.options.to(
                WeightedConfig if g.weighted else EngineConfig,
                lenient=True)
        return IncrementalSSSP(g, sources, config=config)

    def serve(self, *, mesh=None, **kwargs) -> GraphService:
        """A tiered :class:`repro_torch.serve.GraphService` over the
        source graph on the handle's device (epoch-guarded when the graph
        is dynamic).  ``config`` defaults from the handle's options and
        ``weights`` from the handle; other keywords pass through
        (``n_landmarks=``, ``max_batch=``, ``clock=``, ...)."""
        kwargs.setdefault("config",
                          self.options.to(EngineConfig, lenient=True))
        if self._weights is not None:
            kwargs.setdefault("weights", self._weights)
        return GraphService(self.graph, mesh=mesh, device=self.device,
                            **kwargs)

    # -- autotuning --------------------------------------------------------

    @property
    def tuning(self) -> Optional[TuningPlan]:
        """The TuningPlan cached on this handle (None = untuned)."""
        return self.options.tuning

    def tune(self, *, use_hlo: bool = True, save=None,
             profile=None) -> TuningPlan:
        """Build a roofline :class:`TuningPlan` for this graph on the
        handle's device (with its lane weights, the tropical forms are
        priced too), cache it on the handle (every later query consults
        it — tiles, the fused gate, deterministic ``mode="auto"``
        direction pins), and optionally ``save`` it for reproducible
        reruns (``prepare(g, tuning="plan.json")``).  ``use_hlo=False``
        skips the op counts: a static plan."""
        plan = build_plan(self.prepared(), weights=self._lane_weights(),
                          profile=profile, use_hlo=use_hlo)
        if save is not None:
            plan.save(save)
        self.options = dataclasses.replace(self.options, tuning=plan)
        self._sharded = {}       # baked configs must pick the plan up
        return plan


def prepare(graph: Union[CSRGraph, DynamicCSRGraph], *, weights=None,
            options: Optional[SweepOptions] = None, device=None,
            **opts) -> DawnGraph:
    """Entry point of the facade: wrap a graph in a :class:`DawnGraph`.

    ``graph`` is a :class:`CSRGraph` or a :class:`DynamicCSRGraph`.
    ``options=`` takes a ready :class:`SweepOptions`; any extra keywords
    construct one (``prepare(g, source_batch=64, use_kernel=False)``).
    ``weights=`` attaches (m_pad,) lane weights (at least ``n_edges``
    non-negative values in lane order) for the tropical semiring; a
    dynamic graph carries its own.  ``device=None`` means the card; a
    dynamic graph must lie on that device (``ValueError`` otherwise).
    ``tuning=`` accepts a :class:`TuningPlan` or the path of a saved one,
    loaded with the fingerprint check against the handle's device — the
    reproducibility lock for ``mode="auto"`` runs; build one with
    :meth:`DawnGraph.tune`.
    """
    if not isinstance(graph, (CSRGraph, DynamicCSRGraph)):
        raise TypeError(f"prepare() takes a CSRGraph or a DynamicCSRGraph, "
                        f"not {type(graph).__name__}")
    if options is not None and opts:
        raise ValueError("pass options= or plain keywords, not both")
    if isinstance(opts.get("tuning"), (str, os.PathLike)):
        opts["tuning"] = TuningPlan.load(opts["tuning"],
                                         device=resolve_device(device))
    return DawnGraph(graph, weights=weights,
                     options=options or SweepOptions(**opts), device=device)
