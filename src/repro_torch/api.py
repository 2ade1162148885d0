"""The ``dawn`` facade of the port: one handle over a prepared graph.

    import repro_torch as dawn

    h = dawn.prepare(graph)                 # operands on the card
    d = h.sssp(0)                           # one dist row
    res = h.apsp(sources)                   # batched engine result
    h = dawn.prepare(graph, weights=w)      # lane weights: tropical
    res = h.apsp(sources, semiring="tropical")

``prepare`` puts the graph's operands on ``device`` (``None``: the card;
pass ``device="cpu"`` for the CPU) and raises when CUDA is missing and
the CPU was not asked for.  The boolean, counting and tropical semirings
and centrality are ported; the other routes of ``repro.api`` raise
``NotImplementedError`` naming the ROADMAP item that brings them.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch

from .core.centrality import MEASURES, CentralityConfig, CentralityResult
from .core.centrality import centrality as _centrality
from .core.centrality import counting_apsp as _counting_apsp
from .core.engine import EngineConfig, PreparedGraph, prepare_graph
from .core.engine import apsp_engine as _apsp_engine
from .core.options import SweepOptions
from .core.weighted import (PreparedWeightedGraph, WeightedConfig,
                            prepare_weighted)
from .core.weighted import weighted_apsp as _weighted_apsp
from .graph.csr import CSRGraph, resolve_device

SEMIRING_NAMES = ("boolean", "tropical", "counting")


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported to repro_torch yet")


class DawnGraph:
    """Prepared-graph handle returned by :func:`prepare`.  The operands
    are built once, lazily, on the handle's device."""

    def __init__(self, graph: CSRGraph, *, weights=None,
                 options: Optional[SweepOptions] = None, device=None):
        self.device = resolve_device(device)
        self.graph = graph
        self.options = options or SweepOptions()
        self._weights = weights
        self._pg: Optional[PreparedGraph] = None
        self._pw: Optional[PreparedWeightedGraph] = None

    def prepared(self) -> PreparedGraph:
        """The :class:`PreparedGraph` (boolean and counting operands) on
        the device."""
        if self._pg is None:
            self._pg = prepare_graph(self.graph, device=self.device)
        return self._pg

    def prepared_weighted(self) -> PreparedWeightedGraph:
        """The :class:`PreparedWeightedGraph` (tropical operands) on the
        device; needs the ``weights=`` given to :func:`prepare`."""
        if self._weights is None:
            raise ValueError("tropical semiring needs weights: "
                             "prepare(graph, weights=...)")
        if self._pw is None:
            self._pw = prepare_weighted(self.graph, self._weights,
                                        device=self.device)
        return self._pw

    def _check_semiring(self, semiring: str) -> None:
        if semiring not in SEMIRING_NAMES:
            raise ValueError(
                f"unknown semiring {semiring!r}; one of {SEMIRING_NAMES}")

    def apsp(self, sources: Optional[Sequence[int]] = None, *,
             semiring: str = "boolean", mesh=None,
             checkpoint_dir: Optional[str] = None, on_chunk=None):
        """Batched multi-source shortest paths (default: all sources) ->
        :class:`repro_torch.core.engine.ApspResult` (boolean),
        :class:`repro_torch.core.weighted.WeightedApspResult` (tropical:
        f32 distances, +inf unreachable) or
        :class:`repro_torch.core.centrality.CountingResult` (counting:
        levels plus exact shortest-path counts)."""
        self._check_semiring(semiring)
        if mesh is not None:
            raise _not_ported("mesh= (the sharded executor, ROADMAP Queue "
                              "1 item 11)")
        if checkpoint_dir is not None or on_chunk is not None:
            raise _not_ported("checkpoint_dir= / on_chunk= (resumable "
                              "jobs, ROADMAP Queue 1 item 10)")
        if semiring == "tropical":
            return _weighted_apsp(self.prepared_weighted(), sources=sources,
                                  config=self.options.to(WeightedConfig,
                                                         lenient=True))
        if semiring == "counting":
            return _counting_apsp(self.prepared(), sources,
                                  config=self.options.to(CentralityConfig,
                                                         lenient=True))
        return _apsp_engine(self.prepared(), sources,
                            config=self.options.to(EngineConfig,
                                                   lenient=True))

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

    def incremental(self, *args, **kwargs):
        raise _not_ported("incremental repair (ROADMAP Queue 1 item 8)")

    def serve(self, *args, **kwargs):
        raise _not_ported("the serving tier (ROADMAP Queue 1 item 9)")

    def tune(self, *args, **kwargs):
        raise _not_ported("the roofline autotuner (ROADMAP Queue 1 "
                          "item 12)")


def prepare(graph: CSRGraph, *, weights=None,
            options: Optional[SweepOptions] = None, device=None,
            **opts) -> DawnGraph:
    """Entry point of the facade: wrap a graph in a :class:`DawnGraph`.

    ``options=`` takes a ready :class:`SweepOptions`; any extra keywords
    construct one (``prepare(g, source_batch=64, use_kernel=False)``).
    ``weights=`` attaches (m_pad,) lane weights (at least ``n_edges``
    non-negative values in lane order) for the tropical semiring.
    ``device=None`` means the card.
    """
    if not isinstance(graph, CSRGraph):
        raise _not_ported(f"{type(graph).__name__} (only a static CSRGraph "
                          f"is ported; DynamicCSRGraph is ROADMAP Queue 1 "
                          f"item 8)")
    if options is not None and opts:
        raise ValueError("pass options= or plain keywords, not both")
    return DawnGraph(graph, weights=weights,
                     options=options or SweepOptions(**opts), device=device)
