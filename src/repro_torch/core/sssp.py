"""Public SSSP/APSP drivers — the paper's user-facing API.

The port of ``repro/core/sssp.py``.  ``sssp(graph, source,
method="auto")`` picks the execution path:

  * ``auto``  — the direction-optimizing engine (``core/engine.py``):
                sources tile into batches and every sweep runs in the
                form the engine chooses.
  * ``sovm``  — pin the edge-parallel sparse sweep (paper Alg. 2),
                single-source state, in-loop parent tracking.
  * ``bovm``  — pin the dense boolean product sweep (paper Alg. 1).

Every result carries a shortest-path-tree ``parent`` array (any
in-neighbour at dist-1; max node id as the deterministic tie-break)
usable with :func:`repro_torch.core.sovm.reconstruct_path`.
"""
from __future__ import annotations

from typing import Iterator, NamedTuple, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..graph.csr import CSRGraph
from .bovm import bovm_msbfs
from .engine import EngineConfig, PreparedGraph, apsp_engine_blocks, \
    prepare_graph
from .sovm import sovm_msbfs, sovm_sssp
from .sweep import derive_parents

METHODS = ("auto", "bovm", "sovm")


class SsspResult(NamedTuple):
    dist: torch.Tensor            # (n,) or (S, n) int32; -1 unreachable
    eccentricity: int             # sweeps that discovered something
    edges_touched: torch.Tensor   # 0-d float32
    # (n,) or (S, n) int32; -1 at sources/unreached.  None when the caller
    # opted out (parents=False skips the O(S * m_pad) post-pass)
    parent: Optional[torch.Tensor]


def _auto_config(n_sources: int) -> EngineConfig:
    b = min(128, max(8, ((n_sources + 7) // 8) * 8))
    return EngineConfig(source_batch=b)


def _check_method(method: str) -> None:
    if method not in METHODS:
        raise ValueError(f"unknown method {method!r}; one of {METHODS}")


def _engine_sssp(g: Union[CSRGraph, PreparedGraph], sources: np.ndarray,
                 config: Optional[EngineConfig],
                 parents: bool) -> SsspResult:
    """Run sources through the engine, attach parents."""
    pg = g if isinstance(g, PreparedGraph) else \
        prepare_graph(g, device=g.device)
    config = config or _auto_config(len(sources))
    rows, ecc = [], 0
    touched = torch.zeros((), dtype=torch.float32, device=pg.device)
    for _, dist, st in apsp_engine_blocks(pg, sources, config=config):
        rows.append(dist)
        ecc = max(ecc, st.sweeps)
        touched = touched + st.edges_touched
    dist = torch.cat(rows, dim=0)
    return SsspResult(dist, ecc, touched,
                      derive_parents(pg.graph, dist) if parents else None)


def sssp(g: Union[CSRGraph, PreparedGraph], source: int, *,
         method: str = "auto", parents: bool = True,
         config: Optional[EngineConfig] = None) -> SsspResult:
    _check_method(method)
    if method == "auto":
        r = _engine_sssp(g, np.asarray([source], np.int32), config, parents)
        return SsspResult(r.dist[0], r.eccentricity, r.edges_touched,
                          r.parent[0] if parents else None)
    graph = g.graph if isinstance(g, PreparedGraph) else g
    if method == "bovm":
        st = bovm_msbfs(graph.to_dense(), [int(source)])
        return SsspResult(st.dist[0], st.step - 1, st.edges_touched,
                          derive_parents(graph, st.dist)[0] if parents
                          else None)
    st = sovm_sssp(graph, source)   # parent tracked in-loop (free)
    return SsspResult(st.dist, st.sweeps, st.edges_touched, st.parent)


def multi_source(g: Union[CSRGraph, PreparedGraph], sources: Sequence[int],
                 *, method: str = "auto", parents: bool = True,
                 config: Optional[EngineConfig] = None) -> SsspResult:
    _check_method(method)
    srcs = np.asarray(sources, np.int32).reshape(-1)
    if method == "auto":
        return _engine_sssp(g, srcs, config, parents)
    graph = g.graph if isinstance(g, PreparedGraph) else g
    if method == "bovm":
        st = bovm_msbfs(graph.to_dense(), srcs)
        return SsspResult(st.dist, st.step - 1, st.edges_touched,
                          derive_parents(graph, st.dist) if parents
                          else None)
    st = sovm_msbfs(graph, srcs)    # parent tracked in-loop
    return SsspResult(st.dist, int(st.sweeps.max()),
                      st.edges_touched.sum(), st.parent)


def apsp(g: Union[CSRGraph, PreparedGraph], *, block: int = 128,
         method: str = "auto") -> Iterator[Tuple[np.ndarray, torch.Tensor]]:
    """All-pairs via blocked multi-source sweeps.  Yields (sources, dist)
    blocks so the full (n, n) matrix is never materialized.

    method='auto' prepares the graph once so the engine operands and the
    calibration cache are shared across every block."""
    if method == "auto" and not isinstance(g, PreparedGraph):
        g = prepare_graph(g, device=g.device)
    n = (g.graph if isinstance(g, PreparedGraph) else g).n_nodes
    for lo in range(0, n, block):
        srcs = np.arange(lo, min(lo + block, n), dtype=np.int32)
        yield srcs, multi_source(g, srcs, method=method, parents=False).dist


def apsp_dense(g: Union[CSRGraph, PreparedGraph], *, block: int = 128,
               method: str = "auto") -> np.ndarray:
    """Materialized APSP on the host (small graphs / tests)."""
    rows = [d.cpu().numpy() for _, d in apsp(g, block=block, method=method)]
    return np.concatenate(rows, axis=0)
