"""Resumable sweep jobs: preemption-safe checkpoint/resume for long
batched workloads (the port of ``repro/core/jobs.py``).

A batched sweep workload — boolean APSP, tropical (min,+) APSP, counting
(dist, sigma) for centrality — runs as a sequence of source-tile
*chunks*, each one engine run on the device, with periodic progress
checkpoints through :mod:`repro_torch.train.checkpoint` (async writer,
sha256-manifested raw-bytes shards, atomic rename), and resumes
bit-identically after a kill:

  * each chunk is a pure function of (graph, chunk sources, config), so
    restored rows are byte-exact copies of what the interrupted run
    computed and recomputed chunks see identical operands;
  * the aggregation is partition-stable: ``sweeps`` is a running max,
    ``direction_counts`` and ``edges_touched`` running sums folded in
    fixed chunk order;
  * the sharded executor (``mesh=``) is bit-identical to the engines and
    across mesh shapes, so a job checkpointed on one mesh restores onto a
    smaller one — the elastic walk is ``plan_remesh`` →
    :func:`repro_torch.launch.mesh.mesh_from_plan` → ``restore(...,
    shardings=)`` — and still reproduces the uninterrupted run.

The checkpoint state is a fixed-shape host tree (full-size dist / sigma
buffers plus scalar counters); each chunk's rows come to the host with
one device-to-host copy before the state is submitted.  The manifest
embeds a job fingerprint (graph content hash, sources, workload,
chunking) equal to the JAX package's for the same job, and resume
refuses, with :class:`JobMismatchError`, checkpoints written by a
different job.

Under ``mode="auto"`` on the reference (CPU) path a plan-less run picks
each chunk's direction by wall clock, so its ``direction_counts`` — and
only they — are not reproducible across invocations.  Pass ``tuning=``
(a :class:`~repro_torch.core.autotune.TuningPlan`, which reaches every
chunk through ``options.to(...)``) to make ``mode="auto"`` reproducible:
the plan's roofline argmin pins each chunk's direction.  The job
fingerprint holds no plan, as in the JAX package.

Fault-injection seam: ``on_chunk(k)`` runs after chunk ``k``'s
checkpoint is submitted; raising from it simulates a kill.

On a mesh every rank runs the same job (the executor's SPMD contract):
only the mesh's origin rank writes the checkpoints (N ranks renaming into
one directory would race), every rank reads them, and the job ends with
a barrier over the mesh once the last write has landed.
"""
from __future__ import annotations

import hashlib
from typing import Callable, NamedTuple, Optional, Sequence

import numpy as np

from ..graph.csr import resolve_device
from ..launch.mesh import check_mesh, check_mesh_device, mesh_device
from ..train import checkpoint as ckpt
from .centrality import CentralityConfig, counting_apsp
from .distributed import (ShardedConfig, is_mesh_leader, mesh_barrier,
                          prepare_sharded, sharded_apsp)
from .engine import EngineConfig, apsp_engine, prepare_graph
from .options import SweepOptions
from .weighted import WeightedConfig, prepare_weighted, weighted_apsp

WORKLOADS = ("boolean", "tropical", "counting")


class JobMismatchError(RuntimeError):
    """``checkpoint_dir`` holds checkpoints of a *different* job (graph
    content, sources, workload or chunking changed) — refusing to resume
    from or garbage-collect them."""


class JobResult(NamedTuple):
    dist: np.ndarray             # (S, n) int32 hops / float32 tropical
    sigma: Optional[np.ndarray]  # (S, n) f32 path counts (counting only)
    sweeps: int                  # max per-tile trip count (== engine's)
    direction_counts: np.ndarray  # summed over chunks
    edges_touched: float         # Eq. 10 work counter summed over chunks
    chunks_total: int
    chunks_computed: int         # chunks swept by THIS invocation
    chunks_restored: int         # chunks recovered from the checkpoint
    checkpoints_written: int     # by this invocation
    restored_step: Optional[int]  # checkpoint step resumed from, or None
    corrupt_skipped: int         # damaged checkpoints skipped over


def _host(x) -> np.ndarray:
    return x.cpu().numpy() if hasattr(x, "cpu") else np.asarray(x)


def _sha(arr) -> str:
    return hashlib.sha256(
        np.ascontiguousarray(np.asarray(arr)).tobytes()).hexdigest()[:16]


def _job_meta(g, epoch: int, srcs, weights, workload: str,
              chunk_size: int, options: SweepOptions) -> dict:
    """JSON-serializable job fingerprint, the same dict as the JAX
    package's for the same job: graph content (edge lanes + epoch),
    sources, workload, weights, and the chunking / mode / tile knobs."""
    return {
        "job": "sweep-v1",
        "workload": workload,
        "n_nodes": int(g.n_nodes),
        "n_edges": int(g.n_edges),
        "epoch": int(epoch),
        "edges_sha": _sha(np.stack([_host(g.src).astype(np.int64),
                                    _host(g.dst).astype(np.int64)])),
        "sources_sha": _sha(np.asarray(srcs, np.int32)),
        "weights_sha": _sha(_host(weights).astype(np.float32))
        if weights is not None else None,
        "chunk_size": int(chunk_size),
        "mode": options.mode,
        "source_batch": int(options.source_batch),
        "max_steps": options.max_steps,
    }


def _chunk_runner(graph, workload: str, weights, mesh,
                  options: SweepOptions, device):
    """Build the operands on ``device`` (or this rank's of ``mesh``)
    once; return (run, n_dirs) where ``run(chunk)`` -> (dist, sigma |
    None, sweeps, dir_counts, edges_touched), the rows as host arrays
    (one copy each)."""
    if mesh is not None:
        cfg = options.to(ShardedConfig, lenient=True, semiring=workload)
        ops = prepare_sharded(
            graph, mesh,
            weights=weights if workload == "tropical" else None, config=cfg)

        def run(chunk):
            r = sharded_apsp(ops, chunk)
            return r.dist.cpu().numpy(), None if r.sigma is None else \
                r.sigma.cpu().numpy(), r.sweeps, r.direction_counts, \
                r.edges_touched
        return run, 2
    if workload == "tropical":
        pw = prepare_weighted(graph, weights, device=device)
        wcfg = options.to(WeightedConfig, lenient=True)

        def run(chunk):
            r = weighted_apsp(pw, sources=chunk, config=wcfg)
            return r.dist.cpu().numpy(), None, r.sweeps, \
                r.direction_counts, r.edges_touched
        return run, 2
    pg = prepare_graph(graph, device=device)
    if workload == "counting":
        ccfg = options.to(CentralityConfig, lenient=True)

        def run(chunk):
            r = counting_apsp(pg, chunk, config=ccfg)
            # the counting engine has no Eq. 10 counter — stays 0
            return r.dist.cpu().numpy(), r.sigma.cpu().numpy(), r.sweeps, \
                r.direction_counts, 0.0
        return run, 2
    ecfg = options.to(EngineConfig, lenient=True)

    def run(chunk):
        r = apsp_engine(pg, chunk, config=ecfg)
        return r.dist.cpu().numpy(), None, r.sweeps, r.direction_counts, \
            r.edges_touched
    return run, 3


def _fresh_state(S: int, n: int, workload: str, n_dirs: int) -> dict:
    """Fixed-shape host checkpoint state: full-size result buffers plus
    scalar progress counters, the same tree structure at every step."""
    tropical = workload == "tropical"
    dist = np.full((S, n), np.inf, np.float32) if tropical \
        else np.full((S, n), -1, np.int32)
    sigma = np.zeros((S, n) if workload == "counting" else (1, 1),
                     np.float32)
    return {
        "dist": dist,
        "sigma": sigma,
        "sweeps": np.int32(0),
        "dir_counts": np.zeros(n_dirs, np.int32),
        "edges_touched": np.float32(0.0),
        "chunks_done": np.int32(0),
    }


def _try_restore(checkpoint_dir: str, like: dict, meta: dict,
                 verify: bool, shardings):
    """Newest-first scan: (state, restored_step, corrupt_skipped).
    Damaged checkpoints (bad sha256, unreadable manifest) are counted and
    skipped; a manifest from a DIFFERENT job raises."""
    corrupt = 0
    for step in sorted(ckpt.all_steps(checkpoint_dir), reverse=True):
        try:
            man = ckpt.read_manifest(checkpoint_dir, step)
        except (OSError, ValueError):
            corrupt += 1
            continue
        got = man.get("meta")
        if got != meta:
            raise JobMismatchError(
                f"{checkpoint_dir!r} step {step} was written by a "
                f"different job:\n  found    {got}\n  expected {meta}")
        try:
            tree, _ = ckpt.restore(checkpoint_dir, step, like,
                                   verify=verify, shardings=shardings)
        except (OSError, KeyError, ValueError):
            corrupt += 1
            continue
        # back to mutable host buffers (a mesh restore puts the leaves on
        # this rank's device)
        return {k: np.array(_host(v)) for k, v in tree.items()}, step, \
            corrupt
    return None, None, corrupt


def run_sweep_job(graph, sources: Optional[Sequence[int]] = None, *,
                  workload: str = "boolean", weights=None, mesh=None,
                  options: Optional[SweepOptions] = None,
                  chunk_size: Optional[int] = None,
                  checkpoint_dir: Optional[str] = None,
                  checkpoint_interval: int = 1, keep: int = 3,
                  resume: bool = True, verify: bool = True,
                  on_chunk: Optional[Callable[[int], None]] = None,
                  device=None) -> JobResult:
    """Run a batched sweep workload as resumable source-tile chunks on
    ``device`` (``None``: the card, or this rank's device of ``mesh``).

    With ``checkpoint_dir=`` set, progress is checkpointed every
    ``checkpoint_interval`` chunks (async, atomic, sha256-manifested;
    newest ``keep`` retained) plus once after the final chunk, and a rerun
    of the same call resumes from the newest intact checkpoint, with
    results bit-identical to an uninterrupted run, also on another mesh
    than the one that wrote the checkpoint.  ``graph`` is a
    :class:`CSRGraph` or a :class:`DynamicCSRGraph` (its content epoch is
    part of the job's fingerprint).  ``mesh=`` runs the chunks through
    the sharded executor and restores through the current mesh
    (``restore(shardings=)``, the elastic path)."""
    if workload not in WORKLOADS:
        raise ValueError(f"unknown workload {workload!r}; one of "
                         f"{WORKLOADS}")
    if mesh is not None:
        check_mesh(mesh)
        dev = mesh_device(mesh) if device is None else resolve_device(device)
        check_mesh_device(mesh, dev)
    else:
        dev = resolve_device(device)
    epoch = 0
    if hasattr(graph, "view"):        # DynamicCSRGraph duck-type
        epoch = int(graph.epoch)
        if weights is None and getattr(graph, "weighted", False):
            weights = graph.view_weights()
        graph = graph.view()
    options = options or SweepOptions()
    n = graph.n_nodes
    srcs = np.arange(n, dtype=np.int32) if sources is None else \
        np.asarray(sources, np.int32)
    if srcs.size == 0:
        raise ValueError("run_sweep_job: empty source list")
    if srcs.min() < 0 or srcs.max() >= n:
        raise ValueError(f"run_sweep_job: sources must be in [0, {n})")
    chunk_size = int(chunk_size or options.source_batch)
    if chunk_size < 1:
        raise ValueError(f"chunk_size must be >= 1: {chunk_size}")
    n_chunks = -(-len(srcs) // chunk_size)

    run, n_dirs = _chunk_runner(graph, workload, weights, mesh, options,
                                dev)
    state = _fresh_state(len(srcs), n, workload, n_dirs)
    meta = _job_meta(graph, epoch, srcs, weights, workload, chunk_size,
                     options)
    meta["chunks_total"] = n_chunks

    hook = None
    writes = 0                 # checkpoints submitted, on every rank
    restored_step = None
    corrupt = 0
    start = 0
    if checkpoint_dir is not None:
        if mesh is None or is_mesh_leader(mesh):
            hook = ckpt.CheckpointHook(checkpoint_dir, keep=keep)
        if resume:
            # restoring through the current mesh is the elastic path: the
            # checkpoint may have been written on another mesh shape
            shardings = None if mesh is None else \
                {k: mesh for k in state}
            got, restored_step, corrupt = _try_restore(
                checkpoint_dir, state, meta, verify, shardings)
            if got is not None:
                state = got
                start = int(state["chunks_done"])

    computed = 0
    try:
        for k in range(start, n_chunks):
            lo = k * chunk_size
            hi = min(len(srcs), lo + chunk_size)
            dist, sigma, sweeps, dirs, edges = run(srcs[lo:hi])
            state["dist"][lo:hi] = dist
            if workload == "counting":
                state["sigma"][lo:hi] = sigma
            state["sweeps"] = np.int32(max(int(state["sweeps"]),
                                           int(sweeps)))
            state["dir_counts"] = (state["dir_counts"]
                                   + _host(dirs).astype(np.int32))
            state["edges_touched"] = np.float32(
                np.float32(state["edges_touched"])
                + np.float32(float(edges)))
            state["chunks_done"] = np.int32(k + 1)
            computed += 1
            if checkpoint_dir is not None and (
                    (k + 1) % checkpoint_interval == 0 or k + 1 == n_chunks):
                if hook is not None:
                    hook.submit(k + 1, state, meta=meta)
                writes += 1
            if on_chunk is not None:
                on_chunk(k)
    finally:
        if hook is not None:
            hook.flush()    # clean shutdown: the last write is durable
        if mesh is not None and checkpoint_dir is not None:
            mesh_barrier(mesh)  # ... before any rank reads it

    return JobResult(
        dist=state["dist"],
        sigma=state["sigma"] if workload == "counting" else None,
        sweeps=int(state["sweeps"]),
        direction_counts=np.asarray(state["dir_counts"]),
        edges_touched=float(state["edges_touched"]),
        chunks_total=n_chunks,
        chunks_computed=computed,
        chunks_restored=start,
        checkpoints_written=writes,
        restored_step=restored_step,
        corrupt_skipped=corrupt)
